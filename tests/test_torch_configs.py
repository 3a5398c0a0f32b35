"""The reference's five other token-input configs on the port, against the
live JAX reference on the CPU at ``smoke_config()`` (2 layers, d_model
64, 4 heads over 2 KV heads of 16, vocab 128; qwen3-moe: 4 experts,
top-2, expert d_ff 32): deepseek-7b (MHA), qwen3-1.7b (qk_norm, tied),
gemma-7b (the gelu GLU, ``norm_plus_one``, ``embed_scale``, tied),
chameleon-34b (qk_norm) and qwen3-moe-235b-a22b (qk_norm, 4 experts under
``router_renorm``).

Weights are a JAX ``Model.init`` tree carried over with
``from_jax_params`` under an f32 plan over a bf16 pool.  Logits of
``prefill_ragged`` and of one ``decode_step_paged`` are held at 1e-4;
engine streams and counters exactly.

The engine workload is ``launch/serve.py``'s (8 prompts of 4-23 tokens,
16 new tokens, 4 lanes, blocks of 16), chosen because it has no near-tie
on any of the five: ``test_engine_workload_has_no_near_tie`` computes,
teacher-forced over the reference's f32 logits, the smallest top-2 margin
behind every token of the reference's streams and holds it above 1e-4,
~100 times the port's logits drift (``ROADMAP.md``, Queue 3,
"Near-ties").  gemma-7b is also served chunked with prefix sharing (kernel
3's path: a shared 17-token head, chunks of 8 and 16), on the slot pool
(kernel 5's) and through ``EngineSpec(shards=2)`` (kernel 4's) against the
JAX ``shards=1`` engine, and through the serve CLI."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import (Engine, EngineKnobs, EngineSpec,  # noqa: E402
                                 Request)

ARCHS = ["deepseek-7b", "qwen3-1.7b", "gemma-7b", "chameleon-34b",
         "qwen3-moe-235b-a22b"]
ATOL = 1e-4
MARGIN = 1e-4
STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


_PAIRS: dict = {}


def _pair(name):
    """(jax model, jax params, port model, port params) at smoke size, f32
    plan, one per config for the module."""
    if name not in _PAIRS:
        jm = j_build_model(j_get_config(name).smoke_config(),
                           j_local_plan(param_dtype=jnp.float32,
                                        compute_dtype=jnp.float32))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(get_config(name).smoke_config(),
                         local_plan(param_dtype=torch.float32,
                                    compute_dtype=torch.float32),
                         device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
        _PAIRS[name] = (jm, jp, tm, tp)
    return _PAIRS[name]


# ---------------------------------------------------------------------------
# the parameter tree (the configs: tests/test_torch_model.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_port_init_builds_reference_tree(name):
    """Same keys, shapes and dtypes as the reference's ``Model.init``
    (qk_norm scales, no unembedding when tied, the router and experts).
    ``param_count()`` leaves out the qk_norm scales, in the reference as
    in the port: two of ``head_dim`` a layer."""
    _, jp, tm, _ = _pair(name)
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)
    assert shapes(own) == shapes(jp)
    assert ("unembed" in own) == (not tm.cfg.tie_embeddings)
    cfg = tm.cfg
    qk = 2 * cfg.num_layers * cfg.head_dim if cfg.qk_norm else 0
    assert sum(a.numel() for a in jax.tree.leaves(own)) == \
        cfg.param_count() + qk


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_prefill_ragged_matches_reference(name):
    jm, jp, tm, tp = _pair(name)
    rng = np.random.default_rng(0)
    B, S = 3, 32
    tokens = rng.integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.asarray([32, 5, 19], np.int32)
    for i, n in enumerate(lengths):
        tokens[i, n:] = 0
    jl, jc = jax.jit(jm.prefill_ragged)(jp, jnp.asarray(tokens),
                                        jnp.asarray(lengths))
    tl, tc = tm.prefill_ragged(tp, torch.from_numpy(tokens),
                               torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tc["attn"][n]), _np(jc["attn"][n]),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_paged_matches_reference(name):
    """One step over a scrambled bf16 pool at ragged positions."""
    jm, jp, tm, tp = _pair(name)
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    B, bs, T = 4, 8, 6
    n_blocks = 1 + B * T
    bt = rng.permutation(np.arange(1, n_blocks))[: B * T] \
        .reshape(B, T).astype(np.int32)
    pos = rng.integers(0, T * bs - 8, B).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    shape = (cfg.num_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    jl, _ = jax.jit(jm.decode_step_paged)(
        jp, {"attn": {n: jnp.asarray(a, jnp.bfloat16)
                      for n, a in pool.items()}},
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(bt))
    tl, _ = tm.decode_step_paged(
        tp, {"attn": {n: torch.from_numpy(a).bfloat16()
                      for n, a in pool.items()}},
        torch.from_numpy(tokens), torch.from_numpy(pos), torch.from_numpy(bt))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _workload(vocab, n=8, max_new=16):
    """``launch/serve.py``'s request stream: (prompt, max_new) pairs."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, 24))
        out.append(([int(t) for t in rng.integers(0, vocab, plen)], max_new))
    return out


def _prefix_load(vocab, *, n_req=5, shared=17, max_new=6, stagger=3):
    """``tests/test_engine_hotpath.py``'s stream: one shared head."""
    rng = np.random.default_rng(0)
    head = [int(t) for t in rng.integers(0, vocab, shared)]
    return [(head + [int(t) for t in rng.integers(0, vocab,
                                                  int(rng.integers(4, 20)))],
             max_new + stagger * i) for i in range(n_req)]


def _serve(eng, req_cls, load) -> dict:
    reqs = [req_cls(prompt=p, max_new_tokens=m, arrival_s=0.0)
            for p, m in load]
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    order = {r.req_id: i for i, r in enumerate(reqs)}
    return {"streams": [tuple(r.output) for r in reqs],
            "finish_order": [order[r.req_id] for r in stats.completed],
            "completed": len(stats.completed),
            "shared_block_hits": getattr(eng.pool, "shared_block_hits", 0),
            **{k: getattr(stats, k) for k in STATS}}


def _both(name, load, **kw) -> dict:
    jm, jp, tm, tp = _pair(name)
    kw = dict(dict(max_seq=128, n_slots=4, block_size=16), **kw)
    ref = _serve(JEngine(jm, jp, knobs=JKnobs(max_batch=4), **kw), JRequest,
                 load)
    got = _serve(Engine(tm, tp, knobs=EngineKnobs(max_batch=4), **kw),
                 Request, load)
    assert got == ref
    assert got["completed"] == len(load)
    return got


_REF_STREAMS: dict = {}


@pytest.mark.parametrize("name,horizon", [(n, 4) for n in ARCHS]
                         + [("gemma-7b", 1)])
def test_engine_matches_reference(name, horizon):
    """Every config through the fused horizon; gemma-7b also one step at
    a time."""
    got = _both(name, _workload(128), paged=True, horizon=horizon)
    assert all(len(s) == 16 for s in got["streams"])
    _REF_STREAMS[name] = got["streams"]


@pytest.mark.parametrize("name", ARCHS)
def test_engine_workload_has_no_near_tie(name):
    """The workload's smallest top-2 margin, teacher-forced over the
    reference's f32 logits along its own paged streams, against
    ``MARGIN``."""
    jm, jp, _, _ = _pair(name)
    load = _workload(128)
    if name not in _REF_STREAMS:
        eng = JEngine(jm, jp, max_seq=128, n_slots=4, paged=True,
                      block_size=16, knobs=JKnobs(max_batch=4))
        _REF_STREAMS[name] = _serve(eng, JRequest, load)["streams"]
    ctxs = [list(p) + list(s) for (p, _), s in zip(load, _REF_STREAMS[name])]
    S = max(len(c) for c in ctxs)
    tokens = np.zeros((len(ctxs), S), np.int32)
    for r, c in enumerate(ctxs):
        tokens[r, :len(c)] = c
    logits = np.asarray(jax.jit(jm.logits)(jp, jnp.asarray(tokens)),
                        np.float64)
    margins = []
    for r, ((prompt, _), stream) in enumerate(zip(load,
                                                  _REF_STREAMS[name])):
        for j in range(len(stream)):
            row = np.sort(logits[r, len(prompt) + j - 1])
            margins.append(row[-1] - row[-2])
    assert min(margins) > MARGIN, min(margins)


@pytest.mark.parametrize("horizon,chunk", [(1, 16), (4, 8)])
def test_gemma_chunked_prefix_shared_matches_reference(horizon, chunk):
    """Kernel 3's path: chunked prefill, the later requests attaching to
    the shared head's blocks."""
    got = _both("gemma-7b", _prefix_load(128), max_seq=64, n_slots=3,
                block_size=8, paged=True, prefix_share=True,
                prefill_chunk=chunk, horizon=horizon)
    assert got["shared_block_hits"] > 0


def test_gemma_slots_match_reference():
    """Kernel 5's path: the slot pool (which decodes one step at a time
    whatever the horizon)."""
    got = _both("gemma-7b", _workload(128), paged=False)
    assert got["prefill_batches"] == 8


@pytest.mark.parametrize("horizon", [1, 4])
def test_gemma_shards_2_matches_reference(horizon):
    """Kernel 4's path: the block-striped pool at shards 2 against the JAX
    ``shards=1`` engine on the same weights."""
    base = dict(max_seq=64, n_slots=4, block_size=8, seed=0, n_blocks=8,
                horizon=horizon)
    jeng = JSpec(j_get_config("gemma-7b").smoke_config(), shards=1,
                 param_dtype=jnp.float32, **base).build()
    eng = EngineSpec(get_config("gemma-7b").smoke_config(), shards=2,
                     param_dtype=torch.float32, **base).build(device="cpu")
    eng.params = from_jax_params(jax.tree.map(np.asarray, jeng.params),
                                 device="cpu")
    load = [([3 + i, 7, 11, 13 + i], 12) for i in range(3)]
    ref = _serve(jeng, JRequest, load)
    got = _serve(eng, Request, load)
    assert eng.shards == 2
    assert got == ref
    assert all(len(s) == 12 for s in got["streams"])


def test_serve_cli_prints_reference_dict():
    """``--arch gemma-7b`` at smoke size: the same printed dict as
    ``repro.launch.serve`` (its counters do not depend on the random
    weights; the CLI reaches every config through ``get_config``)."""
    argv = ["--arch", "gemma-7b", "--smoke"]
    assert t_serve.main(argv + ["--device", "cpu"]) == j_serve.main(argv)
