"""minicpm3-4b (MLA, latent attention) on the port, against the live JAX
reference on the CPU at ``smoke_config()`` (2 layers, d_model 64, 4
heads, q_lora 32, kv_lora 16, qk nope 16 + rope 8, v 16, vocab 128).

Weights are a JAX ``Model.init`` tree carried over with
``from_jax_params`` (a plain copy of the MLA tree).  Logits of ``prefill``
and of ``decode_step`` over the latent slot cache are held at 1e-4 under
an f32 plan; the slot engine's streams and counters exactly.  The prefill
runs kernel 1 with q and k at D = nope + rope and v zero-padded to it
(``attention._flash_padded``), held to the unpadded attention at 1e-6.

The engine workload is ``launch/serve.py``'s (8 prompts of 4-23 tokens,
16 new tokens, 4 slots), chosen because it has no near-tie:
``test_engine_workload_has_no_near_tie`` holds the smallest top-2 margin
behind every token of the reference's streams, teacher-forced over the
reference's f32 logits, above 1e-4 (``ROADMAP.md``, Queue 3,
"Near-ties")."""
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
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import Engine, EngineKnobs, Request  # noqa: E402

ARCH = "minicpm3-4b"
ATOL = 1e-4
MARGIN = 1e-4
STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params), f32 plan."""
    jm = j_build_model(j_get_config(ARCH).smoke_config(),
                       j_local_plan(param_dtype=jnp.float32,
                                    compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32), device="cpu")
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def test_config_matches_reference():
    t, j = get_config(ARCH), j_get_config(ARCH)
    assert t.__dict__ == j.__dict__
    assert t.param_count() == j.param_count()
    assert t.smoke_config().__dict__ == j.smoke_config().__dict__
    assert (t.attn_kind, t.q_lora_rank, t.kv_lora_rank, t.qk_nope_head_dim,
            t.qk_rope_head_dim, t.v_head_dim) == ("mla", 768, 256, 64, 32, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_matches_reference(pair, dtype):
    """The port's own init builds the reference's MLA tree (keys, shapes,
    dtypes); ``from_jax_params`` carries it across bit for bit."""
    jm = j_build_model(j_get_config(ARCH).smoke_config(),
                       j_local_plan(param_dtype=getattr(jnp, dtype)))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(get_config(ARCH).smoke_config(),
                     local_plan(param_dtype=getattr(torch, dtype)),
                     device="cpu")
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace(
        "torch.", "")), own) == shapes
    assert set(jp["layers"]["attn"]) == {"w_dq", "w_uq", "w_dkv", "w_kr",
                                         "w_uk", "w_uv", "w_o", "q_norm",
                                         "kv_norm"}
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


@pytest.mark.parametrize("dv,dk", [(16, 24), (64, 96), (80, 80), (16, 16)])
def test_flash_padded_is_exact(dv, dk):
    """v zero-padded to q's head dim (and both up to a head dim kernel 1
    takes) gives the unpadded attention's o: 1e-6."""
    rng = np.random.default_rng(dk)
    B, S, H = 2, 19, 3
    q, k = (_t(rng.standard_normal((B, S, H, dk)).astype(np.float32))
            for _ in range(2))
    v = _t(rng.standard_normal((B, S, H, dv)).astype(np.float32))
    got = TA._flash_padded(q, k, v, scale=0.3)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert got.shape == (B, S, H, dv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert min(d for d in fa._HEAD_DIMS if d >= max(dk, dv)) >= dk


def test_prefill_matches_reference(pair):
    """``prefill`` logits at 1e-4 and the latent cache (``ckv``, ``kr``)
    at 1e-5."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(0).integers(0, 128, (3, 21)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, _t(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for n in ("ckv", "kr"):
        assert tuple(tc["attn"][n].shape) == tuple(jc["attn"][n].shape)
        np.testing.assert_allclose(tc["attn"][n].numpy(),
                                   np.asarray(jc["attn"][n]), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(pair, cache_dtype):
    """Two decode steps over a random latent cache (a parked slot at
    position 0 among them): logits at 1e-4, the written cache rows equal
    (at 1e-5 over f32; bf16 rows round the same f32 values)."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    B, S = 4, 32
    cache = {"ckv": rng.standard_normal(
        (cfg.num_layers, B, S, cfg.kv_lora_rank)).astype(np.float32),
        "kr": rng.standard_normal(
        (cfg.num_layers, B, S, cfg.qk_rope_head_dim)).astype(np.float32)}
    jc = {"attn": {n: jnp.asarray(a, getattr(jnp, cache_dtype))
                   for n, a in cache.items()}}
    tc = {"attn": {n: _t(a).to(getattr(torch, cache_dtype))
                   for n, a in cache.items()}}
    pos = np.asarray([7, 0, 31, 12], np.int32)
    for step in range(2):
        toks = rng.integers(0, 128, B).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, _t(toks), _t(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        for n in ("ckv", "kr"):
            np.testing.assert_allclose(
                tc["attn"][n].float().numpy(),
                np.asarray(jc["attn"][n], np.float32),
                atol=1e-5 if cache_dtype == "float32" else 1e-2, rtol=0)
        pos = np.minimum(pos + 1, S - 1)


def _workload(vocab, n=8, max_new=16):
    """launch/serve.py's request stream: (prompt, max_new_tokens) pairs."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, 24))
        out.append(([int(t) for t in rng.integers(0, vocab, plen)], max_new))
    return out


def _serve(eng, req_cls, load):
    reqs = [req_cls(prompt=p, max_new_tokens=m, arrival_s=0.0)
            for p, m in load]
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    return {"streams": [tuple(r.output) for r in reqs],
            "completed": len(stats.completed), "paged": eng.paged,
            **{k: getattr(stats, k) for k in STATS}}


_REF: dict = {}


def test_slot_engine_matches_reference(pair):
    """``Engine(..., paged=None)`` picks the slot pool for MLA, as the
    reference's does, and serves its streams and counters."""
    jm, jp, tm, tp = pair
    kw = dict(max_seq=64, n_slots=4, paged=None)
    ref = _serve(JEngine(jm, jp, knobs=JKnobs(max_batch=4), **kw), JRequest,
                 _workload(128))
    got = _serve(Engine(tm, tp, knobs=EngineKnobs(max_batch=4), **kw),
                 Request, _workload(128))
    _REF["streams"] = ref["streams"]
    assert got == ref
    assert got["paged"] is False and got["completed"] == 8
    assert all(len(s) == 16 for s in got["streams"])
    with pytest.raises(ValueError, match="cannot serve paged"):
        Engine(tm, tp, max_seq=64, n_slots=4, paged=True)


def test_engine_workload_has_no_near_tie(pair):
    """The smallest top-2 margin along the reference's slot streams,
    teacher-forced over its f32 logits, against ``MARGIN``."""
    jm, jp, _, _ = pair
    load = _workload(128)
    if "streams" not in _REF:
        eng = JEngine(jm, jp, max_seq=64, n_slots=4, paged=None,
                      knobs=JKnobs(max_batch=4))
        _REF["streams"] = _serve(eng, JRequest, load)["streams"]
    ctxs = [list(p) + list(s) for (p, _), s in zip(load, _REF["streams"])]
    tokens = np.zeros((len(ctxs), max(len(c) for c in ctxs)), np.int32)
    for r, c in enumerate(ctxs):
        tokens[r, :len(c)] = c
    logits = np.asarray(jax.jit(jm.logits)(jp, jnp.asarray(tokens)),
                        np.float64)
    margins = [np.diff(np.sort(logits[r, len(p) + j - 1])[-2:])[0]
               for r, ((p, _), s) in enumerate(zip(load, _REF["streams"]))
               for j in range(len(s))]
    assert min(margins) > MARGIN, min(margins)


def test_serve_cli_prints_reference_dict():
    """``--arch minicpm3-4b --smoke``: mode ``slots`` and the same dict as
    ``repro.launch.serve``."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "3"]
    got = t_serve.main(argv + ["--device", "cpu"])
    assert got == j_serve.main(argv) and got["mode"] == "slots"
