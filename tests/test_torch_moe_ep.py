"""MoE at shards > 1 (the reference's expert parallelism, on one device),
the port against the live JAX reference on the CPU.

``_moe_core`` at ``tp`` 2 and 4 is held to the reference's own ``axis``
branch, run under ``jax.vmap(axis_name="model")`` over the ranks (each
rank its slice of the experts, ``axis_index``, the slices of
``buf_src``/``buf_gate`` and the psum as the reference writes them): y at
``moe_ffn``'s 1e-5 (``tests/test_torch_moe.py``).  granite-moe-3b-a800m's smoke engines serve at shards 2 in an f32
plan over an f32 pool (the reference's serving pool is bf16; both are
patched), with and without the int8 variant, and are held to the JAX
shards=1 engine: streams and counters exactly (the JAX engine cannot serve
sharded under jax 0.9.0, see ``tests/test_torch_sharded.py``).  The
workload is ``tests/test_torch_moe.py``'s, which has no near-tie.

The reference's ``set_shards`` rebuilds every variant under
``serving_plan(n)``, which drops ``quantize_serve``; its int8 variant's
tree holds only ``w_*_q``/``w_*_s`` (``src/repro/models/moe.py:51-57``),
so the rebuilt model looks up bf16 experts it does not hold.  The port
keeps each variant's flag; both sides of that are shown here.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serving import (Engine, EngineKnobs, Request,  # noqa: E402
                                 serving_plan)

ARCH = "granite-moe-3b-a800m"
STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs", "variant_swaps")


# ---------------------------------------------------------------------------
# the MoE core
# ---------------------------------------------------------------------------

def _core_inputs(cfg, T, seed=0):
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    x = rng.standard_normal((T, d)).astype(np.float32)
    rw = rng.standard_normal((d, E)).astype(np.float32)
    ws = [(0.1 * rng.standard_normal(s)).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    return x, rw, ws


@pytest.mark.parametrize("T", [12, 2100], ids=["no_drops", "drops"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
def test_moe_core_matches_reference_axis_branch(arch, tp, T):
    """y of the port's rank-by-rank combine at 1e-5 of the reference's
    ``_moe_core("model", ...)`` under ``jax.vmap`` over ``tp`` ranks,
    every rank's psum the same; at 2100 tokens (4200 assignments) the
    capacity drops some.  The port at ``tp`` 1 stays within 1e-5 of it
    too."""
    jcfg = j_get_config(arch).smoke_config()
    tcfg = get_config(arch).smoke_config()
    x, rw, ws = _core_inputs(jcfg, T)
    E = jcfg.n_experts
    cap = JM._capacity(T, jcfg)
    assert (T * jcfg.top_k > 4096) == (cap < T * jcfg.top_k)

    def rank(wg, wu, wd):
        return JM._moe_core("model", jnp.asarray(x), jnp.asarray(rw), wg, wu,
                            wd, cfg=jcfg, e_pad=E, capacity=cap,
                            activation=jcfg.activation)[0]

    y = jax.vmap(rank, axis_name="model")(
        *[jnp.asarray(w.reshape(tp, E // tp, *w.shape[1:])) for w in ws])
    y = np.asarray(y)
    assert all(np.array_equal(y[0], y[r]) for r in range(tp))
    for t in (tp, 1):
        got, _ = TM._moe_core(torch.from_numpy(x), torch.from_numpy(rw),
                              *map(torch.from_numpy, ws), cfg=tcfg, e_pad=E,
                              capacity=cap, activation=tcfg.activation, tp=t)
        np.testing.assert_allclose(got.numpy(), y[0], atol=1e-5, rtol=0)


def test_moe_combine_sums_partials_in_rank_order():
    """At tp > 1 y is the sum, in rank order, of each rank's partial: its
    experts' contributions in slot order (pinned in bf16, where the order
    of the adds shows)."""
    cfg = get_config(ARCH).smoke_config()
    x, rw, ws = _core_inputs(cfg, 16, seed=1)
    x = torch.from_numpy(x).bfloat16()
    ws = [torch.from_numpy(w).bfloat16() for w in ws]
    E, cap, tp = cfg.n_experts, 32, 2
    got, _ = TM._moe_core(x, torch.from_numpy(rw), *ws, cfg=cfg, e_pad=E,
                          capacity=cap, activation=cfg.activation, tp=tp)
    parts = []
    for r in range(tp):
        lo, hi = r * E // tp, (r + 1) * E // tp
        w_r = [w.clone() for w in ws]
        for w in w_r:                      # the other ranks' experts: 0
            w[:lo] = 0
            w[hi:] = 0
        parts.append(TM._moe_core(x, torch.from_numpy(rw), *w_r, cfg=cfg,
                                  e_pad=E, capacity=cap,
                                  activation=cfg.activation, tp=1)[0])
    assert torch.equal(got, parts[0] + parts[1])


# ---------------------------------------------------------------------------
# engines at shards 2
# ---------------------------------------------------------------------------

def _workload(vocab, n=8, max_new=16):
    """launch/serve.py's request stream (``tests/test_torch_moe.py``'s)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, 24))
        out.append(([int(t) for t in rng.integers(0, vocab, plen)], max_new))
    return out


def _jax_pair(quantize: bool):
    jm = j_build_model(j_get_config(ARCH).smoke_config(),
                       j_local_plan(param_dtype=jnp.float32,
                                    compute_dtype=jnp.float32,
                                    quantize_serve=quantize))
    return jm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_models():
    """{"full": (jax model, params), "int8": the same draws quantized}."""
    return {"full": _jax_pair(False), "int8": _jax_pair(True)}


def _port(jpair, shards: int, quantize: bool):
    tm = build_model(get_config(ARCH).smoke_config(),
                     serving_plan(shards, param_dtype=torch.float32,
                                  compute_dtype=torch.float32,
                                  quantize_serve=quantize), device="cpu")
    return tm, from_jax_params(jax.tree.map(np.asarray, jpair[1]),
                               device="cpu")


@pytest.fixture
def f32_pools(monkeypatch):
    import repro.serving.engine as j_engine
    import repro_torch.serving.engine as t_engine
    monkeypatch.setattr(j_engine, "PagedCachePool", functools.partial(
        j_engine.PagedCachePool, dtype=jnp.float32))
    monkeypatch.setattr(t_engine, "PagedCachePool", functools.partial(
        t_engine.PagedCachePool, dtype=torch.float32))


def _serve(engine_cls, knobs_cls, req_cls, pair, int8=None, *,
           swap_after=None, **kw):
    model, params = pair
    eng = engine_cls(model, params, max_seq=128, n_slots=4,
                     knobs=knobs_cls(max_batch=4), block_size=16, paged=True,
                     **kw)
    if int8 is not None:
        eng.add_variant("int8", *int8)
    reqs = [req_cls(prompt=p, max_new_tokens=m, arrival_s=0.0)
            for p, m in _workload(model.cfg.vocab_size)]
    for r in reqs:
        eng.submit(r)
    if swap_after is not None:
        for i in range(swap_after):
            eng.step(now=float(i))
        eng.set_variant("int8")
    stats = eng.run()
    return {"streams": [tuple(r.output) for r in reqs],
            "completed": len(stats.completed),
            "variant": eng.knobs.variant,
            "pool_dtype": str(eng.pool.cache["attn"]["k"].dtype)
            .replace("torch.", ""),
            **{k: getattr(stats, k) for k in STATS}}


@pytest.mark.parametrize("path", [
    dict(horizon=4), dict(prefill_chunk=8, prefix_share=True),
    dict(horizon=4, swap_after=2), dict(prefill_chunk=8, swap_after=3)],
    ids=["paged h4", "chunked", "paged h4 int8 swap", "chunked int8 swap"])
def test_granite_at_shards_2_matches_reference(f32_pools, jax_models, path):
    """The full variant, and a mid-run ``set_variant("int8")`` onto the
    int8 variant (kept int8 under the shards-2 plan), against the JAX
    shards=1 engine: streams and counters exact."""
    kw = dict(path)
    int8 = "swap_after" in kw
    jint8 = jax_models["int8"] if int8 else None
    ref = _serve(JEngine, JKnobs, JRequest, jax_models["full"], jint8, **kw)
    tint8 = _port(jax_models["int8"], 2, True) if int8 else None
    tpair = _port(jax_models["full"], 2, False)
    got = _serve(Engine, EngineKnobs, Request, tpair, tint8, **kw)
    assert tpair[0].plan.tp == 2 and got["pool_dtype"] == "float32"
    assert got == ref
    assert got["completed"] == 8
    assert got["variant"] == ("int8" if int8 else "full")


def test_reference_rebuild_drops_quantize_serve_the_port_keeps_it(
        jax_models):
    """The reference's reshard rebuilds its int8 variant under a plan
    without ``quantize_serve``: that model cannot run on the int8 tree
    (it looks up ``w_gate``).  The port's ``set_shards(2)`` keeps the
    variant's flag, and the int8 variant serves at shards 2."""
    jm, jp = jax_models["int8"]
    assert "w_gate" not in jp["layers"]["moe"] and \
        "w_gate_q" in jp["layers"]["moe"]
    rebuilt = j_build_model(jm.cfg, j_local_plan(param_dtype=jnp.float32,
                                                 compute_dtype=jnp.float32))
    assert not rebuilt.plan.quantize_serve
    with pytest.raises(KeyError, match="w_gate"):
        rebuilt.prefill(jp, jnp.zeros((1, 4), jnp.int32))
    tm, tp = _port(jax_models["int8"], 1, True)
    eng = Engine(tm, tp, max_seq=64, n_slots=2, block_size=8)
    eng.set_shards(2)
    model, _ = eng.variants["full"]
    assert eng.shards == 2 and model.plan.quantize_serve
    req = Request(prompt=[3, 7, 11, 13], max_new_tokens=6)
    eng.submit(req)
    eng.run()
    assert len(req.output) == 6


@pytest.mark.parametrize("kind", ["granite", "qwen3-moe", "chunked"])
def test_engine_backend_reshards_what_it_once_rejected(kind):
    """``EngineBackend(shards_for_tp=...)`` turns a profile's tp into
    ``set_shards`` on a MoE engine (granite with its int8 variant active,
    qwen3-moe) and on a chunked, prefix-shared engine, where it once
    counted a ``shard_reject``: 4 -> shards 2, 8 -> back to 1, no reject,
    and the engine serves after each."""
    from repro_torch.core.profiles import ConfigPoint
    from repro_torch.serving import EngineBackend, EngineSpec
    name = {"granite": ARCH, "qwen3-moe": "qwen3-moe-235b-a22b",
            "chunked": "llama2-7b"}[kind]
    cfg = get_config(name).smoke_config()
    kw = dict(prefill_chunk=8, prefix_share=True) if kind == "chunked" \
        else {}
    eng = EngineSpec(cfg, max_seq=64, n_slots=2, block_size=8,
                     **kw).build(device="cpu")
    if kind == "granite":
        eng.add_variant("int8", build_model(
            cfg, serving_plan(1, quantize_serve=True), device="cpu"),
            build_model(cfg, serving_plan(1, quantize_serve=True),
                        device="cpu").init(torch.Generator().manual_seed(1)))
        eng.set_variant("int8")
    bk = EngineBackend(eng, shards_for_tp={4: 2, 8: 1})
    for tp, want in ((4, 2), (8, 1)):
        bk.apply_config(ConfigPoint(freq=1.0, tp=tp, batch=16, size="7b",
                                    quant="bf16"))
        assert eng.shards == want and bk.shard_rejects == 0
        req = Request(prompt=[5, 6, 7, 8, 9] * 3, max_new_tokens=4)
        eng.submit(req)
        eng.run()
        assert len(req.output) == 4
    assert eng.stats.shard_swaps == 2
    if kind == "granite":
        assert eng.knobs.variant == "int8" and eng.model.plan.quantize_serve
