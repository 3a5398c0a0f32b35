"""granite-moe-3b-a800m and its int8-expert variant, the port against the
live JAX reference on the CPU at ``smoke_config()`` (2 layers, d_model
64, 4 experts, top-2, expert d_ff 32, vocab 128): the config and the
parameter tree, ``_quantize_experts``, ``_capacity``, ``moe_ffn`` with
bf16-layout and int8 experts, the model's logits, the paged, chunked and
slot engines, ``set_variant``, ``EngineSpec.variants`` and the serve CLI.

Weights are a JAX ``Model.init`` tree carried over with
``from_jax_params`` (f32 plan; the int8 variant's int8 leaves cross as
int8).  Tolerances: ``moe_ffn`` 1e-5, logits 1e-4, int8 leaves and scales
bit-exact, engine streams and counters exact.  The engine workload is
``launch/serve.py``'s (8 prompts of 4-23 tokens).  It has no near-tie:
teacher-forced over f32 logits, the smallest top-2 margin along the
reference's paged streams is 2.5e-5 (full) and 8.0e-5 (int8), against
~3e-7 between the port's and the reference's f32 logits."""
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
from repro.models import moe as JM  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serving import (Engine, EngineKnobs, EngineSpec,  # noqa: E402
                                 Request, serving_plan)

ARCH = "granite-moe-3b-a800m"
ATOL_FFN = 1e-5
ATOL = 1e-4
STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs", "variant_swaps")


def _t(a):
    """A torch copy: a JAX CPU array may share an aligned numpy buffer."""
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _pair(quantize: bool):
    jcfg = j_get_config(ARCH).smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32,
                                          quantize_serve=quantize))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32,
                                quantize_serve=quantize), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    """{"full": (jax model, params, port model, params), "int8": ...}: the
    int8 variant is the full variant's draws, quantized."""
    return {"full": _pair(False), "int8": _pair(True)}


# ---------------------------------------------------------------------------
# config, parameters, quantization
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    t, j = get_config(ARCH), j_get_config(ARCH)
    assert t.__dict__ == j.__dict__
    assert t.param_count() == j.param_count()
    assert t.param_count(active=True) == j.param_count(active=True)
    assert t.smoke_config().__dict__ == j.smoke_config().__dict__
    assert (t.n_experts, t.top_k, t.expert_d_ff, t.tie_embeddings) == \
        (40, 8, 512, True)


@pytest.mark.parametrize("variant", ["full", "int8"])
def test_port_init_builds_reference_tree(models, variant):
    """Same keys, shapes and dtypes (the router f32, int8 experts with
    (E, 1, d_out) f32 scales); the parameter count is the config's, plus
    the scales."""
    _, jp, tm, tp = models[variant]
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)
    assert shapes(own) == shapes(jp) == shapes(tp)
    cfg = tm.cfg
    scales = 0 if variant == "full" else cfg.num_layers * cfg.n_experts * (
        2 * cfg.expert_d_ff + cfg.d_model)
    assert sum(a.numel() for a in jax.tree.leaves(own)) == \
        cfg.param_count() + scales
    assert "unembed" not in own                         # tied embeddings


def test_int8_variant_is_the_quantized_full_variant():
    """Same generator seed under both plans: the int8 leaves are the full
    variant's experts quantized, every other leaf equal."""
    cfg = get_config(ARCH).smoke_config()
    trees = [build_model(cfg, local_plan(param_dtype=torch.bfloat16,
                                         quantize_serve=q), device="cpu")
             .init(torch.Generator().manual_seed(3)) for q in (False, True)]
    full, q = (t["layers"].pop("moe") for t in trees)
    for name in TM.EXPERT_WEIGHTS:
        for i, w in enumerate(full[name]):              # layer by layer
            w_q, s = TM._quantize_experts(w)
            assert torch.equal(q[name + "_q"][i], w_q)
            assert torch.equal(q[name + "_s"][i], s)
    assert torch.equal(q["router"], full["router"])
    flat = [dict(jax.tree_util.tree_leaves_with_path(t)) for t in trees]
    assert flat[0].keys() == flat[1].keys()
    assert all(torch.equal(flat[0][k], flat[1][k]) for k in flat[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_experts_matches_reference(dtype):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((5, 48, 24)).astype(np.float32)
    w[2] = 0.0                                 # a zero expert: scale 1e-8/127
    w[3, :, 7] *= 1e3
    jw = jnp.asarray(w, dtype)
    jq, js = JM._quantize_experts(jw)
    tq, ts = TM._quantize_experts(_t(np.asarray(jw.astype(jnp.float32)))
                                  .to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_capacity_matches_reference():
    for cfg_t, cfg_j in ((get_config(ARCH), j_get_config(ARCH)),
                         (get_config(ARCH).smoke_config(),
                          j_get_config(ARCH).smoke_config())):
        for t in (1, 4, 255, 512, 2048, 2049, 4096, 8192, 8195):
            assert TM._capacity(t, cfg_t) == JM._capacity(t, cfg_j)
    assert TM._capacity(1024, get_config(ARCH)) == 256    # 4 x bucket 256


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _dropped(monkeypatch) -> list:
    """Record, for every ``dispatch``, the assignments past capacity."""
    seen = []
    inner = TM.dispatch

    def dispatch(topv, topi, *, e_pad, capacity):
        out = inner(topv, topi, e_pad=e_pad, capacity=capacity)
        seen.append(int((out[2] == e_pad * capacity).sum()))
        return out

    monkeypatch.setattr(TM, "dispatch", dispatch)
    return seen


@pytest.mark.parametrize("variant", ["full", "int8"])
@pytest.mark.parametrize("B,S", [(4, 1), (3, 700)])
def test_moe_ffn_matches_reference(models, monkeypatch, variant, B, S):
    """Decode (4 tokens) and a prefill of 2100 tokens (4200 assignments,
    capacity 1313 per expert), at 1e-5 (the reference's load-balancing
    loss, a training term, is not ported)."""
    jm, jp, tm, tp = models[variant]
    seen = _dropped(monkeypatch)
    rng = np.random.default_rng(B * S)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["moe"])
    tl = {k: v[1] for k, v in tp["layers"]["moe"].items()}
    jy, _ = JM.moe_ffn(jl, jnp.asarray(x), jm.cfg, jm.plan)
    ty, _ = TM.moe_ffn(tl, _t(x), tm.cfg, tm.plan)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_FFN,
                               rtol=0)
    assert len(seen) == 1


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "int8"])
def test_logits_match_reference(models, variant):
    jm, jp, tm, tp = models[variant]
    tokens = np.random.default_rng(5).integers(0, 128, (2, 24)) \
        .astype(np.int32)
    np.testing.assert_allclose(_np(tm.logits(tp, _t(tokens))),
                               _np(jm.logits(jp, jnp.asarray(tokens))),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["full", "int8"])
def test_ragged_prefill_with_drops_matches_reference(models, monkeypatch,
                                                     variant):
    """A 4 x 1024 bucket (8192 assignments, capacity 2560 per expert): the
    padded rows of the short prompts are routed too and push their expert
    past capacity in every layer, as in the reference."""
    jm, jp, tm, tp = models[variant]
    seen = _dropped(monkeypatch)
    rng = np.random.default_rng(6)
    lengths = np.asarray([1024, 100, 37, 5], np.int32)
    tokens = np.zeros((4, 1024), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(0, 128, n)
    jl, _ = jax.jit(jm.prefill_ragged)(jp, jnp.asarray(tokens),
                                       jnp.asarray(lengths))
    tl, _ = tm.prefill_ragged(tp, _t(tokens), _t(lengths))
    assert len(seen) == tm.cfg.num_layers and min(seen) > 0, seen
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["full", "int8"])
def test_decode_step_paged_matches_reference(models, variant):
    jm, jp, tm, tp = models[variant]
    rng = np.random.default_rng(8)
    B, bs, T = 4, 8, 6
    n_blocks = 1 + B * T
    bt = rng.permutation(np.arange(1, n_blocks))[: B * T].reshape(B, T) \
        .astype(np.int32)
    pos = rng.integers(0, T * bs - 8, B).astype(np.int32)
    tokens = rng.integers(0, 128, B).astype(np.int32)
    cfg = tm.cfg
    shape = (cfg.num_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    jlog, _ = jax.jit(jm.decode_step_paged)(
        jp, {"attn": {n: jnp.asarray(a, jnp.bfloat16)
                      for n, a in pool.items()}},
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(bt))
    tlog, _ = tm.decode_step_paged(
        tp, {"attn": {n: _t(a).bfloat16() for n, a in pool.items()}},
        _t(tokens), _t(pos), _t(bt))
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=ATOL, rtol=0)


def test_moe_at_shards_above_one_is_refused(models):
    """Expert parallelism, once refused, is ported: a sharded plan builds,
    an EngineSpec at shards 2 builds and serves, and ``set_shards(2)``
    mid-run (``can_shard(2)`` without an objection) preempts the request
    in flight, recomputes it under the 2-way plan and completes it.  Its
    streams against the reference: tests/test_torch_moe_ep.py."""
    _, _, tm, tp = models["full"]
    m = build_model(tm.cfg, serving_plan(2), device="cpu")
    assert m.plan.tp == 2 and m.plan.e_pad(m.cfg) == m.cfg.n_experts
    spec = EngineSpec(tm.cfg, shards=2, max_seq=64, n_slots=2, block_size=8)
    built = spec.build(device="cpu")
    req = Request(prompt=[1, 2, 3], max_new_tokens=6)
    built.submit(req)
    built.run()
    assert built.shards == 2 and len(req.output) == 6
    eng = Engine(tm, tp, max_seq=64, n_slots=2, block_size=8)
    req = Request(prompt=[1, 2, 3], max_new_tokens=6)
    eng.submit(req)
    eng.step()
    assert len(eng.active) == 1
    assert eng.can_shard(2) is None            # the counts divide
    eng.set_shards(2)
    assert eng.shards == 2 and eng.stats.preemptions == 1
    assert not eng.active and len(eng.queue) == 1
    eng.run()
    assert len(req.output) == 6 and eng.stats.shard_swaps == 1


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _workload(vocab, n=8, max_new=16):
    """launch/serve.py's request stream: (prompt, max_new_tokens) pairs."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, 24))
        out.append(([int(t) for t in rng.integers(0, vocab, plen)], max_new))
    return out


def _serve(engine_cls, knobs_cls, req_cls, pair, int8=None, *,
           swap_after=None, **kw):
    """Serve the workload; with ``swap_after=n``, ``set_variant("int8")``
    after n scheduler steps (the int8 variant registered first)."""
    model, params = pair
    eng = engine_cls(model, params, max_seq=128, n_slots=4,
                     knobs=knobs_cls(max_batch=4), block_size=16, **kw)
    if int8 is not None:
        eng.add_variant("int8", *int8)
    reqs = [req_cls(prompt=p, max_new_tokens=m, arrival_s=0.0)
            for p, m in _workload(model.cfg.vocab_size)]
    for r in reqs:
        eng.submit(r)
    in_flight = None
    if swap_after is not None:
        for i in range(swap_after):
            eng.step(now=float(i))
        in_flight = len(eng.active) + len(eng.prefilling)
        eng.set_variant("int8")
    stats = eng.run()
    order = {r.req_id: i for i, r in enumerate(reqs)}
    return {
        "streams": [tuple(r.output) for r in reqs],
        "finish_order": [order[r.req_id] for r in stats.completed],
        "completed": len(stats.completed),
        "in_flight_at_swap": in_flight,
        "variant": eng.knobs.variant,
        **{k: getattr(stats, k) for k in STATS},
    }


ENGINES = {
    "paged h1": dict(paged=True, horizon=1),
    "paged h4 preempt": dict(paged=True, horizon=4, n_blocks=10),
    "chunked": dict(paged=True, prefill_chunk=8),
    "slots": dict(paged=False),
}


@pytest.mark.parametrize("path", ["paged h1", "paged h4 preempt", "chunked"])
def test_engine_matches_reference(models, path):
    """The full variant on the paged paths; the slot path, and the int8
    variant on every path, serve in the mid-run swaps below (the slot
    path's first five steps on the full variant)."""
    jm, jp, tm, tp = models["full"]
    kw = ENGINES[path]
    ref = _serve(JEngine, JKnobs, JRequest, (jm, jp), **kw)
    got = _serve(Engine, EngineKnobs, Request, (tm, tp), **kw)
    assert got == ref
    assert got["completed"] == 8
    assert all(len(s) == 16 for s in got["streams"])
    if "n_blocks" in kw:
        assert got["preemptions"] > 0


@pytest.mark.parametrize("path,swap_after", [("paged h4 preempt", 2),
                                             ("chunked", 3), ("slots", 5)])
def test_set_variant_mid_run_matches_reference(models, path, swap_after):
    """``set_variant("int8")`` mid-run preempts every in-flight request and
    recomputes it under the int8 variant: streams and counters exact."""
    jm, jp, tm, tp = models["full"]
    jmq, jpq, tmq, tpq = models["int8"]
    kw = ENGINES[path]
    ref = _serve(JEngine, JKnobs, JRequest, (jm, jp), (jmq, jpq),
                 swap_after=swap_after, **kw)
    got = _serve(Engine, EngineKnobs, Request, (tm, tp), (tmq, tpq),
                 swap_after=swap_after, **kw)
    assert got == ref
    assert got["completed"] == 8 and got["variant_swaps"] == 1
    assert got["variant"] == "int8"
    assert got["in_flight_at_swap"] > 0
    assert got["preemptions"] >= got["in_flight_at_swap"]


def test_set_variant_rejects_before_preempting():
    """At shards 2 a variant whose kv heads do not divide is refused with
    the reference's message, before any in-flight request is preempted;
    the active name is a no-op and an unknown name a KeyError."""
    cfg = get_config("llama2-7b").smoke_config()
    eng = EngineSpec(cfg, shards=2, max_seq=64, n_slots=2, block_size=8,
                     n_blocks=8).build(device="cpu")
    odd = cfg.replace(n_kv_heads=1)
    eng.add_variant("odd", build_model(odd, local_plan(), device="cpu"), None)
    eng.submit(Request(prompt=[3, 7, 11], max_new_tokens=8))
    eng.step()
    assert len(eng.active) == 1
    with pytest.raises(ValueError) as err:
        eng.set_variant("odd")
    assert str(err.value) == ("set_variant('odd') at shard degree 2: "
                              "llama2-7b: n_kv_heads=1 is not divisible by "
                              "shard degree 2")
    assert len(eng.active) == 1 and eng.stats.preemptions == 0
    assert eng.stats.variant_swaps == 0 and eng.knobs.variant == "full"
    assert not eng.variant_compatible("odd")
    assert eng.variant_compatible("full") and not eng.variant_compatible("x")
    assert eng.can_shard(2) == ("variant 'odd': llama2-7b: n_kv_heads=1 is "
                                "not divisible by shard degree 2")
    eng.set_variant("full")
    assert eng.stats.variant_swaps == 0 and len(eng.active) == 1
    with pytest.raises(KeyError):
        eng.set_variant("missing")


def test_params_follow_the_active_variant(models):
    _, _, tm, tp = models["full"]
    _, _, tmq, tpq = models["int8"]
    eng = Engine(tm, tp, max_seq=64, n_slots=2, block_size=8)
    eng.add_variant("int8", tmq, tpq)
    assert eng.params is tp and eng.variants["full"] == (tm, tp)
    pool = eng.pool
    eng.set_variant("int8")
    assert eng.params is tpq and eng.model is tmq
    assert eng.pool is not pool                         # rebuilt for it
    new = {"replaced": True}
    eng.params = new
    assert eng.variants["int8"] == (tmq, new)


def test_engine_spec_builds_variants():
    """``EngineSpec.variants`` are built under the spec's plan, the i-th
    from seed ``seed + 10 + i``, registered under their names as in the
    reference."""
    cfg = get_config(ARCH).smoke_config()
    small = get_config("llama2-7b").smoke_config()
    spec = EngineSpec(cfg, max_seq=64, n_slots=2, block_size=8, seed=3,
                      variants=(("small", small), ("twin", cfg)))
    eng = spec.build(device="cpu")
    jeng = JSpec(j_get_config(ARCH).smoke_config(), max_seq=64, n_slots=2,
                 block_size=8, seed=3,
                 variants=(("small", j_get_config("llama2-7b")
                            .smoke_config()),
                           ("twin", j_get_config(ARCH).smoke_config())))\
        .build()
    assert list(eng.variants) == list(jeng.variants) == \
        ["full", "small", "twin"]
    for i, (name, vcfg) in enumerate(spec.variants):
        m, p = eng.variants[name]
        assert m.cfg == vcfg and m.plan == spec.plan()
        want = build_model(vcfg, spec.plan(), device="cpu").init(
            torch.Generator().manual_seed(3 + 10 + i))
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree.leaves(p), jax.tree.leaves(want)))
    bad = get_config("llama2-7b").smoke_config().replace(n_kv_heads=1)
    with pytest.raises(ValueError, match="'bad'"):
        EngineSpec(small, shards=2, variants=(("bad", bad),)).validate()


def test_serve_cli_prints_reference_dict():
    argv = ["--arch", ARCH, "--smoke", "--requests", "6", "--max-new", "6"]
    ref = j_serve.main(argv)
    got = t_serve.main(argv + ["--device", "cpu"])
    assert got == ref and got["mode"] == "paged"
