"""The slot pool, the port against the live JAX reference on the CPU:
kernel 5's two plain versions (the ``kernels/ref.py`` oracle and the slot
model path's ``_flash_decode_core`` mirror), the model functions that call
it (``gqa_decode``, ``Model.decode_step``, ``Model.init_cache``),
``CachePool`` and the slot ``Engine``, and the serve CLI's ``--no-paged``.

Kernel shapes: GQA, MHA and MQA, head dim 32/64/128; f32 at atol 1e-5 (the
reference's own kernel tolerance).  Model functions run an f32 plan with
weights carried over from a JAX ``Model.init`` tree (``from_jax_params``):
logits at 1e-4 over an f32 cache; over the bf16 cache the engine keeps,
within the bound each test states and explains.  Engines (f32 plan, bf16
cache) must give the same greedy streams token for token and the same
counters."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.serving import CachePool as JCachePool  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_ref, flash_decode_ref)
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import CachePool, Engine, EngineKnobs, Request  # noqa: E402

ATOL = 1e-5


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """numpy f32 -> (torch bf16, jax bf16) holding the same values."""
    t = _t(a).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# kernel 5's plain versions
# ---------------------------------------------------------------------------

DENSE_SHAPES = [
    (2, 8, 2, 64, 64),      # GQA 4:1
    (1, 4, 4, 128, 96),     # MHA, head dim 128
    (3, 4, 1, 32, 40),      # MQA, S not a multiple of a 32-key tile
    (2, 8, 8, 32, 128),     # MHA, head dim 32
]


def _dense_inputs(rng, B, H, K, D, S):
    q, k, v = _arr(rng, B, H, D), _arr(rng, B, S, K, D), _arr(rng, B, S, K, D)
    pos = rng.integers(0, S, B).astype(np.int32)
    pos[0] = S - 1                                   # the whole cache
    return q, k, v, pos


@pytest.mark.parametrize("plain", [decode_attention_ref, flash_decode_ref],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("B,H,K,D,S", DENSE_SHAPES)
def test_dense_decode_plains_match_ref_oracle(plain, B, H, K, D, S):
    rng = np.random.default_rng(B * 100 + S)
    q, k, v, pos = _dense_inputs(rng, B, H, K, D, S)
    o = plain(*map(_t, (q, k, v, pos)))
    o_ref = jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, pos)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


@pytest.mark.parametrize("B,H,K,D,S", DENSE_SHAPES)
def test_dense_decode_plain_matches_interpret_kernel(B, H, K, D, S):
    """The Pallas kernel in interpret mode over 8-key blocks, so blocks
    past the position are skipped as on the TPU."""
    rng = np.random.default_rng(B * 100 + S + 1)
    q, k, v, pos = _dense_inputs(rng, B, H, K, D, S)
    o = ops.decode_attention(*map(_t, (q, k, v, pos)))
    o_ref = jops.decode_attention(*map(jnp.asarray, (q, k, v, pos)),
                                  block_k=8, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


@pytest.mark.parametrize("cache_bf16", [False, True])
def test_flash_decode_plain_matches_reference_model(cache_bf16):
    """Held to the reference model's ``_flash_decode_core`` on one device
    (the XLA path the kernel replaces on the slot path): it writes the new
    token's KV, then rounds the unnormalised exp(s - m) to the cache's
    dtype.  Over an f32 cache: 1e-5.  Over a bf16 cache the frameworks'
    f32 exponentials differ in the last bit now and then, and a value on
    the other side of a bf16 rounding boundary moves its head's output by
    one bf16 step of p times |v|, hence 1e-3 for those rows and 1e-5 for
    the rest."""
    rng = np.random.default_rng(31)
    B, H, K, D, S = 4, 8, 2, 64, 80
    q, k, v, pos = _dense_inputs(rng, B, H, K, D, S)
    k_new, v_new = _arr(rng, B, K, D), _arr(rng, B, K, D)
    if cache_bf16:
        (_, jk), (_, jv) = _bf16(k), _bf16(v)
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
    cfg = j_get_config("llama2-7b").smoke_config().replace(n_heads=H,
                                                           n_kv_heads=K)
    o_ref, jk2, jv2 = JA._flash_decode_core(
        None, jnp.asarray(q), jk, jv, jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(pos), JA.kv_index(cfg, H), 1 / math.sqrt(D))
    tk, tv = (_t(_np(a)) for a in (jk2, jv2))
    if cache_bf16:
        tk, tv = tk.bfloat16(), tv.bfloat16()
    o = ops.decode_attention(_t(q), tk, tv, _t(pos), scale=1 / math.sqrt(D))
    assert o.dtype == torch.float32
    err = np.abs(o.numpy() - np.asarray(o_ref))
    assert err.max() <= (1e-3 if cache_bf16 else ATOL)
    assert (err > ATOL).mean() <= 0.02


def test_paged_decode_equals_dense_decode():
    """Paged decode through a table equals dense decode over the same
    logical cache (``tests/test_paged.py:45``), both plain, at f32."""
    rng = np.random.default_rng(8)
    B, H, K, D, bs, T = 3, 8, 2, 32, 8, 6
    q, k, v, pos = _dense_inputs(rng, B, H, K, D, T * bs)
    perm = rng.permutation(np.arange(1, 1 + B * T)).reshape(B, T)
    kp = np.zeros((1 + B * T, bs, K, D), np.float32)
    vp = np.zeros_like(kp)
    kp[perm] = k.reshape(B, T, bs, K, D)
    vp[perm] = v.reshape(B, T, bs, K, D)
    o_dense = ops.decode_attention(*map(_t, (q, k, v, pos)))
    o_paged = ops.paged_decode_attention(
        *map(_t, (q, kp, vp, perm.astype(np.int32), pos)))
    np.testing.assert_allclose(o_paged.numpy(), o_dense.numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("llama2-7b").smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("llama2-7b").smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_init_cache_matches_reference(models):
    jm, _, tm, _ = models
    jc = jm.init_cache(3, 40)
    tc = tm.init_cache(3, 40, device="cpu")
    for name in ("k", "v"):
        assert tuple(tc["attn"][name].shape) == jc["attn"][name].shape
        assert tc["attn"][name].dtype == torch.bfloat16
        assert not tc["attn"][name].any()
    assert set(tc) == set(jc) and set(tc["attn"]) == set(jc["attn"])


def test_gqa_decode_matches_reference(models):
    """Same output and cache: the new token's KV lands at each row's
    position (0 and S-1 included), every other entry is untouched."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rng = np.random.default_rng(9)
    B, S = 4, 24
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    (tk, jk), (tv, jv) = _bf16(_arr(rng, *shape)), _bf16(_arr(rng, *shape))
    x = _arr(rng, B, cfg.d_model)
    pos = np.asarray([0, S - 1, 7, 13], np.int32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tlp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    o_ref, jc = JA.gqa_decode(jlp, jnp.asarray(x), {"k": jk, "v": jv},
                              jnp.asarray(pos), jm.cfg, jm.plan)
    o, tc = TA.gqa_decode(tlp, _t(x), {"k": tk, "v": tv}, _t(pos), cfg,
                          tm.plan)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(tc[name]), _np(jc[name]))


MLA_CASES = {"fresh": ([0, 0], "float32"), "mid": ([5, 11], "float32"),
             "last": ([15, 15], "float32"), "past": ([3, 16], "float32"),
             "bf16": ([5, 11], "bfloat16")}


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_unported_slot_caches_raise(case):
    """The MLA latent slot cache, once refused, is ported: the slot cache
    holds ``ckv`` and ``kr`` (the reference's shapes and dtype) and the
    slot decode (the reference's ``mla_decode``) writes the new token's
    latent in place, a position past the cache keeping the old row, with
    the reference's output at 1e-5 (its cache rows at 1e-5 over f32,
    within a bf16 step over bf16) from fresh,
    mid, last-slot and past-the-end positions and over a bf16 cache.
    (The SWA ring: tests/test_torch_hymba.py; whole models:
    tests/test_torch_mla.py.)"""
    positions, dtype = MLA_CASES[case]
    jcfg = j_get_config("minicpm3-4b").smoke_config()
    cfg = get_config("minicpm3-4b").smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jlp = jax.tree.map(lambda a: a[0],
                       jm.init(jax.random.PRNGKey(0))["layers"]["attn"])
    tlp = from_jax_params(jax.tree.map(np.asarray, jlp), device="cpu")
    jc, _ = JA.init_attn_cache(jcfg, jm.plan, 2, 16, getattr(jnp, dtype))
    tc = TA.init_attn_cache(cfg, local_plan(), 2, 16, getattr(torch, dtype),
                            device="cpu")
    assert {n: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for n, a in tc.items()} == \
        {n: (tuple(a.shape), str(a.dtype)) for n, a in jc.items()}
    rng = np.random.default_rng(len(case))
    for n in ("ckv", "kr"):
        a = rng.standard_normal(tc[n].shape).astype(np.float32)
        tc[n] = _t(a).to(getattr(torch, dtype))
        jc[n] = jnp.asarray(tc[n].float().numpy()).astype(getattr(jnp, dtype))
    x = _arr(rng, 2, cfg.d_model)
    pos = np.asarray(positions, np.int32)
    plan = local_plan(param_dtype=torch.float32, compute_dtype=torch.float32)
    o_ref, jc = JA.mla_decode(jlp, jnp.asarray(x), jc, jnp.asarray(pos),
                              jcfg, jm.plan)
    before = {n: t.clone() for n, t in tc.items()}
    o, tc2 = TA.gqa_decode(tlp, _t(x), tc, _t(pos), cfg, plan)
    assert tc2 is tc
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL,
                               rtol=0)
    for n in ("ckv", "kr"):
        np.testing.assert_allclose(tc[n].float().numpy(),
                                   np.asarray(jc[n], np.float32),
                                   atol=ATOL if dtype == "float32" else 1e-2,
                                   rtol=0)
        if positions[1] >= 16:                  # past the end: unchanged
            assert torch.equal(tc[n][1], before[n][1])


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(models, cache_dtype):
    """Two slot decode steps over a random cache (a parked slot at
    position 0 among them): the same logits and cache.  Over an f32 cache:
    logits at 1e-4.  Over the bf16 cache a written K or V value within f32
    rounding of a bf16 boundary may round either way (one bf16 step), and
    the rows that read it move by up to 1e-3; the median row stays within
    1e-4."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    bf16 = cache_dtype == "bfloat16"
    rng = np.random.default_rng(10)
    B, S = 4, 32
    shape = (cfg.num_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    cache = {n: _arr(rng, *shape) for n in ("k", "v")}
    jcache = {"attn": {n: jnp.asarray(a, getattr(jnp, cache_dtype))
                       for n, a in cache.items()}}
    tcache = {"attn": {n: _t(a).to(getattr(torch, cache_dtype))
                       for n, a in cache.items()}}
    pos = np.asarray([9, 0, 30, 17], np.int32)
    for step in range(2):
        tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        lj, jcache = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(tokens),
                                             jnp.asarray(pos + step))
        lt, tcache = tm.decode_step(tp, tcache, _t(tokens), _t(pos + step))
        row_err = np.abs(lt.numpy() - np.asarray(lj)).max(axis=1)
        assert row_err.max() <= (1e-3 if bf16 else 1e-4), row_err
        assert np.median(row_err) <= 1e-4, row_err
    for name in ("k", "v"):
        got, want = _np(tcache["attn"][name]), _np(jcache["attn"][name])
        step = 2.0 ** -7 * np.abs(want)           # one bf16 step
        assert (np.abs(got - want) <= (step if bf16 else 1e-5)).all()


# ---------------------------------------------------------------------------
# CachePool
# ---------------------------------------------------------------------------

def test_cache_pool_matches_reference(models):
    """Inserts of single-request prefill caches of several lengths,
    releases and advances: the same slots, lengths, positions and cache
    contents as the reference pool."""
    jm, _, tm, _ = models
    jpool = JCachePool(jm, n_slots=3, max_seq=32)
    tpool = CachePool(tm, n_slots=3, max_seq=32)
    rng = np.random.default_rng(11)
    cfg = tm.cfg

    def prefill(n):
        shape = (cfg.num_layers, 1, n, cfg.n_kv_heads, cfg.head_dim)
        kv = {name: _arr(rng, *shape) for name in ("k", "v")}
        return ({"attn": {k: jnp.asarray(v) for k, v in kv.items()}},
                {"attn": {k: _t(v) for k, v in kv.items()}})

    script = [("insert", 1, 20), ("insert", 2, 7), ("advance",),
              ("release", 1), ("insert", 3, 31), ("advance",),
              ("release", 2), ("insert", 4, 3)]
    for op, *args in script:
        if op == "insert":
            jc, tc = prefill(args[1])
            assert jpool.insert(args[0], jc, args[1]) == \
                tpool.insert(args[0], tc, args[1])
        elif op == "advance":
            slots = list(tpool.slot_of.values())
            jpool.advance(slots)
            tpool.advance(slots)
        else:
            jpool.release(args[0])
            tpool.release(args[0])
        assert tpool.lengths == jpool.lengths
        assert tpool.free == jpool.free and tpool.slot_of == jpool.slot_of
        assert tpool.positions().tolist() == np.asarray(jpool.positions()).tolist()
        assert tpool.has_free() == jpool.has_free()
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(tpool.cache["attn"][name]),
                                      _np(jpool.cache["attn"][name]))


# ---------------------------------------------------------------------------
# the slot engine
# ---------------------------------------------------------------------------

STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")


def _load(vocab, *, n_req, lo, hi, max_new, seed):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, vocab, int(rng.integers(lo, hi)))],
             max_new) for _ in range(n_req)]


def _serve(engine_cls, knobs_cls, req_cls, model, params, load, *, n_slots,
           max_seq, **kw):
    eng = engine_cls(model, params, max_seq=max_seq, n_slots=n_slots,
                     knobs=knobs_cls(max_batch=n_slots), **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=m) for p, m in load]
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    order = {r.req_id: i for i, r in enumerate(reqs)}
    return {
        "streams": [tuple(r.output) for r in reqs],
        "finish_order": [order[r.req_id] for r in stats.completed],
        "completed": len(stats.completed),
        **{k: getattr(stats, k) for k in STATS},
    }


@pytest.mark.parametrize("seed,max_new,horizon,n_slots,max_seq,lo,hi", [
    (0, 6, 1, 3, 64, 4, 20),       # tests/test_paged.py:240's workload
    # its preemption workload's shape (horizon unused by slots); seed 3
    # meets a near-tie at these weights (top-2 logit margin 8e-5 against
    # 2.6e-4 of f32 summation-order drift over the bf16 cache)
    (1, 12, 4, 3, 64, 4, 20),
    (0, 16, 1, 4, 128, 4, 24),     # launch/serve.py's workload
    (5, 40, 1, 2, 48, 4, 20),      # contexts that reach max_seq
])
def test_slot_engine_matches_reference(models, seed, max_new, horizon,
                                       n_slots, max_seq, lo, hi):
    jm, jp, tm, tp = models
    load = _load(tm.cfg.vocab_size, n_req=5, lo=lo, hi=hi, max_new=max_new,
                 seed=seed)
    kw = dict(n_slots=n_slots, max_seq=max_seq, paged=False, horizon=horizon)
    ref = _serve(JEngine, JKnobs, JRequest, jm, jp, load, **kw)
    got = _serve(Engine, EngineKnobs, Request, tm, tp, load, **kw)
    assert got == ref
    assert got["completed"] == 5
    assert got["prefill_batches"] == 5 and got["preemptions"] == 0


def test_slot_and_paged_engines_serve_the_same_streams(models):
    """The port alone (``tests/test_paged.py:263``): slots and the paged
    pool give the same greedy streams; batched admission takes fewer
    prefill launches than one per request."""
    _, _, tm, tp = models
    load = _load(tm.cfg.vocab_size, n_req=5, lo=4, hi=20, max_new=6, seed=0)
    kw = dict(n_slots=3, max_seq=64, block_size=8)
    slots = _serve(Engine, EngineKnobs, Request, tm, tp, load, paged=False,
                   **kw)
    paged = _serve(Engine, EngineKnobs, Request, tm, tp, load, paged=True,
                   **kw)
    assert slots["streams"] == paged["streams"]
    assert paged["prefill_batches"] < slots["prefill_batches"]


def test_serve_cli_no_paged_prints_reference_dict():
    ref = j_serve.main(["--smoke", "--no-paged"])
    got = t_serve.main(["--smoke", "--no-paged", "--device", "cpu"])
    assert got == ref and got["mode"] == "slots"
