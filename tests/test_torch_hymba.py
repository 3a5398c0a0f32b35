"""The hybrid family (hymba-1.5b: sliding-window attention beside Mamba)
through the slot pool, the port against the live JAX reference on the CPU:
kernel 1's window form in its plain version (the ``kernels/ref.py`` oracle
and the Pallas kernel in interpret mode), the windowed prefill attention
against the reference's ``swa_attention`` in each of its three branches,
the ring cache that prefill writes and the ring decode (``_swa_decode``),
Mamba (``_causal_conv``, ``mamba_forward``, ``mamba_decode``), the model
(``init``, ``logits``, ``prefill``, ``decode_step``, ``init_cache``),
``CachePool`` on the hybrid tree, the slot ``Engine`` and the serve CLI.

Tolerances: layers 1e-6 (Mamba's scan at the bound stated there), plain
kernels 1e-5, model logits 1e-4, over the f32 plan with weights carried
over from a JAX ``Model.init`` tree (``from_jax_params``); engine streams
and counters exact.  The smoke config has window 16 and state 4."""
import torch_threads  # noqa: F401  (one torch thread a worker)
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
from repro.models import ssm as JS  # noqa: E402
from repro.serving import CachePool as JCachePool  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import EngineSpec as JEngineSpec  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import decode_attention as dense_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serving import (CachePool, Engine, EngineKnobs,  # noqa: E402
                                 EngineSpec, Request)

ARCH = "hymba-1.5b"


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    """A torch copy: a JAX CPU array may share an aligned numpy buffer, and
    the port writes caches and state in place."""
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0.0)


def _close_scaled(got, want, tol):
    """Within ``tol`` of the output's scale, max(1, max |want|): a layer
    whose outputs reach a few units is held to the same number of f32 ulps
    as one whose outputs stay below 1."""
    _close(got, want, tol * max(1.0, float(np.abs(_np(want)).max())))


def _layer(tree, i):
    """Layer ``i`` of a layer-stacked tree (JAX or torch leaves)."""
    return jax.tree.map(lambda a: a[i], tree)


def _dtypes(tree):
    return jax.tree.map(lambda a: str(a.dtype).replace("torch.", ""), tree)


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config(ARCH).smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# config, init, weights
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    t, j = get_config(ARCH), j_get_config(ARCH)
    assert t.__dict__ == j.__dict__
    assert t.param_count() == j.param_count()
    s = t.smoke_config()
    assert s.__dict__ == j.smoke_config().__dict__
    assert (s.window, s.ssm_state, s.d_inner) == (16, 4, 128)
    assert (t.window, t.d_inner, TS._dt_rank(t)) == (1024, 3200, 100)


def test_port_init_builds_reference_tree(models):
    """Same keys, shapes and dtypes, and the constant Mamba leaves hold the
    reference's values (``dt_bias`` -4.6, ``a_log`` log 1..n per row,
    ``d_skip`` 1)."""
    _, jp, tm, tp = models
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)
    assert shapes(own) == shapes(jp) == shapes(tp)
    mamba, jmamba = own["layers"]["mamba"], jp["layers"]["mamba"]
    for name in ("dt_bias", "a_log", "d_skip"):
        np.testing.assert_array_equal(_np(mamba[name]), _np(jmamba[name]))
    assert set(mamba) == {"w_in", "conv_w", "w_bcdt", "w_dt", "dt_bias",
                          "a_log", "d_skip", "w_out"}
    std = float(mamba["conv_w"].std())
    assert 0.08 < std < 0.12                       # N(0, 0.1)


def test_bf16_tree_carries_over_by_copy():
    """``from_jax_params`` on a bf16 hybrid tree: every leaf, each Mamba
    leaf included (``a_log`` and ``dt_bias`` in the param dtype), keeps its
    shape, dtype and bits."""
    jm = j_build_model(j_get_config(ARCH).smoke_config(),
                       j_local_plan(param_dtype=jnp.bfloat16))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tp = from_jax_params(jp, device="cpu")
    assert set(tp["layers"]["mamba"]) == set(jp["layers"]["mamba"])
    for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert j.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16))


# ---------------------------------------------------------------------------
# kernel 1's window form (plain version)
# ---------------------------------------------------------------------------

WINDOWS = [1, 16, 33, 64, 256, 1000]      # 256 = S; 1000 > S


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("S", [256, 200])
def test_windowed_flash_plain_matches_ref_oracle(S, window):
    rng = np.random.default_rng(window + S)
    q, k, v = _arr(rng, 1, 4, S, 32), _arr(rng, 1, 2, S, 32), \
        _arr(rng, 1, 2, S, 32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_flash_plain_matches_interpret_kernel(window):
    """Against the Pallas kernel in interpret mode, over 64 x 64 tiles (as
    ``tests/test_kernels.py`` runs it), GQA H=4 over K=2."""
    rng = np.random.default_rng(window)
    q, k, v = _arr(rng, 2, 4, 256, 32), _arr(rng, 2, 2, 256, 32), \
        _arr(rng, 2, 2, 256, 32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window, block_q=64,
                                block_k=64, interpret=True)
    _close(got, want, 1e-5)


def test_window_at_or_past_s_is_causal_and_negative_is_refused():
    rng = np.random.default_rng(3)
    q, k, v = (_t(_arr(rng, 1, 2, 40, 16)) for _ in range(3))
    causal = ops.flash_attention(q, k, v)
    for w in (40, 41, 10_000):
        assert torch.equal(ops.flash_attention(q, k, v, window=w), causal)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=-1)
    assert flash_mod.flash_attention.launches == 0
    assert flash_mod.flash_attention.banded == 0


def test_window_keeps_bf16_rounding_of_normalised_p():
    """bf16 inputs: the plain version rounds the normalised P to bf16
    before PV, as the reference's ``_attn_block`` does."""
    rng = np.random.default_rng(4)
    q, k, v = (_t(_arr(rng, 1, 2, 48, 16)).bfloat16() for _ in range(3))
    got = flash_mod.flash_attention_ref(q, k, v, window=16)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / 4.0
    i = torch.arange(48)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 16)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    want = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


# ---------------------------------------------------------------------------
# windowed prefill attention, the ring cache and the ring decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,window", [(12, 16), (16, 16), (100, 16),
                                      (300, 64), (2176, 16)],
                         ids=["causal_short", "causal_equal", "masked_block",
                              "masked_block_w64", "chunked_gather"])
def test_prefill_attention_matches_each_swa_branch(models, S, window):
    """``ops.flash_attention(..., window=W)`` against the reference's
    ``swa_attention``: plain causal (S <= W), one masked block (S <= 2048)
    and the chunked gather (S > 2048, chunks of 128), on the model's
    (B, S, H, D) activations passed as (B, H, S, D) views."""
    jm = models[0]
    rng = np.random.default_rng(S)
    B, H, K, D = 1, 2, 1, 16
    q, k, v = _arr(rng, B, S, H, D), _arr(rng, B, S, K, D), \
        _arr(rng, B, S, K, D)
    want = JA.swa_attention(jnp.asarray(q), jnp.repeat(k, H // K, axis=2),
                            jnp.repeat(v, H // K, axis=2), window=window,
                            scale=0.25, plan=jm.plan, cfg=jm.cfg)
    got = ops.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                              _t(v).transpose(1, 2), scale=0.25,
                              window=window)
    _close(got.transpose(1, 2), want, 1e-5)


@pytest.mark.parametrize("S", [5, 16, 23, 40])
def test_ring_layout_matches_reference(S):
    """Slot p % W holds position p for p in [S - W, S), W = min(16, S),
    exactly as the reference's scatter places it."""
    x = np.arange(2 * S * 3, dtype=np.float32).reshape(2, S, 3, 1)
    W = min(16, S)
    slot = jnp.arange(S - W, S) % W
    want = jnp.zeros((2, W, 3, 1)).at[:, slot].set(jnp.asarray(x)[:, S - W:])
    got = TA._ring(_t(x), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", [9, 16, 37])
def test_gqa_forward_matches_reference_with_ring_cache(models, S):
    """One hybrid attention layer's prefill: output and the ring cache it
    writes, for S below, at and above the window, at 1e-6 of their scale
    (outputs reach ~3)."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(30 + S)
    x = _arr(rng, 2, S, tm.cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    ref, jc = JA.gqa_forward(_layer(jp["layers"]["attn"], 1), jnp.asarray(x),
                             jnp.asarray(pos), jm.cfg, jm.plan,
                             want_cache=True)
    got, tc = TA.gqa_forward(_layer(tp["layers"]["attn"], 1), _t(x),
                             _t(pos), tm.cfg, tm.plan, want_cache=True)
    _close_scaled(got, ref, 1e-6)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape \
            == (2, min(16, S), 2, 16)
        _close_scaled(tc[name], jc[name], 1e-6)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_swa_decode_matches_reference(models, cache_dtype):
    """The ring branch of ``gqa_decode`` (plain path) against the
    reference's, reached through ``gqa_decode``: positions below the ring
    width, past it and parked at 0, three steps in place.  Over the f32
    ring: output 1e-6, ring 1e-6.  Over the bf16 ring the new K/V round to
    bf16 in both, and a value within f32 rounding of a bf16 boundary may
    round either way (one bf16 step); P and o are rounded to bf16 as the
    reference rounds them, so a one-step flip of one term moves the
    output by up to ~1e-3 of its scale."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    bf16 = cache_dtype == "bfloat16"
    rng = np.random.default_rng(40)
    B, W = 4, 16
    ring = {n: _arr(rng, B, W, cfg.n_kv_heads, cfg.head_dim)
            for n in ("k", "v")}
    jcache = {n: jnp.asarray(a, getattr(jnp, cache_dtype))
              for n, a in ring.items()}
    tcache = {n: _t(a).to(getattr(torch, cache_dtype))
              for n, a in ring.items()}
    ptrs = {n: t.data_ptr() for n, t in tcache.items()}
    jlp, tlp = _layer(jp["layers"]["attn"], 0), _layer(tp["layers"]["attn"], 0)
    pos = np.asarray([9, 0, 30, 15], np.int32)
    for step in range(3):
        x = _arr(rng, B, cfg.d_model)
        ref, jcache = JA.gqa_decode(jlp, jnp.asarray(x), jcache,
                                    jnp.asarray(pos + step), jm.cfg, jm.plan)
        got, out = TA.gqa_decode(tlp, _t(x), tcache, _t(pos + step), cfg,
                                 tm.plan)
        assert out is tcache
        scale = np.abs(np.asarray(ref)).max()
        _close(got, ref, 2e-3 * scale if bf16 else 1e-6)
    for name in ("k", "v"):
        assert tcache[name].data_ptr() == ptrs[name]
        got, want = _np(tcache[name]), _np(jcache[name])
        step = 2.0 ** -7 * np.abs(want)           # one bf16 step
        assert (np.abs(got - want) <= (step if bf16 else 1e-6)).all()


def test_swa_decode_ref_is_the_reference_ring_mask():
    """``swa_decode_ref`` with positions clamped to the ring's last slot is
    the reference's ``_swa_decode`` mask, ``slot <= pos or pos >= W``,
    and rounds P and o to the cache's dtype."""
    rng = np.random.default_rng(41)
    B, H, K, W, D = 4, 4, 2, 16, 16
    q = _arr(rng, B, H, D)
    k, v = (_t(_arr(rng, B, W, K, D)).bfloat16() for _ in range(2))
    pos = np.asarray([3, 15, 16, 200], np.int32)
    got = dense_mod.swa_decode_ref(_t(q), k, v,
                                   _t(pos).clamp(max=W - 1))
    ke, ve = (t.repeat_interleave(H // K, dim=2).float() for t in (k, v))
    s = torch.einsum("bhd,bshd->bhs", _t(q), ke) * 0.25
    valid = (torch.arange(W)[None, :] <= _t(pos)[:, None]) \
        | (_t(pos)[:, None] >= W)
    p = torch.softmax(torch.where(valid[:, None], s, -1e30), dim=-1)
    want = torch.einsum("bhs,bshd->bhd", p.bfloat16().float(), ve)
    assert torch.equal(got, want.bfloat16().float())


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba_state(rng, cfg, B, conv_dtype="float32"):
    """A random Mamba state, as (JAX tree, torch tree)."""
    s = {"conv": _arr(rng, B, cfg.conv_width - 1, cfg.d_inner),
         "ssm": _arr(rng, B, cfg.d_inner, cfg.ssm_state)}
    j = {"conv": jnp.asarray(s["conv"], getattr(jnp, conv_dtype)),
         "ssm": jnp.asarray(s["ssm"])}
    t = {"conv": _t(s["conv"]).to(getattr(torch, conv_dtype)),
         "ssm": _t(s["ssm"])}
    return j, t


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_reference(with_prev):
    rng = np.random.default_rng(50)
    x, w = _arr(rng, 2, 11, 32), _arr(rng, 4, 32)
    prev = _arr(rng, 2, 3, 32) if with_prev else None
    y, tail = TS._causal_conv(_t(x), _t(w), None if prev is None else _t(prev))
    jy, jtail = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if prev is None else jnp.asarray(prev))
    _close(y, jy, 1e-6)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


# The reference's chunk (256, halved until it divides S): one step at S =
# 13 (prime, 13 chunks), 64 (one chunk), 4 at S = 300 (75 chunks); the
# port runs one doubling scan at every S.
@pytest.mark.parametrize("S", [1, 13, 64, 300])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_forward_matches_reference(models, S, with_state):
    """Output and new state, from a zero and from a random state.  The
    scan sums the same recurrence in another order (a doubling scan over
    the whole sequence against the reference's chunked associative scan):
    1e-6 of the outputs' scale."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(51 + S)
    jst, tst = _mamba_state(rng, tm.cfg, 2)
    x = _arr(rng, 2, S, tm.cfg.d_model)
    ref, jnew = JS.mamba_forward(_layer(jp["layers"]["mamba"], 1),
                                 jnp.asarray(x), jm.cfg, jm.plan,
                                 jst if with_state else None)
    got, tnew = TS.mamba_forward(_layer(tp["layers"]["mamba"], 1), _t(x),
                                 tm.cfg, tm.plan, tst if with_state else None)
    _close_scaled(got, ref, 1e-6)
    for name in ("conv", "ssm"):
        assert tuple(tnew[name].shape) == jnew[name].shape
        _close_scaled(tnew[name], jnew[name], 1e-6)


def test_mamba_decode_in_place_matches_reference(models):
    """Three decode steps, the state written into the given tree."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(52)
    jst, tst = _mamba_state(rng, tm.cfg, 3)
    ptrs = {n: t.data_ptr() for n, t in tst.items()}
    jlp, tlp = _layer(jp["layers"]["mamba"], 0), _layer(tp["layers"]["mamba"], 0)
    for _ in range(3):
        x = _arr(rng, 3, tm.cfg.d_model)
        ref, jst = JS.mamba_decode(jlp, jnp.asarray(x), jst, jm.cfg, jm.plan)
        got, new = TS.mamba_decode(tlp, _t(x), tst, tm.cfg, tm.plan,
                                   out_state=tst)
        _close_scaled(got, ref, 1e-6)
        for name in ("conv", "ssm"):
            assert new[name] is tst[name]
            assert tst[name].data_ptr() == ptrs[name]
            _close_scaled(tst[name], jst[name], 1e-6)


def test_mamba_state_dtypes_follow_reference(models):
    """An f32 plan over a bf16 pool: the new conv state comes back in f32
    (the reference concatenates the bf16 context with f32 activations), the
    SSM state in f32; under a bf16 plan both conv dtypes stay bf16."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(53)
    jst, tst = _mamba_state(rng, tm.cfg, 2, conv_dtype="bfloat16")
    x = _arr(rng, 2, tm.cfg.d_model)
    _, jnew = JS.mamba_decode(_layer(jp["layers"]["mamba"], 0),
                              jnp.asarray(x), jst, jm.cfg, jm.plan)
    _, tnew = TS.mamba_decode(_layer(tp["layers"]["mamba"], 0), _t(x), tst,
                              tm.cfg, tm.plan)
    assert _dtypes(tnew) == _dtypes(jnew) == {"conv": "float32",
                                              "ssm": "float32"}
    jplan = j_local_plan(param_dtype=jnp.bfloat16)
    tplan = local_plan(param_dtype=torch.bfloat16)
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                       _layer(jp["layers"]["mamba"], 0))
    tpb = {n: t.bfloat16() for n, t in _layer(tp["layers"]["mamba"], 0).items()}
    _, jnew = JS.mamba_decode(jpb, jnp.asarray(x, jnp.bfloat16), jst, jm.cfg,
                              jplan)
    _, tnew = TS.mamba_decode(tpb, _t(x).bfloat16(), tst, tm.cfg, tplan)
    assert _dtypes(tnew) == _dtypes(jnew) == {"conv": "bfloat16",
                                              "ssm": "float32"}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [12, 40])
def test_logits_and_prefill_match_reference(models, S):
    """f32 plan: full-sequence logits, last-token logits and every leaf of
    the prefill cache (the ring and the Mamba state, stacked on L), for a
    prompt inside the window and one past it."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(60 + S)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, S)).astype(np.int32)
    _close(tm.logits(tp, _t(toks)), jm.logits(jp, jnp.asarray(toks)), 1e-4)
    lj, cj = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
    lt, ct = tm.prefill(tp, _t(toks))
    _close(lt, lj, 1e-4)
    assert set(ct) == {"attn", "mamba"}
    assert tuple(ct["attn"]["k"].shape) == cj["attn"]["k"].shape \
        == (2, 2, min(16, S), 2, 16)
    for got, want in zip(jax.tree.leaves(ct), jax.tree.leaves(cj)):
        assert tuple(got.shape) == want.shape
        _close(got, want, 1e-4)


def test_init_cache_matches_reference(models):
    jm, _, tm, _ = models
    for seq in (40, 9):
        jc = jm.init_cache(3, seq)
        tc = tm.init_cache(3, seq, device="cpu")
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc)
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).replace("torch.", "")), tc)
        assert got == want
        assert not any(t.any() for t in jax.tree.leaves(tc))


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(models, pool_dtype):
    """Three decode steps over a random pool (ring of 16, positions below,
    past and across the wrap, a parked slot at 0), in place.  Logits at
    1e-4 over the f32 pool; over the bf16 pool the new K/V round to bf16
    in both, where a value within f32 rounding of a boundary may round
    either way (one bf16 step): rows at 1e-3, the median at 1e-4.  The
    reference's step returns the Mamba conv state in f32 under this f32
    plan, so the pool's conv leaf is f32 after the first step in both."""
    jm, jp, tm, tp = models
    cfg, B = tm.cfg, 4
    bf16 = pool_dtype == "bfloat16"
    rng = np.random.default_rng(70)
    L = cfg.num_layers
    dt = getattr(jnp, pool_dtype)
    ring = {n: _arr(rng, L, B, 16, cfg.n_kv_heads, cfg.head_dim)
            for n in ("k", "v")}
    conv = _arr(rng, L, B, cfg.conv_width - 1, cfg.d_inner)
    ssm = _arr(rng, L, B, cfg.d_inner, cfg.ssm_state)
    jcache = {"attn": {n: jnp.asarray(a, dt) for n, a in ring.items()},
              "mamba": {"conv": jnp.asarray(conv, dt),
                        "ssm": jnp.asarray(ssm)}}
    tdt = getattr(torch, pool_dtype)
    tcache = {"attn": {n: _t(a).to(tdt) for n, a in ring.items()},
              "mamba": {"conv": _t(conv).to(tdt), "ssm": _t(ssm)}}
    ring_ptr = tcache["attn"]["k"].data_ptr()
    pos = np.asarray([9, 0, 30, 14], np.int32)
    step = jax.jit(jm.decode_step)
    for i in range(3):
        tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        lj, jcache = step(jp, jcache, jnp.asarray(tokens),
                          jnp.asarray(pos + i))
        lt, out = tm.decode_step(tp, tcache, _t(tokens), _t(pos + i))
        assert out is tcache
        row_err = np.abs(lt.numpy() - np.asarray(lj)).max(axis=1)
        assert row_err.max() <= (1e-3 if bf16 else 1e-4), row_err
        assert np.median(row_err) <= 1e-4, row_err
        assert _dtypes(tcache) == _dtypes(jcache)
    assert tcache["mamba"]["conv"].dtype == torch.float32
    assert tcache["attn"]["k"].dtype == tdt
    assert tcache["attn"]["k"].data_ptr() == ring_ptr    # written in place
    _close(tcache["mamba"]["ssm"], jcache["mamba"]["ssm"], 1e-4)


@pytest.mark.parametrize("head,total", [(9, 30), (20, 36)])
def test_prefill_then_decode_equals_longer_prefill(models, head, total):
    """Prefill of the head, inserted into a slot pool (ring of 16), then one
    decode step per remaining token past the window's wrap gives the last
    logits of a prefill of the whole prompt, and its Mamba state."""
    _, _, tm, tp = models
    rng = np.random.default_rng(80 + head)
    prompt = _t(rng.integers(0, tm.cfg.vocab_size, (1, total))
                .astype(np.int32))
    want_logits, want_cache = tm.prefill(tp, prompt)
    pool = CachePool(tm, n_slots=2, max_seq=64)
    pool.cache = tm.init_cache(2, 64, dtype=torch.float32, device="cpu")
    _, cache = tm.prefill(tp, prompt[:, :head])
    slot = pool.insert(0, cache, head)
    for t in range(head, total):
        tokens = torch.zeros(2, dtype=torch.int32)
        tokens[slot] = prompt[0, t]
        logits, _ = tm.decode_step(tp, pool.cache, tokens, pool.positions())
        pool.advance([slot])
    _close(logits[slot], want_logits[0], 1e-4)
    _close(pool.cache["mamba"]["ssm"][:, slot],
           want_cache["mamba"]["ssm"][:, 0], 1e-4)


# ---------------------------------------------------------------------------
# CachePool on the hybrid tree
# ---------------------------------------------------------------------------

def test_cache_pool_holds_hybrid_caches_like_reference(models):
    """Inserts of single-request prefill caches: a ring from a prompt
    shorter than the window is a prefix insert, a full ring and each Mamba
    leaf fill the whole slot; f32 leaves are cast into the bf16 pool
    (the SSM state stays f32).  The same slots, lengths and contents as
    the reference pool."""
    jm, _, tm, _ = models
    jpool = JCachePool(jm, n_slots=3, max_seq=32)
    tpool = CachePool(tm, n_slots=3, max_seq=32)
    rng = np.random.default_rng(90)
    cfg, L = tm.cfg, tm.cfg.num_layers

    def prefill(n):
        W = min(16, n)
        c = {"attn": {name: _arr(rng, L, 1, W, cfg.n_kv_heads, cfg.head_dim)
                      for name in ("k", "v")},
             "mamba": {"conv": _arr(rng, L, 1, cfg.conv_width - 1,
                                    cfg.d_inner),
                       "ssm": _arr(rng, L, 1, cfg.d_inner, cfg.ssm_state)}}
        return jax.tree.map(jnp.asarray, c), jax.tree.map(_t, c)

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
    assert _dtypes(tpool.cache) == _dtypes(jpool.cache)
    assert tpool.cache["mamba"]["ssm"].dtype == torch.float32
    for got, want in zip(jax.tree.leaves(tpool.cache),
                         jax.tree.leaves(jpool.cache)):
        np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# the slot engine and the CLI
# ---------------------------------------------------------------------------

STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")


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


def _load(vocab, lengths, max_new, seed):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, vocab, n)], max_new)
            for n in lengths]


# Workloads: prompts shorter and longer than the window of 16, every
# request decoding past its ring's wrap; four prompt lengths each (each
# distinct length compiles the reference's prefill once).  Checked free of
# near-ties: along every reference stream the top-2 margin of the f32
# full-sequence logits (whose argmax is the stream's token at every step)
# stays at or above 1.1e-3, against ~1e-6 of drift between the two f32
# paths over the bf16 pool.
@pytest.mark.parametrize("lengths,max_new,n_slots,max_seq,seed", [
    ((5, 20, 12, 30, 20), 14, 3, 64, 0),   # 5 requests through 3 slots
    ((12, 30, 30, 5), 20, 2, 40, 1),       # contexts that reach max_seq
    ((17, 9, 26, 9, 17), 12, 4, 48, 2),
])
def test_slot_engine_matches_reference(models, lengths, max_new, n_slots,
                                       max_seq, seed):
    jm, jp, tm, tp = models
    load = _load(tm.cfg.vocab_size, lengths, max_new, seed)
    kw = dict(n_slots=n_slots, max_seq=max_seq)
    ref = _serve(JEngine, JKnobs, JRequest, jm, jp, load, paged=None, **kw)
    got = _serve(Engine, EngineKnobs, Request, tm, tp, load, paged=None, **kw)
    assert got == ref
    assert got["completed"] == len(lengths)
    assert got["prefill_batches"] == len(lengths)
    assert got["preemptions"] == 0
    assert all(len(p) + len(s) > 16 for (p, _), s in zip(load,
                                                          got["streams"]))


def test_paged_hybrid_raises_as_reference(models):
    jm, jp, tm, tp = models
    with pytest.raises(ValueError) as ref:
        JEngine(jm, jp, n_slots=2, max_seq=32, paged=True)
    with pytest.raises(ValueError) as got:
        Engine(tm, tp, n_slots=2, max_seq=32, paged=True)
    assert str(got.value) == str(ref.value)
    assert not tm.supports_paged and not jm.supports_paged


def test_engine_spec_build_raises_as_reference():
    """``EngineSpec`` builds a paged engine (``paged=True``), in the
    reference as here, so a hybrid spec validates and its ``build`` raises
    the reference's ValueError: the slot pool is reached through
    ``Engine(..., paged=None)``."""
    kw = dict(max_seq=48, n_slots=2, max_batch=2)
    spec = EngineSpec(get_config(ARCH).smoke_config(), **kw)
    spec.validate()
    with pytest.raises(ValueError) as ref:
        JEngineSpec(j_get_config(ARCH).smoke_config(), **kw).build()
    with pytest.raises(ValueError) as got:
        spec.build(device="cpu")
    assert str(got.value) == str(ref.value)


def test_serve_cli_hymba_prints_reference_dict():
    argv = ["--arch", ARCH, "--smoke", "--requests", "4", "--max-new", "6"]
    ref = j_serve.main(argv)
    got = t_serve.main(argv + ["--device", "cpu"])
    assert got == ref and got["mode"] == "slots"
    assert got == {"mode": "slots", "completed": 4, "decode_tokens": 20,
                   "prefill_tokens": 73, "prefill_batches": 4,
                   "preemptions": 0, "goodput_tok_per_step": 6.0}
    with pytest.raises(ValueError, match="cannot serve paged"):
        t_serve.main(argv + ["--paged", "--device", "cpu"])
