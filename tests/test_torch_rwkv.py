"""RWKV6 through the slot pool, the port against the live JAX reference on
the CPU: kernel 7's plain version (the ``kernels/ref.py`` oracle and the
Pallas kernel in interpret mode), the model functions that call it
(``_rwkv_mix``, ``rwkv_tmix_forward``, ``rwkv_cmix_forward``), the model
(``init``, ``logits``, ``prefill``, ``decode_step``, ``init_cache``),
``CachePool`` on the state tree, the slot ``Engine`` and the serve CLI.

Kernel shapes are ``tests/test_kernels.py``'s, at its tolerance (atol =
rtol = 1e-4).  Model functions run an f32 plan with weights carried over
from a JAX ``Model.init`` tree (``from_jax_params``), held at 1e-4; over
the bf16 pool the engine keeps, within the bound each test states.
Engines (f32 plan, bf16 pool) must give the same greedy streams token for
token and the same counters.  Few distinct prompt lengths: each one
compiles the reference's scan anew."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving import CachePool as JCachePool  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv_mod  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serving import CachePool, Engine, EngineKnobs, Request  # noqa: E402

ATOL = 1e-4


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    """A torch copy: a JAX CPU array may share an aligned numpy buffer, and
    the port writes state in place."""
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _tree_close(got, want, atol=ATOL):
    jl, tl = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        _close(t, j, atol)


# ---------------------------------------------------------------------------
# kernel 7's plain version
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, B, T, H, D, lo=0.8, zero_state=False):
    r, k, v = (_arr(rng, B, T, H, D) for _ in range(3))
    w = rng.uniform(lo, 0.999, (B, T, H, D)).astype(np.float32)
    u = _arr(rng, H, D)
    s0 = np.zeros((B, H, D, D), np.float32) if zero_state \
        else _arr(rng, B, H, D, D)
    return r, k, v, w, u, s0


WKV_SHAPES = [(1, 64, 2, 32, 16), (2, 128, 4, 64, 64)]   # test_kernels.py's


@pytest.mark.parametrize("B,T,H,D", [s[:4] for s in WKV_SHAPES]
                         + [(2, 37, 3, 16), (1, 1, 4, 128)],
                         ids=["t64d32", "t128d64", "ragged_t37", "t1d128"])
def test_wkv_plain_matches_ref_oracle(B, T, H, D):
    rng = np.random.default_rng(T)
    args = _wkv_inputs(rng, B, T, H, D)
    y, s = wkv_mod.rwkv6_wkv_ref(*map(_t, args))
    y_ref, s_ref = jref.rwkv6_wkv_ref(*map(jnp.asarray, args))
    _close(y, y_ref, rtol=1e-4)
    _close(s, s_ref, rtol=1e-4)


@pytest.mark.parametrize("B,T,H,D,bt", WKV_SHAPES)
def test_wkv_plain_matches_interpret_kernel(B, T, H, D, bt):
    """``ops.rwkv6_wkv`` on CPU tensors against the Pallas kernel in
    interpret mode, over time blocks of ``bt``."""
    rng = np.random.default_rng(T + 1)
    args = _wkv_inputs(rng, B, T, H, D)
    y, s = ops.rwkv6_wkv(*map(_t, args))
    y_ref, s_ref = jops.rwkv6_wkv(*map(jnp.asarray, args), block_t=bt,
                                  interpret=True)
    _close(y, y_ref, rtol=1e-4)
    _close(s, s_ref, rtol=1e-4)


def test_wkv_state_carries_across_calls():
    """Two calls (T1 = 32, then T2 = 32 from the first's state) equal one
    call (``tests/test_kernels.py:87``); so do a ragged split and 1-step
    calls written over their own state (``s_out = s0``, as decode does)."""
    rng = np.random.default_rng(3)
    r, k, v, w, u, s0 = map(_t, _wkv_inputs(rng, 1, 64, 2, 32, lo=0.9,
                                            zero_state=True))
    y_full, s_full = ops.rwkv6_wkv(r, k, v, w, u, None)
    for cut in (32, 23):
        y1, s1 = ops.rwkv6_wkv(r[:, :cut], k[:, :cut], v[:, :cut],
                               w[:, :cut], u, s0)
        y2, s2 = ops.rwkv6_wkv(r[:, cut:], k[:, cut:], v[:, cut:],
                               w[:, cut:], u, s1)
        _close(torch.cat([y1, y2], 1), y_full)
        _close(s2, s_full)
    state = s0.clone()
    ys = []
    for t in range(8):
        y, s = ops.rwkv6_wkv(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                             w[:, t:t + 1], u, state, s_out=state)
        assert s is state
        ys.append(y)
    y8, s8 = ops.rwkv6_wkv(r[:, :8], k[:, :8], v[:, :8], w[:, :8], u, None)
    _close(torch.cat(ys, 1), y8)
    _close(state, s8)


def test_wkv_bf16_inputs_round_y_once():
    """bf16 r/k/v with f32 w/u/state: y is the f32 recurrence over the
    widened inputs, rounded once to bf16, as the reference model's f32
    recurrence followed by ``astype`` (and as its oracle on bf16 inputs)."""
    rng = np.random.default_rng(5)
    r, k, v, w, u, s0 = _wkv_inputs(rng, 2, 24, 3, 16)
    rb, kb, vb = (_t(a).bfloat16() for a in (r, k, v))
    y, s = ops.rwkv6_wkv(rb, kb, vb, _t(w), _t(u), _t(s0))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y32, s32 = ops.rwkv6_wkv(rb.float(), kb.float(), vb.float(), _t(w),
                             _t(u), _t(s0))
    assert torch.equal(y, y32.bfloat16())
    assert torch.equal(s, s32)
    jb = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
          for a in (rb, kb, vb)]
    y_ref, s_ref = jref.rwkv6_wkv_ref(*jb, jnp.asarray(w), jnp.asarray(u),
                                      jnp.asarray(s0))
    assert y_ref.dtype == jnp.bfloat16
    # the same f32 value may round either way where the two frameworks'
    # sums differ in the last bit: one bf16 step at most
    assert (np.abs(_np(y) - _np(y_ref))
            <= 2.0 ** -7 * np.abs(_np(y_ref)) + 1e-6).all()
    _close(s, s_ref, rtol=1e-4)


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("rwkv6-3b").smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("rwkv6-3b").smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_config_matches_reference():
    t, j = get_config("rwkv6-3b"), j_get_config("rwkv6-3b")
    assert t.__dict__ == j.__dict__
    assert t.param_count() == j.param_count()
    assert t.smoke_config().__dict__ == j.smoke_config().__dict__
    assert t.smoke_config().rwkv_lora_w == 8


def test_port_init_builds_reference_tree(models):
    """Same keys, shapes and dtypes; ``lora_a``/``lora_b`` keep the fixed
    rank 32 while ``decay_a``/``decay_b`` take ``rwkv_lora_w``."""
    _, jp, tm, tp = models
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)
    assert shapes(own) == shapes(jp) == shapes(tp)
    tmix = own["layers"]["tmix"]
    assert tmix["lora_a"].shape[-1] == 32 and tmix["decay_a"].shape[-1] == 8
    assert (tmix["decay_base"] == -6.0).all() and (tmix["mu"] == 0.5).all()


def test_bf16_tree_carries_over_by_copy():
    """``from_jax_params`` on a bf16 reference tree: every leaf keeps its
    shape, dtype and bits."""
    jm = j_build_model(j_get_config("rwkv6-3b").smoke_config(),
                       j_local_plan(param_dtype=jnp.bfloat16))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tp = from_jax_params(jp, device="cpu")
    for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert j.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16))


def _layer(tree, i):
    """Layer ``i`` of a layer-stacked tree (JAX or torch leaves)."""
    return jax.tree.map(lambda a: a[i], tree)


def _state(rng, cfg, B):
    """A random one-layer RWKV state, as (JAX tree, torch tree)."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    s = {"tmix": {"shift": _arr(rng, B, 1, d),
                  "wkv": _arr(rng, B, H, hd, hd)},
         "cmix": {"shift": _arr(rng, B, 1, d)}}
    return jax.tree.map(jnp.asarray, s), jax.tree.map(_t, s)


def test_rwkv_mix_matches_reference(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(20)
    x, xp = _arr(rng, 2, 7, tm.cfg.d_model), _arr(rng, 2, 7, tm.cfg.d_model)
    ref = JS._rwkv_mix(_layer(jp["layers"]["tmix"], 1), jnp.asarray(x),
                       jnp.asarray(xp))
    got = TS._rwkv_mix(_layer(tp["layers"]["tmix"], 1), _t(x), _t(xp))
    assert tuple(got.shape) == ref.shape == (2, 7, 5, tm.cfg.d_model)
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("part", ["tmix", "cmix"])
def test_mix_forward_matches_reference(models, part, with_state):
    """Output and new state (shift, and the WKV state for tmix), from a
    zero state and from a random one, over 9 tokens and over 1 (decode)."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(21)
    jfwd = {"tmix": JS.rwkv_tmix_forward, "cmix": JS.rwkv_cmix_forward}[part]
    tfwd = {"tmix": TS.rwkv_tmix_forward, "cmix": TS.rwkv_cmix_forward}[part]
    jst, tst = _state(rng, tm.cfg, 2)
    for S in (9, 1):
        x = _arr(rng, 2, S, tm.cfg.d_model)
        ref, jnew = jfwd(_layer(jp["layers"][part], 0), jnp.asarray(x),
                         jm.cfg, jm.plan, jst[part] if with_state else None)
        got, tnew = tfwd(_layer(tp["layers"][part], 0), _t(x), tm.cfg,
                         tm.plan, tst[part] if with_state else None)
        _close(got, ref)
        _tree_close(tnew, jnew)


def test_mix_forward_writes_out_state_in_place(models):
    """``out_state = state`` (the slot decode's call) leaves the new state
    in the given tree, equal to the returned one of a fresh call."""
    _, _, tm, tp = models
    rng = np.random.default_rng(22)
    _, tst = _state(rng, tm.cfg, 3)
    x = _t(_arr(rng, 3, 1, tm.cfg.d_model))
    for part, fwd in (("tmix", TS.rwkv_tmix_forward),
                      ("cmix", TS.rwkv_cmix_forward)):
        lp = _layer(tp["layers"][part], 1)
        fresh = {n: t.clone() for n, t in tst[part].items()}
        want_out, want = fwd(lp, x, tm.cfg, tm.plan, fresh)
        st = tst[part]
        ptrs = {n: t.data_ptr() for n, t in st.items()}
        out, new = fwd(lp, x, tm.cfg, tm.plan, st, out_state=st)
        assert torch.equal(out, want_out)
        for n in st:
            assert new[n] is st[n] and st[n].data_ptr() == ptrs[n]
            assert torch.equal(st[n], want[n])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_logits_and_prefill_match_reference(models):
    """f32 plan: full-sequence logits, last-token logits and every state
    leaf of the prefill cache (stacked on L) at 1e-4."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(23)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 13)).astype(np.int32)
    _close(tm.logits(tp, _t(toks)), jm.logits(jp, jnp.asarray(toks)))
    lj, cj = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
    lt, ct = tm.prefill(tp, _t(toks))
    _close(lt, lj)
    assert set(ct) == {"tmix", "cmix"} and set(ct["tmix"]) == {"shift", "wkv"}
    _tree_close(ct, cj)


def test_init_cache_matches_reference(models):
    jm, _, tm, _ = models
    jc = jm.init_cache(3, 40)
    tc = tm.init_cache(3, 40, device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc)
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), tc)
    assert got == want
    assert not any(t.any() for t in jax.tree.leaves(tc))


def test_decode_step_matches_reference(models):
    """Three decode steps over a bf16 pool of random state, in place.  The
    reference's step returns the state in the compute dtype, so after the
    first step the pool's shift leaves are f32 in both.  The bf16 shift
    inputs are the same values in both, the rest is f32: logits and state
    at 1e-4."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(24)
    cfg, B = tm.cfg, 4
    L = cfg.num_layers
    shift = [_arr(rng, L, B, 1, cfg.d_model) for _ in range(2)]
    wkv = _arr(rng, L, B, cfg.n_heads, cfg.head_dim, cfg.head_dim)
    jcache = {"tmix": {"shift": jnp.asarray(shift[0], jnp.bfloat16),
                       "wkv": jnp.asarray(wkv)},
              "cmix": {"shift": jnp.asarray(shift[1], jnp.bfloat16)}}
    tcache = {"tmix": {"shift": _t(shift[0]).bfloat16(), "wkv": _t(wkv)},
              "cmix": {"shift": _t(shift[1]).bfloat16()}}
    wkv_ptr = tcache["tmix"]["wkv"].data_ptr()
    pos = np.asarray([9, 0, 30, 17], np.int32)
    step = jax.jit(jm.decode_step)
    for i in range(3):
        tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        lj, jcache = step(jp, jcache, jnp.asarray(tokens),
                          jnp.asarray(pos + i))
        lt, out = tm.decode_step(tp, tcache, _t(tokens), _t(pos + i))
        assert out is tcache
        _close(lt, lj)
        _tree_close(tcache, jcache)
    assert tcache["tmix"]["shift"].dtype == torch.float32
    assert jcache["tmix"]["shift"].dtype == jnp.float32
    assert tcache["tmix"]["wkv"].data_ptr() == wkv_ptr     # written in place


def test_prefill_then_decode_equals_longer_prefill(models):
    """State carry through the model: prefill of ``prompt[:n]`` then one
    decode step per remaining token gives the last logits (and state) of
    a prefill of the whole prompt."""
    _, _, tm, tp = models
    rng = np.random.default_rng(25)
    prompt = _t(rng.integers(0, tm.cfg.vocab_size, (2, 15)).astype(np.int32))
    want_logits, want_state = tm.prefill(tp, prompt)
    _, state = tm.prefill(tp, prompt[:, :9])
    for t in range(9, 15):
        logits, state = tm.decode_step(tp, state, prompt[:, t].contiguous(),
                                       torch.full((2,), t, dtype=torch.int32))
    _close(logits, want_logits)
    for got, want in zip(jax.tree.leaves(state), jax.tree.leaves(want_state)):
        _close(got, want)


# ---------------------------------------------------------------------------
# CachePool on the state tree
# ---------------------------------------------------------------------------

def test_cache_pool_holds_state_like_reference(models):
    """Inserts of single-request prefill states (f32, cast into the bf16
    shift leaves and the f32 WKV leaf), releases and advances: the same
    slots, lengths and contents as the reference pool."""
    jm, _, tm, _ = models
    jpool = JCachePool(jm, n_slots=3, max_seq=32)
    tpool = CachePool(tm, n_slots=3, max_seq=32)
    rng = np.random.default_rng(26)
    cfg = tm.cfg

    def prefill_state():
        j, t = _state(rng, cfg, 1)
        L = cfg.num_layers
        j = jax.tree.map(lambda a: jnp.broadcast_to(a, (L,) + a.shape) * 1.5,
                         j)
        return j, jax.tree.map(_t, j)

    script = [("insert", 1, 20), ("insert", 2, 7), ("advance",),
              ("release", 1), ("insert", 3, 31), ("advance",),
              ("release", 2), ("insert", 4, 3)]
    for op, *args in script:
        if op == "insert":
            jc, tc = prefill_state()
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
    assert tpool.cache["tmix"]["shift"].dtype == torch.bfloat16
    assert tpool.cache["tmix"]["wkv"].dtype == torch.float32
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


# Workloads: three prompt lengths each (each distinct length compiles the
# reference's prefill once).  Checked free of near-ties: along every
# reference stream the top-2 logit margin stays above 1e-3, against ~1e-6
# of drift between the two f32 paths.
@pytest.mark.parametrize("lengths,max_new,n_slots,max_seq,seed", [
    ((5, 12, 5, 19, 12), 8, 3, 64, 0),     # 5 requests through 3 slots
    ((12, 19, 19, 5), 14, 2, 28, 1),       # contexts that reach max_seq
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


def test_paged_rwkv_raises_as_reference(models):
    jm, jp, tm, tp = models
    with pytest.raises(ValueError) as ref:
        JEngine(jm, jp, n_slots=2, max_seq=32, paged=True)
    with pytest.raises(ValueError) as got:
        Engine(tm, tp, n_slots=2, max_seq=32, paged=True)
    assert str(got.value) == str(ref.value)
    assert not tm.supports_paged


def test_serve_cli_rwkv_prints_reference_dict():
    argv = ["--arch", "rwkv6-3b", "--smoke", "--requests", "4",
            "--max-new", "6"]
    ref = j_serve.main(argv)
    got = t_serve.main(argv + ["--device", "cpu"])
    assert got == ref and got["mode"] == "slots"
    with pytest.raises(ValueError, match="cannot serve paged"):
        t_serve.main(argv + ["--paged", "--device", "cpu"])
