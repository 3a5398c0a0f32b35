"""The port's block-striped paged pool against the JAX reference.

Kernel 4 (``paged_decode_attention_lse``) and ``combine_lse`` are held to
the reference's Pallas kernel (interpret mode on the CPU, as
``tests/test_sharded.py`` runs it) and ``combine_lse`` at 1e-6 in f32.
The sharded decode core is held to the reference's ``_paged_decode_core``
run unsharded (``axis=None``) over the whole pool, on the inputs of
``tests/_sharded_parity_main.py``: o at 1e-6, the pools bit-exact.

The reference engine cannot serve at shards >= 2 on this tree (under jax
0.9 its sharded prefill raises on ``with_sharding_constraint``), so the
port's sharded engines are held to the JAX ``EngineSpec(shards=1)``
engine: the reference's own invariant, which
``_sharded_parity_main.py`` asserts between shards 1 and 2.  Those runs
use ``_run_streams``' workload with the JAX weights carried across
(``param_dtype`` f32, the reference's default compute and pool dtypes).
The smoke config has 2 kv heads, which ``shard_compat`` admits at 2
shards only, so shards = 4 runs the same config with 4 kv heads (MHA).
``n_blocks = 8`` holds the 6 live blocks without preemption and fills
every stripe; each run checks that it did.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.models.attention import _paged_decode_core as j_core  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro.serving import shard_compat as j_shard_compat  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pa  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import (EngineSpec, PagedCachePool,  # noqa: E402
                                 Request, serving_plan, shard_compat)

NEG_INF = -1e30
STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")


def _t(a):
    """A torch copy of a numpy array (the port writes pools in place; JAX
    may alias the numpy buffer it was given)."""
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# kernel 4 and combine_lse
# ---------------------------------------------------------------------------

def _lse_inputs(K):
    """``test_sharded.py``'s kernel-4 inputs: 3 lanes, 8 heads over K kv
    heads, 16 blocks of 8, scrambled tables, positions 5/17/30."""
    rng = np.random.default_rng(0)
    B, H, D, bs, nb, T = 3, 8, 16, 8, 16, 4
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, K, D)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, K, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:B * T].reshape(B, T) \
        .astype(np.int32)
    pos = np.asarray([5, 17, 30], np.int32)
    return q, kp, vp, bt, pos


def _stripe(bt, r, nb_loc):
    local = bt - r * nb_loc
    owned = ((local >= 0) & (local < nb_loc)).astype(np.int32)
    return np.clip(local, 0, nb_loc - 1).astype(np.int32), owned


@pytest.mark.parametrize("K", [4, 8, 1], ids=["gqa", "mha", "mqa"])
@pytest.mark.parametrize("shards", [2, 4])
def test_lse_plain_matches_pallas_per_stripe(shards, K):
    """Per stripe, o and lse at 1e-6; a stripe that owns no live key of a
    lane gives lse = -1e30 and o = 0 on both sides."""
    q, kp, vp, bt, pos = _lse_inputs(K)
    nb_loc = kp.shape[0] // shards
    empty = 0
    for r in range(shards):
        sl = slice(r * nb_loc, (r + 1) * nb_loc)
        safe, owned = _stripe(bt, r, nb_loc)
        jo, jlse = j_ops.paged_decode_attention_lse(
            *map(jnp.asarray, (q, kp[sl], vp[sl], safe, pos, owned)))
        to, tlse = ops.paged_decode_attention_lse(
            *map(_t, (q, kp[sl], vp[sl], safe, pos, owned)))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-6,
                                   rtol=0)
        for b in range(q.shape[0]):
            live = [j for j in range(bt.shape[1])
                    if owned[b, j] and j * kp.shape[1] <= pos[b]]
            if not live:
                empty += 1
                assert (tlse[b] == NEG_INF).all()
                assert (np.asarray(jlse)[b] == NEG_INF).all()
                assert (to[b] == 0).all() and (np.asarray(jo)[b] == 0).all()
    assert empty > 0, "no stripe without a live key of some lane"


@pytest.mark.parametrize("shards", [2, 4])
def test_combine_lse_matches_reference(shards):
    """``combine_lse`` of the stripes at 1e-6 against the JAX
    ``combine_lse`` of the same inputs and the full-pool kernel 2."""
    q, kp, vp, bt, pos = _lse_inputs(4)
    nb_loc = kp.shape[0] // shards
    os_, lses = [], []
    for r in range(shards):
        sl = slice(r * nb_loc, (r + 1) * nb_loc)
        safe, owned = _stripe(bt, r, nb_loc)
        o, lse = ops.paged_decode_attention_lse(
            *map(_t, (q, kp[sl], vp[sl], safe, pos, owned)))
        os_.append(o)
        lses.append(lse)
    got = pa.combine_lse(torch.stack(os_), torch.stack(lses))
    want = j_ops.combine_lse(jnp.asarray(torch.stack(os_).numpy()),
                             jnp.asarray(torch.stack(lses).numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    full = j_ops.paged_decode_attention(*map(jnp.asarray,
                                             (q, kp, vp, bt, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(full), atol=1e-6,
                               rtol=0)


def test_combine_lse_of_empty_stripes():
    """Stripes that saw no key (lse -1e30, o 0) weigh nothing beside one
    that did, and a lane no stripe saw merges to 0, as in the reference."""
    rng = np.random.default_rng(1)
    os_ = rng.standard_normal((3, 2, 4, 8)).astype(np.float32)
    lses = rng.standard_normal((3, 2, 4)).astype(np.float32)
    os_[1:, 0], lses[1:, 0] = 0.0, NEG_INF
    os_[:, 1], lses[:, 1] = 0.0, NEG_INF
    got = pa.combine_lse(_t(os_), _t(lses)).numpy()
    want = np.asarray(j_ops.combine_lse(jnp.asarray(os_), jnp.asarray(lses)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0], os_[0, 0], atol=1e-6, rtol=0)
    assert (got[1] == 0).all()


# ---------------------------------------------------------------------------
# the sharded decode core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_map", ["grouped", "interleaved"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_core_matches_reference(shards, kv_map):
    """``_sharded_parity_main.check_core_parity``'s decode inputs.  The
    port's kernels read kv head h // G for query head h (the map
    ``kv_index`` gives the model); the reference test passes h % K, which
    the port meets by permuting the query heads."""
    rng = np.random.default_rng(0)
    B, H, K, hd, bs, T = 3, 4, 2, 16, 8, 4
    nb = shards * 4
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, K, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, K, hd)).astype(np.float32)
    tables = (rng.permutation(np.arange(1, nb))[:B * T].reshape(B, T)
              if nb - 1 >= B * T else rng.integers(1, nb, (B, T))) \
        .astype(np.int32)
    positions = np.asarray([13, 7, 24], np.int32)
    kn = rng.normal(size=(B, K, hd)).astype(np.float32)
    vn = rng.normal(size=(B, K, hd)).astype(np.float32)
    if kv_map == "grouped":
        kv_idx, perm = np.arange(H) * K // H, np.arange(H)
    else:
        kv_idx = np.arange(H) % K
        perm = np.argsort(kv_idx, kind="stable")
    o_ref, kp_ref, vp_ref = j_core(
        None, *map(jnp.asarray, (q, kp, vp, tables, positions, kn, vn)),
        scale=0.25, kv_idx=jnp.asarray(kv_idx))
    tk, tv = _t(kp), _t(vp)
    o = TA._paged_decode_striped(shards, _t(q[:, perm]), tk, tv, _t(tables),
                                 _t(positions), _t(kn), _t(vn), scale=0.25)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref)[:, perm],
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kp_ref))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vp_ref))


def test_owned_write_drops_unowned_lanes():
    """Only the owning stripe writes a lane's new row; a stripe that owns
    no lane's block is left bit for bit, and a stripe owning two lanes
    writes both."""
    pool = torch.arange(4 * 2 * 1 * 2, dtype=torch.float32).reshape(4, 2, 1, 2)
    before = pool.clone()
    tables = torch.tensor([[3], [1], [2]], dtype=torch.int32)
    positions = torch.tensor([1, 0, 1], dtype=torch.int32)
    new = -torch.arange(1, 4, dtype=torch.float32)[:, None, None] \
        .expand(3, 1, 2).contiguous()
    for r in range(2):
        stripe = pool[2 * r:2 * r + 2]
        local = tables[:, 0] - 2 * r
        owned = (local >= 0) & (local < 2)
        rows = (local.clamp(0, 1) * 2 + positions % 2).long()
        TA._write_owned(stripe, rows, owned, new)
    want = before.clone()
    want[3, 1], want[1, 0], want[2, 1] = new[0], new[1], new[2]
    assert torch.equal(pool, want)
    stripe = pool[:2]
    TA._write_owned(stripe, torch.tensor([3, 1]), torch.tensor([False, False]),
                    torch.zeros(2, 1, 2))
    assert torch.equal(pool, want)


# ---------------------------------------------------------------------------
# the model: one sharded decode step against the reference's unsharded one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port params) at smoke size, f32 compute."""
    jm = j_build_model(j_get_config("llama2-7b").smoke_config(),
                       j_local_plan(param_dtype=jnp.float32,
                                    compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def test_sharded_decode_step_matches_reference(pair):
    """The port's model under a 2-way plan against the reference model at
    shards = 1, one paged decode step over an f32 pool whose scrambled
    tables spread every lane over both stripes: logits at 1e-5, the pool
    at 1e-5 (from layer 1 on, the written rows carry the attention
    output's rounding)."""
    jm, jp, tp = pair
    rng = np.random.default_rng(2)
    B, bs, T = 4, 8, 6
    n_blocks = 2 + B * T                    # 26: a multiple of 2
    bt = rng.permutation(np.arange(1, n_blocks))[:B * T].reshape(B, T) \
        .astype(np.int32)
    pos = np.asarray([40, 3, 17, 0], np.int32)
    tokens = rng.integers(0, 128, B).astype(np.int32)
    cfg = jm.cfg
    shape = (cfg.num_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    pool = {"attn": {n: rng.standard_normal(shape).astype(np.float32)
                     for n in ("k", "v")}}
    jl, jc = jax.jit(jm.decode_step_paged)(
        jp, jax.tree.map(jnp.asarray, pool), *map(jnp.asarray,
                                                  (tokens, pos, bt)))
    tm = build_model(get_config("llama2-7b").smoke_config(),
                     serving_plan(2, param_dtype=torch.float32,
                                  compute_dtype=torch.float32), device="cpu")
    tc = {"attn": {n: _t(a) for n, a in pool["attn"].items()}}
    tl, _ = tm.decode_step_paged(tp, tc, *map(_t, (tokens, pos, bt)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc["attn"][n].numpy(),
                                   np.asarray(jc["attn"][n]), atol=1e-5,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _cfgs(kv):
    return (j_get_config("llama2-7b").smoke_config().replace(n_kv_heads=kv),
            get_config("llama2-7b").smoke_config().replace(n_kv_heads=kv))


def _base(**kw):
    return dict(max_seq=64, n_slots=4, block_size=8, seed=0, **kw)


def _run_streams(eng, req_cls, n=3, new=12):
    """``_sharded_parity_main._run_streams``; also returns, at the step
    that ended with the most live blocks, the live blocks of each stripe."""
    reqs = [req_cls(prompt=[3 + i, 7, 11, 13 + i], max_new_tokens=new)
            for i in range(n)]
    for r in reqs:
        eng.submit(r)
    peak, stripes = 0, []
    for _ in range(80):
        if not (eng.queue or eng.active or eng.prefilling):
            break
        eng.step()
        pool = eng.pool
        if pool.used_blocks > peak:
            peak = pool.used_blocks
            n = getattr(pool, "shards", 1)
            nb_loc = pool.n_blocks // n
            stripes = [int((pool.ref[r * nb_loc:(r + 1) * nb_loc] > 0).sum())
                       for r in range(n)]
    return [list(r.output) for r in reqs], stripes


def _jax_engine(jcfg, **kw):
    return JSpec(jcfg, shards=1, param_dtype=jnp.float32, **_base(**kw)) \
        .build()


def _port_engine(tcfg, jeng, shards, **kw):
    eng = EngineSpec(tcfg, shards=shards, param_dtype=torch.float32,
                     **_base(**kw)).build(device="cpu")
    eng.params = from_jax_params(jax.tree.map(np.asarray, jeng.params),
                                 device="cpu")
    return eng


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("shards,kv", [(2, 2), (4, 4)])
def test_sharded_engine_matches_reference(shards, kv, horizon):
    jcfg, tcfg = _cfgs(kv)
    jeng = _jax_engine(jcfg, n_blocks=8, horizon=horizon)
    ref, _ = _run_streams(jeng, JRequest)
    eng = _port_engine(tcfg, jeng, shards, n_blocks=8, horizon=horizon)
    got, stripes = _run_streams(eng, Request)
    assert eng.shards == shards and eng.pool.n_blocks == 8
    assert got == ref
    assert all(len(s) == 12 for s in got)
    for k in STATS:
        assert getattr(eng.stats, k) == getattr(jeng.stats, k), k
    assert eng.stats.preemptions == 0
    assert len(stripes) == shards and all(n > 0 for n in stripes), stripes


def test_sharded_pool_invariants():
    """``check_pool_invariants``: the blocks allocated on submit all come
    back on completion, per stripe."""
    _, tcfg = _cfgs(2)
    eng = EngineSpec(tcfg, shards=2, **_base()).build(device="cpu")
    pool = eng.pool
    assert pool.shards == 2 and pool.n_blocks % pool.shards == 0
    free0, lanes0 = len(pool.free_blocks), len(pool.free_lanes)
    _run_streams(eng, Request)
    assert len(pool.free_blocks) == free0
    assert len(pool.free_lanes) == lanes0
    assert int(pool.ref[1:].sum()) == 0          # block 0 is the parking block
    assert sorted(pool.free_blocks) == list(range(1, pool.n_blocks))


def test_sharded_pool_rounds_n_blocks_up():
    _, tcfg = _cfgs(4)
    m = build_model(tcfg, serving_plan(4), device="cpu")
    pool = PagedCachePool(m, 2, 32, block_size=8, n_blocks=9)
    assert pool.shards == 4 and pool.n_blocks == 12
    assert tuple(pool.cache["attn"]["k"].shape)[:2] == (2, 12)
    with pytest.raises(ValueError, match="round n_blocks up"):
        m.init_paged_cache(9, 8)


def test_set_shards_keeps_streams():
    """``check_set_shards``: a live reshard 1 -> 2 keeps the streams;
    incompatible degrees are refused with a reason and change nothing."""
    jcfg, tcfg = _cfgs(2)
    jeng = _jax_engine(jcfg)
    ref, _ = _run_streams(jeng, JRequest)
    eng = _port_engine(tcfg, jeng, 1)
    assert eng.can_shard(2) is None
    eng.set_shards(2)
    assert eng.shards == 2 and eng.stats.shard_swaps == 1
    assert eng.pool.shards == 2
    got, _ = _run_streams(eng, Request)
    assert got == ref
    assert "n_kv_heads" in eng.can_shard(4)       # n_kv_heads=2 % 4 != 0
    assert eng.can_shard(100) is not None
    assert eng.can_shard(0) is not None
    with pytest.raises(ValueError):
        eng.set_shards(4)
    assert eng.shards == 2 and eng.stats.shard_swaps == 1
    eng.set_shards(1)
    assert eng.shards == 1 and eng.pool.shards == 1
    assert eng.stats.shard_swaps == 2


def test_set_shards_preempts_in_flight():
    """1 -> 2 with every request mid-decode: each is preempted, recomputed
    under the new plan, and the streams are the reference's."""
    jcfg, tcfg = _cfgs(2)
    jeng = _jax_engine(jcfg)
    ref, _ = _run_streams(jeng, JRequest)
    eng = _port_engine(tcfg, jeng, 1)
    reqs = [Request(prompt=[3 + i, 7, 11, 13 + i], max_new_tokens=12)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    assert len(eng.active) == 3
    eng.set_shards(2)
    assert eng.stats.preemptions == 3 and eng.stats.shard_swaps == 1
    assert not eng.active and len(eng.queue) == 3
    eng.run()
    assert [list(r.output) for r in reqs] == ref


def test_sharded_paths_not_ported_raise():
    """Chunked prefill and prefix sharing at shards > 1, once refused, are
    ported: ``EngineSpec(shards=2)`` with each builds and serves, and
    ``set_shards(2)`` on a shards-1 engine with each swaps (their streams
    held to the reference in ``test_torch_sharded_chunk.py``); the
    ``variants`` field and the speculative fields (``spec_k``, ``draft``,
    ``drafters``) build and serve (``test_torch_spec.py``)."""
    _, tcfg = _cfgs(2)
    for kw in (dict(prefill_chunk=16), dict(prefix_share=True),
               dict(prefill_chunk=8, prefix_share=True)):
        eng = EngineSpec(tcfg, shards=2, **_base(**kw)).build(device="cpu")
        req = Request(prompt=[3, 7, 11, 13] * 5, max_new_tokens=6)
        eng.submit(req)
        eng.run()
        assert eng.shards == 2 and len(req.output) == 6
        eng = EngineSpec(tcfg, **_base(**kw)).build(device="cpu")
        assert eng.can_shard(2) is None
        eng.set_shards(2)
        assert eng.shards == 2 and eng.stats.shard_swaps == 1
    for kw in (dict(spec_k=2), dict(draft="ngram"),
               dict(drafters=(("d", tcfg),))):
        eng = EngineSpec(tcfg, **_base(**kw)).build(device="cpu")
        req = Request(prompt=[3, 7, 11, 13], max_new_tokens=6)
        eng.submit(req)
        stats = eng.run()
        assert len(req.output) == 6 and stats.decode_tokens == 5
        assert (stats.verify_passes > 0) == ("draft" in kw)
    eng = EngineSpec(tcfg, variants=(("small", tcfg),)).build(device="cpu")
    assert list(eng.variants) == ["full", "small"]
    m = build_model(tcfg, serving_plan(2), device="cpu")
    pool = m.init_paged_cache(4, 8)
    i = torch.zeros(1, dtype=torch.int32)
    logits, _ = m.prefill_chunk_paged(
        m.init(torch.Generator().manual_seed(0)), pool,
        torch.zeros(1, 8, dtype=torch.int32), i, i + 8,
        torch.tensor([[1, 2]], dtype=torch.int32))
    assert torch.isfinite(logits).all()
    assert pool["attn"]["k"][:, 1].abs().sum() > 0    # stripe 0's block 1


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kv", [2, 4, 1])
def test_shard_compat_matches_reference(shards, kv):
    jcfg, tcfg = _cfgs(kv)
    assert shard_compat(shards, tcfg) == j_shard_compat(shards, jcfg)
    for name in ("d_ff", "vocab_size", "n_heads"):
        jbad = jcfg.replace(**{name: getattr(jcfg, name) + 1})
        tbad = tcfg.replace(**{name: getattr(tcfg, name) + 1})
        assert shard_compat(shards, tbad) == j_shard_compat(shards, jbad)


def test_engine_spec_rejects_unshardable_config():
    _, tcfg = _cfgs(2)
    with pytest.raises(ValueError, match="n_kv_heads"):
        EngineSpec(tcfg, shards=4).build(device="cpu")


def test_serving_plan():
    one, two = serving_plan(1), serving_plan(2, compute_dtype=torch.float32)
    _, tcfg = _cfgs(2)
    assert one == local_plan(param_dtype=torch.bfloat16)
    assert one.tp == 1 and not one.paged_pool_sharded(tcfg)
    assert two.tp == 2 and two.paged_pool_sharded(tcfg)
    assert two.param_dtype == torch.bfloat16
    assert two.compute_dtype == torch.float32
    assert not serving_plan(2, shard_paged_pool=False).paged_pool_sharded()
    assert (two.h_pad(tcfg), two.k_pad(tcfg), two.v_pad(tcfg)) == \
        (tcfg.n_heads, tcfg.n_kv_heads, tcfg.vocab_size)
