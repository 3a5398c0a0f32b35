"""Chunked prefill and prefix sharing over the port's block-striped pool,
against the JAX reference on the CPU.

Kernel 3's owned/LSE form (``paged_prefill_attention_lse``) is held per
stripe to the reference's masked per-stripe core, the Pallas kernel 4
(interpret mode on the CPU, as ``tests/test_sharded.py`` runs it) with
each of a chunk's C queries as a lane of its own at ``starts + c``: o and
lse at 1e-5.  The sharded chunk core is held to the reference's
``_paged_prefill_core`` run unsharded (``axis=None``) over the whole pool:
o at 1e-6, the pools bit-exact.

The reference engine cannot serve at shards >= 2 on this tree (see
``tests/test_torch_sharded.py``), so the port's chunked and prefix-shared
engines at shards 2 and 4 are held to the JAX ``shards=1`` engine on the
workloads of ``tests/test_torch_prefix.py`` (f32 plans, as there, over f32
pools: see ``f32_pools``): streams, counters and the pool's sharing
counters exactly.  The smoke config's 2 kv heads admit shards 2 only, so
shards 4 runs the same config with 4 kv heads.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import functools

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
from repro.models.attention import _paged_prefill_core as j_core  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pa  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (Engine, EngineKnobs, Request,  # noqa: E402
                                 serving_plan)

NEG_INF = -1e30
STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")
POOL_STATS = ("shared_block_hits", "pending_share_waits")


def _t(a):
    """A torch copy of a numpy array (the port writes pools in place)."""
    return torch.from_numpy(np.array(a))


def _stripe(bt, r, nb_loc):
    local = bt - r * nb_loc
    owned = ((local >= 0) & (local < nb_loc)).astype(np.int32)
    return np.clip(local, 0, nb_loc - 1).astype(np.int32), owned


def _chunk_inputs(shards, K=2, seed=0):
    """3 lanes of chunks of 8 (valid 8/3/6 at starts 0/5/13), 4 heads over
    K kv heads, blocks of 4, 5 slots a table; every lane's blocks distinct
    (a prompt's positions each have one owner) and spread over the
    stripes."""
    rng = np.random.default_rng(seed)
    B, C, H, hd, bs, T = 3, 8, 4, 16, 4, 5
    nb = shards * 8
    q = rng.normal(size=(B, C, H, hd)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, K, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, K, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:B * T].reshape(B, T) \
        .astype(np.int32)
    starts = np.asarray([0, 5, 13], np.int32)
    lengths = np.asarray([8, 3, 6], np.int32)
    k = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    return q, kp, vp, bt, starts, lengths, k, v


# ---------------------------------------------------------------------------
# kernel 3's owned/LSE form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [2, 4, 1], ids=["gqa", "mha", "mqa"])
@pytest.mark.parametrize("shards", [2, 4])
def test_prefill_lse_plain_matches_reference_per_stripe(shards, K):
    """Per stripe, o and lse at 1e-5 against the reference's kernel 4 with
    the chunk's queries as lanes; a stripe that owns no key a query sees
    gives lse = -1e30 and o = 0 on both sides, and at 4 stripes some
    stripe does."""
    q, kp, vp, bt, starts, _, _, _ = _chunk_inputs(shards, K)
    B, C, H, D = q.shape
    nb_loc = kp.shape[0] // shards
    empty = 0
    for r in range(shards):
        sl = slice(r * nb_loc, (r + 1) * nb_loc)
        local, owned = _stripe(bt, r, nb_loc)
        to, tlse = ops.paged_prefill_attention_lse(
            *map(_t, (q, kp[sl], vp[sl], local, starts, owned)))
        assert to.shape == (B, C, H, D) and tlse.shape == (B, C, H)
        pos = (starts[:, None] + np.arange(C)[None, :]).reshape(-1)
        jo, jlse = j_ops.paged_decode_attention_lse(*map(jnp.asarray, (
            q.reshape(B * C, H, D), kp[sl], vp[sl], np.repeat(local, C, 0),
            pos.astype(np.int32), np.repeat(owned, C, 0))))
        np.testing.assert_allclose(to.numpy().reshape(B * C, H, D),
                                   np.asarray(jo), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tlse.numpy().reshape(B * C, H),
                                   np.asarray(jlse), atol=1e-5, rtol=0)
        none = np.asarray(jlse) == NEG_INF
        empty += int(none.any())
        assert (tlse.numpy().reshape(B * C, H)[none] == NEG_INF).all()
        assert (to.numpy().reshape(B * C, H, D)[none] == 0).all()
    if shards == 4:
        assert empty > 0, "no stripe without a key some query sees"


@pytest.mark.parametrize("shards", [2, 4])
def test_prefill_lse_combined_equals_kernel_3(shards):
    """``combine_lse`` over the chunk's (S, B, C, H, D) stripes equals
    kernel 3's plain version over the whole pool (1e-6), and the
    reference's Pallas kernel 3 (1e-5)."""
    q, kp, vp, bt, starts, _, _, _ = _chunk_inputs(shards, 2, seed=1)
    nb_loc = kp.shape[0] // shards
    os_, lses = [], []
    for r in range(shards):
        sl = slice(r * nb_loc, (r + 1) * nb_loc)
        local, owned = _stripe(bt, r, nb_loc)
        o, lse = ops.paged_prefill_attention_lse(
            *map(_t, (q, kp[sl], vp[sl], local, starts, owned)))
        os_.append(o)
        lses.append(lse)
    got = pa.combine_lse(torch.stack(os_), torch.stack(lses))
    want = ops.paged_prefill_attention(*map(_t, (q, kp, vp, bt, starts)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    ref = j_ops.paged_prefill_attention(*map(jnp.asarray,
                                             (q, kp, vp, bt, starts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_prefill_lse_rounds_like_kernel_4_in_bf16():
    """Over a bf16 stripe each chunk query's (o, lse) is kernel 4's plain
    version at its position: the same rounding of exp(s - local m)."""
    q, kp, vp, bt, starts, _, _, _ = _chunk_inputs(2, 2, seed=2)
    B, C, H, D = q.shape
    local, owned = _stripe(bt, 1, kp.shape[0] // 2)
    kb, vb = (_t(a[kp.shape[0] // 2:]).to(torch.bfloat16) for a in (kp, vp))
    o, lse = ops.paged_prefill_attention_lse(_t(q), kb, vb, _t(local),
                                             _t(starts), _t(owned))
    pos = _t((starts[:, None] + np.arange(C)[None, :]).reshape(-1))
    o4, lse4 = ops.paged_decode_attention_lse(
        _t(q.reshape(B * C, H, D)), kb, vb, _t(np.repeat(local, C, 0)),
        pos.to(torch.int32), _t(np.repeat(owned, C, 0)))
    np.testing.assert_allclose(o.numpy().reshape(B * C, H, D), o4.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy().reshape(B * C, H), lse4.numpy(),
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the sharded chunk core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_chunk_core_matches_reference(shards):
    """The inputs above through ``_paged_prefill_striped`` against the
    reference's ``_paged_prefill_core(None, ...)`` over the whole pool:
    o at 1e-6, both pools bit-exact (every valid token's KV written by the
    rank that owns its block, no invalid token written anywhere)."""
    q, kp, vp, bt, starts, lengths, k, v = _chunk_inputs(shards)
    H, K = q.shape[2], kp.shape[2]
    o_ref, kp_ref, vp_ref = j_core(
        None, *map(jnp.asarray, (q, kp, vp, bt, starts, lengths, k, v)),
        scale=0.25, kv_idx=jnp.asarray(np.arange(H) * K // H))
    tk, tv = _t(kp), _t(vp)
    o = TA._paged_prefill_striped(shards, _t(q), tk, tv, _t(bt), _t(starts),
                                  _t(lengths), _t(k), _t(v), scale=0.25)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kp_ref))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vp_ref))


def test_owned_write_of_a_chunk():
    """``_write_owned`` over a chunk's B * C rows: each stripe writes only
    the valid tokens whose block it owns; a stripe owning none of them is
    left bit for bit."""
    pool = torch.arange(4 * 2 * 1 * 2, dtype=torch.float32).reshape(4, 2, 1, 2)
    want = pool.clone()
    # lane 0: tokens at block 3 offsets 0, 1; lane 1: block 1 offset 1 and
    # an invalid token (parked at block 0 offset 0 by the unsharded path)
    blocks = torch.tensor([[3, 3], [1, 0]])
    offs = torch.tensor([[0, 1], [1, 0]])
    valid = torch.tensor([[True, True], [True, False]])
    new = -torch.arange(1, 5, dtype=torch.float32)[:, None, None] \
        .expand(4, 1, 2).contiguous()
    for r in range(2):
        stripe = pool[2 * r:2 * r + 2]
        local = blocks - 2 * r
        owned = valid & (local >= 0) & (local < 2)
        rows = (local.clamp(0, 1) * 2 + offs).reshape(-1)
        TA._write_owned(stripe, rows, owned.reshape(-1), new)
    want[3, 0], want[3, 1], want[1, 1] = new[0], new[1], new[2]
    assert torch.equal(pool, want)
    TA._write_owned(pool[:2], torch.tensor([3, 1, 0, 2]),
                    torch.zeros(4, dtype=torch.bool), new)
    assert torch.equal(pool, want)


# ---------------------------------------------------------------------------
# the model: one sharded chunk against the reference's unsharded one
# ---------------------------------------------------------------------------

def test_sharded_chunk_step_matches_reference():
    """``prefill_chunk_paged`` under a 2-way plan against the reference
    model at shards = 1: one chunk over an f32 pool whose scrambled tables
    spread every lane over both stripes, after earlier context: logits at
    1e-5, the pool at 1e-5 but for the parking block 0, where the
    unsharded path parks the chunk's invalid tokens and the sharded core
    drops them, as the reference's own cores do."""
    jm = j_build_model(j_get_config("llama2-7b").smoke_config(),
                       j_local_plan(param_dtype=jnp.float32,
                                    compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    B, C, bs, T = 3, 8, 8, 6
    n_blocks = 2 + B * T                    # 20: a multiple of 2
    bt = rng.permutation(np.arange(1, n_blocks))[:B * T].reshape(B, T) \
        .astype(np.int32)
    starts = np.asarray([0, 9, 30], np.int32)
    lengths = np.asarray([8, 5, 8], np.int32)
    tokens = rng.integers(0, 128, (B, C)).astype(np.int32)
    cfg = jm.cfg
    shape = (cfg.num_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    pool = {"attn": {n: rng.standard_normal(shape).astype(np.float32)
                     for n in ("k", "v")}}
    jl, jc = jax.jit(jm.prefill_chunk_paged)(
        jp, jax.tree.map(jnp.asarray, pool),
        *map(jnp.asarray, (tokens, starts, lengths, bt)))
    tm = build_model(get_config("llama2-7b").smoke_config(),
                     serving_plan(2, param_dtype=torch.float32,
                                  compute_dtype=torch.float32), device="cpu")
    tc = {"attn": {n: _t(a) for n, a in pool["attn"].items()}}
    tl, _ = tm.prefill_chunk_paged(tp, tc, *map(_t, (tokens, starts, lengths,
                                                     bt)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc["attn"][n].numpy()[:, 1:],
                                   np.asarray(jc["attn"][n])[:, 1:],
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tc["attn"][n].numpy()[:, 0],
                                      pool["attn"][n][:, 0])


# ---------------------------------------------------------------------------
# chunked and prefix-shared engines at shards 2 and 4
# ---------------------------------------------------------------------------

def _cfgs(kv):
    return (j_get_config("llama2-7b").smoke_config().replace(n_kv_heads=kv),
            get_config("llama2-7b").smoke_config().replace(n_kv_heads=kv))


def _hotpath_load(vocab, *, n_req=5, max_new=6, seed=0, shared=0, stagger=0):
    """``tests/test_torch_prefix.py``'s request stream (a shared head)."""
    rng = np.random.default_rng(seed)
    head = [int(t) for t in rng.integers(0, vocab, shared)]
    out = []
    for i in range(n_req):
        plen = int(rng.integers(4, 20))
        tail = [int(t) for t in rng.integers(0, vocab, plen)]
        out.append((head + tail, max_new + stagger * i))
    return out


def _dedup_load(vocab):
    """``tests/test_torch_prefix.py``'s same-wave wave: three prompts with
    one 24-token head (3 full blocks at block size 8)."""
    rng = np.random.default_rng(3)
    head = [int(t) for t in rng.integers(0, vocab, 24)]
    return [(head + [int(t) for t in rng.integers(0, vocab, 4 + i)], 4)
            for i in range(3)]


# (load, pool blocks): the shared-head pool spreads its load over every
# stripe at 4 (a horizon of 4 preempts once there), the same-wave pool
# over at least 2
LOADS = {"shared_head": (lambda: _hotpath_load(128, shared=17, max_new=6,
                                               stagger=3), 16),
         "same_wave": (lambda: _dedup_load(128), 8)}


def _serve(eng, load, req_cls):
    """Serve ``load``; the streams, counters, and at the step that ended
    with the most live blocks the live blocks of each stripe."""
    reqs = [req_cls(prompt=p, max_new_tokens=m) for p, m in load]
    for r in reqs:
        eng.submit(r)
    peak, stripes = 0, []
    for _ in range(200):
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
    out = {"streams": [list(r.output) for r in reqs],
           **{k: getattr(eng.stats, k) for k in STATS},
           **{k: getattr(eng.pool, k) for k in POOL_STATS},
           "used_blocks": eng.pool.used_blocks}
    return out, stripes


@pytest.fixture
def f32_pools(monkeypatch):
    """Both engines' paged pools in f32.  Over the reference's bf16 pool
    each stripe rounds exp(s - its own max) to bf16 where the unsharded
    path rounds the normalised P (ROADMAP.md, Queue 3), so a stream may
    flip at a near-tie; in f32 both roundings are the identity and the
    streams must be equal."""
    import repro.serving.engine as j_engine
    import repro_torch.serving.engine as t_engine
    monkeypatch.setattr(j_engine, "PagedCachePool", functools.partial(
        j_engine.PagedCachePool, dtype=jnp.float32))
    monkeypatch.setattr(t_engine, "PagedCachePool", functools.partial(
        t_engine.PagedCachePool, dtype=torch.float32))


def _engines(kv, shards, **kw):
    """(JAX shards=1 engine, the port's engine at ``shards``), f32 plans
    over the same weights."""
    jcfg, tcfg = _cfgs(kv)
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, serving_plan(shards, param_dtype=torch.float32,
                                        compute_dtype=torch.float32),
                     device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(max_seq=64, n_slots=4, block_size=8, prefix_share=True, **kw)
    return (JEngine(jm, jp, knobs=JKnobs(max_batch=4), paged=True, **kw),
            Engine(tm, tp, knobs=EngineKnobs(max_batch=4), paged=True, **kw))


@pytest.mark.parametrize("load", sorted(LOADS))
@pytest.mark.parametrize("horizon,chunk", [(1, 16), (4, 8)])
@pytest.mark.parametrize("shards,kv", [(2, 2), (4, 4)])
def test_sharded_chunked_engine_matches_reference(f32_pools, shards, kv,
                                                  horizon, chunk, load):
    """A chunked, prefix-shared engine at shards 2 and 4 serves the JAX
    shards=1 engine's streams, its counters and its shared-block hits and
    pending-share waits; the stripes hold live blocks at the run's fullest
    point (all of them on the shared-head load)."""
    make, n_blocks = LOADS[load]
    jeng, eng = _engines(kv, shards, prefill_chunk=chunk, horizon=horizon,
                         n_blocks=n_blocks)
    ref, _ = _serve(jeng, make(), JRequest)
    got, stripes = _serve(eng, make(), Request)
    assert eng.shards == shards and eng.pool.shards == shards
    assert eng.pool.cache["attn"]["k"].dtype == torch.float32
    assert got == ref
    assert got["used_blocks"] == 0
    key = "pending_share_waits" if load == "same_wave" \
        else "shared_block_hits"
    assert got[key] > 0
    live = sum(n > 0 for n in stripes)
    assert live == shards if load == "shared_head" else live >= 2, stripes


def test_set_shards_on_a_chunked_engine(f32_pools):
    """1 -> 2 mid-run on a chunked, prefix-shared engine: ``can_shard``
    does not object, the in-flight requests are preempted and recomputed
    chunk by chunk over the striped pool, every request completes and the
    pool gives back every block.  The tokens emitted before the swap are
    the JAX engine's; ``set_shards`` then resets the compute dtype to the
    serving plan's bf16, as the reference's does, so the rest is not held
    to an f32 stream."""
    make, n_blocks = LOADS["shared_head"]
    jeng, eng = _engines(2, 1, prefill_chunk=8, horizon=2, n_blocks=n_blocks)
    ref, _ = _serve(jeng, make(), JRequest)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in make()]
    for r in reqs:
        eng.submit(r)
    while not any(r.output for r in reqs):
        eng.step()
    before = [list(r.output) for r in reqs]
    in_flight = len(eng.active) + len(eng.prefilling)
    assert in_flight > 0 and any(before)
    assert eng.can_shard(2) is None
    eng.set_shards(2)
    assert eng.shards == 2 and eng.pool.shards == 2
    assert eng.stats.shard_swaps == 1 and eng.stats.preemptions == in_flight
    assert eng.model.plan.compute_dtype == torch.bfloat16
    stats = eng.run()
    assert [s[:len(b)] for s, b in zip(ref["streams"], before)] == before
    assert [len(r.output) for r in reqs] == [m for _, m in make()]
    assert len(stats.completed) == len(reqs) and eng.pool.used_blocks == 0
