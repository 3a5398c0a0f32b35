"""Prefix sharing over the paged pool, the port against the live JAX
reference on the CPU: ``PagedCachePool``'s content-hash prefix index,
pending claims and release, driven through one sequence of operations on
both pools, and the prefix-shared chunked ``Engine`` on the workloads of
``tests/test_engine_hotpath.py`` (a shared 17-token head; a same-wave
wave of identical 24-token heads), at horizon 1 and 4, under a tight pool,
and with a prefilling request preempted mid-prompt.

Both engines serve the same weights (a JAX ``Model.init`` tree carried over
with ``from_jax_params``, f32 plan, bf16 pool); greedy streams must match
token for token and the counters exactly."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import PagedCachePool as JPool  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import Engine, EngineKnobs, PagedCachePool, Request  # noqa: E402
from repro_torch.serving.kvcache import _chain_key  # noqa: E402

STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")
POOL_STATS = ("shared_block_hits", "pending_share_waits")


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


# ---------------------------------------------------------------------------
# the pool's prefix index and pending claims
# ---------------------------------------------------------------------------

def test_chain_key_matches_reference():
    from repro.serving.kvcache import _chain_key as j_chain_key
    k1, k2 = b"", b""
    for chunk in ([1, 2, 3], list(range(16)), [2 ** 31 - 1, 0]):
        k1, k2 = _chain_key(k1, chunk), j_chain_key(k2, chunk)
        assert k1 == k2 and len(k1) == 16


def _state(pool) -> dict:
    return {
        "prefix_index": {k: list(v) for k, v in pool.prefix_index.items()},
        "key_of": dict(pool.key_of),
        "pending_index": dict(pool.pending_index),
        "pending_of": {k: list(v) for k, v in pool.pending_of.items()},
        "ref": pool.ref.tolist(),
        "free_blocks": list(pool.free_blocks),
        "free_lanes": list(pool.free_lanes),
        "blocks_of": {k: list(v) for k, v in pool.blocks_of.items()},
        "tables": pool.block_tables.tolist(),
        "lengths": pool.lengths.tolist(),
        "shared_block_hits": pool.shared_block_hits,
    }


def test_prefix_pool_matches_reference_through_one_op_sequence(models):
    """Admissions with and without a shared head, pending claims, publish,
    release with a live sharer and the last release: after every step the
    two pools hold the same index, claims, refcounts, free lists and
    tables, and answer ``shared_prefix``/``pending_shared`` alike."""
    jm, _, tm, _ = models
    jpool = JPool(jm, n_lanes=3, max_seq=64, block_size=8)
    tpool = PagedCachePool(tm, n_lanes=3, max_seq=64, block_size=8)
    rng = np.random.default_rng(7)
    head = [int(t) for t in rng.integers(0, 128, 24)]       # 3 full blocks
    a = head + [int(t) for t in rng.integers(0, 128, 5)]
    b = head + [int(t) for t in rng.integers(0, 128, 11)]
    c = [int(t) for t in rng.integers(0, 128, 17)]
    script = [
        ("shared_prefix", a), ("admit", 1, a, 0), ("pending", 1, a),
        ("pending_shared", b, 0), ("pending_shared", c, 0),
        ("set_length", 1, len(a)), ("publish", 1, a),
        ("pending_shared", b, 0), ("shared_prefix", b),
        ("admit", 2, b, 3), ("pending", 2, b),
        ("admit", 3, c, 0), ("pending", 3, c), ("pending_shared", c, 0),
        ("release", 3), ("pending_shared", c, 0),
        ("release", 1), ("shared_prefix", b),
        ("set_length", 2, len(b)), ("publish", 2, b), ("shared_prefix", a),
        ("release", 2), ("shared_prefix", a),
    ]
    for op, *args in script:
        got = []
        for pool in (jpool, tpool):
            if op == "shared_prefix":
                got.append(pool.shared_prefix(args[0]))
            elif op == "admit":
                rid, toks, n_shared = args
                shared = pool.shared_prefix(toks)
                assert len(shared) == n_shared
                got.append(pool.admit_prefill(rid, len(toks), shared))
            elif op == "pending":
                got.append(pool.register_pending(*args))
            elif op == "pending_shared":
                toks, have = args
                got.append(pool.pending_shared(toks, have=have))
            elif op == "set_length":
                got.append(pool.set_length(pool.lane_of[args[0]], args[1]))
            elif op == "publish":
                got.append(pool.register_prefix(*args))
            else:
                got.append(pool.release(*args))
        assert got[0] == got[1], (op, args, got)
        assert _state(tpool) == _state(jpool), (op, args)
    assert tpool.used_blocks == 0 and not tpool.prefix_index
    assert not tpool.pending_index and not tpool.pending_of
    assert tpool.shared_block_hits == 3


# ---------------------------------------------------------------------------
# prefix-shared engines
# ---------------------------------------------------------------------------

def _hotpath_load(vocab, *, n_req=5, max_new=6, seed=0, shared=0, stagger=0):
    """``tests/test_engine_hotpath.py::_submit_load``'s request stream."""
    rng = np.random.default_rng(seed)
    head = [int(t) for t in rng.integers(0, vocab, shared)]
    out = []
    for i in range(n_req):
        plen = int(rng.integers(4, 20))
        tail = [int(t) for t in rng.integers(0, vocab, plen)]
        out.append((head + tail, max_new + stagger * i))
    return out


def _dedup_load(vocab):
    """``test_pending_share_dedups_same_wave_admissions``'s wave: three
    prompts with one 24-token head (3 full blocks at block size 8)."""
    rng = np.random.default_rng(3)
    head = [int(t) for t in rng.integers(0, vocab, 24)]
    return [(head + [int(t) for t in rng.integers(0, vocab, 4 + i)], 4)
            for i in range(3)]


def _serve(engine_cls, knobs_cls, req_cls, model, params, load, *,
           preempt_after=None, **kw):
    """Serve ``load``; with ``preempt_after=n`` run n steps, preempt the
    oldest request still prefilling, then drain."""
    kw.setdefault("max_seq", 64)
    kw.setdefault("n_slots", 3)
    eng = engine_cls(model, params, knobs=knobs_cls(max_batch=kw["n_slots"]),
                     paged=True, block_size=8, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=m) for p, m in load]
    for r in reqs:
        eng.submit(r)
    preempted = None
    if preempt_after is not None:
        for i in range(preempt_after):
            eng.step(now=float(i))
        preempted = sorted(eng.prefilling)[0]
        eng._preempt([preempted])
        preempted = [r.req_id for r in reqs].index(preempted)
    stats = eng.run()
    order = {r.req_id: i for i, r in enumerate(reqs)}
    return {
        "streams": [tuple(r.output) for r in reqs],
        "finish_order": [order[r.req_id] for r in stats.completed],
        "completed": len(stats.completed),
        "preempted": preempted,
        **{k: getattr(stats, k) for k in STATS},
        **{k: getattr(eng.pool, k) for k in POOL_STATS},
        "used_blocks": eng.pool.used_blocks,
        "index_left": len(eng.pool.prefix_index) + len(eng.pool.pending_index),
    }


def _both(models, load, **kw):
    jm, jp, tm, tp = models
    ref = _serve(JEngine, JKnobs, JRequest, jm, jp, load, **kw)
    got = _serve(Engine, EngineKnobs, Request, tm, tp, load, **kw)
    assert got == ref
    assert got["completed"] == len(load)
    assert got["used_blocks"] == 0 and got["index_left"] == 0
    return got


@pytest.mark.parametrize("horizon,chunk", [(1, 16), (4, 16), (4, 8)])
def test_prefix_engine_matches_reference(models, horizon, chunk):
    """The shared 17-token head: later requests attach to its 2 full
    blocks instead of prefilling them."""
    load = _hotpath_load(128, shared=17, max_new=6, stagger=3)
    got = _both(models, load, prefix_share=True, prefill_chunk=chunk,
                horizon=horizon)
    assert got["shared_block_hits"] > 0


def test_pending_share_engine_matches_reference(models):
    """The same-wave duplicates wait for the first request's in-flight
    prefill and attach to its head blocks."""
    got = _both(models, _dedup_load(128), max_seq=128, n_slots=4,
                prefix_share=True, prefill_chunk=16)
    assert got["pending_share_waits"] > 0
    assert got["shared_block_hits"] >= 6


def test_prefix_engine_under_a_tight_pool_matches_reference(models):
    """12 blocks (11 usable) for 3 lanes of growing contexts: decode
    preempts, and recomputed contexts find their heads in the index."""
    load = _hotpath_load(128, shared=17, max_new=10, stagger=4, seed=2)
    got = _both(models, load, prefix_share=True, prefill_chunk=8, horizon=2,
                n_blocks=12)
    assert got["preemptions"] > 0 and got["shared_block_hits"] > 0


def test_preempting_a_prefilling_request_matches_reference(models):
    """A request preempted mid-prompt (its chunks written so far dropped,
    its pending claims released) is requeued at the front and recomputed:
    both engines then serve the same streams with the same counters, and
    the waiters on its claims are not left waiting."""
    got = _both(models, _dedup_load(128), max_seq=128, n_slots=4,
                prefix_share=True, prefill_chunk=8, preempt_after=1)
    assert got["preemptions"] == 1 and got["preempted"] == 0
