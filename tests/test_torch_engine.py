"""The port's paged Engine against the JAX Engine, and PagedCachePool
allocator invariants.

Both engines serve ``launch/serve.py``'s workload (8 requests, prompts of
4-23 tokens, 16 new tokens, 4 lanes, block size 16, max_seq 128) on the
same weights (a JAX ``Model.init`` tree carried over with
``from_jax_params``, f32 plan; the KV pool is bf16 on both sides).  Greedy
streams must match token for token, and the engine counters exactly."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import PagedCachePool as JPool  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import Engine, EngineKnobs, PagedCachePool, Request  # noqa: E402
from repro_torch.serving.engine import _bucket  # noqa: E402

STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")


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


def _workload(vocab, n=8, max_new=16):
    """launch/serve.py's request stream: (prompt, max_new_tokens) pairs."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, 24))
        out.append(([int(t) for t in rng.integers(0, vocab, plen)], max_new))
    return out


def _serve(engine_cls, knobs_cls, req_cls, model, params, *, horizon,
           n_blocks=None):
    eng = engine_cls(model, params, max_seq=128, n_slots=4,
                     knobs=knobs_cls(max_batch=4), paged=True, block_size=16,
                     n_blocks=n_blocks, horizon=horizon)
    reqs = [req_cls(prompt=p, max_new_tokens=m, arrival_s=0.0)
            for p, m in _workload(model.cfg.vocab_size)]
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


@pytest.mark.parametrize("horizon,n_blocks", [(1, None), (4, None), (1, 10),
                                              (4, 10)])
def test_engine_matches_reference(models, horizon, n_blocks):
    """n_blocks=10 (9 usable) cannot hold 4 growing lanes: preemption."""
    jm, jp, tm, tp = models
    ref = _serve(JEngine, JKnobs, JRequest, jm, jp, horizon=horizon,
                 n_blocks=n_blocks)
    got = _serve(Engine, EngineKnobs, Request, tm, tp, horizon=horizon,
                 n_blocks=n_blocks)
    assert got == ref
    assert got["completed"] == 8
    assert all(len(s) == 16 for s in got["streams"])
    if n_blocks is not None:
        assert got["preemptions"] > 0


def test_serve_cli_prints_reference_dict():
    """Same flags, same printed dict: the counters of serve's workload do
    not depend on the (framework-specific) random weights."""
    ref = j_serve.main(["--smoke"])
    got = t_serve.main(["--smoke", "--device", "cpu"])
    assert got == ref


def test_bucket_matches_reference():
    from repro.serving.engine import _bucket as j_bucket
    for n in (1, 15, 16, 17, 100, 200, 257):
        for hi in (None, 128, 200, 2048):
            assert _bucket(n, hi=hi) == j_bucket(n, hi=hi)
        assert _bucket(n, lo=1) == j_bucket(n, lo=1)


def test_unported_request_kinds_raise(models):
    _, _, tm, tp = models
    eng = Engine(tm, tp, max_seq=64, n_slots=2)
    with pytest.raises(NotImplementedError):
        eng.submit(Request(prompt=[1, 2], temperature=0.7))
    with pytest.raises(NotImplementedError):
        eng.submit(Request(prompt=[1, 2], deadline_ms=10.0))
    with pytest.raises(NotImplementedError):
        Engine(tm, tp, paged=False)


def test_goodput_matches_reference(models):
    jm, jp, tm, tp = models
    jeng = JEngine(jm, jp, max_seq=64, n_slots=2, paged=True, block_size=8)
    teng = Engine(tm, tp, max_seq=64, n_slots=2, block_size=8)
    for eng, req in ((jeng, JRequest), (teng, Request)):
        for i in range(3):
            eng.submit(req(prompt=[1, 2, 3, 4 + i], max_new_tokens=5))
        eng.run()
    for slo in ((50.0, 5.0), (1.0, 0.5), (0.0, 0.0)):
        assert teng.goodput(ttft_slo=slo[0], tbt_slo=slo[1]) == \
            jeng.goodput(ttft_slo=slo[0], tbt_slo=slo[1])


# ---------------------------------------------------------------------------
# PagedCachePool allocator invariants (the reference's, on the port)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("llama2-7b").smoke_config()
    return build_model(cfg, local_plan(param_dtype=torch.bfloat16),
                       device="cpu")


def _fake_prefill(model, batch, seq, value=1.0):
    cfg = model.cfg
    shape = (cfg.num_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"attn": {"k": torch.full(shape, value, dtype=torch.bfloat16),
                     "v": torch.full(shape, 2 * value, dtype=torch.bfloat16)}}


def test_pool_alloc_release_invariants(tiny):
    pool = PagedCachePool(tiny, n_lanes=3, max_seq=64, block_size=8)
    total = pool.n_blocks - 1          # block 0 reserved for parking
    assert len(pool.free_blocks) == total
    pool.insert(10, _fake_prefill(tiny, 1, 20), 0, 20)   # 3 blocks
    pool.insert(11, _fake_prefill(tiny, 1, 8), 0, 8)     # 1 block
    assert pool.used_blocks == 4
    held = pool.blocks_of[10] + pool.blocks_of[11]
    assert len(set(held)) == len(held), "double-allocated block"
    assert 0 not in held, "parking block must never be allocated"
    lane = pool.lane_of[10]
    assert list(pool.block_tables[lane][:3]) == pool.blocks_of[10]
    assert all(b == 0 for b in pool.block_tables[lane][3:])
    pool.release(10)
    assert pool.used_blocks == 1
    assert len(pool.free_blocks) == total - 1
    while pool.can_admit(16):
        pool.insert(100 + pool.used_blocks, _fake_prefill(tiny, 1, 16), 0, 16)
    assert not pool.free_lanes or len(pool.free_blocks) < pool.blocks_for(17)
    assert pool.utilization() == pool.used_blocks / total


def test_pool_insert_writes_only_touched_blocks(tiny):
    pool = PagedCachePool(tiny, n_lanes=2, max_seq=32, block_size=8)
    pool.insert(1, _fake_prefill(tiny, 1, 16, value=3.0), 0, 16)
    before = pool.cache["attn"]["k"].clone()
    blks1 = list(pool.blocks_of[1])
    pool.insert(2, _fake_prefill(tiny, 1, 9, value=5.0), 0, 9)
    after = pool.cache["attn"]["k"]
    touched = set(pool.blocks_of[2])
    for b in range(pool.n_blocks):
        if b not in touched:
            assert torch.equal(after[:, b], before[:, b])
    for b in blks1:
        assert float(after[:, b].max()) == 3.0


def test_pool_append_allocation_and_preemption_path(tiny):
    pool = PagedCachePool(tiny, n_lanes=2, max_seq=32, block_size=8,
                          n_blocks=4)   # 3 usable blocks
    pool.insert(1, _fake_prefill(tiny, 1, 8), 0, 8)
    pool.insert(2, _fake_prefill(tiny, 1, 8), 0, 8)
    victims = pool.ensure_append_blocks([2, 1])
    assert victims == [1]
    assert len(pool.blocks_of[2]) == 2
    pool.release(1)
    assert pool.ensure_append_blocks([2]) == []


def test_pool_device_mirrors_follow_host(tiny):
    """Device copies are built once, then rewritten a row at a time."""
    pool = PagedCachePool(tiny, n_lanes=3, max_seq=32, block_size=8)
    tables, positions = pool.tables(), pool.positions()
    pool.insert(1, _fake_prefill(tiny, 1, 12), 0, 12)
    pool.set_last_token(pool.lane_of[1], 77)
    assert pool.tables() is tables and pool.positions() is positions
    np.testing.assert_array_equal(pool.tables().numpy(), pool.block_tables)
    np.testing.assert_array_equal(pool.positions().numpy(), pool.lengths)
    np.testing.assert_array_equal(pool.last_tokens_dev().numpy(),
                                  pool.last_tokens)
    pool.release(1)
    np.testing.assert_array_equal(pool.tables().numpy(), pool.block_tables)
    assert int(pool.positions().sum()) == 0


def test_pool_allocation_matches_reference(tiny):
    """Same admissions, appends and releases -> the same block ids in the
    same tables as the reference allocator, and the same pool contents."""
    jm = j_build_model(j_get_config("llama2-7b").smoke_config(),
                       j_local_plan(param_dtype=jnp.bfloat16))
    jpool = JPool(jm, n_lanes=3, max_seq=64, block_size=8)
    tpool = PagedCachePool(tiny, n_lanes=3, max_seq=64, block_size=8)
    rng = np.random.default_rng(0)
    shape = (2, 1, 24, 2, 16)
    for rid, n in ((1, 20), (2, 9), (3, 24)):
        kv = {n_: rng.standard_normal(shape).astype(np.float32)
              for n_ in ("k", "v")}
        jpool.insert(rid, {"attn": {k: jnp.asarray(v) for k, v in kv.items()}},
                     0, n)
        tpool.insert(rid, {"attn": {k: torch.from_numpy(v)
                                    for k, v in kv.items()}}, 0, n)
    assert jpool.ensure_append_blocks([3, 1], horizon=4) == \
        tpool.ensure_append_blocks([3, 1], horizon=4)
    jpool.release(2)
    tpool.release(2)
    np.testing.assert_array_equal(tpool.block_tables, jpool.block_tables)
    assert tpool.free_blocks == jpool.free_blocks
    assert tpool.free_lanes == jpool.free_lanes
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            tpool.cache["attn"][name].float().numpy(),
            np.asarray(jpool.cache["attn"][name], np.float32))


def test_engine_pool_fully_reclaimed(tiny):
    params = tiny.init(torch.Generator().manual_seed(0))
    eng = Engine(tiny, params, max_seq=64, n_slots=2,
                 knobs=EngineKnobs(max_batch=2), block_size=8)
    for _ in range(3):
        eng.submit(Request(prompt=[1, 2, 3, 4], max_new_tokens=4))
    eng.run()
    assert eng.pool.used_blocks == 0
    assert sorted(eng.pool.free_lanes) == [0, 1]
    assert (eng.pool.block_tables == 0).all()
    assert len(eng.stats.completed) == 3


@pytest.mark.parametrize("knob", [{"variant": "int8"}, {"paused": True}])
def test_unported_knobs_are_refused(knob):
    """Knobs whose mechanism is not ported (set_variant, reconfiguration
    drains) are not accepted, so no caller gets a silently ignored knob."""
    assert {"variant", "paused"} <= set(JKnobs.__dataclass_fields__)
    with pytest.raises(TypeError):
        EngineKnobs(**knob)
