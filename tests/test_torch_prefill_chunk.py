"""Chunked prefill over the paged pool, the port against the live JAX
reference on the CPU: kernel 3's plain version (``paged_prefill_attention``
and ``paged_verify_attention``), the model functions that call it
(``gqa_prefill_paged``, ``Model.prefill_chunk_paged``) and the chunked
``Engine``.

Kernel shapes follow the reference's kernel tests (``tests/test_paged.py``):
GQA, MHA and MQA, block size 8/16, head dim 32/64, scrambled block tables;
f32 at atol 1e-5 (the reference's own kernel tolerance).  Model functions
run an f32 plan with weights carried over from a JAX ``Model.init`` tree
(``from_jax_params``): logits at 1e-4 over an f32 pool; over the bf16 pool
the engine keeps, within the bound each test states and explains.  Engines
(f32 plan, bf16 pool) must give the same greedy streams token for token
and the same counters."""
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
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import (  # noqa: E402
    paged_prefill_attention_ref)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import Engine, EngineKnobs, Request  # noqa: E402

ATOL = 1e-5


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """numpy f32 -> (torch bf16, jax bf16) holding the same values."""
    t = _t(a).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# kernel 3's plain version
# ---------------------------------------------------------------------------

def _prefill_inputs(rng, B, C, H, K, D, bs, T):
    n_blocks = 1 + B * T
    kp, vp = _arr(rng, n_blocks, bs, K, D), _arr(rng, n_blocks, bs, K, D)
    q = _arr(rng, B, C, H, D)
    starts = rng.integers(0, T * bs - C, B).astype(np.int32)
    bt = rng.permutation(np.arange(1, n_blocks))[: B * T] \
        .reshape(B, T).astype(np.int32)                     # scrambled
    return q, kp, vp, bt, starts


PREFILL_SHAPES = [
    (2, 6, 8, 2, 64, 16, 8),     # GQA 4:1
    (1, 16, 4, 4, 32, 8, 8),     # MHA, block 8
    (3, 5, 4, 1, 32, 8, 6),      # MQA
    (2, 8, 8, 2, 32, 16, 4),     # GQA, head dim 32, block 16
    (2, 12, 4, 4, 64, 8, 6),     # MHA, head dim 64, block 8
]


@pytest.mark.parametrize("B,C,H,K,D,bs,T", PREFILL_SHAPES)
def test_paged_prefill_plain_matches_ref_oracle(B, C, H, K, D, bs, T):
    rng = np.random.default_rng(B * 100 + C + D)
    q, kp, vp, bt, st = _prefill_inputs(rng, B, C, H, K, D, bs, T)
    o = paged_prefill_attention_ref(*map(_t, (q, kp, vp, bt, st)))
    o_ref = jref.paged_prefill_attention_ref(*map(jnp.asarray,
                                                  (q, kp, vp, bt, st)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


@pytest.mark.parametrize("B,C,H,K,D,bs,T", PREFILL_SHAPES)
def test_paged_prefill_plain_matches_interpret_kernel(B, C, H, K, D, bs, T):
    rng = np.random.default_rng(B * 100 + C + D + 1)
    q, kp, vp, bt, st = _prefill_inputs(rng, B, C, H, K, D, bs, T)
    o = ops.paged_prefill_attention(*map(_t, (q, kp, vp, bt, st)))
    o_ref = jops.paged_prefill_attention(*map(jnp.asarray,
                                              (q, kp, vp, bt, st)),
                                         interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


@pytest.mark.parametrize("pool_bf16", [False, True])
def test_paged_prefill_plain_matches_reference_model(pool_bf16):
    """Held to the reference model's ``attention.paged_prefill_attention``
    (the XLA path the kernel replaces), which rounds the normalised P to
    the pool's dtype before PV as the plain version does.  Over an f32 pool
    that rounding is the identity: 1e-5.  Over a bf16 pool the two
    frameworks' f32 exponentials differ in the last bit now and then, and a
    probability on the other side of a bf16 rounding boundary moves its
    output row by one bf16 step of p times |v|: a few rows in ten thousand
    probabilities, hence 1e-3 for those and 1e-5 for the rest."""
    rng = np.random.default_rng(21)
    B, C, H, K, D, bs, T = 3, 9, 8, 2, 64, 16, 6
    q, kp, vp, bt, st = _prefill_inputs(rng, B, C, H, K, D, bs, T)
    if pool_bf16:
        (tk, jk), (tv, jv) = _bf16(kp), _bf16(vp)
    else:
        tk, tv, jk, jv = _t(kp), _t(vp), jnp.asarray(kp), jnp.asarray(vp)
    o = ops.paged_prefill_attention(_t(q), tk, tv, _t(bt), _t(st),
                                    scale=1 / math.sqrt(D))
    cfg = j_get_config("llama2-7b").smoke_config().replace(n_heads=H,
                                                           n_kv_heads=K)
    o_ref = JA.paged_prefill_attention(jnp.asarray(q), jk, jv,
                                       jnp.asarray(bt), jnp.asarray(st),
                                       scale=1 / math.sqrt(D),
                                       kv_idx=JA.kv_index(cfg, H))
    assert o.dtype == torch.float32
    err = np.abs(o.numpy() - np.asarray(o_ref))
    assert err.max() <= (1e-3 if pool_bf16 else ATOL)
    assert (err > ATOL).mean() <= 0.02


def test_paged_prefill_chunk_equals_decode_steps():
    """A C-token chunk attends exactly like C successive decode steps whose
    KV is already in place (``tests/test_paged.py:102``)."""
    rng = np.random.default_rng(5)
    B, H, K, D, bs, T, C = 2, 4, 2, 32, 8, 4, 6
    n_blocks = 1 + B * T
    kp, vp = _t(_arr(rng, n_blocks, bs, K, D)), _t(_arr(rng, n_blocks, bs, K, D))
    q = _t(_arr(rng, B, C, H, D))
    starts = torch.tensor([5, 11], dtype=torch.int32)
    bt = _t(rng.permutation(np.arange(1, n_blocks)).reshape(B, T)
            .astype(np.int32))
    o_chunk = ops.paged_prefill_attention(q, kp, vp, bt, starts)
    for c in range(C):
        o_one = ops.paged_decode_attention(q[:, c].contiguous(), kp, vp, bt,
                                           starts + c)
        np.testing.assert_allclose(o_chunk[:, c].numpy(), o_one.numpy(),
                                   atol=ATOL)


@pytest.mark.parametrize("B,Q,H,K,D,bs,T", [
    (2, 5, 8, 2, 64, 16, 8),   # GQA 4:1, K=4 speculation (Q = K + 1)
    (1, 2, 4, 4, 64, 16, 4),   # MHA, K=1
    (3, 5, 4, 1, 32, 8, 8),    # MQA
])
def test_paged_verify_matches_ref(B, Q, H, K, D, bs, T):
    rng = np.random.default_rng(B * 1000 + Q)
    q, kp, vp, bt, pos = _prefill_inputs(rng, B, Q, H, K, D, bs, T)
    o = ops.paged_verify_attention(*map(_t, (q, kp, vp, bt, pos)))
    o_ref = jref.paged_verify_attention_ref(*map(jnp.asarray,
                                                 (q, kp, vp, bt, pos)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


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


def _pool_pair(rng, shape):
    """A random bf16 pool, as a (torch, jax) pair holding the same values."""
    out = {}
    for name in ("k", "v"):
        t, j = _bf16(_arr(rng, *shape))
        out[name] = (t, j)
    return ({n: p[0] for n, p in out.items()}, {n: p[1] for n, p in out.items()})


def test_gqa_prefill_paged_matches_reference(models):
    """Same output and same pool, with a ragged row (lengths < C) whose
    invalid positions go to the parking block 0 at offset 0, and a padded
    row (length 0, table of zeros)."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    B, C, bs, T = 3, 8, 8, 4
    n_blocks = 1 + 2 * T
    tpool, jpool = _pool_pair(rng, (n_blocks, bs, cfg.n_kv_heads,
                                    cfg.head_dim))
    x = _arr(rng, B, C, cfg.d_model)
    bt = np.zeros((B, T), np.int32)
    bt[:2] = rng.permutation(np.arange(1, n_blocks)).reshape(2, T)
    starts = np.asarray([5, 16, 0], np.int32)
    lengths = np.asarray([8, 3, 0], np.int32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tlp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    o_ref, jc = JA.gqa_prefill_paged(jlp, jnp.asarray(x), jpool,
                                     jnp.asarray(starts), jnp.asarray(lengths),
                                     jnp.asarray(bt), jm.cfg, jm.plan)
    o, tc = TA.gqa_prefill_paged(tlp, _t(x), tpool, _t(starts), _t(lengths),
                                 _t(bt), cfg, tm.plan)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-4)
    for name in ("k", "v"):
        got = tc[name].float().numpy()
        want = np.asarray(jc[name], np.float32)
        # every block but the parking block holds exactly the same values
        np.testing.assert_array_equal(got[1:], want[1:])
        np.testing.assert_array_equal(got[0, 1:], want[0, 1:])
    # block 0 offset 0 took one of the invalid positions' KV (duplicate
    # writes land in no fixed order); the valid rows never touch block 0
    assert not np.array_equal(tc["k"][0, 0].float().numpy(),
                              np.asarray(jpool["k"][0, 0], np.float32))


def _chunk_args(rng, cfg, B, C, T, starts, lengths, tables):
    tokens = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    return tokens, np.asarray(starts, np.int32), np.asarray(lengths, np.int32), \
        np.asarray(tables, np.int32)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_prefill_chunk_paged_matches_reference(models, pool_dtype):
    """Two chunks over the same pool (the second reads the first's KV),
    with a ragged and a padded row: the same logits and pool.  Over an f32
    pool: logits at 1e-4, pool at 1e-5.  Over the bf16 pool the engine
    keeps, a K or V value within f32 rounding of a bf16 boundary may round
    either way (one bf16 step, in a few entries per thousand), and the
    rows that read it move by up to 1e-3; every other row stays within
    1e-4."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    bf16 = pool_dtype == "bfloat16"
    rng = np.random.default_rng(4)
    B, C, bs, T = 4, 8, 8, 4
    n_blocks = 1 + 3 * T
    jcache = jm.init_paged_cache(n_blocks, bs, getattr(jnp, pool_dtype))
    tcache = tm.init_paged_cache(n_blocks, bs, getattr(torch, pool_dtype))
    tables = np.zeros((B, T), np.int32)
    tables[:3] = rng.permutation(np.arange(1, n_blocks)).reshape(3, T)
    for starts, lengths in (([0, 0, 0, 0], [8, 5, 8, 0]),
                            ([8, 5, 8, 0], [8, 2, 3, 0])):
        args = _chunk_args(rng, cfg, B, C, T, starts, lengths, tables)
        lj, jcache = jax.jit(jm.prefill_chunk_paged)(
            jp, jcache, *map(jnp.asarray, args))
        lt, tcache = tm.prefill_chunk_paged(tp, tcache, *map(_t, args))
        row_err = np.abs(lt.numpy() - np.asarray(lj)).max(axis=1)
        assert row_err.max() <= (1e-3 if bf16 else 1e-4), row_err
        assert np.median(row_err) <= 1e-4, row_err
    for name in ("k", "v"):
        got = tcache["attn"][name].float().numpy()[:, 1:]
        want = np.asarray(jcache["attn"][name], np.float32)[:, 1:]
        step = 2.0 ** -7 * np.abs(want)           # one bf16 step
        assert (np.abs(got - want) <= (step if bf16 else 1e-5)).all()
        assert (got != want).mean() <= (2e-3 if bf16 else 1.0)


def test_chunked_prefill_matches_whole_prompt_prefill(models):
    """The port alone: two chunks of a prompt over an f32 pool give the
    logits of one whole-prompt ragged prefill of it."""
    _, _, tm, tp = models
    rng = np.random.default_rng(6)
    bs, T, n = 8, 4, 13
    prompt = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (1, n))
                              .astype(np.int32))
    want, _ = tm.prefill_ragged(tp, prompt, torch.tensor([n], dtype=torch.int32))
    cache = tm.init_paged_cache(1 + T, bs, torch.float32)
    table = torch.arange(1, T + 1, dtype=torch.int32)[None]
    for start, take in ((0, 8), (8, 5)):
        tokens = torch.zeros(1, 8, dtype=torch.int32)
        tokens[0, :take] = prompt[0, start:start + take]
        got, cache = tm.prefill_chunk_paged(
            tp, cache, tokens, torch.tensor([start], dtype=torch.int32),
            torch.tensor([take], dtype=torch.int32), table)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# the chunked engine
# ---------------------------------------------------------------------------

STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")
POOL_STATS = ("shared_block_hits", "pending_share_waits")


def _workload(vocab, n=8, max_new=16):
    """launch/serve.py's request stream: (prompt, max_new_tokens) pairs."""
    rng = np.random.default_rng(0)
    return [([int(t) for t in rng.integers(0, vocab, int(rng.integers(4, 24)))],
             max_new) for _ in range(n)]


def _serve(engine_cls, knobs_cls, req_cls, model, params, **kw):
    eng = engine_cls(model, params, max_seq=128, n_slots=4,
                     knobs=knobs_cls(max_batch=4), paged=True, block_size=16,
                     **kw)
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
        **{k: getattr(eng.pool, k) for k in POOL_STATS},
        "used_blocks": eng.pool.used_blocks,
    }


@pytest.mark.parametrize("horizon,chunk,n_blocks", [
    (1, 8, None), (4, 16, None), (4, 8, 10), (1, 16, 10)])
def test_chunked_engine_matches_reference(models, horizon, chunk, n_blocks):
    """n_blocks=10 (9 usable) cannot hold 4 growing lanes: preemption."""
    jm, jp, tm, tp = models
    kw = dict(horizon=horizon, prefill_chunk=chunk, n_blocks=n_blocks)
    ref = _serve(JEngine, JKnobs, JRequest, jm, jp, **kw)
    got = _serve(Engine, EngineKnobs, Request, tm, tp, **kw)
    assert got == ref
    assert got["completed"] == 8 and got["used_blocks"] == 0
    assert all(len(s) == 16 for s in got["streams"])
    if n_blocks is not None:
        assert got["preemptions"] > 0
