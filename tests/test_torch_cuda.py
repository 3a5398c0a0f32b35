"""The CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips (with the reason) where there is no CUDA
device or no ``nvcc``; run them on a GPU machine with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The module imports no JAX, so it runs where only PyTorch is installed.
Tolerances: f32 at 1e-4 (sums in another order than the plain version),
bf16 at 2e-2 (rounding of P and of the output to bf16); besides, the
error's norm over the plain output's norm stays below 1e-5 (f32) or 1e-2
(bf16), a bound that scales with outputs that shrink at long contexts."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int8_matmul as i8
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pa
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.kernels import rwkv6_wkv as wkv
from repro_torch.models import build_model, local_plan

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def assert_close(got, want, dtype):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=0)
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    assert rel <= REL_TOL[dtype], f"relative error {rel:.3e}"


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D", [
    (2, 8, 2, 64, 64), (1, 4, 4, 200, 128), (3, 4, 1, 37, 32),
    (2, 32, 32, 513, 128), (2, 4, 2, 24, 16),
])
def test_flash_kernel_matches_plain(gen, dtype, B, H, K, S, D):
    q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    v = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    before = fa.flash_attention.launches
    o = fa.flash_attention(*args)
    assert fa.flash_attention.launches == before + 1
    assert o.stride() == args[0].stride()          # output keeps q's layout
    assert_close(o, fa.flash_attention_ref(*args), dtype)


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,H,K,D,bs,T", [
    (2, 8, 2, 64, 16, 8), (1, 4, 4, 128, 32, 4), (3, 4, 1, 64, 16, 8),
    (2, 64, 8, 128, 16, 20), (4, 8, 8, 32, 8, 6),
])
def test_paged_decode_kernel_matches_plain(gen, q_dt, kv_dt, B, H, K, D, bs, T):
    n_blocks = 1 + B * T
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    pos = torch.randint(0, T * bs, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    vp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    o = ops.paged_decode_attention(q, kp, vp, tables, pos)
    ref = pa.paged_decode_attention_ref(q, kp, vp, tables, pos)
    assert_close(o, ref, max(q_dt, kv_dt, key=TOL.get))


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,C,H,K,D,bs,T", [
    (2, 16, 8, 2, 64, 16, 8), (3, 8, 4, 4, 128, 32, 4),
    (2, 5, 4, 1, 32, 8, 10), (2, 128, 32, 32, 128, 16, 24),
    (2, 16, 64, 8, 128, 16, 20), (1, 24, 4, 2, 16, 8, 6),
])
def test_paged_prefill_kernel_matches_plain(gen, q_dt, kv_dt, B, C, H, K, D,
                                            bs, T):
    """Scrambled tables, one start at 0 and one mid-table, and a padded
    lane (table of zeros, start 0) reading only the parking block."""
    n_blocks = 1 + B * T
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    starts = torch.randint(0, T * bs - C + 1, (B,), generator=gen,
                           device="cuda", dtype=torch.int32)
    starts[0] = 0
    if B > 2:
        tables[-1] = 0
        starts[-1] = 0
    q = torch.randn(B, C, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    vp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    before = ppa.paged_prefill_attention.launches
    o = ops.paged_prefill_attention(q, kp, vp, tables, starts)
    assert ppa.paged_prefill_attention.launches == before + 1
    ref = ppa.paged_prefill_attention_ref(q, kp, vp, tables, starts)
    assert_close(o, ref, max(q_dt, kv_dt, key=TOL.get))
    v = ops.paged_verify_attention(q, kp, vp, tables, starts)
    assert ppa.paged_prefill_attention.launches == before + 2
    assert torch.equal(o, v)


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,H,K,D,S", [
    (2, 8, 2, 64, 64), (1, 4, 4, 128, 100), (3, 4, 1, 32, 37),
    (4, 32, 32, 128, 2048), (2, 64, 8, 128, 1000), (2, 4, 2, 16, 24),
])
def test_decode_kernel_matches_plain(gen, q_dt, kv_dt, B, H, K, D, S):
    """Contiguous cache, S not always a multiple of the key tile, one lane
    at the last position and one parked at 0; held against the plain
    version of the slot model path (``flash_decode_ref``, what the
    dispatcher takes on the CPU) and against the oracle."""
    pos = torch.randint(0, S, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[0] = S - 1
    if B > 1:
        pos[-1] = 0
    q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=q_dt)
    k = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=kv_dt)
    v = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=kv_dt)
    before = da.decode_attention.launches
    o = ops.decode_attention(q, k, v, pos)
    assert da.decode_attention.launches == before + 1
    dt = max(q_dt, kv_dt, key=TOL.get)
    assert_close(o, da.flash_decode_ref(q, k, v, pos), dt)
    assert_close(o, da.decode_attention_ref(q, k, v, pos), dt)


def _striped_inputs(gen, shards, B, H, K, D, bs, T, q_dt, kv_dt):
    """A pool of a multiple of ``shards`` blocks, scrambled tables over all
    of it (every stripe holds blocks of most lanes), one lane at the last
    position and one at position 0 (its one live key in one stripe)."""
    n_blocks = -(-(1 + B * T) // shards) * shards
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    pos = torch.randint(0, T * bs, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[0] = T * bs - 1
    if B > 1:
        pos[-1] = 0
    q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    vp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    return q, kp, vp, tables, pos


def _stripe_args(kp, vp, tables, r, shards):
    nb_loc = kp.shape[0] // shards
    local = tables - r * nb_loc
    owned = ((local >= 0) & (local < nb_loc)).to(torch.int32)
    return (kp[r * nb_loc:(r + 1) * nb_loc], vp[r * nb_loc:(r + 1) * nb_loc],
            local.clamp(0, nb_loc - 1), owned)


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,H,K,D,bs,T", [
    (2, 8, 2, 64, 16, 8), (1, 4, 4, 128, 32, 4), (3, 4, 1, 64, 16, 8),
    (2, 64, 8, 128, 16, 20), (4, 8, 8, 32, 8, 6), (3, 8, 2, 128, 8, 40),
])
@pytest.mark.parametrize("shards", [2, 4])
def test_paged_decode_lse_kernel_matches_plain(gen, q_dt, kv_dt, shards, B,
                                               H, K, D, bs, T):
    """Kernel 4 per stripe against its plain version (GQA, MHA and MQA,
    head dims 32/64/128, block sizes 8/16/32): o at the dtype's
    tolerance, lse at 1e-4 where finite and -1e30 exactly where the
    stripe saw no key; the stripes' ``combine_lse`` against kernel 2 and
    its plain version over the whole pool."""
    q, kp, vp, tables, pos = _striped_inputs(gen, shards, B, H, K, D, bs, T,
                                             q_dt, kv_dt)
    dt = max(q_dt, kv_dt, key=TOL.get)
    os_, lses = [], []
    for r in range(shards):
        args = (q, *_stripe_args(kp, vp, tables, r, shards))
        k_s, v_s, local, owned = args[1:]
        before = pa.paged_decode_attention_lse.launches
        o, lse = ops.paged_decode_attention_lse(q, k_s, v_s, local, pos, owned)
        assert pa.paged_decode_attention_lse.launches == before + 1
        o_ref, lse_ref = pa.paged_decode_attention_lse_ref(q, k_s, v_s, local,
                                                           pos, owned)
        assert o.dtype == q_dt and lse.dtype == torch.float32
        assert_close(o, o_ref, dt)
        empty = lse_ref == -1e30
        assert torch.equal(lse == -1e30, empty)
        torch.testing.assert_close(lse[~empty], lse_ref[~empty], atol=1e-4,
                                   rtol=0)
        assert (o[empty] == 0).all()
        os_.append(o)
        lses.append(lse)
    got = pa.combine_lse(torch.stack(os_), torch.stack(lses))
    assert_close(got, pa.paged_decode_attention_ref(q, kp, vp, tables, pos),
                 dt)
    assert_close(got, pa.paged_decode_attention(q, kp, vp, tables, pos), dt)


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,C,H,K,D,bs,T", [
    (2, 16, 8, 2, 64, 16, 8), (3, 8, 4, 4, 128, 32, 4),
    (2, 5, 4, 1, 32, 8, 10), (2, 128, 32, 32, 128, 16, 24),
    (1, 24, 4, 2, 16, 8, 6), (2, 40, 16, 16, 256, 16, 6),
    (3, 33, 40, 40, 96, 8, 12),
])
@pytest.mark.parametrize("shards", [2, 4])
def test_paged_prefill_lse_kernel_matches_plain(gen, q_dt, kv_dt, shards, B,
                                                C, H, K, D, bs, T):
    """Kernel 3's owned/LSE form per stripe against its plain version
    (GQA, MHA and MQA, head dims 16-256, block sizes 8/16/32, one lane at
    0, the others mid-table, a padded lane): o at the dtype's tolerance,
    lse at 1e-4 where finite and -1e30 exactly where the stripe saw no
    key (o 0 there); the stripes' ``combine_lse`` against kernel 3 and its
    plain version over the whole pool; each bf16 launch on the tensor
    cores.  Its inputs come from a generator of its own, so the tests
    after it draw from ``gen`` what they drew before it was added."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    n_blocks = -(-(1 + B * T) // shards) * shards
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    starts = torch.randint(0, T * bs - C + 1, (B,), generator=gen,
                           device="cuda", dtype=torch.int32)
    starts[0] = 0
    if B > 2:
        tables[-1] = 0
        starts[-1] = 0
    q = torch.randn(B, C, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp, vp = (torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                          dtype=kv_dt) for _ in range(2))
    dt = max(q_dt, kv_dt, key=TOL.get)
    os_, lses = [], []
    for r in range(shards):
        k_s, v_s, local, owned = _stripe_args(kp, vp, tables, r, shards)
        before = (ppa.paged_prefill_attention_lse.launches,
                  ppa.paged_prefill_attention_lse.tensor_core)
        o, lse = ops.paged_prefill_attention_lse(q, k_s, v_s, local, starts,
                                                 owned)
        assert (ppa.paged_prefill_attention_lse.launches,
                ppa.paged_prefill_attention_lse.tensor_core) == \
            (before[0] + 1, before[1] + (q_dt == torch.bfloat16))
        o_ref, lse_ref = ppa.paged_prefill_attention_lse_ref(
            q, k_s, v_s, local, starts, owned)
        assert o.dtype == q_dt and lse.shape == (B, C, H)
        assert_close(o, o_ref, dt)
        empty = lse_ref == -1e30
        assert torch.equal(lse == -1e30, empty)
        torch.testing.assert_close(lse[~empty], lse_ref[~empty], atol=1e-4,
                                   rtol=0)
        assert (o[empty] == 0).all()
        os_.append(o)
        lses.append(lse)
    got = pa.combine_lse(torch.stack(os_), torch.stack(lses))
    assert_close(got, ppa.paged_prefill_attention_ref(q, kp, vp, tables,
                                                      starts), dt)
    assert_close(got, ppa.paged_prefill_attention(q, kp, vp, tables, starts),
                 dt)


def test_paged_prefill_lse_kernel_edges(gen):
    """A stripe that owns nothing gives o = 0 and lse = -1e30 everywhere,
    in bf16 and f32; the wrapper refuses owned of another dtype or
    shape.  A generator of its own, as above."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    B, C, H, K, D, bs, T = 3, 16, 8, 2, 64, 16, 8
    n_blocks = 2 * (1 + B * T)
    tables = torch.randint(1, n_blocks, (B, T), generator=gen, device="cuda",
                           dtype=torch.int32)
    starts = torch.tensor([0, 40, 100], dtype=torch.int32, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(B, C, H, D, generator=gen, device="cuda", dtype=dt)
        kp, vp = (torch.randn(n_blocks, bs, K, D, generator=gen,
                              device="cuda", dtype=dt) for _ in range(2))
        owned = torch.zeros_like(tables)
        o, lse = ppa.paged_prefill_attention_lse(q, kp, vp, tables % 10,
                                                 starts, owned)
        assert (o == 0).all() and (lse == -1e30).all()
    with pytest.raises(TypeError):
        ppa.paged_prefill_attention_lse(q, kp, vp, tables, starts,
                                        owned.long())
    with pytest.raises(ValueError):
        ppa.paged_prefill_attention_lse(q, kp, vp, tables, starts,
                                        owned[:, :-1].contiguous())


def _striped(gen, pattern, nb_loc):
    """Tables whose slot (b, j) names a distinct block of stripe
    ``pattern[b][j]`` of a pool of ``len(pattern)``-independent stripes of
    ``nb_loc`` blocks; returns the global tables."""
    shards = int(pattern.max()) + 1
    tables = torch.empty_like(pattern)
    for r in range(shards):
        where = pattern == r
        ids = torch.randperm(nb_loc - 1, generator=gen, device="cuda")[
            : int(where.sum())] + 1
        tables[where] = (r * nb_loc + ids).to(torch.int32)
    return tables


# kernel 3's owned/LSE form at its split edges: name -> (B, C, H, K, D, bs,
# T, starts).  "boundary": lane 0's walk in stripe 0 is 16 whole blocks of
# 16 ending on its last visible block, two splits of the plan's 128 keys
# exactly, and lane 1 (start 0, one visible block) owns one block in
# stripe 1 and none in stripe 0; bs 24 and 40 cut the 64-key tiles; C 129
# is two query tiles with a ragged second; D = 256 is gemma-7b's.
LSE_SPLIT_CASES = {
    "boundary": (2, 16, 8, 2, 64, 16, 64, (400, 0)),
    "bs24": (3, 40, 16, 16, 128, 24, 20, (0, 200, 439)),
    "bs40 G3": (2, 33, 24, 8, 96, 40, 12, (7, 300)),
    "ragged C 129": (2, 129, 4, 4, 64, 8, 64, (0, 300)),
    "D256": (2, 40, 16, 16, 256, 16, 24, (0, 300)),
}


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", sorted(LSE_SPLIT_CASES))
def test_paged_prefill_lse_kernel_at_split_edges(gen, case, shards):
    """The bf16 owned/LSE form (its owned walk split over CTAs, the
    splits merged in the launch) per stripe against the one-pass plain
    version and the split version at the plan's L (bf16 tolerance), lse
    at 1e-4 and the rows without an owned key exactly empty; the stripes'
    ``combine_lse`` against kernel 3 over the whole pool; the f32 route
    against its plain version; every ticket counter 0 afterwards.  A
    generator of its own."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    B, C, H, K, D, bs, T, st = LSE_SPLIT_CASES[case]
    nb_loc = B * T + 1
    pattern = torch.randint(0, shards, (B, T), generator=gen, device="cuda",
                            dtype=torch.int32)
    if case == "boundary":
        pattern[0, :26] = torch.tensor([0, 1] * 10 + [0] * 6,
                                       dtype=torch.int32, device="cuda")
        pattern[1, 0] = 1
        L, _ = ppa.paged_prefill_split_plan(B, C, H, K, T, bs)
        assert (L, st[0] + C) == (128, 26 * bs)   # 16 owned blocks = 2 L
    tables = _striped(gen, pattern, nb_loc)
    starts = torch.tensor(st, dtype=torch.int32, device="cuda")
    q = torch.randn(B, C, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp, vp = (torch.randn(shards * nb_loc, bs, K, D, generator=gen,
                          device="cuda", dtype=torch.bfloat16)
              for _ in range(2))
    L, _ = ppa.paged_prefill_split_plan(B, C, H, K, T, bs)
    os_, lses = [], []
    for r in range(shards):
        k_s, v_s, local, owned = _stripe_args(kp, vp, tables, r, shards)
        args = (q, k_s, v_s, local, starts, owned)
        o, lse = ppa.paged_prefill_attention_lse(*args)
        o_ref, lse_ref = ppa.paged_prefill_attention_lse_ref(*args)
        o_split, _ = ppa.paged_prefill_attention_lse_split_ref(*args, L)
        assert_close(o, o_ref, torch.bfloat16)
        assert_close(o, o_split, torch.bfloat16)
        empty = lse_ref == -1e30
        assert torch.equal(lse == -1e30, empty)
        assert (o[empty] == 0).all()
        torch.testing.assert_close(lse[~empty], lse_ref[~empty], atol=1e-4,
                                   rtol=0)
        if case == "boundary":
            assert bool(empty[1].all()) == (r != 1)
        f_args = (q.float(), *args[1:])
        fo, flse = ppa.paged_prefill_attention_lse(*f_args)
        fo_ref, flse_ref = ppa.paged_prefill_attention_lse_ref(*f_args)
        assert_close(fo, fo_ref, torch.bfloat16)   # P rounded to the pool
        assert torch.equal(flse == -1e30, flse_ref == -1e30)
        os_.append(o)
        lses.append(lse)
    got = pa.combine_lse(torch.stack(os_), torch.stack(lses))
    assert_close(got, ppa.paged_prefill_attention(q, kp, vp, tables, starts),
                 torch.bfloat16)
    torch.cuda.synchronize()
    assert all(int(t.abs().sum()) == 0 for t in da._TICKETS.values())


def test_paged_decode_lse_kernel_edges(gen):
    """A stripe that owns nothing gives o = 0 and lse = -1e30 everywhere;
    a lane at a negative position sees no key; the wrapper refuses owned
    of another dtype or shape."""
    q, kp, vp, tables, pos = _striped_inputs(gen, 2, 3, 8, 2, 64, 16, 8,
                                             torch.bfloat16, torch.bfloat16)
    k_s, v_s, local, owned = _stripe_args(kp, vp, tables, 0, 2)
    o, lse = pa.paged_decode_attention_lse(q, k_s, v_s, local, pos,
                                           torch.zeros_like(owned))
    assert (o == 0).all() and (lse == -1e30).all()
    pos = pos.clone()
    pos[1] = -1
    o, lse = pa.paged_decode_attention_lse(q, k_s, v_s, local, pos,
                                           torch.ones_like(owned))
    assert (o[1] == 0).all() and (lse[1] == -1e30).all()
    with pytest.raises(TypeError):
        pa.paged_decode_attention_lse(q, k_s, v_s, local, pos, owned.long())
    with pytest.raises(ValueError):
        pa.paged_decode_attention_lse(q, k_s, v_s, local, pos,
                                      owned[:, :-1].contiguous())


def test_kernel_wrappers_raise_on_bad_input(gen):
    q = torch.zeros(1, 2, 16, 48, device="cuda")          # head dim 48
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    pool = torch.zeros(3, 8, 2, 32, device="cuda")
    tab = torch.zeros(1, 2, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError):
        pa.paged_decode_attention(torch.zeros(1, 2, 32, device="cuda"), pool,
                                  pool, tab,
                                  torch.zeros(1, dtype=torch.int32,
                                              device="cuda"))
    with pytest.raises(ValueError):                      # head dim 48
        ppa.paged_prefill_attention(torch.zeros(1, 4, 2, 48, device="cuda"),
                                    torch.zeros(3, 8, 2, 48, device="cuda"),
                                    torch.zeros(3, 8, 2, 48, device="cuda"),
                                    tab.int(), torch.zeros(1, dtype=torch.int32,
                                                           device="cuda"))
    with pytest.raises(ValueError):                      # H not a multiple of K
        da.decode_attention(torch.zeros(1, 3, 32, device="cuda"),
                            torch.zeros(1, 8, 2, 32, device="cuda"),
                            torch.zeros(1, 8, 2, 32, device="cuda"),
                            torch.zeros(1, dtype=torch.int32, device="cuda"))


def test_smoke_model_kernel_path_matches_plain_path(gen):
    """A smoke-size model's prefill logits through the kernels vs through
    the plain versions, both on the card, at f32."""
    cfg = get_config("llama2-7b").smoke_config()
    m = build_model(cfg, local_plan(param_dtype=torch.float32,
                                    compute_dtype=torch.float32))
    p = m.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (3, 32), generator=gen,
                           device="cuda", dtype=torch.int32)
    lengths = torch.tensor([32, 7, 20], dtype=torch.int32, device="cuda")
    lk, _ = m.prefill_ragged(p, tokens, lengths)
    saved = ops.flash_attention
    ops.flash_attention = fa.flash_attention_ref
    try:
        lp, _ = m.prefill_ragged(p, tokens, lengths)
    finally:
        ops.flash_attention = saved
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)


def test_smoke_model_chunk_and_slot_paths_match_plain_path(gen):
    """A smoke-size model's chunked-prefill logits (kernel 3) and slot
    decode logits (kernel 5) through the kernels vs through the plain
    versions, both on the card, all in f32."""
    cfg = get_config("llama2-7b").smoke_config()
    m = build_model(cfg, local_plan(param_dtype=torch.float32,
                                    compute_dtype=torch.float32))
    p = m.init(torch.Generator(device="cuda").manual_seed(0))
    B, C, bs, T = 3, 16, 8, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=gen,
                           device="cuda", dtype=torch.int32)
    starts = torch.tensor([0, 16, 40], dtype=torch.int32, device="cuda")
    lengths = torch.tensor([16, 5, 16], dtype=torch.int32, device="cuda")
    tables = (1 + torch.arange(B * T, device="cuda", dtype=torch.int32)
              ).reshape(B, T)
    pool = m.init_paged_cache(1 + B * T, bs, dtype=torch.float32)
    for leaf in pool["attn"].values():
        leaf.normal_(generator=gen)
    cache = m.init_cache(B, 64, dtype=torch.float32)
    for leaf in cache["attn"].values():
        leaf.normal_(generator=gen)
    pos = torch.tensor([63, 0, 30], dtype=torch.int32, device="cuda")
    pool2 = {"attn": {n: t.clone() for n, t in pool["attn"].items()}}
    cache2 = {"attn": {n: t.clone() for n, t in cache["attn"].items()}}
    lk, _ = m.prefill_chunk_paged(p, pool, tokens, starts, lengths, tables)
    dk, _ = m.decode_step(p, cache, tokens[:, 0].contiguous(), pos)
    saved = ops.paged_prefill_attention, ops.decode_attention
    ops.paged_prefill_attention = ppa.paged_prefill_attention_ref
    ops.decode_attention = da.flash_decode_ref
    try:
        lp, _ = m.prefill_chunk_paged(p, pool2, tokens, starts, lengths,
                                      tables)
        dp, _ = m.decode_step(p, cache2, tokens[:, 0].contiguous(), pos)
    finally:
        ops.paged_prefill_attention, ops.decode_attention = saved
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)
    torch.testing.assert_close(dk, dp, atol=1e-4, rtol=0)
    # the same rows written; from layer 1 on their values carry the
    # attention outputs' rounding differences
    for n in ("k", "v"):
        torch.testing.assert_close(pool["attn"][n][:, 1:],
                                   pool2["attn"][n][:, 1:], atol=1e-4, rtol=0)
        torch.testing.assert_close(cache["attn"][n], cache2["attn"][n],
                                   atol=1e-4, rtol=0)


def _wkv_inputs(gen, B, T, H, D, dtype, zero_state=False):
    """r/k/v in ``dtype``; w = exp(-exp(dw)) around the model's init decay
    (dw = -6 + N(0, 1)), u and s0 f32."""
    r, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda",
                           dtype=dtype) for _ in range(3))
    dw = -6.0 + torch.randn(B, T, H, D, generator=gen, device="cuda")
    w = torch.exp(-torch.exp(dw))
    u = 0.1 * torch.randn(H, D, generator=gen, device="cuda")
    s0 = None if zero_state else torch.randn(B, H, D, D, generator=gen,
                                             device="cuda")
    return r, k, v, w, u, s0


def assert_wkv_close(got, want, dtype):
    """The state sums ~1/(1 - w) steps (~400 at the init decay), so |y|
    reaches the hundreds: held by the error's max over max |plain| and
    its norm over the plain norm (summation order, not defects, sets the
    absolute error)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= TOL[dtype] * max(want.abs().max().item(), 1.0), err
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    assert rel <= REL_TOL[dtype], f"relative error {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,D,zero", [
    (4, 1, 40, 64, False),     # decode: one step from a carried state
    (1, 200, 40, 64, True),    # prefill from a zero state
    (2, 37, 3, 64, False),     # ragged T
    (1, 64, 2, 32, False), (2, 128, 4, 64, False),   # test_kernels.py's
    (2, 50, 3, 16, False), (1, 33, 2, 128, True),
])
def test_wkv_kernel_matches_plain(gen, dtype, B, T, H, D, zero):
    args = _wkv_inputs(gen, B, T, H, D, dtype, zero_state=zero)
    before = wkv.rwkv6_wkv.launches
    y, s = wkv.rwkv6_wkv(*args)
    torch.cuda.synchronize()
    assert wkv.rwkv6_wkv.launches == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    y_ref, s_ref = wkv.rwkv6_wkv_ref(*args)
    assert_wkv_close(y, y_ref, dtype)
    assert_wkv_close(s, s_ref, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_carries_state_in_place(gen, dtype):
    """Two calls (120 + 80 steps) equal one call of 200; eight one-step
    calls written over their own state (``s_out = s0``) equal one call of
    eight; strided (B, T, H, D) views run as their copies do."""
    r, k, v, w, u, _ = _wkv_inputs(gen, 1, 200, 40, 64, dtype)
    y, s = wkv.rwkv6_wkv(r, k, v, w, u)
    y1, s1 = wkv.rwkv6_wkv(r[:, :120], k[:, :120], v[:, :120], w[:, :120], u)
    y2, s2 = wkv.rwkv6_wkv(r[:, 120:], k[:, 120:], v[:, 120:], w[:, 120:], u,
                           s1)
    assert_wkv_close(torch.cat([y1, y2], 1), y, dtype)
    assert_wkv_close(s2, s, torch.float32)
    state = torch.zeros(1, 40, 64, 64, device="cuda")
    ys = []
    for t in range(8):
        yt, st = wkv.rwkv6_wkv(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                               w[:, t:t + 1], u, state, s_out=state)
        assert st is state
        ys.append(yt)
    y8, s8 = wkv.rwkv6_wkv(r[:, :8], k[:, :8], v[:, :8], w[:, :8], u)
    torch.testing.assert_close(torch.cat(ys, 1), y8, atol=0, rtol=0)
    torch.testing.assert_close(state, s8, atol=0, rtol=0)
    big = torch.randn(1, 50, 40, 3 * 64, generator=gen, device="cuda",
                      dtype=dtype)
    rs, ks, vs = big[..., :64], big[..., 64:128], big[..., 128:]
    ws = w[:, :50]
    ys_, ss_ = wkv.rwkv6_wkv(rs, ks, vs, ws, u)
    yc, sc = wkv.rwkv6_wkv(rs.contiguous(), ks.contiguous(), vs.contiguous(),
                           ws.contiguous(), u)
    torch.testing.assert_close(ys_, yc, atol=0, rtol=0)
    torch.testing.assert_close(ss_, sc, atol=0, rtol=0)


def test_wkv_wrapper_raises_on_bad_input(gen):
    r, k, v, w, u, s0 = _wkv_inputs(gen, 2, 5, 3, 32, torch.float32)
    before = wkv.rwkv6_wkv.launches
    bad = [
        dict(w=w.bfloat16()),                       # w must be f32
        dict(r=r.bfloat16()),                       # r/k/v of one dtype
        dict(u=u[:2]),                              # u (H, D)
        dict(s0=s0[:1]),                            # s0 (B, H, D, D)
        dict(r=torch.randn(2, 5, 3, 64, device="cuda")[..., ::2]),
        dict(s0=s0.transpose(2, 3)),                # non-contiguous state
        dict(s0=s0.cpu()),                          # device mix
    ]
    for kw in bad:
        args = dict(r=r, k=k, v=v, w=w, u=u, s0=s0) | kw
        with pytest.raises((ValueError, TypeError)):
            wkv.rwkv6_wkv(**args)
    for d in (40, 144):                              # D % 16 != 0, D > 128
        rd = torch.randn(2, 5, 3, d, device="cuda")
        with pytest.raises(ValueError):
            wkv.rwkv6_wkv(rd, rd, rd, rd.abs(), torch.zeros(3, d,
                                                            device="cuda"))
    flat = torch.zeros(2 * 3 * 32 * 32 + 32, device="cuda")
    with pytest.raises(ValueError):                 # s_out overlaps s0
        wkv.rwkv6_wkv(r, k, v, w, u, flat[:s0.numel()].view_as(s0),
                      s_out=flat[32:].view_as(s0))
    with pytest.raises(ValueError):
        wkv.rwkv6_wkv(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu())
    assert wkv.rwkv6_wkv.launches == before


def test_smoke_rwkv_kernel_path_matches_plain_path(gen):
    """rwkv6-3b's smoke model, f32: prefill logits and state, then a slot
    decode step written in place, through kernel 7 vs through its plain
    version, both on the card."""
    cfg = get_config("rwkv6-3b").smoke_config()
    m = build_model(cfg, local_plan(param_dtype=torch.float32,
                                    compute_dtype=torch.float32))
    p = m.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (3, 29), generator=gen,
                           device="cuda", dtype=torch.int32)
    before = wkv.rwkv6_wkv.launches
    lk, ck = m.prefill(p, tokens)
    dk, _ = m.decode_step(p, ck, tokens[:, 0].contiguous(),
                          torch.full((3,), 29, dtype=torch.int32,
                                     device="cuda"))
    assert wkv.rwkv6_wkv.launches == before + 2 * cfg.num_layers
    saved = ops.rwkv6_wkv
    ops.rwkv6_wkv = wkv.rwkv6_wkv_ref
    try:
        lp, cp = m.prefill(p, tokens)
        dp, _ = m.decode_step(p, cp, tokens[:, 0].contiguous(),
                              torch.full((3,), 29, dtype=torch.int32,
                                         device="cuda"))
    finally:
        ops.rwkv6_wkv = saved
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)
    torch.testing.assert_close(dk, dp, atol=1e-4, rtol=0)
    for part in ("tmix", "cmix"):
        for name, leaf in ck[part].items():
            torch.testing.assert_close(leaf, cp[part][name], atol=1e-4,
                                       rtol=1e-4)


def test_serve_cli_rwkv_on_cuda_matches_cpu(gen):
    """rwkv6-3b's serve CLI on the card runs kernel 7 in slot mode (its
    serve form only: no captured or eager serving step reaches
    ``ops.WkvFn``'s training form) and prints the same dict as on the
    CPU."""
    from repro_torch.launch import serve
    argv = ["--arch", "rwkv6-3b", "--smoke", "--requests", "4",
            "--max-new", "6"]
    wkv.rwkv6_wkv.launches = 0
    train = wkv.rwkv6_wkv_train.launches
    got = serve.main(argv)
    assert wkv.rwkv6_wkv.launches > 0 and got["mode"] == "slots"
    assert wkv.rwkv6_wkv_train.launches == train
    assert got == serve.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("mode", [[], ["--no-paged"]])
def test_serve_cli_modes_on_cuda_match_cpu(gen, mode):
    """The paged and slot serve CLI on the card print the same dict as on
    the CPU (no eos in its workload, so the counters do not depend on the
    weights)."""
    from repro_torch.launch import serve
    assert serve.main(["--smoke", *mode]) == \
        serve.main(["--smoke", *mode, "--device", "cpu"])


def test_serve_cli_on_cuda_matches_cpu(gen):
    """The serve CLI's default device runs both kernels and prints the
    same counters as its CPU run (serve's workload has no eos, so they do
    not depend on the weights)."""
    from repro_torch.launch import serve
    fa.flash_attention.launches = pa.paged_decode_attention.launches = 0
    got = serve.main(["--smoke"])
    assert fa.flash_attention.launches > 0
    assert pa.paged_decode_attention.launches > 0
    assert got == serve.main(["--smoke", "--device", "cpu"])


@pytest.mark.parametrize("shards", [2, 4])
def test_smoke_model_sharded_decode_matches_plain_and_unsharded(gen, shards):
    """One paged decode step of a smoke-size model (4 kv heads) under a
    sharded plan, all f32: kernel 4 against its plain version, and
    against the unsharded step through kernel 2, on one pool state."""
    from repro_torch.models import transformer as TR
    from repro_torch.serving import serving_plan
    cfg = get_config("llama2-7b").smoke_config().replace(n_kv_heads=4)
    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    m1 = build_model(cfg, local_plan(**f32))
    ms = build_model(cfg, serving_plan(shards, **f32))
    p = m1.init(torch.Generator(device="cuda").manual_seed(0))
    B, bs, T = 4, 8, 6
    n_blocks = 4 + B * T
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    pos = torch.tensor([47, 0, 20, 9], dtype=torch.int32, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                           device="cuda", dtype=torch.int32)
    pool = m1.init_paged_cache(n_blocks, bs, dtype=torch.float32)
    for leaf in pool["attn"].values():
        leaf.normal_(generator=gen)
    copies = [TR.L.tree_map(torch.clone, pool) for _ in range(2)]
    before = pa.paged_decode_attention_lse.launches
    lk, _ = ms.decode_step_paged(p, pool, tokens, pos, tables)
    assert pa.paged_decode_attention_lse.launches == \
        before + shards * cfg.num_layers
    saved = ops.paged_decode_attention_lse
    ops.paged_decode_attention_lse = pa.paged_decode_attention_lse_ref
    try:
        lp, _ = ms.decode_step_paged(p, copies[0], tokens, pos, tables)
    finally:
        ops.paged_decode_attention_lse = saved
    l1, _ = m1.decode_step_paged(p, copies[1], tokens, pos, tables)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)
    torch.testing.assert_close(lk, l1, atol=1e-4, rtol=0)
    for n in ("k", "v"):
        torch.testing.assert_close(pool["attn"][n], copies[1]["attn"][n],
                                   atol=1e-4, rtol=0)


def test_sharded_engine_spec_on_cuda(gen):
    """A 2-way ``EngineSpec`` engine on the card serves the CPU run's
    counters, every decode step through kernel 4 (2 stripes x 2 layers)
    and none through kernel 2; ``set_shards(1)`` goes back to kernel 2."""
    from repro_torch.serving import EngineSpec, Request
    cfg = get_config("llama2-7b").smoke_config()
    spec = EngineSpec(cfg, shards=2, max_seq=64, n_slots=4, block_size=8,
                      n_blocks=8, horizon=4)

    def run(eng):
        keys = ("decode_tokens", "prefill_tokens", "host_syncs",
                "preemptions")
        before = [getattr(eng.stats, k) for k in keys]
        for i in range(3):
            eng.submit(Request(prompt=[3 + i, 7, 11, 13 + i],
                               max_new_tokens=12))
        eng.run()
        return [getattr(eng.stats, k) - b for k, b in zip(keys, before)]

    eng = spec.build()
    pa.paged_decode_attention_lse.launches = 0
    pa.paged_decode_attention.launches = 0
    got = run(eng)
    steps = eng.stats.decode_syncs * eng.horizon
    assert pa.paged_decode_attention_lse.launches == 2 * 2 * steps
    assert pa.paged_decode_attention.launches == 0
    assert got == run(spec.build(device="cpu"))
    eng.set_shards(1)
    assert run(eng) == got and pa.paged_decode_attention.launches > 0


def _int8_inputs(gen, M, K, N):
    x_q = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.int8)
    w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.int8)
    sx = 0.01 + 0.09 * torch.rand(M, 1, generator=gen, device="cuda")
    sw = 0.01 + 0.09 * torch.rand(1, N, generator=gen, device="cuda")
    return x_q, w_q, sx, sw


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [
    (128, 256, 128), (256, 512, 256),           # the reference's test shapes
    (256, 1536, 512), (256, 512, 1536),         # granite's expert GEMMs
    (200, 1536, 520), (64, 100, 48),           # one operand staged by byte
    (65, 100, 33), (3, 7, 5), (1, 16, 16), (64, 0, 8),
])
def test_int8_matmul_kernel_is_bit_exact(gen, M, K, N, out_dtype):
    """Bit-exact against the plain version, at aligned (16-byte staging),
    half-ragged (x or w staged by byte) and ragged shapes, for both output
    types."""
    args = _int8_inputs(gen, M, K, N)
    before = i8.int8_matmul.launches
    out = i8.int8_matmul(*args, out_dtype=out_dtype)
    assert i8.int8_matmul.launches == before + 1
    assert out.dtype == out_dtype and out.shape == (M, N)
    assert torch.equal(out, i8.int8_matmul_ref(*args, out_dtype=out_dtype))


def test_int8_matmul_kernel_extremes_and_misaligned(gen):
    """Sums past 2**24 (every product 127 * 127, K = 4096: f32 rounds the
    sum, the same way on both sides), and operands that start one byte
    past a 16-byte boundary (the byte staging path)."""
    M, K, N = 64, 4096, 80
    x_q = torch.full((M, K), -127, dtype=torch.int8, device="cuda")
    w_q = torch.full((K, N), -127, dtype=torch.int8, device="cuda")
    x_q[::3] = 127
    sx = torch.full((M, 1), 0.37, device="cuda")
    sw = torch.full((1, N), 1.3, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(i8.int8_matmul(x_q, w_q, sx, sw, out_dtype=dt),
                           i8.int8_matmul_ref(x_q, w_q, sx, sw, out_dtype=dt))
    x_q, w_q, sx, sw = _int8_inputs(gen, 96, 64, 48)
    xs = torch.empty(x_q.numel() + 1, dtype=torch.int8, device="cuda")
    ws = torch.empty(w_q.numel() + 1, dtype=torch.int8, device="cuda")
    xs[1:] = x_q.reshape(-1)
    ws[1:] = w_q.reshape(-1)
    xm, wm = xs[1:].view(96, 64), ws[1:].view(64, 48)
    assert xm.is_contiguous() and xm.data_ptr() % 16 == 1
    assert torch.equal(i8.int8_matmul(xm, wm, sx, sw),
                       i8.int8_matmul_ref(x_q, w_q, sx, sw))


def test_int8_matmul_quantized_on_cuda(gen):
    """Quantize + kernel against quantize + plain, bit-exact, and within
    the reference's 2% of the f32 GEMM."""
    x = torch.randn(256, 1536, generator=gen, device="cuda")
    w = torch.randn(1536, 512, generator=gen, device="cuda")
    o = ops.int8_matmul_quantized(x, w)
    assert torch.equal(o, i8.int8_matmul_quantized_ref(x, w))
    o_ref = x @ w
    rel = ((o.float() - o_ref).abs().mean() / o_ref.abs().mean()).item()
    assert rel < 0.02, rel


def test_int8_matmul_wrapper_raises_on_bad_input(gen):
    x_q, w_q, sx, sw = _int8_inputs(gen, 32, 64, 48)
    before = i8.int8_matmul.launches
    with pytest.raises(ValueError):                       # not contiguous
        i8.int8_matmul(x_q, w_q.T.contiguous().T, sx, sw)
    with pytest.raises(ValueError):
        i8.int8_matmul(x_q.T.contiguous().T, w_q, sx, sw)
    with pytest.raises(TypeError):                        # wrong dtypes
        i8.int8_matmul(x_q.to(torch.uint8), w_q, sx, sw)
    with pytest.raises(TypeError):
        i8.int8_matmul(x_q, w_q.int(), sx, sw)
    with pytest.raises(TypeError):
        i8.int8_matmul(x_q, w_q, sx.double(), sw)
    with pytest.raises(TypeError):
        i8.int8_matmul(x_q, w_q, sx, sw, out_dtype=torch.float16)
    with pytest.raises(ValueError):                       # shapes
        i8.int8_matmul(x_q, w_q[:-1].contiguous(), sx, sw)
    with pytest.raises(ValueError):
        i8.int8_matmul(x_q, w_q, sx.reshape(1, -1), sw)
    with pytest.raises(ValueError):                       # a CPU scale
        i8.int8_matmul(x_q, w_q, sx.cpu(), sw)
    assert i8.int8_matmul.launches == before


@pytest.mark.parametrize("quantize", [False, True])
def test_smoke_moe_model_kernel_path_matches_plain_path(gen, quantize):
    """granite-moe's smoke model, both variants, at f32 (an f32 pool):
    prefill and one paged decode step through the kernels vs the plain
    versions."""
    cfg = get_config("granite-moe-3b-a800m").smoke_config()
    m = build_model(cfg, local_plan(param_dtype=torch.float32,
                                    compute_dtype=torch.float32,
                                    quantize_serve=quantize))
    p = m.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (3, 32), generator=gen,
                           device="cuda", dtype=torch.int32)
    lengths = torch.tensor([32, 7, 20], dtype=torch.int32, device="cuda")
    tables = torch.arange(1, 13, dtype=torch.int32, device="cuda") \
        .reshape(3, 4)
    pool = m.init_paged_cache(13, 16, dtype=torch.float32)
    nxt = tokens[:, 0].contiguous()

    def run():
        lp, _ = m.prefill_ragged(p, tokens, lengths)
        ld, _ = m.decode_step_paged(p, {"attn": {n: t.clone() for n, t in
                                                 pool["attn"].items()}},
                                    nxt, lengths, tables)
        return lp, ld

    before = (fa.flash_attention.launches, pa.paged_decode_attention.launches)
    lk, dk = run()
    assert fa.flash_attention.launches > before[0]
    assert pa.paged_decode_attention.launches > before[1]
    saved = ops.flash_attention, ops.paged_decode_attention
    ops.flash_attention = fa.flash_attention_ref
    ops.paged_decode_attention = pa.paged_decode_attention_ref
    try:
        lp, dp = run()
    finally:
        ops.flash_attention, ops.paged_decode_attention = saved
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)
    torch.testing.assert_close(dk, dp, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D,window", [
    (2, 4, 2, 256, 32, 1), (2, 4, 2, 256, 32, 16), (1, 4, 2, 200, 64, 33),
    (1, 8, 2, 300, 64, 64), (2, 4, 4, 130, 16, 1000),
    (1, 25, 5, 2048, 64, 1024),
])
def test_flash_window_kernel_matches_plain(gen, dtype, B, H, K, S, D, window):
    """Kernel 1's window form: windows below the 32- and 64-row tiles, not
    a multiple of either, past S, and hymba's (25/5 heads, window 1024 at
    S = 2048); ``banded`` counts only 0 < window < S."""
    q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    v = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    before = fa.flash_attention.launches, fa.flash_attention.banded
    o = fa.flash_attention(*args, window=window)
    assert fa.flash_attention.launches == before[0] + 1
    assert fa.flash_attention.banded == before[1] + (window < S)
    assert_close(o, fa.flash_attention_ref(*args, window=window), dtype)
    if window >= S:                                 # the causal kernel's
        assert torch.equal(o, fa.flash_attention(*args))


def test_flash_window_wrapper_refuses_negative_window(gen):
    q = torch.zeros(1, 2, 16, 32, device="cuda")
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=-1)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_decode_kernel_on_a_ring_matches_plain(gen, q_dt, kv_dt):
    """Kernel 5 over hymba's ring (4 lanes, 25/5 heads, W = 1024) with the
    positions clamped to the ring's last slot as the model clamps them,
    against ``swa_decode_ref`` (which rounds o to the ring's dtype: the
    f32-over-bf16 pair is held at the bf16 tolerance)."""
    B, H, K, W, D = 4, 25, 5, 1024, 64
    q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=q_dt)
    k = torch.randn(B, W, K, D, generator=gen, device="cuda", dtype=kv_dt)
    v = torch.randn(B, W, K, D, generator=gen, device="cuda", dtype=kv_dt)
    pos = torch.tensor([1990, 1400, 1000, 200], dtype=torch.int32,
                       device="cuda").clamp(max=W - 1)
    assert_close(da.decode_attention(q, k, v, pos),
                 da.swa_decode_ref(q, k, v, pos), kv_dt)


def test_smoke_hybrid_model_kernel_path_matches_plain_path(gen):
    """hymba's smoke model at f32 over an f32 pool: prefills past the
    window (kernel 1's window form) and inside it, then decode steps over
    the ring across its wrap (kernel 5), through the kernels vs the plain
    versions, both on the card."""
    cfg = get_config("hymba-1.5b").smoke_config()
    m = build_model(cfg, local_plan(param_dtype=torch.float32,
                                    compute_dtype=torch.float32))
    p = m.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                           device="cuda", dtype=torch.int32)

    def run():
        long, _ = m.prefill(p, tokens)
        short, cache = m.prefill(p, tokens[:, :12])
        pool = m.init_cache(2, 64, dtype=torch.float32)
        for part, leaves in cache.items():
            for name, leaf in leaves.items():
                pool[part][name][:, :, :leaf.shape[2]] = leaf
        for t in range(12, 40):
            step, _ = m.decode_step(p, pool, tokens[:, t].contiguous(),
                                    torch.full((2,), t, dtype=torch.int32,
                                               device="cuda"))
        return long, short, step

    before = (fa.flash_attention.launches, fa.flash_attention.banded,
              da.decode_attention.launches)
    got = run()
    L = cfg.num_layers
    assert fa.flash_attention.launches == before[0] + 2 * L
    assert fa.flash_attention.banded == before[1] + L
    assert da.decode_attention.launches == before[2] + 28 * L
    saved = ops.flash_attention, ops.decode_attention
    ops.flash_attention = fa.flash_attention_ref
    ops.decode_attention = lambda *a, ring=False, **kw: \
        (da.swa_decode_ref if ring else da.flash_decode_ref)(*a, **kw)
    try:
        want = run()
    finally:
        ops.flash_attention, ops.decode_attention = saved
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    # decode across the wrap equals the longer prefill
    torch.testing.assert_close(got[2], got[0], atol=1e-4, rtol=0)


def test_serve_cli_hymba_on_cuda_matches_cpu(gen):
    """hymba's serve CLI on the card runs kernels 1 (window form: its
    prompts of 4-23 tokens pass the smoke window of 16) and 5 in slot mode
    and prints the same dict as on the CPU."""
    from repro_torch.launch import serve
    argv = ["--arch", "hymba-1.5b", "--smoke", "--requests", "4",
            "--max-new", "6"]
    fa.flash_attention.launches = da.decode_attention.launches = 0
    got = serve.main(argv)
    assert fa.flash_attention.launches > 0 and da.decode_attention.launches
    assert got["mode"] == "slots"
    assert got == serve.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D,window", [
    (2, 4, 2, 1, 16, 0), (2, 4, 2, 31, 16, 0), (2, 4, 2, 33, 32, 0),
    (1, 8, 2, 64, 64, 0), (4, 16, 16, 1000, 80, 0), (2, 8, 2, 1000, 80, 0),
    (2, 4, 2, 33, 32, 1), (2, 4, 2, 200, 64, 16), (1, 8, 2, 1000, 80, 100),
    (2, 4, 2, 31, 16, 1000),
])
def test_flash_bidirectional_kernel_matches_plain(gen, dtype, B, H, K, S, D,
                                                  window):
    """Kernel 1's bidirectional form: S of one row, below and just past
    the 32-key tile, and hubert's 1000 frames (24 pad keys in the last
    tile, which every row must mask itself); GQA; windows below the tiles,
    inside S and past it.  ``bidirectional`` counts the launch; ``banded``
    only when 0 < window < S."""
    q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    v = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    before = (fa.flash_attention.launches, fa.flash_attention.banded,
              fa.flash_attention.bidirectional)
    o = fa.flash_attention(*args, causal=False, window=window)
    assert (fa.flash_attention.launches, fa.flash_attention.banded,
            fa.flash_attention.bidirectional) == \
        (before[0] + 1, before[1] + (0 < window < S), before[2] + 1)
    assert_close(o, fa.flash_attention_ref(*args, causal=False,
                                           window=window), dtype)
    if window >= S:                          # the unwindowed kernel's
        assert torch.equal(o, fa.flash_attention(*args, causal=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 96, 128, 256])
def test_flash_kernel_at_every_head_dim(gen, dtype, causal, D):
    """Every head dim kernel 1 is built for: the smoke configs' 16, the
    registered configs' 64, 80 (hubert), 96 (minicpm3), 128 and 256 (gemma,
    16-key tiles), at a ragged S with GQA."""
    B, H, K, S = 2, 4, 2, 97
    q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    v = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert_close(fa.flash_attention(*args, causal=causal),
                 fa.flash_attention_ref(*args, causal=causal), dtype)


def test_flash_wrapper_refuses_other_head_dims(gen):
    before = fa.flash_attention.launches, fa.flash_attention.bidirectional
    for D in (8, 48, 112, 512):
        q = torch.zeros(1, 2, 16, D, device="cuda")
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention(q, q, q, causal=False)
    assert (fa.flash_attention.launches,
            fa.flash_attention.bidirectional) == before


def test_smoke_encoder_model_kernel_path_matches_plain_path(gen):
    """hubert's smoke model at f32: per-frame logits and a prefill over
    ragged frame counts through kernel 1's bidirectional form vs through
    the plain versions, both on the card; one bidirectional launch per
    layer and forward, no other kernel."""
    cfg = get_config("hubert-xlarge").smoke_config()
    m = build_model(cfg, local_plan(param_dtype=torch.float32,
                                    compute_dtype=torch.float32))
    p = m.init(torch.Generator(device="cuda").manual_seed(0))
    frames = torch.randn(3, 45, cfg.d_model, generator=gen, device="cuda")

    def run():
        logits = m.logits(p, frames)
        last, cache = m.prefill(p, frames[:, :33])
        return logits, last, cache["attn"]["k"]

    before = (fa.flash_attention.launches, fa.flash_attention.bidirectional,
              da.decode_attention.launches)
    got = run()
    L = cfg.num_layers
    assert (fa.flash_attention.launches, fa.flash_attention.bidirectional,
            da.decode_attention.launches) == \
        (before[0] + 2 * L, before[1] + 2 * L, before[2])
    saved = ops.flash_attention
    ops.flash_attention = fa.flash_attention_ref
    try:
        want = run()
    finally:
        ops.flash_attention = saved
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


# Kernel 1's bf16 route (wgmma tiles fed by TMA): every head dim, both
# forms, windows below, inside and past S, ragged S about the 64-key and
# 64/128-row tiles, GQA 8/2 and hymba's 25/5.
TC_HEADS = ((8, 2), (25, 5))
TC_SEQS = (1, 63, 65, 97, 1000)


@pytest.mark.parametrize("window", [0, 1, 16, 64, 5000])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("D", fa._HEAD_DIMS)
def test_flash_bf16_runs_on_the_tensor_cores(gen, D, causal, window):
    """Each bf16 launch counts one ``tensor_core`` launch and matches the
    plain version; a window >= S gives the unwindowed output bit for
    bit."""
    for H, K in TC_HEADS:
        for S in TC_SEQS:
            B = 2 if S < 1000 else 1
            q, k, v = (torch.randn(B, S, n, D, generator=gen, device="cuda",
                                   dtype=torch.bfloat16).transpose(1, 2)
                       for n in (H, K, K))
            before = (fa.flash_attention.launches,
                      fa.flash_attention.tensor_core)
            o = fa.flash_attention(q, k, v, causal=causal, window=window)
            assert (fa.flash_attention.launches,
                    fa.flash_attention.tensor_core) == \
                (before[0] + 1, before[1] + 1)
            assert_close(o, fa.flash_attention_ref(q, k, v, causal=causal,
                                                   window=window),
                         torch.bfloat16)
            if window >= S:
                assert torch.equal(o, fa.flash_attention(q, k, v,
                                                         causal=causal))


@pytest.mark.parametrize("D", fa._HEAD_DIMS)
def test_flash_bf16_reads_any_layout(gen, D):
    """The model's strided (B, S, H, D) views and contiguous (B, H, S, D)
    copies of the same values give the same output, each laid out like
    its q."""
    B, S, H, K = 2, 130, 8, 2
    views = [torch.randn(B, S, n, D, generator=gen, device="cuda",
                         dtype=torch.bfloat16).transpose(1, 2)
             for n in (H, K, K)]
    copies = [t.contiguous() for t in views]
    for causal in (True, False):
        for window in (0, 40):
            a = fa.flash_attention(*views, causal=causal, window=window)
            b = fa.flash_attention(*copies, causal=causal, window=window)
            assert a.stride() == views[0].stride() and b.is_contiguous()
            assert torch.equal(a, b)


def test_flash_f32_stays_on_the_cuda_cores(gen):
    """f32 launches count as launches and never as ``tensor_core`` ones
    (tensor cores in f32 would be TF32)."""
    for D in fa._HEAD_DIMS:
        q, k, v = (torch.randn(1, 4, 70, D, generator=gen, device="cuda")
                   for _ in range(3))
        before = fa.flash_attention.launches, fa.flash_attention.tensor_core
        o = fa.flash_attention(q, k, v, causal=False, window=16)
        assert (fa.flash_attention.launches,
                fa.flash_attention.tensor_core) == (before[0] + 1, before[1])
        assert_close(o, fa.flash_attention_ref(q, k, v, causal=False,
                                               window=16), torch.float32)


# Kernel 5 split over the key axis and merged in the same launch: every
# dtype pair, G query heads per KV head from 1 to 12 (12 takes two head
# groups of CTAs), head dims 64/80/128/256, caches of 1 to 2048 keys, and
# lanes at the split edges of ``split_plan``'s length L: positions 0,
# L - 1, L, S - 1 and one drawn.
@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 5, 8, 12])
def test_decode_kernel_at_split_edges(gen, q_dt, kv_dt, D, G):
    K = 2
    H = G * K
    dt = max(q_dt, kv_dt, key=TOL.get)
    for S in (1, 31, 1000, 2048):
        L, splits, _ = da.split_plan(5, H, K, S)
        pos = torch.tensor([S - 1, 0, min(L - 1, S - 1), min(L, S - 1),
                            S // 3], dtype=torch.int32, device="cuda")
        q = torch.randn(5, H, D, generator=gen, device="cuda", dtype=q_dt)
        k, v = (torch.randn(5, S, K, D, generator=gen, device="cuda",
                            dtype=kv_dt) for _ in range(2))
        before = da.decode_attention.launches
        o = da.decode_attention(q, k, v, pos)
        assert da.decode_attention.launches == before + 1
        assert not o.isnan().any(), (S, L, splits)
        assert_close(o, da.flash_decode_ref(q, k, v, pos), dt)
        assert_close(o, da.split_decode_ref(q, k, v, pos, L), dt)
        if S <= 1024:
            assert_close(o.to(kv_dt).to(q_dt), da.swa_decode_ref(q, k, v, pos),
                         dt)


def test_decode_kernel_back_to_back_shapes_reset_the_tickets(gen):
    """Launches of different shapes queued back to back on one stream,
    then the first shape again: each matches its plain version, and every
    ticket counter is 0 once the card is done (the last CTA of each
    (lane, KV head) resets its own)."""
    shapes = [(4, 32, 32, 128, 2048), (4, 25, 5, 64, 1024),
              (3, 24, 8, 64, 300), (4, 32, 32, 128, 2048)]
    runs = []
    for B, H, K, D, S in shapes:
        q = torch.randn(B, H, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(B, S, K, D, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        pos = torch.randint(0, S, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
        runs.append(((q, k, v, pos), da.decode_attention(q, k, v, pos)))
    torch.cuda.synchronize()
    for args, o in runs:
        assert_close(o, da.flash_decode_ref(*args), torch.bfloat16)
    assert all(int(t.abs().sum()) == 0 for t in da._TICKETS.values())


def _prefill_inputs(gen, B, C, H, K, D, bs, T, q_dt, kv_dt, starts):
    """Scrambled tables over the pool, the given starts; the last lane is
    padded (a table of zeros, start 0) when ``starts`` ends in None."""
    n_blocks = 1 + B * T
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    if starts[-1] is None:
        tables[-1] = 0
        starts = [*starts[:-1], 0]
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    q = torch.randn(B, C, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp, vp = (torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                          dtype=kv_dt) for _ in range(2))
    return q, kp, vp, tables, st


# Kernel 3's bf16 route (wgmma tiles over a gathered K/V ring): every head
# dim, G = 1, 3, 4, 8 (3 does not divide the 128-row tile), block sizes
# 8/16/32, chunks of 1 to 128 tokens, starts on and off the 64-key tile's
# edges, and a padded lane.
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("D", ppa._HEAD_DIMS)
def test_paged_prefill_bf16_runs_on_the_tensor_cores(gen, D, bs):
    T = 320 // bs
    for G in (1, 3, 4, 8):
        H, K = 2 * G, 2
        for C in (1, 16, 100, 128):
            top = T * bs - C
            starts = [0, 64, min(63, top), min(191, top), None]
            q, kp, vp, tables, st = _prefill_inputs(
                gen, 5, C, H, K, D, bs, T, torch.bfloat16, torch.bfloat16,
                starts)
            before = (ppa.paged_prefill_attention.launches,
                      ppa.paged_prefill_attention.tensor_core)
            o = ppa.paged_prefill_attention(q, kp, vp, tables, st)
            assert (ppa.paged_prefill_attention.launches,
                    ppa.paged_prefill_attention.tensor_core) == \
                (before[0] + 1, before[1] + 1)
            assert_close(o, ppa.paged_prefill_attention_ref(q, kp, vp,
                                                            tables, st),
                         torch.bfloat16)


@pytest.mark.parametrize("kv_dt", [torch.float32, torch.bfloat16])
def test_paged_prefill_f32_stays_on_the_cuda_cores(gen, kv_dt):
    """f32 q (over an f32 or a bf16 pool) at every head dim counts as a
    launch and never as a ``tensor_core`` one, and holds the tolerance of
    its lowest precision."""
    for D in ppa._HEAD_DIMS:
        q, kp, vp, tables, st = _prefill_inputs(
            gen, 3, 40, 8, 2, D, 16, 12, torch.float32, kv_dt, [0, 100, None])
        before = (ppa.paged_prefill_attention.launches,
                  ppa.paged_prefill_attention.tensor_core)
        o = ppa.paged_prefill_attention(q, kp, vp, tables, st)
        assert (ppa.paged_prefill_attention.launches,
                ppa.paged_prefill_attention.tensor_core) == \
            (before[0] + 1, before[1])
        assert_close(o, ppa.paged_prefill_attention_ref(q, kp, vp, tables, st),
                     max(torch.float32, kv_dt, key=TOL.get))


# Kernels 2 and 4 split over each lane's walk through its table and merged
# in the same launch: every dtype pair, GQA 8/2, 24/8, 25/5 and MHA, block
# sizes 8/16/32, T * bs not a multiple of the split, and lanes at the
# split edges L - 1, L, L + 1, on block edges, at the last key and parked
# (position 0, a table of zeros: key 0 of the parking block).
def _edge_inputs(gen, H, K, D, bs, T, L, q_dt, kv_dt, n_blocks=None):
    top = T * bs - 1
    pos = [min(p, top) for p in (L - 1, L, L + 1, top, bs - 1, bs, 2 * bs + 1,
                                 0)]
    B = len(pos)
    n_blocks = n_blocks or 1 + B * T
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    tables[-1] = 0
    q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp, vp = (torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                          dtype=kv_dt) for _ in range(2))
    return q, kp, vp, tables, torch.tensor(pos, dtype=torch.int32,
                                           device="cuda")


PAGED_HEADS = [(8, 2, 64), (24, 8, 64), (25, 5, 64), (32, 32, 128),
               (16, 2, 256)]


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("H,K,D", PAGED_HEADS)
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_decode_kernel_at_split_edges(gen, q_dt, kv_dt, H, K, D, bs):
    """Kernel 2 at ``paged_split_plan``'s split (through the wrapper, one
    launch a call) and at forced splits of one and two blocks, 64 and 256
    keys, against its one-pass plain version and its split plain version
    at the same split."""
    T = 200 // bs + 1                        # T * bs: 208 or 224 keys
    dt = max(q_dt, kv_dt, key=TOL.get)
    L, _, _ = pa.paged_split_plan(8, H, K, T, bs)
    assert L % bs == 0
    for split in sorted({L, bs, 2 * bs, 64 if 64 % bs == 0 else bs, 256}):
        args = _edge_inputs(gen, H, K, D, bs, T, split, q_dt, kv_dt)
        if split == L:
            before = pa.paged_decode_attention.launches
            o = pa.paged_decode_attention(*args)
            assert pa.paged_decode_attention.launches == before + 1
        else:
            o = pa._launch(*args, split=split)
        assert not o.float().isnan().any(), split
        assert_close(o, pa.paged_decode_attention_ref(*args), dt)
        assert_close(o, pa.split_paged_decode_ref(*args, split), dt)


def _owned(tables, n_blocks, r, shards):
    nb_loc = n_blocks // shards
    local = tables - r * nb_loc
    owned = ((local >= 0) & (local < nb_loc)).to(torch.int32)
    return local.clamp(0, nb_loc - 1), owned


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("H,K,D", PAGED_HEADS)
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_decode_lse_kernel_at_split_edges(gen, q_dt, kv_dt, H, K, D,
                                                bs):
    """Kernel 4 per stripe at the split edges of ``_edge_inputs``, with
    lane 1's blocks all in stripe 0 (stripe 1 owns none of them: o = 0 and
    lse = -1e30 exactly, every split of it empty) and lane 0's later
    splits empty; against the one-pass and the split plain versions, and
    the stripes' ``combine_lse`` against kernel 2."""
    T = 200 // bs + 1
    dt = max(q_dt, kv_dt, key=TOL.get)
    L, _, _ = pa.paged_split_plan(8, H, K, T, bs)
    n_blocks = 2 * (8 * T + 1)
    q, kp, vp, tables, pos = _edge_inputs(gen, H, K, D, bs, T, L, q_dt,
                                          kv_dt, n_blocks)
    tables[1] = torch.arange(1, T + 1, dtype=torch.int32, device="cuda")
    nb_loc = n_blocks // 2
    os_, lses = [], []
    for r in range(2):
        local, owned = _owned(tables, n_blocks, r, 2)
        args = (q, kp[r * nb_loc:(r + 1) * nb_loc],
                vp[r * nb_loc:(r + 1) * nb_loc], local, pos, owned)
        before = pa.paged_decode_attention_lse.launches
        o, lse = pa.paged_decode_attention_lse(*args)
        assert pa.paged_decode_attention_lse.launches == before + 1
        o_ref, lse_ref = pa.paged_decode_attention_lse_ref(*args)
        so, slse = pa.split_paged_decode_lse_ref(*args, L)
        empty = lse_ref == -1e30
        assert torch.equal(lse == -1e30, empty)
        assert torch.equal(slse == -1e30, empty)
        assert (o[empty] == 0).all()
        if r == 1:
            assert empty[1].all()
        assert_close(o, o_ref, dt)
        assert_close(o, so, dt)
        torch.testing.assert_close(lse[~empty], lse_ref[~empty], atol=1e-4,
                                   rtol=0)
        os_.append(o)
        lses.append(lse)
    assert_close(pa.combine_lse(torch.stack(os_), torch.stack(lses)),
                 pa.paged_decode_attention_ref(q, kp, vp, tables, pos), dt)


def test_split_kernels_leave_the_tickets_at_zero(gen):
    """Kernels 2, 4 and 5 queued back to back on one stream at several
    shapes, each at its plan's split and at forced ones: every output
    matches its plain version and every ticket counter is 0 once the card
    is done."""
    runs = []
    for H, K, D, bs, T, split in ((32, 32, 128, 16, 128, None),
                                  (24, 8, 64, 16, 20, 16),
                                  (25, 5, 64, 8, 30, None),
                                  (8, 2, 64, 32, 9, 64)):
        args = _edge_inputs(gen, H, K, D, bs, T, split or 64,
                            torch.bfloat16, torch.bfloat16)
        runs.append(("2", args, pa._launch(*args, split=split)))
        local, owned = _owned(args[3], args[1].shape[0] // 2 * 2, 0, 2)
        nb = args[1].shape[0] // 2
        lse_args = (args[0], args[1][:nb], args[2][:nb], local, args[4],
                    owned)
        runs.append(("4", lse_args, pa._launch(*lse_args, split=split)))
        q = args[0]
        k = torch.randn(q.shape[0], 300, K, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        d_args = (q, k, k.flip(1).contiguous(), args[4].clamp(max=299))
        runs.append(("5", d_args, da.decode_attention(*d_args)))
    torch.cuda.synchronize()
    for kind, args, got in runs:
        if kind == "2":
            assert_close(got, pa.paged_decode_attention_ref(*args),
                         torch.bfloat16)
        elif kind == "4":
            o_ref, lse_ref = pa.paged_decode_attention_lse_ref(*args)
            assert_close(got[0], o_ref, torch.bfloat16)
            assert torch.equal(got[1] == -1e30, lse_ref == -1e30)
        else:
            assert_close(got, da.flash_decode_ref(*args), torch.bfloat16)
    assert all(int(t.abs().sum()) == 0 for t in da._TICKETS.values())


def test_paged_decode_kernels_on_two_streams(gen):
    """Kernels 2 and 4 launched on two streams at once, each stream with
    its own ticket counters: both match their plain versions, and the
    counters of both streams are 0 afterwards."""
    args = _edge_inputs(gen, 32, 32, 128, 16, 128, 256, torch.bfloat16,
                        torch.bfloat16)
    local, owned = _owned(args[3], args[1].shape[0] // 2 * 2, 1, 2)
    nb = args[1].shape[0] // 2
    lse_args = (args[0], args[1][nb:2 * nb], args[2][nb:2 * nb], local,
                args[4], owned)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        with torch.cuda.stream(s1):
            outs.append(("2", pa.paged_decode_attention(*args)))
        with torch.cuda.stream(s2):
            outs.append(("4", pa.paged_decode_attention_lse(*lse_args)))
    torch.cuda.synchronize()
    want2 = pa.paged_decode_attention_ref(*args)
    want4, lse4 = pa.paged_decode_attention_lse_ref(*lse_args)
    for kind, got in outs:
        if kind == "2":
            assert_close(got, want2, torch.bfloat16)
        else:
            assert_close(got[0], want4, torch.bfloat16)
            assert torch.equal(got[1] == -1e30, lse4 == -1e30)
    keys = [(torch.cuda.current_device(), s.cuda_stream) for s in (s1, s2)]
    assert all(k in da._TICKETS for k in keys)
    assert all(int(da._TICKETS[k].abs().sum()) == 0 for k in keys)


def test_paged_decode_wrapper_call_is_one_launch(gen):
    """One call of either wrapper puts exactly one kernel on the card (its
    splits merged inside it; no second pass), and the wrapper refuses a
    head dim above 512."""
    from torch.profiler import ProfilerActivity, profile
    args = _edge_inputs(gen, 32, 32, 128, 16, 128, 256, torch.bfloat16,
                        torch.bfloat16)
    local, owned = _owned(args[3], args[1].shape[0] // 2 * 2, 0, 2)
    nb = args[1].shape[0] // 2
    lse_args = (args[0], args[1][:nb], args[2][:nb], local, args[4], owned)
    pa.paged_decode_attention(*args)
    pa.paged_decode_attention_lse(*lse_args)
    torch.cuda.synchronize()
    for fn, a, name in ((pa.paged_decode_attention, args,
                         "paged_decode_split_kernel"),
                        (pa.paged_decode_attention_lse, lse_args,
                         "paged_decode_lse_split_kernel")):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*a)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type.name == "CUDA"
                   and "memset" not in e.name.lower()
                   and "memcpy" not in e.name.lower()]
        assert [name in e.name for e in kernels] == [True], \
            [e.name for e in kernels]
    big = torch.zeros(1, 2, 520, device="cuda")
    pool = torch.zeros(2, 8, 2, 520, device="cuda")
    one = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        pa.paged_decode_attention(big, pool, pool, one, one[0])


# ---------------------------------------------------------------------------
# kernels 6 and 7 as redesigned for Hopper: int8 wgmma with split-K merged
# in the same launch; the WKV state split over columns (CTAs) and rows
# (lanes)
# ---------------------------------------------------------------------------

def _i8_counts():
    f = i8.int8_matmul
    return f.launches, f.wgmma, f.split


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [520, 516, 522])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 12])
def test_int8_matmul_ragged_n_at_every_split(gen, N, splits, out_dtype):
    """N = 520 (8-byte copies of w), 516 (4-byte), 522 (single bytes), K
    split 1-12 ways (the last CTA of each tile merging the others' int32
    partials): bit-exact, every launch on wgmma, the split counted, every
    ticket back to 0."""
    M, K = 200, 1536
    args = _int8_inputs(gen, M, K, N)
    k_split = i8._k_split(K, splits)
    n = -(-K // k_split)
    before = _i8_counts()
    out = i8._launch(*args, out_dtype, n, k_split)
    torch.cuda.synchronize()
    assert _i8_counts() == (before[0] + 1, before[1] + 1,
                            before[2] + (n > 1))
    assert torch.equal(out, i8.int8_matmul_ref(*args, out_dtype=out_dtype))
    assert all(int(t.abs().sum()) == 0 for t in da._TICKETS.values())


@pytest.mark.parametrize("offset", [1, 4, 8])
@pytest.mark.parametrize("splits", [1, 3])
def test_int8_matmul_misaligned_operands(gen, offset, splits):
    """x and w starting 1, 4 or 8 bytes past a 16-byte boundary (single
    bytes, 4-byte or 8-byte copies for both) at one split and three."""
    M, K, N = 130, 1024, 264
    x_q, w_q, sx, sw = _int8_inputs(gen, M, K, N)
    xs = torch.empty(x_q.numel() + 16, dtype=torch.int8, device="cuda")
    ws = torch.empty(w_q.numel() + 16, dtype=torch.int8, device="cuda")
    xs[offset:offset + x_q.numel()] = x_q.reshape(-1)
    ws[offset:offset + w_q.numel()] = w_q.reshape(-1)
    xm = xs[offset:offset + x_q.numel()].view(M, K)
    wm = ws[offset:offset + w_q.numel()].view(K, N)
    assert xm.data_ptr() % 16 == offset
    k_split = i8._k_split(K, splits)
    for dt in (torch.float32, torch.bfloat16):
        got = i8._launch(xm, wm, sx, sw, dt, -(-K // k_split), k_split)
        assert torch.equal(got, i8.int8_matmul_ref(x_q, w_q, sx, sw,
                                                   out_dtype=dt))


def test_int8_matmul_sums_past_2_24_at_every_split(gen):
    """Every product 127 * 127 over K = 4096 (sums past 2**24, rounded to
    f32 once): bit-exact whole and split 2, 4 and 32 ways."""
    M, K, N = 256, 4096, 136
    x_q = torch.full((M, K), -127, dtype=torch.int8, device="cuda")
    w_q = torch.full((K, N), -127, dtype=torch.int8, device="cuda")
    x_q[::3] = 127
    sx = torch.full((M, 1), 0.37, device="cuda")
    sw = torch.full((1, N), 1.3, device="cuda")
    for splits in (1, 2, 4, 32):
        k_split = i8._k_split(K, splits)
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(
                i8._launch(x_q, w_q, sx, sw, dt, -(-K // k_split), k_split),
                i8.int8_matmul_ref(x_q, w_q, sx, sw, out_dtype=dt))


@pytest.mark.parametrize("M,K,N", [(256, 1536, 512), (2048, 1024, 2048),
                                   (1, 1536, 512), (256, 100, 512)])
def test_int8_matmul_routes_follow_the_plan(gen, M, K, N):
    """The wrapper's launch takes wgmma always and split-K exactly when
    ``int8_split_plan`` splits: granite's gate/up shape (8 tiles, 4
    splits) and one row do, 256 tiles and K below two blocks do not."""
    args = _int8_inputs(gen, M, K, N)
    splits = i8.int8_split_plan(M, N, K)[0]
    before = _i8_counts()
    out = i8.int8_matmul(*args)
    torch.cuda.synchronize()
    assert _i8_counts() == (before[0] + 1, before[1] + 1,
                            before[2] + (splits > 1))
    assert (splits > 1) == ((M, K, N) in ((256, 1536, 512), (1, 1536, 512)))
    assert torch.equal(out, i8.int8_matmul_ref(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("T", [1, 31, 33, 200])
def test_wkv_kernel_at_every_head_dim(gen, dtype, D, T):
    """Every head dim the kernel takes, at T across its tiles (16-64 steps
    of double-buffered r/k/v/w) and groups of Q steps, from a random state
    (T < 200) and a zero one (T = 200), and written in place."""
    B, H = (1, 5) if T == 200 else (2, 3)
    args = _wkv_inputs(gen, B, T, H, D, dtype, zero_state=T == 200)
    before = wkv.rwkv6_wkv.launches
    y, s = wkv.rwkv6_wkv(*args)
    assert wkv.rwkv6_wkv.launches == before + 1
    y_ref, s_ref = wkv.rwkv6_wkv_ref(*args)
    assert_wkv_close(y, y_ref, dtype)
    assert_wkv_close(s, s_ref, torch.float32)
    if args[5] is not None:
        state = args[5].clone()
        y2, s2 = wkv.rwkv6_wkv(*args[:5], state, s_out=state)
        assert s2 is state
        torch.testing.assert_close(y2, y, atol=0, rtol=0)
        torch.testing.assert_close(state, s, atol=0, rtol=0)


# the (D, Q) pairs csrc/rwkv6_wkv.cu instantiates
WKV_LANES = {16: (2,), 32: (4,), 48: (4,), 64: (2, 4, 8, 16), 80: (8,),
             96: (8,), 112: (8,), 128: (8,)}


def _wkv_column_counts(D, q):
    """One warp's columns a CTA, and the most (a power of two dividing D,
    at most 256 lanes)."""
    jc = 32 // q
    top = jc
    while 2 * top * q <= 256 and D % (2 * top) == 0:
        top *= 2
    return sorted({jc, top})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", sorted(WKV_LANES))
def test_wkv_kernel_bits_do_not_depend_on_the_plan(gen, dtype, D):
    """Every instantiated lane count (and the columns a CTA beside it)
    gives the same y and s bit for bit, staged (T = 8, 37) and unstaged
    (T = 1, 4; T = 0 hands s0 back), and the wrapper's plan gives those
    bits too."""
    for T in (0, 1, 4, 8, 37):
        args = _wkv_inputs(gen, 2, T, 3, D, dtype)
        runs = [wkv._launch(*args, None, jc, q)
                for q in WKV_LANES[D] for jc in _wkv_column_counts(D, q)]
        runs.append(wkv.rwkv6_wkv(*args))
        for y, s in runs[1:]:
            assert torch.equal(y, runs[0][0]) and torch.equal(s, runs[0][1])
        if T == 0:
            assert runs[0][0].shape == args[0].shape
            assert torch.equal(runs[0][1], args[5])


@pytest.mark.parametrize("jc,q", [(64, 2), (32, 2), (16, 2), (64, 4),
                                  (32, 4), (8, 4), (32, 8), (16, 8), (4, 8),
                                  (16, 16), (2, 16)])
@pytest.mark.parametrize("B,T,H", [(1, 200, 40), (4, 1, 40), (1, 1, 1),
                                   (3, 37, 7)])
def test_wkv_kernel_at_grid_edges(gen, jc, q, B, T, H):
    """rwkv6-3b's head dim at every instantiated lane count and columns a
    CTA from one warp (JC * Q = 32) to 256 lanes, at grids of B*H*(D/JC)
    from 1 CTA to 640, in bf16."""
    args = _wkv_inputs(gen, B, T, H, 64, torch.bfloat16, zero_state=T == 200)
    y, s = wkv._launch(*args, None, jc, q)
    y_ref, s_ref = wkv.rwkv6_wkv_ref(*args)
    assert_wkv_close(y, y_ref, torch.bfloat16)
    assert_wkv_close(s, s_ref, torch.float32)


# ---------------------------------------------------------------------------
# the serving steps as CUDA graphs (serving/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_STATS = ("decode_tokens", "prefill_tokens", "prefill_batches",
               "preemptions", "host_syncs", "decode_syncs", "variant_swaps")


def _launch_counts() -> dict:
    from repro_torch.serving.graphs import _wrapper_counters
    return {f"{fn.__name__}.{name}": getattr(fn, name)
            for fn, name in _wrapper_counters()}


def _graph_load(vocab: int, sampled: bool) -> list:
    """Six requests of 5-40 tokens; with ``sampled`` every other one at
    temperature 0.8 and top-k 40 (explicit seeds on two of them)."""
    g = torch.Generator().manual_seed(5)
    out = []
    for i in range(6):
        n = int(torch.randint(5, 41, (1,), generator=g))
        prompt = torch.randint(0, vocab, (n,), generator=g).tolist()
        kw = dict(temperature=0.8, top_k=40, seed=(11 * i if i < 3 else
                                                   None)) \
            if sampled and i % 2 else {}
        out.append((prompt, 10 + i, kw))
    return out


def _serve_graphs(model, params, load, graphs: bool, swap=None, **kw):
    """Serve ``load`` on a fresh engine; returns (streams, stats,
    launch-count deltas, engine)."""
    from repro_torch.serving import Engine, EngineKnobs, Request
    eng = Engine(model, params, max_seq=96, n_slots=4,
                 knobs=EngineKnobs(max_batch=4), block_size=8,
                 graphs=graphs, **kw)
    if swap is not None:
        eng.add_variant(*swap)
    # fixed ids: a request without a seed of its own derives it from its id
    reqs = [Request(prompt=p, max_new_tokens=m, req_id=900 + i, **rkw)
            for i, (p, m, rkw) in enumerate(load)]
    for r in reqs:
        eng.submit(r)
    before = _launch_counts()
    if swap is not None:
        eng.step(now=0.0)
        eng.step(now=1.0)
        eng.set_variant(swap[0])
    eng.run()
    torch.cuda.synchronize()
    after = _launch_counts()
    return ([list(r.output) for r in reqs],
            [getattr(eng.stats, k) for k in GRAPH_STATS],
            {k: after[k] - before[k] for k in after}, eng)


def _graph_model(arch: str, quantize: bool = False, shards: int = 1,
                 kv: int = 0):
    """A smoke model in bf16 from seed 0, under the ``shards``-way serving
    plan, with ``kv`` kv heads where given."""
    from repro_torch.serving import serving_plan
    cfg = get_config(arch).smoke_config()
    if kv:
        cfg = cfg.replace(n_kv_heads=kv)
    m = build_model(cfg, serving_plan(shards, quantize_serve=quantize))
    return m, m.init(torch.Generator(device="cuda").manual_seed(0))


GRAPH_PATHS = {
    "llama paged h4": ("llama2-7b", dict(horizon=4)),
    "llama paged h1 preempt": ("llama2-7b", dict(horizon=1, n_blocks=10)),
    "llama paged h4 preempt": ("llama2-7b", dict(horizon=4, n_blocks=10)),
    "llama chunked prefix": ("llama2-7b", dict(horizon=4, prefill_chunk=8,
                                               prefix_share=True)),
    "llama slots": ("llama2-7b", dict(paged=False)),
    "rwkv6-3b slots": ("rwkv6-3b", dict()),
    "hymba slots": ("hymba-1.5b", dict()),
    "granite paged h4": ("granite-moe-3b-a800m", dict(horizon=4)),
    # gemma-7b's scaled embedding, (1 + w) norms and gelu GLU, qwen3's
    # qk_norm and 128-expert router (4 at smoke size) inside a capture
    "gemma paged h4": ("gemma-7b", dict(horizon=4)),
    "gemma chunked prefix": ("gemma-7b", dict(horizon=4, prefill_chunk=8,
                                              prefix_share=True)),
    "gemma slots": ("gemma-7b", dict(paged=False)),
    "qwen3 paged h4": ("qwen3-1.7b", dict(horizon=4)),
    "qwen3-moe paged h4": ("qwen3-moe-235b-a22b", dict(horizon=4)),
    # every paged path at shards 2 and 4 (kernel 3's owned/LSE form in the
    # chunk tick, kernel 4 in the horizon, MoE over 2 ranks), and MLA's
    # latent slot step
    "llama chunked prefix shards 2": ("llama2-7b", dict(
        horizon=4, prefill_chunk=8, prefix_share=True, shards=2)),
    "llama chunked prefix shards 4": ("llama2-7b", dict(
        horizon=4, prefill_chunk=8, prefix_share=True, shards=4, kv=4)),
    "granite paged h4 shards 2": ("granite-moe-3b-a800m", dict(
        horizon=4, shards=2)),
    "minicpm3 slots": ("minicpm3-4b", dict()),
}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_captured_engine_matches_eager(gen, path, sampled):
    """Every captured path (the horizon, the chunk tick, the slot step)
    against ``graphs=False`` on the same weights and requests: identical
    streams, ``EngineStats`` counters and kernel launch counts; the
    captured engine replayed its graphs, the eager one captured none."""
    arch, kw = GRAPH_PATHS[path]
    kw = dict(kw)
    m, p = _graph_model(arch, shards=kw.pop("shards", 1), kv=kw.pop("kv", 0))
    load = _graph_load(m.cfg.vocab_size, sampled)
    got = _serve_graphs(m, p, load, True, **kw)
    want = _serve_graphs(m, p, load, False, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    cap, eager = got[3], want[3]
    assert cap.captured and not eager.captured
    assert sum(pr.captures for pr in cap.programs.values()) >= 1
    assert sum(pr.replays for pr in cap.programs.values()) >= 1
    assert all(pr.captures == 0 for pr in eager.programs.values())
    if "chunked" in path:
        assert any(k[0] == "tick" for k in cap.programs)
    if "shards" in path:
        assert cap.shards == m.plan.tp > 1
        assert got[2]["paged_decode_attention_lse.launches"] > 0
        assert got[2]["paged_decode_attention.launches"] == 0
    if "chunked" in path and "shards" in path:
        assert got[2]["paged_prefill_attention_lse.launches"] > 0
        assert got[2]["paged_prefill_attention.launches"] == 0


def test_captured_sharded_engine_matches_eager(gen):
    """The block-striped pool at shards 2 and (after ``set_shards``) 4:
    the captured horizon against the eager one, streams, counters and
    kernel 4's launches equal; ``set_shards`` drops the programs and the
    next run captures anew."""
    from repro_torch.serving import EngineSpec, Request
    cfg = get_config("llama2-7b").smoke_config().replace(n_kv_heads=4)
    spec = EngineSpec(cfg, shards=2, max_seq=64, n_slots=4, block_size=8,
                      n_blocks=16, horizon=4)
    load = _graph_load(cfg.vocab_size, True)

    def run(eng):
        reqs = [Request(prompt=pr, max_new_tokens=n, req_id=900 + i, **kw)
                for i, (pr, n, kw) in enumerate(load)]
        for r in reqs:
            eng.submit(r)
        before = _launch_counts()
        eng.run()
        torch.cuda.synchronize()
        after = _launch_counts()
        return [list(r.output) for r in reqs], \
            {k: after[k] - before[k] for k in after}

    cap, eager = spec.build(), spec.build()
    eager.graphs = False              # before its first step
    for n in (2, 4):
        if n == 4:
            cap.set_shards(4)
            eager.set_shards(4)
            assert cap.programs == {}
        a, b = run(cap), run(eager)
        assert a == b
        assert a[1]["paged_decode_attention_lse.launches"] > 0
        assert sum(pr.captures for pr in cap.programs.values()) >= 1


def test_captured_variant_swap_matches_eager(gen):
    """granite's full variant, then ``set_variant("int8")`` after two
    steps: the programs go with the rebuilt pool, the int8 variant's are
    captured anew, and the captured run equals the eager one."""
    m, p = _graph_model("granite-moe-3b-a800m")
    mq, pq = _graph_model("granite-moe-3b-a800m", quantize=True)
    load = _graph_load(m.cfg.vocab_size, False)
    got = _serve_graphs(m, p, load, True, swap=("int8", mq, pq), horizon=4)
    want = _serve_graphs(m, p, load, False, swap=("int8", mq, pq), horizon=4)
    assert got[:3] == want[:3]
    assert got[1][GRAPH_STATS.index("variant_swaps")] == 1
    assert all(k[1] == "int8" for k in got[3].programs)
    assert sum(pr.captures for pr in got[3].programs.values()) >= 1


def test_replays_leave_the_tickets_at_zero(gen):
    """Captured horizons replay kernel 2 many times: every ticket counter
    is 0 once the card is done."""
    m, p = _graph_model("llama2-7b")
    _, _, launches, eng = _serve_graphs(m, p, _graph_load(m.cfg.vocab_size,
                                                          True), True,
                                        horizon=4)
    assert launches["paged_decode_attention.launches"] > 0
    assert sum(pr.replays for pr in eng.programs.values()) > 0
    torch.cuda.synchronize()
    assert all(int(t.abs().sum()) == 0 for t in da._TICKETS.values())


def test_recapture_when_the_parameters_move(gen):
    """A program recaptures when a parameter leaf it captured moves
    (``Engine.params = ...``), and the new weights then take effect."""
    from repro_torch.serving import Engine, Request
    m, p = _graph_model("llama2-7b")
    eng = Engine(m, p, max_seq=64, n_slots=2, block_size=8, horizon=2)
    eng.submit(Request(prompt=[3, 5, 7], max_new_tokens=6))
    eng.run()
    (prog,) = eng.programs.values()
    assert prog.captures == 1
    from repro_torch.models.layers import tree_map
    eng.params = tree_map(torch.clone, p)
    eng.submit(Request(prompt=[3, 5, 7], max_new_tokens=6))
    eng.run()
    assert prog.captures == 2


def test_capture_meeting_a_host_sync_raises(gen):
    """A body that reads a value back (``.item()``) cannot be captured:
    the program raises with its name instead of running eagerly, and the
    card takes work afterwards."""
    from repro_torch.serving.graphs import Program
    x = torch.ones(4, device="cuda")
    out = torch.zeros(1, device="cuda")

    def body():
        out.fill_(x.sum().item())

    prog = Program("probe step", body, {}, lambda: (), capture=True,
                   stream=torch.cuda.Stream())
    with pytest.raises(RuntimeError, match="capture of the probe step"):
        prog.run()
    assert prog.graph is None and prog.captures == 0
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 8.0


def test_graphs_false_runs_eager(gen):
    """``graphs=False`` on the card: no program captures, every launch is
    counted as it happens."""
    from repro_torch.serving import Engine, Request
    m, p = _graph_model("llama2-7b")
    eng = Engine(m, p, max_seq=64, n_slots=2, block_size=8, horizon=3,
                 graphs=False)
    assert not eng.captured
    before = pa.paged_decode_attention.launches
    eng.submit(Request(prompt=[3, 5, 7], max_new_tokens=7))
    eng.run()
    assert all(pr.graph is None and pr.captures == 0
               for pr in eng.programs.values())
    assert pa.paged_decode_attention.launches - before == \
        eng.stats.decode_syncs * 3 * m.cfg.num_layers


def test_prng_on_the_card_matches_the_cpu(gen):
    """Keys, 32-bit draws and uniforms made on the card are bit-identical
    to the same calls on the CPU (integer arithmetic and exact float
    steps); categorical draws, which pass through two logs, agree too on
    these logits."""
    from repro_torch.models import prng
    from repro_torch.models import transformer as T
    seeds = torch.tensor([0, 1, 7, 2**31 - 1, 12345], dtype=torch.int32)
    idx = torch.tensor([1, 5, 300, 2047, 65535], dtype=torch.int32)
    logits = torch.randn(5, 1000, generator=torch.Generator().manual_seed(1))
    for dev in ("cpu", "cuda"):
        keys = T.event_keys(T.lane_keys(seeds.to(dev)), idx.to(dev),
                            T.SALT_SAMPLE)
        got = (keys.cpu(), prng.random_bits(keys, 257).cpu(),
               T.uniform_lanes(keys).cpu(),
               prng.categorical(keys, logits.to(dev)).cpu())
        if dev == "cpu":
            want = got
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["horizon", "chunk", "slot"])
def test_replay_is_bit_identical_to_eager(gen, kind):
    """A replay computes what the eager body computes, bit for bit, on the
    same inputs and the same pool (each run on its own copy of it)."""
    from repro_torch.models.layers import tree_map
    from repro_torch.serving import graphs as G
    m, p = _graph_model("llama2-7b")
    cfg, B = m.cfg, 3
    tokens = torch.randint(0, cfg.vocab_size, (B, 16), generator=gen,
                           device="cuda", dtype=torch.int32)
    if kind == "slot":
        pool = m.init_cache(B, 64)
        pool["attn"]["k"].normal_(generator=gen)
        pool["attn"]["v"].normal_(generator=gen)
    else:
        pool = m.init_paged_cache(1 + B * 8, 8)
        for leaf in pool["attn"].values():
            leaf.normal_(generator=gen)
    tables = (1 + torch.arange(B * 8, device="cuda", dtype=torch.int32)
              ).reshape(B, 8)
    pos = torch.tensor([20, 7, 33], dtype=torch.int32, device="cuda")
    inputs = {"horizon": {"tokens": tokens[:, 0].contiguous(),
                          "positions": pos, "tables": tables,
                          "active": torch.ones(B, dtype=torch.bool,
                                               device="cuda"),
                          "budgets": torch.full((B,), 9, dtype=torch.int32,
                                                device="cuda"),
                          "eos": torch.full((B,), -1, dtype=torch.int32,
                                            device="cuda")},
              "chunk": {"tokens": tokens, "starts": pos,
                        "lens": torch.tensor([16, 5, 1], dtype=torch.int32,
                                             device="cuda"),
                        "tables": tables},
              "slot": {"tokens": tokens[:, 0].contiguous(),
                       "positions": pos}}[kind]

    def program(cache, capture):
        tensors = lambda: (p, cache)  # noqa: E731
        kw = dict(capture=capture, stream=torch.cuda.Stream())
        if kind == "horizon":
            return G.horizon_program(m, tensors, B, 8, max_len=64,
                                     sampled=True, **kw)
        if kind == "chunk":
            return G.chunk_program(m, tensors, B, 16, 8, **kw)
        return G.slot_program(m, tensors, B, sampled=True, **kw)

    def run(prog):
        if "temps" in prog.bufs:
            G.set_sampling(prog.bufs, [0.8, 0.0, 1.2], [40, 0, 5], [1, 2, 3])
        for name, t in inputs.items():
            prog.bufs[name].copy_(t)
        prog.run()
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in prog.bufs.items()}

    eager_pool = tree_map(torch.clone, pool)
    eager = run(program(eager_pool, False))
    cap_pool = tree_map(torch.clone, pool)
    cap = program(cap_pool, True)
    run(cap)                    # the first step, eager, then the capture
    tree_map(lambda d, s: d.copy_(s), cap_pool, pool)   # same addresses
    replay = run(cap)
    assert cap.captures == 1 and cap.replays == 1
    for name in eager:
        assert torch.equal(eager[name], replay[name]), name
    # the parking block (0) takes every padded token's write, in no
    # defined order; the rest of the pool must match bit for bit
    for a, b in zip(G._leaves(eager_pool), G._leaves(cap_pool)):
        if kind == "slot":
            assert torch.equal(a, b)
        else:
            assert torch.equal(a[:, 1:], b[:, 1:])


def test_collector_stays_out_of_captures(gen):
    """A captured graph that becomes cyclic garbage (an engine whose
    programs refer back to it) must not be collected during another
    capture: destroying a graph mid-capture invalidates the capture.  Here
    the last reference to a captured program drops into a cycle inside a
    capture, with the collector set to run at almost every allocation;
    the capture still succeeds and its replay computes what it should."""
    import gc
    from repro_torch.serving.graphs import Program
    x = torch.ones(8, device="cuda")
    y = torch.zeros(8, device="cuda")
    victim = Program("victim step", lambda: y.copy_(x * 2), {}, lambda: (),
                     capture=True, stream=torch.cuda.Stream())
    victim.run()                          # the eager step, then the capture
    holder = [victim]
    del victim

    def body():
        y.add_(1)
        if torch.cuda.is_current_stream_capturing() and holder:
            cycle = [holder.pop()]
            cycle.append(cycle)
            del cycle
            junk = [[] for _ in range(10000)]   # the collector's cue
            del junk
        y.add_(1)

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        prog = Program("second step", body, {}, lambda: (), capture=True,
                       stream=torch.cuda.Stream())
        prog.run()
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert prog.captures == 1 and not holder
    y.zero_()
    prog.run()                            # a replay: two adds
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(y, 2.0))


# ---------------------------------------------------------------------------
# speculative decode: the verify fold's pinned plan, captured rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,H,K,T,spec_k", [(4, 32, 32, 128, 4),
                                            (4, 40, 40, 128, 4),
                                            (3, 24, 8, 40, 2),
                                            (2, 8, 2, 6, 7)])
def test_verify_fold_with_pinned_plan_is_bit_identical(gen, q_dt, kv_dt, B,
                                                       H, K, T, spec_k):
    """Kernel 2 over a verify pass's B * (K+1) pseudo-lanes (candidate i of
    lane b at position ``pos[b] + i`` through lane b's table) with the plan
    pinned to B lanes gives, row for row, the bits of the B-lane launch at
    each candidate's position; the parked lane (position 0 over row 0)
    too."""
    D, bs = 128 if H >= 32 else 64, 16
    Q = spec_k + 1
    n_blocks = 1 + B * T
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1).reshape(B, T).to(torch.int32)
    q = torch.randn(B * Q, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp, vp = (torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                          dtype=kv_dt) for _ in range(2))
    pos = torch.randint(0, T * bs - Q, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[-1] = 0
    tables[-1] = 0
    j = torch.arange(Q, dtype=torch.int32, device="cuda")
    fold_pos = (pos[:, None] + j[None]).reshape(B * Q).contiguous()
    fold_tab = tables[:, None].expand(B, Q, T).reshape(B * Q, T).contiguous()
    fold_pos.view(B, Q)[-1] = 0
    got = pa.paged_decode_attention(q, kp, vp, fold_tab, fold_pos,
                                    plan_lanes=B).view(B, Q, H, D)
    for i in range(Q):
        want = pa.paged_decode_attention(
            q.view(B, Q, H, D)[:, i].contiguous(), kp, vp, tables,
            fold_pos.view(B, Q)[:, i].contiguous())
        assert torch.equal(got[:, i], want), f"candidate {i}"


def _spec_model(arch: str, layers: int | None = None, seed: int = 0):
    cfg = get_config(arch).smoke_config()
    if layers:
        cfg = cfg.replace(num_layers=layers)
    m = build_model(cfg, local_plan(param_dtype=torch.bfloat16))
    return m, m.init(torch.Generator(device="cuda").manual_seed(seed))


SPEC_PATHS = {
    "ngram h4": dict(draft="ngram", spec_k=4, horizon=4),
    "ngram h4 preempt": dict(draft="ngram", spec_k=4, horizon=4,
                             n_blocks=12),
    "drafter h4": dict(drafter=True, spec_k=3, horizon=4),
    "drafter chunked prefix": dict(drafter=True, spec_k=3, horizon=2,
                                   prefill_chunk=8, prefix_share=True),
}


def _serve_spec(m, p, load, graphs: bool, drafter=None, **kw):
    """``_serve_graphs`` with speculation: ``drafter`` (model, params) is
    registered and chosen as "d"; returns (streams, stats with the spec
    counters, launch-count deltas, engine)."""
    from repro_torch.serving import Engine, EngineKnobs, Request
    eng = Engine(m, p, max_seq=96, n_slots=4, knobs=EngineKnobs(max_batch=4),
                 block_size=8, graphs=graphs, **kw)
    if drafter is not None:
        eng.add_drafter("d", *drafter)
        eng.set_drafter("d")
    reqs = [Request(prompt=pr, max_new_tokens=n, req_id=900 + i, **rkw)
            for i, (pr, n, rkw) in enumerate(load)]
    for r in reqs:
        eng.submit(r)
    before = _launch_counts()
    eng.run()
    torch.cuda.synchronize()
    after = _launch_counts()
    stats = [getattr(eng.stats, k) for k in GRAPH_STATS
             + ("verify_passes", "draft_tokens", "accepted_tokens")]
    return ([list(r.output) for r in reqs], stats,
            {k: after[k] - before[k] for k in after}, eng)


def _repeating_load(vocab: int, sampled: bool) -> list:
    """``_graph_load``'s prompts, each ending with its last 6 tokens said
    twice more, so n-gram drafts can be accepted."""
    return [(pr + pr[-6:] * 2, n, kw)
            for pr, n, kw in _graph_load(vocab, sampled)]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("path", sorted(SPEC_PATHS))
def test_captured_spec_engine_matches_eager(gen, path, sampled):
    """The speculative round (n-gram or model drafts, the drafter's chunk
    ticks) as CUDA graphs against ``graphs=False``: identical streams,
    ``EngineStats`` (the spec counters too) and launch counts, kernel 2
    launched by the verify passes and the drafter's steps."""
    kw = dict(SPEC_PATHS[path])
    m, p = _spec_model("llama2-7b")
    drafter = _spec_model("llama2-7b", layers=1, seed=1) \
        if kw.pop("drafter", False) else None
    load = _repeating_load(m.cfg.vocab_size, sampled)
    got = _serve_spec(m, p, load, True, drafter, **kw)
    want = _serve_spec(m, p, load, False, drafter, **kw)
    assert got[:3] == want[:3]
    cap = got[3]
    assert cap.captured and any(k[0] == "spec" for k in cap.programs)
    assert sum(pr.replays for k, pr in cap.programs.items()
               if k[0] == "spec") >= 1
    assert got[1][-3] > 0 and got[2]["paged_decode_attention.launches"] > 0
    if "preempt" in path:
        assert got[1][GRAPH_STATS.index("preemptions")] > 0
    if "chunked" in path:
        assert any(k[0] == "draft tick" for k in cap.programs)


@pytest.mark.parametrize("path", ["ngram h4", "drafter h4"])
def test_spec_streams_equal_across_horizons(gen, path):
    """Sampled and greedy requests: the keys fold (seed, sequence index,
    salt) only, so the streams at horizon 1 and 4 are the same."""
    kw = dict(SPEC_PATHS[path])
    m, p = _spec_model("llama2-7b")
    drafter = _spec_model("llama2-7b", layers=1, seed=1) \
        if kw.pop("drafter", False) else None
    load = _repeating_load(m.cfg.vocab_size, True)
    h4 = _serve_spec(m, p, load, True, drafter, **kw)
    h1 = _serve_spec(m, p, load, True, drafter, **dict(kw, horizon=1))
    assert h1[0] == h4[0]


def test_dropped_spec_engine_frees_the_card_without_the_collector(gen):
    """A captured speculative engine with a model drafter and pools of
    4096 blocks, built, served, dropped and built again with the cyclic
    collector held off: each drop ends the engine and its step programs
    (their CUDA graphs) at once and gives back at least its pool's and
    draft pool's bytes."""
    import gc
    import weakref
    from repro_torch.serving import graphs as G
    m, p = _spec_model("llama2-7b")
    drafter = _spec_model("llama2-7b", layers=1, seed=1)
    load = _repeating_load(m.cfg.vocab_size, True)
    kw = dict(SPEC_PATHS["drafter chunked prefix"], n_blocks=4096)
    kw.pop("drafter")
    collecting = gc.isenabled()
    gc.disable()
    try:
        streams = []
        for _ in range(2):
            out = _serve_spec(m, p, load, True, drafter, **kw)
            eng = out[3]
            assert eng.captured and eng.programs
            held = sum(t.untyped_storage().nbytes() for t in G._leaves(
                [eng.pool.cache, eng.pool.draft_cache]))
            refs = [weakref.ref(x) for x in (eng, eng.pool,
                                             *eng.programs.values())]
            streams.append(out[0])
            torch.cuda.synchronize()
            alive = torch.cuda.memory_allocated()
            del out, eng
            torch.cuda.synchronize()
            assert [r() for r in refs] == [None] * len(refs)
            assert alive - torch.cuda.memory_allocated() >= held > 0
        assert streams[0] == streams[1]
    finally:
        if collecting:
            gc.enable()


def test_dropped_engine_fleet_frees_the_card_without_the_collector(gen):
    """An ``EngineFleet`` of two captured smoke llama2-7b engines on one
    weight copy, pools of 4096 blocks, that has served inside a
    ``ClusterSim`` on the card, dropped with the cyclic collector held
    off: the fleet, its engines, their pools and step programs, its
    backends and the simulator end at once, and the card gets back at
    least the pools' bytes."""
    import gc
    import weakref

    import numpy as np
    from repro_torch.core.datacenter import DCConfig
    from repro_torch.core.simulator import TAPAS, ClusterSim, SimConfig
    from repro_torch.serving import EngineFleet, EngineSpec
    from repro_torch.serving import graphs as G
    spec = EngineSpec(get_config("llama2-7b").smoke_config(), max_seq=96,
                      n_slots=4, n_blocks=4096, horizon=4)
    dc = DCConfig(n_rows=2, racks_per_row=2, servers_per_rack=4,
                  region="hot")
    collecting = gc.isenabled()
    gc.disable()
    try:
        fleet = EngineFleet(spec, n_engines=2, backend_kw=dict(
            requests_per_load=3.0, prompt_len=4, max_new_tokens=4))
        sim = ClusterSim(SimConfig(dc=dc, horizon_h=3.0, tick_min=10.0,
                                   seed=3, policy=TAPAS, occupancy=0.95,
                                   demand_scale=1.0), device="cuda")
        while sim.tick < sim.ticks:
            st = sim.step()
            for srv in np.flatnonzero(st.kind == 2):
                if int(srv) not in sim.backends:
                    sim.attach_backend(int(srv), fleet.make_backend())
        fleet.drain(now_h=3.0)
        engines = fleet.engines
        assert sim.backends and fleet.flushes > 0
        assert all(e.captured and e.programs for e in engines)
        assert sum(len(r.output) for bk in sim.backends.values()
                   for r in bk.issued) > 0
        held = sum(t.untyped_storage().nbytes()
                   for t in G._leaves([e.pool.cache for e in engines]))
        refs = [weakref.ref(x) for x in (
            fleet, sim, *engines, *(e.pool for e in engines),
            *(p for e in engines for p in e.programs.values()),
            *sim.backends.values())]
        torch.cuda.synchronize()
        alive = torch.cuda.memory_allocated()
        del fleet, sim, st, engines
        torch.cuda.synchronize()
        assert [r() for r in refs] == [None] * len(refs)
        assert alive - torch.cuda.memory_allocated() >= held > 0
    finally:
        if collecting:
            gc.enable()


def test_spec_greedy_equals_plain_greedy_in_f32(gen):
    """Greedy speculation in an f32 compute plan (TF32 off): n-gram and
    model-drafter streams equal the plain horizon's."""
    from repro_torch.serving import Engine, EngineKnobs, Request
    cfg = get_config("llama2-7b").smoke_config()
    plan = local_plan(param_dtype=torch.bfloat16,
                      compute_dtype=torch.float32)
    m = build_model(cfg, plan)
    p = m.init(torch.Generator(device="cuda").manual_seed(0))
    d = build_model(cfg.replace(num_layers=1), plan)
    dp = d.init(torch.Generator(device="cuda").manual_seed(1))
    load = _repeating_load(cfg.vocab_size, False)
    plain = Engine(m, p, max_seq=96, n_slots=4, block_size=8, horizon=8,
                   knobs=EngineKnobs(max_batch=4))
    reqs = [Request(prompt=pr, max_new_tokens=n) for pr, n, _ in load]
    for r in reqs:
        plain.submit(r)
    plain.run()
    want = [list(r.output) for r in reqs]
    assert _serve_spec(m, p, load, True, **SPEC_PATHS["ngram h4"])[0] == want
    kw = dict(SPEC_PATHS["drafter h4"])
    kw.pop("drafter")
    assert _serve_spec(m, p, load, True, (d, dp), **kw)[0] == want


# ---------------------------------------------------------------------------
# resilience on the card: the scrub, quarantine, crash, the physics
# ---------------------------------------------------------------------------

def test_scrub_keeps_kernel_2_finite_over_a_reused_block(gen):
    """A quarantined lane's block reused with NaN left in its unwritten
    tail: after ``_zero_blocks`` kernel 2 is finite and the plain
    version's (what it makes of the unscrubbed residue is a reading in
    ``chip_smoke.py`` phase 10)."""
    from repro_torch.serving.kvcache import _zero_blocks
    B, H, D, bs, T = 2, 8, 64, 16, 4
    n_blocks = 1 + B * T
    kp = torch.randn(n_blocks, bs, H, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(n_blocks, bs, H, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    q = torch.randn(B, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    tables = (1 + torch.arange(B * T, device="cuda",
                               dtype=torch.int32)).reshape(B, T)
    pos = torch.tensor([21, 50], device="cuda", dtype=torch.int32)
    last = int(tables[0, 21 // bs])
    want = pa.paged_decode_attention_ref(q, kp, vp, tables, pos)
    keep = kp[last].clone(), vp[last].clone()
    kp[last], vp[last] = float("nan"), float("nan")
    _zero_blocks({"attn": {"k": kp[None], "v": vp[None]}},
                 torch.tensor([last], device="cuda"))
    assert int(kp[last].abs().sum()) == 0
    kp[last, : 21 % bs + 1] = keep[0][: 21 % bs + 1]
    vp[last, : 21 % bs + 1] = keep[1][: 21 % bs + 1]
    o = ops.paged_decode_attention(q, kp, vp, tables, pos)
    assert bool(o.isfinite().all())
    assert_close(o, want, torch.bfloat16)


def _resilience_engine(m, p, **kw):
    from repro_torch.serving import Engine, EngineKnobs
    return Engine(m, p, max_seq=64, n_slots=3, block_size=8,
                  knobs=EngineKnobs(max_batch=3), **kw)


def _resilience_load(vocab, seed):
    from repro_torch.serving import Request
    g = torch.Generator().manual_seed(seed)
    return [Request(prompt=torch.randint(0, vocab, (int(n),),
                                         generator=g).tolist(),
                    max_new_tokens=6)
            for n in torch.randint(4, 16, (4,), generator=g)]


def _dry(eng, now=0.0):
    for _ in range(500):
        if not (eng.queue or eng.active or eng.prefilling or eng._delayed):
            return
        eng.step(now=now)
        now += 1.0
    raise AssertionError("engine did not drain")


@pytest.mark.parametrize("horizon", [1, 4])
def test_quarantine_on_the_card_recovers_exact_streams(gen, horizon):
    """The guard's scan on the card finds the poisoned lane; recompute
    gives the clean run's streams; every free block is finite after."""
    m, p = _graph_model("llama2-7b")
    base = _resilience_engine(m, p, horizon=horizon)
    clean = _resilience_load(m.cfg.vocab_size, 2)
    for r in clean:
        base.submit(r)
    _dry(base)
    eng = _resilience_engine(m, p, horizon=horizon)
    reqs = _resilience_load(m.cfg.vocab_size, 2)
    for r in reqs:
        eng.submit(r)
    eng.step(now=0.0)
    victim = sorted(eng.active)[0]
    mask = torch.zeros(eng.pool.n_lanes, dtype=torch.bool).numpy()
    mask[list(eng.pool.lane_of.values())] = True
    eng.inject_kv_corruption(victim, last_block=True)
    bad = eng.pool.bad_lanes(mask)
    assert bad.tolist() == [lane == eng.pool.lane_of[victim]
                            for lane in range(eng.pool.n_lanes)]
    _dry(eng, now=1.0)
    assert eng.stats.quarantined == 1 and eng.stats.retried == 1
    assert [r.output for r in reqs] == [r.output for r in clean]
    free = sorted(eng.pool.free_blocks)
    for leaf in eng.pool.cache["attn"].values():
        assert bool(leaf[:, free].isfinite().all())


def test_crash_drops_the_captured_programs_with_the_pool(gen):
    """``crash()`` rebuilds the pool and drops every step program that
    captured the old one, so no graph replays against freed memory; after
    ``restore()`` the engine captures anew and the requeued requests give
    the clean run's streams."""
    m, p = _graph_model("llama2-7b")
    base = _resilience_engine(m, p, horizon=4)
    clean = _resilience_load(m.cfg.vocab_size, 3)
    for r in clean:
        base.submit(r)
    _dry(base)
    eng = _resilience_engine(m, p, horizon=4)
    reqs = _resilience_load(m.cfg.vocab_size, 3)
    for r in reqs:
        eng.submit(r)
    eng.step(now=0.0)
    eng.step(now=1.0)
    assert eng.programs and eng.captured
    old_pool = eng.pool
    assert eng.crash(2.0) == []
    assert eng.programs == {} and eng.pool is not old_pool
    assert eng.step(now=3.0) == 0
    eng.restore()
    _dry(eng, now=4.0)
    assert sum(pr.captures for pr in eng.programs.values()) >= 1
    assert [r.output for r in reqs] == [r.output for r in clean]
    assert eng.pool.used_blocks == 0


def test_cluster_sim_on_the_card_matches_the_cpu(gen):
    """The physics on the card against the CPU: event counts equal, the
    floats within 1e-5 relative."""
    import numpy as np
    from repro_torch.core.datacenter import DCConfig
    from repro_torch.core.scenario import (DemandSurge, FailureEvent,
                                           Scenario)
    from repro_torch.core.simulator import BASELINE, TAPAS, ClusterSim, \
        SimConfig
    for policy in (BASELINE, TAPAS):
        cfg = SimConfig(dc=DCConfig(n_rows=4, racks_per_row=5,
                                    servers_per_rack=4),
                        horizon_h=12.0, tick_min=10.0, seed=2,
                        policy=policy, occupancy=0.95, demand_scale=1.0,
                        scenario=Scenario((
                            FailureEvent(kind="thermal", start_h=3.0,
                                         end_h=6.0, target=0),
                            DemandSurge(start_h=3.0, end_h=6.0,
                                        scale=1.4))))
        a = ClusterSim(cfg, device="cuda").run()
        b = ClusterSim(cfg, device="cpu").run()
        sa, sb = a.summary(), b.summary()
        for k in ("thermal_events", "power_events"):
            assert sa[k] == sb[k]
        for k in sa:
            np.testing.assert_allclose(sa[k], sb[k], rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(a.max_gpu_temp_c, b.max_gpu_temp_c,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# kernel 1's backward, and training through it
# ---------------------------------------------------------------------------

# query q sees key k: causal, a window of 24 (causal), bidirectional
BWD_FORMS = {"causal": (True, 0), "window": (True, 24),
             "bidirectional": (False, 0)}
# of max |grad|: f32 sums in other orders; bf16 rounds dq/dk/dv and P
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def bgen(gen):
    """A generator of these tests' own, so the module's shared one gives
    every earlier test the inputs it drew before."""
    return torch.Generator(device="cuda").manual_seed(27)


def _bwd_inputs(gen, dtype, B, H, K, S, D):
    """The model's (B, S, H, D) activations as (B, H, S, D) views, a
    forward with its lse, and a random dO laid out like o."""
    q, k, v = (torch.randn(B, S, n, D, generator=gen, device="cuda",
                           dtype=dtype).transpose(1, 2) for n in (H, K, K))
    do = torch.randn(B, S, H, D, generator=gen, device="cuda",
                     dtype=dtype).transpose(1, 2)
    return q, k, v, do


def _held_to_scale(got, want, tol):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, want.abs().max())


# (B, H, K, S, causal, window) in bf16 at every head dim: tile edges S in
# {1, 63, 64, 65, 129, 300}, GQA 8/2 and 25/5, windows 1, 64 and >= S,
# bidirectional with and without a window
BWD_EDGES = [(2, 8, 2, 1, True, 0), (1, 25, 5, 63, True, 0),
             (2, 8, 2, 64, True, 0), (1, 25, 5, 65, False, 0),
             (1, 8, 2, 129, True, 1), (1, 25, 5, 129, True, 64),
             (1, 8, 2, 300, True, 300), (1, 25, 5, 300, False, 64),
             (2, 8, 2, 65, False, 1), (1, 8, 2, 300, True, 0),
             (1, 25, 5, 64, False, 64), (1, 8, 2, 129, False, 0),
             (1, 25, 5, 1, False, 1)]
# the forms at S = 77 in both dtypes, then the edges in bf16
BWD_CASES = (
    [(dt, D, 2, 6, 2, 77, *BWD_FORMS[form])
     for dt in (torch.float32, torch.bfloat16)
     for D in (16, 32, 64, 80, 96, 128, 256) for form in BWD_FORMS]
    + [(torch.bfloat16, D, *edge) for D in (16, 32, 64, 80, 96, 128, 256)
       for edge in BWD_EDGES])
BWD_IDS = [f"{'bf16' if dt == torch.bfloat16 else 'f32'}-D{D}-B{B}-H{H}-K{K}"
           f"-S{S}-{'causal' if c else 'bidir'}-W{w}"
           for dt, D, B, H, K, S, c, w in BWD_CASES]


@pytest.mark.parametrize("dtype,D,B,H,K,S,causal,window", BWD_CASES,
                         ids=BWD_IDS)
def test_flash_bwd_kernel_matches_plain(bgen, dtype, D, B, H, K, S, causal,
                                        window):
    q, k, v, do = _bwd_inputs(bgen, dtype, B, H, K, S, D)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    assert_close(o, o_ref, dtype)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4 if dtype ==
                               torch.float32 else 2e-2, rtol=0)
    before = fa.flash_attention_bwd.launches
    tc = fa.flash_attention_bwd.tensor_core
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    # every bf16 call takes the wgmma kernels, no f32 call does
    assert fa.flash_attention_bwd.tensor_core == tc + (dtype == torch.bfloat16)
    want = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    # where every query sees one key (S = 1, or causal with W = 1) dq and dk
    # are 0 in exact arithmetic (P = 1, dP = delta): both sides give
    # rounding noise, held below 1e-3 (a key let through a mask gives O(1))
    one_key = S == 1 or (causal and window == 1)
    for name, g, w, t in zip("qkv", got, want, (q, k, v)):
        assert g.shape == t.shape and g.stride() == t.stride()
        assert torch.isfinite(g).all()
        if one_key and name != "v":
            assert g.abs().max().item() <= 1e-3
            assert w.abs().max().item() <= 1e-3
        else:
            _held_to_scale(g, w, BWD_TOL[dtype])


@pytest.mark.parametrize("D", [80, 128, 256])
def test_flash_bwd_two_calls_give_the_same_bits(bgen, D):
    q, k, v, do = _bwd_inputs(bgen, torch.bfloat16, 2, 8, 2, 300, D)
    o, lse = fa.flash_attention_lse(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, o, do, lse)
    b = fa.flash_attention_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_serve_form_launch_writes_no_lse_and_matches_lse_form(bgen):
    q, k, v, _ = _bwd_inputs(bgen, torch.bfloat16, 1, 4, 4, 130, 64)
    o = fa.flash_attention(q, k, v)
    o2, _ = fa.flash_attention_lse(q, k, v)
    assert torch.equal(o, o2)


def test_kernel_wrappers_refuse_grad(bgen):
    q, k, v, _ = _bwd_inputs(bgen, torch.bfloat16, 1, 4, 4, 16, 64)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention(q[:, :, 0], k.transpose(1, 2), v.transpose(1, 2),
                            torch.full((1,), 15, device="cuda",
                                       dtype=torch.int32))
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    o = ops.flash_attention(q, k, v)            # the Function
    assert o.grad_fn is not None
    # kernel 7: the raw wrappers refuse; ops.rwkv6_wkv is WkvFn
    r, kk, vv, w, u, s0 = _wkv_inputs(bgen, 1, 5, 2, 16, torch.float32)
    r.requires_grad_(True)
    for fn in (wkv.rwkv6_wkv, wkv.rwkv6_wkv_train):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(r, kk, vv, w, u, s0)
    y, s = ops.rwkv6_wkv(r, kk, vv, w, u, s0)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == \
        "WkvFnBackward"


def test_train_step_grads_through_kernels_match_plain(bgen, monkeypatch):
    """A smoke-size qwen3-1.7b loss's grads through kernel 1's training
    forward and backward against the same Function on the plain versions,
    on the card in an f32 plan: within 1e-4 of each leaf's max |g|."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training.train_step import _value_and_grad
    cfg = get_config("qwen3-1.7b").smoke_config()
    model = build_model(cfg, local_plan(param_dtype=torch.float32,
                                        compute_dtype=torch.float32))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 2, 40), generator=bgen,
                        device="cuda")
    fwd, bwd = fa.flash_attention_lse.launches, fa.flash_attention_bwd.launches
    loss, grads = _value_and_grad(model, params, ids[0], ids[1])
    assert fa.flash_attention_lse.launches - fwd == cfg.num_layers
    assert fa.flash_attention_bwd.launches - bwd == cfg.num_layers
    monkeypatch.setattr(fa, "flash_attention_lse", fa.flash_attention_lse_ref)
    monkeypatch.setattr(fa, "flash_attention_bwd", fa.flash_attention_bwd_ref)
    loss_p, grads_p = _value_and_grad(model, params, ids[0], ids[1])
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_p)):
        _held_to_scale(g, w, 1e-4)


def test_remat_full_on_the_card(bgen):
    """``remat="full"`` recomputes each layer's forward in the backward:
    kernel 1's training forward runs twice a layer, its backward once, and
    the loss and grads equal those without remat (f32 plan: 1e-6 of each
    leaf's max |g|, the same kernels on the same inputs)."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training.train_step import _value_and_grad
    cfg = get_config("qwen3-1.7b").smoke_config()
    plans = [local_plan(param_dtype=torch.float32,
                        compute_dtype=torch.float32, remat=r)
             for r in ("none", "full")]
    params = build_model(cfg, plans[0]).init(
        torch.Generator(device="cuda").manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 2, 40), generator=bgen,
                        device="cuda")
    out = []
    for plan in plans:
        fwd, bwd = (fa.flash_attention_lse.launches,
                    fa.flash_attention_bwd.launches)
        out.append(_value_and_grad(build_model(cfg, plan), params, *ids))
        n_fwd = fa.flash_attention_lse.launches - fwd
        assert n_fwd == cfg.num_layers * (2 if plan.remat == "full" else 1)
        assert fa.flash_attention_bwd.launches - bwd == cfg.num_layers
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        _held_to_scale(a, b, 1e-6)


def test_moe_train_step_on_the_card(bgen, monkeypatch):
    """A smoke-size granite-moe train step on the card: the loss (with its
    load-balancing term) finite, every parameter moved, and the grads
    through kernel 1 against the plain route's in f32 (1e-4 of each
    leaf's max |g|)."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import (_value_and_grad,
                                                 make_train_step)
    cfg = get_config("granite-moe-3b-a800m").smoke_config()
    model = build_model(cfg, local_plan(param_dtype=torch.float32,
                                        compute_dtype=torch.float32))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 2, 40), generator=bgen,
                        device="cuda")
    loss, grads = _value_and_grad(model, params, *ids)
    with monkeypatch.context() as m:
        m.setattr(fa, "flash_attention_lse", fa.flash_attention_lse_ref)
        m.setattr(fa, "flash_attention_bwd", fa.flash_attention_bwd_ref)
        loss_p, grads_p = _value_and_grad(model, params, *ids)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_p)):
        _held_to_scale(g, w, 1e-4)
    before = [t.clone() for t in tree_leaves(params)]
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))
    params, state, met = step(params, init_opt_state(params), *ids)
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    assert int(state["step"]) == 1
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                   before)]
    assert sum(moved) >= len(moved) - 1, moved   # pad experts may stay


# ---------------------------------------------------------------------------
# kernel 7's training form and backward
# ---------------------------------------------------------------------------

# chip_smoke.py phase 15's shapes: (B, T, H, D, s0 and dS_T random)
WKV_BWD_CASES = [(4, 1024, 40, 64, False), (2, 333, 40, 64, True),
                 (2, 200, 8, 48, True), (2, 200, 8, 96, True),
                 (2, 200, 8, 128, True)]


def _wkv_bwd_case(gen, dtype, B, T, H, D, rand):
    args = _wkv_inputs(gen, B, T, H, D, dtype, zero_state=not rand)
    dy = torch.randn(B, T, H, D, generator=gen, device="cuda", dtype=dtype)
    ds = (torch.randn(B, H, D, D, generator=gen, device="cuda") if rand
          else None)
    return args, dy, ds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,D,rand", WKV_BWD_CASES)
def test_wkv_bwd_kernel_matches_plain(bgen, dtype, B, T, H, D, rand):
    """The training form's y and state are the serve form's bits and its
    checkpoints the plain training form's; the backward's six gradients
    from the kernel's checkpoints against the plain backward from the
    same, held as the forward's outputs are (``assert_wkv_close``), and
    two calls give the same bits."""
    args, dy, ds = _wkv_bwd_case(bgen, dtype, B, T, H, D, rand)
    launches = wkv.rwkv6_wkv_train.launches, wkv.rwkv6_wkv_bwd.launches
    y, s, ck = wkv.rwkv6_wkv_train(*args)
    y_serve, s_serve = wkv.rwkv6_wkv(*args)
    assert torch.equal(y, y_serve) and torch.equal(s, s_serve)
    _, _, ck_ref = wkv.rwkv6_wkv_train_ref(*args)
    assert_wkv_close(ck, ck_ref, torch.float32)
    got = wkv.rwkv6_wkv_bwd(*args[:5], ck, dy, ds)
    again = wkv.rwkv6_wkv_bwd(*args[:5], ck, dy, ds)
    torch.cuda.synchronize()
    assert (wkv.rwkv6_wkv_train.launches - launches[0],
            wkv.rwkv6_wkv_bwd.launches - launches[1]) == (1, 2)
    want = wkv.rwkv6_wkv_bwd_ref(*args[:5], ck, dy, ds)
    assert [g.dtype for g in got] == [dtype] * 3 + [torch.float32] * 3
    for a, b, c in zip(got, again, want):
        assert a.shape == c.shape and torch.equal(a, b)
        assert_wkv_close(a, c, dtype)


@pytest.mark.parametrize("D", wkv.HEAD_DIMS)
@pytest.mark.parametrize("T", [1, 31, 64, 257])
def test_wkv_bwd_kernel_at_every_head_dim(bgen, D, T):
    """Every head dim at T within, at and across its chunk edges (C = 128
    down to 16), bf16, from a random state with dS_T: against the plain
    backward and the plain version of the kernel's cluster partition
    (``rwkv6_wkv_bwd_split_ref`` at ``wkv_bwd_plan``'s P), two calls the
    same bits."""
    args, dy, ds = _wkv_bwd_case(bgen, torch.bfloat16, 2, T, 3, D, True)
    _, _, ck = wkv.rwkv6_wkv_train(*args)
    got = wkv.rwkv6_wkv_bwd(*args[:5], ck, dy, ds)
    again = wkv.rwkv6_wkv_bwd(*args[:5], ck, dy, ds)
    want = wkv.rwkv6_wkv_bwd_ref(*args[:5], ck, dy, ds)
    split = wkv.rwkv6_wkv_bwd_split_ref(*args[:5], ck, dy, ds,
                                        P=wkv.wkv_bwd_plan(D)[0])
    for a, b, c, d in zip(got, again, want, split):
        assert torch.equal(a, b)
        assert_wkv_close(a, c, torch.bfloat16)
        assert_wkv_close(a, d, torch.bfloat16)


def test_wkv_bwd_kernel_allocates_no_state_scratch(bgen):
    """At rwkv6-3b's training shape the call allocates its outputs (and
    du's per-(b, h) partials) and nothing else: no B*H*C*D*D f32 buffer
    of recomputed states (168 MB here)."""
    B, T, H, D = 4, 1024, 40, 64
    args, dy, ds = _wkv_bwd_case(bgen, torch.bfloat16, B, T, H, D, True)
    _, _, ck = wkv.rwkv6_wkv_train(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = wkv.rwkv6_wkv_bwd(*args[:5], ck, dy, ds)
    torch.cuda.synchronize()
    outputs = sum(g.numel() * g.element_size() for g in got) + B * H * D * 4
    assert torch.cuda.max_memory_allocated() - base <= outputs + (1 << 20)


def test_wkv_function_on_the_card(bgen):
    """``ops.rwkv6_wkv`` under autograd runs the training form and the
    backward kernel once each, no serve-form launch and no plain version,
    and its grads are the backward kernel's; s0's gradient is ds0."""
    args, dy, ds = _wkv_bwd_case(bgen, torch.bfloat16, 2, 70, 4, 64, True)
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = (wkv.rwkv6_wkv.launches, wkv.rwkv6_wkv_train.launches,
              wkv.rwkv6_wkv_bwd.launches, wkv.rwkv6_wkv_train_ref.calls,
              wkv.rwkv6_wkv_bwd_ref.calls)
    y, s = ops.rwkv6_wkv(*leaves)
    got = torch.autograd.grad((y.float() * dy.float()).sum()
                              + (s * ds).sum(), leaves)
    after = (wkv.rwkv6_wkv.launches, wkv.rwkv6_wkv_train.launches,
             wkv.rwkv6_wkv_bwd.launches, wkv.rwkv6_wkv_train_ref.calls,
             wkv.rwkv6_wkv_bwd_ref.calls)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1, 0, 0]
    _, _, ck = wkv.rwkv6_wkv_train(*args)
    # dy as autograd hands it back: the f32 product's gradient cast to bf16
    want = wkv.rwkv6_wkv_bwd(*args[:5], ck, dy.float().bfloat16(), ds)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b", "minicpm3-4b",
                                  "hubert-xlarge"])
def test_smoke_family_grads_through_kernels_match_plain(bgen, monkeypatch,
                                                        arch):
    """The smoke configs of the four families that once refused training,
    in an f32 plan on the card: loss and grads through kernels 1 and 7's
    training forms and backward kernels against the plain route's (1e-5
    relative; 1e-4 of each leaf's max |g|), each kernel launched once a
    layer, no plain version called."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training.data import DataConfig, TokenPipeline
    from repro_torch.training.train_step import _value_and_grad
    cfg = get_config(arch).smoke_config()
    model = build_model(cfg, local_plan(param_dtype=torch.float32,
                                        compute_dtype=torch.float32))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 2, 40))
    batch = (pipe.next_embed_batch(cfg.d_model) if cfg.input_kind == "embeds"
             else pipe.next_batch())
    fwd, bwd = ((wkv.rwkv6_wkv_train, wkv.rwkv6_wkv_bwd) if cfg.rwkv
                else (fa.flash_attention_lse, fa.flash_attention_bwd))
    counts = fwd.launches, bwd.launches
    loss, grads = _value_and_grad(model, params, *batch)
    assert (fwd.launches - counts[0], bwd.launches - counts[1]) == \
        (cfg.num_layers, cfg.num_layers)
    with monkeypatch.context() as m:
        m.setattr(fa, "flash_attention_lse", fa.flash_attention_lse_ref)
        m.setattr(fa, "flash_attention_bwd", fa.flash_attention_bwd_ref)
        m.setattr(wkv, "rwkv6_wkv_train", wkv.rwkv6_wkv_train_ref)
        m.setattr(wkv, "rwkv6_wkv_bwd", wkv.rwkv6_wkv_bwd_ref)
        loss_p, grads_p = _value_and_grad(model, params, *batch)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_p)):
        _held_to_scale(g, w, 1e-4)


# ---------------------------------------------------------------------------
# the dry run, the accounting and the audit against the card (chip_smoke.py
# phase 16 at smoke size)
# ---------------------------------------------------------------------------

def test_dryrun_allocates_nothing_and_its_bytes_are_the_cards(gen):
    """A full-width cell on the meta device allocates nothing on the card
    (``max_memory_allocated`` does not move); a smoke train cell's
    parameter and AdamW bytes, and a paged pool's, equal a real build's on
    the card, and the allocator's delta lies in ``allocator_span``."""
    from repro_torch.analysis import oncard
    from repro_torch.configs import Shape
    from repro_torch.launch.dryrun import run_cell
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    run_cell("llama2-7b", "decode_32k")
    assert torch.cuda.max_memory_allocated() == before
    assert torch.cuda.memory_allocated() == before
    cfg = get_config("qwen3-1.7b").smoke_config()
    shape = Shape("train", "train", 64, 2)
    acc = oncard.state_vs_allocation(cfg, shape,
                                     plan_overrides={"remat": "none"})
    assert acc["meta"] == acc["real"] and acc["real"]["opt"] > 0
    assert acc["span"][0] >= acc["real"]["params"] + acc["real"]["opt"]
    assert acc["span"][0] <= acc["allocated"] <= acc["span"][1]
    row = run_cell(cfg, shape, plan_overrides={"remat": "none",
                                               "grad_accum": 1})
    pk = oncard.train_peak(cfg, shape, acc["build"], row)
    assert pk["estimate"] > 0 and pk["measured"] > 0
    pool = oncard.pool_vs_allocation(get_config("llama2-7b").smoke_config(),
                                     n_lanes=3, max_seq=64, block_size=8)
    assert pool["meta"] == pool["real"] > 0
    assert pool["span"][0] <= pool["allocated"] <= pool["span"][1]


def test_audit_agrees_with_capture(gen):
    """Every registered audit entry runs clean under the audit on the card
    and captures; the synthetic host sync and host-built tensor are
    flagged by the audit and refused by the capture."""
    from repro_torch.analysis import oncard
    launches = (fa.flash_attention.launches,
                pa.paged_decode_attention.launches,
                ppa.paged_prefill_attention.launches)
    rows = oncard.audit_vs_capture("cuda")
    for name, findings, captured, error in rows:
        if name.startswith("synthetic_"):
            assert findings and not captured, (name, findings, error)
        else:
            assert not findings and captured, (name, findings, error)
    assert fa.flash_attention.launches > launches[0]
    assert pa.paged_decode_attention.launches > launches[1]
    assert ppa.paged_prefill_attention.launches > launches[2]


def test_roofline_reading_of_a_captured_step(gen):
    """A captured smoke decode step, counted by op_cost on the card: its
    share of the roofline is in (0, 1]."""
    import time

    from repro_torch.analysis import oncard, op_cost
    from repro_torch.analysis.iraudit import (ENTRYPOINTS_BY_NAME,
                                              AuditContext)
    from repro_torch.serving.graphs import Program
    ctx = AuditContext(device="cuda")
    built = ENTRYPOINTS_BY_NAME["decode_multi_paged_h4"].build(ctx)
    cost = op_cost.count(built.body)[1]
    prog = Program("h4", built.body, {}, built.tensors, capture=True,
                   stream=torch.cuda.Stream())
    prog.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        prog.run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 100
    r = oncard.roofline_reading(flops=cost["flops"], n_bytes=cost["bytes"],
                                model_flops=1.0, device_ms=ms)
    assert 0 < r["roofline_share"] <= 1
    assert cost["kernels"]["paged_decode_attention"]["calls"] == \
        4 * ctx.cfg.num_layers
