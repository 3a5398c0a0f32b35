"""Kernels 6 and 7 as redesigned for Hopper: their launch plans and the
plain versions of their split arithmetic, against the plain versions and
the live JAX reference on the CPU.

Kernel 6 (``int8_matmul``) splits K over CTAs when its output has few
128 x 128 tiles and sums the int32 partials in the same launch:
``int8_matmul_split_ref`` sums each K range exactly and adds the partials,
so it must be bit-identical to ``int8_matmul_ref`` and to
``repro.kernels.ref.int8_matmul_ref`` at every split.  Kernel 7
(``rwkv6_wkv``) splits the state's columns over CTAs and each column's
rows over Q lanes: ``rwkv6_wkv_split_ref`` sums y over fixed partials of
the rows, added as a butterfly partly within a lane and partly across the
Q lanes, and adds v_j c_t with c_t = sum_i r_i u_i k_i, a reordering of
the same sums, so it stays within 1e-6 (relative, in f32) of
``rwkv6_wkv_ref``, of the JAX oracle and of the Pallas kernel in
interpret mode (run as ``tests/test_torch_rwkv.py`` runs it), gives the
same bits at every Q, and its state is the plain version's bit for bit.
Both plans are functions of shapes alone."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import int8_matmul as i8  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402

SMS = 132


def _t(a):
    """A torch copy: a JAX CPU array may share an aligned numpy buffer."""
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# kernel 6: the split plan and the split arithmetic
# ---------------------------------------------------------------------------

# (M, K, N): chip_smoke.py's shapes, then the edges: one row, K below one
# 128-byte block, K = 0, ragged N, a wide output (no split)
PLAN_SHAPES = [(128, 256, 128), (256, 512, 256), (256, 1536, 512),
               (256, 512, 1536), (200, 1536, 520), (4096, 4096, 4096),
               (1, 1536, 512), (256, 100, 512), (64, 0, 8), (200, 1536, 516),
               (3, 7, 5), (1024, 1536, 512), (2048, 2048, 2048)]


@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
def test_int8_split_plan_covers_k_in_whole_blocks(M, K, N):
    """``(splits, k_split)`` from the three ints alone: ranges of whole
    128-byte blocks that cover K with none empty, at most 4, and a split
    only while the grid of tiles x splits is below the card's 132 SMs."""
    splits, k_split = i8.int8_split_plan(M, N, K)
    assert (splits, k_split) == i8.int8_split_plan(M, N, K)
    assert k_split % i8.BLOCK_K == 0 and k_split >= i8.BLOCK_K
    assert splits == max(1, math.ceil(K / k_split))
    assert splits == 1 or (splits - 1) * k_split < K       # none empty
    tiles = math.ceil(M / 128) * math.ceil(N / 128)
    assert 1 <= splits <= 4
    if splits > 1:
        assert tiles * (splits - 1) < SMS
        assert K >= 2 * i8.BLOCK_K * (splits - 1)          # 2 blocks a range
    if tiles >= SMS or K <= 2 * i8.BLOCK_K:
        assert splits == 1


def test_int8_split_plan_grows_the_grid_of_few_tiles():
    """Granite's expert GEMMs at a prefill bucket's capacity (256 rows) and
    the ragged shape have 8-10 output tiles: the plan takes them to 4
    splits, 32-40 CTAs; the square GEMM of 4096 (1024 tiles) stays whole."""
    assert i8.int8_split_plan(256, 512, 1536) == (4, 384)
    assert i8.int8_split_plan(200, 520, 1536) == (4, 384)
    assert i8.int8_split_plan(4096, 4096, 4096) == (1, 4096)
    assert i8.int8_split_plan(1, 512, 1536) == (4, 384)      # M = 1
    assert i8.int8_split_plan(256, 512, 100) == (1, 128)     # K < a block


def _int8_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (M, K)).astype(np.int8),
            rng.integers(-127, 128, (K, N)).astype(np.int8),
            rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32),
            rng.uniform(0.01, 0.1, (1, N)).astype(np.float32))


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,K,N,splits", [
    (200, 1536, 520, 1), (200, 1536, 520, 2), (200, 1536, 520, 3),
    (200, 1536, 520, 4), (200, 1536, 520, 12), (256, 1536, 512, 4),
    (128, 256, 128, 2), (3, 7, 5, 2), (65, 300, 33, 3), (1, 520, 16, 5),
])
def test_int8_split_ref_is_bit_identical(M, K, N, splits, out):
    """Exact partial sums per K range, added, then the epilogue: the same
    bits as the one-pass plain version and as the reference oracle."""
    args = _int8_inputs(M, K, N, M + K + splits)
    tdt = getattr(torch, out)
    got = i8.int8_matmul_split_ref(*map(_t, args), splits=splits,
                                   out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    assert torch.equal(got, i8.int8_matmul_ref(*map(_t, args),
                                               out_dtype=tdt))
    want = jref.int8_matmul_ref(*map(jnp.asarray, args),
                                out_dtype=getattr(jnp, out))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_int8_split_ref_past_2_24():
    """Sums past 2**24 (every product 127 * 127 over K = 4096): f32 rounds
    the exact integer once, the same at every split."""
    M, K, N = 64, 4096, 80
    x_q = torch.full((M, K), -127, dtype=torch.int8)
    x_q[::3] = 127
    w_q = torch.full((K, N), -127, dtype=torch.int8)
    sx = torch.full((M, 1), 0.37)
    sw = torch.full((1, N), 1.3)
    want = i8.int8_matmul_ref(x_q, w_q, sx, sw, out_dtype=torch.float32)
    assert abs(float(want[0, 0])) > 2 ** 24 * 0.37 * 1.3
    for splits in (1, 2, 3, 4, 32):
        assert torch.equal(
            i8.int8_matmul_split_ref(x_q, w_q, sx, sw, splits=splits,
                                     out_dtype=torch.float32), want)


# ---------------------------------------------------------------------------
# kernel 7: the plan and the split arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,D", [
    (1, 40, 64), (4, 40, 64), (8, 40, 64), (1, 1, 16), (4, 40, 16),
    (1, 40, 48), (2, 3, 80), (1, 40, 96), (1, 8, 112), (1, 1, 128),
    (4, 40, 128), (64, 64, 128), (2, 40, 64), (1, 1, 64),
])
def test_wkv_plan_fills_the_card(B, H, D):
    """``(JC, Q)`` from the three ints alone: Q the head dim's lanes, a
    divisor of its partials; JC a power of two dividing D, whole warps of
    at most 128 stepping lanes; the widest such CTA whose grid of
    B*H*(D/JC) CTAs keeps at least half of 132 SMs busy, else the
    narrowest (one warp a CTA)."""
    jc, q = wkv.wkv_plan(B, H, D)
    assert (jc, q) == wkv.wkv_plan(B, H, D)
    assert q == wkv._LANES[D] and D % q == 0 and wkv._PARTS[D] % q == 0
    assert D % jc == 0 and jc & (jc - 1) == 0
    assert (jc * q) % 32 == 0 and 32 <= jc * q <= 128
    ctas = B * H * (D // jc)
    if ctas < SMS // 2:
        assert jc * q == 32
    elif 2 * jc * q <= 128 and D % (2 * jc) == 0:
        assert B * H * (D // (2 * jc)) < SMS // 2


def test_wkv_plan_at_rwkv6_3b():
    """rwkv6-3b (H = 40, D = 64): a 200-token prefill (B = 1), a one-slot
    and a 4-slot decode step all take 32 columns of 4 lanes a CTA (80,
    80 and 320 CTAs: the sweep's fastest at the prefill, within 3% of it
    at the decode step); one head alone takes one warp, 8 columns."""
    assert wkv.wkv_plan(1, 40, 64) == (32, 4)
    assert wkv.wkv_plan(4, 40, 64) == (32, 4)
    assert wkv.wkv_plan(1, 1, 64) == (8, 4)


def _wkv_inputs(rng, B, T, H, D, zero_state=False):
    r, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.8, 0.999, (B, T, H, D)).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    s0 = np.zeros((B, H, D, D), np.float32) if zero_state \
        else rng.standard_normal((B, H, D, D)).astype(np.float32)
    return r, k, v, w, u, s0


def _within(got, want, rel):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    norm = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rel and norm <= rel, (err, norm)


# (B, T, H, D): every head dim the kernel takes, T across tile and group
# edges
WKV_SHAPES = [(2, 37, 3, 16), (1, 64, 2, 32), (2, 21, 3, 48),
              (2, 128, 4, 64), (1, 33, 2, 80), (2, 17, 2, 96),
              (1, 9, 2, 112), (1, 1, 4, 128), (4, 1, 5, 64)]


@pytest.mark.parametrize("B,T,H,D", WKV_SHAPES)
def test_wkv_split_ref_matches_plain(B, T, H, D):
    rng = np.random.default_rng(T + D)
    args = tuple(map(_t, _wkv_inputs(rng, B, T, H, D)))
    y, s = wkv.rwkv6_wkv_split_ref(*args, q=wkv.wkv_plan(B, H, D)[1])
    y_ref, s_ref = wkv.rwkv6_wkv_ref(*args)
    _within(y, y_ref, 1e-6)
    assert torch.equal(s, s_ref)


@pytest.mark.parametrize("q", [1, 2, 4, 8, 16])
def test_wkv_split_ref_at_every_lane_count(q):
    """The plan's and the sweep's lane counts at rwkv6-3b's head dim (and
    one lane holding every partial), from a zero state and from a random
    one."""
    rng = np.random.default_rng(q)
    for zero in (True, False):
        args = tuple(map(_t, _wkv_inputs(rng, 1, 40, 3, 64, zero)))
        y, s = wkv.rwkv6_wkv_split_ref(*args, q=q)
        y_ref, s_ref = wkv.rwkv6_wkv_ref(*args)
        _within(y, y_ref, 1e-6)
        assert torch.equal(s, s_ref)


@pytest.mark.parametrize("D", wkv.HEAD_DIMS)
def test_wkv_split_ref_bits_do_not_depend_on_q(D):
    """Every lane count that divides the head dim's partials adds the
    same values in the same order: y and s equal bit for bit, so the
    plan's Q (or any other that the kernel instantiates) cannot change a
    result; a q that does not divide them is refused."""
    rng = np.random.default_rng(D)
    args = tuple(map(_t, _wkv_inputs(rng, 2, 6, 3, D)))
    qs = [q for q in (1, 2, 4, 8, 16) if wkv._PARTS[D] % q == 0]
    assert wkv._LANES[D] in qs
    y0, s0 = wkv.rwkv6_wkv_split_ref(*args, q=qs[0])
    for q in qs[1:]:
        y, s = wkv.rwkv6_wkv_split_ref(*args, q=q)
        assert torch.equal(y, y0) and torch.equal(s, s0), q
    with pytest.raises(ValueError):
        wkv.rwkv6_wkv_split_ref(*args, q=2 * wkv._PARTS[D])


@pytest.mark.parametrize("B,T,H,D", [(1, 64, 2, 48), (2, 32, 2, 80),
                                     (1, 32, 3, 96), (2, 64, 2, 64)])
def test_wkv_split_ref_matches_oracle_and_interpret_kernel(B, T, H, D):
    """Against ``kernels/ref.py``'s oracle and the Pallas kernel in
    interpret mode over time blocks of 32, at the new head dims."""
    rng = np.random.default_rng(B * T + D)
    args = _wkv_inputs(rng, B, T, H, D)
    y, s = wkv.rwkv6_wkv_split_ref(*map(_t, args),
                                   q=wkv.wkv_plan(B, H, D)[1])
    y_o, s_o = jref.rwkv6_wkv_ref(*map(jnp.asarray, args))
    _within(y, y_o, 1e-6)
    _within(s, s_o, 1e-6)
    y_k, s_k = jops.rwkv6_wkv(*map(jnp.asarray, args), block_t=32,
                              interpret=True)
    _within(y, y_k, 1e-6)
    _within(s, s_k, 1e-6)
