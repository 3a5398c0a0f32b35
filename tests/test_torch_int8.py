"""Kernel 6, the w8a8 int8 GEMM: its plain version and the quantizers
against the live JAX reference on the CPU.

The plain version must be bit-exact against ``kernels/ref.py``'s
``int8_matmul_ref`` and against the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it), at the reference's test shapes
(``test_int8_matmul_exact``) and ragged ones: integer sums are exact, and
the f32 epilogue is the same sequence of operations.  The quantizers are
bit-exact against the reference's ``jnp`` ones, and the quantized GEMM
stays within the reference's 2% of the f32 GEMM."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import int8_matmul as j_int8  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import int8_matmul as i8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # pragma: no cover - the property test needs it
    given = None


def _t(a):
    """A torch copy: a JAX CPU array may share an aligned numpy buffer."""
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _inputs(M, K, N):
    """``test_int8_matmul_exact``'s draws: int8 operands, scales in
    [0.01, 0.1)."""
    rng = np.random.default_rng(M)
    return (rng.integers(-127, 128, (M, K)).astype(np.int8),
            rng.integers(-127, 128, (K, N)).astype(np.int8),
            rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32),
            rng.uniform(0.01, 0.1, (1, N)).astype(np.float32))


# the reference's test shapes, a ragged one inside the Pallas kernel's
# single block (its asserts need divisible blocks), and a ragged one at a
# MoE expert's width
INTERPRET_SHAPES = [(128, 256, 128), (256, 512, 256), (200, 328, 136)]
SHAPES = INTERPRET_SHAPES + [(200, 1536, 520), (3, 7, 5)]
OUT = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
       "float32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("out", sorted(OUT))
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_ref_oracle(M, K, N, out):
    args = _inputs(M, K, N)
    want = jref.int8_matmul_ref(*map(jnp.asarray, args),
                                out_dtype=OUT[out][0])
    got = i8.int8_matmul_ref(*map(_t, args), out_dtype=OUT[out][1])
    assert got.dtype == OUT[out][1] and got.shape == (M, N)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("M,K,N", INTERPRET_SHAPES)
def test_ops_match_interpret_kernel(M, K, N):
    """``ops.int8_matmul`` on CPU tensors (the plain version) against the
    reference's ``ops.int8_matmul`` (the Pallas kernel, interpreted), and
    the f32-output kernel against the f32 plain version."""
    args = _inputs(M, K, N)
    want = jops.int8_matmul(*map(jnp.asarray, args))
    np.testing.assert_array_equal(_np(ops.int8_matmul(*map(_t, args))),
                                  _np(want))
    want32 = j_int8.int8_matmul(*map(jnp.asarray, args),
                                out_dtype=jnp.float32, interpret=True)
    got32 = ops.int8_matmul(*map(_t, args), out_dtype=torch.float32)
    np.testing.assert_array_equal(got32.numpy(), np.asarray(want32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 96), (5, 3), (1, 40)])
def test_quantizers_match_reference(shape, dtype):
    """Rows and columns, a zero row and column (scale 1e-8 / 127), a row
    of exact halves (round half to even)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x[0] = 0.0
    x[:, 0] = 0.0
    if shape[1] > 2:
        x[-1, :3] = [127.0, 0.5, -1.5]
    jx = jnp.asarray(x, dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    for jfn, tfn in ((j_int8.quantize_rows, ops.quantize_rows),
                     (j_int8.quantize_cols, ops.quantize_cols)):
        jq, js = jfn(jx)
        tq, ts = tfn(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (200, 328, 136)])
def test_quantized_matmul_matches_reference(M, K, N):
    """``int8_matmul_quantized`` on f32 operands: bit-exact against the
    reference's (quantize, then the interpreted kernel) and within 2% of
    the f32 GEMM (``test_int8_quantized_matmul_error_bound``)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    want = jops.int8_matmul_quantized(jnp.asarray(x), jnp.asarray(w))
    got = ops.int8_matmul_quantized(_t(x), _t(w))
    np.testing.assert_array_equal(_np(got), _np(want))
    o, o_ref = _np(got), x @ w
    assert np.abs(o - o_ref).mean() / np.abs(o_ref).mean() < 0.02


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """CPU tensors (no count), and the dispatcher refuses mixed devices."""
    xq, wq, sx, sw = map(_t, _inputs(8, 16, 4))
    with pytest.raises(ValueError):
        i8.int8_matmul(xq, wq, sx, sw)
    with pytest.raises(ValueError):
        i8.int8_matmul_quantized(xq.float(), wq.float())
    with pytest.raises(ValueError):
        ops.int8_matmul(xq, wq.to("meta"), sx, sw)
    assert i8.int8_matmul.launches == 0


if given is not None:
    @settings(max_examples=25, deadline=None)
    @given(rows=st.integers(2, 40), cols=st.integers(2, 40),
           seed=st.integers(0, 99))
    def test_int8_quantize_roundtrip(rows, cols, seed):
        """``tests/test_properties.py``'s round trip through the port's
        ``quantize_rows``: within one quantization step of the input."""
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((rows, cols)).astype(np.float32)
        xq, s = ops.quantize_rows(_t(x))
        back = xq.float().numpy() * s.numpy()
        err = np.abs(back - x).max()
        assert err <= np.abs(x).max() / 127.0 + 1e-6
