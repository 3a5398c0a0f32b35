"""w8a8 int8 GEMM with per-row and per-column scales: the CUDA kernel's
wrapper, its plain PyTorch version, and the quantizers.

The kernel (``csrc/int8_matmul.cu``) replaces the Pallas TPU kernel
``repro/kernels/int8_matmul.py::int8_matmul``::

    out = ((float32(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n]) -> out_dtype

x_q (M, K) int8, w_q (K, N) int8, sx (M, 1) f32, sw (1, N) f32; the sum is
exact in int32, the epilogue is those two f32 products in that order, then
one rounding to ``out_dtype`` (bf16 or f32).  Any M, N and K (the Pallas
kernel asserts divisibility by its blocks).  The kernel runs on the int8
tensor cores (``wgmma``) over 128 x 128 output tiles; where the tiles are
too few to fill the card, ``int8_split_plan`` splits K over CTAs and the
last CTA of each tile sums the int32 partials in the same launch.

The plain version mirrors ``kernels/ref.py::int8_matmul_ref``.  It sums in
float64, which holds every sum exactly (|sum| <= K * 127**2, far below
2**53) on the CPU and on CUDA, where ``torch.matmul`` has no int32 path;
rounding that exact integer to f32 is the int32 -> f32 conversion, so the
plain version and the kernel agree bit for bit.

``quantize_rows``/``quantize_cols`` are plain torch on every device, as
they are plain ``jnp`` in the reference: symmetric, scale = max(amax,
1e-8) / 127, round half to even, clip to +-127.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import _tickets

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _quantize(x: torch.Tensor, dim: int):
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization: (x_q, scale (M, 1) f32)."""
    return _quantize(x, -1)


def quantize_cols(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization: (w_q, scale (1, N))."""
    return _quantize(w, 0)


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor, *, out_dtype=torch.bfloat16):
    """Plain w8a8 GEMM (port of ``kernels/ref.py::int8_matmul_ref``): the
    exact integer sum, ``(acc_f32 * sx) * sw``, one cast."""
    acc = (x_q.double() @ w_q.double()).float()
    return (acc * sx * sw).to(out_dtype)


def int8_matmul_quantized_ref(x: torch.Tensor, w: torch.Tensor, *,
                              out_dtype=torch.bfloat16):
    """Quantize both operands, then the plain GEMM."""
    x_q, sx = quantize_rows(x)
    w_q, sw = quantize_cols(w)
    return int8_matmul_ref(x_q, w_q, sx, sw, out_dtype=out_dtype)


def int8_matmul_split_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                          sx: torch.Tensor, sw: torch.Tensor, *, splits: int,
                          out_dtype=torch.bfloat16):
    """The kernel's split-K arithmetic in plain torch (for the tests): the
    exact integer sum of each of ``splits`` K ranges of whole 128-byte
    blocks (``int8_split_plan``'s ranges for that count), the partials
    added, then the epilogue.  Integer sums are exact in any order, so it
    is bit-identical to ``int8_matmul_ref``."""
    K = x_q.shape[1]
    k_split = _k_split(K, splits)
    acc = torch.zeros(x_q.shape[0], w_q.shape[1], dtype=torch.float64,
                      device=x_q.device)
    for lo in range(0, K, k_split):
        acc += x_q[:, lo:lo + k_split].double() @ w_q[lo:lo + k_split].double()
    return (acc.float() * sx * sw).to(out_dtype)


TILE = 128           # output rows and columns per CTA (csrc TM, TN)
BLOCK_K = 128        # bytes of K per staged block (csrc TK)
_MAX_SPLITS = 4      # the last CTA of a tile reads splits - 1 partials


def _k_split(K: int, splits: int) -> int:
    """Bytes of K per split: ``splits`` ranges of whole blocks."""
    blocks = max(1, -(-K // BLOCK_K))
    return -(-blocks // max(1, min(splits, blocks))) * BLOCK_K


@functools.lru_cache(maxsize=256)
def int8_split_plan(M: int, N: int, K: int) -> tuple[int, int]:
    """``(splits, k_split)`` of a launch over (M, K) @ (K, N), from shapes
    alone: one CTA per 128 x 128 output tile and K range.  A grid of
    fewer tiles than the card's 132 SMs splits K into ranges of whole
    128-byte blocks until the grid fills the card, at most 4 ranges (the
    last CTA of each tile reads the others' int32 partials, 64 KB each)
    and at least 2 blocks each; ``k_split`` is the bytes of K a range
    holds (the last may be short)."""
    tiles = -(-M // TILE) * -(-N // TILE)
    blocks = -(-K // BLOCK_K)
    splits = 1
    while (splits < _MAX_SPLITS and tiles * splits < build.SMS
           and blocks >= 2 * (splits + 1)):
        splits += 1
    k_split = _k_split(K, splits)
    return max(1, -(-K // k_split)), k_split


@functools.cache
def _kernel():
    fn = build.library("int8_matmul").int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x_q, w_q, sx, sw, out_dtype) -> None:
    build.refuse_grad("int8_matmul", x_q, w_q, sx, sw)
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError(f"int8_matmul: x_q must be on a CUDA device, got "
                         f"{dev}")
    for name, t in (("w_q", w_q), ("sx", sx), ("sw", sw)):
        if t.device != dev:
            raise ValueError(f"int8_matmul: {name} must be on x_q's CUDA "
                             f"device, got {t.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"int8_matmul: x_q on {dev}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    for name, t, dt in (("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
                        ("sx", sx, torch.float32), ("sw", sw, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"int8_matmul: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_matmul: out_dtype {out_dtype}: need f32 or "
                        f"bf16")
    xs, ws = x_q.shape, w_q.shape
    if len(xs) != 2 or len(ws) != 2 or xs[1] != ws[0]:
        raise ValueError(f"int8_matmul: x_q {tuple(xs)} @ w_q {tuple(ws)}")
    if sx.shape != (xs[0], 1) or sw.shape != (1, ws[1]):
        raise ValueError(f"int8_matmul: sx {tuple(sx.shape)}, sw "
                         f"{tuple(sw.shape)}: need {(xs[0], 1)} and "
                         f"{(1, ws[1])}")


def _launch(x_q, w_q, sx, sw, out_dtype, splits: int, k_split: int):
    """One launch at a given split (the wrapper's plan, or the sweep's)."""
    (M, K), N = x_q.shape, w_q.shape[1]
    dev = x_q.device
    out = torch.empty(M, N, dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = tickets = None
    if splits > 1:             # the splits' int32 tiles, and their counters
        tiles = -(-M // TILE) * -(-N // TILE)
        part = torch.empty(splits * tiles * TILE * TILE, dtype=torch.int32,
                           device=dev)
        tickets = _tickets(dev, stream, tiles)
    err = _kernel()(x_q.data_ptr(), w_q.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), out.data_ptr(),
                    None if part is None else part.data_ptr(),
                    None if tickets is None else tickets.data_ptr(), M, N, K,
                    splits, k_split, _OUT_DTYPES[out_dtype], stream)
    build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    int8_matmul.wgmma += 1
    int8_matmul.split += splits > 1
    return out


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, *, out_dtype=torch.bfloat16):
    """Launch the CUDA kernel (all tensors on the current CUDA device):
    out (M, N) in ``out_dtype``, K split as ``int8_split_plan`` says."""
    _check(x_q, w_q, sx, sw, out_dtype)
    splits, k_split = int8_split_plan(x_q.shape[0], w_q.shape[1],
                                      x_q.shape[1])
    return _launch(x_q, w_q, sx, sw, out_dtype, splits, k_split)


# launches; those on the tensor cores (every one: the kernel has no other
# route); those split over K
int8_matmul.launches = 0
int8_matmul.wgmma = 0
int8_matmul.split = 0


def int8_matmul_quantized(x: torch.Tensor, w: torch.Tensor, *,
                          out_dtype=torch.bfloat16):
    """Quantize both operands (plain torch), then launch the kernel."""
    build.refuse_grad("int8_matmul_quantized", x, w)
    x_q, sx = quantize_rows(x)
    w_q, sw = quantize_cols(w)
    return int8_matmul(x_q, w_q, sx, sw, out_dtype=out_dtype)
