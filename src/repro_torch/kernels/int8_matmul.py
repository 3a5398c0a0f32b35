"""w8a8 int8 GEMM with per-row and per-column scales: the CUDA kernel's
wrapper, its plain PyTorch version, and the quantizers.

The kernel (``csrc/int8_matmul.cu``) replaces the Pallas TPU kernel
``repro/kernels/int8_matmul.py::int8_matmul``::

    out = ((float32(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n]) -> out_dtype

x_q (M, K) int8, w_q (K, N) int8, sx (M, 1) f32, sw (1, N) f32; the sum is
exact in int32, the epilogue is those two f32 products in that order, then
one rounding to ``out_dtype`` (bf16 or f32).  Any M, N and K (the Pallas
kernel asserts divisibility by its blocks).

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


@functools.cache
def _kernel():
    fn = build.library("int8_matmul").int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x_q, w_q, sx, sw, out_dtype) -> None:
    named = (("x_q", x_q), ("w_q", w_q), ("sx", sx), ("sw", sw))
    for name, t in named:
        if not t.is_cuda or t.device != x_q.device:
            raise ValueError(f"int8_matmul: {name} must be on x_q's CUDA "
                             f"device, got {t.device}")
    if x_q.device.index != torch.cuda.current_device():
        raise ValueError(f"int8_matmul: x_q on {x_q.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    for name, t, dt in (("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
                        ("sx", sx, torch.float32), ("sw", sw, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"int8_matmul: {name} must be {dt}, got {t.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_matmul: out_dtype {out_dtype}: need f32 or "
                        f"bf16")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_matmul: x_q {tuple(x_q.shape)} @ w_q "
                         f"{tuple(w_q.shape)}")
    M, N = x_q.shape[0], w_q.shape[1]
    if sx.shape != (M, 1) or sw.shape != (1, N):
        raise ValueError(f"int8_matmul: sx {tuple(sx.shape)}, sw "
                         f"{tuple(sw.shape)}: need {(M, 1)} and {(1, N)}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, *, out_dtype=torch.bfloat16):
    """Launch the CUDA kernel (all tensors on the current CUDA device):
    out (M, N) in ``out_dtype``."""
    _check(x_q, w_q, sx, sw, out_dtype)
    M, K = x_q.shape
    N = w_q.shape[1]
    out = torch.empty(M, N, dtype=out_dtype, device=x_q.device)
    err = _kernel()(x_q.data_ptr(), w_q.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), out.data_ptr(), M, N, K,
                    _OUT_DTYPES[out_dtype],
                    torch.cuda.current_stream(x_q.device).cuda_stream)
    build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int8_matmul_quantized(x: torch.Tensor, w: torch.Tensor, *,
                          out_dtype=torch.bfloat16):
    """Quantize both operands (plain torch), then launch the kernel."""
    x_q, sx = quantize_rows(x)
    w_q, sw = quantize_cols(w)
    return int8_matmul(x_q, w_q, sx, sw, out_dtype=out_dtype)
