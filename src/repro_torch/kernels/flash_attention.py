"""Causal GQA flash attention (prompt prefill): the CUDA kernel's wrapper
and its plain PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  Layout follows the
reference: q (B, H, S, D), k/v (B, K, S, D), head h reading KV head h*K//H.
Both functions accept any strides with a unit stride on D, so the model
passes ``x.transpose(1, 2)`` views of its (B, S, H, D) activations and no
transpose copy is made; the kernel's output keeps q's layout.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)   # instantiated in csrc/flash_attention.cu


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::flash_attention_ref``,
    causal).  The normalised P is rounded to v's dtype before PV, as the
    reference model's ``_attn_block`` does (the kernel rounds the
    unnormalised exponentials instead); at f32 that is the identity."""
    B, H, S, D = q.shape
    K = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ke = k.repeat_interleave(H // K, dim=1)
    ve = v.repeat_interleave(H // K, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), ke.float()) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), ve.float())
    return o.to(q.dtype)


@functools.cache
def _kernel():
    fn = build.library("flash_attention").flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on q's CUDA "
                             f"device, got {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-D with a unit "
                             f"stride on D, got shape {tuple(t.shape)} "
                             f"strides {t.stride()}")
        vec = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} rows must start on 16 "
                             f"bytes, got strides {t.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported")
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"flash_attention: {H} heads over {k.shape[1]} KV heads")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {_HEAD_DIMS}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: q on {q.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, H, S, D), k/v (B, K, S, D), one dtype
    (bf16 or f32), all on the current CUDA device -> o, laid out like q."""
    _check(q, k, v)
    B, H, S, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, k.shape[1], S, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], scale, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
