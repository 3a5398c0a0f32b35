"""Paged flash-decode (one query token per lane through a block table):
the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/paged_decode_attention.cu``) replaces the Pallas TPU
kernel ``repro/kernels/paged_decode_attention.py::paged_decode_attention``.
q (B, H, D); k_pool/v_pool (n_blocks, bs, K, D); block_tables (B, T) int32
physical block ids (unused slots hold the parking block 0); positions (B,)
int32, the last valid key index per lane -> o (B, H, D) in q's dtype.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, pool dtype) pairs the kernel is built for; f32 queries over a
# bf16 pool is the reference's f32 plan (the pool is always bf16 there)
_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
          (torch.float32, torch.bfloat16)}


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               positions: torch.Tensor, *,
                               scale: float | None = None) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::paged_decode_attention_ref``):
    gather each lane's logical KV view through its table, then attend
    (``decode_attention_ref`` rounds the normalised P to v's dtype, as the
    reference model's ``paged_attention`` does)."""
    B, H, D = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    k = k_pool[block_tables].reshape(B, T * bs, K, D)
    v = v_pool[block_tables].reshape(B, T * bs, K, D)
    return decode_attention_ref(q, k, v, positions, scale=scale)


@functools.cache
def _kernel():
    fn = build.library("paged_decode_attention").paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, block_tables, positions) -> None:
    named = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_tables", block_tables), ("positions", positions))
    for name, t in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} must be on q's "
                             f"CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    if (q.dtype, k_pool.dtype) not in _PAIRS or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_decode_attention: q {q.dtype} over pools "
                        f"{k_pool.dtype}/{v_pool.dtype} not supported")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and positions "
                        "must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    B, H, D = q.shape
    K = k_pool.shape[2]
    if k_pool.shape[3] != D or H % K or D % 8:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} does "
                         f"not fit pools {tuple(k_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or positions.shape != (B,):
        raise ValueError(f"paged_decode_attention: tables "
                         f"{tuple(block_tables.shape)} positions "
                         f"{tuple(positions.shape)} for {B} lanes")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention: pools must start on 16 bytes")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"paged_decode_attention: q on {q.device}, current "
                         f"device is cuda:{torch.cuda.current_device()}")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (all tensors on the current CUDA device)."""
    _check(q, k_pool, v_pool, block_tables, positions)
    B, H, D = q.shape
    n_blocks, bs, K, _ = k_pool.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, H, K, D, n_blocks, bs, block_tables.shape[1], scale,
        _DTYPES[q.dtype], _DTYPES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
