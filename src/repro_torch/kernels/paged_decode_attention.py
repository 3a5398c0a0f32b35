"""Paged flash-decode (one query token per lane through a block table):
the CUDA kernels' wrappers and their plain PyTorch versions.

``csrc/paged_decode_attention.cu`` holds two kernels of one body, which
replace two Pallas TPU kernels of ``repro/kernels/paged_decode_attention.py``:

- ``paged_decode_attention`` (kernel 2): q (B, H, D); k_pool/v_pool
  (n_blocks, bs, K, D); block_tables (B, T) int32 physical block ids
  (unused slots hold the parking block 0); positions (B,) int32, the last
  valid key index per lane -> o (B, H, D) in q's dtype.
- ``paged_decode_attention_lse`` (kernel 4), the per-stripe step of the
  block-striped pool: the pools are one stripe, the tables hold local ids
  (clipped into range where not owned) and ``owned`` (B, T) int32 is
  nonzero where the stripe holds the slot's block; it attends over the
  owned slots only -> (o (B, H, D) in q's dtype, lse (B, H) f32).
  ``combine_lse`` merges the stripes' outputs; it is plain torch on every
  device, as the reference's is plain ``jnp``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import NEG_INF, decode_attention_ref

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


def paged_decode_attention_lse_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   positions: torch.Tensor,
                                   owned: torch.Tensor, *,
                                   scale: float | None = None):
    """Plain per-stripe decode (the function of the reference's
    ``paged_decode_attention_lse``): attend over the keys ``kpos <=
    positions[b]`` of the table slots with ``owned[b, j] != 0`` only.
    Returns ``(o, lse)``: o normalised over those keys (0 where there are
    none) in q's dtype, lse = m + log l in f32 (-1e30 where there are none).

    The reference model's sharded core (``models/attention.py::
    _paged_decode_core``) rounds the unnormalised exp(s - m) to the pool's
    dtype before PV, with m the max over every stripe (its pmax); one
    stripe knows only its own max, so this version rounds exp(s - local m)
    and l sums the unrounded values.  At f32 the rounding is the identity,
    and the function is the Pallas kernel's."""
    B, H, D = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ids = block_tables.long()
    ke = k_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    ve = v_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), ke.float()) * scale
    live = ((torch.arange(T * bs, device=q.device)[None, :]
             <= positions[:, None])
            & (owned != 0).repeat_interleave(bs, dim=1))[:, None, :]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1)
    pexp = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = pexp.sum(dim=-1)
    num = torch.einsum("bhs,bshd->bhd", pexp.to(v_pool.dtype).float(),
                       ve.float())
    o = (num / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    return o, lse


def combine_lse(os: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Merge per-stripe ``paged_decode_attention_lse`` outputs exactly (port
    of ``kernels/paged_decode_attention.py::combine_lse``).  os (S, B, H, D)
    per-stripe normalised outputs; lses (S, B, H).  Each stripe is weighted
    by exp(lse - max lse): one softmax over the union of the stripes'
    keys.  Returns (B, H, D) in os's dtype."""
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])
    denom = w.sum(dim=0).clamp_min(1e-30)
    o = (os.float() * w[..., None]).sum(dim=0) / denom[..., None]
    return o.to(os.dtype)


@functools.cache
def _kernel():
    fn = build.library("paged_decode_attention").paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lse_kernel():
    fn = build.library("paged_decode_attention").paged_decode_attention_lse
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, q, k_pool, v_pool, block_tables, positions,
           owned=None) -> None:
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_tables", block_tables), ("positions", positions)]
    if owned is not None:
        named.append(("owned", owned))
    for arg, t in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be on q's CUDA device, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if (q.dtype, k_pool.dtype) not in _PAIRS or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{name}: q {q.dtype} over pools "
                        f"{k_pool.dtype}/{v_pool.dtype} not supported")
    if any(t.dtype != torch.int32 for _, t in named[3:]):
        raise TypeError(f"{name}: {', '.join(a for a, _ in named[3:])} "
                        f"must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    B, H, D = q.shape
    K = k_pool.shape[2]
    if k_pool.shape[3] != D or H % K or D % 8:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or positions.shape != (B,):
        raise ValueError(f"{name}: tables {tuple(block_tables.shape)} "
                         f"positions {tuple(positions.shape)} for {B} lanes")
    if owned is not None and owned.shape != block_tables.shape:
        raise ValueError(f"{name}: owned {tuple(owned.shape)} does not match "
                         f"tables {tuple(block_tables.shape)}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: pools must start on 16 bytes")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: q on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (all tensors on the current CUDA device)."""
    _check("paged_decode_attention", q, k_pool, v_pool, block_tables,
           positions)
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


def paged_decode_attention_lse(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               positions: torch.Tensor, owned: torch.Tensor,
                               *, scale: float | None = None):
    """Launch the per-stripe CUDA kernel (all tensors on the current CUDA
    device); returns ``(o, lse)``."""
    _check("paged_decode_attention_lse", q, k_pool, v_pool, block_tables,
           positions, owned)
    B, H, D = q.shape
    n_blocks, bs, K, _ = k_pool.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, dtype=torch.float32, device=q.device)
    err = _lse_kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), owned.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, K, D, n_blocks, bs,
        block_tables.shape[1], scale, _DTYPES[q.dtype], _DTYPES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    paged_decode_attention_lse.launches += 1
    return out, lse


paged_decode_attention_lse.launches = 0
