"""Dense flash-decode (one query token per lane over a contiguous KV cache):
the CUDA kernel's wrapper and its two plain PyTorch versions.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.  q (B, H, D);
k/v (B, S, K, D), head h reading KV head h*K//H; positions (B,) int32, the
last valid key index per lane -> o (B, H, D) in q's dtype.

Two plain versions, one per parity target:
- ``decode_attention_ref`` ports the oracle ``kernels/ref.py::
  decode_attention_ref`` (softmax, then P rounded to v's dtype, as the
  paged model path rounds; at f32 the rounding is the identity);
- ``flash_decode_ref`` mirrors the model function the kernel stands in for
  on the slot path, ``models/attention.py::_flash_decode_core``: it rounds
  the unnormalised ``exp(s - m)`` to v's dtype and divides by the f32 sum
  afterwards.  The dispatcher (``ops.decode_attention``) takes this one on
  the CPU, so the slot engine is token-exact with the reference there;
- ``swa_decode_ref`` mirrors the sliding-window ring decode,
  ``models/attention.py::_swa_decode``, whose mask ``slot <= position or
  position >= W`` is ``slot <= min(position, W - 1)``: the model passes
  positions clamped so, and the kernel runs unchanged.  It rounds the
  normalised P to v's dtype, and the output as well (the reference's PV
  product is in v's dtype); the dispatcher takes it for ``ring=True``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, cache dtype) pairs the kernel is built for; f32 queries over a
# bf16 cache is the reference's f32 plan (its caches are always bf16)
_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
          (torch.float32, torch.bfloat16)}


def _scores(q, k, positions, scale):
    """Masked f32 scores (B, H, S) with k expanded to H heads."""
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ke = k.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), ke.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= positions[:, None, None])
    return torch.where(mask, s, NEG_INF)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, *,
                         scale: float | None = None) -> torch.Tensor:
    """Plain dense decode (port of ``kernels/ref.py::decode_attention_ref``).
    q (B, H, D); k/v (B, S, K, D); positions (B,).  Scores and softmax in
    f32, probabilities rounded to v's dtype before PV as the reference
    model's ``paged_attention`` does; at f32 that is the identity."""
    H = q.shape[1]
    ve = v.repeat_interleave(H // v.shape[2], dim=2)
    p = torch.softmax(_scores(q, k, positions, scale), dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p.to(v.dtype).float(), ve.float())
    return o.to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """Plain dense decode on the slot model path (mirrors
    ``models/attention.py::_flash_decode_core`` on one device): the
    unnormalised ``exp(s - max s)`` is rounded to v's dtype before PV and
    the f32 numerator is divided by ``max(sum exp, 1e-30)``."""
    H = q.shape[1]
    ve = v.repeat_interleave(H // v.shape[2], dim=2)
    s = _scores(q, k, positions, scale)
    pexp = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    num = torch.einsum("bhs,bshd->bhd", pexp.to(v.dtype).float(), ve.float())
    o = num / pexp.sum(dim=-1).clamp_min(1e-30)[..., None]
    return o.to(q.dtype)


def swa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, *,
                   scale: float | None = None) -> torch.Tensor:
    """Plain decode over a sliding window's ring cache, rounded as
    ``models/attention.py::_swa_decode`` rounds: P normalised, then
    rounded to v's dtype, and o rounded to v's dtype before q's.
    ``positions`` are the lanes' positions clamped to the ring's last
    slot, ``min(position, W - 1)``."""
    o = decode_attention_ref(q, k, v, positions, scale=scale)
    return o.to(v.dtype).to(q.dtype)


@functools.cache
def _kernel():
    fn = build.library("decode_attention").decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, positions) -> None:
    named = (("q", q), ("k", k), ("v", v), ("positions", positions))
    for name, t in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be on q's CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if (q.dtype, k.dtype) not in _PAIRS or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: q {q.dtype} over cache "
                        f"{k.dtype}/{v.dtype} not supported")
    if positions.dtype != torch.int32:
        raise TypeError("decode_attention: positions must be int32")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] or D % 8:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"the cache {tuple(k.shape)}")
    if positions.shape != (B,):
        raise ValueError(f"decode_attention: positions "
                         f"{tuple(positions.shape)} for {B} lanes")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: the cache must start on 16 bytes")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"decode_attention: q on {q.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (all tensors on the current CUDA device)."""
    _check(q, k, v, positions)
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
        out.data_ptr(), B, H, K, D, S, scale, _DTYPES[q.dtype],
        _DTYPES[k.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
