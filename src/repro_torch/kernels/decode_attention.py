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

The kernel splits each lane's keys into pieces of ``split_plan``'s length
and merges the pieces' partials inside the same launch;
``split_decode_ref`` is that arithmetic in plain PyTorch (per-split
partials, then the merge: ``split_merge``, which kernels 2 and 4's split
versions share), with the split length as an argument.
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


def split_merge(s: torch.Tensor, live: torch.Tensor, walk: torch.Tensor,
                ve: torch.Tensor, split: int, p_dtype=None):
    """The split kernels' arithmetic (kernels 2, 4 and 5) in plain PyTorch.
    s (B, H, N) f32 scores; live (B, N) the keys a lane's walk visits;
    walk (B, N) their positions on the walk; ve (B, N, H, D) f32 values.
    Split i holds the live keys at walk positions ``[i * split, (i + 1) *
    split)`` and keeps ``m_i = max s`` (-1e30 when it holds no key), ``l_i
    = sum exp(s - m_i)`` and ``acc_i = sum p v`` with p = exp(s - m_i),
    rounded to ``p_dtype`` where one is given; the merge is ``o = sum e^{m_i
    - M} acc_i / max(sum e^{m_i - M} l_i, 1e-30)``, M the largest m_i, and
    ``lse = M + log(sum e^{m_i - M} l_i)`` (-1e30 where no split holds a
    key): an empty split adds exactly 0.  Returns (o, lse) in f32."""
    N = s.shape[-1]
    n = -(-N // split)
    ids = torch.arange(n, device=s.device)
    mask = live[:, None, :] & (walk[:, None, :] // split == ids[:, None])
    mask = mask[:, None]                                    # (B, 1, n, N)
    sm = torch.where(mask, s[:, :, None, :], NEG_INF)       # (B, H, n, N)
    m = sm.max(dim=-1).values                               # (B, H, n)
    p = torch.where(mask, torch.exp(sm - m[..., None]), 0.0)
    l_i = p.sum(dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    acc = torch.einsum("bhnt,bthd->bhnd", p, ve)
    M = m.max(dim=-1, keepdim=True).values
    w = torch.exp(m - M)
    denom = (w * l_i).sum(dim=-1)
    o = (w[..., None] * acc).sum(dim=2) / denom.clamp_min(1e-30)[..., None]
    lse = torch.where(denom > 0, M[..., 0] + torch.log(denom.clamp_min(1e-30)),
                      NEG_INF)
    return o, lse


def split_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, split: int, *,
                     scale: float | None = None) -> torch.Tensor:
    """Kernel 5's split-and-merge arithmetic in plain PyTorch: split i
    of a lane owns keys ``[i * split, (i + 1) * split)`` of its ``0 ..
    positions``, and ``split_merge`` merges the splits with p rounded to
    v's dtype before PV."""
    S = k.shape[1]
    ve = v.repeat_interleave(q.shape[1] // v.shape[2], dim=2).float()
    keys = torch.arange(S, device=q.device)[None, :]
    live = keys <= positions[:, None]
    o, _ = split_merge(_scores(q, k, positions, scale), live,
                       keys.expand_as(live), ve, split, v.dtype)
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


# CTAs wanted per launch: two per SM
_MIN_CTAS = 2 * build.SMS
_MAX_HEADS = 8        # query heads per CTA (csrc/split_decode.cuh MAX_G)
_MAX_SPLITS = 256     # splits per lane (csrc/split_decode.cuh MAX_SPLITS)


def split_plan(B: int, H: int, K: int, S: int) -> tuple[int, int, int]:
    """``(L, splits, head_groups)`` for a launch over (B, S, K, D) with H
    query heads, from shapes alone (never from positions, which stay on
    the card): L is the largest power of two >= 32 for which
    ``B * K * head_groups * ceil(S / L)`` is still >= two CTAs per SM, or
    32 when none is, and stops growing once one split holds all S keys;
    past 8192 keys it grows further to keep at most 256 splits."""
    G = H // K
    groups = -(-G // min(G, _MAX_HEADS))
    pairs = B * K * groups
    L = 32
    while L < S and pairs * -(-S // (2 * L)) >= _MIN_CTAS:
        L *= 2
    while -(-S // L) > _MAX_SPLITS:
        L *= 2
    return L, -(-S // L), groups


@functools.cache
def _kernel():
    fn = build.library("decode_attention").decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# one int32 ticket counter per (lane, KV head, head group), zero between
# launches (the kernel's last CTA of each resets its own), kept per device
# and stream so that launches queued on two streams never share one;
# kernels 2 and 4 (paged_decode_attention.py) use the same buffers
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def _check(q, k, v, positions) -> None:
    build.refuse_grad("decode_attention", q, k, v)
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
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] or D % 8 \
            or D > 512:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"the cache {tuple(k.shape)} (D % 8 == 0, D <= 512)")
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
    """Launch the CUDA kernel (all tensors on the current CUDA device):
    one launch, its splits merged inside it."""
    _check(q, k, v, positions)
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    L, splits, groups = split_plan(B, H, K, S)
    per_cta = min(H // K, _MAX_HEADS) * (D + 2)
    part = torch.empty(B * K * groups * splits * per_cta,
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, B * K * groups)
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
        out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, H, K, D, S,
        L, scale, _DTYPES[q.dtype], _DTYPES[k.dtype], stream)
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
