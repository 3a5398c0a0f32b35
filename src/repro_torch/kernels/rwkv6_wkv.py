"""RWKV6 WKV recurrence: the CUDA kernel's wrapper and its plain PyTorch
version.

The kernel (``csrc/rwkv6_wkv.cu``) replaces the Pallas TPU kernel
``repro/kernels/rwkv6_wkv.py::rwkv6_wkv``.  Per (batch, head) a D x D f32
state S is carried over time::

    y_t = r_t . (S + (u * k_t) v_t^T);   S <- diag(w_t) S + k_t v_t^T

r/k/v (B, T, H, D) in f32 or bf16, w (B, T, H, D) f32 decay in (0, 1),
u (H, D) f32, s0 (B, H, D, D) f32 or None for a zero state -> y (B, T, H, D)
in r's dtype and the final state (B, H, D, D) f32.  Any T (the Pallas
kernel asserts ``T % block_t == 0``); D in {16, 32, 64, 128}.  With
``s_out`` the final state is written there, and ``s_out`` may be ``s0``:
the slot pool's decode updates its state in place.

The plain version ports the oracle ``kernels/ref.py::rwkv6_wkv_ref``: a
loop over time in f32, y cast to r's dtype once.  The reference model's
``_wkv_chunk`` (``models/ssm.py:214``) does the same arithmetic, chunked
only by a carried state, so one plain version serves both parity targets.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def rwkv6_wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  s0: torch.Tensor | None = None, *,
                  s_out: torch.Tensor | None = None):
    """Plain WKV (port of ``kernels/ref.py::rwkv6_wkv_ref``).  r/k/v/w
    (B, T, H, D); u (H, D); s0 (B, H, D, D) or None (zeros).  Returns
    (y (B, T, H, D) in r's dtype, s (B, H, D, D) f32); s is copied into
    ``s_out`` when given, as the kernel writes it there."""
    B, T, H, D = r.shape
    s = torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    uf = u.float()[None]
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        at = kt[..., :, None] * vt[..., None, :]
        bonus = (uf * kt)[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s + bonus))
        s = wt[..., :, None] * s + at
    y = torch.stack(ys, dim=1) if ys else r.new_zeros(r.shape, dtype=torch.float32)
    return y.to(r.dtype), (s if s_out is None else s_out.copy_(s))


@functools.cache
def _kernel():
    fn = build.library("rwkv6_wkv").rwkv6_wkv
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, s0, s_out) -> None:
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    named += [(n, t) for n, t in (("s0", s0), ("s_out", s_out))
              if t is not None]
    for name, t in named:
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"rwkv6_wkv: {name} must be on r's CUDA device, "
                             f"got {t.device}")
    if r.device.index != torch.cuda.current_device():
        raise ValueError(f"rwkv6_wkv: r on {r.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_wkv: r/k/v {r.dtype}/{k.dtype}/{v.dtype}: "
                        f"need one of f32 or bf16")
    for name, t in named[3:]:
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv6_wkv: {name} must be f32, got {t.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6_wkv: r/k/v/w shapes {tuple(r.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} {tuple(w.shape)}")
    B, T, H, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv: head dim {D} not in {HEAD_DIMS}")
    if u.shape != (H, D):
        raise ValueError(f"rwkv6_wkv: u {tuple(u.shape)} for {H} heads of {D}")
    for name, t in named[5:]:
        if t.shape != (B, H, D, D):
            raise ValueError(f"rwkv6_wkv: {name} {tuple(t.shape)}, need "
                             f"{(B, H, D, D)}")
    for name, t in named[:4]:
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6_wkv: {name}'s head dim must be "
                             f"contiguous")
    for name, t in named[4:]:
        if not t.is_contiguous():
            raise ValueError(f"rwkv6_wkv: {name} must be contiguous")
    if s0 is not None and s_out is not None \
            and s0.data_ptr() != s_out.data_ptr():
        lo = max(s0.data_ptr(), s_out.data_ptr())
        hi = min(s0.data_ptr(), s_out.data_ptr()) + 4 * s0.numel()
        if lo < hi:
            raise ValueError("rwkv6_wkv: s_out overlaps s0 without being it")


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: torch.Tensor | None = None, *,
              s_out: torch.Tensor | None = None):
    """Launch the CUDA kernel (all tensors on the current CUDA device).
    Returns (y, s); s is ``s_out`` when given (which may be ``s0``)."""
    _check(r, k, v, w, u, s0, s_out)
    B, T, H, D = r.shape
    y = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    if s_out is None:
        s_out = torch.empty(B, H, D, D, dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (r, k, v, w) for s in t.stride()[:3]))
    err = _kernel()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), s_out.data_ptr(), y.data_ptr(),
        B, T, H, D, ctypes.cast(strides, ctypes.c_void_p), _DTYPES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "rwkv6_wkv")
    rwkv6_wkv.launches += 1
    return y, s_out


rwkv6_wkv.launches = 0
