"""GQA flash attention (prompt prefill, and the encoder's forward): the
CUDA kernel's wrapper and its plain PyTorch version.  Query q sees key k
iff ``k <= q`` when ``causal`` (every key when not) and, with ``window``
W > 0, ``k > q - W``: the reference's two flags, independent.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` in every form:
causal or bidirectional, with and without ``window``, at every head dim a
registered config uses.  bf16 runs on the tensor cores (``wgmma`` tiles
fed by TMA), f32 on the CUDA cores (tensor cores in f32 would be TF32):
the route is chosen by dtype alone, never by a retry.  Layout follows
the reference: q (B, H, S, D), k/v (B, K, S, D), head h reading KV head
h*K//H.
Both functions accept any strides with a unit stride on D, so the model
passes ``x.transpose(1, 2)`` views of its (B, S, H, D) activations and no
transpose copy is made; the kernel's output keeps q's layout.

Training adds two calls.  ``flash_attention_lse`` is the same launch with
each query row's log-sum-exp written too (f32, (B, H, S)); the serve
paths call ``flash_attention``, which writes none.  ``flash_attention_bwd``
launches kernel 1's backward (``csrc/flash_attention_bwd.cu``, three
passes, no atomics) from q, k, v, o, dO and that lse: dq, dk and dv, the
last two summed over each KV head's group of query heads.  Like the
forward it takes two routes by dtype: bf16 on the tensor cores (``wgmma``
fed by TMA), f32 on the CUDA cores.  The reference
has no Pallas backward: it trains through XLA autodiff of
``causal_attention``.  ``ops.FlashAttentionFn`` ties the two together.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)  # csrc/flash_attention.cu's


def _check_window(window: int) -> None:
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0 (0 = no "
                         f"window), got {window}")


def _mask(S: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, S) bool: query q sees key k."""
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril()                # k <= q
    if window:
        mask = mask.triu(1 - window)      # k > q - window
    return mask


def _scores(q, k, scale, causal, window):
    """Masked f32 scores (B, H, S, S) and the f32 keys expanded to H."""
    _check_window(window)
    B, H, S, D = q.shape
    ke = k.repeat_interleave(H // k.shape[1], dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), ke) * scale
    return torch.where(_mask(S, causal, window, q.device), s, NEG_INF), ke


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::flash_attention_ref``, its
    mask built from ``causal`` and ``window`` as there).  The normalised P
    is rounded to v's dtype before PV, as the reference model's
    ``_attn_block`` does (the kernel rounds the unnormalised exponentials
    instead); at f32 that is the identity."""
    flash_attention_ref.calls += 1
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s, _ = _scores(q, k, scale, causal, window)
    return _pv(torch.softmax(s, dim=-1), v, q.dtype)


def _pv(p, v, dtype):
    """P (rounded to v's dtype) times v expanded to P's heads."""
    ve = v.repeat_interleave(p.shape[1] // v.shape[1], dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), ve.float())
    return o.to(dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: float | None = None,
                            causal: bool = True, window: int = 0):
    """Plain version of the training forward: ``(o, lse)``, o as
    ``flash_attention_ref`` and lse each query row's log-sum-exp of its
    scaled, masked scores, f32 (B, H, S)."""
    flash_attention_lse_ref.calls += 1
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s, _ = _scores(q, k, scale, causal, window)
    return (_pv(torch.softmax(s, dim=-1), v, q.dtype),
            torch.logsumexp(s, dim=-1))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, *, scale: float | None = None,
                            causal: bool = True, window: int = 0):
    """Plain version of kernel 1's backward, the kernel's formulas in f32:
    P = exp(s scale - lse) on the keys each query sees, delta =
    rowsum(dO * O), dV = P^T dO with P rounded to v's dtype (as
    ``flash_attention_ref`` rounds the P of PV), dP = dO V^T, dS = P (dP -
    delta) rounded to q's dtype (the kernel's tensor-core products take
    bf16 operands; at f32 the identity), dQ = dS K scale, dK = dS^T Q
    scale; dk and dv summed over each KV head's H / K query heads.
    Returns ``(dq, dk, dv)`` in the inputs' dtype."""
    flash_attention_bwd_ref.calls += 1
    B, H, S, D = q.shape
    K = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s, ke = _scores(q, k, scale, causal, window)
    p = torch.exp(s - lse[..., None])        # a masked key's is exp(-1e30)
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1)
    ve = v.repeat_interleave(H // K, dim=1).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, ve) - delta[..., None])
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, ke) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dk = dk.view(B, K, H // K, S, D).sum(dim=2)
    dv = dv.view(B, K, H // K, S, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# calls of the plain versions: a training run on the card shows that none
# ran on its path
flash_attention_ref.calls = 0
flash_attention_lse_ref.calls = 0
flash_attention_bwd_ref.calls = 0


@functools.cache
def _kernel():
    fn = build.library("flash_attention").flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = build.library("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, **more) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
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
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} is "
                             f"not q's shape {tuple(q.shape)}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: q on {q.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")


def _launch(q, k, v, scale, causal, window, lse):
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, k.shape[1], S, D, int(causal), window, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], scale,
        _DTYPES[q.dtype], None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, H, S, D), k/v (B, K, S, D), one dtype
    (bf16 or f32), all on the current CUDA device -> o, laid out like q.
    ``launches`` counts every launch, ``banded`` those whose window is
    narrower than the sequence (0 < window < S), the ones that mask,
    ``bidirectional`` those with ``causal=False``, and ``tensor_core`` the
    bf16 launches, which take the ``wgmma`` kernel (f32 takes the
    CUDA-core one).  No backward: under autograd take
    ``ops.flash_attention``."""
    _check_window(window)
    build.refuse_grad("flash_attention", q, k, v,
                      hint="ops.flash_attention carries kernel 1's backward")
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = _launch(q, k, v, scale, causal, window, None)
    flash_attention.launches += 1
    flash_attention.banded += 0 < window < q.shape[2]
    flash_attention.bidirectional += not causal
    flash_attention.tensor_core += q.dtype == torch.bfloat16
    return out


flash_attention.launches = 0
flash_attention.banded = 0
flash_attention.bidirectional = 0
flash_attention.tensor_core = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None, causal: bool = True,
                        window: int = 0):
    """The training forward: kernel 1 with each query row's log-sum-exp
    written too.  Returns ``(o, lse)``, o as ``flash_attention`` gives it
    and lse f32 (B, H, S).  ``launches`` counts these launches apart from
    the serve form's, ``tensor_core`` the bf16 ones."""
    _check_window(window)
    _check(q, k, v)
    B, H, S, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    out = _launch(q, k, v, scale, causal, window, lse)
    flash_attention_lse.launches += 1
    flash_attention_lse.tensor_core += q.dtype == torch.bfloat16
    return out, lse


flash_attention_lse.launches = 0
flash_attention_lse.tensor_core = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, scale: float | None = None, causal: bool = True,
                        window: int = 0):
    """Launch kernel 1's backward: q, o and dO (B, H, S, D), k/v (B, K,
    S, D) in one dtype with a unit stride on D, lse f32 (B, H, S)
    contiguous from ``flash_attention_lse`` of the same q, k, v and flags.
    Returns ``(dq, dk, dv)``, each laid out like its input, dk and dv
    summed over each KV head's group of query heads.  Three launches (delta,
    dK/dV, dQ) on the current stream; ``launches`` counts calls and
    ``tensor_core`` the bf16 ones, which take the ``wgmma`` kernels (f32
    takes the CUDA-core ones)."""
    _check_window(window)
    _check(q, k, v, o=o, do=do)
    B, H, S, D = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (B, H, S)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be f32 (B, H, S) "
                         f"contiguous on q's device, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # pass 0's delta (and, in bf16, lse) in 64-row tiles per (batch, head)
    delta = torch.empty(B, H, 2 * -(-S // 64) * 64, dtype=torch.float32,
                        device=q.device)
    strides = [st for t in (q, k, v, o, do, dq, dk, dv)
               for st in t.stride()[:3]]
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, k.shape[1], S, D, int(causal), window,
        (ctypes.c_longlong * 24)(*strides), scale, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.tensor_core += q.dtype == torch.bfloat16
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.tensor_core = 0
