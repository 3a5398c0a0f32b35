"""Dispatch between each kernel and its plain version by device.

A CPU tensor runs the plain PyTorch version; a CUDA tensor launches the
hand-written kernel, whose wrapper raises on anything it cannot take.
There is no fallback from a CUDA tensor to the plain version.  The model
calls these through the module (``ops.flash_attention``) so one call site
serves both devices.

Under autograd ``flash_attention`` goes through ``FlashAttentionFn`` and
``rwkv6_wkv`` through ``WkvFn``: kernels 1's and 7's training forms and
their backward kernels on CUDA, their plain versions on the CPU.  No other
kernel has a backward, and its wrapper raises when it would be asked for
one (``build.refuse_grad``).

The meta device takes the plain path as the CPU does (shapes only, nothing
built or launched): ``launch.dryrun`` and ``analysis`` trace whole steps
there.  Every call goes through ``_call``, so ``analysis.op_cost`` and
``analysis.iraudit`` see a kernel call as one unit, counted by its
formula in ``analysis.roofline``, whichever route runs it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dense
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import int8_matmul as _i8
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import paged_prefill_attention as _prefill
from repro_torch.kernels import rwkv6_wkv as _wkv


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (or every one on the meta
    device: the plain path, shapes only), False when every one is on
    CUDA; anything else is an error."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs on devices {sorted(kinds)}: need all "
                     f"on the CPU, all on the meta device or all on CUDA")


# ``_HOOK(name, args, kwargs, run)``, when set, is handed every kernel call
# (``name`` the wrapper's, ``run()`` makes the call); None costs one test
_HOOK = None


def _call(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, the kernel call ``name``, through
    ``_HOOK`` when one is set."""
    if _HOOK is None:
        return fn(*args, **kwargs)
    return _HOOK(name, args, kwargs, lambda: fn(*args, **kwargs))


class FlashAttentionFn(torch.autograd.Function):
    """Kernel 1 under autograd.  The forward keeps each query row's
    log-sum-exp (``flash_attention_lse``) and saves q, k, v, o and lse; the
    backward is kernel 1's backward kernel (``flash_attention_bwd``), which
    recomputes P from them.  On the CPU the same Function runs the plain
    versions, so the CPU tests run its saved tensors and its GQA
    reduction (dk and dv summed over each KV head's query heads)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        kw = dict(scale=scale, causal=causal, window=window)
        fn = (_flash.flash_attention_lse_ref if _on_cpu(q, k, v)
              else _flash.flash_attention_lse)
        o, lse = _call("flash_attention_lse", fn, q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _on_cpu(q, k, v, do):
            fn = _flash.flash_attention_bwd_ref
        else:
            fn = _flash.flash_attention_bwd
            if do.stride() != o.stride():     # the kernel takes o's layout
                do = torch.empty_like(o).copy_(do)
        grads = _call("flash_attention_bwd", fn, q, k, v, o, do, lse,
                      **ctx.kw)
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, scale=None, causal=True, window=0):
    """GQA attention: q (B, H, S, D), k/v (B, K, S, D), any strides; over
    keys k <= q when ``causal`` (every key when not) and, with ``window``
    W > 0, keys k > q - W only.  Under autograd (grad mode on and an input
    that requires grad) it is ``FlashAttentionFn``; otherwise the serve
    form, which writes no lse."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, scale, causal, window)
    fn = (_flash.flash_attention_ref if _on_cpu(q, k, v)
          else _flash.flash_attention)
    return _call("flash_attention", fn, q, k, v, scale=scale, causal=causal,
                 window=window)


def paged_decode_attention(q, k_pool, v_pool, block_tables, positions, *,
                           scale=None, plan_lanes=None):
    """One-token attention over a paged KV pool.  ``plan_lanes`` pins the
    kernel's split plan to that of so many lanes (the plain version has
    no splits)."""
    args = (q, k_pool, v_pool, block_tables, positions)
    if _on_cpu(*args):
        return _call("paged_decode_attention",
                     _paged.paged_decode_attention_ref, *args, scale=scale)
    return _call("paged_decode_attention", _paged.paged_decode_attention,
                 *args, scale=scale, plan_lanes=plan_lanes)


def paged_decode_attention_lse(q, k_pool, v_pool, block_tables, positions,
                               owned, *, scale=None, plan_lanes=None):
    """One-token attention over the owned slots of one pool stripe;
    returns ``(o, lse)``.  ``plan_lanes`` as for
    ``paged_decode_attention``."""
    args = (q, k_pool, v_pool, block_tables, positions, owned)
    if _on_cpu(*args):
        return _call("paged_decode_attention_lse",
                     _paged.paged_decode_attention_lse_ref, *args,
                     scale=scale)
    return _call("paged_decode_attention_lse",
                 _paged.paged_decode_attention_lse, *args, scale=scale,
                 plan_lanes=plan_lanes)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, starts, *,
                            scale=None):
    """Chunk attention over a paged KV pool: q (B, C, H, D) at
    ``starts + c``."""
    args = (q, k_pool, v_pool, block_tables, starts)
    fn = (_prefill.paged_prefill_attention_ref if _on_cpu(*args)
          else _prefill.paged_prefill_attention)
    return _call("paged_prefill_attention", fn, *args, scale=scale)


def paged_prefill_attention_lse(q, k_pool, v_pool, block_tables, starts,
                                owned, *, scale=None):
    """Chunk attention over the owned slots of one pool stripe; returns
    ``(o, lse)``."""
    args = (q, k_pool, v_pool, block_tables, starts, owned)
    fn = (_prefill.paged_prefill_attention_lse_ref if _on_cpu(*args)
          else _prefill.paged_prefill_attention_lse)
    return _call("paged_prefill_attention_lse", fn, *args, scale=scale)


def paged_verify_attention(q, k_pool, v_pool, block_tables, positions, *,
                           scale=None):
    """Speculative verify: chunk attention with ``starts = positions``."""
    args = (q, k_pool, v_pool, block_tables, positions)
    fn = (_prefill.paged_prefill_attention_ref if _on_cpu(*args)
          else _prefill.paged_verify_attention)
    return _call("paged_prefill_attention", fn, *args, scale=scale)


def decode_attention(q, k, v, positions, *, scale=None, ring=False):
    """One-token attention over a contiguous (B, S, K, D) cache, rounded
    as the slot model path rounds (``flash_decode_ref`` on the CPU).  With
    ``ring`` the cache is a sliding window's ring, positions clamped to its
    last slot by the caller, and the CPU takes ``swa_decode_ref``, which
    rounds as the reference's ring decode does; the kernel is the same."""
    if _on_cpu(q, k, v, positions):
        fn = _dense.swa_decode_ref if ring else _dense.flash_decode_ref
    else:
        fn = _dense.decode_attention
    return _call("decode_attention", fn, q, k, v, positions, scale=scale)


class WkvFn(torch.autograd.Function):
    """Kernel 7 under autograd.  The forward is its training form, which
    keeps the state every ``wkv_chunk(D)`` steps, and saves r, k, v, w, u
    and those checkpoints; the backward is kernel 7's backward kernel
    (``rwkv6_wkv_bwd``), which recomputes each chunk's states from its
    checkpoint.  Returns (y, final state); the final state's gradient
    feeds the backward where the state is used (None otherwise), and ds0
    goes back to s0 where one was given.  On the CPU the same Function
    runs the plain versions, so the CPU tests run its saved tensors and
    checkpoints."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        fn = (_wkv.rwkv6_wkv_train_ref
              if _on_cpu(*(t for t in (r, k, v, w, u, s0) if t is not None))
              else _wkv.rwkv6_wkv_train)
        y, s, ckpt = _call("rwkv6_wkv_train", fn, r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.has_s0 = s0 is not None
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        if _on_cpu(r, k, v, w, u, dy):
            fn = _wkv.rwkv6_wkv_bwd_ref
        else:
            fn = _wkv.rwkv6_wkv_bwd
            ds = None if ds is None else ds.float().contiguous()
        grads = _call("rwkv6_wkv_bwd", fn, r, k, v, w, u, ckpt, dy, ds)
        dr, dk, dv, dw, du, ds0 = grads
        return dr, dk, dv, dw, du, (ds0 if ctx.has_s0 else None)


def rwkv6_wkv(r, k, v, w, u, s0=None, *, s_out=None):
    """RWKV6 WKV recurrence over (B, T, H, D); returns (y, final state).
    With ``s_out`` (which may be ``s0``) the final state is written there.
    Under autograd (grad mode on and an input that requires grad) it is
    ``WkvFn``, which writes no ``s_out``; otherwise the serve form."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        if s_out is not None:
            raise ValueError("rwkv6_wkv: under autograd the state is "
                             "returned, not written into s_out")
        return WkvFn.apply(r, k, v, w, u, s0)
    fn = (_wkv.rwkv6_wkv_ref
          if _on_cpu(*(t for t in (r, k, v, w, u, s0, s_out) if t is not None))
          else _wkv.rwkv6_wkv)
    return _call("rwkv6_wkv", fn, r, k, v, w, u, s0, s_out=s_out)


def int8_matmul(x_q, w_q, sx, sw, *, out_dtype=torch.bfloat16):
    """w8a8 GEMM: x_q (M, K) and w_q (K, N) int8, sx (M, 1) and sw (1, N)
    f32 -> (M, N) in ``out_dtype``."""
    fn = (_i8.int8_matmul_ref if _on_cpu(x_q, w_q, sx, sw)
          else _i8.int8_matmul)
    return _call("int8_matmul", fn, x_q, w_q, sx, sw, out_dtype=out_dtype)


def int8_matmul_quantized(x, w, *, out_dtype=torch.bfloat16):
    """Quantize bf16/f32 operands on the fly (per row of x, per column of
    w), then the w8a8 GEMM."""
    fn = (_i8.int8_matmul_quantized_ref if _on_cpu(x, w)
          else _i8.int8_matmul_quantized)
    return _call("int8_matmul_quantized", fn, x, w, out_dtype=out_dtype)


def quantize_rows(x):
    """Symmetric per-row int8 quantization: (x_q, scale (M, 1) f32).
    Plain torch on either device: it is plain ``jnp`` in the reference."""
    _on_cpu(x)
    return _i8.quantize_rows(x)


def quantize_cols(w):
    """Symmetric per-column int8 quantization: (w_q, scale (1, N) f32).
    Plain torch on either device."""
    _on_cpu(w)
    return _i8.quantize_cols(w)


__all__ = ["flash_attention", "paged_decode_attention",
           "paged_decode_attention_lse", "paged_prefill_attention",
           "paged_prefill_attention_lse", "paged_verify_attention", "decode_attention", "rwkv6_wkv",
           "int8_matmul", "int8_matmul_quantized", "quantize_rows",
           "quantize_cols"]
