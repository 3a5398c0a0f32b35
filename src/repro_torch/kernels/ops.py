"""Each hand-written kernel as one ``torch.library`` op, and the calls the
model makes.

Every kernel is registered once, below, as ``torch.ops.repro_torch.<name>``
with its schema and three implementations: the CUDA kernel's wrapper for
CUDA tensors, its plain PyTorch version for CPU tensors, and a fake that
gives its outputs' shapes, dtypes and strides (the meta device and
``FakeTensor`` take it, so a meta trace runs no plain loop).  The
dispatcher picks the route by the inputs' device; there is no fallback
from a CUDA tensor to the plain version, and a kernel's wrapper raises on
anything it cannot take.  Inputs on two devices raise ``ValueError``.
``torch.ops.repro_torch`` lists the ops; ``torch.library.opcheck`` holds
each fake against the implementation of the inputs' device.

No op has an autograd formula: each one raises when grad mode is on and
an input requires grad (``build.refuse_grad``), on every device, rather
than cut the gradient.  Under autograd ``flash_attention`` goes through
``FlashAttentionFn`` and ``rwkv6_wkv`` through ``WkvFn``: kernels 1's and
7's training forms and their backward kernels, each an op, called where
no gradient is recorded.

The model calls the functions of this module (``ops.flash_attention``),
each one call of its op, so one call site serves every device.  A
``TorchDispatchMode`` sees each kernel call as one op:
``analysis.op_cost`` counts it by its formula in ``analysis.roofline``,
and a profiler trace names it, whichever route runs it.
"""
from __future__ import annotations

import torch
from torch.library import Library, fallthrough_kernel, register_fake

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as _dense
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import int8_matmul as _i8
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import paged_prefill_attention as _prefill
from repro_torch.kernels import rwkv6_wkv as _wkv

NAMESPACE = "repro_torch"
_LIB = Library(NAMESPACE, "DEF")


def _refusing(name: str, fn, hint: str = ""):
    """``fn`` behind the check every route makes: no gradient asked of an
    op that has none (``build.refuse_grad``)."""
    def impl(*args, **kwargs):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in args):
            build.refuse_grad(name, *args, hint=hint)
        return fn(*args, **kwargs)
    return impl


def _one_device(name: str, fake):
    """``fake`` behind a check that its tensors (the schema's positional
    arguments) share a device.  The dispatcher hands a mix of meta and
    CPU tensors to the fake; a mix with CUDA tensors goes to the CUDA
    implementation, whose wrapper refuses any tensor off q's device, and
    the CPU implementation sees CPU tensors alone."""
    def impl(*args, **kwargs):
        kinds = {t.device.type for t in args if t is not None}
        if len(kinds) > 1:
            raise ValueError(f"{name}: inputs on devices {sorted(kinds)}: "
                             f"need all on the CPU, all on the meta device "
                             f"or all on CUDA")
        return fake(*args, **kwargs)
    return impl


def _register(name: str, schema: str, *, cuda, cpu, fake, hint: str = ""):
    """Define op ``name`` (``name.overload`` for an overload) with its
    three implementations; returns the op to call."""
    _LIB.define(name + schema)
    _LIB.impl(name, _refusing(name, cuda, hint), "CUDA")
    _LIB.impl(name, _refusing(name, cpu, hint), "CPU")
    # no autograd formula: autograd passes the call through to the route,
    # which refuses a gradient
    _LIB.impl(name, fallthrough_kernel, "Autograd")
    register_fake(f"{NAMESPACE}::{name}",
                  _refusing(name, _one_device(name, fake), hint), lib=_LIB)
    op, _, overload = name.partition(".")
    return getattr(getattr(getattr(torch.ops, NAMESPACE), op),
                   overload or "default")


# ---------------------------------------------------------------------------
# the fakes: each kernel's outputs as shapes only
# ---------------------------------------------------------------------------

def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def _attn_out(q, *_, **__):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _flash_lse_out(q, *_, **__):
    return _attn_out(q), _empty(q.shape[:3], torch.float32, q)


def _flash_bwd_out(q, k, v, *_, **__):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def _lse_out(q, *_, **__):
    return _attn_out(q), _empty(q.shape[:-1], torch.float32, q)


def _chunk_out(q, *_, **__):
    """Kernel 3's o: contiguous from the kernel (as on the meta device,
    which stands in for the card); its plain versions write it in (B, H,
    C, D) order."""
    if q.device.type != "cpu":
        return _attn_out(q)
    B, C, H, D = q.shape
    return _empty((B, H, C, D), q.dtype, q).transpose(1, 2)


def _chunk_lse_out(q, *_, **__):
    """Kernel 3's owned/LSE form: o as ``_chunk_out``, and lse (B, C, H)
    f32 laid out as o is."""
    if q.device.type != "cpu":
        return _lse_out(q)
    B, C, H, D = q.shape
    return (_chunk_out(q),
            _empty((B, H, C), torch.float32, q).transpose(1, 2))


def _wkv_out(r, *_, **__):
    B, T, H, D = r.shape
    return torch.empty_like(r), _empty((B, H, D, D), torch.float32, r)


def _wkv_train_out(r, *_, **__):
    B, T, H, D = r.shape
    return (*_wkv_out(r), _empty((B, H, -(-T // _wkv.wkv_chunk(D)), D, D),
                                 torch.float32, r))


def _wkv_bwd_out(r, k, v, w, u, *_, **__):
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            _empty(w.shape, torch.float32, r),
            _empty(u.shape, torch.float32, r), _wkv_out(r)[1])


def _int8_out(x, w, *_, out_dtype, **__):
    return _empty((x.shape[0], w.shape[1]), out_dtype, x)


# ---------------------------------------------------------------------------
# the registrations
# ---------------------------------------------------------------------------

# each implementation looks its function up in the kernel's module at
# call time, so a test can patch the module's wrapper or plain version
_FLASH_ARGS = ("(Tensor q, Tensor k, Tensor v, *, float? scale=None, "
               "bool causal=True, int window=0)")
_FLASH_HINT = "ops.flash_attention carries kernel 1's backward"
_WKV_HINT = "ops.rwkv6_wkv carries kernel 7's backward"
_POOL = "Tensor q, Tensor k_pool, Tensor v_pool, Tensor block_tables"
_WKV_ARGS = "Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? s0"

_FLASH = _register(
    "flash_attention", _FLASH_ARGS + " -> Tensor",
    cuda=lambda *a, **k: _flash.flash_attention(*a, **k),
    cpu=lambda *a, **k: _flash.flash_attention_ref(*a, **k),
    fake=_attn_out, hint=_FLASH_HINT)
_FLASH_LSE = _register(
    "flash_attention_lse", _FLASH_ARGS + " -> (Tensor, Tensor)",
    cuda=lambda *a, **k: _flash.flash_attention_lse(*a, **k),
    cpu=lambda *a, **k: _flash.flash_attention_lse_ref(*a, **k),
    fake=_flash_lse_out, hint=_FLASH_HINT)
_FLASH_BWD = _register(
    "flash_attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor do, Tensor lse, *, "
    "float? scale=None, bool causal=True, int window=0) "
    "-> (Tensor, Tensor, Tensor)",
    cuda=lambda *a, **k: _flash.flash_attention_bwd(*a, **k),
    cpu=lambda *a, **k: _flash.flash_attention_bwd_ref(*a, **k),
    fake=_flash_bwd_out, hint=_FLASH_HINT)
# the plain versions of kernels 2 and 4 have no splits: no plan to pin
_PAGED_DECODE = _register(
    "paged_decode_attention",
    f"({_POOL}, Tensor positions, *, float? scale=None, "
    "int? plan_lanes=None) -> Tensor",
    cuda=lambda *a, **k: _paged.paged_decode_attention(*a, **k),
    cpu=lambda *a, plan_lanes=None, **k:
        _paged.paged_decode_attention_ref(*a, **k),
    fake=_attn_out)
_PAGED_DECODE_LSE = _register(
    "paged_decode_attention_lse",
    f"({_POOL}, Tensor positions, Tensor owned, *, float? scale=None, "
    "int? plan_lanes=None) -> (Tensor, Tensor)",
    cuda=lambda *a, **k: _paged.paged_decode_attention_lse(*a, **k),
    cpu=lambda *a, plan_lanes=None, **k:
        _paged.paged_decode_attention_lse_ref(*a, **k),
    fake=_lse_out)
_PAGED_PREFILL = _register(
    "paged_prefill_attention",
    f"({_POOL}, Tensor starts, *, float? scale=None) -> Tensor",
    cuda=lambda *a, **k: _prefill.paged_prefill_attention(*a, **k),
    cpu=lambda *a, **k: _prefill.paged_prefill_attention_ref(*a, **k),
    fake=_chunk_out)
_PAGED_PREFILL_LSE = _register(
    "paged_prefill_attention_lse",
    f"({_POOL}, Tensor starts, Tensor owned, *, float? scale=None) "
    "-> (Tensor, Tensor)",
    cuda=lambda *a, **k: _prefill.paged_prefill_attention_lse(*a, **k),
    cpu=lambda *a, **k: _prefill.paged_prefill_attention_lse_ref(*a, **k),
    fake=_chunk_lse_out)
# kernel 3's launch with starts = positions: an entry point of its own on
# the card, kernel 3's plain version on the CPU
_PAGED_VERIFY = _register(
    "paged_verify_attention",
    f"({_POOL}, Tensor positions, *, float? scale=None) -> Tensor",
    cuda=lambda *a, **k: _prefill.paged_verify_attention(*a, **k),
    cpu=lambda *a, **k: _prefill.paged_prefill_attention_ref(*a, **k),
    fake=_chunk_out)


def _dense_cpu(q, k, v, positions, *, scale=None, ring: bool = False):
    """Kernel 5's plain versions: the ring decode's rounding with
    ``ring``, the slot path's without; the kernel is the same."""
    fn = _dense.swa_decode_ref if ring else _dense.flash_decode_ref
    return fn(q, k, v, positions, scale=scale)


_DECODE = _register(
    "decode_attention",
    "(Tensor q, Tensor k, Tensor v, Tensor positions, *, "
    "float? scale=None, bool ring=False) -> Tensor",
    cuda=lambda q, k, v, positions, *, scale=None, ring=False:
        _dense.decode_attention(q, k, v, positions, scale=scale),
    cpu=_dense_cpu, fake=_attn_out)
# kernel 7's serve form returns a fresh final state, or (the overload
# ``state_out``) writes it into ``s_out``, which may be ``s0``, and
# returns y alone: an op returns no alias of its inputs
_WKV = _register(
    "rwkv6_wkv", f"({_WKV_ARGS}) -> (Tensor, Tensor)",
    cuda=lambda *a: _wkv.rwkv6_wkv(*a),
    cpu=lambda *a: _wkv.rwkv6_wkv_ref(*a),
    fake=_wkv_out, hint=_WKV_HINT)
_WKV_INTO = _register(
    "rwkv6_wkv.state_out", f"({_WKV_ARGS}, Tensor(a!) s_out) -> Tensor",
    cuda=lambda *a: _wkv.rwkv6_wkv(*a[:6], s_out=a[6])[0],
    cpu=lambda *a: _wkv.rwkv6_wkv_ref(*a[:6], s_out=a[6])[0],
    fake=lambda r, *_: torch.empty_like(r), hint=_WKV_HINT)
_WKV_TRAIN = _register(
    "rwkv6_wkv_train", f"({_WKV_ARGS}) -> (Tensor, Tensor, Tensor)",
    cuda=lambda *a: _wkv.rwkv6_wkv_train(*a),
    cpu=lambda *a: _wkv.rwkv6_wkv_train_ref(*a),
    fake=_wkv_train_out, hint=_WKV_HINT)
_WKV_BWD = _register(
    "rwkv6_wkv_bwd",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor ckpt, "
    "Tensor dy, Tensor? ds) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    cuda=lambda *a: _wkv.rwkv6_wkv_bwd(*a),
    cpu=lambda *a: _wkv.rwkv6_wkv_bwd_ref(*a),
    fake=_wkv_bwd_out, hint=_WKV_HINT)
_INT8 = _register(
    "int8_matmul",
    "(Tensor x_q, Tensor w_q, Tensor sx, Tensor sw, *, "
    "ScalarType out_dtype) -> Tensor",
    cuda=lambda *a, **k: _i8.int8_matmul(*a, **k),
    cpu=lambda *a, **k: _i8.int8_matmul_ref(*a, **k),
    fake=_int8_out)
_INT8_QUANTIZED = _register(
    "int8_matmul_quantized",
    "(Tensor x, Tensor w, *, ScalarType out_dtype) -> Tensor",
    cuda=lambda *a, **k: _i8.int8_matmul_quantized(*a, **k),
    cpu=lambda *a, **k: _i8.int8_matmul_quantized_ref(*a, **k),
    fake=_int8_out)


# ---------------------------------------------------------------------------
# the calls the model makes
# ---------------------------------------------------------------------------

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
        o, lse = _FLASH_LSE(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.is_cuda and do.stride() != o.stride():
            do = torch.empty_like(o).copy_(do)  # the kernel takes o's layout
        grads = _FLASH_BWD(q, k, v, o, do, lse, **ctx.kw)
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
    return _FLASH(q, k, v, scale=scale, causal=causal, window=window)


def paged_decode_attention(q, k_pool, v_pool, block_tables, positions, *,
                           scale=None, plan_lanes=None):
    """One-token attention over a paged KV pool.  ``plan_lanes`` pins the
    kernel's split plan to that of so many lanes (the plain version has
    no splits)."""
    return _PAGED_DECODE(q, k_pool, v_pool, block_tables, positions,
                         scale=scale, plan_lanes=plan_lanes)


def paged_decode_attention_lse(q, k_pool, v_pool, block_tables, positions,
                               owned, *, scale=None, plan_lanes=None):
    """One-token attention over the owned slots of one pool stripe;
    returns ``(o, lse)``.  ``plan_lanes`` as for
    ``paged_decode_attention``."""
    return _PAGED_DECODE_LSE(q, k_pool, v_pool, block_tables, positions,
                             owned, scale=scale, plan_lanes=plan_lanes)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, starts, *,
                            scale=None):
    """Chunk attention over a paged KV pool: q (B, C, H, D) at
    ``starts + c``."""
    return _PAGED_PREFILL(q, k_pool, v_pool, block_tables, starts,
                          scale=scale)


def paged_prefill_attention_lse(q, k_pool, v_pool, block_tables, starts,
                                owned, *, scale=None):
    """Chunk attention over the owned slots of one pool stripe; returns
    ``(o, lse)``."""
    return _PAGED_PREFILL_LSE(q, k_pool, v_pool, block_tables, starts, owned,
                              scale=scale)


def paged_verify_attention(q, k_pool, v_pool, block_tables, positions, *,
                           scale=None):
    """Speculative verify: chunk attention with ``starts = positions``."""
    return _PAGED_VERIFY(q, k_pool, v_pool, block_tables, positions,
                         scale=scale)


def decode_attention(q, k, v, positions, *, scale=None, ring=False):
    """One-token attention over a contiguous (B, S, K, D) cache, rounded
    as the slot model path rounds (``flash_decode_ref`` on the CPU).  With
    ``ring`` the cache is a sliding window's ring, positions clamped to its
    last slot by the caller, and the CPU takes ``swa_decode_ref``, which
    rounds as the reference's ring decode does; the kernel is the same."""
    return _DECODE(q, k, v, positions, scale=scale, ring=ring)


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
        y, s, ckpt = _WKV_TRAIN(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.has_s0 = s0 is not None
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        if ds is not None and ds.is_cuda:
            ds = ds.float().contiguous()
        dr, dk, dv, dw, du, ds0 = _WKV_BWD(r, k, v, w, u, ckpt, dy, ds)
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
    if s_out is None:
        return _WKV(r, k, v, w, u, s0)
    return _WKV_INTO(r, k, v, w, u, s0, s_out), s_out


def int8_matmul(x_q, w_q, sx, sw, *, out_dtype=torch.bfloat16):
    """w8a8 GEMM: x_q (M, K) and w_q (K, N) int8, sx (M, 1) and sw (1, N)
    f32 -> (M, N) in ``out_dtype``."""
    return _INT8(x_q, w_q, sx, sw, out_dtype=out_dtype)


def int8_matmul_quantized(x, w, *, out_dtype=torch.bfloat16):
    """Quantize bf16/f32 operands on the fly (per row of x, per column of
    w), then the w8a8 GEMM."""
    return _INT8_QUANTIZED(x, w, out_dtype=out_dtype)


def quantize_rows(x):
    """Symmetric per-row int8 quantization: (x_q, scale (M, 1) f32).
    Plain torch on either device: it is plain ``jnp`` in the reference."""
    return _i8.quantize_rows(x)


def quantize_cols(w):
    """Symmetric per-column int8 quantization: (w_q, scale (1, N) f32).
    Plain torch on either device."""
    return _i8.quantize_cols(w)


def registered() -> list[str]:
    """The ops of the namespace, by name (an op's overloads under one)."""
    return sorted({name.split("::")[1].split(".")[0]
                   for name in torch._C._dispatch_get_all_op_names()
                   if name.startswith(f"{NAMESPACE}::")})


__all__ = ["flash_attention", "paged_decode_attention",
           "paged_decode_attention_lse", "paged_prefill_attention",
           "paged_prefill_attention_lse", "paged_verify_attention", "decode_attention", "rwkv6_wkv",
           "int8_matmul", "int8_matmul_quantized", "quantize_rows",
           "quantize_cols"]
