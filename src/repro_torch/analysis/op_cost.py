"""A step's flops, bytes and op census, counted from torch (the port's
counterpart of ``repro.analysis.hlo_cost``).

The reference parses the optimized HLO of a jitted step.  The port has no
compiled graph to parse, so ``count`` runs the step under a
``TorchDispatchMode`` and counts every ATen op it issues, on any device:
on the ``meta`` device no numerics run and nothing is allocated
(``launch.dryrun`` counts full-width cells there), on the CPU or a card
the step runs as it would.

* **Kernels count by their formula.**  Every kernel is one op of the
  ``repro_torch`` namespace (``kernels.ops`` registers them), which
  reaches the mode whole, whatever implementation the dispatcher then
  runs (the kernel, the plain version or, on the meta device, the
  fake), and counts as ``kernel_work``: its row's function in
  ``analysis.roofline``, the data-dependent counts (live keys, owned
  rows, seen pairs) read off its tensors, or, on the meta device where
  there is no data, the most its shapes allow (every table slot live,
  every chunk at the table's end, every block owned).  Nothing its
  implementation does is counted (the mode is off while an op runs):
  the masked dense gathers of kernels 2-4's plain versions and the
  step-by-step recurrence of kernel 7's are not the kernel's
  arithmetic.
* **Matmuls** (``mm``, ``bmm``, ``addmm``, ``baddbmm``) count 2 M N K
  flops (``torch.utils.flop_counter``'s formulas) as ``gemm_flops``; any
  other op that computes counts one flop per output element, as
  ``hlo_cost.py`` counts elementwise ops; data movement (copies, gathers,
  scatters, factories, concatenation) and views count none.
* **Bytes** are an HBM-traffic proxy for eager execution, where no op is
  fused: every op that is not a view reads each tensor argument once and
  writes each output once (an in-place op reads and writes its target),
  except that a gather (``embedding``, ``index``, ...) reads only the rows
  it returns, and a scatter into a tensor (``index_put_``, ...) reads
  and writes only the rows it writes: a decode step's write of one
  token into the KV pool is not a pass over the pool.  A kernel's bytes
  are its formula's.
* **Peak live bytes**: the bytes of the tensors handed in as ``live``
  plus every storage an op (or a kernel call, for its outputs) allocates
  while it lives, freed when torch frees it; the largest sum seen.  Like
  ``jaxprs.py``'s ``peak_live_bytes`` it is an estimate of the
  allocator's peak: no caching-allocator rounding, no workspace.

``breakdown`` (``loop_breakdown``'s counterpart) splits the counts by
layer (the layer loops of ``models/transformer.py``; backward ops carry
no Python frame and count as ``"backward"``) and by kernel name.
"""
from __future__ import annotations

import sys
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import roofline as R
from repro_torch.kernels.ops import NAMESPACE as KERNELS

_GEMMS = {"mm", "bmm", "addmm", "baddbmm"}
# ops that move or make data without arithmetic: no flops
_MOVES = {"_to_copy", "copy", "copy_", "clone", "contiguous", "index",
          "index_put", "index_put_", "index_select", "gather", "scatter",
          "scatter_", "cat", "stack", "embedding", "zeros", "zeros_like",
          "empty", "empty_like", "empty_strided", "full", "full_like",
          "ones", "ones_like", "new_zeros", "new_empty", "new_full",
          "new_ones", "arange", "fill", "fill_", "zero_", "lift_fresh",
          "lift_fresh_copy", "_unsafe_view", "constant_pad_nd", "repeat",
          "repeat_interleave", "expand_copy", "masked_fill", "masked_fill_",
          "where", "select_scatter", "slice_scatter", "_local_scalar_dense",
          "scalar_tensor", "flip", "roll", "tril", "triu", "detach",
          "alias", "set_", "resize_", "randperm", "_index_put_impl_"}
_LAYER_LOOPS = {"_trunk", "prefill_chunk_paged", "decode_step",
                "decode_step_paged"}
# what those loops call once a layer
_LAYER_CALLS = {"layer", "checkpoint", "block_decode", "block_decode_paged",
                "block_prefill_paged"}
# ops that read only the rows they return, and ops that write only some
# rows of their first argument
_GATHERS = {"embedding", "index", "index_select", "gather", "take"}
_SCATTERS = {"index_put_", "index_put", "_index_put_impl_", "scatter_",
             "scatter", "scatter_add_", "scatter_add", "index_copy_",
             "index_add_", "masked_scatter_"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# kernel work, from a call's tensors
# ---------------------------------------------------------------------------

def _op_bytes(name: str, args, kwargs, outs) -> int:
    """The bytes proxy of one ATen op (see the module docstring)."""
    ins = list(_tensors((args, kwargs)))
    ids = sum(_nbytes(t) for t in ins if not t.is_floating_point())
    if name in _GATHERS:
        return 2 * sum(_nbytes(t) for t in outs) + ids
    if name in _SCATTERS:
        rows = sum(_nbytes(t) for t in ins[1:] if t.is_floating_point())
        return 2 * rows + ids
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _paged_decode(q, kp, vp, tables, pos, *rest, **_):
    B, H, D = q.shape
    bs, K, T = kp.shape[1], kp.shape[2], tables.shape[1]
    if pos.is_meta:
        keys, live = B * T * bs, B * T
    else:
        keys = int((pos.long() + 1).sum().item())
        live = int(((pos.long() + bs) // bs).sum().item())
    return R.paged_decode_work(B, H, K, D, q.dtype, kp.dtype, keys, live)


def _paged_decode_lse(q, k_s, v_s, local, pos, owned, **_):
    (B, H, D), (T, bs, K) = q.shape, (local.shape[1],) + k_s.shape[1:3]
    if pos.is_meta or owned.is_meta:
        keys, seen, blocks = B * T * bs, B * T, B * T
    else:
        dev = pos.device
        live = ((torch.arange(T * bs, device=dev)[None, :] <= pos[:, None])
                & (owned != 0).repeat_interleave(bs, dim=1))
        keys = int(live.sum().item())
        seen = int(((torch.arange(T, device=dev)[None, :] * bs)
                    <= pos[:, None]).sum().item())
        blocks = int(live.reshape(B, T, bs).any(-1).sum().item())
    return R.paged_decode_lse_work(B, H, K, D, q.dtype, k_s.dtype, keys,
                                   seen, blocks)


def _chunk_starts(starts, T: int, bs: int, C: int) -> list:
    """Each lane's start: read off ``starts``, or on the meta device the
    chunk at the table's end."""
    if starts.is_meta:
        return [max(T * bs - C, 0)] * starts.shape[0]
    return [int(x) for x in starts.tolist()]


def _paged_prefill(q, kp, vp, tables, starts, **_):
    B, C, H, D = q.shape
    n_blocks, bs, K = kp.shape[:3]
    T = tables.shape[1]
    st = _chunk_starts(starts, T, bs, C)
    if tables.is_meta:
        keys = min(B * T * bs, n_blocks * bs)
    else:
        # distinct (block, offset) key rows the lanes read: a padded lane
        # names block 0 throughout, so its keys are one block's
        tab = tables.tolist()
        keys = len({(tab[b][kpos // bs], kpos % bs)
                    for b, s0 in enumerate(st)
                    for kpos in range(min(s0 + C, T * bs))})
    pairs = sum(C * s0 + C * (C + 1) // 2 for s0 in st)
    blocks = sum(_ceil(s0 + C, bs) for s0 in st)
    return R.paged_prefill_work(B, C, H, K, D, q.dtype, kp.dtype, keys, pairs,
                                blocks)


def _paged_prefill_lse(q, k_s, v_s, local, starts, owned, **_):
    B, C, H, D = q.shape
    T, (n_blocks, bs, K) = local.shape[1], k_s.shape[:3]
    st = _chunk_starts(starts, T, bs, C)
    if local.is_meta or owned.is_meta or starts.is_meta:
        rows = min(B * T * bs, n_blocks * bs)
        pairs = sum(C * s0 + C * (C + 1) // 2 for s0 in st)
    else:
        dev = starts.device
        kpos = torch.arange(T * bs, device=dev)
        qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]
        own = (owned != 0).repeat_interleave(bs, dim=1)
        sees = (kpos[None, None, :] <= qpos[:, :, None]) & own[:, None, :]
        pairs = int(sees.sum().item())
        loc, own_l = local.tolist(), owned.tolist()
        rows = len({(loc[b][k // bs], k % bs)
                    for b in range(B) for k in range(min(st[b] + C, T * bs))
                    if own_l[b][k // bs]})
    blocks = sum(_ceil(s0 + C, bs) for s0 in st)
    return R.paged_prefill_lse_work(B, C, H, K, D, q.dtype, k_s.dtype, rows,
                                    pairs, blocks)


def _decode(q, k, v, pos, **_):
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    keys = B * S if pos.is_meta else int((pos.long() + 1).sum().item())
    return R.decode_work(B, H, K, D, q.dtype, k.dtype, keys)


def _flash(q, k, v, *, causal=True, window=0, lse=False, **_):
    B, H, S, D = q.shape
    return R.flash_attention_work(B, H, k.shape[1], S, D, q.dtype,
                                  causal=causal, window=window, lse=lse)


def _flash_bwd(q, k, v, o, do, lse, *, causal=True, window=0, **_):
    B, H, S, D = q.shape
    return R.flash_attention_bwd_work(B, H, k.shape[1], S, D, q.dtype,
                                      causal=causal, window=window)


def _wkv(r, k, v, w, u, s0=None, *_, **__):
    B, T, H, D = r.shape
    return R.wkv_work(B, T, H, D, r.dtype, state_in=s0 is not None)


def _wkv_train(r, k, v, w, u, s0=None, **_):
    from repro_torch.kernels.rwkv6_wkv import wkv_chunk
    B, T, H, D = r.shape
    return R.wkv_train_work(B, T, H, D, r.dtype, _ceil(T, wkv_chunk(D)),
                            state_in=s0 is not None)


def _wkv_bwd(r, k, v, w, u, ckpt, dy, ds=None, **_):
    B, T, H, D = r.shape
    return R.wkv_bwd_work(B, T, H, D, r.dtype, ckpt.shape[2],
                          ds_in=ds is not None)


def _int8(x, w, *rest, out_dtype=torch.bfloat16, **_):
    return R.int8_matmul_work(x.shape[0], x.shape[1], w.shape[1], out_dtype)


KERNEL_WORK = {
    "flash_attention": _flash,
    "flash_attention_lse": lambda *a, **k: _flash(*a, lse=True, **k),
    "flash_attention_bwd": _flash_bwd,
    "paged_decode_attention": _paged_decode,
    "paged_decode_attention_lse": _paged_decode_lse,
    "paged_prefill_attention": _paged_prefill,
    "paged_prefill_attention_lse": _paged_prefill_lse,
    "paged_verify_attention": _paged_prefill,
    "decode_attention": _decode,
    "rwkv6_wkv": _wkv,
    "rwkv6_wkv_train": _wkv_train,
    "rwkv6_wkv_bwd": _wkv_bwd,
    "int8_matmul": _int8,
    "int8_matmul_quantized": _int8,
}


def kernel_work(name: str, args: tuple, kwargs: dict | None = None) -> tuple:
    """``(bytes, flops, peak)`` of one call of kernel ``name`` (an op of
    ``kernels.ops``) on ``args``: its ``analysis.roofline`` formula,
    the data-dependent counts read off the tensors (the most the shapes
    allow on the meta device)."""
    return KERNEL_WORK[name](*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------

class _Live:
    """Bytes of the storages alive now, each freed by a finalizer."""

    def __init__(self, base: int):
        self.now = base
        self.peak = base
        self.seen: set = set()

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.seen:
            return
        self.seen.add(key)
        n = st.nbytes()
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self.seen.discard(key)
        self.now -= n


_COMPOSITE: dict = {}


def composite(func) -> bool:
    """Whether ``func`` is a composite op (``matmul``, ``einsum``,
    ``linear``, ...).  Under ``torch.inference_mode`` composite ops reach
    a dispatch mode whole; run as their parts (``func.decompose`` under
    the mode) they count as they do under ``torch.no_grad``: ``matmul`` as
    the ``mm`` it makes."""
    hit = _COMPOSITE.get(func)
    if hit is None:
        hit = _COMPOSITE[func] = \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd")
    return hit


class CostMode(TorchDispatchMode):
    """Counts every op issued under it (see the module docstring): an op
    of the kernels' namespace by its formula, any other as an ATen op."""

    def __init__(self, *, live: int = 0, breakdown: bool = False):
        super().__init__()
        self.flops = 0
        self.gemm_flops = 0
        self.bytes = 0
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.census: Counter = Counter()
        self.kernels: dict = {}
        self.sites: dict = {}
        self.breakdown = breakdown
        self.live = _Live(live)

    # -- attribution -------------------------------------------------------
    def _site(self) -> str:
        f, inner = sys._getframe(2), None
        while f is not None:
            if f.f_code.co_name in _LAYER_LOOPS and f.f_code.co_filename \
                    .endswith("transformer.py"):
                if inner in _LAYER_CALLS:          # inside the loop's layer
                    return f"layer {f.f_locals['i']}"
                return "other"                     # embedding, norm, head
            inner, f = f.f_code.co_name, f.f_back
        return "backward" if torch._C._current_graph_task_id() != -1 \
            else "other"

    def _add(self, site_key: str, flops: int, n_bytes: int) -> None:
        if self.breakdown:
            row = self.sites.setdefault(site_key, [0, 0])
            row[0] += flops
            row[1] += n_bytes

    # -- ops ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == KERNELS:
            return self.kernel(func, args, kwargs)
        if composite(func):
            with self:                    # its parts come through the mode
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        self.census[name] += 1
        outs = list(_tensors(out))
        if func.is_view:
            return out
        flops = 0
        if name in _GEMMS:
            flops = int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
            self.gemm_flops += flops
        elif name not in _MOVES:
            flops = sum(t.numel() for t in outs)
        n_bytes = _op_bytes(name, args, kwargs, outs)
        self.flops += flops
        self.bytes += n_bytes
        for t in outs:
            self.live.track(t)
        if self.breakdown:
            self._add(self._site(), flops, n_bytes)
        return out

    def kernel(self, func, args, kwargs):
        """One call of kernel op ``func``: counted by its formula, then
        run.  Neither the formula's reads nor the implementation reach a
        torch function mode (an audit's host-call record)."""
        name = func._overloadpacket.__name__
        with torch._C.DisableTorchFunction():
            n_bytes, flops, _ = kernel_work(name, args, kwargs)
            out = func(*args, **kwargs)
        row = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += n_bytes
        self.kernel_flops += flops
        self.kernel_bytes += n_bytes
        self.flops += flops
        self.bytes += n_bytes
        self.census[f"kernel:{name}"] += 1
        # its outputs, and what it writes into (kernel 7's ``s_out``)
        written = [a for a, arg in zip(args, func._schema.arguments)
                   if arg.alias_info is not None and arg.alias_info.is_write]
        for t in _tensors((out, written)):
            self.live.track(t)
        if self.breakdown:
            self._add(self._site(), flops, n_bytes)
        return out

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "gemm_flops": self.gemm_flops,
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes,
                "peak_live_bytes": self.live.peak,
                "census": dict(sorted(self.census.items())),
                "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
                "breakdown": {k: {"flops": v[0], "bytes": v[1]}
                              for k, v in self.sites.items()}}


class counting:
    """Context manager: ``with counting(live=...) as mode: step()``, then
    ``mode.result()``.  ``mode``: the ``CostMode`` class to count with
    (``mode_kw`` its further arguments)."""

    def __init__(self, *, live=(), breakdown: bool = False, mode=CostMode,
                 **mode_kw):
        base = 0
        seen = set()
        for t in _tensors(live):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                base += t.untyped_storage().nbytes()
        self.mode = mode(live=base, breakdown=breakdown, **mode_kw)
        self.mode.live.seen |= seen

    def __enter__(self) -> CostMode:
        self.mode.__enter__()
        return self.mode

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        return False


def count(fn, *args, live=(), breakdown: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a count: returns ``(its result,
    the count)``, the count's ``flops``, ``bytes``, ``gemm_flops``,
    ``kernel_flops``, ``kernel_bytes``, ``peak_live_bytes``, ``census``
    (ATen op and ``kernel:<name>`` counts), ``kernels`` (calls, flops and
    bytes by kernel) and, with ``breakdown``, ``breakdown`` (flops and
    bytes by layer).  ``live``: tensors alive across the step (parameters,
    optimizer state, cache, inputs), the peak's base."""
    with counting(live=live, breakdown=breakdown) as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()


__all__ = ["CostMode", "KERNELS", "KERNEL_WORK", "count", "counting",
           "composite", "kernel_work"]
