"""The audit's tracer: one run of an entry's body under two modes (the
counterpart of ``repro.analysis.iraudit.jaxprs``).

The reference walks a traced jaxpr.  The port has no graph to walk before
capture, so ``trace`` runs the body once, on the audit's device, under

* ``op_cost``'s ``CostMode`` (a ``TorchDispatchMode``): flops, bytes,
  the ATen op census and the peak of live bytes, every kernel call one
  op of the ``repro_torch`` namespace counted by its formula, nothing
  inside its implementation seen;
* a ``TorchFunctionMode``: the Python-level calls that reach the host
  before any ATen op does (``torch.tensor`` from Python values,
  ``Tensor.item`` / ``tolist`` / ``bool`` / ``int``, ``Tensor.cpu``),

and records what the invariants read: host syncs and host copies, the
matmuls' input dtypes, the outputs of every op (for the in-place check),
the constants made from Python values, and the f32 surface.  On the meta
device no numerics run; a host sync there has no value to return, so
the trace records it and stops (``Trace.stopped``).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.op_cost import (KERNELS, CostMode, _tensors,
                                          composite, counting)

# Python-level calls that read a device value back to the host
HOST_READS = {"item": "Tensor.item()", "tolist": "Tensor.tolist()",
              "__bool__": "bool(tensor)", "__int__": "int(tensor)",
              "__float__": "float(tensor)", "__index__": "a tensor as an "
              "index", "cpu": "Tensor.cpu()", "numpy": "Tensor.numpy()"}
# tensors built on the host from Python values
HOST_BUILT = {"tensor": "torch.tensor(...) from Python values",
              "as_tensor": "torch.as_tensor(...) from Python values",
              "from_numpy": "torch.from_numpy(...)"}
# ATen ops that sync with the host (data-dependent output shapes, scalar
# reads) or copy host data in
SYNC_OPS = {"_local_scalar_dense": "a scalar read back to the host",
            "nonzero": "nonzero (its output shape waits for the device)",
            "masked_select": "masked_select (its output shape waits for the "
                             "device)",
            "lift_fresh": "a tensor made from host data"}
MATMULS = {"mm", "bmm", "addmm", "baddbmm"}
# factories whose values come from Python scalars: a body's per-call
# constants (the counterpart of a jaxpr's closure constants)
CONSTS = {"lift_fresh", "arange", "full", "scalar_tensor"}
WIDE = (torch.float32, torch.float64)


class _Stop(Exception):
    """A host sync on the meta device: no value to go on with."""


@dataclass
class Trace:
    """What one run of a body showed."""
    device: str
    host: list = field(default_factory=list)     # (kind, what) pairs
    wide_matmuls: list = field(default_factory=list)
    outputs: list = field(default_factory=list)  # (op, shape, dtype, key)
    consts: list = field(default_factory=list)   # (op, dtype, shape, bytes)
    f32_out_bytes: int = 0
    cost: dict = field(default_factory=dict)
    stopped: str = ""

    @property
    def census(self) -> dict:
        return self.cost.get("census", {})


class _AuditMode(CostMode):
    """``CostMode`` that also records what the invariants read."""

    def __init__(self, *, tr: Trace, **kw):
        super().__init__(**kw)
        self.tr = tr
        self.device_type = torch.device(tr.device).type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == KERNELS:     # one unit, none of it recorded
            return self.kernel(func, args, kwargs)
        if composite(func):
            with self:                    # its parts come through the mode
                return func.decompose(*args, **kwargs)
        name = func._overloadpacket.__name__
        ins = list(_tensors((args, kwargs)))
        if name in SYNC_OPS:
            self.tr.host.append(("sync" if name != "lift_fresh" else "built",
                                 SYNC_OPS[name]))
            if name == "_local_scalar_dense" and ins and ins[0].is_meta:
                raise _Stop(SYNC_OPS[name])
        if self.device_type != "cpu":
            if any(t.device.type == "cpu" and t.dim() > 0 for t in ins) or (
                    any(t.device.type == "cpu" for t in ins)
                    and name in ("_to_copy", "copy_", "copy")):
                self.tr.host.append(("copy in", f"{name} reads a host "
                                     f"tensor"))
        if name in MATMULS and any(t.dtype in WIDE for t in ins):
            self.tr.wide_matmuls.append(" x ".join(
                f"{t.dtype}{list(t.shape)}" for t in ins))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in _tensors(out):
            if self.device_type != "cpu" and t.device.type == "cpu" \
                    and ins and any(i.device.type != "cpu" for i in ins):
                self.tr.host.append(("copy out", f"{name} writes a host "
                                     f"tensor"))
            if func.is_view:
                continue
            self.tr.outputs.append((name, tuple(t.shape), t.dtype,
                                    t.untyped_storage()._cdata))
            if t.dtype in WIDE:
                self.tr.f32_out_bytes += t.numel() * t.element_size()
            if name in CONSTS:
                self.tr.consts.append((name, str(t.dtype), tuple(t.shape),
                                       t.numel() * t.element_size()))
        return out


class _HostCalls(TorchFunctionMode):
    """Records Python-level host reads and host-built tensors."""

    def __init__(self, tr: Trace):
        super().__init__()
        self.tr = tr

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if func in (torch.tensor, torch.as_tensor, torch.from_numpy):
            self.tr.host.append(("built", HOST_BUILT[name]))
        elif name in HOST_READS and args \
                and isinstance(args[0], torch.Tensor):
            self.tr.host.append(("sync", HOST_READS[name]))
            if args[0].is_meta:
                raise _Stop(HOST_READS[name])
        return func(*args, **kwargs)


def trace(body, *, device, live=()) -> Trace:
    """Run ``body()`` once under the audit's modes on ``device``; returns
    its ``Trace`` (``cost`` as ``op_cost.count``'s)."""
    tr = Trace(str(device))
    with counting(live=live, mode=_AuditMode, tr=tr) as mode, \
            _HostCalls(tr):
        try:
            body()
        except _Stop as e:
            tr.stopped = str(e)
    tr.cost = mode.result()
    return tr


def op_census(tr: Trace) -> dict:
    """``{op: count}`` over the run, kernel calls as ``kernel:<name>``."""
    return dict(sorted(Counter(tr.census).items()))


def const_census(tr: Trace) -> tuple[int, int, list]:
    """The body's per-call constants: ``(count, bytes, rows)``, one
    ``(op, dtype, shape, bytes)`` row each, largest first."""
    rows = sorted(tr.consts, key=lambda r: (-r[3], r[0], r[1], r[2]))
    return len(rows), sum(r[3] for r in rows), rows


__all__ = ["Trace", "const_census", "op_census", "trace"]
