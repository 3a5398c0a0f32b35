"""The audit's invariants over one traced entry (the counterpart of
``repro.analysis.iraudit.jaxpr_pass``).

Four invariants, each with an ``IRxxx`` code (``python -m
repro_torch.analysis.iraudit --explain IR002`` prints its text):

IR001  no host sync or host copy on a step path
IR002  the declared in-place buffers are written in place
IR003  dtype discipline: no f32/f64 matmul inputs in a bf16 plan
IR004  per-call constants under the entry's byte cap

IR005 (budget drift) is ``budget.check_budgets``'s.  As in the
reference there is no waiver: a finding is fixed, or the entry's
declaration (``f32_dot_ok``, ``const_cap_bytes``) changes in the
registry, in review, next to the reason.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.analysis.iraudit.census import const_census
from repro_torch.analysis.iraudit.registry import EntryAudit

INVARIANTS = {
    "IR001": ("host-sync", """\
The step reads a device value back to the host (``.item()``, ``bool()``,
``int()``, ``.tolist()``, ``nonzero``, ``masked_select``), copies a tensor
to or from the host, or builds a tensor from Python values
(``torch.tensor(...)``, ``torch.as_tensor``, ``torch.from_numpy``) inside
its body.  Each is a host round trip on every step: a captured step
(``serving/graphs.py``) refuses it at capture, and an eager one stalls
the queue.  Fix: compute the value on the device (``torch.full``,
``torch.where``), pass it in through the program's buffers, or hoist the
transfer out of the body.  No waivers: serving hot paths must be clean.
The host-copy checks see a host tensor entering a device op and a device
op writing a host tensor, so they run on a card or the meta device and
are off on the CPU, where every tensor is a host tensor; the host syncs
and the tensors built from Python values are flagged on every device."""),
    "IR002": ("not-in-place", """\
A buffer the step must write in place (a KV pool or recurrent-state leaf,
a program's static buffer) was replaced by a new tensor, or an op made a
result of a pool leaf's shape and dtype out of place.  That is the torch
form of an unconsumed donation: the copy doubles the pool's memory on
every step, and a captured graph keeps writing the old buffer.  Fix: write
through an in-place op (``index_put_``, ``copy_``, slice assignment) on
the leaf itself."""),
    "IR003": ("dtype-discipline", """\
A matmul in a bf16 plan takes f32/f64 inputs.  Accumulating in f32 is
deliberate and fine; *feeding* f32 operands doubles the bytes a matmul
moves and runs it off the tensor cores' bf16 rate, and usually means an
upcast leaked in (a lost ``.to(dtype)``, an f32 softmax output fed to the
PV product).  Entries whose bodies upcast by design opt out with
``f32_dot_ok`` in the registry, in review."""),
    "IR004": ("per-call-constants", """\
The step makes more bytes of constants from Python values on every call
(``torch.tensor`` data, ``torch.arange``, ``torch.full``) than its
registry cap.  Each is rebuilt (or re-sent from the host) on every call
where it could be built once and passed in.  Fix: make it once beside
the program's buffers.  If it is genuinely small and per-step (a rope
table, a position ramp), raise the entry's cap in the registry, in
review."""),
    "IR005": ("budget-drift", """\
A cost metric moved outside its tolerance against a pinned budget row (or
the op census changed shape): how an accidental broadcast, a dead
computation or a lost in-place write shows before any card time is
spent.  If the change is intended, re-record the budget and let review
see the cost delta next to the code that caused it."""),
}


@dataclass(frozen=True)
class IRFinding:
    entry: str       # entrypoint name
    code: str        # IRxxx
    message: str

    def __str__(self) -> str:
        return f"{self.code} {self.entry}: {self.message}"


def _check_host(audit: EntryAudit) -> list:
    seen, out = set(), []
    for kind, what in audit.trace.host:
        if (kind, what) not in seen:
            seen.add((kind, what))
            out.append(IRFinding(audit.entry.name, "IR001",
                                 f"host {kind}: {what}"))
    if audit.trace.stopped:
        out.append(IRFinding(audit.entry.name, "IR001",
                             f"the trace stopped at a host sync on the "
                             f"{audit.trace.device} device "
                             f"({audit.trace.stopped})"))
    return out


def _check_inplace(audit: EntryAudit) -> list:
    out = []
    for b, a in zip(audit.inplace_before, audit.inplace_after):
        if b != a:
            out.append(IRFinding(
                audit.entry.name, "IR002",
                f"in-place buffer {b[3]}{list(b[2])} was replaced by a new "
                f"tensor"))
    pools = {(shape, dtype): key for _, key, shape, dtype
             in audit.inplace_before if len(shape) >= 3}
    shapes = dict(pools)
    for shape, dtype in list(pools):
        shapes[(shape[1:], dtype)] = None          # one layer's slice
    keys = {key for _, key, _, _ in audit.inplace_before}
    for name, shape, dtype, key in audit.trace.outputs:
        if (shape, dtype) in shapes and key not in keys:
            out.append(IRFinding(
                audit.entry.name, "IR002",
                f"{name} made a pool-sized {dtype}{list(shape)} result out "
                f"of place"))
            break
    return out


def _check_dtypes(audit: EntryAudit, compute_dtype) -> list:
    if audit.entry.f32_dot_ok or compute_dtype in (torch.float32,
                                                   torch.float64):
        return []
    return [IRFinding(audit.entry.name, "IR003",
                      f"matmul with wide inputs ({shapes}) in a "
                      f"{compute_dtype} plan")
            for shapes in dict.fromkeys(audit.trace.wide_matmuls)]


def _check_consts(audit: EntryAudit) -> list:
    count, total, rows = const_census(audit.trace)
    if total <= audit.entry.const_cap_bytes:
        return []
    head = ", ".join(f"{op} {dt}{list(sh)}={b}B" for op, dt, sh, b
                     in rows[:4])
    return [IRFinding(
        audit.entry.name, "IR004",
        f"{count} per-call constants totalling {total}B exceed the "
        f"{audit.entry.const_cap_bytes}B cap ({head})")]


def run_invariants(audit: EntryAudit,
                   compute_dtype=torch.bfloat16) -> list:
    """All IR001-IR004 findings for one audited entry."""
    return (_check_host(audit) + _check_inplace(audit)
            + _check_dtypes(audit, compute_dtype) + _check_consts(audit))


__all__ = ["INVARIANTS", "IRFinding", "run_invariants"]
