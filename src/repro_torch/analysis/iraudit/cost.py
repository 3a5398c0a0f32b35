"""The audit's cost pass: one budget row per entry (the counterpart of
``repro.analysis.iraudit.hlo_pass``).

Two families of numbers, as in the reference:

* **execution costs** from ``analysis/op_cost.py``: flops and an
  HBM-traffic proxy in bytes, each kernel call by its formula in
  ``analysis/roofline.py``, and the peak of live bytes;
* **structural metrics**: the op census (ATen ops and ``kernel:<name>``
  calls), the per-call constants, the f32 surface, argument and output
  bytes, and the in-place buffers declared and kept.

The roofline view consumes the same flops/bytes pair, so a row doubles
as the entry's roofline point.
"""
from __future__ import annotations

from repro_torch.analysis.iraudit.census import const_census, op_census
from repro_torch.analysis.iraudit.registry import EntryAudit


def cost_metrics(audit: EntryAudit) -> dict:
    """One budget row: every gated metric for one entry."""
    tr = audit.trace
    census = op_census(tr)
    const_count, const_bytes, _ = const_census(tr)
    return {
        "flops": float(tr.cost["flops"]),
        "bytes": float(tr.cost["bytes"]),
        "peak_live_bytes": int(tr.cost["peak_live_bytes"]),
        "arg_bytes": int(audit.arg_bytes),
        "out_bytes": int(audit.out_bytes),
        "n_ops": int(sum(census.values())),
        "f32_out_bytes": int(tr.f32_out_bytes),
        "const_count": int(const_count),
        "const_bytes": int(const_bytes),
        "inplace_leaves": len(audit.inplace_before),
        "kept_leaves": sum(a == b for a, b in zip(audit.inplace_before,
                                                  audit.inplace_after)),
        "census": census,
    }


__all__ = ["cost_metrics"]
