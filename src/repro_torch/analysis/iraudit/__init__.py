"""iraudit — a static audit of the port's serving hot paths (the torch
counterpart of ``repro.analysis.iraudit``).

Where the reference traces each jitted entrypoint to a jaxpr and compiled
HLO, the port runs each registered body once at smoke geometry, on the
meta device (no storage, no numerics), the CPU or a card, under a
``TorchDispatchMode`` and a ``TorchFunctionMode`` (``census``), and runs
two passes over what they saw:

* the **invariants** (``invariants``): host syncs and host copies on a
  step path, in-place writes of the pool and state buffers, dtype
  discipline of the matmuls, per-call constants under a byte cap;
* the **cost pass** (``cost``): flops and bytes through
  ``analysis/op_cost.py`` (each kernel by its formula), the op census,
  the peak of live bytes, emitted as per-entry budget rows that
  ``budget`` compares with the reference's tolerances.

A host sync or host copy is what a CUDA-graph capture of the step refuses
(``serving/graphs.py``); the audit finds it without a card on the meta
device (on the CPU, where every tensor is a host tensor, its host-copy
checks are off).

    PYTHONPATH=src python -m repro_torch.analysis.iraudit            # the card
    PYTHONPATH=src python -m repro_torch.analysis.iraudit --device meta
    PYTHONPATH=src python -m repro_torch.analysis.iraudit --explain IR001
"""
from repro_torch.analysis.iraudit.budget import (budget_row, census_diff,
                                                 check_budgets)
from repro_torch.analysis.iraudit.cost import cost_metrics
from repro_torch.analysis.iraudit.invariants import (INVARIANTS, IRFinding,
                                                     run_invariants)
from repro_torch.analysis.iraudit.registry import (ENTRYPOINTS,
                                                   ENTRYPOINTS_BY_NAME,
                                                   AuditContext, EntryAudit,
                                                   Entrypoint, audit_built,
                                                   audit_entry)

__all__ = ["AuditContext", "ENTRYPOINTS", "ENTRYPOINTS_BY_NAME",
           "EntryAudit", "Entrypoint", "INVARIANTS", "IRFinding",
           "audit_built", "audit_entry", "budget_row",
           "census_diff", "check_budgets", "cost_metrics", "run_invariants"]
