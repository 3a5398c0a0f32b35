"""Budget rows and the drift gate for the audit's cost pass (the
counterpart of ``repro.analysis.iraudit.budget``).

``check_budgets`` mirrors the reference's: named metric, expected vs got,
tolerance in the message, and an added/removed/changed op diff for the
census.  Tolerances are the reference's: the execution costs get a small
relative band, the structural metrics are exact.  The numbers are only
stable under one torch version, so a version skew is itself a failure.
Every function here is pure: no budget file is pinned yet (the port's
first benchmark pins one).
"""
from __future__ import annotations

# metric -> relative tolerance; everything else in a row is exact
REL_TOL = {"flops": 0.02, "bytes": 0.02, "peak_live_bytes": 0.05}
EXACT = ("arg_bytes", "out_bytes", "n_ops", "f32_out_bytes", "const_count",
         "const_bytes", "inplace_leaves", "kept_leaves")


def budget_row(metrics: dict) -> dict:
    """The subset of a cost row that gets pinned (all of it, today)."""
    return dict(metrics)


def census_diff(pinned: dict, got: dict) -> str:
    """Human-readable op diff: 'added scatter(+2); removed
    _local_scalar_dense(-1); changed mm 12->14'."""
    added = [f"{k}(+{v})" for k, v in sorted(got.items()) if k not in pinned]
    removed = [f"{k}(-{v})" for k, v in sorted(pinned.items())
               if k not in got]
    changed = [f"{k} {pinned[k]}->{got[k]}" for k in sorted(pinned)
               if k in got and pinned[k] != got[k]]
    parts = []
    if added:
        parts.append("added " + ", ".join(added))
    if removed:
        parts.append("removed " + ", ".join(removed))
    if changed:
        parts.append("changed " + ", ".join(changed))
    return "; ".join(parts) or "identical"


def check_budgets(current: dict, pinned_payload: dict,
                  torch_version: str) -> list:
    """Compare current rows against a pinned payload (``{"meta":
    {"torch": version}, "entries": {entry: row}}``); returns problem
    strings (empty = within budget).  ``current``: {entry: metrics}."""
    problems = []
    ver = pinned_payload.get("meta", {}).get("torch")
    if ver != torch_version:
        problems.append(
            f"toolchain skew: budgets recorded under torch {ver}, running "
            f"{torch_version} — numbers are only comparable under the pin; "
            f"re-record under that toolchain")
        return problems
    pinned = pinned_payload.get("entries", {})
    for name in sorted(set(pinned) | set(current)):
        if name not in current:
            problems.append(f"{name}: pinned but not registered (stale "
                            f"budget row — re-record)")
            continue
        if name not in pinned:
            problems.append(f"{name}: registered but has no budget row — "
                            f"record it")
            continue
        got, want = current[name], pinned[name]
        for key, tol in REL_TOL.items():
            g, w = float(got[key]), float(want[key])
            if abs(g - w) > tol * max(abs(w), 1.0):
                problems.append(
                    f"{name}: {key} {g:.6g} vs budget {w:.6g} "
                    f"(|Δ| > {tol:.0%})")
        for key in EXACT:
            if int(got[key]) != int(want[key]):
                problems.append(
                    f"{name}: {key} {got[key]} vs budget {want[key]} "
                    f"(exact)")
        if got["census"] != want["census"]:
            problems.append(
                f"{name}: op census drift — "
                f"{census_diff(want['census'], got['census'])}")
    return problems


__all__ = ["EXACT", "REL_TOL", "budget_row", "census_diff", "check_budgets"]
