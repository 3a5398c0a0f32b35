"""``python -m repro_torch.analysis.iraudit``: audit every registered
entry at smoke geometry and print one line per entry and one per
finding; exit 1 on any finding.  ``--explain CODE`` prints an invariant's
text.  The bodies run on the card; ``--device meta`` audits on a machine
without one (no numerics; every check on), ``--device cpu`` runs the
bodies on the host, where IR001's host-copy checks are off."""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.iraudit import (ENTRYPOINTS, INVARIANTS,
                                          AuditContext, audit_entry,
                                          cost_metrics, run_invariants)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.iraudit")
    ap.add_argument("--explain", metavar="CODE", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), meta (no card needed) or cpu")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.explain:
        code = args.explain.upper()
        if code not in INVARIANTS:
            print(f"unknown code {args.explain!r}; known: "
                  f"{', '.join(sorted(INVARIANTS))}", file=sys.stderr)
            return 2
        name, text = INVARIANTS[code]
        print(f"{code} ({name})\n\n{text}")
        return 0
    ctx = AuditContext(device=args.device)
    findings = []
    for entry in ENTRYPOINTS:
        audit = audit_entry(entry, ctx)
        found = run_invariants(audit, ctx.model.plan.compute_dtype)
        row = cost_metrics(audit)
        findings += found
        print(f"{entry.name}: {'clean' if not found else 'FINDINGS'}; "
              f"{row['n_ops']} ops, {row['flops']:.0f} flop, "
              f"{row['bytes']:.0f} B, peak live {row['peak_live_bytes']} B")
    for f in findings:
        print(f)
    print(f"{len(ENTRYPOINTS)} entries on {ctx.device}, "
          f"{len(findings)} findings")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
