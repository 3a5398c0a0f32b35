"""``python -m repro_torch.analysis.lint``: tapaslint over the port.

    PYTHONPATH=src python -m repro_torch.analysis.lint [paths...]
        lint (default: src/repro_torch, chip_smoke.py and the port's
        scripts); exit 1 on any finding not grandfathered in the baseline
    python -m repro_torch.analysis.lint --explain TL003
        print a rule's motivation, detection and fix guidance
    python -m repro_torch.analysis.lint --update-baseline
        rewrite the baseline with the current findings
    python -m repro_torch.analysis.lint --no-baseline
        show every finding, grandfathered or not

The options are ``scripts/tapaslint.py``'s.  The baseline
(``baseline.txt`` beside this file) is a multiset of line-number-
independent finding keys, and it is empty: every finding is fixed or
suppressed inline with ``# tapaslint: disable=TLxxx`` and a reason, on
the flagged (or enclosing ``def``) line.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys

from repro_torch.analysis.lint import (ALL_RULES, RULES_BY_CODE,
                                       collect_files, diff_baseline,
                                       format_baseline, lint_sources,
                                       load_baseline)

ROOT = pathlib.Path(__file__).resolve().parents[4]
DEFAULT_PATHS = ["src/repro_torch", "chip_smoke.py",
                 "scripts/flash_turns.py", "scripts/bwd_probe.py",
                 "scripts/train_probe.py", "scripts/build_overlap.py",
                 "scripts/rwkv_zero_state.py"]
DEFAULT_BASELINE = pathlib.Path(__file__).resolve().parent / "baseline.txt"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific static analysis (TL001-TL008)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="grandfathered-findings file")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline; report everything")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings")
    ap.add_argument("--explain", metavar="TLxxx",
                    help="print a rule's motivation + fix guidance")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--github", action="store_true",
                    help="emit ::error workflow annotations for new "
                         "findings and a markdown summary to "
                         "$GITHUB_STEP_SUMMARY")
    ap.add_argument("--fail-on-baseline", action="store_true",
                    help="fail if the baseline grandfathers anything: the "
                         "debt was paid down to zero, and this keeps new "
                         "findings from being waved through by re-running "
                         "--update-baseline")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            first = r.EXPLAIN.strip().splitlines()[0]
            print(f"{r.code}  {r.name:22s} {first}")
        return 0
    if args.explain:
        rule = RULES_BY_CODE.get(args.explain.upper())
        if rule is None:
            print(f"unknown rule {args.explain!r}; known: "
                  f"{', '.join(sorted(RULES_BY_CODE))}", file=sys.stderr)
            return 2
        print(rule.EXPLAIN.rstrip())
        return 0

    files = collect_files(ROOT, args.paths or DEFAULT_PATHS)
    findings = lint_sources(files)

    if args.update_baseline:
        pathlib.Path(args.baseline).write_text(format_baseline(findings))
        print(f"baseline rewritten: {len(findings)} grandfathered "
              f"finding(s) -> {args.baseline}")
        return 0

    baseline = [] if args.no_baseline else load_baseline(args.baseline)
    if args.fail_on_baseline and baseline:
        print(f"baseline is not empty ({len(baseline)} grandfathered "
              f"entr{'y' if len(baseline) == 1 else 'ies'} in "
              f"{args.baseline}); the debt was burned to zero — fix the "
              f"findings instead of re-grandfathering them")
        if args.github:
            print(f"::error title=tapaslint baseline::{len(baseline)} "
                  f"grandfathered entries re-appeared in {args.baseline}")
        return 1
    new, matched, stale = diff_baseline(findings, baseline)

    for f in new:
        print(f.render())
        if args.github:
            print(f"::error file={f.path},line={f.line},"
                  f"title=tapaslint {f.rule}::{f.message}")
    if stale:
        print(f"\n{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (fixed findings — "
              "remove them, or run --update-baseline):")
        for k in stale:
            print(f"  {k}")
    summary = (f"tapaslint: {len(files)} files, {len(findings)} finding(s) "
               f"({len(new)} new, {len(matched)} grandfathered, "
               f"{len(stale)} stale baseline)")
    print(("\n" if new or stale else "") + summary)
    if args.github:
        step_summary = os.environ.get("GITHUB_STEP_SUMMARY")
        if step_summary:
            with open(step_summary, "a") as fh:
                fh.write(f"### tapaslint\n\n{summary}\n\n")
                if new:
                    fh.write("| file | rule | finding |\n|---|---|---|\n")
                    for f in new:
                        fh.write(f"| `{f.path}:{f.line}` | {f.rule} | "
                                 f"{f.message} |\n")
    if new:
        print(f"\nnew findings fail the run; explain a rule with "
              f"`python -m repro_torch.analysis.lint --explain {new[0].rule}`, "
              "suppress a deliberate one with "
              "`# tapaslint: disable=<rule>`.")
    return 1 if new else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:      # e.g. `--explain TLxxx | head`
        sys.exit(0)
