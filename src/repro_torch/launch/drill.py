"""Failure drill (paper §5.4, Table 2): UPS and AHU emergencies, Baseline
vs TAPAS (port of ``examples/failure_drill.py``).

Each drill runs a clean and a failed ``ClusterSim`` over an 80-server
datacenter, the physics on ``--device`` (default ``cuda``), and prints
the table's row: IaaS and SaaS performance and SaaS quality, in percent.

    PYTHONPATH=src python -m repro_torch.launch.drill --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.core.datacenter import DCConfig
from repro_torch.core.failures import run_drill
from repro_torch.core.simulator import BASELINE, TAPAS


def run_drills(*, horizon_h: float = 18.0, device="cuda") -> list:
    """Print the drill table; return its rows (``DrillReport.row()``)."""
    dc = DCConfig(n_rows=4, racks_per_row=5, servers_per_rack=4)
    print(f"{'failure':<8}{'policy':<22}{'IaaS perf':>10}{'SaaS perf':>10}"
          f"{'quality':>9}")
    rows = []
    for kind in ("ups", "thermal"):
        for pol in (BASELINE, TAPAS):
            r = run_drill(kind, pol, dc=dc, seed=1, horizon_h=horizon_h,
                          device=device)
            row = r.row()
            rows.append(row)
            print(f"{kind:<8}{row['policy']:<22}"
                  f"{row['iaas_perf_pct']:>9.1f}%{row['saas_perf_pct']:>9.1f}%"
                  f"{row['quality_pct']:>8.1f}%")
    print("\nTAPAS absorbs the emergency by steering + reconfiguring SaaS "
          "(bounded quality cost) instead of uniform frequency caps.")
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for the simulator's physics")
    ap.add_argument("--horizon-h", type=float, default=18.0,
                    help="simulated hours of each drill")
    args = ap.parse_args(argv)
    return run_drills(horizon_h=args.horizon_h, device=args.device)


if __name__ == "__main__":
    main()
