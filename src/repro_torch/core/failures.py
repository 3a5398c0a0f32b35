"""Failure management — paper §4.4 / §5.4 (Table 2)
(port of ``repro.core.failures``).

AHU failure: one aisle loses 1/N of its AHUs -> reduced airflow (≈90%
capacity); UPS failure under 4N/3 redundancy -> every row limited to 75%
power.  The drill compares Baseline (uniform frequency capping) against
TAPAS (recompute limits -> steer -> reconfigure -> cap IaaS last) over a
peak-load window, reporting perf impact (% frequency capped x fraction of
workloads affected) and quality impact per workload class.

Drills are scripted as ``Scenario`` events — kind typos and inverted
windows fail at construction, and callers can stack extra events (demand
surges, weather shifts) onto the drill through the same API.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.scenario import FailureEvent, Scenario
from repro_torch.core.simulator import (BASELINE, TAPAS, ClusterSim, Policy,
                                  SimConfig)


@dataclass
class DrillReport:
    kind: str
    policy: str
    iaas_perf: float      # negative = slowdown (frequency capped)
    saas_perf: float      # relative goodput vs demand served
    saas_quality: float   # quality delta vs 1.0

    def row(self) -> dict:
        return {
            "failure": self.kind, "policy": self.policy,
            "iaas_perf_pct": round(100 * self.iaas_perf, 1),
            "saas_perf_pct": round(100 * self.saas_perf, 1),
            "quality_pct": round(100 * self.saas_quality, 1),
        }


def run_drill(kind: str, policy: Policy, *, dc=None, seed: int = 0,
              horizon_h: float = 18.0,
              extra: Scenario | None = None, device="cuda") -> DrillReport:
    """Failure strikes at the peak-load hour and lasts 1.5h (the paper
    evaluates a 5-minute peak window; a longer window smooths tick noise).

    ``extra``: additional scenario events stacked onto both the clean and
    failure runs (e.g. a DemandSurge to drill under surge load)."""
    from repro_torch.core.datacenter import DCConfig
    dc = dc or DCConfig(n_rows=8, racks_per_row=10, servers_per_rack=4)
    # strike at the diurnal demand peak (~14:00-16:00) with the fleet hot
    start = min(14.0, horizon_h - 2.5)
    drill = Scenario((FailureEvent(kind=kind, start_h=start,
                                   end_h=start + 1.5, target=0),))
    clean_scenario = extra if extra is not None else Scenario()
    kw = dict(dc=dc, horizon_h=horizon_h, seed=seed, policy=policy,
              occupancy=0.95, demand_scale=0.98)
    clean = ClusterSim(SimConfig(scenario=clean_scenario, **kw),
                       device=device).run()
    failed = ClusterSim(SimConfig(scenario=clean_scenario + drill, **kw),
                        device=device).run()

    iaas_perf = -(failed.iaas_perf_impact - clean.iaas_perf_impact)
    served_clean = 1.0 - clean.unserved_frac
    served_fail = 1.0 - failed.unserved_frac
    saas_perf = served_fail / max(served_clean, 1e-9) - 1.0
    quality = failed.mean_quality - clean.mean_quality
    return DrillReport(kind=kind, policy=policy.name,
                       iaas_perf=iaas_perf, saas_perf=saas_perf,
                       saas_quality=quality)


def table2(*, seed: int = 0, dc=None, device="cuda") -> list:
    """Both emergencies x both policies (paper Table 2)."""
    rows = []
    for kind in ("ups", "thermal"):
        for pol in (BASELINE, TAPAS):
            rows.append(run_drill(kind, pol, seed=seed, dc=dc,
                                  device=device).row())
    return rows
