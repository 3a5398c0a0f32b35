"""Oversubscription analysis — paper §5.3 (Fig. 21) and §4.4 (Fig. 19/20)
(port of ``repro.core.oversubscribe``).

Add racks into existing rows without growing the provisioned cooling/power
envelopes; measure the fraction of time under thermal/power capping per
policy.  The paper's claim: Baseline degrades past ~20% oversubscription
while TAPAS holds capping below 0.7% of time at up to 40% more servers.

Sweeps take an optional ``Scenario`` so planners can size oversubscription
under scripted stress (failure drills, demand surges, heat waves) through
the same event API the failure drills use.

``FleetOversubPlanner`` lifts the sizing question to the fleet (the §4.4
TCO argument): every region can provision tighter when the global router
can drain a scripted regional failure cross-region.  It sizes each region
twice — alone (the sweep above, one single-region fleet per region) and
fleet-coordinated (a coordinate-descent search over per-region ratios
through ``FleetSim``) — and reports both plans, so the admitted extra
capacity is directly attributable to the cross-region control plane.

Every simulation the sweep and the planner run keeps its physics on their
``device`` argument (default ``cuda``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.core.datacenter import DCConfig, scale_datacenter
from repro_torch.core.scenario import PriceShock, Scenario
from repro_torch.core.simulator import ClusterSim, SimConfig


@dataclass
class OversubPoint:
    ratio: float
    policy: str
    thermal_capped_frac: float
    power_capped_frac: float
    unserved_frac: float

    def row(self) -> dict:
        return {
            "oversub": self.ratio, "policy": self.policy,
            "thermal_capped_pct": round(100 * self.thermal_capped_frac, 3),
            "power_capped_pct": round(100 * self.power_capped_frac, 3),
            "unserved_pct": round(100 * self.unserved_frac, 2),
        }


def sweep(policies: list, ratios=(0.0, 0.1, 0.2, 0.3, 0.4, 0.5), *,
          dc: DCConfig | None = None, horizon_h: float = 24.0,
          seed: int = 0, scenario: Scenario | None = None,
          device="cuda") -> list:
    dc = dc or DCConfig(n_rows=8, racks_per_row=10, servers_per_rack=4)
    out = []
    for ratio in ratios:
        scaled = scale_datacenter(dc, ratio)
        for pol in policies:
            res = ClusterSim(SimConfig(dc=scaled, horizon_h=horizon_h,
                                       seed=seed, policy=pol,
                                       scenario=scenario),
                             device=device).run()
            out.append(OversubPoint(
                ratio=ratio, policy=pol.name,
                thermal_capped_frac=res.thermal_capped_frac,
                power_capped_frac=res.power_capped_frac,
                unserved_frac=res.unserved_frac).row())
    return out


def max_safe_oversubscription(rows: list, policy: str, *,
                              cap_budget: float = 0.007) -> float:
    """Largest *contiguous* safe ratio: walk the sweep points in ratio
    order and stop at the first one whose (thermal+power) capping exceeds
    the budget.  A failing middle point caps the answer — recommending a
    ratio beyond a known-bad operating point would hide a regression the
    operator must pass through while scaling up."""
    pts = sorted((r["oversub"],
                  (r["thermal_capped_pct"] + r["power_capped_pct"]) / 100.0)
                 for r in rows if r["policy"] == policy)
    best = 0.0
    for ratio, capped in pts:
        if capped > cap_budget:
            break
        best = max(best, ratio)
    return best


# ---------------------------------------------------------------------------
# fleet-level planning
# ---------------------------------------------------------------------------

@dataclass
class FleetOversubPlan:
    """The planner's answer: per-region safe oversubscription ratios,
    sized twice — each region alone vs fleet-coordinated.  The difference
    between the two totals is the extra capacity the global router's
    cross-region draining pays for."""

    isolated: dict              # name -> max safe ratio, region alone
    coordinated: dict           # name -> fleet-safe ratio under the router
    cap_budget: float
    rows: list                  # isolated sweep rows (policy == region name)
    trials: list = field(default_factory=list)  # coordinate-descent log
    evaluations: int = 0        # simulation runs the search spent
    coordinated_safe: bool = True   # False: even the all-minimum-ratio
    #                                 fleet blew the capping budget

    def isolated_total(self) -> float:
        return sum(self.isolated.values())

    def coordinated_total(self) -> float:
        return sum(self.coordinated.values())

    def summary(self) -> dict:
        return {
            "cap_budget": self.cap_budget,
            "isolated": dict(self.isolated),
            "coordinated": dict(self.coordinated),
            "isolated_total": self.isolated_total(),
            "coordinated_total": self.coordinated_total(),
            "gain": self.coordinated_total() - self.isolated_total(),
            "coordinated_safe": self.coordinated_safe,
            "evaluations": self.evaluations,
        }


class FleetOversubPlanner:
    """Size per-region oversubscription fleet-wide (§4.4, Fig. 19/20).

    Takes a ``FleetConfig`` describing the fleet at its provisioned sizing
    (ratio 0) — including the scripted stress ``Scenario`` (a regional
    cooling failure, a heat wave) the plan must survive — and answers two
    questions per region:

    * **isolated** — how far can this region oversubscribe alone?  One
      single-region fleet per (region, ratio) grid point under
      ``LatencyOnlyRouter`` (== the standalone ``ClusterSim``, pinned by
      the parity tests), swept exactly like ``sweep()`` and scored with
      ``max_safe_oversubscription`` over the same row format.
    * **coordinated** — how far can every region oversubscribe when the
      global router may drain a stressed region cross-region?  A
      coordinate-descent search over the per-region ratio grid through
      ``FleetSim``: start from the isolated plan, repair any region over
      the capping budget downward, then repeatedly try raising each
      region one grid step, keeping a step only when *every* region's
      (thermal + power) capped fraction stays within ``cap_budget``.

    Every evaluation is a fresh deterministic ``FleetSim`` run, so the
    plan is a pure function of (config, seed, grid) — pass ``cfg.fleet``
    as a policy class/factory (or ``None``), never a live instance whose
    steer memory would leak between evaluations.
    """

    def __init__(self, cfg, *, ratios=(0.0, 0.1, 0.2, 0.3, 0.4, 0.5),
                 cap_budget: float = 0.007, device="cuda"):
        from repro_torch.core.fleet import FleetConfig
        if not isinstance(cfg, FleetConfig):
            raise TypeError(f"FleetOversubPlanner needs a FleetConfig, "
                            f"got {cfg!r}")
        if not cfg.regions:
            raise ValueError("a fleet plan needs at least one region")
        self.ratios = tuple(sorted({float(r) for r in ratios}))
        if not self.ratios or self.ratios[0] < 0.0:
            raise ValueError(f"ratio grid must be non-empty and >= 0, "
                             f"got {ratios}")
        if not 0.0 < cap_budget < 1.0:
            raise ValueError(f"cap_budget must be in (0, 1), "
                             f"got {cap_budget}")
        self.cfg = cfg
        self.cap_budget = cap_budget
        self.device = device
        self.trials: list = []
        self.evaluations = 0
        self._cache: dict = {}

    # -- shared mechanics --------------------------------------------------
    def _scaled(self, spec, ratio: float):
        return replace(spec, dc=scale_datacenter(spec.dc, ratio))

    @staticmethod
    def _capped(result) -> dict:
        return {n: r.thermal_capped_frac + r.power_capped_frac
                for n, r in result.regions.items()}

    def _safe(self, capped: dict) -> bool:
        return all(c <= self.cap_budget for c in capped.values())

    # -- isolated sizing ---------------------------------------------------
    def _region_slice(self, name: str) -> Scenario:
        """The stress events one region faces alone: its tagged events
        plus the fleet-wide ones (price shocks dropped — $/kWh has no
        bearing on thermal/power safety)."""
        scen = self.cfg.scenario or Scenario()
        return Scenario(tuple(
            ev for ev in scen.events
            if not isinstance(ev, PriceShock)
            and getattr(ev, "region", None) in (None, name)))

    def plan_isolated(self) -> tuple:
        """Per-region max safe ratio with no fleet help: ``(ratios, rows)``
        where ``rows`` reuses the ``sweep()`` row format with the region
        name in the ``policy`` column.  The walk up the grid stops at the
        first unsafe ratio — ``max_safe_oversubscription`` is contiguous,
        so points beyond it cannot change the answer."""
        from repro_torch.core.fleet import FleetSim, LatencyOnlyRouter
        rows: list = []
        iso: dict = {}
        for spec in self.cfg.regions:
            scen = self._region_slice(spec.name)
            for ratio in self.ratios:
                # rtt_ms overrides name the absent sibling regions and
                # are meaningless alone — drop them with the regions
                cfg = replace(self.cfg,
                              regions=(self._scaled(spec, ratio),),
                              fleet=LatencyOnlyRouter, scenario=scen,
                              rtt_ms=None)
                res = FleetSim(cfg, device=self.device).run()
                self.evaluations += 1
                r = res.regions[spec.name]
                rows.append(OversubPoint(
                    ratio=ratio, policy=spec.name,
                    thermal_capped_frac=r.thermal_capped_frac,
                    power_capped_frac=r.power_capped_frac,
                    unserved_frac=r.unserved_frac).row())
                if (r.thermal_capped_frac + r.power_capped_frac
                        > self.cap_budget):
                    break
            iso[spec.name] = max_safe_oversubscription(
                rows, spec.name, cap_budget=self.cap_budget)
        return iso, rows

    # -- coordinated sizing ------------------------------------------------
    def evaluate(self, ratios: dict) -> dict:
        """One full-fleet run at a per-region ratio vector (cached)."""
        from repro_torch.core.fleet import FleetSim
        key = tuple(ratios[s.name] for s in self.cfg.regions)
        if key not in self._cache:
            cfg = replace(self.cfg, regions=tuple(
                self._scaled(s, ratios[s.name]) for s in self.cfg.regions))
            capped = self._capped(FleetSim(cfg, device=self.device).run())
            self.evaluations += 1
            entry = {"ratios": dict(ratios), "capped": capped,
                     "safe": self._safe(capped)}
            self._cache[key] = entry
            self.trials.append(entry)
        return self._cache[key]

    def plan(self) -> FleetOversubPlan:
        grid = list(self.ratios)
        iso, rows = self.plan_isolated()
        # snap the start point onto the grid: an isolated answer of 0.0
        # (the max_safe floor when even the first grid ratio is unsafe)
        # need not be a grid point
        cur = {n: max((r for r in grid if r <= iso[n]), default=grid[0])
               for n in iso}
        # repair: the isolated ratios need not be jointly safe (a helper
        # region absorbing a stressed neighbor's drained load may now cap)
        # — walk the worst over-budget region down until the fleet is safe
        while not self.evaluate(cur)["safe"]:
            capped = self.evaluate(cur)["capped"]
            over = [n for n in sorted(capped)
                    if capped[n] > self.cap_budget and grid.index(cur[n]) > 0]
            if not over:
                break
            worst = max(over, key=lambda n: (capped[n], n))
            cur[worst] = grid[grid.index(cur[worst]) - 1]
        # ascend: one grid step per region per pass while the fleet stays
        # safe; regions visited in name order so the search is deterministic
        improved = True
        while improved:
            improved = False
            for name in sorted(cur):
                i = grid.index(cur[name])
                if i + 1 >= len(grid):
                    continue
                trial = dict(cur)
                trial[name] = grid[i + 1]
                if self.evaluate(trial)["safe"]:
                    cur = trial
                    improved = True
        return FleetOversubPlan(
            isolated=iso, coordinated=cur, cap_budget=self.cap_budget,
            rows=rows, trials=list(self.trials),
            evaluations=self.evaluations,
            coordinated_safe=self.evaluate(cur)["safe"])
