"""Oversubscription planning (paper §4.4/§5.3; port of
``examples/oversubscription_planner.py`` and, with ``--fleet``,
``examples/fleet_oversub_planner.py``).

Without ``--fleet``: use the TAPAS simulator with an estimated workload to
size how many extra racks fit the existing cooling/power envelopes — a
sweep of Baseline and TAPAS over oversubscription ratios 0, 20 and 40%,
and the largest contiguous safe ratio of each.

With ``--fleet``, the two fleet-level TCO demonstrations:

1. **Coordinated provisioning beats isolated provisioning.**  Two regions
   — a hot-climate ``ridge`` that suffers a UPS failover (rows derated to
   75% power) in the middle of a heat wave and a regional demand surge,
   and a cold ``lake`` — are sized by ``FleetOversubPlanner`` twice: each
   region alone, and jointly under the global router.
2. **Cost-aware steering cuts the energy bill at unchanged goodput.**  A
   dirty/expensive ``coal`` region and a clean/cheap ``hydro`` region run
   the same workload under the thermal-only ``GlobalTapasRouter`` and with
   ``cost_aware_knobs()``, while a scripted ``PriceShock`` spikes coal's
   spot price mid-run.

Every simulation's physics runs on ``--device`` (default ``cuda``).

    PYTHONPATH=src python -m repro_torch.launch.oversub --device cpu
    PYTHONPATH=src python -m repro_torch.launch.oversub --fleet --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.core.datacenter import DCConfig
from repro_torch.core.fleet import (FleetConfig, FleetKnobs, FleetSim,
                                    GlobalTapasRouter, RegionSpec,
                                    cost_aware_knobs)
from repro_torch.core.oversubscribe import (FleetOversubPlanner,
                                            max_safe_oversubscription, sweep)
from repro_torch.core.scenario import (DemandSurge, FailureEvent, PriceShock,
                                       Scenario, WeatherShift)
from repro_torch.core.simulator import BASELINE, TAPAS

HORIZON_H = 12.0
#: carbon weight of the blended cost index the steering minimizes — 0.5
#: prices money and carbon equally.
CARBON_WEIGHT = 0.5
#: ratio grid the fleet planner searches (rack-aligned for racks_per_row=8).
RATIOS = (0.0, 0.125, 0.25, 0.375, 0.5)


# ---------------------------------------------------------------------------
# one datacenter
# ---------------------------------------------------------------------------

def run_sweep(*, horizon_h: float = HORIZON_H, device="cuda") -> dict:
    dc = DCConfig(n_rows=4, racks_per_row=5, servers_per_rack=4)
    rows = sweep([BASELINE, TAPAS], ratios=(0.0, 0.2, 0.4), dc=dc,
                 horizon_h=horizon_h, seed=1, device=device)
    print(f"{'oversub':>8}{'policy':<22}{'thermal%':>10}{'power%':>8}"
          f"{'unserved%':>10}")
    for r in rows:
        print(f"{r['oversub']:>8.0%}{r['policy']:<22}"
              f"{r['thermal_capped_pct']:>10.3f}{r['power_capped_pct']:>8.3f}"
              f"{r['unserved_pct']:>10.2f}")
    safe = {}
    for pol in ("baseline", TAPAS.name):
        safe[pol] = max_safe_oversubscription(rows, pol)
        print(f"max safe oversubscription ({pol}): {safe[pol]:.0%}")
    return {"rows": rows, "safe": safe}


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def make_planner_fleet(seed: int = 0, *,
                       horizon_h: float = HORIZON_H) -> FleetConfig:
    """The provisioning drill: ridge loses UPS redundancy mid-heat-wave
    (the reference's ``benchmarks/bench_fleet_oversub.py`` workload)."""
    def dc(climate):
        return DCConfig(n_rows=2, racks_per_row=8, servers_per_rack=2,
                        region=climate)

    regions = (
        RegionSpec("ridge", dc=dc("hot"), wan_rtt_ms=8.0, power_price_scale=1.2),
        RegionSpec("lake", dc=dc("cold"), wan_rtt_ms=14.0, power_price_scale=0.7),
    )
    scenario = Scenario((
        # hours 7-11: ridge's UPS failover caps every row at 75% power,
        # in a heat wave, while regional demand surges
        FailureEvent(kind="ups", start_h=7.0, end_h=11.0, region="ridge"),
        WeatherShift(start_h=6.0, end_h=11.5, delta_c=8.0, region="ridge"),
        DemandSurge(start_h=7.0, end_h=10.0, scale=1.3, region="ridge"),
    ))
    # the steering threshold is tuned for the oversubscribed regime: the
    # near-limit power ramp keeps every densified region's risk elevated,
    # so the default 0.45 would veto every destination
    return FleetConfig(
        regions=regions, horizon_h=horizon_h, tick_min=15.0, seed=seed,
        policy=TAPAS, scenario=scenario, occupancy=0.92, demand_scale=0.95,
        fleet=lambda: GlobalTapasRouter(FleetKnobs(risk_threshold=0.7)))


def make_cost_fleet(fleet_policy, seed: int = 0, *,
                    horizon_h: float = HORIZON_H, device="cuda") -> FleetSim:
    """The steering drill: dirty/expensive coal vs clean/cheap hydro, with
    a spot-price spike on coal mid-run."""
    def dc(climate):
        return DCConfig(n_rows=2, racks_per_row=4, servers_per_rack=2,
                        region=climate)

    regions = (
        RegionSpec("coal", dc=dc("mild"), wan_rtt_ms=8.0, power_price_scale=1.3,
                   carbon_scale=1.5),
        RegionSpec("hydro", dc=dc("cold"), wan_rtt_ms=14.0, power_price_scale=0.6,
                   carbon_scale=0.4),
    )
    scenario = Scenario((
        PriceShock(start_h=6.0, end_h=10.0, scale=1.6, region="coal"),
    ))
    return FleetSim(FleetConfig(
        regions=regions, horizon_h=horizon_h, tick_min=15.0, seed=seed,
        policy=TAPAS, scenario=scenario, occupancy=0.8, demand_scale=0.6,
        fleet=fleet_policy), device=device)


def run_planner(seed: int = 0, *, horizon_h: float = HORIZON_H,
                device="cuda") -> dict:
    planner = FleetOversubPlanner(make_planner_fleet(seed,
                                                     horizon_h=horizon_h),
                                  ratios=RATIOS, device=device)
    plan = planner.plan()
    s = plan.summary()
    print(f"{'region':<8}{'isolated':>10}{'coordinated':>13}")
    for name in sorted(plan.isolated):
        print(f"{name:<8}{plan.isolated[name]:>10.1%}"
              f"{plan.coordinated[name]:>13.1%}")
    print(f"{'total':<8}{s['isolated_total']:>10.1%}"
          f"{s['coordinated_total']:>13.1%}   "
          f"({s['evaluations']} simulation runs)\n")
    return s


def run_cost_pair(seed: int = 0, *, horizon_h: float = HORIZON_H,
                  device="cuda") -> tuple:
    out = {}
    for label, policy in (
            ("thermal-only", GlobalTapasRouter),
            ("cost-aware", lambda: GlobalTapasRouter(
                cost_aware_knobs(cost_shift_max=0.6)))):
        res = make_cost_fleet(policy, seed=seed, horizon_h=horizon_h,
                              device=device).run()
        s = res.summary()
        out[label] = s | {"blended_cost": res.blended_cost(CARBON_WEIGHT)}
        print(f"{label:<13} blended={out[label]['blended_cost']:8.1f} "
              f"energy_cost={s['energy_cost']:8.1f} "
              f"carbon={s['carbon_kg']:8.1f} moved={s['moved_load']:6.1f} "
              f"unserved={s['unserved_frac']:.5f}")
    return out["thermal-only"], out["cost-aware"]


def run_fleet(*, device="cuda") -> dict:
    print("== fleet oversubscription planning "
          "(regional UPS failure drill) ==")
    plan = run_planner(device=device)
    assert plan["coordinated_safe"]
    assert plan["coordinated_total"] > plan["isolated_total"], (
        f"fleet coordination admitted no extra oversubscription: "
        f"{plan['coordinated_total']} !> {plan['isolated_total']}")
    print(f"fleet-coordinated planning admits "
          f"{plan['coordinated_total'] - plan['isolated_total']:+.1%} "
          f"oversubscription over per-region planning — the global router "
          f"absorbs the scripted UPS failure cross-region\n")

    print("== carbon/price-aware steering (coal vs hydro, price shock) ==")
    base, cost = run_cost_pair(device=device)
    saving = 1.0 - cost["blended_cost"] / base["blended_cost"]
    goodput = (1.0 - cost["unserved_frac"]) / (1.0 - base["unserved_frac"])
    assert cost["moved_load"] > 0.0, "cost-aware steering never engaged"
    assert cost["blended_cost"] < base["blended_cost"], (
        f"cost-aware steering did not cut the blended energy cost: "
        f"{cost['blended_cost']:.1f} !< {base['blended_cost']:.1f}")
    assert goodput >= 0.99, f"goodput dropped more than 1%: {goodput:.4f}"
    print(f"cost-aware steering cut the blended energy cost by "
          f"{saving:.1%} (goodput ratio {goodput:.4f}) by moving "
          f"{cost['moved_load']:.0f} VM-ticks of load onto the "
          f"cheap/clean grid")
    return {"plan": plan, "thermal-only": base, "cost-aware": cost}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", action="store_true",
                    help="the fleet planner and cost-aware steering")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the simulations' physics")
    args = ap.parse_args(argv)
    return (run_fleet if args.fleet else run_sweep)(device=args.device)


if __name__ == "__main__":
    main()
