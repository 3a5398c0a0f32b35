"""Geo-distributed fleet: three regions, one global router, one regional
cooling failure (port of ``examples/geo_fleet.py``).

Three regions with divergent weather — a hot-climate ``gulf``, a mild
``plains``, a cold ``fjord`` — each run their own TAPAS control plane
(placement / routing / instance configuration) over their own cluster
physics.  At hour 3 the gulf region suffers a thermal emergency (an AHU
loss plus DC-level cooling strain) in the middle of a heat wave and a
fleet-wide demand surge.

The drill runs twice with the per-region control planes held fixed:

* ``latency``  — ``LatencyOnlyRouter``: the per-region-greedy baseline.
  Every region serves its own demand; the failing region fights alone.
* ``global``   — ``GlobalTapasRouter``: ``server_risk`` lifted to region
  granularity.  Demand is steered off the failing region toward cooler
  regions (paying the WAN-latency goodput penalty), and sustained
  emergency risk drains whole VMs cross-region.

Then the same drill on measured goodput: one ``EngineFleet`` of two
engines per region, all six sharing one weight copy, backs every SaaS
server that ever appears.  The printed trace shows routing shift during
the failure window; the run asserts the global router finishes the drill
with fewer throttle events than the per-region-greedy baseline.  The
regions' physics and the engines run on ``--device`` (default ``cuda``).

    PYTHONPATH=src python -m repro_torch.launch.fleet --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.datacenter import DCConfig
from repro_torch.core.fleet import (FleetConfig, FleetSim, GlobalTapasRouter,
                                    LatencyOnlyRouter, RegionSpec)
from repro_torch.core.scenario import (DemandSurge, FailureEvent, Scenario,
                                       WeatherShift)
from repro_torch.core.simulator import TAPAS
from repro_torch.serving import EngineFleet, EngineSpec

HORIZON_H = 12.0


def make_fleet(fleet_policy, seed: int = 0, *, servers_per_rack: int = 4,
               horizon_h: float = HORIZON_H, device="cuda") -> FleetSim:
    """The drill: 3 regions, gulf loses cooling mid-heat-wave (the
    reference's ``benchmarks/bench_fleet.py`` workload at the default
    size; the measured drill below runs it bigger)."""
    def dc(climate):
        return DCConfig(n_rows=4, racks_per_row=4,
                        servers_per_rack=servers_per_rack, region=climate)

    regions = (
        RegionSpec("gulf", dc=dc("hot"), wan_rtt_ms=10.0, power_price_scale=1.2),
        RegionSpec("plains", dc=dc("mild"), wan_rtt_ms=25.0),
        RegionSpec("fjord", dc=dc("cold"), wan_rtt_ms=45.0,
                   power_price_scale=0.7),
    )
    scenario = Scenario((
        # hour 3-10: gulf loses an AHU + DC cooling strain, mid-heat-wave
        FailureEvent(kind="thermal", start_h=3.0, end_h=10.0, target=0,
                     region="gulf"),
        FailureEvent(kind="cooling", start_h=3.0, end_h=10.0, region="gulf"),
        WeatherShift(start_h=2.0, end_h=11.0, delta_c=12.0, region="gulf"),
        DemandSurge(start_h=3.0, end_h=9.0, scale=1.3),
    ))
    return FleetSim(FleetConfig(
        regions=regions, horizon_h=horizon_h, tick_min=10.0, seed=seed,
        policy=TAPAS, fleet=fleet_policy, scenario=scenario,
        occupancy=0.97, demand_scale=1.05), device=device)


def run_drill(label: str, fleet_policy, *, verbose: bool,
              horizon_h: float = HORIZON_H, device="cuda") -> dict:
    fs = make_fleet(fleet_policy, horizon_h=horizon_h, device=device)
    if verbose:
        print(f"  {'h':>5} {'gulf':>22} {'plains':>16} {'fjord':>16} "
              f"{'moved':>8}")
    prev_moved = 0.0
    while fs.tick < fs.ticks:
        st = fs.step()
        if verbose and fs.tick % 6 == 0:
            moved = fs._moved - prev_moved     # since the last printed row
            prev_moved = fs._moved
            cells = []
            for name in ("gulf", "plains", "fjord"):
                cs = st.regions[name]
                load = float(cs.saas_load[cs.kind == 2].sum())
                flag = "!" if st.emergency[name] else " "
                cells.append(f"risk={st.risk[name]:.2f}{flag} "
                             f"load={load:5.1f}")
            print(f"  {st.now_h:5.1f} {cells[0]:>22} {cells[1]:>16} "
                  f"{cells[2]:>16} {moved:8.1f}")
    res = fs.result()
    s = res.summary()
    print(f"{label:8s} throttle={s['throttle_events']:3d} "
          f"(per region { {n: r['thermal_events'] for n, r in s['regions'].items()} }) "
          f"unserved={s['unserved_frac']:.4f} quality={s['mean_quality']:.3f} "
          f"moved={s['moved_load']:.1f} migrations={s['migrations']}\n")
    return s


def run_measured_drill(*, spec: EngineSpec | None = None,
                       horizon_h: float = HORIZON_H, device="cuda",
                       on_tick=None) -> dict:
    """The same 3-region drill on *measured* goodput: every SaaS server
    that ever appears gets a real serving backend.

    One ``EngineFleet`` per region (two engines each, built from ``spec``,
    by default smoke llama2-7b with 4 lanes) backs the region's whole SaaS tier through
    the batched pump — all six engines alias ONE copy of the model weights
    (``EngineSpec.build(share=...)``), and each tick every attached
    ``FleetBackend`` submits its server's routed demand before a single
    ``flush`` per fleet steps the engines for all of them together.
    Attachment is progressive (servers churn).  ``on_tick(fs, state)``,
    if given, runs after every tick (``chip_smoke.py`` reads the card's
    power there)."""
    spec = spec or EngineSpec(get_config("llama2-7b").smoke_config(),
                              max_seq=64, n_slots=4, block_size=8)
    fs = make_fleet(GlobalTapasRouter, servers_per_rack=6,
                    horizon_h=horizon_h, device=device)
    fleets: dict[str, EngineFleet] = {}
    share = None
    for name in sorted(fs.sims):
        fleets[name] = EngineFleet(
            spec, n_engines=2, steps_per_tick=4, share=share, device=device,
            backend_kw=dict(requests_per_load=1.0, prompt_len=4,
                            max_new_tokens=2))
        share = share or fleets[name].engines[0]
    attached: dict[tuple, object] = {}
    measured_ticks = 0
    while fs.tick < fs.ticks:
        st = fs.step()
        for name, cs in st.regions.items():
            for srv in np.flatnonzero(cs.kind == 2):
                key = (name, int(srv))
                if key not in attached:
                    bk = fleets[name].make_backend()
                    fs.attach_backend(name, int(srv), bk)
                    attached[key] = bk
        measured_ticks += sum(
            1 for name, cs in st.regions.items()
            if any(k[0] == name and cs.measured_goodput.get(k[1], 0.0) > 0
                   for k in attached))
        if on_tick is not None:
            on_tick(fs, st)
    for fl in fleets.values():
        fl.drain(now_h=horizon_h + 1.0)

    share_params = fleets[sorted(fleets)[0]].engines[0].variants["full"][1]
    engines = [e for fl in fleets.values() for e in fl.engines]
    served = sum(1 for bk in (b for fl in fleets.values()
                              for b in fl.backends)
                 if any(len(r.output) > 0 for r in bk.issued))
    tokens = sum(len(r.output) for fl in fleets.values()
                 for bk in fl.backends for r in bk.issued)
    out = {
        "attached": len(attached),
        "engines": len(engines),
        "one_weight_copy": all(e.variants["full"][1] is share_params
                               for e in engines),
        "served_servers": served,
        "decode_tokens": tokens,
        "flushes": {n: fl.flushes for n, fl in fleets.items()},
        "measured_region_ticks": measured_ticks,
        "summary": fs.result().summary(),
        "fleets": fleets,
    }
    print(f"measured  attached={out['attached']} servers on "
          f"{out['engines']} engines (one weight copy: "
          f"{out['one_weight_copy']})  served={served} servers, "
          f"{tokens} tokens  flushes={out['flushes']}")
    return out


def check_drills(base: dict, glob: dict) -> None:
    """The routing shift must be real and must pay off in throttling."""
    assert glob["moved_load"] > 0.0, \
        "the global router steered nothing during a regional emergency"
    assert base["moved_load"] == 0.0
    assert glob["throttle_events"] < base["throttle_events"], (
        f"global router did not reduce throttling: "
        f"{glob['throttle_events']} vs {base['throttle_events']}")


def check_measured(m: dict) -> None:
    assert m["attached"] >= 100, \
        f"only {m['attached']} servers ever ran on a real backend"
    assert m["one_weight_copy"], "engines did not share one params copy"
    assert m["decode_tokens"] > 0 and m["served_servers"] >= 50
    assert all(n > 0 for n in m["flushes"].values()), \
        "a region's fleet was never flushed by the batched pump"
    assert m["measured_region_ticks"] > 0, \
        "no region ever reported engine-measured goodput"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for the physics and the engines")
    device = ap.parse_args(argv).device

    print("== per-region-greedy baseline (LatencyOnlyRouter) ==")
    base = run_drill("latency", LatencyOnlyRouter, verbose=False,
                     device=device)
    print("== global risk-weighted router (GlobalTapasRouter) ==")
    glob = run_drill("global", GlobalTapasRouter, verbose=True,
                     device=device)
    check_drills(base, glob)
    print(f"regional cooling failure: global router cut throttle events "
          f"{base['throttle_events']} -> {glob['throttle_events']} by "
          f"steering {glob['moved_load']:.0f} VM-ticks of load "
          f"(+{glob['migrations']} VM migrations) across regions")

    print("\n== same drill on measured goodput (fleet of real engines) ==")
    m = run_measured_drill(device=device)
    check_measured(m)
    print(f"{m['attached']} simulated servers served by "
          f"{m['engines']} real engines through the batched pump")
    return {"latency": base, "global": glob,
            "measured": {k: v for k, v in m.items() if k != "fleets"}}


if __name__ == "__main__":
    main()
