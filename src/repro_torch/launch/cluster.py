"""Engine-in-the-loop: real serving engines as SaaS servers inside the
TAPAS cluster simulation (port of ``examples/engine_in_the_loop.py``).

The step-wise ``ClusterSim`` is driven tick by tick from the outside.  A
few ticks in, two of the placed SaaS servers get a real ``Engine`` bound
to them through ``EngineBackend``; from then on every TAPAS
``reconfigure()`` decision for those servers lands on the engine's knobs
(``freq_scale`` / ``max_batch`` / ``set_variant``) and the engines'
measured goodput is reported back into ``ClusterState.measured_goodput``:
the paper's Fig. 17 control loop with a live model in place of vLLM.

A scripted ``Scenario`` (thermal emergency + demand surge over hours 2–6)
pushes the backed servers' violation risk over the reconfigure threshold
mid-run, so the knob turns show in the printed trace.  The simulator's
physics and the engines run on ``--device`` (default ``cuda``).

    PYTHONPATH=src python -m repro_torch.launch.cluster --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.datacenter import DCConfig
from repro_torch.core.scenario import DemandSurge, FailureEvent, Scenario
from repro_torch.core.simulator import TAPAS, ClusterSim, SimConfig
from repro_torch.serving import Engine, EngineBackend, EngineSpec

N_BACKENDS = 2


def build_engine(seed: int, device) -> Engine:
    cfg = get_config("llama2-7b").smoke_config()
    small = cfg.replace(num_layers=1, d_ff=64, name="llama2-smaller")
    return EngineSpec(cfg, max_seq=96, n_slots=4, max_batch=4, seed=seed,
                      variants=(("small", small),)).build(device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for the physics and the engines")
    args = ap.parse_args(argv)

    dc = DCConfig(n_rows=2, racks_per_row=2, servers_per_rack=4,
                  region="hot")
    scenario = Scenario((
        FailureEvent(kind="thermal", start_h=2.0, end_h=6.0, target=0),
        DemandSurge(start_h=2.0, end_h=6.0, scale=1.4),
    ))
    sim = ClusterSim(SimConfig(dc=dc, horizon_h=8.0, tick_min=10.0, seed=1,
                               policy=TAPAS, occupancy=0.95,
                               demand_scale=1.0, scenario=scenario),
                     device=args.device)

    # --- drive the sim until SaaS servers exist, then bind real engines ---
    backends: dict[int, EngineBackend] = {}
    while len(backends) < N_BACKENDS and sim.tick < sim.ticks:
        state = sim.step()
        saas = np.flatnonzero(state.kind == 2)
        if len(saas) >= N_BACKENDS and not backends:
            for i, srv in enumerate(saas[:N_BACKENDS]):
                b = EngineBackend(build_engine(i, args.device), seed=i,
                                  variant_for_size={"70b": "full",
                                                    "13b": "small",
                                                    "7b": "small"})
                sim.attach_backend(int(srv), b)
                backends[int(srv)] = b
    servers = sorted(backends)
    knobs0 = {s: (backends[s].engine.knobs.freq_scale,
                  backends[s].engine.knobs.max_batch,
                  backends[s].engine.knobs.variant) for s in servers}
    print(f"engines bound to servers {servers} (knobs: {knobs0})\n")
    hdr = " ".join(f"srv{s}: risk freq bat var   gp" for s in servers)
    print(f"{'h':>5} emerg  {hdr}")

    # --- continue the run with the engines in the loop --------------------
    while sim.tick < sim.ticks:
        state = sim.step()
        if sim.tick % 3:
            continue
        cells = []
        for s in servers:
            k = backends[s].engine.knobs
            cells.append(f"{state.risk[s]:10.2f} {k.freq_scale:.2f} "
                         f"{k.max_batch:>3} {k.variant[:4]:<4} "
                         f"{state.measured_goodput.get(s, 0.0):6.0f}")
        print(f"{state.now_h:5.1f} {str(state.emergency):<5} "
              + " ".join(cells))

    # --- verify the loop actually closed ----------------------------------
    applied = {s: backends[s].applied for s in servers}
    changed = {s: (backends[s].engine.knobs.freq_scale,
                   backends[s].engine.knobs.max_batch,
                   backends[s].engine.knobs.variant) != knobs0[s]
               or len(applied[s]) > 0 for s in servers}
    served = {s: len(backends[s].engine.stats.completed) for s in servers}
    summary = sim.result().summary()
    print(f"\nconfigs applied per server (first is the attach-time sync): "
          f"{ {s: len(a) for s, a in applied.items()} }")
    print(f"requests completed per engine: {served}")
    print(f"final summary: "
          f"{ {k: round(float(v), 4) for k, v in summary.items()} }")
    # beyond the initial attach-time sync, live reconfigure decisions must
    # have reached the engines and observably turned their knobs
    assert any(len(a) > 1 for a in applied.values()), \
        "no reconfigure decision reached an engine"
    assert all(changed.values()), "a bound engine saw no observable change"
    assert all(n > 0 for n in served.values()), "an engine served nothing"
    return {"servers": servers, "applied": applied, "served": served,
            "summary": summary}


if __name__ == "__main__":
    main()
