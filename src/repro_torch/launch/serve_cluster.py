"""End-to-end TAPAS mini-cluster: REAL serving engines under the TAPAS
control plane (port of ``examples/serve_cluster.py``).

Four ``Engine`` instances (SaaS VMs on 4 'servers' of one row, one copy
of the weights between them) serve live requests through the thermal/
power-aware router; the instance configurator reacts to a simulated
afternoon heat spike by trimming the hot server's batch knob and, in an
emergency, swapping it to the smaller model variant — the paper's Fig. 17
loop with a real model in place of vLLM.

``--smoke`` serves llama2-7b's smoke widths; without it, llama2-7b at full
width and depth (random weights).  The engines and the thermal model run
on ``--device`` (default ``cuda``).

    PYTHONPATH=src python -m repro_torch.launch.serve_cluster --smoke --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.datacenter import Datacenter, DCConfig
from repro_torch.core.router import TapasRouter
from repro_torch.core.thermal import ThermalModel
from repro_torch.serving import EngineSpec, Request

N_VMS = 4


def build_engines(*, smoke: bool, device="cuda") -> list:
    """``N_VMS`` engines on one weight copy (``build(share=)``), each with
    the "small" variant the reference builds: one layer, ``d_ff`` 64."""
    cfg = get_config("llama2-7b")
    if smoke:
        cfg = cfg.smoke_config()
    small = cfg.replace(num_layers=1, d_ff=64, name="llama2-smaller")
    spec = EngineSpec(cfg, max_seq=96, n_slots=4, max_batch=4, block_size=16,
                      variants=(("small", small),))
    first = spec.build(device=device)
    return [first] + [spec.build(share=first) for _ in range(N_VMS - 1)]


def run(*, smoke: bool = False, device="cuda", engines=None) -> dict:
    """Eight ticks of the heat ramp over ``engines`` (default: fresh ones
    from ``build_engines``); prints the reference's table and closing line
    and returns the engines with the totals."""
    engines = engines or build_engines(smoke=smoke, device=device)
    vocab = engines[0].model.cfg.vocab_size

    # --- physics for their servers (first 4 servers of row 0) ---
    dc = Datacenter(DCConfig(n_rows=2, racks_per_row=1, servers_per_rack=4))
    th = ThermalModel.calibrate(dc, device=device)
    router = TapasRouter()
    rng = np.random.default_rng(0)

    print(f"{'tick':>4} {'t_out':>6} {'risk':>24} {'load':>24} served")
    for tick in range(8):
        t_out = 26.0 + 2.0 * tick  # afternoon heat ramp
        inlet = th.inlet_temp(t_out, 0.7).cpu().numpy()
        u_max = th.max_util_for_temp(
            inlet, th.gpu_limit - 3.0).cpu().numpy()[:N_VMS]
        risk = 1.0 / (1.0 + np.exp(-(th.gpu_temp(
            inlet, np.ones((dc.n_servers, 8))).cpu().numpy()[:N_VMS].max(1)
            - th.gpu_limit) / 2.0))

        # TAPAS instance configuration: hot VMs trim batch; hottest swaps model
        for v, e in enumerate(engines):
            if risk[v] > 0.8 and e.knobs.variant != "small":
                e.set_variant("small")      # emergency: smaller model
            elif risk[v] > 0.5:
                e.knobs.max_batch = 2       # shave thermal output
            else:
                e.knobs.max_batch = 4

        # route this tick's requests by risk-aware weights
        n_req = int(rng.integers(4, 9))
        cap = np.asarray([u_max[v] * engines[v].knobs.max_batch
                          for v in range(N_VMS)])
        dec = router.route(float(n_req), cap, risk)
        served = 0
        for v, e in enumerate(engines):
            for _ in range(int(round(dec.load[v]))):
                e.submit(Request(
                    prompt=list(rng.integers(0, vocab, 8)),
                    max_new_tokens=4, customer=f"c{rng.integers(0, 3)}"))
            before = len(e.stats.completed)
            for _ in range(6):
                e.step(now=float(tick))
            served += len(e.stats.completed) - before
        print(f"{tick:>4} {t_out:>6.1f} "
              f"{np.array2string(risk, precision=2):>24} "
              f"{np.array2string(dec.load, precision=1):>24} {served}")

    total = sum(len(e.stats.completed) for e in engines)
    variants = [e.knobs.variant for e in engines]
    util = [round(e.pool.utilization(), 2) for e in engines]
    print(f"\ncompleted {total} requests; final variants: {variants}; "
          f"paged-pool utilization: {util}")
    assert total > 0
    return {"engines": engines, "total": total, "variants": variants,
            "util": util}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="llama2-7b's smoke widths (default: full width)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the engines and the physics")
    args = ap.parse_args(argv)
    return run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
