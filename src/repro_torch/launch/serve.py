"""Serving CLI: continuous-batched generation through the port's Engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --smoke --requests 12 --device cpu

Same flags and printed dict as ``repro.launch.serve``, plus ``--device``
(default ``cuda``).  Weights are random from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, local_plan
from repro_torch.serving import Engine, EngineKnobs, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="TAPAS batch knob (default: --slots)")
    ap.add_argument("--freq-scale", type=float, default=1.0,
                    help="TAPAS frequency knob (1.0 = nominal clock)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV pool block size (tokens)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--paged", dest="paged", action="store_true",
                      default=None, help="force the paged-KV pool")
    mode.add_argument("--no-paged", dest="paged", action="store_false",
                      help="force the slot pool")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke_config()
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to decode")
    plan = local_plan(param_dtype=torch.bfloat16)
    model = build_model(cfg, plan, device=args.device)
    params = model.init(torch.Generator(device=args.device).manual_seed(0))
    knobs = EngineKnobs(max_batch=args.max_batch or args.slots,
                        freq_scale=args.freq_scale)
    eng = Engine(model, params, max_seq=args.max_seq, n_slots=args.slots,
                 knobs=knobs, paged=args.paged, block_size=args.block_size)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        eng.submit(Request(
            prompt=list(rng.integers(0, cfg.vocab_size, plen)),
            max_new_tokens=args.max_new, customer=f"cust{i % 3}",
            arrival_s=0.0))
    stats = eng.run()
    gp = eng.goodput(ttft_slo=50.0, tbt_slo=5.0)
    out = {
        "mode": "paged" if eng.paged else "slots",
        "completed": len(stats.completed),
        "decode_tokens": stats.decode_tokens,
        "prefill_tokens": stats.prefill_tokens,
        "prefill_batches": stats.prefill_batches,
        "preemptions": stats.preemptions,
        "goodput_tok_per_step": round(gp, 3),
    }
    print(out)
    return out


if __name__ == "__main__":
    main()
