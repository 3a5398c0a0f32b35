#!/usr/bin/env python3
"""One full-width training run of the PyTorch/CUDA port on one card,
longer or larger than ``chip_smoke.py``'s phases 14 and 15 can afford:
each step's loss on its own fresh batch, one held-out batch's loss
before and after the run (a batch the run never trains on, so the
between-batch spread drops out), the first step's batch's loss after the
run, the uniform loss ln V, step ms and the card's peak memory.  A step
that runs out of the card's memory is reported with the peak reached, not
raised.

    python3 scripts/train_probe.py --arch rwkv6-3b --batch 2 --seq 1024 \\
        --steps 20
    python3 scripts/train_probe.py --arch hymba-1.5b --batch 2 --seq 2048 \\
        --steps 3 --remat full

Parameters in f32 from seed 0, bf16 compute, AdamW (``--lr``, warmup 2,
cosine over ``--steps``), ``TokenPipeline``'s tokens (frame embeddings for
an encoder), as ``chip_smoke.py``'s ``train_run`` trains.  ``--layers``
cuts the depth (default: all).  Prints the card's name and power limit
first and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

# data step of the held-out batch: far past any step a run here trains on
HELD_OUT_STEP = 1_000_000


def batch_at(cfg, B: int, S: int, step: int, device: str):
    from repro_torch.training.data import DataConfig, TokenPipeline
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, B, S), step=step,
                         device=device)
    if cfg.input_kind == "embeds":
        return pipe.next_embed_batch(cfg.d_model)
    return pipe.next_batch()


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none", choices=("none", "full"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, local_plan
    from repro_torch.training.data import DataConfig, TokenPipeline
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_opt_state,
                                                 make_eval_step,
                                                 make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    model = build_model(cfg, local_plan(param_dtype=torch.float32,
                                        compute_dtype=torch.bfloat16,
                                        remat=args.remat), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    B, S = args.batch, args.seq
    print(f"{args.arch}: {cfg.num_layers} layers, batch {B} x {S}, "
          f"{args.steps} steps, lr {args.lr}, remat {args.remat}; uniform "
          f"loss ln V = {math.log(cfg.vocab_size):.4f}", flush=True)
    evaluate = make_eval_step(model)
    held = batch_at(cfg, B, S, HELD_OUT_STEP, "cuda")
    first = batch_at(cfg, B, S, 0, "cuda")
    held0 = float(evaluate(params, *held))
    step_fn = make_train_step(model, AdamWConfig(
        lr=args.lr, warmup_steps=2, total_steps=args.steps))
    state = init_opt_state(params)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, B, S), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, oom = [], [], None
    for i in range(args.steps):
        inputs, labels = (pipe.next_embed_batch(cfg.d_model)
                          if cfg.input_kind == "embeds" else pipe.next_batch())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            params, state, met = step_fn(params, state, inputs, labels)
            loss = float(met["loss"])
        except torch.cuda.OutOfMemoryError:
            oom = i
            break
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        print(f"step {i} loss {loss:.4f} gnorm {float(met['grad_norm']):.3f}"
              f" {ms[-1]:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    out = {"arch": args.arch, "layers": cfg.num_layers, "batch": B,
           "seq": S, "remat": args.remat, "card": card,
           "peak_gib": peak, "card_gib": total, "oom_at_step": oom,
           "losses": losses}
    if oom is not None:
        print(f"out of the card's memory at step {oom}: peak {peak:.2f} GiB "
              f"allocated of {total:.2f} GiB", flush=True)
    else:
        out.update(held_before=held0,
                   held_after=float(evaluate(params, *held)),
                   first_after=float(evaluate(params, *first)),
                   median_ms=statistics.median(ms[1:] or ms),
                   mean_after_first=statistics.fmean(losses[1:] or losses))
        print(f"held-out batch {out['held_before']:.4f} -> "
              f"{out['held_after']:.4f}; the first step's batch "
              f"{losses[0]:.4f} -> {out['first_after']:.4f}; mean of steps "
              f"2-{len(losses)} {out['mean_after_first']:.4f}; median step "
              f"{out['median_ms']:.1f} ms; peak {peak:.2f} GiB allocated of "
              f"{total:.2f} GiB", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
