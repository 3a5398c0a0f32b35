"""End-to-end training entry point (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b

The reference's flags, plus ``--device`` (default ``cuda``) and
``--remat`` (``none`` or ``full``: each layer's activations recomputed in
the backward).  Parameters in f32 from a seeded ``torch.Generator``,
compute in bf16 (the reference's ``local_plan(param_dtype=f32)``), AdamW,
the synthetic ``TokenPipeline``; with ``--ckpt`` a committed checkpoint
every ``--ckpt-every`` steps, and a rerun resumes from the last one.
Prints each step as the reference does and returns ``{"first_loss",
"last_loss"}`` of this run's steps.  Every registered family trains:
the dense, MoE, MLA, RWKV6 and hybrid token decoders on ``next_batch``'s
tokens, the encoder (hubert-xlarge) on ``next_embed_batch``'s frame
embeddings, as the reference chooses by ``input_kind``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, local_plan
from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import DataConfig, TokenPipeline
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_opt_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    ap.add_argument("--remat", default="none", choices=("none", "full"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke_config()
    plan = local_plan(param_dtype=torch.float32, remat=args.remat)
    model = build_model(cfg, plan, device=args.device)

    params = model.init(torch.Generator(device=args.device).manual_seed(0))
    opt_state = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, grad_accum=args.grad_accum)
    data_cfg = DataConfig(cfg.vocab_size, args.batch, args.seq)
    pipe = TokenPipeline(data_cfg, device=args.device)

    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        (params, opt_state), manifest = restore_checkpoint(
            args.ckpt, (params, opt_state))
        start = manifest["step"]
        pipe = TokenPipeline(data_cfg, step=start, device=args.device)
        print(f"resumed from step {start}")

    losses = []
    for step in range(start, args.steps):
        if cfg.input_kind == "embeds":
            inputs, labels = pipe.next_embed_batch(cfg.d_model)
        else:
            inputs, labels = pipe.next_batch()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, inputs, labels)
        loss = float(metrics["loss"])
        losses.append(loss)
        print(f"step {step:4d} loss {loss:.4f} "
              f"gnorm {float(metrics['grad_norm']):.3f} "
              f"({time.perf_counter() - t0:.2f}s)")
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, step + 1, (params, opt_state),
                            meta={"arch": cfg.name})
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None}


if __name__ == "__main__":
    out = main()
    print(out)
