"""Quickstart: build an architecture, train it a little, serve it (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [arch] \
        [--device cpu]

Everything runs at smoke scale.  Every registered architecture trains
(the encoder on frame embeddings); an encoder-only one is not served,
as in the reference.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, local_plan
from repro_torch.models.layers import tree_leaves
from repro_torch.serving import Engine, EngineKnobs, Request
from repro_torch.training.data import DataConfig, TokenPipeline
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_opt_state, make_train_step


def main(arch: str = "qwen3-1.7b", device="cuda") -> dict:
    cfg = get_config(arch).smoke_config()
    print(f"== {arch} (reduced config: {cfg.num_layers}L d={cfg.d_model}) ==")
    model = build_model(cfg, local_plan(param_dtype=torch.float32),
                        device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    print(f"params: {sum(t.numel() for t in tree_leaves(params)):,}")

    # --- train a few steps ---
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=2,
                                              total_steps=10))
    opt = init_opt_state(params)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, batch=8, seq_len=64),
                         device=device)
    losses = []
    for i in range(10):
        if cfg.input_kind == "embeds":
            x, y = pipe.next_embed_batch(cfg.d_model)
        else:
            x, y = pipe.next_batch()
        params, opt, m = step(params, opt, x, y)
        losses.append(float(m["loss"]))
        if i % 3 == 0:
            print(f"  step {i}: loss {losses[-1]:.4f}")

    # --- serve it ---
    if cfg.encoder_only:
        print("encoder-only arch: no decode; done.")
        return {"losses": losses, "completed": 0, "decode_tokens": 0}
    eng = Engine(model, params, max_seq=96, n_slots=4,
                 knobs=EngineKnobs(max_batch=4))
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(Request(prompt=list(rng.integers(0, cfg.vocab_size, 12)),
                           max_new_tokens=8, customer=f"c{i % 2}"))
    stats = eng.run()
    print(f"served {len(stats.completed)} requests, "
          f"{stats.decode_tokens} decode tokens, "
          f"goodput {eng.goodput(ttft_slo=50, tbt_slo=5):.2f} tok/step")
    return {"losses": losses, "completed": len(stats.completed),
            "decode_tokens": stats.decode_tokens}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="qwen3-1.7b")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.arch, a.device)
