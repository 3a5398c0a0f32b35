#!/usr/bin/env python3
"""Kernel 1 of two trees, timed in turns on one card: the bf16
``flash_attention`` of the PyTorch/CUDA port at ``chip_smoke.py``'s four
phase-1 shapes (llama2-7b causal, hymba-1.5b's window, hubert-xlarge
bidirectional, gemma-7b's D=256).

    python3 scripts/flash_turns.py OTHER_TREE

OTHER_TREE is a checkout of another commit, for instance the parent
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Four processes run in the order other, this, this, other.  Each puts its
tree's ``src`` first on ``sys.path``, builds that tree's kernel from its
own ``csrc`` and times its wrapper at each shape: median, min and max of
5 runs of CUDA events around 20 calls (after 3 warm-up calls), with the
largest error against that tree's plain version.  The script prints every
process's readings, then each shape's medians side by side beside the
bound (the larger of bytes over 3.35 TB/s and flops over 989 TFLOP/s).
Needs one CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parent.parent
# name: (B, H, K, S, D, causal, window)
SHAPES = {
    "llama2-7b causal": (4, 32, 32, 512, 128, True, 0),
    "hymba-1.5b window": (1, 25, 5, 2048, 64, True, 1024),
    "hubert-xlarge bidirectional": (4, 16, 16, 1000, 80, False, 0),
    "gemma-7b causal D=256": (1, 16, 16, 2048, 256, True, 0),
}


def pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps per (batch, head)."""
    if not causal:
        return sum(S - max(0, q - window + 1) for q in range(S)) \
            if window else S * S
    W = min(window, S) if window else S
    return W * (W + 1) // 2 + (S - W) * W


def bound_ms(B, H, K, S, D, causal, window) -> tuple[float, int]:
    n_bytes = 2 * B * S * (H + K) * D * 2            # q, k, v in, o out
    flops = 4 * D * B * H * pairs(S, causal, window)
    return max(n_bytes / 3.35e12, flops / 989e12) * 1e3, flops


def child(src: str) -> None:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import flash_attention as fa

    def cuda_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    out = {}
    for name, (B, H, K, S, D, causal, window) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
                   for n in (H, K, K))
        kw = {"causal": causal, "window": window}
        err = (fa.flash_attention(q, k, v, **kw).float()
               - fa.flash_attention_ref(q, k, v, **kw).float()).abs().max()
        runs = [cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
                for _ in range(5)]
        out[name] = {"ms": statistics.median(runs), "min": min(runs),
                     "max": max(runs), "err": err.item()}
    print("TURN " + json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        child(argv[1])
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    turns = []
    for label, tree in (("other", other), ("this", THIS), ("this", THIS),
                        ("other", other)):
        run = subprocess.run([sys.executable, __file__, "--child",
                              str(tree / "src")], capture_output=True,
                             text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("TURN ")]
        if run.returncode or not lines:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append((label, json.loads(lines[0][5:])))
        print(f"{label} ({tree}): {lines[0][5:]}", flush=True)
    for name, shape in SHAPES.items():
        bound, flops = bound_ms(*shape)
        cells = ", ".join(
            f"{label} {t[name]['ms']:.4f} ({t[name]['min']:.4f}-"
            f"{t[name]['max']:.4f}; {flops / t[name]['ms'] / 1e9:.1f} "
            f"TFLOP/s; err {t[name]['err']:.3e})" for label, t in turns)
        print(f"{name} {shape}: {cells}; bound {bound:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
