"""Train a small qwen3-family model for a few hundred steps with
checkpoint/restart (port of ``examples/train_small.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_small [--steps 300] \
        [--ckpt DIR] [--device cuda]

It passes the reference example's flags to ``repro_torch.launch.train``.
Those include ``--smoke``, so it trains qwen3-1.7b's smoke config (2
layers, d_model 64), not the ~100M-parameter model the reference
example's docstring names.  Kill it mid-run and rerun: it resumes from
the last committed checkpoint.
"""
import argparse

from repro_torch.launch.train import main as train_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default="ckpt_train_small",
                    help="checkpoint directory (relative to the working "
                         "directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train_main([
        "--arch", "qwen3-1.7b", "--smoke", "--steps", str(args.steps),
        "--batch", "16", "--seq", "128", "--lr", "1e-3",
        "--ckpt", args.ckpt, "--ckpt-every", "25", "--device", args.device,
    ])
    print(out)
    return out


if __name__ == "__main__":
    main()
