#!/usr/bin/env python3
"""``analysis.op_cost``'s counts of two trees of the port, side by side,
on the CPU and the meta device (no card needed).

    python3 scripts/op_cost_parity.py OTHER_TREE

OTHER_TREE is a checkout of another commit (for instance the parent,
unpacked with ``git archive`` into a directory ``.gitignore`` lists).
Each tree runs in a process of its own, with its ``src`` first on
``sys.path`` and one torch thread, and counts: a paged decode step and a
chunk tick of the smoke llama2-7b, qwen3-1.7b and granite-moe-3b-a800m
(bf16 weights from seed 0, under ``torch.inference_mode``), one train
step (AdamW) of the smoke llama2-7b, rwkv6-3b, hymba-1.5b, hubert-xlarge
and minicpm3-4b, and every cell of ``launch.dryrun.sweep`` on the meta
device.  Prints, per case, "equal" or each field that differs (flops,
bytes, gemm and kernel flops and bytes, peak live bytes, the census, the
kernels' rows; a dry-run cell's row but its seconds), then how many
cases are equal.  Exits 1 when any differs.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

THIS = Path(__file__).resolve().parent.parent
SERVE = ("llama2-7b", "qwen3-1.7b", "granite-moe-3b-a800m")
TRAIN = ("llama2-7b", "rwkv6-3b", "hymba-1.5b", "hubert-xlarge",
         "minicpm3-4b")


def child(src: str, out: str) -> None:
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch.analysis import op_cost
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model, local_plan
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    i32 = torch.int32
    res = {}
    for arch in SERVE:
        cfg = get_config(arch).smoke_config()
        m = build_model(cfg, local_plan(param_dtype=torch.bfloat16),
                        device="cpu")
        p = m.init(torch.Generator().manual_seed(0))
        pool = m.init_paged_cache(25, 8)
        with torch.inference_mode():
            res[f"decode {arch}"] = op_cost.count(
                m.decode_step_paged, p, pool,
                torch.tensor([5, 9, 11], dtype=i32),
                torch.tensor([4, 17, 30], dtype=i32),
                torch.arange(24, dtype=i32).reshape(3, 8) + 1,
                live=(p, pool), breakdown=True)[1]
            pool = m.init_paged_cache(25, 8)
            res[f"chunk {arch}"] = op_cost.count(
                m.prefill_chunk_paged, p, pool,
                torch.arange(16, dtype=i32).reshape(2, 8) % 100,
                torch.tensor([0, 4], dtype=i32),
                torch.tensor([8, 3], dtype=i32),
                torch.arange(16, dtype=i32).reshape(2, 8) + 1,
                live=(p, pool), breakdown=True)[1]
    for arch in TRAIN:
        cfg = get_config(arch).smoke_config()
        m = build_model(cfg, local_plan(), device="cpu")
        p = m.init(torch.Generator().manual_seed(0))
        opt = init_opt_state(p)
        g = torch.Generator().manual_seed(1)
        inputs = (torch.randn(2, 16, cfg.d_model, generator=g)
                  if arch == "hubert-xlarge" else
                  torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                                dtype=i32))
        labels = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                               dtype=i32)
        res[f"train {arch}"] = op_cost.count(
            make_train_step(m, AdamWConfig()), p, opt, inputs, labels,
            live=(p, opt))[1]
    for row in dryrun.sweep():
        row.pop("t_s", None)
        res[f"dryrun {row['arch']} {row['shape']}"] = row
    Path(out).write_text(json.dumps(res, sort_keys=True, default=str))


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--child":
        child(argv[1], argv[2])
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"other": Path(argv[0]).resolve(), "this": THIS}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {label: (subprocess.Popen(
            [sys.executable, __file__, "--child", str(tree / "src"),
             str(Path(tmp) / f"{label}.json")]), Path(tmp) / f"{label}.json")
            for label, tree in trees.items()}
        if any(p.wait() for p, _ in procs.values()):
            return 1
        other, this = (json.loads(f.read_text())
                       for _, f in procs.values())
    same = 0
    for case in sorted(set(other) | set(this)):
        a, b = other.get(case), this.get(case)
        if a == b:
            same += 1
            print(f"{case}: equal", flush=True)
            continue
        keys = sorted(set(a or {}) | set(b or {}))
        diff = {k: ((a or {}).get(k), (b or {}).get(k)) for k in keys
                if (a or {}).get(k) != (b or {}).get(k)}
        print(f"{case}: differs {json.dumps(diff, default=str)[:2000]}",
              flush=True)
    print(f"{same} of {len(set(other) | set(this))} cases equal")
    return 0 if same == len(set(other) | set(this)) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
