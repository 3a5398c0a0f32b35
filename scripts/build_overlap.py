"""Time the kernels' build alone and beside the dry run, on the host of a
card: whether ``chip_smoke.py`` gains by running phase 16 (a)'s dry run
(``launch.dryrun.sweep``) while ``nvcc`` builds.

    PYTHONPATH=src python3 scripts/build_overlap.py

Builds every kernel source into a fresh temporary directory (so nothing
is reused) three times: alone, beside the sweep (``chip_smoke.py``'s own
``dryrun_beside_build``), and alone again; then runs the sweep alone.
Prints each time, the card's name and power limit, and the seconds the
overlap saves against running the two one after the other.  Needs
``nvcc``; initialises no CUDA context.
"""
from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def fresh_build(fn):
    """``fn()`` with ``build.BUILD`` pointed at a new empty directory;
    returns its result and wall seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        build.BUILD = Path(tmp)
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0


def main() -> int:
    print(f"card: {chip_smoke.card_line()}", flush=True)
    _, alone1 = fresh_build(build.build_all)
    print(f"build alone: {alone1:.1f} s", flush=True)
    (_, build_s, rows), both = fresh_build(
        lambda: chip_smoke.dryrun_beside_build(torch, build))
    print(f"build beside the dry run: build {build_s:.1f} s, both ended at "
          f"{both:.1f} s ({len(rows)} rows)", flush=True)
    _, alone2 = fresh_build(build.build_all)
    print(f"build alone again: {alone2:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows = list(dryrun.sweep())
    sweep_s = time.perf_counter() - t0
    print(f"dry run alone: {sweep_s:.1f} s ({len(rows)} rows)", flush=True)
    serial = (alone1 + alone2) / 2 + sweep_s
    print(f"one after the other {serial:.1f} s (mean build alone + dry run "
          f"alone), overlapped {both:.1f} s: the overlap saves "
          f"{serial - both:.1f} s; CUDA initialised: "
          f"{torch.cuda.is_initialized()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
