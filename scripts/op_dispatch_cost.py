#!/usr/bin/env python3
"""The host's cost of calling a kernel through a ``torch.library`` op, on
toy ops whose bodies allocate their output and launch nothing, and of
the port's own entry points.

    python3 scripts/op_dispatch_cost.py [--device cpu|cuda]

Times, in µs a call (the median of 5 runs of 20,000 calls after 200
warm-up calls, in grad mode, under ``torch.no_grad`` and under
``torch.inference_mode``), a Python function called directly; an op
defined by ``torch.library.Library`` with an implementation for the
device and autograd passed through (the route ``kernels/ops.py``
takes); the same op with a Python autograd kernel that checks the
inputs and redispatches below autograd; and the same function as a
``torch.library.custom_op``.  Then, on the CPU only, the dispatch of
``ops.paged_decode_attention`` at its smallest shape with its
implementation patched to return its input, so the figure is the
entry point's own: its op, the refusal check and the late-bound
adapter.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
from torch.library import Library, fallthrough_kernel  # noqa: E402

SCHEMA = ("(Tensor q, Tensor k, *, float? scale=None, bool causal=True, "
          "int window=0) -> Tensor")


def body(q, k, *, scale=None, causal=True, window=0):
    return torch.empty_like(q)


def us_per_call(fn, n: int = 20_000) -> float:
    for _ in range(200):
        fn()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(runs)


def toy_ops(device: str) -> dict:
    key = "CUDA" if device == "cuda" else "CPU"
    lib = Library("dispatch_cost", "DEF")
    lib.define("library" + SCHEMA)
    lib.impl("library", body, key)
    lib.impl("library", fallthrough_kernel, "Autograd")
    lib.define("autograd" + SCHEMA)
    lib.impl("autograd", body, key)
    op = torch.ops.dispatch_cost.autograd.default
    below = torch._C._after_autograd_keyset

    def autograd(keys, q, k, **kw):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
            raise RuntimeError("no backward")
        return op.redispatch(keys & below, q, k, **kw)

    lib.impl("autograd", autograd, "Autograd", with_keyset=True)

    @torch.library.custom_op("dispatch_cost::custom", mutates_args=())
    def custom(q: torch.Tensor, k: torch.Tensor, scale: float | None = None,
               causal: bool = True, window: int = 0) -> torch.Tensor:
        return torch.empty_like(q)

    return {"direct call": body,
            "Library op, autograd passed through":
                torch.ops.dispatch_cost.library.default,
            "Library op, a Python autograd kernel": op,
            "custom_op": custom}, lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    calls, _lib = toy_ops(args.device)
    q = torch.zeros(4, device=args.device)
    print("bodies: torch.empty_like(q) in every route", flush=True)
    for mode, ctx in (("grad mode", torch.enable_grad),
                      ("no_grad", torch.no_grad),
                      ("inference_mode", torch.inference_mode)):
        with ctx():
            cells = ", ".join(
                f"{name} {us_per_call(lambda: fn(q, q, scale=0.5, window=3)):.2f}"
                for name, fn in calls.items())
        print(f"{args.device}, {mode}, µs a call: {cells}", flush=True)
    if args.device == "cpu":
        from repro_torch.kernels import ops
        from repro_torch.kernels import paged_decode_attention as pa
        pa.paged_decode_attention_ref = lambda q, *a, **k: q
        t = torch.zeros(1, 1, 8)
        pool = torch.zeros(1, 1, 1, 8)
        tab = torch.zeros(1, 1, dtype=torch.int32)
        pos = torch.zeros(1, dtype=torch.int32)
        print(f"cpu, grad mode, ops.paged_decode_attention with a plain "
              f"version that returns q, µs a call: "
              f"{us_per_call(lambda: ops.paged_decode_attention(t, pool, pool, tab, pos)):.2f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
