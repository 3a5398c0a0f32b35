#!/usr/bin/env python3
"""A short first call for kernel 1's backward on the card: build kernel 1
and its backward (``csrc/flash_attention.cu``, ``flash_attention_bwd.cu``),
print ptxas's registers and spills for the backward's ``wgmma`` kernels
and any note of its that ``wgmma`` instructions were serialised (C75xx),
then hold the bf16 backward against its plain version at ``SHAPES`` (the
largest |kernel - plain| of dq, dk and dv over their max |g|, and whether
two calls give the same bits) and time it beside SDPA's backward on the
same tensors (CUDA events around 20 calls; the kernel's median of 3
runs, SDPA's of 5).

    python3 scripts/bwd_probe.py

Needs one CUDA card and nvcc.  The full compiler report goes to
``src/repro_torch/_build/flash_attention_bwd.ptxas.txt`` beside the built
library.
"""
from __future__ import annotations

import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (B, H, K, S, D, causal, window): chip_smoke.py's BWD_CASES, then small
# edges at D 16, 32 and 96
SHAPES = [(4, 32, 32, 512, 128, True, 0), (4, 16, 8, 1024, 128, True, 0),
          (4, 24, 8, 512, 64, True, 0), (1, 16, 16, 2048, 256, True, 0),
          (1, 25, 5, 2048, 64, True, 1024), (4, 16, 16, 1000, 80, False, 0),
          (1, 8, 2, 77, 16, False, 0), (1, 8, 2, 77, 32, True, 24),
          (1, 8, 2, 77, 96, True, 0)]


def ms_of(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.time()
    jobs = {n: build._start(n) for n in ("flash_attention",
                                         "flash_attention_bwd")}
    logs = {n: build._finish(n, j) for n, j in jobs.items()}
    print(f"build {time.time() - t0:.1f} s", flush=True)
    report = logs["flash_attention_bwd"]
    (build.BUILD / "flash_attention_bwd.ptxas.txt").write_text(report)
    kernel = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        if kernel and "wgmma" in kernel and ("Used" in line
                                             or "spill" in line):
            print(re.sub(r".*(bwd_\w+?I[^E]+E).*", r"\1", kernel),
                  line.strip(), flush=True)
        if "C75" in line:
            print(line.strip()[:200], flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    for B, H, K, S, D, causal, window in SHAPES:
        q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
                   for n in (H, K, K))
        do = torch.randn(B, S, H, D, generator=g, device="cuda",
                         dtype=torch.bfloat16).transpose(1, 2)
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        want = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
        errs = [((a.float() - w.float()).abs().max()
                 / w.float().abs().max()).item() for a, w in zip(got, want)]
        again = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ms = statistics.median(ms_of(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, do, lse, **kw)) for _ in range(3))
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        mask = fa._mask(S, causal, window, "cuda") if (not causal or window) \
            else None
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                            is_causal=mask is None,
                                            enable_gqa=H != K)
        lib = statistics.median(ms_of(torch, lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True)) for _ in range(5))
        print(f"{(B, H, K, S, D, causal, window)}: rel err dq {errs[0]:.2e} "
              f"dk {errs[1]:.2e} dv {errs[2]:.2e} same bits {same}; kernel "
              f"{ms:.4f} ms, sdpa bwd {lib:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
