#!/usr/bin/env python3
"""Kernels 1-5 of two trees, timed in turns on one card: the bf16
``flash_attention`` (kernel 1) of the PyTorch/CUDA port at
``chip_smoke.py``'s four phase-1 shapes (llama2-7b causal, hymba-1.5b's
window, hubert-xlarge bidirectional, gemma-7b's D=256), the bf16
``paged_decode_attention`` (kernel 2) at llama2-7b's phase-1 shape and at
its served decode step (4 lanes at 230/180/120/40), the bf16
``paged_decode_attention_lse`` (kernel 4) per launch over 2 stripes at
the phase-1 shape and over 2 and 4 stripes at the served step, the bf16
``paged_prefill_attention`` (kernel 3) at llama2-7b's chunk shape and the
bf16 ``decode_attention`` (kernel 5) at llama2-7b's slot shape and over
hymba-1.5b's ring, kernel 1's bf16 backward (``flash_attention_bwd``)
at ``chip_smoke.py``'s ``BWD_CASES`` shapes (qwen3-1.7b's training shape
among them) beside SDPA's backward on the same tensors, the bf16 owned/LSE
form of kernel 3 (``paged_prefill_attention_lse``, "3s") per launch over 2
stripes at llama2-7b's phase-1 chunk and at gemma-7b's head dim 256,
beside SDPA over each stripe's gathered owned keys, and kernel 7's bf16
backward (``rwkv6_wkv_bwd``, "7 bwd") at ``chip_smoke.py``'s
``WKV_BWD_CASES``.

    python3 scripts/flash_turns.py OTHER_TREE [--only NAME,NAME]
    python3 scripts/flash_turns.py OTHER_TREE --host
    python3 scripts/flash_turns.py --sweep

``--only`` keeps the shapes whose names contain one of the comma-separated
strings (``--only "kernel 3,kernel 7"`` times kernels 3, 3s, 7 and 7's
backward and builds only their sources).

With ``--sweep``, this tree alone times kernels 2 and 4 at each of their
shapes with the split length forced to 64, 128, 256 and 512 keys and at
``paged_split_plan``'s own, events and device time beside the bound;
kernel 6 at each of its shapes with K split 1, 2, 3, 4, 6, 8 and 12 ways
beside ``int8_split_plan``'s; and kernel 7 at its two shapes at every
instantiated (JC, Q) of head dim 64 beside ``wkv_plan``'s, by device
time: the readings the plans' rules were chosen from.

With ``--sweep`` it also times 3s at split lengths 128-1024 beside
``paged_prefill_split_plan``'s.

With ``--host`` the turns time the host's share of a call instead, at
kernel 2's served step (4 lanes at 230/180/120/40), kernel 1 at the
llama2-7b phase-1 shape and one eager prompt prefill of full-width
llama2-7b (``prefill_ragged``, 4 prompts of 230/180/120/40 tokens in a
256 bucket, random bf16 weights from seed 0: 32 kernel-1 calls), each
through ``kernels.ops`` as the model calls it (in grad mode, as the
engine runs) and, for the two kernels, through the kernel's wrapper
alone: CUDA events around back-to-back calls (median of 5 runs of 20
calls, 5 prefills), the device time (of the calls held behind a spin
kernel; a prefill's, whose launches overflow the queue behind a spin,
from a trace), the host's time to queue them (while the card is held;
a prefill onto an idle card), and events minus device time.

OTHER_TREE is a checkout of another commit, for instance the parent
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Four processes run in the order other, this, this, other.  Each puts its
tree's ``src`` first on ``sys.path``, builds that tree's kernels from its
own ``csrc`` and times its wrappers at each shape on the same seeded
inputs: median, min and max of 5 runs of CUDA events around 20 calls
(after 3 warm-up calls), with the largest error against that tree's plain
version, and the device time of 20 calls queued behind a spin kernel, so
that the card runs them back to back (events around calls that are not
held time the host where a kernel is shorter than its wrapper's host
work, as kernel 5 over hymba's ring is).  Each process also saves kernels
1, 3, 5 and 6's outputs, kernel 7's y and final state in its serve and
its training form, and the backward's dq, dk and dv, and the script
prints the largest |other - this| of them at each shape, per gradient for
the backward (0 when the two trees compute the same bits; kernel 6 must
give 0).  The backward's error is the largest of its three gradients'
against the plain version, each over its max |g|; its SDPA reading is the
median of 5 event runs and the held device time.  Then
each shape's medians side by side, events and device time, beside the
bound (the larger of bytes over 3.35 TB/s and flops over 989 TFLOP/s;
for kernels 2 and 4 the bytes of the keys these inputs make live, the
owned ones for kernel 4; for kernel 6 ops over 1979 TOP/s of int8, for
kernel 7 flops over 67 TFLOP/s of f32, as chip_smoke.py bounds them;
for the backward 10 D flops a seen pair and q, o, dO, dq, k, v, dk, dv
and the f32 lse once).  Needs one CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

THIS = Path(__file__).resolve().parent.parent
# kernel 1, name: (B, H, K, S, D, causal, window)
FLASH = {
    "llama2-7b causal": (4, 32, 32, 512, 128, True, 0),
    "hymba-1.5b window": (1, 25, 5, 2048, 64, True, 1024),
    "hubert-xlarge bidirectional": (4, 16, 16, 1000, 80, False, 0),
    "gemma-7b causal D=256": (1, 16, 16, 2048, 256, True, 0),
}
# kernel 1's backward, name: (B, H, K, S, D, causal, window), bf16
BWD = {
    "bwd llama2-7b": (4, 32, 32, 512, 128, True, 0),
    "bwd qwen3-1.7b train step": (4, 16, 8, 1024, 128, True, 0),
    "bwd granite-moe-3b-a800m": (4, 24, 8, 512, 64, True, 0),
    "bwd gemma-7b": (1, 16, 16, 2048, 256, True, 0),
    "bwd hymba-1.5b window": (1, 25, 5, 2048, 64, True, 1024),
    "bwd hubert-xlarge bidirectional": (4, 16, 16, 1000, 80, False, 0),
}
# kernel 3: (B, C, H, K, D, bs, T, starts; the last lane padded)
PREFILL = {"kernel 3 llama2-7b chunk": (4, 128, 32, 32, 128, 16, 128,
                                        (0, 1100, 515, 0))}
# kernel 3s, per launch over every stripe of a pool of 516 blocks: (B, C,
# H, K, D, bs, T, stripes, starts), chip_smoke.py phase 1's tables (lane 1
# on blocks 1-128, all in stripe 0; lane 3 padded)
PREFILL_LSE = {
    "kernel 3s llama2-7b chunk, 2 stripes": (4, 128, 32, 32, 128, 16, 128, 2,
                                             (0, 1100, 515, 0)),
    "kernel 3s gemma-7b D=256, 2 stripes": (4, 128, 16, 16, 256, 16, 128, 2,
                                            (0, 1100, 515, 0)),
}
LSE_SWEEP = (128, 256, 512, 1024)
# kernel 7's backward, bf16: chip_smoke.py's WKV_BWD_CASES (B, T, H, D, s0
# and dS_T random)
WKV_BWD = {
    "kernel 7 bwd rwkv6-3b train step": (4, 1024, 40, 64, False),
    "kernel 7 bwd ragged T": (2, 333, 40, 64, True),
    "kernel 7 bwd D=48": (2, 200, 8, 48, True),
    "kernel 7 bwd D=96": (2, 200, 8, 96, True),
    "kernel 7 bwd D=128": (2, 200, 8, 128, True),
}
# kernel 2: (B, H, K, D, bs, T, positions); kernel 4, timed per launch
# over all stripes: (B, H, K, D, bs, T, n_blocks, stripes, positions).
# Scrambled tables over the whole pool, drawn from seed 0
PHASE1_POS = (2047, 1500, 1100, 700, 300, 1900, 50, 1000)
SERVED_POS = (230, 180, 120, 40)
PAGED = {
    "kernel 2 llama2-7b phase 1": (8, 32, 32, 128, 16, 128, PHASE1_POS),
    "kernel 2 llama2-7b served": (4, 32, 32, 128, 16, 128, SERVED_POS),
    "kernel 2 granite served": (4, 24, 8, 64, 16, 128, SERVED_POS),
}
STRIPED = {
    "kernel 4 llama2-7b phase 1, 2 stripes": (8, 32, 32, 128, 16, 128, 1028,
                                              2, PHASE1_POS),
    "kernel 4 llama2-7b served, 2 stripes": (4, 32, 32, 128, 16, 128, 516, 2,
                                             SERVED_POS),
    "kernel 4 llama2-7b served, 4 stripes": (4, 32, 32, 128, 16, 128, 516, 4,
                                             SERVED_POS),
}
SWEEP = (64, 128, 256, 512)
# kernel 6: (M, K, N), bf16 out
INT8 = {f"kernel 6 int8 {m}x{k}x{n}": (m, k, n)
        for m, k, n in ((256, 1536, 512), (200, 1536, 520),
                        (4096, 4096, 4096))}
INT8_SPLITS = (1, 2, 3, 4, 6, 8, 12)
# kernel 7: (B, T, H, D), bf16 r/k/v
WKV = {"kernel 7 rwkv6-3b prefill": (1, 200, 40, 64),
       "kernel 7 rwkv6-3b decode": (4, 1, 40, 64)}
WKV_PAIRS = ((64, 2), (32, 2), (16, 2), (64, 4), (32, 4), (16, 4), (8, 4),
             (32, 8), (16, 8), (8, 8), (4, 8), (16, 16), (8, 16), (4, 16),
             (2, 16))
# kernel 5: (B, H, K, D, S, positions)
DECODE = {
    "kernel 5 llama2-7b slots": (4, 32, 32, 128, 2048, (2047, 1500, 545, 0)),
    "kernel 5 hymba-1.5b ring": (4, 25, 5, 64, 1024, (1023, 1023, 1000, 200)),
}


def pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps per (batch, head)."""
    if not causal:
        return sum(S - max(0, q - window + 1) for q in range(S)) \
            if window else S * S
    W = min(window, S) if window else S
    return W * (W + 1) // 2 + (S - W) * W


def bound_ms(n_bytes: int, flops: int) -> float:
    return max(n_bytes / 3.35e12, flops / 989e12) * 1e3


def flash_bound(B, H, K, S, D, causal, window) -> tuple[float, int]:
    n_bytes = 2 * B * S * (H + K) * D * 2            # q, k, v in, o out
    flops = 4 * D * B * H * pairs(S, causal, window)
    return bound_ms(n_bytes, flops), flops


def bwd_bound(B, H, K, S, D, causal, window) -> tuple[float, int]:
    n_bytes = 4 * B * S * (H + K) * D * 2 + 4 * B * H * S
    flops = 10 * D * B * H * pairs(S, causal, window)
    return bound_ms(n_bytes, flops), flops


def prefill_bound(B, C, H, K, D, bs, T, starts) -> tuple[float, int]:
    """Distinct K/V rows the lanes read (the padded lane's are block 0's),
    q in and o out, the tables' live entries and the starts."""
    keys = sum(s0 + C for s0 in starts[:-1]) + min(bs, starts[-1] + C)
    seen = sum(C * s0 + C * (C + 1) // 2 for s0 in starts)
    n_bytes = (2 * keys * K * D * 2 + 2 * B * C * H * D * 2
               + 4 * sum(-(-(s0 + C) // bs) for s0 in starts) + 4 * B)
    flops = 4 * D * H * seen
    return bound_ms(n_bytes, flops), flops


def prefill_lse_bound(calls) -> tuple[float, int]:
    """Per launch over the stripes (``calls``' arguments, as chip_smoke.py's
    prefill_lse_yardstick counts them): the owned K/V rows some query of a
    lane sees, q in, o and lse out, the table ids, owned flags and starts;
    4 D flops an owned (query, key) pair and head."""
    import torch
    n_bytes, flops = 0, 0
    for q, k_s, _, local, starts, owned in calls:
        B, C, H, D = q.shape
        T, bs, K = local.shape[1], k_s.shape[1], k_s.shape[2]
        kpos = torch.arange(T * bs, device=q.device)
        qpos = starts[:, None] + torch.arange(C, device=q.device)[None, :]
        own = (owned != 0).repeat_interleave(bs, dim=1)
        sees = (kpos[None, None, :] <= qpos[:, :, None]) & own[:, None, :]
        loc, own_l, st = local.tolist(), owned.tolist(), starts.tolist()
        rows = {(loc[b][k // bs], k % bs) for b in range(B)
                for k in range(st[b] + C) if own_l[b][k // bs]}
        n_bytes += (2 * len(rows) * K * D * 2 + 2 * B * C * H * D * 2
                    + 4 * B * C * H
                    + 8 * sum(-(-(s0 + C) // bs) for s0 in st) + 4 * B)
        flops += 4 * D * H * int(sees.sum())
    n = len(calls)
    return bound_ms(n_bytes // n, flops // n), flops // n


def wkv_bwd_bound(B, T, H, D, ds_in) -> tuple[float, int]:
    """chip_smoke.py's wkv_bwd_bound in bf16: r, k, v, dy, w, u, the
    checkpoints (every C = wkv_chunk(D) steps) and dS_T read once, dr, dk,
    dv, dw, du and ds0 written once; 14 flops an entry of the state and 12
    a row per step at 67 TFLOP/s of f32."""
    c = 1
    while 2 * c * D <= 4096:
        c *= 2
    n_ck = -(-T // c)
    n_bytes = (B * T * H * D * (4 * 2 + 4) + H * D * 4
               + B * H * n_ck * D * D * 4 + ds_in * B * H * D * D * 4
               + B * T * H * D * (3 * 2 + 4) + H * D * 4 + B * H * D * D * 4)
    flops = B * T * H * (14 * D * D + 12 * D)
    return max(n_bytes / 3.35e12, flops / 67e12) * 1e3, flops


def decode_bound(B, H, K, D, S, positions) -> tuple[float, int]:
    keys = sum(p + 1 for p in positions)
    n_bytes = 2 * keys * K * D * 2 + 2 * B * H * D * 2 + 4 * B
    flops = 4 * D * H * keys
    return bound_ms(n_bytes, flops), flops


def int8_bound(M, K, N) -> tuple[float, int]:
    """x, w, the scales read once, bf16 out written once; 2 M N K int8
    operations at 1979 TOP/s."""
    n_bytes = M * K + K * N + 4 * (M + N) + 2 * M * N
    ops = 2 * M * N * K
    return max(n_bytes / 3.35e12, ops / 1979e12) * 1e3, ops


def wkv_bound(B, T, H, D) -> tuple[float, int]:
    """bf16 r/k/v and f32 w read, bf16 y written, u read, the state read
    (when T == 1: the decode step's) and written; 5 flops an entry and 5 a
    row per step at 67 TFLOP/s of f32 (chip_smoke.py's wkv_bound)."""
    state_in = T == 1
    n_bytes = (B * T * H * D * (4 * 2 + 4) + H * D * 4
               + (1 + state_in) * B * H * D * D * 4)
    flops = 5 * B * T * H * D * D + 5 * B * T * H * D
    return max(n_bytes / 3.35e12, flops / 67e12) * 1e3, flops


def int8_inputs(torch, M, K, N):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(-127, 128, (M, K), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    sx = 0.01 + 0.09 * torch.rand(M, 1, generator=g, device="cuda")
    sw = 0.01 + 0.09 * torch.rand(1, N, generator=g, device="cuda")
    return x, w, sx, sw


def wkv_inputs(torch, B, T, H, D):
    """bf16 r/k/v, w around rwkv6-3b's init decay, u; a random f32 state
    for a decode step (T == 1), none (zeros) for a prefill."""
    g = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = (torch.randn(B, T, H, D, generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + torch.randn(B, T, H, D, generator=g,
                                                 device="cuda")))
    u = 0.1 * torch.randn(H, D, generator=g, device="cuda")
    s0 = torch.randn(B, H, D, D, generator=g, device="cuda") if T == 1 \
        else None
    return r, k, v, w, u, s0


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def timers(torch):
    """(cuda_ms, held_ms): CUDA events around 20 calls after 3 warm-up
    calls, and the device time of 20 calls held behind a spin kernel."""
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

    def held_ms(fn, iters=20):
        # the spin (torch.cuda._sleep, doubled until it outlasts the host's
        # queueing) holds the card until all calls are queued
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        cycles = int(2 * (time.perf_counter() - t0) * 2e9) + 2_000_000
        torch.cuda.synchronize()
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            held = not start.query()
            end.synchronize()
            if held:
                return start.elapsed_time(end) / iters
            cycles *= 2
        raise RuntimeError("the card ran the calls before all were queued")

    return cuda_ms, held_ms


def child(src: str, save: str, only: str) -> None:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import paged_decode_attention as pa
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import rwkv6_wkv as wkv

    cuda_ms, held_ms = timers(torch)

    def timed(kernel, plain, per=1):
        err = (kernel().float() - plain().float()).abs().max()
        runs = [cuda_ms(kernel) / per for _ in range(5)]
        return {"ms": statistics.median(runs), "min": min(runs),
                "max": max(runs), "dev": held_ms(kernel) / per,
                "err": err.item()}

    def keep(shapes):
        return {n: v for n, v in shapes.items()
                if not only or any(o in n for o in only.split(","))}

    out, saved = {}, {}
    bf16 = torch.bfloat16
    for name, (B, H, K, S, D, causal, window) in keep(FLASH).items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda",
                               dtype=bf16).transpose(1, 2)
                   for n in (H, K, K))
        kw = {"causal": causal, "window": window}
        saved[name] = fa.flash_attention(q, k, v, **kw).cpu()
        out[name] = timed(lambda: fa.flash_attention(q, k, v, **kw),
                          lambda: fa.flash_attention_ref(q, k, v, **kw))
    for name, (B, H, K, S, D, causal, window) in keep(BWD).items():
        out[name], saved[name] = timed_bwd(torch, fa, cuda_ms, held_ms, B, H,
                                           K, S, D, causal, window)
    for name, (B, C, H, K, D, bs, T, starts) in keep(PREFILL).items():
        g = torch.Generator(device="cuda").manual_seed(0)
        n_blocks = 1 + B * T
        tables = (torch.randperm(n_blocks - 1, generator=g, device="cuda")
                  + 1)[: B * T].reshape(B, T).to(torch.int32)
        tables[-1] = 0
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        q = torch.randn(B, C, H, D, generator=g, device="cuda", dtype=bf16)
        kp, vp = (torch.randn(n_blocks, bs, K, D, generator=g, device="cuda",
                              dtype=bf16) for _ in range(2))
        args = (q, kp, vp, tables, st)
        saved[name] = ppa.paged_prefill_attention(*args).cpu()
        out[name] = timed(lambda: ppa.paged_prefill_attention(*args),
                          lambda: ppa.paged_prefill_attention_ref(*args))
    for name, spec in keep(PREFILL_LSE).items():
        calls = prefill_lse_inputs(torch, *spec)
        n = len(calls)
        out[name] = timed(
            lambda: torch.stack([ppa.paged_prefill_attention_lse(*a)[0]
                                 for a in calls]),
            lambda: torch.stack([ppa.paged_prefill_attention_lse_ref(*a)[0]
                                 for a in calls]), per=n)
        out[name]["bound"] = prefill_lse_bound(calls)[0]
        lib = sdpa_owned(torch, calls)
        out[name]["lib"] = statistics.median(cuda_ms(lib) / n
                                             for _ in range(5))
    for name, (B, H, K, D, S, positions) in keep(DECODE).items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(B, H, D, generator=g, device="cuda", dtype=bf16)
        k, v = (torch.randn(B, S, K, D, generator=g, device="cuda",
                            dtype=bf16) for _ in range(2))
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        saved[name] = da.decode_attention(q, k, v, pos).cpu()
        out[name] = timed(lambda: da.decode_attention(q, k, v, pos),
                          lambda: da.flash_decode_ref(q, k, v, pos))
    for name, (B, H, K, D, bs, T, positions) in keep(PAGED).items():
        args, n_bytes, flops = paged_inputs(torch, B, H, K, D, bs, T,
                                            1 + B * T, 1, positions)[0]
        out[name] = timed(lambda: pa.paged_decode_attention(*args),
                          lambda: pa.paged_decode_attention_ref(*args))
        out[name]["bound"] = bound_ms(n_bytes, flops)
    for name, (B, H, K, D, bs, T, nb, stripes, positions) in \
            keep(STRIPED).items():
        calls = paged_inputs(torch, B, H, K, D, bs, T, nb, stripes, positions)
        out[name] = timed(
            lambda: stripes_of(pa.paged_decode_attention_lse, calls),
            lambda: stripes_of(pa.paged_decode_attention_lse_ref, calls),
            per=stripes)
        out[name]["bound"] = bound_ms(sum(c[1] for c in calls) // stripes,
                                      sum(c[2] for c in calls) // stripes)
    for name, (M, K, N) in keep(INT8).items():
        args = int8_inputs(torch, M, K, N)
        saved[name] = i8.int8_matmul(*args).cpu()
        out[name] = timed(lambda: i8.int8_matmul(*args),
                          lambda: i8.int8_matmul_ref(*args))
    for name, (B, T, H, D) in keep(WKV).items():
        r, k, v, w, u, s0 = wkv_inputs(torch, B, T, H, D)
        # the serve form's and the training form's y and final state
        saved[name] = (*wkv.rwkv6_wkv(r, k, v, w, u, s0),
                       *wkv.rwkv6_wkv_train(r, k, v, w, u, s0)[:2])
        saved[name] = tuple(t.cpu() for t in saved[name])
        # the error against the plain version from the same state; then
        # the timed calls write their state in place, as the slot pool's
        # decode does
        err = (wkv.rwkv6_wkv(r, k, v, w, u, s0)[0].float()
               - wkv.rwkv6_wkv_ref(r, k, v, w, u, s0)[0].float()).abs().max()

        def call():
            return wkv.rwkv6_wkv(r, k, v, w, u, s0, s_out=s0)[0]
        out[name] = timed(call, call)
        out[name]["err"] = err.item()
    for name, (B, T, H, D, rand) in keep(WKV_BWD).items():
        g = torch.Generator(device="cuda").manual_seed(15)
        r, k, v = (torch.randn(B, T, H, D, generator=g, device="cuda",
                               dtype=bf16) for _ in range(3))
        w = torch.exp(-torch.exp(-6.0 + torch.randn(B, T, H, D, generator=g,
                                                     device="cuda")))
        u = 0.1 * torch.randn(H, D, generator=g, device="cuda")
        s0 = (torch.randn(B, H, D, D, generator=g, device="cuda") if rand
              else None)
        dy = torch.randn(B, T, H, D, generator=g, device="cuda", dtype=bf16)
        ds = (torch.randn(B, H, D, D, generator=g, device="cuda") if rand
              else None)
        _, _, ck = wkv.rwkv6_wkv_train(r, k, v, w, u, s0)
        got = wkv.rwkv6_wkv_bwd(r, k, v, w, u, ck, dy, ds)
        want = wkv.rwkv6_wkv_bwd_ref(r, k, v, w, u, ck, dy, ds)
        err = max(((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item() for a, b in zip(got, want))

        def call():
            return wkv.rwkv6_wkv_bwd(r, k, v, w, u, ck, dy, ds)[0]
        out[name] = timed(call, call)
        out[name]["err"] = err
    torch.save(saved, save)
    print("TURN " + json.dumps(out), flush=True)


def timed_bwd(torch, fa, cuda_ms, held_ms, B, H, K, S, D, causal, window):
    """Kernel 1's bf16 backward on seeded inputs (the model's (B, S, H, D)
    layout, dO laid out like o): its times, its largest error over max |g|
    against the plain version, SDPA's backward on the same tensors; and
    its (dq, dk, dv) on the host."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)
               for n in (H, K, K))
    do = torch.randn(B, S, H, D, generator=g, device="cuda",
                     dtype=torch.bfloat16).transpose(1, 2)
    kw = {"causal": causal, "window": window}
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    err = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item() for a, b in zip(got, want))

    def call():
        return fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)

    runs = [cuda_ms(call) for _ in range(5)]
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    mask = fa._mask(S, causal, window, "cuda") if (not causal or window) \
        else None
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                        is_causal=mask is None,
                                        enable_gqa=H != K)

    def sdpa():
        return torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)

    lib = [cuda_ms(sdpa) for _ in range(5)]
    return ({"ms": statistics.median(runs), "min": min(runs),
             "max": max(runs), "dev": held_ms(call), "err": err,
             "sdpa": statistics.median(lib), "sdpa_dev": held_ms(sdpa)},
            tuple(t.cpu() for t in got))


def paged_inputs(torch, B, H, K, D, bs, T, n_blocks, stripes, positions):
    """Seeded bf16 inputs of kernel 2 (stripes = 1) or of kernel 4 per
    stripe of a pool of ``n_blocks`` split ``stripes`` ways: a list of
    (args, bytes, flops), the bytes the K/V of the keys each call's walk
    visits, q in, o (and lse) out, the table ids, owned flags and
    positions it reads."""
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    tables = (torch.randperm(n_blocks - 1, generator=g, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, D, generator=g, device="cuda", dtype=bf16)
    kp, vp = (torch.randn(n_blocks, bs, K, D, generator=g, device="cuda",
                          dtype=bf16) for _ in range(2))
    seen = torch.arange(T, device="cuda")[None, :] * bs <= pos[:, None]
    if stripes == 1:
        blocks = int(seen.sum())
        keys = sum(p + 1 for p in positions)
        n_bytes = (2 * keys * K * D * 2 + 2 * B * H * D * 2 + 4 * blocks
                   + 4 * B)
        return [((q, kp, vp, tables, pos), n_bytes, 4 * D * H * keys)]
    nb_loc = n_blocks // stripes
    calls = []
    for r in range(stripes):
        local = tables - r * nb_loc
        owned = ((local >= 0) & (local < nb_loc)).to(torch.int32)
        live = ((torch.arange(T * bs, device="cuda")[None, :] <= pos[:, None])
                & (owned != 0).repeat_interleave(bs, dim=1))
        keys = int(live.sum())
        n_bytes = (2 * keys * K * D * 2 + 2 * B * H * D * 2 + 4 * B * H
                   + 4 * (int(seen.sum()) + int((seen & (owned != 0)).sum())
                          + B))
        calls.append(((q, kp[r * nb_loc:(r + 1) * nb_loc],
                       vp[r * nb_loc:(r + 1) * nb_loc],
                       local.clamp(0, nb_loc - 1), pos, owned), n_bytes,
                      4 * D * H * keys))
    return calls


def prefill_lse_inputs(torch, B, C, H, K, D, bs, T, stripes, starts):
    """Seeded bf16 inputs of kernel 3s per stripe of a pool of 516 blocks,
    as chip_smoke.py's phase 1 makes them: scrambled tables, lane 1 on
    blocks 1 .. T (all in stripe 0), the last lane padded (zeros)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    nb = 516
    tables = (torch.randperm(nb - 1, generator=g, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    tables[1] = torch.arange(1, T + 1, dtype=torch.int32, device="cuda")
    tables[-1] = 0
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    q = torch.randn(B, C, H, D, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    kp, vp = (torch.randn(nb, bs, K, D, generator=g, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    nl = nb // stripes
    calls = []
    for r in range(stripes):
        local = tables - r * nl
        owned = ((local >= 0) & (local < nl)).to(torch.int32)
        calls.append((q, kp[r * nl:(r + 1) * nl], vp[r * nl:(r + 1) * nl],
                      local.clamp(0, nl - 1), st, owned))
    return calls


def sdpa_owned(torch, calls):
    """One SDPA call a stripe over its owned keys gathered into a dense,
    masked (B, K, T*bs, D) cache (the gather not timed; o only, no lse)."""
    import torch.nn.functional as F
    dense = []
    for q, k_s, v_s, local, starts, owned in calls:
        B, C, H, D = q.shape
        T, bs, K = local.shape[1], k_s.shape[1], k_s.shape[2]
        kpos = torch.arange(T * bs, device="cuda")
        qpos = starts[:, None] + torch.arange(C, device="cuda")[None, :]
        own = (owned != 0).repeat_interleave(bs, dim=1)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) & own[:, None, :]
        kd = k_s[local.long()].reshape(B, T * bs, K, D).transpose(1, 2)
        vd = v_s[local.long()].reshape(B, T * bs, K, D).transpose(1, 2)
        dense.append((q.transpose(1, 2), kd, vd, mask[:, None]))
    return lambda: [F.scaled_dot_product_attention(qq, kd, vd, attn_mask=m)
                    for qq, kd, vd, m in dense]


def stripes_of(fn, calls):
    """``fn`` over every stripe's inputs; the outputs (o of each) stacked."""
    import torch
    return torch.stack([fn(*args)[0] for args, _, _ in calls])


def sweep() -> int:
    """Kernels 2, 4 and 3s of this tree at forced split lengths and at the
    plan's, per launch: events (median of 5 x 20 calls) and device time;
    kernel 6 at forced K splits and kernel 7 at forced (JC, Q), beside
    their plans', by device time."""
    sys.path.insert(0, str(THIS / "src"))
    import torch
    from repro_torch.kernels import paged_decode_attention as pa
    from repro_torch.kernels import build
    build.build_all()
    print(f"card: {card()}", flush=True)
    cuda_ms, held_ms = timers(torch)
    shapes = [(n, *s[:6], 1 + s[0] * s[5], 1, s[6]) for n, s in PAGED.items()]
    shapes += [(n, *s) for n, s in STRIPED.items()]
    for name, B, H, K, D, bs, T, nb, stripes, positions in shapes:
        calls = paged_inputs(torch, B, H, K, D, bs, T, nb, stripes, positions)
        bound = bound_ms(sum(c[1] for c in calls) // stripes,
                         sum(c[2] for c in calls) // stripes)
        plan = pa.paged_split_plan(B, H, K, T, bs, stripes > 1)[0]
        cells = []
        for split in (*SWEEP, plan):
            def run(split=split):
                return [pa._launch(*args, split=split) for args, _, _ in calls]
            runs = [cuda_ms(run) / stripes for _ in range(5)]
            cells.append(f"L={split}{' (plan)' if split == plan else ''} "
                         f"{statistics.median(runs):.4f} ({min(runs):.4f}-"
                         f"{max(runs):.4f}; device "
                         f"{held_ms(run) / stripes:.4f})")
        print(f"sweep {name}: {', '.join(cells)}; bound {bound:.4f} ms",
              flush=True)
    from repro_torch.kernels import paged_prefill_attention as ppa
    for name, spec in PREFILL_LSE.items():
        calls = prefill_lse_inputs(torch, *spec)
        B, C, H, K, _, bs, T = spec[:7]
        plan = ppa.paged_prefill_split_plan(B, C, H, K, T, bs)[0]
        cells = []
        for split in (*LSE_SWEEP, plan):
            def run(split=split):
                return [ppa._launch_lse(*a, split=split) for a in calls]
            runs = [cuda_ms(run) / len(calls) for _ in range(5)]
            cells.append(f"L={split}{' (plan)' if split == plan else ''} "
                         f"{statistics.median(runs):.4f} ({min(runs):.4f}-"
                         f"{max(runs):.4f}; device "
                         f"{held_ms(run) / len(calls):.4f})")
        print(f"sweep {name}: {', '.join(cells)}; bound "
              f"{prefill_lse_bound(calls)[0]:.4f} ms", flush=True)
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import rwkv6_wkv as wkv
    for name, (M, K, N) in INT8.items():
        args = int8_inputs(torch, M, K, N)
        plan = i8.int8_split_plan(M, N, K)
        cells, seen = [], set()
        for want in INT8_SPLITS:
            k_split = i8._k_split(K, want)
            splits = -(-K // k_split)
            if splits in seen:
                continue
            seen.add(splits)
            ms = held_ms(lambda: i8._launch(*args, torch.bfloat16, splits,
                                            k_split))
            cells.append(f"splits={splits}"
                         f"{' (plan)' if splits == plan[0] else ''} "
                         f"{ms:.4f}")
        print(f"sweep {name}: device ms {', '.join(cells)}; bound "
              f"{int8_bound(M, K, N)[0]:.5f} ms", flush=True)
    for name, (B, T, H, D) in WKV.items():
        r, k, v, w, u, s0 = wkv_inputs(torch, B, T, H, D)
        plan = wkv.wkv_plan(B, H, D)
        cells = []
        for jc, q in WKV_PAIRS:
            ms = held_ms(lambda: wkv._launch(r, k, v, w, u, s0, s0, jc, q))
            cells.append(f"JC={jc} Q={q}"
                         f"{' (plan)' if (jc, q) == plan else ''} "
                         f"{ms:.4f}")
        print(f"sweep {name}: device ms {', '.join(cells)}; bound "
              f"{wkv_bound(B, T, H, D)[0]:.5f} ms", flush=True)
    return 0


def host_child(src: str) -> None:
    """One turn of ``--host``: the host's share of a call of kernel 2, of
    kernel 1 and of an eager prefill, through the ops and the wrappers."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode_attention as pa
    from repro_torch.models import build_model, local_plan

    cuda_ms, held_ms = timers(torch)

    def host_ms(fn, iters):
        """Host time per call queueing ``iters`` calls behind a spin."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)       # >= 0.2 s at <= 2 GHz
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        return host

    def read(fn):
        runs = [cuda_ms(fn) for _ in range(5)]
        ev = statistics.median(runs)
        dev = statistics.median(held_ms(fn) for _ in range(5))
        return {"events": ev, "min": min(runs), "max": max(runs),
                "device": dev,
                "host": statistics.median(host_ms(fn, 20) for _ in range(5)),
                "excess": ev - dev}

    def read_prefill(fn):
        """A prefill's ~2300 launches overflow the card's queue behind a
        spin, so: the device's busy time from a trace of one prefill, and
        the host's time to issue one onto an idle card (it issues slower
        than the card runs them, so it never waits on the queue)."""
        from torch.profiler import ProfilerActivity, profile
        runs = [cuda_ms(fn, 5) for _ in range(5)]
        ev = statistics.median(runs)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
                  for e in prof.key_averages()
                  if e.device_type.name == "CUDA") / 1e3
        hosts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            hosts.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return {"events": ev, "min": min(runs), "max": max(runs),
                "device": dev, "host": statistics.median(hosts),
                "excess": ev - dev}

    out = {}
    B, H, K, D, bs, T, positions = PAGED["kernel 2 llama2-7b served"]
    args = paged_inputs(torch, B, H, K, D, bs, T, 1 + B * T, 1,
                        positions)[0][0]
    out["kernel 2 served, ops"] = read(
        lambda: ops.paged_decode_attention(*args))
    out["kernel 2 served, wrapper"] = read(
        lambda: pa.paged_decode_attention(*args))
    Bf, Hf, Kf, S, Df, causal, window = FLASH["llama2-7b causal"]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(Bf, S, n, Df, generator=g, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)
               for n in (Hf, Kf, Kf))
    out["kernel 1 phase 1, ops"] = read(
        lambda: ops.flash_attention(q, k, v, causal=causal, window=window))
    out["kernel 1 phase 1, wrapper"] = read(
        lambda: fa.flash_attention(q, k, v, causal=causal, window=window))
    cfg = get_config("llama2-7b")
    model = build_model(cfg, local_plan(param_dtype=torch.bfloat16))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    lengths = [230, 180, 120, 40]
    tokens = torch.randint(0, cfg.vocab_size, (4, 256), device="cuda",
                           dtype=torch.int32, generator=torch.Generator(
                               device="cuda").manual_seed(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = fa.flash_attention.launches
    model.prefill_ragged(params, tokens, lens)
    per = fa.flash_attention.launches - before
    out["llama2-7b eager prefill"] = read_prefill(
        lambda: model.prefill_ragged(params, tokens, lens))
    out["llama2-7b eager prefill"]["kernel-1 calls"] = per
    out["decode step count"] = decode_count(torch, model, params, lengths)
    print("TURN " + json.dumps(out), flush=True)


def decode_count(torch, model, params, lengths) -> dict:
    """``op_cost``'s count of the body of ``chip_smoke.py`` phase 16 (c)'s
    decode step (the horizon program over a 516-block pool, 4 lanes at
    ``lengths`` + 50), exact: flops, bytes, peak live bytes, the kernels'
    rows and a digest of the census."""
    import hashlib
    from repro_torch.analysis import op_cost
    from repro_torch.serving import PagedCachePool
    from repro_torch.serving import graphs as G
    B = len(lengths)
    pool = PagedCachePool(model, B, 2048, block_size=16, n_blocks=516)
    T = pool.blocks_per_seq
    prog = G.horizon_program(model, lambda: (params, pool.cache), B, T,
                             max_len=2048, sampled=False, capture=False)
    prog.bufs["tables"].copy_((1 + torch.arange(B * T, device="cuda",
                                                dtype=torch.int32)
                               ).reshape(B, T))
    prog.bufs["positions"].copy_(torch.tensor(lengths, device="cuda") + 50)
    prog.bufs["active"].fill_(True)
    prog.bufs["budgets"].fill_(1000)
    prog.bufs["eos"].fill_(-1)
    with torch.inference_mode():
        cost = op_cost.count(prog.body)[1]
    census = json.dumps(cost["census"], sort_keys=True).encode()
    return {k: cost[k] for k in ("flops", "bytes", "gemm_flops",
                                 "peak_live_bytes", "kernels")} | {
        "census": hashlib.sha256(census).hexdigest()[:16]}


def host_turns(other: Path) -> int:
    """``--host``: four turns (other, this, this, other), then each
    case's readings side by side."""
    print(f"card: {card()}", flush=True)
    turns = []
    for label, tree in (("other", other), ("this", THIS), ("this", THIS),
                        ("other", other)):
        run = subprocess.run([sys.executable, __file__, "--host-child",
                              str(tree / "src")], capture_output=True,
                             text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("TURN ")]
        if run.returncode or not lines:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append((label, json.loads(lines[0][5:])))
        print(f"{label} ({tree}): {lines[0][5:]}", flush=True)
    counts = [t.pop("decode step count") for _, t in turns]
    print(f"decode step count, equal in every turn: "
          f"{all(c == counts[0] for c in counts)}; "
          f"{json.dumps(counts[0])}", flush=True)
    for name in turns[0][1]:
        cells = ", ".join(
            f"{label} events {t[name]['events']:.4f} ({t[name]['min']:.4f}-"
            f"{t[name]['max']:.4f}) device {t[name]['device']:.4f} host "
            f"{t[name]['host']:.4f} events-device {t[name]['excess']:.4f}"
            for label, t in turns)
        print(f"{name} (ms a call): {cells}", flush=True)
    return 0


def main(argv: list[str]) -> int:
    if len(argv) == 4 and argv[0] == "--child":
        child(argv[1], argv[2], argv[3])
        return 0
    if len(argv) == 2 and argv[0] == "--host-child":
        host_child(argv[1])
        return 0
    if len(argv) == 2 and argv[1] == "--host":
        return host_turns(Path(argv[0]).resolve())
    if argv == ["--sweep"]:
        return sweep()
    only = ""
    if len(argv) == 3 and argv[1] == "--only":
        only, argv = argv[2], argv[:1]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    other = Path(argv[0]).resolve()
    print(f"card: {card()}", flush=True)
    turns, outputs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tree) in enumerate((("other", other), ("this", THIS),
                                           ("this", THIS),
                                           ("other", other))):
            save = str(Path(tmp) / f"turn{i}.pt")
            run = subprocess.run([sys.executable, __file__, "--child",
                                  str(tree / "src"), save, only],
                                 capture_output=True, text=True, timeout=900)
            lines = [ln for ln in run.stdout.splitlines()
                     if ln.startswith("TURN ")]
            if run.returncode or not lines:
                print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
                return 1
            turns.append((label, json.loads(lines[0][5:])))
            outputs.append((label, torch.load(save)))
            print(f"{label} ({tree}): {lines[0][5:]}", flush=True)
    shapes = {**{n: flash_bound(*s) for n, s in FLASH.items()},
              **{n: bwd_bound(*s) for n, s in BWD.items()},
              **{n: prefill_bound(*s) for n, s in PREFILL.items()},
              **{n: decode_bound(*s) for n, s in DECODE.items()}}
    shapes.update({n: (turns[0][1][n]["bound"], None)
                   for n in (*PAGED, *STRIPED, *PREFILL_LSE)
                   if n in turns[0][1]})
    shapes.update({n: int8_bound(*s) for n, s in INT8.items()})
    shapes.update({n: wkv_bound(*s) for n, s in WKV.items()})
    shapes.update({n: wkv_bwd_bound(*s) for n, s in WKV_BWD.items()})
    for name, (bound, flops) in shapes.items():
        if name not in turns[0][1]:
            continue

        def rate(t):
            return ("" if flops is None else
                    f"; {flops / t[name]['ms'] / 1e9:.1f} TFLOP/s")

        def sdpa(t):
            if "lib" in t[name]:
                return f"; sdpa over the owned keys {t[name]['lib']:.4f}"
            return ("" if "sdpa" not in t[name] else
                    f"; sdpa backward {t[name]['sdpa']:.4f}, device "
                    f"{t[name]['sdpa_dev']:.4f}")
        cells = ", ".join(
            f"{label} {t[name]['ms']:.4f} ({t[name]['min']:.4f}-"
            f"{t[name]['max']:.4f}; device {t[name]['dev']:.4f}"
            f"{rate(t)}; err {t[name]['err']:.3e}{sdpa(t)})"
            for label, t in turns)
        print(f"{name}: {cells}; bound {bound:.4f} ms", flush=True)
    for name in (*FLASH, *PREFILL, *DECODE, *INT8, *WKV):
        if name not in outputs[0][1]:
            continue
        parts = (outputs[0][1][name] if isinstance(outputs[0][1][name], tuple)
                 else (outputs[0][1][name],))
        labels = (("serve y", "serve state", "training y", "training state")
                  if name in WKV else ("",))
        cells = []
        for i, what in enumerate(labels):
            diff = max((_part(a[name], i).float()
                        - _part(b[name], i).float()).abs().max().item()
                       for (la, a) in outputs for (lb, b) in outputs
                       if la == "other" and lb == "this")
            cells.append(f"{what + ' ' if what else ''}{diff:.3e}"
                         f"{'' if diff == 0 else ' (outputs differ)'}")
        assert len(parts) == len(labels)
        print(f"{name}: max |other - this| = {', '.join(cells)}", flush=True)
    for name in BWD:
        if name not in outputs[0][1]:
            continue
        cells = []
        for i, grad in enumerate(("dq", "dk", "dv")):
            diff = max((a[name][i].float() - b[name][i].float()).abs().max()
                       .item() for (la, a) in outputs for (lb, b) in outputs
                       if la == "other" and lb == "this")
            scale = outputs[1][1][name][i].float().abs().max().item()
            cells.append(f"{grad} {diff:.3e} (max |{grad}| {scale:.3e})")
        print(f"{name}: max |other - this| {', '.join(cells)}", flush=True)
    return 0


def _part(saved, i: int):
    """Output ``i`` of a saved entry (a tensor, or a tuple of them)."""
    return saved[i] if isinstance(saved, tuple) else saved


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
