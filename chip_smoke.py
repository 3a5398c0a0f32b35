#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, in parallel), then:

1. holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes, in bf16 and f32, and times kernel, plain version
   and a PyTorch library call beside each (the library call is a yardstick
   only; the port never calls it);
2. serves full-width llama2-7b (random weights from a seeded generator)
   through the paged ``Engine`` at horizon 1 and at horizon 8, checking
   completion, identical greedy streams and that both kernels ran;
3. compares prefill logits and one paged decode step computed through the
   kernels with the same computed through the plain versions on the card;
4. traces one prefill and one decode horizon at the serving shape with
   ``torch.profiler``: host wall time and device busy time per step, the
   device's idle share, and the device kernels that take the time.  The
   same decode horizon is also timed on the host clock after init (plain
   and under ``torch.inference_mode``) and after each later phase, so the
   drift of the host's clock over the run stands beside the trace.

Any failed check exits non-zero.  The last line is the result JSON; the
lines before it list every kernel with its launches, error and times, and
the card's name and power limit as ``nvidia-smi`` prints them.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call
# is the larger of its bytes over HBM bandwidth and its flops over the
# peak of its input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# kernel vs plain version, by the lowest input precision: the max abs err,
# and the error's norm relative to the plain output's norm (the latter scales
# with the outputs, which shrink as more keys are averaged: a bf16 defect of
# a few percent passes the absolute bound at long contexts but not this one)
TOL = {"bf16": 2e-2, "f32": 1e-4}
REL_TOL = {"bf16": 1e-2, "f32": 1e-5}


def compare(got, want) -> tuple[float, float]:
    """(max abs err, ||got - want|| / ||want||) in f32."""
    d = got.float() - want.float()
    return (d.abs().max().item(),
            (d.norm() / want.float().norm().clamp_min(1e-30)).item())


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card: CUDA events around ``iters`` calls
    after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
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


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(torch, dtypes, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, H, K, D = 4, 32, 32, 128
    timed = None
    for name, dt in dtypes.items():
        for S in (16, 200, 512):
            # the model's (B, S, H, D) activations, passed as strided views
            q, k, v = (torch.randn(B, S, n, D, generator=gen, device="cuda",
                                   dtype=dt).transpose(1, 2)
                       for n in (H, K, K))
            err, rel = compare(fa.flash_attention(q, k, v),
                               fa.flash_attention_ref(q, k, v))
            ok = err <= TOL[name] and rel <= REL_TOL[name]
            print(f"flash_attention {name} B={B} H={H} K={K} S={S} D={D}: "
                  f"max_abs_err={err:.3e} tol={TOL[name]:.0e} "
                  f"rel_err={rel:.3e} rel_tol={REL_TOL[name]:.0e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash_attention {name} S={S} disagrees with its plain "
                     f"version")
            if name == "bf16" and S == 512:
                timed = (q, k, v, err)
    q, k, v, err = timed
    S = q.shape[2]
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                            is_causal=True))
    n_bytes = 4 * B * S * H * D * q.element_size()
    flops = 4 * D * B * H * S * (S + 1) // 2
    bound = max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bf16"]) * 1e3
    by = "bytes" if n_bytes / HBM_BYTES_PER_S > flops / PEAK_FLOPS["bf16"] \
        else "operations"
    print(f"flash_attention bf16 B={B} H={H} S={S} D={D}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} "
          f"ms ({by}: {n_bytes} B, {flops} flop)", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:79",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def _paged_inputs(torch, gen, B, H, K, D, bs, T, q_dt, kv_dt):
    n_blocks = 1 + B * T
    perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
    tables = perm[: B * T].reshape(B, T).to(torch.int32)     # scrambled
    pos = torch.randint(0, T * bs, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)                    # ragged
    pos[0] = T * bs - 1
    q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    vp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    return q, kp, vp, tables, pos


def check_paged(torch, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attention as pa
    bf16, f32 = torch.bfloat16, torch.float32
    B, D, bs, T = 8, 128, 16, 128
    cases = [("bf16", 32, 32, bf16, bf16), ("f32", 32, 32, f32, f32),
             ("bf16", 32, 32, f32, bf16), ("bf16", 64, 8, bf16, bf16),
             ("f32", 64, 8, f32, f32)]
    timed = None
    for name, H, K, q_dt, kv_dt in cases:
        args = _paged_inputs(torch, gen, B, H, K, D, bs, T, q_dt, kv_dt)
        err, rel = compare(pa.paged_decode_attention(*args),
                           pa.paged_decode_attention_ref(*args))
        ok = err <= TOL[name] and rel <= REL_TOL[name]
        print(f"paged_decode_attention q={q_dt} pool={kv_dt} B={B} H={H} "
              f"K={K} D={D} bs={bs} T={T} max_pos={args[4].max().item()}: "
              f"max_abs_err={err:.3e} tol={TOL[name]:.0e} "
              f"rel_err={rel:.3e} rel_tol={REL_TOL[name]:.0e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"paged_decode_attention {q_dt}/{kv_dt} H={H} K={K} "
                 f"disagrees with its plain version")
        if timed is None:
            timed = (args, err)
    (q, kp, vp, tables, pos), err = timed
    H, K = q.shape[1], kp.shape[2]
    ms = cuda_ms(lambda: pa.paged_decode_attention(q, kp, vp, tables, pos))
    plain_ms = cuda_ms(
        lambda: pa.paged_decode_attention_ref(q, kp, vp, tables, pos))
    # yardstick: SDPA over the same keys gathered into a dense, masked
    # (B, H, T*bs, D) cache (the gather itself is not timed)
    kd = kp[tables].reshape(B, T * bs, K, D).transpose(1, 2)
    vd = vp[tables].reshape(B, T * bs, K, D).transpose(1, 2)
    mask = (torch.arange(T * bs, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=mask))
    keys = int((pos.long() + 1).sum().item())
    live_blocks = int(((pos.long() + bs) // bs).sum().item())
    n_bytes = (2 * keys * K * D * kp.element_size()     # K and V of live keys
               + 2 * B * H * D * q.element_size()       # q in, o out
               + 4 * live_blocks + 4 * B)               # table ids, positions
    flops = 4 * D * H * keys
    bound = max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bf16"]) * 1e3
    by = "bytes" if n_bytes / HBM_BYTES_PER_S > flops / PEAK_FLOPS["bf16"] \
        else "operations"
    print(f"paged_decode_attention bf16 B={B} H={H} K={K} D={D} keys={keys}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa-dense "
          f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}: {n_bytes} B, "
          f"{flops} flop)", flush=True)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:331",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# phase 2: full-width llama2-7b through the Engine
# ---------------------------------------------------------------------------

def serve_once(torch, model, params, horizon, fa, pa):
    import numpy as np
    from repro_torch.serving import Engine, EngineKnobs, Request
    eng = Engine(model, params, max_seq=2048, n_slots=4,
                 knobs=EngineKnobs(max_batch=4), block_size=16,
                 horizon=horizon)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
                        0, model.cfg.vocab_size, int(n))],
                    max_new_tokens=32, arrival_s=0.0)
            for n in rng.integers(16, 201, 8)]
    for r in reqs:
        eng.submit(r)
    fa.flash_attention.launches = 0
    pa.paged_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_decode_attention": pa.paged_decode_attention.launches}
    streams = [list(r.output) for r in reqs]
    steps = stats.decode_syncs * horizon
    # scheduler steps end on the horizon's readback; at horizon 1 the
    # median leaves out the 4 steps that also admitted a prefill batch, at
    # horizon 8 those are half of the steps
    step_ms = sorted(t * 1e3 / horizon for t in stats.step_times)
    print(f"serve llama2-7b horizon={horizon}: {len(stats.completed)} done, "
          f"decode_tokens={stats.decode_tokens} "
          f"prefill_tokens={stats.prefill_tokens} "
          f"prefill_batches={stats.prefill_batches} "
          f"host_syncs={stats.host_syncs} decode_steps={steps} "
          f"wall_s={wall:.3f} decode_tok_per_s={stats.decode_tokens / wall:.1f} "
          f"step_ms_median={step_ms[len(step_ms) // 2]:.3f} "
          f"({step_ms[0]:.3f}-{step_ms[-1]:.3f} over {len(step_ms)} "
          f"scheduler steps, per decode step) "
          f"launches={launches} per_prefill="
          f"{launches['flash_attention'] / max(stats.prefill_batches, 1):.1f} "
          f"per_decode_step="
          f"{launches['paged_decode_attention'] / max(steps, 1):.1f}",
          flush=True)
    if len(stats.completed) != 8 or any(len(s) != 32 for s in streams):
        fail(f"horizon={horizon}: not every request completed its budget")
    if any(not 0 <= t < model.cfg.vocab_size for s in streams for t in s):
        fail(f"horizon={horizon}: token outside the vocabulary")
    if min(launches.values()) == 0:
        fail(f"horizon={horizon}: a kernel of the path never launched: "
             f"{launches}")
    return streams, launches


# ---------------------------------------------------------------------------
# phase 3: teacher-forced kernels vs plain versions on the same weights
# ---------------------------------------------------------------------------

def teacher_forced(torch, model, params, fa, pa):
    from repro_torch.kernels import ops
    from repro_torch.serving import PagedCachePool
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = torch.tensor([200, 77, 16, 131], dtype=torch.int32,
                           device="cuda")
    tokens = torch.randint(0, model.cfg.vocab_size, (4, 256), generator=gen,
                           device="cuda", dtype=torch.int32)
    pool = PagedCachePool(model, 4, 2048, block_size=16)

    def plain_swap():
        saved = (ops.flash_attention, ops.paged_decode_attention)
        ops.flash_attention = fa.flash_attention_ref
        ops.paged_decode_attention = pa.paged_decode_attention_ref
        return saved

    lk, cache = model.prefill_ragged(params, tokens, lengths)
    saved = plain_swap()
    try:
        lp, _ = model.prefill_ragged(params, tokens, lengths)
    finally:
        ops.flash_attention, ops.paged_decode_attention = saved
    # one decode step from the kernels' prefill state, both ways
    for i, n in enumerate(lengths.tolist()):
        pool.insert(100 + i, cache, i, n)
    pool.ensure_append_blocks([100 + i for i in range(4)])
    nxt = lk[:, : model.cfg.vocab_size].argmax(-1).to(torch.int32)
    pos, tab = pool.positions(), pool.tables()
    pool_copy = {"attn": {n: t.clone() for n, t in pool.cache["attn"].items()}}
    dk, _ = model.decode_step_paged(params, pool.cache, nxt, pos, tab)
    saved = plain_swap()
    try:
        dp, _ = model.decode_step_paged(params, pool_copy, nxt, pos, tab)
    finally:
        ops.flash_attention, ops.paged_decode_attention = saved
    ok = True
    for what, a, b in (("prefill", lk, lp), ("decode", dk, dp)):
        a = a[:, : model.cfg.vocab_size].float()
        b = b[:, : model.cfg.vocab_size].float()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{what} logits not finite")
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        tol = 0.05 * scale
        top2 = b.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        agree = bool((a.argmax(-1) == b.argmax(-1)).all())
        print(f"teacher-forced {what} logits (4 rows, bf16): kernel vs plain "
              f"max_abs_err={err:.4e} tol={tol:.4e} (5% of max|logit| "
              f"{scale:.3f}) argmax_agree={agree} min_top2_margin={margin:.4e}",
              flush=True)
        ok &= err <= tol and agree
    if not ok:
        fail("teacher-forced kernel path disagrees with the plain path")


# ---------------------------------------------------------------------------
# phase 4: where the time of a prefill and of a decode step goes
# ---------------------------------------------------------------------------

def host_walls(torch, fn, per: int, reps: int) -> list:
    """``fn``'s host wall time in ms per step: one warm-up, then ``reps``
    calls, each ended by a synchronise, divided by ``per`` (the steps one
    call runs).  The host's clock varies between calls more than the
    device's."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / per)
    return walls


def trace(torch, label: str, fn, walls: list, per: int, unit: str) -> None:
    """Trace one call of ``fn`` with ``torch.profiler``: device busy time,
    the device's idle share against the median of ``walls`` (its host
    wall per step) and the device kernels that take the time, all divided
    by ``per``."""
    import statistics
    from torch.profiler import ProfilerActivity, profile
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type.name == "CUDA":
            rows.append((dev_us, e.count, e.key))
    busy_ms = sum(r[0] for r in rows) / 1e3 / per
    n_ops = sum(r[1] for r in rows) / per
    print(f"{label}: host wall {wall_ms:.3f} ms/{unit} (median of "
          f"{len(walls)}, {min(walls):.3f}-{max(walls):.3f}), device busy "
          f"{busy_ms:.3f} ms/{unit} over "
          f"{n_ops:.0f} device ops/{unit}, idle share "
          + (f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else "not measured"),
          flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev_us / 1e3 / per:8.3f} ms/{unit}  {count / per:6.1f}/"
              f"{unit}  {key[:90]}", flush=True)


def phase4_calls(torch, model, params, horizon: int = 8):
    """One bucketed prefill (4 prompts of 40-230 tokens in a 256 bucket) and
    one greedy decode horizon at the serving shape (4 lanes at the same
    positions), as closures over their inputs: (label, prefill, decode)."""
    from repro_torch.serving import PagedCachePool
    B, dev = 4, model.device
    lengths = [230, 180, 120, 40]
    pool = PagedCachePool(model, B, 2048, block_size=16)
    T = pool.blocks_per_seq
    tokens = torch.randint(0, model.cfg.vocab_size, (B, 256), device=dev,
                           dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tables = (1 + torch.arange(B * T, device=dev, dtype=torch.int32)
              ).reshape(B, T)
    tok = tokens[:, 0].contiguous()
    active = torch.ones(B, dtype=torch.bool, device=dev)
    budgets = torch.full((B,), 1000, dtype=torch.int32, device=dev)
    eos = torch.full((B,), -1, dtype=torch.int32, device=dev)
    return (f"{B} lanes at positions {lengths}, horizon={horizon}",
            lambda: model.prefill_ragged(params, tokens, lens),
            lambda: model.decode_multi_paged(
                params, pool.cache, tok, lens, tables, active, budgets, eos,
                num_steps=horizon, max_len=2048))


def host_probe(torch, stage: str, decode, horizon: int = 8) -> None:
    """The decode horizon's host wall per step at one stage of the run,
    beside the caching allocator's state: shows how far the host clock
    drifts while the work stays the same."""
    walls = host_walls(torch, decode, horizon, reps=3)
    print(f"host probe {stage}: decode host wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms/step; allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)


def where_time_goes(torch, label, prefill, decode, horizon: int = 8) -> None:
    # both calls are timed before either is traced: decode reps timed right
    # after the prefill's trace read 57.9-66.2 ms/step where the same
    # horizon timed away from a trace read 34.7-42.8 (H100 80GB HBM3, 700 W)
    prefill_walls = host_walls(torch, prefill, 1, reps=5)
    decode_walls = host_walls(torch, decode, horizon, reps=5)
    trace(torch, "prefill profile llama2-7b bf16, 4 prompts of "
          "[230, 180, 120, 40] tokens in a 256 bucket", prefill,
          prefill_walls, per=1, unit="prefill")
    trace(torch, f"decode profile llama2-7b bf16, {label}", decode,
          decode_walls, per=horizon, unit="step")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pa
    from repro_torch.models import build_model, local_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # phase 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    entries = [check_flash(torch, dtypes, gen), check_paged(torch, gen)]

    # phase 2
    cfg = get_config("llama2-7b")
    model = build_model(cfg, local_plan(param_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"llama2-7b full width: {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab_size}; {n_params} params in bf16, "
          f"init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    if n_params != cfg.param_count():
        fail(f"parameter count {n_params} != config's {cfg.param_count()}")
    label, prefill, decode = phase4_calls(torch, model, params)
    host_probe(torch, "after init", decode)
    with torch.inference_mode():
        host_probe(torch, "after init, under torch.inference_mode", decode)
    s1, l1 = serve_once(torch, model, params, 1, fa, pa)
    s8, l8 = serve_once(torch, model, params, 8, fa, pa)
    if s1 != s8:
        fail("greedy streams differ between horizon 1 and horizon 8")
    print("greedy streams identical at horizon 1 and 8", flush=True)
    for e in entries:
        e["launches"] = l1[e["name"]] + l8[e["name"]]

    host_probe(torch, "after serve", decode)

    # phase 3
    teacher_forced(torch, model, params, fa, pa)
    host_probe(torch, "after teacher-forced", decode)

    # phase 4
    where_time_goes(torch, label, prefill, decode)
    host_probe(torch, "after phase 4", decode)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(card)          # name, power limit: nvidia-smi's own line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
