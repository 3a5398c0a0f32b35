#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, in parallel), then:

1. holds each kernel against its plain PyTorch version on the card at the
   serving paths' shapes, in every (query, cache) dtype pair the kernel is
   built for (for the WKV recurrence: f32 and bf16 r/k/v, at the decode,
   prefill, ragged and state-carry shapes; for the per-stripe decode,
   kernel 4, each stripe of a pool split 2 and 4 ways, the stripes
   merged by ``combine_lse`` against kernel 2 over the whole pool, and a
   stripe that owns no block of a lane (lse -1e30 and o 0 exactly); for
   kernel 2, lanes at its split's edges, on block edges and parked, and
   llama2-7b's served step (4 lanes at 230/180/120/40) timed by events
   and device time beside SDPA; for the int8 GEMM, kernel 6, bit-exact
   at the reference's test shapes,
   granite's expert shapes, a ragged and a large shape, in both output
   types, with each shape's split plan and route (wgmma at 4096^3,
   split-K at granite's gate/up shape); kernel 7 also at head dims 48
   and 96; for kernel 1's window form, hymba-1.5b's prefill shape and edge
   windows at small S; for its bidirectional form, hubert-xlarge's shape
   (S = 1000, D = 80) and edge cases at small and ragged S, GQA and
   windows; kernel 1 at head dims 80, 96 and 256, causal and
   bidirectional, each bf16 launch on the tensor cores and each f32 one
   on the CUDA cores; kernel 3 at every head dim kernel 1 takes, in every
   dtype pair, each bf16 launch on the tensor cores and each f32 one on
   the CUDA cores; for kernel 5, also hymba's ring with its positions
   clamped to the ring's last slot, timed beside its plain version and
   SDPA; for kernel 2, a speculative verify pass's 20 pseudo-lanes, 4
   lanes' current tokens and 4 drafts each, with the split plan pinned to
   4 lanes, bit-identical row for row to 4-lane launches at each
   candidate's position, at llama2-7b's and llama2-13b's heads), and
   times kernel, plain version and a
   PyTorch library call beside each where one exists (the library call is
   a yardstick only; the port never calls it).  Kernels 1-5 and kernel
   1's window and bidirectional forms are timed five times (20 calls
   each): median, min and max, kernel 1's with its TFLOP/s; kernel 1
   causal at D = 80, 96 and 256 at S = 2048 is a reading (D = 256,
   gemma-7b's prefill shape, timed five times); kernels 1-5 at gemma-7b's
   heads (16/16 of D = 256: a prefill bucket, a decode step over 4
   lanes, a chunk tick, that step per stripe at 2 stripes, 4 slots of
   2048) through the same checks, held in every dtype pair and timed
   beside their plain versions, a library call and the bound (readings);
   and kernel 3's owned/LSE form (the per-stripe chunk attention of the
   block-striped pool) at llama2-7b's and gemma-7b's heads over 2 and 4
   stripes in every dtype pair, a lane whose keys one stripe owns (o 0
   and lse -1e30 exactly in the others), per stripe against its plain
   version and the stripes' ``combine_lse`` against kernel 3 over the
   whole pool, timed beside SDPA over a stripe's owned keys and the
   bound;
2. serves full-width llama2-7b (random weights from a seeded generator)
   through the ``Engine`` on five paths, each with every launch count set
   to 0 just before and read just after: the paged pool with whole-prompt
   prefill at horizon 1 and at horizon 8 (identical greedy streams); the
   block-striped pool through ``EngineSpec(shards=2, horizon=8)`` and then
   ``set_shards(4)`` on that engine (every decode step through kernel 4,
   ``shards`` launches per layer, none through kernel 2; every stripe
   holding live blocks); chunked prefill with prefix sharing (a shared
   128-token system prompt, chunks of 128, horizon 8), beside a
   whole-prompt run of the same requests; and the slot pool
   (``paged=False``).  Each checks completion, its counters, that its
   kernels ran, that every kernel-1 and every kernel-3 launch of the bf16
   run took the tensor cores and, on the paged pool, that the free list
   and refcounts return to their start.  Every engine runs its decode
   horizon, chunk tick and slot step as CUDA graphs (``graphs=True``, the
   default): each run checks that its programs replayed.  The horizon-8,
   shards-2, chunked and slot runs are repeated with ``graphs=False`` in
   the same call, and each pair must give identical streams, counters and
   launch counts (``same_as_eager``).  Then sampled traffic
   (``sampled_load``: ``plain_load``'s prompts, every other one at
   temperature 0.8 and top-k 40 under a seed of its own): captured at
   horizons 8 and 1 and eager at horizon 8, the same streams, the greedy
   requests those of the greedy horizon-8 run; and with and without a
   pool small enough to preempt, the same streams in an f32 compute plan
   (in bf16 a reading: a recomputed prefill's logits differ from the
   decode's in the last bits).  Then speculative decode with n-gram
   drafts (spec_k 4, horizon 4) on ``plain_load``'s prompts and on
   their continuation load (each prompt followed by its own 32-token
   greedy continuation, as ``benchmarks/bench_engine.py`` builds it),
   greedy and sampled, captured and eager (equal), beside horizon 8 without
   speculation on the same load, kernel 2 launched once per layer and
   verify round; in an f32 compute plan the greedy speculative streams
   must equal the horizon-8 run's.  Every run prints its decode tok/s;
3. compares logits teacher-forced: prefill and one paged decode step,
   one decode step through the block-striped pool at shards 2 and 4
   against the unsharded step (bf16 and f32 compute plans), a two-chunk
   prefill over a shared head and one slot decode step, each through the
   kernels and through the plain versions on the card; the chunked prompt
   against whole-prompt prefill; and the slot decode step against the
   paged one on the same context;
4. traces one whole-prompt prefill, one decode horizon (unsharded and at
   shards 2 and 4), one n-gram verify round, one chunk tick and one slot
   decode step at the serving
   shape with ``torch.profiler``: host wall time and device busy time per
   step, the device's idle share, the device kernels that take the time,
   and the time and share of kernels 1-5 beside the device ops per
   step, each decode horizon, the chunk tick and the slot step both eager
   and as replays of a captured graph (with its capture time: first step
   and warm-up, record, end and instantiate).  The same decode horizon is
   also timed on the host clock after
   init (plain and under ``torch.inference_mode``) and after each later
   phase, so the drift of the host's clock over the run stands beside the
   trace.
5. frees llama2-7b and runs phases 2-4 for full-width rwkv6-3b (random
   weights from a seeded generator) on the slot pool: the same requests
   served with every WKV launch counted (32 per prefill and per decode
   step) and no attention kernel run, captured and eager; the sampled
   traffic captured and eager (equal; the greedy requests those of the
   greedy run); a prefill and a slot decode step
   teacher-forced through the kernel and through its plain version, and
   prefill of a prompt's head plus one decode step per remaining token
   against prefill of the whole prompt (the state carried through the
   model); traces of one prefill and one slot decode step (eager and
   captured).
6. frees rwkv6-3b and serves full-width granite-moe-3b-a800m (random bf16
   weights from a seeded generator) and its int8-expert variant (the same
   draws, quantized) through the paged pool: horizon 1 and 8 on the full
   variant (identical greedy streams), and a horizon-8 run that switches
   to the int8 variant with ``set_variant`` after two steps (every
   request completes, one swap, every in-flight request preempted),
   captured and eager (equal: the swap drops the full variant's graphs
   and the int8 variant's are captured anew); each
   variant's prefill and paged decode step teacher-forced through the
   kernels and the plain versions, and the int8 variant's logits against
   the full variant's (a reading: the quality cost of the knob); kernel 6
   through ``ops.int8_matmul_quantized`` on the tokens that layer 0 of a
   prefill routes to one expert, with that expert's dequantized weights;
   traces of one prefill and one decode step per variant (the step eager
   and captured).

7. frees granite and serves full-width hymba-1.5b (random bf16 weights
   from a seeded generator; sliding-window attention, window 1024, beside
   a Mamba branch in every layer) through the slot pool: four of phase
   2's prompts and four of 1000-1990 tokens, every request completing,
   kernel 1 once per layer and prefill (in its window form for each prompt
   longer than the window), kernel 5 once per layer and decode step over
   the ring, no other attention kernel, captured and eager (equal); a
   1536-token prefill and one slot
   decode step teacher-forced through the kernels and the plain versions
   (checked in an f32 compute plan over an f32 cache, read in bf16); a
   1000-token prefill plus 64 decode steps across the ring's wrap against
   the 1064-token prefill (f32 plan); traces of one 1536-token prefill and
   one slot decode step at positions 1990/1400/1000/200 (eager and
   captured).
8. frees hymba and runs full-width hubert-xlarge's encoder forward
   (random bf16 weights from a seeded generator; 48 layers of
   bidirectional attention at head dim 80, LayerNorm, a GELU MLP) on 4
   clips of 1000 frame embeddings: ``Model.logits`` with every launch
   count set to 0 just before and read just after (kernel 1 once per
   layer, every launch bidirectional and on the tensor cores, no other
   kernel; finite logits of (4, 1000, 504)), ``Model.prefill`` (its
   last-frame logits against the forward's, its (48, 4, 1000, 16, 80)
   cache), the whole forward through
   the kernels against the plain versions in an f32 compute plan (held
   at 1e-4 of max |logit|) and in bf16 (a reading), and a trace of one
   forward with kernel 1's share of the device time.
9. frees hubert and serves full-width llama2-13b cut to 10 of its 40
   layers (random bf16 weights, seed 0) with its registered drafter,
   full-width llama2-7b cut to 8 of its 32 (seed 100; ``CUT_LAYERS``):
   ``plain_load``'s prompts at horizon 8 give a continuation load,
   served greedy and sampled at horizon 8 and speculatively with the
   drafter (spec_k 4, horizon 4), captured and eager (equal), kernel 2 launched by every
   verify pass and drafter step, kernel 1 by both models' prefills; one
   round traced eager and captured beside the drafter's 5 steps alone
   (its share of the round).
10. frees llama2-13b and runs the TAPAS control loop on the card
   (``cluster_phases``): the 320-server sim's physics against the CPU,
   the loop with an ``EngineFleet`` of two full-width llama2-13b engines
   (10 layers; the "small" variant llama2-7b at 8; the fleet, its
   engines and pools end when the loop drops them, with the cyclic
   collector held off), and ``examples/fault_storm.py``'s
   three arms on full-width llama2-7b.
11. frees phase 10's engines and serves, one model at a time (each freed
   before the next is built), the reference's five other token-input
   configs at their published widths with random bf16 weights from seed
   0: deepseek-7b, qwen3-1.7b (qk_norm, tied), gemma-7b (head dim 256,
   the gelu GLU, (1 + w) norms, the scaled embedding, tied),
   chameleon-34b and qwen3-moe-235b-a22b (128 experts top-8), each cut
   to 8 layers (of 30, 28, 28, 48 and 94): ``plain_load`` at horizon 8
   through the paged pool, captured and eager (equal); gemma-7b also through the
   block-striped pool at shards 2 (captured and eager) and 4, chunked
   prefill with prefix sharing and the slot pool, each captured and
   eager, so kernels 1-5 all run at D = 256; the dense models' prefill
   and decode step teacher-forced kernels vs plain; one captured decode
   step traced per model (device ms per step, idle share), and each
   model's tok/s and launches beside the card's name and power limit.
12. the fleet (``fleet_phases``): ``repro_torch.launch.fleet``'s drill
   (3 regions, both routers) with each region's physics on the card
   against the CPU (summaries equal); its measured drill with one
   ``EngineFleet`` of two full-width llama2-7b engines (8 layers) per
   region, all
   six on one weight copy, ``nvidia-smi``'s power, SM clock and
   temperature read every tick, the reference's closing checks and the
   summary equal to the same drill's without engines (the drill cut to
   its first 6 of 12 hours); and the oversubscription sweep on the card,
   its rows equal to the CPU's.
13. every paged path at shards 2 and 4, and MLA.  The sharded paths run
   inside the phases that hold their model (their lines start "phase
   13"): in phase 2, llama2-7b's chunked prefill with prefix sharing at
   shards 2 and 4 (every chunk tick through kernel 3's owned/LSE form,
   every decode step through kernel 4, the same shared blocks and
   prefill tokens as shards 1), the same in an f32 plan over an f32 pool
   at shards 1 and 2 (equal streams), and n-gram speculation at shards
   2; in phase 6, granite's shard degrees refused by its vocabulary
   (49155, odd), as the reference's rule refuses them; in phase 11,
   gemma-7b chunked and qwen3-moe (the experts combined over 2 ranks) at
   shards 2; each captured and eager (equal).
   Then full-width minicpm3-4b (62 layers of MLA) on the slot pool,
   captured and eager, kernel 1 alone carrying its prefills (q and k at
   D = 96, v zero-padded from 64), kernel 1's reading at that shape,
   prefill and one decode step teacher-forced kernels vs plain (f32 plan
   over an f32 cache), one captured slot step traced beside its weights'
   byte bound.
14. training.  (a) Kernel 1's backward (``flash_attention_bwd``, three
   launches: delta, dK/dV, dQ) and its training forward
   (``flash_attention_lse``, o and each row's lse) against their plain
   versions at llama2-7b's phase-1 shape, qwen3-1.7b's training shape
   (16/8, S = 1024), granite's GQA (24/8, D = 64), gemma-7b's D = 256,
   and the shapes phase 15 trains: hymba's window (25/5, W = 1024, 2 x
   2048), hubert's bidirectional form (16/16, D = 80, 4 x 1000) and
   minicpm3-4b's MLA (40/40, D = 96, 4 x 1024, v and dO zero-padded from
   64 as ``_flash_padded`` pads them), in bf16 and f32 (dq, dk, dv each within
   ``BWD_TOL`` of its max |g|; two calls give the same bits; bf16 calls
   on the tensor cores, f32 calls not), each bf16 case and the f32 llama
   case timed: events and device time, the plain version, SDPA's backward
   on the same tensors (the median of 5 timed runs, and its device time)
   and the bound.
   (b) Full-width qwen3-1.7b (f32 parameters, bf16 compute, AdamW,
   ``TokenPipeline`` at batch 4 x 1024) trains 10 steps: finite and
   falling loss, 28 forward and 28 backward launches of kernel 1 a step,
   every backward on the tensor cores, no serve-form launch, no other
   kernel and no call of a plain attention version; median step ms,
   tokens/s, peak memory, ``nvidia-smi``'s power, SM clock and
   temperature during the steps, and one traced step (device busy, idle
   share, kernel 1's forward and backward shares, the backward by pass).
   (c) The same batch through 2 layers at full width in an f32 plan: the
   loss and every grad leaf through the kernels against the plain
   route's.  (d) The 2-layer model trains 10
   steps with a checkpoint at step 5 (under ``_phase14_ckpt/`` in the
   checkout, removed after); a fresh model and optimizer restored from it
   give losses 6-10 bit for bit.
15. the other four families train.  (a) Kernel 7's training form
   (``rwkv6_wkv_train``: y and the final state bit for bit the serve
   form's, the checkpoints every C steps) and its backward
   (``rwkv6_wkv_bwd``, ``csrc/rwkv6_wkv_bwd.cu``: dr, dk, dv, dw, du and
   ds0, no atomics) against their plain versions in bf16 and f32 r/k/v at
   rwkv6-3b's training shape (B = 4, T = 1024, H = 40, D = 64, zero state),
   a ragged T of 333 with a random s0 and dS_T, and head dims 48, 96 and
   128 (each gradient by its max abs error over max |plain|; two calls
   the same bits), the training shape timed in bf16 beside the plain
   version and the bound.  (b) Full-width rwkv6-3b (32 layers, f32
   parameters, bf16 compute, AdamW) trains 5 steps at batch 2 x 1024 (its
   f32 parameters and moments take 34.6 GiB): finite losses, the first
   step's batch's loss falling over the run and the mean of steps 2-5 on
   fresh batches below step 1's, 32 training-form and 32 backward launches
   of kernel 7 a step, no serve-form launch, no plain WKV call, no other
   kernel; step ms, tokens/s, peak memory, ``nvidia-smi`` during the
   steps, a traced step with kernel 7's forward and backward shares.
   (c) The same for hymba-1.5b (8 of 32 layers, 2 x 2048 tokens, so its
   window of 1024 masks keys; the Mamba branch's scan under autograd),
   minicpm3-4b (8 of 62 layers, 4 x 1024; MLA's kernel 1 at D = 96 with v
   padded) and hubert-xlarge (48 layers, 4 x 1000 frame embeddings from
   ``next_embed_batch``; its labels are random, so only the first batch's
   loss is held to fall): kernel 1's training forward and backward once a
   layer and step, every backward on the tensor cores, no plain attention
   call, no other kernel.  (d) Each of the four at 2 layers and full width
   in an f32 plan: the loss and every grad leaf through the kernels
   against the plain route's (1e-5 relative, 1e-4 of each leaf's max
   |g|).
16. The analysis against the card (``repro_torch/analysis/oncard.py``).
   (a) While ``nvcc`` builds the kernels, ``launch.dryrun.sweep`` runs
   every ``ASSIGNED`` x runnable cell on the meta device in this process,
   before CUDA is first initialised; CUDA must still not be initialised
   after it, and every cell must give a row (printed at the end).
   (b) qwen3-1.7b's parameter and AdamW bytes at phase 14's shape and
   llama2-7b's phase-4 pool bytes: the meta build's equal to the card's,
   and the caching allocator's delta within ``allocator_span`` of the
   real build's storages; one train step's peak-live estimate beside
   ``max_memory_allocated`` (a reading).  (c) Printed in phases 4 and 14:
   ``op_cost``'s flops and bytes of the captured llama2-7b decode step and
   of the train step beside their device time, the share of the roofline
   and the MFU.  (d) Every audit entry run eagerly under the audit on the
   card, then captured: the verdicts agree, and a synthetic ``.item()``
   and host-built tensor are flagged and refused.

The launch counts are per launch whether the launch ran eagerly or as a
node of a replayed graph: a capture records each wrapper's count and
every replay adds it (``serving.graphs``).  At the end, every ticket
counter of the split kernels (2, 4, 5 and 6) must be 0.  Any failed check exits non-zero.  The last line is the result
JSON; the lines before it list every kernel with its launches, error and
times, and the card's name and power limit as ``nvidia-smi`` prints them.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import subprocess
import sys
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# every kernel's work formula, the H100 SXM's peaks and ``bound_of`` (the
# larger of a call's bytes over HBM bandwidth and its flops over the peak
# of its input type) live in ``repro_torch.analysis.roofline``; a call's
# data-dependent counts (live keys, owned rows, seen pairs) come from
# ``op_cost.kernel_work``, the dry run's and the audit's count too
from repro_torch.analysis import roofline as R  # noqa: E402
from repro_torch.analysis.op_cost import kernel_work  # noqa: E402
from repro_torch.analysis.roofline import (bound_of,  # noqa: E402
                                           window_pairs)
# kernel vs plain version, by the lowest input precision: the max abs err,
# and the error's norm relative to the plain output's norm (the latter scales
# with the outputs, which shrink as more keys are averaged: a bf16 defect of
# a few percent passes the absolute bound at long contexts but not this one)
TOL = {"bf16": 2e-2, "f32": 1e-4}
REL_TOL = {"bf16": 1e-2, "f32": 1e-5}
# depth of the models phases 9, 10 and 12 serve beside phases 2-4's
# full-depth llama2-7b (and phase 11's ``TOKEN_CONFIGS``): widths as
# published, the depth cut so the whole script stays well inside its
# 1200 s on a slow host (PERF.md §4); phase 15 trains hymba-1.5b and
# minicpm3-4b at 8 layers (``TRAIN15``)
CUT_LAYERS = {"llama2-13b": 10, "llama2-7b": 8}


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


def spread_ms(fn, per: int = 1, reps: int = 5) -> tuple[float, float, float]:
    """(median, min, max) over ``reps`` runs of ``cuda_ms(fn)`` (each 20
    calls after 3 warm-up calls), each divided by ``per``: the spread of a
    kernel's time within one run."""
    import statistics
    runs = [cuda_ms(fn) / per for _ in range(reps)]
    return statistics.median(runs), min(runs), max(runs)


def spread(ms: float, lo: float, hi: float) -> str:
    return f"{ms:.4f} ms (median; {lo:.4f}-{hi:.4f} over 5 x 20 calls)"


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel (``torch.cuda._sleep``) that holds the
    card until the host has queued them all, so that the card runs them
    back to back and the events time the card alone, for a kernel shorter
    than its wrapper's host work, where events around calls that are not
    held time the host.  The spin is doubled until the start event is
    still pending when the last call has been queued."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # twice the host's time to queue the calls, plus 1 ms, at <= 2 GHz
    cycles = int(2 * host_s * 2e9) + 2_000_000
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
    fail("device_ms: the card ran the calls before the host had queued "
         "them all, at every spin length")


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(torch, dtypes, gen, shapes=None):
    """Kernel 1, causal, B = 4, over ``shapes`` ((generator, H, K, D, S,
    label) cases), each held in every dtype of ``dtypes``; the bf16 case
    of most work timed.  By default llama2-7b's heads, then
    granite-moe-3b-a800m's (GQA 24/8, D=64) at its prefill buckets from a
    generator of their own, so the llama inputs stay as drawn."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B = 4
    if shapes is None:
        g6 = torch.Generator(device="cuda").manual_seed(6)
        shapes = ([(gen, 32, 32, 128, S, "") for S in (16, 200, 512)]
                  + [(g6, 24, 8, 64, S, " (granite)")
                     for S in (16, 200, 256)])
    timed, work = None, 0
    for name, dt in dtypes.items():
        for g, H, K, D, S, model in shapes:
            # the model's (B, S, H, D) activations, passed as strided views
            q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda",
                                   dtype=dt).transpose(1, 2)
                       for n in (H, K, K))
            err = held(f"flash_attention {name} B={B} H={H} K={K} S={S} "
                       f"D={D}{model}", fa.flash_attention(q, k, v),
                       fa.flash_attention_ref(q, k, v), name)
            if name == "bf16" and H * D * S * S > work:
                timed, work = (q, k, v, err), H * D * S * S
    q, k, v, err = timed
    _, H, S, D = q.shape
    ms, lo, hi = spread_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                            is_causal=True))
    n_bytes, flops, peak = kernel_work("flash_attention", (q, k, v))
    bound, by = bound_of(n_bytes, flops, peak)
    print(f"flash_attention bf16 B={B} H={H} S={S} D={D}: kernel "
          f"{spread(ms, lo, hi)}, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} "
          f"ms ({by}: {n_bytes} B, {flops} flop; "
          f"{flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:79",
            "max_abs_err": err, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def check_flash_window(torch, dtypes):
    """Kernel 1's window form against its plain version: hymba-1.5b's
    prefill shape (B=1, 25/5 heads, D=64, S=2048, window 1024), then edge
    windows at small S (1 and 16, below the 32-key and 64-row tiles; 33,
    not a multiple of either; 64; 1000 >= S), bf16 and f32, from a
    generator of its own so the other checks' inputs stay as drawn.  A
    window >= S must give the causal kernel's output bit for bit.  Times
    the main shape in bf16 beside its plain version, SDPA with a banded
    boolean mask over GQA-expanded K/V (a yardstick only; the expansion is
    not timed), and the causal kernel at the same shape (a reading)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(8)
    main = (1, 25, 5, 2048, 64, 1024)
    shapes = [main] + [(2, 4, 2, 256, 64, w) for w in (1, 16, 33, 64, 1000)] \
        + [(1, 25, 5, 200, 64, 33)]
    timed = None
    for name, dt in dtypes.items():
        for B, H, K, S, D, W in shapes:
            q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda",
                                   dtype=dt).transpose(1, 2)
                       for n in (H, K, K))
            o = fa.flash_attention(q, k, v, window=W)
            err = held(f"flash_attention window={W} {name} B={B} H={H} "
                       f"K={K} S={S} D={D}", o,
                       fa.flash_attention_ref(q, k, v, window=W), name)
            if W >= S and not torch.equal(o, fa.flash_attention(q, k, v)):
                fail(f"flash_attention window={W} >= S={S} differs from "
                     f"the causal kernel")
            if name == "bf16" and (B, H, K, S, D, W) == main:
                timed = (q, k, v, err)
    q, k, v, err = timed
    B, H, S, D = q.shape
    K, W = k.shape[1], main[-1]
    ms, lo, hi = spread_ms(lambda: fa.flash_attention(q, k, v, window=W))
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, window=W))
    causal_ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
    ke, ve = (t.repeat_interleave(H // K, dim=1) for t in (k, v))
    band = torch.ones(S, S, dtype=torch.bool, device="cuda").tril() \
        .triu(1 - W)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=band))
    n_bytes, flops, peak = kernel_work("flash_attention", (q, k, v),
                                       {"window": W})
    bound, by = bound_of(n_bytes, flops, peak)
    print(f"flash_attention window={W} bf16 B={B} H={H} K={K} S={S} D={D}: "
          f"kernel {spread(ms, lo, hi)}, plain {plain_ms:.4f} ms, sdpa with "
          f"a banded mask over expanded K/V {lib_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}: {n_bytes} B, {flops} flop, "
          f"{window_pairs(S, W)} pairs per head; "
          f"{flops / ms / 1e9:.1f} TFLOP/s); reading: the causal "
          f"kernel at this shape {causal_ms:.4f} ms ({window_pairs(S, S)} "
          f"pairs per head)", flush=True)
    return {"name": "flash_attention_window", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:79",
            "max_abs_err": err, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def check_flash_bidirectional(torch, dtypes):
    """Kernel 1's bidirectional form (``causal=False``) against its plain
    version: hubert-xlarge's shape (B=4, H=K=16, S=1000, D=80: 24 pad keys
    in the last 32-key tile, which every row must mask itself), then edge
    cases at small S (1; 31 and 33 about the 32-key tile; 64), GQA (H=8,
    K=2), windows 1, 16 and >= S, bf16 and f32, from a generator of its
    own so the other checks' inputs stay as drawn.  A window >= S must give
    the unwindowed output bit for bit.  Times the main shape in bf16
    beside its plain version and SDPA (``is_causal=False``; a yardstick
    only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(17)
    main = (4, 16, 16, 1000, 80, 0)
    shapes = [main] + [(2, 8, 2, S, 80, 0) for S in (1, 31, 33, 64, 1000)] \
        + [(2, 8, 2, 200, 64, w) for w in (1, 16, 200, 1000)] \
        + [(1, 16, 16, 1000, 80, 16)]
    timed = None
    for name, dt in dtypes.items():
        for B, H, K, S, D, W in shapes:
            q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda",
                                   dtype=dt).transpose(1, 2)
                       for n in (H, K, K))
            o = fa.flash_attention(q, k, v, causal=False, window=W)
            err = held(f"flash_attention bidirectional window={W} {name} "
                       f"B={B} H={H} K={K} S={S} D={D}", o,
                       fa.flash_attention_ref(q, k, v, causal=False,
                                              window=W), name)
            if W >= S and not torch.equal(
                    o, fa.flash_attention(q, k, v, causal=False)):
                fail(f"flash_attention bidirectional window={W} >= S={S} "
                     f"differs from the unwindowed kernel")
            if name == "bf16" and (B, H, K, S, D, W) == main:
                timed = (q, k, v, err)
    q, k, v, err = timed
    B, H, S, D = q.shape
    ms, lo, hi = spread_ms(lambda: fa.flash_attention(q, k, v, causal=False))
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, causal=False))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=False))
    n_bytes, flops, peak = kernel_work("flash_attention", (q, k, v),
                                       {"causal": False})
    bound, by = bound_of(n_bytes, flops, peak)
    print(f"flash_attention bidirectional bf16 B={B} H={H} S={S} D={D}: "
          f"kernel {spread(ms, lo, hi)}, plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}: {n_bytes} B, "
          f"{flops} flop; {flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
    return {"name": "flash_attention_bidirectional", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:79",
            "max_abs_err": err, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def check_flash_head_dims(torch, dtypes) -> None:
    """Kernel 1 at the head dims past 128 and off the powers of two that
    registered configs use (80 hubert-xlarge, 96 minicpm3-4b, 256
    gemma-7b), causal and bidirectional, bf16 and f32, against its plain
    version at a ragged S with GQA, from a generator of its own.  Readings
    (not entries of the kernels line): the causal kernel at B=1, H=K=16,
    S=2048 for each of the three, D=256 (gemma-7b's prefill shape) timed
    five times, each beside the plain version, SDPA and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(18)
    for name, dt in dtypes.items():
        for D in (80, 96, 256):
            for causal in (True, False):
                q, k, v = (torch.randn(2, 333, n, D, generator=g,
                                       device="cuda", dtype=dt).transpose(1, 2)
                           for n in (8, 2, 2))
                before = fa.flash_attention.tensor_core
                o = fa.flash_attention(q, k, v, causal=causal)
                if fa.flash_attention.tensor_core != before + (name == "bf16"):
                    fail(f"flash_attention {name} D={D}: the launch did not "
                         f"take the route of its dtype (bf16: tensor cores, "
                         f"f32: CUDA cores)")
                held(f"flash_attention {'causal' if causal else 'bidirectional'}"
                     f" {name} B=2 H=8 K=2 S=333 D={D}", o,
                     fa.flash_attention_ref(q, k, v, causal=causal), name)
    B, H, S = 1, 16, 2048
    for D in (80, 96, 256):
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        if D == 256:
            ms, lo, hi = spread_ms(lambda: fa.flash_attention(q, k, v))
            when = spread(ms, lo, hi)
        else:
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
            when = f"{ms:.4f} ms (20 calls)"
        plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        n_bytes, flops, peak = kernel_work("flash_attention", (q, k, v))
        bound, by = bound_of(n_bytes, flops, peak)
        print(f"reading: flash_attention causal bf16 B={B} H=K={H} S={S} "
              f"D={D}: kernel {when}, plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}: {n_bytes} B, "
              f"{flops} flop; {flops / ms / 1e9:.1f} TFLOP/s)", flush=True)


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


def check_paged(torch, gen, cases=None, B=8, D=128):
    """Kernel 2 over tables of 128 blocks of 16 at ragged positions (lane
    0 at the last), one call per (tolerance name, H, K, q dtype, pool
    dtype) of ``cases``, the first one timed.  By default llama2-7b's
    heads and a GQA 64/8 case."""
    from repro_torch.kernels import paged_decode_attention as pa
    bf16, f32 = torch.bfloat16, torch.float32
    bs, T = 16, 128
    if cases is None:
        cases = [("bf16", 32, 32, bf16, bf16), ("f32", 32, 32, f32, f32),
                 ("bf16", 32, 32, f32, bf16), ("bf16", 64, 8, bf16, bf16),
                 ("f32", 64, 8, f32, f32)]
    timed = None
    for name, H, K, q_dt, kv_dt in cases:
        args = _paged_inputs(torch, gen, B, H, K, D, bs, T, q_dt, kv_dt)
        err = held(f"paged_decode_attention q={q_dt} pool={kv_dt} B={B} "
                   f"H={H} K={K} D={D} bs={bs} T={T} "
                   f"max_pos={args[4].max().item()}",
                   pa.paged_decode_attention(*args),
                   pa.paged_decode_attention_ref(*args), name)
        if timed is None:
            timed = (args, err)
    (q, kp, vp, tables, pos), err = timed
    H, K = q.shape[1], kp.shape[2]
    ms, lo, hi = spread_ms(
        lambda: pa.paged_decode_attention(q, kp, vp, tables, pos))
    plain_ms = cuda_ms(
        lambda: pa.paged_decode_attention_ref(q, kp, vp, tables, pos))
    lib_ms, n_bytes, flops = paged_yardstick(torch, q, kp, vp, tables, pos)
    bound, by = bound_of(n_bytes, flops, "bf16")
    keys = flops // (4 * D * H)
    print(f"paged_decode_attention bf16 B={B} H={H} K={K} D={D} keys={keys}: "
          f"kernel {spread(ms, lo, hi)}, plain {plain_ms:.4f} ms, sdpa-dense "
          f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}: {n_bytes} B, "
          f"{flops} flop)", flush=True)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:331",
            "max_abs_err": err, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def check_paged_edges(torch) -> None:
    """Kernel 2 beyond ``check_paged``'s cases: granite-moe-3b-a800m's
    decode (GQA 24/8, D=64, four lanes) at its phase-6 step's positions,
    from a generator of its own; lanes at the edges of the plan's split;
    llama2-7b's served step (``served_paged``)."""
    from repro_torch.kernels import paged_decode_attention as pa
    bf16, f32 = torch.bfloat16, torch.float32
    B, D, bs, T = 8, 128, 16, 128
    g7 = torch.Generator(device="cuda").manual_seed(7)
    for name, q_dt, kv_dt in (("bf16", bf16, bf16), ("f32", f32, f32),
                              ("bf16", f32, bf16)):
        q, kp, vp, tables, _ = _paged_inputs(torch, g7, 4, 24, 8, 64, bs, T,
                                             q_dt, kv_dt)
        pos = torch.tensor([230, 180, 120, 40], dtype=torch.int32,
                           device="cuda")
        held(f"paged_decode_attention q={q_dt} pool={kv_dt} B=4 H=24 K=8 "
             f"D=64 bs={bs} T={T} positions 230/180/120/40 (granite)",
             pa.paged_decode_attention(q, kp, vp, tables, pos),
             pa.paged_decode_attention_ref(q, kp, vp, tables, pos), name)
    # lanes at the edges of the plan's split L (L - 1, L, L + 1), on block
    # edges, at the table's last key, and parked (position 0 over a table
    # row of zeros: key 0 of the parking block), from a generator of its own
    g8 = torch.Generator(device="cuda").manual_seed(8)
    L = pa.paged_split_plan(B, 32, 32, T, bs)[0]
    edges = [L - 1, L, L + 1, T * bs - 1, bs - 1, bs, 3 * L + bs, 0]
    for name, q_dt, kv_dt in _pairs(torch):
        q, kp, vp, tables, _ = _paged_inputs(torch, g8, len(edges), 32, 32,
                                             D, bs, T, q_dt, kv_dt)
        tables[-1] = 0
        pos = torch.tensor(edges, dtype=torch.int32, device="cuda")
        held(f"paged_decode_attention q={q_dt} pool={kv_dt} H=K=32 D={D} "
             f"bs={bs} T={T} positions {edges} (split L={L} edges, block "
             f"edges, a parked lane)",
             pa.paged_decode_attention(q, kp, vp, tables, pos),
             pa.paged_decode_attention_ref(q, kp, vp, tables, pos), name)
    served_paged(torch, g8)


def paged_yardstick(torch, q, kp, vp, tables, pos) -> tuple[float, int, int]:
    """(SDPA ms, bytes, flops) of one kernel-2 call: SDPA over the same
    keys gathered into a dense, masked (B, H, T*bs, D) cache (the gather
    itself is not timed), and what the call must move and compute
    (``roofline.paged_decode_work``)."""
    import torch.nn.functional as F
    B, H, D = q.shape
    bs, K = kp.shape[1], kp.shape[2]
    T = tables.shape[1]
    kd = kp[tables].reshape(B, T * bs, K, D).transpose(1, 2)
    vd = vp[tables].reshape(B, T * bs, K, D).transpose(1, 2)
    mask = (torch.arange(T * bs, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=mask))
    n_bytes, flops, _ = kernel_work("paged_decode_attention",
                                    (q, kp, vp, tables, pos))
    return lib_ms, n_bytes, flops


def served_paged(torch, gen) -> None:
    """Kernel 2 at llama2-7b's served decode step (4 lanes at positions
    230/180/120/40 over a table of 128 blocks of 16): held against its
    plain version, timed by CUDA events and by device time (``device_ms``:
    events around wrapper calls that are not held time the host here)
    beside the plain version, SDPA over the gathered dense cache and the
    bound."""
    from repro_torch.kernels import paged_decode_attention as pa
    B, H, K, D, bs, T = 4, 32, 32, 128, 16, 128
    q, kp, vp, tables, _ = _paged_inputs(torch, gen, B, H, K, D, bs, T,
                                         torch.bfloat16, torch.bfloat16)
    pos = torch.tensor([230, 180, 120, 40], dtype=torch.int32, device="cuda")
    args = (q, kp, vp, tables, pos)
    held(f"paged_decode_attention bf16 B={B} H=K={H} D={D} bs={bs} T={T} "
         f"positions 230/180/120/40 (served step)",
         pa.paged_decode_attention(*args), pa.paged_decode_attention_ref(*args),
         "bf16")
    ms, lo, hi = spread_ms(lambda: pa.paged_decode_attention(*args))
    dev = device_ms(torch, lambda: pa.paged_decode_attention(*args))
    plain_ms = cuda_ms(lambda: pa.paged_decode_attention_ref(*args))
    lib_ms, n_bytes, flops = paged_yardstick(torch, *args)
    bound, by = bound_of(n_bytes, flops, "bf16")
    keys = flops // (4 * D * H)
    print(f"paged_decode_attention bf16 served step B={B} H=K={H} D={D} "
          f"keys={keys} (split L={pa.paged_split_plan(B, H, K, T, bs)[0]}): "
          f"kernel {spread(ms, lo, hi)}, device {dev:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa-dense {lib_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}: {n_bytes} B)", flush=True)


def check_verify_fold(torch) -> None:
    """Kernel 2 over a verify pass's B * (K+1) pseudo-lanes (K = 4: the
    current token and 4 drafts of each of 4 lanes, candidate i at position
    ``pos + i`` through its lane's table, the last lane parked) with the
    plan pinned to B lanes (``plan_lanes``, what ``decode_verify_paged``
    passes) against B-lane launches at each candidate's position: every
    row bit-identical, in every dtype pair, at llama2-7b's and
    llama2-13b's heads; beside it, as a reading, the fold at its own
    plan (B * (K+1) lanes), whose splits round otherwise."""
    from repro_torch.kernels import paged_decode_attention as pa
    g9 = torch.Generator(device="cuda").manual_seed(9)
    B, Q, D, bs, T = 4, 5, 128, 16, 128
    for heads in (32, 40):
        for name, q_dt, kv_dt in _pairs(torch):
            q, kp, vp, tables, _ = _paged_inputs(torch, g9, B * Q, heads,
                                                 heads, D, bs, T, q_dt, kv_dt)
            tables = tables[:B].contiguous()
            tables[-1] = 0
            pos = torch.tensor([230, 180, 120, 0], dtype=torch.int32,
                               device="cuda")
            fpos = (pos[:, None] + torch.arange(Q, dtype=torch.int32,
                                                device="cuda")[None])
            fpos[-1] = 0
            fpos = fpos.reshape(B * Q).contiguous()
            ftab = tables[:, None].expand(B, Q, T).reshape(B * Q, T) \
                .contiguous()
            pinned = pa.paged_decode_attention(q, kp, vp, ftab, fpos,
                                               plan_lanes=B).view(B, Q, heads,
                                                                  D)
            own = pa.paged_decode_attention(q, kp, vp, ftab, fpos).view(
                B, Q, heads, D)
            same, own_err = 0, 0.0
            for i in range(Q):
                want = pa.paged_decode_attention(
                    q.view(B, Q, heads, D)[:, i].contiguous(), kp, vp,
                    tables, fpos.view(B, Q)[:, i].contiguous())
                same += int(torch.equal(pinned[:, i], want))
                own_err = max(own_err, compare(own[:, i], want)[0])
            L_b = pa.paged_split_plan(B, heads, heads, T, bs)[0]
            L_f = pa.paged_split_plan(B * Q, heads, heads, T, bs)[0]
            print(f"paged_decode_attention verify fold q={q_dt} pool={kv_dt} "
                  f"H=K={heads} D={D} {B} lanes x {Q} candidates at "
                  f"positions 230/180/120 + i (a parked lane): pinned plan "
                  f"(L={L_b}) bit-identical to {B}-lane launches in {same}/"
                  f"{Q} candidate rows; the fold's own plan (L={L_f}) "
                  f"differs by up to {own_err:.3e} (a reading)", flush=True)
            if same != Q:
                fail(f"kernel 2's verify fold with the pinned plan differs "
                     f"from {B}-lane launches ({q_dt}/{kv_dt}, H={heads})")


def lse_yardstick(torch, calls: list) -> tuple:
    """(SDPA ms, bytes, flops) of one kernel-4 launch per stripe in
    ``calls`` (each the launch's arguments), summed over the stripes:
    SDPA over each stripe's owned keys gathered into a dense, masked (B,
    K, T*bs, D) cache (the gather itself is not timed; it gives o but no
    lse), and what the launches must move and compute
    (``roofline.paged_decode_lse_work``)."""
    import torch.nn.functional as F
    sdpa, n_bytes, flops = [], 0, 0
    for q, k_s, v_s, local, pos, owned in calls:
        (B, H, D), (T, bs, K) = q.shape, (local.shape[1],) + k_s.shape[1:3]
        keys_live = ((torch.arange(T * bs, device="cuda")[None, :]
                      <= pos[:, None])
                     & (owned != 0).repeat_interleave(bs, dim=1))
        kd = k_s[local.long()].reshape(B, T * bs, K, D).transpose(1, 2)
        vd = v_s[local.long()].reshape(B, T * bs, K, D).transpose(1, 2)
        sdpa.append((q[:, :, None], kd, vd, keys_live[:, None, None, :]))
        b, f, _ = kernel_work("paged_decode_attention_lse",
                              (q, k_s, v_s, local, pos, owned))
        n_bytes += b
        flops += f
    lib_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(
        qq, kd, vd, attn_mask=m) for qq, kd, vd, m in sdpa]) / len(calls)
    return lib_ms, n_bytes, flops


def check_lse(torch, gen, B=8, H=32, D=128, n_blocks=1028, stripes=(2, 4)):
    """Kernel 4 at kernel 2's phase-1 shapes (by default B=8, H=K=32,
    D=128; bs=16, T=128) over a pool of ``n_blocks`` blocks (a multiple
    of each count of ``stripes``) with scrambled tables across all of
    it, split into stripes: every stripe owns blocks of every lane.  Per
    stripe, (o, lse) against the plain version; the stripes'
    ``combine_lse`` against kernel 2 over the whole pool.  bf16 and
    f32-over-bf16 pairs.  Timed at 2 stripes, per launch: CUDA events
    around both stripes' launches, halved."""
    from repro_torch.kernels import paged_decode_attention as pa
    K, bs, T = H, 16, 128
    timed = None
    bf16, f32 = torch.bfloat16, torch.float32
    for name, q_dt, kv_dt in (("bf16", bf16, bf16), ("bf16", f32, bf16)):
        perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
        tables = perm[: B * T].reshape(B, T).to(torch.int32)
        pos = torch.randint(0, T * bs, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
        pos[0] = T * bs - 1
        q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=q_dt)
        kp, vp = (torch.randn(n_blocks, bs, K, D, generator=gen,
                              device="cuda", dtype=kv_dt) for _ in range(2))
        full = pa.paged_decode_attention(q, kp, vp, tables, pos)
        for shards in stripes:
            nb_loc = n_blocks // shards
            calls, os_, lses = [], [], []
            for r in range(shards):
                local = tables - r * nb_loc
                owned = ((local >= 0) & (local < nb_loc)).to(torch.int32)
                if not bool(owned.any(dim=1).all()):
                    fail(f"lse setup: stripe {r}/{shards} owns no block of "
                         f"some lane")
                args = (q, kp[r * nb_loc:(r + 1) * nb_loc],
                        vp[r * nb_loc:(r + 1) * nb_loc],
                        local.clamp(0, nb_loc - 1), pos, owned)
                o, lse = pa.paged_decode_attention_lse(*args)
                o_ref, lse_ref = pa.paged_decode_attention_lse_ref(*args)
                what = (f"paged_decode_attention_lse q={q_dt} pool={kv_dt} "
                        f"B={B} H={H} K={K} D={D} bs={bs} T={T} stripe "
                        f"{r}/{shards}")
                err = held(f"{what} o", o, o_ref, name)
                empty = lse_ref == -1e30
                lse_err = (lse - lse_ref)[~empty].abs().max().item()
                print(f"{what} lse: max_abs_err={lse_err:.3e} tol=1e-04, "
                      f"{int(empty.sum())} (lane, head) rows with no key",
                      flush=True)
                if not torch.equal(lse == -1e30, empty) or lse_err > 1e-4:
                    fail(f"{what} lse disagrees with its plain version")
                calls.append(args)
                os_.append(o)
                lses.append(lse)
            held(f"combine_lse of {shards} kernel-4 stripes vs "
                 f"paged_decode_attention q={q_dt} pool={kv_dt}",
                 pa.combine_lse(torch.stack(os_), torch.stack(lses)), full,
                 name)
            if shards == 2 and q_dt == torch.bfloat16:
                timed = (calls, err)
    calls, err = timed
    ms, lo, hi = spread_ms(lambda: [pa.paged_decode_attention_lse(*a)
                                    for a in calls], per=2)
    plain_ms = cuda_ms(lambda: [pa.paged_decode_attention_lse_ref(*a)
                                for a in calls]) / 2
    lib_ms, n_bytes, flops = lse_yardstick(torch, calls)
    bound, by = bound_of(n_bytes // 2, flops // 2, "bf16")
    print(f"paged_decode_attention_lse bf16 B={B} H={H} K={K} D={D}, 2 "
          f"stripes of {n_blocks // 2} blocks, per launch: kernel "
          f"{spread(ms, lo, hi)}, plain {plain_ms:.4f} ms, sdpa over the gathered owned keys "
          f"{lib_ms:.4f} ms (o only, no lse), bound {bound:.4f} ms ({by}: "
          f"{n_bytes // 2} B, {flops // 2} flop)", flush=True)
    return {"name": "paged_decode_attention_lse", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:180",
            "max_abs_err": err, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def lse_empty_stripe(torch, n_blocks: int) -> None:
    """Kernel 4 where a stripe owns no block of a lane: lane 1's table is
    blocks 1-128, all in stripe 0 at 2 and 4 stripes, so every other
    stripe must give that lane lse = -1e30 and o = 0 exactly (every split
    of its walk empty); the other lanes as in ``check_lse``.  Per stripe
    against the plain version, and the stripes merged against kernel 2,
    from a generator of its own."""
    from repro_torch.kernels import paged_decode_attention as pa
    B, H, K, D, bs, T = 8, 32, 32, 128, 16, 128
    g9 = torch.Generator(device="cuda").manual_seed(9)
    for name, q_dt, kv_dt in (("bf16", torch.bfloat16, torch.bfloat16),
                              ("bf16", torch.float32, torch.bfloat16)):
        perm = torch.randperm(n_blocks - 1, generator=g9, device="cuda") + 1
        tables = perm[: B * T].reshape(B, T).to(torch.int32)
        tables[1] = torch.arange(1, T + 1, dtype=torch.int32, device="cuda")
        pos = torch.randint(0, T * bs, (B,), generator=g9, device="cuda",
                            dtype=torch.int32)
        pos[0], pos[1] = T * bs - 1, 1000
        q = torch.randn(B, H, D, generator=g9, device="cuda", dtype=q_dt)
        kp, vp = (torch.randn(n_blocks, bs, K, D, generator=g9,
                              device="cuda", dtype=kv_dt) for _ in range(2))
        for shards in (2, 4):
            nb_loc = n_blocks // shards
            os_, lses = [], []
            for r in range(shards):
                local = tables - r * nb_loc
                owned = ((local >= 0) & (local < nb_loc)).to(torch.int32)
                args = (q, kp[r * nb_loc:(r + 1) * nb_loc],
                        vp[r * nb_loc:(r + 1) * nb_loc],
                        local.clamp(0, nb_loc - 1), pos, owned)
                o, lse = pa.paged_decode_attention_lse(*args)
                o_ref, lse_ref = pa.paged_decode_attention_lse_ref(*args)
                what = (f"paged_decode_attention_lse q={q_dt} pool={kv_dt} "
                        f"stripe {r}/{shards}, lane 1 owned by stripe 0 only")
                held(f"{what} o", o, o_ref, name)
                empty = lse_ref == -1e30
                if bool(empty[1].all()) != (r > 0):
                    fail(f"{what}: setup, lane 1's rows empty "
                         f"{bool(empty[1].all())}")
                lse_err = ((lse - lse_ref)[~empty].abs().max().item()
                           if bool((~empty).any()) else 0.0)
                if (not torch.equal(lse == -1e30, empty) or lse_err > 1e-4
                        or not bool((o[empty] == 0).all())):
                    fail(f"{what}: lse or the empty rows' o disagree (lse "
                         f"err {lse_err:.3e})")
                print(f"{what}: lse max_abs_err={lse_err:.3e} tol=1e-04, "
                      f"{int(empty.sum())} (lane, head) rows with no key: "
                      f"lse -1e30 and o 0 exactly", flush=True)
                os_.append(o)
                lses.append(lse)
            held(f"combine_lse of {shards} kernel-4 stripes (lane 1 in "
                 f"stripe 0 only) vs paged_decode_attention q={q_dt}",
                 pa.combine_lse(torch.stack(os_), torch.stack(lses)),
                 pa.paged_decode_attention(q, kp, vp, tables, pos), name)


def held(label: str, got, want, name: str) -> float:
    """Compare a kernel's output with its plain version's; fail outside
    ``TOL``/``REL_TOL`` of the lowest input precision ``name``."""
    err, rel = compare(got, want)
    ok = err <= TOL[name] and rel <= REL_TOL[name]
    print(f"{label}: max_abs_err={err:.3e} tol={TOL[name]:.0e} "
          f"rel_err={rel:.3e} rel_tol={REL_TOL[name]:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return err


def _pairs(torch):
    """(tolerance name, q dtype, cache dtype): the three pairs each kernel
    is built for; f32 over bf16 is the f32 plan over the serving pool."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [("bf16", bf16, bf16), ("f32", f32, f32), ("bf16", f32, bf16)]


def prefill_yardstick(torch, q, kp, vp, tables, starts) -> tuple:
    """(SDPA ms, bytes, flops) of one kernel-3 call: SDPA with a boolean
    mask over the same keys gathered into a dense (B, K, T*bs, D) cache
    (the gather itself is not timed), and what the call must move and
    compute (``roofline.paged_prefill_work``)."""
    import torch.nn.functional as F
    B, C, H, D = q.shape
    bs, K = kp.shape[1], kp.shape[2]
    T = tables.shape[1]
    kd = kp[tables].reshape(B, T * bs, K, D).transpose(1, 2)
    vd = vp[tables].reshape(B, T * bs, K, D).transpose(1, 2)
    qpos = starts[:, None] + torch.arange(C, device="cuda")[None, :]
    mask = (torch.arange(T * bs, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask))
    n_bytes, flops, _ = kernel_work("paged_prefill_attention",
                                    (q, kp, vp, tables, starts))
    return lib_ms, n_bytes, flops


def check_prefill(torch, gen, heads=((32, 32), (64, 8)), chunks=(16, 128),
                  D=128):
    """Kernel 3 at the chunked path's shapes: 4 lanes, T = 128 blocks of
    16 (max_seq 2048), each (H, K) of ``heads`` and chunk of ``chunks``;
    the first heads' largest chunk timed in bf16.  Lane 0 starts at 0,
    lane 1 past 1024, lane 2 mid-table, and lane 3 is a padded row (table
    of zeros, start 0) as the engine's row bucket adds; the engine's
    ragged rows (lengths < C) differ only in which outputs it reads."""
    from repro_torch.kernels import paged_prefill_attention as ppa
    B, bs, T = 4, 16, 128
    timed = None
    for name, q_dt, kv_dt in _pairs(torch):
        for H, K in heads:
            for C in chunks:
                n_blocks = 1 + B * T
                perm = torch.randperm(n_blocks - 1, generator=gen,
                                      device="cuda") + 1
                tables = perm[: B * T].reshape(B, T).to(torch.int32)
                tables[3] = 0
                starts = torch.tensor([0, 1100, 515, 0], dtype=torch.int32,
                                      device="cuda")
                q = torch.randn(B, C, H, D, generator=gen, device="cuda",
                                dtype=q_dt)
                kp = torch.randn(n_blocks, bs, K, D, generator=gen,
                                 device="cuda", dtype=kv_dt)
                vp = torch.randn(n_blocks, bs, K, D, generator=gen,
                                 device="cuda", dtype=kv_dt)
                args = (q, kp, vp, tables, starts)
                err = held(f"paged_prefill_attention q={q_dt} pool={kv_dt} "
                           f"B={B} C={C} H={H} K={K} D={D} bs={bs} T={T} "
                           f"starts={starts.tolist()}",
                           ppa.paged_prefill_attention(*args),
                           ppa.paged_prefill_attention_ref(*args), name)
                if (q_dt, kv_dt, H, C) == (torch.bfloat16, torch.bfloat16,
                                           heads[0][0], chunks[-1]):
                    timed = (args, err)
    (q, kp, vp, tables, starts), err = timed
    C, H, K = q.shape[1], q.shape[2], kp.shape[2]
    ms, lo, hi = spread_ms(lambda: ppa.paged_prefill_attention(
        q, kp, vp, tables, starts))
    plain_ms = cuda_ms(lambda: ppa.paged_prefill_attention_ref(
        q, kp, vp, tables, starts))
    lib_ms, n_bytes, flops = prefill_yardstick(torch, *timed[0])
    st = [int(x) for x in starts.tolist()]
    bound, by = bound_of(n_bytes, flops, "bf16")
    print(f"paged_prefill_attention bf16 B={B} C={C} H={H} K={K} D={D} "
          f"starts={st}: kernel {spread(ms, lo, hi)}, plain {plain_ms:.4f} "
          f"ms, "
          f"sdpa-dense {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
          f"{n_bytes} B, {flops} flop)", flush=True)
    return {"name": "paged_prefill_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_prefill_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:255",
            "max_abs_err": err, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def prefill_lse_yardstick(torch, calls: list) -> tuple:
    """(SDPA ms, bytes, flops) of one launch of kernel 3's owned/LSE form
    per stripe in ``calls`` (each the launch's arguments), summed over the
    stripes: SDPA over each stripe's owned keys gathered into a dense,
    masked (B, K, T*bs, D) cache (the gather itself is not timed; it
    gives o but no lse), and what the launches must move and compute
    (``roofline.paged_prefill_lse_work``)."""
    import torch.nn.functional as F
    sdpa, n_bytes, flops = [], 0, 0
    for q, k_s, v_s, local, starts, owned in calls:
        B, C, H, D = q.shape
        T, (bs, K) = local.shape[1], k_s.shape[1:3]
        kpos = torch.arange(T * bs, device="cuda")
        qpos = starts[:, None] + torch.arange(C, device="cuda")[None, :]
        own = (owned != 0).repeat_interleave(bs, dim=1)          # (B, T*bs)
        sees = (kpos[None, None, :] <= qpos[:, :, None]) & own[:, None, :]
        kd = k_s[local.long()].reshape(B, T * bs, K, D).transpose(1, 2)
        vd = v_s[local.long()].reshape(B, T * bs, K, D).transpose(1, 2)
        sdpa.append((q.transpose(1, 2), kd, vd, sees[:, None]))
        b, f, _ = kernel_work("paged_prefill_attention_lse",
                              (q, k_s, v_s, local, starts, owned))
        n_bytes += b
        flops += f
    lib_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(
        qq, kd, vd, attn_mask=m) for qq, kd, vd, m in sdpa]) / len(calls)
    return lib_ms, n_bytes, flops


def check_prefill_lse(torch, gen, H=32, D=128, stripes=(2, 4),
                      label="llama2-7b", timed_stripes=2):
    """Kernel 3's owned/LSE form at the chunked path's shape (4 lanes, a
    chunk of 128, tables of 128 blocks of 16, H = K heads of D) over a
    pool of 516 blocks split into ``stripes`` stripes, in every dtype pair.
    Lane 0 starts at 0 and lane 2 at 515 over scrambled tables (their
    chunks' keys span the stripes); lane 1 starts at 1100 over blocks
    1-128, all in stripe 0, so every other stripe owns none of its keys
    (o 0 and lse -1e30 exactly); lane 3 is a padded row.  Per stripe,
    (o, lse) against the plain version; the stripes' ``combine_lse``
    against kernel 3 over the whole pool; each bf16 launch on the tensor
    cores.  Timed in bf16 at ``timed_stripes`` stripes per launch (both
    stripes' launches, halved) beside the plain version, SDPA over each
    stripe's owned keys and the bound."""
    from repro_torch.kernels import paged_decode_attention as pa
    from repro_torch.kernels import paged_prefill_attention as ppa
    B, C, K, bs, T, n_blocks = 4, 128, H, 16, 128, 516
    timed = None
    for name, q_dt, kv_dt in _pairs(torch):
        perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
        tables = perm[: B * T].reshape(B, T).to(torch.int32)
        tables[1] = torch.arange(1, T + 1, dtype=torch.int32, device="cuda")
        tables[3] = 0
        starts = torch.tensor([0, 1100, 515, 0], dtype=torch.int32,
                              device="cuda")
        q = torch.randn(B, C, H, D, generator=gen, device="cuda", dtype=q_dt)
        kp, vp = (torch.randn(n_blocks, bs, K, D, generator=gen,
                              device="cuda", dtype=kv_dt) for _ in range(2))
        full = ppa.paged_prefill_attention(q, kp, vp, tables, starts)
        for shards in stripes:
            nb_loc = n_blocks // shards
            calls, os_, lses = [], [], []
            for r in range(shards):
                local = tables - r * nb_loc
                owned = ((local >= 0) & (local < nb_loc)).to(torch.int32)
                args = (q, kp[r * nb_loc:(r + 1) * nb_loc],
                        vp[r * nb_loc:(r + 1) * nb_loc],
                        local.clamp(0, nb_loc - 1), starts, owned)
                before = ppa.paged_prefill_attention_lse.tensor_core
                o, lse = ppa.paged_prefill_attention_lse(*args)
                if ppa.paged_prefill_attention_lse.tensor_core != \
                        before + (q_dt == torch.bfloat16):
                    fail(f"paged_prefill_attention_lse q={q_dt}: the launch "
                         f"did not take the route of its dtype")
                o_ref, lse_ref = ppa.paged_prefill_attention_lse_ref(*args)
                what = (f"paged_prefill_attention_lse ({label}) q={q_dt} "
                        f"pool={kv_dt} B={B} C={C} H={H} K={K} D={D} bs={bs} "
                        f"T={T} starts={starts.tolist()} stripe {r}/{shards}")
                err = held(f"{what} o", o, o_ref, name)
                empty = lse_ref == -1e30
                lse_err = ((lse - lse_ref)[~empty].abs().max().item()
                           if bool((~empty).any()) else 0.0)
                if bool(empty[1].all()) != (r > 0):
                    fail(f"{what}: setup, lane 1's rows empty "
                         f"{bool(empty[1].all())}")
                print(f"{what} lse: max_abs_err={lse_err:.3e} tol=1e-04, "
                      f"{int(empty.sum())} (lane, token, head) rows with no "
                      f"key: lse -1e30 and o 0 exactly", flush=True)
                if (not torch.equal(lse == -1e30, empty) or lse_err > 1e-4
                        or not bool((o[empty] == 0).all())):
                    fail(f"{what}: lse or the empty rows' o disagree with "
                         f"the plain version")
                calls.append(args)
                os_.append(o)
                lses.append(lse)
            held(f"combine_lse of {shards} stripes of paged_prefill_"
                 f"attention_lse ({label}) vs paged_prefill_attention "
                 f"q={q_dt} pool={kv_dt}",
                 pa.combine_lse(torch.stack(os_), torch.stack(lses)), full,
                 name)
            if shards == timed_stripes and q_dt == torch.bfloat16:
                timed = (calls, err)
    calls, err = timed
    n = len(calls)
    ms, lo, hi = spread_ms(lambda: [ppa.paged_prefill_attention_lse(*a)
                                    for a in calls], per=n)
    plain_ms = cuda_ms(lambda: [ppa.paged_prefill_attention_lse_ref(*a)
                                for a in calls]) / n
    lib_ms, n_bytes, flops = prefill_lse_yardstick(torch, calls)
    bound, by = bound_of(n_bytes // n, flops // n, "bf16")
    L, splits = ppa.paged_prefill_split_plan(B, C, H, K, T, bs)
    print(f"paged_prefill_attention_lse ({label}) bf16 B={B} C={C} H={H} "
          f"K={K} D={D}, {n} stripes of {n_blocks // n} blocks, owned walks "
          f"split in {splits} pieces of {L} keys, per launch: "
          f"kernel {spread(ms, lo, hi)}, plain {plain_ms:.4f} ms, sdpa over "
          f"the gathered owned keys {lib_ms:.4f} ms (o only, no lse), bound "
          f"{bound:.4f} ms ({by}: {n_bytes // n} B, {flops // n} flop)",
          flush=True)
    return {"name": "paged_prefill_attention_lse", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_prefill_attention_lse.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:255",
            "max_abs_err": err, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def check_prefill_head_dims(torch) -> None:
    """Kernel 3 at every head dim kernel 1 takes, in every dtype pair, at
    G = 4 (8/2 heads) and granite's G = 3 (24/8), a chunk of 40 over
    blocks of 16 with one lane at 0, one at 100 and a padded lane, from a
    generator of its own; each bf16 launch on the tensor cores, each f32
    one on the CUDA cores."""
    from repro_torch.kernels import paged_prefill_attention as ppa
    g = torch.Generator(device="cuda").manual_seed(19)
    B, C, bs, T = 3, 40, 16, 12
    for name, q_dt, kv_dt in _pairs(torch):
        for D in ppa._HEAD_DIMS:
            for H, K in ((8, 2), (24, 8)):
                n_blocks = 1 + B * T
                tables = (torch.randperm(n_blocks - 1, generator=g,
                                         device="cuda") + 1)[: B * T]
                tables = tables.reshape(B, T).to(torch.int32)
                tables[-1] = 0
                starts = torch.tensor([0, 100, 0], dtype=torch.int32,
                                      device="cuda")
                q = torch.randn(B, C, H, D, generator=g, device="cuda",
                                dtype=q_dt)
                kp, vp = (torch.randn(n_blocks, bs, K, D, generator=g,
                                      device="cuda", dtype=kv_dt)
                          for _ in range(2))
                args = (q, kp, vp, tables, starts)
                before = ppa.paged_prefill_attention.tensor_core
                o = ppa.paged_prefill_attention(*args)
                if ppa.paged_prefill_attention.tensor_core != \
                        before + (q_dt == torch.bfloat16):
                    fail(f"paged_prefill_attention q={q_dt} D={D}: the "
                         f"launch did not take the route of its dtype (bf16: "
                         f"tensor cores, f32: CUDA cores)")
                held(f"paged_prefill_attention q={q_dt} pool={kv_dt} B={B} "
                     f"C={C} H={H} K={K} D={D} bs={bs} T={T} starts "
                     f"[0, 100, padded]", o,
                     ppa.paged_prefill_attention_ref(*args), name)


def check_head_dim_256(torch) -> None:
    """Kernels 1-5 at gemma-7b's served heads (16/16 of D = 256) through
    phase 1's checks, from a generator of their own: each held against its
    plain version in every dtype pair it is built for, and timed in bf16
    beside its plain version, a PyTorch library call and the bound.
    Kernel 1: a prefill bucket (B = 4, S = 256) causal; kernel 2: 4 lanes
    over tables of 128 blocks of 16; kernel 3: a chunk of 128 at starts
    0/1100/515 and a padded lane; kernel 4: 4 lanes at 2 stripes of a
    516-block pool; kernel 5: 4 slots of 2048; kernel 3's owned/LSE form
    as ``check_prefill_lse`` at 2 and 4 stripes.  Readings, not entries of
    the kernels line."""
    g = torch.Generator(device="cuda").manual_seed(25)
    check_flash(torch, {"bf16": torch.bfloat16, "f32": torch.float32}, g,
                shapes=[(g, 16, 16, 256, 256, " (gemma-7b)")])
    check_paged(torch, g, B=4, D=256, cases=[
        (name, 16, 16, q_dt, kv_dt) for name, q_dt, kv_dt in _pairs(torch)])
    check_prefill(torch, g, heads=((16, 16),), chunks=(128,), D=256)
    check_lse(torch, g, B=4, H=16, D=256, n_blocks=516, stripes=(2,))
    check_dense(torch, g, heads=((16, 16),), lengths=(2048,), D=256)
    check_prefill_lse(torch, g, H=16, D=256, label="gemma-7b")


def check_dense(torch, gen, heads=((32, 32), (64, 8)), lengths=(2048, 1000),
                D=128):
    """Kernel 5 at the slot path's shapes: 4 slots of max_seq 2048, and a
    cache length of 1000 that is not a multiple of a split.  One lane at
    the last position, one parked at 0, two ragged.  Held against
    ``flash_decode_ref``, the plain version of the slot model path (what
    the dispatcher takes on the CPU).  Each (H, K) of ``heads`` and cache
    length of ``lengths``; the first of each timed in bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    B = 4
    timed = None
    for name, q_dt, kv_dt in _pairs(torch):
        for H, K in heads:
            for S in lengths:
                pos = torch.randint(0, S, (B,), generator=gen, device="cuda",
                                    dtype=torch.int32)
                pos[0], pos[3] = S - 1, 0
                q = torch.randn(B, H, D, generator=gen, device="cuda",
                                dtype=q_dt)
                k = torch.randn(B, S, K, D, generator=gen, device="cuda",
                                dtype=kv_dt)
                v = torch.randn(B, S, K, D, generator=gen, device="cuda",
                                dtype=kv_dt)
                args = (q, k, v, pos)
                err = held(f"decode_attention q={q_dt} cache={kv_dt} B={B} "
                           f"H={H} K={K} D={D} S={S} "
                           f"positions={pos.tolist()}",
                           da.decode_attention(*args),
                           da.flash_decode_ref(*args), name)
                if (q_dt, kv_dt, H, S) == (torch.bfloat16, torch.bfloat16,
                                           heads[0][0], lengths[0]):
                    timed = (args, err)
    (q, k, v, pos), err = timed
    H, S, K = q.shape[1], k.shape[1], k.shape[2]
    ms, lo, hi = spread_ms(lambda: da.decode_attention(q, k, v, pos))
    plain_ms = cuda_ms(lambda: da.flash_decode_ref(q, k, v, pos))
    # yardstick: SDPA with a boolean mask over the cache's (B, K, S, D)
    # transposed view
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask))
    n_bytes, flops, peak = kernel_work("decode_attention", (q, k, v, pos))
    keys = flops // (4 * D * H)
    bound, by = bound_of(n_bytes, flops, peak)
    dev = device_ms(torch, lambda: da.decode_attention(q, k, v, pos))
    print(f"decode_attention bf16 B={B} H={H} K={K} D={D} S={S} "
          f"keys={keys}: kernel {spread(ms, lo, hi)}, device {dev:.4f} ms "
          f"(20 calls held back to back), plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}: {n_bytes} B, "
          f"{flops} flop)", flush=True)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:70",
            "max_abs_err": err, "ms": ms, "ms_min": lo, "ms_max": hi,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def check_ring(torch) -> None:
    """Kernel 5 over hymba's ring: a reading beside its plain version and
    SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    B = 4
    # hymba-1.5b's ring (4 slots, 25/5 heads, D=64, W=1024), positions
    # clamped to the ring's last slot as the model clamps them, against the
    # ring decode's plain version (o rounded to the ring's dtype), from a
    # generator of its own
    g9 = torch.Generator(device="cuda").manual_seed(9)
    ring_pos = torch.tensor([1990, 1400, 1000, 200], dtype=torch.int32,
                            device="cuda")
    clamped = ring_pos.clamp(max=1023)
    for name, q_dt, kv_dt in _pairs(torch):
        qr = torch.randn(B, 25, 64, generator=g9, device="cuda", dtype=q_dt)
        kr, vr = (torch.randn(B, 1024, 5, 64, generator=g9, device="cuda",
                              dtype=kv_dt) for _ in range(2))
        held(f"decode_attention over a ring q={q_dt} cache={kv_dt} B={B} "
             f"H=25 K=5 D=64 W=1024 positions {ring_pos.tolist()} clamped "
             f"to {clamped.tolist()} (hymba)",
             da.decode_attention(qr, kr, vr, clamped),
             da.swa_decode_ref(qr, kr, vr, clamped), name)
        if q_dt == kv_dt == torch.bfloat16:
            ring = (qr, kr, vr)
    qr, kr, vr = ring
    keys = int((clamped.long() + 1).sum().item())
    r_bound, r_by = bound_of(*kernel_work("decode_attention",
                                          (qr, kr, vr, clamped)))
    ring_ms = spread_ms(lambda: da.decode_attention(qr, kr, vr, clamped))
    ring_plain = cuda_ms(lambda: da.swa_decode_ref(qr, kr, vr, clamped))
    # yardstick: SDPA over the ring's (B, K, W, D) transposed view with a
    # mask of the live slots, the 5 KV heads shared by 25 query heads
    rmask = (torch.arange(1024, device="cuda")[None, :]
             <= clamped[:, None])[:, None, None, :]
    ring_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qr[:, :, None], kr.transpose(1, 2), vr.transpose(1, 2),
        attn_mask=rmask, enable_gqa=True))
    ring_dev = device_ms(torch, lambda: da.decode_attention(qr, kr, vr,
                                                            clamped))
    print(f"reading: decode_attention over hymba's ring bf16 B={B} H=25 K=5 "
          f"D=64 W=1024 keys={keys}: kernel {spread(*ring_ms)}, device "
          f"{ring_dev:.4f} ms (20 calls held back to back), plain "
          f"{ring_plain:.4f} ms, sdpa {ring_lib:.4f} ms, bound "
          f"{r_bound:.4f} ms ({r_by})", flush=True)


def held_scaled(label: str, got, want, name: str) -> float:
    """``held`` for outputs that grow with the data: the max abs error over
    max |plain| against ``TOL``, the error norm over the plain norm against
    ``REL_TOL``.  Returns the max abs error."""
    err, rel = compare(got, want)
    scale = max(want.float().abs().max().item(), 1.0)
    ok = err <= TOL[name] * scale and rel <= REL_TOL[name]
    print(f"{label}: max_abs_err={err:.3e} max|plain|={scale:.3e} "
          f"err/max={err / scale:.3e} tol={TOL[name]:.0e} rel_err={rel:.3e} "
          f"rel_tol={REL_TOL[name]:.0e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return err


def _wkv_inputs(torch, gen, B, T, H, D, dt, zero_state):
    """r/k/v in ``dt``; w = exp(-exp(dw)) around rwkv6-3b's init decay
    (dw = -6 + N(0, 1)); u and s0 f32 (s0 None: a zero state)."""
    r, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda",
                           dtype=dt) for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + torch.randn(B, T, H, D, generator=gen,
                                                 device="cuda")))
    u = 0.1 * torch.randn(H, D, generator=gen, device="cuda")
    s0 = None if zero_state else torch.randn(B, H, D, D, generator=gen,
                                             device="cuda")
    return r, k, v, w, u, s0


def wkv_grid(wkv, B: int, T: int, H: int, D: int) -> str:
    """``wkv_plan``'s launch shape of one call, as printed."""
    jc, q = wkv.wkv_plan(B, H, D)
    return (f"plan JC={jc} Q={q}: {B * H * (D // jc)} CTAs of {jc * q} + 32 "
            f"threads")


def check_wkv(torch, gen):
    """Kernel 7 at rwkv6-3b's serving shapes (H=40, D=64): a slot decode
    step (4 slots, T=1, from a random state), a prefill (B=1, T=200, zero
    state) and a ragged T=37, with f32 and with bf16 r/k/v (w, u and the
    state are f32 in both); then state carry: 120 + 80 steps against 200,
    and eight one-step calls written over their own state against the
    plain version's one call of eight; then the decode and prefill shapes
    at head dims 48 and 96.  Each line names ``wkv_plan``'s grid.

    The state sums ~1/(1 - w) steps (~400 at the init decay), so |y|
    reaches the hundreds and an absolute f32 bound of 1e-4 would measure
    summation order, not defects: y and the state are held by their max
    abs error over max |plain| and their error norm over the plain norm
    (``held_scaled``)."""
    from repro_torch.kernels import rwkv6_wkv as wkv
    H, D = 40, 64
    timed = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for label, B, T, zero in (("decode", 4, 1, False),
                                  ("prefill", 1, 200, True),
                                  ("ragged", 2, 37, False)):
            args = _wkv_inputs(torch, gen, B, T, H, D, dt, zero)
            y, s = wkv.rwkv6_wkv(*args)
            y_ref, s_ref = wkv.rwkv6_wkv_ref(*args)
            what = (f"rwkv6_wkv {label} r/k/v={dt} B={B} T={T} H={H} D={D} "
                    f"s0={'zero' if zero else 'random'} "
                    f"{wkv_grid(wkv, B, T, H, D)}")
            err = held_scaled(f"{what} y", y, y_ref, name)
            held_scaled(f"{what} state", s, s_ref, "f32")
            if name == "bf16":
                timed[label] = (args, err)
        r, k, v, w, u, _ = _wkv_inputs(torch, gen, 1, 200, H, D, dt, True)
        y, s = wkv.rwkv6_wkv(r, k, v, w, u)
        y1, s1 = wkv.rwkv6_wkv(r[:, :120], k[:, :120], v[:, :120],
                               w[:, :120], u)
        y2, s2 = wkv.rwkv6_wkv(r[:, 120:], k[:, 120:], v[:, 120:],
                               w[:, 120:], u, s1)
        what = f"rwkv6_wkv carry r/k/v={dt} 120 + 80 steps vs 200"
        held_scaled(f"{what} y", torch.cat([y1, y2], 1), y, name)
        held_scaled(f"{what} state", s2, s, "f32")
        state = torch.zeros(1, H, D, D, device="cuda")
        ys = [wkv.rwkv6_wkv(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                            w[:, t:t + 1], u, state, s_out=state)[0]
              for t in range(8)]
        y8, s8 = wkv.rwkv6_wkv_ref(r[:, :8], k[:, :8], v[:, :8], w[:, :8], u)
        what = (f"rwkv6_wkv in place r/k/v={dt} 8 one-step calls vs plain "
                f"T=8")
        held_scaled(f"{what} y", torch.cat(ys, 1), y8, name)
        held_scaled(f"{what} state", state, s8, "f32")
    # the head dims rwkv6-3b does not use, at its decode and prefill shapes
    # (from a generator of their own: the inputs above stay as they were)
    gen_d = torch.Generator(device="cuda").manual_seed(48)
    for Dx in (48, 96):
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for label, B, T, zero in (("decode", 4, 1, False),
                                      ("prefill", 1, 200, True)):
                args = _wkv_inputs(torch, gen_d, B, T, H, Dx, dt, zero)
                y, s = wkv.rwkv6_wkv(*args)
                y_ref, s_ref = wkv.rwkv6_wkv_ref(*args)
                what = (f"rwkv6_wkv {label} r/k/v={dt} B={B} T={T} H={H} "
                        f"D={Dx} {wkv_grid(wkv, B, T, H, Dx)}")
                held_scaled(f"{what} y", y, y_ref, name)
                held_scaled(f"{what} state", s, s_ref, "f32")
    rows = {}
    for label, ((r, k, v, w, u, s0), err) in timed.items():
        B, T = r.shape[:2]
        if s0 is None:
            call = lambda: wkv.rwkv6_wkv(r, k, v, w, u)  # noqa: E731
            plain_ms = cuda_ms(lambda: wkv.rwkv6_wkv_ref(r, k, v, w, u),
                               iters=5, warmup=1)
        else:   # the slot decode's call: the state written in place
            call = lambda: wkv.rwkv6_wkv(r, k, v, w, u, s0,  # noqa: E731
                                         s_out=s0)
            plain_ms = cuda_ms(lambda: wkv.rwkv6_wkv_ref(r, k, v, w, u, s0,
                                                         s_out=s0))
        # the kernel's own time on the card; CUDA events around back-to-back
        # wrapper calls also time the wrapper's host work where that is longer
        ms = device_ms(torch, call)
        call_ms = cuda_ms(call)
        n_bytes, flops, peak = kernel_work("rwkv6_wkv", (r, k, v, w, u, s0))
        bound, by = bound_of(n_bytes, flops, peak)
        rows[label] = (ms, call_ms, plain_ms, bound, by, err)
        print(f"rwkv6_wkv {label} bf16 r/k/v B={B} T={T} H={H} D={D}: "
              f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms per "
              f"back-to-back wrapper call, CUDA events), plain "
              f"{plain_ms:.4f} ms, library none (no single PyTorch call "
              f"computes the recurrence), bound {bound:.5f} ms ({by}: "
              f"{n_bytes} B, {flops} flop)", flush=True)
    # the line's entry is the decode shape's: 32 of the path's launches
    # per decode step against 32 per request's prefill.  Its ms is the
    # device time of calls held back to back on the card (``device_ms``),
    # where the other kernels' is CUDA events around back-to-back calls;
    # call_ms is this kernel's by that measure (its wrapper's host work,
    # longer than the kernel)
    ms, call_ms, plain_ms, bound, by, err = rows["decode"]
    return {"name": "rwkv6_wkv", "route": "cuda",
            "source": "src/repro_torch/csrc/rwkv6_wkv.cu",
            "replaces": "src/repro/kernels/rwkv6_wkv.py:52",
            "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


INT8_SHAPES = [(128, 256, 128), (256, 512, 256),     # the reference's tests
               (256, 1536, 512), (256, 512, 1536),   # granite's experts at
               #                                       a prefill bucket's
               #                                       capacity of 256 rows
               (200, 1536, 520),                     # ragged (byte staging)
               (4096, 4096, 4096)]                   # for the rate


def check_int8(torch, gen):
    """Kernel 6 against its plain version, bit for bit (integer sums are
    exact and the f32 epilogue is the same sequence of operations), at
    ``INT8_SHAPES`` in both output types, each with ``int8_split_plan``'s
    grid and the route its launch took (failing unless 4096^3 ran whole
    and (256, 1536, 512) split over K; the ``wgmma`` counter equals the
    launches by construction, the kernel having no other route, so only
    the split half of the route tells anything); ``ops.int8_matmul_quantized``
    on f32 operands against quantize + plain (bit-exact) and against the
    f32 GEMM (relative error < 0.02, the reference's
    ``test_int8_quantized_matmul_error_bound``).  Each shape timed with
    bf16 output: the kernel's device time, plain, bound, and the yardstick
    ``torch._int_mm`` (cuBLASLt's int8 GEMM) plus the same scale epilogue,
    by its device time.  The line's entry is granite's gate/up shape (256,
    1536, 512), the path's."""
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ops
    rows, errs, routes = {}, {}, {}
    for M, K, N in INT8_SHAPES:
        x_q = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.int8)
        w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.int8)
        sx = 0.01 + 0.09 * torch.rand(M, 1, generator=gen, device="cuda")
        sw = 0.01 + 0.09 * torch.rand(1, N, generator=gen, device="cuda")
        args = (x_q, w_q, sx, sw)
        splits, k_split = i8.int8_split_plan(M, N, K)
        for dt in (torch.bfloat16, torch.float32):
            before = (i8.int8_matmul.wgmma, i8.int8_matmul.split)
            got = i8.int8_matmul(*args, out_dtype=dt)
            route = ("wgmma" if i8.int8_matmul.wgmma > before[0] else "none") \
                + (", split-K" if i8.int8_matmul.split > before[1] else "")
            routes[(M, K, N)] = route
            print(f"int8_matmul M={M} K={K} N={N} out={dt}: plan splits="
                  f"{splits} k_split={k_split} (grid {-(-N // 128)} x "
                  f"{-(-M // 128)} x {splits} CTAs), route {route}",
                  flush=True)
            want = i8.int8_matmul_ref(*args, out_dtype=dt)
            err = (got.float() - want.float()).abs().max().item()
            same = torch.equal(got, want)
            errs[(M, K, N)] = max(errs.get((M, K, N), 0.0), err)
            print(f"int8_matmul M={M} K={K} N={N} out={dt}: bit-exact="
                  f"{same} max_abs_err={err:.3e} tol=0 "
                  f"{'ok' if same else 'FAIL'}", flush=True)
            if not same:
                fail(f"int8_matmul M={M} K={K} N={N} {dt} is not bit-exact "
                     f"against its plain version")
        # the kernel's own time on the card (``device_ms``), beside CUDA
        # events around back-to-back wrapper calls, which at the small
        # shapes time the wrapper's host work
        ms = device_ms(torch, lambda: i8.int8_matmul(*args))
        call_ms = cuda_ms(lambda: i8.int8_matmul(*args))
        plain_ms = cuda_ms(lambda: i8.int8_matmul_ref(*args), iters=5,
                           warmup=1)

        def library():
            return (torch._int_mm(x_q, w_q).float() * sx * sw).to(
                torch.bfloat16)
        try:
            if not torch.equal(library(), want.to(torch.bfloat16)):
                print(f"  torch._int_mm at M={M} K={K} N={N} differs from "
                      f"the plain version (a reading)", flush=True)
            # device time of every kernel of the call: the GEMM and the
            # epilogue's elementwise passes; the GEMM alone beside it
            lib_ms = device_ms(torch, library)
            lib_call_ms = cuda_ms(library)
            mm_ms = device_ms(torch, lambda: torch._int_mm(x_q, w_q))
            lib = (f"{lib_ms:.4f} ms on the device ({lib_call_ms:.4f} ms "
                   f"CUDA events; the GEMM alone {mm_ms:.4f} ms)")
        except RuntimeError as e:          # shapes cuBLASLt does not take
            lib_ms, lib = None, f"n/a ({e})"
        n_bytes, n_ops, peak = R.int8_matmul_work(M, K, N, torch.bfloat16)
        bound, by = bound_of(n_bytes, n_ops, peak)
        rows[(M, K, N)] = (ms, call_ms, plain_ms, bound, by, lib_ms)
        print(f"int8_matmul bf16-out M={M} K={K} N={N}: kernel {ms:.4f} ms "
              f"on the device ({n_ops / ms / 1e9:.1f} TOPS; {call_ms:.4f} "
              f"ms per back-to-back wrapper call, CUDA events), plain "
              f"{plain_ms:.4f} ms, torch._int_mm + scales {lib}, bound "
              f"{bound:.5f} ms ({by}: {n_bytes} B, {n_ops} int8 ops)",
              flush=True)
    # the routes the plan is for: the square GEMM (256 output tiles) whole,
    # granite's gate/up shape (8 output tiles) split over K; "wgmma" is in
    # both because every launch counts there (the kernel's one route)
    for shape, need in (((4096, 4096, 4096), "wgmma"),
                        ((256, 1536, 512), "wgmma, split-K")):
        ok = routes[shape] == need
        print(f"int8_matmul M, K, N = {shape}: route {routes[shape]}, need "
              f"{need} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"int8_matmul {shape} took {routes[shape]}, not {need}")
    x = torch.randn(128, 256, generator=gen, device="cuda")
    w = torch.randn(256, 128, generator=gen, device="cuda")
    got = ops.int8_matmul_quantized(x, w)
    same = torch.equal(got, i8.int8_matmul_quantized_ref(x, w))
    ref = x @ w
    rel = ((got.float() - ref).abs().mean() / ref.abs().mean()).item()
    print(f"int8_matmul_quantized f32 128x256 @ 256x128: bit-exact against "
          f"quantize + plain={same}, mean relative error against the f32 "
          f"GEMM {rel:.4e} (< 0.02) {'ok' if same and rel < 0.02 else 'FAIL'}",
          flush=True)
    if not same or rel >= 0.02:
        fail("int8_matmul_quantized disagrees")
    # ms and library_ms are device times (``device_ms``), call_ms CUDA
    # events around back-to-back wrapper calls, as for kernel 7
    ms, call_ms, plain_ms, bound, by, lib_ms = rows[(256, 1536, 512)]
    return {"name": "int8_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/int8_matmul.cu",
            "replaces": "src/repro/kernels/int8_matmul.py:41",
            "max_abs_err": errs[(256, 1536, 512)], "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# phase 2: full-width llama2-7b through the Engine
# ---------------------------------------------------------------------------

def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name (kernels 1's and 7's
    training forms and backward kernels too); each counts its launches
    (kernel 1's also those of its window form that band, ``banded``, those
    of its bidirectional form, ``bidirectional``, and kernels 1's and 3's
    those that took the tensor cores, ``tensor_core``: every bf16
    launch)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import paged_decode_attention as pa
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import rwkv6_wkv as wkv
    return {"flash_attention": fa.flash_attention,
            "flash_attention_lse": fa.flash_attention_lse,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "paged_decode_attention": pa.paged_decode_attention,
            "paged_decode_attention_lse": pa.paged_decode_attention_lse,
            "paged_prefill_attention": ppa.paged_prefill_attention,
            "paged_prefill_attention_lse": ppa.paged_prefill_attention_lse,
            "decode_attention": da.decode_attention,
            "rwkv6_wkv": wkv.rwkv6_wkv,
            "rwkv6_wkv_train": wkv.rwkv6_wkv_train,
            "rwkv6_wkv_bwd": wkv.rwkv6_wkv_bwd,
            "int8_matmul": i8.int8_matmul}


def reset_launches() -> None:
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["flash_attention"].banded = 0
    wrappers["flash_attention"].bidirectional = 0
    wrappers["flash_attention"].tensor_core = 0
    wrappers["flash_attention_lse"].tensor_core = 0
    wrappers["flash_attention_bwd"].tensor_core = 0
    wrappers["paged_prefill_attention"].tensor_core = 0
    wrappers["paged_prefill_attention_lse"].tensor_core = 0


def read_launches() -> dict:
    """Launches by kernel; ``flash_attention_window`` counts the launches
    of kernel 1 that band (0 < window < S), ``flash_attention_bidirectional``
    those with ``causal=False``, ``flash_attention_tensor_core`` those that
    took the wgmma kernel; ``flash_attention`` counts all of them too.
    ``paged_prefill_attention_tensor_core`` counts kernel 3's launches that
    took its wgmma kernel, ``flash_attention_bwd_tensor_core`` kernel 1's
    backward calls that took its wgmma kernels."""
    wrappers = kernel_wrappers()
    out = {name: fn.launches for name, fn in wrappers.items()}
    out["flash_attention_window"] = wrappers["flash_attention"].banded
    out["flash_attention_bidirectional"] = \
        wrappers["flash_attention"].bidirectional
    out["flash_attention_tensor_core"] = \
        wrappers["flash_attention"].tensor_core
    for name in ("flash_attention_bwd", "paged_prefill_attention",
                 "paged_prefill_attention_lse"):
        out[f"{name}_tensor_core"] = wrappers[name].tensor_core
    return out


def tensor_core_route(launches: dict, label: str) -> None:
    """Fail unless every kernel-1 and every kernel-3 launch (its owned/LSE
    form's too) of a bf16 run took the tensor cores."""
    for num, name in ((1, "flash_attention"), (3, "paged_prefill_attention"),
                      ("3s", "paged_prefill_attention_lse")):
        tc, n = launches[f"{name}_tensor_core"], launches[name]
        if num == "3s" and not n:
            continue
        print(f"{label}: kernel {num} on the tensor cores {tc} of {n} "
              f"launches", flush=True)
        if tc != n:
            fail(f"{label}: {n - tc} bf16 launches of kernel {num} did not "
                 f"take the tensor cores")


def plain_load(vocab: int) -> list:
    """8 prompts of 16-200 tokens, 32 new tokens each: (prompt, max_new)."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [([int(t) for t in rng.integers(0, vocab, int(n))], 32)
            for n in rng.integers(16, 201, 8)]


def system_prompt_load(vocab: int) -> list:
    """Shared-system-prompt traffic: 8 requests, each a 128-token system
    prompt (8 full blocks of 16) and a tail of 16-200 tokens, 32 new
    tokens each."""
    import numpy as np
    rng = np.random.default_rng(1)
    system = [int(t) for t in rng.integers(0, vocab, 128)]
    return [(system + [int(t) for t in rng.integers(0, vocab, int(n))], 32)
            for n in rng.integers(16, 201, 8)]


COUNTERS = ("decode_tokens", "prefill_tokens", "prefill_batches",
            "preemptions", "host_syncs", "decode_syncs", "variant_swaps",
            "verify_passes", "draft_tokens", "accepted_tokens")


def watch_pool(pool, shards: int) -> dict:
    """Record the paged pool at its fullest: after each
    ``ensure_append_blocks`` (a step's admissions come before it, its
    releases after) the live blocks, and at the largest count the live
    blocks of each of the ``shards`` stripes.  The wrapper refers to the
    pool, so ``unwatch_pool`` must take it off after the run."""
    seen = {"peak": 0, "stripes": [0] * shards}
    inner = pool.ensure_append_blocks
    nb_loc = pool.n_blocks // shards

    def ensure_append_blocks(*a, **kw):
        out = inner(*a, **kw)
        if pool.used_blocks > seen["peak"]:
            seen["peak"] = pool.used_blocks
            seen["stripes"] = [int((pool.ref[r * nb_loc:(r + 1) * nb_loc]
                                    > 0).sum()) for r in range(shards)]
        return out

    pool.ensure_append_blocks = ensure_append_blocks
    return seen


def unwatch_pool(pool) -> None:
    """Take ``watch_pool``'s wrapper off ``pool`` (it and the pool refer
    to each other, which would keep the pool alive past its engine)."""
    vars(pool).pop("ensure_append_blocks", None)


def serve(torch, model, params, label: str, load: list, need: tuple,
          drafter: tuple | None = None, repeats: int = 0,
          **engine_kw) -> dict:
    """Serve ``load`` through one Engine (4 lanes, blocks of 16, max_seq
    2048) with ``drive``; ``drafter`` (model, params) is registered and
    chosen as the speculative drafter.  Then ``repeats`` more runs of the
    same load on the same engine, its programs captured: their decode
    tok/s is ``warm_tok_s`` (the first run's wall holds the captures and
    the first prefills), and their streams must equal the first run's.
    The engine and its pool are freed before returning."""
    from repro_torch.serving import Engine, EngineKnobs
    eng = Engine(model, params, max_seq=2048, n_slots=4,
                 knobs=EngineKnobs(max_batch=4), block_size=16, **engine_kw)
    if drafter is not None:
        eng.add_drafter(drafter[0].cfg.name, *drafter)
        eng.set_drafter(drafter[0].cfg.name)
    out = drive(torch, eng, label, load, need)
    out["warm_tok_s"] = []
    for i in range(repeats):
        again = drive(torch, eng, f"{label} warm {i + 1}", load, need)
        if again["streams"] != out["streams"]:
            fail(f"{label}: warm run {i + 1} changed the streams")
        out["warm_tok_s"].append(again["tok_s"])
    # the engine goes with its last reference, its pools and graphs with
    # it, so the next engine's pools have the memory (llama2-13b with its
    # drafter leaves room for one engine at a time)
    gone = [weakref.ref(eng), weakref.ref(eng.pool)]
    del eng
    if any(r() is not None for r in gone):
        fail(f"{label}: the dropped engine or its pool is still referenced")
    torch.cuda.empty_cache()
    return out


def drive(torch, eng, label: str, load: list, need: tuple,
          swap: tuple | None = None) -> dict:
    """Serve ``load`` through ``eng`` with every launch count set to 0
    just before the run and read just after; check completion and that
    the kernels in ``need`` ran.  Counters are this run's (the engine's
    less their values before it).  On a paged pool, also record its
    fullest point (``watch_pool``) and check that the free list and the
    refcounts are back to their start (``_sharded_parity_main.py``'s
    ``check_pool_invariants``), on the pool the run ends on.  With
    ``swap=(n, name)`` the run calls ``set_variant(name)`` after n
    scheduler steps; ``in_flight`` is then the requests in flight at the
    swap."""
    from types import SimpleNamespace
    from repro_torch.serving import PagedCachePool, Request
    model, stats, pool = eng.model, eng.stats, eng.pool
    reqs = [Request(prompt=p, max_new_tokens=m, arrival_s=0.0, **kw)
            for p, m, *rest in load for kw in (rest[0] if rest else {},)]
    for r in reqs:
        eng.submit(r)
    paged = isinstance(pool, PagedCachePool)
    shards = pool.shards if paged else 1
    seen = watch_pool(pool, shards) if paged else None
    if paged:
        free0, lanes0 = len(pool.free_blocks), len(pool.free_lanes)
    before = {k: getattr(stats, k) for k in COUNTERS}
    n_done, n_steps = len(stats.completed), stats.n_steps
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    in_flight = None
    if swap is not None:
        for i in range(swap[0]):
            eng.step(now=float(i))
        in_flight = len(eng.active) + len(eng.prefilling)
        eng.set_variant(swap[1])
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if paged:
        unwatch_pool(pool)
    pool = eng.pool
    run = SimpleNamespace(
        completed=stats.completed[n_done:],
        step_times=list(stats.step_times)[
            max(len(stats.step_times) - (stats.n_steps - n_steps), 0):],
        **{k: getattr(stats, k) - v for k, v in before.items()})
    streams = [list(r.output) for r in reqs]
    horizon = eng.horizon if eng.paged else 1
    steps = run.decode_syncs * horizon
    # scheduler steps end on the decode readback; steps that also admitted
    # or advanced a prefill are among them
    step_ms = sorted(t * 1e3 / horizon for t in run.step_times)
    progs = list(eng.programs.values())
    out = {"streams": streams, "stats": run, "launches": launches,
           "wall": wall, "steps": steps, "shards": shards,
           "in_flight": in_flight, "tok_s": run.decode_tokens / wall,
           "captured": eng.captured,
           "shared_block_hits": getattr(pool, "shared_block_hits", 0),
           "pending_share_waits": getattr(pool, "pending_share_waits", 0),
           "peak_blocks": seen["peak"] if paged else 0,
           "stripe_blocks": seen["stripes"] if paged else []}
    L = model.cfg.num_layers
    per_step = (launches["paged_decode_attention"]
                + launches["paged_decode_attention_lse"]
                + launches["decode_attention"] + launches["rwkv6_wkv"])
    print(f"serve {model.cfg.name} {label}: {len(run.completed)} done, "
          f"decode_tokens={run.decode_tokens} "
          f"prefill_tokens={run.prefill_tokens} "
          f"prefill_batches={run.prefill_batches} "
          f"host_syncs={run.host_syncs} decode_steps={steps} "
          f"preemptions={run.preemptions} "
          f"shared_block_hits={out['shared_block_hits']} "
          f"pending_share_waits={out['pending_share_waits']} "
          f"wall_s={wall:.3f} decode_tok_per_s={run.decode_tokens / wall:.1f} "
          f"step_ms_median={step_ms[len(step_ms) // 2]:.3f} "
          f"({step_ms[0]:.3f}-{step_ms[-1]:.3f} over {len(step_ms)} "
          f"scheduler steps, per decode step) launches={launches} "
          f"per_prefill_batch_per_layer="
          f"{(launches['flash_attention'] + launches['paged_prefill_attention']) / max(run.prefill_batches * L, 1):.2f} "
          f"per_decode_step_per_layer={per_step / max(steps * L, 1):.2f}"
          + (f" pool: {pool.n_blocks} blocks, fullest at "
             f"{out['peak_blocks']} live, per stripe {out['stripe_blocks']}"
             if paged else "")
          + (f" set_variant({swap[1]!r}) after {swap[0]} steps with "
             f"{in_flight} in flight, variant_swaps={run.variant_swaps}"
             if swap else ""), flush=True)
    captures = sum(pr.captures for pr in progs)
    replays = sum(pr.replays for pr in progs)
    print(f"  {label} step programs ({'CUDA graphs' if eng.captured else 'eager, graphs=False'}): "
          + "; ".join(f"{pr.name}: {pr.captures} captures, {pr.replays} "
                      f"replays" + "".join(
                          f", capture {w:.3f} + {r:.3f} + {i:.3f} s "
                          f"(first step and warm-up, record, end and "
                          f"instantiate)" for w, r, i in pr.capture_s)
                      for pr in progs), flush=True)
    if eng.captured and (not captures or not replays):
        fail(f"{label}: the captured engine replayed no graph")
    if not eng.captured and captures:
        fail(f"{label}: graphs=False captured a graph")
    if len(run.completed) != len(load) or any(
            len(s) != ld[1] for s, ld in zip(streams, load)):
        fail(f"{label}: not every request completed its budget")
    if any(not 0 <= t < model.cfg.vocab_size for s in streams for t in s):
        fail(f"{label}: token outside the vocabulary")
    missing = [n for n in need if launches[n] == 0]
    if missing:
        fail(f"{label}: kernels of the path never launched: {missing} "
             f"({launches})")
    if model.plan.compute_dtype == torch.bfloat16:
        tensor_core_route(launches, f"{model.cfg.name} {label}")
    if paged and (len(pool.free_blocks) != free0
                  or len(pool.free_lanes) != lanes0
                  or int(pool.ref[1:].sum()) != 0
                  or sorted(pool.free_blocks) != list(
                      range(1, pool.n_blocks))):
        fail(f"{label}: the free list or refcounts did not return to their "
             f"start")
    return out


def same_streams(a: list, b: list) -> int:
    return sum(x == y for x, y in zip(a, b))


def same_as_eager(cap: dict, eager: dict, label: str) -> None:
    """Fail unless a captured run (the default, ``graphs=True``) and its
    ``graphs=False`` twin on the same weights and requests agree: streams,
    every ``EngineStats`` counter, the pool's shared-block hits and
    pending-share waits, and every kernel's launch count.  Prints both
    runs' decode tok/s."""
    if not cap["captured"] or eager["captured"]:
        fail(f"{label}: the twin runs are not captured and eager")
    n = len(cap["streams"])
    same = same_streams(cap["streams"], eager["streams"])
    counters = [k for k in COUNTERS
                if getattr(cap["stats"], k) != getattr(eager["stats"], k)]
    counters += [k for k in ("shared_block_hits", "pending_share_waits")
                 if cap[k] != eager[k]]
    launches = {k: (cap["launches"][k], eager["launches"][k])
                for k in cap["launches"]
                if cap["launches"][k] != eager["launches"][k]}
    print(f"{label}, captured vs eager: {same}/{n} streams equal, counters "
          f"differing {counters} (none), launch counts differing {launches} "
          f"(none); decode tok/s {cap['tok_s']:.1f} captured, "
          f"{eager['tok_s']:.1f} eager ({cap['tok_s'] / eager['tok_s']:.2f}x"
          f"), wall {cap['wall']:.3f} / {eager['wall']:.3f} s", flush=True)
    if same != n or counters or launches:
        fail(f"{label}: the captured run differs from the eager one")


def sampled_load(vocab: int) -> list:
    """``plain_load``'s requests, the odd ones sampled at temperature 0.8
    and top-k 40 with seeds of their own (100 + i), the even ones greedy:
    (prompt, max_new, request kwargs)."""
    return [(p, m, dict(temperature=0.8, top_k=40, seed=100 + i)
             if i % 2 else {}) for i, (p, m) in enumerate(plain_load(vocab))]


def greedy_lanes_equal(sampled: dict, greedy: dict, label: str) -> None:
    """Fail unless the greedy requests of a mixed run (the even ones of
    ``sampled_load``) produced the streams of an all-greedy run."""
    pairs = list(zip(sampled["streams"], greedy["streams"]))[::2]
    same = sum(a == b for a, b in pairs)
    diff = sum(a != b for a, b in
               list(zip(sampled["streams"], greedy["streams"]))[1::2])
    print(f"{label}: greedy requests {same}/{len(pairs)} streams equal to "
          f"the all-greedy run's; sampled requests differ from greedy in "
          f"{diff}/{len(pairs)}", flush=True)
    if same != len(pairs):
        fail(f"{label}: a greedy request's stream changed beside sampled "
             f"ones")
    if not diff:
        fail(f"{label}: no sampled request left the greedy stream")


def preempting(torch, model, params, load: list, label: str) -> list:
    """``load`` captured at horizon 8 in a pool that holds every request
    (no preemption) and in one three quarters the size of its fullest
    point (preemption: requests recomputed by prefill mid-stream).
    Returns both runs and the number of streams they share."""
    paged = ("flash_attention", "paged_decode_attention")
    big = serve(torch, model, params, f"{label} horizon=8", load, paged,
                horizon=8)
    small = max(big["peak_blocks"] * 3 // 4, 16)
    tight = serve(torch, model, params, f"{label} horizon=8, a pool of "
                  f"{small} blocks", load, paged, horizon=8, n_blocks=small)
    n = same_streams(big["streams"], tight["streams"])
    print(f"llama2-7b {label}: {n}/8 streams equal with and without "
          f"preemption; preemptions {big['stats'].preemptions} (0) in the "
          f"first pool, {tight['stats'].preemptions} (> 0) in {small} "
          f"blocks", flush=True)
    if big["stats"].preemptions or not tight["stats"].preemptions:
        fail(f"{label}: the large pool preempted or the small one did not")
    return [big, tight], n


def serve_sampled(torch, model, params, greedy: dict) -> list:
    """``sampled_load`` through the paged pool: captured at horizon 8 and
    1 and eager (``graphs=False``) at horizon 8, which must give the same
    streams, the greedy requests those of ``greedy`` (the all-greedy
    horizon-8 run).  The keys depend only on (seed, sequence index), so
    preemption cannot change a draw; a preempted request's context is
    recomputed by prefill, whose bf16 logits differ from the decode's in
    the last bits (other kernels, other GEMM shapes), so in bf16 the
    streams with and without preemption are a reading, and the check runs
    in an f32 compute plan on the same weights (the paths agree there to
    ~1e-6), where they must be equal."""
    from repro_torch.models import build_model, local_plan
    paged = ("flash_attention", "paged_decode_attention")
    load = sampled_load(model.cfg.vocab_size)
    (h8, tight), n = preempting(torch, model, params, load, "sampled")
    h1 = serve(torch, model, params, "sampled horizon=1", load, paged,
               horizon=1)
    eager = serve(torch, model, params, "sampled horizon=8 eager", load,
                  paged, horizon=8, graphs=False)
    same_as_eager(h8, eager, "llama2-7b sampled horizon=8")
    n1 = same_streams(h8["streams"], h1["streams"])
    print(f"llama2-7b sampled: {n1}/8 streams at horizon 8 equal to "
          f"horizon 1's; with and without preemption in bf16 {n}/8 (a "
          f"reading)", flush=True)
    if n1 != 8:
        fail("sampled streams differ between horizon 8 and horizon 1")
    greedy_lanes_equal(h8, greedy, "llama2-7b sampled horizon=8")
    f32 = build_model(model.cfg, local_plan(param_dtype=torch.bfloat16,
                                            compute_dtype=torch.float32),
                      device=model.device)
    runs, n = preempting(torch, f32, params, load, "sampled (f32 plan)")
    if n != 8:
        fail("sampled streams (f32 plan) differ with and without "
             "preemption")
    return [h8, tight, h1, eager] + runs


def serve_sharded(torch, model, params, load: list, ref: dict) -> list:
    """The block-striped pool: ``EngineSpec(shards=2, horizon=8).build()``
    serves ``load``, then ``set_shards(4)`` on that engine and the same
    load again.  The pool holds the smallest multiple of 4 blocks above
    the unsharded horizon-8 run's fullest point (``ref``), so the same
    schedule runs without preemption and the upper stripes hold live
    blocks.  Each run checks kernel 4's launches (shards x L x decode
    steps) and none of kernel 2, no preemption, a live block in every
    stripe at the fullest point, and (in ``drive``) the free list; the
    reshard is counted.  Streams against the unsharded run are a reading
    (bf16 at full width)."""
    from repro_torch.serving import EngineSpec
    cfg, L = model.cfg, model.cfg.num_layers
    n_blocks = -(-(ref["peak_blocks"] + 1) // 4) * 4
    spec = EngineSpec(cfg, shards=2, max_seq=2048, n_slots=4, max_batch=4,
                      block_size=16, n_blocks=n_blocks, horizon=8, seed=0)
    t0 = time.perf_counter()
    eng = spec.build(device=model.device)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b)
               for a, b in zip(_leaves(eng.params), _leaves(params)))
    print(f"EngineSpec(shards=2) built in {time.perf_counter() - t0:.1f} s; "
          f"its seed-0 weights equal the serve runs': {same}", flush=True)
    if not same:
        fail("EngineSpec's seeded weights differ from build_model + init")
    eng.params = params          # one copy of the weights on the card
    torch.cuda.empty_cache()
    runs = []
    # the eager twin of the shards=2 run: the engine EngineSpec builds, on
    # the same weights, with graphs=False
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, EngineKnobs, serving_plan
    eager = Engine(build_model(cfg, serving_plan(
        2, param_dtype=model.plan.param_dtype), device=model.device), params,
        max_seq=2048, n_slots=4, knobs=EngineKnobs(max_batch=4), paged=True,
        block_size=16, n_blocks=n_blocks, horizon=8, graphs=False)
    runs.append(drive(torch, eager, "EngineSpec shards=2 horizon=8 eager",
                      load, ("flash_attention",
                             "paged_decode_attention_lse")))
    del eager
    torch.cuda.empty_cache()
    for n in (2, 4):
        if n == 4:
            eng.set_shards(4)
            print(f"set_shards(4): shards={eng.shards} "
                  f"shard_swaps={eng.stats.shard_swaps}", flush=True)
            if eng.shards != 4 or eng.stats.shard_swaps != 1:
                fail("set_shards(4) did not reshard once")
        run = drive(torch, eng, f"EngineSpec shards={n} horizon=8", load,
                    ("flash_attention", "paged_decode_attention_lse"))
        lse, want = run["launches"]["paged_decode_attention_lse"], \
            n * L * run["steps"]
        print(f"shards={n} checks: paged_decode_attention_lse launches={lse} "
              f"({n} x {L} x {run['steps']} decode steps = {want}), "
              f"paged_decode_attention launches="
              f"{run['launches']['paged_decode_attention']} (0), "
              f"preemptions={run['stats'].preemptions} (0), live blocks per "
              f"stripe at the fullest point {run['stripe_blocks']} (all > "
              f"0); {same_streams(run['streams'], ref['streams'])}/8 streams "
              f"equal to the shards=1 horizon-8 run (a reading, not a "
              f"check: bf16 at full width)", flush=True)
        if lse != want or run["launches"]["paged_decode_attention"]:
            fail(f"shards={n}: decode did not go through kernel 4 alone, "
                 f"{n} launches per layer and step")
        if run["stats"].preemptions:
            fail(f"shards={n}: a request was preempted in a pool sized for "
                 f"the load")
        if len(run["stripe_blocks"]) != n or min(run["stripe_blocks"]) == 0:
            fail(f"shards={n}: a stripe held no live block")
        if n == 2:
            same_as_eager(run, runs[0], f"{cfg.name} EngineSpec shards=2")
        runs.append(run)
    del eng
    torch.cuda.empty_cache()
    return runs


def serve_chunked(torch, model, params) -> list:
    """Chunked prefill with prefix sharing (chunks of 128, horizon 8) on
    ``system_prompt_load``, captured and eager, beside a whole-prompt run
    of the same requests; checks the shared blocks, the unshared prefill
    tokens and kernel 3's launches (one per layer and chunk tick)."""
    name, vocab, L = model.cfg.name, model.cfg.vocab_size, \
        model.cfg.num_layers
    paged = ("flash_attention", "paged_decode_attention")
    sys_load = system_prompt_load(vocab)
    chunked = serve(torch, model, params,
                    "chunked prefill_chunk=128 prefix_share horizon=8",
                    sys_load, ("paged_prefill_attention",
                               "paged_decode_attention"),
                    horizon=8, prefill_chunk=128, prefix_share=True)
    st, hits = chunked["stats"], chunked["shared_block_hits"]
    want_tokens = sum(len(p) for p, _ in sys_load) - 16 * hits
    want_launches = L * st.prefill_batches
    print(f"chunked checks: shared_block_hits={hits} (> 0), "
          f"preemptions={st.preemptions} (0), prefill_tokens="
          f"{st.prefill_tokens} (sum of contexts - 16 x hits = "
          f"{want_tokens}), paged_prefill_attention launches="
          f"{chunked['launches']['paged_prefill_attention']} ({L} x "
          f"{st.prefill_batches} prefill batches = {want_launches})",
          flush=True)
    if hits <= 0:
        fail("chunked: no prompt block was shared")
    if st.preemptions:
        fail("chunked: a request was preempted in a pool sized for all")
    if st.prefill_tokens != want_tokens:
        fail("chunked: prefill_tokens is not the unshared context")
    if chunked["launches"]["paged_prefill_attention"] != want_launches:
        fail("chunked: paged_prefill_attention did not launch once per "
             "layer and chunk tick")
    chunked_eager = serve(torch, model, params, "chunked prefill_chunk=128 "
                          "prefix_share horizon=8 eager", sys_load,
                          ("paged_prefill_attention",
                           "paged_decode_attention"),
                          horizon=8, prefill_chunk=128, prefix_share=True,
                          graphs=False)
    same_as_eager(chunked, chunked_eager, f"{name} chunked")
    whole = serve(torch, model, params, "whole-prompt, same requests, "
                  "horizon=8", sys_load, paged, horizon=8)
    print(f"chunked vs whole-prompt on the same weights: "
          f"{same_streams(chunked['streams'], whole['streams'])}/8 streams "
          f"equal (a reading, not a check: bf16 at full width); "
          f"prefill_tokens {st.prefill_tokens} vs "
          f"{whole['stats'].prefill_tokens}", flush=True)
    return [chunked, chunked_eager, whole]


def serve_slots(torch, model, params, load: list, ref: dict) -> list:
    """The slot pool (``paged=False``) on ``load``, captured and eager;
    checks kernel 5's launches (one per layer and decode step) and reads
    the streams against the paged run ``ref``."""
    name, L = model.cfg.name, model.cfg.num_layers
    slots = serve(torch, model, params, "slots (paged=False)", load,
                  ("flash_attention", "decode_attention"), paged=False)
    want = L * slots["stats"].decode_syncs
    print(f"slot checks: decode_attention launches="
          f"{slots['launches']['decode_attention']} ({L} x "
          f"{slots['stats'].decode_syncs} decode steps = {want}); "
          f"{same_streams(slots['streams'], ref['streams'])}/8 streams "
          f"equal to the paged run (a reading, not a check)",
          flush=True)
    if slots["launches"]["decode_attention"] != want:
        fail("slots: decode_attention did not launch once per layer and "
             "decode step")
    slots_eager = serve(torch, model, params, "slots (paged=False) eager",
                        load, ("flash_attention", "decode_attention"),
                        paged=False, graphs=False)
    same_as_eager(slots, slots_eager, f"{name} slots")
    return [slots, slots_eager]


def serve_paths(torch, model, params) -> dict:
    """Phase 2: the paged pool at horizon 1 and 8, the block-striped pool
    at shards 2 and 4 (``serve_sharded``), chunked prefill with prefix
    sharing beside a whole-prompt run of its requests, and the slot pool.
    Returns the launches of each kernel summed over the runs."""
    paged = ("flash_attention", "paged_decode_attention")
    load = plain_load(model.cfg.vocab_size)
    runs = [serve(torch, model, params, "horizon=1", load, paged, horizon=1),
            serve(torch, model, params, "horizon=8", load, paged, horizon=8)]
    if runs[0]["streams"] != runs[1]["streams"]:
        fail("greedy streams differ between horizon 1 and horizon 8")
    print("greedy streams identical at horizon 1 and 8", flush=True)
    eager = serve(torch, model, params, "horizon=8 eager", load, paged,
                  horizon=8, graphs=False)
    same_as_eager(runs[1], eager, "llama2-7b horizon=8")
    runs += [eager] + serve_sampled(torch, model, params, runs[1])
    runs += serve_sharded(torch, model, params, load, runs[1])
    chunked = serve_chunked(torch, model, params)
    runs += chunked
    runs += serve_slots(torch, model, params, load, runs[0])
    # phase 13's llama paths, while llama2-7b is on the card
    runs += chunked_shards(torch, model, params, chunked[0], (2, 4))
    runs += chunked_f32_shards(torch, model, params)
    runs += spec_shards(torch, model, params)
    total = {}
    for run in runs:
        for name, n in run["launches"].items():
            total[name] = total.get(name, 0) + n
    return total, {"greedy": runs[1], "sampled": runs[3]}


# ---------------------------------------------------------------------------
# speculative decode (phase 2: llama2-7b with n-gram drafts; phase 9:
# llama2-13b with the llama2-7b drafter)
# ---------------------------------------------------------------------------

SPEC = dict(spec_k=4, horizon=4)
# warm runs of each llama2-7b speculative load and of its horizon-8 base:
# the tok/s comparison reads their medians and spread (llama2-13b's
# drafted runs, 0.24-0.30x, are far enough from 1 without them)
WARM = 3


def continuation_load(load: list, streams: list, sampled: bool) -> list:
    """``benchmarks/bench_engine.py``'s continuation style (primer 32): each
    of ``load``'s prompts followed by its own 32-token greedy continuation
    (``streams``, a greedy run of ``load``), 32 new tokens, so the text
    the model emits next is already in its context; with ``sampled`` the
    odd requests sample at temperature 0.8, top-k 40, seed 100 + i."""
    return [(list(p) + list(s), 32,
             dict(temperature=0.8, top_k=40, seed=100 + i)
             if sampled and i % 2 else {})
            for i, ((p, *_), s) in enumerate(zip(load, streams))]


def spec_report(run: dict, base: dict, label: str, model,
                drafter=None) -> None:
    """Print a speculative run's decode tok/s beside ``base`` (the same
    load at horizon 8 without speculation, in the same call), its spec
    counters, host syncs per 1k decode tokens and kernel-2 launches; fail
    unless verify passes ran and kernel 2 launched once per layer and
    verify round (and with a drafter once per drafter layer and drafter
    step, spec_k + 1 a round: the drafts and the backfill)."""
    st = run["stats"]
    k = SPEC["spec_k"]
    rounds = st.decode_syncs * SPEC["horizon"]
    ws, wb = run["warm_tok_s"], base["warm_tok_s"]
    if ws and wb:
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        print(f"spec {model.cfg.name} {label}: warm decode tok/s "
              f"{med(ws):.1f} (runs {', '.join(f'{x:.1f}' for x in ws)}) "
              f"against {med(wb):.1f} (runs "
              f"{', '.join(f'{x:.1f}' for x in wb)}) at horizon 8 without "
              f"speculation: {med(ws) / med(wb):.2f}x of the medians, "
              f"{min(ws) / max(wb):.2f}-{max(ws) / min(wb):.2f}x over "
              f"the runs", flush=True)
    per_round = model.cfg.num_layers + (
        drafter.cfg.num_layers * (k + 1) if drafter is not None else 0)
    k2 = run["launches"]["paged_decode_attention"]
    bst = base["stats"]
    print(f"spec {model.cfg.name} {label}: decode tok/s {run['tok_s']:.1f} "
          f"(horizon 8 without speculation, same load: {base['tok_s']:.1f};"
          f" {run['tok_s'] / base['tok_s']:.2f}x); verify_passes="
          f"{st.verify_passes} draft_tokens={st.draft_tokens} "
          f"accepted_tokens={st.accepted_tokens} acceptance_rate="
          f"{st.accepted_tokens / max(st.draft_tokens, 1):.3f} "
          f"accepted_per_sync="
          f"{st.accepted_tokens / max(st.decode_syncs, 1):.2f}; host syncs "
          f"per 1k tokens {1e3 * st.host_syncs / st.decode_tokens:.1f} "
          f"({1e3 * bst.host_syncs / bst.decode_tokens:.1f} without); "
          f"kernel-2 launches {k2} ({per_round} x {rounds} rounds; "
          f"{base['launches']['paged_decode_attention']} without)",
          flush=True)
    if not st.verify_passes or st.draft_tokens != k * st.verify_passes:
        fail(f"{label}: no verify pass, or drafts != spec_k x passes")
    if k2 != per_round * rounds:
        fail(f"{label}: kernel 2 launched {k2} times, not {per_round} per "
             f"round over {rounds} rounds")


def spec_pairs(torch, model, params, loads: dict, bases: dict,
               drafter=None, repeats: int = 0) -> list:
    """Each ``loads[name]`` served speculatively (``SPEC``; n-gram drafts,
    or ``drafter``'s), captured and eager (``graphs=False``), which must
    agree (``same_as_eager``), each reported beside ``bases[name]``, the
    captured run with ``repeats`` warm runs; greedy loads' streams beside
    the base's (in bf16 a reading).  Returns the runs."""
    paged = ("flash_attention", "paged_decode_attention")
    how = (f"{drafter[0].cfg.name} drafter" if drafter is not None
           else "n-gram") + (f" spec_k={SPEC['spec_k']} "
                             f"horizon={SPEC['horizon']}")
    kw = dict(SPEC) if drafter is not None else dict(SPEC, draft="ngram")
    d_model = drafter[0] if drafter is not None else None
    runs = []
    for name, load in loads.items():
        cap = serve(torch, model, params, f"{name} {how}", load, paged,
                    drafter=drafter, repeats=repeats, **kw)
        eager = serve(torch, model, params, f"{name} {how} eager", load,
                      paged, drafter=drafter, graphs=False, **kw)
        same_as_eager(cap, eager, f"{model.cfg.name} {name} {how}")
        for run, tag in ((cap, "captured"), (eager, "eager")):
            spec_report(run, bases[name], f"{name} {how} {tag}", model,
                        d_model)
        if "greedy" in name:
            print(f"{model.cfg.name} {name} {how}: "
                  f"{same_streams(cap['streams'], bases[name]['streams'])}/8"
                  f" streams equal to the horizon-8 run without speculation "
                  f"(a reading in bf16: the verify pass's GEMMs take "
                  f"{4 * (SPEC['spec_k'] + 1)} rows where the step's take "
                  f"4)", flush=True)
        runs += [cap, eager]
    return runs


def spec_f32_greedy(torch, model, params, load: list) -> list:
    """The check behind greedy speculation: in an f32 compute plan (TF32
    off) on the same weights, n-gram speculative greedy streams equal the
    horizon-8 run's.  A stream that parts at a near-tie (top-2 gap of the
    teacher-forced f32 logits below 1e-3: 20-row against 4-row GEMMs;
    kernel 2's fold is bit-identical, phase 1) is printed as a reading;
    anywhere else it fails."""
    from repro_torch.models import build_model, local_plan
    paged = ("flash_attention", "paged_decode_attention")
    f32 = build_model(model.cfg, local_plan(param_dtype=torch.bfloat16,
                                            compute_dtype=torch.float32),
                      device=model.device)
    base = serve(torch, f32, params, "continuation greedy horizon=8 (f32 "
                 "plan)", load, paged, horizon=8)
    spec = serve(torch, f32, params, "continuation greedy n-gram spec (f32 "
                 "plan)", load, paged, draft="ngram", **SPEC)
    n = same_streams(base["streams"], spec["streams"])
    print(f"llama2-7b f32 plan: {n}/8 n-gram speculative greedy streams "
          f"equal to the horizon-8 run's", flush=True)
    for r, (a, b) in enumerate(zip(base["streams"], spec["streams"])):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = torch.tensor([list(load[r][0]) + a[:t]], dtype=torch.int32,
                           device=model.device)
        top = f32.logits(params, ctx)[0, -1, :model.cfg.vocab_size].float()
        top = top.topk(2).values
        gap = float(top[0] - top[1])
        print(f"  request {r} parts at new token {t}: {a[t]} without, "
              f"{b[t]} with speculation; top-2 gap of the teacher-forced "
              f"f32 logits {gap:.3e}", flush=True)
        if gap >= 1e-3:
            fail("greedy speculation (f32 plan) parts from the plain "
                 "stream away from a near-tie")
    return [base, spec]


def sum_launches(runs: list) -> dict:
    total = {}
    for run in runs:
        for name, n in run["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def serve_spec(torch, model, params, h8: dict) -> dict:
    """Phase 2's speculative runs on llama2-7b (n-gram drafts, ``SPEC``):
    ``plain_load``'s prompts (greedy, and ``sampled_load``) and their
    continuation load (``continuation_load`` over ``h8``'s greedy
    horizon-8 run's streams), greedy and sampled, each captured and
    eager, beside horizon-8 runs without speculation on the same loads,
    with ``WARM`` warm runs on each side; then the f32 check.  Returns
    the launches summed over the runs."""
    vocab = model.cfg.vocab_size
    paged = ("flash_attention", "paged_decode_attention")
    plain = plain_load(vocab)
    loads = {"plain greedy": plain, "plain sampled": sampled_load(vocab)}
    for kind in ("greedy", "sampled"):
        loads[f"continuation {kind}"] = continuation_load(
            plain, h8["greedy"]["streams"], kind == "sampled")
    bases = {name: serve(torch, model, params, f"{name} horizon=8", load,
                         paged, horizon=8, repeats=WARM)
             for name, load in loads.items()}
    runs = list(bases.values())
    runs += spec_pairs(torch, model, params, loads, bases, repeats=WARM)
    runs += spec_f32_greedy(torch, model, params,
                            loads["continuation greedy"])
    return sum_launches(runs)


# ---------------------------------------------------------------------------
# phase 3: teacher-forced logits, kernels vs plain versions on one card
# ---------------------------------------------------------------------------

def _decode_ref(q, k, v, positions, *, scale=None, ring=False):
    """``ops.decode_attention``'s CPU choice, taken for CUDA tensors."""
    from repro_torch.kernels import decode_attention as da
    ref = da.swa_decode_ref if ring else da.flash_decode_ref
    return ref(q, k, v, positions, scale=scale)


class plain_versions:
    """Within the block, ``ops`` sends CUDA tensors to the plain versions
    (the ones each kernel is held against); ``as`` gives the ``ops``
    module, whose entries the block may set further."""

    def __enter__(self):
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import int8_matmul as i8
        from repro_torch.kernels import ops
        from repro_torch.kernels import paged_decode_attention as pa
        from repro_torch.kernels import paged_prefill_attention as ppa
        from repro_torch.kernels import rwkv6_wkv as wkv
        self.ops = ops
        self.saved = {n: getattr(ops, n) for n in ops.__all__}
        ops.flash_attention = fa.flash_attention_ref
        ops.paged_decode_attention = pa.paged_decode_attention_ref
        ops.paged_decode_attention_lse = pa.paged_decode_attention_lse_ref
        ops.paged_prefill_attention = ppa.paged_prefill_attention_ref
        ops.paged_prefill_attention_lse = ppa.paged_prefill_attention_lse_ref
        ops.paged_verify_attention = ppa.paged_prefill_attention_ref
        ops.decode_attention = _decode_ref
        ops.rwkv6_wkv = wkv.rwkv6_wkv_ref
        ops.int8_matmul = i8.int8_matmul_ref
        ops.int8_matmul_quantized = i8.int8_matmul_quantized_ref
        return ops

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)


def logits_agree(torch, vocab: int, what: str, a, b, tol=None) -> bool:
    """Within ``tol`` (default 5% of max |logit| of ``b``) and the same
    argmax on every row that bf16 logits decide.  A row whose top-2 margin in ``b`` is within
    two bf16 steps at max |logit| is a tie at bf16 resolution: one step
    of rounding anywhere upstream can swap its argmax, so there the
    token ``a`` picks must score within those two steps of ``b``'s max."""
    import math
    a, b = a[:, :vocab].float(), b[:, :vocab].float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail(f"{what} logits not finite")
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    limit = (f"5% of max|logit| {scale:.3f}" if tol is None
             else f"max|logit| {scale:.3f}")
    tol = 0.05 * scale if tol is None else tol
    band = 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)   # 2 bf16 steps
    top2 = b.topk(2, dim=-1).values
    margins = top2[:, 0] - top2[:, 1]
    pick = a.argmax(-1)
    same = pick == b.argmax(-1)
    tied = margins <= band
    in_band = b.gather(1, pick[:, None])[:, 0] >= top2[:, 0] - band
    agree = bool((same | (tied & in_band)).all())
    print(f"teacher-forced {what} logits ({a.shape[0]} rows, bf16): "
          f"max_abs_err={err:.4e} tol={tol:.4e} ({limit}) "
          f"argmax_same={int(same.sum())}/{a.shape[0]} "
          f"tied_rows={int(tied.sum())} (top-2 margin <= {band:.4e}) "
          f"argmax_agree={agree} min_top2_margin={margins.min().item():.4e}",
          flush=True)
    return err <= tol and agree


def _prompts(torch, model, seed: int):
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.tensor([200, 77, 16, 131], dtype=torch.int32, device=dev)
    tokens = torch.randint(0, model.cfg.vocab_size, (4, 256), generator=gen,
                           device=dev, dtype=torch.int32)
    return tokens, lengths


def teacher_forced(torch, model, params):
    """Whole-prompt prefill and one paged decode step from its state."""
    from repro_torch.serving import PagedCachePool
    vocab = model.cfg.vocab_size
    tokens, lengths = _prompts(torch, model, 1)
    pool = PagedCachePool(model, 4, 2048, block_size=16)
    lk, cache = model.prefill_ragged(params, tokens, lengths)
    with plain_versions():
        lp, _ = model.prefill_ragged(params, tokens, lengths)
    # one decode step from the kernels' prefill state, both ways
    for i, n in enumerate(lengths.tolist()):
        pool.insert(100 + i, cache, i, n)
    pool.ensure_append_blocks([100 + i for i in range(4)])
    nxt = lk[:, :vocab].argmax(-1).to(torch.int32)
    pos, tab = pool.positions(), pool.tables()
    pool_copy = {"attn": {n: t.clone() for n, t in pool.cache["attn"].items()}}
    dk, _ = model.decode_step_paged(params, pool.cache, nxt, pos, tab)
    with plain_versions():
        dp, _ = model.decode_step_paged(params, pool_copy, nxt, pos, tab)
    ok = logits_agree(torch, vocab, "prefill, kernel vs plain", lk, lp)
    ok &= logits_agree(torch, vocab, "paged decode, kernel vs plain", dk, dp)
    del pool, pool_copy, cache
    torch.cuda.empty_cache()
    if not ok:
        fail("teacher-forced kernel path disagrees with the plain path")


def teacher_forced_sharded(torch, model, params):
    """One paged decode step through the block-striped pool at shards 2
    and 4 (kernel 4, ``combine_lse``) against the unsharded step (kernel 2)
    from the same pool state, in the serving (bf16) plan and in an f32
    compute plan over the same bf16 weights.  The pool of 32 blocks (a
    multiple of 4) holds the four prompts' prefill and first append in
    blocks 1-29, so every stripe holds live blocks at both degrees."""
    from repro_torch.models import build_model, local_plan
    from repro_torch.serving import PagedCachePool, serving_plan
    cfg, vocab = model.cfg, model.cfg.vocab_size
    tokens, lengths = _prompts(torch, model, 1)
    rids = [100 + i for i in range(4)]
    ok = True
    for name, cdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        kw = dict(param_dtype=torch.bfloat16, compute_dtype=cdt)
        m1 = build_model(cfg, local_plan(**kw), device=model.device)
        lk, cache = m1.prefill_ragged(params, tokens, lengths)
        pool = PagedCachePool(m1, 4, 2048, block_size=16, n_blocks=32)
        for rid, n in zip(rids, lengths.tolist()):
            pool.insert(rid, cache, rid - 100, n)
        pool.ensure_append_blocks(rids)
        del cache
        nxt = lk[:, :vocab].argmax(-1).to(torch.int32)
        pos, tab = pool.positions(), pool.tables()
        d1, _ = m1.decode_step_paged(params, _clone(pool.cache), nxt, pos,
                                     tab)
        for n in (2, 4):
            nb_loc = pool.n_blocks // n
            live = [int((pool.ref[r * nb_loc:(r + 1) * nb_loc] > 0).sum())
                    for r in range(n)]
            print(f"teacher-forced shards={n}: live blocks per stripe {live}",
                  flush=True)
            if min(live) == 0:
                fail(f"teacher-forced shards={n}: a stripe holds no live "
                     f"block")
            ms = build_model(cfg, serving_plan(n, **kw), device=model.device)
            dn, _ = ms.decode_step_paged(params, _clone(pool.cache), nxt, pos,
                                         tab)
            ok &= logits_agree(torch, vocab, f"{name} plan paged decode, "
                               f"shards={n} (kernel 4) vs shards=1 "
                               f"(kernel 2)", dn, d1)
        del pool
    torch.cuda.empty_cache()
    if not ok:
        fail("teacher-forced sharded decode disagrees with the unsharded one")


def teacher_forced_chunks(torch, model, params):
    """A two-chunk prefill over a shared head: chunk 1 writes a 128-token
    head into blocks 1-8; chunk 2 runs 4 rows at start 128 (tails of 128,
    100, 37 and 5 tokens, C = 128) whose tables all begin with those
    blocks.  Kernels vs plain versions on fresh pools, then the chunked
    logits against whole-prompt prefill of head + tail."""
    vocab, dev = model.cfg.vocab_size, model.device
    B, C, bs, T = 4, 128, 16, 128
    gen = torch.Generator(device=dev).manual_seed(3)
    head = torch.randint(0, vocab, (1, C), generator=gen, device=dev,
                         dtype=torch.int32)
    tails = torch.randint(0, vocab, (B, C), generator=gen, device=dev,
                          dtype=torch.int32)
    lens = torch.tensor([128, 100, 37, 5], dtype=torch.int32, device=dev)
    tables = torch.zeros(B, T, dtype=torch.int32, device=dev)
    tables[:, :8] = torch.arange(1, 9, dtype=torch.int32, device=dev)
    tables[:, 8:16] = (9 + torch.arange(B * 8, dtype=torch.int32, device=dev)
                       ).reshape(B, 8)
    n_blocks = 9 + B * 8
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    full = torch.full((1,), C, dtype=torch.int32, device=dev)
    at_head = torch.full((B,), C, dtype=torch.int32, device=dev)

    def two_chunks():
        pool = model.init_paged_cache(n_blocks, bs)
        l1, _ = model.prefill_chunk_paged(params, pool, head, zero, full,
                                          tables[:1].contiguous())
        l2, _ = model.prefill_chunk_paged(params, pool, tails, at_head, lens,
                                          tables)
        return l1, l2

    l1k, l2k = two_chunks()
    with plain_versions():
        l1p, l2p = two_chunks()
    torch.cuda.empty_cache()
    whole = torch.cat([head.expand(B, C), tails], dim=1)
    lr, _ = model.prefill_ragged(params, whole, C + lens)
    ok = logits_agree(torch, vocab, "chunk 1 (head), kernel vs plain",
                      l1k, l1p)
    ok &= logits_agree(torch, vocab, "chunk 2 (shared head), kernel vs plain",
                       l2k, l2p)
    ok &= logits_agree(torch, vocab, "two chunks vs prefill_ragged", l2k, lr)
    if not ok:
        fail("teacher-forced chunked prefill disagrees")


def teacher_forced_slots(torch, model, params):
    """One slot decode step from a whole-prompt prefill's state, kernel vs
    plain, and against one paged decode step on the same context."""
    from repro_torch.serving import PagedCachePool
    vocab = model.cfg.vocab_size
    tokens, lengths = _prompts(torch, model, 4)
    lk, cache = model.prefill_ragged(params, tokens, lengths)
    slot = model.init_cache(4, 2048, device=model.device)
    S = tokens.shape[1]
    for n, dst in slot["attn"].items():
        dst[:, :, :S] = cache["attn"][n]
    slot_copy = {"attn": {n: t.clone() for n, t in slot["attn"].items()}}
    nxt = lk[:, :vocab].argmax(-1).to(torch.int32)
    dk, _ = model.decode_step(params, slot, nxt, lengths)
    with plain_versions():
        dp, _ = model.decode_step(params, slot_copy, nxt, lengths)
    del slot, slot_copy
    pool = PagedCachePool(model, 4, 2048, block_size=16)
    for i, n in enumerate(lengths.tolist()):
        pool.insert(100 + i, cache, i, n)
    pool.ensure_append_blocks([100 + i for i in range(4)])
    pk, _ = model.decode_step_paged(params, pool.cache, nxt, pool.positions(),
                                    pool.tables())
    del pool, cache
    torch.cuda.empty_cache()
    ok = logits_agree(torch, vocab, "slot decode, kernel vs plain", dk, dp)
    ok &= logits_agree(torch, vocab, "slot decode vs paged decode", dk, pk)
    if not ok:
        fail("teacher-forced slot decode disagrees")


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
    by ``per``, and the time and share of kernels 1-5 where they ran.
    Returns the device busy ms per ``unit``."""
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
    for label_k, key in (("kernel 1 (flash_attention)", "flash_kernel"),
                         ("kernel 2 (paged_decode_attention)",
                          "paged_decode_split_kernel"),
                         ("kernel 3 (paged_prefill_attention)",
                          "paged_prefill_"),
                         ("kernel 4 (paged_decode_attention_lse)",
                          "paged_decode_lse_split_kernel"),
                         ("kernel 5 (decode_attention)",
                          "split_decode_kernel")):
        ms = sum(r[0] for r in rows if key in r[2]) / 1e3 / per
        n = sum(r[1] for r in rows if key in r[2]) / per
        if ms:
            print(f"  {label_k} {ms:.3f} ms/{unit} over {n:.0f} launches, "
                  f"share {ms / busy_ms:.3f} of device busy, beside "
                  f"{n_ops:.0f} device ops/{unit}", flush=True)
    return busy_ms


def replayed(prog, inputs: dict, steps: int = 0):
    """A call that fills the step program ``prog``'s static inputs from
    ``inputs`` (copies on the card) and runs it: a horizon of ``steps``
    runs (``run_horizon``), else one.  Captured, its first call captures
    and every later one replays; ``fn.program`` is ``prog``."""
    from repro_torch.serving import graphs as G

    def fn():
        for name, t in inputs.items():
            prog.bufs[name].copy_(t)
        if steps:
            G.run_horizon(prog, steps)
        else:
            prog.run()

    fn.program = prog
    return fn


def captured_horizon(torch, model, params, cache, inputs: dict,
                     horizon: int, sampled: bool = False):
    """The decode horizon of ``inputs`` (tokens, positions, tables,
    active, budgets, eos) as replays of one captured step; ``sampled``
    draws every lane at temperature 0.8 and top-k 40."""
    from repro_torch.serving import graphs as G
    B, T = inputs["tables"].shape
    prog = G.horizon_program(model, lambda: (params, cache), B, T,
                             max_len=2048, sampled=sampled, capture=True,
                             stream=torch.cuda.Stream())
    if sampled:
        G.set_sampling(prog.bufs, [0.8] * B, [40] * B, list(range(B)))
    return replayed(prog, inputs, horizon)


def captured_slot(torch, model, params, slots, tok, pos):
    """One slot decode step (and each slot's argmax) as a captured
    program."""
    from repro_torch.serving import graphs as G
    prog = G.slot_program(model, lambda: (params, slots), tok.shape[0],
                          sampled=False, capture=True,
                          stream=torch.cuda.Stream())
    return replayed(prog, {"tokens": tok, "positions": pos})


def capture_times(calls: dict, model_name: str) -> None:
    """Print each captured phase-4 program's capture time: the first step
    with the warm-up, the recording, and capture end with instantiation."""
    for name, (_, fn, _, _) in calls.items():
        prog = getattr(fn, "program", None)
        for w, r, i in getattr(prog, "capture_s", ()):
            print(f"{name} {model_name} capture: first step and warm-up "
                  f"{w * 1e3:.1f} ms, record {r * 1e3:.1f} ms, end and "
                  f"instantiate {i * 1e3:.1f} ms; replays "
                  f"{prog.replays}", flush=True)


def phase4_calls(torch, model, params, horizon: int = 8) -> dict:
    """The serving shape's device calls, as closures over their inputs:
    one bucketed prefill (4 prompts of 40-230 tokens in a 256 bucket), one
    greedy decode horizon (4 lanes at the same positions), the same
    horizon through the block-striped pool at shards 2 and 4 (516 blocks,
    a multiple of both, the lanes' blocks spread over the stripes), one
    chunk tick (4 rows at start 128 past a shared head, tails of 128, 100,
    37 and 5 tokens in a chunk of 128) and one slot decode step (4 slots
    of 2048 at the same positions); each decode horizon, the chunk tick
    and the slot step also as replays of a captured CUDA graph (the
    serving engine's default)."""
    from repro_torch.serving import graphs as G
    from repro_torch.models import build_model
    from repro_torch.serving import PagedCachePool, serving_plan
    B, dev = 4, model.device
    lengths = [230, 180, 120, 40]
    pool = PagedCachePool(model, B, 2048, block_size=16, n_blocks=516)
    slots = model.init_cache(B, 2048, device=dev)
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
    chunk = tokens[:, :128].contiguous()
    starts = torch.full((B,), 128, dtype=torch.int32, device=dev)
    takes = torch.tensor([128, 100, 37, 5], dtype=torch.int32, device=dev)

    def decode(m):
        return lambda: m.decode_multi_paged(
            params, pool.cache, tok, lens, tables, active, budgets, eos,
            num_steps=horizon, max_len=2048)

    lanes = {"tokens": tok, "positions": lens, "tables": tables,
             "active": active, "budgets": budgets, "eos": eos}
    sharded = {}
    for n in (2, 4):
        m = build_model(model.cfg, serving_plan(
            n, param_dtype=model.plan.param_dtype), device=dev)
        label = (f"{B} lanes at positions {lengths}, horizon={horizon}, "
                 f"{n} stripes of {516 // n} blocks")
        sharded[f"decode shards={n}"] = (label, decode(m), horizon, "step")
        sharded[f"decode shards={n} captured"] = (
            label + ", replays of one captured step",
            captured_horizon(torch, m, params, pool.cache, lanes, horizon),
            horizon, "step")
    chunk_prog = G.chunk_program(model, lambda: (params, pool.cache), B, 128,
                                 T, capture=True, stream=torch.cuda.Stream())
    # a speculative round's lane state: each lane's history holds its
    # prompt, the current token at its position
    hist = torch.zeros(B, 2049, dtype=torch.int32, device=dev)
    hist[:, :256] = tokens
    spec_lanes = dict(lanes, hist=hist)

    def verify_round(capture: bool):
        prog = G.spec_program(
            model, None, lambda: (params, pool.cache, None, None), B, T,
            2049, spec_k=4, max_len=2048, ngram=2, capture=capture,
            stream=torch.cuda.Stream() if capture else None)
        return replayed(prog, spec_lanes)

    spec_label = (f"{B} lanes at positions {lengths}, one n-gram verify "
                  f"round (spec_k=4: {B * 5} pseudo-lanes)")
    return {
        "prefill": (f"{B} prompts of {lengths} tokens in a 256 bucket",
                    lambda: model.prefill_ragged(params, tokens, lens), 1,
                    "prefill"),
        "decode": (f"{B} lanes at positions {lengths}, horizon={horizon}",
                   decode(model), horizon, "step"),
        "decode captured": (f"{B} lanes at positions {lengths}, horizon="
                            f"{horizon}, replays of one captured step",
                            captured_horizon(torch, model, params,
                                             pool.cache, lanes, horizon),
                            horizon, "step"),
        "decode sampled captured": (
            f"{B} lanes at positions {lengths}, horizon={horizon}, every "
            f"lane sampled (temperature 0.8, top-k 40), replays of one "
            f"captured step", captured_horizon(
                torch, model, params, pool.cache, lanes, horizon, True),
            horizon, "step"),
        **sharded,
        "chunk": (f"{B} rows at start 128, takes {takes.tolist()} in a "
                  f"chunk of 128",
                  lambda: model.prefill_chunk_paged(
                      params, pool.cache, chunk, starts, takes, tables), 1,
                  "tick"),
        "chunk captured": (f"{B} rows at start 128, takes {takes.tolist()} "
                           f"in a chunk of 128, a captured tick",
                           replayed(chunk_prog, {
                               "tokens": chunk, "starts": starts,
                               "lens": takes, "tables": tables}), 1, "tick"),
        "verify round": (spec_label, verify_round(False), 1, "round"),
        "verify round captured": (spec_label + ", a captured round",
                                  verify_round(True), 1, "round"),
        "slot": (f"{B} slots of 2048 at positions {lengths}",
                 lambda: model.decode_step(params, slots, tok, lens), 1,
                 "step"),
        "slot captured": (f"{B} slots of 2048 at positions {lengths}, a "
                          f"captured step", captured_slot(
                              torch, model, params, slots, tok, lens), 1,
                          "step"),
    }


def host_probe(torch, stage: str, decode, horizon: int = 8) -> None:
    """The decode horizon's host wall per step at one stage of the run,
    beside the caching allocator's state: shows how far the host clock
    drifts while the work stays the same."""
    walls = host_walls(torch, decode, horizon, reps=3)
    print(f"host probe {stage}: decode host wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms/step; allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)


def where_time_goes(torch, calls: dict) -> None:
    # every call is timed before any is traced: decode reps timed right
    # after the prefill's trace read 57.9-66.2 ms/step where the same
    # horizon timed away from a trace read 34.7-42.8 (H100 80GB HBM3, 700 W)
    walls = {name: host_walls(torch, fn, per, reps=5)
             for name, (_, fn, per, _) in calls.items()}
    for name, (label, fn, per, unit) in calls.items():
        trace(torch, f"{name} profile llama2-7b bf16, {label}", fn,
              walls[name], per=per, unit=unit)
    capture_times(calls, "llama2-7b")


# ---------------------------------------------------------------------------
# phase 5: full-width rwkv6-3b through the slot pool
# ---------------------------------------------------------------------------

ATTENTION = ("flash_attention", "paged_decode_attention",
             "paged_decode_attention_lse", "paged_prefill_attention",
             "decode_attention")


def serve_rwkv(torch, model, params) -> dict:
    """``plain_load``'s requests through the slot pool (rwkv6-3b cannot
    serve paged): every request completes, the WKV kernel launches once
    per layer for every prefill and every decode step, and no attention
    kernel runs; the captured run equals its eager twin.  Then
    ``sampled_load`` captured and eager: equal, and its greedy requests
    those of the greedy run.  Returns the launches summed over the runs."""
    L = model.cfg.num_layers
    load = plain_load(model.cfg.vocab_size)
    run = serve(torch, model, params, "slots (paged=None)", load,
                ("rwkv6_wkv",), paged=None)
    eager = serve(torch, model, params, "slots (paged=None) eager", load,
                  ("rwkv6_wkv",), paged=None, graphs=False)
    same_as_eager(run, eager, "rwkv6-3b slots")
    load = sampled_load(model.cfg.vocab_size)
    sampled = [serve(torch, model, params, f"sampled slots{tag}", load,
                     ("rwkv6_wkv",), paged=None, graphs=not tag)
               for tag in ("", " eager")]
    same_as_eager(*sampled, "rwkv6-3b sampled slots")
    greedy_lanes_equal(sampled[0], run, "rwkv6-3b sampled slots")
    st, launches = run["stats"], run["launches"]
    want = L * (st.prefill_batches + st.decode_syncs)
    print(f"rwkv checks: rwkv6_wkv launches={launches['rwkv6_wkv']} ({L} x "
          f"({st.prefill_batches} prefills + {st.decode_syncs} decode steps) "
          f"= {want}); attention kernels "
          f"{ {n: launches[n] for n in ATTENTION} } (all 0)", flush=True)
    if launches["rwkv6_wkv"] != want:
        fail("rwkv: rwkv6_wkv did not launch once per layer, prefill and "
             "decode step")
    if any(launches[n] for n in ATTENTION):
        fail("rwkv: an attention kernel ran on an attention-free model")
    total = dict(launches)
    for other in [eager] + sampled:
        for name, n in other["launches"].items():
            total[name] += n
    return total


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def wkv_other_order(r, k, v, w, u, s0=None, *, s_out=None):
    """The plain recurrence with y summed elementwise over k in place of
    the einsum: the same function in another f32 summation order."""
    import torch
    B, T, H, D = r.shape
    s = torch.zeros(B, H, D, D, device=r.device) if s0 is None else s0.float()
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        bonus = (u.float()[None] * kt)[..., :, None] * vt[..., None, :]
        ys.append((rt[..., :, None] * (s + bonus)).sum(dim=-2))
        s = wt[..., :, None] * s + kv
    y = torch.stack(ys, dim=1).to(r.dtype)
    return y, (s if s_out is None else s_out.copy_(s))


def _reading(torch, vocab: int, what: str, a, b) -> None:
    a, b = a[:, :vocab].float(), b[:, :vocab].float()
    print(f"reading {what} logits: max_abs_err={(a - b).abs().max().item():.4e} "
          f"max|logit|={b.abs().max().item():.3f} argmax_same="
          f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{a.shape[0]}",
          flush=True)


def rwkv_layers_forced(torch, m, params, tokens) -> bool:
    """Every layer of a whole prefill fed the same input (the kernel
    path's hidden state), through the kernel and through its plain
    version: the block's output and its new WKV state, held by the error
    norm over the plain norm (``REL_TOL`` of the plan's dtype)."""
    from repro_torch.models import transformer as TR
    name = "f32" if m.plan.compute_dtype == torch.float32 else "bf16"
    x = m._embed_inputs(params, tokens)
    worst = [0.0, 0.0]
    for i in range(m.cfg.num_layers):
        lp = TR._layer(params["layers"], i)
        xk, ck = TR.block_forward(x, lp, None, m.cfg, m.plan, want_cache=True)
        with plain_versions():
            xp, cp = TR.block_forward(x, lp, None, m.cfg, m.plan,
                                      want_cache=True)
        worst[0] = max(worst[0], compare(xk, xp)[1])
        worst[1] = max(worst[1], compare(ck["tmix"]["wkv"],
                                         cp["tmix"]["wkv"])[1])
        x = xk
    ok = max(worst) <= REL_TOL[name]
    print(f"teacher-forced rwkv {name} plan, each of {m.cfg.num_layers} "
          f"layers fed the same input ({tuple(tokens.shape)} tokens): "
          f"worst rel_err block output {worst[0]:.3e}, WKV state "
          f"{worst[1]:.3e} rel_tol={REL_TOL[name]:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def rwkv_zero_state(torch, m, params, first, plan: str) -> None:
    """Readings: one decode step from a zero state through the kernel,
    through its plain version and through the plain version in another
    summation order, and a one-token prefill beside it (the same
    computation as position 0 of any prefill)."""
    vocab, dev, B = m.cfg.vocab_size, m.device, first.shape[0]
    at0 = torch.zeros(B, dtype=torch.int32, device=dev)

    def step():
        return m.decode_step(params, m.init_cache(B, 1, device=dev), first,
                             at0)[0]

    zk = step()
    with plain_versions():
        zp = step()
    with plain_versions() as ops:
        ops.rwkv6_wkv = wkv_other_order
        zo = step()
    l1, _ = m.prefill(params, first[:, None])
    what = f"rwkv {plan} plan decode step from a zero state"
    _reading(torch, vocab, f"{what}, kernel vs plain", zk, zp)
    _reading(torch, vocab, f"{what}, plain vs plain in another summation "
             f"order", zo, zp)
    _reading(torch, vocab, f"rwkv {plan} plan one-token prefill vs decode "
             f"step from a zero state, both through the kernel", l1, zk)


def teacher_forced_rwkv(torch, model, params):
    """Teacher-forced checks of rwkv6-3b on 4 prompts of 200 tokens, in
    the serving (bf16) plan and in an f32 compute plan over the same bf16
    weights.

    Checks, in both plans: one slot decode step from a prefill's state,
    through the kernel and through its plain version (the argmax-with-
    margin rule), and a whole prefill with every layer fed the same input
    (``rwkv_layers_forced``); in the bf16 plan, the state carried through
    the model: prefill of the first 192 tokens and one decode step per
    remaining token against the 200-token prefill.

    Readings, in the f32 plan: the whole prefill through the kernel
    against the plain version, beside the plain version against itself
    in another f32 summation order (on this random-weight model the two
    differ about as much, so that comparison does not hold the kernel);
    and one decode step from a zero state (``rwkv_zero_state``)."""
    from repro_torch.models import build_model, local_plan
    vocab, dev = model.cfg.vocab_size, model.device
    B, S, head = 4, 200, 192
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, vocab, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    ok = True
    f32_model = build_model(model.cfg, local_plan(
        param_dtype=torch.bfloat16, compute_dtype=torch.float32))
    for plan, m in (("bf16", model), ("f32", f32_model)):
        lk, state = m.prefill(params, tokens)
        if plan == "f32":
            with plain_versions():
                lp, _ = m.prefill(params, tokens)
            with plain_versions() as ops:
                ops.rwkv6_wkv = wkv_other_order
                lo, _ = m.prefill(params, tokens)
            _reading(torch, vocab, "rwkv f32 plan prefill, kernel vs plain",
                     lk, lp)
            _reading(torch, vocab, "rwkv f32 plan prefill, plain vs plain "
                     "in another summation order", lo, lp)
            rwkv_zero_state(torch, m, params, tokens[:, 0].contiguous(),
                            plan)
        ok &= rwkv_layers_forced(torch, m, params, tokens)
        nxt = lk[:, :vocab].argmax(-1).to(torch.int32)
        state_copy = _clone(state)
        dk, _ = m.decode_step(params, state, nxt, pos)
        with plain_versions():
            dp, _ = m.decode_step(params, state_copy, nxt, pos)
        ok &= logits_agree(torch, vocab, f"rwkv {plan} plan slot decode, "
                           f"kernel vs plain", dk, dp)
        del state, state_copy
        if plan != "bf16":
            continue
        _, carried = m.prefill(params, tokens[:, :head])
        for t in range(head, S):
            lc, _ = m.decode_step(params, carried, tokens[:, t].contiguous(),
                                  torch.full((B,), t, dtype=torch.int32,
                                             device=dev))
        ok &= logits_agree(torch, vocab, f"rwkv bf16 plan prefill {head} + "
                           f"{S - head} decode steps vs prefill {S}", lc, lk)
        del carried
    torch.cuda.empty_cache()
    if not ok:
        fail("teacher-forced rwkv6-3b disagrees")


def rwkv_phase4_calls(torch, model, params) -> dict:
    """One request's prefill (200 tokens; the slot pool prefills one
    request at a time) and one slot decode step over 4 slots."""
    dev = model.device
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 200), device=dev,
                           dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(6))
    slots = model.init_cache(4, 2048, device=dev)
    tok = tokens[0, :4].contiguous()
    pos = torch.tensor([230, 180, 120, 40], dtype=torch.int32, device=dev)
    return {
        "prefill": ("1 prompt of 200 tokens",
                    lambda: model.prefill(params, tokens), 1, "prefill"),
        "slot": ("4 slots", lambda: model.decode_step(params, slots, tok,
                                                      pos), 1, "step"),
        "slot captured": ("4 slots, a captured step", captured_slot(
            torch, model, params, slots, tok, pos), 1, "step"),
    }


def rwkv_phases(torch) -> dict:
    """Phases 2-4 for full-width rwkv6-3b; returns the serve run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, local_plan
    cfg = get_config("rwkv6-3b")
    model = build_model(cfg, local_plan(param_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    # param_count leaves out the per-layer vectors: the six token-shift
    # mixes (mu_base, mu) and decay_base, u_bonus, ln_x of the time-mix,
    # mu_k and mu_r of the channel-mix
    vectors = cfg.num_layers * (8 * cfg.d_model
                                + 3 * cfg.n_heads * cfg.head_dim)
    print(f"rwkv6-3b full width: {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.n_heads} x {cfg.head_dim} d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab_size}; {n_params} params in bf16 "
          f"(config's count {cfg.param_count()} + {vectors} per-layer "
          f"vector entries), init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    if n_params != cfg.param_count() + vectors:
        fail(f"rwkv6-3b parameter count {n_params} != "
             f"{cfg.param_count()} + {vectors}")
    launches = serve_rwkv(torch, model, params)
    teacher_forced_rwkv(torch, model, params)
    calls = rwkv_phase4_calls(torch, model, params)
    walls = {name: host_walls(torch, fn, per, reps=5)
             for name, (_, fn, per, _) in calls.items()}
    for name, (label, fn, per, unit) in calls.items():
        trace(torch, f"{name} profile rwkv6-3b bf16, {label}", fn,
              walls[name], per=per, unit=unit)
    capture_times(calls, "rwkv6-3b")
    del model, params, calls
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: full-width granite-moe-3b-a800m and its int8-expert variant
# ---------------------------------------------------------------------------

def granite_models(torch):
    """Both variants from seed 0: the full variant in bf16, the int8
    variant (``quantize_serve``) from the same draws, quantized.  Checks
    the parameter counts (the config's; plus the int8 variant's scales)
    and that the int8 experts of the first and last layer are the full
    variant's, quantized."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, local_plan
    from repro_torch.models import moe as M
    cfg = get_config("granite-moe-3b-a800m")
    out = {}
    for name, q in (("full", False), ("int8", True)):
        model = build_model(cfg, local_plan(param_dtype=torch.bfloat16,
                                            quantize_serve=q))
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        leaves = list(_leaves(params))
        n = sum(t.numel() for t in leaves)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        scales = q * cfg.num_layers * cfg.n_experts * (2 * cfg.expert_d_ff
                                                      + cfg.d_model)
        print(f"granite-moe-3b-a800m {name}: {cfg.num_layers} layers d_model "
              f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} x "
              f"{cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k} of "
              f"d_ff {cfg.expert_d_ff}, vocab {cfg.vocab_size}, tied; {n} "
              f"params ({cfg.param_count()} + {scales} scales), "
              f"{n_bytes / 2**30:.2f} GiB, init "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
        if n != cfg.param_count() + scales:
            fail(f"granite {name}: parameter count {n} != "
                 f"{cfg.param_count()} + {scales}")
        out[name] = (model, params)
    full, q = out["full"][1]["layers"]["moe"], out["int8"][1]["layers"]["moe"]
    for i in (0, cfg.num_layers - 1):
        for w in M.EXPERT_WEIGHTS:
            w_q, s_ = M._quantize_experts(full[w][i])
            if not (torch.equal(w_q, q[w + "_q"][i])
                    and torch.equal(s_, q[w + "_s"][i])):
                fail(f"granite int8 layer {i} {w} is not the full variant's "
                     f"quantized")
    print(f"granite int8 variant: layers 0 and {cfg.num_layers - 1} hold "
          f"the full variant's experts quantized", flush=True)
    return out


def serve_granite(torch, variants) -> dict:
    """``plain_load`` on the full variant at horizon 1 and 8 (identical
    streams), then at horizon 8 with ``set_variant("int8")`` after two
    scheduler steps.  Each run checks completion, kernels 1 and 2 once per
    layer for every prefill batch and decode step, and the pool; the swap
    run one swap and at least one preemption per request in flight at the
    swap.  Returns the launches summed over the runs."""
    from repro_torch.serving import Engine, EngineKnobs
    model, params = variants["full"]
    L = model.cfg.num_layers
    paged = ("flash_attention", "paged_decode_attention")
    load = plain_load(model.cfg.vocab_size)
    runs = [serve(torch, model, params, "full horizon=1", load, paged,
                  horizon=1),
            serve(torch, model, params, "full horizon=8", load, paged,
                  horizon=8)]
    if runs[0]["streams"] != runs[1]["streams"]:
        fail("granite: greedy streams differ between horizon 1 and 8")
    print("granite greedy streams identical at horizon 1 and 8", flush=True)
    eng = Engine(model, params, max_seq=2048, n_slots=4,
                 knobs=EngineKnobs(max_batch=4), block_size=16, horizon=8)
    eng.add_variant("int8", *variants["int8"])
    swap = drive(torch, eng, "horizon=8, full then int8", load, paged,
                 swap=(2, "int8"))
    del eng
    torch.cuda.empty_cache()
    eng = Engine(model, params, max_seq=2048, n_slots=4,
                 knobs=EngineKnobs(max_batch=4), block_size=16, horizon=8,
                 graphs=False)
    eng.add_variant("int8", *variants["int8"])
    swap_eager = drive(torch, eng, "horizon=8, full then int8, eager", load,
                       paged, swap=(2, "int8"))
    del eng
    torch.cuda.empty_cache()
    same_as_eager(swap, swap_eager, "granite full then int8")
    # phase 13: granite's shard degrees, refused by its vocabulary
    granite_refuses_shards(torch, variants)
    st = swap["stats"]
    print(f"granite swap checks: variant_swaps={st.variant_swaps} (1), "
          f"preemptions={st.preemptions} (>= {swap['in_flight']} in flight "
          f"at the swap); {same_streams(swap['streams'], runs[1]['streams'])}"
          f"/8 streams equal to the full variant's (a reading: requests "
          f"finished before the swap are the full variant's)", flush=True)
    if st.variant_swaps != 1 or not swap["in_flight"] \
            or st.preemptions < swap["in_flight"]:
        fail("granite: set_variant did not swap once, preempting every "
             "request in flight")
    for run in runs + [swap, swap_eager]:
        st, la = run["stats"], run["launches"]
        if (la["flash_attention"] != L * st.prefill_batches
                or la["paged_decode_attention"] != L * run["steps"]):
            fail(f"granite: kernels 1/2 did not launch once per layer and "
                 f"prefill batch / decode step ({la})")
    total = {}
    for run in runs + [swap, swap_eager]:
        for name, n in run["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def _reading_top1(torch, vocab: int, what: str, a, b) -> None:
    a, b = a[:, :vocab].float(), b[:, :vocab].float()
    same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"reading {what}: top-1 agreement {same:.4f} over {a.shape[0]} "
          f"rows, max_abs_diff {(a - b).abs().max().item():.4e}, "
          f"max|logit| {b.abs().max().item():.3f}", flush=True)


def _granite_pool(torch, model, cache, lengths, dtype):
    """A paged pool of ``dtype`` holding a 4-row prefill's cache, each
    row's next block allocated."""
    from repro_torch.serving import PagedCachePool
    pool = PagedCachePool(model, 4, 2048, block_size=16, dtype=dtype)
    for i, n in enumerate(lengths.tolist()):
        pool.insert(100 + i, cache, i, n)
    pool.ensure_append_blocks([100 + i for i in range(4)])
    return pool


def _granite_decode(model, params, pool, nxt):
    """One paged decode step of ``nxt`` on a copy of ``pool``'s cache."""
    cache = {"attn": {n: t.clone() for n, t in pool.cache["attn"].items()}}
    logits, _ = model.decode_step_paged(params, cache, nxt, pool.positions(),
                                        pool.tables())
    return logits


def teacher_forced_granite(torch, variants):
    """Per variant, prefill through the kernels and through the plain
    versions, then one paged decode step both ways from copies of one
    pool, filled by the kernels' prefill, in the plan's compute dtype (an
    f32 pool in the f32 plan, so the new token's K/V, f32 values a few
    ulp apart on the two paths, are not rounded to bf16 neighbours).
    Checked at ``TOL["f32"]`` (``logits_agree``) in an f32 compute plan
    over the bf16 weights, a reading in the serving bf16 plan, where a
    rounding step of the attention output can move a token's top-8
    routing at a near-tie (the router is discontinuous).  Then the int8
    variant against the full one in the serving plan, both through the
    kernels: top-1 agreement and max abs difference, a reading (the
    knob's quality cost on random weights)."""
    from repro_torch.models import build_model, local_plan
    model = variants["full"][0]
    vocab = model.cfg.vocab_size
    tokens, lengths = _prompts(torch, model, 1)
    ok = True
    served = {}
    for name, (m, p) in variants.items():
        for plan, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            mm = build_model(m.cfg, local_plan(
                param_dtype=torch.bfloat16, compute_dtype=cdt,
                quantize_serve=m.plan.quantize_serve), device=m.device)
            lk, ck = mm.prefill_ragged(p, tokens, lengths)
            with plain_versions():
                lp, cp = mm.prefill_ragged(p, tokens, lengths)
            what = f"granite {name} {plan} plan"
            if plan == "f32":
                # why two bf16 pools, one filled by each prefill, decode
                # apart: their K/V round to different bf16 neighbours
                pairs = list(zip(_leaves(ck), _leaves(cp)))
                differ = sum(int((a.bfloat16() != b.bfloat16()).sum())
                             for a, b in pairs)
                print(f"reading {what}: {differ} of "
                      f"{sum(a.numel() for a, _ in pairs)} prefill K/V "
                      f"entries round to a different bf16 value, kernel vs "
                      f"plain prefill", flush=True)
            del cp
            pool = _granite_pool(torch, mm, ck, lengths, cdt)
            del ck
            nxt = lk[:, :vocab].argmax(-1).to(torch.int32)
            dk = _granite_decode(mm, p, pool, nxt)
            with plain_versions():
                dp = _granite_decode(mm, p, pool, nxt)
            del pool
            tol = TOL["f32"] if plan == "f32" else None
            agree = logits_agree(torch, vocab, f"{what} prefill, kernel vs "
                                 f"plain", lk, lp, tol)
            agree &= logits_agree(torch, vocab, f"{what} paged decode, "
                                  f"kernel vs plain", dk, dp, tol)
            if plan == "f32":
                ok &= agree
            else:
                print(f"  ({what}: a reading, not a check)", flush=True)
                served[name] = (lk, dk, nxt)
            torch.cuda.empty_cache()
    _, _, nxt = served["full"]
    m8, p8 = variants["int8"]
    lq, cq = m8.prefill_ragged(p8, tokens, lengths)
    dq = _granite_decode(m8, p8, _granite_pool(torch, m8, cq, lengths,
                                               torch.bfloat16), nxt)
    del cq
    _reading_top1(torch, vocab, "granite int8 vs full prefill logits",
                  lq, served["full"][0])
    _reading_top1(torch, vocab, "granite int8 vs full paged decode logits "
                  "(same input token)", dq, served["full"][1])
    torch.cuda.empty_cache()
    if not ok:
        fail("teacher-forced granite kernel path disagrees with the plain "
             "path (f32 plan)")


def int8_on_served_data(torch, variants) -> dict:
    """Kernel 6 on the served model's own data: layer 0's MoE input in a
    prefill of ``_prompts`` (4 rows in a 256 bucket: capacity 256 per
    expert), taken from the model's own ``_moe_core`` call with the
    dequantized experts it was given, the rows routed to the expert with
    the most tokens, and that expert's weights: gate and up (256 x 1536 @
    1536 x 512), then down on its ``act * up`` (256 x 512 @ 512 x 1536),
    each through ``ops.int8_matmul_quantized`` with every launch count set
    to 0 before and read after.  Checks: bit-exact against quantize +
    plain.  Readings: the error against the bf16 expert GEMM the model
    runs (w8a16).  Returns the launches."""
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ops
    from repro_torch.models import moe as M
    model, params = variants["int8"]
    tokens, lengths = _prompts(torch, model, 1)
    seen, core = [], M._moe_core

    def first_call(x, router_w, *weights, **kw):
        if not seen:
            seen.append((x, router_w, weights, kw))
        return core(x, router_w, *weights, **kw)

    M._moe_core = first_call
    try:
        model.prefill_ragged(params, tokens, lengths)
    finally:
        M._moe_core = core
    x, router_w, weights, kw = seen[0]
    cap = kw["capacity"]
    topv, topi, _ = M.route(x, router_w, kw["cfg"])
    buf_src, _, _ = M.dispatch(topv, topi, e_pad=kw["e_pad"], capacity=cap)
    filled = (buf_src < x.shape[0]).reshape(kw["e_pad"], cap).sum(1)
    e = int(filled.argmax())
    xg = torch.cat([x, x.new_zeros(1, x.shape[1])])[buf_src].reshape(
        kw["e_pad"], cap, -1)[e]
    w = {n: t[e] for n, t in zip(M.EXPERT_WEIGHTS, weights)}
    act = (torch.nn.functional.silu((xg @ w["w_gate"]).float())
           .to(xg.dtype) * (xg @ w["w_up"]))
    calls = {"gate": (xg, w["w_gate"]), "up": (xg, w["w_up"]),
             "down": (act, w["w_down"])}
    torch.cuda.synchronize()
    reset_launches()
    outs = {k: ops.int8_matmul_quantized(a, b) for k, (a, b) in calls.items()}
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"kernel 6 on granite's served data: layer 0, expert {e} "
          f"({int(filled[e])} of {cap} rows filled; {int((filled == cap).sum())}"
          f" experts full), launches {launches['int8_matmul']}", flush=True)
    for k, (a, b) in calls.items():
        same = torch.equal(outs[k], i8.int8_matmul_quantized_ref(a, b))
        ref = a @ b
        rel = ((outs[k].float() - ref.float()).abs().mean()
               / ref.float().abs().mean()).item()
        print(f"  {k}: {tuple(a.shape)} @ {tuple(b.shape)} bit-exact against "
              f"quantize + plain={same}; reading: w8a8 against the bf16 "
              f"expert GEMM mean relative error {rel:.4e}, max abs "
              f"{(outs[k].float() - ref.float()).abs().max().item():.4e} "
              f"(max|ref| {ref.float().abs().max().item():.3f})", flush=True)
        if not same:
            fail(f"kernel 6 on granite's {k} GEMM is not bit-exact")
    if launches["int8_matmul"] != len(calls):
        fail("kernel 6 did not launch once per ops.int8_matmul_quantized")
    return launches


def granite_calls(torch, model, params, name: str) -> dict:
    """One bucketed prefill (4 prompts of 40-230 tokens in a 256 bucket)
    and one greedy decode horizon of 8 (4 lanes at the same positions)."""
    from repro_torch.serving import PagedCachePool
    B, dev, lengths = 4, model.device, [230, 180, 120, 40]
    pool = PagedCachePool(model, B, 2048, block_size=16, n_blocks=516)
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
    return {
        f"prefill {name}": (f"{B} prompts of {lengths} tokens in a 256 bucket",
                            lambda: model.prefill_ragged(params, tokens, lens),
                            1, "prefill"),
        f"decode {name}": (f"{B} lanes at positions {lengths}, horizon=8",
                           lambda: model.decode_multi_paged(
                               params, pool.cache, tok, lens, tables, active,
                               budgets, eos, num_steps=8, max_len=2048),
                           8, "step"),
        f"decode {name} captured": (
            f"{B} lanes at positions {lengths}, horizon=8, replays of one "
            f"captured step", captured_horizon(
                torch, model, params, pool.cache,
                {"tokens": tok, "positions": lens, "tables": tables,
                 "active": active, "budgets": budgets, "eos": eos}, 8),
            8, "step"),
    }


def granite_phases(torch) -> dict:
    """Phase 6; returns the launches of its serve runs and of kernel 6 on
    the served data."""
    variants = granite_models(torch)
    launches = serve_granite(torch, variants)
    teacher_forced_granite(torch, variants)
    for name, n in int8_on_served_data(torch, variants).items():
        launches[name] += n
    calls = {}
    for name, (m, p) in variants.items():
        calls.update(granite_calls(torch, m, p, name))
    walls = {name: host_walls(torch, fn, per, reps=3)
             for name, (_, fn, per, _) in calls.items()}
    for name, (label, fn, per, unit) in calls.items():
        trace(torch, f"{name} profile granite-moe-3b-a800m bf16, {label}",
              fn, walls[name], per=per, unit=unit)
    capture_times(calls, "granite-moe-3b-a800m")
    del variants, calls
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: full-width hymba-1.5b through the slot pool
# ---------------------------------------------------------------------------

def hymba_load(vocab: int) -> list:
    """Four of ``plain_load``'s prompts (16-200 tokens), then four long
    prompts of 1000, 1400, 1700 and 1990 tokens, 32 new tokens each: the
    1000-token request's ring wraps while it decodes, the others' prefills
    band (S > window 1024)."""
    import numpy as np
    rng = np.random.default_rng(7)
    return plain_load(vocab)[:4] + [
        ([int(t) for t in rng.integers(0, vocab, n)], 32)
        for n in (1000, 1400, 1700, 1990)]


def hymba_model(torch):
    """Full-width hymba-1.5b in bf16 from seed 0; checks the parameter
    count: the config's, plus what its formula leaves out of each Mamba
    branch (``w_bcdt``'s and ``w_dt``'s dt-rank columns and rows, ``a_log``
    and ``d_skip``, less one vector it counts)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, local_plan
    from repro_torch.models import ssm as SS
    cfg = get_config("hymba-1.5b")
    model = build_model(cfg, local_plan(param_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n = sum(t.numel() for t in leaves)
    di, dtr = cfg.d_inner, SS._dt_rank(cfg)
    extra = cfg.num_layers * (2 * dtr * di + cfg.ssm_state * di + di)
    ring = 2 * min(cfg.window, 2048) * cfg.n_kv_heads * cfg.head_dim * 2 \
        * cfg.num_layers
    state = cfg.num_layers * ((cfg.conv_width - 1) * di * 2
                              + di * cfg.ssm_state * 4)
    print(f"hymba-1.5b full width: {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim}, window {cfg.window}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, Mamba d_inner {di} state {cfg.ssm_state} conv "
          f"{cfg.conv_width} dt rank {dtr}; {n} params ({cfg.param_count()} "
          f"+ {extra}), {sum(t.numel() * t.element_size() for t in leaves) / 2**30:.2f} "
          f"GiB in bf16, init {time.perf_counter() - t0:.1f} s; per slot a "
          f"ring of {ring} B and {state} B of Mamba state", flush=True)
    if n != cfg.param_count() + extra:
        fail(f"hymba-1.5b parameter count {n} != {cfg.param_count()} + "
             f"{extra}")
    return model, params


def serve_hymba(torch, model, params) -> dict:
    """``hymba_load`` through the slot pool (hymba cannot serve paged):
    every request completes; kernel 1 launches once per layer and prefill,
    in its window form (banded) for each prompt longer than the window;
    kernel 5 once per layer and decode step; no other attention kernel."""
    cfg, L = model.cfg, model.cfg.num_layers
    load = hymba_load(cfg.vocab_size)
    need = ("flash_attention", "flash_attention_window", "decode_attention")
    run = serve(torch, model, params, "slots (paged=None)", load, need,
                paged=None)
    eager = serve(torch, model, params, "slots (paged=None) eager", load,
                  need, paged=None, graphs=False)
    same_as_eager(run, eager, "hymba-1.5b slots")
    st, la = run["stats"], run["launches"]
    banded = L * sum(len(p) > cfg.window for p, _ in load)
    others = {n: la[n] for n in ATTENTION + ("rwkv6_wkv", "int8_matmul")
              if n not in ("flash_attention", "decode_attention")}
    print(f"hymba checks: flash_attention launches={la['flash_attention']} "
          f"({L} x {st.prefill_batches} prefills = "
          f"{L * st.prefill_batches}), of them banded="
          f"{la['flash_attention_window']} ({L} x "
          f"{banded // L} prompts longer than the window = {banded}); "
          f"decode_attention launches={la['decode_attention']} ({L} x "
          f"{st.decode_syncs} decode steps = {L * st.decode_syncs}); other "
          f"kernels {others} (all 0)", flush=True)
    if (la["flash_attention"] != L * st.prefill_batches
            or st.prefill_batches != len(load)
            or la["flash_attention_window"] != banded
            or la["decode_attention"] != L * st.decode_syncs
            or any(others.values())):
        fail("hymba: the kernels did not launch as the slot path runs them")
    return {name: n + eager["launches"][name] for name, n in la.items()}


def _hymba_slots(torch, model, cache, dtype):
    """A slot cache of ``dtype`` (ring 1024 wide at max_seq 2048) holding
    a B-row prefill's cache as ``CachePool.insert`` places it: a ring from
    a prompt shorter than the window fills a prefix of the slot, a full
    ring and the Mamba state the whole slot."""
    B = cache["attn"]["k"].shape[1]
    slots = model.init_cache(B, 2048, dtype=dtype, device=model.device)
    for part, leaves in cache.items():
        for name, src in leaves.items():
            dst = slots[part][name]
            dst[:, :, :src.shape[2]] = src.to(dst.dtype)
    return slots


def teacher_forced_hymba(torch, model, params):
    """Teacher-forced checks of full-width hymba-1.5b.

    Kernels against plain versions on the card: a 1536-token prefill of
    two prompts (kernel 1's window form) and one slot decode step from
    copies of one slot cache filled by the kernels' prefill (kernel 5 over
    the ring), checked at ``TOL["f32"]`` in an f32 compute plan over an
    f32 cache (bf16 weights), read in the serving bf16 plan.  Carry
    across the wrap, through the kernels, in the f32 plan: prefill of the
    first 1000 tokens of a 1064-token prompt, then the remaining 64
    teacher-forced one decode step each (the ring wraps at 1024), against
    the prefill of all 1064 tokens, at ``TOL["f32"]``."""
    from repro_torch.models import build_model, local_plan
    vocab, dev = model.cfg.vocab_size, model.device
    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, vocab, (2, 1536), generator=gen, device=dev,
                           dtype=torch.int32)
    ok = True
    f32 = build_model(model.cfg, local_plan(param_dtype=torch.bfloat16,
                                            compute_dtype=torch.float32))
    for plan, m, cdt in (("f32", f32, torch.float32),
                         ("bf16", model, torch.bfloat16)):
        lk, ck = m.prefill(params, tokens)
        with plain_versions():
            lp, _ = m.prefill(params, tokens)
        slots = _hymba_slots(torch, m, ck, cdt)
        del ck
        nxt = lk[:, :vocab].argmax(-1).to(torch.int32)
        pos = torch.full((2,), tokens.shape[1], dtype=torch.int32,
                         device=dev)
        copy = _clone(slots)
        dk, _ = m.decode_step(params, slots, nxt, pos)
        with plain_versions():
            dp, _ = m.decode_step(params, copy, nxt, pos)
        del slots, copy
        tol = TOL["f32"] if plan == "f32" else None
        what = f"hymba {plan} plan"
        agree = logits_agree(torch, vocab, f"{what} prefill 1536 (window "
                             f"form), kernel vs plain", lk, lp, tol)
        agree &= logits_agree(torch, vocab, f"{what} slot decode at 1536 "
                              f"(ring), kernel vs plain", dk, dp, tol)
        if plan == "f32":
            ok &= agree
        else:
            print(f"  ({what}: a reading, not a check)", flush=True)
        torch.cuda.empty_cache()
    head, total = 1000, 1064
    prompt = tokens[:, :total].contiguous()
    want, _ = f32.prefill(params, prompt)
    _, cache = f32.prefill(params, prompt[:, :head])
    slots = _hymba_slots(torch, f32, cache, torch.float32)
    del cache
    for t in range(head, total):
        got, _ = f32.decode_step(params, slots, prompt[:, t].contiguous(),
                                 torch.full((2,), t, dtype=torch.int32,
                                            device=dev))
    del slots
    ok &= logits_agree(torch, vocab, f"hymba f32 plan prefill {head} + "
                       f"{total - head} decode steps across the ring's wrap "
                       f"vs prefill {total}", got, want, TOL["f32"])
    torch.cuda.empty_cache()
    if not ok:
        fail("teacher-forced hymba-1.5b disagrees (f32 plan)")


def hymba_calls(torch, model, params) -> dict:
    """One request's prefill (1536 tokens; the slot pool prefills one
    request at a time) and one slot decode step over 4 slots at positions
    1990, 1400, 1000 and 200 (three rings wrapped)."""
    dev = model.device
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 1536), device=dev,
                           dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(12))
    slots = model.init_cache(4, 2048, device=dev)
    tok = tokens[0, :4].contiguous()
    pos = torch.tensor([1990, 1400, 1000, 200], dtype=torch.int32,
                       device=dev)
    return {
        "prefill": ("1 prompt of 1536 tokens (window form)",
                    lambda: model.prefill(params, tokens), 1, "prefill"),
        "slot": (f"4 slots at positions {pos.tolist()}",
                 lambda: model.decode_step(params, slots, tok, pos), 1,
                 "step"),
        "slot captured": (f"4 slots at positions {pos.tolist()}, a captured "
                          f"step", captured_slot(torch, model, params, slots,
                                                 tok, pos), 1, "step"),
    }


def hymba_phases(torch) -> dict:
    """Phase 7; returns the serve run's launches."""
    model, params = hymba_model(torch)
    launches = serve_hymba(torch, model, params)
    teacher_forced_hymba(torch, model, params)
    calls = hymba_calls(torch, model, params)
    walls = {name: host_walls(torch, fn, per, reps=3)
             for name, (_, fn, per, _) in calls.items()}
    for name, (label, fn, per, unit) in calls.items():
        trace(torch, f"{name} profile hymba-1.5b bf16, {label}", fn,
              walls[name], per=per, unit=unit)
    capture_times(calls, "hymba-1.5b")
    del model, params, calls
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 8: full-width hubert-xlarge's encoder forward
# ---------------------------------------------------------------------------

def hubert_model(torch):
    """Full-width hubert-xlarge in bf16 from seed 0; checks the parameter
    count: the config's, plus what its formula leaves out (the LayerNorm
    biases and the MLP's two biases)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, local_plan
    cfg = get_config("hubert-xlarge")
    model = build_model(cfg, local_plan(param_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n = sum(t.numel() for t in leaves)
    d, L = cfg.d_model, cfg.num_layers
    extra = (2 * L + 1) * d + L * (cfg.d_ff + d)
    print(f"hubert-xlarge full width: {L} layers d_model {d} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, bidirectional, LayerNorm, "
          f"GELU MLP, frame-embedding inputs; {n} params "
          f"({cfg.param_count()} + {extra}), "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 2**30:.2f} "
          f"GiB in bf16, init {time.perf_counter() - t0:.1f} s", flush=True)
    if n != cfg.param_count() + extra:
        fail(f"hubert-xlarge parameter count {n} != {cfg.param_count()} + "
             f"{extra}")
    return model, params


def hubert_frames(torch, model):
    """4 clips of 1000 frames of frame embeddings (20 s of audio at
    HuBERT's 20 ms frame stride; the CNN frontend is a stub in the
    reference too), N(0, 1) in f32 from seed 13."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    return torch.randn(4, 1000, model.cfg.d_model, generator=gen,
                       device="cuda")


def hubert_forward(torch, model, params, frames) -> dict:
    """``Model.logits`` through the kernels with every launch count set to
    0 just before and read just after: per-frame logits (4, 1000, 504),
    finite; kernel 1 once per layer, every launch bidirectional, no other
    attention kernel.  Then ``Model.prefill``: its last-frame logits
    against the forward's, its cache (L, 4, 1000, K, hd)."""
    cfg, L = model.cfg, model.cfg.num_layers
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits = model.logits(params, frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    la = read_launches()
    others = {n: la[n] for n in ATTENTION + ("rwkv6_wkv", "int8_matmul")
              if n != "flash_attention"}
    shape = (frames.shape[0], frames.shape[1], cfg.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    print(f"hubert forward: logits {tuple(logits.shape)} (want {shape}), "
          f"finite={finite}, max|logit| {logits.float().abs().max().item():.3f}"
          f", {wall * 1e3:.1f} ms host wall; flash_attention launches="
          f"{la['flash_attention']} ({L} layers), of them bidirectional="
          f"{la['flash_attention_bidirectional']}, banded="
          f"{la['flash_attention_window']}; other kernels {others} (all 0)",
          flush=True)
    if tuple(logits.shape) != shape or not finite:
        fail("hubert: the forward's logits are not finite of the expected "
             "shape")
    if (la["flash_attention"] != L or la["flash_attention_bidirectional"] != L
            or la["flash_attention_window"] or any(others.values())):
        fail("hubert: the forward did not launch kernel 1's bidirectional "
             "form once per layer and nothing else")
    tensor_core_route(la, "hubert forward")
    last, cache = model.prefill(params, frames)
    want = (L, frames.shape[0], frames.shape[1], cfg.n_kv_heads,
            cfg.head_dim)
    shapes = {n: tuple(t.shape) for n, t in cache["attn"].items()}
    print(f"hubert prefill: cache {shapes} (want k and v {want})",
          flush=True)
    if set(cache) != {"attn"} or any(sh != want for sh in shapes.values()) \
            or set(shapes) != {"k", "v"}:
        fail("hubert: prefill's cache is not (L, B, S, K, hd) k and v")
    del cache
    if not logits_agree(torch, cfg.vocab_size, "hubert prefill last frame "
                        "vs logits[:, -1]", last, logits[:, -1]):
        fail("hubert: prefill's last-frame logits differ from the forward's")
    torch.cuda.empty_cache()
    return la, logits


def hubert_kernel_vs_plain(torch, model, params, frames, logits) -> None:
    """The whole forward through the kernels against the plain versions on
    the card: in an f32 compute plan (bf16 weights, TF32 off) held at 1e-4
    of max |logit|; in the serving bf16 plan a reading (max error, argmax
    per frame)."""
    from repro_torch.models import build_model, local_plan
    vocab = model.cfg.vocab_size
    f32 = build_model(model.cfg, local_plan(param_dtype=torch.bfloat16,
                                            compute_dtype=torch.float32))
    lk = f32.logits(params, frames).reshape(-1, vocab)
    with plain_versions():
        lp = f32.logits(params, frames).reshape(-1, vocab)
    scale = max(1.0, lp.abs().max().item())
    ok = logits_agree(torch, vocab, "hubert f32 plan forward (4 x 1000 "
                      "frames), kernel vs plain", lk, lp, 1e-4 * scale)
    del lk, lp
    with plain_versions():
        lp = model.logits(params, frames).reshape(-1, vocab)
    _reading(torch, vocab, "hubert bf16 plan forward (4 x 1000 frames), "
             "kernel vs plain", logits.reshape(-1, vocab), lp)
    del lp
    torch.cuda.empty_cache()
    if not ok:
        fail("hubert-xlarge forward: kernel and plain versions disagree "
             "(f32 plan)")


def hubert_phases(torch) -> dict:
    """Phase 8; returns the forward's launches."""
    model, params = hubert_model(torch)
    frames = hubert_frames(torch, model)
    launches, logits = hubert_forward(torch, model, params, frames)
    hubert_kernel_vs_plain(torch, model, params, frames, logits)
    del logits
    fwd = lambda: model.logits(params, frames)  # noqa: E731
    walls = host_walls(torch, fwd, 1, reps=3)
    trace(torch, "forward profile hubert-xlarge bf16, 4 clips of 1000 "
          "frames", fwd, walls, per=1, unit="forward")
    del model, params, frames
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9: full-width llama2-13b with the llama2-7b drafter
# ---------------------------------------------------------------------------

def cut(name: str):
    """``name``'s config at its published widths and the depth of
    ``CUT_LAYERS`` (phases 9, 10 and 12, beside the full-depth llama2-7b of
    phases 2-4)."""
    from repro_torch.configs import get_config
    return get_config(name).replace(num_layers=CUT_LAYERS[name])


def llama13b_models(torch) -> tuple:
    """Full-width llama2-13b (seed 0) and its registered drafter,
    llama2-7b (seed 100, the reference ``EngineSpec``'s first drafter
    seed), random bf16 weights, each at the depth of ``CUT_LAYERS``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.drafters import drafter_for
    from repro_torch.models import build_model, local_plan
    out = []
    for name, seed in (("llama2-13b", 0), (drafter_for("llama2-13b"), 100)):
        cfg = cut(name)
        model = build_model(cfg, local_plan(param_dtype=torch.bfloat16))
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"{name} full width: {cfg.num_layers} layers (of "
              f"{get_config(name).num_layers}) d_model "
              f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} d_ff "
              f"{cfg.d_ff} vocab {cfg.vocab_size}; {n_params} params in "
              f"bf16, init {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
        if n_params != cfg.param_count():
            fail(f"{name} parameter count {n_params} != "
                 f"{cfg.param_count()}")
        out.append((model, params))
    return tuple(out)


def drafter_round_calls(torch, target, drafter) -> dict:
    """One speculative round of ``target`` with ``drafter``'s drafts (4
    lanes at positions 230/180/120/40 over pools of 516 blocks, spec_k 4:
    4 drafter steps, the backfill step and the verify pass over 20
    pseudo-lanes), eager and as a captured program, and the drafter's 5
    steps alone, eager and captured: (label, fn, per, unit) as
    ``phase4_calls``'s."""
    from repro_torch.models import transformer as TT
    from repro_torch.serving import PagedCachePool
    from repro_torch.serving import graphs as G
    (tm, tp), (dm, dp) = target, drafter
    B, dev, k = 4, tm.device, SPEC["spec_k"]
    lengths = [230, 180, 120, 40]
    pool = PagedCachePool(tm, B, 2048, block_size=16, n_blocks=516)
    pool.attach_draft(dm)
    T = pool.blocks_per_seq
    g = torch.Generator(device=dev).manual_seed(3)
    hist = torch.zeros(B, 2049, dtype=torch.int32, device=dev)
    hist[:, :256] = torch.randint(0, tm.cfg.vocab_size, (B, 256), device=dev,
                                  dtype=torch.int32, generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    lanes = {"tokens": hist[:, 0].contiguous(), "positions": lens,
             "tables": (1 + torch.arange(B * T, device=dev,
                                         dtype=torch.int32)).reshape(B, T),
             "active": torch.ones(B, dtype=torch.bool, device=dev),
             "budgets": torch.full((B,), 1000, dtype=torch.int32, device=dev),
             "eos": torch.full((B,), -1, dtype=torch.int32, device=dev),
             "hist": hist}
    tensors = lambda: (tp, pool.cache, dp, pool.draft_cache)  # noqa: E731

    def round_call(capture: bool):
        prog = G.spec_program(
            tm, dm, tensors, B, T, 2049, spec_k=k, max_len=2048, ngram=2,
            capture=capture, stream=torch.cuda.Stream() if capture else None)
        return replayed(prog, lanes)

    # the round's drafting as it runs it: greedy lanes (temperature 0)
    # through the warped dist and the draw, then the backfill step
    temps = torch.zeros(B, dtype=torch.float32, device=dev)
    top_ks = torch.zeros(B, dtype=torch.int32, device=dev)
    keys = TT.lane_keys(torch.zeros(B, dtype=torch.int32, device=dev))

    def drafter_steps():
        cur = lanes["tokens"]
        for j in range(k + 1):
            lg, _ = dm.decode_step_paged(dp, pool.draft_cache, cur, lens + j,
                                         lanes["tables"])
            if j < k:
                qd = TT.sampling_dist(lg[:, :dm.cfg.vocab_size], temps,
                                      top_ks)
                cur = TT.sample_from_dist(TT.event_keys(
                    keys, lens + j + 1, TT.SALT_DRAFT), qd, temps <= 0)

    steps_prog = G.Program("drafter steps", drafter_steps, {},
                           lambda: (dp, pool.draft_cache), capture=True,
                           stream=torch.cuda.Stream())
    label = (f"{B} lanes at positions {lengths}, spec_k={k} with the "
             f"{dm.cfg.name} drafter")
    return {
        "drafter round": (label + f": {k} drafter steps, the backfill and "
                          f"the verify pass over {B * (k + 1)} pseudo-lanes",
                          round_call(False), 1, "round"),
        "drafter round captured": (label + ", a captured round",
                                   round_call(True), 1, "round"),
        "drafter steps": (label + f": the drafter's {k + 1} steps alone",
                          drafter_steps, 1, "round"),
        "drafter steps captured": (label + f": the drafter's {k + 1} steps "
                                   f"alone, captured", replayed(steps_prog,
                                                                {}), 1,
                                   "round"),
    }


def llama13b_phases(torch) -> dict:
    """Phase 9: llama2-13b served with the llama2-7b drafter.  The plain
    prompts at horizon 8 without speculation give the continuation load
    (``continuation_load``); greedy and sampled, it is served at horizon
    8 without speculation and with the drafter (``SPEC``), captured and
    eager (equal), kernel 2 launched by every verify pass and every
    drafter step, kernel 1 by both models' prefills.  Then one round
    traced eager and captured, beside the drafter's share of it.
    Returns the runs' launches."""
    target, drafter = llama13b_models(torch)
    tm, tp = target
    paged = ("flash_attention", "paged_decode_attention")
    plain = plain_load(tm.cfg.vocab_size)
    first = serve(torch, tm, tp, "plain greedy horizon=8", plain, paged,
                  horizon=8)
    runs, loads, bases = [first], {}, {}
    for kind in ("greedy", "sampled"):
        name = f"continuation {kind}"
        loads[name] = continuation_load(plain, first["streams"],
                                        kind == "sampled")
        bases[name] = serve(torch, tm, tp, f"{name} horizon=8", loads[name],
                            paged, horizon=8)
        runs.append(bases[name])
    runs += spec_pairs(torch, tm, tp, loads, bases, drafter=drafter)
    want = (tm.cfg.num_layers + drafter[0].cfg.num_layers) \
        * runs[-1]["stats"].prefill_batches
    if runs[-1]["launches"]["flash_attention"] != want:
        fail("llama2-13b drafted: kernel 1 did not launch once per layer of "
             "both models and prefill batch")
    calls = drafter_round_calls(torch, target, drafter)
    walls = {name: host_walls(torch, fn, per, reps=5)
             for name, (_, fn, per, _) in calls.items()}
    busy = {name: trace(torch, f"{name} profile llama2-13b bf16, {label}", fn,
                        walls[name], per=per, unit=unit)
            for name, (label, fn, per, unit) in calls.items()}
    for tag in ("", " captured"):
        print(f"llama2-13b drafter round{tag}: the llama2-7b drafter's "
              f"steps take {busy['drafter steps' + tag]:.3f} of the round's "
              f"{busy['drafter round' + tag]:.3f} ms device busy (share "
              f"{busy['drafter steps' + tag] / busy['drafter round' + tag]:.3f})",
              flush=True)
    capture_times(calls, "llama2-13b")
    del target, drafter, tm, tp, calls
    torch.cuda.empty_cache()
    return sum_launches(runs)


# ---------------------------------------------------------------------------
# phase 10: the TAPAS control loop on the card
# ---------------------------------------------------------------------------

# bench_ablation's / bench_oversubscription's datacenter: 8 rows x 10 racks
# x 4 servers = 320 servers (2560 GPUs), TAPAS, a thermal failure and a
# x1.4 demand surge over hours 4-8 of a 12 h run at 10-minute ticks
CLUSTER = dict(horizon_h=12.0, tick_min=10.0, seed=1, occupancy=0.95,
               demand_scale=1.0)
N_BOUND = 16                     # SaaS servers backed by the fleet
SIZE_TO_VARIANT = {"70b": "full", "13b": "full", "7b": "small"}


def cluster_config():
    from repro_torch.core.datacenter import DCConfig
    from repro_torch.core.scenario import DemandSurge, FailureEvent, Scenario
    from repro_torch.core.simulator import TAPAS, SimConfig
    return SimConfig(
        dc=DCConfig(n_rows=8, racks_per_row=10, servers_per_rack=4),
        policy=TAPAS, scenario=Scenario((
            FailureEvent(kind="thermal", start_h=4.0, end_h=8.0, target=0),
            DemandSurge(start_h=4.0, end_h=8.0, scale=1.4))), **CLUSTER)


SMI_FIELDS = (("power.draw", "W"), ("clocks.sm", "MHz"),
              ("temperature.gpu", "C"), ("utilization.gpu", "%"))


def smi_reading() -> tuple:
    """``SMI_FIELDS`` as ``nvidia-smi`` reads them now (utilization.gpu:
    the share of its last sample period in which a kernel ran); None
    where it reads no number."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + ",".join(f for f, _ in SMI_FIELDS),
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    vals = []
    for v in out.stdout.strip().splitlines()[0].split(","):
        try:
            vals.append(float(v))
        except ValueError:
            vals.append(None)
    return tuple(vals)


def _flat(summary: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in summary.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def summaries_agree(got: dict, want: dict, label: str) -> None:
    """A ``summary()`` (a fleet's nests its regions') equal to another,
    every field exactly (NaN where both are NaN): the physics on the card
    is bit-equal to the CPU's, and engines are telemetry only."""
    got, want = _flat(got), _flat(want)
    nan = object()
    differ = sorted(k for k in set(got) | set(want)
                    if got.get(k, nan) != want.get(k, nan)
                    and not (got.get(k) != got.get(k)
                             and want.get(k) != want.get(k)))
    if differ:
        fail(f"{label}: {len(differ)} of {len(want)} fields differ, e.g. "
             + ", ".join(f"{k} {got.get(k)!r} vs {want.get(k)!r}"
                         for k in differ[:4]))
    print(f"{label}: all {len(want)} fields equal", flush=True)


def physics_phase(torch):
    """(a): the 320-server sim with no engines, on the card and on the
    host's CPU, under TAPAS (the loop's configuration) and under Baseline
    (whose placement trips thermal limits, so counts other than 0 are
    held): the summaries equal, each tick's hottest GPU and row power
    within 1e-5 relative.  Returns the card's TAPAS result."""
    import dataclasses

    import numpy as np
    from repro_torch.core.simulator import BASELINE, ClusterSim
    out = {}
    for policy in ("TAPAS", "Baseline"):
        cfg = cluster_config()
        if policy == "Baseline":
            cfg = dataclasses.replace(cfg, policy=BASELINE)
        res = {}
        for dev in ("cuda", "cpu"):
            sim = ClusterSim(cfg, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[dev] = sim.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"physics {policy} on {dev}: {sim.ticks} ticks of "
                  f"{sim.dc.n_servers} servers "
                  f"({sim.dc.n_servers * sim.dc.cfg.hw.chips} GPUs) in "
                  f"{dt:.3f} s, {dt / sim.ticks * 1e3:.3f} ms per tick "
                  f"(physics, telemetry and the control plane)", flush=True)
        card, cpu = res["cuda"], res["cpu"]
        summaries_agree(card.summary(), cpu.summary(),
                        f"physics {policy} card vs CPU")
        for name in ("max_gpu_temp_c", "row_power_frac"):
            a, b = getattr(card, name), getattr(cpu, name)
            if not np.allclose(a, b, rtol=1e-5, atol=0):
                fail(f"physics {policy} card vs CPU: per-tick {name} "
                     f"differs by {np.abs(a - b).max():.3e}")
        print(f"physics {policy} card summary: "
              f"{ {k: round(float(v), 6) for k, v in card.summary().items()} }",
              flush=True)
        out[policy] = card
    return out["TAPAS"]


class EngineLog:
    """Records what one engine of the fleet is asked to do (submissions,
    variant reloads, scheduler steps with the knobs they ran under) so an
    eager twin can replay it."""

    def __init__(self, eng):
        self.eng, self.events = eng, []
        self._orig = {n: getattr(eng, n) for n in ("submit", "step",
                                                   "set_variant")}

        def submit(req):
            self.events.append(("submit", req))
            return self._orig["submit"](req)

        def step(now=None):
            k = eng.knobs
            self.events.append(("step", now, k.max_batch, k.freq_scale,
                                k.paused))
            return self._orig["step"](now)

        def set_variant(name):
            self.events.append(("set_variant", name))
            return self._orig["set_variant"](name)

        eng.submit, eng.step, eng.set_variant = submit, step, set_variant

    def stop(self) -> list:
        """Unhook; the logged requests' outputs as they stand now."""
        for n in self._orig:
            delattr(self.eng, n)
        return [list(ev[1].output) for ev in self.events
                if ev[0] == "submit"]

    def replay(self, twin) -> list:
        from repro_torch.serving import Request
        copies = []
        for ev in self.events:
            if ev[0] == "submit":
                r = ev[1]
                c = Request(prompt=list(r.prompt),
                            max_new_tokens=r.max_new_tokens,
                            customer=r.customer, arrival_s=r.arrival_s,
                            deadline_ms=r.deadline_ms,
                            max_retries=r.max_retries)
                copies.append(c)
                twin.submit(c)
            elif ev[0] == "set_variant":
                twin.set_variant(ev[1])
            else:
                _, now, twin.knobs.max_batch, twin.knobs.freq_scale, \
                    twin.knobs.paused = ev
                twin.step(now)
        return [list(c.output) for c in copies]


def loop_phase(torch, card) -> tuple:
    """(b): the same sim on the card with full-width engines in the loop:
    an ``EngineFleet`` of 2 llama2-13b engines with the llama2-7b "small"
    variant, one weight copy (``build(share=)``), backing the first 16
    SaaS servers once placed.  Returns the loop's launches and weak
    references to its fleet, simulator, engines and pools."""
    import statistics

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.simulator import ClusterSim
    from repro_torch.serving import EngineFleet, EngineSpec
    from repro_torch.serving import graphs as G
    spec = EngineSpec(cut("llama2-13b"), n_slots=16, max_seq=512,
                      horizon=4, variants=(("small", cut("llama2-7b")),))
    t0 = time.perf_counter()
    fleet = EngineFleet(spec, n_engines=2, steps_per_tick=4,
                        backend_kw=dict(variant_for_size=SIZE_TO_VARIANT,
                                        prompt_len=256, max_new_tokens=32))
    torch.cuda.synchronize()
    first = fleet.engines[0]
    one_copy = all(e.variants[n][1] is first.variants[n][1]
                   for e in fleet.engines for n in ("full", "small"))
    n_params = {n: sum(t.numel() for t in _leaves(p))
                for n, (_, p) in first.variants.items()}
    print(f"fleet of {len(fleet.engines)} engines built in "
          f"{time.perf_counter() - t0:.1f} s: {n_params} params in bf16, "
          f"one weight copy: {one_copy}; pool per engine "
          f"{first.pool.n_blocks} blocks of {first.pool.block_size} tokens "
          f"({first.model.cfg.num_layers} layers x 2 x "
          f"{first.model.cfg.n_kv_heads} x {first.model.cfg.head_dim} bf16); "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    if not one_copy:
        fail("the fleet's engines do not share one weight copy")
    for name, cfg in (("full", spec.cfg), ("small", cut("llama2-7b"))):
        if n_params[name] != cfg.param_count():
            fail(f"{name} parameter count {n_params[name]} != "
                 f"{cfg.param_count()}")

    captures = [0]
    orig_capture = G.Program._capture

    def counting_capture(self):
        captures[0] += 1
        return orig_capture(self)

    flush_s = [0.0]
    orig_flush = fleet.flush

    def timed_flush(*, now):
        t = time.perf_counter()
        n = orig_flush(now=now)
        flush_s[0] += time.perf_counter() - t
        return n

    G.Program._capture = counting_capture
    fleet.flush = timed_flush
    sim = ClusterSim(cluster_config(), device="cuda")
    bound, log, first_outputs = {}, None, None
    knobs0 = [None] * len(fleet.engines)
    knob_states, power, tick_s, physics_s = set(), [], [], []
    profiled = None
    reset_launches()
    t_loop = time.perf_counter()
    try:
        while sim.tick < sim.ticks:
            flush_before = flush_s[0]
            if bound and len(tick_s) == 4:
                # one bound tick traced: device busy against host wall
                torch.cuda.synchronize()
                t = time.perf_counter()
                # the device's activity only: recording the host's ops
                # too multiplies a tick's wall many times over
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    st = sim.step()
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t
                busy = sum(getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0))
                           for e in prof.key_averages()
                           if e.device_type.name == "CUDA") / 1e6
                profiled = (sim.tick - 1, wall, busy)
            else:
                t = time.perf_counter()
                st = sim.step()
                wall = time.perf_counter() - t
            if not bound:
                saas = np.flatnonzero(st.kind == 2)
                if len(saas) >= N_BOUND:
                    for srv in saas[:N_BOUND]:
                        bk = fleet.make_backend()
                        sim.attach_backend(int(srv), bk)
                        bound[int(srv)] = bk
                    knobs0 = [knob_tuple(e) for e in fleet.engines]
                    log = EngineLog(fleet.engines[0])
                    print(f"tick {sim.tick - 1} ({st.now_h:.2f} h): "
                          f"{len(saas)} SaaS servers placed; the fleet "
                          f"backs {sorted(bound)} (engine of each: "
                          f"{[fleet.engines.index(b.engine) for b in bound.values()]})",
                          flush=True)
                continue
            tick_s.append(wall)
            physics_s.append(wall - (flush_s[0] - flush_before))
            power.append(smi_reading())
            if len(tick_s) == 3:
                first_outputs = log.stop()
            states = tuple(knob_tuple(e) for e in fleet.engines)
            knob_states.add(states)
            servers = sorted(bound)
            gp = [st.measured_goodput.get(s, 0.0) for s in servers]
            print(f"{st.now_h:5.2f} h emerg={str(st.emergency):<5} risk "
                  + " ".join(f"{st.risk[s]:.2f}" for s in servers)
                  + " | knobs " + " ".join(
                      f"e{i}:f{k[0]:.2f}/b{k[1]}/{k[2]}{'/P' if k[3] else ''}"
                      for i, k in enumerate(states))
                  + " | goodput tok/s " + " ".join(f"{g:.0f}" for g in gp)
                  + f" | tick {wall:.3f} s", flush=True)
    finally:
        G.Program._capture = orig_capture
        del fleet.flush
    loop_wall = time.perf_counter() - t_loop
    launches = read_launches()
    tensor_core_route(launches, "cluster loop llama2-13b/llama2-7b")

    summary = sim.result().summary()
    applied = {s: len(b.applied) for s, b in bound.items()}
    served = [len(e.stats.completed) for e in fleet.engines]
    swaps = [e.stats.variant_swaps for e in fleet.engines]
    print(f"cluster loop: {len(tick_s)} bound ticks in {loop_wall:.1f} s "
          f"({sim.ticks} ticks in all); per bound tick host wall median "
          f"{statistics.median(tick_s):.3f} s ({min(tick_s):.3f}-"
          f"{max(tick_s):.3f}), of which the engines' flush "
          f"{statistics.median([a - b for a, b in zip(tick_s, physics_s)]):.3f}"
          f" s and physics, telemetry and control "
          f"{statistics.median(physics_s) * 1e3:.1f} ms (medians)",
          flush=True)
    if profiled:
        # the profiler stretches the traced tick's own wall many times
        # over, so its busy time stands beside the unprofiled ticks on
        # either side (load alternates from tick to tick)
        tick, wall, busy = profiled
        i = 4
        near = (tick_s[i - 1] + tick_s[i + 1]) / 2 \
            if len(tick_s) > i + 1 else statistics.median(tick_s)
        print(f"cluster loop tick {tick} traced (device activity only): "
              f"device busy {busy:.3f} s; its host wall under the profiler "
              f"{wall:.3f} s; the unprofiled ticks either side "
              f"{near:.3f} s (idle share beside them {1 - busy / near:.3f}, "
              f"a reading); phase (b)'s host wall {loop_wall:.1f} s",
              flush=True)
    print(f"cluster loop: configs applied per bound server {applied}; "
          f"requests completed per engine {served}; variant swaps {swaps}; "
          f"graph captures {captures[0]}; decode tokens "
          f"{[e.stats.decode_tokens for e in fleet.engines]}; queued at the "
          f"end {[len(e.queue) for e in fleet.engines]}; launches "
          f"flash_attention={launches['flash_attention']} "
          f"paged_decode_attention={launches['paged_decode_attention']}",
          flush=True)
    for i, (name, unit) in enumerate(SMI_FIELDS):
        vals = sorted(r[i] for r in power if r[i] is not None)
        if vals:
            print(f"cluster loop {name} over {len(vals)} ticks: min "
                  f"{vals[0]:.1f} {unit}, median "
                  f"{statistics.median(vals):.1f} {unit}, max "
                  f"{vals[-1]:.1f} {unit}", flush=True)
        else:
            print(f"cluster loop {name}: not measured (nvidia-smi read no "
                  f"number)", flush=True)
    if not any(n > 1 for n in applied.values()):
        fail("cluster loop: no reconfigure decision reached an engine")
    if len(knob_states | {tuple(knobs0)}) < 2:
        fail("cluster loop: no engine's knobs changed")
    if not all(served):
        fail(f"cluster loop: an engine served nothing ({served})")
    if summary != card.summary():
        fail(f"cluster loop: the summary with engines {summary} differs "
             f"from the card's without {card.summary()}")
    print("cluster loop: summary with engines equals the card's without "
          "(telemetry only)", flush=True)
    for name in ("flash_attention", "paged_decode_attention"):
        if launches[name] == 0:
            fail(f"cluster loop: {name} never launched")

    # captured vs eager on engine 0's first 3 bound ticks
    twin = spec.build(share=first)
    twin.graphs = False
    t = time.perf_counter()
    eager = log.replay(twin)
    same = sum(a == b for a, b in zip(first_outputs, eager))
    print(f"cluster loop engine 0, first 3 bound ticks: captured vs eager "
          f"{same}/{len(eager)} streams equal ({sum(map(len, eager))} "
          f"tokens; eager replay {time.perf_counter() - t:.1f} s)",
          flush=True)
    if same != len(eager) or not eager:
        fail("cluster loop: captured and eager streams differ")
    ends = [weakref.ref(x) for x in (fleet, sim, twin, *fleet.engines,
                                     *(e.pool for e in fleet.engines))]
    return launches, ends


def knob_tuple(eng) -> tuple:
    k = eng.knobs
    return (k.freq_scale, k.max_batch, k.variant, k.paused)


# fault_storm.py's drill clock (hours): cooling fails mid-run, the storm
# lands inside it
STORM = dict(horizon_h=2.0, tick_min=5.0, cooling=(0.8, 1.2),
             crash=(0.9, 1.1), nan_burst=(1.0, 1.1), dropout=(0.8, 1.3))


def storm_arm(share, spec, *, storm: bool, knobs) -> dict:
    """One arm of ``examples/fault_storm.py``'s drill through the port: two
    backends over engines that alias ``share``'s weights."""
    import numpy as np
    from repro_torch.core.datacenter import DCConfig
    from repro_torch.core.faults import (DegradationLadder, EngineFault,
                                         ResilienceKnobs, SensorDropout,
                                         audit_requests)
    from repro_torch.core.scenario import FailureEvent, Scenario
    from repro_torch.core.simulator import TAPAS, ClusterSim, SimConfig
    from repro_torch.serving import EngineBackend
    dc = DCConfig(n_rows=2, racks_per_row=2, servers_per_rack=4,
                  region="hot")

    def sim_of(scenario, res):
        return ClusterSim(SimConfig(
            dc=dc, horizon_h=STORM["horizon_h"], tick_min=STORM["tick_min"],
            seed=0, policy=TAPAS, occupancy=0.95, demand_scale=1.0,
            scenario=scenario, resilience=res), device="cuda")

    probe = sim_of(Scenario(), None)
    attach_tick, saas = None, []
    while probe.tick < probe.ticks:
        st = probe.step()
        saas = [int(s) for s in np.flatnonzero(st.kind == 2)]
        if len(saas) >= 2:
            attach_tick = probe.tick
            break
    if attach_tick is None:
        fail("fault drill: the datacenter never placed 2 SaaS servers")
    events = [FailureEvent(kind="cooling", start_h=STORM["cooling"][0],
                           end_h=STORM["cooling"][1], target=0)]
    if storm:
        events += [
            EngineFault(kind="crash", start_h=STORM["crash"][0],
                        end_h=STORM["crash"][1], server=saas[0]),
            EngineFault(kind="nan_burst", start_h=STORM["nan_burst"][0],
                        end_h=STORM["nan_burst"][1], server=saas[1]),
            SensorDropout(start_h=STORM["dropout"][0],
                          end_h=STORM["dropout"][1])]
    res = knobs if knobs is not None else ResilienceKnobs()
    sim = sim_of(Scenario(tuple(events)), res)
    backends, max_age = {}, 0
    while sim.tick < sim.ticks:
        st = sim.step()
        max_age = max(max_age, st.telemetry_age_ticks)
        if sim.tick == attach_tick and not backends:
            for srv in saas[:2]:
                bk = EngineBackend(
                    spec.build(share=share), seed=srv, max_new_tokens=8,
                    steps_per_tick=5,
                    ladder=DegradationLadder() if res.ladder else None,
                    deadline_ms=3_600_000.0)
                sim.attach_backend(srv, bk)
                backends[srv] = bk
    for bk in backends.values():
        bk.drain(now_h=float(sim.t_h[-1]) + STORM["tick_min"] / 60.0)
    issued = [r for bk in backends.values() for r in bk.issued]
    audit = audit_requests(issued)
    engines = [bk.engine for bk in backends.values()]
    pristine = all(
        bool(torch_isfinite(e.pool.cache["attn"][n][:, sorted(
            e.pool.free_blocks)])) for e in engines for n in ("k", "v"))
    return {
        "goodput_tokens": audit["accepted_tokens"],
        "outcomes": audit["outcomes"], "lost": len(audit["lost"]),
        "issued": audit["total"],
        "crashes": sum(e.stats.crashes for e in engines),
        "quarantined": sum(e.stats.quarantined for e in engines),
        "retried": sum(e.stats.retried for e in engines),
        "timed_out": sum(e.stats.timed_out for e in engines),
        "dropped": sum(len(bk.dropped) for bk in backends.values()),
        "watchdog_drains": sim.watchdog_drains,
        "ladder_walks": sum(bk.ladder.walks for bk in backends.values()
                            if bk.ladder is not None),
        "max_telemetry_age": max_age, "pristine_free_blocks": pristine,
        "streams": {bk.seed: [list(r.output) for r in bk.issued]
                    for bk in backends.values()},
        "nan_server": saas[1],
    }


def torch_isfinite(t) -> bool:
    return bool(t.isfinite().all())


def scrub_check(torch, device="cuda") -> None:
    """Kernel 2 over a reused block whose unwritten tail still holds NaN
    (a quarantined lane's, had it not been scrubbed): a reading of what
    the kernel and its plain version make of the residue (the plain
    version's masked ``0 * NaN`` is NaN), then the scrub
    (``_zero_blocks``) and the check that the lane's output is finite and
    the plain version's.  llama2-7b's heads, 2 lanes, block size 16."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode_attention as pa
    from repro_torch.serving.kvcache import _zero_blocks
    g = torch.Generator(device=device).manual_seed(11)
    B, H, D, bs, T = 2, 32, 128, 16, 4
    n_blocks = 1 + B * T
    kp = torch.randn(n_blocks, bs, H, D, generator=g, device=device,
                     dtype=torch.bfloat16)
    vp = torch.randn(n_blocks, bs, H, D, generator=g, device=device,
                     dtype=torch.bfloat16)
    q = torch.randn(B, H, D, generator=g, device=device, dtype=torch.bfloat16)
    tables = (1 + torch.arange(B * T, device=device,
                               dtype=torch.int32)).reshape(B, T)
    pos = torch.tensor([37, 50], device=device, dtype=torch.int32)
    last = int(tables[0, 37 // bs])
    kp[last, 37 % bs + 1:] = float("nan")      # the unwritten tail
    vp[last, 37 % bs + 1:] = float("nan")
    o = ops.paged_decode_attention(q, kp, vp, tables, pos)
    ref = pa.paged_decode_attention_ref(q, kp, vp, tables, pos)
    print(f"scrub check: kernel 2 over a NaN tail past the lane's length: "
          f"lane 0 finite {torch_isfinite(o[0])} (plain version "
          f"{torch_isfinite(ref[0])}), lane 1 finite {torch_isfinite(o[1])}",
          flush=True)
    cache = {"attn": {"k": kp[None], "v": vp[None]}}
    keep_k, keep_v = kp[last, :37 % bs + 1].clone(), vp[last,
                                                        :37 % bs + 1].clone()
    _zero_blocks(cache, torch.tensor([last], device=device))
    kp[last, :37 % bs + 1], vp[last, :37 % bs + 1] = keep_k, keep_v
    o = ops.paged_decode_attention(q, kp, vp, tables, pos)
    ref = pa.paged_decode_attention_ref(q, kp, vp, tables, pos)
    err, rel = compare(o, ref)
    print(f"scrub check: after the scrub lane 0 finite {torch_isfinite(o)}, "
          f"max abs err against the plain version {err:.3e} (rel {rel:.3e})",
          flush=True)
    if not torch_isfinite(o) or err > TOL["bf16"] or rel > REL_TOL["bf16"]:
        fail("scrub check: kernel 2 after the scrub is not finite or not "
             "the plain version's")


def fault_drill_phase(torch) -> dict:
    """(c): ``examples/fault_storm.py``'s three arms through the port on two
    backends over one shared full-width llama2-7b.  Returns the arms'
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import recovery_off
    from repro_torch.serving import EngineSpec
    scrub_check(torch)
    spec = EngineSpec(get_config("llama2-7b"), max_seq=96, n_slots=4,
                      max_batch=4, block_size=8)
    t0 = time.perf_counter()
    share = spec.build()
    torch.cuda.synchronize()
    print(f"fault drill: llama2-7b full width built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reset_launches()
    arms = {}
    for label, storm, knobs in (("fault_free", False, None),
                                ("recovery_on", True, None),
                                ("recovery_off", True, recovery_off())):
        t = time.perf_counter()
        arms[label] = r = storm_arm(share, spec, storm=storm, knobs=knobs)
        print(f"fault drill {label:13s} goodput={r['goodput_tokens']:5d} tok "
              f"outcomes={r['outcomes']} lost={r['lost']} "
              f"dropped={r['dropped']} issued={r['issued']} "
              f"crashes={r['crashes']} quarantined={r['quarantined']} "
              f"retried={r['retried']} watchdog={r['watchdog_drains']} "
              f"ladder={r['ladder_walks']} "
              f"max_telemetry_age={r['max_telemetry_age']} "
              f"free blocks finite={r['pristine_free_blocks']} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    launches = read_launches()
    tensor_core_route(launches, "fault drill llama2-7b")
    free, on, off = (arms[k] for k in ("fault_free", "recovery_on",
                                       "recovery_off"))
    ratio_on = on["goodput_tokens"] / max(free["goodput_tokens"], 1)
    ratio_off = off["goodput_tokens"] / max(free["goodput_tokens"], 1)
    print(f"fault drill: goodput vs fault-free: recovery on {ratio_on:.3f}, "
          f"recovery off {ratio_off:.3f}; launches "
          f"flash_attention={launches['flash_attention']} "
          f"paged_decode_attention={launches['paged_decode_attention']}",
          flush=True)
    nan_srv = off["nan_server"]
    a, b = free["streams"][nan_srv], off["streams"][nan_srv]
    differ = [(x, y) for x, y in zip(a, b) if x != y]
    zeros = sum(1 for _, y in differ if y and y[-1] == 0)
    print(f"fault drill recovery off, server {nan_srv} (the NaN burst's): "
          f"{len(differ)} of {len(b)} streams differ from the fault-free "
          f"arm's, {zeros} of them ending in token 0 (argmax of NaN "
          f"logits); e.g. {differ[:2]}", flush=True)
    if on["lost"] != 0:
        fail("fault drill: the recovery-on arm lost requests")
    if not (on["crashes"] >= 1 and off["crashes"] >= 1):
        fail("fault drill: a storm arm saw no crash")
    if on["quarantined"] < 1:
        fail("fault drill: the recovery-on arm quarantined nothing")
    if not (on["watchdog_drains"] >= 1 and on["max_telemetry_age"] > 0
            and on["ladder_walks"] >= 1):
        fail("fault drill: the recovery-on arm's watchdog, stale telemetry "
             "or ladder did not engage")
    if not on["pristine_free_blocks"]:
        fail("fault drill: a free block holds a non-finite value after "
             "recovery")
    if ratio_on < 0.9:
        fail(f"fault drill: the storm cost too much goodput: {ratio_on:.3f}")
    if off["lost"] + off["dropped"] == 0:
        fail("fault drill: the recovery-off arm lost nothing")
    if not ratio_off < ratio_on:
        fail("fault drill: recovery made nothing better")
    for name in ("flash_attention", "paged_decode_attention"):
        if launches[name] == 0:
            fail(f"fault drill: {name} never launched")
    del share
    torch.cuda.empty_cache()
    return launches


def cluster_phases(torch) -> dict:
    """Phase 10: (a) the physics on the card against the CPU, (b) the loop
    with full-width engines, (c) the fault drill.  Returns the launches of
    (b) and (c)."""
    t0 = time.perf_counter()
    card = physics_phase(torch)
    print(f"phase 10 (a) done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t = time.perf_counter()
    # the loop's fleet must end when (b) drops it, with the cyclic
    # collector held off: no reference cycle may keep its engines, pools
    # and CUDA graphs (~50 GiB) on the card into phase 11
    collecting = gc.isenabled()
    gc.disable()
    try:
        launches, ends = loop_phase(torch, card)
        left = sum(r() is not None for r in ends)
    finally:
        if collecting:
            gc.enable()
    torch.cuda.empty_cache()
    print(f"phase 10 (b) done in {time.perf_counter() - t:.1f} s; its "
          f"fleet, simulator, engines and pools ended with it: "
          f"{len(ends) - left} of {len(ends)}, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB left allocated",
          flush=True)
    if left:
        fail(f"cluster loop: {left} of {len(ends)} of the fleet's objects "
             f"outlived the phase (a reference cycle)")
    t = time.perf_counter()
    for name, n in fault_drill_phase(torch).items():
        launches[name] += n
    print(f"phase 10 (c) done in {time.perf_counter() - t:.1f} s; phase 10 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the reference's five other token-input configs at full width
# ---------------------------------------------------------------------------

# (arch, layers): every width as published; qwen3-moe-235b-a22b's depth cut
# to 8 of its 94 layers (94 layers of 128 experts, ~470 GB in bf16, fit no
# single card; 8 take ~42 GB)
TOKEN_CONFIGS = (("deepseek-7b", 8), ("qwen3-1.7b", 8), ("gemma-7b", 8),
                 ("chameleon-34b", 8), ("qwen3-moe-235b-a22b", 8))


def full_width(torch, name: str, layers=None):
    """``name`` at its published widths (depth ``layers`` where given),
    random bf16 weights from seed 0; fails unless the tree holds the
    config's parameters (plus the qk_norm scales and MLA's q and kv norm
    scales, which ``param_count`` leaves out, in the reference as in the
    port)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, local_plan
    cfg = get_config(name)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    model = build_model(cfg, local_plan(param_dtype=torch.bfloat16))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    want = cfg.param_count() + (2 * cfg.num_layers * cfg.head_dim
                                if cfg.qk_norm else 0)
    if cfg.attn_kind == "mla":       # nor MLA's q and kv norms
        want += cfg.num_layers * (cfg.q_lora_rank + cfg.kv_lora_rank)
    experts = (f" {cfg.n_experts} experts top-{cfg.top_k} of d_ff "
               f"{cfg.expert_d_ff}" if cfg.n_experts else f" d_ff {cfg.d_ff}")
    print(f"{name} full width: {cfg.num_layers} layers"
          f"{f' (of {get_config(name).num_layers})' if layers else ''} "
          f"d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim}{experts} vocab {cfg.vocab_size}"
          f"{' qk_norm' if cfg.qk_norm else ''}"
          f"{' tied' if cfg.tie_embeddings else ''}; {n} params in bf16, "
          f"init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB at the "
          f"init's peak", flush=True)
    if n != want:
        fail(f"{name}: parameter count {n} != config's {want}")
    return model, params


def decode_step_trace(torch, model, params) -> tuple:
    """One decode horizon of 8 steps at 4 lanes at positions
    230/180/120/40 (a pool of 516 blocks of 16) as replays of one
    captured step: host wall per step over 5 calls, and one traced
    call's device busy per step and idle share."""
    import statistics
    from repro_torch.serving import PagedCachePool
    B, dev = 4, model.device
    lengths = [230, 180, 120, 40]
    pool = PagedCachePool(model, B, 2048, block_size=16, n_blocks=516)
    T = pool.blocks_per_seq
    gen = torch.Generator(device=dev).manual_seed(2)
    lanes = {"tokens": torch.randint(0, model.cfg.vocab_size, (B,),
                                     device=dev, dtype=torch.int32,
                                     generator=gen),
             "positions": torch.tensor(lengths, dtype=torch.int32,
                                       device=dev),
             "tables": (1 + torch.arange(B * T, device=dev, dtype=torch.int32)
                        ).reshape(B, T),
             "active": torch.ones(B, dtype=torch.bool, device=dev),
             "budgets": torch.full((B,), 1000, dtype=torch.int32, device=dev),
             "eos": torch.full((B,), -1, dtype=torch.int32, device=dev)}
    fn = captured_horizon(torch, model, params, pool.cache, lanes, 8)
    walls = host_walls(torch, fn, 8, reps=5)
    busy = trace(torch, f"{model.cfg.name} decode captured ({B} lanes at "
                 f"positions {lengths}, horizon=8, replays of one captured "
                 f"step)", fn, walls, 8, "step")
    del fn, pool
    torch.cuda.empty_cache()
    return busy, statistics.median(walls)


def token_config_phase(torch, name: str, layers) -> dict:
    """One config of phase 11: whole-prompt prefill and horizon-8 decode
    through the paged pool, captured and eager (equal); for gemma-7b
    (head dim 256) also the block-striped pool (``serve_sharded``: shards
    2 captured and eager, then ``set_shards(4)``), chunked prefill with
    prefix sharing and the slot pool, each captured and eager; prefill
    and one decode step teacher-forced through the kernels and the plain
    versions (the dense configs; a MoE's routing is discontinuous in
    bf16, so granite's check in phase 6 runs in an f32 plan); a traced
    captured decode step; phase 13's paths on the same weights: gemma-7b
    chunked at shards 2, a MoE config at shards 2.  Returns the launches
    of its runs."""
    model, params = full_width(torch, name, layers)
    paged = ("flash_attention", "paged_decode_attention")
    load = plain_load(model.cfg.vocab_size)
    runs = [serve(torch, model, params, "horizon=8", load, paged, horizon=8),
            serve(torch, model, params, "horizon=8 eager", load, paged,
                  horizon=8, graphs=False)]
    same_as_eager(runs[0], runs[1], f"{name} horizon=8")
    if model.cfg.head_dim == 256:
        runs += serve_sharded(torch, model, params, load, runs[0])
        chunked = serve_chunked(torch, model, params)
        runs += chunked
        runs += serve_slots(torch, model, params, load, runs[0])
        runs += chunked_shards(torch, model, params, chunked[0], (2,))
    if model.cfg.n_experts:
        runs += moe_shards(torch, model, params, runs[0])
    if not model.cfg.n_experts:
        teacher_forced(torch, model, params)
    busy, wall = decode_step_trace(torch, model, params)
    total = {}
    for run in runs:
        for k, n in run["launches"].items():
            total[k] = total.get(k, 0) + n
    print(f"phase 11 {name}: decode tok/s {runs[0]['tok_s']:.1f} captured, "
          f"{runs[1]['tok_s']:.1f} eager (horizon 8, 4 lanes, "
          f"{len(load)} requests of 32 new tokens); captured decode step "
          f"{busy:.3f} ms of device work, {wall:.3f} ms host wall, idle "
          f"share {1 - busy / wall:.3f}; kernel launches "
          f"{ {k: n for k, n in total.items() if n} }; card "
          f"{card_line()}", flush=True)
    del model, params
    torch.cuda.empty_cache()
    return total


def token_config_phases(torch) -> dict:
    """Phase 11: each of ``TOKEN_CONFIGS`` in turn, the last one's weights
    freed before the next is built."""
    total = {}
    for name, layers in TOKEN_CONFIGS:
        t0 = time.perf_counter()
        for k, n in token_config_phase(torch, name, layers).items():
            total[k] = total.get(k, 0) + n
        print(f"phase 11 {name} done in {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB left "
              f"allocated", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 12: the fleet of regions and the oversubscription sweep on the card
# ---------------------------------------------------------------------------

# the measured drill's horizon on the card: the reference's 12 h drill cut
# to its first 6 h (the failure, the heat wave and the surge start inside
# them), which halves its ~130 s of full-width prefills
MEASURED_H = 6.0


def fleet_physics_phase(torch) -> dict:
    """(a): ``repro_torch.launch.fleet``'s drill (3 regions of 64 servers,
    12 h at 10-minute ticks, gulf's cooling failure in a heat wave) under
    both routers, each region's physics on the card and on the host's
    CPU: the summaries equal.  Returns the card's summaries by router."""
    from repro_torch.core.fleet import GlobalTapasRouter, LatencyOnlyRouter
    from repro_torch.launch import fleet as geo
    out = {}
    for label, router in (("latency", LatencyOnlyRouter),
                          ("global", GlobalTapasRouter)):
        res = {}
        for dev in ("cuda", "cpu"):
            fs = geo.make_fleet(router, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[dev] = fs.run().summary()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n = sum(s.dc.n_servers for s in fs.sims.values())
            print(f"fleet {label} on {dev}: {fs.ticks} ticks of "
                  f"{len(fs.sims)} regions, {n} servers, in {dt:.3f} s, "
                  f"{dt / fs.ticks * 1e3:.3f} ms per tick", flush=True)
        summaries_agree(res["cuda"], res["cpu"],
                              f"fleet {label} card vs CPU")
        s = res["cuda"]
        print(f"fleet {label} card summary: throttle="
              f"{s['throttle_events']} per region "
              f"{ {n: r['thermal_events'] for n, r in s['regions'].items()} } "
              f"unserved={s['unserved_frac']:.6f} "
              f"quality={s['mean_quality']:.6f} moved={s['moved_load']:.3f} "
              f"migrations={s['migrations']}", flush=True)
        out[label] = s
    geo.check_drills(out["latency"], out["global"])
    return out


def measured_fleet_phase(torch) -> dict:
    """(b): ``run_measured_drill`` with full-width llama2-7b engines: one
    ``EngineFleet`` of two engines per region (4 lanes, max_seq 64,
    blocks of 8), all six on one weight copy, backing every SaaS server
    that appears (3 regions of 96 servers, ``MEASURED_H`` hours), with
    every launch count set to 0 just before and read just after;
    ``nvidia-smi``'s power, SM clock and temperature read after every
    tick.  Fails unless the
    reference's closing checks hold, kernels 1 and 2 ran (every kernel-1
    launch on the tensor cores) and the fleet's summary equals the same
    drill's without engines on the card (the backends are telemetry
    only).  Returns its launches."""
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.core.fleet import GlobalTapasRouter
    from repro_torch.launch import fleet as geo
    from repro_torch.serving import EngineSpec
    spec = EngineSpec(cut("llama2-7b"), max_seq=64, n_slots=4,
                      block_size=8)
    smi, walls = [], []
    last = [time.perf_counter()]

    def on_tick(fs, st):
        now = time.perf_counter()
        walls.append(now - last[0])
        smi.append(smi_reading())
        if fs.tick % 6 == 0:
            flushes = {n: fl.flushes for n, fl in fleets_of(fs).items()}
            print(f"measured fleet h={st.now_h:5.2f}: risk "
                  f"{ {n: round(float(r), 3) for n, r in st.risk.items()} } "
                  f"emergency {st.emergency} tick wall {walls[-1]:.3f} s, "
                  f"power {smi[-1][0]} W, SM {smi[-1][1]} MHz, "
                  f"{smi[-1][2]} C; flushes {flushes}", flush=True)
        last[0] = time.perf_counter()

    def fleets_of(fs):
        out = {}
        for name, sim in fs.sims.items():
            for bk in sim.backends.values():
                out[name] = bk.fleet
        return out

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    m = geo.run_measured_drill(spec=spec, on_tick=on_tick,
                               horizon_h=MEASURED_H)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    geo.check_measured(m)
    tensor_core_route(launches, "measured fleet llama2-7b")
    for name in ("flash_attention", "paged_decode_attention"):
        if launches[name] == 0:
            fail(f"measured fleet: {name} never launched")
    engines = [e for fl in m["fleets"].values() for e in fl.engines]
    served = sum(len(e.stats.completed) for e in engines)
    decode = sum(e.stats.decode_tokens for e in engines)
    step_s = sum(e.stats.step_time_total for e in engines)
    caps = sum(p.captures for e in engines for p in e.programs.values())
    reps = sum(p.replays for e in engines for p in e.programs.values())
    cols = list(zip(*smi))
    ranges = ", ".join(
        f"{f} {min(v for v in c if v is not None):.1f}-"
        f"{statistics.median([v for v in c if v is not None]):.1f}-"
        f"{max(v for v in c if v is not None):.1f} {u}"
        for (f, u), c in zip(SMI_FIELDS, cols) if any(v is not None
                                                      for v in c))
    print(f"measured fleet: {wall:.1f} s for {len(walls)} ticks (median "
          f"tick {statistics.median(walls):.3f} s, {min(walls):.3f}-"
          f"{max(walls):.3f}), engines' steps {step_s:.1f} s of it; "
          f"{served} requests completed, {decode} decode tokens "
          f"({decode / step_s:.1f} tok/s over the engines' step time), "
          f"graph captures {caps}, replays {reps}; launches "
          f"flash_attention={launches['flash_attention']} "
          f"paged_decode_attention={launches['paged_decode_attention']}; "
          f"over the ticks (min-median-max) {ranges}; card {card_line()}",
          flush=True)
    plain = geo.make_fleet(GlobalTapasRouter, servers_per_rack=6,
                           horizon_h=MEASURED_H).run()
    summaries_agree(m["summary"], plain.summary(),
                          "measured fleet vs the same drill without engines")
    del m, engines
    torch.cuda.empty_cache()
    return launches


def sweep_phase(torch) -> None:
    """(c): ``repro_torch.launch.oversub``'s sweep (Baseline and TAPAS at
    0, 20 and 40% over a 4 x 5 x 4 datacenter, 12 h) on the card, its
    rows equal to the same sweep's on the host's CPU."""
    from repro_torch.core.datacenter import DCConfig
    from repro_torch.core.oversubscribe import sweep
    from repro_torch.core.simulator import BASELINE, TAPAS
    from repro_torch.launch import oversub
    t0 = time.perf_counter()
    card = oversub.run_sweep()
    t1 = time.perf_counter()
    cpu = sweep([BASELINE, TAPAS], ratios=(0.0, 0.2, 0.4),
                dc=DCConfig(n_rows=4, racks_per_row=5, servers_per_rack=4),
                horizon_h=12.0, seed=1, device="cpu")
    t2 = time.perf_counter()
    same = sum(a == b for a, b in zip(card["rows"], cpu))
    print(f"sweep card vs CPU: {same}/{len(cpu)} rows equal; card "
          f"{t1 - t0:.1f} s, CPU {t2 - t1:.1f} s", flush=True)
    if card["rows"] != cpu:
        fail("the oversubscription sweep's rows differ between the card and "
             "the CPU")


def fleet_phases(torch) -> dict:
    """Phase 12: (a) the fleet's physics on the card against the CPU, (b)
    the measured drill on full-width engines, (c) the sweep.  Returns the
    launches of (b)."""
    t0 = time.perf_counter()
    fleet_physics_phase(torch)
    print(f"phase 12 (a) done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t = time.perf_counter()
    launches = measured_fleet_phase(torch)
    print(f"phase 12 (b) done in {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    sweep_phase(torch)
    print(f"phase 12 (c) done in {time.perf_counter() - t:.1f} s; phase 12 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: every paged path at shards 2 and 4, and MLA (minicpm3-4b)
# ---------------------------------------------------------------------------
#
# The sharded paths run on the phases that already hold their model on the
# card (llama2-7b in phase 2, granite in phase 6, gemma-7b and qwen3-moe in
# phase 11), so no model is built twice; each line they print starts with
# "phase 13".  minicpm3-4b is built and served at the end.

def sharded(torch, model, n: int, **plan_kw):
    """``model``'s config under the ``n``-way serving plan (a ``Model``
    holds no weights: the same parameters serve it)."""
    from repro_torch.models import build_model
    from repro_torch.serving import serving_plan
    plan_kw.setdefault("param_dtype", model.plan.param_dtype)
    return build_model(model.cfg, serving_plan(n, **plan_kw),
                       device=model.device)


def twins(torch, model, params, label: str, load: list, need: tuple,
          **engine_kw) -> list:
    """``load`` served captured and with ``graphs=False`` on the same
    weights: the pair must agree (``same_as_eager``)."""
    cap = serve(torch, model, params, label, load, need, **engine_kw)
    eager = serve(torch, model, params, f"{label} eager", load, need,
                  graphs=False, **engine_kw)
    same_as_eager(cap, eager, f"phase 13 {model.cfg.name} {label}")
    return [cap, eager]


def pool_for(ref: dict) -> int:
    """The smallest multiple of 4 blocks above a run's fullest point: the
    same schedule without preemption, every stripe of 2 or 4 live."""
    return -(-(ref["peak_blocks"] + 1) // 4) * 4


def striped_launches(run: dict, n: int, L: int, label: str) -> None:
    """Fail unless every decode step went through kernel 4 (``n`` launches
    per layer, none of kernel 2) and every chunk tick through kernel 3's
    owned/LSE form (``n`` per layer, none of kernel 3), with a live block
    in every stripe at the run's fullest point."""
    la, st = run["launches"], run["stats"]
    want = {"paged_decode_attention_lse": n * L * run["steps"],
            "paged_decode_attention": 0, "paged_prefill_attention": 0}
    if "paged_prefill_attention_lse" in la and st.prefill_batches and \
            la["flash_attention"] == 0:
        want["paged_prefill_attention_lse"] = n * L * st.prefill_batches
    got = {k: la[k] for k in want}
    print(f"phase 13 {label} shards={n} checks: launches {got} (want "
          f"{want}), live blocks per stripe at the fullest point "
          f"{run['stripe_blocks']} (all > 0)", flush=True)
    if got != want:
        fail(f"{label} shards={n}: the striped kernels did not carry every "
             f"step and tick")
    if len(run["stripe_blocks"]) != n or min(run["stripe_blocks"]) == 0:
        fail(f"{label} shards={n}: a stripe held no live block")


def chunked_shards(torch, model, params, ref: dict, counts=(2, 4)) -> list:
    """Chunked prefill with prefix sharing (``system_prompt_load``, chunks
    of 128, horizon 8) at each shard count of ``counts``, captured and
    eager, over a pool just above the unsharded chunked run ``ref``'s
    fullest point: every chunk tick through kernel 3's owned/LSE form,
    every decode step through kernel 4, the same shared blocks and
    prefill tokens as ``ref``, no preemption; streams against ``ref`` are
    a reading (bf16)."""
    name, L = model.cfg.name, model.cfg.num_layers
    load = system_prompt_load(model.cfg.vocab_size)
    runs = []
    for n in counts:
        pair = twins(torch, sharded(torch, model, n), params,
                     "chunked prefill_chunk=128 prefix_share horizon=8",
                     load, ("paged_prefill_attention_lse",
                            "paged_decode_attention_lse"),
                     horizon=8, prefill_chunk=128, prefix_share=True,
                     n_blocks=pool_for(ref))
        run = pair[0]
        striped_launches(run, n, L, f"{name} chunked")
        st, rs = run["stats"], ref["stats"]
        print(f"phase 13 {name} chunked shards={n}: shared_block_hits="
              f"{run['shared_block_hits']} ({ref['shared_block_hits']} "
              f"unsharded), prefill_tokens={st.prefill_tokens} "
              f"({rs.prefill_tokens}), preemptions={st.preemptions} (0); "
              f"{same_streams(run['streams'], ref['streams'])}/8 streams "
              f"equal to shards 1 (a reading: bf16); decode tok/s "
              f"{run['tok_s']:.1f} captured, {pair[1]['tok_s']:.1f} eager; "
              f"card {card_line()}", flush=True)
        if (run["shared_block_hits"] != ref["shared_block_hits"]
                or st.prefill_tokens != rs.prefill_tokens
                or st.preemptions):
            fail(f"{name} chunked shards={n}: the sharing or the schedule "
                 f"differs from shards 1")
        runs += pair
    return runs


def chunked_f32_shards(torch, model, params) -> list:
    """llama's chunked, prefix-shared streams in an f32 compute plan over
    an f32 pool at shards 1 and 2 (captured): they must be equal.  Over
    the bf16 pool each stripe rounds exp(s - its own max) where shards 1
    rounds the normalised P; in f32 both are the identity."""
    import functools
    from repro_torch.serving import engine as E
    load = system_prompt_load(model.cfg.vocab_size)
    pool_cls = E.PagedCachePool
    E.PagedCachePool = functools.partial(pool_cls, dtype=torch.float32)
    try:
        runs = [serve(torch, sharded(torch, model, n,
                                     compute_dtype=torch.float32), params,
                      f"chunked f32 plan, f32 pool, shards={n}", load,
                      ("paged_prefill_attention_lse" if n > 1
                       else "paged_prefill_attention",),
                      horizon=8, prefill_chunk=128, prefix_share=True)
                for n in (1, 2)]
    finally:
        E.PagedCachePool = pool_cls
    same = same_streams(runs[0]["streams"], runs[1]["streams"])
    print(f"phase 13 {model.cfg.name} chunked, f32 plan over an f32 pool: "
          f"{same}/8 streams equal between shards 1 and 2; decode tok/s "
          f"{runs[0]['tok_s']:.1f} / {runs[1]['tok_s']:.1f}", flush=True)
    if runs[0]["streams"] != runs[1]["streams"]:
        fail("chunked f32: shards 2 streams differ from shards 1")
    return runs


def spec_shards(torch, model, params) -> list:
    """N-gram speculative decode (spec_k 4, horizon 4) at shards 2 on
    ``plain_load``, captured and eager: every verify pass folded into
    kernel 4 (2 launches per layer and round; kernel 2 never), drafts
    proposed and accepted."""
    name, L = model.cfg.name, model.cfg.num_layers
    pair = twins(torch, sharded(torch, model, 2), params,
                 "n-gram spec spec_k=4 horizon=4 shards=2",
                 plain_load(model.cfg.vocab_size),
                 ("flash_attention", "paged_decode_attention_lse"),
                 draft="ngram", **SPEC)
    run = pair[0]
    st, la = run["stats"], run["launches"]
    rounds = st.decode_syncs * SPEC["horizon"]
    print(f"phase 13 {name} n-gram spec at shards 2: verify_passes="
          f"{st.verify_passes} draft_tokens={st.draft_tokens} "
          f"accepted_tokens={st.accepted_tokens} kernel 4 launches "
          f"{la['paged_decode_attention_lse']} (2 x {L} x {rounds} rounds), "
          f"kernel 2 {la['paged_decode_attention']} (0); decode tok/s "
          f"{run['tok_s']:.1f} captured, {pair[1]['tok_s']:.1f} eager",
          flush=True)
    if (st.verify_passes == 0 or la["paged_decode_attention"]
            or la["paged_decode_attention_lse"] != 2 * L * rounds):
        fail(f"{name} spec shards=2: the verify passes did not go through "
             f"kernel 4 alone")
    return pair


def moe_shards(torch, model, params, ref: dict) -> list:
    """A MoE config at shards 2 on ``plain_load`` at horizon 8, captured
    and eager, over a pool just above the unsharded run ``ref``'s fullest
    point: every decode step through kernel 4, the experts combined over 2
    ranks; streams against ``ref`` are a reading (bf16; routing is
    discontinuous)."""
    name, L = model.cfg.name, model.cfg.num_layers
    pair = twins(torch, sharded(torch, model, 2), params,
                 "horizon=8 shards=2", plain_load(model.cfg.vocab_size),
                 ("flash_attention", "paged_decode_attention_lse"),
                 horizon=8, n_blocks=pool_for(ref))
    striped_launches(pair[0], 2, L, f"{name} MoE")
    print(f"phase 13 {name} at shards 2: "
          f"{same_streams(pair[0]['streams'], ref['streams'])}/8 streams "
          f"equal to shards 1 (a reading); decode tok/s "
          f"{pair[0]['tok_s']:.1f} captured, {pair[1]['tok_s']:.1f} eager; "
          f"card {card_line()}", flush=True)
    return pair


def granite_refuses_shards(torch, variants) -> None:
    """granite at full width cannot serve sharded: its vocabulary (49155)
    divides by neither 2 nor 4, and ``shard_compat``, the reference's
    rule the port keeps, refuses a plan whose pads would not carry the
    parameters over.  ``can_shard`` gives that reason and an
    ``EngineBackend`` mapping tp onto 2 shards counts a reject and keeps
    the engine at 1 (the expert-parallel path runs at full width on
    qwen3-moe in phase 11; granite's smoke config, vocab 128, serves at
    shards 2 in the CPU tests)."""
    from repro_torch.core.profiles import ConfigPoint
    from repro_torch.serving import Engine, EngineBackend
    model, params = variants["full"]
    eng = Engine(model, params, max_seq=2048, n_slots=4, block_size=16)
    why = {n: eng.can_shard(n) for n in (2, 4)}
    bk = EngineBackend(eng, shards_for_tp={4: 2})
    bk.apply_config(ConfigPoint(freq=1.0, tp=4, batch=16, size="7b",
                                quant="bf16"))
    print(f"phase 13 granite-moe-3b-a800m at shards 2 and 4: refused, "
          f"{why}; EngineBackend shard_rejects={bk.shard_rejects} (1), "
          f"shards={eng.shards} (1)", flush=True)
    if (not all(why.values()) or "vocab_size" not in why[2]
            or bk.shard_rejects != 1 or eng.shards != 1):
        fail("granite: a shard degree its vocabulary does not divide was "
             "not refused")
    del eng, bk
    torch.cuda.empty_cache()


def mla_flash_reading(torch, model) -> None:
    """Kernel 1 at minicpm3-4b's prefill (one prompt of 200 tokens, 40
    heads, q and k at D = 96, v zero-padded from 64 to 96) beside its plain
    version, SDPA on the same padded inputs and the bound of the unpadded
    work; the padded output's first 64 columns against attention with v
    at 64 (plain torch)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    cfg = model.cfg
    H, S = cfg.n_heads, 200
    Dk, Dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k = (torch.randn(1, H, S, Dk, generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    v = torch.randn(1, H, S, Dv, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    vp = F.pad(v, (0, Dk - Dv))
    scale = 1.0 / Dk ** 0.5
    o = fa.flash_attention(q, k, vp, scale=scale, causal=True)[..., :Dv]
    want = F.scaled_dot_product_attention(q.float(), k.float(), v.float(),
                                          is_causal=True, scale=scale)
    held(f"flash_attention minicpm3-4b prefill B=1 H={H} S={S} D={Dk}, v "
         f"padded {Dv} -> {Dk}, o[..., :{Dv}] vs attention with v at {Dv}",
         o, want, "bf16")
    ms, lo, hi = spread_ms(lambda: fa.flash_attention(q, k, vp, scale=scale,
                                                      causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, vp, scale=scale,
                                                      causal=True))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, vp, is_causal=True, scale=scale))
    pairs = S * (S + 1) // 2
    bound, by = bound_of(2 * H * S * (2 * Dk + 2 * Dv),
                         2 * H * pairs * (Dk + Dv), "bf16")
    print(f"phase 13 kernel 1 at D = {Dk} with v padded from {Dv} (minicpm3-4b "
          f"prefill, B=1 H={H} S={S}): kernel {spread(ms, lo, hi)}, plain "
          f"{plain_ms:.4f} ms, sdpa on the padded inputs {lib_ms:.4f} ms, "
          f"bound of the unpadded work {bound:.4f} ms ({by}); card "
          f"{card_line()}", flush=True)


def mla_phase(torch) -> dict:
    """Phase 13's MLA: full-width minicpm3-4b (62 layers, random bf16
    weights from seed 0) on the slot pool (``paged=None`` picks it, as the
    reference's engine does): ``plain_load`` captured and eager (equal),
    kernel 1 once per layer and prefill (q/k at D = 96, v padded), no
    other kernel (the latent decode is plain torch); prefill and one slot
    decode step teacher-forced kernels vs plain versions in an f32 plan
    (1e-4 of max |logit|; bf16 a reading); kernel 1's reading at the
    prefill shape; one captured slot step traced beside the weights'
    byte bound."""
    model, params = full_width(torch, "minicpm3-4b")
    cfg, L = model.cfg, model.cfg.num_layers
    load = plain_load(cfg.vocab_size)
    runs = twins(torch, model, params, "slots (MLA latent cache)", load,
                 ("flash_attention",), paged=None)
    la, st = runs[0]["launches"], runs[0]["stats"]
    others = {k: la[k] for k in ("paged_decode_attention",
                                 "paged_decode_attention_lse",
                                 "paged_prefill_attention",
                                 "paged_prefill_attention_lse",
                                 "decode_attention", "rwkv6_wkv")}
    print(f"phase 13 minicpm3-4b slots: flash_attention launches "
          f"{la['flash_attention']} ({L} x {st.prefill_batches} prefills), "
          f"other kernels {others} (all 0); decode tok/s "
          f"{runs[0]['tok_s']:.1f} captured, {runs[1]['tok_s']:.1f} eager; "
          f"card {card_line()}", flush=True)
    if la["flash_attention"] != L * st.prefill_batches or any(
            others.values()):
        fail("minicpm3-4b: kernel 1 did not carry each prefill alone")
    mla_flash_reading(torch, model)
    mla_teacher_forced(torch, model, params)
    tok = torch.tensor([5, 9, 13, 17], dtype=torch.int32, device="cuda")
    pos = torch.tensor([230, 180, 120, 40], dtype=torch.int32, device="cuda")
    slots = model.init_cache(4, 2048, device="cuda")
    fn = captured_slot(torch, model, params, slots, tok, pos)
    walls = host_walls(torch, fn, 1, reps=5)
    busy = trace(torch, "minicpm3-4b slot decode captured (4 slots at "
                 "positions 230/180/120/40 of 2048)", fn, walls, 1, "step")
    import statistics
    wall = statistics.median(walls)
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"phase 13 minicpm3-4b captured slot step: {busy:.3f} ms of device "
          f"work, {wall:.3f} ms host wall, idle share {1 - busy / wall:.3f}; "
          f"the weights' byte bound {w_bytes / R.HW.hbm_bw * 1e3:.2f} ms "
          f"({w_bytes} B); card {card_line()}", flush=True)
    del fn, slots
    total = {}
    for run in runs:
        for k, n in run["launches"].items():
            total[k] = total.get(k, 0) + n
    del model, params, runs
    torch.cuda.empty_cache()
    return total


def mla_teacher_forced(torch, model, params) -> None:
    """minicpm3-4b's prefill of 4 prompts of 200 tokens and one slot decode
    step after it, through the kernels and through the plain versions on
    the card: in an f32 compute plan over the same bf16 weights and an
    f32 slot cache (held at 1e-4 of max |logit|; over a bf16 cache a
    written value within f32 rounding of a bf16 boundary may round either
    way) and in bf16 (a reading)."""
    from repro_torch.models import build_model, local_plan
    for plan in ("f32", "bf16"):
        m = model if plan == "bf16" else build_model(
            model.cfg, local_plan(param_dtype=torch.bfloat16,
                                  compute_dtype=torch.float32))
        toks = _prompts(torch, m, 7)[0][:, :200]

        def run():
            logits, cache = m.prefill(params, toks)
            nxt = logits.argmax(-1).to(torch.int32)
            slots = m.init_cache(toks.shape[0], 256, device="cuda",
                                 dtype=m.plan.compute_dtype)
            for name, leaf in cache["attn"].items():
                slots["attn"][name][:, :, :toks.shape[1]] = leaf.to(
                    slots["attn"][name].dtype)
            pos = torch.full((toks.shape[0],), toks.shape[1],
                             dtype=torch.int32, device="cuda")
            return logits, m.decode_step(params, slots, nxt, pos)[0]

        pk, dk = run()
        with plain_versions():
            pp, dp = run()
        for what, a, b in (("prefill", pk, pp), ("decode step", dk, dp)):
            label = f"minicpm3-4b {plan} plan {what} logits, kernels vs plain"
            if plan == "f32":
                held_scaled(label, a[:, :model.cfg.vocab_size],
                            b[:, :model.cfg.vocab_size], "f32")
            else:
                _reading(torch, model.cfg.vocab_size, label, a, b)


# ---------------------------------------------------------------------------
# phase 14: training on the card
# ---------------------------------------------------------------------------

# kernel 1's backward, phase 1's shape first: (label, B, H, K, S, D,
# causal, window, v's own head dim (0: D)); hymba-1.5b, minicpm3-4b and
# hubert-xlarge at phase 15's training shapes, minicpm3-4b's v (and dO)
# zero-padded from 64 to q's 96 as ``_flash_padded`` pads it
BWD_CASES = (("llama2-7b", 4, 32, 32, 512, 128, True, 0, 0),
             ("qwen3-1.7b train step", 4, 16, 8, 1024, 128, True, 0, 0),
             ("granite-moe-3b-a800m", 4, 24, 8, 512, 64, True, 0, 0),
             ("gemma-7b", 1, 16, 16, 2048, 256, True, 0, 0),
             ("hymba-1.5b window", 2, 25, 5, 2048, 64, True, 1024, 0),
             ("hubert-xlarge bidirectional", 4, 16, 16, 1000, 80, False, 0,
              0),
             ("minicpm3-4b MLA", 4, 40, 40, 1024, 96, True, 0, 64))
# kernel vs plain, of each gradient's max |g|: f32 sums in other orders;
# bf16 rounds dq, dk, dv, the P of dV and dS to bf16
BWD_TOL = {"bf16": 2e-2, "f32": 1e-5}
TRAIN = dict(batch=4, seq=1024, steps=10, lr=1e-3, warmup=2)


def sdpa_mask(torch, S, causal, window):
    from repro_torch.kernels import flash_attention as fa
    if not causal or window:
        return fa._mask(S, causal, window, "cuda")
    return None


BWD_PASSES = ("bwd_delta", "bwd_dkdv", "bwd_dq")


def check_flash_bwd(torch) -> list:
    """Phase 14 (a): kernel 1's backward against its plain version at
    ``BWD_CASES`` in bf16 and f32 (the forward's lse against the plain
    lse too), each bf16 case and the f32 llama case timed: events and
    device time, the plain version, SDPA's backward on the same tensors
    (the median of 5 timed runs) and the bound.  Every bf16 call must take
    the tensor cores, no f32 call.  Each pass's device time is read from
    phase 14 (b)'s traced step.
    Returns the kernels line's entries of the backward and of the
    training forward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(14)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    entries = {}
    for name, dt in dtypes.items():
        for label, B, H, K, S, D, causal, window, dv in BWD_CASES:
            q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda",
                                   dtype=dt) for n in (H, K, K))
            do = torch.randn(B, S, H, D, generator=g, device="cuda",
                             dtype=dt)
            if dv:          # o's padded columns are cut: their dO is 0
                v, do = (F.pad(t[..., :dv], (0, D - dv)) for t in (v, do))
            q, k, v, do = (t.transpose(1, 2) for t in (q, k, v, do))
            kw = dict(causal=causal, window=window)
            o, lse = fa.flash_attention_lse(q, k, v, **kw)
            o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
            tag = (f"{name} B={B} H={H} K={K} S={S} D={D} "
                   f"{'causal' if causal else 'bidirectional'}"
                   f"{f' W={window}' if window else ''}"
                   f"{f' v padded from {dv}' if dv else ''} ({label})")
            err_o = held(f"flash_attention_lse {tag}: o", o, o_ref, name)
            err_l = (lse - lse_ref).abs().max().item()
            print(f"flash_attention_lse {tag}: lse max_abs_err={err_l:.3e} "
                  f"tol={TOL[name]:.0e}", flush=True)
            if not err_l <= TOL[name]:
                fail(f"flash_attention_lse {tag}: lse disagrees")
            tc = fa.flash_attention_bwd.tensor_core
            got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            want = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
            again = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            torch.cuda.synchronize()
            if fa.flash_attention_bwd.tensor_core - tc != 2 * (name == "bf16"):
                fail(f"flash_attention_bwd {tag}: the route is not the "
                     f"dtype's (tensor cores for bf16 only)")
            errs = []
            for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                err = (a.float() - b.float()).abs().max().item()
                scale = b.float().abs().max().item()
                errs.append(err)
                ok = err <= BWD_TOL[name] * scale
                print(f"flash_attention_bwd {tag}: {gname} max_abs_err="
                      f"{err:.3e} (max |{gname}| {scale:.3e}, tol "
                      f"{BWD_TOL[name]:.0e} of it) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    fail(f"flash_attention_bwd {tag}: {gname} disagrees "
                         f"with its plain version")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"flash_attention_bwd {tag}: two calls differ")
            if name == "f32" and label != "llama2-7b":
                continue
            n_bytes, flops, peak = kernel_work(
                "flash_attention_bwd", (q, k, v, o, do, lse), kw)
            bound, by = bound_of(n_bytes, flops, peak)
            ms, lo, hi = spread_ms(lambda: fa.flash_attention_bwd(
                q, k, v, o, do, lse, **kw))
            dev = device_ms(torch, lambda: fa.flash_attention_bwd(
                q, k, v, o, do, lse, **kw))
            plain = cuda_ms(lambda: fa.flash_attention_bwd_ref(
                q, k, v, o, do, lse, **kw), iters=5, warmup=1)
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
            mask = sdpa_mask(torch, S, causal, window)
            ol = F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, is_causal=mask is None,
                enable_gqa=H != K)
            lib, lib_lo, lib_hi = spread_ms(lambda: torch.autograd.grad(
                ol, (ql, kl, vl), do, retain_graph=True))
            lib_dev = device_ms(torch, lambda: torch.autograd.grad(
                ol, (ql, kl, vl), do, retain_graph=True))
            print(f"flash_attention_bwd {tag}: kernel {spread(ms, lo, hi)}, "
                  f"device {dev:.4f} ms, plain {plain:.4f} ms, sdpa backward "
                  f"{spread(lib, lib_lo, lib_hi)}, device {lib_dev:.4f} ms; "
                  f"bound {bound:.4f} ms ({by}: {flops} flop; "
                  f"{flops / ms / 1e9:.1f} TFLOP/s at 10 D a pair)",
                  flush=True)
            if "flash_attention_bwd" not in entries:
                entries["flash_attention_bwd"] = {
                    "name": "flash_attention_bwd", "route": "cuda",
                    "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                    "replaces": "none: port-only, the reference's gradient "
                                "is XLA autodiff of causal_attention "
                                "(src/repro/models/attention.py:182)",
                    "max_abs_err": max(errs), "ms": ms, "ms_min": lo,
                    "ms_max": hi, "call_ms": dev, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib}
            if "flash_attention_lse" not in entries:
                fwd_ms, flo, fhi = spread_ms(
                    lambda: fa.flash_attention_lse(q, k, v, **kw))
                serve_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
                fplain = cuda_ms(lambda: fa.flash_attention_lse_ref(
                    q, k, v, **kw), iters=5, warmup=1)
                flib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True))
                fb, fby = bound_of(*kernel_work("flash_attention_lse",
                                                (q, k, v), kw))
                print(f"flash_attention_lse {tag}: kernel "
                      f"{spread(fwd_ms, flo, fhi)} (the serve form "
                      f"{serve_ms:.4f} ms), plain {fplain:.4f} ms, sdpa "
                      f"{flib:.4f} ms, bound {fb:.4f} ms ({fby})",
                      flush=True)
                entries["flash_attention_lse"] = {
                    "name": "flash_attention_lse", "route": "cuda",
                    "source": "src/repro_torch/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:79",
                    "max_abs_err": max(err_o, err_l), "ms": fwd_ms,
                    "ms_min": flo, "ms_max": fhi, "plain_ms": fplain,
                    "bound_ms": fb, "bound_by": fby, "library_ms": flib}
    return [entries["flash_attention_lse"], entries["flash_attention_bwd"]]


class plain_grad_route:
    """Within the block, ``ops.FlashAttentionFn`` and ``ops.WkvFn`` run
    kernels 1 and 7's training forms and backward kernels through their
    plain versions on CUDA tensors."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rwkv6_wkv as wkv
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (fa, "flash_attention_lse"), (fa, "flash_attention_bwd"),
            (wkv, "rwkv6_wkv_train"), (wkv, "rwkv6_wkv_bwd"))]
        for mod, name, _ in self.saved:
            setattr(mod, name, getattr(mod, name + "_ref"))

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def grads_vs_plain(torch, model, params, batch) -> tuple:
    """The loss and every grad leaf through the kernels against the plain
    route's: (loss kernels, loss plain, the loss's relative error, the
    worst leaf's max |diff| over its max |g|)."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training.train_step import _value_and_grad
    loss_k, g_k = _value_and_grad(model, params, *batch)
    with plain_grad_route():
        loss_p, g_p = _value_and_grad(model, params, *batch)
    worst = 0.0
    for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)):
        worst = max(worst, ((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-30)).item())
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    return float(loss_k), float(loss_p), rel, worst


def plain_calls() -> int:
    from repro_torch.kernels import flash_attention as fa
    return (fa.flash_attention_ref.calls + fa.flash_attention_lse_ref.calls
            + fa.flash_attention_bwd_ref.calls)


def train_model(torch, layers=None, compute=None):
    """qwen3-1.7b at its published widths (depth ``layers`` where given)
    with f32 parameters from seed 0, bf16 compute unless ``compute``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, local_plan
    cfg = get_config("qwen3-1.7b")
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    plan = local_plan(param_dtype=torch.float32,
                      compute_dtype=compute or torch.bfloat16)
    model = build_model(cfg, plan)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n = sum(t.numel() for t in _leaves(params))
    want = cfg.param_count() + 2 * cfg.num_layers * cfg.head_dim  # qk_norm
    if n != want:
        fail(f"qwen3-1.7b: parameter count {n} != config's {want}")
    return model, params


def pipe_batch(pipe, cfg):
    """The pipeline's next batch: tokens, or for the encoder frame
    embeddings (as ``launch/train.py`` chooses by ``input_kind``)."""
    if cfg.input_kind == "embeds":
        return pipe.next_embed_batch(cfg.d_model)
    return pipe.next_batch()


def first_batch(cfg, B: int, S: int):
    """``TokenPipeline``'s first batch of B x S for ``cfg`` (seed 0)."""
    from repro_torch.training.data import DataConfig, TokenPipeline
    return pipe_batch(TokenPipeline(DataConfig(cfg.vocab_size, B, S)), cfg)


def train_run(torch, model, params, steps: int, *, start: int = 0,
              state=None, save=None, setup=TRAIN):
    """``steps`` AdamW steps of ``setup`` (``TRAIN``'s by default) from
    data step ``start``, on ``TokenPipeline``'s tokens or, for the
    encoder, its frame embeddings: (losses, params, state, step ms).
    ``save`` = (dir, step): a checkpoint after that step, as
    ``launch/train.py`` writes one."""
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.data import DataConfig, TokenPipeline
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    opt_cfg = AdamWConfig(lr=setup["lr"], warmup_steps=setup["warmup"],
                          total_steps=setup["steps"])
    step_fn = make_train_step(model, opt_cfg)
    state = state if state is not None else init_opt_state(params)
    pipe = TokenPipeline(DataConfig(model.cfg.vocab_size, setup["batch"],
                                    setup["seq"]), step=start)
    losses, ms = [], []
    for i in range(start, steps):
        batch = pipe_batch(pipe, model.cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = step_fn(params, state, *batch)
        losses.append(float(met["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if save is not None and i + 1 == save[1]:
            save_checkpoint(save[0], i + 1, (params, state),
                            meta={"arch": model.cfg.name})
    return losses, params, state, ms


KERNEL1_GROUPS = (("kernel 1 forward (flash_kernel)", ("flash_kernel",)),
                  ("kernel 1 backward (bwd_delta, bwd_dkdv, bwd_dq)",
                   ("bwd_delta", "bwd_dkdv", "bwd_dq")))


def train_trace(torch, model, params, state, batch, *, title="phase 14",
                groups=KERNEL1_GROUPS, by_pass=True) -> float:
    """One traced train step: device busy, idle share against the step's
    host wall, the kernels that take the time, the shares of ``groups``'
    kernels (kernel 1's forward and backward by default) and of the GEMMs,
    and with ``by_pass`` kernel 1's backward split by pass.  Returns the
    device's busy ms."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step
    step_fn = make_train_step(model, AdamWConfig(lr=0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, state, *batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type.name == "CUDA":
            rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e3
    n_ops = sum(r[1] for r in rows)
    print(f"{title} traced train step: host wall {wall:.1f} ms (traced), "
          f"device busy {busy:.1f} ms over {n_ops} device ops, idle share "
          + (f"{1 - busy / wall:.3f}" if busy else "not measured"),
          flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}",
              flush=True)
    for label, keys in (*groups, ("GEMMs (gemm / nvjet / cutlass)",
                                  ("gemm", "nvjet", "cutlass", "sm90_xmma"))):
        ms = sum(r[0] for r in rows if any(k in r[2] for k in keys)) / 1e3
        n = sum(r[1] for r in rows if any(k in r[2] for k in keys))
        print(f"  {label}: {ms:.3f} ms over {n} launches, share "
              f"{ms / busy if busy else 0:.3f} of device busy", flush=True)
    if by_pass:
        # each pass beside the total: the launches of a train step run
        # inside autograd's backward, where the trace holds every one
        print("  kernel 1 backward by pass: " + ", ".join(
            f"{k} {sum(r[0] for r in rows if k in r[2]) / 1e3:.3f} ms over "
            f"{sum(r[1] for r in rows if k in r[2])}" for k in BWD_PASSES),
            flush=True)
    return busy


def smi_during(fn) -> tuple:
    """(``fn()``, the ``smi_reading`` tuples taken every 0.5 s while it
    ran, on a thread of its own)."""
    import threading
    readings, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            readings.append(smi_reading())
            stop.wait(0.5)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        stop.set()
        th.join()
    return out, readings


def training_phase(torch) -> dict:
    """Phase 14 (b)-(d): full-width qwen3-1.7b trains on the card; kernel
    vs plain route at full width in an f32 plan; a checkpoint and resume.
    Returns the launches of (b)'s run."""
    import shutil
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.training.checkpoint import restore_checkpoint
    from repro_torch.training.data import DataConfig, TokenPipeline
    from repro_torch.training.optimizer import init_opt_state
    cfg = get_config("qwen3-1.7b")
    n_tok = TRAIN["batch"] * TRAIN["seq"]

    # (b) full width, 10 steps
    gc.collect()
    torch.cuda.empty_cache()
    model, params = train_model(torch)
    print(f"phase 14 qwen3-1.7b full width: {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size} qk_norm "
          f"tied; {sum(t.numel() for t in _leaves(params))} params in f32, "
          f"bf16 compute, AdamW, TokenPipeline batch {TRAIN['batch']} x seq "
          f"{TRAIN['seq']}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    plain0 = plain_calls()
    (losses, params, state, ms), smi = smi_during(
        lambda: train_run(torch, model, params, TRAIN["steps"]))
    la = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    plain = plain_calls() - plain0
    med = statistics.median(ms[1:])
    print(f"phase 14 losses: {[round(x, 4) for x in losses]}", flush=True)
    print(f"phase 14 train step: {med:.1f} ms median of steps 2-"
          f"{TRAIN['steps']} (first {ms[0]:.1f} ms), "
          f"{n_tok / med * 1e3:.0f} tokens/s, peak {peak:.2f} GiB allocated; "
          f"kernel 1 forward launches {la['flash_attention_lse']}, backward "
          f"{la['flash_attention_bwd']} ({cfg.num_layers} layers x "
          f"{TRAIN['steps']} steps; on the tensor cores "
          f"{la['flash_attention_bwd_tensor_core']} of them), serve-form "
          f"launches "
          f"{la['flash_attention']}, plain attention calls {plain}",
          flush=True)
    print(f"phase 14 card during the steps ({len(smi)} nvidia-smi readings, "
          f"median): " + ", ".join(
              f"{f} {statistics.median(r[i] for r in smi if r[i] is not None)}"
              f"{u}" for i, (f, u) in enumerate(SMI_FIELDS)
              if any(r[i] is not None for r in smi)), flush=True)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"phase 14: the loss is not finite and falling: {losses}")
    want = cfg.num_layers * TRAIN["steps"]
    if la["flash_attention_lse"] != want or la["flash_attention_bwd"] != want:
        fail(f"phase 14: kernel 1's training launches "
             f"{la['flash_attention_lse']}/{la['flash_attention_bwd']} != "
             f"{want}")
    if la["flash_attention_bwd_tensor_core"] != la["flash_attention_bwd"]:
        fail(f"phase 14: {la['flash_attention_bwd_tensor_core']} of "
             f"{la['flash_attention_bwd']} bf16 backward launches took the "
             f"tensor cores")
    if plain or la["flash_attention"]:
        fail(f"phase 14: {plain} plain attention calls and "
             f"{la['flash_attention']} serve-form launches on the train path")
    others = [n for n in ("paged_decode_attention",
                          "paged_decode_attention_lse",
                          "paged_prefill_attention",
                          "paged_prefill_attention_lse", "decode_attention",
                          "rwkv6_wkv", "rwkv6_wkv_train", "rwkv6_wkv_bwd",
                          "int8_matmul") if la[n]]
    if others:
        fail(f"phase 14: kernels {others} launched on the train path")
    batch = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN["batch"],
                                     TRAIN["seq"])).next_batch()
    busy = train_trace(torch, model, params, state, batch)
    roofline_train(torch, cfg, busy)
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()

    # (c) kernel route against plain route: 2 layers at full width, f32
    model, params = train_model(torch, layers=2, compute=torch.float32)
    loss_k, loss_p, rel, worst = grads_vs_plain(torch, model, params, batch)
    print(f"phase 14 (c) qwen3-1.7b 2 layers at full width, f32 plan: loss "
          f"kernels {loss_k:.6f} plain {loss_p:.6f} (rel "
          f"{rel:.2e}, tol 1e-5); worst grad leaf max|diff| / max|g| "
          f"{worst:.2e} (tol 1e-4: f32 sums in other orders)", flush=True)
    if not (rel <= 1e-5 and worst <= 1e-4):
        fail("phase 14 (c): grads through the kernels differ from the plain "
             "route's")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) checkpoint at step 5 and resume in a fresh model and optimizer
    ckpt = ROOT / "_phase14_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        model, params = train_model(torch, layers=2)
        t0 = time.perf_counter()
        whole, params, state, _ = train_run(torch, model, params,
                                            TRAIN["steps"], save=(ckpt, 5))
        whole_s = time.perf_counter() - t0
        del params, state
        fresh = model.init(torch.Generator(device="cuda").manual_seed(1))
        t0 = time.perf_counter()
        (params, state), manifest = restore_checkpoint(
            ckpt, (fresh, init_opt_state(fresh)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resumed, params, state, _ = train_run(torch, model, params,
                                              TRAIN["steps"], start=5,
                                              state=state)
        size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        print(f"phase 14 (d) qwen3-1.7b 2 layers at full width: checkpoint "
              f"at step {manifest['step']} ({size / 2**30:.2f} GiB; the "
              f"10-step run with its save {whole_s:.1f} s, restore "
              f"{restore_s:.1f} s); losses 6-10 uninterrupted "
              f"{whole[5:]}, resumed {resumed}", flush=True)
        if resumed != whole[5:]:
            fail("phase 14 (d): the resumed run's losses differ from the "
                 "uninterrupted run's")
        print("phase 14 (d): resumed losses equal the uninterrupted run's "
              "bit for bit", flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del model, params, state, fresh
    gc.collect()
    torch.cuda.empty_cache()
    return la


# ---------------------------------------------------------------------------
# phase 15: training of rwkv6-3b, hymba-1.5b, minicpm3-4b and hubert-xlarge
# ---------------------------------------------------------------------------

# kernel 7's backward against its plain version: (label, B, T, H, D, s0 and
# dS_T random (else a zero state and no dS_T)), the training shape first
WKV_BWD_CASES = (("rwkv6-3b train step", 4, 1024, 40, 64, False),
                 ("ragged T", 2, 333, 40, 64, True),
                 ("D=48", 2, 200, 8, 48, True),
                 ("D=96", 2, 200, 8, 96, True),
                 ("D=128", 2, 200, 8, 128, True))
# the four families' training runs: (arch, layers (None: all), batch, seq,
# steps), every width as published.  hymba-1.5b at seq 2048 so its window
# of 1024 masks keys; hymba and minicpm3-4b cut to 8 layers for the time
# limit (PERF.md §4).  rwkv6-3b's f32 parameters and AdamW moments take
# 34.6 GiB and its grads 11.6 (3.1 B parameters); at batch 4 x 1024 its
# activations left the allocator too little room and a step ran out of the
# card's memory, so it trains at batch 2 x 1024
TRAIN15 = (("rwkv6-3b", None, 2, 1024, 5), ("hymba-1.5b", 8, 2, 2048, 5),
           ("minicpm3-4b", 8, 4, 1024, 5),
           ("hubert-xlarge", None, 4, 1000, 5))
# (d)'s 2-layer f32 checks: (arch, batch, seq)
PLAIN15 = (("rwkv6-3b", 2, 512), ("hymba-1.5b", 1, 2048),
           ("minicpm3-4b", 2, 512), ("hubert-xlarge", 2, 500))
KERNEL7_GROUPS = (("kernel 7 training forward (wkv_kernel)", ("wkv_kernel",)),
                  ("kernel 7 backward (wkv_bwd_kernel)", ("wkv_bwd_kernel",)))


def check_wkv_bwd(torch) -> list:
    """Phase 15 (a): kernel 7's training form and backward against their
    plain versions at ``WKV_BWD_CASES`` in bf16 and f32 r/k/v: the
    training form's y and final state bit for bit the serve form's, its
    checkpoints and y against the plain training form; the backward's six
    gradients (dr, dk, dv, dw, du, ds0) from the kernel's checkpoints
    against ``rwkv6_wkv_bwd_ref`` from the same (each by its max abs error
    over max |plain| and its norm error, ``held_scaled``), two calls the
    same bits.  The training shape is timed in bf16: events and device
    time, the plain version, the bound (no PyTorch call computes the
    recurrence, so no library time); there the backward call must
    allocate nothing beside its outputs (its states stay on chip).  Returns the kernels line's entries
    of the training form and the backward."""
    from repro_torch.kernels import rwkv6_wkv as wkv
    g = torch.Generator(device="cuda").manual_seed(15)
    entries = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for label, B, T, H, D, rand in WKV_BWD_CASES:
            r, k, v, w, u, s0 = _wkv_inputs(torch, g, B, T, H, D, dt,
                                            not rand)
            dy = torch.randn(B, T, H, D, generator=g, device="cuda",
                             dtype=dt)
            ds = (torch.randn(B, H, D, D, generator=g, device="cuda")
                  if rand else None)
            tag = (f"{name} B={B} T={T} H={H} D={D} C={wkv.wkv_chunk(D)} "
                   f"s0/dS_T={'random' if rand else 'none'} ({label})")
            y, s, ck = wkv.rwkv6_wkv_train(r, k, v, w, u, s0)
            y_serve, s_serve = wkv.rwkv6_wkv(r, k, v, w, u, s0)
            if not (torch.equal(y, y_serve) and torch.equal(s, s_serve)):
                fail(f"rwkv6_wkv_train {tag}: y or the state differ from the "
                     f"serve form's bits")
            y_ref, _, ck_ref = wkv.rwkv6_wkv_train_ref(r, k, v, w, u, s0)
            err_y = held_scaled(f"rwkv6_wkv_train {tag} y", y, y_ref, name)
            held_scaled(f"rwkv6_wkv_train {tag} checkpoints", ck, ck_ref,
                        "f32")
            got = wkv.rwkv6_wkv_bwd(r, k, v, w, u, ck, dy, ds)
            again = wkv.rwkv6_wkv_bwd(r, k, v, w, u, ck, dy, ds)
            want = wkv.rwkv6_wkv_bwd_ref(r, k, v, w, u, ck, dy, ds)
            torch.cuda.synchronize()
            errs = [held_scaled(f"rwkv6_wkv_bwd {tag} {gname}", a, b, name)
                    for gname, a, b in zip(("dr", "dk", "dv", "dw", "du",
                                            "ds0"), got, want)]
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"rwkv6_wkv_bwd {tag}: two calls differ")
            print(f"rwkv6_wkv_bwd {tag}: two calls give the same bits",
                  flush=True)
            if name != "bf16" or label != WKV_BWD_CASES[0][0]:
                continue
            # no device memory beside the outputs (and du's per-(b, h)
            # partials): the chunk's recomputed states stay on chip
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = wkv.rwkv6_wkv_bwd(r, k, v, w, u, ck, dy, ds)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            outputs = (sum(g.numel() * g.element_size() for g in out)
                       + B * H * D * 4)
            del out
            P, rs = wkv.wkv_bwd_plan(D)
            print(f"rwkv6_wkv_bwd {tag}: a cluster of {P} CTAs of {rs} rows "
                  f"a (b, h), {B * H * P} CTAs; the call allocated {extra} "
                  f"B, its outputs {outputs} B (a B*H*C*D*D f32 scratch "
                  f"would be {B * H * wkv.wkv_chunk(D) * D * D * 4} B)",
                  flush=True)
            if extra > outputs + (1 << 20):
                fail(f"rwkv6_wkv_bwd {tag}: the call allocated {extra} B "
                     f"beside {outputs} B of outputs")
            n_bytes, flops, peak = kernel_work(
                "rwkv6_wkv_bwd", (r, k, v, w, u, ck, dy, ds))
            bound, by = bound_of(n_bytes, flops, peak)
            call = lambda: wkv.rwkv6_wkv_bwd(  # noqa: E731
                r, k, v, w, u, ck, dy, ds)
            ms, lo, hi = spread_ms(call)
            dev = device_ms(torch, call)
            plain = cuda_ms(lambda: wkv.rwkv6_wkv_bwd_ref(
                r, k, v, w, u, ck, dy, ds), iters=2, warmup=1)
            print(f"rwkv6_wkv_bwd {tag}: kernel {spread(ms, lo, hi)}, device "
                  f"{dev:.4f} ms, plain {plain:.4f} ms, library none (no "
                  f"PyTorch call computes the recurrence), bound {bound:.4f} "
                  f"ms ({by}: {n_bytes} B, {flops} flop; "
                  f"{flops / ms / 1e9:.2f} TFLOP/s)", flush=True)
            entries["rwkv6_wkv_bwd"] = {
                "name": "rwkv6_wkv_bwd", "route": "cuda",
                "source": "src/repro_torch/csrc/rwkv6_wkv_bwd.cu",
                "replaces": "none: port-only, the reference's gradient is "
                            "XLA autodiff of _wkv_chunk "
                            "(src/repro/models/ssm.py:214)",
                "max_abs_err": max(errs), "ms": ms, "ms_min": lo,
                "ms_max": hi, "call_ms": dev, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "library_ms": None}
            fwd = lambda: wkv.rwkv6_wkv_train(r, k, v, w, u, s0)  # noqa: E731
            f_ms, f_lo, f_hi = spread_ms(fwd)
            serve_ms = cuda_ms(lambda: wkv.rwkv6_wkv(r, k, v, w, u, s0))
            f_plain = cuda_ms(lambda: wkv.rwkv6_wkv_train_ref(
                r, k, v, w, u, s0), iters=2, warmup=1)
            # a zero s0 read as no state read, as the serve form's row
            fbytes, fflops, fpeak = R.wkv_train_work(
                B, T, H, D, r.dtype, ck.shape[2], state_in=False)
            ck_bytes = ck.numel() * 4
            fb, fby = bound_of(fbytes, fflops, fpeak)
            print(f"rwkv6_wkv_train {tag}: kernel {spread(f_ms, f_lo, f_hi)} "
                  f"(the serve form {serve_ms:.4f} ms), plain {f_plain:.4f} "
                  f"ms, bound {fb:.4f} ms ({fby}: {fbytes} B with "
                  f"{ck_bytes} B of checkpoints, {fflops} flop)", flush=True)
            entries["rwkv6_wkv_train"] = {
                "name": "rwkv6_wkv_train", "route": "cuda",
                "source": "src/repro_torch/csrc/rwkv6_wkv.cu",
                "replaces": "src/repro/kernels/rwkv6_wkv.py:52",
                "max_abs_err": err_y, "ms": f_ms, "ms_min": f_lo,
                "ms_max": f_hi, "plain_ms": f_plain, "bound_ms": fb,
                "bound_by": fby, "library_ms": None}
    return [entries["rwkv6_wkv_train"], entries["rwkv6_wkv_bwd"]]


def plain_wkv_calls() -> int:
    from repro_torch.kernels import rwkv6_wkv as wkv
    return wkv.rwkv6_wkv_train_ref.calls + wkv.rwkv6_wkv_bwd_ref.calls


def train_model15(torch, arch: str, layers=None, compute=None):
    """``arch`` at its published widths (depth ``layers`` where given)
    with f32 parameters from seed 0, bf16 compute unless ``compute``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, local_plan
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    plan = local_plan(param_dtype=torch.float32,
                      compute_dtype=compute or torch.bfloat16)
    model = build_model(cfg, plan)
    return model, model.init(torch.Generator(device="cuda").manual_seed(0))


def train15(torch, arch: str, layers, B: int, S: int, steps: int) -> dict:
    """Phase 15 (b)/(c): ``arch`` trains ``steps`` AdamW steps at full
    width (f32 parameters, bf16 compute) on B x S of ``TokenPipeline``'s
    tokens or frames: finite losses; the first step's batch's loss after
    the run below its loss at the first step; on tokens, the mean loss of
    steps 2..N on their fresh batches below step 1's (the encoder's labels
    are uniform draws independent of its frames, so nothing it learns
    carries to a fresh batch: PERF.md §7); rwkv6-3b launches kernel
    7's training form and backward once a layer and step and no other
    kernel, the others kernel 1's training forward and backward (every
    bf16 backward on the tensor cores) and no other kernel; no plain
    attention or WKV call; median step ms, tokens/s, peak memory,
    ``nvidia-smi`` during the steps, one traced step.  Returns the run's
    launches."""
    import statistics
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    model, params = train_model15(torch, arch, layers)
    cfg, L = model.cfg, model.cfg.num_layers
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"phase 15 {arch} full width: {L} layers"
          f"{f' (of {get_config(arch).num_layers})' if layers else ''} "
          f"d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size}; {n_par} "
          f"params in f32, bf16 compute, AdamW, "
          f"{'frame embeddings' if cfg.input_kind == 'embeds' else 'tokens'}"
          f" batch {B} x seq {S}", flush=True)
    from repro_torch.training.train_step import make_eval_step
    setup = dict(batch=B, seq=S, steps=steps, lr=1e-3, warmup=2)
    batch = first_batch(cfg, B, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    plain0, wplain0 = plain_calls(), plain_wkv_calls()
    (losses, params, state, ms), smi = smi_during(
        lambda: train_run(torch, model, params, steps, setup=setup))
    la = read_launches()
    after = float(make_eval_step(model)(params, *batch))
    peak = torch.cuda.max_memory_allocated() / 2**30
    plain, wplain = plain_calls() - plain0, plain_wkv_calls() - wplain0
    med = statistics.median(ms[1:])
    want = L * steps
    if cfg.rwkv:
        names = ("rwkv6_wkv_train", "rwkv6_wkv_bwd")
        what = (f"kernel 7 training forward {la[names[0]]}, backward "
                f"{la[names[1]]}, serve form {la['rwkv6_wkv']}")
    else:
        names = ("flash_attention_lse", "flash_attention_bwd")
        what = (f"kernel 1 training forward {la[names[0]]}, backward "
                f"{la[names[1]]} (on the tensor cores "
                f"{la['flash_attention_bwd_tensor_core']}), serve form "
                f"{la['flash_attention']}")
    print(f"phase 15 {arch} losses: {[round(x, 4) for x in losses]}; the "
          f"first step's batch after the run {after:.4f} (at the first step "
          f"{losses[0]:.4f})", flush=True)
    print(f"phase 15 {arch} train step: {med:.1f} ms median of steps 2-"
          f"{steps} (first {ms[0]:.1f} ms), {B * S / med * 1e3:.0f} "
          f"tokens/s, peak {peak:.2f} GiB allocated; {what} ({L} layers x "
          f"{steps} steps); plain attention calls {plain}, plain WKV calls "
          f"{wplain}", flush=True)
    print(f"phase 15 {arch} card during the steps ({len(smi)} nvidia-smi "
          f"readings, median): " + ", ".join(
              f"{f} {statistics.median(r[i] for r in smi if r[i] is not None)}"
              f"{u}" for i, (f, u) in enumerate(SMI_FIELDS)
              if any(r[i] is not None for r in smi)), flush=True)
    fresh = statistics.fmean(losses[1:])
    print(f"phase 15 {arch} mean loss of steps 2-{steps} {fresh:.4f} "
          f"(step 1 {losses[0]:.4f}; held below it on tokens)", flush=True)
    if (not all(map(math.isfinite, losses)) or not after < losses[0]
            or (cfg.input_kind == "tokens" and not fresh < losses[0])):
        fail(f"phase 15 {arch}: the loss is not finite and falling: {losses}"
             f", the first batch's after the run {after}")
    if la[names[0]] != want or la[names[1]] != want:
        fail(f"phase 15 {arch}: training launches {la[names[0]]}/"
             f"{la[names[1]]} != {L} layers x {steps} steps")
    if not cfg.rwkv and la["flash_attention_bwd_tensor_core"] != want:
        fail(f"phase 15 {arch}: {la['flash_attention_bwd_tensor_core']} of "
             f"{want} bf16 backward launches took the tensor cores")
    others = [n for n in kernel_wrappers() if la[n] and n not in names]
    if others or plain or wplain:
        fail(f"phase 15 {arch}: kernels {others}, {plain} plain attention "
             f"and {wplain} plain WKV calls on the train path")
    train_trace(torch, model, params, state, batch,
                title=f"phase 15 {arch}",
                groups=KERNEL7_GROUPS if cfg.rwkv else KERNEL1_GROUPS,
                by_pass=not cfg.rwkv)
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return la


def kernels_vs_plain15(torch, arch: str, B: int, S: int) -> None:
    """Phase 15 (d): 2 layers of ``arch`` at full width in an f32 plan on
    one batch: the loss and every grad leaf through the kernels against
    the plain route's (kernels 1 and 7's training forms and backward
    kernels through their plain versions): loss within 1e-5 relative,
    each leaf within 1e-4 of its max |g| (f32 sums in other orders)."""
    model, params = train_model15(torch, arch, 2, compute=torch.float32)
    batch = first_batch(model.cfg, B, S)
    loss_k, loss_p, rel, worst = grads_vs_plain(torch, model, params, batch)
    print(f"phase 15 (d) {arch} 2 layers at full width, f32 plan, batch {B} "
          f"x {S}: loss kernels {loss_k:.6f} plain {loss_p:.6f} (rel "
          f"{rel:.2e}, tol 1e-5); worst grad leaf max|diff| / max|g| "
          f"{worst:.2e} (tol 1e-4)", flush=True)
    if not (rel <= 1e-5 and worst <= 1e-4):
        fail(f"phase 15 (d) {arch}: grads through the kernels differ from "
             f"the plain route's")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def training15_phase(torch) -> dict:
    """Phase 15 (b)-(d): the four families train at full width, then
    kernels against plain at 2 layers in f32.  Returns the launches of
    the training runs."""
    total = {}
    for arch, layers, B, S, steps in TRAIN15:
        for name, n in train15(torch, arch, layers, B, S, steps).items():
            total[name] = total.get(name, 0) + n
    for arch, B, S in PLAIN15:
        kernels_vs_plain15(torch, arch, B, S)
    return total


# ---------------------------------------------------------------------------
# phase 16: the dry run, the accounting and the audit against the card
# ---------------------------------------------------------------------------

def dryrun_beside_build(torch, build) -> tuple:
    """Phase 16 (a)'s dry run, ``launch.dryrun.sweep`` (every ``ASSIGNED``
    x shape cell on the meta device), in this process while
    ``build.build_all`` runs in a thread (its ``nvcc`` processes take the
    other cores).  CUDA is not initialised before the sweep and must not
    be after it: nothing of the sweep reached the card.  Returns the
    build's reports and seconds and the sweep's rows."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import dryrun

    def timed_build():
        t0 = time.perf_counter()
        return build.build_all(), time.perf_counter() - t0

    if torch.cuda.is_initialized():
        fail("phase 16 (a): CUDA was initialised before the dry run")
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(timed_build)
        t0 = time.perf_counter()
        rows = list(dryrun.sweep())
        sweep_s = time.perf_counter() - t0
        touched = torch.cuda.is_initialized()
        reports, build_s = building.result()
    print(f"phase 16 (a) dry run: {len(rows)} rows in {sweep_s:.1f} s beside "
          f"the build ({build_s:.1f} s); CUDA initialised after it: "
          f"{touched}", flush=True)
    if touched:
        fail("phase 16 (a): the dry run initialised CUDA")
    return reports, build_s, rows


def reading_line(label: str, r: dict) -> str:
    return (f"phase 16 (c) roofline, {label}: op_cost {r['flops']:.4e} flop, "
            f"{r['bytes']:.4e} B; H100 terms compute {r['t_compute_ms']:.4f} "
            f"ms, memory {r['t_memory_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}); measured device {r['device_ms']:.4f} ms; "
            f"share of the roofline {r['roofline_share']:.4f}, mfu "
            f"{r['mfu']:.4f} (model flops over the bf16 peak); card "
            f"{card_line()}")


def roofline_decode(torch, model, calls) -> None:
    """Phase 16 (c) for phase 2's captured llama2-7b decode step (phase
    4's horizon program): one eager step counted by ``op_cost`` on the
    card (kernel 2 by its formula at the lanes' live keys), the replayed
    graph's device time per step (``device_ms``), the roofline terms,
    the share and the MFU."""
    from repro_torch.analysis import oncard, op_cost
    prog = calls["decode captured"][1].program
    B = prog.bufs["positions"].shape[0]
    with torch.inference_mode():
        cost = op_cost.count(prog.body)[1]
    ms = device_ms(torch, prog.run)
    r = oncard.roofline_reading(
        flops=cost["flops"], n_bytes=cost["bytes"],
        model_flops=2.0 * model.cfg.param_count(active=True) * B,
        device_ms=ms)
    k2 = cost["kernels"]["paged_decode_attention"]
    print(reading_line(
        f"llama2-7b captured decode step ({B} lanes at positions "
        f"{prog.bufs['positions'].tolist()}; GEMMs {cost['gemm_flops']:.4e} "
        f"flop, kernel 2 {k2['calls']} calls {k2['bytes']} B)", r),
        flush=True)
    if not 0 < r["roofline_share"] < math.inf:
        fail(f"phase 16 (c): the decode step's share of the roofline is "
             f"{r['roofline_share']}")


@functools.cache
def train_row(cfg) -> dict:
    """``launch.dryrun.run_cell`` of phase 14's train step (TRAIN's batch
    x seq, no remat, one microbatch) on the meta device: phase 16 (c)'s
    count and (b)'s peak-live estimate."""
    from repro_torch.configs import Shape
    from repro_torch.launch.dryrun import run_cell
    return run_cell(cfg, Shape("train", "train", TRAIN["seq"],
                               TRAIN["batch"]),
                    plan_overrides={"remat": "none", "grad_accum": 1})


def roofline_train(torch, cfg, busy_ms: float) -> None:
    """Phase 16 (c) for phase 14's train step (qwen3-1.7b, TRAIN's batch
    x seq, no remat, one AdamW update): counted on the meta device (the
    same shapes; its attention is kernel 1's forward and backward by
    formula), beside the traced step's device busy time."""
    from repro_torch.analysis import oncard
    row = train_row(cfg)
    r = oncard.roofline_reading(flops=row["flops"], n_bytes=row["bytes"],
                                model_flops=row["model_flops"],
                                device_ms=busy_ms)
    print(reading_line(f"qwen3-1.7b train step ({TRAIN['batch']} x "
                       f"{TRAIN['seq']}, counted on the meta device; GEMMs "
                       f"{row['gemm_flops']:.4e} flop)", r), flush=True)
    if not 0 < r["roofline_share"] < math.inf:
        fail(f"phase 16 (c): the train step's share of the roofline is "
             f"{r['roofline_share']}")


def analysis_phase(torch, sweep: list) -> dict:
    """Phase 16: (a) the rows of ``dryrun_beside_build``'s sweep, every
    cell present and none failed; (b) qwen3-1.7b's parameter and AdamW
    bytes at phase 14's shape and llama2-7b's phase-4 pool bytes, the meta
    build's against the card's exactly, the allocator's delta within
    ``oncard.allocator_span`` of the real build's storages, and the peak-live
    estimate of one train step beside ``max_memory_allocated``; (d) every
    audit entry run eagerly under the audit on the card, then captured:
    the verdicts agree, and the synthetic host sync and host-built tensor
    are flagged and refused.  Returns the launches of (b) and (d)."""
    import gc
    from repro_torch.analysis import oncard
    from repro_torch.configs import ASSIGNED, Shape, get_config, \
        runnable_cells
    # (a)
    done = [r for r in sweep if "skipped" not in r and "error" not in r]
    errors = [r for r in sweep if "error" in r]
    want = sum(len(runnable_cells(get_config(a))) for a in ASSIGNED)
    for row in done:
        print(f"phase 16 (a) dry run {row['arch']} x {row['shape']}: fits "
              f"one H100 {row['fits']} (peak live {row['peak_live_bytes'] / 1e9:.2f}"
              f" GB; params {row['param_bytes'] / 1e9:.2f}, AdamW "
              f"{row['opt_bytes'] / 1e9:.2f}, KV/state {row['kv_bytes'] / 1e9:.2f}"
              f" GB), grad_accum {row.get('grad_accum', '-')}, compute "
              f"{row['t_compute_s']:.4f} s, memory {row['t_memory_s']:.4f} s "
              f"({row['bottleneck']}), roofline_fraction "
              f"{row['roofline_fraction']:.4f}, traced in {row['t_s']} s",
              flush=True)
    print(f"phase 16 (a) dry run: {len(done)} of {want} cells, skipped "
          f"{[(r['arch'], r['shape']) for r in sweep if 'skipped' in r]}",
          flush=True)
    if errors or len(done) != want:
        fail(f"phase 16 (a): {len(done)} of {want} cells, errors {errors}")
    reset_launches()
    # (b)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-1.7b")
    shape = Shape("train", "train", TRAIN["seq"], TRAIN["batch"])
    over = {"remat": "none"}
    acc = oncard.state_vs_allocation(cfg, shape, plan_overrides=over)
    lo, hi = acc["span"]
    print(f"phase 16 (b) qwen3-1.7b at {TRAIN['batch']} x {TRAIN['seq']}: "
          f"dry run params {acc['meta']['params']} B, AdamW "
          f"{acc['meta']['opt']} B; on the card {acc['real']['params']} B, "
          f"{acc['real']['opt']} B; allocator delta {acc['allocated']} B "
          f"(storages rounded {lo} B, +{acc['allocated'] - lo} B, at most "
          f"{hi} B)", flush=True)
    if acc["meta"] != acc["real"]:
        fail(f"phase 16 (b): the dry run's bytes {acc['meta']} are not the "
             f"card's {acc['real']}")
    if not lo <= acc["allocated"] <= hi:
        fail(f"phase 16 (b): the allocator's delta {acc['allocated']} B is "
             f"outside [{lo}, {hi}]")
    pk = oncard.train_peak(cfg, shape, acc.pop("build"), train_row(cfg))
    print(f"phase 16 (b) peak-live estimate of one train step "
          f"{pk['estimate']} B beside max_memory_allocated {pk['measured']} B:"
          f" ratio {pk['ratio']:.4f} (a reading); card {card_line()}",
          flush=True)
    del acc, pk
    gc.collect()
    torch.cuda.empty_cache()
    pool = oncard.pool_vs_allocation(get_config("llama2-7b"), n_lanes=4,
                                     max_seq=2048, block_size=16,
                                     n_blocks=516)
    lo, hi = pool["span"]
    print(f"phase 16 (b) llama2-7b phase-4 pool ({pool['n_blocks']} blocks "
          f"of 16): dry run {pool['meta']} B, on the card {pool['real']} B; "
          f"allocator delta {pool['allocated']} B (storages rounded {lo} B, "
          f"at most {hi} B)", flush=True)
    if pool["meta"] != pool["real"]:
        fail("phase 16 (b): the dry run's pool bytes are not the card's")
    if not lo <= pool["allocated"] <= hi:
        fail(f"phase 16 (b): the allocator's delta {pool['allocated']} B is "
             f"outside [{lo}, {hi}]")
    torch.cuda.empty_cache()
    # (d)
    agree = 0
    rows = oncard.audit_vs_capture("cuda")
    for name, findings, captured, error in rows:
        synthetic = name.startswith("synthetic_")
        ok = (bool(findings) == (not captured)
              and bool(findings) == synthetic)
        agree += ok
        print(f"phase 16 (d) {name}: audit "
              f"{'; '.join(findings) if findings else 'clean'}; capture "
              f"{'and replay ok' if captured else 'refused: ' + error}"
              f"{'' if ok else ' DISAGREE'}", flush=True)
    print(f"phase 16 (d) audit and capture agree on {agree} of {len(rows)}",
          flush=True)
    if agree != len(rows):
        fail("phase 16 (d): the audit and the capture disagree")
    la = read_launches()
    want_kernels = ("flash_attention", "paged_decode_attention",
                    "paged_prefill_attention", "paged_prefill_attention_lse",
                    "paged_decode_attention_lse", "flash_attention_lse",
                    "flash_attention_bwd")
    if not all(la[k] for k in want_kernels):
        fail(f"phase 16: kernels {[k for k in want_kernels if not la[k]]} "
             f"not launched")
    return la


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model, local_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    t_start = time.perf_counter()
    # phase 16 (a)'s dry run of every cell on the meta device runs here,
    # beside the build and before anything initialises CUDA
    reports, build_s, sweep = dryrun_beside_build(torch, build)
    print(f"built {sorted(reports)} in {build_s:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"build and dry run ended at {time.perf_counter() - t_start:.1f} "
          f"s", flush=True)

    # phase 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    # kernels 4, 6 and 3's owned/LSE form last, in the order they came:
    # the earlier kernels draw the inputs they drew before
    entries = [check_flash(torch, dtypes, gen), check_flash_window(torch,
                                                                  dtypes),
               check_flash_bidirectional(torch, dtypes),
               check_paged(torch, gen),
               check_prefill(torch, gen), check_dense(torch, gen),
               check_wkv(torch, gen), check_lse(torch, gen),
               check_int8(torch, gen), check_prefill_lse(torch, gen)]
    check_paged_edges(torch)
    check_ring(torch)
    lse_empty_stripe(torch, 1028)
    check_verify_fold(torch)
    check_flash_head_dims(torch, dtypes)
    check_prefill_head_dims(torch)
    check_head_dim_256(torch)
    print(f"phase 1 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

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
    calls = phase4_calls(torch, model, params)
    decode = calls["decode"][1]
    host_probe(torch, "after init", decode)
    with torch.inference_mode():
        host_probe(torch, "after init, under torch.inference_mode", decode)
    launches, h8 = serve_paths(torch, model, params)
    for name, n in serve_spec(torch, model, params, h8).items():
        launches[name] += n
    host_probe(torch, "after serve", decode)
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 3
    teacher_forced(torch, model, params)
    teacher_forced_sharded(torch, model, params)
    teacher_forced_chunks(torch, model, params)
    teacher_forced_slots(torch, model, params)
    host_probe(torch, "after teacher-forced", decode)

    # phase 4
    where_time_goes(torch, calls)
    roofline_decode(torch, model, calls)
    host_probe(torch, "after phase 4", decode)
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 5: llama2-7b's weights, pools and traces go first
    del model, params, calls, decode
    torch.cuda.empty_cache()
    for name, n in rwkv_phases(torch).items():
        launches[name] += n
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 6: rwkv6-3b went at the end of phase 5
    for name, n in granite_phases(torch).items():
        launches[name] += n
    print(f"phase 6 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 7: granite's variants went at the end of phase 6
    for name, n in hymba_phases(torch).items():
        launches[name] += n
    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 8: hymba went at the end of phase 7
    for name, n in hubert_phases(torch).items():
        launches[name] += n
    print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 9: hubert went at the end of phase 8
    for name, n in llama13b_phases(torch).items():
        launches[name] += n
    print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 10: llama2-13b and its drafter went at the end of phase 9
    for name, n in cluster_phases(torch).items():
        launches[name] += n
    print(f"phase 10 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 11: phase 10's engines went with it
    for name, n in token_config_phases(torch).items():
        launches[name] += n
    print(f"phase 11 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 12: the last phase-11 model went at its end
    for name, n in fleet_phases(torch).items():
        launches[name] += n
    print(f"phase 12 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 13: minicpm3-4b (the sharded paths ran in phases 2, 6 and 11)
    for name, n in mla_phase(torch).items():
        launches[name] += n
    print(f"phase 13 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 14: training (minicpm3-4b went at the end of phase 13)
    entries += check_flash_bwd(torch)
    for name, n in training_phase(torch).items():
        launches[name] += n
    print(f"phase 14 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 15: the other four families train (phase 14's models are gone)
    entries += check_wkv_bwd(torch)
    for name, n in training15_phase(torch).items():
        launches[name] += n
    print(f"phase 15 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # phase 16: the dry run, the accounting and the audit on the card
    for name, n in analysis_phase(torch, sweep).items():
        launches[name] += n
    print(f"phase 16 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(f"all phases done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # kernels 2, 4, 5 and 6 share per-device, per-stream ticket counters
    # that every launch leaves at 0
    from repro_torch.kernels import decode_attention as da
    torch.cuda.synchronize()
    if any(int(t.abs().sum()) for t in da._TICKETS.values()):
        fail("split kernels' ticket counters are not 0 after the run")
    print(f"ticket counters: {len(da._TICKETS)} buffers, all 0", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "ms_min", "ms_max", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys if k in e}
                                  for e in entries]}))
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
