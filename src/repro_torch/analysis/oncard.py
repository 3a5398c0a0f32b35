"""The analysis held against the card: ``chip_smoke.py`` phase 16.

(Phase 16 (a), the dry run of every cell on the meta device, is
``launch.dryrun.sweep`` itself.)

* ``state_vs_allocation`` / ``pool_vs_allocation``: the bytes a meta build
  reports against the bytes a real build on the card holds, exactly, and
  the caching allocator's delta beside ``allocator_span`` of them.
* ``train_peak``: the count's peak-live estimate of one train step beside
  ``torch.cuda.max_memory_allocated`` of the same step on the card.
* ``roofline_reading``: a counted step's roofline terms beside its
  measured device time: the share of the roofline and the MFU.
* ``audit_vs_capture``: every registered audit entry (and the synthetic
  host sync and host-built tensor) run eagerly under the audit on the
  card, then captured as ``serving/graphs.py`` captures a step; the
  audit's verdict and the capture's must agree.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.roofline import HW, bound_of
from repro_torch.models.layers import tree_leaves

# PyTorch's CUDA caching allocator rounds every request up to a multiple
# of 512 B, splits a cached block when what is left of it is 512 B or more
# (requests up to 1 MiB) or more than 1 MiB (larger requests), and counts
# a block whole in ``memory_allocated``
ALLOC_ROUND = 512
ALLOC_TAIL = 1 << 20


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if t is not None)


def allocator_span(tree) -> tuple[int, int]:
    """The least and the most ``torch.cuda.memory_allocated`` grows by
    when ``tree``'s tensors are allocated one by one and kept: each
    distinct storage rounded up to ``ALLOC_ROUND``, and at most
    ``ALLOC_TAIL`` more for each above ``ALLOC_TAIL`` (its block's unsplit
    tail)."""
    storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in tree_leaves(tree) if t is not None}
    sizes = [-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in storages.values()]
    return sum(sizes), sum(sizes) + ALLOC_TAIL * sum(n > ALLOC_TAIL
                                                      for n in sizes)


def _allocated() -> int:
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else 0


def state_vs_allocation(cfg, shape, *, device="cuda",
                        plan_overrides: dict | None = None) -> dict:
    """A cell's parameter, AdamW and cache bytes as the meta build reports
    them and as a real build on ``device`` holds them (its tensors' bytes),
    ``allocated`` the allocator's delta over the real build and ``span``
    its ``allocator_span``.  Returns these and the real build."""
    from repro_torch.launch.dryrun import cell_state
    meta = cell_state(cfg, shape, device="meta",
                      plan_overrides=plan_overrides)
    before = _allocated()
    real = cell_state(cfg, shape, device=device,
                      plan_overrides=plan_overrides)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    names = ("params", "opt", "cache")
    return {"meta": dict(zip(names, map(_bytes, meta[1:]))),
            "real": dict(zip(names, map(_bytes, real[1:]))),
            "allocated": _allocated() - before,
            "span": allocator_span(real[1:]), "build": real}


def pool_vs_allocation(cfg, *, n_lanes: int, max_seq: int, block_size: int,
                       n_blocks: int | None = None, device="cuda",
                       dtype=torch.bfloat16) -> dict:
    """A paged KV pool's bytes from the meta device against the pool an
    engine of this geometry allocates on ``device``; ``allocated`` the
    allocator's delta over building the model and the pool, ``span`` the
    pool's ``allocator_span``."""
    from repro_torch.models import build_model, local_plan
    from repro_torch.serving import PagedCachePool
    plan = local_plan(param_dtype=dtype)
    meta = PagedCachePool(build_model(cfg, plan, device="meta"), n_lanes,
                          max_seq, block_size=block_size, n_blocks=n_blocks,
                          dtype=dtype)
    before = _allocated()
    real = PagedCachePool(build_model(cfg, plan, device=device), n_lanes,
                          max_seq, block_size=block_size, n_blocks=n_blocks,
                          dtype=dtype)
    out = {"n_blocks": real.n_blocks, "meta": _bytes(meta.cache),
           "real": _bytes(real.cache), "allocated": _allocated() - before,
           "span": allocator_span(real.cache)}
    del real
    return out


def train_peak(cfg, shape, build, row: dict, *, device="cuda") -> dict:
    """One AdamW train step of ``cfg`` at ``shape`` on ``build``
    (``state_vs_allocation``'s real build): the peak-live estimate of
    ``row`` (``launch.dryrun.run_cell`` of the same cell, one microbatch)
    beside ``torch.cuda.max_memory_allocated`` of the step on
    ``device``."""
    from repro_torch.training.data import DataConfig, TokenPipeline
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step
    model, params, opt, _ = build
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, shape.global_batch,
                                    shape.seq_len), device=device)
    batch = pipe.next_batch()
    step = make_train_step(model, AdamWConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(params, opt, *batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"estimate": row["peak_live_bytes"], "measured": peak,
            "ratio": row["peak_live_bytes"] / peak}


def roofline_reading(*, flops: float, n_bytes: float, model_flops: float,
                     device_ms: float, hw=HW) -> dict:
    """A counted step beside its measured device time: the roofline's
    compute and memory terms (ms), the bound (the larger), the share of
    the roofline (bound over measured) and the MFU (``model_flops`` over
    the measured time at the bf16 peak)."""
    t_compute = flops / hw.peak_flops_bf16 * 1e3
    t_memory = n_bytes / hw.hbm_bw * 1e3
    bound, by = bound_of(n_bytes, flops, "bf16", hw)
    return {"flops": flops, "bytes": n_bytes, "t_compute_ms": t_compute,
            "t_memory_ms": t_memory, "bound_ms": bound, "bound_by": by,
            "device_ms": device_ms, "roofline_share": bound / device_ms,
            "mfu": model_flops / (device_ms * 1e-3 * hw.peak_flops_bf16)}


def audit_vs_capture(device="cuda") -> list:
    """Each registered entry, then the synthetic ``item`` and
    ``host_built`` faults, on ``device``: the audit's findings from one
    eager run, then a capture of the same body as ``serving/graphs.py``
    captures a step (an eager warm-up on a side stream, then the
    capture) and one replay.  Returns ``(name, findings, captured,
    error)`` rows; the audit and the capture agree where a clean audit
    goes with a capture that succeeded."""
    from repro_torch.analysis.iraudit import (ENTRYPOINTS, AuditContext,
                                              audit_built, run_invariants)
    from repro_torch.analysis.iraudit.registry import Entrypoint, synthetic
    from repro_torch.serving.graphs import Program
    ctx = AuditContext(device=device)
    cases = [(e, e.build) for e in ENTRYPOINTS] + [
        (Entrypoint(f"synthetic_{f}", "model", None),
         lambda c, f=f: synthetic(c, f)) for f in ("item", "host_built")]
    rows = []
    for entry, build in cases:
        built = build(ctx)
        audit = audit_built(entry, built, ctx.device)
        findings = [str(f) for f in run_invariants(
            audit, ctx.model.plan.compute_dtype)]
        prog = Program(entry.name, built.body, {},
                       built.tensors or (lambda: ()), capture=True,
                       stream=torch.cuda.Stream())
        try:
            prog.run()               # warm-up and capture
            prog.run()               # a replay
            torch.cuda.synchronize()
            captured, error = prog.captures == 1 and prog.replays == 1, ""
        except RuntimeError as e:
            torch.cuda.synchronize()
            captured, error = False, str(e).splitlines()[0]
        rows.append((entry.name, findings, captured, error))
    return rows
