"""LLM serving engine: continuous batching over the paged KV pool (port of
the paged mode of ``repro.serving.engine``).

One Engine is one TAPAS "VM instance": it exposes the configurator's knobs
(max batch, frequency cap as a step-time multiplier) and reports goodput.
Admission runs bucketed batched prefill (prompts padded to power-of-two
length buckets, one prefill launch per bucket shape); decode walks
per-lane block tables, ``horizon`` greedy steps per host sync
(``Model.decode_multi_paged``).  When the pool runs out of blocks the
youngest request is preempted and recomputed later.

Ported so far: greedy requests, whole-prompt prefill.  Not ported yet (see
ROADMAP.md): the slot pool, chunked prefill and prefix sharing,
speculative decode, sampling, variants and shards, and the resilience
paths (deadlines, retries, quarantine, crash).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.transformer import Model
from repro_torch.serving.kvcache import PagedCachePool
from repro_torch.serving.request import Request

STEP_WINDOW = 512       # recent step times retained for inspection


@dataclass
class EngineKnobs:
    """The TAPAS-configurable instance settings ported so far (the variant
    and pause knobs wait for ``set_variant`` and reconfiguration)."""
    max_batch: int = 8
    freq_scale: float = 1.0      # 1.0 = nominal clock; <1 slows step time


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_batches: int = 0     # prefill launches (not requests)
    preemptions: int = 0         # requests requeued for recompute
    rejected: int = 0            # contexts that can never fit max_seq
    host_syncs: int = 0          # device->host readbacks on the serving path
    decode_syncs: int = 0        # the subset issued by decode launches
    submitted: int = 0
    n_steps: int = 0             # recorded (working) scheduler steps
    step_time_total: float = 0.0  # running sum of freq-scaled step times
    completed: list = field(default_factory=list)
    step_times: deque = field(
        default_factory=lambda: deque(maxlen=STEP_WINDOW))
    _good_acc: dict = field(default_factory=dict, repr=False)

    def record_step(self, dt: float) -> None:
        self.n_steps += 1
        self.step_time_total += dt
        self.step_times.append(dt)

    def goodput(self, *, ttft_slo: float, tbt_slo: float) -> float:
        """Tokens/s over completed requests meeting both SLOs (only
        requests finished ``accepted`` count).  Each completed request is
        folded into the per-SLO accumulator exactly once."""
        key = (ttft_slo, tbt_slo)
        idx, good, t_max = self._good_acc.get(key, (0, 0, 1e-9))
        for r in self.completed[idx:]:
            t_max = max(t_max, r.finish_s or 0.0)
            if (r.outcome == "accepted" and (r.ttft() or 0) <= ttft_slo
                    and (r.tbt() or 0) <= tbt_slo):
                good += len(r.output)
        self._good_acc[key] = (len(self.completed), good, t_max)
        return good / t_max


def _bucket(n: int, lo: int = 16, hi: int | None = None) -> int:
    """Power-of-two prompt-length bucket (bounds distinct prefill shapes),
    clamped to ``hi``; callers reject contexts longer than ``hi`` first."""
    b = lo
    while b < n:
        b *= 2
    if hi is not None:
        b = min(b, hi)
    return b


class Engine:
    def __init__(self, model: Model, params: dict, *, max_seq: int = 512,
                 n_slots: int = 8, knobs: EngineKnobs | None = None,
                 paged: bool | None = None, block_size: int = 16,
                 n_blocks: int | None = None, horizon: int = 1):
        if paged is False:
            raise NotImplementedError("the slot pool (paged=False) is not "
                                      "ported yet")
        if not model.supports_paged:
            raise ValueError(f"{model.cfg.name} cannot serve paged "
                             f"(attn_kind={model.cfg.attn_kind!r})")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        self.model = model
        self.params = params
        self.knobs = knobs or EngineKnobs(max_batch=n_slots)
        self.max_seq = max_seq
        self.n_slots = n_slots
        self.block_size = block_size
        self.horizon = horizon
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.stats = EngineStats()
        self.pool = PagedCachePool(model, n_slots, max_seq,
                                   block_size=block_size, n_blocks=n_blocks)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.model.device)

    # -- request lifecycle -------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.temperature > 0:
            raise NotImplementedError("sampled requests (temperature > 0) "
                                      "are not ported yet; serve greedy")
        if req.deadline_ms is not None:
            raise NotImplementedError("request deadlines are not ported yet")
        self.stats.submitted += 1
        self.queue.append(req)

    @staticmethod
    def _context(req: Request) -> list:
        """Prefill context: prompt plus any tokens generated before a
        preemption (recompute-style resume)."""
        return list(req.prompt) + list(req.output)

    def _finish(self, req: Request, now: float, outcome: str) -> None:
        """The single terminal transition: stamp the outcome, count it and
        log the request as completed."""
        req.finish(now, outcome)
        if outcome == "rejected":
            self.stats.rejected += 1
        self.stats.completed.append(req)

    def _reject(self, req: Request, now: float) -> None:
        """A context that can never fit the cache is finished empty."""
        self._finish(req, now, "rejected")

    def _activate(self, req: Request, tok: int, now: float) -> None:
        """Append the prefill token and either activate the request or, if
        it already hit its budget/eos, finish it without taking a lane."""
        req.output.append(tok)
        if req.first_token_s is None:
            req.first_token_s = now
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._finish(req, now, "accepted")
            self.pool.release(req.req_id)
            return
        self.active[req.req_id] = req
        self.pool.set_last_token(self.pool.lane_of[req.req_id], tok)

    def _next_from_prefill(self, logits: torch.Tensor) -> np.ndarray:
        """Each row's first output token: the greedy argmax."""
        v = self.model.cfg.vocab_size
        return logits[:, :v].argmax(dim=-1).cpu().numpy()

    def _admit_paged(self, now: float) -> None:
        """Batched admission: drain the queue into length buckets, one
        prefill launch per bucket shape (not per request)."""
        batch: list[Request] = []
        # reserve lanes/blocks as the batch builds — can_admit alone would
        # double-count the free lists across requests admitted together
        lanes_left = len(self.pool.free_lanes)
        blocks_left = len(self.pool.free_blocks)
        while (self.queue
               and len(self.active) + len(batch) < self.knobs.max_batch
               and lanes_left > 0):
            ctx_len = len(self._context(self.queue[0]))
            if ctx_len > self.max_seq - 1:
                self._reject(self.queue.popleft(), now)
                continue
            # reserve the first decode append too
            need = self.pool.blocks_for(ctx_len + 1)
            if blocks_left < need:
                break
            batch.append(self.queue.popleft())
            lanes_left -= 1
            blocks_left -= need
        if not batch:
            return
        groups: dict[int, list[Request]] = {}
        for req in batch:
            groups.setdefault(
                _bucket(len(self._context(req)), hi=self.max_seq),
                []).append(req)
        for s_bucket, reqs in sorted(groups.items()):
            b_pad = _bucket(len(reqs), lo=1)   # batch bucket, as the reference
            tokens = np.zeros((b_pad, s_bucket), np.int32)
            lengths = np.ones(b_pad, np.int32)
            for i, req in enumerate(reqs):
                ctx = self._context(req)
                tokens[i, : len(ctx)] = ctx
                lengths[i] = len(ctx)
            logits, cache = self.model.prefill_ragged(
                self.params, self._to_device(tokens),
                self._to_device(lengths))
            nxt = self._next_from_prefill(logits)
            self.stats.prefill_batches += 1
            self.stats.host_syncs += 1
            for i, req in enumerate(reqs):
                self.pool.insert(req.req_id, cache, i, int(lengths[i]))
                self.stats.prefill_tokens += int(lengths[i])
                self._activate(req, int(nxt[i]), now)

    def _preempt(self, req_ids: list) -> None:
        """Pool ran dry: drop these requests' blocks and requeue them at the
        front for recompute (prompt + generated-so-far become the context)."""
        for rid in req_ids:
            req = self.active.pop(rid)
            self.pool.release(rid)
            self.queue.appendleft(req)
            self.stats.preemptions += 1

    def _decode_paged(self, now: float) -> int:
        """Horizon decode: one ``decode_multi_paged`` call runs
        ``horizon`` steps for every lane; the host syncs once to drain the
        produced ``(tokens, emitted)``."""
        budgets = {rid: req.max_new_tokens - len(req.output)
                   for rid, req in self.active.items()}
        n_eff = self.horizon
        # allocate append blocks oldest-request-first; when the pool is
        # exhausted the youngest actives are the ones preempted
        victims = self.pool.ensure_append_blocks(
            sorted(self.active), horizon=n_eff, budgets=budgets)
        if victims:
            self._preempt(victims)
        if not self.active:
            return 0
        width = self.pool.n_lanes
        active_mask = np.zeros(width, bool)
        budget_arr = np.zeros(width, np.int32)
        eos_arr = np.full(width, -1, np.int32)
        for rid, req in self.active.items():
            lane = self.pool.lane_of[rid]
            active_mask[lane] = True
            budget_arr[lane] = budgets[rid]
            if req.eos_id is not None:
                eos_arr[lane] = req.eos_id
        toks, emitted, _, (tok_f, pos_f, _, _), _ = \
            self.model.decode_multi_paged(
                self.params, self.pool.cache, self.pool.last_tokens_dev(),
                self.pool.positions(), self.pool.tables(),
                self._to_device(active_mask), self._to_device(budget_arr),
                self._to_device(eos_arr), num_steps=n_eff,
                max_len=self.max_seq)
        # the horizon's single host sync: tokens and flags in one readback
        drained = torch.stack([toks, emitted.to(torch.int32)]).cpu().numpy()
        toks_h, em_h = drained[0], drained[1].astype(bool)
        self.stats.host_syncs += 1
        self.stats.decode_syncs += 1
        # the loop's final device state becomes the pool mirror; the numpy
        # mirrors are updated below
        self.pool.adopt_device("positions", pos_f)
        self.pool.adopt_device("last_tokens", tok_f)
        produced = 0
        finished = []
        for rid, req in list(self.active.items()):
            lane = self.pool.lane_of[rid]
            cnt = int(em_h[:, lane].sum())
            req.output.extend(int(t) for t in toks_h[:cnt, lane])
            produced += cnt
            self.pool.lengths[lane] += cnt
            self.pool.last_tokens[lane] = req.output[-1]
            full = int(self.pool.lengths[lane]) + 1 > self.max_seq
            if (len(req.output) >= req.max_new_tokens
                    or (req.eos_id is not None
                        and req.output[-1] == req.eos_id) or full):
                finished.append(rid)
        for rid in finished:
            self._finish(self.active.pop(rid), now, "accepted")
            self.pool.release(rid)
        self.stats.decode_tokens += produced
        return produced

    def step(self, now: float | None = None) -> int:
        """One scheduler iteration: admit, then one decode launch of
        ``horizon`` steps.  Returns the number of decode tokens produced."""
        t0 = time.perf_counter()
        now = now if now is not None else t0
        self._admit_paged(now)
        produced = self._decode_paged(now) if self.active else 0
        if produced:
            # simulated frequency knob: a capped clock stretches wall time
            self.stats.record_step((time.perf_counter() - t0)
                                   / max(self.knobs.freq_scale, 1e-3))
        return produced

    def run(self, *, max_steps: int = 10_000) -> EngineStats:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step(now=float(steps))
            steps += 1
        return self.stats

    def goodput(self, *, ttft_slo: float, tbt_slo: float) -> float:
        """Tokens/s over completed requests meeting both SLOs (times are in
        scheduler-step units when run() supplies logical `now`)."""
        return self.stats.goodput(ttft_slo=ttft_slo, tbt_slo=tbt_slo)
