"""LLM serving engine: continuous batching over a paged (or slot) KV cache
(port of ``repro.serving.engine``).

One Engine is one TAPAS "VM instance": it exposes the configurator's knobs
(max batch, frequency cap as a step-time multiplier, model variant) and
reports goodput.

* ``paged`` (the default for plain-GQA models): KV lives in the global
  block pool (``PagedCachePool``).  Admission runs bucketed batched
  prefill (prompts padded to power-of-two length buckets, one prefill
  launch per bucket shape); decode walks per-lane block tables,
  ``horizon`` steps per host sync (``Model.decode_multi_paged``'s step).
  When the pool runs out of blocks the youngest request is preempted and
  recomputed later.  With ``prefill_chunk=C`` prompts instead stream into
  the pool C tokens per scheduler step, every prefilling row in one
  launch, interleaved with decode; with ``prefix_share=True`` admission
  reuses the refcounted blocks of a prompt head another request wrote.
* ``slots`` (``paged=False``): the contiguous slot pool (``CachePool``),
  one exact-length prefill per admitted request and one decode step per
  scheduler step.

``set_variant(name)`` reloads another registered model variant
(``add_variant``): a model size, or the int8-expert form of a MoE model
(``ShardPlan.quantize_serve``), TAPAS's quantization knob (paper §4.3).
In-flight requests are preempted and recomputed under the new variant.

``set_shards(n)`` reconfigures the model-parallel degree: the paged pool
is block-striped over ``n`` ranks and every decode step and chunk tick
attends stripe by stripe; a MoE layer combines its experts over ``n``
ranks.  All stripes and ranks live on the engine's one device (the
reference puts each on its own device), so no device count limits ``n``.

Sampled requests (``temperature > 0``, optional ``top_k``) draw every
token under a key folded from the request's seed (its own, or one derived
from the engine's ``seed`` and its id) and the token's absolute sequence
index, ``jax.random``'s keys bit for bit (``models.prng``): a draw
depends on its logits and that key alone, never on preemption, horizon
splits or capture (a preempted request's recomputed logits may still
differ in the last bits in bf16).

Speculative decode (``draft="ngram"``, or a model drafter registered with
``add_drafter`` and chosen with ``set_drafter``): each decode launch runs
``horizon`` verify rounds, each proposing ``spec_k`` drafts per lane,
verifying them with the current token in one target pass (the candidates
folded into the decode step's lanes, so kernel 2 carries verify) and
emitting the accepted prefix plus one corrected or bonus token; one host
sync drains up to ``horizon * (spec_k + 1)`` tokens a lane.  A model
drafter's KV pool shares the target pool's block tables; its prompts are
prefilled beside the target's.

``graphs=True`` (the default) runs the decode horizon, the speculative
round, the chunk tick and the slot step as CUDA graphs captured once per
shape and replayed (``serving.graphs``), the counterpart of the
reference's jitted steps; on the CPU the same steps run eagerly.
``graphs=False`` runs them eagerly on the card too, as ``jax.disable_jit``
does for the reference.  Every deliberate host-device copy (the staging of
a step's host state, the one readback per horizon) goes through
``analysis.lint.runtime``'s ``sanctioned``/``sanctioned_readback``, as the
reference's goes through explicit ``device_put``/``np.asarray``: under
``no_implicit_syncs`` any other sync on the path raises.

Resilience (the fault model of ``core.faults``): ``EngineKnobs.paused``
holds admission through a reconfiguration drain; requests with
``deadline_ms`` are evicted once past it, wherever they are; a quarantined
request is retried with exponential backoff, up to its ``max_retries``;
``inject_kv_corruption`` poisons a block of an active lane with NaNs and
arms the guard, whose scan before the next decode quarantines every lane
holding a non-finite written position; ``crash``/``restore`` take the
engine offline and rebuild its pool, re-queueing (or, with ``drop=True``,
returning) its unfinished work; ``take_unfinished`` strips it for a
watchdog to re-home.  On the no-fault path none of it launches or syncs
anything.

Every path of the reference's engine is ported: greedy and sampled
requests; variants; shards > 1 on every paged path (whole-prompt and
chunked prefill, prefix sharing, speculative decode, MoE); the pause knob
and the resilience paths.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analysis.lint.runtime import sanctioned, sanctioned_readback
from repro_torch.configs.drafters import check_draft_pair
from repro_torch.core.traces import _stable_seed
from repro_torch.models.transformer import (SALT_SAMPLE, Model, event_keys,
                                            lane_keys, sample_from_dist,
                                            sampling_dist)
from repro_torch.serving import graphs as G
from repro_torch.serving.kvcache import CachePool, PagedCachePool
from repro_torch.serving.request import Request

STEP_WINDOW = 512       # recent step times retained for inspection


@dataclass
class EngineKnobs:
    """The TAPAS-configurable instance settings."""
    max_batch: int = 8
    freq_scale: float = 1.0      # 1.0 = nominal clock; <1 slows step time
    variant: str = "full"        # model-size / quantization variant key
    paused: bool = False         # drained during reconfiguration (§4.3)


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_batches: int = 0     # prefill launches (not requests)
    preemptions: int = 0         # requests requeued for recompute (pool ran
    #                              dry, or displaced by a variant reload)
    variant_swaps: int = 0       # set_variant reloads (may preempt actives)
    shard_swaps: int = 0         # set_shards reconfigures (preempt actives)
    rejected: int = 0            # finished "rejected": contexts that can
    #                              never fit max_seq, or retry-exhausted
    host_syncs: int = 0          # device->host readbacks on the serving path
    decode_syncs: int = 0        # the subset issued by decode launches
    # speculative decode: one verify pass emits a whole accepted run, so
    # tokens per pass (and per sync) is what speculation buys
    draft_tokens: int = 0        # drafts proposed across verify passes
    accepted_tokens: int = 0     # drafts accepted (bonus tokens excluded)
    verify_passes: int = 0       # target verify passes (lane-rounds) run
    # resilience: each counter tracks one recovery mechanism; terminal
    # outcomes live on the Request (mutually exclusive), these count
    # events, so retried can exceed the number of requests
    submitted: int = 0           # requests ever handed to submit()
    timed_out: int = 0           # requests evicted past their deadline_ms
    retried: int = 0             # re-queues via the bounded-retry path
    #                              (quarantine), not preemptions
    retry_exhausted: int = 0     # retry budget burned -> finished rejected
    quarantined: int = 0         # lanes pulled by the NaN/Inf KV guard
    guard_scans: int = 0         # pre-decode corruption scans launched
    crashes: int = 0             # crash() invocations survived
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

    @property
    def accepted_per_sync(self) -> float:
        """Accepted draft tokens per decode sync: the free tokens each
        host round trip carried on top of the one-per-pass baseline."""
        return self.accepted_tokens / max(self.decode_syncs, 1)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the target accepted."""
        return self.accepted_tokens / max(self.draft_tokens, 1)


def shard_compat(shards: int, cfg) -> str | None:
    """Why ``cfg`` cannot serve at ``shards``-way model parallelism, or
    None when it can.

    Sharded serving requires *identity pads*: head, kv-head, vocab and ffn
    counts that the shard degree divides, so the parameters carry over
    unchanged between plans on ``set_shards`` and the KV pool keeps the
    real head count."""
    if shards <= 1:
        return None
    if cfg.n_kv_heads and cfg.n_kv_heads % shards:
        return (f"{cfg.name}: n_kv_heads={cfg.n_kv_heads} is not divisible "
                f"by shard degree {shards}")
    if cfg.n_heads % shards:
        return (f"{cfg.name}: n_heads={cfg.n_heads} is not divisible by "
                f"shard degree {shards}")
    if cfg.vocab_size % shards:
        return (f"{cfg.name}: vocab_size={cfg.vocab_size} is not divisible "
                f"by shard degree {shards}")
    if cfg.d_ff % shards:
        return (f"{cfg.name}: d_ff={cfg.d_ff} is not divisible by "
                f"shard degree {shards}")
    return None


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
                 n_blocks: int | None = None, horizon: int = 1,
                 prefill_chunk: int | None = None,
                 prefix_share: bool = False, spec_k: int = 4,
                 draft: str | None = None, ngram: int = 2, seed: int = 0,
                 graphs: bool = True):
        self.model = model
        self.variants: dict[str, tuple[Model, dict]] = {"full": (model,
                                                                params)}
        self.knobs = knobs or EngineKnobs(max_batch=n_slots)
        self.max_seq = max_seq
        self.n_slots = n_slots
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.paged = model.supports_paged if paged is None else paged
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        self.horizon = horizon
        # prefix sharing rides on the chunked (in-pool) prefill path: a
        # shared head must be skipped, so the suffix is prefilled against
        # the pool; default to one whole-prompt-sized chunk when unset
        if prefix_share and prefill_chunk is None:
            prefill_chunk = max_seq
        self.prefill_chunk = prefill_chunk
        self.prefix_share = prefix_share
        if (prefill_chunk or prefix_share) and not self.paged:
            raise ValueError("chunked prefill / prefix sharing require the "
                             "paged serving mode")
        # speculative decode: ``draft`` picks the proposer ("ngram" =
        # prompt lookup, or a model drafter registered by add_drafter);
        # spec_k drafts are verified per target pass.  draft=None keeps
        # the plain horizon decode
        if draft is not None and not self.paged:
            raise ValueError("speculative decoding requires the paged "
                             "serving mode")
        if draft is not None and spec_k < 1:
            raise ValueError(f"spec_k must be >= 1 with a drafter, "
                             f"got {spec_k}")
        if draft is not None and draft != "ngram":
            raise ValueError("model drafters are registered via "
                             "add_drafter()/set_drafter(); the constructor "
                             "only accepts draft='ngram' or None")
        self.spec_k = spec_k
        self.draft_name = draft
        self.ngram = ngram
        self.drafters: dict[str, tuple[Model, dict]] = {}
        self.seed = seed
        self.graphs = graphs
        self._stream = None           # the side stream captures run on
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.prefilling: dict[int, Request] = {}
        self._prefill_pos: dict[int, int] = {}
        self._pending_waiter: int | None = None   # req deferred on a
        #                                           pending shared prefill
        # resilience state, inert on the no-fault path: the backoff heap
        # stays empty, deadline eviction is gated on _has_deadlines and
        # the guard scan runs only while armed, so fault-free streams and
        # host syncs are those of an engine without it
        self.offline = False          # crash()ed and not yet restore()d
        self.slow_factor = 1.0        # stuck-slow fault: step-time stretch
        self.retry_backoff_s = 0.05   # base of the exponential re-queue
        #                               backoff (doubles per retry)
        self._guard_armed = False     # scan KV for NaN/Inf before decode
        self._delayed: list = []      # (not_before_s, seq, req) heap
        self._delay_seq = 0
        self._has_deadlines = False
        self.stats = EngineStats()
        self._bind(model)

    def _make_pool(self) -> None:
        """(Re)create the KV pool for the current model.  The step
        programs captured the old pool's tensors, so they go with it: no
        graph is ever replayed against a freed pool.  The old pool is
        dropped before the new one is allocated."""
        # step programs by (path, variant, shards, shape, sampled)
        self.programs: dict[tuple, G.Program] = {}
        self.pool = None
        if self.paged:
            self.pool = PagedCachePool(self.model, self.n_slots, self.max_seq,
                                       block_size=self.block_size,
                                       n_blocks=self.n_blocks)
        else:
            self.pool = CachePool(self.model, self.n_slots, self.max_seq)

    def _bind(self, model: Model) -> None:
        """(Re)build the pool for ``model``; the step programs, which
        captured the old parameters and pool, go with them."""
        self.model = model
        if self.paged and not model.supports_paged:
            raise ValueError(f"{model.cfg.name} cannot serve paged "
                             f"(attn_kind={model.cfg.attn_kind!r})")
        self._make_pool()
        self._bind_spec()

    @property
    def captured(self) -> bool:
        """Do the step programs run as CUDA graphs?  Only on a CUDA
        device, and only with ``graphs=True``."""
        return self.graphs and self.model.device.type == "cuda"

    def _program(self, key: tuple, make, tensors=None) -> G.Program:
        """The step program under ``key``, built by ``make(tensors,
        capture=..., stream=...)`` on first use.  ``tensors(engine)`` picks
        what the program works on, by default the active variant's
        (parameters, pool).  The program reaches the engine through a weak
        reference: the engine holds its programs, so a strong one would
        keep a dropped engine's pools (GBs at full width) alive until the
        cyclic collector ran."""
        prog = self.programs.get(key)
        if prog is None:
            if self.captured and self._stream is None:
                self._stream = torch.cuda.Stream(self.model.device)
            pick = tensors or (lambda eng: (eng.params, eng.pool.cache))
            ref = weakref.ref(self)
            prog = make(lambda: pick(ref()), capture=self.captured,
                        stream=self._stream)
            self.programs[key] = prog
        return prog

    # -- speculative decode (drafter lifecycle) ----------------------------
    @property
    def _spec_on(self) -> bool:
        return self.paged and self.spec_k > 0 and self.draft_name is not None

    def _bind_spec(self) -> None:
        """(Re)bind the speculative path to the current target model and
        drafter choice: attach a fresh (cold) drafter pool to the paged
        pool, or detach it, and drop the speculative programs and the
        drafter's chunk ticks, which captured the old ones."""
        self._d_model = self._d_params = None
        self.programs = {k: v for k, v in self.programs.items()
                         if k[0] not in ("spec", "draft tick")}
        if not self._spec_on or self.draft_name == "ngram":
            if self.paged:
                self.pool.detach_draft()
            return
        d_model, d_params = self.drafters[self.draft_name]
        check_draft_pair(self.model.cfg, d_model.cfg)
        self.pool.attach_draft(d_model)
        self._d_model, self._d_params = d_model, d_params

    def add_drafter(self, name: str, model: Model, params: dict) -> None:
        """Register a small same-tokenizer model as a drafter choice
        (pairing is validated: shared vocab, paged-servable)."""
        check_draft_pair(self.model.cfg, model.cfg)
        self.drafters[name] = (model, params)

    def set_drafter(self, name: str | None) -> None:
        """Switch the speculation proposer mid-flight: None (off),
        "ngram" (prompt lookup), or a registered model drafter.

        In-flight requests keep their target KV: speculation changes how
        candidates are proposed, never what the target accepts, so
        nothing is preempted.  A freshly attached model drafter starts
        with a cold draft pool, which costs acceptance until lanes turn
        over, not correctness."""
        if name == self.draft_name:
            return
        if name is not None and name != "ngram" and name not in self.drafters:
            raise KeyError(f"unknown drafter {name!r}")
        self.draft_name = name
        self._bind_spec()

    # -- variant management (model-size / quantization knob) --------------
    def add_variant(self, name: str, model: Model, params: dict) -> None:
        self.variants[name] = (model, params)

    def set_variant(self, name: str) -> None:
        """Reload a different model variant (costs a pause, paper §4.3).

        In-flight requests lose their KV state (the new variant's pool is
        rebuilt) but are not dropped: they are preempted (blocks released,
        requeued at the front) and recomputed under the new variant, as in
        a pool-exhaustion preemption.  A variant that cannot serve at the
        current shard degree is refused before anything is preempted.
        Setting the active variant is a no-op."""
        if name == self.knobs.variant:
            return
        model, _ = self.variants[name]
        err = shard_compat(self.shards, model.cfg)
        if err is not None:
            raise ValueError(f"set_variant({name!r}) at shard degree "
                             f"{self.shards}: {err}")
        in_flight = set(self.active) | set(self.prefilling)
        if in_flight:
            # reverse-sorted so the front of the queue ends up in rid order
            self._preempt(sorted(in_flight, reverse=True))
        self.knobs.variant = name
        self.stats.variant_swaps += 1
        self._bind(model)

    def variant_compatible(self, name: str) -> bool:
        """Can ``set_variant(name)`` succeed at the current shard degree?"""
        if name not in self.variants:
            return False
        return shard_compat(self.shards, self.variants[name][0].cfg) is None

    @property
    def params(self) -> dict:
        """The active variant's parameters."""
        return self.variants[self.knobs.variant][1]

    @params.setter
    def params(self, params: dict) -> None:
        model, _ = self.variants[self.knobs.variant]
        self.variants[self.knobs.variant] = (model, params)

    # -- shard management (parallelism-degree knob) ------------------------
    @property
    def shards(self) -> int:
        """Current model-parallel degree of the serving plan."""
        plan = self.model.plan
        return plan.tp if plan.paged_pool_sharded(self.model.cfg) else 1

    def can_shard(self, n: int) -> str | None:
        """Why the engine cannot reconfigure to ``n``-way model
        parallelism (None = it can): the paged mode, and every registered
        variant's and drafter's counts divide cleanly.  The reference also
        needs ``n`` devices; here every stripe lives on the engine's one
        device, so that objection does not arise."""
        if n < 1:
            return f"shard degree must be >= 1, got {n}"
        if n == 1:
            return None
        if not self.paged:
            return "sharded serving requires the paged mode"
        for kind, reg in (("variant", self.variants),
                          ("drafter", self.drafters)):
            for name, (m, _) in reg.items():
                err = shard_compat(n, m.cfg)
                if err is not None:
                    return f"{kind} {name!r}: {err}"
        return None

    def set_shards(self, n: int) -> None:
        """Reconfigure the model-parallel degree (costs a pause, like a
        variant reload): preempt in-flight work, rebuild every registered
        variant's model under the new plan with the same parameters, and
        rebuild the pool.  Raises ``ValueError``, without preempting, when
        ``can_shard`` objects.

        Each variant keeps its own ``quantize_serve``, where the
        reference's rebuild under ``serving_plan`` drops it (its int8
        variant would then look up bf16 experts it does not hold)."""
        if n == self.shards:
            return
        err = self.can_shard(n)
        if err is not None:
            raise ValueError(f"set_shards({n}): {err}")
        from repro_torch.serving.spec import serving_plan  # import cycle
        plan = serving_plan(n, param_dtype=self.model.plan.param_dtype)
        in_flight = set(self.active) | set(self.prefilling)
        if in_flight:
            self._preempt(sorted(in_flight, reverse=True))
        def rebuild(reg: dict) -> dict:
            return {k: (Model(m.cfg, dataclasses.replace(
                plan, quantize_serve=m.plan.quantize_serve), m.device), p)
                for k, (m, p) in reg.items()}

        self.variants = rebuild(self.variants)
        self.drafters = rebuild(self.drafters)
        self.stats.shard_swaps += 1
        self._bind(self.variants[self.knobs.variant][0])

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        with sanctioned():
            return torch.from_numpy(a).to(self.model.device)

    # -- request lifecycle -------------------------------------------------
    def submit(self, req: Request) -> None:
        self.stats.submitted += 1
        if req.deadline_ms is not None:
            self._has_deadlines = True
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
        if outcome == "timed_out":
            self.stats.timed_out += 1
        elif outcome == "rejected":
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
        if self._spec_on:
            lane = self.pool.lane_of[req.req_id]
            self.pool.set_hist_token(lane, int(self.pool.lengths[lane]), tok)
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._finish(req, now, "accepted")
            self.pool.release(req.req_id)
            return
        self.active[req.req_id] = req
        if self.paged:
            self.pool.set_last_token(self.pool.lane_of[req.req_id], tok)

    def _req_seed(self, req: Request) -> int:
        """Per-request deterministic sampling seed: the request's own, or
        a crc32 fold of (engine seed, req_id) — process-stable, so
        sampled replays reproduce across runs."""
        if req.seed is not None:
            return int(req.seed) % (2 ** 31)
        return _stable_seed("request", self.seed, req.req_id) % (2 ** 31)

    def _sampling(self, reqs: dict) -> tuple:
        """Host arrays of temperatures, top-k and seeds for ``{lane:
        request}`` over ``width`` lanes (unused lanes greedy)."""
        width = self.pool.n_lanes if self.paged else self.pool.n_slots
        temps = np.zeros(width, np.float32)
        top_ks = np.zeros(width, np.int32)
        seeds = np.zeros(width, np.int32)
        for lane, req in reqs.items():
            temps[lane] = req.temperature
            top_ks[lane] = req.top_k
            seeds[lane] = self._req_seed(req)
        return temps, top_ks, seeds

    def _next_from_prefill(self, logits: torch.Tensor, reqs: list,
                           idx) -> np.ndarray:
        """Each row's first output token from its prefill logits: the
        argmax, with sampled rows (temperature > 0) drawn from the warped
        distribution under the request's key at sequence index ``idx``
        (the context's length); one readback either way."""
        v = self.model.cfg.vocab_size
        nxt = logits[:, :v].argmax(dim=-1).to(torch.int32)
        if any(r.temperature > 0 for r in reqs):
            rows, dev = len(reqs), logits.device
            with sanctioned():
                temps = torch.tensor([r.temperature for r in reqs],
                                     dtype=torch.float32, device=dev)
                top_ks = torch.tensor([r.top_k for r in reqs],
                                      dtype=torch.int32, device=dev)
                seeds = torch.tensor([self._req_seed(r) for r in reqs],
                                     dtype=torch.int32, device=dev)
                pos = torch.as_tensor(np.asarray(idx[:rows], np.int32),
                                      device=dev)
            keys = event_keys(lane_keys(seeds), pos, SALT_SAMPLE)
            nxt[:rows] = sample_from_dist(
                keys, sampling_dist(logits[:rows, :v], temps, top_ks),
                temps <= 0.0)
        return sanctioned_readback(nxt)

    # -- resilience: deadlines, bounded retry, NaN quarantine, crash -------
    def _release_delayed(self, now: float) -> None:
        """Move backoff-delayed retries whose time has come back into the
        admission queue (no-op while the heap is empty)."""
        while self._delayed and self._delayed[0][0] <= now:
            _, _, req = heapq.heappop(self._delayed)
            self.queue.append(req)

    def _expire_deadlines(self, now: float) -> None:
        """Evict every request past its deadline — queued, backing off,
        prefilling or active — so expired work never holds a lane.  Gated
        on _has_deadlines: an engine that never saw a deadline_ms skips
        it entirely."""
        if not self._has_deadlines:
            return

        def expired(r: Request) -> bool:
            return r.deadline_s is not None and now >= r.deadline_s

        if any(expired(r) for r in self.queue):
            kept: deque[Request] = deque()
            for req in self.queue:
                if expired(req):
                    self._finish(req, now, "timed_out")
                else:
                    kept.append(req)
            self.queue = kept
        if any(expired(item[2]) for item in self._delayed):
            kept_d = []
            for item in self._delayed:
                if expired(item[2]):
                    self._finish(item[2], now, "timed_out")
                else:
                    kept_d.append(item)
            self._delayed = kept_d
            heapq.heapify(self._delayed)
        for rid in sorted((rid for rid, r in self.active.items()
                           if expired(r)), reverse=True):
            req = self.active.pop(rid)
            self.pool.release(rid)
            self._finish(req, now, "timed_out")
        for rid in sorted((rid for rid, r in self.prefilling.items()
                           if expired(r)), reverse=True):
            req = self.prefilling.pop(rid)
            del self._prefill_pos[rid]
            self.pool.release(rid)
            self._finish(req, now, "timed_out")

    def _requeue_for_retry(self, req: Request, now: float) -> None:
        """Bounded retry on the recompute path: re-queue with exponential
        backoff, or finish rejected once the budget is burned.  Unlike
        _preempt (scheduler churn: unlimited, no backoff), retries are
        fault recovery: bounded and backed off."""
        if req.retries >= req.max_retries:
            self.stats.retry_exhausted += 1
            self._finish(req, now, "rejected")
            return
        req.retries += 1
        self.stats.retried += 1
        delay = self.retry_backoff_s * (2.0 ** (req.retries - 1))
        self._delay_seq += 1
        heapq.heappush(self._delayed, (now + delay, self._delay_seq, req))

    def _quarantine_scan(self, now: float) -> int:
        """Pre-decode NaN/Inf sweep over the active lanes' written KV.
        Runs only while armed (a fault injection just landed), so the
        no-fault path never pays the scan or its readback.  A corrupted
        lane is quarantined: its blocks scrubbed and released, its request
        re-queued for recompute through the bounded retry, so the
        corrupted KV never feeds a decode step and a recovered stream
        equals the fault-free one."""
        if not (self._guard_armed and self.paged and self.active):
            return 0
        self._guard_armed = False
        mask = np.zeros(self.pool.n_lanes, bool)
        for rid in self.active:
            mask[self.pool.lane_of[rid]] = True
        bad = self.pool.bad_lanes(mask)
        self.stats.host_syncs += 1
        self.stats.guard_scans += 1
        bad_rids = sorted((rid for rid in self.active
                           if bad[self.pool.lane_of[rid]]), reverse=True)
        for rid in bad_rids:
            req = self.active.pop(rid)
            self.pool.scrub_lane(rid)     # never recycle poisoned blocks
            self.pool.release(rid)
            self.stats.quarantined += 1
            self._requeue_for_retry(req, now)
        return len(bad_rids)

    def inject_kv_corruption(self, rid: int, *, last_block: bool = False,
                             arm_guard: bool = True) -> None:
        """Fault hook: poison one of an active request's KV blocks with
        NaNs (its oldest block by default, cold corruption; its freshest
        with ``last_block``, a NaN-logit burst) and arm the guard scan.
        ``arm_guard=False`` models an unguarded engine: the corruption
        stays and the next decode reads it."""
        if not self.paged:
            raise ValueError("KV corruption targets the paged pool")
        if rid not in self.active:
            raise KeyError(f"request {rid} is not active")
        lane = self.pool.lane_of[rid]
        n_written = max(1, int(self.pool.lengths[lane]))
        idx = (n_written - 1) // self.pool.block_size if last_block else 0
        self.pool.corrupt_lane(lane, block_idx=idx)
        if arm_guard:
            self._guard_armed = True

    def crash(self, now: float, *, drop: bool = False) -> list:
        """Simulate process death.  The engine goes offline (step() is a
        no-op until restore()) and all KV state is lost: the pool is
        rebuilt and the step programs with it.  With ``drop=False``
        unfinished work is re-queued for recompute after the restart; with
        ``drop=True`` (recovery off) every unfinished request is returned
        unfinished, the silent loss the resilience audit exists to
        catch."""
        self.stats.crashes += 1
        self.offline = True
        dropped: list[Request] = []
        for rid in sorted(set(self.active) | set(self.prefilling),
                          reverse=True):
            req = self.active.pop(rid, None)
            if req is None:
                req = self.prefilling.pop(rid)
                del self._prefill_pos[rid]
            if drop:
                dropped.append(req)
            else:
                self.queue.appendleft(req)
        if drop:
            dropped.extend(self.queue)
            self.queue.clear()
            dropped.extend(item[2] for item in self._delayed)
            self._delayed.clear()
        self._pending_waiter = None
        self._prefill_pos.clear()
        self._make_pool()
        if self._d_model is not None:
            self.pool.attach_draft(self._d_model)
        return dropped

    def restore(self) -> None:
        """Bring a crashed engine back online (its queue survives; crash()
        already wiped the KV)."""
        self.offline = False

    def heartbeat(self) -> bool:
        """Liveness probe the watchdog polls each tick."""
        return not self.offline

    def take_unfinished(self) -> list:
        """Strip every unfinished request off this engine (a watchdog
        drain onto siblings): in-flight KV released, queued and backing-
        off work unhooked.  Returns the requests sorted by req_id, so
        re-homing is deterministic."""
        out = list(self.queue)
        self.queue.clear()
        out.extend(item[2] for item in self._delayed)
        self._delayed.clear()
        for rid in sorted(set(self.active) | set(self.prefilling),
                          reverse=True):
            req = self.active.pop(rid, None)
            if req is None:
                req = self.prefilling.pop(rid)
                del self._prefill_pos[rid]
            self.pool.release(rid)
            out.append(req)
        self._pending_waiter = None
        return sorted(out, key=lambda r: r.req_id)

    def _admit(self, now: float) -> None:
        if self.paged:
            if self.prefill_chunk:
                self._admit_chunked(now)
            else:
                self._admit_paged(now)
            return
        # slot pool: one exact-length prefill (and one host sync) per request
        while (self.queue and self.pool.has_free()
               and len(self.active) < self.knobs.max_batch
               and not self.knobs.paused):
            if len(self._context(self.queue[0])) > self.max_seq - 1:
                self._reject(self.queue.popleft(), now)
                continue
            req = self.queue.popleft()
            ctx = self._context(req)
            logits, cache = self.model.prefill(
                self.params, self._to_device(np.asarray([ctx], np.int32)))
            self.stats.prefill_tokens += len(ctx)
            self.stats.prefill_batches += 1
            tok = int(self._next_from_prefill(logits, [req],
                                              [len(ctx)])[0])
            self.stats.host_syncs += 1
            self.pool.insert(req.req_id, cache, len(ctx))
            self._activate(req, tok, now)

    def _admit_paged(self, now: float) -> None:
        """Batched admission: drain the queue into length buckets, one
        prefill launch per bucket shape (not per request)."""
        batch: list[Request] = []
        # reserve lanes/blocks as the batch builds — can_admit alone would
        # double-count the free lists across requests admitted together
        lanes_left = len(self.pool.free_lanes)
        blocks_left = len(self.pool.free_blocks)
        while (self.queue and not self.knobs.paused
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
            nxt = self._next_from_prefill(logits, reqs, lengths)
            self.stats.prefill_batches += 1
            self.stats.host_syncs += 1
            d_cache = None
            if self._d_model is not None:
                # the drafter's KV for the same rows, scattered into the
                # SAME blocks (the draft pool shares this pool's tables)
                _, d_cache = self._d_model.prefill_ragged(
                    self._d_params, self._to_device(tokens),
                    self._to_device(lengths))
            for i, req in enumerate(reqs):
                lane = self.pool.insert(req.req_id, cache, i,
                                        int(lengths[i]))
                if self._spec_on:
                    self.pool.set_hist(lane, self._context(req))
                if d_cache is not None:
                    self.pool.insert_draft(req.req_id, d_cache, i,
                                           int(lengths[i]))
                self.stats.prefill_tokens += int(lengths[i])
                self._activate(req, int(nxt[i]), now)

    def _admit_chunked(self, now: float) -> None:
        """Chunked-prefill admission: claim a lane plus every block the
        context needs (reusing prefix-shared blocks), then let
        ``_prefill_tick`` stream the prompt into the pool one chunk per
        scheduler step, interleaved with decode."""
        while (self.queue and not self.knobs.paused
               and len(self.active) + len(self.prefilling)
               < self.knobs.max_batch):
            ctx = self._context(self.queue[0])
            if len(ctx) > self.max_seq - 1:
                self._reject(self.queue.popleft(), now)
                continue
            shared = self.pool.shared_prefix(ctx) if self.prefix_share \
                else []
            if self.prefix_share and self.pool.pending_shared(
                    ctx, have=len(shared)):
                # an in-flight prefill owns this prompt's next shareable
                # block: wait at the queue head and attach to its copy
                # (pending claims are released on preemption, so the wait
                # cannot deadlock)
                if self.queue[0].req_id != self._pending_waiter:
                    self._pending_waiter = self.queue[0].req_id
                    self.pool.pending_share_waits += 1
                break
            lane = self.pool.admit_prefill(self.queue[0].req_id, len(ctx),
                                           shared)
            if lane is None:
                break
            req = self.queue.popleft()
            if self._spec_on:
                self.pool.set_hist(lane, ctx)
            self.prefilling[req.req_id] = req
            self._prefill_pos[req.req_id] = \
                len(shared) * self.pool.block_size
            if self.prefix_share:
                self.pool.register_pending(req.req_id, ctx)

    def _prefill_tick(self, now: float) -> int:
        """Advance every in-progress prefill by one chunk: one
        ``prefill_chunk_paged`` launch over all prefilling rows, padded to
        shared row and chunk buckets."""
        if not self.prefilling:
            return 0
        reqs = sorted(self.prefilling.values(), key=lambda r: r.req_id)
        ctxs = [self._context(r) for r in reqs]
        takes = [min(self.prefill_chunk,
                     len(ctx) - self._prefill_pos[r.req_id])
                 for r, ctx in zip(reqs, ctxs)]
        c_pad = _bucket(max(takes), lo=min(16, self.prefill_chunk))
        b_pad = _bucket(len(reqs), lo=1)
        tokens = np.zeros((b_pad, c_pad), np.int32)
        starts = np.zeros(b_pad, np.int32)
        lens = np.zeros(b_pad, np.int32)
        tables = np.zeros((b_pad, self.pool.blocks_per_seq), np.int32)
        for i, (req, ctx, take) in enumerate(zip(reqs, ctxs, takes)):
            pos = self._prefill_pos[req.req_id]
            tokens[i, :take] = ctx[pos:pos + take]
            starts[i] = pos
            lens[i] = take
            tables[i] = self.pool.block_tables[self.pool.lane_of[req.req_id]]
        width = self.pool.blocks_per_seq
        prog = self._program(
            ("tick", self.knobs.variant, self.shards, b_pad, c_pad, width),
            lambda tensors, **kw: G.chunk_program(self.model, tensors, b_pad,
                                                  c_pad, width, **kw))
        progs = [prog]
        if self._d_model is not None:
            # stream the same chunk through the drafter into its pool
            d_model, name = self._d_model, self.draft_name
            progs.append(self._program(
                ("draft tick", name, self.shards, b_pad, c_pad, width),
                lambda tensors, **kw: G.chunk_program(d_model, tensors, b_pad,
                                                      c_pad, width, **kw),
                lambda eng: (eng._d_params, eng.pool.draft_cache)))
        for p in progs:
            with sanctioned():
                for name, a in (("tokens", tokens), ("starts", starts),
                                ("lens", lens), ("tables", tables)):
                    p.bufs[name].copy_(torch.from_numpy(a))
            p.run()
        self.stats.prefill_batches += 1
        nxt = None
        if any(self._prefill_pos[r.req_id] + t == len(ctx)
               for r, ctx, t in zip(reqs, ctxs, takes)):
            nxt = self._next_from_prefill(
                prog.bufs["logits"], reqs,
                [self._prefill_pos[r.req_id] + t
                 for r, t in zip(reqs, takes)])
            self.stats.host_syncs += 1
        worked = 0
        for i, (req, ctx, take) in enumerate(zip(reqs, ctxs, takes)):
            self._prefill_pos[req.req_id] += take
            self.stats.prefill_tokens += take
            worked += take
            if self._prefill_pos[req.req_id] == len(ctx):
                rid = req.req_id
                del self.prefilling[rid]
                del self._prefill_pos[rid]
                self.pool.set_length(self.pool.lane_of[rid], len(ctx))
                if self.prefix_share:
                    self.pool.register_prefix(rid, ctx)
                self._activate(req, int(nxt[i]), now)
        return worked

    def _preempt(self, req_ids: list) -> None:
        """Pool ran dry: drop these requests' blocks and requeue them at the
        front for recompute (prompt + generated-so-far become the context).
        A request still prefilling loses the chunks it wrote so far."""
        for rid in req_ids:
            req = self.active.pop(rid, None)
            if req is None:
                req = self.prefilling.pop(rid)
                del self._prefill_pos[rid]
            self.pool.release(rid)
            self.queue.appendleft(req)
            self.stats.preemptions += 1

    def _decode_paged(self, now: float) -> int:
        """Horizon decode: ``horizon`` runs of the step program (captured:
        replays of one CUDA graph) advance every lane; the host syncs once
        to drain the produced ``(tokens, emitted)``."""
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
        # sampling buffers only when some lane samples, so an all-greedy
        # batch runs the greedy program
        sampled = any(r.temperature > 0 for r in self.active.values())
        T = self.pool.blocks_per_seq
        prog = self._program(
            ("horizon", self.knobs.variant, self.shards, width, T, sampled),
            lambda tensors, **kw: G.horizon_program(
                self.model, tensors, width, T, max_len=self.max_seq,
                sampled=sampled, **kw))
        b = prog.bufs
        b["tokens"].copy_(self.pool.last_tokens_dev())
        b["positions"].copy_(self.pool.positions())
        b["tables"].copy_(self.pool.tables())
        with sanctioned():
            for name, a in (("active", active_mask), ("budgets", budget_arr),
                            ("eos", eos_arr)):
                b[name].copy_(torch.from_numpy(a))
            if sampled:
                G.set_sampling(b, *self._sampling(
                    {self.pool.lane_of[rid]: req
                     for rid, req in self.active.items()}))
        toks, emitted = G.run_horizon(prog, n_eff)
        # the horizon's single host sync: tokens and flags in one readback
        drained = sanctioned_readback(
            torch.stack([toks, emitted.to(torch.int32)]))
        toks_h, em_h = drained[0], drained[1].astype(bool)
        self.stats.host_syncs += 1
        self.stats.decode_syncs += 1
        # the loop's final device state becomes the pool mirror; the numpy
        # mirrors are updated below
        self.pool.adopt_device("positions", b["positions"])
        self.pool.adopt_device("last_tokens", b["tokens"])
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

    def _decode_spec(self, now: float) -> int:
        """Speculative decode: ``horizon`` runs of the speculative round
        program (captured: replays of one CUDA graph), each advancing every
        lane by its accepted drafts + 1; one host sync drains up to
        ``horizon * (spec_k + 1)`` tokens a lane, with the flags and
        accepted counts, in one readback."""
        budgets = {rid: req.max_new_tokens - len(req.output)
                   for rid, req in self.active.items()}
        k = self.spec_k
        n_eff = self.horizon
        # each round may write KV up to spec_k slots past the emitted run,
        # so pad the per-request budgets by spec_k for block reservation
        victims = self.pool.ensure_append_blocks(
            sorted(self.active), horizon=n_eff * (k + 1),
            budgets={rid: b + k for rid, b in budgets.items()})
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
        T = self.pool.blocks_per_seq
        hist = self.pool.hist_dev()
        d_model = self._d_model
        prog = self._program(
            ("spec", self.knobs.variant, self.shards, width, T, k,
             self.draft_name),
            lambda tensors, **kw: G.spec_program(
                self.model, d_model, tensors, width, T, hist.shape[1],
                spec_k=k, max_len=self.max_seq, ngram=self.ngram, **kw),
            lambda eng: (eng.params, eng.pool.cache, eng._d_params,
                         eng.pool.draft_cache))
        b = prog.bufs
        b["tokens"].copy_(self.pool.last_tokens_dev())
        b["positions"].copy_(self.pool.positions())
        b["tables"].copy_(self.pool.tables())
        b["hist"].copy_(hist)
        with sanctioned():
            for name, a in (("active", active_mask), ("budgets", budget_arr),
                            ("eos", eos_arr)):
                b[name].copy_(torch.from_numpy(a))
            G.set_sampling(b, *self._sampling(
                {self.pool.lane_of[rid]: req
                 for rid, req in self.active.items()}))
        toks, em, acc = G.run_spec(prog, n_eff)
        # the launch's single host sync: tokens, flags and accepted counts
        # in one readback
        drained = sanctioned_readback(torch.cat([
            toks.flatten(), em.flatten().to(torch.int32), acc.flatten()]))
        n = toks.numel()
        toks_h = drained[:n].reshape(toks.shape)
        em_h = drained[n:2 * n].reshape(toks.shape).astype(bool)
        acc_h = drained[2 * n:].reshape(acc.shape)
        self.stats.host_syncs += 1
        self.stats.decode_syncs += 1
        self.pool.adopt_device("positions", b["positions"])
        self.pool.adopt_device("last_tokens", b["tokens"])
        self.pool.adopt_device("hist", b["hist"])
        produced = 0
        finished = []
        for rid, req in list(self.active.items()):
            lane = self.pool.lane_of[rid]
            em_l = em_h[:, lane, :]                          # (N, K+1)
            # row-major boolean drain keeps round-then-slot order
            new = [int(t) for t in toks_h[:, lane, :][em_l]]
            cnt = len(new)
            # a verify pass ran for this lane iff its slot 0 emitted
            rounds = int(em_l[:, 0].sum())
            self.stats.verify_passes += rounds
            self.stats.draft_tokens += k * rounds
            self.stats.accepted_tokens += int(
                np.minimum(em_l.sum(axis=1), acc_h[:, lane]).sum())
            if cnt:
                base = int(self.pool.lengths[lane])
                self.pool.token_hist[lane, base + 1: base + 1 + cnt] = new
                req.output.extend(new)
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

    def _decode_slots(self, now: float) -> int:
        """One decode step over every slot (parked slots decode at
        position 0, which the next insert overwrites), through the slot
        step program (captured: one CUDA graph); one host sync."""
        lanes = {rid: self.pool.slot_of[rid] for rid in self.active}
        width = self.pool.n_slots
        tokens = np.zeros(width, np.int32)
        for rid, req in self.active.items():
            tokens[lanes[rid]] = req.output[-1]
        sampled = any(r.temperature > 0 for r in self.active.values())
        prog = self._program(
            ("slot", self.knobs.variant, width, sampled),
            lambda tensors, **kw: G.slot_program(self.model, tensors, width,
                                                 sampled=sampled, **kw))
        with sanctioned():
            prog.bufs["tokens"].copy_(torch.from_numpy(tokens))
            prog.bufs["positions"].copy_(
                torch.tensor(self.pool.lengths, dtype=torch.int32))
            if sampled:
                G.set_sampling(prog.bufs, *self._sampling(
                    {lanes[rid]: req for rid, req in self.active.items()}))
        prog.run()
        nxt = sanctioned_readback(prog.bufs["nxt"])
        self.stats.host_syncs += 1
        self.stats.decode_syncs += 1
        produced = 0
        finished = []
        for rid, req in list(self.active.items()):
            ln = lanes[rid]
            tok = int(nxt[ln])
            req.output.append(tok)
            produced += 1
            # ``>=``: the slot path stops one token before the paged
            # path's ``>`` would, as in the reference
            full = int(self.pool.lengths[ln]) + 1 >= self.max_seq
            if (len(req.output) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id) or full):
                finished.append(rid)
        self.pool.advance(list(lanes.values()))
        for rid in finished:
            self._finish(self.active.pop(rid), now, "accepted")
            self.pool.release(rid)
        self.stats.decode_tokens += produced
        return produced

    def step(self, now: float | None = None) -> int:
        """One scheduler iteration (a no-op while offline): release due
        retries, expire deadlines, run the armed guard scan, admit,
        advance chunked prefills by one chunk, then one decode launch
        (``horizon`` steps in paged mode, ``horizon`` verify rounds with
        speculation on, one step in slot mode).  Returns the number of
        decode tokens produced."""
        t0 = time.perf_counter()
        now = now if now is not None else t0
        if self.offline:
            return 0
        self._release_delayed(now)
        self._expire_deadlines(now)
        self._quarantine_scan(now)
        self._admit(now)
        prefilled = self._prefill_tick(now) \
            if self.paged and self.prefill_chunk else 0
        produced = 0
        if self.active:
            if self._spec_on:
                produced = self._decode_spec(now)
            elif self.paged:
                produced = self._decode_paged(now)
            else:
                produced = self._decode_slots(now)
        if produced or prefilled:
            # simulated frequency knob: a capped clock stretches wall
            # time; a stuck-slow fault stretches it further
            self.stats.record_step((time.perf_counter() - t0)
                                   * self.slow_factor
                                   / max(self.knobs.freq_scale, 1e-3))
        return produced

    def run(self, *, max_steps: int = 10_000) -> EngineStats:
        steps = 0
        while (self.queue or self.active or self.prefilling
               or self._delayed) and steps < max_steps:
            self.step(now=float(steps))
            steps += 1
        return self.stats

    def goodput(self, *, ttft_slo: float, tbt_slo: float) -> float:
        """Tokens/s over completed requests meeting both SLOs (times are in
        scheduler-step units when run() supplies logical `now`)."""
        return self.stats.goodput(ttft_slo=ttft_slo, tbt_slo=tbt_slo)
