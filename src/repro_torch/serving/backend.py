"""Engine-in-the-loop backend: a real serving Engine as a simulated SaaS
server (port of ``repro.serving.backend``).

``EngineBackend`` binds one ``serving.Engine`` (with its ``EngineKnobs``)
to a server inside ``ClusterSim``.  Each tick the simulator

* mirrors the control plane's ``reconfigure()`` decisions onto the engine —
  a ``ConfigPoint`` becomes ``set_variant`` / ``max_batch`` / ``freq_scale``
  (plus ``paused`` while a reload drains), and
* pumps the engine with requests proportional to the load the router
  assigned to that server, then reports the engine's *measured* goodput
  back into ``ClusterState.measured_goodput``.

This closes the loop that ``profiles.measure_from_engine()`` opened: that
feeds engine measurements into the profile tables offline; here the
engine runs live inside the simulated datacenter and the control plane's
decisions land on actual serving knobs.  ``measured_goodput`` is
wall-clock (tokens over the engine's step time, stretched by the
simulated ``freq_scale``), so it is telemetry only; ``freq_scale`` never
sets the card's clocks.

The backend is telemetry-only with respect to the physics: attaching
engines never changes the simulated thermal/power trajectory, so
simulation results stay reproducible with or without live engines.

Backends work unchanged inside a fleet: ``FleetSim.attach_backend(region,
server, backend)`` binds the engine to one region's cluster, and the
region's own reconfigure decisions keep landing on the engine's knobs
(the fleet layer only redirects demand).  If a fleet migration evicts the
bound server, the backend idles — ``pump`` receives zero load until the
server hosts SaaS again — rather than erroring; rebind to the VM's new
region to follow it across the WAN.
"""
from __future__ import annotations

import weakref

import numpy as np

from repro_torch.core.faults import fault_pick
from repro_torch.core.profiles import ConfigPoint
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request


class EngineBackend:
    """Binds a real ``Engine`` to a simulated SaaS server.

    ``variant_for_size`` maps profile model sizes ("70b"/"13b"/"7b") onto
    engine variant names registered via ``Engine.add_variant``; sizes
    without a mapping leave the variant untouched.  ``batch_for_knob``
    maps the profile's batch axis onto engine ``max_batch`` values
    (default: 1 -> 1, 16 -> half the lanes, 64 -> all lanes).
    """

    #: set on FleetBackend instances; the simulator flushes each distinct
    #: fleet once per tick after every attached backend has pumped
    fleet = None

    def __init__(self, engine: Engine, *,
                 variant_for_size: dict | None = None,
                 batch_for_knob: dict | None = None,
                 requests_per_load: float = 3.0,
                 steps_per_tick: int = 4,
                 prompt_len: int = 6, max_new_tokens: int = 4,
                 seed: int = 0, draft_min_freq: float | None = None,
                 ladder=None, deadline_ms: float | None = None,
                 max_retries: int = 3,
                 shards_for_tp: dict | None = None):
        n = engine.n_slots
        self.engine = engine
        self.variant_for_size = variant_for_size or {}
        unknown = sorted(set(self.variant_for_size.values())
                         - set(engine.variants))
        if unknown:
            raise ValueError(
                f"variant_for_size names variants {unknown} not registered "
                f"on the engine (has {sorted(engine.variants)}); a typo "
                f"here would silently disable model swaps")
        self.batch_for_knob = batch_for_knob or {1: 1, 16: max(1, n // 2),
                                                 64: n}
        # parallelism as a reconfigure axis: map the profile's tp degree
        # onto engine shard counts (``Engine.set_shards``); unmapped tp
        # values leave the shard degree untouched, and a mapping the
        # engine rejects (``can_shard``) is counted, not crashed on
        self.shards_for_tp = shards_for_tp or {}
        self.shard_rejects = 0
        self.requests_per_load = requests_per_load
        self.steps_per_tick = steps_per_tick
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.rng = np.random.default_rng(seed)
        self._next_id = 0
        self._last_rate = 0.0
        self.applied: list[ConfigPoint] = []   # reconfigure decisions seen
        # speculation as a reconfigure axis: under a deep frequency cap
        # the drafter's extra passes stop paying for themselves, so the
        # control plane drops it (like quantization) and restores it when
        # the cap lifts.  None disables the rule.
        self.draft_min_freq = draft_min_freq
        self._stashed_draft: str | None = None
        self.draft_drops = 0
        # resilience: the fault lane (apply_faults) + degradation ladder
        # (tick_ladder), both driven by the simulator's reconfigure phase;
        # `issued` is the zero-silent-loss ledger — every request this
        # backend ever created, audited with faults.audit_requests after
        # a drained run
        self.seed = seed
        self.ladder = ladder          # core.faults.DegradationLadder | None
        self.deadline_ms = deadline_ms   # stamped onto pumped requests
        self.max_retries = max_retries
        self.issued: list[Request] = []
        self.dropped: list[Request] = []   # lost to drop-mode crashes
        self._fault_down = False      # inside a crash window right now
        self._fault_stashed_draft: str | None = None

    # -- control-plane side ------------------------------------------------
    def apply_config(self, cfg: ConfigPoint, *, paused: bool = False) -> None:
        """Translate a configurator decision into engine knob turns."""
        knobs = self.engine.knobs
        knobs.freq_scale = float(cfg.freq)
        knobs.max_batch = int(self.batch_for_knob.get(
            cfg.batch, self.engine.n_slots))
        knobs.paused = bool(paused)
        variant = self.variant_for_size.get(cfg.size)
        if variant is not None and variant != knobs.variant:
            self.engine.set_variant(variant)
        shards = self.shards_for_tp.get(cfg.tp)
        if shards is not None and shards != self.engine.shards:
            if self.engine.can_shard(shards) is None:
                self.engine.set_shards(shards)
            else:
                self.shard_rejects += 1
        if self.draft_min_freq is not None:
            if cfg.freq < self.draft_min_freq:
                if self.engine.draft_name is not None:
                    self._stashed_draft = self.engine.draft_name
                    self.engine.set_drafter(None)
                    self.draft_drops += 1
            elif self._stashed_draft is not None \
                    and self.engine.draft_name is None:
                self.engine.set_drafter(self._stashed_draft)
                self._stashed_draft = None
        self.applied.append(cfg)

    # -- workload side -----------------------------------------------------
    def pump(self, *, now: float, load: float) -> int:
        """Feed demand proportional to the routed ``load`` (nominal-VM
        units) and run scheduler steps; returns decode tokens produced.

        ``now`` is the simulator clock in hours; the engine clock runs in
        simulated seconds (``now * 3600``) so per-request ``deadline_ms``
        has its natural unit.  Nothing consumes the absolute timestamps
        except deadline eviction, and ``measured_goodput`` stays
        wall-clock based, so the conversion is behavior-neutral for
        engines without deadlines.

        Also measures this tick's decode rate (tokens per wall-second of
        engine stepping, with the simulated frequency knob already folded
        into the step times) so ``measured_goodput`` reflects the engine's
        *current* capacity, not a lifetime average."""
        now_s = now * 3600.0
        vocab = self.engine.model.cfg.vocab_size
        for _ in range(int(round(load * self.requests_per_load))):
            # fresh construction, not a copy of an existing Request — the
            # backend attrs just share the field names
            req = Request(  # tapaslint: disable=TL004
                prompt=[int(t) for t in self.rng.integers(
                    0, vocab, self.prompt_len)],
                max_new_tokens=self.max_new_tokens,
                customer=f"bk{self._next_id % 4}", arrival_s=now_s,
                deadline_ms=self.deadline_ms,
                max_retries=self.max_retries)
            self.issued.append(req)
            self.engine.submit(req)
            self._next_id += 1
        wall_before = self.engine.stats.step_time_total
        produced = 0
        for _ in range(self.steps_per_tick):
            if self.engine.offline:
                break   # crashed: nothing steps until restore()
            if self.engine.knobs.paused and not self.engine.active:
                break   # drained during a reload pause
            produced += self.engine.step(now=now_s)
        wall = self.engine.stats.step_time_total - wall_before
        # no steps ran (paused-and-drained, crashed, or idle) => the
        # instance is serving nothing right now; report that, not the
        # last busy rate
        self._last_rate = produced / wall if wall > 0.0 else 0.0
        return produced

    def measured_goodput(self) -> float:
        """Decode tokens per wall-second over the most recent ``pump``
        window — responds immediately to knob turns (batch/variant change
        tokens-per-step, ``freq_scale`` stretches the step times)."""
        return self._last_rate

    # -- resilience side ---------------------------------------------------
    def apply_faults(self, faults: list, *, now_h: float, tick: int,
                     knobs) -> None:
        """Land this tick's active ``EngineFault`` windows on the engine.

        Crash windows are edge-triggered (one crash() per window, one
        restore() when it closes); stuck-slow and drafter failures are
        level-triggered; KV corruption picks one active request per tick
        via ``fault_pick`` so the injection timeline is a pure function
        of (seed, kind, tick) — replay-stable.  ``knobs`` is the run's
        ``ResilienceKnobs``: with recovery off, crashes drop work instead
        of re-queueing it and corruption goes unguarded."""
        eng = self.engine
        kinds = {f.kind for f in faults}
        now_s = now_h * 3600.0
        if "crash" in kinds and not self._fault_down:
            self._fault_down = True
            self.dropped.extend(
                eng.crash(now_s, drop=not knobs.requeue_on_crash))
        elif "crash" not in kinds and self._fault_down:
            self._fault_down = False
            eng.restore()
        slow = [f.slow_factor for f in faults if f.kind == "stuck_slow"]
        eng.slow_factor = max(slow) if slow else 1.0
        if "draft_fail" in kinds:
            if eng.draft_name is not None:
                self._fault_stashed_draft = eng.draft_name
                eng.set_drafter(None)
        elif self._fault_stashed_draft is not None \
                and eng.draft_name is None:
            eng.set_drafter(self._fault_stashed_draft)
            self._fault_stashed_draft = None
        for kind in ("nan_burst", "kv_corrupt"):
            if kind in kinds and eng.active and not eng.offline:
                rids = sorted(eng.active)
                rid = rids[fault_pick(len(rids), kind, tick, self.seed)]
                eng.inject_kv_corruption(rid,
                                         last_block=(kind == "nan_burst"),
                                         arm_guard=knobs.nan_guard)

    def tick_ladder(self, emergency: bool) -> None:
        """Walk the attached degradation ladder one rung (down under an
        emergency, up after a calm stretch); no-op without a ladder or
        while the engine is down."""
        if self.ladder is not None and not self.engine.offline:
            self.ladder.tick(self, emergency)

    def heartbeat(self) -> bool:
        """Liveness probe for the simulator's watchdog."""
        return self.engine.heartbeat()

    def adopt(self, reqs: list) -> None:
        """Accept requests drained off an unhealthy sibling (watchdog
        re-homing).  They keep their identity — the origin backend's
        ``issued`` ledger still audits them."""
        for req in reqs:
            self.engine.submit(req)

    def drain(self, *, now_h: float, max_steps: int = 200) -> int:
        """Run the engine dry after the sim's last tick, advancing the
        clock one simulated second per step so backoff-delayed retries
        release (and overdue deadlines expire).  A backend still inside
        a crash window is restored first — the run is over; what matters
        is that no re-queued request is left in limbo."""
        return _drain(self.engine, now_h=now_h, max_steps=max_steps)


def _drain(eng: Engine, *, now_h: float, max_steps: int) -> int:
    """``EngineBackend.drain`` for one engine."""
    if eng.offline:
        eng.restore()
    now_s = now_h * 3600.0
    produced = 0
    for _ in range(max_steps):
        if not (eng.queue or eng.active or eng.prefilling or eng._delayed):
            break
        produced += eng.step(now=now_s)
        now_s += 1.0
    return produced


# ---------------------------------------------------------------------------
# fleet of engines: many simulated servers, few real engines
# ---------------------------------------------------------------------------

class EngineFleet:
    """A small pool of real engines backing 100+ simulated SaaS servers.

    All engines are built from ONE ``EngineSpec`` and share one copy of
    the model params (``EngineSpec.build(share=first)`` aliases the
    parameter tensors), so the weight footprint is per *fleet*, not per
    simulated server.  Simulated servers attach via
    ``make_backend()``, which round-robins them across the engines.

    The pump is batched: each simulator tick every ``FleetBackend`` only
    *submits* its server's demand (``pump``), and one ``flush()`` per
    fleet then runs each engine's scheduler steps once for all of its
    servers together — one process backs a whole region's SaaS tier on
    measured goodput instead of stepping one engine per server.
    """

    def __init__(self, spec, *, n_engines: int = 2, steps_per_tick: int = 4,
                 backend_kw: dict | None = None, share=None, device="cuda"):
        if n_engines < 1:
            raise ValueError(f"n_engines must be >= 1, got {n_engines}")
        self.spec = spec
        first = spec.build(device=device, share=share)
        self.engines = [first] + [spec.build(share=first)
                                  for _ in range(n_engines - 1)]
        self.steps_per_tick = steps_per_tick
        self.backend_kw = dict(backend_kw or {})
        # each backend holds its fleet (the simulator flushes it through
        # them), so the fleet holds its backends weakly: a strong list
        # would close a cycle that keeps a dropped fleet's engines, pools
        # and CUDA graphs on the card until the cyclic collector ran
        self._backends: list[weakref.ref] = []
        self._made = 0
        self.flushes = 0

    @property
    def backends(self) -> list["FleetBackend"]:
        """The fleet's live backends, in the order they were made."""
        return [bk for bk in (r() for r in self._backends) if bk is not None]

    def make_backend(self, **kw) -> "FleetBackend":
        """A backend for one more simulated server, assigned round-robin
        to the fleet's engines."""
        i = self._made
        self._made += 1
        merged = {**self.backend_kw, **kw}
        merged.setdefault("seed", i)
        bk = FleetBackend(self.engines[i % len(self.engines)],
                          fleet=self, index=i, **merged)
        self._backends.append(weakref.ref(bk))
        return bk

    def flush(self, *, now: float) -> int:
        """Run each engine's scheduler steps for this tick and settle the
        per-server measured rates.  The simulator calls this once per
        distinct fleet after every attached backend pumped."""
        self.flushes += 1
        now_s = now * 3600.0
        produced_total = 0
        backends = self.backends
        for eng in self.engines:
            wall_before = eng.stats.step_time_total
            produced = 0
            for _ in range(self.steps_per_tick):
                if eng.offline:
                    break   # crashed: nothing steps until restore()
                if eng.knobs.paused and not eng.active:
                    break   # drained during a reload pause
                produced += eng.step(now=now_s)
            wall = eng.stats.step_time_total - wall_before
            produced_total += produced
            for bk in backends:
                if bk.engine is eng:
                    bk._settle(wall)
        return produced_total

    def drain(self, *, now_h: float, max_steps: int = 200) -> int:
        """Run every engine dry after the last tick."""
        return sum(_drain(eng, now_h=now_h, max_steps=max_steps)
                   for eng in self.engines)


class FleetBackend(EngineBackend):
    """An ``EngineBackend`` whose engine is shared with other simulated
    servers through an ``EngineFleet``.

    ``pump`` only submits this server's demand (requests tagged with the
    server's fleet index); the engine steps run once per tick for all
    servers in ``EngineFleet.flush``, which settles each server's
    measured goodput from its own requests' output-token delta over the
    engine's step wall-clock."""

    def __init__(self, engine: Engine, *, fleet: EngineFleet, index: int,
                 **kw):
        super().__init__(engine, **kw)
        self.fleet = fleet
        self.index = index
        self._out_cursor = 0      # output tokens already credited

    def pump(self, *, now: float, load: float) -> int:
        now_s = now * 3600.0
        vocab = self.engine.model.cfg.vocab_size
        for _ in range(int(round(load * self.requests_per_load))):
            # fresh construction, not a copy of an existing Request — the
            # backend attrs just share the field names
            req = Request(  # tapaslint: disable=TL004
                prompt=[int(t) for t in self.rng.integers(
                    0, vocab, self.prompt_len)],
                max_new_tokens=self.max_new_tokens,
                customer=f"srv{self.index}", arrival_s=now_s,
                deadline_ms=self.deadline_ms,
                max_retries=self.max_retries)
            self.issued.append(req)
            self.engine.submit(req)
            self._next_id += 1
        return 0    # tokens are produced (and counted) at flush time

    def _settle(self, wall: float) -> None:
        """Credit this tick's output-token delta against the engine's
        step wall-clock for the tick (shared across the engine's
        servers)."""
        total = sum(len(r.output) for r in self.issued)
        produced = total - self._out_cursor
        self._out_cursor = total
        self._last_rate = produced / wall if wall > 0.0 else 0.0

    def drain(self, *, now_h: float, max_steps: int = 200) -> int:
        produced = super().drain(now_h=now_h, max_steps=max_steps)
        # fold the drained tokens into this server's cursor so a later
        # audit of `issued` matches what was credited
        self._out_cursor = sum(len(r.output) for r in self.issued)
        return produced
