"""Fault injection + graceful degradation: the failure model under TAPAS
(port of ``repro.core.faults``).

The paper's headline claim is *emergency handling* — cooling and power
failures absorbed by exploiting SaaS adaptability — but emergencies in a
real fleet are rarely just thermal: serving processes crash, accelerators
emit NaNs, KV memory corrupts, and the telemetry the control plane steers
on goes stale exactly when it matters.  This module defines the
deterministic, seeded fault model the serving tier is hardened against:

* ``EngineFault`` — a windowed fault targeting one bound engine backend
  (or all of them): process crash/restart, NaN-logit burst, KV-block
  corruption, a stuck-slow lane, or a drafter failure.
* ``SensorDropout`` — a window during which the cluster's derived
  telemetry (inlet estimate, risk, thermal ceilings) freezes at its
  last-known-good reading; ``ClusterState.telemetry_age_ticks`` counts
  how stale the frozen snapshot is so policies steer conservatively
  instead of trusting a lying sensor.
* ``ResilienceKnobs`` — the recovery machinery's switches (watchdog,
  re-queue-on-crash, NaN guard, degradation ladder, stale-risk bump).
  ``recovery_off()`` disables all of it — the ablation arm of the
  fault-storm drill (``benchmarks/bench_resilience.py``).
* ``DegradationLadder`` — the SaaS-flexibility story made explicit: under
  an emergency the reconfigure phase walks an engine down the ladder
  (drop drafter -> shrink horizon -> force quantized variant -> cap
  max_batch) one rung per tick, and unwinds it rung by rung once the
  emergency clears and stays clear.

Both event types validate at construction and slot into ``Scenario``
exactly like the existing events (region tags, ``for_region`` slicing).
Every random-looking choice (which request a NaN burst hits) derives from
``traces._stable_seed``, so a fault timeline replays bit-identically for
a given seed + scenario — the property the replay-determinism tests pin.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.traces import _stable_seed

ENGINE_FAULT_KINDS = ("crash", "nan_burst", "kv_corrupt", "stuck_slow",
                      "draft_fail")

#: Request terminal outcomes ("accepted" covers every normally-served
#: completion, including budget/eos finishes).  Mutually exclusive and
#: exhaustive: a request that ends any other way was *lost*, which the
#: resilience bench treats as a hard failure.
REQUEST_OUTCOMES = ("accepted", "timed_out", "rejected")


def _check_window(start_h: float, end_h: float) -> None:
    if start_h < 0.0:
        raise ValueError(f"event start_h must be >= 0, got {start_h}")
    if end_h <= start_h:
        raise ValueError(
            f"event window is empty or inverted: [{start_h}, {end_h})")


def _check_region(region) -> None:
    if region is not None and (not isinstance(region, str) or not region):
        raise ValueError(
            f"event region must be None or a non-empty region name, "
            f"got {region!r}")


@dataclass(frozen=True)
class EngineFault:
    """A windowed fault on bound serving engines.

    ``crash``: the engine process dies for the window (restarts at
    ``end_h``); with recovery on, the watchdog drains its unfinished
    requests onto healthy siblings, with recovery off the in-flight and
    queued work is silently dropped (the loss the audit catches).
    ``nan_burst``: one active request's freshest KV block goes NaN (a
    transient bad logit source); ``kv_corrupt``: one active request's
    oldest KV block goes NaN (cold memory corruption).  Both are caught
    by the engine's NaN guard, which quarantines the lane and re-queues
    the request on the recompute path.  ``stuck_slow``: the engine's
    step clock runs ``slow_factor`` slower for the window (a degraded
    but live replica).  ``draft_fail``: the speculative drafter breaks
    and is dropped for the window (plain decode continues).
    """
    kind: str              # one of ENGINE_FAULT_KINDS
    start_h: float
    end_h: float
    server: int | None = None     # target server id; None hits every
    #                               bound backend
    slow_factor: float = 4.0      # stuck_slow: step-time multiplier
    region: str | None = None     # fleet runs: scope to one region

    def __post_init__(self):
        if self.kind not in ENGINE_FAULT_KINDS:
            raise ValueError(
                f"unknown engine-fault kind {self.kind!r}; expected one of "
                f"{ENGINE_FAULT_KINDS}")
        _check_window(self.start_h, self.end_h)
        _check_region(self.region)
        if self.server is not None and self.server < 0:
            raise ValueError(
                f"fault server must be None or >= 0, got {self.server}")
        if self.slow_factor < 1.0:
            raise ValueError(
                f"slow_factor must be >= 1 (a *slow* lane), "
                f"got {self.slow_factor}")

    def active(self, now_h: float) -> bool:
        return self.start_h <= now_h < self.end_h


@dataclass(frozen=True)
class SensorDropout:
    """Telemetry staleness window: derived sensor readings (inlet
    estimate, risk, thermal ceilings) freeze at their last-known-good
    snapshot while the physics keeps moving underneath."""
    start_h: float
    end_h: float
    region: str | None = None     # fleet runs: scope to one region

    def __post_init__(self):
        _check_window(self.start_h, self.end_h)
        _check_region(self.region)

    def active(self, now_h: float) -> bool:
        return self.start_h <= now_h < self.end_h


def fault_pick(n: int, *parts) -> int:
    """Deterministic index in ``[0, n)`` for fault targeting.

    crc32-folded (the ``trace_seed`` idiom), so which request a NaN burst
    lands on is a pure function of (seed, kind, tick, ...) — never of
    process hash randomization or dict order."""
    if n <= 0:
        raise ValueError(f"fault_pick needs n >= 1, got {n}")
    return _stable_seed("fault", *parts) % n


@dataclass(frozen=True)
class ResilienceKnobs:
    """Switches for the recovery machinery (``SimConfig.resilience``)."""

    #: heartbeat watchdog: drain an unresponsive backend's unfinished
    #: requests onto healthy siblings, restore on recovery.
    watchdog: bool = True
    #: consecutive missed heartbeats before the watchdog declares a
    #: backend unhealthy and drains it.
    heartbeat_misses: int = 1
    #: a crashing engine re-queues its in-flight work for recompute
    #: (False: the crash drops it — the silent-loss failure mode).
    requeue_on_crash: bool = True
    #: NaN/Inf KV guard: scan armed lanes before decode, quarantine and
    #: retry corrupted requests instead of emitting garbage tokens.
    nan_guard: bool = True
    #: walk attached ``DegradationLadder``s under emergencies.
    ladder: bool = True
    #: risk added per tick of telemetry staleness under ``SensorDropout``
    #: (0.0 trusts the frozen reading verbatim).
    stale_risk_bump: float = 0.02

    def __post_init__(self):
        if self.heartbeat_misses < 1:
            raise ValueError(
                f"heartbeat_misses must be >= 1, got {self.heartbeat_misses}")
        if self.stale_risk_bump < 0.0:
            raise ValueError(
                f"stale_risk_bump must be >= 0, got {self.stale_risk_bump}")


def recovery_off() -> ResilienceKnobs:
    """The ablation preset: every recovery mechanism disabled.  Faults
    still fire — crashes drop work, stale telemetry is trusted verbatim —
    which is exactly the arm the fault-storm drill compares against."""
    return ResilienceKnobs(watchdog=False, requeue_on_crash=False,
                           nan_guard=False, ladder=False,
                           stale_risk_bump=0.0)


#: ladder rungs in walk order; ``quantized_variant`` is skipped when the
#: ladder has no quantized variant configured.
LADDER_RUNGS = ("drop_drafter", "shrink_horizon", "quantized_variant",
                "cap_batch")


class DegradationLadder:
    """Graceful-degradation ladder for one ``EngineBackend``.

    Each emergency tick steps one rung *down* (cheaper serving, lower
    quality); each ``calm_ticks``-long quiet stretch steps one rung back
    *up*, restoring the exact pre-emergency knob values.  Rungs, in
    order: drop the speculative drafter, halve the fused decode horizon,
    force the quantized model variant, halve ``max_batch``.

    The ladder is attached per backend (``EngineBackend(ladder=...)``)
    and walked by the simulator's reconfigure phase *after* the tick's
    ``ConfigPoint`` landed, so ladder caps win over the configurator's
    knob turns for the tick; unwinding restores the saved pre-ladder
    values and the next reconfigure re-asserts its own view.
    """

    def __init__(self, *, quantized_variant: str | None = None,
                 calm_ticks: int = 2, min_horizon: int = 1,
                 min_batch: int = 1):
        if calm_ticks < 1:
            raise ValueError(f"calm_ticks must be >= 1, got {calm_ticks}")
        self.quantized_variant = quantized_variant
        self.calm_ticks = calm_ticks
        self.min_horizon = min_horizon
        self.min_batch = min_batch
        self.level = 0            # rungs currently applied
        self.walks = 0            # total step-downs over the run
        self.skipped_rungs = 0    # quantized swaps refused by the engine
        #                           (variant indivisible at the current
        #                           shard degree — reject, don't crash)
        self._calm = 0
        self._saved: dict[str, object] = {}

    def rungs(self) -> list:
        return [r for r in LADDER_RUNGS
                if r != "quantized_variant" or self.quantized_variant]

    def tick(self, backend, emergency: bool) -> None:
        """One reconfigure-phase walk: down a rung under an emergency,
        up a rung after ``calm_ticks`` consecutive quiet ticks."""
        rungs = self.rungs()
        if emergency:
            self._calm = 0
            if self.level < len(rungs):
                self._apply(backend, rungs[self.level])
                self.level += 1
                self.walks += 1
        elif self.level > 0:
            self._calm += 1
            if self._calm >= self.calm_ticks:
                self._calm = 0
                self.level -= 1
                self._unwind(backend, rungs[self.level])
        self._enforce(backend)

    def _apply(self, backend, rung: str) -> None:
        eng = backend.engine
        if rung == "drop_drafter":
            self._saved["drafter"] = eng.draft_name
            if eng.draft_name is not None:
                eng.set_drafter(None)
        elif rung == "shrink_horizon":
            self._saved["horizon"] = eng.horizon
            eng.horizon = max(self.min_horizon, eng.horizon // 2)
        elif rung == "quantized_variant":
            ok = getattr(eng, "variant_compatible", None)
            if ok is not None and not ok(self.quantized_variant):
                # the variant's head count does not divide the engine's
                # shard degree: skip the rung, keep walking the ladder
                self.skipped_rungs += 1
                return
            self._saved["variant"] = eng.knobs.variant
            if eng.knobs.variant != self.quantized_variant:
                eng.set_variant(self.quantized_variant)
        elif rung == "cap_batch":
            self._saved["max_batch"] = eng.knobs.max_batch
            eng.knobs.max_batch = max(self.min_batch,
                                      eng.knobs.max_batch // 2)

    def _unwind(self, backend, rung: str) -> None:
        eng = backend.engine
        if rung == "drop_drafter":
            drafter = self._saved.pop("drafter", None)
            if drafter is not None:
                eng.set_drafter(drafter)
        elif rung == "shrink_horizon":
            eng.horizon = self._saved.pop("horizon", eng.horizon)
        elif rung == "quantized_variant":
            variant = self._saved.pop("variant", None)
            if variant is not None and variant != eng.knobs.variant:
                eng.set_variant(variant)
        elif rung == "cap_batch":
            eng.knobs.max_batch = self._saved.pop("max_batch",
                                                  eng.knobs.max_batch)

    def _enforce(self, backend) -> None:
        """Re-assert active caps: a reconfigure that landed this tick may
        have raised ``max_batch`` past the rung's cap."""
        rungs = self.rungs()[: self.level]
        eng = backend.engine
        if "cap_batch" in rungs:
            cap = max(self.min_batch, self._saved["max_batch"] // 2)
            eng.knobs.max_batch = min(eng.knobs.max_batch, cap)


def audit_requests(requests) -> dict:
    """Zero-silent-loss audit over a request population.

    Every request must end in exactly one terminal outcome
    (``REQUEST_OUTCOMES``); a ``None`` outcome after a drained run means
    the request *vanished* — the failure mode recovery must prevent.
    Returns outcome counts, the lost req_ids, and accepted-token goodput.
    """
    counts = dict.fromkeys(REQUEST_OUTCOMES, 0)
    lost = []
    accepted_tokens = 0
    for r in requests:
        if r.outcome is None:
            lost.append(r.req_id)
            continue
        counts[r.outcome] += 1
        if r.outcome == "accepted":
            accepted_tokens += len(r.output)
    return {"outcomes": counts, "lost": sorted(lost),
            "accepted_tokens": accepted_tokens, "total": len(requests)}
