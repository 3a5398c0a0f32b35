"""Scenario scripting — composable, validated simulation events
(port of ``repro.core.scenario``).

A ``Scenario`` is an ordered bag of typed events that perturb a simulation
run: infrastructure failures (paper §5.4), extra VM arrivals, endpoint
demand surges, weather/region shifts, and power-price shocks.  Every event validates its fields
at construction — a typo'd ``kind="upss"`` raises immediately instead of
being silently ignored mid-drill — and ``failures.py``, ``oversubscribe.py``
and the benchmarks all script their runs through this one API instead of
hand-rolled tuples.

Events carry an optional ``region`` tag for fleet-scale runs
(``core.fleet.FleetSim``): ``region="eu"`` scopes the event to that region's
cluster, ``region=None`` means fleet-wide (every region) — except for
``VMArrival``, where ``region=None`` inside a fleet scenario means "let the
``FleetPolicy.admit_region`` hook choose the region".  A single-cluster
``ClusterSim`` rejects region-tagged events at construction (the tag would
otherwise be silently ignored); ``Scenario.for_region`` strips the tags
when a fleet hands each region its slice.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.faults import EngineFault, SensorDropout

FAILURE_KINDS = ("ahu", "ups", "cooling", "thermal")
VM_KINDS = ("iaas", "saas")


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
class FailureEvent:
    """Infrastructure failure (paper §5.4, Table 2).

    ``ahu``: one aisle loses 1/N of its AHUs (reduced airflow);
    ``ups``: 4N/3 failover limits every row to 75% power (fleet-wide —
    the redundancy pool is shared, so ``target`` does not apply);
    ``cooling``: DC-level cooling strain (+3 °C inlet, fleet-wide);
    ``thermal``: the §5.4 thermal emergency (AHU loss + cooling strain).
    """
    kind: str          # one of FAILURE_KINDS
    start_h: float
    end_h: float
    target: int = 0    # aisle id (ahu/thermal); must stay 0 for the
    #                    cluster-wide kinds (ups/cooling)
    region: str | None = None   # fleet runs: scope to one region

    def __post_init__(self):
        if self.kind not in FAILURE_KINDS:
            raise ValueError(
                f"unknown failure kind {self.kind!r}; expected one of "
                f"{FAILURE_KINDS}")
        _check_window(self.start_h, self.end_h)
        _check_region(self.region)
        if self.target < 0:
            raise ValueError(f"failure target must be >= 0, got {self.target}")
        if self.kind in ("ups", "cooling") and self.target != 0:
            raise ValueError(
                f"{self.kind} failures are cluster-wide; target={self.target} "
                f"would be silently ignored — leave it at 0")

    def active(self, now_h: float) -> bool:
        return self.start_h <= now_h < self.end_h


@dataclass(frozen=True)
class DemandSurge:
    """Multiply one endpoint's (or every endpoint's) demand for a window."""
    start_h: float
    end_h: float
    scale: float              # multiplier on routed demand (> 0)
    endpoint: str | None = None   # None == every endpoint
    region: str | None = None     # fleet runs: scope to one region

    def __post_init__(self):
        _check_window(self.start_h, self.end_h)
        _check_region(self.region)
        if self.scale <= 0.0:
            raise ValueError(f"surge scale must be > 0, got {self.scale}")

    def active(self, now_h: float) -> bool:
        return self.start_h <= now_h < self.end_h


@dataclass(frozen=True)
class WeatherShift:
    """Add ``delta_c`` °C to the outside temperature for a window (heat
    wave / cold snap / a geo-region swap approximated as an offset)."""
    start_h: float
    end_h: float
    delta_c: float
    region: str | None = None     # fleet runs: scope to one region

    def __post_init__(self):
        _check_window(self.start_h, self.end_h)
        _check_region(self.region)

    def active(self, now_h: float) -> bool:
        return self.start_h <= now_h < self.end_h


@dataclass(frozen=True)
class VMArrival:
    """Script an extra VM arrival on top of the generated workload.

    SaaS arrivals name an endpoint (created if new); IaaS arrivals name a
    customer template.
    """
    arrival_h: float
    kind: str                 # "iaas" | "saas"
    customer: str             # endpoint name (saas) / customer template
    lifetime_h: float
    peak_util: float = 1.0
    region: str | None = None   # fleet runs: pin to a region; None lets
    #                             FleetPolicy.admit_region choose

    def __post_init__(self):
        if self.kind not in VM_KINDS:
            raise ValueError(
                f"unknown VM kind {self.kind!r}; expected one of {VM_KINDS}")
        if self.arrival_h < 0.0:
            raise ValueError(f"arrival_h must be >= 0, got {self.arrival_h}")
        if self.lifetime_h <= 0.0:
            raise ValueError(
                f"lifetime_h must be > 0, got {self.lifetime_h}")
        if not 0.0 < self.peak_util <= 1.0:
            raise ValueError(
                f"peak_util must be in (0, 1], got {self.peak_util}")


@dataclass(frozen=True)
class PriceShock:
    """Multiply a region's effective power price for a window.

    A spot-market spike, a demand-response curtailment price, or a grid
    event folded into $/kWh.  Price is fleet-level economics — the event
    is consumed by ``FleetSim`` (steering/accounting), never by a region's
    ``ClusterSim`` (clusters have no price concept), so ``for_region``
    filters it out of the per-region scenario slices.
    """
    start_h: float
    end_h: float
    scale: float                  # multiplier on power_price_scale (> 0)
    region: str | None = None     # None == every region

    def __post_init__(self):
        _check_window(self.start_h, self.end_h)
        _check_region(self.region)
        if self.scale <= 0.0:
            raise ValueError(
                f"price shock scale must be > 0, got {self.scale}")

    def active(self, now_h: float) -> bool:
        return self.start_h <= now_h < self.end_h


_EVENT_TYPES = (FailureEvent, DemandSurge, WeatherShift, VMArrival,
                PriceShock, EngineFault, SensorDropout)


@dataclass(frozen=True)
class Scenario:
    """A validated, composable set of simulation events.

    Construction rejects anything that is not a known event type; each
    event validated its own fields already.  Accessors answer the per-tick
    questions the simulator asks, so policy code never pattern-matches on
    raw tuples.
    """
    events: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            if not isinstance(ev, _EVENT_TYPES):
                raise TypeError(
                    f"unknown scenario event {ev!r}; expected one of "
                    f"{[t.__name__ for t in _EVENT_TYPES]}")

    # -- per-tick accessors ------------------------------------------------
    def failures(self, now_h: float) -> list:
        """Failure events active at ``now_h``."""
        return [ev for ev in self.events
                if isinstance(ev, FailureEvent) and ev.active(now_h)]

    def demand_scale(self, now_h: float, endpoint: str) -> float:
        """Combined demand multiplier for ``endpoint`` at ``now_h``."""
        scale = 1.0
        for ev in self.events:
            if (isinstance(ev, DemandSurge) and ev.active(now_h)
                    and ev.endpoint in (None, endpoint)):
                scale *= ev.scale
        return scale

    def weather_delta(self, now_h: float) -> float:
        """Outside-temperature offset (°C) at ``now_h``."""
        return sum(ev.delta_c for ev in self.events
                   if isinstance(ev, WeatherShift) and ev.active(now_h))

    def vm_arrivals(self) -> list:
        return [ev for ev in self.events if isinstance(ev, VMArrival)]

    def engine_faults(self, now_h: float) -> list:
        """Engine faults (``core.faults.EngineFault``) active at ``now_h``."""
        return [ev for ev in self.events
                if isinstance(ev, EngineFault) and ev.active(now_h)]

    def sensor_dropout(self, now_h: float) -> bool:
        """True while any ``SensorDropout`` window covers ``now_h``."""
        return any(isinstance(ev, SensorDropout) and ev.active(now_h)
                   for ev in self.events)

    def price_scale(self, now_h: float, region: str | None = None) -> float:
        """Combined power-price multiplier for ``region`` at ``now_h``
        (untagged shocks hit every region)."""
        scale = 1.0
        for ev in self.events:
            if (isinstance(ev, PriceShock) and ev.active(now_h)
                    and ev.region in (None, region)):
                scale *= ev.scale
        return scale

    # -- fleet accessors ---------------------------------------------------
    def regions_named(self) -> set:
        """Every region name any event is scoped to (for validation)."""
        return {ev.region for ev in self.events if ev.region is not None}

    def for_region(self, name: str) -> "Scenario":
        """The slice of this fleet scenario one region's cluster replays.

        Keeps events scoped to ``name`` and untagged fleet-wide events,
        with the region tag stripped (``ClusterSim`` rejects tagged
        events) — except untagged ``VMArrival``s, which belong to the
        fleet admission path (``FleetPolicy.admit_region``), not to any
        one region's workload.
        """
        out = []
        for ev in self.events:
            if isinstance(ev, VMArrival) and ev.region is None:
                continue
            if isinstance(ev, PriceShock):
                continue          # fleet-level economics, never a cluster's
            if ev.region in (None, name):
                out.append(replace(ev, region=None))
        return Scenario(tuple(out))

    def fleet_arrivals(self) -> list:
        """Untagged VM arrivals a fleet admits via ``admit_region``."""
        return [ev for ev in self.events
                if isinstance(ev, VMArrival) and ev.region is None]

    def __add__(self, other: "Scenario") -> "Scenario":
        return Scenario(self.events + tuple(other.events))


def as_scenario(scenario: Scenario | None, failures: tuple = ()) -> Scenario:
    """Normalize the two SimConfig channels (typed ``scenario`` plus the
    legacy ``failures`` tuple) into one validated Scenario."""
    base = scenario if scenario is not None else Scenario()
    if failures:
        base = base + Scenario(tuple(failures))
    return base
