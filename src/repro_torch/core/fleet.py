"""Fleet control plane: a global router over per-region ``ClusterSim``s
(port of ``repro.core.fleet``).

TAPAS manages thermal/power headroom *inside* one cluster; clouds operate
fleets of regions whose cooling headroom diverges with the weather and
whose failures are regional.  This module grows the control-plane API
(``core.state``) one level up:

* ``RegionSpec`` — one region's identity: datacenter topology/climate
  (``DCConfig``), WAN RTT to the fleet's front door, power price, a
  scripted ``WeatherShift`` schedule, and the trace-seed namespace that
  keeps two identically-configured regions from replaying identical
  weather/customer noise.
* ``FleetState`` — the per-tick fleet snapshot: every region's typed
  ``ClusterState`` plus the lifted per-region telemetry a global policy
  reasons about (``region_risk`` scores, SaaS capacity/headroom, natural
  per-endpoint demand, inter-region RTTs).
* ``FleetPolicy`` — the protocol a global controller implements:
  ``admit_region`` (place a new VM across regions), ``route_region``
  (steer SaaS demand cross-region, paying a WAN-latency goodput penalty),
  and ``rebalance`` (drain/migrate VMs when a region loses cooling or
  power).
* ``FleetSim`` — owns N step-wise ``ClusterSim`` instances and drives
  them through the ``observe``/``route``/``finish_tick`` seam.  The
  physics is never forked: each region runs the exact single-cluster code
  path, the fleet only substitutes the demand figures ``route`` would
  have computed locally.  A single-region fleet under the identity policy
  is bit-identical to a standalone ``ClusterSim`` run.
* ``GlobalTapasRouter`` — the reference policy: risk-weighted steering
  via ``core.risk.server_risk`` lifted to region granularity
  (``region_risk``), emergency drains, price/RTT-aware admission.
  ``LatencyOnlyRouter`` is the per-region-greedy baseline (serve
  everything at home, admit to the lowest-RTT region).

Cross-region steering pays for the WAN: demand served ``rtt`` ms away
from home is inflated by ``1 + wan_penalty_per_ms * rtt`` — the remote
region must spend extra capacity to deliver the same within-SLO goodput
(TTFT grows by the round trip, streaming tokens buffer deeper).  Keeping
load home is therefore free, and a global policy must beat that default
on throttling to justify every megabyte it moves.

Each region's physics runs on the fleet's ``device`` (``FleetSim(cfg,
device=...)``, handed to every ``ClusterSim``); the policies read only the
numpy telemetry ``ClusterSim.observe`` returns.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field, replace
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.datacenter import DCConfig
from repro_torch.core.risk import (energy_cost_index, region_risk,
                             thermally_comparable)
from repro_torch.core.scenario import Scenario, VMArrival, WeatherShift
from repro_torch.core.simulator import TAPAS, ClusterSim, Policy, SimConfig
from repro_torch.core.traces import carbon_intensity


@dataclass(frozen=True)
class RegionSpec:
    """One region of the fleet.

    ``trace_namespace`` seeds the region's weather/customer/endpoint noise
    (see ``traces.trace_seed``); ``None`` derives it from ``name`` so
    distinct regions never replay identical traces, while an explicit
    ``""`` opts into the shared global traces (exact single-cluster
    parity).
    """
    name: str
    dc: DCConfig = field(default_factory=DCConfig)
    wan_rtt_ms: float = 20.0      # RTT to the fleet's user front door
    power_price_scale: float = 1.0  # relative $/kWh multiplier (admission preference)
    carbon_scale: float = 1.0     # grid dirtiness vs the fleet-mean grid
    weather: tuple = ()           # WeatherShift schedule for this region
    trace_namespace: str | None = None
    # custom region control plane, forwarded to SimConfig.control: a
    # ControlPolicy instance or a zero-arg factory.  Prefer a factory —
    # an instance shared across regions (or runs) carries its state with
    # it.  None -> built from the fleet-wide ``policy`` flags.
    control: object | None = None
    # forwarded to SimConfig.iaas_only_capping (None derives from the
    # fleet ``policy`` flags; set when driving a custom ``control``)
    iaas_only_capping: bool | None = None
    # forwarded to SimConfig.resilience (a core.faults.ResilienceKnobs;
    # None -> the region runs with full recovery defaults)
    resilience: object | None = None

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise ValueError(f"region name must be a non-empty string, "
                             f"got {self.name!r}")
        if self.wan_rtt_ms < 0.0:
            raise ValueError(f"wan_rtt_ms must be >= 0, got {self.wan_rtt_ms}")
        if self.power_price_scale <= 0.0:
            raise ValueError(
                f"power_price_scale must be > 0, got {self.power_price_scale}")
        if self.carbon_scale <= 0.0:
            raise ValueError(
                f"carbon_scale must be > 0, got {self.carbon_scale}")
        object.__setattr__(self, "weather", tuple(self.weather))
        for ev in self.weather:
            if not isinstance(ev, WeatherShift):
                raise TypeError(
                    f"RegionSpec.weather takes WeatherShift events, "
                    f"got {ev!r}")
            if ev.region not in (None, self.name):
                raise ValueError(
                    f"weather event for region {ev.region!r} attached to "
                    f"region {self.name!r}")


@dataclass(frozen=True)
class Migration:
    """One ``rebalance`` decision: move the VM on ``server`` of ``src``
    to region ``dst`` (evicted now, re-admitted there next tick)."""
    src: str
    server: int
    dst: str

    def __post_init__(self):
        if self.src == self.dst:
            raise ValueError(f"migration from {self.src!r} to itself")
        if self.server < 0:
            raise ValueError(f"server must be >= 0, got {self.server}")


@dataclass
class FleetState:
    """Per-tick fleet snapshot handed to ``FleetPolicy`` hooks.

    ``regions`` carries each region's full ``ClusterState`` (the same
    live-view caveats apply: treat arrays as read-only); the remaining
    fields are the lifted region-granularity telemetry global policies
    actually route on.
    """
    tick: int
    now_h: float
    regions: dict                  # name -> ClusterState
    specs: dict                    # name -> RegionSpec
    rtt_ms: dict                   # (a, b) -> one-way-pair RTT in ms
    risk: dict                     # name -> region_risk score in [0, 1]
    emergency: dict                # name -> any active failure event
    capacity: dict                 # name -> SaaS capacity, nominal-VM units
    headroom: dict                 # name -> capacity - natural demand
    demand: dict                   # endpoint -> {name: natural demand}
    price: dict = field(default_factory=dict)   # name -> effective $/kWh
    #                                             (shock-scaled power_price_scale)
    telemetry_age: dict = field(default_factory=dict)  # name -> ticks the
    #                                             region's telemetry has been
    #                                             stale (SensorDropout)
    carbon: dict = field(default_factory=dict)  # name -> grid carbon
    #                                             intensity right now
    wan_penalty_per_ms: float = 0.0             # the fleet's WAN tax rate

    def free_servers(self, name: str) -> int:
        return int((self.regions[name].kind == 0).sum())

    def cost_index(self, name: str, *, carbon_weight: float = 0.5) -> float:
        """Blended price/carbon cost of a kWh served in ``name`` now."""
        return energy_cost_index(self.price.get(name, 1.0),
                                 self.carbon.get(name, 1.0),
                                 carbon_weight=carbon_weight)


@runtime_checkable
class FleetPolicy(Protocol):
    """The global-control contract ``FleetSim`` drives every tick.

    Hooks run in tick order: ``admit_region`` for each due fleet-level VM
    arrival, ``rebalance`` once, then ``route_region`` once per endpoint.
    All three see the same ``FleetState`` observed at the top of the tick.
    """

    def admit_region(self, fleet: FleetState, vm: VMArrival) -> str | None:
        """Pick the region a fleet-level VM arrival lands in (placement
        *within* the region stays with that region's ControlPolicy), or
        None to reject the arrival."""
        ...

    def route_region(self, fleet: FleetState, endpoint: str,
                     demands: dict) -> dict:
        """Steer ``endpoint``'s demand across regions.

        ``demands`` maps each region that hosts the endpoint to its
        natural (home) demand this tick.  Return ``{origin: {dest:
        fraction}}``; fractions per origin should sum to 1 (a shortfall
        is assigned back home), and every dest must host the endpoint.
        Demand moved off its origin is inflated by the WAN goodput
        penalty before it lands."""
        ...

    def rebalance(self, fleet: FleetState) -> list:
        """Return ``Migration``s draining load out of failing regions.
        Evictions happen immediately; the VM re-arrives in ``dst`` next
        tick (the WAN transfer is not free)."""
        ...


# ---------------------------------------------------------------------------
# reference policies
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetKnobs:
    """Named parameters of the ``GlobalTapasRouter`` reference policy."""

    #: region risk at which cross-region steering engages (mirrors the
    #: §4.3 hot threshold — the fleet reacts when the cluster loop does).
    risk_threshold: float = 0.45
    #: a destination must be at least this much cooler than the origin.
    margin: float = 0.08
    #: ceiling on the fraction of an origin's demand moved per tick.
    shift_max: float = 0.7
    #: links with a higher RTT than this are never worth the goodput
    #: penalty for thermal relief.
    rtt_budget_ms: float = 250.0
    #: emergency + this region risk starts VM migration (not just
    #: request steering).
    drain_risk: float = 0.55
    #: VMs migrated out of a draining region per tick.
    drain_per_tick: int = 2
    #: quantile ``region_risk`` lifts per-server risk with.
    risk_quantile: float = 0.8
    #: steer-fraction decay per tick once the pressure target drops.
    #: Risk is measured *after* steering relieved the region, so acting on
    #: the instantaneous score bang-bangs: steer, look cool, snap the load
    #: back, throttle, repeat.  Holding the steered fraction and releasing
    #: it slowly turns the oscillation into a ramp.
    release: float = 0.75
    #: ceiling on the fraction of a *cool* origin's demand moved purely for
    #: cost (price/carbon).  0.0 disables cost-aware steering — the
    #: default, which preserves the recorded ``BENCH_fleet`` trajectory;
    #: see ``cost_aware_knobs()`` for the enabled preset.
    cost_shift_max: float = 0.0
    #: a cost destination may be at most this much riskier than the origin
    #: (and always below ``risk_threshold``): the thermal tolerance band
    #: inside which regions count as equivalent and $/carbon may decide.
    cost_risk_band: float = 0.15
    #: minimum fractional cost advantage — net of the WAN goodput tax — a
    #: destination must offer before cost-chasing engages.  Paired with
    #: the reused ``release`` hysteresis, this keeps a marginally-cheap
    #: region from flapping demand back and forth across the WAN.
    cost_margin: float = 0.08
    #: weight of grid carbon intensity vs bare power price in the blended
    #: cost index (see ``risk.energy_cost_index``).
    carbon_weight: float = 0.5
    #: a region whose telemetry has been stale (SensorDropout) for more
    #: than this many ticks is not trusted as a steering/drain destination
    #: — its frozen risk score may be hiding a heating region.
    stale_dest_ticks: int = 2


def cost_aware_knobs(**overrides) -> FleetKnobs:
    """The carbon/price-aware preset: thermal steering as recorded, plus
    cost-chasing of up to 35% of a cool origin's demand."""
    kw = dict(cost_shift_max=0.35)
    kw.update(overrides)
    return FleetKnobs(**kw)


class GlobalTapasRouter:
    """Risk-weighted global routing: ``server_risk`` lifted to regions.

    Admission prefers cold, cheap, close regions (deterministic
    ``(risk, price, rtt, name)`` order); steering moves demand from
    regions past the risk threshold toward cooler regions with headroom,
    deeper the hotter the origin runs, with per-origin hysteresis (see
    ``FleetKnobs.release``) so relief does not immediately argue for
    undoing itself; an emergency plus deep risk drains whole VMs.  Every
    candidate ordering ends in the region name or server id, so decisions
    are stable across Python versions and insertion orders.

    With ``FleetKnobs.cost_shift_max > 0`` (see ``cost_aware_knobs()``),
    thermally-cool origins additionally chase cheap/clean energy: demand
    moves toward regions whose blended price/carbon index — inflated by
    the WAN goodput tax — undercuts home by ``cost_margin``, but only
    inside the ``cost_risk_band`` thermal tolerance band, and the moved
    fraction reuses the same hysteresis so price flapping cannot
    oscillate load across the WAN.  The default knobs leave cost-chasing
    off, preserving the recorded thermal-drill trajectories.

    The steer-fraction memory makes the policy stateful — pass the class
    (or a factory) to ``FleetConfig(fleet=...)`` when rerunning one
    ``FleetSim``, exactly like stateful ``SimConfig.control`` policies.
    """

    def __init__(self, knobs: FleetKnobs | None = None):
        self.knobs = knobs or FleetKnobs()
        self._steer: dict = {}   # (endpoint, origin) -> held moved fraction
        self._cost: dict = {}    # (endpoint, origin) -> held cost-move frac

    def admit_region(self, fleet: FleetState, vm: VMArrival) -> str | None:
        cands = [(fleet.risk[n], fleet.specs[n].power_price_scale,
                  fleet.specs[n].wan_rtt_ms, n)
                 for n in sorted(fleet.regions) if fleet.free_servers(n) > 0]
        return min(cands)[3] if cands else None

    def route_region(self, fleet: FleetState, endpoint: str,
                     demands: dict) -> dict:
        k = self.knobs
        shares: dict = {}
        for h in sorted(demands):
            shares[h] = {h: 1.0}
            key = (endpoint, h)
            r_h = fleet.risk[h]
            depth = min(1.0, max(r_h - k.risk_threshold, 0.0)
                        / max(1.0 - k.risk_threshold, 1e-9))
            if fleet.emergency[h]:
                depth = max(depth, 0.8)
            # hysteresis: rise to the target immediately, release slowly
            move = max(k.shift_max * depth,
                       self._steer.get(key, 0.0) * k.release)
            if move < 1e-3:
                self._steer.pop(key, None)
                # a thermally-cool origin is free to chase cheap energy
                self._cost_route(fleet, endpoint, h, demands, shares)
                continue
            dests = []
            for q in sorted(demands):
                if q == h or fleet.rtt_ms[(h, q)] > k.rtt_budget_ms:
                    continue
                # stale telemetry: the frozen risk score may hide a
                # heating region — never steer *toward* blind spots
                if fleet.telemetry_age.get(q, 0) > k.stale_dest_ticks:
                    continue
                # absolute dest gate: a flapping relative-to-origin gate
                # would re-couple the two regions' oscillations
                if fleet.risk[q] >= min(k.risk_threshold,
                                        r_h - k.margin) \
                        or fleet.emergency[q]:
                    continue
                w = max(fleet.headroom[q], 0.0) \
                    * (max(r_h, k.risk_threshold) - fleet.risk[q])
                if w > 0.0:
                    dests.append((q, w))
            if not dests:
                self._steer[key] = move * k.release
                continue
            self._steer[key] = move
            tot = sum(w for _, w in dests)
            shares[h][h] = 1.0 - move
            for q, w in dests:
                shares[h][q] = move * w / tot
        return shares

    def _cost_route(self, fleet: FleetState, endpoint: str, h: str,
                    demands: dict, shares: dict) -> None:
        """Carbon/price-aware steering for a thermally-cool origin ``h``.

        Only engages inside the thermal tolerance band (the destination
        must be no more than ``cost_risk_band`` riskier than the origin
        and below the steering threshold), and only when the destination's
        blended price/carbon index — inflated by the WAN goodput tax for
        the extra capacity remote serving burns — undercuts the origin's
        by at least ``cost_margin``.  The moved fraction reuses the
        thermal hysteresis: it rises to the target immediately, and once
        the advantage shrinks into the ``+-cost_margin`` dead band the
        held share keeps landing on the break-even destinations while
        decaying by ``release`` per tick — so two regions pricing within
        noise of each other ramp demand back gradually instead of
        flipping it across the WAN every tick.  A hard reversal (the dest
        now costlier than home by more than the margin, or thermally
        excluded) sends demand home immediately.
        """
        k = self.knobs
        key = (endpoint, h)
        if k.cost_shift_max <= 0.0:
            return
        r_h = fleet.risk[h]
        c_h = fleet.cost_index(h, carbon_weight=k.carbon_weight)
        # two tiers around the break-even point: a dest must undercut home
        # by cost_margin to *engage* new steering, but a previously-engaged
        # share keeps landing (decaying) on any dest inside the +-margin
        # dead band — advantage hovering around the margin therefore ramps
        # instead of flipping up to cost_shift_max of the demand per tick
        engage, hold = [], []
        for q in sorted(demands):
            if q == h or fleet.rtt_ms[(h, q)] > k.rtt_budget_ms:
                continue
            if fleet.telemetry_age.get(q, 0) > k.stale_dest_ticks:
                continue   # blind spot: cheap-looking but unverifiable
            if fleet.emergency[q] or fleet.headroom[q] <= 0.0 \
                    or not thermally_comparable(
                        r_h, fleet.risk[q], band=k.cost_risk_band,
                        threshold=k.risk_threshold):
                continue
            wan = 1.0 + fleet.wan_penalty_per_ms * fleet.rtt_ms[(h, q)]
            gain = 1.0 - (fleet.cost_index(q, carbon_weight=k.carbon_weight)
                          * wan) / max(c_h, 1e-9)
            if gain >= k.cost_margin:
                engage.append((q, fleet.headroom[q] * gain))
            elif gain > -k.cost_margin:
                hold.append((q, fleet.headroom[q]
                             * max(gain + k.cost_margin, 1e-9)))
        held = self._cost.get(key, 0.0)
        if engage:
            dests, move = engage, k.cost_shift_max
        elif hold and held >= 1e-3:
            dests, move = hold, held * k.release
        else:
            # dests reversed hard (or thermally excluded): the held share
            # decays with nowhere to land — demand returns home at once
            held *= k.release
            if held < 1e-3:
                self._cost.pop(key, None)
            else:
                self._cost[key] = held
            return
        # goodput guard: never move more than the destinations' actual
        # headroom can absorb (with margin for the WAN tax)
        avail = 0.9 * sum(max(fleet.headroom[q], 0.0) for q, _ in dests)
        move = min(move, avail / max(demands[h], 1e-9))
        if move < 1e-3:
            self._cost.pop(key, None)
            return
        self._cost[key] = move
        tot = sum(w for _, w in dests)
        shares[h][h] = 1.0 - move
        for q, w in dests:
            shares[h][q] = shares[h].get(q, 0.0) + move * w / tot

    def rebalance(self, fleet: FleetState) -> list:
        k = self.knobs
        migs: list = []
        placed: dict = {}
        for h in sorted(fleet.regions):
            if not (fleet.emergency[h] and fleet.risk[h] >= k.drain_risk):
                continue
            st = fleet.regions[h]
            dests = sorted(
                (fleet.risk[q], fleet.rtt_ms[(h, q)], q)
                for q in sorted(fleet.regions)
                if q != h and not fleet.emergency[q]
                and fleet.risk[q] < k.risk_threshold
                and fleet.telemetry_age.get(q, 0) <= k.stale_dest_ticks)
            # hottest SaaS servers drain first; ties break on server id
            order = sorted((int(s) for s in np.flatnonzero(st.kind == 2)),
                           key=lambda s: (-float(st.risk[s]), s))
            for s in order[: k.drain_per_tick]:
                dest = next((q for _, _, q in dests
                             if fleet.free_servers(q) - placed.get(q, 0) > 0),
                            None)
                if dest is None:
                    break
                placed[dest] = placed.get(dest, 0) + 1
                migs.append(Migration(src=h, server=s, dst=dest))
        return migs


class LatencyOnlyRouter:
    """The per-region-greedy baseline: every region serves its own demand
    (zero WAN latency paid, zero thermal awareness), and fleet arrivals
    land in the lowest-RTT region with a free server."""

    def admit_region(self, fleet: FleetState, vm: VMArrival) -> str | None:
        cands = [(fleet.specs[n].wan_rtt_ms, n)
                 for n in sorted(fleet.regions) if fleet.free_servers(n) > 0]
        return min(cands)[1] if cands else None

    def route_region(self, fleet: FleetState, endpoint: str,
                     demands: dict) -> dict:
        return {h: {h: 1.0} for h in demands}

    def rebalance(self, fleet: FleetState) -> list:
        return []


# ---------------------------------------------------------------------------
# fleet simulator
# ---------------------------------------------------------------------------

@dataclass
class FleetConfig:
    regions: tuple = ()
    horizon_h: float = 24.0
    tick_min: float = 5.0
    saas_fraction: float = 0.5
    seed: int = 0
    policy: Policy = TAPAS         # each region's control-plane flags
    # global controller: a FleetPolicy instance (good for one run) or a
    # zero-arg factory rebuilt every reset(); None -> GlobalTapasRouter.
    fleet: object | None = None
    scenario: Scenario | None = None
    occupancy: float = 0.88
    demand_scale: float = 0.85
    #: demand served one ms of RTT away from home needs this extra
    #: fraction of capacity to hold the same within-SLO goodput.
    wan_penalty_per_ms: float = 0.002
    #: explicit inter-region RTT overrides {(a, b): ms}; the default is
    #: the star topology through the front door (rtt_a + rtt_b).
    rtt_ms: dict | None = None


@dataclass
class FleetResult:
    regions: dict                  # name -> SimResult
    moved_load: float              # cross-region load (nominal-VM-ticks)
    wan_overhead: float            # extra demand paid to the WAN penalty
    migrations: int
    migrations_failed: int         # dest filled up; tenant sent back home
    fleet_admissions: int
    unserved_frac: float           # fleet-wide, demand-weighted
    mean_quality: float
    energy_kwh: float = 0.0        # fleet IT energy drawn over the run
    energy_cost_kwh: float = 0.0   # price-weighted kWh (power_price_scale is unitless)
    carbon_kg: float = 0.0         # sum of kWh x grid carbon intensity

    def blended_cost(self, carbon_weight: float = 0.5) -> float:
        """The objective cost-aware steering minimizes: served energy
        weighted by the blended price/carbon index (see
        ``risk.energy_cost_index``), integrated over the run."""
        return ((1.0 - carbon_weight) * self.energy_cost_kwh
                + carbon_weight * self.carbon_kg)

    def summary(self) -> dict:
        th = sum(r.thermal_events for r in self.regions.values())
        pw = sum(r.power_events for r in self.regions.values())
        return {
            "thermal_events": th,
            "power_events": pw,
            "throttle_events": th + pw,
            "max_temp_c": max(float(r.max_gpu_temp_c.max())
                              for r in self.regions.values()),
            "unserved_frac": self.unserved_frac,
            "mean_quality": self.mean_quality,
            "moved_load": self.moved_load,
            "wan_overhead": self.wan_overhead,
            "migrations": self.migrations,
            "migrations_failed": self.migrations_failed,
            "fleet_admissions": self.fleet_admissions,
            "energy_kwh": self.energy_kwh,
            "energy_cost": self.energy_cost_kwh,
            "carbon_kg": self.carbon_kg,
            "regions": {n: r.summary() for n, r in self.regions.items()},
        }


class FleetSim:
    """N per-region ``ClusterSim``s under one ``FleetPolicy``.

    Each tick: observe every region, lift the telemetry into a
    ``FleetState``, run the policy's admission/rebalance/steering hooks,
    then let every region finish its tick through the unmodified
    single-cluster code path (reconfigure, backend sync, physics).  The
    per-region physics and control planes are exactly ``ClusterSim``'s —
    the fleet only chooses *where* demand and VMs land.
    """

    def __init__(self, cfg: FleetConfig, *, device="cuda"):
        if not cfg.regions:
            raise ValueError("a fleet needs at least one region")
        names = [spec.name for spec in cfg.regions]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate region names: {names}")
        self.cfg = cfg
        self.specs = {spec.name: spec for spec in cfg.regions}
        scenario = cfg.scenario or Scenario()
        unknown = scenario.regions_named() - set(names)
        if unknown:
            raise ValueError(
                f"scenario events target unknown regions {sorted(unknown)}; "
                f"fleet regions are {names}")
        self.rtt_ms = self._build_rtt(cfg, names)
        self.sims: dict[str, ClusterSim] = {}
        for spec in cfg.regions:
            regional = scenario.for_region(spec.name) + Scenario(
                tuple(replace(w, region=None) for w in spec.weather))
            ns = spec.name if spec.trace_namespace is None \
                else spec.trace_namespace
            # total construction: every SimConfig field is carried
            # explicitly — an omitted field silently reverts to its
            # default (the scale_datacenter bug class)
            self.sims[spec.name] = ClusterSim(SimConfig(
                dc=spec.dc, horizon_h=cfg.horizon_h, tick_min=cfg.tick_min,
                saas_fraction=cfg.saas_fraction, seed=cfg.seed,
                policy=cfg.policy, scenario=regional,
                failures=(),               # legacy channel; region-scoped
                #                            failures ride the scenario
                occupancy=cfg.occupancy, demand_scale=cfg.demand_scale,
                control=spec.control,
                iaas_only_capping=spec.iaas_only_capping,
                resilience=spec.resilience,
                region_name=spec.name, trace_namespace=ns),
                device=device)
        first = next(iter(self.sims.values()))
        self.ticks = first.ticks
        self.t_h = first.t_h
        self._fleet_vms = scenario.fleet_arrivals()
        self._scenario = scenario      # fleet-level events (price shocks)
        # per-region grid carbon-intensity traces, namespaced exactly like
        # the weather/customer noise so identical configs still diverge
        self._carbon = {}
        for spec in cfg.regions:
            ns = spec.name if spec.trace_namespace is None \
                else spec.trace_namespace
            self._carbon[spec.name] = (
                spec.carbon_scale
                * carbon_intensity(self.t_h, seed=cfg.seed, namespace=ns))
        self.reset()

    @staticmethod
    def _build_rtt(cfg: FleetConfig, names: list) -> dict:
        specs = {s.name: s for s in cfg.regions}
        rtt = {}
        for a in names:
            for b in names:
                rtt[(a, b)] = 0.0 if a == b else (specs[a].wan_rtt_ms
                                                  + specs[b].wan_rtt_ms)
        for key, ms in (cfg.rtt_ms or {}).items():
            a, b = key
            if a not in specs or b not in specs:
                raise ValueError(f"rtt_ms override {key} names an unknown "
                                 f"region; fleet regions are {names}")
            if ms < 0.0:
                raise ValueError(f"rtt_ms override {key} must be >= 0")
            rtt[(a, b)] = rtt[(b, a)] = float(ms)
        return rtt

    # ------------------------------------------------------------------
    def reset(self) -> None:
        cfg = self.cfg
        for sim in self.sims.values():
            if sim.tick:
                sim.reset()
        if cfg.fleet is None:
            self.policy = GlobalTapasRouter()
        elif isinstance(cfg.fleet, type) or (
                callable(cfg.fleet)
                and not isinstance(cfg.fleet, FleetPolicy)):
            self.policy = cfg.fleet()
        else:
            self.policy = cfg.fleet
        self.tick = 0
        self._evseq = itertools.count()
        self._pending_fleet = [(ev.arrival_h, next(self._evseq), ev)
                               for ev in self._fleet_vms]
        heapq.heapify(self._pending_fleet)
        self._moved = 0.0
        self._wan_extra = 0.0
        self._migrations = 0
        self._mig_failed = 0
        self._admissions = 0
        self._energy_kwh = 0.0
        self._energy_cost_kwh = 0.0
        self._carbon_kg = 0.0
        self._prev_energy = dict.fromkeys(self.sims, 0.0)
        # migrations whose dest placement has not been confirmed yet:
        # (dst, src, injected VMSpec), resolved after the next observe
        self._inflight: list = []
        self.last_state: FleetState | None = None

    def attach_backend(self, region: str, server: int, backend) -> None:
        """Bind a real serving engine to a SaaS server of one region
        (see ``ClusterSim.attach_backend`` / ``serving.backend``)."""
        self._check_region(region)
        self.sims[region].attach_backend(server, backend)

    def _check_region(self, name) -> None:
        if name not in self.sims:
            raise ValueError(f"unknown region {name!r}; fleet regions are "
                             f"{sorted(self.sims)}")

    # ------------------------------------------------------------------
    def _fleet_state(self, states: dict) -> FleetState:
        k = getattr(self.policy, "knobs", None)
        quantile = getattr(k, "risk_quantile", 0.8)
        risk, emergency, capacity = {}, {}, {}
        for name, st in states.items():
            risk[name] = region_risk(st.risk, st.kind, quantile=quantile)
            emergency[name] = bool(st.emergency)
            cap = 0.0
            for srv, inst in st.instances.items():
                if st.kind[srv] == 2 and not inst.paused:
                    cap += ((inst.entry.goodput / st.nominal.goodput)
                            * float(st.freq_cap[srv]))
            capacity[name] = cap
        demand: dict = {}
        natural = dict.fromkeys(states, 0.0)
        for name, sim in self.sims.items():
            st = states[name]
            for ep, servers in st.endpoints.items():
                if not servers:
                    continue
                d = sim.endpoint_demand(ep, st.now_h)
                demand.setdefault(ep, {})[name] = d
                natural[name] += float(d)
        headroom = {n: capacity[n] - natural[n] for n in states}
        now = float(self.t_h[self.tick])
        price = {n: self.specs[n].power_price_scale
                 * self._scenario.price_scale(now, n) for n in states}
        carbon = {n: float(self._carbon[n][self.tick]) for n in states}
        return FleetState(
            tick=self.tick, now_h=now,
            regions=states, specs=self.specs, rtt_ms=self.rtt_ms,
            risk=risk, emergency=emergency, capacity=capacity,
            headroom=headroom, demand=demand, price=price, carbon=carbon,
            telemetry_age={n: int(st.telemetry_age_ticks)
                           for n, st in states.items()},
            wan_penalty_per_ms=self.cfg.wan_penalty_per_ms)

    def _apply_shares(self, ep: str, demands: dict, shares: dict,
                      overrides: dict) -> None:
        pen = self.cfg.wan_penalty_per_ms
        # every hosting region gets an explicit figure — an origin whose
        # demand was steered away entirely must land at 0.0, not fall back
        # to its natural demand (which would double-serve the moved load)
        for q in demands:
            overrides[q].setdefault(ep, 0.0)
        for h, d in demands.items():
            row = dict(shares.get(h) or {h: 1.0})
            for q, w in row.items():
                if q not in demands:
                    raise ValueError(
                        f"route_region sent {ep!r} load to region {q!r}, "
                        f"which hosts no {ep!r} servers")
                if w < -1e-12:
                    raise ValueError(
                        f"route_region returned a negative share {w} for "
                        f"{ep!r} {h}->{q}")
            tot = sum(row.values())
            if tot > 1.0 + 1e-9:
                raise ValueError(
                    f"route_region shares for {ep!r} origin {h!r} sum to "
                    f"{tot} > 1")
            if tot < 1.0 - 1e-9:      # shortfall stays home
                row[h] = row.get(h, 0.0) + (1.0 - tot)
            for q, w in row.items():
                if w <= 0.0:
                    continue
                eff = d * w
                if q != h:
                    self._moved += float(eff)
                    extra = eff * pen * self.rtt_ms[(h, q)]
                    self._wan_extra += float(extra)
                    eff = eff + extra
                overrides[q][ep] = overrides[q].get(ep, 0.0) + eff

    def step(self) -> FleetState:
        """Advance the whole fleet one tick; returns the ``FleetState``."""
        if self.tick >= self.ticks:
            raise RuntimeError(
                f"simulation horizon reached ({self.ticks} ticks); "
                f"call reset() to rerun")
        states = {name: sim.observe() for name, sim in self.sims.items()}
        fleet = self._fleet_state(states)
        now = fleet.now_h

        # -- confirm last tick's migrations landed -----------------------
        # placement runs inside the dest's observe; a migration whose dest
        # filled up in the meantime must not silently lose a live tenant —
        # send it home (one retry; a drop there is the generic full-fleet
        # arrival-drop semantics) and count the failure
        for dst, src, vm in self._inflight:
            if vm.arrival_h + vm.lifetime_h <= now:
                continue    # reached its scheduled end either way — a
                #             landed-then-departed VM is not a failure,
                #             and an expired one must not be resurrected
            if not (self.sims[dst].alloc_state.vm_of == vm.vm_id).any():
                self._mig_failed += 1
                remaining = max(vm.arrival_h + vm.lifetime_h - now,
                                self.cfg.tick_min / 60.0)
                self.sims[src].inject_vm(
                    kind=vm.kind, customer=vm.customer, arrival_h=now,
                    lifetime_h=remaining, peak_util=vm.peak_util)
        self._inflight = []

        # -- fleet-level VM admissions (policy picks the region) ---------
        while self._pending_fleet and self._pending_fleet[0][0] <= now:
            _, _, ev = heapq.heappop(self._pending_fleet)
            region = self.policy.admit_region(fleet, ev)
            if region is None:
                continue
            self._check_region(region)
            self.sims[region].inject_vm(
                kind=ev.kind, customer=ev.customer, arrival_h=now,
                lifetime_h=ev.lifetime_h, peak_util=ev.peak_util)
            self._admissions += 1

        # -- drains/migrations (before routing: drained servers take no
        #    load this tick; the VM re-arrives at the dest next tick) ----
        for m in self.policy.rebalance(fleet) or []:
            if not isinstance(m, Migration):
                raise TypeError(f"rebalance must return Migrations, "
                                f"got {m!r}")
            self._check_region(m.src)
            self._check_region(m.dst)
            vm = self.sims[m.src].evict(states[m.src], m.server)
            if vm is None:
                continue
            remaining = max(vm.arrival_h + vm.lifetime_h - now,
                            self.cfg.tick_min / 60.0)
            injected = self.sims[m.dst].inject_vm(
                kind=vm.kind, customer=vm.customer, arrival_h=now,
                lifetime_h=remaining, peak_util=vm.peak_util)
            self._inflight.append((m.dst, m.src, injected))
            self._migrations += 1

        # -- global steering, then each region's unmodified tick tail ----
        overrides: dict = {name: {} for name in self.sims}
        for ep in sorted(fleet.demand):
            demands = fleet.demand[ep]
            shares = self.policy.route_region(fleet, ep, dict(demands))
            self._apply_shares(ep, demands, shares, overrides)
        for name, sim in self.sims.items():
            sim.route(states[name], demand_overrides=overrides[name])
            sim.finish_tick(states[name])
        # energy/cost accounting: this tick's per-region energy priced at
        # this tick's effective power price and grid carbon intensity
        for name, sim in self.sims.items():
            kwh = sim._energy_kwh - self._prev_energy[name]
            self._prev_energy[name] = sim._energy_kwh
            self._energy_kwh += kwh
            self._energy_cost_kwh += kwh * fleet.price[name]
            self._carbon_kg += kwh * fleet.carbon[name]
        self.tick += 1
        self.last_state = fleet
        return fleet

    # ------------------------------------------------------------------
    def result(self) -> FleetResult:
        if self.tick == 0:
            raise RuntimeError(
                "no ticks simulated yet; call step() or run() first")
        regions = {name: sim.result() for name, sim in self.sims.items()}
        unserved = sum(sim._unserved_total for sim in self.sims.values())
        demand = sum(sim._demand_total for sim in self.sims.values())
        q_acc = sum(sim._quality_acc for sim in self.sims.values())
        q_w = sum(sim._quality_w for sim in self.sims.values())
        return FleetResult(
            regions=regions, moved_load=self._moved,
            wan_overhead=self._wan_extra, migrations=self._migrations,
            migrations_failed=self._mig_failed,
            fleet_admissions=self._admissions,
            unserved_frac=unserved / max(demand, 1e-9),
            mean_quality=q_acc / max(q_w, 1e-9),
            energy_kwh=self._energy_kwh, energy_cost_kwh=self._energy_cost_kwh,
            carbon_kg=self._carbon_kg)

    def run(self) -> FleetResult:
        if self.tick:
            self.reset()
        while self.tick < self.ticks:
            self.step()
        return self.result()
