"""Discrete-time cluster simulator — paper §5.1 (port of
``repro.core.simulator``).

Replays IaaS power traces and SaaS LLM-inference load over the datacenter
of §2, evaluating placement/routing/configuration policies under the
thermal (Eqs. 1–3) and power (Eq. 4) models; tracks throttling/capping
events and their performance/quality impact.

The physics (thermal/power models) run as float32 torch tensors over all
servers on the sim's ``device`` (the reference's ``jnp`` on its
accelerator); every reading the control plane takes comes back to the host
explicitly (``.cpu().numpy()``), and policy logic is event-level
Python/NumPy, mirroring the control plane.

The simulator is *step-wise*: external drivers advance it one tick at a
time with ``state = sim.step()`` and read (or log) the typed
``ClusterState`` (see ``core.state``) it returns; ``run()`` is just
``reset(); while ...: step(); result()``.  Internally each ``step()``
executes the phases

    state = self.observe()           # arrivals/departures + telemetry
    self.route(state)                # policy.route per endpoint
    changes = self.policy.reconfigure(state)
    self.apply(state)                # physics, throttling, capping

and then advances ``self.tick`` — the phase methods themselves never do,
so drivers that call phases directly (to perturb state between them) must
manage ``self.tick`` and run each phase exactly once per tick.  Real
serving engines bind to simulated SaaS servers via
``sim.attach_backend`` (see ``serving.backend``).

Policies are ``ControlPolicy`` objects; the Baseline/TAPAS control planes
are composed from ``PlacementPolicy`` / ``RoutingPolicy`` /
``ReconfigurePolicy`` adapters over the pre-existing allocator, router and
instance-configurator classes.  Custom policies plug in through
``SimConfig(control=...)``.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import profiles as P
from repro_torch.core.allocator import (AllocatorState, BaselineAllocator,
                                  PlacementPolicy, TapasAllocator)
from repro_torch.core.configurator import InstanceConfigurator, ReconfigurePolicy
from repro_torch.core.datacenter import Datacenter, DCConfig
from repro_torch.core.faults import EngineFault, ResilienceKnobs
from repro_torch.core.power import PowerModel, capping_factors
from repro_torch.core.risk import server_risk
from repro_torch.core.router import BaselineRouter, RoutingPolicy, TapasRouter
from repro_torch.core.scenario import (PriceShock, Scenario, WeatherShift,
                                 as_scenario)
# legacy re-exports: FailureEvent and friends used to live in this module
from repro_torch.core.scenario import DemandSurge, FailureEvent, VMArrival  # noqa: F401,E501
from repro_torch.core.state import ClusterState, ControlPolicy, InstanceView
from repro_torch.core.thermal import ThermalModel, outside_temperature
from repro_torch.core.traces import (VMSpec, endpoint_load, generate_workload,
                               iaas_util, trace_seed)


@dataclass(frozen=True)
class Policy:
    place: bool = False
    route: bool = False
    config: bool = False

    @property
    def name(self) -> str:
        if not (self.place or self.route or self.config):
            return "baseline"
        parts = [n for n, on in (("place", self.place), ("route", self.route),
                                 ("config", self.config)) if on]
        return "+".join(parts)


BASELINE = Policy()
TAPAS = Policy(place=True, route=True, config=True)


@dataclass
class SimConfig:
    dc: DCConfig = field(default_factory=DCConfig)
    horizon_h: float = 24.0
    tick_min: float = 5.0
    saas_fraction: float = 0.5
    seed: int = 0
    policy: Policy = BASELINE
    scenario: Scenario | None = None
    failures: tuple = ()         # legacy channel, merged into the scenario
    occupancy: float = 0.88
    demand_scale: float = 0.85   # endpoint demand vs fleet capacity
    # custom control plane: a ControlPolicy instance (good for one run) or a
    # zero-arg factory returning one (rebuilt on every reset(), so repeated
    # run() calls stay deterministic).  None -> built from ``policy`` flags.
    control: ControlPolicy | None = None
    # power-capping semantics (paper §5.4): True caps IaaS only (SaaS was
    # already reconfigured/steered), False caps every server in the row.
    # None derives it from ``policy.config`` — set explicitly when driving
    # a custom ``control`` whose reconfigure behavior the flags don't know.
    iaas_only_capping: bool | None = None
    # fleet identity: the region label stamped on every ClusterState, and
    # the trace-seed namespace (see ``traces.trace_seed``) that keeps two
    # regions with identical configs from replaying identical weather /
    # customer / endpoint noise.  Both default to the standalone behavior.
    region_name: str = ""
    trace_namespace: str = ""
    # recovery machinery switches (core.faults.ResilienceKnobs); None ->
    # everything on at defaults.  Pass faults.recovery_off() for the
    # no-recovery ablation arm.
    resilience: ResilienceKnobs | None = None


@dataclass
class SimResult:
    time_h: np.ndarray
    max_gpu_temp_c: np.ndarray         # (T,)
    peak_row_power_frac: np.ndarray  # (T,) hottest row / provisioned
    thermal_events: int
    power_events: int
    thermal_capped_frac: float       # fraction of server-ticks throttled
    power_capped_frac: float
    unserved_frac: float             # SaaS demand that queued (SLO proxy)
    mean_quality: float              # load-weighted SaaS quality
    iaas_perf_impact: float          # mean freq-cap depth x affected frac
    saas_perf_impact: float
    row_power_frac: np.ndarray       # (T, R)
    energy_kwh: float = 0.0          # IT energy drawn over the run

    def summary(self) -> dict:
        return {
            "energy_kwh": self.energy_kwh,
            "max_temp_c": float(self.max_gpu_temp_c.max()),
            "p99_temp_c": float(np.quantile(self.max_gpu_temp_c, 0.99)),
            "peak_row_power_frac": float(self.peak_row_power_frac.max()),
            "thermal_events": self.thermal_events,
            "power_events": self.power_events,
            "thermal_capped_frac": self.thermal_capped_frac,
            "power_capped_frac": self.power_capped_frac,
            "unserved_frac": self.unserved_frac,
            "mean_quality": self.mean_quality,
            "iaas_perf_impact": self.iaas_perf_impact,
            "saas_perf_impact": self.saas_perf_impact,
        }


class CompositeControlPlane:
    """A ``ControlPolicy`` bundled from placement/routing/reconfigure
    adapters — the shape both built-in control planes share."""

    def __init__(self, placement: PlacementPolicy, routing: RoutingPolicy,
                 reconfig: ReconfigurePolicy):
        self.placement = placement
        self.routing = routing
        self.reconfig = reconfig

    def begin_tick(self, state: ClusterState) -> None:
        self.reconfig.begin_tick(state)

    def place(self, state: ClusterState, vm: VMSpec) -> int | None:
        return self.placement.place(state, vm)

    def route(self, state: ClusterState, endpoint: str, demand: float):
        return self.routing.route(state, endpoint, demand)

    def reconfigure(self, state: ClusterState) -> list:
        return self.reconfig.reconfigure(state)

    def release(self, state: ClusterState, server: int) -> None:
        self.reconfig.release(state, server)


def build_control_policy(policy: Policy, *, tick_s: float,
                         seed: int = 0) -> CompositeControlPlane:
    """Compose the Baseline/TAPAS control plane selected by the per-
    subsystem ``Policy`` flags (paper Fig. 20 ablation axes)."""
    allocator = (TapasAllocator(seed=seed) if policy.place
                 else BaselineAllocator(seed=seed))
    router = TapasRouter() if policy.route else BaselineRouter()
    configurator = InstanceConfigurator(tick_s=tick_s)
    return CompositeControlPlane(
        PlacementPolicy(allocator),
        RoutingPolicy(router, thermal_aware=policy.route),
        ReconfigurePolicy(configurator, active=policy.config))


class ClusterSim:
    def __init__(self, cfg: SimConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dc = Datacenter(cfg.dc)
        self.thermal = ThermalModel.calibrate(self.dc, device=self.device)
        self.power = PowerModel.calibrate(self.dc, device=self.device)
        self.scenario = as_scenario(cfg.scenario, cfg.failures)
        self._validate_scenario_targets()
        self.resilience = (cfg.resilience if cfg.resilience is not None
                           else ResilienceKnobs())
        self._tseed = trace_seed(cfg.seed, cfg.trace_namespace)
        self.work = generate_workload(
            n_servers=self.dc.n_servers, horizon_h=cfg.horizon_h,
            seed=self._tseed, saas_fraction=cfg.saas_fraction,
            occupancy=cfg.occupancy)
        self._inject_scripted_vms()
        # pristine workload watermark: reset() truncates back to it, so
        # mid-run inject_vm() calls (fleet admissions/migrations) are not
        # replayed as scripted arrivals on a rerun
        self._n_base_vms = len(self.work.vms)
        self._base_endpoints = set(self.work.endpoints)
        self.nominal = P._entry(P.NOMINAL)
        self.ticks = int(cfg.horizon_h * 60 / cfg.tick_min)
        self.t_h = np.arange(self.ticks) * cfg.tick_min / 60.0
        self.reset()

    def _validate_scenario_targets(self) -> None:
        """Event fields validate themselves, but only the sim knows the
        topology — catch an out-of-range aisle target here instead of an
        IndexError hours into the drill."""
        for ev in self.scenario.events:
            if getattr(ev, "region", None) is not None:
                raise ValueError(
                    f"event {ev!r} is scoped to region {ev.region!r}, but "
                    f"this is a single-cluster sim — region-tagged events "
                    f"need core.fleet.FleetSim (or drop the tag)")
            if isinstance(ev, PriceShock):
                raise ValueError(
                    f"event {ev!r} is fleet-level economics; a single "
                    f"cluster has no power price — price shocks need "
                    f"core.fleet.FleetSim")
            if (isinstance(ev, FailureEvent) and ev.kind in ("ahu", "thermal")
                    and ev.target >= self.dc.n_aisles):
                raise ValueError(
                    f"{ev.kind} failure targets aisle {ev.target}, but the "
                    f"datacenter has {self.dc.n_aisles} aisles")
            if (isinstance(ev, EngineFault) and ev.server is not None
                    and ev.server >= self.dc.n_servers):
                raise ValueError(
                    f"{ev.kind} engine fault targets server {ev.server}, "
                    f"but the datacenter has {self.dc.n_servers} servers")

    def _inject_scripted_vms(self) -> None:
        """Append Scenario VMArrival events to the generated workload."""
        vid = len(self.work.vms)
        for ev in self.scenario.vm_arrivals():
            vm = VMSpec(vid, ev.kind, ev.customer, arrival_h=ev.arrival_h,
                        lifetime_h=ev.lifetime_h, peak_util=ev.peak_util)
            self.work.vms.append(vm)
            if ev.kind == "saas":
                self.work.endpoints.setdefault(ev.customer, []).append(vid)
            vid += 1

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """(Re)initialize all per-run mutable state; each ``run()`` (or
        external step sequence) after a reset is deterministic.

        A custom ``control`` passed as a *factory* is rebuilt here; a bare
        policy instance is reused as-is and keeps whatever internal state
        (affinity memory, RNG position) it accumulated — pass a factory if
        you rerun the same sim."""
        cfg = self.cfg
        if cfg.control is None:
            self.policy: ControlPolicy = build_control_policy(
                cfg.policy, tick_s=cfg.tick_min * 60.0, seed=cfg.seed)
        elif isinstance(cfg.control, type) or (
                callable(cfg.control)
                and not isinstance(cfg.control, ControlPolicy)):
            # a policy class or any other zero-arg factory: build fresh
            # (isinstance(SomeClass, Protocol) is True for the class object
            # itself, so classes must be caught before the protocol check)
            self.policy = cfg.control()
        else:
            self.policy = cfg.control
        self.alloc_state = AllocatorState.empty(self.dc, self.thermal,
                                                self.power)
        # drop VMs injected mid-run (fleet admissions/migrations) so the
        # rerun replays only the generated + scripted workload
        del self.work.vms[self._n_base_vms:]
        for name in list(self.work.endpoints):
            ids = [v for v in self.work.endpoints[name]
                   if v < self._n_base_vms]
            if ids or name in self._base_endpoints:
                self.work.endpoints[name] = ids
            else:
                del self.work.endpoints[name]
        self.tick = 0
        t_out = outside_temperature(cfg.dc.region, self.t_h,
                                    seed=self._tseed,
                                    device=self.device).cpu().numpy()
        if any(isinstance(ev, WeatherShift) for ev in self.scenario.events):
            t_out = t_out + np.array([self.scenario.weather_delta(float(t))
                                      for t in self.t_h])
        self._t_out = t_out
        # event queues: O(log n) pops instead of pop(0)/rebuild-and-remove
        self._evseq = itertools.count()
        self._pending = [(vm.arrival_h, next(self._evseq), vm)
                         for vm in self.work.vms]
        heapq.heapify(self._pending)
        self._departures: list = []   # heap of (depart_h, seq, srv, vm)
        self._ep_servers: dict[str, list] = {e: []
                                             for e in self.work.endpoints}
        self._server_ep: dict[int, str] = {}
        self._vm_on: dict[int, VMSpec] = {}     # server -> resident VM
        self._freq_cap = np.ones(self.dc.n_servers)
        self._last_util = np.zeros(self.dc.n_servers)
        # engine bindings carry live queues/stats that reset() cannot
        # rewind, so they are per-run: reattach after each reset
        self.backends: dict = {}   # server -> serving.backend.EngineBackend
        self._backends_synced: set = set()
        # resilience: watchdog health tracking + last-known-good telemetry
        self._unhealthy: set = set()
        self._hb_miss: dict = {}          # server -> consecutive misses
        self._parked: list = []           # drained reqs with no healthy home
        self._lkg: dict | None = None     # last-known-good sensor snapshot
        self._telemetry_age = 0           # ticks since the snapshot was live
        self.watchdog_drains = 0          # unhealthy transitions observed
        # accumulators
        self._max_temp = np.zeros(self.ticks)
        self._peak_row = np.zeros(self.ticks)
        self._row_frac_t = np.zeros((self.ticks, self.dc.n_rows))
        self._th_events = self._pw_events = 0
        self._th_capped = self._pw_capped = 0
        self._occupied_acc = 0
        self._energy_kwh = 0.0
        self._unserved_total = self._demand_total = 0.0
        self._quality_acc = self._quality_w = 0.0
        self._iaas_impact = self._saas_impact = 0.0

    def attach_backend(self, server: int, backend) -> None:
        """Bind a real serving engine (``serving.backend.EngineBackend``)
        to a simulated SaaS server: reconfigure decisions for that server
        are mirrored onto the engine's knobs, and the engine's measured
        goodput is reported back into ``ClusterState.measured_goodput``.

        Bindings last until the next ``reset()`` — an engine's queue and
        stats cannot be rewound, so a rerun starts unbound."""
        self.backends[int(server)] = backend

    # ------------------------------------------------------------------
    # observe: arrivals/departures + telemetry -> ClusterState
    # ------------------------------------------------------------------
    def observe(self) -> ClusterState:
        cfg, dc, th = self.cfg, self.dc, self.thermal
        ti = self.tick
        now = float(self.t_h[ti])
        state = self._begin_state(ti, now)

        # -- arrivals / departures -----------------------------------
        while self._pending and self._pending[0][0] <= now:
            _, _, vm = heapq.heappop(self._pending)
            srv = self.policy.place(state, vm)
            if srv is not None:
                heapq.heappush(self._departures,
                               (vm.arrival_h + vm.lifetime_h,
                                next(self._evseq), srv, vm))
                self._vm_on[srv] = vm
                if vm.kind == "saas":
                    self._ep_servers[vm.customer].append(srv)
                    self._server_ep[srv] = vm.customer
        while self._departures and self._departures[0][0] <= now:
            _, _, srv, vm = heapq.heappop(self._departures)
            if self._vm_on.get(srv) is not vm:
                continue   # evicted (fleet migration); server may be reused
            self.alloc_state.release(srv)
            self._vm_on.pop(srv, None)
            if vm.kind == "saas" and srv in self._server_ep:
                self._ep_servers[self._server_ep.pop(srv)].remove(srv)
            self.policy.release(state, srv)

        kind = state.kind
        self._occupied_acc += int((kind > 0).sum())

        # -- IaaS utilization: maintained server -> vm map -----------
        util_srv = np.zeros(dc.n_servers)
        for srv, vm in self._vm_on.items():
            if vm.kind == "iaas":
                util_srv[srv] = iaas_util(vm, np.asarray([now]),
                                          seed=self._tseed)[0]
        state.iaas_util = util_srv

        # -- instance telemetry + capacity/risk forecasts ------------
        self.policy.begin_tick(state)
        dc_load_prev = float(self._last_util.mean())
        state.inlet_est = th.inlet_temp(
            self._t_out[ti], dc_load_prev,
            cooling_derate=state.cooling_extra_c).cpu().numpy()
        state.risk = server_risk(
            dc, th, self.power, inlet=state.inlet_est,
            prov_row_power_w=state.prov_row_power_w,
            prov_aisle_cfm=state.prov_aisle_cfm,
            util=np.maximum(util_srv, self._last_util), kind=kind)
        # Eq. 2-derived per-server load ceilings: thermal-aware routing
        # can never push a server past its thermal cap
        state.u_max = th.max_util_for_temp(
            state.inlet_est, th.gpu_limit - 3.0).cpu().numpy()

        # -- sensor dropout: freeze derived telemetry at last-known-good --
        # The physics in apply() keeps using ground truth (hardware does
        # not stop heating because a sensor died); only what the control
        # plane *sees* freezes.  Risk gets a per-tick staleness bump so
        # policies steer conservatively instead of trusting the frozen
        # reading; telemetry_age_ticks exposes the staleness itself.
        if self.scenario.sensor_dropout(now) and self._lkg is not None:
            self._telemetry_age += 1
            state.inlet_est = self._lkg["inlet_est"]
            state.u_max = self._lkg["u_max"]
            state.risk = np.minimum(
                self._lkg["risk"]
                + self.resilience.stale_risk_bump * self._telemetry_age,
                1.0)
            state.telemetry_age_ticks = self._telemetry_age
        else:
            self._lkg = {"inlet_est": state.inlet_est,
                         "u_max": state.u_max, "risk": state.risk.copy()}
            self._telemetry_age = 0
        return state

    def _begin_state(self, ti: int, now: float) -> ClusterState:
        """Construct the tick's state: occupancy views + scenario-derived
        failure derates (available to ``place`` before telemetry)."""
        dc = self.dc
        ahu_derate = np.ones(dc.n_aisles)
        ups_derate = np.ones(dc.n_rows)
        cooling_extra = 0.0
        emergency = False
        for f in self.scenario.failures(now):
            emergency = True
            if f.kind == "ahu":
                n = dc.cfg.ahus_per_aisle
                ahu_derate[f.target] = (n - 1) / n
            elif f.kind == "ups":
                ups_derate[:] = 0.75                 # 4N/3 failover
            elif f.kind == "cooling":
                cooling_extra = 3.0
            elif f.kind == "thermal":
                # paper §5.4 thermal emergency: ~90% cooling capacity
                # (an AHU loss in one aisle + DC-level cooling strain)
                n = dc.cfg.ahus_per_aisle
                ahu_derate[f.target] = (n - 1) / n
                cooling_extra = 2.5
        return ClusterState(
            tick=ti, now_h=now, t_outside_c=float(self._t_out[ti]),
            seed=self._tseed, dc=dc, nominal=self.nominal,
            region=self.cfg.region_name,
            alloc=self.alloc_state, kind=self.alloc_state.kind_of,
            vm_of=self.alloc_state.vm_of, endpoints=self._ep_servers,
            emergency=emergency, ahu_derate=ahu_derate,
            ups_derate=ups_derate, cooling_extra_c=cooling_extra,
            prov_row_power_w=dc.prov_row_power_w * ups_derate,
            prov_aisle_cfm=dc.prov_ahu_cfm * ahu_derate,
            freq_cap=self._freq_cap, last_util=self._last_util,
            saas_load=np.zeros(dc.n_servers),
            quality=np.ones(dc.n_servers))

    # ------------------------------------------------------------------
    # route: endpoint demand through the policy
    # ------------------------------------------------------------------
    def endpoint_demand(self, ep: str, now: float) -> float:
        """This cluster's natural demand for ``ep`` at ``now`` (diurnal
        trace x fleet scale x scenario surges) — the quantity ``route``
        uses when no external driver overrides it, exposed so a fleet
        router can read every region's demand before redistributing it."""
        cfg = self.cfg
        demand = (endpoint_load(ep, np.asarray([now]),
                                seed=self._tseed)[0]
                  * len(self._ep_servers[ep]) * cfg.demand_scale)
        surge = self.scenario.demand_scale(now, ep)
        if surge != 1.0:
            demand = demand * surge
        return demand

    def route(self, state: ClusterState,
              demand_overrides: dict | None = None) -> None:
        """Route every endpoint's demand through the policy.

        ``demand_overrides`` (endpoint -> demand) substitutes an external
        driver's figure — a ``FleetSim`` steering load across regions —
        for the cluster's natural ``endpoint_demand``; endpoints not in
        the dict fall back to the natural demand."""
        now = state.now_h
        for ep, servers in state.endpoints.items():
            if not servers:
                continue
            if demand_overrides is not None and ep in demand_overrides:
                demand = demand_overrides[ep]
            else:
                demand = self.endpoint_demand(ep, now)
            out = self.policy.route(state, ep, demand)
            state.saas_load[out.servers] = out.load
            state.quality[out.servers] = out.quality
            self._unserved_total += out.unserved
            self._demand_total += demand
            self._quality_acc += float((out.load * out.quality).sum())
            self._quality_w += float(out.load.sum())

    # ------------------------------------------------------------------
    # apply: physics, throttling, capping
    # ------------------------------------------------------------------
    def apply(self, state: ClusterState) -> None:
        cfg, dc, th, pm = self.cfg, self.dc, self.thermal, self.power
        ti = state.tick
        s = dc.n_servers
        chips = dc.cfg.hw.chips
        kind = state.kind
        iaas_mask = kind == 1
        freq_cap = self._freq_cap
        util_srv = state.iaas_util
        saas_load = state.saas_load
        prov_air = state.prov_aisle_cfm
        prov_pwr = state.prov_row_power_w

        # -- chip utilization --------------------------------------
        chip_util = np.zeros((s, chips))
        # IaaS: capped clocks scale both work done and draw
        chip_util[iaas_mask] = (util_srv[iaas_mask]
                                * freq_cap[iaas_mask])[:, None]
        for srv in np.flatnonzero(kind == 2):
            e = state.instances[int(srv)].entry
            cap = (e.goodput / self.nominal.goodput) * freq_cap[srv]
            busy = min(saas_load[srv] / max(cap, 1e-9), 1.0)
            tp = e.cfg.tp
            # e.temp_frac is the per-active-chip utilization-equivalent of
            # this config at full busy (work concentrates at low TP)
            chip_util[srv, :tp] = min(busy * e.temp_frac, 1.0)
        chip_util = np.clip(chip_util, 0.0, 1.0)

        # -- physics -----------------------------------------------
        power_s = pm.server_power(chip_util).cpu().numpy()
        power_s = np.where(kind > 0, power_s, 0.12 * dc.cfg.hw.idle_power_w)
        p_row = dc.row_sum(power_s)
        dc_load = float(power_s.sum()
                        / (dc.cfg.hw.peak_power_w * s))
        inlet = th.inlet_temp(self._t_out[ti], dc_load,
                              cooling_derate=state.cooling_extra_c
                              ).cpu().numpy()
        t_gpu = th.gpu_temp(inlet, chip_util).cpu().numpy()
        air = np.asarray(th.airflow(chip_util.mean(axis=1)))
        air = np.where(kind > 0, air, th.airflow_idle_cfm * 0.5)
        a_air = dc.aisle_sum(air)

        # heat recirculation: aisles over provisioned airflow push inlet
        recirc = np.maximum(a_air / np.maximum(prov_air, 1.0) - 1.0, 0.0)
        t_gpu += (6.0 * recirc)[dc.aisle_of][:, None]

        # -- throttling / capping ----------------------------------
        hot_srv = (t_gpu.max(axis=1) >= dc.cfg.hw.gpu_temp_limit_c) & (kind > 0)
        over_row = p_row > prov_pwr
        # record the *demanded* (pre-throttle) peak — what the load asked
        # for; hardware clamps the realized temperature at the limit
        self._max_temp[ti] = (float(t_gpu[kind > 0].max())
                              if (kind > 0).any() else 0.0)
        self._th_events += int(hot_srv.sum())
        self._pw_events += int(over_row.sum())
        self._th_capped += int(hot_srv.sum())
        self._pw_capped += int(((over_row[dc.row_of]) & (kind > 0)).sum())

        # hardware thermal throttling clamps the hot server within the
        # tick: cut util to the Eq. 2 inversion at the limit, redo physics
        clamp = np.ones(s)
        if hot_srv.any():
            u_lim = th.max_util_for_temp(
                inlet, dc.cfg.hw.gpu_temp_limit_c).cpu().numpy()
            cur = chip_util.max(axis=1)
            clamp = np.where(hot_srv, np.minimum(
                u_lim / np.maximum(cur, 1e-6), 1.0), 1.0)
            chip_util = chip_util * clamp[:, None]
            power_s = pm.server_power(chip_util).cpu().numpy()
            power_s = np.where(kind > 0, power_s,
                               0.12 * dc.cfg.hw.idle_power_w)
            p_row = dc.row_sum(power_s)
            t_gpu = th.gpu_temp(inlet, chip_util).cpu().numpy()
            t_gpu += (6.0 * recirc)[dc.aisle_of][:, None]
            # throttling costs served throughput on SaaS servers
            loss = saas_load * (1.0 - clamp)
            self._unserved_total += float(loss[kind == 2].sum())
            saas_load = saas_load - loss
            state.saas_load = saas_load

        # power capping: baseline caps every server in the row uniformly;
        # TAPAS caps IaaS only (SaaS was already reconfigured/steered)
        iaas_only = (cfg.iaas_only_capping if cfg.iaas_only_capping
                     is not None else cfg.policy.config)
        mask = iaas_mask if iaas_only else (kind > 0)
        factors = capping_factors(
            dc, power_s, prov_pwr, pm,
            iaas_only_mask=mask).cpu().numpy()
        new_cap = np.clip(freq_cap * factors, 0.3, 1.0)
        freq_cap = np.where(factors < 1.0, new_cap,
                            np.minimum(freq_cap * 1.1, 1.0))
        self._freq_cap = freq_cap
        state.freq_cap = freq_cap

        # perf impact = power-cap depth + in-tick thermal-clamp depth
        cap_depth = (1.0 - freq_cap) + (1.0 - clamp)
        self._iaas_impact += (float(cap_depth[iaas_mask].mean())
                              if iaas_mask.any() else 0.0)
        saas_mask = kind == 2
        self._saas_impact += (float(cap_depth[saas_mask].mean())
                              if saas_mask.any() else 0.0)

        # served energy this tick (post-throttle/post-capping power draw)
        self._energy_kwh += (float(power_s.sum()) * cfg.tick_min / 60.0
                             / 1000.0)

        rowf = p_row / np.maximum(dc.prov_row_power_w, 1.0)
        self._row_frac_t[ti] = rowf
        self._peak_row[ti] = float(rowf.max())
        self._last_util = chip_util.mean(axis=1)

        # post-physics telemetry for external drivers
        state.last_util = self._last_util
        state.max_gpu_temp_c = self._max_temp[ti]
        state.row_power_frac = rowf
        state.thermal_throttled = hot_srv
        state.power_over_rows = over_row

    # ------------------------------------------------------------------
    def step(self) -> ClusterState:
        """Advance one tick; returns the tick's ``ClusterState``."""
        if self.tick >= self.ticks:
            raise RuntimeError(
                f"simulation horizon reached ({self.ticks} ticks); "
                f"call reset() to rerun")
        state = self.observe()
        self.route(state)
        return self.finish_tick(state)

    def finish_tick(self, state: ClusterState) -> ClusterState:
        """The tick's trailing half: reconfigure, backend sync, physics,
        tick advance.  Split out of ``step`` so external drivers (a
        ``FleetSim`` steering demand between ``observe`` and ``route``)
        share the exact reconfigure/apply code path instead of forking it.
        """
        changes = self.policy.reconfigure(state)
        # fold the decisions into the instance telemetry so the contract is
        # "return your changes" — policies need not also mutate
        # state.instances (the built-in adapter does both, identically)
        for ch in changes:
            state.instances[ch.server] = InstanceView(entry=ch.entry,
                                                      paused=ch.reloading)
        if self.backends:
            self._sync_backends(state, changes)
        self.apply(state)
        self.tick += 1
        return state

    # ------------------------------------------------------------------
    # fleet hooks: mid-run VM injection (scripted fleet admissions,
    # cross-region migrations) and eviction (drains)
    # ------------------------------------------------------------------
    def inject_vm(self, *, kind: str, customer: str, arrival_h: float,
                  lifetime_h: float, peak_util: float = 1.0) -> VMSpec:
        """Append a VM to this cluster's pending arrivals mid-run.

        Placement happens in the next ``observe`` whose time has reached
        ``arrival_h`` — a fleet admission or migration therefore lands one
        tick after the decision (the WAN transfer is not instantaneous).
        New SaaS endpoint names are created on the fly.
        """
        vm = VMSpec(len(self.work.vms), kind, customer, arrival_h=arrival_h,
                    lifetime_h=lifetime_h, peak_util=peak_util)
        self.work.vms.append(vm)
        if kind == "saas":
            self.work.endpoints.setdefault(customer, [])
            self.work.endpoints[customer].append(vm.vm_id)
            self._ep_servers.setdefault(customer, [])
        heapq.heappush(self._pending, (arrival_h, next(self._evseq), vm))
        return vm

    def evict(self, state: ClusterState, server: int) -> VMSpec | None:
        """Immediately remove the VM on ``server`` (fleet drain/migration).

        Releases occupancy and policy state exactly like a departure; the
        VM's scheduled departure event becomes a no-op (guarded by object
        identity).  Returns the evicted ``VMSpec`` so the fleet can
        re-inject it elsewhere, or None when the server is empty."""
        vm = self._vm_on.pop(server, None)
        if vm is None:
            return None
        self.alloc_state.release(server)
        if vm.kind == "saas" and server in self._server_ep:
            self._ep_servers[self._server_ep.pop(server)].remove(server)
        self.policy.release(state, server)
        return vm

    def _sync_backends(self, state: ClusterState, changes: list) -> None:
        """Mirror reconfigure decisions onto bound engines and report the
        engines' measured goodput back into the state.

        The resilience machinery runs here too, in a fixed order: land
        the tick's engine faults, run the watchdog (drain unhealthy
        backends onto healthy siblings), walk each degradation ladder,
        then pump.  Fault application precedes the watchdog so a crash
        is detected the same tick it fires."""
        for ch in changes:
            backend = self.backends.get(ch.server)
            if backend is not None:
                backend.apply_config(ch.entry.cfg, paused=ch.reloading)
                self._backends_synced.add(ch.server)
        res = self.resilience
        faults = self.scenario.engine_faults(state.now_h)
        for srv in sorted(self.backends):
            self.backends[srv].apply_faults(
                [f for f in faults if f.server in (None, srv)],
                now_h=state.now_h, tick=state.tick, knobs=res)
        if res.watchdog:
            self._watchdog_tick(state)
        for srv, backend in self.backends.items():
            inst = state.instances.get(srv)
            if srv not in self._backends_synced and inst is not None:
                # first tick after attach: push the server's *current*
                # config — it may have been reconfigured before binding
                backend.apply_config(inst.entry.cfg, paused=inst.paused)
                self._backends_synced.add(srv)
            if inst is not None:
                # track the reload drain: paused while pause_ticks run,
                # admitting again as soon as the configurator's view clears
                backend.engine.knobs.paused = inst.paused
            if res.ladder:
                backend.tick_ladder(state.emergency)
            load = (float(state.saas_load[srv])
                    if state.kind[srv] == 2 else 0.0)
            backend.pump(now=state.now_h, load=load)
        # batched pump: fleet-attached backends only *submitted* demand
        # above; run each distinct fleet's engines once for all of its
        # servers, then read everyone's settled rate
        fleets: list = []
        for backend in self.backends.values():
            fl = getattr(backend, "fleet", None)
            if fl is not None and all(fl is not f for f in fleets):
                fleets.append(fl)
        for fl in fleets:
            fl.flush(now=state.now_h)
        for srv, backend in self.backends.items():
            state.measured_goodput[srv] = backend.measured_goodput()

    def _watchdog_tick(self, state: ClusterState) -> None:
        """Heartbeat sweep: after ``heartbeat_misses`` consecutive missed
        beats a backend is marked unhealthy and its unfinished requests
        (in-flight, queued, backing off) are drained onto healthy sibling
        engines round-robin — re-homed requests keep their identity, so
        the origin's issued-ledger audit still sees their outcome.  With
        no healthy sibling the drained work parks at the watchdog and is
        re-homed the moment a backend recovers.  Recovery clears the
        unhealthy mark; already re-homed requests stay where they are."""
        res = self.resilience
        healthy = [s for s in sorted(self.backends)
                   if self.backends[s].heartbeat()]
        for srv in sorted(self.backends):
            backend = self.backends[srv]
            if backend.heartbeat():
                self._hb_miss[srv] = 0
                self._unhealthy.discard(srv)
                continue
            self._hb_miss[srv] = self._hb_miss.get(srv, 0) + 1
            if self._hb_miss[srv] < res.heartbeat_misses:
                continue
            if srv not in self._unhealthy:
                self._unhealthy.add(srv)
                self.watchdog_drains += 1
            # drain every tick while unhealthy: requests pumped into the
            # dead backend since the last sweep get re-homed too
            reqs = backend.engine.take_unfinished()
            dests = [self.backends[h] for h in healthy if h != srv]
            if not dests:
                self._parked.extend(reqs)
                continue
            for i, req in enumerate(reqs):
                dests[i % len(dests)].adopt([req])
        if self._parked and healthy:
            parked, self._parked = self._parked, []
            dests = [self.backends[h] for h in healthy]
            for i, req in enumerate(parked):
                dests[i % len(dests)].adopt([req])

    def result(self) -> SimResult:
        """Aggregate the ticks simulated so far into a SimResult."""
        if self.tick == 0:
            raise RuntimeError(
                "no ticks simulated yet; call step() or run() first")
        done = self.tick
        # normalize capped-event counts by the true occupied server-ticks
        # (summed per tick — occupancy drifts as VMs arrive and depart)
        occupied_ticks = max(self._occupied_acc, 1)
        return SimResult(
            time_h=self.t_h[:self.tick],
            max_gpu_temp_c=self._max_temp[:self.tick],
            peak_row_power_frac=self._peak_row[:self.tick],
            thermal_events=self._th_events,
            power_events=self._pw_events,
            thermal_capped_frac=self._th_capped / occupied_ticks,
            power_capped_frac=self._pw_capped / occupied_ticks,
            unserved_frac=self._unserved_total / max(self._demand_total, 1e-9),
            mean_quality=self._quality_acc / max(self._quality_w, 1e-9),
            iaas_perf_impact=self._iaas_impact / done,
            saas_perf_impact=self._saas_impact / done,
            row_power_frac=self._row_frac_t[:self.tick],
            energy_kwh=self._energy_kwh,
        )

    def run(self) -> SimResult:
        if self.tick:
            self.reset()
        while self.tick < self.ticks:
            self.step()
        return self.result()


def run_policy(policy: Policy, *, device="cuda", **kw) -> SimResult:
    cfg = SimConfig(policy=policy, **kw)
    return ClusterSim(cfg, device=device).run()
