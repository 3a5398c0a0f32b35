"""Typed control-plane protocol: ``ClusterState`` + ``ControlPolicy``
(port of ``repro.core.state``).

The TAPAS contribution is a control plane — placement, routing, instance
reconfiguration — reacting to thermal/power telemetry every tick.  This
module defines the API between the datacenter simulation (physics, traces,
events) and that control plane:

* ``ClusterState`` is the per-tick telemetry snapshot handed to policies:
  per-server occupancy / utilization / frequency caps / violation risk /
  instance configs, per-row and per-aisle provisioned envelopes after
  failure derates, and the endpoint → server map.
* ``ControlPolicy`` is the protocol a policy object implements.  The three
  decision hooks mirror the paper's three subsystems —
  ``place(state, vm)`` (§4.1 allocator), ``route(state, endpoint, demand)``
  (§4.2 load balancer) and ``reconfigure(state)`` (§4.3 instance
  configurator) — plus two lifecycle hooks (``begin_tick``, ``release``)
  for per-tick bookkeeping and VM departures.

``ClusterSim`` drives any ``ControlPolicy`` tick-by-tick; the bundled
Baseline/TAPAS implementations are adapters over the pre-existing
allocator/router/configurator classes (see ``core.simulator``), and custom
policies plug in through ``SimConfig(control=...)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core import profiles as P
from repro_torch.core.allocator import AllocatorState
from repro_torch.core.datacenter import Datacenter
from repro_torch.core.traces import VMSpec


@dataclass
class InstanceView:
    """A SaaS server's current instance configuration, as telemetry."""
    entry: P.ProfileEntry      # profile row of the active ConfigPoint
    paused: bool               # draining through a reload (§4.3)


@dataclass
class EndpointRoute:
    """One endpoint's routing decision for a tick."""
    servers: np.ndarray        # (n,) server ids, endpoint order
    load: np.ndarray           # (n,) assigned load, nominal-VM units
    quality: np.ndarray        # (n,) quality of each server's config
    unserved: float            # demand that found no headroom (queued)


@dataclass
class ConfigChange:
    """A reconfiguration decision applied to one SaaS server this tick."""
    server: int
    entry: P.ProfileEntry      # the newly active profile row
    reloading: bool            # True when the move costs a reload pause


@dataclass
class ClusterState:
    """Per-tick cluster telemetry snapshot (the policies' world view).

    Filled in phases as the tick progresses: occupancy and scenario state
    exist before arrivals are placed; utilization/risk/instance telemetry
    before routing; ``saas_load`` after routing; post-physics measurements
    (``max_gpu_temp_c``, ``row_power_frac``, throttle masks) after
    ``apply``.  Arrays are live views, not copies — policies must treat
    them as read-only.
    """
    # -- clock / identity --------------------------------------------------
    tick: int
    now_h: float
    t_outside_c: float
    seed: int
    dc: Datacenter
    nominal: P.ProfileEntry            # the nominal instance profile row

    # -- occupancy ---------------------------------------------------------
    alloc: AllocatorState              # mutable occupancy view (placement)
    kind: np.ndarray                   # (S,) 0 empty / 1 iaas / 2 saas
    vm_of: np.ndarray                  # (S,) resident vm_id or -1
    endpoints: dict                    # endpoint -> [server ids]

    # -- scenario / failure state -----------------------------------------
    emergency: bool
    ahu_derate: np.ndarray             # (A,) airflow derate factors
    ups_derate: np.ndarray             # (R,) power derate factors
    cooling_extra_c: float             # inlet offset from cooling failures
    prov_row_power_w: np.ndarray       # (R,) envelope after derates
    prov_aisle_cfm: np.ndarray         # (A,) envelope after derates

    # -- fleet identity ----------------------------------------------------
    region: str = ""                   # region name inside a FleetSim ("" ==
    #                                    standalone single-cluster run)

    # -- telemetry (filled by observe) ------------------------------------
    iaas_util: np.ndarray = None       # (S,) IaaS trace utilization
    freq_cap: np.ndarray = None        # (S,) persistent power-cap state
    last_util: np.ndarray = None       # (S,) previous-tick mean chip util
    inlet_est: np.ndarray = None       # (S,) Eq. 1 inlet estimate
    risk: np.ndarray = None            # (S,) Eq. 1-4 violation risk
    u_max: np.ndarray = None           # (S,) Eq. 2 thermal load ceiling
    telemetry_age_ticks: int = 0       # ticks since inlet_est/risk/u_max
    #                                    were live (> 0 under SensorDropout:
    #                                    the values are a frozen last-known-
    #                                    good snapshot, risk staleness-bumped)
    instances: dict = field(default_factory=dict)  # server -> InstanceView

    # -- routing outcome (filled during the route phase) ------------------
    saas_load: np.ndarray = None       # (S,) routed load, nominal-VM units
    quality: np.ndarray = None         # (S,) served quality per server

    # -- engine-in-the-loop telemetry -------------------------------------
    measured_goodput: dict = field(default_factory=dict)  # server -> tok/s

    # -- post-physics measurements (filled by apply) ----------------------
    max_gpu_temp_c: float = 0.0
    row_power_frac: np.ndarray = None  # (R,) row power / provisioned
    thermal_throttled: np.ndarray = None  # (S,) bool, in-tick hardware clamp
    power_over_rows: np.ndarray = None    # (R,) bool, over the envelope

    @property
    def occupied(self) -> np.ndarray:
        return self.kind > 0


@runtime_checkable
class ControlPolicy(Protocol):
    """The control-plane contract ``ClusterSim`` drives every tick.

    Hooks run in tick order: ``place``/``release`` during the
    arrival/departure phase, ``begin_tick`` before telemetry is observed,
    ``route`` once per endpoint, ``reconfigure`` once after routing.
    Stateful policies (affinity memory, configurator state, RNG) should be
    freshly constructed per run.
    """

    def begin_tick(self, state: ClusterState) -> None:
        """Per-tick bookkeeping before telemetry observation: advance
        reload countdowns and publish ``state.instances`` views."""
        ...

    def place(self, state: ClusterState, vm: VMSpec) -> int | None:
        """Pick a server for an arriving VM (and record it in
        ``state.alloc``), or return None to reject the arrival."""
        ...

    def route(self, state: ClusterState, endpoint: str,
              demand: float) -> EndpointRoute:
        """Distribute ``demand`` across ``state.endpoints[endpoint]``."""
        ...

    def reconfigure(self, state: ClusterState) -> list:
        """Adjust SaaS instance configurations for the observed risk and
        return the ``ConfigChange`` list applied this tick.  The simulator
        folds the returned changes into ``state.instances`` (so they reach
        the physics and any bound engine backends); policies do not need
        to mutate ``state.instances`` themselves."""
        ...

    def release(self, state: ClusterState, server: int) -> None:
        """A VM departed ``server``; drop any per-instance state."""
        ...
