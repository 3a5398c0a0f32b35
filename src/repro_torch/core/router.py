"""Request Router — paper §4.2 / §4.5 Load Balancer
(port of ``repro.core.router``).

Per endpoint and per tick, distribute the endpoint's demanded load across
its VMs:

  filter   — drop VMs that would trip (a) aisle airflow, (b) row power, or
             (c) server GPU-temperature risk (Eq. 2 forecast at the load
             they'd receive);
  affinity — keep customer shares where they already ran (KV-cache reuse);
  pack     — concentrate load on fewest VMs (energy);
  spread   — distribute the remainder for performance.

The Baseline router splits load uniformly across the endpoint's VMs.
Loads are in "nominal-VM units" (1.0 == one VM fully busy at nominal
config); per-VM capacity comes from the instance's current config.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# no cycle: state.py imports allocator/profiles, never this module
from repro_torch.core.state import EndpointRoute


@dataclass
class RouteDecision:
    load: np.ndarray          # (n_vms,) assigned load
    unserved: float           # demand that found no headroom (queued)


class BaselineRouter:
    def route(self, demand: float, capacity: np.ndarray, risk: np.ndarray,
              affinity: np.ndarray | None = None,
              ids: np.ndarray | None = None) -> RouteDecision:
        n = len(capacity)
        if n == 0:
            return RouteDecision(np.zeros(0), demand)
        load = np.full(n, demand / n)
        over = np.maximum(load - capacity, 0.0).sum()
        return RouteDecision(np.minimum(load, capacity), over)


class TapasRouter:
    """risk: (n_vms,) in [0,1] — probability the VM's server/row/aisle trips
    a limit if given more load (computed by the simulator from Eqs. 1–4);
    VMs with risk >= threshold are filtered (paper: 'high risk')."""

    def __init__(self, *, risk_threshold: float = 0.5, pack: bool = True):
        self.risk_threshold = risk_threshold
        self.pack = pack

    def route(self, demand: float, capacity: np.ndarray, risk: np.ndarray,
              affinity: np.ndarray | None = None,
              ids: np.ndarray | None = None) -> RouteDecision:
        """``ids`` (server ids, positional) breaks packing-order ties:
        candidates equal on (risk, load) fill lowest-id first, so results
        do not depend on the endpoint list's historical insertion order."""
        n = len(capacity)
        if n == 0:
            return RouteDecision(np.zeros(0), demand)
        ids = np.arange(n) if ids is None else np.asarray(ids)
        usable = risk < self.risk_threshold
        cap = np.where(usable, capacity, 0.0)
        load = np.zeros(n)
        remaining = demand

        # 1) affinity: hold the conversation-reuse share in place where safe
        # (most traffic reuses KV state; a quarter is free to move per tick,
        # which also damps tick-to-tick reassignment oscillation)
        if affinity is not None:
            keep = 0.75 * np.minimum(affinity, cap)
            keep = keep * min(1.0, remaining / max(keep.sum(), 1e-9))
            load += keep
            remaining -= keep.sum()

        headroom = cap - load
        if remaining > 1e-12 and headroom.sum() > 0:
            # 2) energy packing only while the endpoint runs light — at high
            # load concentration trades directly against peak row power
            if self.pack and demand < 0.4 * max(cap.sum(), 1e-9):
                order = np.lexsort((ids, -load, risk))
                for i in order:
                    take = min(headroom[i], remaining)
                    load[i] += take
                    remaining -= take
                    if remaining <= 1e-12:
                        break
            else:
                # 3-pre) risk-weighted spread: cooler rows take more
                w = headroom * np.square(1.0 - np.minimum(risk, 1.0))
                if w.sum() <= 1e-12:
                    w = headroom
                share = np.minimum(w / w.sum() * remaining, headroom)
                load += share
                remaining = max(demand - load.sum(), 0.0)

        # 3) spread overflow across *all* VMs (perf beats risk if queueing)
        if remaining > 1e-9:
            headroom_all = capacity - load
            pos = headroom_all > 1e-12
            if pos.any():
                share = np.where(pos, headroom_all, 0.0)
                share = share / share.sum() * min(remaining, share.sum())
                load += share
                remaining -= share.sum()
        return RouteDecision(load, max(remaining, 0.0))


class RoutingPolicy:
    """``ControlPolicy.route`` adapter over a Baseline/Tapas router.

    Owns the per-endpoint affinity memory (KV-cache reuse shares) and the
    translation from ``ClusterState`` telemetry to per-server capacities:
    a paused (reloading) instance serves nothing; otherwise capacity is the
    instance's goodput fraction times its frequency cap, and a
    thermal-aware router additionally ceilings each server at the Eq. 2
    load limit (``state.u_max``) so energy-packing can never push a server
    past its thermal cap.
    """

    def __init__(self, router, *, thermal_aware: bool):
        self.router = router
        self.thermal_aware = thermal_aware
        self._affinity: dict = {}

    def route(self, state, endpoint: str, demand: float) -> EndpointRoute:
        idx = np.asarray(state.endpoints[endpoint])
        caps, quals = [], []
        for srv in idx:
            inst = state.instances[int(srv)]
            e = inst.entry
            cap = (0.0 if inst.paused else
                   (e.goodput / state.nominal.goodput) * state.freq_cap[srv])
            if self.thermal_aware and cap > 0:
                busy_max = min(state.u_max[srv] / max(e.temp_frac, 1e-6), 1.0)
                cap *= busy_max
            caps.append(cap)
            quals.append(e.quality)
        caps = np.asarray(caps)
        # affinity shares are positional, so they are only valid while the
        # endpoint's server membership is unchanged — any churn (not just a
        # size change) resets them, else a departed server's KV-reuse share
        # would pin load onto an unrelated replacement
        prev = self._affinity.get(endpoint)
        if prev is not None and np.array_equal(prev[0], idx):
            aff = prev[1]
        else:
            aff = np.zeros(len(idx))
        dec = self.router.route(demand, caps, state.risk[idx], aff, ids=idx)
        self._affinity[endpoint] = (idx, dec.load.copy())
        return EndpointRoute(servers=idx, load=dec.load,
                             quality=np.asarray(quals),
                             unserved=dec.unserved)
