"""VM Allocator — paper §4.1 / §4.5: Protean-style rule engine
(port of ``repro.core.allocator``).

Rules, in order:
  1. validator  — filter servers whose aisle's predicted peak airflow or
     row's predicted peak power would violate Eq. 3 / Eq. 4 if the VM landed
     there (history-based peak prediction; peak assumed when history < 1 wk).
  2. preference — IaaS to cooler servers, SaaS to warmer servers (3 equal
     temperature groups: cold / medium / warm).
  3. preference — keep IaaS/SaaS balanced per aisle+row (3 groups:
     IaaS-heavy / SaaS-heavy / balanced).
Final pick: best rule score, seeded-random tie-break.

The *Baseline* allocator (thermal/power-oblivious Protean) picks uniformly
among empty servers.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.datacenter import Datacenter
from repro_torch.core.power import PowerModel
from repro_torch.core.thermal import ThermalModel
from repro_torch.core.traces import VMSpec, predict_peak_util


@dataclass
class AllocatorState:
    """Mutable cluster occupancy view used for placement decisions."""
    dc: Datacenter
    thermal: ThermalModel
    power: PowerModel
    vm_of: np.ndarray        # (S,) vm_id or -1
    kind_of: np.ndarray      # (S,) 0 empty, 1 iaas, 2 saas
    peak_util: np.ndarray    # (S,) predicted per-VM peak util

    @staticmethod
    def empty(dc: Datacenter, thermal: ThermalModel, power: PowerModel):
        s = dc.n_servers
        return AllocatorState(dc, thermal, power,
                              vm_of=np.full(s, -1),
                              kind_of=np.zeros(s, np.int64),
                              peak_util=np.zeros(s))

    def place(self, server: int, vm: VMSpec, peak: float) -> None:
        self.vm_of[server] = vm.vm_id
        self.kind_of[server] = 1 if vm.kind == "iaas" else 2
        self.peak_util[server] = peak

    def release(self, server: int) -> None:
        self.vm_of[server] = -1
        self.kind_of[server] = 0
        self.peak_util[server] = 0.0


class TapasAllocator:
    def __init__(self, *, seed: int = 0, typical_outside: float = 30.0):
        self.rng = np.random.default_rng(seed + 4)
        self.typical_outside = typical_outside

    # -- rule 1: validator --------------------------------------------------
    def _validator(self, st: AllocatorState, peak: float) -> np.ndarray:
        dc, th, pm = st.dc, st.thermal, st.power
        util = st.peak_util  # predicted peaks of current residents
        air_now = np.asarray(th.airflow(util))
        air_now = np.where(st.kind_of > 0, air_now, 0.0)
        aisle_air = dc.aisle_sum(air_now)
        add_air = float(th.airflow(np.asarray([peak]))[0])
        air_ok = (aisle_air + add_air) <= dc.prov_ahu_cfm  # (A,)

        pwr_now = pm.server_power(
            np.repeat(util[:, None], dc.cfg.hw.chips, axis=1)).cpu().numpy()
        pwr_now = np.where(st.kind_of > 0, pwr_now, 0.15 * pwr_now)
        row_pwr = dc.row_sum(pwr_now)
        add_pwr = float(pm.server_power(
            np.full((1, dc.cfg.hw.chips), peak)).cpu().numpy()[0])
        pwr_ok = (row_pwr + add_pwr) <= dc.prov_row_power_w  # (R,)
        return air_ok[dc.aisle_of] & pwr_ok[dc.row_of]

    # -- rule 2: temperature preference --------------------------------------
    def _peak_temp(self, st: AllocatorState, util: float) -> np.ndarray:
        th = st.thermal
        inlet = th.inlet_temp(self.typical_outside, 0.7).cpu().numpy()
        u = np.full((st.dc.n_servers, st.dc.cfg.hw.chips), util)
        return th.gpu_temp(inlet, u).cpu().numpy().max(axis=1)

    def _temp_groups(self, st: AllocatorState) -> np.ndarray:
        """0=cold 1=medium 2=warm thirds by predicted peak GPU temperature."""
        t_peak = self._peak_temp(st, 1.0)
        q1, q2 = np.quantile(t_peak, [1 / 3, 2 / 3])
        return np.digitize(t_peak, [q1, q2])

    # -- rule 3: IaaS/SaaS balance -------------------------------------------
    def _balance_score(self, st: AllocatorState, kind: str) -> np.ndarray:
        dc = st.dc
        iaas = dc.row_sum((st.kind_of == 1).astype(float))
        saas = dc.row_sum((st.kind_of == 2).astype(float))
        total = np.maximum(iaas + saas, 1.0)
        frac_iaas = iaas / total
        # want balanced rows; placing `kind` where it is under-represented
        target = frac_iaas[dc.row_of]
        return (1.0 - target) if kind == "iaas" else target

    def place(self, st: AllocatorState, vm: VMSpec, *, seed: int = 0) -> int | None:
        peak = predict_peak_util(vm, seed=seed)
        empty = st.kind_of == 0
        ok = empty & self._validator(st, peak)
        if not ok.any():
            ok = empty  # validator exhausted: fall back, capping will manage
            if not ok.any():
                return None
        groups = self._temp_groups(st)
        if vm.kind == "iaas":
            temp_score = {0: 1.0, 1: 0.5, 2: 0.0}
            t_sc = np.vectorize(temp_score.get)(groups)
        else:
            # SaaS to warm servers — but ONLY those whose predicted GPU temp
            # at the endpoint's predicted peak load stays under the limit
            # (paper §4.1); unsafe-at-peak servers rank below cold ones
            t_pred = self._peak_temp(st, 0.95 * peak)
            safe = t_pred <= st.thermal.gpu_limit - 1.0
            temp_score = {0: 0.0, 1: 0.5, 2: 1.0}
            t_sc = np.vectorize(temp_score.get)(groups)
            t_sc = np.where(safe, t_sc, -2.0)
        b_sc = self._balance_score(st, vm.kind)
        # spread predicted peak power across rows (the validator's headroom
        # as a preference, not just a filter — smooths the Fig. 10 tail)
        util = np.where(st.kind_of > 0, st.peak_util, 0.0)
        pwr = st.power.server_power(
            np.repeat(util[:, None], st.dc.cfg.hw.chips, axis=1)).cpu().numpy()
        pwr = np.where(st.kind_of > 0, pwr, 0.0)
        row_frac = (st.dc.row_sum(pwr)
                    / np.maximum(st.dc.prov_row_power_w, 1.0))
        p_sc = 1.0 - row_frac[st.dc.row_of]
        score = np.where(ok, 1.5 * t_sc + b_sc + 2.5 * p_sc, -np.inf)
        best = score.max()
        cand = np.flatnonzero(score >= best - 1e-9)
        server = int(self.rng.choice(cand))
        st.place(server, vm, peak)
        return server


class BaselineAllocator:
    """Thermal/power-oblivious placement (traditional Protean, §5.1).

    Protean packs arrivals tightly to preserve large free blocks — which is
    exactly what co-locates same-phase VMs into the same rows and produces
    the heavy-tailed row-power distribution of Fig. 10."""

    def __init__(self, *, seed: int = 0):
        self.rng = np.random.default_rng(seed + 5)

    def place(self, st: AllocatorState, vm: VMSpec, *, seed: int = 0) -> int | None:
        empty = np.flatnonzero(st.kind_of == 0)
        if empty.size == 0:
            return None
        # first-fit with a small window (allocation isn't perfectly serial)
        server = int(self.rng.choice(empty[:4]))
        st.place(server, vm, predict_peak_util(vm, seed=seed))
        return server


class PlacementPolicy:
    """``ControlPolicy.place`` adapter over a Baseline/Tapas allocator.

    Reads occupancy from ``state.alloc`` (which the wrapped allocator
    mutates on a successful placement) and the workload seed from
    ``state.seed``; everything else about the decision lives in the
    wrapped rule engine.
    """

    def __init__(self, allocator):
        self.allocator = allocator

    def place(self, state, vm: VMSpec) -> int | None:
        return self.allocator.place(state.alloc, vm, seed=state.seed)
