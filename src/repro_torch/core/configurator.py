"""Instance Configurator — paper §4.3 / §4.5
(port of ``repro.core.configurator``).

Per SaaS VM, pick the config point (freq, TP, batch, size, quant) that
maximizes goodput under the server's current power/temperature caps while
holding quality; reload-requiring moves (TP/size/quant) are last-resort and
pause the instance for the reload duration (requests are steered away
during transitions).  In emergencies a per-endpoint quality budget lets a
bounded fraction of load go to smaller/quantized variants (§5.4: TAPAS
takes up to −12% quality instead of capping performance).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import profiles as P
from repro_torch.core.risk import DEFAULT_THRESHOLDS, ReconfigureThresholds
# no cycle: state.py imports allocator/profiles, never this module
from repro_torch.core.state import ConfigChange, InstanceView


@dataclass
class VMConfigState:
    current: P.ConfigPoint = P.NOMINAL
    pause_ticks: int = 0      # draining during reload

    @property
    def entry(self) -> P.ProfileEntry:
        return P._entry(self.current)


class InstanceConfigurator:
    def __init__(self, *, tick_s: float = 300.0,
                 quality_floor: float = 1.0,
                 emergency_quality_floor: float = 0.85):
        self.entries = P.build_profile()
        self.tick_s = tick_s
        self.quality_floor = quality_floor
        self.emergency_floor = emergency_quality_floor
        self.state: dict[int, VMConfigState] = {}

    def get(self, vm_id: int) -> VMConfigState:
        return self.state.setdefault(vm_id, VMConfigState())

    def tick(self) -> None:
        for st in self.state.values():
            if st.pause_ticks > 0:
                st.pause_ticks -= 1

    def decide(self, vm_id: int, *, power_cap: float, temp_cap: float,
               emergency: bool = False,
               min_goodput: float = 0.0) -> VMConfigState:
        """Update the VM's config for the new caps (fractions of nominal)."""
        st = self.get(vm_id)
        floor = self.emergency_floor if emergency else self.quality_floor
        choice = P.best_config(self.entries, power_cap=power_cap,
                               temp_cap=temp_cap, min_quality=floor,
                               current=st.current,
                               min_goodput=min_goodput if emergency else 0.0)
        if choice is None and emergency:
            # deepest emergency: any quality, minimum power point
            feas = [e for e in self.entries
                    if e.power_frac <= power_cap and e.temp_frac <= temp_cap]
            choice = max(feas, key=lambda e: e.goodput) if feas else None
        if choice is None:
            return st  # nothing fits: capping layer will handle it
        if choice.cfg != st.current:
            if choice.cfg.needs_reload_from(st.current):
                st.pause_ticks = max(
                    1, int(round(choice.cfg.reload_cost_s / self.tick_s)))
            st.current = choice.cfg
        return st

    def reset(self, vm_id: int) -> None:
        self.state.pop(vm_id, None)


class ReconfigurePolicy:
    """``ControlPolicy`` reconfigure/lifecycle adapter over the
    ``InstanceConfigurator``.

    ``begin_tick`` advances reload countdowns and publishes every SaaS
    server's current config into ``state.instances``; ``reconfigure`` runs
    the §4.3 loop — servers whose risk exceeds ``thresholds.hot_risk`` get
    power/temperature caps proportional to their remaining margin, servers
    back under ``thresholds.cool_risk`` are restored to nominal — and
    returns the ``ConfigChange`` list so engine backends can mirror the
    decisions onto real serving engines.  ``active=False`` (Baseline)
    publishes telemetry but never reconfigures.
    """

    def __init__(self, configurator: InstanceConfigurator, *,
                 active: bool,
                 thresholds: ReconfigureThresholds | None = None):
        self.configurator = configurator
        self.active = active
        self.thresholds = thresholds or DEFAULT_THRESHOLDS

    def begin_tick(self, state) -> None:
        self.configurator.tick()
        for srv in np.flatnonzero(state.kind == 2):
            st = self.configurator.get(int(srv))
            state.instances[int(srv)] = InstanceView(
                entry=st.entry, paused=st.pause_ticks > 0)

    def release(self, state, server: int) -> None:
        self.configurator.reset(server)

    def _publish(self, state, srv: int, st: VMConfigState,
                 before: P.ConfigPoint, changes: list) -> None:
        reloading = st.pause_ticks > 0
        state.instances[srv] = InstanceView(entry=st.entry, paused=reloading)
        if st.current != before:
            changes.append(ConfigChange(server=srv, entry=st.entry,
                                        reloading=reloading))

    def reconfigure(self, state) -> list:
        if not self.active:
            return []
        th = self.thresholds
        changes: list = []
        hot = state.risk > th.hot_risk
        for srv in np.flatnonzero((state.kind == 2) & hot):
            margin = 1.0 - state.risk[srv]
            before = self.configurator.get(int(srv)).current
            st = self.configurator.decide(
                int(srv),
                power_cap=max(th.cap_floor, margin + th.hot_risk),
                temp_cap=max(th.cap_floor, margin + th.hot_risk),
                emergency=state.emergency,
                min_goodput=float(state.saas_load[srv])
                * state.nominal.goodput)
            self._publish(state, int(srv), st, before, changes)
        # restore drained servers once their risk clears
        cool = state.risk < th.cool_risk
        for srv in np.flatnonzero((state.kind == 2) & cool):
            st0 = self.configurator.state.get(int(srv))
            if st0 is not None and st0.current != P.NOMINAL:
                before = st0.current
                st = self.configurator.decide(
                    int(srv), power_cap=1.0, temp_cap=th.restore_temp_cap)
                self._publish(state, int(srv), st, before, changes)
        return changes
