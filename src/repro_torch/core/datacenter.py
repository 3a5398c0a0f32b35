"""Datacenter topology + provisioning (paper §2, Fig. 1)
(port of ``repro.core.datacenter``).

Rows of racks of 8-chip servers; an aisle = two adjacent rows sharing AHUs
and a contained cold aisle.  Power: three-level hierarchy abstracted to the
row envelope (Eq. 4) — the paper's management granularity; UPS redundancy
is 4N/3 (failure => 75% capacity), AHU N+1 per aisle (failure => reduced
aisle airflow).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np


@dataclass(frozen=True)
class HWProfile:
    """Per-server (8-chip tray) envelope — A100-class by default."""
    name: str = "a100"
    chips: int = 8
    idle_power_w: float = 1500.0
    peak_power_w: float = 6500.0
    airflow_idle_cfm: float = 300.0
    airflow_max_cfm: float = 1105.0   # paper: 840/1105 CFM @ 80% PWM A100/H100
    gpu_temp_limit_c: float = 85.0    # thermal throttling threshold
    mem_temp_limit_c: float = 95.0


@dataclass(frozen=True)
class DCConfig:
    n_rows: int = 8
    racks_per_row: int = 10
    servers_per_rack: int = 4
    hw: HWProfile = field(default_factory=HWProfile)
    seed: int = 0
    # provisioning headroom over nominal peak (1.0 = exactly peak-provisioned)
    power_headroom: float = 1.0
    airflow_headroom: float = 1.0
    # operators provision to the *observed* peak, not nameplate TDP
    # (paper §2.2 / Fig. 19: baseline rows run near 1.0 of provisioned)
    power_provision_frac: float = 0.88
    airflow_provision_frac: float = 0.94
    ahus_per_aisle: int = 4           # N+1 redundant
    region: str = "hot"               # hot | mild | cold

    @property
    def n_servers(self) -> int:
        return self.n_rows * self.racks_per_row * self.servers_per_rack

    @property
    def n_aisles(self) -> int:
        return (self.n_rows + 1) // 2


class Datacenter:
    """Static topology arrays + provisioned limits."""

    def __init__(self, cfg: DCConfig):
        self.cfg = cfg
        s = cfg.n_servers
        idx = np.arange(s)
        per_row = cfg.racks_per_row * cfg.servers_per_rack
        self.row_of = idx // per_row                      # (S,)
        self.aisle_of = self.row_of // 2                  # (S,)
        self.rack_of = (idx % per_row) // cfg.servers_per_rack
        self.height_of = idx % cfg.servers_per_rack       # position in rack
        self.n_servers = s
        self.n_rows = cfg.n_rows
        self.n_aisles = cfg.n_aisles

        # provisioned limits: observed peak demand at full occupancy (Eqs. 3, 4)
        servers_per_aisle = np.bincount(self.aisle_of, minlength=self.n_aisles)
        self.prov_ahu_cfm = (servers_per_aisle * cfg.hw.airflow_max_cfm
                             * cfg.airflow_provision_frac
                             * cfg.airflow_headroom)      # (A,)
        servers_per_row = np.bincount(self.row_of, minlength=self.n_rows)
        self.prov_row_power_w = (servers_per_row * cfg.hw.peak_power_w
                                 * cfg.power_provision_frac
                                 * cfg.power_headroom)    # (R,)

    def row_sum(self, per_server: np.ndarray) -> np.ndarray:
        return np.bincount(self.row_of, weights=per_server,
                           minlength=self.n_rows)

    def aisle_sum(self, per_server: np.ndarray) -> np.ndarray:
        return np.bincount(self.aisle_of, weights=per_server,
                           minlength=self.n_aisles)


def scale_datacenter(cfg: DCConfig, oversub: float) -> DCConfig:
    """Add racks into existing rows (paper §4.4): +oversub fraction servers
    without changing provisioned cooling/power (they were sized for the
    original occupancy).  ``dataclasses.replace`` keeps the copy total —
    the hand-rolled field list here once dropped the provision fractions
    (tapaslint TL004)."""
    extra = int(round(cfg.racks_per_row * oversub))
    shrink = cfg.racks_per_row / (cfg.racks_per_row + extra)
    return replace(
        cfg,
        racks_per_row=cfg.racks_per_row + extra,
        power_headroom=cfg.power_headroom * shrink,
        airflow_headroom=cfg.airflow_headroom * shrink,
    )
