"""Thermal models — paper §2.1, Eqs. (1)–(3) — as float32 torch tensors on
one device (port of ``repro.core.thermal``).

Eq. 1  T_inlet[s] = f_s(T_outside, Load_DC): piecewise in outside temp
       (flat >= 18 °C floor below 15 °C to limit humidity, linear 15–25 °C,
       compressed above 25 °C when mechanical assist kicks in) plus a
       load-dependent offset (Fig. 5: ~2 °C between idle and full DC load)
       and static spatial offsets (rows up to ~1 °C, racks up to ~2 °C,
       height minor — Fig. 4).

Eq. 2  T_gpu[s,g] = T_inlet[s] + alpha[s,g] * util + beta[s,g]: linear
       regression per chip (paper MAE < 1 °C), with per-chip heterogeneity
       up to ~10 °C inside one server; even-indexed chips run cooler
       (server layout, Fig. 8/9).

Eq. 3  f_air(util): linear fan curve between idle and max CFM; the aisle
       constraint is sum(f_air) <= ProvAHU.

The reference runs these in ``jnp`` with x64 off, so every coefficient and
every input is float32 there; here each is cast to float32 explicitly
(``torch.as_tensor`` would keep numpy's float64).  The methods take numpy
arrays, Python scalars or tensors and return float32 tensors on the
model's device; callers read them back with ``.cpu().numpy()``.
``airflow`` stays plain arithmetic, as in the reference, where numpy
inputs never reach ``jnp``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.datacenter import Datacenter

REGION_OUTSIDE = {  # (mean °C, daily amplitude °C)
    "hot": (28.0, 7.0),
    "mild": (20.0, 7.0),
    "cold": (10.0, 6.0),
}


def f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``: what ``jnp.asarray`` makes
    of a numpy array or Python scalar with x64 off (float64 rounds to
    nearest float32)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by true division on every device.  CUDA divides a tensor
    by a Python scalar as ``x * (1 / c)``, which rounds differently; a
    0-d device tensor keeps the division the reference's."""
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


@dataclass
class ThermalModel:
    """Per-server / per-chip regression coefficients (seeded 'calibration')."""
    inlet_base: torch.Tensor      # (S,) °C at the 18 °C floor
    inlet_slope: torch.Tensor     # (S,) °C per outside °C in [15, 25]
    inlet_hot_slope: torch.Tensor  # (S,) compressed slope above 25 °C
    load_coeff: torch.Tensor      # (S,) °C at full DC load (Fig. 5: ~2)
    gpu_alpha: torch.Tensor       # (S, 8) °C per unit chip util
    gpu_beta: torch.Tensor        # (S, 8) static offset
    airflow_idle_cfm: float
    airflow_max_cfm: float
    gpu_limit: float

    @property
    def device(self) -> torch.device:
        return self.inlet_base.device

    # ------------------------------------------------------------------
    @staticmethod
    def calibrate(dc: Datacenter, *, device="cuda") -> "ThermalModel":
        cfg = dc.cfg
        rng = np.random.default_rng(cfg.seed + 1)
        s = dc.n_servers
        # spatial heterogeneity (Fig. 4): row up to 1 °C, rack up to 2 °C,
        # height within rack minor (0.3 °C); ends of some rows warmer
        row_off = rng.uniform(0.0, 1.0, dc.n_rows)[dc.row_of]
        rack_off = rng.uniform(0.0, 2.0, (dc.n_rows, cfg.racks_per_row))[
            dc.row_of, dc.rack_of]
        height_off = 0.3 * dc.height_of / max(cfg.servers_per_rack - 1, 1)
        inlet_base = 18.0 + row_off + rack_off + height_off
        inlet_slope = rng.uniform(0.75, 0.95, s)   # Fig. 3 regression band
        hot_slope = inlet_slope * rng.uniform(0.45, 0.6, s)
        load_coeff = rng.uniform(1.6, 2.4, s)      # Fig. 5: ~2 °C idle->full

        # per-chip (Eq. 2): even-indexed chips cooler; process variation
        # (Fig. 9: >20 °C spread across a DC, ~10 °C inside one server)
        g = cfg.hw.chips
        layout = np.where(np.arange(g) % 2 == 0, -3.0, 3.0)  # Fig. 9
        proc = rng.normal(0.0, 2.5, (s, g))
        # server-level component (heatsink/airflow lottery) is what makes
        # placement matter; chip-level variation adds the Fig. 9 spread
        server_off = rng.normal(0.0, 4.5, (s, 1))
        gpu_alpha = (35.0 + server_off + rng.normal(0.0, 3.0, (s, g))
                     + layout)  # °C @ util=1
        gpu_beta = 6.0 + proc
        return ThermalModel(
            inlet_base=f32(inlet_base, device),
            inlet_slope=f32(inlet_slope, device),
            inlet_hot_slope=f32(hot_slope, device),
            load_coeff=f32(load_coeff, device),
            gpu_alpha=f32(gpu_alpha, device),
            gpu_beta=f32(gpu_beta, device),
            airflow_idle_cfm=cfg.hw.airflow_idle_cfm,
            airflow_max_cfm=cfg.hw.airflow_max_cfm,
            gpu_limit=cfg.hw.gpu_temp_limit_c,
        )

    # ------------------------------------------------------------------
    def inlet_temp(self, t_outside, dc_load, *, cooling_derate: float = 0.0):
        """Eq. 1. t_outside: scalar °C; dc_load: scalar in [0,1].

        ``cooling_derate``: extra °C from a datacenter cooling-device
        failure (§2.1 Failures / §5.4)."""
        t = f32(t_outside, self.device)
        warm = torch.clamp(t - 15.0, 0.0, 10.0) * self.inlet_slope
        hot = torch.clamp(t - 25.0, min=0.0) * self.inlet_hot_slope
        return (self.inlet_base + warm + hot
                + self.load_coeff * f32(dc_load, self.device)
                + cooling_derate)

    def gpu_temp(self, t_inlet, chip_util):
        """Eq. 2. t_inlet: (S,); chip_util: (S, 8) in [0,1] -> (S, 8) °C."""
        return (f32(t_inlet, self.device)[:, None]
                + self.gpu_alpha * f32(chip_util, self.device)
                + self.gpu_beta)

    def airflow(self, server_util):
        """Eq. 3 LHS. server_util: (S,) mean chip util -> CFM (S,)."""
        return (self.airflow_idle_cfm
                + (self.airflow_max_cfm - self.airflow_idle_cfm) * server_util)

    def max_util_for_temp(self, t_inlet, t_limit):
        """Invert Eq. 2: hottest-chip util cap to stay below t_limit."""
        worst = self.gpu_alpha.max(dim=1).values
        worst_beta = self.gpu_beta.max(dim=1).values
        head = t_limit - f32(t_inlet, self.device) - worst_beta
        return torch.clamp(head / worst, 0.0, 1.0)


def outside_temperature(region: str, t_hours, *, seed: int = 0,
                        device="cuda"):
    """Diurnal outside temperature trace (°C) for t in hours."""
    mean, amp = REGION_OUTSIDE[region]
    t = f32(t_hours, device)
    base = mean + amp * torch.sin(divide(2 * math.pi * (t - 9.0), 24.0))
    wob = 1.5 * torch.sin(divide(2 * math.pi * t, 24.0 * 6.3) + seed)
    return base + wob
