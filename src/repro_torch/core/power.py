"""Power models — paper §2.2, Eq. (4) — as float32 torch tensors on one
device (port of ``repro.core.power``).

Server power is a polynomial in chip utilization (idle draw is significant;
fans/CPU/memory follow load — §2.2), aggregated to rows against the
provisioned row envelope.  Capping scales chip frequency (=> util) down
until the row fits, mirroring hardware power capping.

As in ``core.thermal``, every coefficient and input is cast to float32
explicitly (the reference's ``jnp`` with x64 off).  The per-server mean
over chips sums the chips one after another, the order XLA's CPU
reduction takes, so the card, the CPU and the reference round alike;
``row_power`` is the reference's float32 one-hot matmul, whose summation
order is the BLAS's (within 1e-5 relative of the reference).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.datacenter import Datacenter
from repro_torch.core.thermal import f32


@dataclass
class PowerModel:
    idle_w: torch.Tensor        # (S,)
    dyn_w: torch.Tensor         # (S,) peak-idle
    quad_frac: torch.Tensor     # (S,) fraction of dynamic power that is ~util^2
    fan_w: torch.Tensor         # (S,) fan power at full airflow

    @property
    def device(self) -> torch.device:
        return self.idle_w.device

    @staticmethod
    def calibrate(dc: Datacenter, *, device="cuda") -> "PowerModel":
        cfg = dc.cfg
        rng = np.random.default_rng(cfg.seed + 2)
        s = dc.n_servers
        idle = cfg.hw.idle_power_w * rng.uniform(0.95, 1.05, s)
        fan = 0.06 * cfg.hw.peak_power_w * np.ones(s)
        dyn = (cfg.hw.peak_power_w - idle - fan) * rng.uniform(0.97, 1.03, s)
        quad = rng.uniform(0.3, 0.45, s)
        return PowerModel(f32(idle, device), f32(dyn, device),
                          f32(quad, device), f32(fan, device))

    def server_power(self, chip_util):
        """chip_util: (S, 8) in [0,1] -> watts (S,). Polynomial f_power."""
        c = f32(chip_util, self.device)
        u = c[:, 0]
        for g in range(1, c.shape[1]):
            u = u + c[:, g]
        u = u / c.shape[1]
        dyn = self.dyn_w * ((1 - self.quad_frac) * u + self.quad_frac * u * u)
        return self.idle_w + dyn + self.fan_w * u

    def max_util_for_power(self, budget_w):
        """Invert server_power: mean-util cap under a per-server budget."""
        a = self.quad_frac * self.dyn_w
        b = (1 - self.quad_frac) * self.dyn_w + self.fan_w
        c = self.idle_w - f32(budget_w, self.device)
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        u = (-b + torch.sqrt(disc)) / (2 * a)
        return torch.clamp(u, 0.0, 1.0)


def row_power(dc: Datacenter, power_s) -> torch.Tensor:
    """Eq. 4 LHS: per-row aggregate watts."""
    p = f32(power_s, power_s.device if torch.is_tensor(power_s) else "cpu")
    row = torch.nn.functional.one_hot(
        torch.as_tensor(dc.row_of, device=p.device), dc.n_rows).to(p.dtype)
    return p @ row


def capping_factors(dc: Datacenter, power_s, limits_w, pm: PowerModel,
                    *, iaas_only_mask=None):
    """Rows over budget -> per-server frequency (util) scale factors.

    Baseline semantics (§5.4): uniform scaling across the row's servers
    (optionally restricted to a mask, e.g. IaaS-only last-resort capping).
    Returns (S,) multiplicative util factors in (0, 1]."""
    dev = pm.device
    p_srv = f32(power_s, dev)
    p_row = row_power(dc, p_srv)
    limits = f32(limits_w, dev)
    over = torch.clamp(p_row / torch.clamp(limits, min=1.0), min=1.0)  # (R,)
    # dynamic power is roughly linear in util at high load: cut utilization
    # by the row overshoot applied to the dynamic fraction
    dyn_frac = torch.clamp((p_srv - pm.idle_w)
                           / torch.clamp(p_srv, min=1.0), 0.05, 1.0)
    row_over = over[torch.as_tensor(dc.row_of, device=dev)]
    needed_cut = (row_over - 1.0) / row_over  # fraction of row power to shed
    cut = needed_cut / dyn_frac
    if iaas_only_mask is not None:
        cut = torch.where(torch.as_tensor(np.asarray(iaas_only_mask),
                                          device=dev), cut, 0.0)
    return torch.clamp(1.0 - cut, 0.05, 1.0)
