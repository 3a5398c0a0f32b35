"""Shared risk scoring for the control plane (paper §4.2, Eqs. 1–4)
(port of ``repro.core.risk``).

Every TAPAS policy reasons about the same quantity: the probability that a
server — or the row/aisle it lives in — trips a thermal or power limit if
it is handed more load.  This module owns that computation and the named
knobs behind it, so the simulator, the router, the reconfiguration policy,
and any external driver all score risk identically instead of each carrying
private copies of the constants.

``server_risk`` is the Eq. 1–4 forecast previously buried in
``ClusterSim._risk``; ``RiskKnobs`` names its magic numbers.
``ReconfigureThresholds`` names the inline 0.45/0.25 thresholds the
instance-configuration loop used to hardcode.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.datacenter import Datacenter
from repro_torch.core.power import PowerModel
from repro_torch.core.thermal import ThermalModel


@dataclass(frozen=True)
class RiskKnobs:
    """Named parameters of the Eq. 1–4 violation-risk forecast."""

    #: utilization increase probed when forecasting temperature — the paper
    #: routes on *violation risk* at moderately increased load, not the
    #: full-load worst case (which would mark nearly every warm server risky
    #: and starve routing).
    probe_util_delta: float = 0.35
    #: softness (°C) of the sigmoid mapping forecast GPU temperature
    #: overshoot into [0, 1] risk.
    temp_softness_c: float = 2.0
    #: row power fraction above the fleet mean that saturates the relative
    #: balancing term — above-average rows repel load long before the
    #: envelope (§4.2 Row).
    row_balance_band: float = 0.25
    #: weight of the relative balancing term vs the hard near-limit ramp.
    row_balance_weight: float = 0.7
    #: row power fraction where the hard ramp toward the envelope engages.
    row_near_limit_start: float = 0.85
    #: width of that hard ramp (risk hits 1.0 at start + width).
    row_near_limit_width: float = 0.15
    #: aisle airflow headroom (fraction of max per-server CFM) below which
    #: airflow risk starts accruing.
    air_headroom_margin: float = 0.8


@dataclass(frozen=True)
class ReconfigureThresholds:
    """Named thresholds of the §4.3 instance-reconfiguration loop."""

    #: risk above which a SaaS instance is reconfigured down.  The value is
    #: also reused as the cap offset — ``cap = max(cap_floor, (1 - risk) +
    #: hot_risk)`` — so a server exactly at the threshold keeps cap ≈ 1.0
    #: and caps deepen smoothly as risk rises past it.
    hot_risk: float = 0.45
    #: risk below which a previously drained instance is restored to the
    #: nominal configuration.
    cool_risk: float = 0.25
    #: lowest power/temperature cap ever handed to the configurator; below
    #: this the row-capping layer takes over.
    cap_floor: float = 0.6
    #: temperature cap used when restoring a cooled instance (1.35 == the
    #: profile table's hottest-chip ceiling, i.e. "no temperature cap").
    restore_temp_cap: float = 1.35


DEFAULT_RISK_KNOBS = RiskKnobs()
DEFAULT_THRESHOLDS = ReconfigureThresholds()


def server_risk(dc: Datacenter, thermal: ThermalModel, power: PowerModel, *,
                inlet: np.ndarray, prov_row_power_w: np.ndarray,
                prov_aisle_cfm: np.ndarray, util: np.ndarray,
                kind: np.ndarray,
                knobs: RiskKnobs = DEFAULT_RISK_KNOBS) -> np.ndarray:
    """Per-server violation risk in [0, 1] from the Eq. 1–4 forecasts.

    ``inlet``: (S,) estimated inlet temperature; ``prov_row_power_w`` /
    ``prov_aisle_cfm``: provisioned envelopes *after* failure derates;
    ``util``: (S,) current utilization estimate; ``kind``: (S,) occupancy
    (0 empty, 1 IaaS, 2 SaaS).
    """
    th, pm = thermal, power
    chips = dc.cfg.hw.chips
    # server-level: temperature forecast at moderately increased load
    probe = np.clip(util + knobs.probe_util_delta, 0.0, 1.0)
    t_probe = th.gpu_temp(
        inlet, np.repeat(probe[:, None], chips, axis=1)).cpu().numpy().max(axis=1)
    t_risk = 1.0 / (1.0 + np.exp(-(t_probe - th.gpu_limit)
                                 / knobs.temp_softness_c))
    # row-level: graded power risk — engages well before the envelope so
    # packing prefers cold rows and hot rows shed SaaS load (§4.2 Row)
    pwr = pm.server_power(
        np.repeat(util[:, None], chips, axis=1)).cpu().numpy()
    pwr = np.where(kind > 0, pwr, 0.0)
    rowp = dc.row_sum(pwr)
    row_frac = rowp / np.maximum(prov_row_power_w, 1.0)
    rel = np.clip((row_frac - row_frac.mean()) / knobs.row_balance_band,
                  0.0, 1.0)
    near = np.clip((row_frac - knobs.row_near_limit_start)
                   / knobs.row_near_limit_width, 0.0, 1.0)
    p_risk = np.maximum(rel * knobs.row_balance_weight, near)[dc.row_of]
    # aisle airflow headroom
    air = np.asarray(th.airflow(util))
    a_air = dc.aisle_sum(np.where(kind > 0, air, 0.0))
    n_per_aisle = dc.aisle_sum((kind > 0).astype(float))
    a_head = (prov_aisle_cfm - a_air) / np.maximum(
        n_per_aisle * th.airflow_max_cfm, 1.0)
    a_risk = np.clip(knobs.air_headroom_margin - a_head, 0.0, 1.0)[dc.aisle_of]
    return np.maximum.reduce([t_risk, p_risk, a_risk])


def energy_cost_index(price: float, carbon: float, *,
                      carbon_weight: float = 0.5) -> float:
    """One scalar "how expensive is a kWh served here right now".

    Blends the region's effective power price (relative $/kWh, shocks
    applied) with its instantaneous grid carbon intensity (relative,
    1.0 == fleet mean) — both ~1.0-centered, so the blend stays comparable
    across weights.  ``carbon_weight`` 0 prices money only, 1 prices
    carbon only.  The fleet router minimizes this index when regions are
    thermally equivalent; the fleet accounting integrates it over served
    energy.
    """
    if not 0.0 <= carbon_weight <= 1.0:
        raise ValueError(
            f"carbon_weight must be in [0, 1], got {carbon_weight}")
    return (1.0 - carbon_weight) * price + carbon_weight * carbon


def thermally_comparable(risk_origin: float, risk_dest: float, *,
                         band: float, threshold: float) -> bool:
    """True when steering load origin -> dest is thermally a wash: the
    destination sits below the steering ``threshold`` and is no more than
    ``band`` riskier than the origin.  Cost-chasing is only allowed inside
    this band — outside it, thermal steering (cooler regions only) owns
    the decision."""
    return (risk_dest < threshold
            and risk_dest - risk_origin <= band)


def region_risk(risk: np.ndarray, kind: np.ndarray, *,
                quantile: float = 0.8) -> float:
    """Lift per-server violation risk to one regional score in [0, 1].

    The fleet router reasons about regions the way ``server_risk`` lets the
    cluster router reason about servers: "how likely is this region to trip
    a limit if handed more load".  A high quantile of the occupied servers'
    risk (not the mean) is what matters — steering decisions are driven by
    the hot tail that will throttle first, and a mostly-cold region with
    one hot row must still repel load from that row's capacity share.
    """
    occupied = np.asarray(risk)[np.asarray(kind) > 0]
    if occupied.size == 0:
        return 0.0
    return float(np.quantile(occupied, quantile))
