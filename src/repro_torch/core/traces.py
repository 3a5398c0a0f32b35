"""Seeded production-like traces (port of ``repro.core.traces``; numpy, bit
for bit the reference's).

- IaaS VMs: opaque, whole-server, diurnal utilization with customer
  templates (predictable: row-level error <10% — Fig. 14) and long lifetimes
  (>60% beyond two weeks — Fig. 12a).
- SaaS endpoints: LLM inference services, 23–100 VMs each (Fig. 12b),
  diurnal request load with sharper peaks.
- VM arrivals: Poisson, 50/50 IaaS/SaaS by default (§5.1).

The engine also folds ``_stable_seed`` into per-request sampling seeds.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np


def _stable_seed(*parts) -> int:
    """Process-stable 32-bit seed for string-keyed traces.

    ``hash(str)`` is randomized per interpreter process, which made trace
    phases — and therefore every simulation metric — unreproducible across
    runs of the same seed.  CRC32 of the repr is stable everywhere.
    """
    return zlib.crc32(repr(parts).encode())


def trace_seed(seed: int, namespace: str = "") -> int:
    """Namespace a trace seed by region name (crc32, process-stable).

    Two regions of a fleet configured with the same ``seed`` must not
    replay identical weather wobble, customer phases and endpoint peaks —
    that would make every region's thermal trajectory a copy and
    cross-region steering trivially pointless.  An empty namespace returns
    ``seed`` unchanged, so single-cluster runs (and their golden parity
    numbers) are bit-identical to the pre-fleet behavior.
    """
    if not namespace:
        return seed
    # int32-safe: the seed reaches the weather wobble's float32 phase
    return _stable_seed("region", namespace, seed) % (2 ** 31)


@dataclass
class VMSpec:
    vm_id: int
    kind: str                  # "iaas" | "saas"
    customer: str              # IaaS: customer template; SaaS: endpoint name
    arrival_h: float
    lifetime_h: float
    peak_util: float           # predicted peak chip utilization


@dataclass
class Workload:
    vms: list
    endpoints: dict            # name -> list of SaaS vm_ids
    horizon_h: float

    def endpoint_of(self, vm_id: int) -> str | None:
        for name, ids in self.endpoints.items():
            if vm_id in ids:
                return name
        return None


def _lifetime(rng) -> float:
    """Fig. 12a: >60% of VMs live over two weeks."""
    if rng.random() < 0.62:
        return float(rng.uniform(14 * 24, 8 * 7 * 24))
    return float(rng.lognormal(mean=3.3, sigma=1.2))  # hours, median ~27h


def generate_workload(*, n_servers: int, horizon_h: float, seed: int = 0,
                      saas_fraction: float = 0.5, occupancy: float = 0.92,
                      n_endpoints: int = 10) -> Workload:
    rng = np.random.default_rng(seed + 3)
    n_vms = int(n_servers * occupancy)
    n_saas = int(n_vms * saas_fraction)
    n_iaas = n_vms - n_saas

    vms: list[VMSpec] = []
    # endpoint sizes 23..100 (Fig. 12b), scaled to the SaaS pool
    sizes = rng.integers(23, 101, n_endpoints).astype(float)
    sizes = np.maximum((sizes / sizes.sum() * n_saas).astype(int), 1)
    endpoints: dict[str, list] = {}
    vid = 0
    for e in range(n_endpoints):
        name = f"ep{e}"
        endpoints[name] = []
        for _ in range(int(sizes[e])):
            # endpoints scale up over days; arrivals interleave with IaaS
            vms.append(VMSpec(vid, "saas", name,
                              arrival_h=float(rng.uniform(0, horizon_h * 0.25)),
                              lifetime_h=horizon_h * 2,
                              peak_util=1.0))
            endpoints[name].append(vid)
            vid += 1
    for i in range(n_iaas):
        cust = f"cust{rng.integers(0, 6)}"  # few big customers => sync'd rows
        vms.append(VMSpec(vid, "iaas", cust,
                          arrival_h=float(rng.uniform(0, horizon_h * 0.3)),
                          lifetime_h=_lifetime(rng),
                          peak_util=float(rng.uniform(0.55, 1.0))))
        vid += 1
    return Workload(vms=vms, endpoints=endpoints, horizon_h=horizon_h)


# ---------------------------------------------------------------------------
# load traces
# ---------------------------------------------------------------------------

_CUST_PHASE: dict[str, float] = {}


def iaas_util(vm: VMSpec, t_h: np.ndarray, *, seed: int = 0) -> np.ndarray:
    """Diurnal utilization trace in [0,1] for an IaaS VM (Fig. 13a)."""
    key = (vm.customer, seed)  # cache keyed by seed: cross-run determinism
    if key not in _CUST_PHASE:
        rng = np.random.default_rng(_stable_seed(*key))
        _CUST_PHASE[key] = float(rng.uniform(0, 24))
    phase = _CUST_PHASE[key]
    rng = np.random.default_rng((vm.vm_id, seed))
    base = 0.62 + 0.3 * np.sin(2 * np.pi * (t_h - phase) / 24.0)
    noise = 0.08 * rng.standard_normal(np.shape(t_h))
    burst = (rng.random(np.shape(t_h)) < 0.02) * rng.uniform(0.1, 0.3)
    return np.clip(vm.peak_util * (base + noise + burst), 0.02, vm.peak_util)


def endpoint_load(name: str, t_h: np.ndarray, *, seed: int = 0) -> np.ndarray:
    """Aggregate request load for a SaaS endpoint, normalized to [0,1]
    per-VM-equivalent units (1.0 == every VM fully busy)."""
    rng = np.random.default_rng(_stable_seed(name, seed))
    phase = rng.uniform(7, 11)  # business-hours peak
    sharp = rng.uniform(1.2, 2.2)
    base = 0.45 + 0.55 * np.maximum(
        np.sin(2 * np.pi * (t_h - phase) / 24.0), 0.0) ** sharp
    spikes = (rng.random(np.shape(t_h)) < 0.01) * rng.uniform(0.15, 0.35)
    noise = 0.05 * np.random.default_rng((_stable_seed(name) % 997, seed)) \
        .standard_normal(np.shape(t_h))
    return np.clip(base + spikes + noise, 0.05, 1.0)


def carbon_intensity(t_h: np.ndarray, *, seed: int = 0,
                     namespace: str = "") -> np.ndarray:
    """Relative grid carbon intensity over time (1.0 == fleet-mean grid).

    Diurnal shape of a mixed solar/fossil grid: intensity dips through the
    midday solar window and peaks into the evening ramp, with a small
    seeded wobble.  ``namespace`` is the region's trace namespace (see
    ``trace_seed``) so two regions of a fleet never replay an identical
    grid — phases, solar depth and evening ramp all differ per region —
    while the trace stays deterministic per (seed, namespace).  Values are
    clipped to [0.3, 1.8]; multiply by a region's ``carbon_scale`` for the
    absolute dirtiness of its grid.
    """
    t_h = np.asarray(t_h, dtype=float)
    rng = np.random.default_rng(_stable_seed("carbon", namespace, seed))
    solar_mid = rng.uniform(12.0, 14.0)     # center of the solar dip
    solar_depth = rng.uniform(0.25, 0.45)
    evening_peak = rng.uniform(17.5, 20.5)
    evening_gain = rng.uniform(0.15, 0.35)
    # half-cosine windows: a 8h solar dip and a 6h evening fossil ramp
    solar = np.cos(np.clip((t_h % 24.0 - solar_mid) / 4.0, -1.0, 1.0)
                   * np.pi / 2.0)
    evening = np.cos(np.clip((t_h % 24.0 - evening_peak) / 3.0, -1.0, 1.0)
                     * np.pi / 2.0)
    wobble = 0.03 * np.sin(2 * np.pi * (t_h - rng.uniform(0, 24)) / 24.0)
    out = 1.0 - solar_depth * solar + evening_gain * evening + wobble
    return np.clip(out, 0.3, 1.8)


def predict_peak_util(vm: VMSpec, *, history_h: float = 168.0,
                      seed: int = 0, quantile: float = 0.99) -> float:
    """Template-based peak prediction (paper §4.1/§4.5: previous-week P99;
    under-prediction <4% of row-hours)."""
    t = np.arange(0, history_h, 1.0)
    if vm.kind == "iaas":
        return float(np.quantile(iaas_util(vm, t, seed=seed), quantile))
    return 1.0  # endpoints can always spike to full
