"""LLM instance profiles + Pareto frontier (paper §3.3, Figs. 15–16; port
of ``repro.core.profiles``).

The offline profiling phase measures goodput / power / peak-temperature /
quality for every configuration point (GPU frequency, tensor parallelism,
batch size, model size, quantization).  ``measure_from_engine()`` runs that
phase for real: it sweeps the serving Engine's knobs (max_batch x
freq_scale x variant) on a reduced-size model and turns the measured
token rates into ``ProfileEntry`` rows; ``calibrate()`` then folds the
measured batch efficiencies / frequency exponent / size speedups into the
``_entry`` physics so every downstream consumer (Instance Configurator,
ClusterSim) reads engine-measured numbers through the unchanged
``_entry`` API.  The hand values below remain the paper-calibrated
defaults for axes the smoke engine cannot observe (TP, quantization).

Conventions: goodput normalized to the best config = 1.0; power/temp
normalized to server TDP / temp-at-TDP = 1.0; quality in [0,1]
(Llama2-70B=1.0; 7B is 30–40% lower — paper §3.3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from itertools import product

FREQS = (0.6, 0.7, 0.8, 0.9, 1.0)
TPS = (2, 4, 8)
BATCHES = (1, 16, 64)
SIZES = ("70b", "13b", "7b")
QUANTS = ("bf16", "int8")

_SIZE = {  # speedup vs 70B, quality, compute intensity
    "70b": (1.0, 1.00, 1.00),
    "13b": (3.6, 0.85, 0.55),
    "7b": (6.0, 0.62, 0.40),
}
_QUANT = {  # speedup, quality delta, power scale
    "bf16": (1.0, 0.0, 1.0),
    "int8": (1.45, -0.08, 0.82),
}

# paper-curve defaults, replaced by calibrate(measure_from_engine(...))
_DEFAULT_BATCH_EFF = {1: 0.25, 16: 0.85, 64: 1.0}
_DEFAULT_FREQ_EXP = 0.85
_CAL: dict = {"batch_eff": dict(_DEFAULT_BATCH_EFF),
              "freq_exp": _DEFAULT_FREQ_EXP, "size_speed": {},
              "source": "paper-calibrated"}


@dataclass(frozen=True)
class ConfigPoint:
    freq: float
    tp: int
    batch: int
    size: str
    quant: str

    @property
    def reload_cost_s(self) -> float:
        """§4.3: freq is instant; batch is cheap; TP/size/quant reload."""
        return 0.0 if self.tp == 8 and self.size == "70b" and \
            self.quant == "bf16" else 8.0

    def needs_reload_from(self, other: "ConfigPoint") -> bool:
        return (self.tp, self.size, self.quant) != \
            (other.tp, other.size, other.quant)


@dataclass(frozen=True)
class ProfileEntry:
    cfg: ConfigPoint
    goodput: float      # tokens/s, normalized
    power_frac: float   # fraction of server TDP
    temp_frac: float    # hottest-chip util-equivalent in [0,1]
    quality: float


def _per_chip_power(util: float, freq: float, chips_frac: float = 1.0) -> float:
    """Per-active-chip draw: static+dynamic split over frequency; work
    concentrates (draw rises) as fewer chips share it (paper §3.3)."""
    return util * (0.55 + 0.45 * freq ** 2.2) / chips_frac ** 0.35


def _entry(c: ConfigPoint) -> ProfileEntry:
    size_speed, qual, intensity = _SIZE[c.size]
    size_speed = _CAL["size_speed"].get(c.size, size_speed)
    qspeed, qqual, qpow = _QUANT[c.quant]
    # goodput: prompt phase ~ freq-sensitive (paper: prefill more sensitive);
    # batching amortizes weights until SLO pressure at the top knob
    batch_eff = _CAL["batch_eff"][c.batch]
    tp_eff = {8: 1.0, 4: 0.80, 2: 0.55}[c.tp]
    goodput = (c.freq ** _CAL["freq_exp"]) * batch_eff * tp_eff \
        * size_speed * qspeed
    # power: fewer active chips with lower TP lowers SERVER power; per-chip
    # power rises (work concentrates) -> temp of hottest chip up (paper §3.3)
    util = intensity * batch_eff
    chips_frac = c.tp / 8.0
    per_chip = _per_chip_power(util, c.freq, chips_frac)
    power = chips_frac * per_chip * qpow
    temp = min(per_chip * qpow, 1.35)
    quality = max(qual + qqual, 0.0)
    return ProfileEntry(c, goodput=goodput, power_frac=min(power, 1.0),
                        temp_frac=temp, quality=quality)


def build_profile() -> list:
    """All config points (Fig. 16 scatter)."""
    out = []
    for f, tp, b, s, q in product(FREQS, TPS, BATCHES, SIZES, QUANTS):
        out.append(_entry(ConfigPoint(f, tp, b, s, q)))
    return out


def pareto_frontier(entries: list) -> list:
    """Configs not dominated in (goodput up, power down, temp down,
    quality up)."""
    front = []
    for e in entries:
        dominated = any(
            (o.goodput >= e.goodput and o.power_frac <= e.power_frac
             and o.temp_frac <= e.temp_frac and o.quality >= e.quality
             and (o.goodput, -o.power_frac, -o.temp_frac, o.quality)
             != (e.goodput, -e.power_frac, -e.temp_frac, e.quality))
            for o in entries)
        if not dominated:
            front.append(e)
    return front


def best_config(entries: list, *, power_cap: float, temp_cap: float,
                min_quality: float, current: ConfigPoint | None = None,
                allow_reload: bool = True,
                min_goodput: float = 0.0) -> ProfileEntry | None:
    """§4.3 Instance Configurator: maximize goodput under caps.

    Reload-requiring moves (TP/size/quant) are last-resort: a candidate that
    needs a reload is only chosen when no no-reload candidate both fits the
    caps and sustains ``min_goodput`` (the instance's assigned load) — this
    is how emergencies push load onto smaller/quantized variants (quality
    cost) instead of dropping throughput (paper §5.4)."""
    feasible = [e for e in entries
                if e.power_frac <= power_cap + 1e-9 and e.temp_frac <= temp_cap + 1e-9
                and e.quality >= min_quality - 1e-9]
    if not feasible:
        return None
    if current is not None:
        no_reload = [e for e in feasible
                     if not e.cfg.needs_reload_from(current)]
        sustaining = [e for e in no_reload if e.goodput >= min_goodput - 1e-9]
        if sustaining:
            return max(sustaining, key=lambda e: (e.goodput, e.quality))
        if no_reload and not allow_reload:
            return max(no_reload, key=lambda e: (e.goodput, e.quality))
        if not allow_reload:
            return None
        if no_reload and max(e.goodput for e in feasible) <= max(
                e.goodput for e in no_reload) + 1e-9:
            return max(no_reload, key=lambda e: (e.goodput, e.quality))
    return max(feasible, key=lambda e: (e.goodput, e.quality))


NOMINAL = ConfigPoint(freq=1.0, tp=8, batch=64, size="70b", quant="bf16")


# ---------------------------------------------------------------------------
# engine-measured profiles (paper's offline profiling phase, §3.3)
# ---------------------------------------------------------------------------

@dataclass
class MeasuredProfile:
    """Engine-measured goodput sweep + the calibration it implies.

    rows: one dict per swept knob point with the raw measured token rate;
    entries: the same points as ProfileEntry rows (goodput normalized to
    the best measured point, power/temp from the _entry physics driven by
    the measured efficiencies); calibration: overrides for _entry.
    """
    rows: list = field(default_factory=list)
    entries: list = field(default_factory=list)
    calibration: dict = field(default_factory=dict)


def _snap(value: float, grid: tuple) -> float:
    return min(grid, key=lambda g: abs(g - value))


def measure_from_engine(*, arch: str = "llama2-7b",
                        batches: tuple = (1, 2, 4),
                        freqs: tuple = (0.6, 0.8, 1.0),
                        variants: tuple = (("full", "70b"), ("small", "7b")),
                        n_requests: int = 8, prompt_len: int = 8,
                        max_new: int = 10, max_seq: int = 96,
                        seed: int = 0, device="cuda") -> MeasuredProfile:
    """Run the offline profiling phase on the real serving engine.

    Sweeps EngineKnobs (max_batch x freq_scale x variant) on a smoke-scale
    model and measures decode tokens per wall-second at each point.  The
    measured batch knobs map onto the profile's BATCHES axis by rank and
    each engine variant onto a SIZES entry (``variants`` pairs knob name
    with size), so the emitted ProfileEntry rows slot straight into the
    configurator/simulator tables.  One engine per variant is built on
    ``device`` and its (mutable) batch/freq knobs swept in place, so every
    decode program is captured once per variant (on a card).
    """
    if len(batches) > len(BATCHES):
        raise ValueError(f"at most {len(BATCHES)} batch knobs map onto the "
                         f"profile's BATCHES axis, got {batches}")
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, local_plan
    from repro_torch.serving import Engine, EngineKnobs, EngineStats, Request

    cfg_full = get_config(arch).smoke_config()
    cfg_small = cfg_full.replace(num_layers=1, d_ff=max(cfg_full.d_ff // 2, 8),
                                 name=f"{cfg_full.name}-small")
    plan = local_plan(param_dtype=torch.bfloat16)
    models = {"full": build_model(cfg_full, plan, device=device),
              "small": build_model(cfg_small, plan, device=device)}
    n_lanes = max(batches)
    rows = []
    for vi, (vname, size) in enumerate(variants):
        model = models[vname]
        params = model.init(torch.Generator(device=device).manual_seed(vi))
        eng = Engine(model, params, max_seq=max_seq, n_slots=n_lanes,
                     knobs=EngineKnobs(max_batch=n_lanes))

        def submit_load(rng):
            for _ in range(n_requests):
                eng.submit(Request(
                    prompt=[int(t) for t in rng.integers(
                        0, cfg_full.vocab_size, prompt_len)],
                    max_new_tokens=max_new))

        for batch in batches:
            eng.knobs.max_batch = batch
            eng.knobs.freq_scale = 1.0
            # warmup: capture this knob point's decode programs so
            # measured step times are steady-state, not captures
            eng.stats = EngineStats()
            submit_load(np.random.default_rng(seed))
            eng.run()
            for freq in freqs:
                eng.knobs.freq_scale = freq
                eng.stats = EngineStats()
                submit_load(np.random.default_rng(seed))
                stats = eng.run()
                wall = max(stats.step_time_total, 1e-9)
                rows.append({
                    "variant": vname, "size": size, "batch": batch,
                    "freq": freq, "tok_per_s": stats.decode_tokens / wall,
                    "decode_tokens": stats.decode_tokens,
                    "preemptions": stats.preemptions,
                })

    # --- calibration: batch efficiency, freq exponent, size speedup ------
    def rate(vname, batch, freq):
        return next(r["tok_per_s"] for r in rows
                    if r["variant"] == vname and r["batch"] == batch
                    and r["freq"] == freq)

    f_top = max(freqs)
    b_top = max(batches)
    base = variants[0][0]
    top_rate = rate(base, b_top, f_top)
    # measured batch knobs map onto the profile's BATCHES axis by rank,
    # aligned at the top (the biggest measured batch defines eff = 1.0);
    # unmeasured low knobs conservatively inherit the smallest measured eff
    eff_of = {b: min(rate(base, b, f_top) / max(top_rate, 1e-9), 1.0)
              for b in batches}
    knob_of = dict(zip(sorted(batches)[::-1], BATCHES[::-1]))
    batch_eff = {knob: min(eff_of.values()) for knob in BATCHES}
    for b, knob in knob_of.items():
        batch_eff[knob] = eff_of[b]
    exps = [math.log(max(rate(base, b_top, f) / max(top_rate, 1e-9), 1e-9))
            / math.log(f) for f in freqs if f != f_top]
    freq_exp = float(np.clip(np.mean(exps), 0.3, 2.0)) if exps \
        else _DEFAULT_FREQ_EXP
    size_speed = {}
    for vname, size in variants:
        size_speed[size] = rate(vname, b_top, f_top) / max(top_rate, 1e-9)
    calibration = {"batch_eff": batch_eff, "freq_exp": freq_exp,
                   "size_speed": size_speed, "source": "engine-measured"}

    # --- ProfileEntry rows for the measured points ------------------------
    best = max(r["tok_per_s"] for r in rows)
    entries = []
    for r in rows:
        c = ConfigPoint(freq=_snap(r["freq"], FREQS), tp=8,
                        batch=knob_of[r["batch"]], size=r["size"],
                        quant="bf16")
        _, qual, intensity = _SIZE[c.size]
        util = intensity * batch_eff[c.batch]
        per_chip = _per_chip_power(util, c.freq)   # measured points run tp=8
        entries.append(ProfileEntry(
            c, goodput=r["tok_per_s"] / max(best, 1e-9),
            power_frac=min(per_chip, 1.0), temp_frac=min(per_chip, 1.35),
            quality=qual))
    return MeasuredProfile(rows=rows, entries=entries,
                           calibration=calibration)


def calibrate(measured: MeasuredProfile) -> None:
    """Fold engine measurements into the ``_entry`` physics so the
    configurator and ClusterSim consume measured numbers through the
    unchanged API (acceptance: nominal entries come from the engine)."""
    _CAL.update(measured.calibration)


def reset_calibration() -> None:
    _CAL.update(batch_eff=dict(_DEFAULT_BATCH_EFF),
                freq_exp=_DEFAULT_FREQ_EXP, size_speed={},
                source="paper-calibrated")
