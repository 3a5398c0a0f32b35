"""The port's ``core/`` against the live JAX reference on the CPU.

Traces, datacenter, profiles, allocator, router, configurator, risk,
faults and scenario are numpy or plain Python on both sides: held bit for
bit.  The thermal and power models run in float32 on both sides (the
reference's ``jnp`` with x64 off, the port's torch tensors): every method
within 1e-5 relative (on this CPU they agree to the bit but for ``sin``).
Validation raises the same exception with the same message, and the
``DegradationLadder`` walks down and back up exactly as the reference's,
on the reference's stub engine (``tests/test_resilience.py``)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401
import torch  # noqa: E402

from repro.core import allocator as JA  # noqa: E402
from repro.core import configurator as JC  # noqa: E402
from repro.core import datacenter as JD  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.core import power as JP  # noqa: E402
from repro.core import profiles as JPR  # noqa: E402
from repro.core import risk as JR  # noqa: E402
from repro.core import router as JRT  # noqa: E402
from repro.core import scenario as JS  # noqa: E402
from repro.core import thermal as JT  # noqa: E402
from repro.core import traces as JTR  # noqa: E402
from repro_torch.core import allocator as TA  # noqa: E402
from repro_torch.core import configurator as TC  # noqa: E402
from repro_torch.core import datacenter as TD  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import power as TP  # noqa: E402
from repro_torch.core import profiles as TPR  # noqa: E402
from repro_torch.core import risk as TR  # noqa: E402
from repro_torch.core import router as TRT  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402
from repro_torch.core import thermal as TT  # noqa: E402
from repro_torch.core import traces as TTR  # noqa: E402

RTOL = 1e-5
DCS = [dict(n_rows=4, racks_per_row=5, servers_per_rack=4),
       dict(n_rows=2, racks_per_row=2, servers_per_rack=4, seed=3),
       dict(n_rows=3, racks_per_row=4, servers_per_rack=2, seed=7,
            region="cold", power_headroom=1.1),
       dict(n_rows=8, racks_per_row=10, servers_per_rack=4, seed=1,
            region="mild")]


def _pair(kw):
    jdc = JD.Datacenter(JD.DCConfig(**kw))
    tdc = TD.Datacenter(TD.DCConfig(**kw))
    return jdc, tdc


def _models(kw):
    jdc, tdc = _pair(kw)
    return (jdc, JT.ThermalModel.calibrate(jdc), JP.PowerModel.calibrate(jdc),
            tdc, TT.ThermalModel.calibrate(tdc, device="cpu"),
            TP.PowerModel.calibrate(tdc, device="cpu"))


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# traces + datacenter: numpy on both sides, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,occ", [(0, 40, 0.92), (5, 80, 0.95),
                                        (11, 33, 0.5), (123, 320, 0.88)])
def test_generate_workload_matches_reference(seed, n, occ):
    kw = dict(n_servers=n, horizon_h=24.0, seed=seed, occupancy=occ)
    want, got = JTR.generate_workload(**kw), TTR.generate_workload(**kw)
    assert [dataclasses.astuple(v) for v in got.vms] == \
        [dataclasses.astuple(v) for v in want.vms]
    assert got.endpoints == want.endpoints
    assert got.horizon_h == want.horizon_h
    vid = got.vms[len(got.vms) // 2].vm_id
    assert got.endpoint_of(vid) == want.endpoint_of(vid)


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 5])
def test_trace_functions_match_reference(seed):
    t = np.arange(0, 48.0, 0.25)
    work = JTR.generate_workload(n_servers=40, horizon_h=24.0, seed=seed % 97)
    for vm in work.vms[::5]:
        tvm = TTR.VMSpec(*dataclasses.astuple(vm))
        np.testing.assert_array_equal(TTR.iaas_util(tvm, t, seed=seed),
                                      JTR.iaas_util(vm, t, seed=seed))
        assert TTR.predict_peak_util(tvm, seed=seed) == \
            JTR.predict_peak_util(vm, seed=seed)
    for ep in ("ep0", "ep7", "surge"):
        np.testing.assert_array_equal(TTR.endpoint_load(ep, t, seed=seed),
                                      JTR.endpoint_load(ep, t, seed=seed))
    for ns in ("", "eu", "us-west"):
        np.testing.assert_array_equal(
            TTR.carbon_intensity(t, seed=seed, namespace=ns),
            JTR.carbon_intensity(t, seed=seed, namespace=ns))
        assert TTR.trace_seed(seed, ns) == JTR.trace_seed(seed, ns)
    assert TTR._stable_seed("x", seed) == JTR._stable_seed("x", seed)


@pytest.mark.parametrize("kw", DCS)
def test_datacenter_matches_reference(kw):
    jdc, tdc = _pair(kw)
    for name in ("row_of", "aisle_of", "rack_of", "height_of",
                 "prov_ahu_cfm", "prov_row_power_w"):
        np.testing.assert_array_equal(getattr(tdc, name), getattr(jdc, name))
    w = np.random.default_rng(0).random(tdc.n_servers)
    np.testing.assert_array_equal(tdc.row_sum(w), jdc.row_sum(w))
    np.testing.assert_array_equal(tdc.aisle_sum(w), jdc.aisle_sum(w))
    for over in (0.0, 0.2, 0.4):
        assert dataclasses.asdict(TD.scale_datacenter(tdc.cfg, over)) == \
            dataclasses.asdict(JD.scale_datacenter(jdc.cfg, over))


# ---------------------------------------------------------------------------
# thermal + power: float32 on both sides, 1e-5 relative
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", DCS)
def test_thermal_model_matches_reference(kw):
    jdc, jth, _, tdc, tth, _ = _models(kw)
    for name in ("inlet_base", "inlet_slope", "inlet_hot_slope",
                 "load_coeff", "gpu_alpha", "gpu_beta"):
        got = getattr(tth, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jth,
                                                                      name)))
    rng = np.random.default_rng(kw.get("seed", 0))
    util = rng.random((tdc.n_servers, 8))
    for t_out, load, derate in ((-10.0, 0.5, 0.0), (18.3, 0.2, 2.5),
                                (np.float32(27.7), 0.93, 3.0),
                                (np.float64(33.1), 1.0, 0.0)):
        inlet = np.asarray(jth.inlet_temp(t_out, load, cooling_derate=derate))
        _close(tth.inlet_temp(t_out, load, cooling_derate=derate), inlet)
        _close(tth.gpu_temp(inlet, util), jth.gpu_temp(inlet, util))
        for limit in (85.0, 82.0):
            _close(tth.max_util_for_temp(inlet, limit),
                   jth.max_util_for_temp(inlet, limit))
    server_util = util.mean(axis=1)
    np.testing.assert_array_equal(tth.airflow(server_util),
                                  jth.airflow(server_util))
    t_h = np.arange(0, 72.0, 1 / 6)
    for region in ("hot", "mild", "cold"):
        for seed in (0, 7, 2 ** 31 - 3):
            _close(TT.outside_temperature(region, t_h, seed=seed,
                                          device="cpu"),
                   JT.outside_temperature(region, t_h, seed=seed))


@pytest.mark.parametrize("kw", DCS)
def test_power_model_matches_reference(kw):
    jdc, _, jpm, tdc, _, tpm = _models(kw)
    for name in ("idle_w", "dyn_w", "quad_frac", "fan_w"):
        np.testing.assert_array_equal(getattr(tpm, name).numpy(),
                                      np.asarray(getattr(jpm, name)))
    rng = np.random.default_rng(1)
    s = tdc.n_servers
    for util in (rng.random((s, 8)), np.zeros((s, 8)), np.ones((s, 8)),
                 np.repeat(rng.random(s)[:, None], 8, 1)):
        want = np.asarray(jpm.server_power(util))
        _close(tpm.server_power(util), want)
        _close(TP.row_power(tdc, want), JP.row_power(jdc, want))
        limits = jdc.row_sum(want) * rng.uniform(0.7, 1.2, jdc.n_rows)
        mask = rng.random(s) < 0.5
        for m in (None, mask):
            _close(TP.capping_factors(tdc, want, limits, tpm,
                                      iaas_only_mask=m),
                   JP.capping_factors(jdc, want, limits, jpm,
                                      iaas_only_mask=m))
    for budget in (0.3 * 6500.0, 0.7 * 6500.0, 2000.0 + rng.random(s)):
        _close(tpm.max_util_for_power(budget),
               jpm.max_util_for_power(budget))


# ---------------------------------------------------------------------------
# profiles, configurator, router: plain Python / numpy, bit for bit
# ---------------------------------------------------------------------------

def _entry_tuple(e):
    return None if e is None else (dataclasses.astuple(e.cfg), e.goodput,
                                   e.power_frac, e.temp_frac, e.quality)


def test_profiles_match_reference():
    want, got = JPR.build_profile(), TPR.build_profile()
    assert [_entry_tuple(e) for e in got] == [_entry_tuple(e) for e in want]
    assert [_entry_tuple(e) for e in TPR.pareto_frontier(got)] == \
        [_entry_tuple(e) for e in JPR.pareto_frontier(want)]
    cur = [None, TPR.NOMINAL,
           TPR.ConfigPoint(freq=0.8, tp=4, batch=16, size="13b", quant="int8")]
    for pc in (1.0, 0.85, 0.6, 0.35):
        for tc in (1.35, 1.0, 0.6):
            for q in (1.0, 0.85, 0.0):
                for c in cur:
                    jc = None if c is None else JPR.ConfigPoint(
                        *dataclasses.astuple(c))
                    for kw in (dict(), dict(allow_reload=False),
                               dict(min_goodput=1.2)):
                        assert _entry_tuple(TPR.best_config(
                            got, power_cap=pc, temp_cap=tc, min_quality=q,
                            current=c, **kw)) == _entry_tuple(
                            JPR.best_config(want, power_cap=pc, temp_cap=tc,
                                            min_quality=q, current=jc, **kw))
    for c in got[::17]:
        jc = JPR.ConfigPoint(*dataclasses.astuple(c.cfg))
        assert c.cfg.reload_cost_s == jc.reload_cost_s
        assert c.cfg.needs_reload_from(TPR.NOMINAL) == \
            jc.needs_reload_from(JPR.NOMINAL)


def test_profile_calibration_matches_reference():
    measured = dict(batch_eff={1: 0.3, 16: 0.7, 64: 1.0}, freq_exp=0.9,
                    size_speed={"7b": 5.0}, source="engine-measured")
    try:
        TPR.calibrate(TPR.MeasuredProfile(calibration=dict(measured)))
        JPR.calibrate(JPR.MeasuredProfile(calibration=dict(measured)))
        assert [_entry_tuple(e) for e in TPR.build_profile()] == \
            [_entry_tuple(e) for e in JPR.build_profile()]
        assert TPR._CAL == JPR._CAL
    finally:
        TPR.reset_calibration()
        JPR.reset_calibration()
    assert TPR._CAL == JPR._CAL
    assert TPR._CAL["source"] == "paper-calibrated"


def test_measure_from_engine_matches_reference_counts():
    """The offline sweep on each side's engine: the same knob points and
    token counts (the rates are wall-clock, so only their shape is
    held)."""
    kw = dict(batches=(1, 2), freqs=(0.8, 1.0), n_requests=3, prompt_len=5,
              max_new=3, max_seq=32)
    want = JPR.measure_from_engine(**kw)
    got = TPR.measure_from_engine(**kw, device="cpu")
    keys = ("variant", "size", "batch", "freq", "decode_tokens",
            "preemptions")
    assert [tuple(r[k] for k in keys) for r in got.rows] == \
        [tuple(r[k] for k in keys) for r in want.rows]
    assert all(r["tok_per_s"] > 0 for r in got.rows)
    assert [dataclasses.astuple(e.cfg) for e in got.entries] == \
        [dataclasses.astuple(e.cfg) for e in want.entries]
    assert set(got.calibration) == set(want.calibration)
    assert set(got.calibration["batch_eff"]) == \
        set(want.calibration["batch_eff"])


def test_configurator_decisions_match_reference():
    rng = np.random.default_rng(4)
    jc, tc = JC.InstanceConfigurator(), TC.InstanceConfigurator()
    for step in range(120):
        vm = int(rng.integers(0, 6))
        kw = dict(power_cap=float(rng.uniform(0.3, 1.0)),
                  temp_cap=float(rng.uniform(0.5, 1.35)),
                  emergency=bool(rng.random() < 0.3),
                  min_goodput=float(rng.uniform(0.0, 1.5)))
        a, b = jc.decide(vm, **kw), tc.decide(vm, **kw)
        assert (dataclasses.astuple(b.current), b.pause_ticks) == \
            (dataclasses.astuple(a.current), a.pause_ticks)
        assert _entry_tuple(b.entry) == _entry_tuple(a.entry)
        if step % 7 == 0:
            jc.tick()
            tc.tick()
        if step % 31 == 0:
            jc.reset(vm)
            tc.reset(vm)


@pytest.mark.parametrize("seed", range(4))
def test_routers_match_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 3, 8, 20):
        cap = rng.uniform(0.0, 1.2, n)
        risk = rng.random(n)
        ids = rng.permutation(100)[:n]
        aff = rng.random(n) if seed % 2 else None
        for demand in (0.1, 0.3 * cap.sum(), cap.sum(), 2.0 * cap.sum() + 1):
            for j, t in ((JRT.BaselineRouter(), TRT.BaselineRouter()),
                         (JRT.TapasRouter(), TRT.TapasRouter()),
                         (JRT.TapasRouter(pack=False, risk_threshold=0.3),
                          TRT.TapasRouter(pack=False, risk_threshold=0.3))):
                a = j.route(demand, cap, risk, aff, ids=ids)
                b = t.route(demand, cap, risk, aff, ids=ids)
                np.testing.assert_array_equal(b.load, a.load)
                assert b.unserved == a.unserved


# ---------------------------------------------------------------------------
# allocator + risk: numpy over float32 physics, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", DCS[:3])
def test_allocators_match_reference(kw):
    jdc, jth, jpm, tdc, tth, tpm = _models(kw)
    jst = JA.AllocatorState.empty(jdc, jth, jpm)
    tst = TA.AllocatorState.empty(tdc, tth, tpm)
    np.testing.assert_array_equal(TA.TapasAllocator()._temp_groups(tst),
                                  JA.TapasAllocator()._temp_groups(jst))
    seed = kw.get("seed", 0)
    work = JTR.generate_workload(n_servers=tdc.n_servers, horizon_h=24.0,
                                 seed=seed, occupancy=1.1)
    for jalloc, talloc in ((JA.TapasAllocator(seed=seed),
                            TA.TapasAllocator(seed=seed)),
                           (JA.BaselineAllocator(seed=seed),
                            TA.BaselineAllocator(seed=seed))):
        jst = JA.AllocatorState.empty(jdc, jth, jpm)
        tst = TA.AllocatorState.empty(tdc, tth, tpm)
        for vm in work.vms:
            tvm = TTR.VMSpec(*dataclasses.astuple(vm))
            if isinstance(talloc, TA.TapasAllocator):
                np.testing.assert_array_equal(
                    talloc._validator(tst, 0.9), jalloc._validator(jst, 0.9))
            assert talloc.place(tst, tvm, seed=seed) == \
                jalloc.place(jst, vm, seed=seed)
        np.testing.assert_array_equal(tst.kind_of, jst.kind_of)
        np.testing.assert_array_equal(tst.vm_of, jst.vm_of)


@pytest.mark.parametrize("kw", DCS)
def test_server_risk_matches_reference(kw):
    jdc, jth, jpm, tdc, tth, tpm = _models(kw)
    rng = np.random.default_rng(2)
    s = tdc.n_servers
    inlet = np.asarray(jth.inlet_temp(29.0, 0.6))
    for trial in range(3):
        util = rng.random(s)
        kind = rng.integers(0, 3, s)
        prov_row = jdc.prov_row_power_w * (0.75 if trial == 2 else 1.0)
        prov_air = jdc.prov_ahu_cfm * (0.75 if trial else 1.0)
        knobs = dict(knobs=JR.RiskKnobs(probe_util_delta=0.5)) \
            if trial == 1 else {}
        tknobs = dict(knobs=TR.RiskKnobs(probe_util_delta=0.5)) \
            if trial == 1 else {}
        want = JR.server_risk(jdc, jth, jpm, inlet=inlet,
                              prov_row_power_w=prov_row,
                              prov_aisle_cfm=prov_air, util=util, kind=kind,
                              **knobs)
        got = TR.server_risk(tdc, tth, tpm, inlet=inlet,
                             prov_row_power_w=prov_row,
                             prov_aisle_cfm=prov_air, util=util, kind=kind,
                             **tknobs)
        np.testing.assert_array_equal(got, want)
        assert TR.region_risk(got, kind) == JR.region_risk(want, kind)
    for w in (0.0, 0.3, 1.0):
        assert TR.energy_cost_index(1.2, 0.8, carbon_weight=w) == \
            JR.energy_cost_index(1.2, 0.8, carbon_weight=w)
    assert TR.thermally_comparable(0.2, 0.3, band=0.15, threshold=0.5) == \
        JR.thermally_comparable(0.2, 0.3, band=0.15, threshold=0.5)


# ---------------------------------------------------------------------------
# validation: the same exception, word for word
# ---------------------------------------------------------------------------

def _bad_events(S, F):
    return [
        lambda: S.FailureEvent(kind="upss", start_h=0, end_h=1),
        lambda: S.FailureEvent(kind="ups", start_h=-1, end_h=1),
        lambda: S.FailureEvent(kind="ups", start_h=2, end_h=2),
        lambda: S.FailureEvent(kind="ahu", start_h=0, end_h=1, target=-1),
        lambda: S.FailureEvent(kind="cooling", start_h=0, end_h=1, target=2),
        lambda: S.FailureEvent(kind="ahu", start_h=0, end_h=1, region=""),
        lambda: S.DemandSurge(start_h=0, end_h=1, scale=0.0),
        lambda: S.WeatherShift(start_h=3, end_h=1, delta_c=2.0),
        lambda: S.VMArrival(arrival_h=0, kind="paas", customer="c",
                            lifetime_h=1),
        lambda: S.VMArrival(arrival_h=-1, kind="iaas", customer="c",
                            lifetime_h=1),
        lambda: S.VMArrival(arrival_h=0, kind="iaas", customer="c",
                            lifetime_h=0),
        lambda: S.VMArrival(arrival_h=0, kind="iaas", customer="c",
                            lifetime_h=1, peak_util=1.5),
        lambda: S.PriceShock(start_h=0, end_h=1, scale=-1),
        lambda: S.Scenario(("not an event",)),
        lambda: F.EngineFault(kind="meltdown", start_h=0, end_h=1),
        lambda: F.EngineFault(kind="crash", start_h=1, end_h=0),
        lambda: F.EngineFault(kind="crash", start_h=0, end_h=1, server=-1),
        lambda: F.EngineFault(kind="stuck_slow", start_h=0, end_h=1,
                              slow_factor=0.5),
        lambda: F.EngineFault(kind="crash", start_h=0, end_h=1, region=""),
        lambda: F.SensorDropout(start_h=1, end_h=0.5),
        lambda: F.SensorDropout(start_h=0, end_h=1, region=3),
        lambda: F.ResilienceKnobs(heartbeat_misses=0),
        lambda: F.ResilienceKnobs(stale_risk_bump=-0.1),
        lambda: F.DegradationLadder(calm_ticks=0),
        lambda: F.fault_pick(0, "x"),
    ]


@pytest.mark.parametrize("i", range(len(_bad_events(JS, JF))))
def test_validation_matches_reference(i):
    def raised(make):
        try:
            make()
        except Exception as e:        # noqa: BLE001 - compared below
            return type(e).__name__, str(e)
        return None

    want = raised(_bad_events(JS, JF)[i])
    got = raised(_bad_events(TS, TF)[i])
    assert want is not None
    assert got == want


def test_scenario_accessors_match_reference():
    def build(S, F):
        return S.Scenario((
            S.FailureEvent(kind="thermal", start_h=1.0, end_h=3.0, target=1),
            S.FailureEvent(kind="ups", start_h=2.0, end_h=4.0,
                           region="west"),
            S.DemandSurge(start_h=1.5, end_h=2.5, scale=1.4, endpoint="ep1"),
            S.DemandSurge(start_h=2.0, end_h=5.0, scale=1.2),
            S.WeatherShift(start_h=0.5, end_h=2.0, delta_c=3.0),
            S.VMArrival(arrival_h=1.0, kind="saas", customer="ep9",
                        lifetime_h=4.0),
            S.VMArrival(arrival_h=1.0, kind="iaas", customer="c1",
                        lifetime_h=4.0, region="east"),
            S.PriceShock(start_h=0.0, end_h=1.0, scale=2.0),
            F.EngineFault(kind="crash", start_h=1.0, end_h=2.0, server=3),
            F.EngineFault(kind="nan_burst", start_h=0.0, end_h=3.0,
                          region="west"),
            F.SensorDropout(start_h=1.0, end_h=2.0)))

    def view(sc):
        out = []
        for t in np.arange(0.0, 5.5, 0.25):
            out.append((repr(sc.failures(t)), sc.demand_scale(t, "ep1"),
                        sc.demand_scale(t, "ep2"), sc.weather_delta(t),
                        repr(sc.engine_faults(t)), sc.sensor_dropout(t),
                        sc.price_scale(t), sc.price_scale(t, "west")))
        return (out, repr(sc.vm_arrivals()), sorted(sc.regions_named()),
                repr(sc.fleet_arrivals()), repr(sc.for_region("west").events),
                repr((sc + sc).events))

    assert view(build(TS, TF)) == view(build(JS, JF))
    assert repr(TS.as_scenario(None, (TS.FailureEvent(
        kind="ahu", start_h=0, end_h=1),)).events) == repr(JS.as_scenario(
            None, (JS.FailureEvent(kind="ahu", start_h=0, end_h=1),)).events)


def test_fault_helpers_match_reference():
    assert TF.ENGINE_FAULT_KINDS == JF.ENGINE_FAULT_KINDS
    assert TF.REQUEST_OUTCOMES == JF.REQUEST_OUTCOMES
    assert TF.LADDER_RUNGS == JF.LADDER_RUNGS
    for n in (1, 3, 7, 100):
        assert [TF.fault_pick(n, "nan_burst", t, s) for t in range(40)
                for s in (0, 5)] == \
            [JF.fault_pick(n, "nan_burst", t, s) for t in range(40)
             for s in (0, 5)]
    assert dataclasses.asdict(TF.recovery_off()) == \
        dataclasses.asdict(JF.recovery_off())
    assert dataclasses.asdict(TF.ResilienceKnobs()) == \
        dataclasses.asdict(JF.ResilienceKnobs())


# ---------------------------------------------------------------------------
# degradation ladder: the same walk, rung for rung
# ---------------------------------------------------------------------------

class _StubEngine:
    """The reference's ladder stub (``tests/test_resilience.py``), with a
    shard-compatibility answer for the quantized rung."""

    def __init__(self, compatible=True):
        self.draft_name = "ngram"
        self.horizon = 8
        self.knobs = types.SimpleNamespace(max_batch=8, variant="full")
        self.offline = False
        self._compatible = compatible

    def set_drafter(self, name):
        self.draft_name = name

    def set_variant(self, name):
        self.knobs.variant = name

    def variant_compatible(self, name):
        return self._compatible


def _walk(F, kw, pattern, compatible, poke):
    bk = types.SimpleNamespace(engine=_StubEngine(compatible))
    ladder = F.DegradationLadder(**kw)
    out = []
    for i, emergency in enumerate(pattern):
        if i in poke:
            bk.engine.knobs.max_batch = 16   # a reconfigure raises the knob
        ladder.tick(bk, emergency)
        e = bk.engine
        out.append((ladder.level, ladder.walks, ladder.skipped_rungs,
                    e.draft_name, e.horizon, e.knobs.variant,
                    e.knobs.max_batch))
    return out


@pytest.mark.parametrize("kw", [dict(quantized_variant="q8", calm_ticks=2),
                                dict(calm_ticks=1),
                                dict(quantized_variant="int8", calm_ticks=3,
                                     min_horizon=2, min_batch=3)])
@pytest.mark.parametrize("compatible", [True, False])
def test_degradation_ladder_matches_reference(kw, compatible):
    rng = np.random.default_rng(len(kw))
    pattern = [True] * 6 + [False] * 10 + list(rng.random(30) < 0.4) \
        + [False] * 14
    poke = {3, 9, 20}
    assert _walk(TF, kw, pattern, compatible, poke) == \
        _walk(JF, kw, pattern, compatible, poke)
    want = JF.DegradationLadder(**kw).rungs()
    assert TF.DegradationLadder(**kw).rungs() == want


def test_audit_requests_matches_reference():
    from repro.serving.request import Request as JRequest
    from repro_torch.serving.request import Request as TRequest

    def audit(F, R):
        reqs = [R(prompt=[1], max_new_tokens=4) for _ in range(5)]
        reqs[0].output = [5, 6]
        reqs[0].finish(1.0, "accepted")
        reqs[1].finish(1.0, "timed_out")
        reqs[2].finish(1.0, "rejected")
        reqs[4].output = [1]
        reqs[4].finish(2.0, "accepted")
        a = F.audit_requests(reqs)
        base = reqs[0].req_id
        return {**a, "lost": [r - base for r in a["lost"]]}

    assert audit(TF, TRequest) == audit(JF, JRequest)
