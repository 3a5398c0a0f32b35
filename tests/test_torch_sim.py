"""The port's ``ClusterSim`` against the live JAX reference on the CPU.

Both simulators run the same configuration tick by tick: Baseline and
TAPAS, with no scenario and with one that mixes failures (thermal, UPS,
AHU), a demand surge, a weather shift, a scripted SaaS arrival and a
sensor dropout, on 32-80 servers over 12-16 h.  Event counts are held
exactly and every float of the summary, and each tick's
``max_gpu_temp_c`` and ``row_power_frac``, within 1e-5 relative (the
physics is float32 on both sides; a value that is zero but for round-off,
below 1e-12, is held absolutely).  Each tick's routing, quality and
telemetry-age are held too.  Step-wise driving equals ``run()`` inside
the port, and ``run_drill`` equals the reference's."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401

from repro.core import failures as JFL  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.core import scenario as JS  # noqa: E402
from repro.core import simulator as JSIM  # noqa: E402
from repro.core.datacenter import DCConfig as JDC  # noqa: E402
from repro_torch.core import failures as TFL  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402
from repro_torch.core import simulator as TSIM  # noqa: E402
from repro_torch.core.datacenter import DCConfig as TDC  # noqa: E402

RTOL = 1e-5
COUNTS = ("thermal_events", "power_events")


def _mixed(S, F):
    return S.Scenario((
        S.FailureEvent(kind="thermal", start_h=4.0, end_h=6.0, target=0),
        S.FailureEvent(kind="ups", start_h=7.0, end_h=8.5),
        S.FailureEvent(kind="ahu", start_h=9.0, end_h=10.0, target=0),
        S.DemandSurge(start_h=3.5, end_h=8.0, scale=1.4),
        S.DemandSurge(start_h=5.0, end_h=6.0, scale=1.3, endpoint="ep2"),
        S.WeatherShift(start_h=2.0, end_h=9.0, delta_c=4.0),
        S.VMArrival(arrival_h=1.0, kind="saas", customer="ep_new",
                    lifetime_h=20.0),
        F.SensorDropout(start_h=5.5, end_h=7.0)))


CASES = [  # (dc kwargs, sim kwargs)
    (dict(n_rows=2, racks_per_row=4, servers_per_rack=4),
     dict(horizon_h=16.0, tick_min=10.0, seed=1, occupancy=0.95,
          demand_scale=1.0)),
    (dict(n_rows=4, racks_per_row=5, servers_per_rack=4, region="hot"),
     dict(horizon_h=12.0, tick_min=10.0, seed=2, occupancy=0.95,
          demand_scale=0.98)),
    (dict(n_rows=4, racks_per_row=4, servers_per_rack=4, seed=5,
          region="mild"),
     dict(horizon_h=12.0, tick_min=10.0, seed=7, occupancy=0.9,
          demand_scale=1.05)),
]


def _sims(case, policy: str, scenario: bool):
    dc_kw, kw = case
    pols = {"baseline": (JSIM.BASELINE, TSIM.BASELINE),
            "tapas": (JSIM.TAPAS, TSIM.TAPAS)}[policy]
    j = JSIM.ClusterSim(JSIM.SimConfig(
        dc=JDC(**dc_kw), policy=pols[0],
        scenario=_mixed(JS, JF) if scenario else None, **kw))
    t = TSIM.ClusterSim(TSIM.SimConfig(
        dc=TDC(**dc_kw), policy=pols[1],
        scenario=_mixed(TS, TF) if scenario else None, **kw), device="cpu")
    return j, t


def _tick(st) -> dict:
    return {"emergency": st.emergency, "age": st.telemetry_age_ticks,
            "kind": st.kind.copy(), "saas_load": np.array(st.saas_load),
            "quality": np.array(st.quality), "risk": np.array(st.risk),
            "freq_cap": np.array(st.freq_cap),
            "instances": {s: (dataclasses.astuple(v.entry.cfg), v.paused)
                          for s, v in st.instances.items()},
            "max_gpu_temp_c": st.max_gpu_temp_c,
            "row_power_frac": np.array(st.row_power_frac)}


def _assert_summary(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k in COUNTS:
            assert got[k] == want[k], k
        else:
            # atol: a fraction that is zero but for round-off (an unserved
            # residue of 1e-17) has no relative precision to hold
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=1e-12, err_msg=k)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("policy", ["baseline", "tapas"])
@pytest.mark.parametrize("scenario", [False, True])
def test_cluster_sim_matches_reference(case, policy, scenario):
    jsim, tsim = _sims(CASES[case], policy, scenario)
    assert tsim.ticks == jsim.ticks
    while jsim.tick < jsim.ticks:
        a, b = _tick(jsim.step()), _tick(tsim.step())
        for k in ("emergency", "age", "instances"):
            assert b[k] == a[k], (jsim.tick, k)
        np.testing.assert_array_equal(b["kind"], a["kind"])
        for k in ("saas_load", "quality", "risk", "freq_cap",
                  "max_gpu_temp_c", "row_power_frac"):
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=1e-12,
                                       err_msg=f"tick {jsim.tick} {k}")
    want, got = jsim.result(), tsim.result()
    _assert_summary(got.summary(), want.summary())
    np.testing.assert_allclose(got.max_gpu_temp_c, want.max_gpu_temp_c,
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(got.row_power_frac, want.row_power_frac,
                               rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got.time_h, want.time_h)
    if scenario:
        assert any(st for st in (jsim.scenario.sensor_dropout(t)
                                 for t in jsim.t_h))


def test_stepwise_equals_run_and_reruns_are_deterministic():
    _, tsim = _sims(CASES[0], "tapas", True)
    ran = tsim.run().summary()
    tsim.reset()
    while tsim.tick < tsim.ticks:
        tsim.step()
    assert tsim.result().summary() == ran
    assert tsim.run().summary() == ran          # run() resets a used sim
    with pytest.raises(RuntimeError, match="horizon reached"):
        tsim.step()
    tsim.reset()
    with pytest.raises(RuntimeError, match="no ticks simulated"):
        tsim.result()


def test_run_policy_matches_reference():
    dc_kw, kw = CASES[0]
    # Baseline and TAPAS are held above; the two partial control planes
    for jp, tp in ((JSIM.Policy(place=True), TSIM.Policy(place=True)),
                   (JSIM.Policy(route=True, config=True),
                    TSIM.Policy(route=True, config=True))):
        assert tp.name == jp.name
        _assert_summary(
            TSIM.run_policy(tp, dc=TDC(**dc_kw), device="cpu",
                            **kw).summary(),
            JSIM.run_policy(jp, dc=JDC(**dc_kw), **kw).summary())


@pytest.mark.parametrize("kind", ["ups", "thermal"])
def test_run_drill_matches_reference(kind):
    kw = dict(n_rows=2, racks_per_row=4, servers_per_rack=4)
    for jp, tp in ((JSIM.BASELINE, TSIM.BASELINE), (JSIM.TAPAS, TSIM.TAPAS)):
        want = JFL.run_drill(kind, jp, dc=JDC(**kw), seed=1, horizon_h=12.0)
        got = TFL.run_drill(kind, tp, dc=TDC(**kw), seed=1, horizon_h=12.0,
                            device="cpu")
        assert (got.kind, got.policy) == (want.kind, want.policy)
        for f in ("iaas_perf", "saas_perf", "saas_quality"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=RTOL, atol=1e-9, err_msg=f)
        assert got.row() == want.row()


def test_scenario_targets_are_validated_as_the_reference():
    def err(S, F, SIM, DC, scenario, **kw):
        try:
            SIM.ClusterSim(SIM.SimConfig(
                dc=DC(n_rows=2, racks_per_row=1, servers_per_rack=4),
                horizon_h=1.0, tick_min=10.0, scenario=scenario(S, F)),
                **kw)
        except ValueError as e:
            return str(e)
        return None

    for make in (
            lambda S, F: S.Scenario((S.FailureEvent(kind="ahu", start_h=0,
                                                    end_h=1, target=3),)),
            lambda S, F: S.Scenario((F.EngineFault(kind="crash", start_h=0,
                                                   end_h=1, server=99),)),
            lambda S, F: S.Scenario((S.PriceShock(start_h=0, end_h=1,
                                                  scale=2.0),)),
            lambda S, F: S.Scenario((S.DemandSurge(start_h=0, end_h=1,
                                                   scale=2.0,
                                                   region="eu"),))):
        want = err(JS, JF, JSIM, JDC, make)
        assert want is not None
        got = err(TS, TF, TSIM, TDC, make, device="cpu")
        # the messages carry the event's repr, whose class is the same name
        assert got == want
