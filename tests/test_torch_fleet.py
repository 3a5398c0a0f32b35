"""The port's fleet of regions and oversubscription planner against the
live JAX reference on the CPU.

Both packages run the same configurations: a single-region fleet against
a standalone ``ClusterSim`` (in the port, bit for bit, and against the
reference); ``examples/geo_fleet.py``'s three-region drill under
``LatencyOnlyRouter`` and ``GlobalTapasRouter`` (a regional thermal and
cooling failure in a heat wave, a fleet-wide surge) tick by tick, and
``examples/fleet_oversub_planner.py``'s two fleets (a regional UPS
failure in a heat wave with a regional surge, sized by a
``FleetOversubPlanner``; a regional price shock, thermal-only and
cost-aware); ``sweep`` rows with ``max_safe_oversubscription``; and an
``EngineFleet`` of two engines on one weight copy inside a ``FleetSim``.
Event, migration and admission counts are held exactly, every float of a
summary, a plan or a trial within 1e-12 relative (1e-12 absolute for
values that are zero but for round-off), except the geo drill's:
``outside_temperature``'s float32 ``sin`` differs by 1 ulp between the
packages (``test_torch_sim.py``), which moves a few servers' loads on a
few ticks by up to 1.4e-6 relative and the summary by up to 8.6e-9, so
the drill is held tick by tick at ``RTOL_TICK`` and in its summary at
``RTOL_SUMMARY``; the engines' streams, outcomes and counters
exactly.  The
entry points ``repro_torch.launch.fleet`` and ``repro_torch.launch.oversub``
print what the reference examples print (the planner, the drills and the
sweep at shorter horizons)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import fleet as JFL  # noqa: E402
from repro.core import oversubscribe as JOS  # noqa: E402
from repro.core import scenario as JS  # noqa: E402
from repro.core import simulator as JSIM  # noqa: E402
from repro.core.datacenter import DCConfig as JDC  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineFleet as JFleet  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import fleet as TFL  # noqa: E402
from repro_torch.core import oversubscribe as TOS  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402
from repro_torch.core import simulator as TSIM  # noqa: E402
from repro_torch.core.datacenter import DCConfig as TDC  # noqa: E402
from repro_torch.launch import fleet as t_geo  # noqa: E402
from repro_torch.launch import oversub as t_oversub  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import Engine, EngineFleet, EngineKnobs  # noqa: E402
from repro_torch.serving import EngineSpec  # noqa: E402

RTOL = 1e-12
# the geo drill's limits, a few times its worst readings: 1.37e-6 on a
# tick (the gulf's loads on tick 66, latency router; 3.0e-7 under the
# global router), 8.6e-9 in a summary (the gulf's unserved fraction) and
# 3.3e-10 in the load moved
RTOL_TICK = 5e-6
RTOL_SUMMARY = 1e-7
COUNTS = ("thermal_events", "power_events", "throttle_events", "migrations",
          "migrations_failed", "fleet_admissions")
JAX_SIDE = dict(FL=JFL, OS=JOS, S=JS, SIM=JSIM, DC=JDC, kw={})
PORT_SIDE = dict(FL=TFL, OS=TOS, S=TS, SIM=TSIM, DC=TDC,
                 kw={"device": "cpu"})
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    """A reference example as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _horizon(mod, hours, monkeypatch):
    """Run a reference example's fleet factories at ``hours``: its
    ``FleetConfig`` with the horizon replaced."""
    monkeypatch.setattr(mod, "FleetConfig", lambda **kw: JFL.FleetConfig(
        **{**kw, "horizon_h": hours}))


def _close(got, want, what, rtol=RTOL):
    """Counts exact; floats (nested in dicts) within ``rtol``."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}", rtol)
    elif isinstance(want, (bool, int, np.integer)) or what.split(".")[-1] \
            in COUNTS:
        assert got == want, what
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=rtol,
                                   atol=1e-12, err_msg=what)


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def _solo(ns, policy, fleet=None, horizon_h=12.0):
    dc = ns["DC"](n_rows=2, racks_per_row=4, servers_per_rack=4)
    kw = dict(horizon_h=horizon_h, tick_min=10.0, seed=0, occupancy=0.97,
              demand_scale=1.0)
    spec = ns["FL"].RegionSpec("solo", dc=dc, wan_rtt_ms=0.0,
                               trace_namespace="")
    pol = getattr(ns["SIM"], policy)
    fs = ns["FL"].FleetSim(ns["FL"].FleetConfig(
        regions=(spec,), policy=pol, fleet=fleet, **kw), **ns["kw"])
    sim = ns["SIM"].ClusterSim(ns["SIM"].SimConfig(dc=dc, policy=pol, **kw),
                               **ns["kw"])
    return fs, sim


@pytest.mark.parametrize("router", ["LatencyOnlyRouter", "GlobalTapasRouter"])
@pytest.mark.parametrize("policy", ["BASELINE", "TAPAS"])
def test_single_region_fleet_matches_cluster_sim(policy, router):
    """One region is the standalone ``ClusterSim`` in the port, bit for
    bit, and the reference's single-region fleet within RTOL."""
    fs, sim = _solo(PORT_SIDE, policy, getattr(TFL, router))
    res = fs.run()
    assert res.regions["solo"].summary() == sim.run().summary()
    assert res.moved_load == 0.0 and res.migrations == 0
    jfs, _ = _solo(JAX_SIDE, policy, getattr(JFL, router))
    _close(res.summary(), jfs.run().summary(), "summary")


def _geo(ns, router):
    """``examples/geo_fleet.py::make_fleet`` in either package."""
    FL, S = ns["FL"], ns["S"]

    def dc(climate):
        return ns["DC"](n_rows=4, racks_per_row=4, servers_per_rack=4,
                        region=climate)

    regions = (
        FL.RegionSpec("gulf", dc=dc("hot"), wan_rtt_ms=10.0,
                      power_price_scale=1.2),
        FL.RegionSpec("plains", dc=dc("mild"), wan_rtt_ms=25.0),
        FL.RegionSpec("fjord", dc=dc("cold"), wan_rtt_ms=45.0,
                      power_price_scale=0.7))
    scenario = S.Scenario((
        S.FailureEvent(kind="thermal", start_h=3.0, end_h=10.0, target=0,
                       region="gulf"),
        S.FailureEvent(kind="cooling", start_h=3.0, end_h=10.0,
                       region="gulf"),
        S.WeatherShift(start_h=2.0, end_h=11.0, delta_c=12.0, region="gulf"),
        S.DemandSurge(start_h=3.0, end_h=9.0, scale=1.3)))
    return FL.FleetSim(FL.FleetConfig(
        regions=regions, horizon_h=12.0, tick_min=10.0, seed=0,
        policy=ns["SIM"].TAPAS, fleet=getattr(FL, router), scenario=scenario,
        occupancy=0.97, demand_scale=1.05), **ns["kw"])


def _fleet_tick(st) -> dict:
    return {"risk": st.risk, "emergency": st.emergency,
            "capacity": st.capacity, "headroom": st.headroom,
            "demand": st.demand, "price": st.price, "carbon": st.carbon,
            "age": st.telemetry_age,
            "kind": {n: st.regions[n].kind.tolist() for n in st.regions},
            "load": {n: np.asarray(st.regions[n].saas_load)
                     for n in st.regions}}


@pytest.mark.parametrize("router", ["LatencyOnlyRouter", "GlobalTapasRouter"])
def test_geo_drill_matches_reference(router):
    """The weather shift and the regional failure, tick by tick: every
    region's risk, capacity, demand and placement, then the summary."""
    jfs, tfs = _geo(JAX_SIDE, router), _geo(PORT_SIDE, router)
    assert tfs.ticks == jfs.ticks
    while jfs.tick < jfs.ticks:
        a, b = _fleet_tick(jfs.step()), _fleet_tick(tfs.step())
        _close(b, a, f"tick {jfs.tick}", RTOL_TICK)
        assert tfs._moved == pytest.approx(jfs._moved, rel=RTOL_SUMMARY,
                                           abs=1e-12)
    want, got = jfs.result().summary(), tfs.result().summary()
    _close(got, want, "summary", RTOL_SUMMARY)
    if router == "GlobalTapasRouter":
        assert got["moved_load"] > 0 and got["migrations"] > 0
    else:
        assert got["moved_load"] == 0.0


def test_fleet_validation_matches_reference():
    """Construction errors carry the reference's messages."""
    def err(ns, make):
        try:
            make(ns)
        except (ValueError, TypeError) as e:
            return type(e).__name__, str(e)
        return None

    dc = dict(n_rows=1, racks_per_row=2, servers_per_rack=2)
    cases = [
        lambda ns: ns["FL"].FleetSim(ns["FL"].FleetConfig(), **ns["kw"]),
        lambda ns: ns["FL"].RegionSpec("", dc=ns["DC"](**dc)),
        lambda ns: ns["FL"].Migration("a", 0, "a"),
        lambda ns: ns["FL"].FleetSim(ns["FL"].FleetConfig(
            regions=(ns["FL"].RegionSpec("a", dc=ns["DC"](**dc)),) * 2),
            **ns["kw"]),
        lambda ns: ns["FL"].FleetSim(ns["FL"].FleetConfig(
            regions=(ns["FL"].RegionSpec("a", dc=ns["DC"](**dc)),),
            scenario=ns["S"].Scenario((ns["S"].DemandSurge(
                start_h=0, end_h=1, scale=2.0, region="b"),))), **ns["kw"]),
        lambda ns: ns["OS"].FleetOversubPlanner(None, **ns["kw"]),
    ]
    for make in cases:
        want = err(JAX_SIDE, make)
        assert want is not None
        assert err(PORT_SIDE, make) == want


# ---------------------------------------------------------------------------
# oversubscription
# ---------------------------------------------------------------------------

def test_sweep_and_max_safe_match_reference():
    """A sweep over 2 x 5 x 4 servers at 8 h with a UPS failure (the
    planner's stress): every row, and the safe ratio at two budgets."""
    def rows(ns):
        S = ns["S"]
        return ns["OS"].sweep(
            [ns["SIM"].BASELINE, ns["SIM"].TAPAS], ratios=(0.0, 0.2, 0.4),
            dc=ns["DC"](n_rows=2, racks_per_row=5, servers_per_rack=4),
            horizon_h=8.0, seed=1, scenario=S.Scenario((S.FailureEvent(
                kind="ups", start_h=4.0, end_h=6.0),)), **ns["kw"])

    want, got = rows(JAX_SIDE), rows(PORT_SIDE)
    assert got == want
    for pol in ("baseline", "place+route+config"):
        for budget in (0.007, 1e-4):
            assert TOS.max_safe_oversubscription(got, pol,
                                                 cap_budget=budget) == \
                JOS.max_safe_oversubscription(want, pol, cap_budget=budget)
    assert any(r["thermal_capped_pct"] + r["power_capped_pct"] > 0
               for r in got)


def test_fleet_oversub_planner_matches_reference(capsys, monkeypatch):
    """``repro_torch.launch.oversub``'s planner against
    ``fleet_oversub_planner.py``'s, both cut to 9 h (the UPS failure at
    hour 7 inside them): the printed plan, its summary, and every trial's
    ratios, verdict and capped fractions."""
    fop = _example("fleet_oversub_planner")
    _horizon(fop, 9.0, monkeypatch)
    planners = {}

    def keep(mod, cls):
        def make(*a, **kw):
            planners[mod] = cls(*a, **kw)
            return planners[mod]
        monkeypatch.setattr(mod, "FleetOversubPlanner", make)

    keep(fop, JOS.FleetOversubPlanner)
    keep(t_oversub, TOS.FleetOversubPlanner)
    want = fop.run_planner()
    want_out = capsys.readouterr().out
    got = t_oversub.run_planner(horizon_h=9.0, device="cpu")
    assert capsys.readouterr().out == want_out
    assert got == want
    a_trials, b_trials = planners[t_oversub].trials, planners[fop].trials
    assert len(a_trials) == len(b_trials)
    for a, b in zip(a_trials, b_trials):
        assert (a["ratios"], a["safe"]) == (b["ratios"], b["safe"])
        _close(a["capped"], b["capped"], "capped")
    assert got["evaluations"] > len(got["isolated"])
    assert got["coordinated_total"] > got["isolated_total"]


# ---------------------------------------------------------------------------
# engines inside the fleet
# ---------------------------------------------------------------------------

def _fleet_with_engines(side):
    """``test_fleet.py::test_engine_backend_runs_inside_fleet`` with an
    ``EngineFleet`` of 2 engines (one weight copy) backing every SaaS
    server of region ``east``: two regions of 12 servers, 4 h."""
    jcfg = j_get_config("llama2-7b").smoke_config().replace(num_layers=1,
                                                            d_ff=32)
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    if side == "jax":
        ns, FleetCls, spec_cls = JAX_SIDE, JFleet, JSpec
        share = JEngine(jm, jp, max_seq=64, n_slots=2, paged=True,
                        block_size=16, knobs=JKnobs(max_batch=2))
        cfg = jcfg
    else:
        ns, FleetCls, spec_cls = PORT_SIDE, EngineFleet, EngineSpec
        tm = build_model(get_config("llama2-7b").smoke_config().replace(
            num_layers=1, d_ff=32), local_plan(param_dtype=torch.float32,
                                               compute_dtype=torch.float32),
            device="cpu")
        share = Engine(tm, from_jax_params(jax.tree.map(np.asarray, jp),
                                           device="cpu"),
                       max_seq=64, n_slots=2, paged=True, block_size=16,
                       knobs=EngineKnobs(max_batch=2))
        cfg = tm.cfg
    FL = ns["FL"]
    small = ns["DC"](n_rows=2, racks_per_row=3, servers_per_rack=2)
    fs = FL.FleetSim(FL.FleetConfig(
        regions=(FL.RegionSpec("east", dc=small, wan_rtt_ms=10.0),
                 FL.RegionSpec("west", dc=small, wan_rtt_ms=30.0)),
        horizon_h=4.0, tick_min=10.0, seed=0, policy=ns["SIM"].TAPAS,
        occupancy=0.9), **ns["kw"])
    fleet = FleetCls(spec_cls(cfg, max_seq=64, n_slots=2, block_size=16),
                     n_engines=2, steps_per_tick=2, share=share,
                     backend_kw=dict(requests_per_load=2.0, prompt_len=4,
                                     max_new_tokens=3))
    attached = {}
    while fs.tick < fs.ticks:
        st = fs.step()
        for srv in np.flatnonzero(st.regions["east"].kind == 2):
            if int(srv) not in attached:
                bk = fleet.make_backend()
                fs.attach_backend("east", int(srv), bk)
                attached[int(srv)] = bk
    fleet.drain(now_h=5.0)
    with pytest.raises(ValueError, match="unknown region"):
        fs.attach_backend("nowhere", 0, fleet.make_backend())
    return {
        "attached": sorted(attached),
        "engine_of": [fleet.engines.index(bk.engine)
                      for _, bk in sorted(attached.items())],
        "flushes": fleet.flushes,
        "requests": {s: [(tuple(r.output), r.outcome) for r in bk.issued]
                     for s, bk in attached.items()},
        "applied": {s: len(bk.applied) for s, bk in attached.items()},
        "stats": [{k: getattr(e.stats, k) for k in (
            "decode_tokens", "prefill_tokens", "prefill_batches",
            "preemptions", "submitted", "host_syncs")}
            for e in fleet.engines],
        "shared": all(e.variants["full"][1] is share.variants["full"][1]
                      for e in fleet.engines),
        "summary": fs.result().summary(),
    }


def test_engine_fleet_inside_fleet_sim_matches_reference():
    want, got = _fleet_with_engines("jax"), _fleet_with_engines("port")
    for k in ("attached", "engine_of", "flushes", "requests", "applied",
              "stats"):
        assert got[k] == want[k], k
    _close(got["summary"], want["summary"], "summary")
    assert got["shared"] and want["shared"]
    assert got["attached"] and got["flushes"] > 0
    assert all(r and o == "accepted" for reqs in got["requests"].values()
               for r, o in reqs)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_launch_fleet_prints_reference_drills(capsys, monkeypatch):
    """``repro_torch.launch.fleet``'s drills at 4 h and its measured
    drill at 2 h print what ``examples/geo_fleet.py``'s do."""
    geo = _example("geo_fleet")
    _horizon(geo, 4.0, monkeypatch)
    for label, router in (("latency", "LatencyOnlyRouter"),
                          ("global", "GlobalTapasRouter")):
        want = geo.run_drill(label, getattr(geo, router), verbose=True)
        want_out = capsys.readouterr().out
        got = t_geo.run_drill(label, getattr(t_geo, router), verbose=True,
                              horizon_h=4.0, device="cpu")
        assert capsys.readouterr().out == want_out
        _close(got, want, label, RTOL_SUMMARY)
    _horizon(geo, 2.0, monkeypatch)
    want = geo.run_measured_drill()
    want_out = capsys.readouterr().out
    got = t_geo.run_measured_drill(horizon_h=2.0, device="cpu")
    assert capsys.readouterr().out == want_out
    for k in ("attached", "engines", "one_weight_copy", "served_servers",
              "decode_tokens", "flushes", "measured_region_ticks"):
        assert got[k] == want[k], k
    assert got["attached"] > 0 and got["one_weight_copy"]


def test_launch_oversub_prints_reference_sweep(capsys, monkeypatch):
    osp = _example("oversubscription_planner")
    monkeypatch.setattr(osp, "sweep", lambda *a, **kw: JOS.sweep(
        *a, **{**kw, "horizon_h": 6.0}))
    osp.main()
    want = capsys.readouterr().out
    got = t_oversub.run_sweep(horizon_h=6.0, device="cpu")
    assert capsys.readouterr().out == want
    assert set(got["safe"]) == {"baseline", "place+route+config"}


def test_launch_oversub_cost_pair_prints_reference(capsys):
    """``--fleet``'s cost-aware steering at 12 h against
    ``fleet_oversub_planner.py``'s, with its closing assertions: the
    price shock moves load and cuts the blended cost at equal goodput."""
    fop = _example("fleet_oversub_planner")
    want = fop.run_cost_pair()
    want_out = capsys.readouterr().out
    base, cost = t_oversub.run_cost_pair(device="cpu")
    assert capsys.readouterr().out == want_out
    _close({"base": base, "cost": cost},
           {"base": want[0], "cost": want[1]}, "cost pair")
    assert cost["moved_load"] > 0.0
    assert cost["blended_cost"] < base["blended_cost"]
