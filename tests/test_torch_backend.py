"""The port's engine backends against the live JAX reference on the CPU.

``examples/engine_in_the_loop.py``'s loop runs in both packages: the same
datacenter, scenario and TAPAS control plane, two ``EngineBackend``s over
smoke llama2-7b engines with a 1-layer ``"small"`` variant, on the same
weights (JAX ``Model.init`` trees carried over with ``from_jax_params``,
f32 plans over bf16 pools, as the other engine parity tests do).  Per
bound server the ``applied`` ``ConfigPoint`` lists, the knob trajectories
and every request's output tokens and outcome are held exactly, and the
summary with engines equals the summary without (the backends are
telemetry only), in the port and against the reference.  The batched
``EngineFleet``/``FleetBackend`` path (one weight copy through
``build(share=)``) and the drafter rule (``draft_min_freq``) likewise.
``measured_goodput`` is wall-clock, so only its sign is held."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import gc
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import profiles as JPR  # noqa: E402
from repro.core import scenario as JS  # noqa: E402
from repro.core import simulator as JSIM  # noqa: E402
from repro.core.datacenter import DCConfig as JDC  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineBackend as JBackend  # noqa: E402
from repro.serving import EngineFleet as JFleet  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import EngineSpec as JSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import profiles as TPR  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402
from repro_torch.core import simulator as TSIM  # noqa: E402
from repro_torch.core.datacenter import DCConfig as TDC  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import (Engine, EngineBackend,  # noqa: E402
                                 EngineFleet, EngineKnobs, EngineSpec)

JAX_SIDE = dict(Engine=JEngine, Knobs=JKnobs, Backend=JBackend,
                Fleet=JFleet, Spec=JSpec, S=JS, SIM=JSIM, DC=JDC, P=JPR,
                cfg=j_get_config, kw={})
PORT_SIDE = dict(Engine=Engine, Knobs=EngineKnobs, Backend=EngineBackend,
                 Fleet=EngineFleet, Spec=EngineSpec, S=TS, SIM=TSIM, DC=TDC,
                 P=TPR, cfg=get_config, kw={"device": "cpu"})
VARIANTS = {"70b": "full", "13b": "small", "7b": "small"}


def _model_pair(cfg_kw: dict, seed: int):
    jcfg = j_get_config("llama2-7b").smoke_config().replace(**cfg_kw)
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(seed))
    tcfg = get_config("llama2-7b").smoke_config().replace(**cfg_kw)
    tm = build_model(tcfg, local_plan(param_dtype=torch.float32,
                                      compute_dtype=torch.float32),
                     device="cpu")
    return (jm, jp), (tm, from_jax_params(jax.tree.map(np.asarray, jp),
                                          device="cpu"))


@pytest.fixture(scope="module")
def weights():
    """Per engine seed i: the full model (seed i) and the small variant
    (seed i + 10), as ``EngineSpec`` seeds them."""
    out = {"jax": [], "port": []}
    small = dict(num_layers=1, d_ff=64, name="llama2-smaller")
    for i in range(2):
        jf, tf = _model_pair({}, i)
        js, ts = _model_pair(small, i + 10)
        out["jax"].append((jf, js))
        out["port"].append((tf, ts))
    return out


def _engine(weights, side, i, **kw):
    ns = JAX_SIDE if side == "jax" else PORT_SIDE
    (m, p), small = weights[side][i]
    kw.setdefault("max_seq", 96)
    kw.setdefault("n_slots", 4)
    eng = ns["Engine"](m, p, knobs=ns["Knobs"](max_batch=kw["n_slots"]),
                       paged=True, block_size=16, seed=i, **kw)
    eng.add_variant("small", *small)
    return eng


def _sim(ns, **over):
    dc = ns["DC"](n_rows=2, racks_per_row=2, servers_per_rack=4,
                  region="hot")
    S = ns["S"]
    scenario = S.Scenario((
        S.FailureEvent(kind="thermal", start_h=2.0, end_h=6.0, target=0),
        S.DemandSurge(start_h=2.0, end_h=6.0, scale=1.4)))
    cfg = dict(dc=dc, horizon_h=8.0, tick_min=10.0, seed=1,
               policy=ns["SIM"].TAPAS, occupancy=0.95, demand_scale=1.0,
               scenario=scenario)
    cfg.update(over)
    return ns["SIM"].ClusterSim(ns["SIM"].SimConfig(**cfg),
                                **ns["kw"])


def _knobs(eng):
    k = eng.knobs
    return (k.freq_scale, k.max_batch, k.variant, k.paused)


def _loop(weights, side):
    """engine_in_the_loop.py's driver, recording what it prints and more."""
    ns = JAX_SIDE if side == "jax" else PORT_SIDE
    sim = _sim(ns)
    backends = {}
    while len(backends) < 2 and sim.tick < sim.ticks:
        state = sim.step()
        saas = np.flatnonzero(state.kind == 2)
        if len(saas) >= 2 and not backends:
            for i, srv in enumerate(saas[:2]):
                b = ns["Backend"](_engine(weights, side, i), seed=i,
                                  variant_for_size=VARIANTS)
                sim.attach_backend(int(srv), b)
                backends[int(srv)] = b
    servers = sorted(backends)
    knobs, risk, serving = [], [], []
    while sim.tick < sim.ticks:
        state = sim.step()
        knobs.append({s: _knobs(backends[s].engine) for s in servers})
        risk.append([float(state.risk[s]) for s in servers])
        serving.append({s: (backends[s].engine.stats.n_steps,
                            state.measured_goodput.get(s, 0.0))
                        for s in servers})
    return {
        "servers": servers,
        "applied": {s: [dataclasses.astuple(c) for c in backends[s].applied]
                    for s in servers},
        "knobs": knobs, "risk": risk,
        "requests": {s: [(tuple(r.output), r.outcome)
                         for r in backends[s].issued] for s in servers},
        "stats": {s: {k: getattr(backends[s].engine.stats, k)
                      for k in ("decode_tokens", "prefill_tokens",
                                "variant_swaps", "preemptions",
                                "submitted")} for s in servers},
        "summary": sim.result().summary(),
        "serving": serving,
    }


@pytest.fixture(scope="module")
def loops(weights):
    return {side: _loop(weights, side) for side in ("jax", "port")}


def test_engine_in_the_loop_matches_reference(loops):
    want, got = loops["jax"], loops["port"]
    for k in ("servers", "applied", "knobs", "requests", "stats"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["risk"], want["risk"], rtol=1e-5)
    # the loop closed: live decisions reached the engines and turned knobs
    assert any(len(a) > 1 for a in got["applied"].values())
    assert len({tuple(sorted(k.items())) for k in got["knobs"]}) > 1
    assert all(st["submitted"] > 0 and st["decode_tokens"] > 0
               for st in got["stats"].values())


def test_backends_are_telemetry_only(loops):
    """The summary with engines in the loop equals the summary without,
    in the port, and against the reference's."""
    for side in ("jax", "port"):
        ns = JAX_SIDE if side == "jax" else PORT_SIDE
        bare = _sim(ns).run().summary()
        assert loops[side]["summary"] == bare, side
    want, got = loops["jax"]["summary"], loops["port"]["summary"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-12,
                                   err_msg=k)


def test_measured_goodput_is_wall_clock_telemetry(loops, weights):
    """> 0 on a tick whose steps served; 0 when paused and drained."""
    got = loops["port"]
    served = [g for tick in got["serving"] for (_, g) in tick.values()]
    assert any(g > 0 for g in served)
    prev = {s: 0 for s in got["servers"]}
    for tick in got["serving"]:
        for s, (steps, g) in tick.items():
            assert (g > 0) == (steps > prev[s]), (s, steps, g)
            prev[s] = steps
    eng = _engine(weights, "port", 0)
    bk = EngineBackend(eng, seed=0)
    assert bk.pump(now=0.0, load=1.0) > 0 and bk.measured_goodput() > 0
    eng.knobs.paused = True
    for h in range(1, 20):
        bk.pump(now=h / 60.0, load=1.0)
        if not eng.active:
            break
    bk.pump(now=1.0, load=1.0)            # queued, nothing admitted
    assert not eng.active and eng.queue
    assert bk.measured_goodput() == 0.0


def test_apply_config_matches_reference(weights):
    """Every ConfigPoint lands on the same knobs (variant reloads, batch
    map, freq) as the reference's backend does."""
    rng = np.random.default_rng(0)
    pts = [dataclasses.astuple(c.cfg) for c in JPR.build_profile()]
    picks = [pts[i] for i in rng.integers(0, len(pts), 25)]

    def run(side):
        ns = JAX_SIDE if side == "jax" else PORT_SIDE
        bk = ns["Backend"](_engine(weights, side, 0), seed=0,
                           variant_for_size=VARIANTS,
                           batch_for_knob={1: 1, 16: 2, 64: 4})
        out = []
        for i, p in enumerate(picks):
            bk.apply_config(ns["P"].ConfigPoint(*p), paused=i % 5 == 0)
            out.append((_knobs(bk.engine), bk.engine.stats.variant_swaps))
        return out

    assert run("port") == run("jax")
    with pytest.raises(ValueError, match="not registered"):
        EngineBackend(_engine(weights, "port", 0),
                      variant_for_size={"7b": "tiny"})


def test_backend_drops_drafter_under_freq_cap(weights):
    """Speculation as a reconfigure axis: a deep frequency cap stashes the
    drafter, lifting the cap restores it (the reference's
    ``test_backend_drops_drafter_under_freq_cap``, on both engines)."""
    def run(side):
        ns = JAX_SIDE if side == "jax" else PORT_SIDE
        eng = _engine(weights, side, 0, horizon=4, draft="ngram", spec_k=2)
        bk = ns["Backend"](eng, draft_min_freq=0.7)
        lo = ns["P"].ConfigPoint(freq=0.5, tp=8, batch=16, size="7b",
                                 quant="bf16")
        hi = ns["P"].ConfigPoint(freq=1.0, tp=8, batch=16, size="7b",
                                 quant="bf16")
        out = []
        for c in (lo, lo, hi, lo, hi):
            bk.apply_config(c)
            out.append((eng.draft_name, bk.draft_drops, bk._stashed_draft))
        return out

    got = run("port")
    assert got == run("jax")
    assert got[:3] == [(None, 1, "ngram"), (None, 1, "ngram"),
                       ("ngram", 1, None)]


def _fleet_run(weights, side, refs=None):
    """``test_sharded.py::test_cluster_sim_flushes_fleet_backends`` on a
    2-engine fleet sharing one weight copy.  ``refs``, when given, gets
    weak references to the fleet, the simulator, the engines, their pools
    and the backends."""
    ns = JAX_SIDE if side == "jax" else PORT_SIDE
    share = _engine(weights, side, 0, max_seq=64, n_slots=3)
    cfg = ns["cfg"]("llama2-7b").smoke_config()
    spec = ns["Spec"](cfg, max_seq=64, n_slots=3, block_size=16,
                      variants=(("small", cfg.replace(
                          num_layers=1, d_ff=64, name="llama2-smaller")),))
    fleet = ns["Fleet"](spec, n_engines=2, steps_per_tick=4, share=share,
                        backend_kw=dict(requests_per_load=3.0, prompt_len=4,
                                        max_new_tokens=2))
    sim = _sim(ns, horizon_h=3.0, seed=3, scenario=None)
    attached, measured, bound_ticks = {}, 0, 0
    while sim.tick < sim.ticks:
        bound_ticks += bool(attached)
        st = sim.step()
        for srv in np.flatnonzero(st.kind == 2):
            if int(srv) not in attached:
                bk = fleet.make_backend()
                sim.attach_backend(int(srv), bk)
                attached[int(srv)] = bk
        measured += sum(1 for srv in attached
                        if st.measured_goodput.get(srv, 0.0) > 0.0)
    fleet.drain(now_h=2.0)
    shared = all(e.variants[n][1] is share.variants[n][1]
                 for e in fleet.engines for n in ("full", "small"))
    if refs is not None:
        refs += [weakref.ref(x) for x in (
            fleet, sim, share, *fleet.engines,
            *(e.pool for e in fleet.engines), *attached.values())]
    return {
        "attached": sorted(attached),
        "engine_of": [fleet.engines.index(bk.engine)
                      for _, bk in sorted(attached.items())],
        "flushes": fleet.flushes,
        "requests": {s: [(tuple(r.output), r.outcome) for r in bk.issued]
                     for s, bk in attached.items()},
        "cursors": {s: bk._out_cursor for s, bk in attached.items()},
        "summary": sim.result().summary(),
        "shared": shared, "measured": measured > 0,
        "bound_ticks": bound_ticks,
    }


def test_dropped_engine_fleet_ends_without_the_collector(weights):
    """A fleet that has served inside a simulator, dropped with the cyclic
    collector held off: the fleet, its engines, their pools, its backends
    and the simulator all end at once (no reference cycle keeps a dropped
    fleet's pools alive)."""
    refs = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        out = _fleet_run(weights, "port", refs)
        assert out["measured"] and len(refs) > 7
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        if collecting:
            gc.enable()


def test_engine_fleet_flushes_once_per_tick_matching_reference(weights):
    want, got = _fleet_run(weights, "jax"), _fleet_run(weights, "port")
    assert got["shared"] and want["shared"]     # one weight copy
    assert got["measured"]
    for k in ("attached", "engine_of", "flushes", "requests", "cursors"):
        assert got[k] == want[k], k
    assert got["flushes"] == got["bound_ticks"] > 0   # once per bound tick
    assert set(got["engine_of"]) == {0, 1}             # round-robin
    assert any(o for reqs in got["requests"].values() for o, _ in reqs)


def test_spec_build_share_aliases_every_variant_and_drafter():
    cfg = get_config("llama2-7b").smoke_config()
    small = cfg.replace(num_layers=1, d_ff=32, name="s")
    spec = EngineSpec(cfg, max_seq=32, n_slots=2, block_size=8,
                      variants=(("small", small),),
                      drafters=(("d", small),), draft="d")
    first = spec.build(device="cpu")
    other = spec.build(share=first)
    assert other is not first and other.pool is not first.pool
    for reg in ("variants", "drafters"):
        a, b = getattr(first, reg), getattr(other, reg)
        assert a.keys() == b.keys()
        assert all(a[n][0] is b[n][0] and a[n][1] is b[n][1] for n in a)
    assert other.draft_name == "d" and other.model.device.type == "cpu"
