"""The port's engine-side resilience paths against the live JAX engine on
the CPU (the engine tests of ``tests/test_resilience.py``, each run on
both engines).

Both engines serve the same requests on the same weights (a JAX
``Model.init`` tree carried over with ``from_jax_params``, f32 plan over a
bf16 pool, as the other engine parity tests do): deadline eviction, the
NaN guard's quarantine and retry, crash/restore in requeue and drop mode,
the terminal-outcome audit under a variant swap, the no-fault path, the
replayed fault drill and the three arms of ``examples/fault_storm.py`` at
smoke size.  Streams, outcomes and counters are held exactly, except the
streams of requests that decoded from NaN KV with the guard off: those
are held by their outcomes and audit counts (on this CPU both engines
pick token 0 from all-NaN logits; ROADMAP.md, Queue 3)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_jit_memo import shared_jit  # noqa: E402,F401

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.core import scenario as JS  # noqa: E402
from repro.core import simulator as JSIM  # noqa: E402
from repro.core.datacenter import DCConfig as JDC  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineBackend as JBackend  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import scenario as TS  # noqa: E402
from repro_torch.core import simulator as TSIM  # noqa: E402
from repro_torch.core.datacenter import DCConfig as TDC  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.serving import Engine, EngineBackend, EngineKnobs  # noqa: E402
from repro_torch.serving import Request  # noqa: E402

COUNTERS = ("submitted", "timed_out", "retried", "retry_exhausted",
            "quarantined", "guard_scans", "crashes", "rejected",
            "preemptions", "variant_swaps", "decode_tokens",
            "prefill_tokens", "prefill_batches", "host_syncs",
            "decode_syncs")

JAX_SIDE = dict(Engine=JEngine, Knobs=JKnobs, Request=JRequest,
                Backend=JBackend, F=JF, S=JS, SIM=JSIM, DC=JDC)
PORT_SIDE = dict(Engine=Engine, Knobs=EngineKnobs, Request=Request,
                 Backend=EngineBackend, F=TF, S=TS, SIM=TSIM, DC=TDC)


def _pair(cfg_name_or_cfg, seed):
    jcfg = cfg_name_or_cfg
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(seed))
    tcfg = get_config("llama2-7b").smoke_config().replace(
        **{f: getattr(jcfg, f) for f in ("num_layers", "d_ff", "name")})
    tm = build_model(tcfg, local_plan(param_dtype=torch.float32,
                                      compute_dtype=torch.float32),
                     device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return (jm, jp), (tm, tp)


@pytest.fixture(scope="module")
def models():
    cfg = j_get_config("llama2-7b").smoke_config()
    jfull, tfull = _pair(cfg, 0)
    small = cfg.replace(num_layers=1, d_ff=32, name="t-small")
    jsmall, tsmall = _pair(small, 7)
    return {"jax": (jfull, jsmall), "port": (tfull, tsmall)}


def _engine(models, side, **kw):
    (m, p), _ = models[side]
    ns = JAX_SIDE if side == "jax" else PORT_SIDE
    kw.setdefault("max_seq", 64)
    kw.setdefault("n_slots", 3)
    kw.setdefault("block_size", 8)
    kw.setdefault("paged", True)
    kw.setdefault("knobs", ns["Knobs"](max_batch=kw["n_slots"]))
    return ns["Engine"](m, p, **kw)


def _submit(side, eng, vocab, *, n_req=4, max_new=6, seed=0, **req_kw):
    R = (JAX_SIDE if side == "jax" else PORT_SIDE)["Request"]
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_req):
        plen = int(rng.integers(4, 16))
        req = R(prompt=[int(t) for t in rng.integers(0, vocab, plen)],
                max_new_tokens=max_new, **req_kw)
        eng.submit(req)
        reqs.append(req)
    return reqs


def _streams(reqs):
    return [tuple(r.output) for r in sorted(reqs, key=lambda r: r.req_id)]


def _outcomes(reqs):
    return [r.outcome for r in sorted(reqs, key=lambda r: r.req_id)]


def _run_dry(eng, *, now=0.0, max_steps=500):
    for _ in range(max_steps):
        if not (eng.queue or eng.active or eng.prefilling or eng._delayed):
            return
        eng.step(now=now)
        now += 1.0
    raise AssertionError("engine did not drain")


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _counters(eng):
    return {k: getattr(eng.stats, k) for k in COUNTERS}


def _audit(F, reqs):
    a = F.audit_requests(reqs)
    base = min(r.req_id for r in reqs)
    return {**a, "lost": [r - base for r in a["lost"]]}


def _both(fn, models):
    """``fn(side)`` on each engine; their results must be equal."""
    want, got = fn("jax"), fn("port")
    assert got == want
    return got


def test_deadline_evicts_queued_and_active(models):
    def run(side):
        eng = _engine(models, side)
        reqs = _submit(side, eng, eng.model.cfg.vocab_size, n_req=3,
                       max_new=40, seed=1, arrival_s=0.0, deadline_ms=5_000.0)
        eng.knobs.max_batch = 2
        eng.step(now=0.0)                  # two admitted, one queued
        before = (len(eng.active), len(eng.queue))
        eng.step(now=10.0)                 # everyone is past 5 s now
        F = (JAX_SIDE if side == "jax" else PORT_SIDE)["F"]
        return (before, _outcomes(reqs), _counters(eng), _audit(F, reqs),
                bool(eng.queue or eng.active or eng.prefilling),
                eng.pool.used_blocks)

    before, outcomes, counters, audit, busy, used = _both(run, models)
    assert before[0] >= 1 and before[1] >= 1
    assert outcomes == ["timed_out"] * 3 and counters["timed_out"] == 3
    assert audit["lost"] == [] and not busy and used == 0


def test_nan_guard_quarantine_recovers_exact_streams(models):
    def run(side):
        base = _engine(models, side)
        vocab = base.model.cfg.vocab_size
        base_reqs = _submit(side, base, vocab, n_req=4, max_new=6, seed=2)
        _run_dry(base)
        eng = _engine(models, side)
        reqs = _submit(side, eng, vocab, n_req=4, max_new=6, seed=2)
        eng.step(now=0.0)
        eng.inject_kv_corruption(sorted(eng.active)[0], last_block=True)
        _run_dry(eng, now=1.0)
        free = sorted(eng.pool.free_blocks)
        cache = eng.pool.cache["attn"]
        pristine = all(bool(np.isfinite(_f32(cache[n][:, free])).all())
                       for n in ("k", "v"))
        return (_streams(base_reqs), _streams(reqs), _outcomes(reqs),
                _counters(eng), pristine)

    base, streams, outcomes, counters, pristine = _both(run, models)
    assert counters["quarantined"] == 1 and counters["guard_scans"] == 1
    assert counters["retried"] == 1
    assert outcomes == ["accepted"] * 4
    assert streams == base            # recompute recovery: exact streams
    assert pristine                   # scrubbed before re-entering the list


def test_unguarded_corruption_is_held_by_outcomes(models):
    """The guard off: the corruption stays and the next decodes read it.
    Outcomes and counters are held exactly; the poisoned stream differs
    from the clean one on both engines."""
    def run(side):
        base = _engine(models, side)
        vocab = base.model.cfg.vocab_size
        base_reqs = _submit(side, base, vocab, n_req=4, max_new=6, seed=2)
        _run_dry(base)
        off = _engine(models, side)
        reqs = _submit(side, off, vocab, n_req=4, max_new=6, seed=2)
        off.step(now=0.0)
        off.inject_kv_corruption(sorted(off.active)[0], last_block=True,
                                 arm_guard=False)
        _run_dry(off, now=1.0)
        return (_outcomes(reqs), _counters(off),
                _streams(reqs) != _streams(base_reqs))

    outcomes, counters, poisoned = _both(run, models)
    assert counters["quarantined"] == 0 and poisoned
    assert outcomes == ["accepted"] * 4


def test_crash_requeues_and_recovers_exact_streams(models):
    def run(side):
        F = (JAX_SIDE if side == "jax" else PORT_SIDE)["F"]
        base = _engine(models, side)
        vocab = base.model.cfg.vocab_size
        base_reqs = _submit(side, base, vocab, n_req=4, max_new=6, seed=3)
        _run_dry(base)
        eng = _engine(models, side)
        reqs = _submit(side, eng, vocab, n_req=4, max_new=6, seed=3)
        eng.step(now=0.0)
        dropped = eng.crash(1.0)           # requeue mode
        offline = (eng.offline, eng.heartbeat(), eng.step(now=2.0))
        eng.restore()
        _run_dry(eng, now=3.0)
        off = _engine(models, side)
        off_reqs = _submit(side, off, vocab, n_req=4, max_new=6, seed=3)
        off.step(now=0.0)
        lost = off.crash(1.0, drop=True)
        off.restore()
        _run_dry(off, now=2.0)
        base_id = min(r.req_id for r in off_reqs)
        return (dropped, offline, _streams(base_reqs), _streams(reqs),
                _outcomes(reqs), _counters(eng),
                sorted(r.req_id - base_id for r in lost),
                [r.outcome for r in lost], _audit(F, off_reqs),
                _streams(off_reqs), _counters(off))

    (dropped, offline, base, streams, outcomes, counters, lost, lost_out,
     audit, _, _) = _both(run, models)
    assert dropped == [] and offline == (True, False, 0)
    assert counters["crashes"] == 1 and counters["retried"] == 0
    assert outcomes == ["accepted"] * 4 and streams == base
    assert lost and all(o is None for o in lost_out)
    assert audit["lost"] == lost


def test_terminal_outcomes_exclusive_exhaustive_no_stats_drift(models):
    """A request preempted by a variant swap and then timed out counts
    once as timed_out, never as a retry, and its tokens stay out of
    goodput."""
    def run(side):
        F = (JAX_SIDE if side == "jax" else PORT_SIDE)["F"]
        eng = _engine(models, side)
        eng.add_variant("small", *models[side][1])
        vocab = eng.model.cfg.vocab_size
        reqs = _submit(side, eng, vocab, n_req=3, max_new=30, seed=4,
                       arrival_s=0.0, deadline_ms=4_000.0)
        ok = _submit(side, eng, vocab, n_req=1, max_new=3, seed=5)
        eng.step(now=0.0)
        active = bool(eng.active)
        eng.set_variant("small")           # preempts every in-flight lane
        swapped = _counters(eng)
        _run_dry(eng, now=10.0)            # past every deadline
        good = eng.stats.goodput(ttft_slo=1e9, tbt_slo=1e9)
        t_max = max(r.finish_s for r in eng.stats.completed)
        return (active, swapped, _audit(F, reqs + ok), _counters(eng),
                len(eng.stats.completed), _streams(ok), good,
                sum(len(r.output) for r in ok) / t_max)

    active, swapped, audit, counters, n_done, _, good, want_good = \
        _both(run, models)
    assert active and swapped["preemptions"] >= 1
    assert swapped["variant_swaps"] == 1 and swapped["retried"] == 0
    assert audit["lost"] == [] and audit["outcomes"]["timed_out"] == 3
    assert audit["outcomes"]["accepted"] == 1
    assert counters["timed_out"] == 3 and counters["submitted"] == 4 == n_done
    assert counters["retried"] == 0 and counters["retry_exhausted"] == 0
    assert good == pytest.approx(want_good)


def test_retry_budget_and_backoff_match_reference(models):
    """Corrupt the same request until its budget is burned: backoff
    releases at now + 0.05 * 2**(retries-1), then it finishes rejected."""
    def run(side):
        eng = _engine(models, side)
        reqs = _submit(side, eng, eng.model.cfg.vocab_size, n_req=2,
                       max_new=20, seed=6, max_retries=2)
        trace, now = [], 0.0
        for _ in range(40):
            if not (eng.queue or eng.active or eng._delayed):
                break
            victim = reqs[0].req_id
            if victim in eng.active and reqs[0].outcome is None:
                eng.inject_kv_corruption(victim)
            eng.step(now=now)
            base = reqs[0].req_id
            trace.append((now, [r - base for r in sorted(eng.active)],
                          len(eng.queue),
                          [round(d[0], 6) for d in eng._delayed]))
            now += 0.03
        return trace, _outcomes(reqs), _counters(eng), _streams(reqs)

    trace, outcomes, counters, _ = _both(run, models)
    assert outcomes == ["rejected", "accepted"]
    assert counters["retried"] == 2 and counters["retry_exhausted"] == 1
    assert counters["quarantined"] == 3


def test_no_fault_path_parity(models):
    """Resilience at rest is invisible: the same streams and host syncs
    with or without deadlines armed, as long as none fires."""
    def run(side):
        plain = _engine(models, side)
        vocab = plain.model.cfg.vocab_size
        plain_reqs = _submit(side, plain, vocab, n_req=5, max_new=6, seed=6)
        _run_dry(plain)
        armed = _engine(models, side)
        armed_reqs = _submit(side, armed, vocab, n_req=5, max_new=6, seed=6,
                             arrival_s=0.0, deadline_ms=3_600_000.0,
                             max_retries=5)
        _run_dry(armed)
        return (_streams(plain_reqs), _streams(armed_reqs), _counters(plain),
                _counters(armed))

    plain, armed, pc, ac = _both(run, models)
    assert armed == plain and ac["host_syncs"] == pc["host_syncs"]
    assert ac["guard_scans"] == 0 and ac["timed_out"] == 0


def test_paused_knob_holds_admission(models):
    def run(side):
        eng = _engine(models, side)
        reqs = _submit(side, eng, eng.model.cfg.vocab_size, n_req=3,
                       max_new=4, seed=8)
        eng.knobs.paused = True
        idle = [eng.step(now=float(i)) for i in range(3)]
        held = (len(eng.queue), len(eng.active))
        eng.knobs.paused = False
        _run_dry(eng, now=3.0)
        return idle, held, _streams(reqs), _counters(eng)

    idle, held, _, _ = _both(run, models)
    assert idle == [0, 0, 0] and held == (3, 0)


def test_take_unfinished_rehomes_deterministically(models):
    def run(side):
        eng = _engine(models, side)
        vocab = eng.model.cfg.vocab_size
        reqs = _submit(side, eng, vocab, n_req=5, max_new=8, seed=9)
        eng.step(now=0.0)
        taken = eng.take_unfinished()
        base = min(r.req_id for r in reqs)
        ids = [r.req_id - base for r in taken]
        other = _engine(models, side)
        for r in taken:
            other.submit(r)
        _run_dry(other, now=1.0)
        return (ids, eng.pool.used_blocks, _streams(reqs), _outcomes(reqs))

    ids, used, _, outcomes = _both(run, models)
    assert ids == [0, 1, 2, 3, 4] and used == 0
    assert outcomes == ["accepted"] * 5


def test_kv_faults_refused_as_reference(models):
    for side in ("jax", "port"):
        eng = _engine(models, side)
        with pytest.raises(KeyError):
            eng.inject_kv_corruption(12345)
        slots = _engine(models, side, paged=False)
        with pytest.raises(ValueError, match="paged pool"):
            slots.inject_kv_corruption(0)


# ---------------------------------------------------------------------------
# cluster drills: the replayed fault drill and the fault storm's three arms
# ---------------------------------------------------------------------------

def _attach_plan(ns, dc_kw, kw):
    probe = ns["SIM"].ClusterSim(ns["SIM"].SimConfig(
        dc=ns["DC"](**dc_kw), scenario=ns["S"].Scenario(), **kw),
        **({} if ns is JAX_SIDE else {"device": "cpu"}))
    while probe.tick < probe.ticks:
        st = probe.step()
        saas = [int(s) for s in np.flatnonzero(st.kind == 2)]
        if len(saas) >= 2:
            return probe.tick, saas
    raise AssertionError("drill datacenter never placed 2 SaaS servers")


def _drill(models, side, *, dc_kw, kw, events, knobs, backend_kw, end_h):
    ns = JAX_SIDE if side == "jax" else PORT_SIDE
    F, S = ns["F"], ns["S"]
    attach_tick, saas = _attach_plan(ns, dc_kw, kw)
    evs = events(S, F, saas)
    res = knobs(F) if knobs is not None else F.ResilienceKnobs()
    sim = ns["SIM"].ClusterSim(ns["SIM"].SimConfig(
        dc=ns["DC"](**dc_kw), scenario=S.Scenario(tuple(evs)),
        resilience=res, **kw),
        **({} if side == "jax" else {"device": "cpu"}))
    backends, max_age = {}, 0
    while sim.tick < sim.ticks:
        st = sim.step()
        max_age = max(max_age, st.telemetry_age_ticks)
        if sim.tick == attach_tick and not backends:
            for srv in saas[:2]:
                bk = ns["Backend"](
                    _engine(models, side, max_seq=96, n_slots=4,
                            block_size=8), seed=srv,
                    ladder=F.DegradationLadder() if res.ladder else None,
                    **backend_kw)
                sim.attach_backend(srv, bk)
                backends[srv] = bk
    for bk in backends.values():
        bk.drain(now_h=end_h(sim))
    issued = [r for bk in backends.values() for r in bk.issued]
    engines = [bk.engine for bk in backends.values()]
    return {
        "audit": _audit(F, issued),
        "counters": [_counters(e) for e in engines],
        "dropped": sum(len(bk.dropped) for bk in backends.values()),
        "watchdog": sim.watchdog_drains,
        "ladder": [bk.ladder.walks if bk.ladder else None
                   for bk in backends.values()],
        "max_age": max_age,
        "outcomes": _outcomes(issued),
        "streams": _streams(issued),
        "applied": {s: [tuple(vars(c).values()) for c in bk.applied]
                    for s, bk in backends.items()},
    }


def test_fault_drill_matches_reference_and_replays(models):
    """The reference's replayed drill (``tests/test_resilience.py``): same
    seed and scenario, the same fault timeline, outcomes and recovered
    streams; twice in the port, once in the reference."""
    dc_kw = dict(n_rows=1, racks_per_row=2, servers_per_rack=4)
    kw = dict(horizon_h=1.2, tick_min=6.0, seed=2, policy=None,
              occupancy=0.95, demand_scale=1.0)

    def events(S, F, saas):
        return (S.FailureEvent(kind="cooling", start_h=0.5, end_h=0.8,
                               target=0),
                F.EngineFault(kind="crash", start_h=0.5, end_h=0.7,
                              server=saas[0]),
                F.EngineFault(kind="nan_burst", start_h=0.6, end_h=0.7,
                              server=saas[1]),
                F.SensorDropout(start_h=0.5, end_h=0.9))

    def run(side):
        ns = JAX_SIDE if side == "jax" else PORT_SIDE
        return _drill(models, side, dc_kw=dc_kw,
                      kw={**kw, "policy": ns["SIM"].TAPAS}, events=events,
                      knobs=None,
                      backend_kw=dict(max_new_tokens=8, steps_per_tick=2,
                                      deadline_ms=3_600_000.0),
                      end_h=lambda sim: float(sim.t_h[-1]) + 1.0)

    got = _both(run, models)
    assert run("port") == got                       # replays bit for bit
    assert got["audit"]["lost"] == []
    assert sum(c["crashes"] for c in got["counters"]) >= 1
    assert got["watchdog"] >= 1


@pytest.mark.parametrize("arm", ["fault_free", "recovery_on",
                                 "recovery_off"])
def test_fault_storm_arms_match_reference(models, arm):
    """``examples/fault_storm.py``'s drill at smoke size: a cooling failure,
    one backend crashing, the other taking a NaN burst, and stale sensors;
    fault-free, with the recovery stack and with ``recovery_off()``."""
    dc_kw = dict(n_rows=2, racks_per_row=2, servers_per_rack=4,
                 region="hot")
    kw = dict(horizon_h=2.0, tick_min=5.0, seed=0, occupancy=0.95,
              demand_scale=1.0)
    storm = arm != "fault_free"

    def events(S, F, saas):
        evs = [S.FailureEvent(kind="cooling", start_h=0.8, end_h=1.2,
                              target=0)]
        if storm:
            evs += [F.EngineFault(kind="crash", start_h=0.9, end_h=1.1,
                                  server=saas[0]),
                    F.EngineFault(kind="nan_burst", start_h=1.0, end_h=1.1,
                                  server=saas[1]),
                    F.SensorDropout(start_h=0.8, end_h=1.3)]
        return evs

    def run(side):
        ns = JAX_SIDE if side == "jax" else PORT_SIDE
        out = _drill(models, side, dc_kw=dc_kw,
                     kw={**kw, "policy": ns["SIM"].TAPAS}, events=events,
                     knobs=(lambda F: F.recovery_off())
                     if arm == "recovery_off" else None,
                     backend_kw=dict(max_new_tokens=8, steps_per_tick=5,
                                     deadline_ms=3_600_000.0),
                     end_h=lambda sim: float(sim.t_h[-1]) + 5.0 / 60.0)
        if arm == "recovery_off":
            out.pop("streams")      # decoded from NaN KV: held by outcomes
        return out

    got = _both(run, models)
    if arm == "recovery_on":
        assert got["audit"]["lost"] == []
        assert sum(c["crashes"] for c in got["counters"]) >= 1
        assert sum(c["quarantined"] for c in got["counters"]) >= 1
        assert got["watchdog"] >= 1 and got["max_age"] > 0
    if arm == "recovery_off":
        assert len(got["audit"]["lost"]) + got["dropped"] > 0
