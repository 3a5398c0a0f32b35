"""Sampling in the port against the live JAX reference on the CPU.

``repro_torch.models.prng`` is ``jax.random``'s threefry path in torch:
keys, 32-bit draws and uniforms must equal jax's bit for bit (under
``jax_threefry_partitionable=True``, jax's default), the gumbel noise
within 4 ulp (XLA's ``log`` and torch's differ in the last bit; near 0
the outer log turns one ulp of the inner into many of the result, so the
ulp is taken at ``max(|g|, 1)``).  The sampling helpers
(``sampling_dist`` at 1e-6, ``sample_from_dist``, ``event_keys`` ...) are
held to the reference's, then a sampled ``decode_multi_paged`` and the
sampled ``Engine`` on every path: token-exact streams and equal counters.

The engines run an f32 plan over a bf16 pool on weights carried over from
a JAX ``Model.init`` tree, as ``test_torch_engine.py`` does; their logits
drift ~1e-5 apart.  Each workload is checked free of near-ties: at every
token of every reference stream the gap between the two largest values
of the decision (the logits for a greedy request, ``log(p + 1e-30)`` plus
the event's gumbel noise for a sampled one) is computed from the
reference's full-sequence logits and must stay above 1e-3; the smallest
gap of each workload is recorded beside it."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.traces import _stable_seed as j_stable_seed  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.traces import _stable_seed  # noqa: E402
from repro_torch.models import build_model, local_plan, prng  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Engine, EngineKnobs, Request  # noqa: E402

STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs")
SALTS = (TT.SALT_SAMPLE, TT.SALT_DRAFT, TT.SALT_ACCEPT, TT.SALT_BONUS)
MARGIN = 1e-3


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def _key(seed: int) -> torch.Tensor:
    return prng.prng_key(torch.tensor(seed, dtype=torch.int32))


# ---------------------------------------------------------------------------
# prng: bit-exact against jax.random
# ---------------------------------------------------------------------------

def test_jax_uses_the_partitionable_layout():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, -1, -2**31])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(_key(seed).numpy(),
                                  _u32(jax.random.PRNGKey(seed)))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), data=st.integers(0, 2**32 - 1),
       n=st.integers(1, 300))
def test_fold_in_and_bits_match_jax(seed, data, n):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(data))
    tk = prng.fold_in(_key(seed), data)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    np.testing.assert_array_equal(prng.random_bits(tk, n).numpy(),
                                  _u32(jax.random.bits(jk, (n,))))
    np.testing.assert_array_equal(prng.uniform(tk, n).numpy(),
                                  np.asarray(jax.random.uniform(jk, (n,))))


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("rank", [1, 2])
def test_event_keys_and_uniform_lanes_match_jax(salt, rank):
    rng = np.random.default_rng(salt + 10 * rank)
    seeds = rng.integers(0, 2**31, 6).astype(np.int32)
    shape = (6,) if rank == 1 else (6, 5)
    idx = rng.integers(0, 1 << 20, shape).astype(np.int32)
    jkeys = JT.event_keys(JT.lane_keys(jnp.asarray(seeds)), jnp.asarray(idx),
                          salt)
    tkeys = TT.event_keys(TT.lane_keys(torch.from_numpy(seeds)),
                          torch.from_numpy(idx), salt)
    assert tkeys.shape == idx.shape + (2,)
    np.testing.assert_array_equal(tkeys.numpy(), _u32(jkeys))
    np.testing.assert_array_equal(TT.uniform_lanes(tkeys).numpy(),
                                  np.asarray(JT.uniform_lanes(jkeys)))


def _fegetround() -> int:
    """The C library's rounding mode (FE_TONEAREST is 0 on x86-64 and
    aarch64), read through ctypes: a diagnostic of the failure message."""
    import ctypes
    import ctypes.util
    return ctypes.CDLL(ctypes.util.find_library("m")).fegetround()


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_gumbel_within_4_ulp_of_jax(seed):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    want = np.asarray(jax.random.gumbel(jk, (50000,)))
    got = prng.gumbel(prng.fold_in(_key(seed), 17), 50000).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    bad = ~(np.abs(got - want) <= 4 * ulp)
    assert not bad.any(), (want[bad][:5], got[bad][:5], torch.get_num_threads(),
                           "first bad index", int(np.flatnonzero(bad)[0]),
                           "fegetround", _fegetround())


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_categorical_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((8, 300))).astype(np.float32)
    keys = TT.event_keys(TT.lane_keys(torch.arange(8, dtype=torch.int32)),
                         torch.full((8,), seed, dtype=torch.int32), 0)
    jkeys = JT.event_keys(JT.lane_keys(jnp.arange(8, dtype=jnp.int32)),
                          jnp.full((8,), seed, jnp.int32), 0)
    want = jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(logits))
    got = prng.categorical(keys, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# sampling_dist / sample_from_dist
# ---------------------------------------------------------------------------

V = 50


def _dist_inputs(top_k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((5, V)).astype(np.float32)
    logits[4, :] = np.round(logits[4, :])        # ties at the k-th value
    temps = np.asarray([0.8, 0.0, 1.5, 1e-9, 0.7], np.float32)
    top_ks = np.full(5, top_k, np.int32)
    return logits, temps, top_ks


@pytest.mark.parametrize("top_k", [0, 1, 3, V, V + 7, -2])
def test_sampling_dist_matches_reference(top_k):
    logits, temps, top_ks = _dist_inputs(top_k)
    want = np.asarray(JT.sampling_dist(jnp.asarray(logits),
                                       jnp.asarray(temps),
                                       jnp.asarray(top_ks)))
    got = TT.sampling_dist(torch.from_numpy(logits), torch.from_numpy(temps),
                           torch.from_numpy(top_ks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the greedy lane is an exact one-hot of the argmax
    np.testing.assert_array_equal(got[1], np.eye(V, dtype=np.float32)[
        logits[1].argmax()])
    np.testing.assert_array_equal(got > 0, want > 0)


def test_sample_from_dist_matches_reference():
    logits, temps, top_ks = _dist_inputs(8, seed=4)
    seeds = np.asarray([5, 6, 7, 8, 9], np.int32)
    idx = np.asarray([10, 11, 300, 4, 4], np.int32)
    jdist = JT.sampling_dist(jnp.asarray(logits), jnp.asarray(temps),
                             jnp.asarray(top_ks))
    want = JT.sample_from_dist(
        JT.event_keys(JT.lane_keys(jnp.asarray(seeds)), jnp.asarray(idx), 0),
        jdist, jnp.asarray(temps) <= 0)
    tdist = TT.sampling_dist(torch.from_numpy(logits),
                             torch.from_numpy(temps), torch.from_numpy(top_ks))
    got = TT.sample_from_dist(
        TT.event_keys(TT.lane_keys(torch.from_numpy(seeds)),
                      torch.from_numpy(idx), 0),
        tdist, torch.from_numpy(temps) <= 0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1] == logits[1].argmax()       # the greedy lane: the argmax


def test_greedy_lanes_take_the_exact_argmax():
    """Greedy lanes are the argmax whatever the key, even where a
    categorical over the one-hot's log would be only almost surely so."""
    logits = torch.randn(64, 40, generator=torch.Generator().manual_seed(0))
    temps = torch.zeros(64)
    dist = TT.sampling_dist(logits, temps, torch.zeros(64, dtype=torch.int32))
    keys = TT.event_keys(TT.lane_keys(torch.arange(64, dtype=torch.int32)),
                         torch.arange(64, dtype=torch.int32), 0)
    got = TT.sample_from_dist(keys, dist, temps <= 0)
    assert torch.equal(got, logits.argmax(-1).to(torch.int32))


def test_stable_seed_matches_reference():
    for parts in (("request", 0, 5), ("request", 3, 2**40), ("x",)):
        assert _stable_seed(*parts) == j_stable_seed(*parts)


# ---------------------------------------------------------------------------
# the sampled horizon
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    jcfg = j_get_config("llama2-7b").smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("llama2-7b").smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32), device="cpu")
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture(scope="module")
def rwkv():
    jcfg = j_get_config("rwkv6-3b").smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("rwkv6-3b").smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32), device="cpu")
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def test_sampled_decode_multi_paged_matches_reference(llama):
    """A horizon of 4 with two sampled lanes (one top-k), a greedy lane
    and a parked one: tokens where emitted, the flags and the final lane
    state equal the reference's."""
    jm, jp, tm, tp = llama
    rng = np.random.default_rng(3)
    B, bs, T = 4, 8, 6
    n_blocks = 1 + B * T
    bt = rng.permutation(np.arange(1, n_blocks))[: B * T] \
        .reshape(B, T).astype(np.int32)
    pos = rng.integers(0, T * bs - 8, B).astype(np.int32)
    tokens = rng.integers(0, 128, B).astype(np.int32)
    shape = (tm.cfg.num_layers, n_blocks, bs, tm.cfg.n_kv_heads,
             tm.cfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    active = np.asarray([True, True, False, True])
    budgets = np.asarray([9, 9, 9, 2], np.int32)
    eos = np.full(B, -1, np.int32)
    temps = np.asarray([0.8, 0.0, 1.0, 1.3], np.float32)
    top_ks = np.asarray([0, 0, 5, 3], np.int32)
    seeds = np.asarray([5, 9, 2**31 - 1, 0], np.int32)
    args = (tokens, pos, bt, active, budgets, eos)
    samp = (temps, top_ks, seeds)
    jout = jax.jit(jm.decode_multi_paged,
                   static_argnames=("num_steps", "max_len"))(
        jp, {"attn": {n: jnp.asarray(a, jnp.bfloat16)
                      for n, a in pool.items()}},
        *map(jnp.asarray, args), num_steps=4, max_len=64,
        **dict(zip(("temps", "top_ks", "seeds"), map(jnp.asarray, samp))))
    tout = tm.decode_multi_paged(
        tp, {"attn": {n: torch.from_numpy(a).bfloat16()
                      for n, a in pool.items()}},
        *map(torch.from_numpy, args), num_steps=4, max_len=64,
        **dict(zip(("temps", "top_ks", "seeds"), map(torch.from_numpy,
                                                     samp))))
    j_em, t_em = np.asarray(jout[1]), tout[1].numpy()
    np.testing.assert_array_equal(t_em, j_em)
    np.testing.assert_array_equal(tout[0].numpy()[t_em],
                                  np.asarray(jout[0])[j_em])
    assert t_em.sum(axis=0).tolist() == [4, 4, 0, 2]
    for t_state, j_state in zip(tout[3], jout[3]):
        np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))


# ---------------------------------------------------------------------------
# the sampled Engine, every path
# ---------------------------------------------------------------------------

def _load(vocab: int, seed: int, n: int = 8, lo: int = 4, hi: int = 24,
          head: list | None = None) -> list:
    """(prompt, max_new, request kwargs): odd requests sampled at
    temperature 0.8 (top-k 40 on every other one), explicit seeds on the
    first two of them, the rest derived from the engine seed; even ones
    greedy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = (head or []) + [int(t) for t in
                                 rng.integers(0, vocab, int(rng.integers(lo,
                                                                         hi)))]
        kw = {}
        if i % 2:
            kw = dict(temperature=0.8, top_k=40 if i % 4 == 1 else 0,
                      seed=1000 + i if i < 4 else None)
        out.append((prompt, 16, kw))
    return out


# each (engine, model, load, engine kwargs) served once per module: the
# near-tie checks read the reference streams the engine tests served, and
# the horizon/preemption check the port streams (the runs are
# deterministic, so a second run would give the same dict)
_SERVED: dict = {}


def _serve(engine_cls, knobs_cls, req_cls, model, params, load, **kw):
    key = (engine_cls, id(model), repr(load), tuple(sorted(kw.items())))
    if key not in _SERVED:
        _SERVED[key] = _serve_once(engine_cls, knobs_cls, req_cls, model,
                                   params, load, **kw)
    return _SERVED[key]


def _serve_once(engine_cls, knobs_cls, req_cls, model, params, load, **kw):
    eng = engine_cls(model, params, max_seq=kw.pop("max_seq", 128),
                     n_slots=4, knobs=knobs_cls(max_batch=4), seed=3, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=m, arrival_s=0.0,
                    req_id=500 + i, **rkw)
            for i, (p, m, rkw) in enumerate(load)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    return {"streams": [tuple(r.output) for r in reqs],
            "completed": len(stats.completed),
            "shared_block_hits": getattr(eng.pool, "shared_block_hits", 0),
            **{k: getattr(stats, k) for k in STATS}}


def _both(pair, load, **kw):
    jm, jp, tm, tp = pair
    ref = _serve(JEngine, JKnobs, JRequest, jm, jp, load, **kw)
    got = _serve(Engine, EngineKnobs, Request, tm, tp, load, **kw)
    assert got == ref
    assert got["completed"] == len(load)
    return got


def _min_margin(pair, load, streams, engine_seed: int = 3) -> float:
    """The smallest top-2 gap of the decision behind every token of the
    reference's ``streams``, from its full-sequence logits (see the module
    docstring)."""
    jm, jp = pair[0], pair[1]
    V = jm.cfg.vocab_size
    ctxs = [list(p) + list(s) for (p, _, _), s in zip(load, streams)]
    S = max(len(c) for c in ctxs)
    tokens = np.zeros((len(ctxs), S), np.int32)
    for r, c in enumerate(ctxs):
        tokens[r, :len(c)] = c
    logits = np.asarray(jax.jit(jm.logits)(jp, jnp.asarray(tokens)))
    rows, temps, top_ks, seeds, idx = [], [], [], [], []
    for r, ((prompt, _, kw), stream) in enumerate(zip(load, streams)):
        seed = kw.get("seed")
        if seed is None:
            seed = j_stable_seed("request", engine_seed, 500 + r)
        for j in range(len(stream)):
            at = len(prompt) + j               # the token being decided
            rows.append(logits[r, at - 1, :V])
            temps.append(kw.get("temperature", 0.0))
            top_ks.append(kw.get("top_k", 0))
            seeds.append(seed % 2**31)
            idx.append(at)
    lg = jnp.asarray(np.stack(rows))
    temps = jnp.asarray(temps, jnp.float32)
    dist = JT.sampling_dist(lg, temps, jnp.asarray(top_ks, jnp.int32))
    keys = JT.event_keys(JT.lane_keys(jnp.asarray(seeds, jnp.int32)),
                         jnp.asarray(idx, jnp.int32), JT.SALT_SAMPLE)
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys)
    vals = jnp.where((temps > 0)[:, None], jnp.log(dist + 1e-30) + noise, lg)
    top = np.sort(np.asarray(vals), axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


# Smallest top-2 gap of each workload (``_min_margin``, the reference's
# streams): llama paged 6.2e-3, llama chunked and prefix-shared 4.2e-3,
# rwkv6-3b slots 5.8e-3, each far above the ~1e-5 drift between the two
# engines' logits.
@pytest.mark.parametrize("horizon,n_blocks", [(1, None), (4, None), (1, 10),
                                              (4, 10)])
def test_sampled_paged_engine_matches_reference(llama, horizon, n_blocks):
    """Mixed greedy and sampled requests, explicit and derived seeds, at
    horizons 1 and 4; ``n_blocks=10`` preempts (and recomputes) requests
    mid-stream without changing a token."""
    load = _load(llama[2].cfg.vocab_size, 0)
    got = _both(llama, load, paged=True, block_size=16, n_blocks=n_blocks,
                horizon=horizon)
    if n_blocks is not None:
        assert got["preemptions"] > 0


def test_sampled_streams_do_not_depend_on_horizon_or_preemption(llama):
    """The keys fold only (seed, sequence index): the port's streams are
    the same at horizon 1 and 4, with and without preemption, and the
    greedy requests' streams equal an all-greedy run's."""
    _, _, tm, tp = llama
    load = _load(tm.cfg.vocab_size, 0)
    runs = [_serve(Engine, EngineKnobs, Request, tm, tp, load, paged=True,
                   block_size=16, n_blocks=nb, horizon=h)
            for h, nb in ((1, None), (4, None), (4, 10))]
    assert runs[0]["streams"] == runs[1]["streams"] == runs[2]["streams"]
    assert runs[2]["preemptions"] > 0
    greedy = _serve(Engine, EngineKnobs, Request, tm, tp,
                    [(p, m, {}) for p, m, _ in load], paged=True,
                    block_size=16, horizon=4)
    for i in range(0, len(load), 2):
        assert runs[1]["streams"][i] == greedy["streams"][i]
    assert any(runs[1]["streams"][i] != greedy["streams"][i]
               for i in range(1, len(load), 2))


def test_sampled_paged_load_is_free_of_near_ties(llama):
    load = _load(llama[2].cfg.vocab_size, 0)
    ref = _serve(JEngine, JKnobs, JRequest, llama[0], llama[1], load,
                 paged=True, block_size=16, n_blocks=None, horizon=4)
    assert _min_margin(llama, load, ref["streams"]) > MARGIN


@pytest.mark.parametrize("horizon,chunk", [(1, 8), (4, 8), (4, 16)])
def test_sampled_chunked_prefix_engine_matches_reference(llama, horizon,
                                                         chunk):
    """Chunked prefill with prefix sharing: every prompt opens with one
    20-token head; the first token of each request comes from its last
    chunk's logits."""
    head = [int(t) for t in np.random.default_rng(7).integers(0, 128, 20)]
    load = _load(llama[2].cfg.vocab_size, 1, head=head)
    got = _both(llama, load, paged=True, block_size=8, horizon=horizon,
                prefill_chunk=chunk, prefix_share=True)
    assert got["shared_block_hits"] > 0


def test_sampled_chunked_load_is_free_of_near_ties(llama):
    head = [int(t) for t in np.random.default_rng(7).integers(0, 128, 20)]
    load = _load(llama[2].cfg.vocab_size, 1, head=head)
    ref = _serve(JEngine, JKnobs, JRequest, llama[0], llama[1], load,
                 paged=True, block_size=8, horizon=4, prefill_chunk=8,
                 prefix_share=True)
    assert _min_margin(llama, load, ref["streams"]) > MARGIN


def test_sampled_slot_engine_matches_reference(llama):
    """The slot pool (``paged=False``): the first token from the
    exact-length prefill, every later one from the slot step."""
    load = _load(llama[2].cfg.vocab_size, 0)
    _both(llama, load, paged=False)


@pytest.mark.parametrize("max_seq", [64, 28])
def test_sampled_rwkv_slot_engine_matches_reference(rwkv, max_seq):
    """rwkv6-3b's smoke model through the slot pool; at max_seq 28 some
    contexts reach the end of the slot."""
    load = _load(rwkv[2].cfg.vocab_size, 2, n=6)
    _both(rwkv, load, paged=None, max_seq=max_seq)


def test_sampled_rwkv_load_is_free_of_near_ties(rwkv):
    load = _load(rwkv[2].cfg.vocab_size, 2, n=6)
    ref = _serve(JEngine, JKnobs, JRequest, rwkv[0], rwkv[1], load,
                 paged=None, max_seq=64)
    assert _min_margin(rwkv, load, ref["streams"]) > MARGIN


def test_engine_spec_passes_its_seed():
    from repro_torch.serving import EngineSpec
    spec = EngineSpec(get_config("llama2-7b").smoke_config(), max_seq=32,
                      n_slots=2, seed=17)
    eng = spec.build(device="cpu")
    assert eng.seed == 17 and not eng.captured
    req = Request(prompt=[1, 2, 3], req_id=4)
    assert eng._req_seed(req) == _stable_seed("request", 17, 4) % 2**31
    assert eng._req_seed(Request(prompt=[1], seed=2**33 + 5)) == 5
