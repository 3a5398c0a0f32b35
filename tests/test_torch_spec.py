"""Speculative decode in the port against the live JAX reference on the CPU.

``ngram_propose`` and ``rejection_choose`` are held exact on the same
numpy inputs; ``decode_verify_paged`` within 1e-4 of the reference's
logits and, inside the port, equal to sequential ``decode_step_paged`` at
each candidate.  Then the speculative ``Engine`` on every path: n-gram
and model drafts, greedy and sampled requests, eos and budget stops, a
mid-flight ``set_drafter`` swap, chunked prefill with prefix sharing and
a pool small enough to preempt: streams token-exact and the spec and sync
counters equal to the JAX engine's, which serves the same requests on the
same weights (a JAX ``Model.init`` tree carried over with
``from_jax_params``, f32 plan over a bf16 pool, as
``test_torch_sampling.py`` does).

Each JAX engine compiles its speculative loop once; its workloads run on
it one after another (the counters are compared per workload, as
differences), so the module takes about 35 s on one worker."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from test_torch_jit_memo import shared_jit  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import check_draft_pair as j_check_draft_pair  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineKnobs as JKnobs  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.drafters import (DRAFT_PAIRS,  # noqa: E402
                                          check_draft_pair, drafter_for)
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import (Engine, EngineKnobs, EngineSpec,  # noqa: E402
                                 Request, serving_plan)

STATS = ("decode_tokens", "prefill_tokens", "prefill_batches", "preemptions",
         "host_syncs", "decode_syncs", "verify_passes", "draft_tokens",
         "accepted_tokens")
F32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
J32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32)


# ---------------------------------------------------------------------------
# ngram_propose / rejection_choose on identical inputs
# ---------------------------------------------------------------------------

def _ngram_cases():
    rng = np.random.default_rng(0)
    # small vocabularies, so suffixes recur
    for S, vocab, n in ((40, 4, 2), (40, 3, 3), (25, 6, 1), (64, 2, 4)):
        hist = rng.integers(0, vocab, (6, S)).astype(np.int32)
        pos = rng.integers(0, S, 6).astype(np.int32)
        pos[:3] = [0, n - 1, S - 1]          # pos < n, the last index
        yield hist, pos, n
    hist = np.arange(40, dtype=np.int32)[None].repeat(3, 0)   # no match
    yield hist, np.asarray([5, 20, 39], np.int32), 2
    for S in (1, 2, 3):                       # S <= n: no window at all
        yield (rng.integers(0, 5, (3, S)).astype(np.int32),
               np.asarray([0, S - 1, S - 1], np.int32), 3)


@pytest.mark.parametrize("k", [1, 4])
def test_ngram_propose_matches_reference(k):
    ref = jax.jit(JT.ngram_propose, static_argnames=("k", "n"))
    for hist, pos, n in _ngram_cases():
        want = np.asarray(ref(jnp.asarray(hist), jnp.asarray(pos), k=k, n=n))
        got = TT.ngram_propose(torch.from_numpy(hist), torch.from_numpy(pos),
                               k=k, n=n)
        assert got.dtype == torch.int32 and got.shape == (hist.shape[0], k)
        np.testing.assert_array_equal(got.numpy(), want)


def _rejection_inputs(spec_k: int, seed: int, V: int = 12, B: int = 64):
    """Drafts drawn from q, half the lanes greedy (one-hot p and q, drafts
    the argmax or not), positions and n_valid varied."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(V, 0.5), (B, spec_k + 1)).astype(np.float32)
    q = rng.dirichlet(np.full(V, 0.5), (B, spec_k)).astype(np.float32)
    drafts = np.stack([[rng.choice(V, p=q[b, j] / q[b, j].sum())
                        for j in range(spec_k)] for b in range(B)]
                      ).astype(np.int32)
    greedy = np.arange(B) % 2 == 0
    am = p.argmax(-1)
    hit = rng.random((B, spec_k)) < 0.7
    drafts[greedy] = np.where(hit, am[:, :spec_k], (am[:, :spec_k] + 1) % V
                              )[greedy]
    p[greedy] = np.eye(V, dtype=np.float32)[am[greedy]]
    q[greedy] = np.eye(V, dtype=np.float32)[drafts[greedy]]
    seeds = rng.integers(0, 2**31, B).astype(np.int32)
    pos = rng.integers(0, 500, B).astype(np.int32)
    n_valid = rng.integers(0, spec_k + 2, B).astype(np.int32)
    return seeds, pos, drafts, q, p, greedy, n_valid


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec_k", [1, 4])
def test_rejection_choose_matches_reference(spec_k, seed):
    seeds, pos, drafts, q, p, greedy, n_valid = _rejection_inputs(spec_k,
                                                                  seed)
    j_acc, j_cand = jax.jit(JT.rejection_choose)(
        JT.lane_keys(jnp.asarray(seeds)), jnp.asarray(pos),
        jnp.asarray(drafts), jnp.asarray(q), jnp.asarray(p),
        jnp.asarray(greedy), jnp.asarray(n_valid))
    t_acc, t_cand = TT.rejection_choose(
        TT.lane_keys(torch.from_numpy(seeds)), torch.from_numpy(pos),
        torch.from_numpy(drafts), torch.from_numpy(q), torch.from_numpy(p),
        torch.from_numpy(greedy), torch.from_numpy(n_valid))
    assert t_acc.dtype == t_cand.dtype == torch.int32
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(t_cand.numpy(), np.asarray(j_cand))
    assert 0 < int(t_acc.sum()) < len(seeds) * spec_k   # mixed outcomes


@pytest.mark.parametrize("spec_k", [1, 4])
def test_rejection_sampling_matches_target_dist(spec_k):
    """The port's ``rejection_choose``: the slot-0 emitted-token marginal is
    the target p (the losslessness theorem), over many lanes with q far
    from p (the reference's ``test_spec_decode.py`` test, on the port)."""
    V, B = 8, 16384
    rng = np.random.default_rng(42)
    p0 = rng.dirichlet(np.full(V, 0.6), size=spec_k + 1).astype(np.float32)
    q0 = rng.dirichlet(np.full(V, 0.6), size=spec_k).astype(np.float32)
    p = torch.from_numpy(p0).expand(B, spec_k + 1, V)
    q = torch.from_numpy(q0).expand(B, spec_k, V)
    drafts = torch.from_numpy(np.stack(
        [rng.choice(V, size=B, p=q0[j] / q0[j].sum())
         for j in range(spec_k)], axis=1).astype(np.int32))
    n_acc, cand = TT.rejection_choose(
        TT.lane_keys(torch.arange(B, dtype=torch.int32)),
        torch.zeros(B, dtype=torch.int32), drafts, q, p,
        torch.zeros(B, dtype=torch.bool),
        torch.full((B,), spec_k + 1, dtype=torch.int32))
    freq = np.bincount(cand[:, 0].numpy(), minlength=V) / B
    assert 0.5 * np.abs(freq - p0[0]).sum() < 0.03     # the target...
    assert 0.5 * np.abs(freq - q0[0]).sum() > 0.1      # ...not the proposer
    assert 0 < int(n_acc.sum()) < B * spec_k


# ---------------------------------------------------------------------------
# decode_verify_paged
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, port model, the same params) for the target
    (llama2-7b's smoke config, seed 0) and a one-layer drafter of the same
    vocabulary (seed 1)."""
    out = {}
    for name, layers, seed in (("target", 2, 0), ("drafter", 1, 1)):
        jcfg = j_get_config("llama2-7b").smoke_config().replace(
            num_layers=layers)
        jm = j_build_model(jcfg, j_local_plan(**J32))
        jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
        tcfg = get_config("llama2-7b").smoke_config().replace(
            num_layers=layers)
        tm = build_model(tcfg, local_plan(**F32), device="cpu")
        out[name] = (jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp),
                                                 device="cpu"))
    return out


def _verify_inputs(cfg, seed=5):
    rng = np.random.default_rng(seed)
    B, Q, bs, T = 3, 5, 8, 6
    n_blocks = 1 + B * T
    tables = (1 + rng.permutation(B * T)).reshape(B, T).astype(np.int32)
    pos = np.asarray([7, 30, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, Q)).astype(np.int32)
    n_valid = np.asarray([5, 3, 0], np.int32)
    shape = (cfg.num_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    return tokens, pos, tables, n_valid, pool


def test_decode_verify_paged_matches_reference(pair):
    """Logits of the valid candidates within 1e-4 of the reference's."""
    jm, jp, tm, tp = pair["target"]
    tokens, pos, tables, n_valid, pool = _verify_inputs(tm.cfg)
    j_logits, _ = jax.jit(jm.decode_verify_paged)(
        jp, {"attn": {n: jnp.asarray(a, jnp.bfloat16)
                      for n, a in pool.items()}},
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(tables),
        jnp.asarray(n_valid))
    t_logits, _ = tm.decode_verify_paged(
        tp, {"attn": {n: torch.from_numpy(a).bfloat16()
                      for n, a in pool.items()}},
        torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(tables), torch.from_numpy(n_valid))
    valid = np.arange(tokens.shape[1])[None] < n_valid[:, None]
    np.testing.assert_allclose(t_logits.numpy()[valid],
                               np.asarray(j_logits)[valid], atol=1e-4,
                               rtol=0)


def test_decode_verify_paged_equals_sequential_steps(pair):
    """Inside the port the fold is the decode step: candidate i's logits
    equal those of ``decode_step_paged`` fed candidates 0..i one at a
    time, and the pool ends the same at every written position."""
    _, _, tm, tp = pair["target"]
    tokens, pos, tables, n_valid, pool = _verify_inputs(tm.cfg)
    fold = {"attn": {n: torch.from_numpy(a).bfloat16()
                     for n, a in pool.items()}}
    seq = {"attn": {n: a.clone() for n, a in fold["attn"].items()}}
    got, _ = tm.decode_verify_paged(
        tp, fold, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(tables), torch.from_numpy(n_valid))
    for b in range(tokens.shape[0]):
        for i in range(int(n_valid[b])):
            want, _ = tm.decode_step_paged(
                tp, seq, torch.from_numpy(tokens[b:b + 1, i]),
                torch.tensor([pos[b] + i], dtype=torch.int32),
                torch.from_numpy(tables[b:b + 1]))
            torch.testing.assert_close(got[b, i], want[0], atol=1e-5, rtol=0)
    # every written block holds the same keys (the parking block aside)
    for n in ("k", "v"):
        assert torch.equal(fold["attn"][n][:, 1:], seq["attn"][n][:, 1:])


def test_decode_spec_paged_matches_reference(pair):
    """Three rounds of n-gram speculation over 4 lanes (two sampled, one
    greedy, one parked; one lane's budget ends mid-round): the emitted
    tokens, flags, accepted counts, final lane state and history equal
    the reference's ``decode_spec_paged``."""
    jm, jp, tm, tp = pair["target"]
    rng = np.random.default_rng(11)
    B, bs, T, S = 4, 8, 8, 64
    tables = (1 + rng.permutation(B * T)).reshape(B, T).astype(np.int32)
    pos = np.asarray([20, 9, 30, 0], np.int32)
    hist = np.zeros((B, S + 1), np.int32)
    for b in range(B):      # a repeating history: n-gram matches
        hist[b, :pos[b] + 1] = np.resize(rng.integers(0, 128, 4),
                                         pos[b] + 1)
    tokens = hist[np.arange(B), pos]
    shape = (tm.cfg.num_layers, 1 + B * T, bs, tm.cfg.n_kv_heads,
             tm.cfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    args = (hist, tokens, pos, tables, np.asarray([True, True, True, False]),
            np.asarray([12, 3, 12, 5], np.int32), np.full(B, -1, np.int32),
            np.asarray([0.8, 0.0, 1.1, 0.0], np.float32),
            np.asarray([0, 0, 5, 0], np.int32),
            np.asarray([5, 6, 7, 8], np.int32))
    kw = dict(num_steps=3, spec_k=3, max_len=S, ngram=2)
    want = jax.jit(jm.decode_spec_paged, static_argnums=(0,),
                   static_argnames=tuple(kw))(
        None, jp, {"attn": {n: jnp.asarray(a, jnp.bfloat16)
                            for n, a in pool.items()}}, None, None,
        *map(jnp.asarray, args), **kw)
    got = tm.decode_spec_paged(
        None, tp, {"attn": {n: torch.from_numpy(a).bfloat16()
                            for n, a in pool.items()}}, None, None,
        *map(torch.from_numpy, args), **kw)
    em = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), em)
    np.testing.assert_array_equal(got[0].numpy()[em], np.asarray(want[0])[em])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    assert em.sum() > 3 * 2 and not em[:, 3].any()


# ---------------------------------------------------------------------------
# the speculative Engine against the JAX Engine
# ---------------------------------------------------------------------------

def _load(vocab: int, seed: int, *, n: int = 6, sampled: bool = False,
          head: list | None = None, eos: int | None = None) -> list:
    """(prompt, max_new, request kwargs): prompts of a random lead-in and a
    5-token phrase said three times (so n-gram drafts can be accepted),
    budgets 10-15; with ``sampled`` the odd requests sample at
    temperature 0.8 (top-k 40 on every other one), explicit seeds on the
    first two; with ``eos`` every third request stops at that token."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        phrase = [int(t) for t in rng.integers(0, vocab, 5)]
        prompt = (head or []) + [int(t) for t in rng.integers(
            0, vocab, int(rng.integers(3, 10)))] + phrase * 3
        kw = {}
        if sampled and i % 2:
            kw = dict(temperature=0.8, top_k=40 if i % 4 == 1 else 0,
                      seed=1000 + i if i < 4 else None)
        if eos is not None and i % 3 == 0:
            kw["eos_id"] = eos
        out.append((prompt, 10 + i, kw))
    return out


def _run(eng, req_cls, load, rid0: int, swaps: dict | None = None) -> dict:
    """Serve ``load`` on ``eng`` (which may have served earlier loads):
    streams and this run's counters; ``swaps`` maps a scheduler step to
    the ``set_drafter`` argument applied before it."""
    before = {k: getattr(eng.stats, k) for k in STATS}
    reqs = [req_cls(prompt=p, max_new_tokens=m, arrival_s=0.0,
                    req_id=rid0 + i, **kw)
            for i, (p, m, kw) in enumerate(load)]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.queue or eng.active or eng.prefilling:
        if swaps and steps in swaps:
            eng.set_drafter(swaps[steps])
        eng.step(now=float(steps))
        steps += 1
        assert steps < 500
    return {"streams": [tuple(r.output) for r in reqs],
            "done": sum(r.outcome == "accepted" for r in reqs),
            "blocks_used": eng.pool.used_blocks,
            **{k: getattr(eng.stats, k) - v for k, v in before.items()}}


def _engines(pair, *, drafter: bool, **kw):
    """A JAX and a port engine of the same settings on the same weights,
    the drafter registered as "d" on both when asked for."""
    jm, jp, tm, tp = pair["target"]
    djm, djp, dtm, dtp = pair["drafter"]
    common = dict(max_seq=96, n_slots=4, block_size=8, seed=3, **kw)
    jeng = JEngine(jm, jp, knobs=JKnobs(max_batch=4), **common)
    teng = Engine(tm, tp, knobs=EngineKnobs(max_batch=4), **common)
    if drafter:
        jeng.add_drafter("d", djm, djp)
        teng.add_drafter("d", dtm, dtp)
    return jeng, teng


# (name, rid offset, load kwargs, scheduler-step swaps)
NGRAM_LOADS = (("greedy", 0, dict(seed=0), None),
               ("sampled", 100, dict(seed=1, sampled=True), None),
               ("stops", 200, dict(seed=2, sampled=True, eos=5), None))
DRAFTER_LOADS = (("swap", 300, dict(seed=3, sampled=True),
                  {2: None, 4: "d"}),
                 ("greedy", 400, dict(seed=4), None),
                 ("sampled", 500, dict(seed=5, sampled=True), None))


@pytest.fixture(scope="module")
def spec_runs(pair):
    """spec_k 4, horizon 4, one engine per side serving one load after
    another (its compiled programs shared): on n-gram drafts greedy,
    mixed sampled, and eos/budget stops (``NGRAM_LOADS``); then a mixed
    load that starts on n-gram drafts, turns speculation off before step
    2 and on with the one-layer model drafter (its pool cold) before step
    4, and greedy and mixed sampled loads on the drafter
    (``DRAFTER_LOADS``)."""
    jeng, teng = _engines(pair, drafter=True, draft="ngram", spec_k=4,
                          horizon=4)
    vocab = pair["target"][2].cfg.vocab_size
    out = {}
    for group, loads in (("ngram", NGRAM_LOADS), ("drafter", DRAFTER_LOADS)):
        out[group] = {}
        for name, rid0, load_kw, swaps in loads:
            load = _load(vocab, **load_kw)
            out[group][name] = (_run(jeng, JRequest, load, rid0, swaps),
                                _run(teng, Request, load, rid0, swaps), load)
    return out


@pytest.fixture(scope="module")
def ngram_runs(spec_runs):
    return spec_runs["ngram"]


@pytest.fixture(scope="module")
def drafter_runs(spec_runs):
    return spec_runs["drafter"]


def _same(runs: dict, name: str) -> dict:
    ref, got, load = runs[name]
    assert got == ref
    assert got["done"] == len(load) and got["blocks_used"] == 0
    return got


@pytest.mark.parametrize("name", [n for n, *_ in NGRAM_LOADS])
def test_ngram_spec_engine_matches_reference(ngram_runs, name):
    got = _same(ngram_runs, name)
    assert got["verify_passes"] > 0
    assert got["draft_tokens"] == 4 * got["verify_passes"]
    if name != "stops":
        assert got["accepted_tokens"] > 0


def test_ngram_stops_end_streams_on_eos_and_budget(ngram_runs):
    ref, got, load = ngram_runs["stops"]
    for (_, budget, kw), s in zip(load, got["streams"]):
        if "eos_id" in kw and kw["eos_id"] in s:
            assert s.index(kw["eos_id"]) == len(s) - 1
        else:
            assert len(s) == budget
    assert any("eos_id" in kw and kw["eos_id"] in s
               for (_, _, kw), s in zip(load, got["streams"]))


@pytest.mark.parametrize("name", [n for n, *_ in DRAFTER_LOADS])
def test_drafter_spec_engine_matches_reference(drafter_runs, name):
    got = _same(drafter_runs, name)
    assert got["verify_passes"] > 0


@pytest.fixture(scope="module")
def chunked_runs(pair):
    """The model drafter with chunked prefill (chunks of 16) and prefix
    sharing (a 20-token head on every prompt) in a pool of 12 blocks, so
    requests are preempted and recomputed mid-stream."""
    head = [int(t) for t in np.random.default_rng(7).integers(0, 128, 20)]
    jeng, teng = _engines(pair, drafter=True, spec_k=4, horizon=2,
                          prefill_chunk=16, prefix_share=True, n_blocks=12)
    for eng in (jeng, teng):
        eng.set_drafter("d")
    load = _load(pair["target"][2].cfg.vocab_size, 6, n=4, sampled=True,
                 head=head)
    return {"chunked": (_run(jeng, JRequest, load, 600),
                        _run(teng, Request, load, 600), load),
            "hits": (jeng.pool.shared_block_hits,
                     teng.pool.shared_block_hits)}


def test_drafter_spec_chunked_prefix_preempting_matches_reference(
        chunked_runs):
    got = _same(chunked_runs, "chunked")
    assert got["preemptions"] > 0
    hits = chunked_runs["hits"]
    assert hits[0] == hits[1] > 0


def test_spec_greedy_equals_plain_greedy_in_the_port(pair, ngram_runs,
                                                     drafter_runs):
    """Greedy speculation emits the plain horizon's stream: n-gram at
    horizons 1 and 4 and the model drafter give the streams of the
    non-speculative engine."""
    _, _, tm, tp = pair["target"]
    load = _load(tm.cfg.vocab_size, seed=0)
    plain = _run(Engine(tm, tp, max_seq=96, n_slots=4, block_size=8,
                        horizon=4), Request, load, 0)
    assert plain["streams"] == ngram_runs["greedy"][1]["streams"]
    h1 = Engine(tm, tp, max_seq=96, n_slots=4, block_size=8, horizon=1,
                draft="ngram", spec_k=2)
    assert _run(h1, Request, load, 0)["streams"] == plain["streams"]
    d_load = _load(tm.cfg.vocab_size, seed=4)
    d_plain = _run(Engine(tm, tp, max_seq=96, n_slots=4, block_size=8,
                          horizon=8), Request, d_load, 400)
    assert d_plain["streams"] == drafter_runs["greedy"][1]["streams"]


@pytest.mark.parametrize("name", [n for n, *_ in NGRAM_LOADS[:2]])
def test_ngram_spec_at_shards_2_matches_reference(pair, ngram_runs, name):
    """The verify fold through the block-striped pool (kernel 4's plain
    version stripe by stripe, then ``combine_lse``): the port at shards 2
    serves the JAX shards=1 spec engine's streams and counters."""
    ref, _, load = ngram_runs[name]
    model = build_model(get_config("llama2-7b").smoke_config(),
                        serving_plan(2, **F32), device="cpu")
    eng = Engine(model, pair["target"][3], max_seq=96, n_slots=4,
                 block_size=8, horizon=4, draft="ngram", spec_k=4, seed=3)
    assert eng.shards == 2
    rid0 = dict((n, r) for n, r, *_ in NGRAM_LOADS)[name]
    assert _run(eng, Request, load, rid0) == ref


# ---------------------------------------------------------------------------
# refusals and the construction API
# ---------------------------------------------------------------------------

def test_draft_pairs_and_refusals_match_reference(pair):
    assert DRAFT_PAIRS == {"llama2-70b": "llama2-7b",
                           "llama2-13b": "llama2-7b",
                           "qwen3-moe-235b-a22b": "qwen3-1.7b"}
    assert drafter_for("llama2-13b") == "llama2-7b"
    assert drafter_for("llama2-7b") is None
    llama = get_config("llama2-7b")
    cases = [(llama, get_config("rwkv6-3b")), (get_config("rwkv6-3b"),) * 2,
             (llama, get_config("hymba-1.5b")),
             (llama, llama.replace(vocab_size=32001))]
    for target, draft in cases:
        with pytest.raises(ValueError) as got:
            check_draft_pair(target, draft)
        with pytest.raises(ValueError) as want:
            j_check_draft_pair(j_get_config(target.name).replace(
                vocab_size=target.vocab_size), j_get_config(draft.name)
                .replace(vocab_size=draft.vocab_size))
        assert str(got.value) == str(want.value)
    check_draft_pair(get_config("llama2-13b"), llama)
    _, _, tm, tp = pair["target"]
    jm, jp = pair["target"][:2]
    for kw in (dict(draft="ngram", paged=False), dict(draft="ngram",
                                                      spec_k=0),
               dict(draft="d")):
        with pytest.raises(ValueError) as got:
            Engine(tm, tp, max_seq=64, n_slots=2, **kw)
        with pytest.raises(ValueError) as want:
            JEngine(jm, jp, max_seq=64, n_slots=2, **kw)
        assert str(got.value) == str(want.value)
    eng = Engine(tm, tp, max_seq=64, n_slots=2)
    with pytest.raises(KeyError):
        eng.set_drafter("nope")
    rwkv = build_model(get_config("rwkv6-3b").smoke_config(), local_plan(),
                       device="cpu")
    with pytest.raises(ValueError, match="paged-servable"):
        eng.add_drafter("r", rwkv, None)
    assert eng.drafters == {}


def test_engine_spec_builds_spec_engines():
    """``spec_k``/``draft``/``ngram``/``drafters`` build as the
    reference's: the drafter from seed ``seed + 100 + i``, chosen with
    ``set_drafter``; its pool shares the target pool's geometry."""
    cfg = get_config("llama2-7b").smoke_config()
    eng = EngineSpec(cfg, max_seq=64, n_slots=2, block_size=8, draft="d",
                     spec_k=3, ngram=3, seed=4, drafters=(("d", cfg),)
                     ).build(device="cpu")
    assert (eng.draft_name, eng.spec_k, eng.ngram) == ("d", 3, 3)
    d_model, d_params = eng.drafters["d"]
    want = d_model.init(torch.Generator().manual_seed(104))
    assert torch.equal(d_params["embed"], want["embed"])
    assert eng.pool.draft_cache["attn"]["k"].shape[1:] == \
        eng.pool.cache["attn"]["k"].shape[1:]
    eng.set_drafter(None)
    assert eng.pool.draft_cache is None
    with pytest.raises(ValueError, match="'d'.*n_kv_heads"):
        EngineSpec(cfg.replace(n_kv_heads=4), shards=4,
                   drafters=(("d", cfg),)).validate()


# ---------------------------------------------------------------------------
# a dropped engine frees its pools at once
# ---------------------------------------------------------------------------

DROP_PATHS = {
    "paged": dict(),
    "ngram spec": dict(draft="ngram", spec_k=3, horizon=2),
    "drafter spec chunked": dict(spec_k=2, prefill_chunk=8,
                                 prefix_share=True),
    "slots": dict(paged=False),
}


@pytest.mark.parametrize("path", sorted(DROP_PATHS))
def test_dropped_engine_is_freed_without_the_collector(pair, path):
    """The step programs reach their engine through a weak reference, so
    the engine, its pool, its draft pool and its programs go with the last
    reference to the engine, the cyclic collector held off."""
    import gc
    import weakref
    _, _, tm, tp = pair["target"]
    _, _, dm, dp = pair["drafter"]
    kw = dict(DROP_PATHS[path])
    collecting = gc.isenabled()
    gc.disable()
    try:
        eng = Engine(tm, tp, max_seq=64, n_slots=2, block_size=8, **kw)
        if "drafter" in path:
            eng.add_drafter("d", dm, dp)
            eng.set_drafter("d")
        eng.submit(Request(prompt=[3, 7, 11, 13] * 3, max_new_tokens=6))
        eng.run()
        assert eng.programs
        refs = [weakref.ref(x) for x in (eng, eng.pool,
                                         *eng.programs.values())]
        if "drafter" in path:
            refs.append(weakref.ref(eng.pool.draft_cache["attn"]["k"]))
        del eng
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        if collecting:
            gc.enable()
