"""The port's model against the JAX reference model on the same weights.

A JAX ``Model.init`` tree is carried over with ``from_jax_params`` under
``local_plan(param_dtype=f32, compute_dtype=f32)``; logits are held to the
reference at atol 1e-4 (f32 through two layers and the unembedding, with
the pool in bf16 exactly as the reference keeps it)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) at smoke size."""
    jcfg = j_get_config("llama2-7b").smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config("llama2-7b").smoke_config()
    tm = build_model(tcfg, local_plan(param_dtype=torch.float32,
                                      compute_dtype=torch.float32),
                     device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _pool(rng, model, n_blocks, bs):
    cfg = model.cfg
    shape = (cfg.num_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    return {"attn": {n: rng.standard_normal(shape).astype(np.float32)
                     for n in ("k", "v")}}


def _jpool(pool):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pool)


def _tpool(pool):
    return {"attn": {n: torch.from_numpy(a).bfloat16()
                     for n, a in pool["attn"].items()}}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# configs and parameter layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama2-7b", "llama2-13b", "llama2-70b"])
def test_configs_match_reference(name):
    t, j = get_config(name), j_get_config(name)
    assert t.__dict__ == j.__dict__
    assert t.param_count() == j.param_count()
    assert t.smoke_config().__dict__ == j.smoke_config().__dict__


@pytest.mark.parametrize("name", ["llama2-7b", "llama2-13b", "llama2-70b"])
def test_local_plan_pads_match_reference(name):
    """One device pads nothing: heads, KV heads and vocab as published."""
    t, j = local_plan(), j_local_plan()
    t_cfg, j_cfg = get_config(name), j_get_config(name)
    assert (t.h_pad(t_cfg), t.k_pad(t_cfg), t.v_pad(t_cfg)) == \
        (j.h_pad(j_cfg), j.k_pad(j_cfg), j.v_pad(j_cfg)) == \
        (t_cfg.n_heads, t_cfg.n_kv_heads, t_cfg.vocab_size)


def test_registry_lists_ported_archs():
    assert list_archs() == ["llama2-13b", "llama2-70b", "llama2-7b"]
    with pytest.raises(KeyError):
        get_config("rwkv6-3b")


def test_port_init_matches_reference_tree(pair):
    """The port's own init builds the reference's tree: same keys, shapes
    and dtypes, layers stacked on the leading L axis."""
    jm, jp, tm, _ = pair
    own = tm.init(torch.Generator().manual_seed(0))
    ref_shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    own_shapes = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), own)
    assert own_shapes == ref_shapes


def test_from_jax_params_copies_bf16_bit_exact():
    jcfg = j_get_config("llama2-7b").smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.bfloat16))
    jp = jm.init(jax.random.PRNGKey(3))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    w = np.asarray(jp["layers"]["attn"]["w_q"])
    t = tp["layers"]["attn"]["w_q"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == w.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  w.view(np.int16))


def test_kv_index_matches_reference():
    for H, K in ((4, 2), (8, 8), (64, 8), (4, 1)):
        cfg = get_config("llama2-7b").smoke_config().replace(n_heads=H,
                                                             n_kv_heads=K)
        jcfg = j_get_config("llama2-7b").smoke_config().replace(n_heads=H,
                                                                n_kv_heads=K)
        np.testing.assert_array_equal(
            TA.kv_index(cfg, H, device="cpu").numpy(),
            np.asarray(JA.kv_index(jcfg, H)))
        # the map the kernels apply: head h reads KV head h*K//H
        assert TA.kv_index(cfg, H, device="cpu").tolist() == \
            [h * K // H for h in range(H)]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def test_prefill_ragged_logits_and_cache(pair):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(0)
    B, S = 3, 32
    tokens = rng.integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.asarray([32, 5, 19], np.int32)
    for i, n in enumerate(lengths):
        tokens[i, n:] = 0                          # right padding
    jl, jc = jax.jit(jm.prefill_ragged)(jp, jnp.asarray(tokens),
                                        jnp.asarray(lengths))
    tl, tc = tm.prefill_ragged(tp, torch.from_numpy(tokens),
                               torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc["attn"][name]),
                                   _np(jc["attn"][name]), atol=ATOL)


def test_prefill_and_logits(pair):
    jm, jp, tm, tp = pair
    tokens = np.random.default_rng(1).integers(0, 128, (2, 24)).astype(np.int32)
    jl, _ = jax.jit(jm.prefill)(jp, jnp.asarray(tokens))
    tl, _ = tm.prefill(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    np.testing.assert_allclose(_np(tm.logits(tp, torch.from_numpy(tokens))),
                               _np(jax.jit(jm.logits)(jp, jnp.asarray(tokens))),
                               atol=ATOL)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _decode_inputs(rng, B=4, bs=8, T=6):
    n_blocks = 1 + B * T
    bt = rng.permutation(np.arange(1, n_blocks))[: B * T] \
        .reshape(B, T).astype(np.int32)                       # scrambled
    pos = rng.integers(0, T * bs - 8, B).astype(np.int32)     # ragged
    tokens = rng.integers(0, 128, B).astype(np.int32)
    return n_blocks, bs, bt, pos, tokens


def test_decode_step_paged_logits_and_pool(pair):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(2)
    n_blocks, bs, bt, pos, tokens = _decode_inputs(rng)
    pool = _pool(rng, tm, n_blocks, bs)
    jl, jc = jax.jit(jm.decode_step_paged)(
        jp, _jpool(pool), jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(bt))
    tc = _tpool(pool)
    tl, tc = tm.decode_step_paged(tp, tc, torch.from_numpy(tokens),
                                  torch.from_numpy(pos), torch.from_numpy(bt))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    # the written slots agree to one bf16 step (a value within f32 rounding
    # of a bf16 boundary may round either way); untouched slots bit-exact
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc["attn"][name]),
                                   _np(jc["attn"][name]), atol=1e-2, rtol=0)
    written = np.zeros((n_blocks, bs), bool)
    written[bt[np.arange(4), pos // bs], pos % bs] = True
    for name in ("k", "v"):
        a, b = _np(tc["attn"][name]), _np(jc["attn"][name])
        np.testing.assert_array_equal(a[:, ~written], b[:, ~written])


def test_decode_multi_paged_horizon(pair):
    """Greedy horizon of 4 steps: tokens where emitted, emitted flags and
    the final lane state match; lane 1 starts parked, lane 2 finishes
    mid-horizon on its budget, lane 3 on max_len."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(3)
    n_blocks, bs, bt, pos, tokens = _decode_inputs(rng)
    pool = _pool(rng, tm, n_blocks, bs)
    max_len = 40
    pos[3] = max_len - 3
    active = np.asarray([True, False, True, True])
    budgets = np.asarray([9, 9, 2, 9], np.int32)
    eos = np.full(4, -1, np.int32)
    args = (tokens, pos, bt, active, budgets, eos)
    jout = jax.jit(jm.decode_multi_paged, static_argnames=("num_steps",
                                                           "max_len"))(
        jp, _jpool(pool), *map(jnp.asarray, args), num_steps=4,
        max_len=max_len)
    tout = tm.decode_multi_paged(tp, _tpool(pool),
                                 *map(torch.from_numpy, args),
                                 num_steps=4, max_len=max_len)
    j_tok, j_em = np.asarray(jout[0]), np.asarray(jout[1])
    t_tok, t_em = tout[0].numpy(), tout[1].numpy()
    np.testing.assert_array_equal(t_em, j_em)
    np.testing.assert_array_equal(t_tok[t_em], j_tok[j_em])
    assert t_em.sum(axis=0).tolist() == [4, 0, 2, 3]
    for t_state, j_state in zip(tout[3], jout[3]):
        np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))


def test_init_paged_cache_layout(pair):
    jm, _, tm, _ = pair
    tc = tm.init_paged_cache(7, 8)
    jc = jm.init_paged_cache(7, 8)
    for name in ("k", "v"):
        assert tuple(tc["attn"][name].shape) == jc["attn"][name].shape
        assert tc["attn"][name].dtype == torch.bfloat16
    assert tm.supports_paged == jm.supports_paged is True


def test_unported_family_raises():
    cfg = get_config("llama2-7b").smoke_config().replace(attn_kind="mla")
    with pytest.raises(NotImplementedError):
        build_model(cfg, local_plan(), device="cpu")
