"""The encoder family (hubert-xlarge: bidirectional attention over frame
embeddings, LayerNorm, a two-layer GELU MLP), the port against the live
JAX reference on the CPU: ``layer_norm`` and ``gelu_mlp``, kernel 1's
bidirectional form in its plain version (the ``kernels/ref.py`` oracle and
the Pallas kernel in interpret mode) in every (causal, window) pair, the
prefill attention against the reference's ``encoder_attention`` branch of
``gqa_forward``, the model (``init``, ``logits``, ``prefill``, the decode
steps it refuses), the weight bridge and the serve CLI.

Tolerances: layers 1e-6 (of the output's scale for attention), plain
kernels 1e-5, model logits and caches 1e-4, over the f32 plan with weights
carried over from a JAX ``Model.init`` tree (``from_jax_params``).  The
smoke config has 2 layers, d_model 64 and 4 query heads over 2 KV heads of
16 (GQA, where the full config has 16/16 heads of 80)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ARCH = "hubert-xlarge"


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    """A torch copy: a JAX CPU array may share an aligned numpy buffer."""
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0.0)


def _close_scaled(got, want, tol):
    """Within ``tol`` of the output's scale, max(1, max |want|)."""
    _close(got, want, tol * max(1.0, float(np.abs(_np(want)).max())))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape),
                                   str(a.dtype).replace("torch.", "")), tree)


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config(ARCH).smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# config, init, weights
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    t, j = get_config(ARCH), j_get_config(ARCH)
    assert t.__dict__ == j.__dict__
    assert t.param_count() == j.param_count()
    assert t.smoke_config().__dict__ == j.smoke_config().__dict__
    assert (t.causal, t.input_kind, t.mlp_kind, t.norm_kind, t.head_dim) \
        == (False, "embeds", "gelu2", "layer", 80)


def test_port_init_builds_reference_tree(models):
    """Same keys, shapes and dtypes as the reference's tree: no ``embed``
    (frame embeddings come in), LayerNorm ``scale`` and ``bias``, the MLP's
    ``w_in``/``b_in``/``w_out``/``b_out``; norms at 1 and 0, biases 0."""
    _, jp, tm, tp = models
    own = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(own) == _shapes(jp) == _shapes(tp)
    assert set(own) == {"layers", "final_norm", "unembed"}
    assert set(own["layers"]["mlp"]) == {"w_in", "b_in", "w_out", "b_out"}
    for norm in (own["final_norm"], own["layers"]["norm1"]):
        assert (norm["scale"] == 1).all() and (norm["bias"] == 0).all()
    assert (own["layers"]["mlp"]["b_in"] == 0).all()
    assert (own["layers"]["mlp"]["b_out"] == 0).all()


def test_from_jax_params_carries_the_encoder_tree():
    """A bf16 JAX tree with trained-looking (non-zero) norm and MLP biases
    carries over key for key, bit for bit."""
    jm = j_build_model(j_get_config(ARCH).smoke_config(),
                       j_local_plan(param_dtype=jnp.bfloat16))
    rng = np.random.default_rng(5)
    jp = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.standard_normal(a.shape).astype(np.float32) * 0.1
                   ).astype(a.dtype), jm.init(jax.random.PRNGKey(1)))
    tp = from_jax_params(jp, device="cpu")
    assert _shapes(tp) == _shapes(jp)
    for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16))


# ---------------------------------------------------------------------------
# layer_norm, gelu_mlp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = _arr(rng, 3, 7, 64) * 3.0 + 1.5
    w, b = _arr(rng, 64), _arr(rng, 64)
    want = JL.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                         jnp.asarray(b, dtype))
    got = TL.layer_norm(_t(x).to(getattr(torch, dtype)),
                        _t(w).to(getattr(torch, dtype)),
                        _t(b).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, 1e-6)
    else:   # the same f32 arithmetic, then one rounding to bf16
        step = 2.0 ** -7 * np.abs(_np(want))
        assert (np.abs(_np(got) - _np(want)) <= step).all()


def test_gelu_mlp_matches_reference():
    rng = np.random.default_rng(2)
    x = _arr(rng, 2, 5, 64)
    p = {"w_in": _arr(rng, 64, 128) * 0.1, "b_in": _arr(rng, 128),
         "w_out": _arr(rng, 128, 64) * 0.1, "b_out": _arr(rng, 64)}
    want = JL.gelu_mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in p.items()})
    got = TL.gelu_mlp(_t(x), {k: _t(v) for k, v in p.items()})
    _close(got, want, 1e-6)


def test_gelu_mlp_init_matches_reference_tree():
    want = JL.gelu_mlp_init(jax.random.PRNGKey(0), 64, 128)
    got = TL.gelu_mlp_init(64, 128, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert _shapes(got) == _shapes(want)
    assert float(got["w_in"].std()) == pytest.approx(0.88 / 8, rel=0.1)


# ---------------------------------------------------------------------------
# kernel 1's bidirectional form (plain version)
# ---------------------------------------------------------------------------

# (causal, window): every pair of the reference's two flags
PAIRS = [(True, 0), (False, 0), (True, 8), (False, 8), (False, 1),
         (False, 1000)]


@pytest.mark.parametrize("S", [1, 31, 33, 200])
@pytest.mark.parametrize("causal,window", PAIRS)
def test_flash_plain_matches_ref_oracle(causal, window, S):
    """GQA 4 over 2 heads, ragged S (not a multiple of any tile)."""
    rng = np.random.default_rng(S + window + 7 * causal)
    q, k, v = _arr(rng, 2, 4, S, 16), _arr(rng, 2, 2, S, 16), \
        _arr(rng, 2, 2, S, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("S", [31, 64])
@pytest.mark.parametrize("causal,window", PAIRS)
def test_flash_plain_matches_interpret_kernel(causal, window, S):
    """Against the Pallas kernel in interpret mode (one tile at S = 31,
    two of 32 at S = 64), GQA H=4 over K=2."""
    rng = np.random.default_rng(S + window + 3 * causal)
    q, k, v = _arr(rng, 1, 4, S, 16), _arr(rng, 1, 2, S, 16), \
        _arr(rng, 1, 2, S, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    blk = min(S, 32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                block_q=blk, block_k=blk, interpret=True)
    _close(got, want, 1e-5)


def test_bidirectional_window_sees_later_keys():
    """``causal=False`` with a window W keeps keys k > q - W, earlier and
    later: a query's output moves when a later key changes, and not when
    a key W or more behind it does."""
    rng = np.random.default_rng(9)
    q, k, v = (_t(_arr(rng, 1, 1, 12, 16)) for _ in range(3))
    base = ops.flash_attention(q, k, v, causal=False, window=4)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 9], v2[:, :, 9] = 5.0, 5.0             # a key after query 3
    moved = ops.flash_attention(q, k2, v2, causal=False, window=4)
    assert not torch.equal(moved[:, :, 3], base[:, :, 3])
    k3, v3 = k.clone(), v.clone()
    k3[:, :, 2], v3[:, :, 2] = 5.0, 5.0             # key 2 = 6 - 4: unseen
    same = ops.flash_attention(q, k3, v3, causal=False, window=4)
    assert torch.equal(same[:, :, 6], base[:, :, 6])
    assert flash_mod.flash_attention.launches == 0
    assert flash_mod.flash_attention.bidirectional == 0


def test_bidirectional_keeps_bf16_rounding_of_normalised_p():
    """bf16 inputs: the plain version rounds the normalised P to bf16
    before PV, as the reference's ``_attn_block`` does in
    ``encoder_attention``."""
    rng = np.random.default_rng(4)
    q, k, v = (_t(_arr(rng, 1, 2, 33, 16)).bfloat16() for _ in range(3))
    got = flash_mod.flash_attention_ref(q, k, v, causal=False)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / 4.0
    p = torch.softmax(s, dim=-1)
    want = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


# ---------------------------------------------------------------------------
# the encoder's attention layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 33, 40, 128])
def test_gqa_forward_matches_encoder_attention(models, S):
    """One bidirectional attention layer through ``gqa_forward``: the
    reference reaches ``encoder_attention`` (query chunks of the largest
    power of two dividing S: 1, 1, 8 and 128 rows here), the port kernel
    1's bidirectional form; output at 1e-6 of its scale, and the cache of
    un-rounded K/V, (B, S, K, hd)."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(20 + S)
    x = _arr(rng, 2, S, tm.cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    ref, jc = JA.gqa_forward(_layer(jp["layers"]["attn"], 1), jnp.asarray(x),
                             jnp.asarray(pos), jm.cfg, jm.plan,
                             want_cache=True)
    got, tc = TA.gqa_forward(_layer(tp["layers"]["attn"], 1), _t(x),
                             _t(pos), tm.cfg, tm.plan, want_cache=True)
    _close_scaled(got, ref, 1e-6)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape == (2, S, 2, 16)
        _close_scaled(tc[name], jc[name], 1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [40, 33])
def test_logits_and_prefill_match_reference(models, S):
    """Frame embeddings (B, S, d) in: per-frame logits, and prefill's
    last-frame logits and its cache ``{"attn": {"k", "v"}}`` of (L, B, S,
    K, hd), at 1e-4."""
    jm, jp, tm, tp = models
    x = _arr(np.random.default_rng(S), 2, S, tm.cfg.d_model)
    want = jm.logits(jp, jnp.asarray(x))
    got = tm.logits(tp, _t(x))
    assert tuple(got.shape) == want.shape == (2, S, 128)
    _close(got, want, 1e-4)
    jlast, jcache = jm.prefill(jp, jnp.asarray(x))
    last, cache = tm.prefill(tp, _t(x))
    _close(last, jlast, 1e-4)
    _close(last, got[:, -1], 1e-4)
    assert set(cache) == set(jcache) == {"attn"}
    for name in ("k", "v"):
        assert tuple(cache["attn"][name].shape) == \
            jcache["attn"][name].shape == (2, 2, S, 2, 16)
        _close(cache["attn"][name], jcache["attn"][name], 1e-4)


def test_bf16_frames_are_cast_to_the_compute_dtype(models):
    """bf16 frame embeddings into an f32 plan are cast up, as the
    reference's ``_embed_inputs`` casts them."""
    jm, jp, tm, tp = models
    x = _arr(np.random.default_rng(6), 1, 20, tm.cfg.d_model)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jm.logits(jp, xb)
    got = tm.logits(tp, _t(np.asarray(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)


def test_decode_steps_raise_reference_error(models):
    jm, jp, tm, tp = models
    tok = np.zeros(2, np.int32)
    with pytest.raises(ValueError) as jerr:
        jm.decode_step(jp, {}, jnp.asarray(tok), jnp.asarray(tok))
    calls = [lambda: tm.decode_step(tp, {}, _t(tok), _t(tok)),
             lambda: tm.decode_step_paged(tp, {}, _t(tok), _t(tok),
                                          _t(tok[:, None])),
             lambda: tm.decode_multi_paged(
                 tp, {}, _t(tok), _t(tok), _t(tok[:, None]),
                 torch.ones(2, dtype=torch.bool), _t(tok), _t(tok - 1),
                 num_steps=2, max_len=8)]
    for call in calls:
        with pytest.raises(ValueError) as err:
            call()
        assert str(err.value) == str(jerr.value) \
            == "hubert-xlarge is encoder-only: no decode step"
    assert tm.supports_paged is jm.supports_paged is False


def test_serve_cli_exits_as_reference():
    argv = ["--arch", ARCH, "--smoke", "--requests", "2"]
    with pytest.raises(SystemExit) as jerr:
        j_serve.main(argv)
    with pytest.raises(SystemExit) as err:
        t_serve.main(argv + ["--device", "cpu"])
    assert str(err.value) == str(jerr.value) \
        == "hubert-xlarge is encoder-only; nothing to decode"
