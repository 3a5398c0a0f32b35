"""Port layer primitives against the JAX reference at f32 (atol 1e-6).

Inputs come from one numpy seed and go through ``repro.models.layers`` and
``repro_torch.models.layers`` alike."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 1e-6


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 64)])
def test_rms_norm(shape, plus_one):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    jx, tx = _both(x)
    jw, tw = _both(w)
    np.testing.assert_allclose(
        TL.rms_norm(tx, tw, plus_one=plus_one).numpy(),
        np.asarray(JL.rms_norm(jx, jw, plus_one=plus_one)), atol=ATOL)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_rope_freqs(head_dim):
    np.testing.assert_allclose(
        TL.rope_freqs(head_dim, 10000.0, device="cpu").numpy(),
        np.asarray(JL.rope_freqs(head_dim, 10000.0)), atol=ATOL)


@pytest.mark.parametrize("B,S,H,D", [(2, 7, 4, 16), (1, 33, 2, 128)])
def test_apply_rope_prefill_layout(B, S, H, D):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    pos[0] += 100   # positions far from 0 exercise large angles
    jx, tx = _both(x)
    jp, tp = _both(pos)
    np.testing.assert_allclose(TL.apply_rope(tx, tp, 10000.0).numpy(),
                               np.asarray(JL.apply_rope(jx, jp, 10000.0)),
                               atol=ATOL)


def test_apply_rope_decode_layout():
    """The one-token form the decode step uses: x[:, None], pos[:, None]."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, 5).astype(np.int32)
    jx, tx = _both(x)
    jp, tp = _both(pos)
    np.testing.assert_allclose(
        TL.apply_rope(tx[:, None], tp[:, None], 10000.0)[:, 0].numpy(),
        np.asarray(JL.apply_rope(jx[:, None], jp[:, None], 10000.0)[:, 0]),
        atol=ATOL)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_glu_mlp(activation):
    rng = np.random.default_rng(3)
    d, f = 64, 128
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    p = {"w_gate": rng.standard_normal((d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jx, tx = _both(x)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(
        TL.glu_mlp(tx, tp, activation=activation).numpy(),
        np.asarray(JL.glu_mlp(jx, jp, activation=activation)), atol=ATOL)


@pytest.mark.parametrize("ids_shape", [(6,), (2, 9)])
def test_take_embedding(ids_shape):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((128, 64)).astype(np.float32)
    ids = rng.integers(0, 128, ids_shape).astype(np.int32)
    np.testing.assert_array_equal(
        TL.take_embedding(torch.from_numpy(table),
                          torch.from_numpy(ids)).numpy(),
        np.asarray(JL.take_embedding(jnp.asarray(table), jnp.asarray(ids))))


def test_dense_init_is_truncated_fan_in_normal():
    """Same law as the reference's dense_init: N(0, 1/fan_in) cut at +-2
    std (the two frameworks' random bits differ, so the law is checked)."""
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init((256, 512), generator=g, device="cpu")
    std = 1.0 / np.sqrt(256)
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    assert float(w.abs().max()) <= 2 * std + 1e-7
    # truncation at 2 std leaves 0.88 of the untruncated std
    assert abs(float(w.std()) / std - 0.8796) < 0.02
    ref = np.asarray(JL.dense_init(jax.random.PRNGKey(0), (256, 512)))
    assert abs(float(w.std()) - float(ref.std())) < 0.02 * std


def test_embed_init_scale_and_dtype():
    g = torch.Generator().manual_seed(0)
    w = TL.embed_init((128, 64), generator=g, dtype=torch.bfloat16,
                      device="cpu")
    assert w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 0.02) < 0.002


def test_tree_map_walks_nested_dicts():
    tree = {"a": 1, "b": {"c": 2, "d": {"e": 3}}}
    other = {"a": 10, "b": {"c": 20, "d": {"e": 30}}}
    assert TL.tree_map(lambda x, y: x + y, tree, other) == \
        {"a": 11, "b": {"c": 22, "d": {"e": 33}}}
