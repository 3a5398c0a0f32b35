"""``models/prng.py``'s ``split``, ``randint`` and ``normal_bf16`` against
live ``jax.random``, and ``TokenPipeline.next_embed_batch`` against the
reference's, on the CPU.

Keys, draws and labels bit-exact.  bf16 normals: jax draws 8 bits a value
and keeps 7, so only 128 values can come out; every one of them is held
bit for bit (jax's erf_inv is XLA's f32 polynomial, which ``normal_bf16``
evaluates in the same order; none of the 128 differs, so no ulp
tolerance is needed)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.training import data as JD  # noqa: E402
from repro_torch.models import prng  # noqa: E402
from repro_torch.training import data as TD  # noqa: E402


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(torch.tensor(seed))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_split_matches_jax(seed):
    jk, tk = _keys(seed)
    for n in (2, 3, 9):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      np.asarray(jax.random.split(jk, n)))
    # split(key)[i] is fold_in(key, i), in jax as here
    np.testing.assert_array_equal(prng.split(tk, 4)[3].numpy(),
                                  prng.fold_in(tk, 3).numpy())


@pytest.mark.parametrize("lo,hi", [(0, 504), (0, 65536), (0, 65537),
                                   (-5, 100000), (3, 3), (7, 2),
                                   (-2**31, 2**31 - 1)])
def test_randint_matches_jax(lo, hi):
    """Spans below, at and above 2**16 (where jax's multiplier wraps in
    uint32), an empty span (minval returned) and the whole int32 range."""
    jk, tk = _keys(11)
    want = np.asarray(jax.random.randint(jk, (13, 77), lo, hi))
    got = prng.randint(tk, (13, 77), lo, hi)
    assert got.shape == (13, 77) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_normal_bf16_every_value_matches_jax():
    """Enough draws that all 128 bit patterns occur, each held bit for
    bit, at two shapes."""
    jk, tk = _keys(3)
    want = np.asarray(jax.random.normal(jk, (40, 1000), jnp.bfloat16)
                      .astype(jnp.float32))
    got = prng.normal_bf16(tk, (40, 1000))
    assert got.dtype == torch.bfloat16 and got.shape == (40, 1000)
    assert np.unique(want).size == 128
    np.testing.assert_array_equal(got.float().numpy(), want)
    jk, tk = _keys(12345)
    np.testing.assert_array_equal(
        prng.normal_bf16(tk, (3, 5, 7)).float().numpy(),
        np.asarray(jax.random.normal(jk, (3, 5, 7), jnp.bfloat16)
                   .astype(jnp.float32)))


def test_next_embed_batch_matches_reference_and_resumes():
    jpipe = JD.TokenPipeline(JD.DataConfig(504, 3, 50, seed=7))
    tpipe = TD.TokenPipeline(TD.DataConfig(504, 3, 50, seed=7), device="cpu")
    want = [jpipe.next_embed_batch(80) for _ in range(3)]
    for wx, wl in want:
        x, lab = tpipe.next_embed_batch(80)
        assert x.dtype == torch.bfloat16 and x.shape == (3, 50, 80)
        assert lab.dtype == torch.int64 and lab.shape == (3, 50)
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(wx.astype(jnp.float32)))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(wl))
    assert tpipe.state() == jpipe.state() == {"seed": 7, "step": 3}
    resumed = TD.TokenPipeline(TD.DataConfig(504, 3, 50, seed=7), step=2,
                               device="cpu")
    x, lab = resumed.next_embed_batch(80)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want[2][1]))
