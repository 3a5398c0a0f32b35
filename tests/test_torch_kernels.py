"""The kernels' plain PyTorch versions against the JAX reference: the
``kernels/ref.py`` oracles, the Pallas kernels in interpret mode (as the
reference's own tests run them on the CPU), and the reference model
functions each kernel replaces on the model path.

f32 at atol 1e-5 (the reference's own kernel tolerance,
``tests/test_paged.py:42``); the shape sweep is the reference's: GQA, MHA
and MQA, head dim 32/64/128, block size 8/16/32, scrambled block tables,
and sequence lengths that are not a multiple of the CUDA kernel's 64-row
tile.  The CUDA kernels themselves are held to these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)

ATOL = 1e-5


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# flash attention (prompt prefill)
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    (2, 8, 2, 64, 64),     # GQA 4:1
    (1, 4, 4, 200, 128),   # MHA, S not a multiple of the 64-row tile
    (3, 4, 1, 37, 32),     # MQA, ragged S below one tile
    (1, 2, 2, 16, 128),    # shortest prefill bucket
]


@pytest.mark.parametrize("B,H,K,S,D", FLASH_SHAPES)
def test_flash_plain_matches_ref_oracle(B, H, K, S, D):
    rng = np.random.default_rng(B * 1000 + S)
    q, k, v = _arr(rng, B, H, S, D), _arr(rng, B, K, S, D), _arr(rng, B, K, S, D)
    o = flash_attention_ref(_t(q), _t(k), _t(v))
    o_ref = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


@pytest.mark.parametrize("B,H,K,S,D", FLASH_SHAPES)
def test_flash_plain_matches_interpret_kernel(B, H, K, S, D):
    """The Pallas kernel in interpret mode (one block per sequence here,
    since S <= its 256-row default tile)."""
    rng = np.random.default_rng(B * 1000 + S + 1)
    q, k, v = _arr(rng, B, H, S, D), _arr(rng, B, K, S, D), _arr(rng, B, K, S, D)
    o = ops.flash_attention(_t(q), _t(k), _t(v))
    o_ref = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


@pytest.mark.parametrize("S", [33, 200])
def test_flash_strided_model_layout_matches_reference_model(S):
    """The model passes (B, H, S, D) views of its (B, S, H, D) activations;
    held to the reference model's causal_attention (its XLA path), which
    takes kv already expanded to H heads."""
    rng = np.random.default_rng(S)
    B, H, K, D = 2, 4, 2, 32
    q, k, v = _arr(rng, B, S, H, D), _arr(rng, B, S, K, D), _arr(rng, B, S, K, D)
    o = ops.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                            _t(v).transpose(1, 2), scale=1 / math.sqrt(D))
    cfg = get_config("llama2-7b").smoke_config()
    idx = JA.kv_index(cfg.replace(n_heads=H, n_kv_heads=K), H)
    ke = jnp.take(jnp.asarray(k), idx, axis=2)
    ve = jnp.take(jnp.asarray(v), idx, axis=2)
    o_ref = JA.causal_attention(jnp.asarray(q), ke, ve, scale=1 / math.sqrt(D),
                                plan=j_local_plan(), cfg=cfg)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(o_ref),
                               atol=ATOL)


def test_flash_plain_rounds_p_to_v_dtype():
    """bf16 inputs: P is rounded to bf16 before PV (the kernel's rule), so
    the plain version equals an explicit rounded computation."""
    rng = np.random.default_rng(9)
    q, k, v = (_t(_arr(rng, 1, 2, 24, 32)).bfloat16() for _ in range(3))
    o = flash_attention_ref(q, k, v)
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(32)
    s = s.masked_fill(~torch.ones(24, 24, dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(s, -1).bfloat16().float()
    assert o.dtype == torch.bfloat16
    torch.testing.assert_close(o, (p @ v.float()).bfloat16(), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_inputs(rng, B, H, K, D, bs, T, pool_dtype=np.float32):
    n_blocks = 1 + B * T
    kp = _arr(rng, n_blocks, bs, K, D).astype(pool_dtype)
    vp = _arr(rng, n_blocks, bs, K, D).astype(pool_dtype)
    q = _arr(rng, B, H, D)
    pos = rng.integers(0, T * bs, B).astype(np.int32)        # ragged
    bt = rng.permutation(np.arange(1, n_blocks))[: B * T] \
        .reshape(B, T).astype(np.int32)                       # scrambled
    return q, kp, vp, bt, pos


PAGED_SHAPES = [
    (2, 8, 2, 64, 16, 8),     # GQA 4:1
    (1, 4, 4, 128, 32, 4),    # MHA
    (3, 4, 1, 64, 16, 8),     # MQA
    (2, 8, 2, 32, 8, 16),     # GQA, head dim 32, block 8
    (4, 8, 1, 128, 8, 6),     # MQA, head dim 128, block 8
    (2, 16, 4, 32, 32, 3),    # GQA 4:1, head dim 32, block 32
]


@pytest.mark.parametrize("B,H,K,D,bs,T", PAGED_SHAPES)
def test_paged_decode_plain_matches_ref_oracle(B, H, K, D, bs, T):
    rng = np.random.default_rng(B * 10 + T + D)
    q, kp, vp, bt, pos = _paged_inputs(rng, B, H, K, D, bs, T)
    o = paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    o_ref = jref.paged_decode_attention_ref(*map(jnp.asarray, (q, kp, vp, bt, pos)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


@pytest.mark.parametrize("B,H,K,D,bs,T", PAGED_SHAPES)
def test_paged_decode_plain_matches_interpret_kernel(B, H, K, D, bs, T):
    rng = np.random.default_rng(B * 10 + T + D + 1)
    q, kp, vp, bt, pos = _paged_inputs(rng, B, H, K, D, bs, T)
    o = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    o_ref = jops.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, bt, pos)),
                                        interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


def test_paged_decode_parked_lane_reads_block_zero():
    """A parked lane (position 0, table row of zeros) attends to the one
    key at block 0 offset 0, exactly as the reference does."""
    rng = np.random.default_rng(11)
    q, kp, vp, bt, pos = _paged_inputs(rng, 3, 4, 2, 32, 8, 4)
    bt[1] = 0
    pos[1] = 0
    o = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    o_ref = jref.paged_decode_attention_ref(*map(jnp.asarray, (q, kp, vp, bt, pos)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(o[1].numpy(),
                               np.repeat(vp[0, 0], 2, axis=0), atol=ATOL)


@pytest.mark.parametrize("pool_bf16", [False, True])
def test_paged_decode_plain_matches_reference_model(pool_bf16):
    """Held to the reference model's paged_attention (the XLA path the
    kernel replaces).  Under the f32 plan the pool is bf16: probabilities
    are rounded to bf16 before PV on both sides, and a probability that
    lands on the other side of a bf16 rounding boundary moves the output
    by at most one bf16 step of p times |v|, hence 1e-3 for that case."""
    rng = np.random.default_rng(12)
    B, H, K, D, bs, T = 3, 8, 2, 64, 16, 6
    q, kp, vp, bt, pos = _paged_inputs(rng, B, H, K, D, bs, T)
    tq, tk, tv = _t(q), _t(kp), _t(vp)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    if pool_bf16:
        tk, tv = tk.bfloat16(), tv.bfloat16()
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    o = ops.paged_decode_attention(tq, tk, tv, _t(bt), _t(pos),
                                   scale=1 / math.sqrt(D))
    cfg = get_config("llama2-7b").smoke_config().replace(n_heads=H,
                                                         n_kv_heads=K)
    o_ref = JA.paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                               jnp.asarray(pos), scale=1 / math.sqrt(D),
                               kv_idx=JA.kv_index(cfg, H))
    assert o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref),
                               atol=1e-3 if pool_bf16 else ATOL)


@pytest.mark.parametrize("B,H,K,D,S", [(2, 8, 2, 64, 40), (3, 4, 1, 32, 17)])
def test_dense_decode_plain_matches_ref_oracle(B, H, K, D, S):
    rng = np.random.default_rng(S)
    q, k, v = _arr(rng, B, H, D), _arr(rng, B, S, K, D), _arr(rng, B, S, K, D)
    pos = rng.integers(0, S, B).astype(np.int32)
    o = decode_attention_ref(_t(q), _t(k), _t(v), _t(pos))
    o_ref = jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, pos)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


def test_paged_decode_masks_future():
    """Entries past the position (within the last live block) are masked."""
    rng = np.random.default_rng(1)
    B, H, K, D, bs, T = 1, 2, 2, 32, 16, 4
    kp, vp = _arr(rng, 1 + T, bs, K, D), _arr(rng, 1 + T, bs, K, D)
    q = _arr(rng, B, H, D)
    bt = np.arange(1, T + 1, dtype=np.int32)[None]
    pos = np.asarray([21], np.int32)
    o1 = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    kp[2, 6:] = 999.0
    kp[3:] = 999.0
    vp[2, 6:] = 999.0
    vp[3:] = 999.0
    o2 = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-6)
