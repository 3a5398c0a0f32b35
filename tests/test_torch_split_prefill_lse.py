"""The split-and-merge arithmetic of kernel 3's owned/LSE form on the CPU.

``paged_prefill_attention_lse_split_ref`` is the bf16 kernel's partition
in plain PyTorch: a lane's walk is the keys of its owned slots in table
order, split i holds walk positions ``[i * L, (i + 1) * L)``, and the
splits' partials merge in split order.  At f32 it is held to the one-pass
``paged_prefill_attention_lse_ref`` (1e-6) at every split length, the
stripes' ``combine_lse`` to the reference's ``_paged_prefill_core(None,
...)`` over the whole pool (1e-5, as ``tests/test_torch_sharded_chunk.py``
runs it), and a stripe that owns no key of a row gives lse = -1e30 and
o = 0 exactly.  ``paged_prefill_split_plan`` reads shapes only.
"""
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models.attention import _paged_prefill_core as j_core  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pa  # noqa: E402
from repro_torch.kernels import paged_prefill_attention as ppa  # noqa: E402

NEG_INF = -1e30


def _inputs(seed, B=3, C=8, H=4, K=2, D=16, bs=4, T=12, shards=2):
    """B lanes of C tokens at starts 0, 13 and 30 (the last walk ends on
    its table's last slot), tables of distinct blocks spread over the
    stripes, a pool of ``shards`` stripes."""
    rng = np.random.default_rng(seed)
    nb = shards * (B * T // shards + 2)
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, K, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, K, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:B * T].reshape(B, T) \
        .astype(np.int32)
    starts = np.asarray([0, 13, T * bs - C][:B], np.int32)
    return q, kp, vp, bt, starts


def _stripe(bt, r, nb_loc):
    local = bt - r * nb_loc
    owned = ((local >= 0) & (local < nb_loc)).astype(np.int32)
    return np.clip(local, 0, nb_loc - 1).astype(np.int32), owned


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("L", [4, 8, 12, 20, 64])
def test_split_ref_matches_one_pass_at_every_split(shards, L):
    """Every split length (a block, several, one that cuts blocks, one
    that holds the walk) gives the one-pass answer per stripe: o and lse
    at 1e-6, the empty rows exactly."""
    q, kp, vp, bt, starts = map(_t, _inputs(shards, shards=shards))
    nb_loc = kp.shape[0] // shards
    for r in range(shards):
        local, owned = map(_t, _stripe(bt.numpy(), r, nb_loc))
        sl = slice(r * nb_loc, (r + 1) * nb_loc)
        args = (q, kp[sl], vp[sl], local, starts, owned)
        o, lse = ppa.paged_prefill_attention_lse_split_ref(*args, L)
        o1, lse1 = ppa.paged_prefill_attention_lse_ref(*args)
        empty = lse1 == NEG_INF
        assert torch.equal(lse == NEG_INF, empty)
        assert (o[empty] == 0).all()
        torch.testing.assert_close(o, o1, atol=1e-6, rtol=0)
        torch.testing.assert_close(lse[~empty], lse1[~empty], atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("shards", [2, 4])
def test_split_stripes_combine_to_the_reference_core(shards):
    """The chunk's KV written by the reference's unsharded core; then the
    split version per stripe of that pool, merged by ``combine_lse``,
    against the core's o (1e-5)."""
    q, kp, vp, bt, starts = _inputs(7, shards=shards)
    B, C, H, D = q.shape
    K = kp.shape[2]
    rng = np.random.default_rng(8)
    k, v = (rng.normal(size=(B, C, K, D)).astype(np.float32)
            for _ in range(2))
    lengths = np.asarray([C, 3, C - 2][:B], np.int32)
    o_ref, kp_ref, vp_ref = j_core(
        None, *map(jnp.asarray, (q, kp, vp, bt, starts, lengths, k, v)),
        scale=D ** -0.5, kv_idx=jnp.asarray(np.arange(H) * K // H))
    kp2, vp2 = _t(np.asarray(kp_ref)), _t(np.asarray(vp_ref))
    nb_loc = kp.shape[0] // shards
    os_, lses = [], []
    for r in range(shards):
        local, owned = map(_t, _stripe(bt, r, nb_loc))
        sl = slice(r * nb_loc, (r + 1) * nb_loc)
        o, lse = ppa.paged_prefill_attention_lse_split_ref(
            _t(q), kp2[sl], vp2[sl], local, _t(starts), owned, 8)
        os_.append(o)
        lses.append(lse)
    got = pa.combine_lse(torch.stack(os_), torch.stack(lses))
    # the reference's o is defined for the valid tokens
    valid = np.arange(C)[None, :] < lengths[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(o_ref)[valid],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("L", [4, 16])
def test_stripe_owning_no_key_is_exactly_empty(L):
    """A stripe that owns no key of a lane (and one that owns nothing)
    gives that lane's rows lse -1e30 and o 0 exactly, and a lane whose only
    owned block lies past its rows' keys the same for those rows."""
    q, kp, vp, bt, starts = map(_t, _inputs(3))
    owned = torch.ones_like(bt)
    owned[0] = 0                           # lane 0 owns nothing
    owned[1] = 0
    owned[1, 5] = 1                        # lane 1: one block, past token 6
    for own in (owned, torch.zeros_like(bt)):
        o, lse = ppa.paged_prefill_attention_lse_split_ref(
            q, kp, vp, bt, starts, own, L)
        o1, lse1 = ppa.paged_prefill_attention_lse_ref(q, kp, vp, bt, starts,
                                                       own)
        assert (lse[0] == NEG_INF).all() and (o[0] == 0).all()
        assert torch.equal(lse == NEG_INF, lse1 == NEG_INF)
        assert torch.equal(o[lse == NEG_INF],
                           torch.zeros_like(o[lse == NEG_INF]))
    # lane 1's token c sees keys <= 13 + c: block 5 (keys 20..23) from c = 7
    o, lse = ppa.paged_prefill_attention_lse_split_ref(q, kp, vp, bt, starts,
                                                       owned, L)
    assert (lse[1, :7] == NEG_INF).all() and (lse[1, 7:] > NEG_INF).all()


def test_split_plan_reads_shapes_only():
    """The plan takes only the launch's shapes, L is a multiple of the
    kernel's 64-key tile, at most 16 splits cover the table's keys, and
    phase 1's shape (4 lanes of 128, 32/32 heads, 128 blocks of 16) splits
    in 4 pieces of 512."""
    assert list(inspect.signature(ppa.paged_prefill_split_plan).parameters) \
        == ["B", "C", "H", "K", "T", "bs"]
    assert ppa.paged_prefill_split_plan(4, 128, 32, 32, 128, 16) == (512, 4)
    for B, C, H, K, T, bs in ((1, 8, 4, 2, 5, 4), (16, 128, 32, 32, 256, 16),
                              (4, 40, 16, 16, 6, 24), (2, 300, 40, 8, 2048,
                                                       8)):
        L, splits = ppa.paged_prefill_split_plan(B, C, H, K, T, bs)
        assert L % 64 == 0 and 1 <= splits <= 16
        assert (splits - 1) * L < T * bs <= splits * L
