"""Kernels 2 and 4's split-and-merge arithmetic and their host-side split
plan, on the CPU against the JAX reference.

``split_paged_decode_ref`` and ``split_paged_decode_lse_ref`` are what the
CUDA kernels compute: each lane's walk through its block table (keys 0 ..
position, or the keys of the owned blocks at or before it, in table
order) cut into splits of L walk positions, per-split partials ``(m_i,
l_i, acc_i)`` merged as ``sum e^{m_i - M} acc_i / max(sum e^{m_i - M} l_i,
1e-30)``.  At f32 they equal the one-pass plain versions up to summation
order, so they are held at 1e-6, and at the JAX oracle's own kernel
tolerance (1e-5) against ``ref.paged_decode_attention_ref`` and the
interpret-mode Pallas ``paged_decode_attention_lse``, as
``test_torch_sharded.py`` runs it."""
import ast
import inspect
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pa  # noqa: E402

ATOL = 1e-5
NEG_INF = -1e30


def _t(a):
    return torch.from_numpy(np.array(a))


# (H, K, D, bs, T, L): GQA 8/2, 24/8, 25/5 and MHA, block sizes 8, 16 and
# 32, splits of one to four blocks, T * bs never a multiple of L
CASES = [
    (8, 2, 16, 8, 13, 32),
    (24, 8, 16, 16, 9, 64),
    (25, 5, 16, 32, 5, 64),
    (4, 4, 32, 16, 11, 48),
    (8, 8, 16, 8, 21, 16),
    (6, 2, 8, 32, 4, 32),
]


def _inputs(H, K, D, bs, T, L, seed):
    """Lanes at the split edges L - 1, L, L + 1 (lane 0's later splits
    all empty), on block edges bs - 1 and bs, at the table's last key, and
    a parked lane (position 0, a table row of zeros); scrambled tables
    over a pool of an even number of blocks.  Lane 1's table is blocks
    1 .. T, all in the pool's first half: the second of two stripes owns
    no block of it."""
    rng = np.random.default_rng(seed)
    top = T * bs - 1
    pos = np.asarray([min(p, top) for p in (L - 1, L, L + 1, bs - 1, bs,
                                            top, 0)], np.int32)
    B = len(pos)
    n_blocks = 2 * (B * T // 2 + 1)
    tables = rng.permutation(np.arange(1, n_blocks))[: B * T].reshape(B, T)
    tables[1] = np.arange(1, T + 1)
    tables[-1] = 0
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_blocks, bs, K, D)).astype(np.float32)
              for _ in range(2))
    return q, kp, vp, tables.astype(np.int32), pos


def _stripe(kp, vp, tables, r, shards):
    nb_loc = kp.shape[0] // shards
    local = tables - r * nb_loc
    owned = ((local >= 0) & (local < nb_loc)).astype(np.int32)
    sl = slice(r * nb_loc, (r + 1) * nb_loc)
    return kp[sl], vp[sl], np.clip(local, 0, nb_loc - 1).astype(np.int32), \
        owned


@pytest.mark.parametrize("H,K,D,bs,T,L", CASES)
def test_split_paged_matches_one_pass_and_oracle(H, K, D, bs, T, L):
    q, kp, vp, tables, pos = _inputs(H, K, D, bs, T, L, H + bs + L)
    o = pa.split_paged_decode_ref(*map(_t, (q, kp, vp, tables, pos)), L)
    assert not o.isnan().any()
    torch.testing.assert_close(
        o, pa.paged_decode_attention_ref(*map(_t, (q, kp, vp, tables, pos))),
        atol=1e-6, rtol=0)
    o_ref = jref.paged_decode_attention_ref(
        *map(jnp.asarray, (q, kp, vp, tables, pos)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("H,K,D,bs,T,L", CASES)
def test_split_paged_lse_matches_one_pass_and_pallas(H, K, D, bs, T, L):
    """Per stripe of 2: o and lse at 1e-6 against the one-pass plain
    version and at 1e-5 against the interpret-mode Pallas kernel; lane 1
    in stripe 1 sees no key (lse exactly -1e30, o exactly 0 on every
    side), and so does the parked lane there."""
    q, kp, vp, tables, pos = _inputs(H, K, D, bs, T, L, H + bs + L + 1)
    for r in range(2):
        k_s, v_s, local, owned = _stripe(kp, vp, tables, r, 2)
        args = (q, k_s, v_s, local, pos, owned)
        o, lse = pa.split_paged_decode_lse_ref(*map(_t, args), L)
        o1, lse1 = pa.paged_decode_attention_lse_ref(*map(_t, args))
        jo, jlse = jops.paged_decode_attention_lse(*map(jnp.asarray, args))
        torch.testing.assert_close(o, o1, atol=1e-6, rtol=0)
        torch.testing.assert_close(lse, lse1, atol=1e-6, rtol=0)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                                   rtol=0)
        empty = lse == NEG_INF
        assert torch.equal(empty, torch.from_numpy(np.asarray(jlse) == NEG_INF))
        assert (o[empty] == 0).all()
        if r == 1:
            assert empty[1].all() and empty[-1].all()


@pytest.mark.parametrize("L", [8, 16, 24, 40, 256])
def test_split_paged_any_split_gives_one_answer(L):
    """The split length changes the order of the sums only: every L that
    is a multiple of the block size gives the one-pass output at 1e-6,
    one split (L past the table's keys) included, in both forms."""
    q, kp, vp, tables, pos = _inputs(8, 2, 16, 8, 13, 32, 3)
    args = tuple(map(_t, (q, kp, vp, tables, pos)))
    torch.testing.assert_close(pa.split_paged_decode_ref(*args, L),
                               pa.paged_decode_attention_ref(*args),
                               atol=1e-6, rtol=0)
    k_s, v_s, local, owned = map(_t, _stripe(kp, vp, tables, 0, 2))
    lse_args = (args[0], k_s, v_s, local, args[4], owned)
    for got, want in zip(pa.split_paged_decode_lse_ref(*lse_args, L),
                         pa.paged_decode_attention_lse_ref(*lse_args)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_split_paged_lse_stripe_owning_nothing():
    """A stripe that owns no block of any lane: lse -1e30 and o 0
    exactly, and in bf16 too, with no NaN."""
    q, kp, vp, tables, pos = _inputs(8, 2, 16, 8, 13, 32, 4)
    k_s, v_s, local, owned = _stripe(kp, vp, tables, 0, 2)
    for dt in (torch.float32, torch.bfloat16):
        o, lse = pa.split_paged_decode_lse_ref(
            _t(q).to(dt), _t(k_s).to(dt), _t(v_s).to(dt), _t(local),
            _t(pos), torch.zeros_like(_t(owned)), 32)
        assert (lse == NEG_INF).all()
        assert torch.equal(o, torch.zeros_like(o))


def test_split_paged_lse_rounds_p_to_the_pool_dtype():
    """In bf16 the split form rounds exp(s - m_i) to the pool's dtype per
    split, the one-pass form per stripe: they agree to bf16's rounding of
    P, not to f32's."""
    q, kp, vp, tables, pos = _inputs(8, 2, 16, 8, 13, 32, 5)
    k_s, v_s, local, owned = _stripe(kp, vp, tables, 0, 2)
    bf = torch.bfloat16
    args = (_t(q).to(bf), _t(k_s).to(bf), _t(v_s).to(bf), _t(local),
            _t(pos), _t(owned))
    o, lse = pa.split_paged_decode_lse_ref(*args, 32)
    o1, lse1 = pa.paged_decode_attention_lse_ref(*args)
    torch.testing.assert_close(o.float(), o1.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, lse1, atol=1e-5, rtol=0)


def test_paged_plan_reads_shapes_only():
    """The plan is a function of shapes alone, and neither wrapper brings
    a tensor's values to the host (no ``.item()``, ``.tolist()``,
    ``.cpu()`` or ``int()`` of a tensor): one host sync per launch would
    be 32 a decode step."""
    assert list(inspect.signature(pa.paged_split_plan).parameters) == \
        ["B", "H", "K", "T", "bs", "lse"]
    for fn in (pa._launch, pa.paged_decode_attention,
               pa.paged_decode_attention_lse):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        calls = {n.func.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)}
        assert not calls & {"item", "tolist", "cpu", "numpy"}
        names = {n.func.id for n in ast.walk(tree)
                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
        assert not names & {"int", "float", "bool"}


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("B,H,K,T,bs", [
    (8, 32, 32, 128, 16), (4, 32, 32, 128, 16), (4, 24, 8, 128, 16),
    (4, 25, 5, 64, 16), (64, 32, 32, 128, 16), (1, 8, 1, 2048, 16),
    (3, 8, 2, 10, 24), (2, 12, 1, 40, 8), (5, 4, 4, 7, 32),
])
def test_paged_plan_splits_whole_blocks(lse, B, H, K, T, bs):
    L, splits, groups = pa.paged_split_plan(B, H, K, T, bs, lse)
    assert L % bs == 0 and L >= 64
    assert splits == -(-T * bs // L) <= 256
    assert groups == -(-(H // K) // 8)


def test_paged_plan_takes_the_sweeps_lengths():
    """llama2-7b's phase-1 shape (8 lanes, 2048-key tables of 16-key
    blocks) and its served step (4 lanes): kernel 2 at L = 256 and 128,
    kernel 4 at 512 and 256, the lengths ``flash_turns.py --sweep`` timed
    fastest or within 4% of it; two or more CTAs per SM of an H100 at
    phase 1's shape; one split where the lanes alone fill the card."""
    assert pa.paged_split_plan(8, 32, 32, 128, 16) == (256, 8, 1)
    assert pa.paged_split_plan(8, 32, 32, 128, 16, True) == (512, 4, 1)
    assert pa.paged_split_plan(4, 32, 32, 128, 16) == (128, 16, 1)
    assert pa.paged_split_plan(4, 32, 32, 128, 16, True) == (256, 8, 1)
    for lse in (False, True):
        L, splits, groups = pa.paged_split_plan(8, 32, 32, 128, 16, lse)
        assert 8 * 32 * groups * splits >= 2 * 132
    assert pa.paged_split_plan(64, 32, 32, 128, 16) == (2048, 1, 1)
