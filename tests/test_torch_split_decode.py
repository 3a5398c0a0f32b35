"""Kernel 5's split-and-merge arithmetic and its host-side split plan, and
kernel 3's plain version at the head dims its tensor-core route added,
on the CPU against the JAX reference.

``split_decode_ref`` is what the CUDA kernel computes: per-split partials
``(m_i, l_i, acc_i)`` merged as ``sum e^{m_i - M} acc_i / max(sum e^{m_i -
M} l_i, 1e-30)``.  At f32 it equals the one-pass plain version
(``flash_decode_ref``) up to summation order, so it is held at 1e-6, and
at the JAX oracle's own kernel tolerance (1e-5) against
``ref.decode_attention_ref``.  Kernel 3's plain version is held at 1e-5
against ``ref.paged_prefill_attention_ref`` and the interpret-mode Pallas
kernel, as ``test_torch_prefill_chunk.py`` holds it at the narrower head
dims."""
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
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import (  # noqa: E402
    paged_prefill_attention_ref)

ATOL = 1e-5


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (B, H, K, D, S, L, positions): the split edges 0, L - 1, L and S - 1, an
# S that is not a multiple of L, and lanes whose every split but the
# first is empty
SPLIT_CASES = [
    (4, 8, 2, 64, 128, 32, [0, 31, 32, 127]),
    (3, 4, 4, 32, 100, 32, [99, 64, 5]),
    (2, 25, 5, 16, 1024, 64, [1023, 63]),
    (4, 6, 2, 32, 70, 64, [0, 1, 63, 30]),
    (2, 8, 1, 64, 257, 128, [256, 128]),
    (1, 4, 2, 32, 40, 32, [39]),
]


@pytest.mark.parametrize("B,H,K,D,S,L,pos", SPLIT_CASES)
def test_split_merge_matches_one_pass_and_oracle(B, H, K, D, S, L, pos):
    rng = np.random.default_rng(S + L + D)
    q, k, v = _arr(rng, B, H, D), _arr(rng, B, S, K, D), _arr(rng, B, S, K, D)
    p = np.asarray(pos, np.int32)
    o = da.split_decode_ref(_t(q), _t(k), _t(v), _t(p), L)
    assert not o.isnan().any()
    torch.testing.assert_close(
        o, da.flash_decode_ref(_t(q), _t(k), _t(v), _t(p)), atol=1e-6, rtol=0)
    o_ref = jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, p)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_merge_empty_splits_add_exactly_zero(dtype):
    """Lanes at position 0 and at L - 1 hold keys in split 0 only: every
    later split is empty (m = -1e30, l = 0), adds 0 to the merge, and the
    output is that of a cache cut to split 0 (up to the order of the
    sums), with no NaN."""
    rng = np.random.default_rng(7)
    B, H, K, D, S, L = 2, 8, 2, 32, 256, 32
    q, k, v = (_t(a).to(dtype) for a in (_arr(rng, B, H, D),
                                         _arr(rng, B, S, K, D),
                                         _arr(rng, B, S, K, D)))
    pos = torch.tensor([0, L - 1], dtype=torch.int32)
    o = da.split_decode_ref(q, k, v, pos, L)
    assert not o.float().isnan().any()
    torch.testing.assert_close(
        o.float(), da.split_decode_ref(q, k[:, :L], v[:, :L], pos, L).float(),
        atol=1e-6, rtol=0)


def test_split_merge_lane_with_no_key_is_zero_not_nan():
    """A lane that sees no key (every split empty) gives 0."""
    rng = np.random.default_rng(8)
    q, k, v = _t(_arr(rng, 1, 4, 16)), _t(_arr(rng, 1, 64, 2, 16)), \
        _t(_arr(rng, 1, 64, 2, 16))
    o = da.split_decode_ref(q, k, v, torch.tensor([-1], dtype=torch.int32),
                            32)
    assert torch.equal(o, torch.zeros_like(o))


def test_split_plan_reads_shapes_only():
    """The plan is a function of (B, H, K, S) alone, and the wrapper never
    brings a tensor's values to the host (no ``.item()``, ``.tolist()``,
    ``.cpu()`` or ``int()`` of a tensor): one host sync per layer would be
    32 a decode step."""
    assert list(inspect.signature(da.split_plan).parameters) == \
        ["B", "H", "K", "S"]
    tree = ast.parse(textwrap.dedent(inspect.getsource(da.decode_attention)))
    calls = {n.func.attr for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not calls & {"item", "tolist", "cpu", "numpy"}
    names = {n.func.id for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert not names & {"int", "float", "bool"}


@pytest.mark.parametrize("shape,want", [
    ((4, 32, 32, 2048), (512, 4, 1)),    # llama2-7b's slots
    ((4, 25, 5, 1024), (64, 16, 1)),     # hymba-1.5b's ring
    ((4, 24, 8, 2048), (128, 16, 1)),    # granite-moe-3b-a800m's slots
])
def test_split_plan_fills_the_card(shape, want):
    B, H, K, S = shape
    L, splits, groups = da.split_plan(B, H, K, S)
    assert (L, splits, groups) == want
    assert B * K * groups * splits >= 264
    # one power of two longer would not
    assert L == 32 or B * K * groups * -(-S // (2 * L)) < 264


def test_split_plan_edges():
    """One split when the lanes alone fill the card or S is short; 32
    keys a split when nothing fills it; head groups of 8 query heads."""
    assert da.split_plan(64, 32, 32, 2048) == (2048, 1, 1)
    assert da.split_plan(4, 32, 32, 1) == (32, 1, 1)
    assert da.split_plan(1, 8, 1, 2048) == (32, 64, 1)
    assert da.split_plan(2, 32, 2, 512)[2] == 2
    assert da.split_plan(1, 8, 1, 32768) == (128, 256, 1)


PREFILL_WIDE = [
    (2, 6, 8, 2, 80, 16, 4),     # hubert-xlarge's head dim
    (2, 5, 4, 4, 96, 8, 6),      # minicpm3-4b's
    (2, 7, 4, 2, 256, 8, 4),     # gemma-7b's
]


def _prefill_inputs(rng, B, C, H, K, D, bs, T):
    n_blocks = 1 + B * T
    kp, vp = _arr(rng, n_blocks, bs, K, D), _arr(rng, n_blocks, bs, K, D)
    q = _arr(rng, B, C, H, D)
    starts = rng.integers(0, T * bs - C, B).astype(np.int32)
    bt = rng.permutation(np.arange(1, n_blocks))[: B * T] \
        .reshape(B, T).astype(np.int32)
    return q, kp, vp, bt, starts


@pytest.mark.parametrize("B,C,H,K,D,bs,T", PREFILL_WIDE)
def test_paged_prefill_plain_wide_head_dims_match_oracle(B, C, H, K, D, bs,
                                                         T):
    rng = np.random.default_rng(D + C)
    args = _prefill_inputs(rng, B, C, H, K, D, bs, T)
    o = paged_prefill_attention_ref(*map(_t, args))
    o_ref = jref.paged_prefill_attention_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)


@pytest.mark.parametrize("B,C,H,K,D,bs,T", PREFILL_WIDE)
def test_paged_prefill_plain_wide_head_dims_match_interpret_kernel(
        B, C, H, K, D, bs, T):
    rng = np.random.default_rng(D + C + 1)
    args = _prefill_inputs(rng, B, C, H, K, D, bs, T)
    o = paged_prefill_attention_ref(*map(_t, args))
    o_ref = jops.paged_prefill_attention(*map(jnp.asarray, args),
                                         interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
