"""Paged flash-decode (one query token per lane through a block table):
the CUDA kernels' wrappers and their plain PyTorch versions.

``csrc/paged_decode_attention.cu`` holds two kernels of one body, which
replace two Pallas TPU kernels of ``repro/kernels/paged_decode_attention.py``:

- ``paged_decode_attention`` (kernel 2): q (B, H, D); k_pool/v_pool
  (n_blocks, bs, K, D); block_tables (B, T) int32 physical block ids
  (unused slots hold the parking block 0); positions (B,) int32, the last
  valid key index per lane -> o (B, H, D) in q's dtype.
- ``paged_decode_attention_lse`` (kernel 4), the per-stripe step of the
  block-striped pool: the pools are one stripe, the tables hold local ids
  (clipped into range where not owned) and ``owned`` (B, T) int32 is
  nonzero where the stripe holds the slot's block; it attends over the
  owned slots only -> (o (B, H, D) in q's dtype, lse (B, H) f32).
  ``combine_lse`` merges the stripes' outputs; it is plain torch on every
  device, as the reference's is plain ``jnp``.

Both kernels split each lane's walk (its keys 0 .. position, or the keys
of its owned blocks) into pieces of ``paged_split_plan``'s length and
merge the pieces' partials inside the same launch;
``split_paged_decode_ref`` and ``split_paged_decode_lse_ref`` are that
arithmetic in plain PyTorch, with the split length as an argument.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (_MAX_HEADS, _MAX_SPLITS,
                                                  NEG_INF, _tickets,
                                                  decode_attention_ref,
                                                  split_merge)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, pool dtype) pairs the kernel is built for; f32 queries over a
# bf16 pool is the reference's f32 plan (the pool is always bf16 there)
_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
          (torch.float32, torch.bfloat16)}


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               positions: torch.Tensor, *,
                               scale: float | None = None,
                               plan_lanes: int | None = None) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::paged_decode_attention_ref``):
    gather each lane's logical KV view through its table, then attend
    (``decode_attention_ref`` rounds the normalised P to v's dtype, as the
    reference model's ``paged_attention`` does).  ``plan_lanes`` is the
    kernel's and is ignored: the plain version has no splits."""
    B, H, D = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    k = k_pool[block_tables].reshape(B, T * bs, K, D)
    v = v_pool[block_tables].reshape(B, T * bs, K, D)
    return decode_attention_ref(q, k, v, positions, scale=scale)


def paged_decode_attention_lse_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   positions: torch.Tensor,
                                   owned: torch.Tensor, *,
                                   scale: float | None = None,
                                   plan_lanes: int | None = None):
    """Plain per-stripe decode (the function of the reference's
    ``paged_decode_attention_lse``): attend over the keys ``kpos <=
    positions[b]`` of the table slots with ``owned[b, j] != 0`` only
    (``plan_lanes``, the kernel's, is ignored).
    Returns ``(o, lse)``: o normalised over those keys (0 where there are
    none) in q's dtype, lse = m + log l in f32 (-1e30 where there are none).

    The reference model's sharded core (``models/attention.py::
    _paged_decode_core``) rounds the unnormalised exp(s - m) to the pool's
    dtype before PV, with m the max over every stripe (its pmax); one
    stripe knows only its own max, so this version rounds exp(s - local m)
    and l sums the unrounded values.  At f32 the rounding is the identity,
    and the function is the Pallas kernel's."""
    B, H, D = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ids = block_tables.long()
    ke = k_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    ve = v_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), ke.float()) * scale
    live = ((torch.arange(T * bs, device=q.device)[None, :]
             <= positions[:, None])
            & (owned != 0).repeat_interleave(bs, dim=1))[:, None, :]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1)
    pexp = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = pexp.sum(dim=-1)
    num = torch.einsum("bhs,bshd->bhd", pexp.to(v_pool.dtype).float(),
                       ve.float())
    o = (num / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    return o, lse


def combine_lse(os: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Merge per-stripe ``paged_decode_attention_lse`` outputs exactly (port
    of ``kernels/paged_decode_attention.py::combine_lse``).  os (S, B, H, D)
    per-stripe normalised outputs; lses (S, B, H).  Each stripe is weighted
    by exp(lse - max lse): one softmax over the union of the stripes'
    keys.  Returns (B, H, D) in os's dtype."""
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])
    denom = w.sum(dim=0).clamp_min(1e-30)
    o = (os.float() * w[..., None]).sum(dim=0) / denom[..., None]
    return o.to(os.dtype)


def _walk(block_tables, positions, bs, owned=None):
    """(live, walk) over the table's T * bs keys: the keys a lane's walk
    visits (0 .. positions, of the owned slots only where ``owned`` is
    given) and their positions on it (an owned block's rank among the
    lane's walked blocks, times bs, plus the key's offset)."""
    B, T = block_tables.shape
    dev = block_tables.device
    blocks = torch.arange(T, device=dev)[None, :] * bs <= positions[:, None]
    if owned is not None:
        blocks = blocks & (owned != 0)
    rank = torch.cumsum(blocks.long(), dim=1) - 1
    keys = torch.arange(T * bs, device=dev)
    walk = rank.repeat_interleave(bs, dim=1) * bs + keys % bs
    live = (blocks.repeat_interleave(bs, dim=1)
            & (keys[None, :] <= positions[:, None]))
    return live, walk


def _split_paged(q, k_pool, v_pool, block_tables, positions, owned, split,
                 scale, p_dtype):
    B, H, D = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ids = block_tables.long()
    ke = k_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    ve = v_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), ke.float()) * scale
    live, walk = _walk(block_tables, positions, bs, owned)
    return split_merge(s, live, walk, ve.float(), split, p_dtype)


def split_paged_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, split: int, *,
                           scale: float | None = None) -> torch.Tensor:
    """Kernel 2's split-and-merge arithmetic in plain PyTorch: split i of
    a lane owns keys ``[i * split, (i + 1) * split)`` of its ``0 ..
    positions`` through its table, merged by ``split_merge`` with P kept
    in f32 (as the kernel keeps it).  Nothing on the serve path calls it."""
    o, _ = _split_paged(q, k_pool, v_pool, block_tables, positions, None,
                        split, scale, None)
    return o.to(q.dtype)


def split_paged_decode_lse_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               positions: torch.Tensor, owned: torch.Tensor,
                               split: int, *, scale: float | None = None):
    """Kernel 4's split-and-merge arithmetic in plain PyTorch: the lane's
    walk is the keys ``kpos <= positions[b]`` of its owned slots in table
    order, split i owns walk positions ``[i * split, (i + 1) * split)``,
    and ``split_merge`` merges them with the unnormalised exp(s - m_i)
    rounded to the pool's dtype before PV.  Returns ``(o, lse)`` as
    ``paged_decode_attention_lse_ref`` does (o = 0 and lse = -1e30 where
    the walk is empty).  Nothing on the serve path calls it."""
    o, lse = _split_paged(q, k_pool, v_pool, block_tables, positions, owned,
                          split, scale, v_pool.dtype)
    return o.to(q.dtype), lse


# CTAs a paged launch aims at, every split counted as live: at llama2-7b's
# phase-1 and served shapes the split lengths this gives were the fastest
# or within 4% of it (``scripts/flash_turns.py --sweep``, PERF.md §6)
_PAGED_CTAS = 2048
_PAGED_MIN_SPLIT = 64     # one key tile at D = 128 in bf16


def paged_split_plan(B: int, H: int, K: int, T: int, bs: int,
                     lse: bool = False) -> tuple[int, int, int]:
    """``(L, splits, head_groups)`` for a launch of kernel 2 (or, with
    ``lse``, kernel 4) over tables (B, T) of ``bs``-key blocks with H query
    heads over K KV heads, from shapes alone (never from positions, which
    stay on the card): L starts at ``max(64, bs)`` and doubles until
    ``B * K * head_groups * ceil(T * bs / L)`` is at most 2048 CTAs
    (kernel 4: 1024, its walk being one stripe's share of the table, at
    most half of it) or one split holds the table's ``T * bs`` keys, and
    further while there are more than 256 splits; then it rounds up to a
    multiple of ``bs``, so that a split covers whole blocks."""
    G = H // K
    groups = -(-G // min(G, _MAX_HEADS))
    pairs = B * K * groups
    N = T * bs
    ctas = _PAGED_CTAS // 2 if lse else _PAGED_CTAS
    L = max(_PAGED_MIN_SPLIT, bs)
    while L < N and pairs * -(-N // L) > ctas:
        L *= 2
    while -(-N // L) > _MAX_SPLITS:
        L *= 2
    L = -(-L // bs) * bs
    return L, -(-N // L), groups


@functools.cache
def _kernel():
    fn = build.library("paged_decode_attention").paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lse_kernel():
    fn = build.library("paged_decode_attention").paged_decode_attention_lse
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, q, k_pool, v_pool, block_tables, positions,
           owned=None) -> None:
    build.refuse_grad(name, q, k_pool, v_pool)
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_tables", block_tables), ("positions", positions)]
    if owned is not None:
        named.append(("owned", owned))
    for arg, t in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be on q's CUDA device, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if (q.dtype, k_pool.dtype) not in _PAIRS or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"{name}: q {q.dtype} over pools "
                        f"{k_pool.dtype}/{v_pool.dtype} not supported")
    if any(t.dtype != torch.int32 for _, t in named[3:]):
        raise TypeError(f"{name}: {', '.join(a for a, _ in named[3:])} "
                        f"must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    B, H, D = q.shape
    K = k_pool.shape[2]
    if k_pool.shape[3] != D or H % K or D % 8 or D > 512:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)} (D % 8 == 0, D <= 512)")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or positions.shape != (B,):
        raise ValueError(f"{name}: tables {tuple(block_tables.shape)} "
                         f"positions {tuple(positions.shape)} for {B} lanes")
    if owned is not None and owned.shape != block_tables.shape:
        raise ValueError(f"{name}: owned {tuple(owned.shape)} does not match "
                         f"tables {tuple(block_tables.shape)}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: pools must start on 16 bytes")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: q on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _launch(q, k_pool, v_pool, block_tables, positions, owned=None, *,
            scale=None, split=None, plan_lanes=None):
    """One launch of kernel 2 (``owned`` None) or kernel 4, its splits of
    ``paged_split_plan``'s length (or ``split`` keys, a multiple of the
    block size) merged inside it; the plan is that of ``plan_lanes``
    lanes where given (default: the launch's own B).  Returns o, or (o,
    lse) for kernel 4."""
    B, H, D = q.shape
    n_blocks, bs, K, _ = k_pool.shape
    T = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    L, splits, groups = paged_split_plan(plan_lanes or B, H, K, T, bs,
                                         owned is not None)
    if split is not None:
        L, splits = split, -(-T * bs // split)
    part = torch.empty(B * K * groups * splits * min(H // K, _MAX_HEADS)
                       * (D + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, B * K * groups)
    out = torch.empty_like(q)
    if owned is None:
        err = _kernel()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), B, H, K, D, n_blocks, bs, T,
            L, scale, _DTYPES[q.dtype], _DTYPES[k_pool.dtype], stream)
        build.check(err, "paged_decode_attention")
        return out
    lse = torch.empty(B, H, dtype=torch.float32, device=q.device)
    err = _lse_kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), owned.data_ptr(),
        out.data_ptr(), lse.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        B, H, K, D, n_blocks, bs, T, L, scale, _DTYPES[q.dtype],
        _DTYPES[k_pool.dtype], stream)
    build.check(err, "paged_decode_attention")
    return out, lse


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *,
                           scale: float | None = None,
                           plan_lanes: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (all tensors on the current CUDA device):
    one launch, its splits merged inside it.

    ``plan_lanes`` pins the split plan to that of a launch over that many
    lanes (still from shapes alone).  A lane's result depends on the
    split length and its own inputs only, so a speculative verify pass,
    whose B * (K + 1) pseudo-lanes are the candidates of B lanes, gives
    each candidate the bits a B-lane decode step would at its position
    when it passes ``plan_lanes=B``."""
    _check("paged_decode_attention", q, k_pool, v_pool, block_tables,
           positions)
    out = _launch(q, k_pool, v_pool, block_tables, positions, scale=scale,
                  plan_lanes=plan_lanes)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_lse(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               positions: torch.Tensor, owned: torch.Tensor,
                               *, scale: float | None = None,
                               plan_lanes: int | None = None):
    """Launch the per-stripe CUDA kernel (all tensors on the current CUDA
    device): one launch, its splits merged inside it; returns ``(o,
    lse)``.  ``plan_lanes`` as for ``paged_decode_attention``."""
    _check("paged_decode_attention_lse", q, k_pool, v_pool, block_tables,
           positions, owned)
    out = _launch(q, k_pool, v_pool, block_tables, positions, owned,
                  scale=scale, plan_lanes=plan_lanes)
    paged_decode_attention_lse.launches += 1
    return out


paged_decode_attention_lse.launches = 0
