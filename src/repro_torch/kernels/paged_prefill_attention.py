"""Paged chunked-prefill attention (C query tokens per lane through a block
table): the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/paged_prefill_attention.cu``, its bodies in
``csrc/paged_prefill.cuh``) replaces the Pallas TPU
kernel ``repro/kernels/paged_decode_attention.py::paged_prefill_attention``.
q (B, C, H, D), query c of lane b at absolute position ``starts[b] + c``;
k_pool/v_pool (n_blocks, bs, K, D) already holding the chunk's own KV;
block_tables (B, T) int32 (unused slots hold the parking block 0); starts
(B,) int32 -> o (B, C, H, D) in q's dtype.  Key kpos is visible to query c
iff ``kpos <= starts[b] + c``.

bf16 q over a bf16 pool runs on the tensor cores (``wgmma`` tiles over a
gathered K/V ring), f32 q on the CUDA cores (tensor cores in f32 would be
TF32): the route is chosen by dtype alone, never by a retry.

``paged_verify_attention`` (speculative verify: the current token plus its
drafts at ``positions + i``) is the same kernel with ``starts = positions``,
as in the reference; it has no kernel of its own.

``paged_prefill_attention_lse`` is its owned/LSE form, the per-stripe
step of a chunk over the block-striped pool (what kernel 4 is to kernel
2): the pools are one stripe, the tables hold local ids (clipped into the
stripe where not owned) and ``owned`` (B, T) int32 is nonzero where the
stripe holds the slot's block; it attends over the owned slots only and
returns ``(o (B, C, H, D) in q's dtype, lse (B, C, H) f32)``, which
``paged_decode_attention.combine_lse`` merges over the stripes.  Built
from ``csrc/paged_prefill_attention_lse.cu``: its bf16 route walks only a
lane's owned blocks, split over CTAs into pieces of
``paged_prefill_split_plan``'s length and merged inside the same launch
(``paged_prefill_attention_lse_split_ref`` is that arithmetic in plain
PyTorch); its f32 route is the CUDA-core body with the owned mask.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import _tickets, split_merge
from repro_torch.kernels.paged_decode_attention import _walk

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, pool dtype) pairs the kernel is built for; f32 queries over a
# bf16 pool is the reference's f32 plan (the pool is always bf16 there)
_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
          (torch.float32, torch.bfloat16)}
_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)   # instantiated in the .cu source


def paged_prefill_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                starts: torch.Tensor, *,
                                scale: float | None = None) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::paged_prefill_attention_ref``):
    gather each lane's logical KV view through its table, mask
    ``kpos <= starts + c``, softmax in f32.  The normalised P is rounded to
    v's dtype before PV, as the reference model's
    ``attention.paged_prefill_attention`` does; at f32 that is the
    identity (the kernel rounds the unnormalised exponentials instead)."""
    B, C, H, D = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = k_pool[block_tables].reshape(B, T * bs, K, D)
    v = v_pool[block_tables].reshape(B, T * bs, K, D)
    ke = k.repeat_interleave(H // K, dim=2)
    ve = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bchd,bshd->bhcs", q.float(), ke.float()) * scale
    qpos = starts[:, None] + torch.arange(C, device=q.device)[None, :]
    mask = (torch.arange(T * bs, device=q.device)[None, None, :]
            <= qpos[:, :, None])
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhcs,bshd->bchd", p.to(v.dtype).float(), ve.float())
    return o.to(q.dtype)


def paged_prefill_attention_lse_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    block_tables: torch.Tensor,
                                    starts: torch.Tensor,
                                    owned: torch.Tensor, *,
                                    scale: float | None = None):
    """Plain per-stripe chunk attention (the function of the reference's
    sharded ``_paged_prefill_core`` on one rank, up to its pmax/psum):
    query c of lane b attends over the keys ``kpos <= starts[b] + c`` of
    the table slots with ``owned[b, j] != 0`` only.  Returns ``(o, lse)``:
    o normalised over those keys (0 where there are none) in q's dtype,
    lse = m + log l in f32 (-1e30 where there are none), (B, C, H).

    As ``paged_decode_attention_lse_ref`` does for one token, it rounds
    the unnormalised exp(s - m) to the pool's dtype before PV with m this
    stripe's own max (the reference's core takes the max over every rank,
    which one stripe does not know), and l sums the unrounded values; at
    f32 the rounding is the identity."""
    B, C, H, D = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ids = block_tables.long()
    ke = k_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    ve = v_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    s = torch.einsum("bchd,bshd->bhcs", q.float(), ke.float()) * scale
    qpos = starts[:, None] + torch.arange(C, device=q.device)[None, :]
    live = ((torch.arange(T * bs, device=q.device)[None, None, :]
             <= qpos[:, :, None])
            & (owned != 0).repeat_interleave(bs, dim=1)[:, None, :])
    live = live[:, None]                                  # (B, 1, C, S)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1)                                    # (B, H, C)
    pexp = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = pexp.sum(dim=-1)
    num = torch.einsum("bhcs,bshd->bchd", pexp.to(v_pool.dtype).float(),
                       ve.float())
    l_c = l.transpose(1, 2)                               # (B, C, H)
    o = (num / l_c.clamp_min(1e-30)[..., None]).to(q.dtype)
    lse = torch.where(l_c > 0, m.transpose(1, 2)
                      + torch.log(l_c.clamp_min(1e-30)), NEG_INF)
    return o, lse


def paged_prefill_attention_lse_split_ref(q: torch.Tensor,
                                          k_pool: torch.Tensor,
                                          v_pool: torch.Tensor,
                                          block_tables: torch.Tensor,
                                          starts: torch.Tensor,
                                          owned: torch.Tensor, L: int, *,
                                          scale: float | None = None):
    """The bf16 kernel's split-and-merge arithmetic in plain PyTorch (for
    the tests): a lane's walk is the keys of its owned slots in table
    order, split i holds walk positions ``[i * L, (i + 1) * L)``, query c
    sees the walked keys ``kpos <= starts[b] + c``, and ``split_merge``
    merges the splits with exp(s - m_i) rounded to the pool's dtype before
    PV.  Returns ``(o, lse)`` as ``paged_prefill_attention_lse_ref`` does
    (o = 0 and lse = -1e30 where a row sees no owned key)."""
    B, C, H, D = q.shape
    bs, K = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ids = block_tables.long()
    ke = k_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    ve = v_pool[ids].reshape(B, T * bs, K, D).repeat_interleave(H // K, dim=2)
    s = torch.einsum("bchd,bshd->bchs", q.float(), ke.float()) * scale
    # each (lane, token) as a lane of its own at position starts + c
    pos = starts[:, None] + torch.arange(C, device=q.device)[None, :]
    live, walk = _walk(block_tables.repeat_interleave(C, dim=0),
                       pos.reshape(-1), bs, owned.repeat_interleave(C, dim=0))
    o, lse = split_merge(s.reshape(B * C, H, T * bs), live, walk,
                         ve.float().repeat_interleave(C, dim=0), L,
                         v_pool.dtype)
    return o.reshape(B, C, H, D).to(q.dtype), lse.reshape(B, C, H)


# CTAs a launch of the owned/LSE form aims at, every split counted as
# live (a stripe walks about 1 / stripes of a table;
# ``scripts/flash_turns.py --sweep`` times split lengths 128-1024 beside
# the plan's), its shortest split (two key tiles, so the ring overlaps a
# copy with a product) and its most splits (the merge's weights live in
# the K/V ring)
_LSE_CTAS = 512
_LSE_MIN_SPLIT = 128
_LSE_MAX_SPLITS = 16


@functools.lru_cache(maxsize=256)
def paged_prefill_split_plan(B: int, C: int, H: int, K: int, T: int,
                             bs: int) -> tuple[int, int]:
    """``(L, splits)`` for a bf16 launch of the owned/LSE form over C
    tokens of B lanes, H query heads over K KV heads and tables (B, T) of
    ``bs``-key blocks, from shapes alone (never from starts or owned,
    which stay on the card: the chunk tick is one CUDA graph).  L starts
    at 128 keys and doubles while ``B * K * query tiles * ceil(T * bs / L)``
    exceeds 512 CTAs and one split does not hold the table's ``T * bs``
    keys, and further while there would be more than 16 splits; L is a
    multiple of the kernel's 64-key tile (a split's walk positions, not
    blocks: any ``bs``)."""
    tiles = -(-C * (H // K) // 128)
    pairs = B * K * tiles
    N = T * bs
    L = _LSE_MIN_SPLIT
    while L < N and pairs * -(-N // L) > _LSE_CTAS:
        L *= 2
    while -(-N // L) > _LSE_MAX_SPLITS:
        L *= 2
    return L, -(-N // L)


@functools.cache
def _kernel():
    fn = build.library("paged_prefill_attention").paged_prefill_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lse_kernel():
    fn = build.library("paged_prefill_attention_lse")\
        .paged_prefill_attention_lse
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, block_tables, starts, owned=None,
           name="paged_prefill_attention") -> None:
    build.refuse_grad(name, q, k_pool, v_pool)
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_tables", block_tables), ("starts", starts)]
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
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    B, C, H, D = q.shape
    if k_pool.shape[3] != D or H % k_pool.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {_HEAD_DIMS}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or starts.shape != (B,):
        raise ValueError(f"{name}: tables {tuple(block_tables.shape)} starts "
                         f"{tuple(starts.shape)} for {B} lanes")
    if owned is not None and owned.shape != block_tables.shape:
        raise ValueError(f"{name}: owned {tuple(owned.shape)} does not match "
                         f"tables {tuple(block_tables.shape)}")
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: q and the pools must start on 16 bytes")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: q on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            starts: torch.Tensor, *,
                            scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (all tensors on the current CUDA device).
    ``launches`` counts every launch, ``tensor_core`` the bf16 ones, which
    take the ``wgmma`` kernel (f32 q takes the CUDA-core one)."""
    _check(q, k_pool, v_pool, block_tables, starts)
    B, C, H, D = q.shape
    n_blocks, bs, K, _ = k_pool.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), out.data_ptr(),
        B, C, H, K, D, n_blocks, bs, block_tables.shape[1], scale,
        _DTYPES[q.dtype], _DTYPES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    paged_prefill_attention.tensor_core += q.dtype == torch.bfloat16
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.tensor_core = 0


def paged_prefill_attention_lse(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                starts: torch.Tensor, owned: torch.Tensor, *,
                                scale: float | None = None):
    """Launch the per-stripe CUDA kernel (all tensors on the current CUDA
    device); returns ``(o, lse)``.  bf16 walks each lane's owned blocks
    split as ``paged_prefill_split_plan`` says, the splits merged inside
    the launch.  ``launches`` counts every launch, ``tensor_core`` the
    bf16 ones (the ``wgmma`` body)."""
    _check(q, k_pool, v_pool, block_tables, starts, owned,
           name="paged_prefill_attention_lse")
    out = _launch_lse(q, k_pool, v_pool, block_tables, starts, owned,
                      scale=scale)
    paged_prefill_attention_lse.launches += 1
    paged_prefill_attention_lse.tensor_core += q.dtype == torch.bfloat16
    return out


def _launch_lse(q, k_pool, v_pool, block_tables, starts, owned, *,
                scale=None, split=None):
    """One launch of the owned/LSE form: bf16 splits each lane's owned walk
    into pieces of ``paged_prefill_split_plan``'s length (or ``split``
    keys, a multiple of 64, for a sweep).  Returns (o, lse)."""
    B, C, H, D = q.shape
    n_blocks, bs, K, _ = k_pool.shape
    T = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(B, C, H, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    L, splits, part, tickets = 0, 0, None, None
    if q.dtype == torch.bfloat16:
        L, splits = paged_prefill_split_plan(B, C, H, K, T, bs)
        if split is not None:
            L, splits = split, -(-T * bs // split)
        groups = B * K * -(-C * (H // K) // 128)
        part = torch.empty(groups * splits * 128 * (D + 2),
                           dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, groups)
    err = _lse_kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), owned.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), B, C, H, K, D,
        n_blocks, bs, T, L, splits, scale, _DTYPES[q.dtype],
        _DTYPES[k_pool.dtype], stream)
    build.check(err, "paged_prefill_attention_lse")
    return out, lse


paged_prefill_attention_lse.launches = 0
paged_prefill_attention_lse.tensor_core = 0


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """Multi-query-per-lane decode (speculative verify): q (B, Q, H, D),
    query i at ``positions[b] + i``.  The mask walk is chunked prefill's
    with ``starts = positions``, so this launches the same kernel (and
    counts as its launch)."""
    return paged_prefill_attention(q, k_pool, v_pool, block_tables,
                                   positions, scale=scale)
