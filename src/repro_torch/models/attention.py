"""Attention (port of ``repro.models.attention``): dense GQA, sliding
window, encoder and MLA.

Projections keep the reference layouts (``w_q (d, H, hd)``, ``w_k``/``w_v
(d, K, hd)``, ``w_o (H, hd, d)``) and run as plain matmuls.  Where the
reference model runs XLA attention (``causal_attention``,
``paged_attention``, ``paged_prefill_attention``, ``_flash_decode_core``)
the port calls the kernels through ``ops``: the CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.  Caches and pools are
written in place.  Under a sharded plan the paged decode step walks the
pool stripe by stripe (``_paged_decode_core``, the reference's per-rank
body) and merges the stripes with ``combine_lse``; a chunk of chunked
prefill does the same through kernel 3's owned/LSE form
(``_paged_prefill_core``).

Sliding-window attention (``attn_kind="swa"``, hymba) runs its prefill
through the window form of the flash kernel (the reference's three
branches of ``swa_attention`` are one function) and keeps a ring cache of
the ``W = min(window, S)`` latest keys, position p in slot p % W.

Bidirectional attention (``causal=False``, hubert) runs through the flash
kernel's bidirectional form, where the reference runs ``encoder_attention``
(``_attn_block`` over query chunks, which do not change the numbers).

MLA (``attn_kind="mla"``, minicpm3-4b) keeps the reference's latent form:
the prefill expands the latent ``ckv`` to per-head k/v and runs kernel 1
with v zero-padded to q's head dim (each output column is computed on its
own, so ``o[..., :v_head_dim]`` is exact); the slot cache holds ``ckv``
and the shared rope key ``kr``, and the decode is the reference's absorbed
form (``_mla_decode_core``) in plain torch, which has no Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import _HEAD_DIMS as FLASH_DIMS
from repro_torch.kernels.paged_decode_attention import combine_lse
from repro_torch.models import layers as L
from repro_torch.models.sharding import ShardPlan

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_gqa(cfg: ArchConfig, plan: ShardPlan, *, generator: torch.Generator,
             device="cuda") -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(generator=generator, dtype=plan.param_dtype, device=device)
    p = {
        "w_q": L.dense_init((d, cfg.n_heads, hd), **kw),
        "w_k": L.dense_init((d, cfg.n_kv_heads, hd), **kw),
        "w_v": L.dense_init((d, cfg.n_kv_heads, hd), **kw),
        "w_o": L.dense_init((cfg.n_heads, hd, d), in_axis=1, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=plan.param_dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=plan.param_dtype, device=device)
    return p


def init_mla(cfg: ArchConfig, plan: ShardPlan, *, generator: torch.Generator,
             device="cuda") -> dict:
    """The reference's MLA tree: low-rank q (``w_dq``, ``w_uq``), the
    latent kv (``w_dkv``), the shared rope key (``w_kr``) and the latent's
    up-projections to per-head k and v (``w_uk``, ``w_uv``)."""
    d, H = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    kw = dict(generator=generator, dtype=plan.param_dtype, device=device)
    return {
        "w_dq": L.dense_init((d, rq), **kw),
        "w_uq": L.dense_init((rq, H, nope + rope_d), **kw),
        "w_dkv": L.dense_init((d, rkv), **kw),
        "w_kr": L.dense_init((d, rope_d), **kw),
        "w_uk": L.dense_init((rkv, H, nope), **kw),
        "w_uv": L.dense_init((rkv, H, vd), **kw),
        "w_o": L.dense_init((H, vd, d), in_axis=1, **kw),
        "q_norm": torch.ones(rq, dtype=plan.param_dtype, device=device),
        "kv_norm": torch.ones(rkv, dtype=plan.param_dtype, device=device),
    }


def kv_index(cfg: ArchConfig, h_pad: int, k_pad: int | None = None,
             device="cuda") -> torch.Tensor:
    """Constant q-head -> kv-slot map; pad heads point at slot 0.  On one
    device this is h * n_kv // n_heads, the map the kernels apply."""
    k = k_pad or cfg.n_kv_heads
    idx = [h * k // cfg.n_heads for h in range(cfg.n_heads)]
    idx += [0] * (h_pad - cfg.n_heads)
    return torch.tensor(idx, dtype=torch.int32, device=device)


def canonicalize_gqa_grads(g: dict, cfg: ArchConfig, plan: ShardPlan) -> dict:
    """The reference zeroes the grads of padded query heads and averages
    those of padded kv-head copies (``attention.py:56``).  The port pads
    neither: ``h_pad == n_heads`` and ``k_pad == n_kv_heads`` on every plan
    (``models/sharding.py``: a plan only takes degrees that divide the head
    and kv-head counts), so the grads are the published model's as they
    are.  Returns ``g``."""
    assert plan.h_pad(cfg) == cfg.n_heads, (plan.h_pad(cfg), cfg.n_heads)
    assert plan.k_pad(cfg) == cfg.n_kv_heads, (plan.k_pad(cfg),
                                               cfg.n_kv_heads)
    return g


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, heads, hd) -> (..., heads, hd)."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).view(*x.shape[:-1], heads, hd)


def _out_proj(o: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """o (..., H, hd) @ w_o (H, hd, d) -> (..., d)."""
    H, hd, d = w_o.shape
    return o.reshape(*o.shape[:-2], H * hd) @ w_o.reshape(H * hd, d)


# ---------------------------------------------------------------------------
# GQA forward (prefill)
# ---------------------------------------------------------------------------

def _swa(cfg: ArchConfig) -> bool:
    return cfg.attn_kind == "swa" and bool(cfg.window)


def _ring(t: torch.Tensor, window: int) -> torch.Tensor:
    """The ring of the ``W = min(window, S)`` latest positions of t
    (B, S, ...): slot p % W holds position p, for p in [S - W, S)."""
    S = t.shape[1]
    W = min(window, S)
    return torch.roll(t[:, S - W:], shifts=(S - W) % W, dims=1)


def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, plan: ShardPlan, *, want_cache: bool):
    """Causal GQA, over a sliding window for ``attn_kind="swa"``, or
    bidirectional for ``causal=False`` (the reference's encoder branch);
    MLA takes ``mla_forward``.
    x: (B, S, d) -> (out (B, S, d), cache | None); the cache holds this
    layer's un-rounded k/v in the compute dtype, (B, S, K, hd), or for
    the window its ring (B, min(window, S), K, hd)."""
    if cfg.attn_kind == "mla":
        return mla_forward(p, x, positions, cfg, plan, want_cache=want_cache)
    if cfg.attn_kind not in ("gqa", "swa"):
        raise NotImplementedError(f"{cfg.name}: attn_kind="
                                  f"{cfg.attn_kind!r} has no attention")
    dt = plan.compute_dtype
    q = _project(x, p["w_q"].to(dt))
    k = _project(x, p["w_k"].to(dt))
    v = _project(x, p["w_v"].to(dt))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if _swa(cfg) else 0
    cache = None
    if want_cache:
        cache = {"k": _ring(k, window), "v": _ring(v, window)} if window \
            else {"k": k, "v": v}
    # (B, H, S, hd) views of the (B, S, H, hd) activations: no copies
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2),
                            scale=1.0 / math.sqrt(cfg.head_dim),
                            causal=cfg.causal, window=window)
    return _out_proj(o.transpose(1, 2), p["w_o"].to(dt)), cache


# ---------------------------------------------------------------------------
# chunked prefill over the paged pool
# ---------------------------------------------------------------------------

def gqa_prefill_paged(p: dict, x: torch.Tensor, cache: dict,
                      starts: torch.Tensor, lengths: torch.Tensor,
                      block_tables: torch.Tensor, cfg: ArchConfig,
                      plan: ShardPlan):
    """Chunked-prefill step over the paged pool: project a chunk of C
    tokens, scatter its KV into the lane's blocks (in place), then attend
    through the block table (cached context + the chunk itself, causally);
    under a sharded plan, stripe by stripe (``_paged_prefill_striped``).

    x: (B, C, d); starts: (B,) absolute position of x[:, 0]; lengths: (B,)
    valid tokens per row.  Invalid positions are written to the parking
    block 0 at offset 0, whose contents are never read unmasked.  The
    scatter is queued before the kernel on the same stream, so the kernel
    reads the chunk's own keys.  -> (out (B, C, d), cache)."""
    dt = plan.compute_dtype
    B, C = x.shape[:2]
    q = _project(x, p["w_q"].to(dt))
    k = _project(x, p["w_k"].to(dt))
    v = _project(x, p["w_v"].to(dt))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    cols = torch.arange(C, device=x.device)[None, :]
    positions = starts[:, None] + cols
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if plan.paged_pool_sharded(cfg):
        o = _paged_prefill_striped(plan.tp, q, cache["k"], cache["v"],
                                   block_tables, starts, lengths, k, v,
                                   scale=scale)
        return _out_proj(o, p["w_o"].to(dt)), cache
    bs = cache["k"].shape[1]
    valid = cols < lengths[:, None]
    safe_pos = torch.where(valid, positions, 0)
    blk = torch.gather(block_tables, 1, (safe_pos // bs).long())
    blk = torch.where(valid, blk, 0).reshape(-1).long()
    off = torch.where(valid, safe_pos % bs, 0).reshape(-1).long()
    K = cache["k"].shape[2]
    cache["k"][blk, off] = k.reshape(B * C, K, -1).to(cache["k"].dtype)
    cache["v"][blk, off] = v.reshape(B * C, K, -1).to(cache["v"].dtype)
    o = ops.paged_prefill_attention(q, cache["k"], cache["v"], block_tables,
                                    starts, scale=scale)
    return _out_proj(o, p["w_o"].to(dt)), cache


# ---------------------------------------------------------------------------
# slot decode (contiguous per-lane cache)
# ---------------------------------------------------------------------------

def _swa_decode(q, k_new, v_new, cache: dict, positions: torch.Tensor, *,
                scale: float) -> torch.Tensor:
    """Ring-buffer sliding-window decode (the reference's ``_swa_decode``):
    write the new token's KV at slot ``position % W`` (in place), then
    attend over every filled slot.  The reference's mask, ``slot <=
    position or position >= W``, is ``slot <= min(position, W - 1)``, and
    softmax does not depend on the order of the slots, so the dense decode
    kernel runs on the ring with the positions clamped so."""
    W = cache["k"].shape[1]
    rows = torch.arange(q.shape[0], device=q.device)
    slot = (positions % W).long()
    for name, new in (("k", k_new), ("v", v_new)):
        cache[name][rows, slot] = new.to(cache[name].dtype)
    return ops.decode_attention(q, cache["k"], cache["v"],
                                positions.clamp(max=W - 1), scale=scale,
                                ring=True)


def gqa_decode(p: dict, x: torch.Tensor, cache: dict,
               positions: torch.Tensor, cfg: ArchConfig, plan: ShardPlan):
    """Slot-cache decode step (``_flash_decode_core`` on one device): write
    the new token's KV at ``positions`` (in place; a position outside the
    cache keeps the old row), then attend over keys 0..position.  For a
    sliding window the cache is its ring (``_swa_decode``); MLA takes
    ``mla_decode``.  x: (B, d); cache leaves (B, S, K, hd) -> (out (B, d),
    cache)."""
    if cfg.attn_kind == "mla":
        return mla_decode(p, x, cache, positions, cfg, plan)
    dt = plan.compute_dtype
    q, k_new, v_new = _decode_qkv(p, x, positions, cfg, plan)
    if _swa(cfg):
        o = _swa_decode(q, k_new, v_new, cache, positions,
                        scale=1.0 / math.sqrt(cfg.head_dim))
        return _out_proj(o, p["w_o"].to(dt)), cache
    S = cache["k"].shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    write = ((positions >= 0) & (positions < S))[:, None, None]
    safe = positions.clamp(0, S - 1).long()
    for name, new in (("k", k_new), ("v", v_new)):
        dst = cache[name]
        dst[rows, safe] = torch.where(write, new.to(dst.dtype), dst[rows, safe])
    o = ops.decode_attention(q, cache["k"], cache["v"], positions,
                             scale=1.0 / math.sqrt(cfg.head_dim))
    return _out_proj(o, p["w_o"].to(dt)), cache


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _decode_qkv(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, plan: ShardPlan):
    """One-token projection: q (B, H, hd) and the new token's k/v
    (B, K, hd), with qk_norm and rope applied."""
    dt = plan.compute_dtype
    q = _project(x, p["w_q"].to(dt))
    k_new = _project(x, p["w_k"].to(dt))
    v_new = _project(x, p["w_v"].to(dt))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k_new = L.rms_norm(k_new, p["k_norm"])
    q = L.apply_rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
    k_new = L.apply_rope(k_new[:, None], positions[:, None], cfg.rope_theta)[:, 0]
    return q, k_new, v_new


def _write_owned(stripe: torch.Tensor, rows: torch.Tensor,
                 owned: torch.Tensor, new: torch.Tensor) -> None:
    """``stripe`` viewed as rows of (K, hd): row ``rows[i]`` = ``new[i]``
    for the owned writes only, in place and with no host sync; i runs over
    a decode step's B lanes or a chunk's B * C tokens.  The reference
    drops the other writes (an out-of-range index with ``mode="drop"``);
    torch has no such scatter, so each unowned write goes to the first
    owned write's row with that write's value (with none owned, row
    ``rows[0]`` with the value it holds).  The owned rows are distinct (one
    token per position), so every repeated index then carries one value,
    and the order of the writes cannot matter.  The first owned write is
    picked through a (1,) index tensor: no boolean indexing, no
    ``nonzero``, and no 0-dim index, which would copy to the host."""
    flat = stripe.view(-1, *stripe.shape[2:])
    first = owned.to(torch.int32).argmax().reshape(1)  # first owned, or 0
    row = rows.index_select(0, first)
    fill = torch.where(owned.any(), new.index_select(0, first),
                       flat.index_select(0, row))
    flat[torch.where(owned, rows, row)] = \
        torch.where(owned[:, None, None], new, fill)


def _paged_decode_core(rank: int, q, k_stripe, v_stripe, block_tables,
                       positions, k_new, v_new, *, scale: float,
                       plan_lanes: int | None = None):
    """One rank's paged decode on its stripe of the block-striped pool
    (port of ``models/attention.py::_paged_decode_core`` up to its
    collectives).

    Rank r owns the physical blocks ``[r*nb_loc, (r+1)*nb_loc)``: the new
    token's KV is written (in place) only by the rank that owns its block,
    the table is localized and clipped into the stripe, and kernel 4
    attends over the owned slots only.  q (B, H, hd); k_stripe/v_stripe
    (nb_loc, bs, K, hd); block_tables (B, T) *global* block ids; k_new/
    v_new (B, K, hd).  Returns this stripe's ``(o, lse)``, which
    ``combine_lse`` merges where the reference takes pmax/psum."""
    nb_loc, bs = k_stripe.shape[0], k_stripe.shape[1]
    off = rank * nb_loc
    blk = torch.gather(block_tables, 1,
                       (positions // bs)[:, None].long())[:, 0]
    local_b = blk - off
    owned = (local_b >= 0) & (local_b < nb_loc)
    rows = (local_b.clamp(0, nb_loc - 1) * bs + positions % bs).long()
    _write_owned(k_stripe, rows, owned, k_new.to(k_stripe.dtype))
    _write_owned(v_stripe, rows, owned, v_new.to(v_stripe.dtype))
    local_t = block_tables - off
    t_owned = ((local_t >= 0) & (local_t < nb_loc)).to(torch.int32)
    return ops.paged_decode_attention_lse(
        q, k_stripe, v_stripe, local_t.clamp(0, nb_loc - 1), positions,
        t_owned, scale=scale, plan_lanes=plan_lanes)


def _paged_decode_striped(shards: int, q, k_pool, v_pool, block_tables,
                          positions, k_new, v_new, *, scale: float,
                          plan_lanes: int | None = None):
    """The sharded paged decode on one device: every rank's
    ``_paged_decode_core`` on its contiguous stripe of the pool (the array
    ``shard_map`` hands that rank in the reference), then one
    ``combine_lse`` where the reference reduces with pmax/psum.
    k_pool/v_pool (n_blocks, bs, K, hd), n_blocks a multiple of
    ``shards``.  -> o (B, H, hd) in q's dtype."""
    nb_loc = k_pool.shape[0] // shards
    os, lses = zip(*(
        _paged_decode_core(r, q, k_pool[r * nb_loc:(r + 1) * nb_loc],
                           v_pool[r * nb_loc:(r + 1) * nb_loc], block_tables,
                           positions, k_new, v_new, scale=scale,
                           plan_lanes=plan_lanes)
        for r in range(shards)))
    return combine_lse(torch.stack(os), torch.stack(lses))


def _paged_prefill_core(rank: int, q, k_stripe, v_stripe, block_tables,
                        starts, lengths, k, v, *, scale: float):
    """One rank's chunk of chunked prefill on its stripe of the
    block-striped pool (port of ``models/attention.py::_paged_prefill_core``
    up to its collectives).

    The chunk's KV is written (in place) only into the blocks the rank
    owns, and only for valid tokens (an invalid token's write is dropped,
    as the reference drops it; the unsharded path parks it in block 0);
    then kernel 3's owned/LSE form attends over the owned slots through
    the table localized and clipped into the stripe.  The writes land
    before the kernel reads on the same stream, so the chunk sees its own
    keys on the rank that owns them.  q (B, C, H, hd); k_stripe/v_stripe
    (nb_loc, bs, K, hd); block_tables (B, T) *global* ids; starts/lengths
    (B,); k/v (B, C, K, hd).  Returns this stripe's ``(o (B, C, H, hd),
    lse (B, C, H))``."""
    B, C = q.shape[:2]
    nb_loc, bs, K = k_stripe.shape[:3]
    off = rank * nb_loc
    cols = torch.arange(C, device=q.device)[None, :]
    valid = cols < lengths[:, None]
    safe_pos = torch.where(valid, starts[:, None] + cols, 0)
    local_b = torch.gather(block_tables, 1, (safe_pos // bs).long()) - off
    owned = valid & (local_b >= 0) & (local_b < nb_loc)
    rows = (local_b.clamp(0, nb_loc - 1) * bs + safe_pos % bs).reshape(-1)
    for stripe, new in ((k_stripe, k), (v_stripe, v)):
        _write_owned(stripe, rows.long(), owned.reshape(-1),
                     new.reshape(B * C, K, -1).to(stripe.dtype))
    local_t = block_tables - off
    t_owned = ((local_t >= 0) & (local_t < nb_loc)).to(torch.int32)
    return ops.paged_prefill_attention_lse(
        q, k_stripe, v_stripe, local_t.clamp(0, nb_loc - 1), starts, t_owned,
        scale=scale)


def _paged_prefill_striped(shards: int, q, k_pool, v_pool, block_tables,
                           starts, lengths, k, v, *, scale: float):
    """The sharded chunk prefill on one device: every rank's
    ``_paged_prefill_core`` on its contiguous stripe, then one
    ``combine_lse`` over the (B, C, H) rows where the reference reduces
    with pmax/psum.  -> o (B, C, H, hd) in q's dtype."""
    nb_loc = k_pool.shape[0] // shards
    os, lses = zip(*(
        _paged_prefill_core(r, q, k_pool[r * nb_loc:(r + 1) * nb_loc],
                            v_pool[r * nb_loc:(r + 1) * nb_loc], block_tables,
                            starts, lengths, k, v, scale=scale)
        for r in range(shards)))
    return combine_lse(torch.stack(os), torch.stack(lses))


def gqa_decode_paged(p: dict, x: torch.Tensor, cache: dict,
                     positions: torch.Tensor, block_tables: torch.Tensor,
                     cfg: ArchConfig, plan: ShardPlan,
                     plan_lanes: int | None = None):
    """Paged-pool decode step: write the new token's KV into its block (in
    place: the pool is updated where it lies), then attend through the
    block table; under a sharded plan, stripe by stripe.  ``plan_lanes``
    pins kernels 2 and 4 to the split plan of so many lanes (a verify
    pass's fold).  x: (B, d) -> (out (B, d), cache)."""
    dt = plan.compute_dtype
    q, k_new, v_new = _decode_qkv(p, x, positions, cfg, plan)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if plan.paged_pool_sharded(cfg):
        o = _paged_decode_striped(plan.tp, q, cache["k"], cache["v"],
                                  block_tables, positions, k_new, v_new,
                                  scale=scale, plan_lanes=plan_lanes)
        return _out_proj(o, p["w_o"].to(dt)), cache
    bs = cache["k"].shape[1]
    blk = torch.gather(block_tables, 1, (positions // bs)[:, None].long())[:, 0]
    off = positions % bs
    cache["k"][blk, off] = k_new.to(cache["k"].dtype)
    cache["v"][blk, off] = v_new.to(cache["v"].dtype)
    o = ops.paged_decode_attention(q, cache["k"], cache["v"], block_tables,
                                   positions, scale=scale,
                                   plan_lanes=plan_lanes)
    return _out_proj(o, p["w_o"].to(dt)), cache


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _flash_padded(q, k, v, *, scale: float) -> torch.Tensor:
    """Causal kernel-1 attention where v's head dim differs from q's:
    q, k (B, S, H, Dk), v (B, S, H, Dv) zero-padded to the least head dim
    kernel 1 takes that holds both, o cut back to Dv.  The zeros add
    exactly 0 to every score, and each output column is its own weighted
    sum of v's column, so the cut o is the unpadded attention's.
    -> (B, S, H, Dv)."""
    Dv = v.shape[-1]
    D = min(d for d in FLASH_DIMS if d >= max(q.shape[-1], Dv))
    q, k, v = (F.pad(t, (0, D - t.shape[-1])) if t.shape[-1] != D else t
               for t in (q, k, v))
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), scale=scale, causal=True)
    return o.transpose(1, 2)[..., :Dv]


def _mla_queries(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ArchConfig, plan: ShardPlan):
    """Low-rank queries: (q_nope (..., H, nope), q_rope with rope applied),
    x (..., S, d) with positions (..., S)."""
    dt = plan.compute_dtype
    cq = L.rms_norm(x @ p["w_dq"].to(dt), p["q_norm"])
    q = _project(cq, p["w_uq"].to(dt))
    nope = cfg.qk_nope_head_dim
    return q[..., :nope], L.apply_rope(q[..., nope:], positions,
                                       cfg.rope_theta)


def _mla_latent(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, plan: ShardPlan):
    """The latent ``ckv`` (..., S, R) and the shared rope key ``kr``
    (..., S, rope_d) of x (..., S, d)."""
    dt = plan.compute_dtype
    ckv = L.rms_norm(x @ p["w_dkv"].to(dt), p["kv_norm"])
    kr = L.apply_rope((x @ p["w_kr"].to(dt))[..., None, :], positions,
                      cfg.rope_theta)[..., 0, :]
    return ckv, kr


def mla_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, plan: ShardPlan, *, want_cache: bool):
    """MLA prefill (the reference's ``mla_forward``): the latent expanded
    to per-head k (nope part, plus the shared rope key) and v, causal
    attention through kernel 1 at scale 1/sqrt(nope + rope).
    x (B, S, d) -> (out (B, S, d), {"ckv", "kr"} | None)."""
    dt = plan.compute_dtype
    q_nope, q_rope = _mla_queries(p, x, positions, cfg, plan)
    ckv, kr = _mla_latent(p, x, positions, cfg, plan)
    cache = {"ckv": ckv, "kr": kr} if want_cache else None
    k_nope = _project(ckv, p["w_uk"].to(dt))
    v = _project(ckv, p["w_uv"].to(dt))
    k = torch.cat([k_nope, kr[:, :, None, :].expand(
        *k_nope.shape[:3], kr.shape[-1])], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    o = _flash_padded(q, k, v, scale=scale)
    return _out_proj(o, p["w_o"].to(dt)), cache


def _mla_decode_core(qc, qr, ckv, kr, c_new, kr_new, positions, *,
                     scale: float) -> torch.Tensor:
    """Absorbed MLA decode over the latent slot cache (the reference's
    ``_mla_decode_core`` on one device): write the new token's latent and
    rope key at ``positions`` (in place; a position outside the cache
    keeps the old row), then attend over keys 0..position with the
    unnormalised exp(s - m) rounded to the cache's dtype before the
    latent PV product, as the reference rounds it.  qc (B, H, R); qr
    (B, H, rope_d); ckv (B, S, R); kr (B, S, rope_d) -> the latent output
    (B, H, R) in qc's dtype."""
    B, S = ckv.shape[:2]
    rows = torch.arange(B, device=qc.device)
    write = ((positions >= 0) & (positions < S))[:, None]
    safe = positions.clamp(0, S - 1).long()
    for dst, new in ((ckv, c_new), (kr, kr_new)):
        dst[rows, safe] = torch.where(write, new.to(dst.dtype),
                                      dst[rows, safe])
    s = (torch.einsum("bhr,bsr->bhs", qc.float(), ckv.float())
         + torch.einsum("bhp,bsp->bhs", qr.float(), kr.float())) * scale
    mask = (torch.arange(S, device=qc.device)[None, None, :]
            <= positions[:, None, None])
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    pexp = torch.exp(s - m[..., None])
    num = torch.einsum("bhs,bsr->bhr", pexp.to(ckv.dtype).float(),
                       ckv.float())
    o = num / pexp.sum(dim=-1).clamp_min(1e-30)[..., None]
    return o.to(qc.dtype)


def mla_decode(p: dict, x: torch.Tensor, cache: dict,
               positions: torch.Tensor, cfg: ArchConfig, plan: ShardPlan):
    """Slot-cache MLA decode step (the reference's ``mla_decode`` on one
    device): W_uk absorbed into the query, attention over the latent, then
    W_uv and the output projection.  x (B, d); cache {"ckv" (B, S, R),
    "kr" (B, S, rope_d)}, written in place -> (out (B, d), cache)."""
    dt = plan.compute_dtype
    q_nope, q_rope = _mla_queries(p, x[:, None], positions[:, None], cfg,
                                  plan)
    qc = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], p["w_uk"].to(dt))
    c_new, kr_new = _mla_latent(p, x[:, None], positions[:, None], cfg, plan)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    o = _mla_decode_core(qc, q_rope[:, 0], cache["ckv"], cache["kr"],
                         c_new[:, 0], kr_new[:, 0], positions, scale=scale)
    ov = torch.einsum("bhr,rhv->bhv", o, p["w_uv"].to(dt))
    return _out_proj(ov, p["w_o"].to(dt)), cache


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def init_paged_attn_cache(cfg: ArchConfig, plan: ShardPlan, n_blocks: int,
                          block_size: int, dtype=torch.bfloat16,
                          device="cuda") -> dict:
    """Per-layer paged KV pool (GQA families only): one global block pool
    shared by every sequence, indexed through per-request block tables."""
    if cfg.rwkv or cfg.family == "hybrid" or cfg.attn_kind != "gqa":
        raise ValueError(f"{cfg.name}: paged KV cache requires plain GQA "
                         f"attention (got attn_kind={cfg.attn_kind!r})")
    if plan.paged_pool_sharded(cfg) and n_blocks % plan.tp:
        raise ValueError(f"paged pool of {n_blocks} blocks does not divide "
                         f"the {plan.tp}-way model axis; round n_blocks up")
    shape = (n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_attn_cache(cfg: ArchConfig, plan: ShardPlan, batch: int,
                    seq_len: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """Per-layer (unstacked) slot cache: k/v (batch, seq_len, K, hd), for
    a sliding window its ring (batch, min(window, seq_len), K, hd), and
    for MLA the latent ``ckv`` (batch, seq_len, kv_lora_rank) beside the
    rope key ``kr`` (batch, seq_len, qk_rope_head_dim)."""
    if cfg.attn_kind == "mla":
        return {"ckv": torch.zeros((batch, seq_len, cfg.kv_lora_rank),
                                   dtype=dtype, device=device),
                "kr": torch.zeros((batch, seq_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
    width = min(cfg.window, seq_len) if _swa(cfg) else seq_len
    shape = (batch, width, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
