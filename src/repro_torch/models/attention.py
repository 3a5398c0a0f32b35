"""GQA attention (port of the dense-GQA parts of ``repro.models.attention``).

Projections keep the reference layouts (``w_q (d, H, hd)``, ``w_k``/``w_v
(d, K, hd)``, ``w_o (H, hd, d)``) and run as plain matmuls.  Where the
reference model runs XLA attention (``causal_attention``,
``paged_attention``) the port calls the kernels through ``ops``: the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.sharding import ShardPlan


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


def kv_index(cfg: ArchConfig, h_pad: int, k_pad: int | None = None,
             device="cuda") -> torch.Tensor:
    """Constant q-head -> kv-slot map; pad heads point at slot 0.  On one
    device this is h * n_kv // n_heads, the map the kernels apply."""
    k = k_pad or cfg.n_kv_heads
    idx = [h * k // cfg.n_heads for h in range(cfg.n_heads)]
    idx += [0] * (h_pad - cfg.n_heads)
    return torch.tensor(idx, dtype=torch.int32, device=device)


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

def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, plan: ShardPlan, *, want_cache: bool):
    """Causal GQA. x: (B, S, d) -> (out (B, S, d), cache | None); the cache
    holds this layer's un-rounded k/v (B, S, K, hd) in the compute dtype."""
    if cfg.attn_kind != "gqa" or not cfg.causal:
        raise NotImplementedError(f"{cfg.name}: only causal GQA is ported "
                                  f"(attn_kind={cfg.attn_kind!r})")
    dt = plan.compute_dtype
    q = _project(x, p["w_q"].to(dt))
    k = _project(x, p["w_k"].to(dt))
    v = _project(x, p["w_v"].to(dt))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    cache = {"k": k, "v": v} if want_cache else None
    # (B, H, S, hd) views of the (B, S, H, hd) activations: no copies
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2),
                            scale=1.0 / math.sqrt(cfg.head_dim))
    return _out_proj(o.transpose(1, 2), p["w_o"].to(dt)), cache


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


def gqa_decode_paged(p: dict, x: torch.Tensor, cache: dict,
                     positions: torch.Tensor, block_tables: torch.Tensor,
                     cfg: ArchConfig, plan: ShardPlan):
    """Paged-pool decode step: write the new token's KV into its block (in
    place: the pool is updated where it lies), then attend through the
    block table.  x: (B, d) -> (out (B, d), cache)."""
    dt = plan.compute_dtype
    q, k_new, v_new = _decode_qkv(p, x, positions, cfg, plan)
    bs = cache["k"].shape[1]
    blk = torch.gather(block_tables, 1, (positions // bs)[:, None].long())[:, 0]
    off = positions % bs
    cache["k"][blk, off] = k_new.to(cache["k"].dtype)
    cache["v"][blk, off] = v_new.to(cache["v"].dtype)
    o = ops.paged_decode_attention(q, cache["k"], cache["v"], block_tables,
                                   positions,
                                   scale=1.0 / math.sqrt(cfg.head_dim))
    return _out_proj(o, p["w_o"].to(dt)), cache


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
    shape = (n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
