"""Shard plan (port of ``repro.models.sharding``).

The plan carries the two dtypes every model function reads, the
model-parallel degree ``tp``, the serve-time quantization knob
``quantize_serve`` (int8 MoE experts, ``models.moe``) and training's
``remat`` (``"full"``: each layer's activations recomputed in the
backward, ``Model._trunk``).  There is no mesh:
at ``tp > 1`` the paged KV pool is block-striped (``paged_pool_sharded``)
and a MoE layer combines its experts rank by rank (``moe._moe_core``), and
every stripe and rank stays on the model's one device, where the reference
hands rank r its stripe and its experts on its own device through
``shard_map``.  The weights stay whole, so projections, MLP and head
compute as at ``tp = 1``.

Every padded dimension equals the published one (``h_pad == n_heads``,
``k_pad == n_kv_heads``, ``v_pad == vocab_size``): a serving plan only
takes degrees that divide the head, kv-head, vocab and d_ff counts
(``serving.engine.shard_compat``).  For the same reason the reference's
``kv_padded`` (kv heads padded up to ``tp`` when ``0 < k < tp``) can never
hold on a serving plan: there ``k % tp != 0``, which ``shard_compat``
rejects, so the port has no kv padding.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShardPlan:
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    tp: int = 1                          # model-parallel degree
    shard_paged_pool: bool = True        # stripe the paged pool over tp
    quantize_serve: bool = False         # int8 MoE experts (TAPAS's knob)
    remat: str = "none"                  # none | full: checkpoint each layer

    def __post_init__(self):
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', got "
                             f"{self.remat!r}")

    def h_pad(self, cfg: ArchConfig) -> int:
        return cfg.n_heads

    def k_pad(self, cfg: ArchConfig) -> int:
        return cfg.n_kv_heads

    def v_pad(self, cfg: ArchConfig) -> int:
        return cfg.vocab_size

    def e_pad(self, cfg: ArchConfig) -> int:
        """Expert count padded to a multiple of ``tp`` (the reference's
        expert parallelism; 0 without experts)."""
        if not cfg.n_experts:
            return 0
        return -(-cfg.n_experts // self.tp) * self.tp

    def paged_pool_sharded(self, cfg: ArchConfig | None = None) -> bool:
        """Stripe the paged block pool's ``n_blocks`` axis over ``tp``
        ranks?  Rank r owns the physical blocks ``[r*nb_loc,
        (r+1)*nb_loc)``; decode attends stripe by stripe and merges the
        partial softmaxes exactly (``attention._paged_decode_striped``).
        It shards by blocks, not heads, so it holds for any kv-head
        count."""
        return self.shard_paged_pool and self.tp > 1


def local_plan(**kw) -> ShardPlan:
    """Single-device plan."""
    return ShardPlan(**kw)
