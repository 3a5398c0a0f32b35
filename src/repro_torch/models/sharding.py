"""Single-device shard plan (port of ``repro.models.sharding``).

Only the meaning of ``local_plan`` is ported: one device, no mesh, so every
padded dimension equals the published one (``h_pad == n_heads``,
``k_pad == n_kv_heads``, ``v_pad == vocab_size``).  The plan carries the two
dtypes every model function reads.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShardPlan:
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def h_pad(self, cfg: ArchConfig) -> int:
        return cfg.n_heads

    def k_pad(self, cfg: ArchConfig) -> int:
        return cfg.n_kv_heads

    def v_pad(self, cfg: ArchConfig) -> int:
        return cfg.vocab_size


def local_plan(**kw) -> ShardPlan:
    """Single-device plan."""
    return ShardPlan(**kw)
