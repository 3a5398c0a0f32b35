"""Dispatch between each kernel and its plain version by device.

A CPU tensor runs the plain PyTorch version; a CUDA tensor launches the
hand-written kernel, whose wrapper raises on anything it cannot take.
There is no fallback from a CUDA tensor to the plain version.  The model
calls these through the module (``ops.flash_attention``) so one call site
serves both devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU, False when every one is on
    CUDA; anything else is an error."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs on devices {sorted(kinds)}: need all "
                     f"on the CPU or all on CUDA")


def flash_attention(q, k, v, *, scale=None):
    """Causal GQA attention: q (B, H, S, D), k/v (B, K, S, D), any strides."""
    if _on_cpu(q, k, v):
        return _flash.flash_attention_ref(q, k, v, scale=scale)
    return _flash.flash_attention(q, k, v, scale=scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, positions, *,
                           scale=None):
    """One-token attention over a paged KV pool."""
    if _on_cpu(q, k_pool, v_pool, block_tables, positions):
        return _paged.paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables, positions, scale=scale)
    return _paged.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                         positions, scale=scale)


__all__ = ["flash_attention", "paged_decode_attention"]
