"""``jax.random``'s threefry path in torch, bit for bit.

Mirrors, for raw ``uint32[2]`` key data (``jax.random.PRNGKey`` without
the typed-key wrapper):

* ``jax._src.prng.threefry_2x32`` -> ``threefry2x32``: Threefry-2x32 with
  20 rounds, rotations 13/15/26/6 and 17/29/16/24, and the key schedule
  ``(k0, k1, k0 ^ k1 ^ 0x1BD11BDA)``;
* ``jax.random.PRNGKey`` (``threefry_seed``) -> ``prng_key``;
* ``jax.random.fold_in`` -> ``fold_in``;
* ``jax.random.bits`` -> ``random_bits``, in the layout of
  ``jax_threefry_partitionable=True`` (jax's default since 0.5): draw i
  is ``x0 ^ x1`` of the block at counter ``(0, i)``;
* ``jax.random.uniform``, ``jax.random.gumbel`` (the default "low" mode)
  and ``jax.random.categorical`` (``replace=True``) -> ``uniform``,
  ``gumbel``, ``categorical``.

Every 32-bit word is held in an int64 tensor masked to 32 bits (torch has
no unsigned shifts on uint32 on every device), so the same calls give the
same bits on the CPU and on CUDA.  Key data is int64 ``(..., 2)``; keys
broadcast against the counters, so one call draws for many lanes.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key``
    (..., 2); key and counters broadcast.  Returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for int32 seeds: ``[0, seed mod
    2**32]``, one key per seed (..., 2)."""
    seed = seed.to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the counter
    ``(0, data)``.  ``data`` is an int (for every key) or a tensor that
    broadcasts against the key's leading axes.  Allocates on the key's
    device only, so it can run inside a CUDA graph capture."""
    if isinstance(data, int):
        data = torch.full(key.shape[:-1], data & MASK, dtype=torch.int64,
                          device=key.device)
    else:
        data = data.to(torch.int64) & MASK
    x0, x1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack([x0, x1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32 values in int64): one row of
    n draws per key, (..., n)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[..., None, :], torch.zeros_like(i), i)
    return x0 ^ x1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), less 1, scaled, then
    clamped below at ``minval`` (..., n)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    # the bounds and their difference in float32, as jax converts them
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in its "low" mode:
    ``-log(-log(u))`` for u uniform on [tiny, 1) (..., n)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, n, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis
    (``replace=True``): the argmax of gumbel noise plus the logits, one
    draw per key; key (..., 2), logits (..., V) float32 -> (...) int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
