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
  ``gumbel``, ``categorical``;
* ``jax.random.split`` -> ``split`` (key i is threefry of the counter
  ``(0, i)``, as ``fold_in(key, i)``), ``jax.random.randint`` (int32) ->
  ``randint``, and ``jax.random.normal`` in bf16 -> ``normal_bf16``.

Every 32-bit word is held in an int64 tensor masked to 32 bits (torch has
no unsigned shifts on uint32 on every device), so the same calls give the
same bits on the CPU and on CUDA.  Key data is int64 ``(..., 2)``; keys
broadcast against the counters, so one call draws for many lanes.
"""
from __future__ import annotations

import math

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


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` with ``jax_threefry_partitionable``:
    key i is threefry of the counter ``(0, i)``, the same as ``fold_in(key,
    i)``.  key (2,) -> (num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key, torch.zeros_like(i), i)
    return torch.stack([x0, x1], dim=-1)


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 (the
    default without x64; ``maxval`` at most 2**31 - 1): two 32-bit draws
    per value from the key's two split keys, folded into [minval, maxval)
    by jax's modulus, ``(hi % span) * m + lo % span`` mod span with m =
    (2**16 % span)**2 mod span, all in uint32 arithmetic (so m is 0 once
    span passes 2**16, as jax's wraps).  Returns int64 values in
    ``shape``."""
    n = math.prod(shape)
    k1, k2 = split(key)
    hi, lo = random_bits(k1, n), random_bits(k2, n)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & MASK) % span     # uint32, as jax's
    # products of two values below 2**32 wrap in int64 as uint64 does, and
    # the mask keeps the low 32 bits: uint32 arithmetic
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return (minval + off % span).view(shape)


# jax's erf_inv in float32 (XLA's ErfInv32: M. Giles, "Approximating the
# erfinv function"), the polynomials in w = -log((1 - x)(1 + x)), highest
# power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 of f32 ``x`` in |x| < 1 with XLA's polynomial, each step
    rounded to f32 (torch's ``erfinv`` is another approximation)."""
    w = -torch.log((1.0 - x) * (1.0 + x))
    lt = w < 5.0
    wl = w - 2.5
    wg = torch.sqrt(w) - 3.0
    pl = torch.full_like(x, _ERFINV_LT5[0])
    pg = torch.full_like(x, _ERFINV_GE5[0])
    for cl, cg in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        pl = cl + pl * wl
        pg = cg + pg * wg
    return torch.where(lt, pl, pg) * x


def normal_bf16(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.normal(key, shape, bfloat16)``: 8 random bits a value
    (bf16 has 7 mantissa bits, so jax draws 8), the top 7 as the mantissa
    of a bf16 in [1, 2), less 1, scaled onto [nextafter(-1, 0), 1) in bf16
    (the span rounds to 2), then sqrt(2) erf^-1 of it: erf^-1 in f32 on
    the widened value, rounded to bf16, times sqrt(2) in bf16.  Only 128
    values can come out; ``tests/test_torch_prng_embed.py`` holds all of
    them against jax.  Returns bf16 values in ``shape``."""
    n = math.prod(shape)
    bf = dict(dtype=torch.bfloat16, device=key.device)
    bits = (random_bits(key, n) & 0xFF) >> 1
    f = (bits | 0x3F80).to(torch.int16).view(torch.bfloat16) \
        - torch.ones((), **bf)
    lo = torch.nextafter(torch.tensor(-1.0, **bf), torch.zeros((), **bf))
    u = torch.maximum(f * (1.0 - lo) + lo, lo)
    e = _erfinv_f32(u.float()).to(torch.bfloat16)
    return (e * torch.full((), math.sqrt(2.0), **bf)).view(shape)
