"""RWKV6 (Finch) time-mix and channel-mix (port of the RWKV half of
``repro.models.ssm``; the mamba branch waits for the hybrid family).

Parameters keep the reference's layouts (``w_r (d, H, hd)``, ``w_o (H, hd,
d)``, ``lora_a (5, d, 32)``, ...), so a JAX ``Model.init`` tree carries over
by copy.  Where the reference scans ``_wkv_chunk`` over chunks of the
sequence (the chunks only carry the state from one scan to the next), the
port makes one ``ops.rwkv6_wkv`` call over the whole sequence: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors.  The roundings
follow the reference: the recurrence runs in f32 (bf16 r/k/v are widened
exactly and y is rounded once to the compute dtype, as the reference's f32
recurrence followed by ``astype``), ``w = exp(-exp(dw))`` in f32, y in the
compute dtype before the per-head ``rms_norm``, the new shift state in the
compute dtype.

With ``out_state`` the new state is written into that tree in place (the
slot pool's decode passes the pool's own layer views): the recurrence
writes its final state over the old one, and the shift is copied in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.sharding import ShardPlan

LORA_MIX = 32   # the token-shift LoRA rank (fixed; rwkv_lora_w is the decay's)


def _normal(shape, std, *, generator, dtype, device):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, std, generator=generator)
    return w.to(dtype)


def init_rwkv_tmix(cfg: ArchConfig, plan: ShardPlan, *,
                   generator: torch.Generator, device="cuda") -> dict:
    d, hd, H = cfg.d_model, cfg.head_dim, plan.h_pad(cfg)
    lw, dt = cfg.rwkv_lora_w, plan.param_dtype
    kw = dict(generator=generator, dtype=dt, device=device)
    return {
        "mu_base": torch.full((d,), 0.5, dtype=dt, device=device),
        "mu": torch.full((5, d), 0.5, dtype=dt, device=device),
        "lora_a": _normal((5, d, LORA_MIX), 0.01, **kw),
        "lora_b": _normal((5, LORA_MIX, d), 0.01, **kw),
        "w_r": L.dense_init((d, H, hd), **kw),
        "w_k": L.dense_init((d, H, hd), **kw),
        "w_v": L.dense_init((d, H, hd), **kw),
        "w_g": L.dense_init((d, H, hd), **kw),
        "w_o": L.dense_init((H, hd, d), in_axis=1, **kw),
        "decay_base": torch.full((H, hd), -6.0, dtype=dt, device=device),
        "decay_a": _normal((d, lw), 0.01, **kw),
        "decay_b": _normal((lw, H, hd), 0.01, **kw),
        "u_bonus": _normal((H, hd), 0.1, **kw),
        "ln_x": torch.ones((H, hd), dtype=dt, device=device),
    }


def _rwkv_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """ddlerp token-shift: (B, S, 5, d) mixed inputs for r/k/v/w/g."""
    dt = x.dtype
    xx = x_prev - x
    base = x + xx * p["mu_base"].to(dt)
    lo = torch.tanh(torch.einsum("bsd,cdr->bscr", base, p["lora_a"].to(dt)))
    dyn = torch.einsum("bscr,crd->bscd", lo, p["lora_b"].to(dt))
    mixes = p["mu"].to(dt)[None, None] + dyn
    return x[:, :, None, :] + xx[:, :, None, :] * mixes


def _shifted(x: torch.Tensor, state: dict | None, dt) -> torch.Tensor:
    """The previous token's input at every position: the carried shift (or
    zeros), then x without its last token (dtypes promote as in JAX)."""
    B, _, d = x.shape
    x_last = state["shift"] if state is not None \
        else torch.zeros(B, 1, d, dtype=dt, device=x.device)
    return torch.cat([x_last, x[:, :-1]], dim=1)


def _new_shift(x: torch.Tensor, dt, out_state: dict | None) -> torch.Tensor:
    last = x[:, -1:].to(dt)
    if out_state is None:
        return last
    return out_state["shift"].copy_(last)


def _flat(w: torch.Tensor, dt) -> torch.Tensor:
    """(d, H, hd) projection as a (d, H*hd) matrix in ``dt``."""
    return w.to(dt).reshape(w.shape[0], -1)


def rwkv_tmix_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                      plan: ShardPlan, state: dict | None = None, *,
                      out_state: dict | None = None):
    """RWKV6 time-mix.  x (B, S, d) -> (out (B, S, d), new state).  The new
    state is written into ``out_state`` when given (it may be ``state``)."""
    dt = plan.compute_dtype
    x_prev = _shifted(x, state, dt)
    mixed = _rwkv_mix(p, x, x_prev)
    xr, xk, xv, xw, xg = mixed.unbind(dim=2)
    r = xr @ _flat(p["w_r"], dt)
    k = xk @ _flat(p["w_k"], dt)
    v = xv @ _flat(p["w_v"], dt)
    g = xg @ _flat(p["w_g"], dt)
    H, hd = p["w_r"].shape[1:]
    heads = lambda t: t.view(*t.shape[:-1], H, hd)  # noqa: E731
    dlo = xw @ p["decay_a"].to(dt)
    dw = p["decay_base"].float() + heads(dlo @ _flat(p["decay_b"], dt)).float()
    w = torch.exp(-torch.exp(dw))                   # (B, S, H, hd) in (0, 1)
    s0 = state["wkv"] if state is not None else None
    s_out = out_state["wkv"] if out_state is not None else None
    y, s_last = ops.rwkv6_wkv(heads(r), heads(k), heads(v), w,
                              p["u_bonus"].float(), s0, s_out=s_out)
    # per-head group norm + gate
    y = L.rms_norm(y.to(dt), p["ln_x"])
    y = y * F.silu(heads(g).float()).to(dt)
    out = y.reshape(*y.shape[:-2], H * hd) @ p["w_o"].to(dt).reshape(H * hd, -1)
    return out, {"shift": _new_shift(x, dt, out_state), "wkv": s_last}


def init_rwkv_cmix(cfg: ArchConfig, plan: ShardPlan, *,
                   generator: torch.Generator, device="cuda") -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, plan.param_dtype
    kw = dict(generator=generator, dtype=dt, device=device)
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dt, device=device),
        "w_k": L.dense_init((d, f), **kw),
        "w_v": L.dense_init((f, d), **kw),
        "w_r": L.dense_init((d, d), **kw),
    }


def rwkv_cmix_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                      plan: ShardPlan, state: dict | None = None, *,
                      out_state: dict | None = None):
    """RWKV channel-mix FFN with token shift.  x (B, S, d) -> (out, new
    state), written into ``out_state`` when given."""
    dt = plan.compute_dtype
    xx = _shifted(x, state, dt) - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    h = xk @ p["w_k"].to(dt)
    h = torch.square(torch.relu(h.float())).to(dt)
    kv = h @ p["w_v"].to(dt)
    rgate = torch.sigmoid((xr @ p["w_r"].to(dt)).float()).to(dt)
    return rgate * kv, {"shift": _new_shift(x, dt, out_state)}


def init_rwkv_state(cfg: ArchConfig, plan: ShardPlan, batch: int,
                    dtype=torch.bfloat16, device="cuda") -> dict:
    """One layer's recurrent state: the token-shift inputs in ``dtype``
    and the WKV state in f32."""
    H, hd, d = plan.h_pad(cfg), cfg.head_dim, cfg.d_model
    return {
        "tmix": {
            "shift": torch.zeros(batch, 1, d, dtype=dtype, device=device),
            "wkv": torch.zeros(batch, H, hd, hd, dtype=torch.float32,
                               device=device),
        },
        "cmix": {"shift": torch.zeros(batch, 1, d, dtype=dtype,
                                      device=device)},
    }
