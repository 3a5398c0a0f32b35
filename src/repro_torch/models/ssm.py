"""State-space and linear-recurrence layers (port of ``repro.models.ssm``):
Mamba, the selective SSM of hymba's parallel branch, and RWKV6 (Finch)
time-mix and channel-mix.

Mamba runs in plain torch, as the reference leaves it to XLA.  Where the
reference scans chunks of the sequence (a chunk of 256 halved until it
divides S, so a prime S runs S chunks of one step) with an associative
scan inside each, the port runs one log-depth doubling scan over the whole
sequence, ~4 device ops per level: the same recurrence h_t = a_t h_{t-1} +
b_t, summed in another order.  Its (B, S, d_inner, state) f32 operands
live one layer at a time.  Under autograd the scan is ``SelectiveScanFn``:
the same forward (the same bits), a and h saved, and a backward that is
the same scan run backwards in time.

RWKV6's WKV recurrence under autograd goes through ``ops.WkvFn`` (kernel
7's training form and its backward kernel on CUDA, their plain versions
on the CPU); serving calls the kernel's serve form as before.

RWKV6:

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


# ===========================================================================
# Mamba (selective SSM) — the parallel branch of hymba
# ===========================================================================

def _dt_rank(cfg: ArchConfig) -> int:
    return max(16, cfg.d_model // 16)


def init_mamba(cfg: ArchConfig, plan: ShardPlan, *,
               generator: torch.Generator, device="cuda") -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, dt = _dt_rank(cfg), plan.param_dtype
    kw = dict(generator=generator, dtype=dt, device=device)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "w_in": L.dense_init((d, 2, di), **kw),     # x branch + gate z
        "conv_w": _normal((cfg.conv_width, di), 0.1, **kw),
        "w_bcdt": L.dense_init((di, dtr + 2 * n), **kw),
        "w_dt": L.dense_init((dtr, di), **kw),
        "dt_bias": torch.full((di,), -4.6, dtype=dt, device=device),
        "a_log": torch.log(a).repeat(di, 1).to(dt),
        "d_skip": torch.ones(di, dtype=dt, device=device),
        "w_out": L.dense_init((di, d), **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 x_prev: torch.Tensor | None = None):
    """Depthwise causal conv over time.  x (B, S, di); w (cw, di);
    ``x_prev`` (B, cw - 1, di) the left context (zeros if None).  Returns
    (y (B, S, di), new left context (B, cw - 1, di)); dtypes promote as in
    JAX."""
    cw, S = w.shape[0], x.shape[1]
    if x_prev is None:
        x_prev = torch.zeros(x.shape[0], cw - 1, x.shape[2], dtype=x.dtype,
                             device=x.device)
    dt = torch.promote_types(x_prev.dtype, x.dtype)
    xp = torch.cat([x_prev.to(dt), x.to(dt)], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(cw))
    return y, xp[:, -(cw - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + e^x) at every x (torch's
    ``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _selective_scan(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor | None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 of a, b (B, S, di, n) f32, from
    h0 (B, di, n) (zeros if None): a doubling scan, log2(S) levels, each
    combining every element with the one k before it, (a1, b1) then (a2,
    b2) -> (a1 a2, a2 b1 + b2).  Overwrites a and b; returns h (B, S, di,
    n), which is b."""
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0
    S, k = a.shape[1], 1
    while k < S:
        b[:, k:] += a[:, k:] * b[:, :-k]
        if 2 * k < S:
            a[:, k:] = a[:, k:] * a[:, :-k]
        k *= 2
    return b


class SelectiveScanFn(torch.autograd.Function):
    """The doubling scan under autograd.  Forward: ``_selective_scan`` on
    copies of a and b (the serve path's bits), saving a and h, not the
    scan's log2(S) levels.  Backward, with g_t = dL/dh_t in total:
    g_t = dh_t + a_{t+1} g_{t+1} (the same doubling scan over the time-
    reversed sequence, a shifted by one), db_t = g_t, da_t = g_t h_{t-1}
    (h_{-1} = h0, or 0), dh0 = a_0 g_0."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _selective_scan(a.clone(), b.clone(), h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        # reversed in time: g^r_s = dh^r_s + a_{S-s} g^r_{s-1}, g^r_0 = dh_{S-1}
        a_rev = torch.cat([torch.zeros_like(a[:, :1]),
                           a.flip(1)[:, :-1]], dim=1)
        g = _selective_scan(a_rev, dh.flip(1).contiguous(), None).flip(1)
        prev = torch.cat([torch.zeros_like(h[:, :1]) if h0 is None
                          else h0[:, None], h[:, :-1]], dim=1)
        da = g * prev
        dh0 = a[:, 0] * g[:, 0] if h0 is not None else None
        return da, g, dh0


def _scan(a: torch.Tensor, b: torch.Tensor,
          h0: torch.Tensor | None) -> torch.Tensor:
    """``_selective_scan`` (a and b overwritten) where no gradient is
    taken, ``SelectiveScanFn`` where one is."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return SelectiveScanFn.apply(a, b, h0)
    return _selective_scan(a, b, h0)


def mamba_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                  plan: ShardPlan, state: dict | None = None, *,
                  out_state: dict | None = None):
    """x (B, S, d) -> (y (B, S, d), new state {"conv" (B, cw - 1, di) in
    the promoted dtype of the old one and the compute dtype, "ssm" (B, di,
    n) f32}).  With ``out_state`` (which may be ``state``) the new state
    is written there, in place."""
    dt = plan.compute_dtype
    B, S, d = x.shape
    di, n, dtr = cfg.d_inner, cfg.ssm_state, _dt_rank(cfg)
    xz = (x @ p["w_in"].to(dt).reshape(d, 2 * di)).view(B, S, 2, di)
    xin, z = xz[:, :, 0], xz[:, :, 1]
    conv_prev = state["conv"] if state is not None else None
    xc, conv_new = _causal_conv(xin, p["conv_w"].to(dt), conv_prev)
    xc = F.silu(xc.float()).to(dt)
    dt_lo, Bs, Cs = (xc @ p["w_bcdt"].to(dt)).split([dtr, n, n], dim=-1)
    delta = _softplus((dt_lo @ p["w_dt"].to(dt)).float()
                      + p["dt_bias"].float())              # (B, S, di)
    A = -torch.exp(p["a_log"].float())                    # (di, n)
    h0 = state["ssm"].float() if state is not None else None
    a = torch.exp(delta[..., None] * A)                   # (B, S, di, n)
    b = delta[..., None] * Bs[:, :, None, :].float() * xc[..., None].float()
    del delta
    h = _scan(a, b, h0)
    del a
    y = torch.einsum("bsin,bsn->bsi", h, Cs.float())
    y = (y + xc.float() * p["d_skip"].float()).to(dt)
    y = y * F.silu(z.float()).to(dt)
    out = y @ p["w_out"].to(dt)
    new_state = {"conv": conv_new, "ssm": h[:, -1]}
    if out_state is not None:
        for name, t in new_state.items():
            new_state[name] = out_state[name].copy_(t)
    return out, new_state


def mamba_decode(p: dict, x: torch.Tensor, state: dict, cfg: ArchConfig,
                 plan: ShardPlan, *, out_state: dict | None = None):
    """x (B, d), one token per row; state {"conv" (B, cw - 1, di), "ssm"
    (B, di, n)} -> (y (B, d), new state, written into ``out_state`` when
    given)."""
    y, new_state = mamba_forward(p, x[:, None], cfg, plan, state,
                                 out_state=out_state)
    return y[:, 0], new_state


def init_mamba_state(cfg: ArchConfig, plan: ShardPlan, batch: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    """One layer's Mamba state: the conv's left context in ``dtype`` and
    the SSM state in f32."""
    di = cfg.d_inner
    return {"conv": torch.zeros(batch, cfg.conv_width - 1, di, dtype=dtype,
                                device=device),
            "ssm": torch.zeros(batch, di, cfg.ssm_state, dtype=torch.float32,
                               device=device)}


# ===========================================================================
# RWKV6 (Finch): data-dependent decay, token-shift, wkv recurrence
# ===========================================================================


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
