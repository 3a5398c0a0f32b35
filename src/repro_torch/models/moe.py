"""Mixture-of-Experts feed-forward (port of ``repro.models.moe``).

Dispatch is sort-based with a fixed per-expert capacity: the router picks
``top_k`` experts per token, the token's assignments are sorted by expert
into per-expert buffers of ``capacity`` rows, every expert runs its gated
MLP over its whole buffer, and each token sums its experts' outputs
weighted by the router gates.  The reference runs the block inside
``shard_map`` with the experts sharded over the ``model`` axis: rank r
holds experts ``[r * e_loc, (r + 1) * e_loc)`` (``e_loc = e_pad / tp``),
scatter-adds its experts' outputs into its own partial y, and one psum
adds the partials.  The port's plan has no mesh: every expert stays on the
model's one device and the expert GEMMs run as one batched product over
all ``e_pad`` experts, but at ``tp > 1`` the combine is the reference's
``axis`` branch, each rank's partial y summed in its slot order and the
partials added in rank order where the reference takes its psum.  Pad
experts (``e_pad > n_experts``) are zero and never routed: the router
covers the real experts only.

TAPAS's quantization knob (``ShardPlan.quantize_serve``) stores the
experts as int8 with one f32 scale per (expert, output channel) and
dequantizes them to the compute dtype at every call, as the reference does
(``moe.py:164-170``): the expert products stay compute-dtype GEMMs (w8a16).
The w8a8 GEMM of kernel 6 is not on this path; it is reached through
``kernels.ops.int8_matmul``, as in the reference.

Where the order of operations decides the numbers, the port keeps the
reference's: a stable argsort (``jnp.argsort``), a stable descending sort
for top-k (``lax.top_k`` breaks ties toward the lower expert), the router
in f32, the gates rounded to the compute dtype before the multiply.  The
reference's combine adds the expert outputs into ``y`` in buffer (slot)
order, expert-ascending per token, in the compute dtype; the port sums
each token's ``top_k`` contributions in that same order, one add at a
time, which on CUDA is also deterministic (an ``index_add_`` there would
add in whatever order its atomics land).

The reference's Switch-style load-balancing loss (``moe.py:100-103``),
E * sum_e mean(probs)_e * stop_grad(count_e / (T k)), feeds training
(``Model.loss``): ``_moe_core`` and ``moe_ffn`` return ``(y, aux)`` as the
reference does, and compute aux when ``want_aux`` (the loss asks for it);
the serve paths pass nothing, get ``aux=None`` and launch nothing for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import ShardPlan

EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def _quantize_experts(w: torch.Tensor):
    """Symmetric per-(expert, out-channel) int8 quantization of (E, d_in,
    d_out) weights: (w_q int8, scale (E, 1, d_out) f32)."""
    wf = w.float()
    amax = wf.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scale), -127, 127)
    return w_q.to(torch.int8), scale


def dequantize(w_q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 experts back to ``dtype``: the product in f32, rounded once."""
    return (w_q.float() * scale).to(dtype)


def init_moe(cfg: ArchConfig, plan: ShardPlan, *,
             generator: torch.Generator, device="cuda") -> dict:
    """Router (f32 in every plan) and the experts in ``param_dtype``,
    padded to ``plan.e_pad(cfg)`` with zero experts; under
    ``quantize_serve`` the experts drawn in ``param_dtype`` are then
    quantized, so the int8 tree is the quantized tree of the same draws."""
    d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    e_pad = plan.e_pad(cfg)
    dt = plan.param_dtype
    kw = dict(generator=generator, device=device)

    def pad_e(w):
        if e_pad == E:
            return w
        return torch.cat([w, w.new_zeros((e_pad - E,) + tuple(w.shape[1:]))])

    p = {
        "router": L.dense_init((d, E), dtype=torch.float32, **kw),
        "w_gate": pad_e(L.dense_init((E, d, f), in_axis=1, dtype=dt, **kw)),
        "w_up": pad_e(L.dense_init((E, d, f), in_axis=1, dtype=dt, **kw)),
        "w_down": pad_e(L.dense_init((E, f, d), in_axis=1, dtype=dt, **kw)),
    }
    if plan.quantize_serve:
        for name in EXPERT_WEIGHTS:
            w_q, s = _quantize_experts(p.pop(name))
            p[name + "_q"] = w_q
            p[name + "_s"] = s
    return p


def _capacity(t_loc: int, cfg: ArchConfig) -> int:
    """Rows per expert buffer: every assignment up to 4096 (decode, small
    batches: no drops), else ``capacity_factor`` of an even share."""
    full = t_loc * cfg.top_k
    if full <= 4096:
        return full
    return -(-int(full * cfg.capacity_factor) // cfg.n_experts)


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig):
    """Router over x (T, d): (top-k gates (T, k) f32, top-k experts
    (T, k), the router's probabilities (T, E)), the gates renormalised
    under ``router_renorm``."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    if cfg.router_renorm:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    return topv, topi, probs


def load_balance_loss(probs: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss (``moe.py:100-103``): E * sum_e f_e * p_e with
    p_e the mean router probability of expert e and f_e, taken out of the
    gradient, its share of the T k assignments.  The counts are integers,
    so adding them by ``scatter_add_`` is exact in any order."""
    T, k = topi.shape
    E = probs.shape[1]
    me = probs.mean(dim=0)
    flat = topi.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=probs.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=probs.device)) / (T * k)
    return E * torch.sum(me * ce.detach())


def dispatch(topv: torch.Tensor, topi: torch.Tensor, *, e_pad: int,
             capacity: int):
    """Sort-based dispatch of T tokens' top-k assignments into ``e_pad``
    buffers of ``capacity`` slots (slot ``e * capacity + i``).

    Returns ``buf_src (e_pad * capacity,)``, the token in each slot (T for
    an empty slot, which reads the zero row), ``buf_gate`` (its f32 gate,
    0 when empty) and ``slots (T, k)``, each token's slots in ascending
    order, ``e_pad * capacity`` for an assignment past its expert's
    capacity (dropped)."""
    T, k = topi.shape
    dev = topi.device
    flat_e = topi.reshape(-1)
    ar = torch.arange(T * k, device=dev)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e_pad, device=dev))
    pos_in_e = ar - starts[sorted_e]
    keep = pos_in_e < capacity
    over = e_pad * capacity                      # the overflow slot
    slot = torch.where(keep, sorted_e * capacity + pos_in_e, over)
    buf_src = torch.full((over + 1,), T, dtype=torch.long, device=dev)
    buf_src.scatter_(0, slot, torch.where(keep, (ar // k)[order], T))
    buf_gate = torch.zeros(over + 1, dtype=torch.float32, device=dev)
    buf_gate.scatter_(0, slot, torch.where(keep, topv.reshape(-1)[order],
                                           0.0))
    slots = torch.empty_like(slot).scatter_(0, order, slot)
    return buf_src[:-1], buf_gate[:-1], slots.reshape(T, k).sort(dim=1)[0]


def _moe_core(x, router_w, w_gate, w_up, w_down, *, cfg: ArchConfig,
              e_pad: int, capacity: int, activation: str, tp: int = 1,
              want_aux: bool = False):
    """MoE over x (T, d): ``(y (T, d), aux)``, aux the load-balancing loss
    when ``want_aux`` and None otherwise.  At ``tp`` 1 every expert is
    local (the reference's ``axis=None``); at ``tp`` > 1 the combine is its
    ``axis`` branch over ``tp`` ranks of ``e_pad // tp`` experts (the
    experts see every token, so the reference's pmean of aux over ranks is
    the identity)."""
    T, d = x.shape
    topv, topi, probs = route(x, router_w, cfg)
    aux = load_balance_loss(probs, topi) if want_aux else None
    buf_src, buf_gate, slots = dispatch(topv, topi, e_pad=e_pad,
                                        capacity=capacity)
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    xg = x_pad[buf_src].reshape(e_pad, capacity, d)
    gate = torch.bmm(xg, w_gate)
    up = torch.bmm(xg, w_up)
    if activation == "gelu":
        act = F.gelu(gate.float(), approximate="tanh").to(xg.dtype)
    else:
        act = F.silu(gate.float()).to(xg.dtype)
    out = torch.bmm(act * up, w_down)
    out = out * buf_gate.reshape(e_pad, capacity, 1).to(out.dtype)
    # combine: each token's contributions in slot order, one add at a time
    # in the compute dtype; dropped assignments read the zero row
    rows = torch.cat([out.reshape(e_pad * capacity, d), out.new_zeros(1, d)])
    parts = rows[slots]                                  # (T, k, d)
    if tp == 1:
        y = parts[:, 0]
        for j in range(1, parts.shape[1]):
            y = y + parts[:, j]
        return y, aux
    # rank r's partial y holds the contributions of its slots [r * e_loc *
    # capacity, (r + 1) * e_loc * capacity) in slot order (a masked-out
    # contribution adds an exact 0); the partials are then added in rank
    # order (the reference's psum); a dropped slot belongs to no rank
    rank = slots // (e_pad // tp * capacity)             # (T, k)
    y = None
    for r in range(tp):
        mine = (rank == r)[..., None]
        y_r = torch.where(mine[:, 0], parts[:, 0], 0)
        for j in range(1, parts.shape[1]):
            y_r = y_r + torch.where(mine[:, j], parts[:, j], 0)
        y = y_r if y is None else y + y_r
    return y, aux


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, plan: ShardPlan, *,
            want_aux: bool = False):
    """x (B, S, d) -> (y (B, S, d), aux), aux as ``_moe_core`` gives it.
    The capacity counts every row of x, padded rows of a ragged prefill
    included, as in the reference."""
    dt = plan.compute_dtype
    B, S, d = x.shape
    if plan.quantize_serve and "w_gate_q" in p:
        weights = [dequantize(p[n + "_q"], p[n + "_s"], dt)
                   for n in EXPERT_WEIGHTS]
    else:
        weights = [p[n].to(dt) for n in EXPERT_WEIGHTS]
    y, aux = _moe_core(x.reshape(B * S, d).to(dt), p["router"], *weights,
                       cfg=cfg, e_pad=plan.e_pad(cfg),
                       capacity=_capacity(B * S, cfg),
                       activation=cfg.activation, tp=plan.tp,
                       want_aux=want_aux)
    return y.reshape(B, S, d), aux
