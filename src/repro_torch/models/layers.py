"""Core layer primitives (port of ``repro.models.layers``).

Plain tensor functions over dict parameter trees; shapes, dtypes and the
order of casts follow the reference so f32 results agree to rounding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(shape, *, generator: torch.Generator, in_axis: int = 0,
               scale: float = 1.0, dtype=torch.float32, device="cuda"):
    """Truncated-normal fan-in init: N(0, std) cut at +-2 std,
    std = scale / sqrt(fan_in).  Drawn in f32, stored in ``dtype``."""
    std = scale / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    return w.to(dtype)


def embed_init(shape, *, generator: torch.Generator, dtype=torch.float32,
               device="cuda"):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=generator)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32; ``plus_one`` uses the Gemma convention w <- (1 + w)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (x * w).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32: the mean, then the variance of ``x - mu``."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def glu_mlp(x: torch.Tensor, p: dict, *, activation: str = "silu") -> torch.Tensor:
    """Gated MLP: act(x Wg) * (x Wu) Wd."""
    dtype = x.dtype
    gate = x @ p["w_gate"].to(dtype)
    up = x @ p["w_up"].to(dtype)
    if activation == "silu":
        act = F.silu(gate.float()).to(dtype)
    elif activation == "gelu":
        act = F.gelu(gate.float(), approximate="tanh").to(dtype)
    else:  # pragma: no cover - config error
        raise ValueError(activation)
    return (act * up) @ p["w_down"].to(dtype)


def mlp_init(d_model: int, d_ff: int, *, generator: torch.Generator,
             dtype=torch.float32, device="cuda") -> dict:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "w_gate": dense_init((d_model, d_ff), **kw),
        "w_up": dense_init((d_model, d_ff), **kw),
        "w_down": dense_init((d_ff, d_model), **kw),
    }


def gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Plain 2-layer GELU MLP (HuBERT / classic transformer encoders):
    tanh-approximate GELU in f32, biases added in the compute dtype."""
    dtype = x.dtype
    h = x @ p["w_in"].to(dtype) + p["b_in"].to(dtype)
    h = F.gelu(h.float(), approximate="tanh").to(dtype)
    return h @ p["w_out"].to(dtype) + p["b_out"].to(dtype)


def gelu_mlp_init(d_model: int, d_ff: int, *, generator: torch.Generator,
                  dtype=torch.float32, device="cuda") -> dict:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "w_in": dense_init((d_model, d_ff), **kw),
        "b_in": torch.zeros(d_ff, dtype=dtype, device=device),
        "w_out": dense_init((d_ff, d_model), **kw),
        "b_out": torch.zeros(d_model, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def take_embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup (rows of ``table`` at ``ids``)."""
    return F.embedding(ids, table)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves``' order: a dict's values by sorted key,
    a tuple's or list's in order, recursively."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves) -> object:
    """The inverse of ``tree_leaves``: ``template``'s structure holding
    ``leaves`` (an iterable, consumed in order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}        # the template's key order
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)
