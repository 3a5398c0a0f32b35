"""AdamW with linear-warmup cosine decay (port of
``repro.training.optimizer``).

The reference's arithmetic in f32 on tensors: the step count, the learning
rate, the global norm and the clip factor stay on the device, so a step
reads nothing back to the host.  Where the reference returns new trees,
``adamw_update`` updates the parameters and the moments in place under
``torch.no_grad()``: at full width the f32 params, grads and two moments
are most of the card's memory, and a second copy would not fit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def init_opt_state(params: dict) -> dict:
    """Zero moments in f32 (what the update keeps them in) beside each
    parameter, and the step, an int32 scalar on the parameters' device."""
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,   # noqa: E731
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an f32 tensor): linear warmup to ``lr``,
    then a cosine to a tenth of it at ``total_steps``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves summed in
    the reference's order."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, opt_state: dict,
                 params: dict):
    """One AdamW step: returns ``(params, opt_state, grad_norm)``, params
    and the moments updated in place, the step a new tensor."""
    step = opt_state["step"] + 1
    stepf = step.float()
    lr = _schedule(cfg, stepf)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - torch.full_like(stepf, cfg.b1).pow(stepf)
    bc2 = 1 - torch.full_like(stepf, cfg.b2).pow(stepf)
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(opt_state["m"]),
                    tree_leaves(opt_state["v"])):
        for p, g, m, v in _slices(*leaf):
            g = g.float() * clip
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            pf = p.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
                + cfg.weight_decay * pf
            p.copy_((pf - lr * delta).to(p.dtype))
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, gnorm


# elements of a leaf updated at once: the update's f32 temporaries stay
# near 64 MiB each (a full-width rwkv6-3b's stacked 2560 x 8960 leaf would
# take 2.7 GiB per temporary)
SLICE = 1 << 24


def _slices(p, g, m, v):
    """(p, g, m, v) in slices of ``SLICE`` elements or more along the first
    axis (views, updated in place).  Every op of the update is elementwise,
    so the slices give the whole leaf's bits."""
    n = p.numel()
    if n <= SLICE or p.dim() == 0:
        yield p, g, m, v
        return
    rows = max(1, SLICE // (n // p.shape[0]))
    for i in range(0, p.shape[0], rows):
        yield p[i:i + rows], g[i:i + rows], m[i:i + rows], v[i:i + rows]


__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "global_norm"]
