"""Training step factory (port of ``repro.training.train_step``): loss ->
grads -> AdamW.

The loss's gradient is taken by autograd with respect to detached
aliases of the parameters (``requires_grad`` on the aliases only), so the
caller's tensors never require grad and can be served as they are; the
update then writes the parameters in place.  The metrics stay on the
device.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)


def _value_and_grad(model: Model, params: dict, inputs, labels):
    """(loss, grads tree) of ``model.loss`` at ``params``.

    Each layer of a layer-stacked leaf is a leaf of its own (a list of
    views, which ``Model._trunk`` indexes as it indexes the stack): the
    gradient of a view of the stack would be a stack-sized tensor per
    layer, summed over the layers, where this way each layer's gradient
    is its own size and the stack is assembled once."""
    grad = lambda a: a.detach().requires_grad_(True)  # noqa: E731
    tree = {k: (L.tree_map(lambda a: [grad(t) for t in a.unbind(0)], v)
                if k == "layers" else L.tree_map(grad, v))
            for k, v in params.items()}
    leaves = tree_leaves(tree)
    loss = model.loss(tree, inputs, labels)
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    for i, (p, g) in enumerate(zip(leaves, grads)):
        if g is None:
            grads[i] = torch.zeros_like(p)
    grads = tree_unflatten(tree, grads)

    def stack(layers: list) -> torch.Tensor:
        # each layer's grads go as soon as they are stacked, so the layers'
        # grads are held twice over one leaf at most (at rwkv6-3b's full
        # width that is 2.7 GiB where the whole stack is 11 GiB)
        out = torch.stack(layers)
        layers.clear()
        return out

    grads["layers"] = L.tree_map(stack, grads["layers"])
    return loss.detach(), grads


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    grad_accum: int = 1) -> Callable:
    """``grad_accum`` > 1 splits the global batch into microbatches run in
    order, each one's grads added as g / a: activation memory scales down
    by the accumulation factor at identical FLOPs."""

    def train_step(params, opt_state, inputs, labels):
        if grad_accum == 1:
            loss, grads = _value_and_grad(model, params, inputs, labels)
        else:
            a = grad_accum
            b = inputs.shape[0]
            assert b % a == 0, (b, a)
            acc, losses = None, []
            for i in range(a):
                sl = slice(i * (b // a), (i + 1) * (b // a))
                li, gi = _value_and_grad(model, params, inputs[sl],
                                         labels[sl])
                gl = tree_leaves(gi)
                if acc is None:
                    acc = [torch.zeros_like(g) for g in gl]
                acc = [s + g / a for s, g in zip(acc, gl)]
                losses.append(li)
            grads = tree_unflatten(params, acc)
            loss = torch.stack(losses).mean()
        grads = model.canonicalize_grads(grads)
        params, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state,
                                                params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_eval_step(model: Model) -> Callable:
    def eval_step(params, inputs, labels):
        with torch.no_grad():
            return model.loss(params, inputs, labels)

    return eval_step


__all__ = ["make_train_step", "make_eval_step", "init_opt_state",
           "AdamWConfig"]
