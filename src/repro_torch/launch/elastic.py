"""Elastic runtime: survive node loss by re-meshing + checkpoint restore
(port of ``repro.launch.elastic``).

Policy, the reference's: never break a TP group — shrink the data axis to
the largest value that fits the surviving device count, rebuild the plan
for the new mesh, and restore the latest committed checkpoint onto it.
On one card every rank lives on that card, so ``recover`` rebuilds the
model with the decision's model degree and restores parameters and
AdamW's state through ``training/checkpoint.py`` onto ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.launch.mesh import make_mesh_for, plan_for, visible_devices
from repro_torch.models import build_model
from repro_torch.training.checkpoint import restore_checkpoint
from repro_torch.training.optimizer import init_opt_state


@dataclass
class ElasticDecision:
    survivors: int
    data: int
    model: int
    dropped: int

    @property
    def usable(self) -> int:
        return self.data * self.model


def plan_remesh(n_surviving: int, *, tp: int = 16) -> ElasticDecision:
    """Largest (data x tp) grid fitting the survivors; TP stays whole."""
    while tp > 1 and n_surviving < tp:
        tp //= 2
    data = max(n_surviving // tp, 1)
    used = data * tp
    return ElasticDecision(survivors=n_surviving, data=data, model=tp,
                           dropped=n_surviving - used)


def recover(arch, ckpt_dir, n_surviving: int, *, device="cuda"):
    """Rebuild the model (``arch``: a name or an ``ArchConfig``) on a mesh
    of the surviving devices and restore the latest checkpoint of
    ``(params, opt_state)`` onto ``device``.  The templates are built on
    the meta device, so nothing is allocated twice.  Returns ``(model,
    params, opt_state, manifest, decision)``, as the reference's."""
    decision = plan_remesh(min(n_surviving, visible_devices(device)))
    mesh = make_mesh_for(decision.usable, want_model=decision.model,
                         device=device)
    plan = plan_for(mesh, param_dtype=torch.float32)   # the training plan
    template = build_model(arch, plan, device="meta")
    params_t = template.init(torch.Generator().manual_seed(0))
    opt_t = init_opt_state(params_t)
    (params, opt_state), manifest = restore_checkpoint(
        ckpt_dir, (params_t, opt_t), device=device)
    model = build_model(arch, plan, device=device)
    return model, params, opt_state, manifest, decision


__all__ = ["ElasticDecision", "plan_remesh", "recover"]
