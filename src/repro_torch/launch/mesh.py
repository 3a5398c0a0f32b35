"""Mesh construction (port of ``repro.launch.mesh``).

The reference builds ``jax.sharding.Mesh``es: 16 x 16 = 256 chips (one
v5e pod slice), 2 x 16 x 16 = 512 across pods, and any (data, model) grid
for the elastic runtime.  The port keeps the same rules over a plain
``Mesh`` record of axis names and degrees.  It runs on one card, and
every stripe of a degree stays on that card (``models/sharding.py``):
``plan_for`` turns a mesh into the ``ShardPlan`` whose ``tp`` is the
model degree, its stripes and expert ranks all on ``mesh.device``.
Nothing here touches a device, so importing it never initialises CUDA.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.sharding import ShardPlan, local_plan


@dataclass(frozen=True)
class Mesh:
    """Axis names and their degrees; every rank lives on ``device``."""
    axis_names: tuple
    dims: tuple
    device: str = "cuda"

    @property
    def shape(self) -> dict:
        """``{axis: degree}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def visible_devices(device="cuda") -> int:
    """Cards a mesh can take ranks from: CUDA's device count, 1 for the
    CPU or meta device."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production meshes, which need 256 (or 512)
    devices: raises as the reference does when fewer are visible."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = visible_devices(device)
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, found {have}; the port runs "
            f"on one card (launch/dryrun.py sizes cells for one H100)")
    return Mesh(axes, shape, str(device))


def make_mesh_for(n_devices: int, *, want_model: int = 0,
                  device="cuda") -> Mesh:
    """Best-effort (data, model) mesh for an arbitrary device count, by the
    reference's rule: keep the model axis whole (TP groups stay intact),
    halving it until it divides ``n_devices``, and shrink the data axis."""
    model = want_model or min(16, n_devices)
    while n_devices % model:
        model //= 2
    data = n_devices // model
    return Mesh(("data", "model"), (data, model), str(device))


def plan_for(mesh: Mesh, **kw) -> ShardPlan:
    """The ``ShardPlan`` of ``mesh``: ``tp`` its model degree (1 without
    a model axis), every stripe on the one card; ``kw`` as
    ``local_plan``'s."""
    return local_plan(tp=mesh.shape.get("model", 1), **kw)


__all__ = ["Mesh", "make_mesh_for", "make_production_mesh", "plan_for",
           "visible_devices"]
