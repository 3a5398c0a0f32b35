"""Carry weights across from the JAX package.

``from_jax_params`` takes a ``repro`` ``Model.init`` tree whose leaves are
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameter tree.  The port keeps the reference layouts — layers stacked on a
leading L axis, ``w_q (d, H, hd)``, ``w_k``/``w_v (d, K, hd)``, ``w_o (H,
hd, d)``, ``embed (V_pad, d)``, ``unembed (d, V_pad)`` — so the bridge is a
copy, not a re-layout, and the port never sees JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_params(tree: dict, *, device="cuda") -> dict:
    """Copy a reference parameter tree (numpy leaves) onto ``device``."""
    return tree_map(lambda a: _to_tensor(a, device), tree)
