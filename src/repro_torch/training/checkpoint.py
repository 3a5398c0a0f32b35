"""Checkpoints with atomic commits (port of ``repro.training.checkpoint``).

Layout, the reference's:  <dir>/step_<N>/
                             manifest.json   step, leaf count, structure, meta
                             shard_0.npz     leaf_<i>, one array per leaf
                          <dir>/LATEST       committed step (atomic rename)

Leaves are numbered in ``jax.tree.flatten``'s order (a dict's keys
sorted, tuples in order, recursively), so a checkpoint written by either
package restores into the other.  bf16 leaves are stored as the
reference's numpy stores them, their 2-byte patterns as ``V2`` records,
and read back from those bits.  On restore each leaf takes its template
leaf's dtype and device (or ``device`` when given).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_unflatten


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # the reference's bf16 records: V2
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:    # bf16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _structure(tree) -> str:
    """A description of the tree's structure for the manifest (the
    reference writes its treedef's ``str``; neither reads it back)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(v) for v in tree) + ")"
    return "*"


def save_checkpoint(ckpt_dir, step: int, tree, *,
                    meta: dict | None = None) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(tree)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
        np.savez(tmp / "shard_0.npz", **arrays)
        manifest = {"step": step, "n_leaves": len(leaves),
                    "treedef": _structure(tree), "meta": meta or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # LATEST pointer via atomic replace
    ptr = ckpt_dir / "LATEST"
    tmp_ptr = ckpt_dir / ".LATEST.tmp"
    tmp_ptr.write_text(str(step))
    os.replace(tmp_ptr, ptr)
    return final


def latest_step(ckpt_dir) -> int | None:
    ptr = pathlib.Path(ckpt_dir) / "LATEST"
    if not ptr.exists():
        return None
    return int(ptr.read_text().strip())


def restore_checkpoint(ckpt_dir, template, *, step: int | None = None,
                       device=None) -> tuple:
    """Restore into the structure of ``template``: ``(tree, manifest)``.
    Each leaf takes its template leaf's dtype, and its device unless
    ``device`` is given."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = tree_leaves(template)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint/model mismatch: {manifest['n_leaves']}"
                         f" leaves saved, {len(leaves)} in the template")
    out = []
    with np.load(d / "shard_0.npz") as data:
        for i, tmpl in enumerate(leaves):
            x = _from_numpy(data[f"leaf_{i}"])
            out.append(x.to(device=device if device is not None
                            else tmpl.device, dtype=tmpl.dtype))
    return tree_unflatten(template, out), manifest
