"""Dry run of every (arch x shape) cell on one H100, on the meta device
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on a 256- or 512-chip mesh and
reads XLA's memory and cost analyses.  The port builds each cell for one
card on the ``meta`` device, where tensors have shapes and dtypes and no
storage, so nothing is allocated and no numerics run: the model, AdamW's
state for ``train_*``, the slot cache for ``decode_*`` / ``long_*``, and
the inputs of ``configs.shapes.input_specs``.  Then it runs the cell's
step once under ``analysis.op_cost``'s count and reports:

* bytes, exact because they are the meta tensors' own: ``param_bytes``,
  ``opt_bytes`` (AdamW's moments and step) and ``kv_bytes`` (the slot
  cache, or the recurrent state);
* ``peak_live_bytes``, the count's estimate of the peak of live tensors
  (the state above, the inputs and every storage the step allocates
  while it lives), and ``fits`` (that estimate within the card's 80 GB);
* ``grad_accum`` (``choose_grad_accum``, the reference's rule at a data
  degree of 1) and the roofline row of ``analysis.roofline``.

A train cell runs one microbatch (``global_batch / grad_accum`` rows)
through the loss and its gradient and multiplies its flops and bytes by
``grad_accum``, then adds one AdamW update; its peak is the larger of the
microbatch's (plus the accumulated gradient when ``grad_accum > 1``) and
the update's.  Train cells take the reference's training plan: f32
parameters, bf16 compute, ``remat="full"``; the others bf16 parameters.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Prints one JSON row per cell and writes no file.  ``sweep`` yields the
same rows to a caller (``chip_smoke.py`` phase 16 (a)).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch.analysis import op_cost
from repro_torch.analysis.roofline import HW, model_flops, roofline_terms
from repro_torch.configs import ASSIGNED, SHAPES, get_config, input_specs
from repro_torch.models import build_model, local_plan
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.train_step import _value_and_grad


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def choose_grad_accum(cfg, shape, dp: int) -> int:
    """Microbatch count so the rematted residual stack stays ~<= 4 GB/dev."""
    b_loc = max(shape.global_batch // dp, 1)
    stack = b_loc * shape.seq_len * cfg.d_model * 2 * cfg.num_layers  # bf16
    accum = 1
    while stack / accum > 4e9 and accum < b_loc:
        accum *= 2
    return accum


def cell_state(cfg, shape, *, device="meta", plan_overrides: dict | None = None):
    """A cell's model and state on ``device``: ``(model, params, opt,
    cache)``, ``opt`` AdamW's state for a train cell and ``cache`` the
    slot cache for a decode cell (None otherwise).  On the meta device
    nothing is allocated; on another it is the real build, whose bytes the
    meta build's must equal."""
    is_train = shape.kind == "train"
    kw = dict(remat="full" if is_train else "none",
              param_dtype=torch.float32 if is_train else torch.bfloat16)
    kw.update(plan_overrides or {})
    model = build_model(cfg, local_plan(**kw), device=device)
    gen = torch.Generator(device=torch.device(device).type
                          if torch.device(device).type == "cuda" else "cpu")
    params = model.init(gen.manual_seed(0))
    opt = init_opt_state(params) if is_train else None
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device=device) if shape.kind == "decode" else None
    return model, params, opt, cache


def lower_cell(arch, shape_name, *, plan_overrides: dict | None = None):
    """Build one cell on the meta device (``arch`` a name or an
    ``ArchConfig``, ``shape_name`` a name or a ``Shape``): returns
    ``(step, live, meta,
    train)``: ``step()`` runs the cell's step (a train cell: one
    microbatch's loss and gradient), ``live`` the tensors alive across it,
    ``meta`` the cell's description and exact state bytes, ``train`` a
    train cell's ``(params, opt)`` (None otherwise)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if shape.name in cfg.skip_shapes:
        raise ValueError(f"{cfg.name} skips {shape.name}: {cfg.notes}")
    overrides = dict(plan_overrides or {})
    accum_override = overrides.pop("grad_accum", None)
    model, params, opt, cache = cell_state(cfg, shape,
                                           plan_overrides=overrides)
    specs = input_specs(cfg, shape)
    meta = {"arch": cfg.name, "shape": shape.name, "mesh": "1x1", "chips": 1,
            "kind": shape.kind, "n_params": cfg.param_count(),
            "n_params_active": cfg.param_count(active=True),
            "param_bytes": tree_bytes(params), "opt_bytes": 0,
            "kv_bytes": 0}
    if shape.kind == "train":
        accum = accum_override or choose_grad_accum(cfg, shape, 1)
        rows = shape.global_batch // accum
        inputs, labels = specs["inputs"][:rows], specs["labels"][:rows]

        def step():
            return _value_and_grad(model, params, inputs, labels)

        meta.update(opt_bytes=tree_bytes(opt), grad_accum=accum,
                    tokens=shape.global_batch * shape.seq_len)
        return step, (params, opt, inputs, labels), meta, (params, opt)
    if shape.kind == "prefill":
        def step():
            with torch.no_grad():
                return model.prefill(params, specs["inputs"])

        meta["tokens"] = shape.global_batch * shape.seq_len
        return step, (params, specs["inputs"]), meta, None

    def step():
        with torch.no_grad():
            return model.decode_step(params, cache, specs["tokens"],
                                     specs["positions"])

    meta.update(kv_bytes=tree_bytes(cache), tokens=shape.global_batch)
    return step, (params, cache, specs["tokens"], specs["positions"]), meta, \
        None


def run_cell(arch, shape_name, *, plan_overrides: dict | None = None) -> dict:
    """One cell's row (``arch`` and ``shape_name`` as ``lower_cell``'s):
    the roofline row, the cell's description, its state bytes, the peak
    estimate, ``fits`` and the seconds it took."""
    t0 = time.perf_counter()
    step, live, meta, train = lower_cell(arch, shape_name,
                                         plan_overrides=plan_overrides)
    _, cost = op_cost.count(step, live=live)
    flops, n_bytes, peak = cost["flops"], cost["bytes"], \
        cost["peak_live_bytes"]
    if train is not None:
        params, opt = train
        accum = meta["grad_accum"]
        grads = _grad_stand_ins(params)
        _, opt_cost = op_cost.count(adamw_update, AdamWConfig(), grads, opt,
                                    params, live=(params, opt, grads))
        flops = flops * accum + opt_cost["flops"]
        n_bytes = n_bytes * accum + opt_cost["bytes"]
        peak = max(peak + (accum > 1) * tree_bytes(grads),
                   opt_cost["peak_live_bytes"])
        for key in ("kernels", "census"):
            cost[key] = {k: _scaled(v, accum) for k, v in cost[key].items()}
    mflops = model_flops(meta["n_params_active"], meta["kind"], meta["tokens"])
    rep = roofline_terms(arch=meta["arch"], shape=meta["shape"],
                         mesh=meta["mesh"],
                         chips=1, cost={"flops": flops, "bytes": n_bytes},
                         model_flops_total=mflops, peak_mem=peak)
    row = rep.row()
    row.update(meta)
    row.update(flops=flops, bytes=n_bytes, gemm_flops=cost["gemm_flops"]
               * meta.get("grad_accum", 1), peak_live_bytes=peak,
               fits=bool(peak <= HW.hbm_bytes), kernels=cost["kernels"],
               t_s=round(time.perf_counter() - t0, 2))
    return row


def _grad_stand_ins(params):
    """Gradient stand-ins: one meta tensor per parameter, in its dtype."""
    return tree_map(torch.empty_like, params)


def _scaled(v, n: int):
    if isinstance(v, dict):
        return {k: x * n for k, x in v.items()}
    return v * n


def sweep(archs=ASSIGNED, shapes=tuple(SHAPES), *,
          plan_overrides: dict | None = None):
    """Each cell of ``archs`` x ``shapes`` in turn: its ``run_cell`` row;
    ``{"arch", "shape", "skipped"}`` (the arch's notes) for a shape its
    arch skips; ``{"arch", "shape", "error"}`` for a cell that raised,
    its traceback printed to stderr."""
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            if shape in cfg.skip_shapes:
                yield {"arch": arch, "shape": shape, "skipped": cfg.notes}
                continue
            try:
                yield run_cell(arch, shape, plan_overrides=plan_overrides)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                yield {"arch": arch, "shape": shape, "error": repr(e)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every ASSIGNED arch x runnable shape")
    ap.add_argument("--plan", default="",
                    help="JSON dict of ShardPlan overrides (and grad_accum)")
    args = ap.parse_args(argv)
    overrides = json.loads(args.plan) if args.plan else None
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    failures = []
    for row in sweep(archs, shapes, plan_overrides=overrides):
        if "error" in row:
            failures.append((row["arch"], row["shape"], row["error"]))
        else:
            print(json.dumps(row), flush=True)
    if failures:
        print(f"{len(failures)} FAILURES:", file=sys.stderr)
        for f in failures:
            print(" ", f, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
