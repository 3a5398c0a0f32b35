"""TL008 — host-constant hazard: no per-call host construction or
module-level numpy/list constants inside captured functions."""
from __future__ import annotations

import ast

from repro_torch.analysis.lint.framework import Rule

EXPLAIN = """\
TL008 host-constant hazard — captured code must not manufacture host
arrays.

In the reference a ``np.asarray``/``np.arange``/list-literal constant
used inside a jitted function is captured as a closure constant and
re-uploaded at every dispatch.  In a CUDA-graph capture the same line is
worse: ``torch.tensor(...)``/``torch.as_tensor(...)``/
``torch.from_numpy(...)`` builds the value on the host and copies it to
the device — a synchronizing copy that the capture refuses, or, where it
goes through, a copy recorded once and replayed with its capture-time
value, whatever the host value is later.  A module-level numpy array or
numeric list read inside the step is the same value frozen into the
graph.  ``python -m repro_torch.analysis.iraudit``'s IR001 counts host
copies in the captured steps dynamically.

Flags, inside captured functions only:
  * ``torch.tensor``/``torch.as_tensor``/``torch.from_numpy`` calls;
  * ``np.<ctor>(...)`` calls (arange/zeros/ones/full/linspace/eye/
    concatenate/stack/...) — per-call host construction.  ``np.array``/
    ``np.asarray`` are deliberately NOT here: on a device tensor they
    read it back, which is TL002's host-sync finding;
  * reads of module-level names bound to an ``np.<ctor>(...)`` result or
    a numeric list/tuple literal — the captured-constant form.

Fix: build the value with ``torch.*`` on the device inside the step
(``torch.arange(n, device=x.device)``), or keep it in a program buffer
filled before the replay (``serving/graphs.py``'s ``bufs``).
``np.*`` and ``torch.tensor`` in host-side code (setup, the scheduler,
mirrors) are fine and unflagged.
"""

#: pure constructors: flagged per call inside captured code.
#: array/asarray belong to TL002 there (a readback), but still mark a
#: module-level binding as a captured host constant.
_NP_CTORS = {"arange", "zeros", "ones", "full",
             "linspace", "logspace", "eye", "empty", "identity",
             "zeros_like", "ones_like", "full_like", "concatenate",
             "stack", "meshgrid", "tri", "tril", "triu", "loadtxt"}
_NP_MODULE_CTORS = _NP_CTORS | {"array", "asarray"}
_TORCH_HOST_CTORS = {"tensor", "as_tensor", "from_numpy"}


def _numpy_aliases(tree: ast.AST) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    names.add(a.asname or "numpy")
    return names


def _is_numeric_literal_seq(value: ast.AST) -> bool:
    """A (possibly nested) list/tuple literal of numbers."""
    if isinstance(value, (ast.List, ast.Tuple)):
        return bool(value.elts) and all(
            _is_numeric_literal_seq(e) or (
                isinstance(e, ast.Constant)
                and isinstance(e.value, (int, float, complex))
                and not isinstance(e.value, bool))
            for e in value.elts)
    return False


class NpConstRule(Rule):
    code = "TL008"
    name = "host-constant"
    scopes = ("src/repro_torch/serving", "src/repro_torch/models",
              "src/repro_torch/kernels")
    EXPLAIN = EXPLAIN

    def _np_ctor_call(self, node: ast.Call, np_names: set,
                      ctors: set = _NP_CTORS) -> str | None:
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in np_names and f.attr in ctors:
            return f"{f.value.id}.{f.attr}"
        return None

    def _module_constants(self, ctx, np_names: set) -> dict:
        """Module-level ``NAME = np.ctor(...)`` / numeric-literal-seq
        bindings: name -> short description."""
        consts = {}
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            desc = None
            if isinstance(value, ast.Call):
                ctor = self._np_ctor_call(value, np_names, _NP_MODULE_CTORS)
                if ctor is not None:
                    desc = f"{ctor}(...)"
            elif _is_numeric_literal_seq(value):
                desc = "numeric list/tuple literal"
            if desc is None:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    consts[t.id] = desc
        return consts

    def check(self, ctx):
        np_names = _numpy_aliases(ctx.tree)
        captured = ctx.captured_functions
        mod_consts = self._module_constants(ctx, np_names)
        for node in ast.walk(ctx.tree):
            fn = ctx.enclosing_function(node)
            if fn is None or fn not in captured:
                continue
            if isinstance(node, ast.Call):
                chain = ctx._attr_chain(node.func)
                ctor = self._np_ctor_call(node, np_names) if np_names \
                    else None
                if ctor is not None:
                    yield from self.emit(
                        ctx, node,
                        f"{ctor}(...) inside a captured function builds a "
                        "host array per call (copied in at capture and "
                        "frozen there) — use torch.* on the device or a "
                        "program buffer")
                elif len(chain) == 2 and chain[0] == "torch" \
                        and chain[1] in _TORCH_HOST_CTORS:
                    yield from self.emit(
                        ctx, node,
                        f"torch.{chain[1]}(...) inside a captured function "
                        "builds on the host and copies to the device (a "
                        "sync the capture refuses, or a value frozen at "
                        "capture) — build it on the device or fill a "
                        "program buffer before the replay")
            elif isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.id in mod_consts:
                yield from self.emit(
                    ctx, node,
                    f"module constant '{node.id}' ({mod_consts[node.id]}) "
                    "read by a captured function: frozen into the graph "
                    "at capture — make it a device tensor or an explicit "
                    "argument")
