"""TL003 — capture hazard: no Python branches on runtime values inside a
captured step, and no per-call-varying program keys."""
from __future__ import annotations

import ast

from repro_torch.analysis.lint.framework import Rule

EXPLAIN = """\
TL003 capture hazard — a captured step must be one graph.

Motivating bug (PR 6, in the reference): the fused decode horizon passed
``num_steps=min(horizon, max_remaining_budget)`` as a jit static arg; the
shrinking tail re-specialized (recompiled) the whole scan mid-measurement,
so step-time benches measured the compiler, not the model.  The port's
form of the same bug is a fresh CUDA-graph capture: ``serving/graphs.py``
keys a program by its lanes, table width, rows and chunk, and every new
value captures (and warms up) a new graph.

Flags:
  * Python ``if``/``while`` inside a captured function whose test reads
    a runtime parameter of that function.  A replay keeps the branch
    taken at capture, whatever the buffers hold later; on a tensor the
    test is also a host sync, which the capture refuses.  Tests on
    statics (``self``/``cfg``/``params``/``num_steps``/...), ``x is
    None`` checks, ``isinstance`` checks, ``len(...)``/``.shape``/
    ``.ndim``/``.dtype`` probes and device probes (``.device``,
    ``.device.type``, ``.is_cuda``) are allowed: those are fixed for the
    life of a capture.  A kernel call needs no device branch at all:
    ``kernels/ops.py`` registers each kernel as a ``torch.library`` op
    whose CUDA and CPU implementations the dispatcher picks.
  * call sites of the program builders (``horizon_program``,
    ``spec_program``, ``chunk_program``, ``slot_program``) and of
    ``run_horizon``/``run_spec`` passing a *computed* expression (min/
    max/arithmetic/len) to a key argument (``lanes``/``width``/``rows``/
    ``chunk``/``num_steps``/``spec_k``): each distinct builder value is a
    fresh capture, and a per-call ``num_steps`` makes each drain's
    outputs a new shape — pass a stable knob and mask the tail on the
    device instead.

Fix: replace the Python branch with ``torch.where`` on the device, and
pin program keys to engine-lifetime constants (bucketed widths).
"""

#: statics commonly threaded through this repo's captured functions
_STATIC_NAMES = {"self", "cls", "cfg", "plan", "params", "config",
                 "num_steps", "max_len", "spec_k", "ngram", "horizon",
                 "block_size", "kwargs", "kw"}
_STATIC_PROBES = {"shape", "ndim", "dtype", "size",
                  # device probes: fixed for the life of a capture
                  "device", "is_cuda"}
#: positional parameters of the program builders and runners
#: (``serving/graphs.py``), and which of them key a program
_PROGRAM_CALLS = {
    "horizon_program": ("model", "tensors", "lanes", "width"),
    "spec_program": ("model", "drafter", "tensors", "lanes", "width",
                     "hist_width"),
    "chunk_program": ("model", "tensors", "rows", "chunk", "width"),
    "slot_program": ("model", "tensors", "slots"),
    "run_horizon": ("prog", "num_steps"),
    "run_spec": ("prog", "num_steps"),
}
_KEY_ARGS = {"lanes", "width", "rows", "chunk", "num_steps", "spec_k"}


class RetraceRule(Rule):
    code = "TL003"
    name = "capture-hazard"
    scopes = ("src/repro_torch/serving", "src/repro_torch/models",
              "src/repro_torch/kernels")
    EXPLAIN = EXPLAIN

    def check(self, ctx):
        captured = ctx.captured_functions
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.If, ast.While)):
                fn = ctx.enclosing_function(node)
                if fn is None or fn not in captured:
                    continue
                name = self._runtime_name_in_test(node.test, fn)
                if name is not None:
                    kind = "while" if isinstance(node, ast.While) else "if"
                    yield from self.emit(
                        ctx, node,
                        f"Python `{kind}` on runtime value '{name}' inside "
                        "a captured function is frozen at capture (and a "
                        "host sync on a tensor); use torch.where on the "
                        "device")
            elif isinstance(node, ast.Call):
                yield from self._check_key_args(ctx, node)

    # -- data-dependent branch test ---------------------------------------
    @classmethod
    def _runtime_name_in_test(cls, test: ast.AST, fn) -> str | None:
        """First runtime (non-static) parameter of ``fn`` the test reads
        outside an allowed probe context, or None."""
        a = fn.args
        all_params = a.posonlyargs + a.args + a.kwonlyargs
        params = {x.arg for x in all_params}
        if a.vararg:
            params.add(a.vararg.arg)
        # params annotated as Python scalars (bool/int/float/str) are
        # capture-time statics by repo convention (``causal: bool``);
        # runtime values are tensors
        static_annotated = set()
        for x in all_params:
            if x.annotation is not None:
                try:
                    ann = ast.unparse(x.annotation)
                except Exception:  # pragma: no cover
                    ann = ""
                if ann.split("|")[0].strip() in ("bool", "int", "float",
                                                 "str"):
                    static_annotated.add(x.arg)
        runtime = params - _STATIC_NAMES - static_annotated
        if not runtime:
            return None
        # `x is None` / `x is not None` / isinstance(...) guards are
        # structure checks, not value branches
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.ops[0], (ast.Is, ast.IsNot)):
            return None
        if isinstance(test, ast.Call):
            chain_last = test.func.attr \
                if isinstance(test.func, ast.Attribute) else \
                (test.func.id if isinstance(test.func, ast.Name) else "")
            if chain_last in ("isinstance", "hasattr", "callable"):
                return None
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return cls._runtime_name_in_test(test.operand, fn)
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                hit = cls._runtime_name_in_test(v, fn)
                if hit is not None:
                    return hit
            return None
        allowed: set[int] = set()
        for sub in ast.walk(test):
            # len(x), x.shape/.ndim/.dtype/.size/.device: fixed for the
            # life of a capture
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                    and sub.func.id == "len":
                allowed.update(id(n) for n in ast.walk(sub))
            elif isinstance(sub, ast.Attribute) \
                    and sub.attr in _STATIC_PROBES:
                allowed.update(id(n) for n in ast.walk(sub))
        for sub in ast.walk(test):
            if isinstance(sub, ast.Name) and sub.id in runtime \
                    and id(sub) not in allowed:
                return sub.id
        return None

    # -- per-call-varying program keys at builder call sites ---------------
    def _check_key_args(self, ctx, node: ast.Call):
        name = ctx._attr_chain(node.func)[-1:]
        params = _PROGRAM_CALLS.get(name[0]) if name else None
        if params is None:
            return
        passed = list(zip(params, node.args)) + [(kw.arg, kw.value)
                                                 for kw in node.keywords]
        for arg, value in passed:
            if arg not in _KEY_ARGS:
                continue
            if self._varies_per_call(value):
                yield from self.emit(
                    ctx, node,
                    f"program key {arg}= computed per call "
                    f"({ast.unparse(value)}): every distinct value "
                    "captures a new graph mid-run (the PR 6 shrinking-"
                    "tail bug); pass a stable knob and mask the tail "
                    "on the device")

    @staticmethod
    def _varies_per_call(value: ast.AST) -> bool:
        """A computed expression (min/len/arithmetic) rather than a
        constant, plain name, or attribute read."""
        if isinstance(value, (ast.Constant, ast.Name)):
            return False
        if isinstance(value, ast.Attribute):
            return False                       # self.horizon etc.
        return True
