"""TL006 — protocol conformance for control-plane policy classes."""
from __future__ import annotations

import ast

from repro_torch.analysis.lint.framework import Rule

EXPLAIN = """\
TL006 protocol conformance — a policy that implements *most* of
``ControlPolicy``/``FleetPolicy`` passes ``isinstance`` checks it should
fail.

The control-plane protocols are ``runtime_checkable``, which only checks
method *presence* by name — a policy missing ``release`` (or taking
``(self, state)`` where the sim calls ``(self, state, server)``) imports
cleanly, drives most of a drill, then dies mid-run on the first VM
departure, wasting a whole debugging cycle on what is a signature typo.

Detection: every class that defines at least half of a scanned
``Protocol``'s methods (or names the protocol in its bases) is treated as
an implementor and must:
  * define *every* protocol method, and
  * match each method's positional parameter names (extra trailing
    parameters are allowed only with defaults; ``**kwargs`` absorbs
    anything).

Fix: implement the full surface; stubs that intentionally do nothing
should still exist (``return None``) so the contract stays checkable.
"""


class ProtocolConformanceRule(Rule):
    code = "TL006"
    name = "protocol-conformance"
    EXPLAIN = EXPLAIN

    def check(self, ctx):
        protocols = ctx.registry.protocols
        if not protocols:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            base_names = {n for b in node.bases
                          for n in ctx._attr_chain(b)}
            if "Protocol" in base_names:
                continue                      # the protocol itself
            methods = {s.name: s for s in node.body
                       if isinstance(s, ast.FunctionDef)}
            for pname, proto in protocols.items():
                declared = pname in base_names
                overlap = len(set(proto.methods) & set(methods))
                # all-but-one: adapters legitimately share a couple of
                # hook names with a protocol; a class one method short of
                # the full surface is the bug shape worth catching
                needed = max(2, len(proto.methods) - 1)
                if not declared and overlap < needed:
                    continue
                missing = sorted(set(proto.methods) - set(methods))
                if missing:
                    yield from self.emit(
                        ctx, node,
                        f"class {node.name} implements {overlap}/"
                        f"{len(proto.methods)} of {pname} but is missing "
                        f"{', '.join(missing)}; runtime_checkable "
                        "isinstance would only fail mid-drill")
                for mname, proto_args in proto.methods.items():
                    impl = methods.get(mname)
                    if impl is None:
                        continue
                    yield from self._check_signature(
                        ctx, impl, pname, mname, proto_args)

    def _check_signature(self, ctx, impl: ast.FunctionDef, pname, mname,
                         proto_args):
        a = impl.args
        if a.kwarg is not None:
            return                            # **kwargs absorbs anything
        impl_args = [x.arg for x in a.posonlyargs + a.args
                     if x.arg not in ("self", "cls")]
        n = len(proto_args)
        if a.vararg is not None and len(impl_args) <= n:
            return                            # *args covers the tail
        if impl_args[:n] != proto_args:
            yield from self.emit(
                ctx, impl,
                f"{mname}({', '.join(impl_args)}) does not match "
                f"{pname}.{mname}({', '.join(proto_args)}); the sim "
                "calls positionally — rename/reorder to the protocol")
            return
        full = [x.arg for x in a.posonlyargs + a.args]
        defaults_start = len(full) - len(a.defaults)
        self_off = len(full) - len(impl_args)      # 0 or 1 (self/cls)
        for i, extra in enumerate(impl_args[n:]):
            if self_off + n + i < defaults_start:
                yield from self.emit(
                    ctx, impl,
                    f"{mname} adds required parameter '{extra}' beyond "
                    f"{pname}.{mname}; give it a default (the sim will "
                    "never pass it)")
