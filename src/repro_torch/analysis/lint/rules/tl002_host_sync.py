"""TL002 — host-sync leak: no device-to-host coercion on the hot path."""
from __future__ import annotations

import ast

from repro_torch.analysis.lint.framework import Rule

EXPLAIN = """\
TL002 host-sync leak — device values must not be coerced to host values
inside serving/model hot-path code.

The decode hot path is engineered around ONE host sync per drained
horizon (PR 3: 5.6x sync reduction); a single stray ``.item()`` /
``float(t)`` / ``t.cpu()`` re-serializes the device stream and silently
costs the whole batch a round-trip.  Inside a captured step it is worse:
``repro_torch.serving.graphs`` refuses a capture that meets a host sync
(``RuntimeError: CUDA graph capture of the ... failed``), and that shows
only on the card — the CPU runs every step eagerly.  PR 25's gemma host
copy in ``Model._embed_inputs`` was exactly such a sync, found on the
card and nowhere else.

Flags, inside functions that run inside a CUDA-graph capture (passed to
``Program(name, body, ...)``, called in a ``with torch.cuda.graph(...)``
block, named like a ``decode_*``/``prefill_*``/kernel entry point, or
nested in one):
  * ``x.item()``, ``x.tolist()``;
  * ``x.cpu()``, ``x.numpy()``, ``x.to("cpu")``;
  * ``float(x)`` / ``int(x)`` / ``bool(x)`` on a non-constant argument;
  * ``np.asarray(x)`` / ``np.array(x)`` — the tensor leaves the device;
  * ``torch.cuda.synchronize()``;
  * ``torch.nonzero(x)`` / ``x.nonzero()`` — its output's shape is read
    back to the host.

Outside captured functions (engine scheduler code in ``serving/``), only
``.item()``/``.tolist()`` are flagged: per-element readbacks hide in stats
paths, whereas one batched ``.cpu().numpy()`` per horizon is the
sanctioned sync idiom (and is counted in ``EngineStats.host_syncs``;
``repro_torch.analysis.lint.runtime.sanctioned_readback`` is its guarded
form).

Fix: keep the value on the device (mask/where), or batch the readback at
the horizon boundary and account it in ``stats.host_syncs``.  Genuinely
cold readbacks can be annotated ``# tapaslint: disable=TL002``.
"""

_COERCERS = ("float", "int", "bool")


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    args = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


class HostSyncRule(Rule):
    code = "TL002"
    name = "host-sync-leak"
    scopes = ("src/repro_torch/serving", "src/repro_torch/models",
              "src/repro_torch/kernels")
    EXPLAIN = EXPLAIN

    def check(self, ctx):
        captured = ctx.captured_functions
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = ctx.enclosing_function(node)
            in_capture = fn is not None and fn in captured
            chain = ctx._attr_chain(node.func)
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else None
            if attr in ("item", "tolist") and not node.args:
                yield from self.emit(
                    ctx, node,
                    f".{node.func.attr}() forces a device->host sync per "
                    "element; batch the readback (one np.asarray per "
                    "horizon) and count it in stats.host_syncs")
                continue
            if not in_capture:
                continue
            if attr in ("cpu", "numpy") and not node.args \
                    or attr == "to" and _to_cpu(node):
                yield from self.emit(
                    ctx, node,
                    f".{attr}() inside a captured function copies to the "
                    "host: a sync the capture refuses; return the tensor "
                    "and read it back once at the horizon boundary")
            elif chain[-3:] == ["torch", "cuda", "synchronize"]:
                yield from self.emit(
                    ctx, node,
                    "torch.cuda.synchronize() inside a captured function "
                    "stalls the host on the device, and a capture refuses "
                    "it; synchronize at the horizon boundary")
            elif chain == ["torch", "nonzero"] or attr == "nonzero":
                yield from self.emit(
                    ctx, node,
                    "nonzero() inside a captured function reads its output "
                    "shape back to the host (a sync the capture refuses); "
                    "use a mask and torch.where")
            elif len(chain) == 2 and chain[0] in ("np", "numpy") \
                    and chain[1] in ("asarray", "array"):
                yield from self.emit(
                    ctx, node,
                    f"np.{chain[1]}() on a device tensor copies it to the "
                    "host (a sync the capture refuses); keep it a tensor "
                    "inside captured code")
            elif chain in (["float"], ["int"], ["bool"]) and node.args \
                    and not isinstance(node.args[0], ast.Constant):
                yield from self.emit(
                    ctx, node,
                    f"{chain[0]}() on a device tensor reads it back (a "
                    "sync the capture refuses); keep it a 0-d tensor (or "
                    "read it back at the horizon boundary)")
