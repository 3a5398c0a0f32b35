"""TL007 — swallowed error: no silent except-pass in the serving/control
planes."""
from __future__ import annotations

import ast

from repro_torch.analysis.lint.framework import Rule

EXPLAIN = """\
TL007 swallowed error — fault-handling code must never discard failures
silently.

The resilience layer's core guarantee is zero *silently* lost requests:
every admitted request ends in exactly one terminal outcome (accepted /
timed_out / rejected), and ``repro_torch.core.faults.audit_requests``
fails the bench if one vanishes.  A bare ``except:`` — or an ``except Exception: pass`` —
in the serving or control plane is how requests vanish: the crash that
should have re-queued the batch is eaten, the stats counters never move,
and the audit has nothing to point at.

The port adds two cases of the same leak: a ``chip_smoke.py`` phase whose
failure is caught while the run goes on to exit 0 (the card's check then
passes on what it never ran), and a kernel wrapper that gives way quietly
when its ``nvcc`` build fails (``repro_torch.kernels.build``), so the
"kernel" path runs something else and its launch counts read 0.

Flags, in the port's ``serving/``, ``core/``, ``kernels/`` and
``chip_smoke.py``:
  * bare ``except:`` handlers (always — they also eat KeyboardInterrupt
    and the watchdog's own failures);
  * ``except Exception`` / ``except BaseException`` (alone or inside a
    tuple) whose body does nothing but ``pass`` / ``...`` / ``continue``.

Narrow handlers (``except KeyError: pass``) stay legal — catching a
*specific* expected failure and moving on is a decision, not a leak.

Fix: catch the narrowest exception that is actually expected, or record
the failure (counter bump, re-queue, log) before continuing.  A genuinely
intentional broad swallow can be annotated
``# tapaslint: disable=TL007``.
"""

_BROAD = {"Exception", "BaseException"}


def _names(node: ast.AST | None):
    """Exception-class names referenced by an ``except`` type expression."""
    if node is None:
        return []
    exprs = node.elts if isinstance(node, ast.Tuple) else [node]
    out = []
    for e in exprs:
        if isinstance(e, ast.Name):
            out.append(e.id)
        elif isinstance(e, ast.Attribute):   # builtins.Exception etc.
            out.append(e.attr)
    return out


def _swallows(body: list) -> bool:
    """True when the handler body does nothing observable."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue   # `...` or a bare docstring
        return False
    return True


class SwallowedErrorRule(Rule):
    code = "TL007"
    name = "swallowed-error"
    scopes = ("src/repro_torch/serving", "src/repro_torch/core",
              "src/repro_torch/kernels", "chip_smoke.py")
    EXPLAIN = EXPLAIN

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield from self.emit(
                    ctx, node,
                    "bare 'except:' swallows every failure (including "
                    "KeyboardInterrupt); catch the narrowest expected "
                    "exception and record the rest")
                continue
            broad = sorted(set(_names(node.type)) & _BROAD)
            if broad and _swallows(node.body):
                yield from self.emit(
                    ctx, node,
                    f"'except {broad[0]}' with a do-nothing body discards "
                    "failures the resilience audit depends on; narrow the "
                    "type or record the failure before continuing")
