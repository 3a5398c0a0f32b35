"""TL005 — unit-suffix discipline for physical quantities in core/."""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.lint.framework import Rule

EXPLAIN = """\
TL005 unit-suffix discipline — ``repro_torch/core/`` carries real physics;
names carry the units.

The thermal/power model mixes watts, CFM, degrees C, hours, seconds,
fractions-of-provisioned and kWh in one dataflow.  The repo convention is
a unit suffix on every field and variable holding a physical quantity:

    suffix   unit                       examples
    ------   ------------------------   --------------------------------
    _w       watts                      idle_power_w, peak_power_w
    _kw      kilowatts                  (reserved; convert at the edge)
    _kwh     kilowatt-hours             energy_kwh
    _c       degrees Celsius            gpu_temp_limit_c, t_outside_c
    _ms      milliseconds               wan_rtt_ms, rtt_budget_ms
    _s       seconds                    finish_s, first_token_s
    _h       hours                      now_h, horizon_h, arrival_h
    _frac    fraction of provisioned    power_provision_frac
    _cfm     cubic feet / minute        airflow_idle_cfm
    _kg      kilograms (CO2)            carbon_kg

Flags:
  * ``+``/``-``/comparison between names carrying *different* unit
    suffixes (``x_c + y_w`` is meaningless; ``x_ms + y_s`` and
    ``x_w + y_kw`` are scale bugs).  ``*``/``/`` are exempt — they
    legitimately form new units.
  * dataclass fields in ``core/`` whose name says physical quantity
    (power/temp/energy/airflow/rtt/latency) but carries no unit suffix —
    dimensionless knobs end in ``_scale``/``_frac``/``_headroom``/
    ``_weight``/``_index``/``_quantile`` instead.

Fix: rename to carry the unit, or convert explicitly at the boundary
(and name the converted value with its new suffix).
"""

_SUFFIX_RE = re.compile(r"_(w|kw|kwh|c|ms|s|h|frac|cfm|kg)$")
#: suffix -> dimension; mixing inside a dimension is a *scale* bug,
#: across dimensions a *meaning* bug — both flagged.
_DIMENSION = {"w": "power", "kw": "power", "kwh": "energy",
              "c": "temperature", "ms": "time", "s": "time", "h": "time",
              "frac": "fraction", "cfm": "airflow", "kg": "mass"}
_QUANTITY_RE = re.compile(
    r"(^|_)(power|temp|energy|airflow|rtt|latency)(_|$)")
_DIMENSIONLESS_RE = re.compile(
    r"_(scale|headroom|weight|index|quantile|kind|name|id|"
    r"events|rows|mask|count|cap)$")
#: annotations that can hold a bare physical scalar/array; fields typed
#: as model objects (PowerModel, ThermalModel, ...) carry their own units
_NUMERIC_ANN_RE = re.compile(
    r"^(float|int|(np|jnp|numpy)\.ndarray|jnp\.Array)")


def _unit_of(node: ast.AST) -> str | None:
    """Unit suffix of a name/attribute operand, if any."""
    name = None
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    if name is None:
        return None
    m = _SUFFIX_RE.search(name)
    return m.group(1) if m else None


class UnitSuffixRule(Rule):
    code = "TL005"
    name = "unit-suffix"
    scopes = ("src/repro_torch/core",)
    EXPLAIN = EXPLAIN

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, (ast.Add, ast.Sub)):
                yield from self._check_pair(ctx, node, node.left,
                                            node.right)
            elif isinstance(node, ast.Compare):
                operands = [node.left, *node.comparators]
                for a, b in zip(operands, operands[1:]):
                    yield from self._check_pair(ctx, node, a, b)
            elif isinstance(node, ast.ClassDef):
                yield from self._check_fields(ctx, node)

    def _check_pair(self, ctx, node, left, right):
        ul, ur = _unit_of(left), _unit_of(right)
        if ul is None or ur is None or ul == ur:
            return
        dl, dr = _DIMENSION[ul], _DIMENSION[ur]
        what = f"different scales of {dl}" if dl == dr else \
            f"{dl} with {dr}"
        yield from self.emit(
            ctx, node,
            f"arithmetic mixes _{ul} and _{ur} ({what}); convert "
            "explicitly and name the result with its unit")

    def _check_fields(self, ctx, node: ast.ClassDef):
        is_dc = any("dataclass" in ctx._attr_chain(
            d.func if isinstance(d, ast.Call) else d)
            for d in node.decorator_list)
        if not is_dc:
            return
        for stmt in node.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            name = stmt.target.id
            if _SUFFIX_RE.search(name) or _DIMENSIONLESS_RE.search(name):
                continue
            try:
                ann = ast.unparse(stmt.annotation)
            except Exception:  # pragma: no cover - unparse never fails here
                ann = ""
            if not _NUMERIC_ANN_RE.match(ann):
                continue
            if _QUANTITY_RE.search(name):
                yield from self.emit(
                    ctx, stmt,
                    f"field '{name}' holds a physical quantity but has "
                    "no unit suffix (_w/_kw/_kwh/_c/_ms/_s/_h/_frac/"
                    "_cfm/_kg); name the unit or a dimensionless role "
                    "(_scale/_frac/_headroom)")
