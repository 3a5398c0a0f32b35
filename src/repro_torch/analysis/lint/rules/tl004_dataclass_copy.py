"""TL004 — dataclass-copy completeness: modified copies must carry every
field (or use dataclasses.replace)."""
from __future__ import annotations

import ast

from repro_torch.analysis.lint.framework import Rule

EXPLAIN = """\
TL004 dataclass-copy completeness — a hand-rolled "copy with tweaks" of a
config dataclass silently resets every field it forgets.

Motivating bug (PR 5): ``scale_datacenter`` (now
``repro_torch.core.datacenter.scale_datacenter`` too) rebuilt ``DCConfig`` field by
field and omitted ``power_provision_frac``/``airflow_provision_frac`` —
custom-provisioned regions quietly reverted to the defaults, skewing
every planner sweep over them until a drill surfaced it.

Detection: a constructor call ``X(...)`` where ``X`` is a repo dataclass
and at least two keyword arguments are verbatim field reads off one
source object (``f=src.f``) is a copy; the rule then requires every field
of ``X`` to appear as a keyword (positional args count positionally).
Missing fields are listed in the message.

Fix: ``dataclasses.replace(src, changed=...)`` — it fails loudly on
unknown fields and can never drop one.  (Adding a field to the dataclass
later keeps working, which the hand-rolled copy never does.)
"""


class DataclassCopyRule(Rule):
    code = "TL004"
    name = "dataclass-copy"
    EXPLAIN = EXPLAIN

    def check(self, ctx):
        specs = ctx.registry.dataclasses
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = None
            if isinstance(node.func, ast.Name):
                cname = node.func.id
            elif isinstance(node.func, ast.Attribute):
                cname = node.func.attr
            spec = specs.get(cname or "")
            if spec is None:
                continue
            kw_named = {kw.arg for kw in node.keywords if kw.arg}
            has_splat = any(kw.arg is None for kw in node.keywords)
            # copy-shaped: >=2 kwargs are `field=<src>.field` off one obj
            src_counts: dict[str, int] = {}
            for kw in node.keywords:
                if kw.arg and isinstance(kw.value, ast.Attribute) \
                        and kw.value.attr == kw.arg \
                        and isinstance(kw.value.value, ast.Name):
                    src = kw.value.value.id
                    src_counts[src] = src_counts.get(src, 0) + 1
            if not src_counts or max(src_counts.values()) < 2:
                continue
            if has_splat:
                continue                     # X(**asdict(src), ...) is total
            covered = kw_named | set(spec.fields[:len(node.args)])
            missing = [f for f in spec.fields if f not in covered]
            if missing:
                src = max(src_counts, key=src_counts.get)
                yield from self.emit(
                    ctx, node,
                    f"field-by-field copy of {cname} drops "
                    f"{', '.join(missing)} (silently reset to defaults — "
                    f"the scale_datacenter bug); use "
                    f"dataclasses.replace({src}, ...)")
