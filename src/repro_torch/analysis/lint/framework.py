"""tapaslint for the port: AST framework for repo-specific invariants
(the counterpart of ``repro.analysis.lint.framework``).

Every rule here is derived from a bug this repo actually shipped (see the
rule modules' ``EXPLAIN`` texts).  The framework is stdlib-only, so the
lint runs without torch or numpy, and deals in three currencies:

* ``Finding`` — one violation, keyed for the baseline by
  ``(rule, path, enclosing symbol, message)`` and *not* by line number, so
  unrelated edits above a grandfathered finding don't churn the baseline.
* suppression — ``# tapaslint: disable=TL002`` (or ``disable=all``) on the
  flagged line or the enclosing ``def``/``class`` line silences a finding
  at the source; ``# tapaslint: disable-file=TL005`` anywhere in the file
  silences a rule for the whole module.
* baseline — a checked-in multiset of grandfathered finding keys
  (``src/repro_torch/analysis/lint/baseline.txt``, empty).  A finding not
  in the baseline fails the run; stale baseline entries are reported so
  the file only shrinks.

Rules see a ``ModuleContext`` (per file: source, AST, parent links,
qualified names, captured-function detection) plus a ``Registry`` built in
a first pass over the whole file set (dataclass field lists and Protocol
method signatures — rules TL004/TL006 need cross-module knowledge).

Where the reference asks which functions run under a jax trace, the port
asks which run inside a CUDA-graph capture: a captured step is replayed
as recorded, so a host sync, a Python branch on a runtime value or a host
constant inside it is frozen at (or refused by) its capture.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    rule: str          # "TL001"
    path: str          # repo-relative posix path
    line: int          # 1-based, for humans; not part of the baseline key
    message: str
    symbol: str = ""   # enclosing def/class qualname ("" == module level)

    def key(self) -> str:
        """Line-independent identity used by the baseline."""
        return f"{self.rule} {self.path}::{self.symbol} {self.message}"

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{sym}"


_SUPPRESS_RE = re.compile(r"#\s*tapaslint:\s*disable=([A-Za-z0-9,]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*tapaslint:\s*disable-file=([A-Za-z0-9,]+)")


def _codes(match: re.Match) -> set[str]:
    return {c.strip().upper() for c in match.group(1).split(",") if c.strip()}


class ModuleContext:
    """One parsed module plus the lazy per-module analyses rules share."""

    def __init__(self, path: str, source: str, registry: "Registry"):
        self.path = path                       # repo-relative posix path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.registry = registry
        self._parents: dict[ast.AST, ast.AST] | None = None
        self._captured: set[ast.AST] | None = None
        self._line_suppress: dict[int, set[str]] = {}
        self._file_suppress: set[str] = set()
        for i, ln in enumerate(self.lines, start=1):
            m = _SUPPRESS_FILE_RE.search(ln)
            if m:
                self._file_suppress |= _codes(m)
                continue
            m = _SUPPRESS_RE.search(ln)
            if m:
                self._line_suppress[i] = _codes(m)

    # -- tree plumbing -----------------------------------------------------
    @property
    def parents(self) -> dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def qualname(self, node: ast.AST) -> str:
        """Dotted name of the innermost enclosing def/class (incl. node)."""
        parts: list[str] = []
        for n in [node, *self.ancestors(node)]:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                parts.append(n.name)
        return ".".join(reversed(parts))

    def enclosing_function(self, node: ast.AST):
        for n in [node, *self.ancestors(node)]:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return n
        return None

    # -- captured-function detection (shared by TL002/TL003/TL008) ---------
    #: calls whose function arguments run inside a CUDA-graph capture:
    #: ``serving/graphs.py``'s ``Program(name, body, ...)`` captures
    #: ``body``; torch's ``make_graphed_callables`` captures its callables
    CAPTURE_WRAPPERS = {"Program", "make_graphed_callables"}
    #: method-name shapes that run inside the captured steps of *other*
    #: modules (the programs call ``Model.decode_*``/``prefill_*``; the
    #: kernels' launchers) — static reachability without whole-program
    #: analysis.  The reference's pattern, unchanged.
    HOT_NAME_RE = re.compile(
        r"^(decode_|prefill_|gqa_prefill|block_|_flash|_paged|.*_kernel$)")

    def _attr_chain(self, func: ast.AST) -> list[str]:
        parts: list[str] = []
        while isinstance(func, ast.Attribute):
            parts.append(func.attr)
            func = func.value
        if isinstance(func, ast.Name):
            parts.append(func.id)
        return list(reversed(parts))

    def _is_graph_block(self, node: ast.AST) -> bool:
        """A ``with torch.cuda.graph(...)`` statement."""
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            return False
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                chain = self._attr_chain(expr.func)
                if chain[-2:] == ["cuda", "graph"]:
                    return True
        return False

    @property
    def captured_functions(self) -> set[ast.AST]:
        """FunctionDefs that (transitively) run inside a CUDA-graph
        capture: passed to ``Program``/``make_graphed_callables``, called
        or defined inside a ``with torch.cuda.graph(...)`` block, named
        like a step entry point, or nested inside any of these."""
        if self._captured is not None:
            return self._captured
        captured: set[ast.AST] = set()
        by_name: dict[str, list[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, []).append(node)
                if self.HOT_NAME_RE.match(node.name):
                    captured.add(node)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                # functions passed (by name) into a capture entry point
                chain = self._attr_chain(node.func)
                if chain[-1:] and chain[-1] in self.CAPTURE_WRAPPERS:
                    for arg in list(node.args) + [kw.value
                                                  for kw in node.keywords]:
                        for ref in ast.walk(arg):
                            if isinstance(ref, ast.Name) \
                                    and ref.id in by_name:
                                captured.update(by_name[ref.id])
            elif self._is_graph_block(node):
                # what a graph block calls or defines is captured
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            captured.add(sub)
                        elif isinstance(sub, ast.Call):
                            name = self._attr_chain(sub.func)[-1:]
                            if name and name[0] in by_name:
                                captured.update(by_name[name[0]])
        # closure: defs nested inside captured defs are captured
        changed = True
        while changed:
            changed = False
            for fns in by_name.values():
                for fn in fns:
                    if fn in captured:
                        continue
                    for anc in self.ancestors(fn):
                        if anc in captured:
                            captured.add(fn)
                            changed = True
                            break
        self._captured = captured
        return captured

    # -- suppression -------------------------------------------------------
    def suppressed(self, rule: str, node: ast.AST) -> bool:
        if rule in self._file_suppress or "ALL" in self._file_suppress:
            return True
        cand_lines = {getattr(node, "lineno", 0)}
        fn = self.enclosing_function(node)
        if fn is not None:
            cand_lines.add(fn.lineno)
        for n in self.ancestors(node):
            if isinstance(n, ast.ClassDef):
                cand_lines.add(n.lineno)
                break
        for ln in cand_lines:
            codes = self._line_suppress.get(ln, set())
            if rule in codes or "ALL" in codes:
                return True
        return False

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.path,
                       line=getattr(node, "lineno", 0), message=message,
                       symbol=self.qualname(node))


@dataclass
class ProtocolSpec:
    name: str
    path: str
    methods: dict = field(default_factory=dict)  # name -> [arg names] (no self)


@dataclass
class DataclassSpec:
    name: str
    path: str
    fields: list = field(default_factory=list)   # declaration order
    frozen: bool = False


class Registry:
    """Cross-module facts collected in pass 1 (before any rule runs)."""

    def __init__(self):
        self.dataclasses: dict[str, DataclassSpec] = {}
        self.protocols: dict[str, ProtocolSpec] = {}

    def collect(self, ctx: ModuleContext) -> None:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            deco_names = set()
            frozen = False
            for dec in node.decorator_list:
                chain = ctx._attr_chain(
                    dec.func if isinstance(dec, ast.Call) else dec)
                deco_names.update(chain)
                if isinstance(dec, ast.Call) and "dataclass" in chain:
                    for kw in dec.keywords:
                        if kw.arg == "frozen" and isinstance(
                                kw.value, ast.Constant):
                            frozen = bool(kw.value.value)
            base_names = {n for b in node.bases for n in ctx._attr_chain(b)}
            if "dataclass" in deco_names:
                fields = [s.target.id for s in node.body
                          if isinstance(s, ast.AnnAssign)
                          and isinstance(s.target, ast.Name)
                          and not s.target.id.startswith("_")]
                if fields:
                    self.dataclasses[node.name] = DataclassSpec(
                        node.name, ctx.path, fields, frozen)
            if "Protocol" in base_names:
                spec = ProtocolSpec(node.name, ctx.path)
                for s in node.body:
                    if isinstance(s, ast.FunctionDef) \
                            and not s.name.startswith("_"):
                        args = [a.arg for a in s.args.args
                                if a.arg != "self"]
                        spec.methods[s.name] = args
                if spec.methods:
                    self.protocols[node.name] = spec


class Rule:
    """Base class: subclasses set ``code``/``name``/``EXPLAIN`` and
    implement ``check(ctx) -> iterator of Finding``."""

    code = "TL000"
    name = "base"
    EXPLAIN = ""
    #: repo-relative path prefixes the rule applies to ("" == everywhere)
    scopes: tuple = ("",)

    def applies(self, path: str) -> bool:
        return any(path.startswith(s) for s in self.scopes)

    def check(self, ctx: ModuleContext):
        raise NotImplementedError
        yield  # pragma: no cover

    def emit(self, ctx: ModuleContext, node: ast.AST, message: str):
        """Yield a finding unless suppressed at the source."""
        if not ctx.suppressed(self.code, node):
            yield ctx.finding(self.code, node, message)


# ---------------------------------------------------------------------------
# driving
# ---------------------------------------------------------------------------

def lint_sources(files: dict, rules: list | None = None) -> list[Finding]:
    """Lint in-memory sources: ``{repo-relative-path: source}``.

    Two passes: collect the cross-module registry, then run every rule
    over every module it scopes to.  Files that fail to parse yield a
    single TL000 syntax finding instead of aborting the run.
    """
    if rules is None:
        from repro_torch.analysis.lint.rules import ALL_RULES
        rules = ALL_RULES
    registry = Registry()
    contexts: list[ModuleContext] = []
    findings: list[Finding] = []
    for path in sorted(files):
        try:
            ctx = ModuleContext(path, files[path], registry)
        except SyntaxError as e:
            findings.append(Finding("TL000", path, e.lineno or 0,
                                    f"syntax error: {e.msg}"))
            continue
        registry.collect(ctx)
        contexts.append(ctx)
    for ctx in contexts:
        for rule in rules:
            if rule.applies(ctx.path):
                findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def collect_files(root, paths) -> dict:
    """Read every ``*.py`` under ``paths`` (relative to ``root``) into a
    ``{relative-posix-path: source}`` dict, skipping caches/results."""
    import pathlib
    root = pathlib.Path(root)
    out: dict[str, str] = {}
    for p in paths:
        base = root / p
        candidates = [base] if base.is_file() else sorted(base.rglob("*.py"))
        for f in candidates:
            rel = f.relative_to(root).as_posix()
            if "__pycache__" in rel or rel.startswith("benchmarks/results"):
                continue
            out[rel] = f.read_text()
    return out


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline(path) -> list[str]:
    import pathlib
    p = pathlib.Path(path)
    if not p.exists():
        return []
    return [ln.strip() for ln in p.read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]


def diff_baseline(findings: list[Finding], baseline: list[str]):
    """Multiset-match finding keys against the baseline.

    Returns ``(new_findings, matched_keys, stale_keys)``: findings whose
    key is not grandfathered, the keys that matched, and baseline entries
    that no longer correspond to any finding (fixed — remove them)."""
    from collections import Counter
    remaining = Counter(baseline)
    new: list[Finding] = []
    matched: list[str] = []
    for f in findings:
        k = f.key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
            matched.append(k)
        else:
            new.append(f)
    stale = list((+remaining).elements())
    return new, matched, stale


def format_baseline(findings: list[Finding]) -> str:
    lines = [
        "# tapaslint baseline for the port — grandfathered findings (the",
        "# lint fails on any finding NOT listed here).  Regenerate after",
        "# fixing an entry:",
        "#   PYTHONPATH=src python -m repro_torch.analysis.lint "
        "--update-baseline",
        "# One key per line: '<rule> <path>::<symbol> <message>'.",
    ]
    lines += sorted(f.key() for f in findings)
    return "\n".join(lines) + "\n"
