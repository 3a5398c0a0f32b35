"""TL001 — determinism: no unseeded or process-varying entropy sources."""
from __future__ import annotations

import ast

from repro_torch.analysis.lint.framework import Rule

EXPLAIN = """\
TL001 determinism — every random draw and every string-keyed seed must be
process-stable.

Motivating bug (PR 2): trace phases were seeded with ``hash(customer)``;
``hash(str)`` is randomized per interpreter process (PYTHONHASHSEED), so
the same simulation seed produced different thermal trajectories on every
run.  Fixed with crc32 (``repro_torch.core.traces._stable_seed``) — which
is what this rule points you at.

Flags:
  * stdlib ``random.*`` calls (module-global RNG — unseeded AND shared);
  * ``np.random.<fn>(...)`` legacy module-global draws (``np.random.seed``
    included: it mutates global state under every other caller);
  * ``np.random.default_rng()`` with no seed argument;
  * ``hash(...)`` — use ``repro_torch.core.traces._stable_seed`` /
    ``zlib.crc32`` for anything that feeds a seed, key or bucket;
  * iterating directly over ``set(...)`` / set literals / frozenset in
    ``for``/comprehensions — set order is hash-order; wrap in
    ``sorted(...)`` before it can touch scheduling decisions;
  * torch's global RNG: ``torch.manual_seed`` / ``torch.cuda.manual_seed``
    (``_all``) — they reseed every other caller's draws — and
    ``torch.rand/randn/randint/randperm/multinomial/bernoulli/normal``,
    their ``*_like`` forms and the in-place ``.uniform_/.normal_/
    .bernoulli_/.exponential_/.random_`` called without ``generator=``.

Fix: draw from ``np.random.default_rng(seed)`` where ``seed`` derives
from config / ``repro_torch.core.traces.trace_seed(seed, namespace)``;
in torch pass ``generator=torch.Generator(device).manual_seed(seed)``, or
derive the bits from ``repro_torch.models.prng``'s keys as the sampled
decode does.
"""

#: torch draws from the global generator unless given ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
                "bernoulli", "normal", "rand_like", "randn_like",
                "randint_like"}
_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                  "random_"}
_GLOBAL_SEEDS = (["torch", "manual_seed"], ["torch", "cuda", "manual_seed"],
                 ["torch", "cuda", "manual_seed_all"],
                 ["torch", "random", "manual_seed"])


class DeterminismRule(Rule):
    code = "TL001"
    name = "determinism"
    EXPLAIN = EXPLAIN

    def check(self, ctx):
        stdlib_random = False
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                stdlib_random |= any(a.name == "random" and a.asname is None
                                     for a in node.names)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(ctx, node, stdlib_random)
                yield from self._check_torch(ctx, node)
            elif isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                if self._is_set_expr(it):
                    yield from self.emit(
                        ctx, it if isinstance(node, ast.comprehension)
                        else node,
                        "iteration over a set is hash-order-dependent; "
                        "wrap in sorted(...) before order can leak into "
                        "scheduling")

    @staticmethod
    def _is_set_expr(node) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("set", "frozenset"):
            return True
        # `a | b` over set(...) builds — the common union-then-iterate shape
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
            return (DeterminismRule._is_set_expr(node.left)
                    or DeterminismRule._is_set_expr(node.right))
        return False

    def _check_call(self, ctx, node, stdlib_random):
        chain = ctx._attr_chain(node.func)
        if len(chain) >= 2 and chain[-2:-1] == ["random"] \
                and chain[0] in ("np", "numpy"):
            fn = chain[-1]
            if fn == "default_rng":
                if not node.args and not node.keywords:
                    yield from self.emit(
                        ctx, node,
                        "np.random.default_rng() without a seed is "
                        "entropy-seeded; derive the seed from config "
                        "(traces.trace_seed)")
            elif fn not in ("Generator", "BitGenerator", "PCG64",
                            "Philox", "SeedSequence"):
                yield from self.emit(
                    ctx, node,
                    f"np.random.{fn}() uses the legacy module-global RNG; "
                    "use np.random.default_rng(seed) with a config-derived "
                    "seed (traces.trace_seed)")
        elif stdlib_random and len(chain) == 2 and chain[0] == "random":
            yield from self.emit(
                ctx, node,
                f"stdlib random.{chain[1]}() draws from the shared "
                "module-global RNG; use np.random.default_rng(seed) "
                "(traces.trace_seed)")
        elif chain == ["hash"]:
            yield from self.emit(
                ctx, node,
                "hash() is randomized per process (PYTHONHASHSEED); use "
                "traces._stable_seed / zlib.crc32 for seeds and keys")

    def _check_torch(self, ctx, node):
        chain = ctx._attr_chain(node.func)
        if chain in _GLOBAL_SEEDS:
            yield from self.emit(
                ctx, node,
                f"{'.'.join(chain)}() reseeds torch's global RNG under "
                "every other caller; seed a torch.Generator(...)"
                ".manual_seed(seed) and pass it as generator=")
            return
        if any(kw.arg == "generator" for kw in node.keywords):
            return
        if len(chain) == 2 and chain[0] == "torch" \
                and chain[1] in _TORCH_DRAWS:
            yield from self.emit(
                ctx, node,
                f"torch.{chain[1]}() without generator= draws from torch's "
                "global RNG; pass generator=torch.Generator(...)"
                ".manual_seed(seed) or derive it from models/prng.py's keys")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _INPLACE_DRAWS:
            yield from self.emit(
                ctx, node,
                f".{node.func.attr}() without generator= draws from "
                "torch's global RNG; pass generator=torch.Generator(...)"
                ".manual_seed(seed)")
