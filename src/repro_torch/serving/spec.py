"""One serving construction API (port of ``repro.serving.spec``).

``EngineSpec`` turns an ``ArchConfig`` plus a shard count into (plan,
seeded parameters, paged pool, ``Engine``) in one call.  ``serving_plan``
is the serving plan's one entry point: ``local_plan`` at ``shards = 1``,
otherwise a plan whose paged pool is block-striped over ``shards`` ranks.

The reference builds a ``(1, shards)`` device mesh and needs ``shards``
devices.  The port keeps every stripe of the pool on the engine's one
device (rank r's stripe is a contiguous view of the pool) and merges the
stripes in-process, so it needs one device at any degree; the weights stay
whole on it.

Weights come from a seeded ``torch.Generator``, which draws other numbers
than the reference's ``jax.random`` key of the same seed: a test that holds
the port to the reference carries the reference's weights across
(``repro_torch.convert.from_jax_params``) into ``Engine.params``.

``build(share=other_engine)`` aliases another engine's (model, parameters)
registries, every variant and drafter included, instead of initialising
them again: a fleet of engines holds ONE copy of the weights (see
``serving.backend.EngineFleet``); each engine still gets its own pool and
step programs.  Nothing in the port writes a parameter in place, so the
aliasing is as safe as the reference's over immutable arrays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.sharding import ShardPlan, local_plan
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import Engine, EngineKnobs, shard_compat


def serving_plan(shards: int = 1, **kw) -> ShardPlan:
    """The serving plan for ``shards``-way model parallelism: a single-
    device ``local_plan`` at ``shards <= 1``, else a plan that stripes the
    paged pool over ``shards`` ranks (all on one device, see the module
    docstring).  ``param_dtype`` defaults to bf16, as the reference's."""
    kw.setdefault("param_dtype", torch.bfloat16)
    if shards <= 1:
        return local_plan(**kw)
    return ShardPlan(tp=shards, **kw)


@dataclass(frozen=True)
class EngineSpec:
    """Declarative description of one serving engine.

    ``variants`` / ``drafters`` are ``(name, ArchConfig)`` pairs: their
    models are built under the spec's plan and registered on the engine,
    the i-th variant's parameters from seed ``seed + 10 + i`` and the
    i-th drafter's from ``seed + 100 + i``, as the reference's.  ``draft``
    is None, ``"ngram"`` or the name of one of ``drafters``.  Every field
    serves at every shard count ``shard_compat`` admits: chunked prefill,
    prefix sharing, speculation and MoE configs included."""
    cfg: ArchConfig
    shards: int = 1
    max_seq: int = 512
    n_slots: int = 8
    max_batch: int | None = None        # default: n_slots
    block_size: int = 16
    n_blocks: int | None = None
    horizon: int = 1
    prefill_chunk: int | None = None
    prefix_share: bool = False
    spec_k: int = 4
    draft: str | None = None            # None | "ngram" | a drafters name
    ngram: int = 2
    seed: int = 0
    param_dtype: torch.dtype = torch.bfloat16
    variants: tuple = ()                # ((name, ArchConfig), ...)
    drafters: tuple = ()                # ((name, ArchConfig), ...)

    def replace(self, **kw) -> "EngineSpec":
        return dataclasses.replace(self, **kw)

    def plan(self) -> ShardPlan:
        return serving_plan(self.shards, param_dtype=self.param_dtype)

    def validate(self) -> None:
        for name, cfg in (("full", self.cfg), *self.variants,
                          *self.drafters):
            err = shard_compat(self.shards, cfg)
            if err is not None:
                raise ValueError(f"EngineSpec ({name!r}): {err}")

    def _materialize(self, cfg: ArchConfig, plan: ShardPlan, seed: int,
                     device):
        model = Model(cfg, plan, device)
        return model, model.init(
            torch.Generator(device=device).manual_seed(seed))

    def build(self, *, device="cuda", share: Engine | None = None) -> Engine:
        """Build (plan, seeded parameters, pool, Engine) on ``device``.
        The engine's sampling seed is the spec's ``seed``, as the
        reference's.

        ``share=`` aliases an existing engine's model and parameter
        registries (it must come from a spec with the same cfg, shards,
        variants and drafters) and builds on its device, so N engines hold
        one copy of the weights."""
        self.validate()
        plan = self.plan()
        if share is not None:
            model, params = share.variants["full"]
        else:
            model, params = self._materialize(self.cfg, plan, self.seed,
                                              device)
        eng = Engine(
            model, params, max_seq=self.max_seq, n_slots=self.n_slots,
            knobs=EngineKnobs(max_batch=self.max_batch or self.n_slots),
            paged=True, block_size=self.block_size, n_blocks=self.n_blocks,
            horizon=self.horizon, prefill_chunk=self.prefill_chunk,
            prefix_share=self.prefix_share, spec_k=self.spec_k,
            draft=self.draft if self.draft in (None, "ngram") else None,
            ngram=self.ngram, seed=self.seed)
        if share is not None:
            for name, (m, p) in share.variants.items():
                if name != "full":
                    eng.add_variant(name, m, p)
            for name, (m, p) in share.drafters.items():
                eng.add_drafter(name, m, p)
        else:
            for i, (name, vcfg) in enumerate(self.variants):
                eng.add_variant(name, *self._materialize(vcfg, plan,
                                                         self.seed + 10 + i,
                                                         device))
            for i, (name, dcfg) in enumerate(self.drafters):
                eng.add_drafter(name, *self._materialize(dcfg, plan,
                                                         self.seed + 100 + i,
                                                         device))
        if self.draft is not None and self.draft != "ngram":
            eng.set_drafter(self.draft)
        eng.spec = self
        return eng
