"""Registry of the serving hot paths, each traced at smoke geometry (port
of ``repro.analysis.iraudit.registry``).

Each :class:`Entrypoint` names one hot path and builds, over a fixed
smoke-scale geometry (llama2-7b's smoke config, bf16 parameters, 3
lanes, ``max_seq`` 64, ``block_size`` 8, horizon 4, chunk 16, bucket 16:
the reference's), the body that runs it, on the audit's device.  The
captured paths are audited through the very bodies ``serving/graphs.py``
captures (``horizon_program``, ``spec_program``, ``chunk_program``,
``slot_program``), built by those functions, never through a copy; the
eager paths (the decode step alone, ragged prefill) through the model's
own methods, the pool's device functions through ``serving/kvcache.py``'s
and the kernels through ``kernels.ops``.

The reference's ``@1x2`` entries run under a 2-device mesh and need two
visible devices.  The port keeps every stripe on one card
(``models/sharding.py``), so its shards-2 entries run on the one device
the others run on.  ``decode_slot_step`` (the slot pool's captured step)
has no counterpart in the reference's registry.

The audit runs on the card unless the caller asks for another device.
On the meta device (the mode for a machine without a card) nothing is
allocated and no numerics run; on the CPU the bodies run at smoke size,
but every tensor is a host tensor there, so IR001's host-copy checks are
off; on a card ``chip_smoke.py`` phase 16 runs each body eagerly and then
captures it, and the audit's verdict must agree with the capture's.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.analysis.op_cost import _tensors as _leaves
from repro_torch.configs import get_config
from repro_torch.models import build_model, local_plan


class AuditContext:
    """Smoke-scale serving geometry shared by every registered entry, on
    ``device`` (the card unless ``"meta"`` or ``"cpu"`` is asked for).  ``shards > 1`` builds
    the same geometry over a block-striped pool (``tp = shards``; the
    pool's block count rounded up to a multiple of it)."""

    def __init__(self, config_name: str = "llama2-7b", *, n_lanes: int = 3,
                 max_seq: int = 64, block_size: int = 8, horizon: int = 4,
                 chunk: int = 16, bucket: int = 16, shards: int = 1,
                 device="cuda"):
        self.config_name = config_name
        self.n_lanes = n_lanes
        self.max_seq = max_seq
        self.block_size = block_size
        self.horizon = horizon
        self.chunk = chunk
        self.bucket = bucket
        self.shards = shards
        self.device = torch.device(device)
        self.blocks_per_seq = max_seq // block_size
        self.n_blocks = n_lanes * self.blocks_per_seq + 1   # + parking block
        if self.n_blocks % max(shards, 1):
            self.n_blocks += shards - self.n_blocks % shards
        self.cfg = get_config(config_name).smoke_config()
        self.model = build_model(
            self.cfg, local_plan(param_dtype=torch.bfloat16, tp=shards),
            device=self.device)
        gen = torch.Generator(device=self.device.type
                              if self.device.type == "cuda" else "cpu")
        self.params = self.model.init(gen.manual_seed(0))
        self.cache = self.model.init_paged_cache(self.n_blocks, block_size)

    # -- common operands -----------------------------------------------------
    def i32(self, *shape, fill=0) -> torch.Tensor:
        return torch.full(shape, fill, dtype=torch.int32, device=self.device)

    def tables(self) -> torch.Tensor:
        """Each lane's table over its own blocks (block 0 parks)."""
        n, T = self.n_lanes, self.blocks_per_seq
        return (torch.arange(n * T, dtype=torch.int32, device=self.device)
                .reshape(n, T) + 1)

    def positions(self) -> torch.Tensor:
        """Lanes part-way through their tables."""
        return torch.arange(self.n_lanes, dtype=torch.int32,
                            device=self.device) * 7 + 5

    def tensors(self):
        return self.params, self.cache

    def pools(self) -> list:
        return list(_leaves(self.cache))


@dataclass(frozen=True)
class Built:
    """One entry's body and what the audit reads beside it: ``inplace()``
    the tensors the body must write in place (pool and state leaves),
    ``args()`` its inputs, ``outs()`` what it writes for its caller."""
    body: Callable
    inplace: Callable = list
    args: Callable = list
    outs: Callable = list
    tensors: Callable | None = None


@dataclass(frozen=True)
class Entrypoint:
    """One audited hot path.

    ``build(ctx)`` returns the ``Built`` body.  ``f32_dot_ok`` marks
    entries whose graphs deliberately run f32 matmuls (the reference's
    Pallas kernel bodies; in the port a kernel call is one unit, so no
    entry needs it but the kernel entries keep the reference's flag).
    ``const_cap_bytes`` bounds the constants the body makes from Python
    values on every call."""
    name: str
    kind: str                    # "model" | "pool" | "kernel"
    build: Callable
    f32_dot_ok: bool = False
    const_cap_bytes: int = 2048
    doc: str = ""


@dataclass
class EntryAudit:
    """One traced entry, input to the invariants and the cost row."""
    entry: Entrypoint
    trace: object
    inplace_before: list
    inplace_after: list
    arg_bytes: int
    out_bytes: int
    built: Built = field(repr=False, default=None)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# builders: each hot path as serving runs it
# ---------------------------------------------------------------------------

def _b_decode_step(ctx: AuditContext) -> Built:
    tok, pos, tab = ctx.i32(ctx.n_lanes), ctx.positions(), ctx.tables()

    def body():
        with torch.inference_mode():
            return ctx.model.decode_step_paged(ctx.params, ctx.cache, tok,
                                               pos, tab)[0]

    return Built(body, ctx.pools, lambda: [tok, pos, tab],
                 tensors=ctx.tensors)


def _program_built(prog, ctx: AuditContext, run) -> Built:
    bufs = prog.bufs

    def body():
        with torch.inference_mode():
            return run(prog)

    return Built(body, lambda: ctx.pools() + list(bufs.values()),
                 lambda: list(bufs.values()), tensors=ctx.tensors)


def _fill_lanes(ctx: AuditContext, bufs: dict) -> None:
    bufs["positions"].copy_(ctx.positions())
    bufs["tables"].copy_(ctx.tables())
    bufs["active"].fill_(True)
    bufs["budgets"].fill_(ctx.horizon * 2)
    bufs["eos"].fill_(-1)


def _b_decode_multi(ctx: AuditContext, *, sampled: bool) -> Built:
    from repro_torch.serving import graphs as G
    prog = G.horizon_program(ctx.model, ctx.tensors, ctx.n_lanes,
                             ctx.blocks_per_seq, max_len=ctx.max_seq,
                             sampled=sampled, capture=False)
    _fill_lanes(ctx, prog.bufs)
    if sampled:
        prog.bufs["temps"].fill_(0.8)
        prog.bufs["top_ks"].fill_(40)
    return _program_built(prog, ctx,
                          lambda p: G.run_horizon(p, ctx.horizon))


def _b_decode_spec(ctx: AuditContext, *, spec_k: int) -> Built:
    from repro_torch.serving import graphs as G
    prog = G.spec_program(ctx.model, None,
                          lambda: (ctx.params, ctx.cache, None, None),
                          ctx.n_lanes, ctx.blocks_per_seq, ctx.max_seq + 1,
                          spec_k=spec_k, max_len=ctx.max_seq, ngram=2,
                          capture=False)
    _fill_lanes(ctx, prog.bufs)
    return _program_built(prog, ctx, lambda p: G.run_spec(p, ctx.horizon))


def _b_prefill_ragged(ctx: AuditContext) -> Built:
    tokens = ctx.i32(ctx.n_lanes, ctx.bucket, fill=3)
    lengths = torch.tensor([ctx.bucket, ctx.bucket - 5, 3],
                           dtype=torch.int32, device=ctx.device)

    def body():
        with torch.inference_mode():
            return ctx.model.prefill_ragged(ctx.params, tokens, lengths)

    return Built(body, list, lambda: [tokens, lengths], tensors=ctx.tensors)


def _b_prefill_chunk(ctx: AuditContext) -> Built:
    from repro_torch.serving import graphs as G
    prog = G.chunk_program(ctx.model, ctx.tensors, ctx.n_lanes, ctx.chunk,
                           ctx.blocks_per_seq, capture=False)
    prog.bufs["starts"].copy_(ctx.positions() - 5)
    prog.bufs["lens"].fill_(ctx.chunk)
    prog.bufs["tables"].copy_(ctx.tables())
    return _program_built(prog, ctx, lambda p: p.run())


def _b_slot_step(ctx: AuditContext) -> Built:
    from repro_torch.serving import graphs as G
    cache = ctx.model.init_cache(ctx.n_lanes, ctx.max_seq,
                                 device=ctx.device)
    tensors = lambda: (ctx.params, cache)  # noqa: E731
    prog = G.slot_program(ctx.model, tensors, ctx.n_lanes, sampled=False,
                          capture=False)
    prog.bufs["positions"].copy_(ctx.positions())
    bufs = prog.bufs

    def body():
        with torch.inference_mode():
            prog.run()

    return Built(body, lambda: list(_leaves(cache)) + list(bufs.values()),
                 lambda: list(bufs.values()), tensors=tensors)


def _b_paged_insert(ctx: AuditContext) -> Built:
    from repro_torch.serving.kvcache import _paged_insert
    with torch.inference_mode():
        _, prefill_cache = ctx.model.prefill_ragged(
            ctx.params, ctx.i32(ctx.n_lanes, ctx.bucket),
            ctx.i32(ctx.n_lanes, fill=ctx.bucket))
    n = -(-ctx.bucket // ctx.block_size)
    idx = torch.arange(1, n + 1, dtype=torch.long, device=ctx.device)

    def body():
        with torch.inference_mode():
            _paged_insert(ctx.cache, prefill_cache, idx, 1)

    return Built(body, ctx.pools, lambda: [idx], tensors=ctx.tensors)


def _b_mirror_row(ctx: AuditContext) -> Built:
    # the device mirror's adopt path: the decode loop's device state copied
    # into the pool's mirror, which keeps its address
    from repro_torch.serving.kvcache import PagedCachePool
    pool = PagedCachePool(ctx.model, ctx.n_lanes, ctx.max_seq,
                          block_size=ctx.block_size)
    mirror = pool._device("positions")
    state = ctx.positions()

    def body():
        pool.adopt_device("positions", state)

    return Built(body, lambda: [mirror], lambda: [state],
                 tensors=lambda: (mirror,))


def _b_bad_lane_scan(ctx: AuditContext) -> Built:
    from repro_torch.serving.kvcache import _bad_lane_scan
    tab, pos = ctx.tables(), ctx.positions()
    mask = torch.ones(ctx.n_lanes, dtype=torch.bool, device=ctx.device)

    def body():
        return _bad_lane_scan(ctx.cache, tab, pos, mask)

    return Built(body, list, lambda: [tab, pos, mask], tensors=ctx.tensors)


def _b_kernel_decode(ctx: AuditContext) -> Built:
    from repro_torch.kernels import ops
    pool = ctx.cache["attn"]["k"][0]            # (n_blocks, bs, K, hd)
    q = torch.zeros(ctx.n_lanes, ctx.cfg.n_heads, ctx.cfg.head_dim,
                    dtype=torch.bfloat16, device=ctx.device)
    tab, pos = ctx.tables(), ctx.positions()

    def body():
        return ops.paged_decode_attention(q, pool, pool, tab, pos)

    return Built(body, list, lambda: [q, pool, tab, pos],
                 tensors=ctx.tensors)


def _b_kernel_prefill(ctx: AuditContext) -> Built:
    from repro_torch.kernels import ops
    pool = ctx.cache["attn"]["k"][0]
    q = torch.zeros(ctx.n_lanes, ctx.chunk, ctx.cfg.n_heads,
                    ctx.cfg.head_dim, dtype=torch.bfloat16,
                    device=ctx.device)
    tab, starts = ctx.tables(), ctx.positions() - 5

    def body():
        return ops.paged_prefill_attention(q, pool, pool, tab, starts)

    return Built(body, list, lambda: [q, pool, tab, starts],
                 tensors=ctx.tensors)


@functools.lru_cache(maxsize=None)
def _sharded_ctx(shards: int, device: str) -> AuditContext:
    """One shards-``shards`` context per device, built on first use."""
    return AuditContext(shards=shards, device=device)


def _b_sharded(builder, shards: int):
    def build(ctx: AuditContext) -> Built:
        return builder(_sharded_ctx(shards, str(ctx.device)))
    return build


ENTRYPOINTS: tuple = (
    Entrypoint("decode_step_paged", "model", _b_decode_step,
               doc="single-token paged decode (the horizon's inner step)"),
    Entrypoint("decode_multi_paged_h4", "model",
               functools.partial(_b_decode_multi, sampled=False),
               doc="the captured horizon step (horizon_program), greedy, "
                   "run 4 times with its per-step output copies"),
    # the sampled and speculative steps make vocab-sized index ramps
    # (top-k, one-hot) on the device every step: 8.8 and 17-18 KB at
    # smoke size, no host data; the caps admit them
    Entrypoint("decode_multi_sampled_h4", "model",
               functools.partial(_b_decode_multi, sampled=True),
               const_cap_bytes=16384,
               doc="the captured horizon step with temperature/top-k/seed "
                   "lanes, run 4 times"),
    Entrypoint("decode_spec_paged_k1", "model",
               functools.partial(_b_decode_spec, spec_k=1),
               const_cap_bytes=32768, doc="the captured speculative round (spec_program), n-gram "
                   "drafts, K=1, 4 rounds"),
    Entrypoint("decode_spec_paged_k4", "model",
               functools.partial(_b_decode_spec, spec_k=4),
               const_cap_bytes=32768, doc="the captured speculative round, n-gram drafts, K=4, 4 "
                   "rounds"),
    Entrypoint("prefill_ragged_b16", "model", _b_prefill_ragged,
               doc="batched ragged prefill at bucket 16 (eager)"),
    Entrypoint("prefill_chunk_paged_c16", "model", _b_prefill_chunk,
               doc="the captured chunk tick (chunk_program), chunk 16"),
    Entrypoint("decode_slot_step", "model", _b_slot_step,
               doc="the captured slot decode step (slot_program); no "
                   "reference entry"),
    Entrypoint("pool_paged_insert", "pool", _b_paged_insert,
               doc="scatter one prefilled request into its pool blocks"),
    Entrypoint("pool_mirror_row", "pool", _b_mirror_row,
               doc="the device mirror's adopt path (PagedCachePool."
                   "adopt_device), in place"),
    Entrypoint("pool_bad_lane_scan", "pool", _b_bad_lane_scan,
               doc="NaN/Inf quarantine sweep over written KV positions"),
    Entrypoint("kernel_paged_decode", "kernel", _b_kernel_decode,
               f32_dot_ok=True, doc="kernel 2 (ops.paged_decode_attention)"),
    Entrypoint("kernel_paged_prefill", "kernel", _b_kernel_prefill,
               f32_dot_ok=True, doc="kernel 3 (ops.paged_prefill_attention)"),
    Entrypoint("decode_step_paged@1x2", "model",
               _b_sharded(_b_decode_step, 2),
               doc="paged decode over a 2-stripe pool (kernel 4 per stripe, "
                   "combine_lse), on one device"),
    Entrypoint("prefill_chunk_paged_c16@1x2", "model",
               _b_sharded(_b_prefill_chunk, 2),
               doc="the chunk tick over a 2-stripe pool (kernel 3's "
                   "owned/LSE form per stripe), on one device"),
)

ENTRYPOINTS_BY_NAME = {e.name: e for e in ENTRYPOINTS}


# ---------------------------------------------------------------------------
# synthetic faults: one small body per invariant, for the tests and for
# the card's check that the audit and a live capture agree
# ---------------------------------------------------------------------------

def synthetic(ctx: AuditContext, fault: str) -> Built:
    """A small body over ``ctx``'s model (embed, scale, a projection, a
    write into a pool leaf) with one fault: ``"item"`` (a scalar read back
    with ``.item()``), ``"host_built"`` (the pattern a capture once met
    in gemma-7b's ``Model._embed_inputs``: the scale as
    ``torch.tensor(..., device=)``,
    a host copy), ``"out_of_place"`` (the pool leaf replaced by an
    ``index_put`` result), ``"f32_matmul"`` (the projection on f32
    inputs), ``"const"`` (a 4 KiB constant made every call), or
    ``"clean"`` (none)."""
    import math

    from repro_torch.models import layers as L
    dev, dt = ctx.device, ctx.model.plan.compute_dtype
    params, d = ctx.params, ctx.cfg.d_model
    tok = torch.zeros(ctx.n_lanes, dtype=torch.int32, device=dev)
    pool = {"k": torch.zeros(2, 5, 8, 2, 16, dtype=torch.bfloat16,
                             device=dev)}
    w = params["layers"]["mlp"]["w_up"][0].to(dt)

    def body():
        x = L.take_embedding(params["embed"], tok).to(dt)
        if fault == "host_built":
            x = x * torch.tensor(math.sqrt(d), dtype=dt, device=dev)
        else:
            x = x * torch.full((), math.sqrt(d), dtype=dt, device=dev)
        if fault == "item":
            x = x + int(x.abs().sum().item())
        h = x.float() @ w.float() if fault == "f32_matmul" else x @ w
        if fault == "const":
            h = h + torch.full((h.shape[-1], 1024), 0.5, device=dev)[:, 0]
        if fault == "out_of_place":
            pool["k"] = pool["k"].index_put(
                (torch.zeros(1, dtype=torch.long, device=dev),),
                torch.ones(1, 5, 8, 2, 16, dtype=torch.bfloat16, device=dev))
        else:
            pool["k"][:, 0] += h.sum().to(torch.bfloat16)
        return h

    return Built(body, lambda: [pool["k"]], lambda: [tok],
                 tensors=lambda: (params, pool))


# each synthetic fault and the code that must flag it
SYNTHETIC_FAULTS = {"item": "IR001", "host_built": "IR001",
                    "out_of_place": "IR002", "f32_matmul": "IR003",
                    "const": "IR004", "clean": None}


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _storages(tensors) -> list:
    return [(id(t), t.untyped_storage()._cdata, tuple(t.shape), t.dtype)
            for t in tensors]


def audit_built(entry: Entrypoint, built: Built, device) -> EntryAudit:
    """Trace one built body once under the audit's modes."""
    from repro_torch.analysis.iraudit.census import trace
    before = _storages(built.inplace())
    live = list(built.args()) + list(built.inplace()) + (
        list(_leaves(built.tensors())) if built.tensors else [])
    tr = trace(built.body, device=device, live=live)
    return EntryAudit(entry=entry, trace=tr, inplace_before=before,
                      inplace_after=_storages(built.inplace()),
                      arg_bytes=_bytes(built.args()),
                      out_bytes=_bytes(built.outs()), built=built)


def audit_entry(entry: Entrypoint, ctx: AuditContext) -> EntryAudit:
    """Build and trace one entry on ``ctx``'s device."""
    return audit_built(entry, entry.build(ctx), ctx.device)


__all__ = ["AuditContext", "Built", "ENTRYPOINTS", "ENTRYPOINTS_BY_NAME",
           "EntryAudit", "Entrypoint", "SYNTHETIC_FAULTS", "audit_built",
           "audit_entry", "synthetic"]
