"""KV-cache pools for continuous batching (port of
``repro.serving.kvcache``).

``PagedCachePool``: one global block pool per layer (leaves ``(L,
n_blocks, block_size, K, hd)``), a free-list block allocator and a
per-lane block table mapping logical KV blocks to physical pool blocks
(under a sharded plan the block ids are striped over the ranks and
``n_blocks`` is rounded up to a multiple of them).  Admission writes
exactly the blocks a prompt occupies (or, for chunked prefill, claims them
for the chunks to fill), decode appends allocate
blocks on demand, and release returns blocks to the free list.  Physical
block 0 is the reserved *parking block*: idle lanes point their whole
table at it, so a fixed-width decode batch never reads unowned memory.
Blocks are refcounted: full prompt blocks are published in a blake2b
content-hash chain index so later prompts with the same head reuse them
(prefix sharing), and an admission claims the chain keys it will publish
so a same-wave duplicate waits and attaches instead of writing a copy.

``CachePool``: the slot pool, one contiguous ``max_seq`` cache (for RWKV6
the recurrent state) per slot; the fallback for cache families the block
pool cannot hold.

For speculative decode the paged pool also keeps each lane's sequence
history (``token_hist``, what n-gram drafting reads) and, with a model
drafter attached, a drafter KV pool of the same block geometry that rides
the same block tables and allocator (``attach_draft``).

The numpy arrays (tables, lengths, last tokens, history) are the source of
truth; ``tables()`` / ``positions()`` / ``last_tokens_dev()`` /
``hist_dev()`` return persistent device copies that are built once and
then updated in place, a row (or cell) at a time, as the allocator
mutates (each upload through ``analysis.lint.runtime.sanctioned``, the
reference's explicit ``device_put``).  After a decode horizon the engine
copies the loop's final device state into them with ``adopt_device``.
The pool itself is written in place (the reference donates it to a
jitted scatter).

Fault injection and the NaN guard: ``corrupt_lane`` poisons one physical
block with NaNs, ``bad_lanes`` finds the lanes whose written positions
hold a NaN or Inf, and ``scrub_lane`` zeroes a quarantined lane's blocks
before they return to the free list.  The scrub matters: the attention
kernels mask keys past a lane's length with -inf, but a NaN left in V
still turns ``0 * NaN`` into NaN for the next lane that reuses the block.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.analysis.lint.runtime import sanctioned, sanctioned_readback
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import Model
from repro_torch.serving.graphs import _leaves


class CachePool:
    """Slot pool: a layer-stacked ``(L, n_slots, max_seq, K, hd)`` cache,
    or for RWKV6 the recurrent state ``(L, n_slots, ...)``, one slot per
    request."""

    def __init__(self, model: Model, n_slots: int, max_seq: int):
        self.model = model
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.cache = model.init_cache(n_slots, max_seq, device=model.device)
        self.lengths = [0] * n_slots          # tokens written per slot
        self.free = list(range(n_slots))
        self.slot_of: dict[int, int] = {}      # req_id -> slot

    def has_free(self) -> bool:
        return bool(self.free)

    def insert(self, req_id: int, prefill_cache: dict, prompt_len: int) -> int:
        """Copy a single-request prefill cache (batch dim 1) into a free
        slot, cast to the pool's dtypes: a leaf whose trailing shape
        differs from the pool's (``(L, 1, S_prompt, K, hd)`` KV) fills the
        first ``S_prompt`` positions, any other (the RWKV state) the whole
        slot."""
        slot = self.free.pop()

        def put_leaf(dst, src):
            if dst.dim() >= 3 and src.shape[2:] != dst.shape[2:]:
                dst[:, slot, : src.shape[2]] = src[:, 0].to(dst.dtype)
            else:
                dst[:, slot] = src[:, 0].to(dst.dtype)

        tree_map(put_leaf, self.cache, prefill_cache)
        self.lengths[slot] = prompt_len
        self.slot_of[req_id] = slot
        return slot

    def release(self, req_id: int) -> None:
        slot = self.slot_of.pop(req_id)
        self.lengths[slot] = 0
        self.free.append(slot)

    def positions(self) -> torch.Tensor:
        """Next write position per slot (parked slots write at 0, which is
        always overwritten by the next prefill insert)."""
        with sanctioned():
            return torch.tensor(self.lengths, dtype=torch.int32,
                                device=self.model.device)

    def advance(self, active_slots: list) -> None:
        for s in active_slots:
            self.lengths[s] += 1


def _poison_block(cache: dict, blk: int) -> None:
    """Overwrite one physical block with NaNs in every leaf, in place
    (fault injection: simulated KV memory corruption)."""
    for leaf in _leaves(cache):
        leaf[:, blk] = float("nan")


def _zero_blocks(cache: dict, blk_ids: torch.Tensor) -> None:
    """Scrub the indexed physical blocks back to zero in place (quarantine
    cleanup).  A freed NaN block reused as a decode append block is only
    partly overwritten, and masked attention still folds the residue in
    as ``0 * NaN``, so poisoned blocks must be back in the pool's pristine
    (zero) state before they re-enter the free list."""
    for leaf in _leaves(cache):
        leaf[:, blk_ids] = 0


def _bad_lane_scan(cache: dict, tables: torch.Tensor, lengths: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Per-lane NaN/Inf detector over the *written* KV positions.

    The reference gathers each lane's logical blocks (``leaf[:, tables]``,
    ``(L, B, P, bs, ...)``), a copy of every active lane's KV.  Here each
    layer of each leaf is reduced over its trailing dims to one flag per
    physical (block, position), the flags are or-ed over layers and
    leaves, and only those ``(n_blocks, bs)`` flags are gathered through
    the tables: the same answer without the copy.  ``isfinite`` reads the
    bf16 pool directly.  Positions at or past ``lengths`` are ignored:
    append blocks reused from the free list may hold stale NaNs in slots
    decode has not written yet, which attention never reads."""
    bad = None
    for leaf in _leaves(cache):
        for layer in leaf:                        # (n_blocks, bs, ...)
            flags = (~torch.isfinite(layer)).flatten(2).any(dim=2)
            bad = flags if bad is None else bad | flags
    n_p, bs = tables.shape[1], bad.shape[1]
    g = bad[tables.long()]                        # (B, P, bs)
    pos = (torch.arange(n_p, device=g.device)[None, :, None] * bs
           + torch.arange(bs, device=g.device)[None, None, :])
    valid = pos < lengths[:, None, None]
    return (g & valid).flatten(1).any(dim=1) & mask


def _paged_insert(cache: dict, prefill_cache: dict, idx: torch.Tensor,
                  row: int) -> None:
    """Scatter row ``row`` of a layer-stacked prefill cache (leaves
    ``(L, B, S_pad, K, hd)``) into the physical blocks ``idx`` (a device
    tensor of block ids) of ``cache``, in place."""
    n = idx.shape[0]
    for name, dst in cache["attn"].items():
        bs = dst.shape[2]
        seq = prefill_cache["attn"][name][:, row]           # (L, S_pad, K, hd)
        need = n * bs
        if seq.shape[1] < need:
            seq = torch.nn.functional.pad(
                seq, (0, 0, 0, 0, 0, need - seq.shape[1]))
        seq = seq[:, :need].reshape((dst.shape[0], n, bs) + dst.shape[3:])
        dst[:, idx] = seq.to(dst.dtype)


def _chain_key(prev: bytes, tokens) -> bytes:
    """Collision-resistant running hash over block-sized token chunks."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class PagedCachePool:
    """Global block-pool KV cache with per-request block tables."""

    def __init__(self, model: Model, n_lanes: int, max_seq: int, *,
                 block_size: int = 16, n_blocks: int | None = None,
                 dtype=torch.bfloat16):
        self.device = model.device
        self.n_lanes = n_lanes              # fixed decode-batch width
        self.max_seq = max_seq
        self.block_size = block_size
        self.blocks_per_seq = -(-max_seq // block_size)
        # +1: block 0 is the reserved parking block, never allocated
        self.n_blocks = n_blocks if n_blocks is not None \
            else 1 + n_lanes * self.blocks_per_seq
        # a sharded pool stripes contiguous block-id ranges over the ranks;
        # round up so every rank owns an equal stripe (the extra blocks
        # just enlarge the free list)
        self.shards = model.plan.tp \
            if model.plan.paged_pool_sharded(model.cfg) else 1
        if self.n_blocks % self.shards:
            self.n_blocks += self.shards - self.n_blocks % self.shards
        self.cache = model.init_paged_cache(self.n_blocks, block_size, dtype)
        self.free_blocks = list(range(self.n_blocks - 1, 0, -1))
        self.free_lanes = list(range(n_lanes - 1, -1, -1))
        self.lane_of: dict[int, int] = {}    # req_id -> lane
        self.blocks_of: dict[int, list] = {}  # req_id -> physical block ids
        self.block_tables = np.zeros((n_lanes, self.blocks_per_seq), np.int32)
        self.lengths = np.zeros(n_lanes, np.int32)  # tokens written per lane
        self.last_tokens = np.zeros(n_lanes, np.int32)  # next decode input
        # refcounts + prefix-sharing index; the index is a multimap of the
        # live physical copies of each content chunk
        self.ref = np.zeros(self.n_blocks, np.int32)
        self.prefix_index: dict[bytes, list] = {}
        self.key_of: dict[int, bytes] = {}   # phys block -> its chain key
        self.shared_block_hits = 0           # blocks reused via the index
        # pending-share dedup: chain keys an in-flight prefill will publish
        # once it completes
        self.pending_index: dict[bytes, int] = {}   # chain key -> req_id
        self.pending_of: dict[int, list] = {}       # req_id -> its keys
        # distinct admissions that deferred to attach to an in-flight
        # prefill (counted by the engine once per waiting request)
        self.pending_share_waits = 0
        # speculative decode: per-lane sequence history (token_hist[l, i] =
        # i-th sequence token; width max_seq + 1 so the token AT max_seq's
        # write position still has a slot) + optional drafter KV pool
        self.token_hist = np.zeros((n_lanes, max_seq + 1), np.int32)
        self.draft_cache: dict | None = None
        self._dev: dict[str, torch.Tensor] = {}       # device mirrors

    # -- device mirrors ----------------------------------------------------
    def _host_of(self, name: str) -> np.ndarray:
        return {"tables": self.block_tables, "positions": self.lengths,
                "last_tokens": self.last_tokens,
                "hist": self.token_hist}[name]

    def _device(self, name: str) -> torch.Tensor:
        if name not in self._dev:
            with sanctioned():
                self._dev[name] = torch.from_numpy(
                    self._host_of(name).copy()).to(self.device)
        return self._dev[name]

    def mirror_write(self, name: str, lane: int,
                     pos: int | None = None) -> None:
        """Replay row ``lane`` (or cell ``(lane, pos)``) of a host array
        into its device copy (a copy not built yet is built whole on next
        access)."""
        dev = self._dev.get(name)
        if dev is None:
            return
        with sanctioned():
            if pos is not None:
                dev[lane, pos] = int(self._host_of(name)[lane, pos])
                return
            row = self._host_of(name)[lane]
            if np.ndim(row) == 0:
                dev[lane] = int(row)
            else:
                dev[lane].copy_(torch.from_numpy(np.ascontiguousarray(row)))

    def adopt_device(self, name: str, arr: torch.Tensor) -> None:
        """Copy a device array produced by the decode loop into the
        mirror, in place: the mirror keeps its address (the caller keeps
        the numpy host state in sync)."""
        self._device(name).copy_(arr)

    # -- allocator ---------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_admit(self, prompt_len: int) -> bool:
        """Lane + blocks for the prompt and its first decode append."""
        return (bool(self.free_lanes)
                and len(self.free_blocks) >= self.blocks_for(prompt_len + 1))

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - 1 - len(self.free_blocks)

    def utilization(self) -> float:
        return self.used_blocks / max(self.n_blocks - 1, 1)

    # -- prefix sharing ----------------------------------------------------
    def _chain(self, tokens: list, n: int):
        """The first ``n`` chain keys of ``tokens`` (one per full block)."""
        key = b""
        for i in range(n):
            key = _chain_key(key, tokens[i * self.block_size:
                                         (i + 1) * self.block_size])
            yield key

    def shared_prefix(self, tokens: list) -> list:
        """Physical blocks already holding a prefix of ``tokens``: the
        longest run of registered full blocks, leaving at least one token
        unshared so the admission still has last-token logits."""
        out = []
        for key in self._chain(tokens, (len(tokens) - 1) // self.block_size):
            copies = self.prefix_index.get(key)
            if not copies:
                break
            out.append(copies[-1])
        return out

    def register_prefix(self, req_id: int, tokens: list) -> None:
        """Publish a request's full, immutable prompt blocks in the prefix
        index (decode appends land past ``len(tokens)``)."""
        blks = self.blocks_of[req_id]
        for i, key in enumerate(self._chain(tokens,
                                            len(tokens) // self.block_size)):
            if blks[i] in self.key_of:
                continue                     # this copy already registered
            self.prefix_index.setdefault(key, []).append(blks[i])
            self.key_of[blks[i]] = key
        self._clear_pending(req_id)

    def register_pending(self, req_id: int, tokens: list) -> None:
        """Claim the chain keys this admission will publish when its
        prefill completes; first claimant wins, live keys need no claim."""
        keys = []
        for key in self._chain(tokens, len(tokens) // self.block_size):
            if key not in self.pending_index and key not in self.prefix_index:
                self.pending_index[key] = req_id
                keys.append(key)
        if keys:
            self.pending_of[req_id] = keys

    def pending_shared(self, tokens: list, *, have: int) -> bool:
        """True when an in-flight prefill owns the next shareable block of
        ``tokens`` (block ``have``, past what ``shared_prefix`` found)."""
        if have >= (len(tokens) - 1) // self.block_size:
            return False
        *_, key = self._chain(tokens, have + 1)
        return key in self.pending_index

    def _clear_pending(self, req_id: int) -> None:
        for key in self.pending_of.pop(req_id, ()):
            if self.pending_index.get(key) == req_id:
                del self.pending_index[key]

    # -- request lifecycle -------------------------------------------------
    def _scatter(self, prefill_cache: dict, blks: list, row: int,
                 cache: dict | None = None) -> None:
        """Write row ``row`` of a layer-stacked prefill cache (leaves
        ``(L, B, S_pad, K, hd)``) into the physical blocks ``blks`` of
        ``cache`` (default: the pool's): the block ids go to the device
        once, then ``_paged_insert``."""
        with sanctioned():
            idx = torch.tensor(blks, dtype=torch.long, device=self.device)
        _paged_insert(self.cache if cache is None else cache, prefill_cache,
                      idx, row)

    def insert(self, req_id: int, prefill_cache: dict, row: int,
               prompt_len: int) -> int:
        """Admit one request: allocate its prompt blocks and scatter row
        ``row`` of a (possibly batched) prefill cache into them."""
        n = self.blocks_for(prompt_len)
        if not self.free_lanes or len(self.free_blocks) < n:
            raise RuntimeError("admission not gated by can_admit")
        lane = self.free_lanes.pop()
        blks = [self.free_blocks.pop() for _ in range(n)]
        self.ref[blks] = 1
        self._scatter(prefill_cache, blks, row)
        self.block_tables[lane, :] = 0
        self.block_tables[lane, :n] = blks
        self.lengths[lane] = prompt_len
        self.lane_of[req_id] = lane
        self.blocks_of[req_id] = blks
        self.mirror_write("tables", lane)
        self.mirror_write("positions", lane)
        return lane

    def admit_prefill(self, req_id: int, ctx_len: int,
                      shared_blocks: list | None = None) -> int | None:
        """Chunked-prefill admission: a lane plus every block the context
        and its first decode append need, reusing the refcounted
        ``shared_blocks`` for the prompt head.  The chunks fill the rest;
        ``lengths`` starts at the shared length.  None when lanes or
        blocks are exhausted."""
        shared = list(shared_blocks or [])
        need_new = self.blocks_for(ctx_len + 1) - len(shared)
        if not self.free_lanes or len(self.free_blocks) < need_new:
            return None
        lane = self.free_lanes.pop()
        blks = shared + [self.free_blocks.pop() for _ in range(need_new)]
        for b in shared:
            self.ref[b] += 1
        self.ref[blks[len(shared):]] = 1
        self.shared_block_hits += len(shared)
        self.block_tables[lane, :] = 0
        self.block_tables[lane, : len(blks)] = blks
        self.lengths[lane] = len(shared) * self.block_size
        self.lane_of[req_id] = lane
        self.blocks_of[req_id] = blks
        self.mirror_write("tables", lane)
        self.mirror_write("positions", lane)
        return lane

    def ensure_append_blocks(self, req_ids: list, *, horizon: int = 1,
                             budgets: dict | None = None) -> list:
        """Make sure each request can write every token it may produce in
        the next ``horizon`` decode steps (positions ``lengths`` ..
        ``lengths + steps - 1``, ``steps`` capped by the per-request
        ``budgets`` and ``max_seq``); allocate fresh blocks at boundary
        crossings.  Returns the req_ids that could NOT get a block — the
        engine preempts those (release + recompute later)."""
        victims = []
        for rid in req_ids:
            lane = self.lane_of[rid]
            steps = horizon if budgets is None else \
                max(1, min(horizon, budgets.get(rid, horizon)))
            target = min(int(self.lengths[lane]) + steps, self.max_seq)
            need = self.blocks_for(target)
            blks = self.blocks_of[rid]
            grew = False
            while len(blks) < need:
                if len(blks) >= self.blocks_per_seq or not self.free_blocks:
                    victims.append(rid)
                    break
                blk = self.free_blocks.pop()
                self.ref[blk] = 1
                self.block_tables[lane, len(blks)] = blk
                blks.append(blk)
                grew = True
            if grew:
                self.mirror_write("tables", lane)
        return victims

    def release(self, req_id: int) -> None:
        # a preempted prefill frees its pending claims, or the requests
        # waiting on it would wait at the queue head forever
        self._clear_pending(req_id)
        lane = self.lane_of.pop(req_id)
        for b in reversed(self.blocks_of.pop(req_id)):
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self.free_blocks.append(b)
                key = self.key_of.pop(b, None)
                if key is not None:
                    copies = self.prefix_index[key]
                    copies.remove(b)
                    if not copies:
                        del self.prefix_index[key]
        self.free_lanes.append(lane)
        self.block_tables[lane, :] = 0       # park the lane on block 0
        self.lengths[lane] = 0
        self.mirror_write("tables", lane)
        self.mirror_write("positions", lane)

    # -- decode-step views -------------------------------------------------
    def positions(self) -> torch.Tensor:
        """Next write position per lane (parked lanes write into the
        parking block at offset 0; their output is discarded)."""
        return self._device("positions")

    def tables(self) -> torch.Tensor:
        return self._device("tables")

    def last_tokens_dev(self) -> torch.Tensor:
        """Per-lane next decode input token, device-resident."""
        return self._device("last_tokens")

    def set_length(self, lane: int, n: int) -> None:
        self.lengths[lane] = n
        self.mirror_write("positions", lane)

    def set_last_token(self, lane: int, tok: int) -> None:
        self.last_tokens[lane] = tok
        self.mirror_write("last_tokens", lane)

    # -- fault injection + NaN guard ----------------------------------------
    def corrupt_lane(self, lane: int, *, block_idx: int = 0) -> None:
        """Poison the lane's ``block_idx``-th logical block with NaNs
        (fault injection).  The parking block is refused, which keeps
        parked lanes clean: every idle lane aliases physical block 0."""
        phys = int(self.block_tables[lane, block_idx])
        if phys == 0:
            raise ValueError(
                f"lane {lane} block {block_idx} is the parking block — "
                f"the lane holds no data there to corrupt")
        _poison_block(self.cache, phys)

    def bad_lanes(self, mask) -> np.ndarray:
        """Which masked lanes hold NaN/Inf anywhere in their written KV:
        one scan and one host readback (the caller counts the sync); the
        engine runs it only while its guard is armed."""
        with sanctioned():
            mask = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        return sanctioned_readback(_bad_lane_scan(
            self.cache, self.tables(), self.positions(), mask))

    def scrub_lane(self, req_id: int) -> None:
        """Zero every block a quarantined request holds, so the blocks
        re-enter the free list pristine.  Sharers of a poisoned block are
        quarantined by the same scan (their tables alias the same physical
        block), so scrubbing under them is safe."""
        with sanctioned():
            ids = torch.tensor(self.blocks_of[req_id], dtype=torch.long,
                               device=self.device)
        _zero_blocks(self.cache, ids)
        if self.draft_cache is not None:
            _zero_blocks(self.draft_cache, ids)

    # -- speculative decode: sequence history + drafter KV ------------------
    def hist_dev(self) -> torch.Tensor:
        """Per-lane sequence history, device-resident (B, max_seq + 1)."""
        return self._device("hist")

    def set_hist(self, lane: int, tokens: list) -> None:
        """Install a lane's known sequence tokens (the prefill context).
        The spec loop appends emissions on the device and hands the result
        back through ``adopt_device("hist", ...)``."""
        row = np.zeros(self.token_hist.shape[1], np.int32)
        row[: len(tokens)] = tokens
        self.token_hist[lane] = row
        self.mirror_write("hist", lane)

    def set_hist_token(self, lane: int, pos: int, tok: int) -> None:
        self.token_hist[lane, pos] = tok
        self.mirror_write("hist", lane, pos)

    def attach_draft(self, model: Model, dtype=torch.bfloat16) -> None:
        """Allocate a drafter KV pool with the SAME block geometry, so the
        drafter rides this pool's block tables and allocator: every block
        id resolves to the request's slots in both caches at once."""
        self.draft_cache = None          # free the old pool first
        self.draft_cache = model.init_paged_cache(self.n_blocks,
                                                  self.block_size, dtype)

    def detach_draft(self) -> None:
        self.draft_cache = None

    def insert_draft(self, req_id: int, prefill_cache: dict, row: int,
                     prompt_len: int) -> None:
        """Scatter the DRAFTER's prefill KV for an already-admitted
        request into the drafter pool at the request's existing blocks."""
        blks = self.blocks_of[req_id][: self.blocks_for(prompt_len)]
        self._scatter(prefill_cache, blks, row, self.draft_cache)
