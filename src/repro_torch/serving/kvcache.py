"""Paged KV-cache pool for continuous batching (port of
``repro.serving.kvcache.PagedCachePool``, without prefix sharing or the
drafter pool).

One global block pool per layer (leaves ``(L, n_blocks, block_size, K,
hd)``), a free-list block allocator and a per-lane block table mapping
logical KV blocks to physical pool blocks.  Admission writes exactly the
blocks a prompt occupies, decode appends allocate blocks on demand, and
release returns blocks to the free list.  Physical block 0 is the reserved
*parking block*: idle lanes point their whole table at it, so a
fixed-width decode batch never reads unowned memory.

The numpy arrays (tables, lengths, last tokens) are the source of truth;
``tables()`` / ``positions()`` / ``last_tokens_dev()`` return persistent
device copies that are built once and then updated in place, a row at a
time, as the allocator mutates.  After a decode horizon the engine hands
the loop's final device state back with ``adopt_device``.  The pool itself
is written in place (the reference donates it to a jitted scatter).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Model


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
        self.cache = model.init_paged_cache(self.n_blocks, block_size, dtype)
        self.free_blocks = list(range(self.n_blocks - 1, 0, -1))
        self.free_lanes = list(range(n_lanes - 1, -1, -1))
        self.lane_of: dict[int, int] = {}    # req_id -> lane
        self.blocks_of: dict[int, list] = {}  # req_id -> physical block ids
        self.block_tables = np.zeros((n_lanes, self.blocks_per_seq), np.int32)
        self.lengths = np.zeros(n_lanes, np.int32)  # tokens written per lane
        self.last_tokens = np.zeros(n_lanes, np.int32)  # next decode input
        self.ref = np.zeros(self.n_blocks, np.int32)  # per-block refcount
        self._dev: dict[str, torch.Tensor] = {}       # device mirrors

    # -- device mirrors ----------------------------------------------------
    def _host_of(self, name: str) -> np.ndarray:
        return {"tables": self.block_tables, "positions": self.lengths,
                "last_tokens": self.last_tokens}[name]

    def _device(self, name: str) -> torch.Tensor:
        if name not in self._dev:
            self._dev[name] = torch.from_numpy(
                self._host_of(name).copy()).to(self.device)
        return self._dev[name]

    def mirror_write(self, name: str, lane: int) -> None:
        """Replay row ``lane`` of a host array into its device copy (a
        copy not built yet is built whole on next access)."""
        dev = self._dev.get(name)
        if dev is None:
            return
        row = self._host_of(name)[lane]
        if np.ndim(row) == 0:
            dev[lane] = int(row)
        else:
            dev[lane].copy_(torch.from_numpy(np.ascontiguousarray(row)))

    def adopt_device(self, name: str, arr: torch.Tensor) -> None:
        """Install a device array produced by the decode loop as the new
        mirror (the caller keeps the numpy host state in sync)."""
        self._dev[name] = arr

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

    # -- request lifecycle -------------------------------------------------
    def _scatter(self, prefill_cache: dict, blks: list, row: int) -> None:
        """Write row ``row`` of a layer-stacked prefill cache (leaves
        ``(L, B, S_pad, K, hd)``) into the physical blocks ``blks``."""
        n, bs = len(blks), self.block_size
        idx = torch.tensor(blks, dtype=torch.long, device=self.device)
        for name, dst in self.cache["attn"].items():
            seq = prefill_cache["attn"][name][:, row]       # (L, S_pad, K, hd)
            need = n * bs
            if seq.shape[1] < need:
                seq = torch.nn.functional.pad(
                    seq, (0, 0, 0, 0, 0, need - seq.shape[1]))
            seq = seq[:, :need].reshape((dst.shape[0], n, bs) + dst.shape[3:])
            dst[:, idx] = seq.to(dst.dtype)

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
        lane = self.lane_of.pop(req_id)
        for b in reversed(self.blocks_of.pop(req_id)):
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self.free_blocks.append(b)
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

    def set_last_token(self, lane: int, tok: int) -> None:
        self.last_tokens[lane] = tok
        self.mirror_write("last_tokens", lane)
