"""Runtime teeth for the port's tapaslint invariants (the counterpart of
``repro.analysis.lint.runtime``).

The static rules (TL002 host sync, TL003 capture hazard) catch the
*shapes* of hot-path bugs; this module catches the *behavior* on the card:

* :func:`no_implicit_syncs` — ``torch.cuda.set_sync_debug_mode("error")``
  inside the block: any operation that synchronizes the host with the
  device raises (``.item()``, a device-to-host copy, a copy from pageable
  host memory to the device, ``nonzero``).  The reference's transfer
  guard disallows implicit transfers; torch has no implicit transfers,
  so the port guards what such a transfer costs, the sync.
* :func:`sanctioned_readback` / :func:`sanctioned` — the engine's
  deliberate syncs: its one readback per drained horizon (counted in
  ``EngineStats.host_syncs``) and its staging uploads (the reference's
  ``_dev_i32`` / ``device_put``), with the guard lifted for exactly that
  copy, so the guard keeps teeth everywhere else.
* :func:`hot_path_guard` — the sync guard alone.  The reference's guard
  adds ``jax.checking_leaks()``; torch has no tracers to leak, so
  ``no_leaked_tracers`` has no counterpart here.
* :func:`capture_budget` — asserts that step programs captured at most
  ``budget`` new CUDA graphs across a region (``Program.captures``, the
  counterpart of the jit cache size); :func:`programs` lists an engine's
  live programs, :func:`capture_count` reads one.

On a host without CUDA (or before CUDA is initialised) there is no
device to sync with: the guards have nothing to guard and do nothing, and
the sanctioned helpers are plain copies.

Unlike the rest of ``repro_torch.analysis.lint`` (stdlib-only), this
module imports torch and numpy and is imported separately: by the serving
engine's staging and by the card's checks.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator

import numpy as np
import torch

__all__ = ["no_implicit_syncs", "hot_path_guard", "sanctioned",
           "sanctioned_readback", "capture_count", "programs",
           "capture_budget"]


@contextlib.contextmanager
def _sync_mode(mode: int) -> Iterator[None]:
    """``torch.cuda``'s sync debug mode set to ``mode`` (0 off, 2 error)
    inside the block, restored after.  Nothing to do on a host without
    CUDA, nor, to lift a guard, before CUDA is initialised (no guard can
    be on yet)."""
    idle = not torch.cuda.is_initialized() if mode == 0 \
        else not torch.cuda.is_available()
    if idle or torch.cuda.get_sync_debug_mode() == mode:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def no_implicit_syncs() -> Iterator[None]:
    """Raise on any host-device synchronization inside the block (a no-op
    on a host without CUDA)."""
    with _sync_mode(2):
        yield


@contextlib.contextmanager
def hot_path_guard() -> Iterator[None]:
    """The sync guard: the full hot-path discipline on the card.  (The
    reference's also checks for leaked tracers; torch has none.)  On a
    host without CUDA there is nothing to guard."""
    with no_implicit_syncs():
        yield


@contextlib.contextmanager
def sanctioned() -> Iterator[None]:
    """Lift an enclosing sync guard for a deliberate staging copy (the
    engine's and pool's uploads of host state)."""
    with _sync_mode(0):
        yield


def sanctioned_readback(x: torch.Tensor) -> np.ndarray:
    """Deliberate device->host sync, exempt from an enclosing guard.

    The serving engine budgets exactly one readback per drained horizon
    (``EngineStats.host_syncs``); it makes that readback through here so
    the guard keeps teeth everywhere else.
    """
    with sanctioned():
        return x.cpu().numpy()


def capture_count(prog: Any) -> int:
    """CUDA graphs a step program (``serving/graphs.py``'s ``Program``)
    has captured: the counterpart of a jitted function's cache size."""
    return int(prog.captures)


def programs(engine: Any) -> dict:
    """An engine's live step programs, by key (its ``programs`` dict), so
    a check can fence all of them at once:
    ``capture_budget(*programs(eng).values())``."""
    return dict(engine.programs)


@contextlib.contextmanager
def capture_budget(*progs: Any, budget: int = 0,
                   names: Callable[[Any], str] = lambda p: p.name
                   ) -> Iterator[None]:
    """Assert each program captures at most ``budget`` new graphs inside
    the block.

    Warm up (one call per live shape) *before* entering; a steady-state
    region then holds at delta 0.  A positive delta means a program was
    captured again mid-run (a leaf moved under it, or it was rebuilt) —
    the port's form of the PR 6 shrinking-tail recompile.
    """
    before = [capture_count(p) for p in progs]
    yield
    over = []
    for p, b in zip(progs, before):
        a = capture_count(p)
        if a - b > budget:
            over.append(f"{names(p)}: +{a - b} captures (budget {budget})")
    if over:
        raise AssertionError(
            "capture budget exceeded — a program was captured again inside "
            "the fenced region:\n  " + "\n  ".join(over))
