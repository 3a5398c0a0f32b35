"""Port of ``repro.core.traces``: so far only ``_stable_seed``, which the
engine folds into per-request sampling seeds."""
from __future__ import annotations

import zlib


def _stable_seed(*parts) -> int:
    """Process-stable 32-bit seed for string-keyed traces.

    ``hash(str)`` is randomized per interpreter process, which made trace
    phases — and therefore every simulation metric — unreproducible across
    runs of the same seed.  CRC32 of the repr is stable everywhere.
    """
    return zlib.crc32(repr(parts).encode())
