"""Port of ``repro.core``: so far only ``traces._stable_seed``."""
