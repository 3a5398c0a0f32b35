"""Inference request / response records (port of ``repro.serving.request``)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

_ids = itertools.count()

#: terminal outcomes — mutually exclusive and exhaustive: a drained run
#: must leave every submitted request with exactly one of these.
OUTCOMES = ("accepted", "timed_out", "rejected")


@dataclass
class Request:
    prompt: list                 # token ids
    max_new_tokens: int = 32
    customer: str = "anon"       # KV-cache affinity key (paper §4.5 LB rule 1)
    arrival_s: float = 0.0
    req_id: int = field(default_factory=lambda: next(_ids))
    eos_id: int | None = None
    # sampling knobs: temperature <= 0 means exact greedy (argmax); top_k
    # <= 0 disables top-k truncation; seed None derives a deterministic
    # per-request seed from the engine seed + req_id (crc32 idiom)
    temperature: float = 0.0
    top_k: int = 0
    seed: int | None = None
    # resilience knobs: deadline_ms is relative to arrival_s (None == no
    # deadline); max_retries bounds quarantine/crash re-queues before the
    # request is rejected as retry-exhausted.
    deadline_ms: float | None = None
    max_retries: int = 3

    # filled during serving
    first_token_s: float | None = None
    finish_s: float | None = None
    output: list = field(default_factory=list)
    retries: int = 0
    outcome: str | None = None   # one of OUTCOMES once terminal

    def __post_init__(self):
        if self.deadline_ms is not None and self.deadline_ms <= 0.0:
            raise ValueError(
                f"deadline_ms must be None or > 0, got {self.deadline_ms}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")

    @property
    def done(self) -> bool:
        return self.finish_s is not None

    @property
    def deadline_s(self) -> float | None:
        """Absolute expiry time on the engine clock (None == never)."""
        if self.deadline_ms is None:
            return None
        return self.arrival_s + self.deadline_ms / 1000.0

    def finish(self, now: float, outcome: str) -> None:
        """Mark terminal exactly once; double-finish is a serving bug."""
        if outcome not in OUTCOMES:
            raise ValueError(
                f"unknown outcome {outcome!r}; expected one of {OUTCOMES}")
        if self.outcome is not None:
            raise RuntimeError(
                f"request {self.req_id} finished twice: "
                f"{self.outcome!r} then {outcome!r}")
        self.finish_s = now
        self.outcome = outcome

    def ttft(self) -> float | None:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    def tbt(self) -> float | None:
        """Mean time between output tokens."""
        if self.finish_s is None or len(self.output) < 2:
            return None
        return (self.finish_s - self.first_token_s) / (len(self.output) - 1)
