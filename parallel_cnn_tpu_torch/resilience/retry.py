"""Seeded, capped exponential backoff (the port's copy of ``RetryPolicy``
from ``parallel_cnn_tpu/resilience/retry.py``; the closed-loop load
generator retries shed requests with it)."""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic (seeded) jitter.

    The k-th delay is ``min(base_delay * multiplier**k, max_delay)``
    scaled by a jitter factor drawn uniformly from
    ``[1 - jitter, 1 + jitter]`` using ``random.Random(seed)`` — the same
    policy always produces the same delay sequence.
    """

    attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be non-negative")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")

    def delays(self) -> Iterator[float]:
        """The (attempts - 1) sleep durations between attempts."""
        rng = random.Random(self.seed)
        for k in range(self.attempts - 1):
            d = min(self.base_delay * self.multiplier**k, self.max_delay)
            yield d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))
