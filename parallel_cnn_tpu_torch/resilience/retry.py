"""Seeded, capped exponential backoff (the port's copy of ``RetryPolicy``
and ``retry_call`` from ``parallel_cnn_tpu/resilience/retry.py``): the
closed-loop load generators retry shed requests and transport errors with
it, and the serve supervisor bounds an endpoint's respawn with it."""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Iterator, Tuple, Type

log = logging.getLogger(__name__)


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

    def decorrelated(self, rank: int = 0) -> "RetryPolicy":
        """Per-rank decorrelation of the SAME policy envelope.

        N clients recovering from one outage all build the identical
        policy, so plain ``delays()`` has them reconnect in lockstep. This
        derives a policy whose jitter stream is seeded by ``(seed, rank)``
        — deterministic per client (replayable), decorrelated across
        clients (no thundering herd). The backoff *envelope* — base,
        multiplier, and above all the ``max_delay`` cap — is unchanged;
        only the jitter draw differs.
        """
        if rank < 0:
            raise ValueError(f"rank must be >= 0, got {rank}")
        # Integer fold of (seed, rank) — stable across processes and
        # Python versions (no reliance on object hashing).
        derived = random.Random(self.seed * 1_000_003 + rank).getrandbits(32)
        return dataclasses.replace(self, seed=derived)


def retry_call(
    fn: Callable,
    *args,
    policy: RetryPolicy | None = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    describe: str | None = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying ``retry_on`` failures.

    Bounded by ``policy.attempts``; the final failure propagates
    unchanged. Pass ``sleep`` to intercept the backoff in tests.
    """
    policy = policy or RetryPolicy()
    delays = list(policy.delays())
    name = describe or getattr(fn, "__name__", repr(fn))
    for attempt in range(policy.attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt == policy.attempts - 1:
                raise
            d = delays[attempt]
            log.warning(
                "%s failed (attempt %d/%d, %s: %s); retrying in %.2fs",
                name, attempt + 1, policy.attempts, type(e).__name__, e, d,
            )
            sleep(d)
