"""Load generator for the serving stack (the port's counterpart of
``parallel_cnn_tpu/serve/loadgen.py``): seeded closed- and open-loop
arrival patterns, client-side latency histograms, and the backoff-retry
client convention for Overloaded sheds.

Two canonical patterns (MLPerf-inference vocabulary):

- **closed loop** — ``concurrency`` synchronous clients, each submitting
  its next request the moment the previous one completes. Measures
  sustainable throughput: the offered load self-regulates to the
  service rate, so at sub-capacity sizing the shed rate must be 0.
  Sheds are retried with resilience.retry.RetryPolicy's seeded, capped
  exponential backoff (the house client convention).
- **open loop** — Poisson arrivals at ``rate`` req/s (seeded exponential
  gaps), submitted regardless of completions, like real user traffic
  that does not slow down because the server is busy. Measures latency
  under a fixed offered load — and, past capacity, exercises the shed
  path (open-loop clients do NOT retry; a shed is recorded and dropped,
  because retrying inside the generator would mutate the arrival
  process being measured).

Determinism: request payloads and arrival gaps derive from ``seed``
only, so a report is replayable bit-for-bit on the same machine state.

The socket transport (NetClient, closed loop over the wire) comes with
the network front door in a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from parallel_cnn_tpu_torch.resilience.retry import RetryPolicy
from parallel_cnn_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    DynamicBatcher,
    Overloaded,
)
from parallel_cnn_tpu_torch.utils.metrics import Histogram


@dataclasses.dataclass
class LoadgenReport:
    """What one loadgen run measured (client-side view)."""

    pattern: str
    requests: int
    completed: int
    shed: int          # Overloaded outcomes (closed loop: after retries)
    expired: int       # DeadlineExceeded outcomes
    errors: int
    seconds: float
    # Seconds per completed request, to its resolution: from submit
    # (closed loop) or from its due time on the arrival schedule (open
    # loop, so a stalled generator's delay counts against the server).
    latency: Histogram
    offered_rate: Optional[float] = None  # open loop only (req/s)

    @property
    def throughput(self) -> float:
        return self.completed / self.seconds if self.seconds > 0 else 0.0

    @property
    def shed_rate(self) -> float:
        return self.shed / self.requests if self.requests else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "pattern": self.pattern,
            "requests": self.requests,
            "completed": self.completed,
            "shed": self.shed,
            "expired": self.expired,
            "errors": self.errors,
            "seconds": round(self.seconds, 4),
            "throughput_rps": round(self.throughput, 2),
            "shed_rate": round(self.shed_rate, 4),
            "offered_rate": self.offered_rate,
            "latency_ms": self.latency.summary(scale=1e3),
        }


def make_samples(n: int, in_shape, seed: int = 0) -> np.ndarray:
    """Deterministic request payloads: n samples of ``in_shape``."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, *in_shape)).astype(np.float32)


def _wait_all(futures, counters, latency, lock):
    """Drain ``(t_due, future)`` pairs after the schedule. Latency runs to
    the future's resolution (``Future.t_done``), not to this observation,
    which comes only after the whole arrival schedule."""
    for t_due, fut in futures:
        try:
            fut.result(timeout=60.0)
            with lock:
                counters["completed"] += 1
            latency.record(fut.t_done - t_due)
        except DeadlineExceeded:
            with lock:
                counters["expired"] += 1
        except BaseException:  # noqa: BLE001 — loadgen must finish
            with lock:
                counters["errors"] += 1


def run_closed_loop(
    batcher: DynamicBatcher,
    samples: np.ndarray,
    *,
    n_requests: int,
    concurrency: int = 8,
    deadline_ms: Optional[float] = None,
    retry: Optional[RetryPolicy] = None,
    seed: int = 0,
) -> LoadgenReport:
    """``concurrency`` synchronous clients, ``n_requests`` total."""
    retry = retry or RetryPolicy(attempts=4, base_delay=0.002,
                                 max_delay=0.05, seed=seed)
    latency = Histogram()
    counters = {"completed": 0, "shed": 0, "expired": 0, "errors": 0}
    lock = threading.Lock()
    next_idx = [0]

    def client(cid: int) -> None:
        delays = list(
            dataclasses.replace(retry, seed=retry.seed + cid).delays()
        )
        while True:
            with lock:
                i = next_idx[0]
                if i >= n_requests:
                    return
                next_idx[0] += 1
            x = samples[i % len(samples)]
            t_sub = time.monotonic()
            fut = None
            for attempt in range(retry.attempts):
                try:
                    fut = batcher.submit(x, deadline_ms=deadline_ms)
                    break
                except Overloaded:
                    if attempt == retry.attempts - 1:
                        with lock:
                            counters["shed"] += 1
                    else:
                        time.sleep(delays[attempt])
            if fut is None:
                continue
            try:
                fut.result(timeout=60.0)
                with lock:
                    counters["completed"] += 1
                latency.record(fut.t_done - t_sub)
            except DeadlineExceeded:
                with lock:
                    counters["expired"] += 1
            except BaseException:  # noqa: BLE001
                with lock:
                    counters["errors"] += 1

    threads = [
        threading.Thread(target=client, args=(c,), daemon=True)
        for c in range(concurrency)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    return LoadgenReport(
        pattern="closed",
        requests=n_requests,
        completed=counters["completed"],
        shed=counters["shed"],
        expired=counters["expired"],
        errors=counters["errors"],
        seconds=seconds,
        latency=latency,
    )


def run_open_loop(
    batcher: DynamicBatcher,
    samples: np.ndarray,
    *,
    n_requests: int,
    rate: float,
    deadline_ms: Optional[float] = None,
    seed: int = 0,
) -> LoadgenReport:
    """Poisson arrivals at ``rate`` req/s; sheds recorded, not retried."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0 req/s, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    latency = Histogram()
    counters = {"completed": 0, "shed": 0, "expired": 0, "errors": 0}
    lock = threading.Lock()
    futures: List = []

    t0 = time.perf_counter()
    next_t = time.monotonic()
    for i in range(n_requests):
        next_t += gaps[i]
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            fut = batcher.submit(
                samples[i % len(samples)], deadline_ms=deadline_ms
            )
            futures.append((next_t, fut))
        except Overloaded:
            with lock:
                counters["shed"] += 1
    _wait_all(futures, counters, latency, lock)
    seconds = time.perf_counter() - t0
    return LoadgenReport(
        pattern="open",
        requests=n_requests,
        completed=counters["completed"],
        shed=counters["shed"],
        expired=counters["expired"],
        errors=counters["errors"],
        seconds=seconds,
        latency=latency,
        offered_rate=rate,
    )


def run(
    batcher: DynamicBatcher,
    *,
    pattern: str = "closed",
    n_requests: int = 512,
    concurrency: int = 8,
    rate: float = 500.0,
    deadline_ms: Optional[float] = None,
    seed: int = 0,
    samples: Optional[np.ndarray] = None,
) -> LoadgenReport:
    """One loadgen run against a batcher; see the pattern docs above."""
    if samples is None:
        samples = make_samples(
            min(n_requests, 64), batcher.pool.handle.in_shape, seed=seed
        )
    if pattern == "closed":
        return run_closed_loop(
            batcher, samples, n_requests=n_requests, concurrency=concurrency,
            deadline_ms=deadline_ms, seed=seed,
        )
    if pattern == "open":
        return run_open_loop(
            batcher, samples, n_requests=n_requests, rate=rate,
            deadline_ms=deadline_ms, seed=seed,
        )
    raise ValueError(f"unknown pattern {pattern!r} (closed or open)")
