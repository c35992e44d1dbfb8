"""Seeded, deterministic traffic scenarios with explicit SLO gates (the
port's copy of the in-process half of ``parallel_cnn_tpu/serve/scenarios.py``:
the same specs, schedules, drivers and gates).

loadgen.py answers "what does this stack do under a fixed arrival
pattern"; this module answers the robustness question — "does the stack
hold its SLO through realistic traffic shapes and injected faults".
Each scenario is a seeded arrival schedule driven through a live
batcher, measured client-side, cross-checked server-side against the
request-conservation law, and judged against explicit p99 / shed-rate
gates:

- **diurnal** — an inhomogeneous Poisson day: the rate sweeps
  trough → peak → trough sinusoidally (piecewise-homogeneous slices,
  seeded gaps). Proves the steady-state ladder: sub-capacity traffic
  must shed nothing at any point of the curve.
- **flash-crowd** — a base rate with a several-× arrival spike in the
  middle. Clients retry sheds with seeded backoff (a blocked client's
  behavior), so the shed gate measures *unrecovered* demand — the
  scenario the autoscaler's scale-up must drive back to 0.
- **slow-client** — closed-loop clients with think time between
  requests: offered load self-regulates (classic backpressure), the
  queue stays shallow, and the gates pin that nothing is shed and p99
  stays near service time.
- **chaos-kill** — steady traffic with ``kill-replica@SEQ`` armed: a
  replica dies mid-traffic and the failover path (evict → retry on
  survivor → respawn) must keep conservation AND the gates.
- **chaos-slow** — steady traffic with ``slow-replica@SEQ:MS`` armed:
  a straggler stalls one batch. With a stall chosen past the p99 gate
  this scenario MUST trip it — the anti-vacuity probe proving the gate
  can fail (chip_smoke.py's slo (e) asserts the trip).

Determinism: payloads, arrival gaps, priorities, and retry backoff all
derive from ``seed``. Wall-clock scheduling jitter moves individual
latencies, so gates carry CPU-scale headroom, but the request sequence
itself replays exactly.

The net suites (``NET_SCENARIOS``, ``run_net``: the same judgment over
the socket of the network front door) come with ROADMAP A12b.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from parallel_cnn_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    DynamicBatcher,
    Overloaded,
)
from parallel_cnn_tpu_torch.serve.loadgen import make_samples
from parallel_cnn_tpu_torch.utils.metrics import Histogram

#: Conservation-law keys (server-side stats delta must balance).
_COUNTER_KEYS = ("submitted", "completed", "shed", "expired", "failed")


@dataclasses.dataclass
class ScenarioReport:
    """One scenario run: client-side outcomes, server-side conservation,
    and the gate verdicts."""

    name: str
    seed: int
    requests: int          # logical requests (retries collapse into one)
    completed: int
    shed: int              # logical requests never accepted
    expired: int
    errors: int
    seconds: float
    latency: Histogram     # submit→result per completed request, seconds
    p99_gate_ms: float
    shed_gate: float
    server: Dict[str, int]          # stats delta over the run
    conservation_ok: bool

    @property
    def p99_ms(self) -> Optional[float]:
        p = self.latency.percentile(99)
        return p * 1e3 if p is not None else None

    @property
    def shed_rate(self) -> float:
        return self.shed / self.requests if self.requests else 0.0

    def gates(self) -> Dict[str, bool]:
        """Per-gate verdicts; the conservation law is always a gate."""
        p99 = self.p99_ms
        return {
            "p99": p99 is not None and p99 <= self.p99_gate_ms,
            "shed_rate": self.shed_rate <= self.shed_gate,
            "conservation": self.conservation_ok and self.errors == 0,
        }

    @property
    def passed(self) -> bool:
        return all(self.gates().values())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "seed": self.seed,
            "requests": self.requests,
            "completed": self.completed,
            "shed": self.shed,
            "expired": self.expired,
            "errors": self.errors,
            "seconds": round(self.seconds, 4),
            "p99_ms": self.p99_ms,
            "shed_rate": round(self.shed_rate, 4),
            "gates": self.gates(),
            "passed": self.passed,
            "server": self.server,
        }


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A named scenario: traffic builder + default gates."""

    name: str
    p99_ms: float            # default p99 gate (CPU-scale headroom)
    max_shed_rate: float     # default shed-rate gate
    retry: bool              # clients retry Overloaded sheds
    needs_chaos: Optional[str]   # required armed fault, or None
    phases: Tuple[Tuple[float, float], ...] = ()   # (seconds, req/s)
    closed: bool = False     # closed-loop (slow-client) instead of open
    n_requests: int = 0      # closed-loop volume
    concurrency: int = 0     # closed-loop client count
    think_ms: float = 0.0    # closed-loop think time per client


SCENARIOS: Dict[str, ScenarioSpec] = {
    # Sub-capacity sinusoid: 2 cycles, trough 100 → peak 500 req/s.
    "diurnal": ScenarioSpec(
        name="diurnal", p99_ms=250.0, max_shed_rate=0.0, retry=False,
        needs_chaos=None,
        phases=tuple(
            (0.08, 100.0 + 400.0 * 0.5 * (1.0 - math.cos(
                2.0 * math.pi * 2.0 * (i + 0.5) / 10.0)))
            for i in range(10)
        ),
    ),
    # 6× arrival spike mid-run; retries make shed-rate measure
    # *unrecovered* demand (what scale-up must drive to 0).
    "flash-crowd": ScenarioSpec(
        name="flash-crowd", p99_ms=500.0, max_shed_rate=0.0, retry=True,
        needs_chaos=None,
        phases=((0.2, 250.0), (0.25, 1500.0), (0.25, 250.0)),
    ),
    # Closed loop with think time: backpressure keeps the queue shallow.
    "slow-client": ScenarioSpec(
        name="slow-client", p99_ms=250.0, max_shed_rate=0.0, retry=False,
        needs_chaos=None, closed=True,
        n_requests=64, concurrency=4, think_ms=4.0,
    ),
    # Steady traffic through a mid-run replica death (failover path).
    "chaos-kill": ScenarioSpec(
        name="chaos-kill", p99_ms=500.0, max_shed_rate=0.0, retry=True,
        needs_chaos="kill-replica",
        phases=((0.5, 400.0),),
    ),
    # Steady traffic through a mid-run straggler stall; with a stall
    # beyond the p99 gate, this scenario MUST report passed=False.
    "chaos-slow": ScenarioSpec(
        name="chaos-slow", p99_ms=150.0, max_shed_rate=0.0, retry=True,
        needs_chaos="slow-replica",
        phases=((0.5, 400.0),),
    ),
}


def _phase_offsets(phases, rng) -> List[float]:
    """Absolute arrival offsets (seconds) for piecewise-homogeneous
    Poisson phases — seeded, so the schedule replays exactly."""
    out: List[float] = []
    t0 = 0.0
    for dur, rate in phases:
        if rate <= 0:
            raise ValueError(f"phase rate must be > 0, got {rate}")
        t = t0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t > t0 + dur:
                break
            out.append(t)
        t0 += dur
    return out


def _settled_delta(stats, before: Dict[str, int],
                   timeout_s: float = 5.0) -> Tuple[Dict[str, int], bool]:
    """Server-side counter delta once it balances. The last future can
    resolve a beat before its on_complete lands, so poll briefly for
    submitted == completed + shed + expired + failed before judging."""
    deadline = time.monotonic() + timeout_s
    while True:
        snap = stats.snapshot()
        delta = {k: snap[k] - before.get(k, 0) for k in _COUNTER_KEYS}
        balanced = delta["submitted"] == (
            delta["completed"] + delta["shed"] + delta["expired"]
            + delta["failed"]
        )
        if balanced or time.monotonic() > deadline:
            return delta, balanced
        time.sleep(0.002)


def _priority_for(rng, best_effort_frac: float) -> str:
    if best_effort_frac > 0 and rng.random() < best_effort_frac:
        return "best-effort"
    return "guaranteed"


def _drive_open(
    batcher: DynamicBatcher,
    spec: ScenarioSpec,
    *,
    seed: int,
    deadline_ms: Optional[float],
    best_effort_frac: float,
    retry_attempts: int,
) -> Dict[str, Any]:
    """Paced submission along the seeded schedule; a shed request is
    retried in place (with seeded backoff) when the spec says clients
    retry — later arrivals shift behind the retries, exactly as a
    blocked client shifts real traffic."""
    rng = np.random.default_rng(seed)
    offsets = _phase_offsets(spec.phases, rng)
    samples = make_samples(
        min(len(offsets), 64) or 1, batcher.pool.handle.in_shape, seed=seed
    )
    counters = {"completed": 0, "shed": 0, "expired": 0, "errors": 0}
    lock = threading.Lock()
    latency = Histogram()
    futures: List[Tuple[float, Any]] = []
    attempts = retry_attempts if spec.retry else 1
    backoffs = rng.uniform(0.001, 0.004, size=max(len(offsets), 1))

    def waiter(items):
        for t_sub, fut in items:
            try:
                fut.result(timeout=60.0)
                with lock:
                    counters["completed"] += 1
                # fut.t_done, not now(): the waiter drains after the
                # whole schedule has been paced out, so observe time
                # would charge early requests the full run duration.
                latency.record((fut.t_done or time.monotonic()) - t_sub)
            except DeadlineExceeded:
                with lock:
                    counters["expired"] += 1
            except BaseException:  # noqa: BLE001 — scenario must finish
                with lock:
                    counters["errors"] += 1

    t_start = time.monotonic()
    for i, off in enumerate(offsets):
        delay = t_start + off - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        x = samples[i % len(samples)]
        prio = _priority_for(rng, best_effort_frac)
        fut = None
        for attempt in range(attempts):
            try:
                fut = batcher.submit(x, deadline_ms=deadline_ms,
                                     priority=prio)
                break
            except Overloaded:
                if attempt < attempts - 1:
                    time.sleep(float(backoffs[i % len(backoffs)])
                               * (attempt + 1))
        if fut is None:
            counters["shed"] += 1
        else:
            futures.append((time.monotonic(), fut))
    waiter(futures)
    return {
        "requests": len(offsets),
        "seconds": time.monotonic() - t_start,
        "latency": latency,
        **counters,
    }


def _drive_closed(
    batcher: DynamicBatcher,
    spec: ScenarioSpec,
    *,
    seed: int,
    deadline_ms: Optional[float],
    best_effort_frac: float,
) -> Dict[str, Any]:
    """Closed-loop clients with think time — the slow-client shape."""
    rng = np.random.default_rng(seed)
    samples = make_samples(
        min(spec.n_requests, 64), batcher.pool.handle.in_shape, seed=seed
    )
    prios = [
        _priority_for(rng, best_effort_frac) for _ in range(spec.n_requests)
    ]
    counters = {"completed": 0, "shed": 0, "expired": 0, "errors": 0}
    lock = threading.Lock()
    latency = Histogram()
    next_idx = [0]

    def client() -> None:
        while True:
            with lock:
                i = next_idx[0]
                if i >= spec.n_requests:
                    return
                next_idx[0] += 1
            t_sub = time.monotonic()
            try:
                fut = batcher.submit(
                    samples[i % len(samples)], deadline_ms=deadline_ms,
                    priority=prios[i],
                )
            except Overloaded:
                with lock:
                    counters["shed"] += 1
                continue
            try:
                fut.result(timeout=60.0)
                with lock:
                    counters["completed"] += 1
                latency.record((fut.t_done or time.monotonic()) - t_sub)
            except DeadlineExceeded:
                with lock:
                    counters["expired"] += 1
            except BaseException:  # noqa: BLE001
                with lock:
                    counters["errors"] += 1
            # The slow client: think before the next request — the
            # backpressure that keeps offered load self-regulated.
            time.sleep(spec.think_ms / 1e3)

    threads = [
        threading.Thread(target=client, daemon=True)
        for _ in range(spec.concurrency)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {
        "requests": spec.n_requests,
        "seconds": time.monotonic() - t0,
        "latency": latency,
        **counters,
    }


def run(
    name: str,
    batcher: DynamicBatcher,
    *,
    seed: int = 0,
    deadline_ms: Optional[float] = None,
    best_effort_frac: float = 0.0,
    retry_attempts: int = 6,
    p99_ms: Optional[float] = None,
    max_shed_rate: Optional[float] = None,
) -> ScenarioReport:
    """Run one named scenario against a live batcher and judge it.

    Gate overrides (``p99_ms`` / ``max_shed_rate``) replace the spec
    defaults; chaos scenarios refuse to run without the matching fault
    armed on the batcher — a chaos gate that never injects would be
    vacuously green."""
    spec = SCENARIOS.get(name)
    if spec is None:
        raise ValueError(
            f"unknown scenario {name!r} (have: {', '.join(SCENARIOS)})"
        )
    if spec.needs_chaos is not None:
        chaos = batcher.chaos
        armed = chaos is not None and (
            (spec.needs_chaos == "kill-replica"
             and chaos.kill_replica_seq is not None)
            or (spec.needs_chaos == "slow-replica"
                and chaos.slow_replica is not None)
        )
        if not armed:
            raise ValueError(
                f"scenario {name!r} needs a ChaosMonkey with "
                f"{spec.needs_chaos}@… armed on the batcher"
            )
    before = {
        k: batcher.stats.snapshot()[k] for k in _COUNTER_KEYS
    }
    if spec.closed:
        out = _drive_closed(
            batcher, spec, seed=seed, deadline_ms=deadline_ms,
            best_effort_frac=best_effort_frac,
        )
    else:
        out = _drive_open(
            batcher, spec, seed=seed, deadline_ms=deadline_ms,
            best_effort_frac=best_effort_frac,
            retry_attempts=retry_attempts,
        )
    server, balanced = _settled_delta(batcher.stats, before)
    return ScenarioReport(
        name=name,
        seed=seed,
        requests=out["requests"],
        completed=out["completed"],
        shed=out["shed"],
        expired=out["expired"],
        errors=out["errors"],
        seconds=out["seconds"],
        latency=out["latency"],
        p99_gate_ms=p99_ms if p99_ms is not None else spec.p99_ms,
        shed_gate=(max_shed_rate if max_shed_rate is not None
                   else spec.max_shed_rate),
        server=server,
        conservation_ok=balanced,
    )
