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

The **net suites** (``run_net`` + NET_SCENARIOS) repeat the exercise
one boundary further out — over the real socket of serve/net.py, with
conservation judged at the wire tier (WireStats delta) as well:

- **net-steady** — closed-loop socket clients, no faults: the wire
  baseline every other net gate is measured against.
- **net-slow-loris** — one client stalls mid-request past the read
  deadline (``slow-loris@SEQ:MS`` armed client-side). The server must
  reap it as *expired* — never a hung handler thread — and the run
  asserts ``reaped >= 1`` on top of conservation.
- **net-kill-endpoint** — ``kill-endpoint@SEQ`` armed server-side:
  the endpoint dies mid-traffic, in-flight wire requests are journaled
  ``net_failed``, and the supervisor's bounded-backoff respawn (same
  port) lets client retries carry every logical request through —
  run WITHOUT a supervisor and the gate trips, which is the
  anti-vacuity control arm.
- **net-hot-swap-diurnal** — the diurnal shape driven over the wire
  with a weight hot-swap triggered mid-peak: the grow → drain →
  retire roll must finish with ``failed_delta == 0`` and conservation
  intact at both tiers (the zero-downtime gate).

``run`` knows only the in-process scenarios: a ``net-*`` name there is an
unknown scenario, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

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


def settle(read: Callable[[], Any], done: Callable[[Any], bool],
           timeout_s: float = 5.0) -> Tuple[Any, bool]:
    """Poll ``read()`` until ``done`` holds of its value or ``timeout_s``
    passes; returns (the last value, whether it was done). A terminal
    outcome is counted (and journaled) a beat after the reply or future
    that carries it, so every count is judged once it has settled."""
    deadline = time.monotonic() + timeout_s
    while True:
        value = read()
        ok = done(value)
        if ok or time.monotonic() > deadline:
            return value, ok
        time.sleep(0.002)


def _balanced(delta: Dict[str, int]) -> bool:
    return delta["submitted"] == (
        delta["completed"] + delta["shed"] + delta["expired"] + delta["failed"]
    )


def settled_delta(stats, before: Dict[str, int], keys: Tuple[str, ...] = _COUNTER_KEYS,
                  timeout_s: float = 5.0) -> Tuple[Dict[str, int], bool]:
    """The delta of ``stats`` (ServeStats or WireStats) over ``before``
    once submitted == completed + shed + expired + failed, and whether
    it balanced before ``timeout_s``."""
    def read() -> Dict[str, int]:
        snap = stats.snapshot()
        return {k: snap[k] - before.get(k, 0) for k in keys}

    return settle(read, _balanced, timeout_s)


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
    server, balanced = settled_delta(batcher.stats, before)
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


# ---------------------------------------------------------------------------
# Net suites: the same judgment over the real socket (serve/net.py).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NetScenarioReport(ScenarioReport):
    """A ScenarioReport with the wire tier judged too: the WireStats
    delta must balance on its own, a slow-loris run must actually reap,
    and a hot-swap run must finish with zero failed and nothing stuck."""

    wire: Dict[str, int] = dataclasses.field(default_factory=dict)
    wire_ok: bool = True
    min_reaped: int = 0
    swap: Optional[Dict[str, Any]] = None

    def gates(self) -> Dict[str, bool]:
        g = super().gates()
        g["wire_conservation"] = self.wire_ok
        if self.min_reaped:
            g["reaped"] = self.wire.get("reaped", 0) >= self.min_reaped
        if self.swap is not None:
            g["hot_swap_zero_failed"] = (
                self.swap.get("failed_delta", 1) == 0
                and not self.swap.get("stuck")
                and len(self.swap.get("swapped", [])) > 0
            )
        return g

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        d["wire"] = self.wire
        d["swap"] = self.swap
        return d


@dataclasses.dataclass(frozen=True)
class NetScenarioSpec:
    """A named net scenario: closed-loop socket clients, optionally
    paced along seeded phase offsets, with the gate defaults."""

    name: str
    p99_ms: float
    max_shed_rate: float
    needs_chaos: Optional[str]    # "slow-loris" (client) / "kill-endpoint"
    n_requests: int
    concurrency: int
    phases: Tuple[Tuple[float, float], ...] = ()  # paced arrivals when set
    min_reaped: int = 0           # required reap count (anti-vacuity)
    swap_at_frac: Optional[float] = None  # hot-swap trigger point
    deadline_ms: Optional[float] = None   # per-request budget on the wire


NET_SCENARIOS: Dict[str, NetScenarioSpec] = {
    # The wire baseline: no faults, nothing shed, nothing lost.
    "net-steady": NetScenarioSpec(
        name="net-steady", p99_ms=500.0, max_shed_rate=0.0,
        needs_chaos=None, n_requests=64, concurrency=4,
    ),
    # One client stalls mid-request past the read deadline; the server
    # must reap it as expired (never a hung handler) and keep serving.
    "net-slow-loris": NetScenarioSpec(
        name="net-slow-loris", p99_ms=500.0, max_shed_rate=0.0,
        needs_chaos="slow-loris", n_requests=48, concurrency=4,
        min_reaped=1,
    ),
    # Endpoint dies mid-traffic; with a supervisor the respawn plus
    # client transport-retries carry every logical request through.
    "net-kill-endpoint": NetScenarioSpec(
        name="net-kill-endpoint", p99_ms=1000.0, max_shed_rate=0.0,
        needs_chaos="kill-endpoint", n_requests=64, concurrency=4,
    ),
    # Diurnal pacing with a weight hot-swap triggered mid-peak: the
    # grow → drain → retire roll must lose nothing (zero failed).
    "net-hot-swap-diurnal": NetScenarioSpec(
        name="net-hot-swap-diurnal", p99_ms=1000.0, max_shed_rate=0.0,
        needs_chaos=None, n_requests=0, concurrency=6,
        phases=((0.05, 150.0), (0.1, 400.0), (0.05, 150.0)),
        swap_at_frac=0.4,
    ),
}


#: The wire tier's counters a net scenario reads as a delta.
WIRE_KEYS = _COUNTER_KEYS + ("reaped", "conn_opened", "endpoint_deaths")


def settled_wire_delta(wire, before: Dict[str, int],
                       timeout_s: float = 5.0) -> Tuple[Dict[str, int], bool]:
    """``settled_delta`` of the WireStats: a handler may account its
    terminal outcome a beat after the client read the reply."""
    return settled_delta(wire, before, WIRE_KEYS, timeout_s)


def run_net(
    name: str,
    batcher: DynamicBatcher,
    *,
    wire,
    address: Optional[Tuple[str, int]] = None,
    server=None,
    supervisor=None,
    chaos=None,
    swap_model: Any = None,
    obs=None,
    seed: int = 0,
    timeout_s: float = 10.0,
    retry=None,
    p99_ms: Optional[float] = None,
    max_shed_rate: Optional[float] = None,
) -> NetScenarioReport:
    """Run one named net scenario over a live socket endpoint.

    ``wire`` is the (respawn-shared) WireStats of the endpoint;
    ``supervisor`` / ``server`` locate the listener (``address``
    overrides — e.g. a fixed port the supervisor respawns on).
    ``chaos`` is the *client-side* monkey (slow-loris); the
    kill-endpoint arming check reads the *server's* monkey. A hot-swap
    scenario needs ``swap_model`` — the new weights (an ``nn.Module`` on
    the host) rolled in mid-peak via serve.supervisor.hot_swap."""
    from parallel_cnn_tpu_torch.serve import loadgen
    from parallel_cnn_tpu_torch.serve import supervisor as supervisor_lib

    spec = NET_SCENARIOS.get(name)
    if spec is None:
        raise ValueError(
            f"unknown net scenario {name!r} "
            f"(have: {', '.join(NET_SCENARIOS)})"
        )
    endpoint = supervisor.server if supervisor is not None else server
    if address is None:
        if endpoint is None:
            raise ValueError("run_net needs address=, server=, or "
                             "supervisor= to locate the endpoint")
        address = endpoint.address
    # Anti-vacuity: a chaos scenario without its fault armed would be
    # vacuously green — refuse instead (same contract as run()).
    if spec.needs_chaos == "slow-loris":
        if chaos is None or chaos.slow_loris is None:
            raise ValueError(
                f"scenario {name!r} needs a client-side ChaosMonkey with "
                f"slow-loris@SEQ:MS armed"
            )
    elif spec.needs_chaos == "kill-endpoint":
        srv_chaos = endpoint.chaos if endpoint is not None else None
        if srv_chaos is None or srv_chaos.kill_endpoint_seq is None:
            raise ValueError(
                f"scenario {name!r} needs kill-endpoint@SEQ armed on the "
                f"endpoint's ChaosMonkey"
            )
    if spec.swap_at_frac is not None and swap_model is None:
        raise ValueError(f"scenario {name!r} needs swap_model= (the new "
                         f"weights to hot-swap in)")
    rng = np.random.default_rng(seed)
    offsets = _phase_offsets(spec.phases, rng) if spec.phases else []
    n_requests = len(offsets) if offsets else spec.n_requests
    samples = make_samples(
        min(n_requests, 64) or 1, batcher.pool.handle.in_shape, seed=seed
    )
    swap_holder: Dict[str, Any] = {}
    swap_threads: List[threading.Thread] = []
    triggered = [False]
    trigger_lock = threading.Lock()
    swap_idx = (
        int(spec.swap_at_frac * n_requests)
        if spec.swap_at_frac is not None else None
    )
    t_start = time.monotonic()

    def on_request(i: int) -> None:
        if offsets:
            delay = t_start + offsets[min(i, len(offsets) - 1)] \
                - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        if swap_idx is not None and i >= swap_idx:
            with trigger_lock:
                if triggered[0]:
                    return
                triggered[0] = True
            t = threading.Thread(
                target=lambda: swap_holder.update(
                    report=supervisor_lib.hot_swap(
                        batcher.pool, batcher, swap_model, obs=obs,
                    )
                ),
                daemon=True, name="hot-swap",
            )
            t.start()
            swap_threads.append(t)

    before_batcher = {
        k: batcher.stats.snapshot()[k] for k in _COUNTER_KEYS
    }
    before_wire = wire.snapshot()
    out = loadgen.run_closed_loop_net(
        address, samples, n_requests=n_requests,
        concurrency=spec.concurrency, deadline_ms=spec.deadline_ms,
        retry=retry, timeout_s=timeout_s, seed=seed, chaos=chaos,
        on_request=on_request if (offsets or swap_idx is not None)
        else None,
    )
    for t in swap_threads:
        t.join(timeout=30.0)
    swap_report = swap_holder.get("report")
    if spec.swap_at_frac is not None and swap_report is None:
        # The trigger never fired (or the swap never finished): that is
        # a failed swap gate, not an absent one.
        swap_report = {"failed_delta": -1, "stuck": [], "swapped": []}
    wire_delta, wire_ok = settled_wire_delta(wire, before_wire)
    server_delta, balanced = settled_delta(batcher.stats, before_batcher)
    return NetScenarioReport(
        name=name,
        seed=seed,
        requests=out.requests,
        completed=out.completed,
        shed=out.shed,
        expired=out.expired,
        errors=out.errors,
        seconds=out.seconds,
        latency=out.latency,
        p99_gate_ms=p99_ms if p99_ms is not None else spec.p99_ms,
        shed_gate=(max_shed_rate if max_shed_rate is not None
                   else spec.max_shed_rate),
        server=server_delta,
        conservation_ok=balanced,
        wire=wire_delta,
        wire_ok=wire_ok,
        min_reaped=spec.min_reaped,
        swap=swap_report,
    )
