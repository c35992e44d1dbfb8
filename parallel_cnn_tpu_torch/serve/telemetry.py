"""Serving telemetry: one ServeStats object shared by engine, batcher,
and CLI — per-request latency percentiles (utils.metrics.Histogram),
queue depth, batch occupancy, and shed/expiry rates.

Two time horizons per signal:

- **lifetime** counters (``submitted``, ``shed_rate()``, ``snapshot()``
  …) — the conservation-law view tests and the CLI epilogue pin; keys
  and semantics are frozen.
- **windowed** views (``window_shed_rate()``, ``window_occupancy()``,
  ``window_p99_ms()``, ``window_snapshot()``) — the same signals under
  an exponential decay with time constant ``window_s``, so a control
  loop (serve/autoscaler.py) reacts to the last few seconds of load
  instead of the run's lifetime average. An event recorded ``window_s``
  seconds ago carries weight 1/e.

``WireStats`` is the same conservation law one boundary further out, at
the network front door (serve/net.py).

Everything here is host-side counters around the device work, so the
cost per request is a few lock acquisitions — nothing touches the
device.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, Optional

from parallel_cnn_tpu_torch.utils.metrics import Histogram


class _DecayingCounter:
    """Float counter whose mass decays exp(-(now - t_last)/tau). NOT
    thread-safe — callers hold the owning ServeStats lock."""

    __slots__ = ("tau", "value", "t_last")

    def __init__(self, tau: float):
        self.tau = tau
        self.value = 0.0
        self.t_last: Optional[float] = None

    def _decay_to(self, now: float) -> None:
        if self.t_last is not None and now > self.t_last:
            self.value *= math.exp((self.t_last - now) / self.tau)
        self.t_last = now

    def add(self, x: float, now: float) -> None:
        self._decay_to(now)
        self.value += x

    def read(self, now: float) -> float:
        self._decay_to(now)
        return self.value


class _DecayingHistogram:
    """Log-binned histogram with exponentially decayed float counts —
    the windowed twin of utils.metrics.Histogram (same bin geometry,
    recent samples dominate the percentile). NOT thread-safe — callers
    hold the owning ServeStats lock."""

    def __init__(self, tau: float, lo: float = 1e-5, hi: float = 100.0,
                 bins: int = 96):
        self.tau = tau
        self.lo = lo
        self.hi = hi
        self.bins = bins
        self._ratio = math.log(hi / lo)
        self._counts = [0.0] * bins
        self._t_last: Optional[float] = None

    def _decay_to(self, now: float) -> None:
        if self._t_last is not None and now > self._t_last:
            f = math.exp((self._t_last - now) / self.tau)
            self._counts = [c * f for c in self._counts]
        self._t_last = now

    def record(self, x: float, now: float) -> None:
        self._decay_to(now)
        if x <= self.lo:
            i = 0
        elif x >= self.hi:
            i = self.bins - 1
        else:
            i = min(self.bins - 1,
                    int(self.bins * math.log(x / self.lo) / self._ratio))
        self._counts[i] += 1.0

    def percentile(self, p: float, now: float) -> Optional[float]:
        """Geometric bin-midpoint percentile over the decayed mass;
        None once less than half a sample's weight survives — a stale
        percentile must go silent, not linger at its last value."""
        self._decay_to(now)
        total = sum(self._counts)
        if total < 0.5:
            return None
        target = total * p / 100.0
        acc = 0.0
        for i, c in enumerate(self._counts):
            acc += c
            if acc >= target:
                lo_e = self.lo * math.exp(self._ratio * i / self.bins)
                hi_e = self.lo * math.exp(self._ratio * (i + 1) / self.bins)
                return math.sqrt(lo_e * hi_e)
        return self.hi


class ServeStats:
    """Aggregated serving counters. Thread-safe.

    ``window_s`` is the exponential-decay time constant for the windowed
    views; ``clock`` is injectable (monotonic seconds) so control-loop
    tests can drive the decay deterministically."""

    def __init__(self, window_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self._lock = threading.Lock()
        self._clock = clock
        self.window_s = window_s
        # End-to-end request latency (submit → result ready), seconds.
        self.latency = Histogram(1e-5, 100.0, bins=96)
        self.submitted = 0
        self.completed = 0
        self.shed = 0        # rejected at submit: queue full / admission
        self.expired = 0     # dropped at coalesce/dispatch: deadline passed
        self.failed = 0      # engine-side errors propagated to futures
        self.batches = 0
        self.requests_in_batches = 0
        self.padded_slots = 0       # bucket − occupancy, summed
        self.queue_depth_sum = 0
        self.queue_depth_max = 0
        self.replica_batches: Dict[int, int] = {}
        # Windowed (decayed) twins of the control-relevant signals.
        self._w_submitted = _DecayingCounter(window_s)
        self._w_shed = _DecayingCounter(window_s)
        self._w_requests = _DecayingCounter(window_s)
        self._w_padded = _DecayingCounter(window_s)
        self._w_latency = _DecayingHistogram(window_s)

    # -- recording hooks (batcher/engine call these) --------------------

    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1
            self._w_submitted.add(1.0, self._clock())

    def on_shed(self) -> None:
        with self._lock:
            self.shed += 1
            self._w_shed.add(1.0, self._clock())

    def on_expired(self, n: int = 1) -> None:
        with self._lock:
            self.expired += n

    def on_batch(self, n: int, bucket: int, replica: int,
                 queue_depth: int) -> None:
        with self._lock:
            self.batches += 1
            self.requests_in_batches += n
            self.padded_slots += bucket - n
            self.queue_depth_sum += queue_depth
            self.queue_depth_max = max(self.queue_depth_max, queue_depth)
            self.replica_batches[replica] = (
                self.replica_batches.get(replica, 0) + 1
            )
            now = self._clock()
            self._w_requests.add(float(n), now)
            self._w_padded.add(float(bucket - n), now)

    def on_complete(self, latency_s: float) -> None:
        self.latency.record(latency_s)
        with self._lock:
            self.completed += 1
            self._w_latency.record(latency_s, self._clock())

    def on_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    # -- views ----------------------------------------------------------

    def shed_rate(self) -> float:
        with self._lock:
            return self.shed / self.submitted if self.submitted else 0.0

    def mean_occupancy(self) -> Optional[float]:
        """Mean fraction of dispatched batch slots holding real requests
        (padding is the waste dynamic bucketing pays for shape reuse)."""
        with self._lock:
            total = self.requests_in_batches + self.padded_slots
            return self.requests_in_batches / total if total else None

    # -- windowed views (the autoscaler's control inputs) ---------------

    def window_shed_rate(self) -> float:
        """Shed fraction over the decay window (0.0 when the window is
        empty — an idle server is not overloaded). "Empty" is less than
        half a request of surviving mass: the shed/submitted *ratio*
        does not decay (both masses shrink by the same factor), so
        without the idle cutoff a long-past shed burst would read as an
        overload forever and wedge the autoscaler's scale-down path."""
        with self._lock:
            now = self._clock()
            sub = self._w_submitted.read(now)
            return self._w_shed.read(now) / sub if sub >= 0.5 else 0.0

    def window_occupancy(self) -> Optional[float]:
        """Batch occupancy over the decay window; None when no batch
        dispatched recently (idle — a scale-down signal of its own).
        Same half-a-request idle cutoff as ``window_shed_rate``."""
        with self._lock:
            now = self._clock()
            req = self._w_requests.read(now)
            total = req + self._w_padded.read(now)
            return req / total if total >= 0.5 else None

    def window_p99_ms(self) -> Optional[float]:
        """p99 end-to-end latency (ms) over the decay window; None when
        no request completed recently."""
        with self._lock:
            p = self._w_latency.percentile(99.0, self._clock())
            return p * 1e3 if p is not None else None

    def window_snapshot(self) -> Dict[str, Any]:
        """The windowed signals in one dict (separate from ``snapshot``
        on purpose — its lifetime keys are a frozen contract)."""
        return {
            "window_s": self.window_s,
            "shed_rate": self.window_shed_rate(),
            "occupancy": self.window_occupancy(),
            "p99_ms": self.window_p99_ms(),
        }

    def snapshot(self) -> Dict[str, Any]:
        lat = self.latency.summary(scale=1e3)  # ms
        with self._lock:
            snap: Dict[str, Any] = {
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                "expired": self.expired,
                "failed": self.failed,
                "batches": self.batches,
                "queue_depth_mean": (
                    self.queue_depth_sum / self.batches if self.batches
                    else 0.0
                ),
                "queue_depth_max": self.queue_depth_max,
                "replica_batches": dict(self.replica_batches),
            }
        snap["shed_rate"] = self.shed_rate()
        occ = self.mean_occupancy()
        snap["batch_occupancy"] = occ if occ is not None else 0.0
        snap["latency_ms"] = lat
        return snap

    def attach_registry(self, registry, prefix: str = "serve") -> None:
        """Expose this ServeStats through an obs.MetricsRegistry.

        Registers ``snapshot`` as a collector, so every exposition
        (Prometheus text or JSON) pulls the live counters under
        ``<prefix>.*`` — the counters themselves keep their semantics
        and locking; the registry never caches them."""
        registry.attach(prefix, self.snapshot)

    def render(self) -> str:
        """Human-readable one-screen summary (the CLI's epilogue)."""
        s = self.snapshot()
        lat = s["latency_ms"]
        lines = [
            f"requests: {s['submitted']} submitted, {s['completed']} ok, "
            f"{s['shed']} shed, {s['expired']} expired, {s['failed']} failed",
            f"batches:  {s['batches']} "
            f"(occupancy {s['batch_occupancy']:.2f}, "
            f"queue depth mean {s['queue_depth_mean']:.1f} "
            f"max {s['queue_depth_max']})",
        ]
        if lat.get("count"):
            lines.append(
                f"latency:  p50 {lat['p50']:.2f} ms, p90 {lat['p90']:.2f} ms, "
                f"p99 {lat['p99']:.2f} ms (mean {lat['mean']:.2f}, "
                f"max {lat['max']:.2f})"
            )
        if s["replica_batches"]:
            per = ", ".join(
                f"r{i}: {n}" for i, n in sorted(s["replica_batches"].items())
            )
            lines.append(f"replicas: {per}")
        return "\n".join(lines)


class WireStats:
    """Wire-tier request accounting for the network front door
    (serve/net.py) — the same conservation law as :class:`ServeStats`,
    one boundary further out: every request *observed on the socket*
    resolves exactly once as completed (reply written), shed (typed
    Overloaded reply), expired (typed DeadlineExceeded reply, or a
    stalled/half-read socket reaped at the connection deadline), or
    failed (endpoint death with the request in flight, or an error
    reply). ``submitted == completed + shed + expired + failed`` must
    therefore hold over the wire in every scenario — including across a
    ``kill-endpoint@`` respawn, where the in-flight remainder lands in
    ``failed`` rather than vanishing.

    Deliberately a separate object from the batcher's ServeStats: a
    slow-loris request that never finished arriving was never
    ``submit()``-ed to the batcher, so it exists only at this tier, and
    an endpoint death fails the wire view of a request the batcher may
    still complete internally. Thread-safe; shared across endpoint
    respawns so the law spans restarts."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.expired = 0
        self.failed = 0
        # Connection-level context (not part of the conservation sum).
        self.conn_opened = 0
        self.conn_closed = 0
        self.reaped = 0          # expired subset: stalled sockets reaped
        self.endpoint_deaths = 0

    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def on_complete(self) -> None:
        with self._lock:
            self.completed += 1

    def on_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def on_expired(self, n: int = 1, reaped: bool = False) -> None:
        with self._lock:
            self.expired += n
            if reaped:
                self.reaped += n

    def on_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def on_conn_open(self) -> None:
        with self._lock:
            self.conn_opened += 1

    def on_conn_close(self) -> None:
        with self._lock:
            self.conn_closed += 1

    def on_endpoint_death(self) -> None:
        with self._lock:
            self.endpoint_deaths += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                "expired": self.expired,
                "failed": self.failed,
                "conn_opened": self.conn_opened,
                "conn_closed": self.conn_closed,
                "reaped": self.reaped,
                "endpoint_deaths": self.endpoint_deaths,
            }

    def balanced(self) -> bool:
        """The wire conservation law, as a predicate."""
        with self._lock:
            return self.submitted == (
                self.completed + self.shed + self.expired + self.failed
            )

    def attach_registry(self, registry, prefix: str = "wire") -> None:
        """Expose through an obs.MetricsRegistry (same pull-collector
        convention as ServeStats)."""
        registry.attach(prefix, self.snapshot)
