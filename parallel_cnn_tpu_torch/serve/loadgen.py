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

The **socket transport** (NetClient + run_closed_loop_net) drives the
same closed loop over the network front door (serve/net.py) instead of
in-process ``submit()``: newline-delimited JSON on a persistent TCP
connection, typed outcome mapping (Overloaded/DeadlineExceeded raised
client-side from the server's error replies), per-request timeouts, and
``RetryPolicy.decorrelated(cid)`` backoff on BOTH Overloaded replies
and transport errors — the latter is what carries a client through a
kill-endpoint → supervisor-respawn window: each retry is a NEW wire
request, so wire-tier conservation balances while the killed
endpoint's in-flight requests stand journaled as ``net_failed``. The
client is also the slow-loris attacker: armed with a
``slow-loris@SEQ:MS`` ChaosMonkey it sends half a request line, stalls
MS, and records the server's reap as ``expired`` (never retried — the
server already accounted it).
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from parallel_cnn_tpu_torch.resilience.retry import RetryPolicy
from parallel_cnn_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    DynamicBatcher,
    Overloaded,
)
from parallel_cnn_tpu_torch.serve.net import encode_request
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


# ---------------------------------------------------------------------------
# Socket transport: the same patterns over the network front door.
# ---------------------------------------------------------------------------


class NetTransportError(RuntimeError):
    """Connection-level failure (refused, reset, reply timeout): the
    retryable class — it is what a client sees while a killed endpoint
    is down, and what decorrelated backoff rides through a respawn."""


class NetRequestFailed(RuntimeError):
    """The server resolved the request with a typed ``Failed`` reply
    (endpoint shutting down, replica error past failover)."""


class _WireSeq:
    """Shared client-side wire-request counter: the clock the slow-loris
    chaos schedule reads, global across all clients of one run."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def next(self) -> int:
        with self._lock:
            n = self._n
            self._n += 1
            return n


class NetClient:
    """One synchronous NDJSON client over a persistent TCP connection.

    Lazily (re)connects, so the same client object survives an endpoint
    death: the next ``request()`` raises NetTransportError, the caller
    backs off, and a later attempt reconnects to the respawned
    listener. ``chaos`` arms the slow-loris injection (see module
    docstring); ``seq`` shares the wire-request counter across clients.
    """

    def __init__(
        self,
        address: Tuple[str, int],
        *,
        timeout_s: float = 10.0,
        chaos=None,
        seq: Optional[_WireSeq] = None,
    ):
        self.address = address
        self.timeout_s = timeout_s
        self.chaos = chaos
        self.seq = seq if seq is not None else _WireSeq()
        self._sock: Optional[socket.socket] = None
        self._buf = bytearray()
        self._rid = 0

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._buf.clear()

    def __enter__(self) -> "NetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                self._sock = socket.create_connection(
                    self.address, timeout=self.timeout_s
                )
            except OSError as e:
                raise NetTransportError(f"connect {self.address}: {e}") from e
            self._buf.clear()
        return self._sock

    def _send_loris(self, sock: socket.socket, line: bytes,
                    stall_ms: float) -> None:
        """The attack: half a request line, then a stall longer than the
        server's read deadline. The server MUST reap us — if instead the
        tail of the line is accepted after the stall, the read deadline
        is broken (and the scenario gate will see a completion where it
        required an expiry)."""
        half = max(1, len(line) // 2)
        sock.sendall(line[:half])
        time.sleep(stall_ms / 1e3)
        try:
            sock.sendall(line[half:])
            self._read_reply(sock)  # a reply here means we were NOT reaped
        except (OSError, NetTransportError):
            pass  # reaped: connection closed under us, as designed
        finally:
            self.close()

    def _read_reply(self, sock: socket.socket) -> Dict[str, Any]:
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                line = bytes(self._buf[:nl])
                del self._buf[:nl + 1]
                return json.loads(line)
            try:
                chunk = sock.recv(65536)
            except (socket.timeout, OSError) as e:
                self.close()
                raise NetTransportError(f"reply read: {e}") from e
            if not chunk:
                self.close()
                raise NetTransportError("connection closed awaiting reply")
            self._buf.extend(chunk)

    def request(
        self,
        x,
        *,
        deadline_ms: Optional[float] = None,
        priority: Optional[str] = None,
    ) -> np.ndarray:
        """One wire request; raises the typed outcome:
        Overloaded / DeadlineExceeded (server-typed replies, mirrors of
        the in-process submit contract), NetRequestFailed, or
        NetTransportError (retryable). A slow-loris injection raises
        DeadlineExceeded — the server reaped it as expired."""
        wire_seq = self.seq.next()
        self._rid += 1
        line = encode_request(self._rid, x, deadline_ms, priority)
        sock = self._connect()
        stall_ms = (
            self.chaos.slow_loris_at(wire_seq)
            if self.chaos is not None else None
        )
        if stall_ms is not None:
            self._send_loris(sock, line, stall_ms)
            raise DeadlineExceeded(
                f"slow-loris@{wire_seq}: reaped by read deadline"
            )
        try:
            sock.settimeout(self.timeout_s)
            sock.sendall(line)
        except OSError as e:
            self.close()
            raise NetTransportError(f"send: {e}") from e
        reply = self._read_reply(sock)
        if reply.get("ok"):
            return np.asarray(reply["y"], dtype=np.float32)
        error = reply.get("error", "Failed")
        message = reply.get("message", "")
        if error == "Overloaded":
            raise Overloaded(message)
        if error == "DeadlineExceeded":
            raise DeadlineExceeded(message)
        raise NetRequestFailed(f"{error}: {message}")


def run_closed_loop_net(
    address: Tuple[str, int],
    samples: np.ndarray,
    *,
    n_requests: int,
    concurrency: int = 4,
    deadline_ms: Optional[float] = None,
    retry: Optional[RetryPolicy] = None,
    timeout_s: float = 10.0,
    seed: int = 0,
    chaos=None,
    on_request: Optional[Any] = None,
) -> LoadgenReport:
    """Closed loop over the wire: ``concurrency`` NetClients, each with
    a ``retry.decorrelated(cid)`` backoff stream covering Overloaded
    replies AND transport errors (the respawn-riding path). Slow-loris
    injections and server-typed deadline replies count ``expired`` and
    are never retried. ``on_request(global_index)`` — when given — is
    called before each request (the scenario hook that triggers a
    mid-run hot swap at a chosen point in the traffic)."""
    retry = retry or RetryPolicy(attempts=6, base_delay=0.01,
                                 max_delay=0.5, seed=seed)
    latency = Histogram()
    counters = {"completed": 0, "shed": 0, "expired": 0, "errors": 0}
    lock = threading.Lock()
    next_idx = [0]
    seq = _WireSeq()

    def client(cid: int) -> None:
        delays = list(retry.decorrelated(cid).delays())
        with NetClient(address, timeout_s=timeout_s, chaos=chaos,
                       seq=seq) as nc:
            while True:
                with lock:
                    i = next_idx[0]
                    if i >= n_requests:
                        return
                    next_idx[0] += 1
                if on_request is not None:
                    on_request(i)
                x = samples[i % len(samples)]
                t_sub = time.monotonic()
                outcome = None
                for attempt in range(retry.attempts):
                    try:
                        nc.request(x, deadline_ms=deadline_ms)
                        outcome = "completed"
                        latency.record(time.monotonic() - t_sub)
                        break
                    except DeadlineExceeded:
                        outcome = "expired"
                        break
                    except Overloaded:
                        outcome = "shed"
                    except (NetTransportError, NetRequestFailed):
                        outcome = "errors"
                    if attempt < retry.attempts - 1:
                        time.sleep(delays[attempt])
                with lock:
                    counters[outcome] += 1

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
        pattern="closed-net",
        requests=n_requests,
        completed=counters["completed"],
        shed=counters["shed"],
        expired=counters["expired"],
        errors=counters["errors"],
        seconds=seconds,
        latency=latency,
    )
