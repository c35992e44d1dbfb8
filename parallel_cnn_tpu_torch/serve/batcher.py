"""Dynamic batcher: bounded queue → coalesce → bucket-pad → split (the
port's counterpart of ``parallel_cnn_tpu/serve/batcher.py``).

- ``submit`` is non-blocking. A full bounded queue sheds the request with
  the typed ``Overloaded`` error instead of queueing without bound.
- The worker thread pops the oldest request, then coalesces followers
  until ``max_batch`` requests OR ``max_wait_ms`` since the first pop —
  whichever first.
- Requests carry optional deadlines; overdue ones are dropped with
  ``DeadlineExceeded`` when the worker pops them, and again at dispatch.
- Formed batches go through ``n_replicas`` runner threads, so while one
  replica computes, the worker is already coalescing the next batch.
- Conservation: every submitted request resolves exactly once, so
  ``submitted == completed + shed + expired + failed``.

A batch whose replica is dead fails with ReplicaDead (counted failed).
Admission control, chaos injection, in-flight replica failover,
observability spans and autoscaler runner growth are not ported yet.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import List, Optional

import numpy as np

from parallel_cnn_tpu_torch.serve.engine import ReplicaDead
from parallel_cnn_tpu_torch.serve.telemetry import ServeStats


class Overloaded(RuntimeError):
    """Request shed: the bounded request queue is full (backpressure).
    Clients back off and retry, or degrade."""


class DeadlineExceeded(RuntimeError):
    """Request dropped: its deadline passed before dispatch."""


class Future:
    """Minimal single-result future resolved by the batcher."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        # Which replica served it, in which batch (None if the request
        # died before reaching a device).
        self.replica: Optional[int] = None
        self.batch_seq: Optional[int] = None
        # Resolution instant (monotonic), so a caller polling result()
        # later still measures the true latency.
        self.t_done: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        if self._error is not None:
            raise self._error
        return self._value

    def _resolve(self, value: np.ndarray) -> None:
        self._value = value
        self.t_done = time.monotonic()
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self.t_done = time.monotonic()
        self._event.set()


class _Request:
    __slots__ = ("x", "deadline", "t_submit", "future")

    def __init__(self, x, deadline, t_submit):
        self.x = x
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.t_submit = t_submit
        self.future = Future()


class DynamicBatcher:
    """Request front-end over an engine.ReplicaPool.

    ``start=False`` builds the batcher with the worker paused, so tests
    can stage the queue (fill, overload, expire) before a batch forms;
    ``start()`` begins serving. As a context manager it closes on exit
    (queued requests fail with RuntimeError)."""

    def __init__(
        self,
        pool,
        *,
        max_wait_ms: float = 2.0,
        queue_depth: int = 256,
        deadline_ms: float = 0.0,
        stats: Optional[ServeStats] = None,
        start: bool = True,
    ):
        self.pool = pool
        self.max_batch = pool.max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.default_deadline_s = deadline_ms / 1e3 if deadline_ms else None
        self.stats = stats if stats is not None else ServeStats()
        self._queue: "queue_mod.Queue[_Request]" = queue_mod.Queue(
            maxsize=queue_depth
        )
        self._stop = threading.Event()
        self._batch_seq = 0
        self._runners = [
            threading.Thread(
                target=self._runner_loop, name=f"serve-runner-{i}", daemon=True
            )
            for i in range(pool.n_replicas)
        ]
        # Formed batches awaiting a runner, bounded at the runner count so
        # requests wait in the REQUEST queue, where shedding and deadline
        # drops see them.
        self._dispatch: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max(pool.n_replicas, 1)
        )
        self._worker = threading.Thread(
            target=self._worker_loop, name="serve-batcher", daemon=True
        )
        self._started = False
        if start:
            self.start()

    # -- client surface -------------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request (a single sample, shape == in_shape).

        Raises Overloaded immediately when the bounded queue is full.
        ``deadline_ms`` is a per-request budget from now (None keeps the
        batcher default, 0 disables)."""
        x = np.asarray(x, dtype=np.float32)
        if x.shape != tuple(self.pool.handle.in_shape):
            raise ValueError(
                f"expected a single sample of shape "
                f"{tuple(self.pool.handle.in_shape)}, got {x.shape}"
            )
        now = time.monotonic()
        if deadline_ms is None:
            deadline = (
                now + self.default_deadline_s
                if self.default_deadline_s
                else None
            )
        else:
            deadline = now + deadline_ms / 1e3 if deadline_ms else None
        req = _Request(x, deadline, now)
        self.stats.on_submit()
        try:
            self._queue.put_nowait(req)
        except queue_mod.Full:
            self.stats.on_shed()
            raise Overloaded(
                f"request queue full ({self._queue.maxsize} deep); "
                "back off and retry"
            ) from None
        return req.future

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for t in self._runners:
            t.start()
        self._worker.start()

    def close(self) -> None:
        self._stop.set()
        if self._started:
            self._worker.join(timeout=5)
            for t in self._runners:
                t.join(timeout=5)
        # Fail anything still queued so no client blocks forever.
        for q in (self._queue, self._dispatch):
            while True:
                try:
                    item = q.get_nowait()
                except queue_mod.Empty:
                    break
                reqs = item[0] if isinstance(item, tuple) else [item]
                failed = [r for r in reqs if not r.future.done()]
                for r in failed:
                    r.future._fail(RuntimeError("batcher closed"))
                if failed:
                    self.stats.on_failed(len(failed))

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker side ----------------------------------------------------

    def _expire_req(self, r: _Request, now: float, where: str) -> None:
        r.future._fail(DeadlineExceeded(
            f"deadline passed {1e3 * (now - r.deadline):.1f} ms {where}"
        ))
        self.stats.on_expired(1)

    def _pop_live(self, timeout: float) -> Optional[_Request]:
        """Pop one request, expiring overdue ones on the spot. Returns
        None on timeout."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            try:
                r = self._queue.get(timeout=max(remaining, 0.0))
            except queue_mod.Empty:
                return None
            now = time.monotonic()
            if r.deadline is not None and now > r.deadline:
                self._expire_req(r, now, "in queue (coalesce sweep)")
                continue
            return r

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            first = self._pop_live(timeout=0.05)
            if first is None:
                continue
            batch = [first]
            t0 = time.monotonic()
            while len(batch) < self.max_batch:
                remaining = t0 + self.max_wait_s - time.monotonic()
                if remaining <= 0:
                    break
                r = self._pop_live(timeout=remaining)
                if r is None:
                    break
                batch.append(r)
            now = time.monotonic()
            live: List[_Request] = []
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    self._expire_req(r, now, "before dispatch")
                else:
                    live.append(r)
            if not live:
                continue
            try:
                replica = self.pool.next_replica()
            except ReplicaDead as e:
                self._fail_batch(live, e)
                continue
            seq = self._batch_seq
            self._batch_seq += 1
            self.stats.on_batch(
                n=len(live),
                bucket=self.pool.engines[replica].bucket_for(len(live)),
                replica=replica,
                queue_depth=self._queue.qsize(),
            )
            # Blocks while every runner is busy — deliberate backpressure.
            while not self._stop.is_set():
                try:
                    self._dispatch.put((live, replica, seq), timeout=0.05)
                    break
                except queue_mod.Full:
                    continue
            else:
                self._fail_batch(live, RuntimeError("batcher closed"))

    def _runner_loop(self) -> None:
        while not self._stop.is_set():
            try:
                live, replica, seq = self._dispatch.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            try:
                self._resolve_batch(live, replica, seq)
            except Exception as e:  # noqa: BLE001 — forwarded to clients
                self._fail_batch(live, e)

    def _resolve_batch(self, live: List[_Request], replica: int,
                       seq: int) -> None:
        """Predict + resolve every request of the batch."""
        xs = np.stack([r.x for r in live])
        ys, _ = self.pool.predict(xs, replica=replica)
        done = time.monotonic()
        for i, r in enumerate(live):
            r.future.replica = replica
            r.future.batch_seq = seq
            r.future._resolve(ys[i])
            self.stats.on_complete(done - r.t_submit)

    def _fail_batch(self, live: List[_Request], e: BaseException) -> None:
        """Every request of the batch resolves once, with the error, and
        is counted failed."""
        pending = [r for r in live if not r.future.done()]
        self.stats.on_failed(len(pending))
        for r in pending:
            r.future._fail(e)


def serve_stack(
    handle,
    cfg,
    *,
    device=None,
    devices=None,
    seed: int = 0,
    stats: Optional[ServeStats] = None,
    start: bool = True,
):
    """(pool, batcher) wired from a config.ServeConfig — the one-call
    constructor the CLI and chip_smoke.py share. ``device`` defaults to
    CUDA (every visible card) and raises without one; ``device="cpu"``
    runs the plain PyTorch path on the host."""
    from parallel_cnn_tpu_torch.serve.engine import ReplicaPool

    pool = ReplicaPool(
        handle,
        n_replicas=cfg.n_replicas,
        checkpoint=cfg.checkpoint,
        max_batch=cfg.max_batch,
        device=device,
        devices=devices,
        seed=seed,
        precompile=cfg.precompile,
    )
    if stats is None:
        stats = ServeStats()
    batcher = DynamicBatcher(
        pool,
        max_wait_ms=cfg.max_wait_ms,
        queue_depth=cfg.queue_depth,
        deadline_ms=cfg.deadline_ms,
        stats=stats,
        start=start,
    )
    return pool, batcher
