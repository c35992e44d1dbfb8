"""Dynamic batcher: bounded queue → coalesce → bucket-pad → split (the
port's counterpart of ``parallel_cnn_tpu/serve/batcher.py``).

- ``submit`` is non-blocking. A full bounded queue sheds the request with
  the typed ``Overloaded`` error instead of queueing without bound.
- The worker thread pops the oldest request, then coalesces followers
  until ``max_batch`` requests OR ``max_wait_ms`` since the first pop —
  whichever first.
- Requests carry optional deadlines; overdue ones are dropped with
  ``DeadlineExceeded`` when the worker pops them, and again at dispatch.
- An optional admission controller (serve/admission.py) runs in front of
  the queue: ``submit`` consults it before enqueueing (predicted-late and
  degradation-ladder rejects surface as ``Overloaded`` and count as
  sheds), and the worker lets it shrink the coalescing window and cap the
  bucket under pressure. The batcher feeds queue-wait and service-time
  observations back, the service time from the predict, which ends on
  the copy of the logits to the host.
- Formed batches go through one runner thread per replica, so while one
  replica computes, the worker is already coalescing the next batch;
  ``add_runner`` adds one when the autoscaler grows the pool.
- Chaos (resilience/chaos.py): ``slow-replica@SEQ:MS`` stalls the replica
  about to run dispatched batch SEQ, ``kill-replica@SEQ`` kills it. A
  batch whose replica died is retried on a survivor (``_failover``); the
  dead slot is respawned from the host weights.
- Conservation: every submitted request resolves exactly once, across a
  failover too, so ``submitted == completed + shed + expired + failed``,
  in ``ServeStats`` and in the obs journal's counts alike.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import List, Optional

import numpy as np

from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.serve.engine import ReplicaDead
from parallel_cnn_tpu_torch.serve.telemetry import ServeStats

PRIORITIES = ("guaranteed", "best-effort")


class Overloaded(RuntimeError):
    """Request shed: the bounded request queue is full, or the admission
    controller rejected it (backpressure). Clients back off and retry, or
    degrade."""


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
    __slots__ = ("x", "deadline", "t_submit", "priority", "future")

    def __init__(self, x, deadline, t_submit, priority="guaranteed"):
        self.x = x
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.t_submit = t_submit
        self.priority = priority  # "guaranteed" | "best-effort"
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
        obs: Optional["obs_lib.Obs"] = None,
        chaos=None,
        admission=None,
    ):
        self.pool = pool
        # resilience.chaos.ChaosMonkey, or None.
        self.chaos = chaos
        # serve.admission.AdmissionController, or None (admit until the
        # queue is full).
        self.admission = admission
        self.max_batch = pool.max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.default_deadline_s = deadline_ms / 1e3 if deadline_ms else None
        self.stats = stats if stats is not None else ServeStats()
        self.obs = obs if obs is not None else obs_lib.NOOP
        self._queue: "queue_mod.Queue[_Request]" = queue_mod.Queue(
            maxsize=queue_depth
        )
        self._stop = threading.Event()
        self._batch_seq = 0
        # Per-replica in-flight batch counts (formed, not yet finished):
        # the autoscaler's drain barrier. Guarded by _lock, as is
        # _executed (predicts that ran, failover retries included).
        self._lock = threading.Lock()
        self._inflight: dict = {}
        self._executed = 0
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

    def submit(self, x, deadline_ms: Optional[float] = None,
               priority: str = "guaranteed") -> Future:
        """Enqueue one request (a single sample, shape == in_shape).

        Raises Overloaded immediately when the bounded queue is full or
        the admission controller rejects it (both count as sheds).
        ``deadline_ms`` is a per-request budget from now (None keeps the
        batcher default, 0 disables). ``priority`` is "guaranteed" or
        "best-effort", the class the degradation ladder drops first."""
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be 'guaranteed' or 'best-effort', "
                f"got {priority!r}"
            )
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
        req = _Request(x, deadline, now, priority)
        self.stats.on_submit()
        if self.obs.enabled:
            self.obs.event("submit", req=id(req.future))
            self.obs.tracer.begin_async("request", id(req.future))
        if self.admission is not None:
            reason = self.admission.admit(
                priority=priority, deadline=deadline, now=now,
                queue_depth=self._queue.qsize(),
            )
            if reason is not None:
                self._shed(req, reason)
                raise Overloaded(f"admission rejected: {reason}; "
                                 "back off and retry")
        try:
            self._queue.put_nowait(req)
        except queue_mod.Full:
            self._shed(req, "queue full")
            raise Overloaded(
                f"request queue full ({self._queue.maxsize} deep); "
                "back off and retry"
            ) from None
        return req.future

    def _shed(self, req: _Request, reason: str) -> None:
        self.stats.on_shed()
        if self.obs.enabled:
            self.obs.event("shed", req=id(req.future), reason=reason)
            self.obs.tracer.end_async("request", id(req.future))

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            runners = list(self._runners)
        for t in runners:
            t.start()
        self._worker.start()

    def close(self) -> None:
        self._stop.set()
        if self._started:
            self._worker.join(timeout=5)
            with self._lock:
                runners = list(self._runners)
            for t in runners:
                t.join(timeout=5)
        # Fail anything still queued so no client blocks forever.
        for q in (self._queue, self._dispatch):
            while True:
                try:
                    item = q.get_nowait()
                except queue_mod.Empty:
                    break
                reqs = item[0] if isinstance(item, tuple) else [item]
                self._fail_batch(reqs, -1, RuntimeError("batcher closed"))

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- runners and the drain barrier -----------------------------------

    def inflight(self, replica: int) -> int:
        """Batches formed for ``replica`` and not yet finished — the
        autoscaler's drain barrier (a failover retry counts against the
        ORIGINAL replica until the batch resolves)."""
        with self._lock:
            return self._inflight.get(replica, 0)

    @property
    def n_runners(self) -> int:
        with self._lock:
            return len(self._runners)

    @property
    def executed(self) -> int:
        """Predicts that ran to the end, failover retries included: each
        is one forward on the card."""
        with self._lock:
            return self._executed

    def add_runner(self) -> None:
        """Grow the runner pool by one thread (autoscaler scale-up, after
        ReplicaPool.grow appended a replica) and widen the dispatch bound
        so the new replica can hold a batch in flight."""
        with self._lock:
            i = len(self._runners)
            t = threading.Thread(
                target=self._runner_loop, name=f"serve-runner-{i}",
                daemon=True,
            )
            self._runners.append(t)
            if self._started:
                t.start()
        # maxsize belongs to the queue's own mutex, the one put()/get()
        # wait on; taking self._lock too would order the two locks
        # against the worker, which blocks in put() holding neither.
        with self._dispatch.mutex:
            self._dispatch.maxsize += 1
            self._dispatch.not_full.notify()

    # -- worker side ----------------------------------------------------

    def _expire_req(self, r: _Request, now: float, where: str) -> None:
        r.future._fail(DeadlineExceeded(
            f"deadline passed {1e3 * (now - r.deadline):.1f} ms {where}"
        ))
        self.stats.on_expired(1)
        if self.obs.enabled:
            self.obs.event("expired", req=id(r.future))
            self.obs.tracer.end_async("request", id(r.future))

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
            # The degradation ladder may shrink the coalescing window and
            # cap the bucket under pressure.
            wait_s = self.max_wait_s
            cap = self.max_batch
            if self.admission is not None:
                wait_s = self.admission.effective_wait_s(wait_s)
                cap = self.admission.effective_max_batch(cap)
            batch = [first]
            t0 = time.monotonic()
            with self.obs.span("serve.coalesce", cat="serve"):
                while len(batch) < cap:
                    remaining = t0 + wait_s - time.monotonic()
                    if remaining <= 0:
                        break
                    r = self._pop_live(timeout=remaining)
                    if r is None:
                        break
                    batch.append(r)
            now = time.monotonic()
            live: List[_Request] = []
            n_expired = 0
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    self._expire_req(r, now, "before dispatch")
                    n_expired += 1
                else:
                    live.append(r)
            if not live:
                continue
            try:
                replica = self.pool.next_replica()
            except ReplicaDead as e:
                self._fail_batch(live, -1, e)
                continue
            seq = self._batch_seq
            self._batch_seq += 1
            bucket = self.pool.engines[replica].bucket_for(len(live))
            self.stats.on_batch(
                n=len(live),
                bucket=bucket,
                replica=replica,
                queue_depth=self._queue.qsize(),
            )
            if self.admission is not None:
                self.admission.observe_queue_wait(
                    max(now - r.t_submit for r in live)
                )
            if self.obs.enabled:
                self.obs.event(
                    "batch", seq=seq, n=len(live), bucket=bucket,
                    replica=replica, expired=n_expired,
                )
            with self._lock:
                self._inflight[replica] = self._inflight.get(replica, 0) + 1
            # Blocks while every runner is busy — deliberate backpressure.
            while not self._stop.is_set():
                try:
                    self._dispatch.put((live, replica, seq), timeout=0.05)
                    break
                except queue_mod.Full:
                    continue
            else:
                with self._lock:
                    self._inflight[replica] -= 1
                self._fail_batch(live, seq, RuntimeError("batcher closed"))

    def _runner_loop(self) -> None:
        while not self._stop.is_set():
            try:
                live, replica, seq = self._dispatch.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            try:
                self._run_batch(live, replica, seq)
            finally:
                with self._lock:
                    self._inflight[replica] -= 1

    def _run_batch(self, live: List[_Request], replica: int, seq: int) -> None:
        if self.chaos is not None:
            stall_ms = self.chaos.slow_replica_at(seq)
            if stall_ms is not None:
                # The replica straggles: the batch, and the queue behind
                # it, eat the stall the SLO gate watches for.
                if self.obs.enabled:
                    self.obs.event("chaos_slow_replica", seq=seq,
                                   replica=replica, ms=stall_ms)
                time.sleep(stall_ms / 1e3)
            if self.chaos.kill_replica_at(seq):
                # The replica dies the instant before its predict, where a
                # real mid-traffic loss would surface (ReplicaDead).
                self.pool.kill(replica)
        try:
            with self.obs.span(
                "serve.batch", cat="serve",
                seq=seq, replica=replica, n=len(live),
            ):
                self._resolve_batch(live, replica, seq)
        except ReplicaDead:
            self._failover(live, replica, seq)
        except Exception as e:  # noqa: BLE001 — forwarded to clients
            self._fail_batch(live, seq, e)

    def _resolve_batch(self, live: List[_Request], replica: int,
                       seq: int) -> None:
        """Predict + resolve, the one dispatch site of the normal path and
        of the failover's retry. ReplicaDead propagates BEFORE any future
        resolves (the pool checks the replica first), so a retried batch
        is still whole."""
        xs = np.stack([r.x for r in live])
        t_exec = time.monotonic()
        ys, _ = self.pool.predict(xs, replica=replica)
        done = time.monotonic()
        with self._lock:
            self._executed += 1
        if self.admission is not None:
            self.admission.observe_service(
                self.pool.engines[replica].bucket_for(len(live)),
                done - t_exec,
            )
        for i, r in enumerate(live):
            r.future.replica = replica
            r.future.batch_seq = seq
            r.future._resolve(ys[i])
            self.stats.on_complete(done - r.t_submit)
            if self.obs.enabled:
                self.obs.event(
                    "complete", req=id(r.future), seq=seq,
                    replica=replica,
                    latency_ms=1e3 * (done - r.t_submit),
                )
                self.obs.tracer.end_async("request", id(r.future))

    def _fail_batch(self, live: List[_Request], seq: int,
                    e: BaseException) -> None:
        """Every still-pending request of the batch resolves once, with
        the error, and is counted failed."""
        pending = [r for r in live if not r.future.done()]
        self.stats.on_failed(len(pending))
        for r in pending:
            r.future._fail(e)
            if self.obs.enabled:
                self.obs.event("failed", req=id(r.future), seq=seq)
                self.obs.tracer.end_async("request", id(r.future))

    def _failover(self, live: List[_Request], dead: int, seq: int) -> None:
        """Replica ``dead`` died with this batch in flight: evict it, retry
        the still-within-deadline requests on a survivor, and re-pin a
        replacement.

        Every request of ``live`` resolves exactly once: completed (the
        retry landed), expired (its deadline passed before the retry), or
        failed (the retry failed, or no survivor was available)."""
        self.pool.evict(dead)
        if self.obs.enabled:
            self.obs.event("replica_evicted", replica=dead, seq=seq)
        now = time.monotonic()
        retry: List[_Request] = []
        for r in live:
            if r.deadline is not None and now > r.deadline:
                self._expire_req(r, now, "into replica failover")
            else:
                retry.append(r)
        respawned = False
        try:
            if retry:
                try:
                    survivor = self.pool.next_replica()
                except ReplicaDead:
                    # A pool of one (or total loss): the replacement IS
                    # the survivor.
                    survivor = self.pool.respawn(dead)
                    respawned = True
                    if self.obs.enabled:
                        self.obs.event("replica_respawned", replica=dead,
                                       seq=seq)
                if self.obs.enabled:
                    self.obs.event(
                        "failover", seq=seq, dead=dead, survivor=survivor,
                        n=len(retry), expired=len(live) - len(retry),
                    )
                self._resolve_batch(retry, survivor, seq)
        except Exception as e:  # noqa: BLE001 — forwarded to clients
            self._fail_batch(retry, seq, e)
        finally:
            if not respawned:
                self.pool.respawn(dead)
                if self.obs.enabled:
                    self.obs.event("replica_respawned", replica=dead, seq=seq)


def serve_stack(
    handle,
    cfg,
    *,
    device=None,
    devices=None,
    seed: int = 0,
    stats: Optional[ServeStats] = None,
    start: bool = True,
    obs: Optional["obs_lib.Obs"] = None,
    chaos=None,
    admission=None,
    cache_dir=None,
):
    """(pool, batcher) wired from a config.ServeConfig — the one-call
    constructor the CLI and chip_smoke.py share. ``device`` defaults to
    CUDA (every visible card) and raises without one; ``device="cpu"``
    runs the plain PyTorch path on the host. ``chaos`` (a ChaosMonkey)
    arms kill-replica / slow-replica; ``admission`` overrides the
    controller, which is otherwise built when ``cfg.admission`` is set.
    JAX's ``cache_dir`` (the on-disk executable cache) is not ported."""
    from parallel_cnn_tpu_torch.config import NotPortedError
    from parallel_cnn_tpu_torch.serve.engine import ReplicaPool

    if cache_dir is not None:
        raise NotPortedError("serve_stack(cache_dir=...), the persistent "
                             "executable cache, comes with ROADMAP A12b")
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
    if admission is None and cfg.admission:
        from parallel_cnn_tpu_torch.serve.admission import AdmissionController

        admission = AdmissionController(
            slo_ms=cfg.slo_ms, queue_depth=cfg.queue_depth, obs=obs,
        )
    if stats is None:
        stats = ServeStats(window_s=cfg.window_s)
    batcher = DynamicBatcher(
        pool,
        max_wait_ms=cfg.max_wait_ms,
        queue_depth=cfg.queue_depth,
        deadline_ms=cfg.deadline_ms,
        stats=stats,
        start=start,
        obs=obs,
        chaos=chaos,
        admission=admission,
    )
    return pool, batcher
