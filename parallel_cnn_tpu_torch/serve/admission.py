"""SLO admission control: reject-early shedding and the graceful
degradation ladder in front of the dynamic batcher (the port's copy of
``parallel_cnn_tpu/serve/admission.py``; its verdicts equal JAX's on the
same clock and observations).

Why a controller in front of a bounded queue that already sheds: the
queue sheds on *occupancy* — a request admitted into a deep backlog
still waits the whole backlog out, misses its deadline, and wastes a
queue slot (and possibly a device slot) producing an answer nobody
reads. The admission controller sheds on *prediction* instead:

- **EWMA estimators.** The batcher feeds back the queue wait of every
  dispatched batch (``observe_queue_wait``) and the device time of
  every executed bucket (``observe_service``: the predict's host time,
  which ends on the copy of the logits to the host, so it spans the
  device's work). ``predicted_wait_s`` combines them — the wait a
  request admitted *now* should expect.
- **Reject-early.** A request whose deadline would already be missed by
  the predicted completion time is rejected at submit
  (``Overloaded``, counted as a shed — conservation holds), freeing
  the client to retry elsewhere immediately instead of after a doomed
  queue wait.
- **Degradation ladder.** Queue pressure (fill fraction, hysteresis
  bands so the level does not flap) walks a 4-level ladder:

      L0 normal            everything admitted, full coalescing window
      L1 shrink-wait       coalescing window cut to 1/4 — latency first
      L2 cap-bucket        batch bucket halved — bound per-batch service
      L3 shed-best-effort  best-effort priority class rejected outright

  Every transition is journaled (``admission_level`` obs event) so a
  pressure excursion is reconstructable from the journal alone.

The controller is clock-injectable and lock-guarded; the batcher calls
``admit`` on the submit path and the effective-knob getters on the
worker path, so everything here must stay a few arithmetic ops.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from parallel_cnn_tpu_torch import obs as obs_lib

#: Ladder level names, L0..L3 (index == level).
LEVELS = ("normal", "shrink-wait", "cap-bucket", "shed-best-effort")

#: Queue fill fraction at which level i+1 engages…
_UP = (0.50, 0.75, 0.90)
#: …and the fill fraction below which it releases (hysteresis band).
_DOWN = (0.30, 0.55, 0.70)


class AdmissionController:
    """Per-request admission verdicts + the degradation ladder.

    ``slo_ms`` is the default completion objective used when a request
    carries no deadline of its own; ``queue_depth`` must match the
    batcher's bound (fill fraction is the pressure signal).
    """

    def __init__(
        self,
        *,
        slo_ms: float = 100.0,
        queue_depth: int = 256,
        ewma_alpha: float = 0.3,
        obs: Optional["obs_lib.Obs"] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.slo_ms = slo_ms
        self.queue_depth = queue_depth
        self.ewma_alpha = ewma_alpha
        self.obs = obs if obs is not None else obs_lib.NOOP
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0
        self._queue_wait_ewma: Optional[float] = None   # seconds
        self._service_ewma: Dict[int, float] = {}       # bucket → seconds
        self._last_arrival: Optional[float] = None      # monotonic seconds
        self._interarrival_ewma: Optional[float] = None  # seconds between
        self._admitted = 0
        self._rejected_late = 0
        self._rejected_ladder = 0

    # -- estimator feedback (batcher worker/runner call these) ----------

    def observe_queue_wait(self, wait_s: float) -> None:
        """Batch-formation feedback: the longest queue wait in the batch
        just dispatched (the pessimistic end — admission should be)."""
        with self._lock:
            prev = self._queue_wait_ewma
            self._queue_wait_ewma = (
                wait_s if prev is None
                else prev + self.ewma_alpha * (wait_s - prev)
            )

    def observe_service(self, bucket: int, service_s: float) -> None:
        """Execution feedback: device time for one batch of ``bucket``."""
        with self._lock:
            prev = self._service_ewma.get(bucket)
            self._service_ewma[bucket] = (
                service_s if prev is None
                else prev + self.ewma_alpha * (service_s - prev)
            )

    def _observe_arrival(self, now: float) -> None:
        """Demand feedback: every submit (admitted OR shed — offered
        load is the signal, not carried load) updates the interarrival
        EWMA the capacity planner reads through ``arrival_rate``."""
        with self._lock:
            last = self._last_arrival
            self._last_arrival = now
            if last is None:
                return
            dt = max(now - last, 1e-6)  # same-tick bursts still count
            prev = self._interarrival_ewma
            self._interarrival_ewma = (
                dt if prev is None
                else prev + self.ewma_alpha * (dt - prev)
            )

    def arrival_rate(self) -> float:
        """Offered load in requests/s (1 / interarrival EWMA); 0.0 until
        two arrivals have been seen — a cold estimate predicts nothing,
        so the capacity planner falls back to the reactive loop."""
        with self._lock:
            ia = self._interarrival_ewma
            return 1.0 / ia if ia else 0.0

    def predicted_wait_s(self) -> float:
        """Expected submit→result time for a request admitted now:
        EWMA queue wait + the slowest bucket's EWMA service time (a new
        request may coalesce into any bucket; the pessimistic bound is
        what a deadline promise must survive). 0.0 until the first
        observations arrive — a cold controller admits everything."""
        with self._lock:
            wait = self._queue_wait_ewma or 0.0
            service = max(self._service_ewma.values(), default=0.0)
            return wait + service

    # -- ladder ---------------------------------------------------------

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def level_name(self) -> str:
        return LEVELS[self.level]

    def _update_level(self, queue_depth: int) -> int:
        """Walk the ladder one rung per call toward the fill fraction's
        band (hysteresis: the engage and release thresholds differ, so
        a fill hovering at one threshold cannot flap the level)."""
        fill = queue_depth / self.queue_depth
        with self._lock:
            old = self._level
            if old < len(_UP) and fill >= _UP[old]:
                self._level = old + 1
            elif old > 0 and fill < _DOWN[old - 1]:
                self._level = old - 1
            new = self._level
        if new != old and self.obs.enabled:
            self.obs.event(
                "admission_level",
                old=LEVELS[old], new=LEVELS[new],
                fill=round(fill, 3),
            )
        return new

    def effective_wait_s(self, base_s: float) -> float:
        """Coalescing window under the ladder: L1+ cuts it to 1/4 —
        under pressure, stop waiting for stragglers to fill buckets."""
        return base_s / 4.0 if self.level >= 1 else base_s

    def effective_max_batch(self, base: int) -> int:
        """Bucket cap under the ladder: L2+ halves it — smaller batches
        bound the per-batch service time a queued request waits behind."""
        return max(1, base // 2) if self.level >= 2 else base

    # -- the verdict ----------------------------------------------------

    def admit(
        self,
        *,
        priority: str,
        deadline: Optional[float],
        now: Optional[float] = None,
        queue_depth: int = 0,
    ) -> Optional[str]:
        """None to admit, else the rejection reason (the batcher raises
        it as ``Overloaded`` and counts a shed).

        ``deadline`` is absolute monotonic seconds (None → the
        controller's own slo_ms budget is the objective)."""
        now = self._clock() if now is None else now
        self._observe_arrival(now)
        level = self._update_level(queue_depth)
        if level >= 3 and priority == "best-effort":
            with self._lock:
                self._rejected_ladder += 1
            return (
                f"degradation level {LEVELS[level]} sheds "
                "best-effort traffic"
            )
        predicted = self.predicted_wait_s()
        budget = (
            deadline - now if deadline is not None else self.slo_ms / 1e3
        )
        if predicted > budget:
            with self._lock:
                self._rejected_late += 1
            return (
                f"predicted completion {1e3 * predicted:.1f} ms exceeds "
                f"the {1e3 * budget:.1f} ms budget"
            )
        with self._lock:
            self._admitted += 1
        return None

    def snapshot(self) -> Dict[str, Any]:
        """Controller state for the metrics registry / debugging."""
        with self._lock:
            return {
                "level": self._level,
                "level_name": LEVELS[self._level],
                "admitted": self._admitted,
                "rejected_late": self._rejected_late,
                "rejected_ladder": self._rejected_ladder,
                "queue_wait_ewma_ms": (
                    1e3 * self._queue_wait_ewma
                    if self._queue_wait_ewma is not None else None
                ),
                "service_ewma_ms": {
                    b: 1e3 * s for b, s in self._service_ewma.items()
                },
                "arrival_rate_rps": (
                    1.0 / self._interarrival_ewma
                    if self._interarrival_ewma else 0.0
                ),
            }

    def attach_registry(self, registry, prefix: str = "admission") -> None:
        """Expose the controller through an obs.MetricsRegistry (same
        pull-collector convention as ServeStats.attach_registry)."""
        registry.attach(prefix, self.snapshot)
