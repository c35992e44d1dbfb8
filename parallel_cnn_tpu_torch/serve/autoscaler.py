"""Replica autoscaler: a windowed-signal control loop over ReplicaPool
(the port's copy of ``parallel_cnn_tpu/serve/autoscaler.py``; its
decisions equal JAX's on the same clock and signals).

The control problem: the serving stack's capacity knob is the replica
count, but the signals that say "wrong size" (shed rate, p99, batch
occupancy) are noisy and lag the load. The loop therefore reads the
*windowed* ServeStats views (exponentially decayed — recent traffic
dominates, serve/telemetry.py) and applies two classic stabilizers:

- **hysteresis** — a direction must persist for ``hysteresis``
  consecutive ticks before the loop acts, so a single noisy window
  cannot trigger a resize;
- **cooldown** — after any action, no further action for
  ``cooldown_s``, so the loop observes the *consequence* of a resize
  before considering the next one (the no-flapping guarantee: at most
  one direction change per cooldown window).

Scale-up reuses the failover machinery: ``ReplicaPool.grow`` revives a
retired slot via the respawn path (or appends a fresh pinned Engine, its
weights copied to the card from the pool's host copy) and the batcher
gains a runner thread so the new replica can actually hold a batch in
flight. Scale-down is drain-then-retire: the victim becomes unroutable
(``pool.drain``), the loop waits for its in-flight count to reach zero
(``batcher.inflight``), then frees the slot and the engine's device
weights — zero in-flight requests are lost by construction.

The reactive loop is by construction *late*: it waits for a symptom
(p99 bust, shed) and then pays hysteresis ticks.  Passing a
``capacity`` planner (serve/capacity.py) adds a **predictive**
feed-forward branch: when the planner's replicas-needed estimate —
arrival-rate EWMA over per-replica service rate, with headroom —
exceeds the routable count, the loop scales up immediately, *before*
the windowed p99 busts the SLO.  The predictive branch skips
hysteresis (the EWMAs are the noise filter) but still honours the
cooldown and ``max_replicas``; while the planner is cold it returns
``None`` and the reactive classifier is the only voice.  With
``capacity=None`` the loop is the purely reactive scaler.

Every decision lands in the event journal (``scale_up`` /
``scale_down`` events, each carrying the ``reason`` —
"predictive"/"reactive") and the metrics registry
(``attach_registry``), so a capacity timeline is reconstructable from
the obs artifacts.

``tick()`` is the testable unit (no thread, injectable clock);
``start()``/``close()`` wrap it in the background control loop.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from parallel_cnn_tpu_torch import obs as obs_lib


class AutoScaler:
    """Grows/shrinks a ReplicaPool between ``min_replicas`` and
    ``max_replicas`` from the batcher's windowed telemetry.

    Overload: windowed shed rate > ``shed_high`` OR windowed p99 >
    ``slo_ms``. Underload: no recent sheds, p99 comfortably inside the
    SLO, and batch occupancy below ``occupancy_low`` (or no traffic at
    all) — capacity is padding batches instead of serving them.
    """

    def __init__(
        self,
        pool,
        batcher,
        *,
        min_replicas: int = 1,
        max_replicas: int = 2,
        slo_ms: float = 100.0,
        shed_high: float = 0.05,
        occupancy_low: float = 0.30,
        hysteresis: int = 2,
        cooldown_s: float = 2.0,
        interval_s: float = 0.25,
        drain_timeout_s: float = 10.0,
        capacity=None,
        obs: Optional["obs_lib.Obs"] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}"
            )
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        if cooldown_s < 0 or interval_s <= 0:
            raise ValueError("cooldown_s must be >= 0, interval_s > 0")
        self.pool = pool
        self.batcher = batcher
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.slo_ms = slo_ms
        self.shed_high = shed_high
        self.occupancy_low = occupancy_low
        self.hysteresis = hysteresis
        self.cooldown_s = cooldown_s
        self.interval_s = interval_s
        self.drain_timeout_s = drain_timeout_s
        #: Optional serve.capacity.CapacityModel — enables the
        #: predictive feed-forward branch of tick().
        self.capacity = capacity
        self.obs = obs if obs is not None else obs_lib.NOOP
        self._clock = clock
        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        self._predictive_ups = 0
        self._last_action_t: Optional[float] = None
        #: (t, direction, replica) decision log — tests replay it.
        self.actions: List[Tuple[float, str, int]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the control step -----------------------------------------------

    def _classify(self) -> Optional[str]:
        """"up", "down", or None from the windowed signals."""
        stats = self.batcher.stats
        shed = stats.window_shed_rate()
        p99 = stats.window_p99_ms()
        occ = stats.window_occupancy()
        if shed > self.shed_high or (p99 is not None and p99 > self.slo_ms):
            return "up"
        if shed <= 1e-9 and (p99 is None or p99 <= 0.5 * self.slo_ms) \
                and (occ is None or occ < self.occupancy_low):
            return "down"
        return None

    def tick(self) -> Optional[str]:
        """One control step; returns the action taken ("up"/"down") or
        None. Hysteresis and cooldown are enforced here, so calling
        tick() faster changes nothing but reaction latency."""
        now = self._clock()
        # Feed-forward first: if the capacity planner predicts demand
        # beyond the routable fleet, grow NOW — no hysteresis (the
        # planner's EWMAs are the noise filter), but cooldown and
        # max_replicas still bound the step.  A cold planner returns
        # None and the reactive classifier below is the only voice.
        if self.capacity is not None:
            with self._lock:
                in_cooldown = (
                    self._last_action_t is not None
                    and now - self._last_action_t < self.cooldown_s
                )
            if not in_cooldown:
                needed = self.capacity.replicas_needed()
                if needed is not None and needed > len(self.pool.routable()):
                    acted = self._scale_up(now, reason="predictive")
                    if acted is not None:
                        with self._lock:
                            self._predictive_ups += 1
                        return acted
        want = self._classify()
        with self._lock:
            if want == "up":
                self._up_streak += 1
                self._down_streak = 0
            elif want == "down":
                self._down_streak += 1
                self._up_streak = 0
            else:
                self._up_streak = 0
                self._down_streak = 0
            in_cooldown = (
                self._last_action_t is not None
                and now - self._last_action_t < self.cooldown_s
            )
            act_up = (not in_cooldown
                      and self._up_streak >= self.hysteresis)
            act_down = (not in_cooldown and not act_up
                        and self._down_streak >= self.hysteresis)
        if act_up:
            return self._scale_up(now)
        if act_down:
            return self._scale_down(now)
        return None

    def _record(self, now: float, direction: str, replica: int) -> None:
        with self._lock:
            self._last_action_t = now
            self._up_streak = 0
            self._down_streak = 0
            self.actions.append((now, direction, replica))

    def _scale_up(self, now: float, reason: str = "reactive") -> Optional[str]:
        if len(self.pool.routable()) >= self.max_replicas:
            return None
        i = self.pool.grow()
        # A grown slot beyond the runner count needs its own runner
        # thread (a revived slot reuses the one it always had).
        while self.pool.n_replicas > self.batcher.n_runners:
            self.batcher.add_runner()
        self._record(now, "up", i)
        if self.obs.enabled:
            self.obs.event("scale_up", replica=i, reason=reason,
                           routable=len(self.pool.routable()))
        return "up"

    def _scale_down(self, now: float) -> Optional[str]:
        routable = self.pool.routable()
        if len(routable) <= self.min_replicas:
            return None
        victim = routable[-1]
        self.pool.drain(victim)
        # Drain barrier: wait for the victim's in-flight batches to
        # resolve; nothing new routes to it once draining.
        deadline = time.monotonic() + self.drain_timeout_s
        while self.batcher.inflight(victim) > 0:
            if time.monotonic() > deadline:
                # In-flight work would not finish — undo the drain
                # rather than retire a busy replica.
                self.pool.respawn(victim)
                return None
            time.sleep(0.001)
        self.pool.retire(victim)
        self._record(now, "down", victim)
        if self.obs.enabled:
            self.obs.event("scale_down", replica=victim, reason="reactive",
                           routable=len(self.pool.routable()))
        return "down"

    # -- lifecycle + exposition -----------------------------------------

    def start(self) -> "AutoScaler":
        with self._lock:
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._loop, name="serve-autoscaler", daemon=True
            )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.interval_s)

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=5)

    def __enter__(self) -> "AutoScaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def direction_changes(self) -> int:
        """Number of up↔down flips in the decision log (the flapping
        metric the no-flapping acceptance gate pins)."""
        with self._lock:
            dirs = [d for _, d, _ in self.actions]
        return sum(1 for a, b in zip(dirs, dirs[1:]) if a != b)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            ups = sum(1 for _, d, _ in self.actions if d == "up")
            downs = sum(1 for _, d, _ in self.actions if d == "down")
            predictive = self._predictive_ups
        return {
            "routable": len(self.pool.routable()),
            "min": self.min_replicas,
            "max": self.max_replicas,
            "scale_ups": ups,
            "scale_downs": downs,
            "predictive_ups": predictive,
            "direction_changes": self.direction_changes(),
        }

    def attach_registry(self, registry, prefix: str = "autoscaler") -> None:
        """Expose the decision counters through an obs.MetricsRegistry
        (same pull-collector convention as ServeStats)."""
        registry.attach(prefix, self.snapshot)
