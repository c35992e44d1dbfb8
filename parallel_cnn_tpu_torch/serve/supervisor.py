"""Endpoint supervision and zero-downtime weight hot-swap (the port's
copy of ``parallel_cnn_tpu/serve/supervisor.py``).

Two recovery paths for the network front door (serve/net.py), both
built from machinery the port already has:

- :class:`Supervisor` — crash-fast cold restart. A monitor thread
  watches the endpoint; when it dies (``kill-endpoint@`` chaos, or any
  abrupt ``kill()``), the supervisor respawns it **on the same port**
  under the bounded, seeded exponential backoff of
  ``resilience.retry.RetryPolicy`` — no infinite respawn loops by
  construction. The respawn is journaled ``endpoint_respawned`` with
  the measured downtime; the killed endpoint already journaled its
  in-flight wire requests as ``net_failed`` (net.py), so the journal
  reconciles exactly across the restart: nothing is silently lost, and
  the wire conservation law — computed over the WireStats *shared*
  across incarnations — keeps holding.

- :func:`hot_swap` — zero-downtime weight replacement. New weights go
  to ``ReplicaPool.set_weights`` (so every replica built from now on
  serves them), then each old replica is rolled: grow a fresh replica
  (new weights, copied to its device) + widen the batcher's runner
  pool, ``drain`` the old one, poll ``batcher.inflight`` to zero,
  ``retire`` it (its device weights go with it) — the same
  drain-then-retire barrier the autoscaler's scale-down uses, which is
  exactly why in-flight requests never die during a swap. The bracket
  is journaled ``hot_swap_begin`` / ``hot_swap_done``; the report
  carries the ``failed`` delta across the swap window so callers can
  gate on *zero failed during swap* plus conservation.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from torch import nn

from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.resilience.retry import RetryPolicy, retry_call
from parallel_cnn_tpu_torch.serve.net import NetServer


class Supervisor:
    """Respawn a killed NetServer on its original port with bounded
    backoff.

    ``factory(port, seq_start) -> NetServer`` must return a *started*
    endpoint bound to ``port`` (0 on the first spawn picks an ephemeral
    port; every respawn passes the concrete port back so the address is
    stable across restarts). ``seq_start`` is the killed endpoint's
    wire-sequence watermark — the replacement continues the numbering,
    so a one-shot chaos schedule can't re-fire in the new incarnation.
    The factory should close over the shared WireStats and hand it to
    each incarnation.

    ``enabled=False`` builds the no-recovery control arm: the endpoint
    stays dead, clients exhaust their retries, and the scenario gate
    trips — the anti-vacuity proof that supervision is load-bearing.
    """

    def __init__(
        self,
        factory: Callable[[int, int], NetServer],
        *,
        policy: Optional[RetryPolicy] = None,
        obs: Optional["obs_lib.Obs"] = None,
        enabled: bool = True,
        port: int = 0,
        poll_interval_s: float = 0.005,
    ):
        self.factory = factory
        self.policy = policy or RetryPolicy(
            attempts=4, base_delay=0.05, max_delay=1.0, seed=0,
        )
        self.obs = obs if obs is not None else obs_lib.NOOP
        self.enabled = enabled
        self.poll_interval_s = poll_interval_s
        self._port_pref = port
        self._lock = threading.Lock()
        self._server: Optional[NetServer] = None
        self._closing = False
        self._respawns = 0
        self._gave_up = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Supervisor":
        srv = self.factory(self._port_pref, 0)
        thread = threading.Thread(
            target=self._monitor, name="serve-supervisor", daemon=True,
        )
        with self._lock:
            self._server = srv
            self._thread = thread
        thread.start()
        return self

    @property
    def server(self) -> Optional[NetServer]:
        with self._lock:
            return self._server

    @property
    def address(self) -> Tuple[str, int]:
        srv = self.server
        if srv is None:
            raise RuntimeError("supervisor not started")
        return srv.address

    @property
    def respawns(self) -> int:
        with self._lock:
            return self._respawns

    @property
    def gave_up(self) -> bool:
        """True when a respawn exhausted its retry budget — the bounded
        failure mode (supervision never loops forever)."""
        with self._lock:
            return self._gave_up

    def close(self) -> None:
        with self._lock:
            self._closing = True
            srv = self._server
        if srv is not None:
            srv.close()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5)

    def __enter__(self) -> "Supervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the watch loop --------------------------------------------------

    def _monitor(self) -> None:
        while True:
            with self._lock:
                if self._closing:
                    return
                srv = self._server
            if srv is not None and srv.killed:
                if not self.enabled:
                    # Control arm: observe the death, recover nothing.
                    return
                if not self._respawn(srv):
                    return
            time.sleep(self.poll_interval_s)

    def _respawn(self, dead: NetServer) -> bool:
        t0 = time.monotonic()
        port = dead.port  # same address across incarnations
        seq_start = dead.next_seq()
        try:
            fresh = retry_call(
                self.factory, port, seq_start,
                policy=self.policy.decorrelated(self._respawns),
                retry_on=(OSError,),
                describe=f"respawn endpoint :{port}",
            )
        except OSError:
            with self._lock:
                self._gave_up = True
            if self.obs.enabled:
                self.obs.event(
                    "endpoint_respawn_gave_up", port=port,
                    attempts=self.policy.attempts,
                )
            return False
        downtime_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            self._server = fresh
            self._respawns += 1
            n = self._respawns
        if self.obs.enabled:
            self.obs.event(
                "endpoint_respawned", port=fresh.port, respawns=n,
                downtime_ms=downtime_ms, seq_start=seq_start,
            )
        return True


def armed_factory(batcher, wire, chaos=None, **server_kw) -> Callable[[int, int], NetServer]:
    """A Supervisor factory of started NetServers over one ``batcher`` and
    one shared ``wire``: the FIRST incarnation carries ``chaos``, every
    respawn comes up clean, so a one-shot ``kill-endpoint@SEQ`` cannot
    replay across restarts. ``server_kw`` go to each NetServer (host,
    conn_deadline_ms, obs)."""
    armed = [chaos]

    def factory(port: int, seq_start: int) -> NetServer:
        chaos_now = armed.pop() if armed else None
        return NetServer(batcher, port=port, wire=wire, chaos=chaos_now,
                         seq_start=seq_start, **server_kw).start()

    return factory


def hot_swap(
    pool,
    batcher,
    model: nn.Module,
    *,
    obs: Optional["obs_lib.Obs"] = None,
    drain_timeout_s: float = 10.0,
    poll_interval_s: float = 0.002,
) -> Dict[str, Any]:
    """Roll the pool onto new weights with zero downtime and zero failed
    requests.

    ``model`` is the new weights on the host (``load_or_init``'s module).
    Sequence (per old replica, one at a time so capacity never dips):
    grow a fresh replica — which copies the *new* host-side weights
    installed via ``pool.set_weights`` to its device — widen the batcher's
    runner pool to match, then drain → poll in-flight to zero → retire
    the old one. A drain that never empties within ``drain_timeout_s``
    is un-drained (the replica returns to rotation, still on old
    weights) and reported rather than force-killed: a stuck swap must
    not become the outage it was avoiding. A retired replica gives its
    device weights back (``ReplicaPool.retire``).

    Returns a report dict: ``swapped`` / ``stuck`` slot lists, ``grown``
    slots, wall-clock ``seconds``, and ``failed_delta`` — the change in
    the batcher's ``failed`` counter across the swap window, which the
    scenario gate requires to be exactly 0.
    """
    obs = obs if obs is not None else obs_lib.NOOP
    t0 = time.monotonic()
    old = pool.routable()
    before = batcher.stats.snapshot()
    if obs.enabled:
        obs.event("hot_swap_begin", old_replicas=old)
    pool.set_weights(model)
    grown: List[int] = []
    swapped: List[int] = []
    stuck: List[int] = []
    for victim in old:
        fresh = pool.grow()
        grown.append(fresh)
        while pool.n_replicas > batcher.n_runners:
            batcher.add_runner()
        pool.drain(victim)
        deadline = time.monotonic() + drain_timeout_s
        while batcher.inflight(victim) > 0:
            if time.monotonic() > deadline:
                break
            time.sleep(poll_interval_s)
        if batcher.inflight(victim) > 0:
            pool.undrain(victim)
            stuck.append(victim)
            continue
        pool.retire(victim)
        swapped.append(victim)
    after = batcher.stats.snapshot()
    report = {
        "old": old,
        "grown": grown,
        "swapped": swapped,
        "stuck": stuck,
        "seconds": time.monotonic() - t0,
        "failed_delta": after["failed"] - before["failed"],
    }
    if obs.enabled:
        obs.event("hot_swap_done", **report)
    return report
