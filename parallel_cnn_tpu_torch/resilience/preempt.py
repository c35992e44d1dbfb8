"""Preemption safety: SIGTERM/SIGINT → "checkpoint and stop cleanly" (the
port's copy of ``parallel_cnn_tpu/resilience/preempt.py``, with its
elastic resize channel).

The signal sets a flag; the epoch loop polls ``requested()`` at its
checkpoint boundary, flushes the final atomic checkpoint through the
normal per-epoch path and returns, so ``--resume`` continues bit-exactly.
The resize channel (``request_resize``) carries a payload instead: the
data world is about to become N ranks, and the elastic controller
(resilience/elastic.py) consumes it at the next optimizer step. The
channel is per process; a run of several ranks agrees on rank 0's.
The handler only records the request (Python runs it between bytecodes on
the main thread, possibly mid-step). A second signal restores the default
disposition and re-raises: Ctrl-C twice still exits at once.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Dict, Tuple

log = logging.getLogger(__name__)

_flag = threading.Event()
_installed: Dict[int, object] = {}

DEFAULT_SIGNALS: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)


def _handler(signum, frame):
    if _flag.is_set():
        # Second signal: the operator means it — restore the default
        # disposition and deliver the signal for real.
        uninstall()
        signal.raise_signal(signum)
        return
    _flag.set()
    log.warning(
        "received %s: will flush a checkpoint and stop at the next epoch "
        "boundary (signal again to exit immediately)",
        signal.Signals(signum).name,
    )


def install(signals: Tuple[int, ...] = DEFAULT_SIGNALS) -> bool:
    """Install the graceful handlers; returns False off the main thread
    (signal.signal is main-thread-only) — callers degrade to no preemption
    handling rather than crashing."""
    if threading.current_thread() is not threading.main_thread():
        log.debug("preempt.install skipped: not on the main thread")
        return False
    for sig in signals:
        if sig not in _installed:
            _installed[sig] = signal.signal(sig, _handler)
    return True


def uninstall() -> None:
    """Restore the pre-install handlers (idempotent)."""
    while _installed:
        sig, old = _installed.popitem()
        signal.signal(sig, old)


def requested() -> bool:
    """True once a shutdown signal arrived; poll at safe boundaries."""
    return _flag.is_set()


def reset() -> None:
    _flag.clear()


# --- elastic resize channel -------------------------------------------
#
# Distinct from the shutdown flag on purpose: a resize request must not
# make PreemptionGuard report the run as preempted.

_resize_lock = threading.Lock()
_resize_world: list = []  # empty = no pending request; else [target_world]


def request_resize(world: int) -> None:
    """Announce a pending world-size change to ``world`` ranks.
    Thread-safe; the newest request wins if several arrive between
    polls."""
    if world < 1:
        raise ValueError(f"resize target must be >= 1, got {world}")
    with _resize_lock:
        _resize_world[:] = [world]
    log.warning(
        "resize requested: world -> %d at the next microbatch boundary",
        world,
    )


def resize_requested() -> "int | None":
    """The pending target world size, or None. Does not consume it."""
    with _resize_lock:
        return _resize_world[0] if _resize_world else None


def clear_resize() -> "int | None":
    """Consume and return the pending resize request (None if absent)."""
    with _resize_lock:
        if _resize_world:
            world = _resize_world[0]
            _resize_world.clear()
            return world
        return None


class PreemptionGuard:
    """Scoped install/uninstall; reads back whether a preemption fired.

    The flag is intentionally NOT cleared on exit — the CLI inspects
    ``guard.preempted`` (or ``requested()``) after the training call
    returns to decide between "finished" and "preempted" exits. Call
    ``reset()`` explicitly to reuse the process (tests do).
    """

    def __init__(self, signals: Tuple[int, ...] = DEFAULT_SIGNALS):
        self.signals = signals
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        self.installed = install(self.signals)
        return self

    def __exit__(self, *exc) -> None:
        self.preempted = requested()
        uninstall()

    @property
    def preempted(self) -> bool:
        return getattr(self, "_preempted", False) or requested()

    @preempted.setter
    def preempted(self, value: bool) -> None:
        self._preempted = value
