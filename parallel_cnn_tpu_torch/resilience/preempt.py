"""Preemption safety: SIGTERM/SIGINT → "checkpoint and stop cleanly" (the
port's copy of ``parallel_cnn_tpu/resilience/preempt.py``, without the
elastic resize channel, which comes with elastic training).

The signal sets a flag; the epoch loop polls ``requested()`` at its
checkpoint boundary, flushes the final atomic checkpoint through the
normal per-epoch path and returns, so ``--resume`` continues bit-exactly.
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
