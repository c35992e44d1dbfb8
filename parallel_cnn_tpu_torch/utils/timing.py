"""Accumulating wall-clock timer (the port's copy of ``Stopwatch`` in
``parallel_cnn_tpu/utils/timing.py``).

The caller ends each span on a value read back from the device (the
trainer reads the epoch error with ``float()``), so a span covers the
device's work and not only its enqueue.
"""

from __future__ import annotations

import time
from typing import Optional


class Stopwatch:
    """Accumulating wall-clock timer; use as a context manager per span."""

    def __init__(self) -> None:
        self.total = 0.0
        self.spans = 0
        self._t0: Optional[float] = None

    def __enter__(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total += time.perf_counter() - self._t0
        self.spans += 1
        self._t0 = None
