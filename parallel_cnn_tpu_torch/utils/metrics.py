"""Training metrics and a streaming latency histogram: the port's copies
of ``MetricsLogger``, ``throughput`` and ``Histogram`` in
``parallel_cnn_tpu/utils/metrics.py``. The trainer CLI writes JSONL
records through the logger; the serving telemetry and the load generator
use the histogram."""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, TextIO


def _scalar(v: Any) -> Any:
    if isinstance(v, (int, str, bool)) or v is None:
        return v
    return float(v)  # numpy / torch scalars (a device value syncs here)


class MetricsLogger:
    """Append-only metrics sink: one JSONL record per event,
    ``{metrics…, "ts": …}``, to a file, stdout and/or memory."""

    def __init__(
        self,
        path: Optional[str] = None,
        echo: bool = False,
        keep_in_memory: bool = True,
    ):
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file: Optional[TextIO] = open(path, "a") if path else None
        self._echo = echo
        self.records: Optional[List[Dict[str, Any]]] = [] if keep_in_memory else None

    def record(self, **values: Any) -> Dict[str, Any]:
        rec = {k: _scalar(v) for k, v in values.items()}
        rec["ts"] = time.time()
        if self.records is not None:
            self.records.append(rec)
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._echo:
            print(line)
        return rec

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def throughput(n_items: int, seconds: float) -> float:
    """items/sec with a zero-guard."""
    return n_items / seconds if seconds > 0 else float("inf")


class Histogram:
    """Streaming histogram over fixed log-spaced bins, with percentiles.

    Built for latency telemetry (serve/): O(1) memory regardless of sample count, O(1) record, and
    p50/p90/p99 queries whose error is bounded by the bin ratio — with
    ``bins`` spanning [lo, hi), each bin covers a factor of
    (hi/lo)**(1/bins), so the default 96 bins over [1e-5 s, 100 s) put
    every quantile within ~±9% of truth. Exact count/sum/min/max ride
    alongside, and percentile answers are clamped into [min, max] so a
    single-sample histogram reports that sample, not a bin midpoint.

    Values below ``lo`` land in the first bin, values >= ``hi`` in the
    last (counted, never dropped). Thread-safe: record() is called from
    batcher worker and client threads concurrently.
    """

    def __init__(self, lo: float = 1e-5, hi: float = 100.0, bins: int = 96):
        if not (0 < lo < hi) or bins < 2:
            raise ValueError(f"need 0 < lo < hi and bins >= 2, got "
                             f"lo={lo} hi={hi} bins={bins}")
        self.lo, self.hi, self.bins = float(lo), float(hi), int(bins)
        self._log_lo = math.log(lo)
        self._inv_width = bins / (math.log(hi) - math.log(lo))
        self.counts = [0] * bins
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = int((math.log(v) - self._log_lo) * self._inv_width)
        return min(max(i, 0), self.bins - 1)

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[self._index(v)] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def percentile(self, p: float) -> Optional[float]:
        """p-th percentile (p in [0, 100]); None on an empty histogram.

        Returns the geometric midpoint of the bin holding the p-th
        sample, clamped into the exact observed [min, max]."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        with self._lock:
            if self.count == 0:
                return None
            rank = p / 100.0 * self.count
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= rank and c:
                    ratio = (self.hi / self.lo) ** (1.0 / self.bins)
                    mid = self.lo * ratio ** (i + 0.5)
                    return min(max(mid, self.min), self.max)
            return self.max

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram (same binning) into this one."""
        if (other.lo, other.hi, other.bins) != (self.lo, self.hi, self.bins):
            raise ValueError("histogram binning mismatch")
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.count += other.count
            self.sum += other.sum
            if other.min is not None:
                self.min = other.min if self.min is None else min(self.min, other.min)
            if other.max is not None:
                self.max = other.max if self.max is None else max(self.max, other.max)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def summary(self, scale: float = 1.0) -> Dict[str, Any]:
        """count/mean/min/max/p50/p90/p99 as plain floats, each value
        multiplied by ``scale`` (e.g. 1e3 for seconds → milliseconds)."""
        with self._lock:
            count = self.count
        if count == 0:
            return {"count": 0}
        out: Dict[str, Any] = {
            "count": count,
            "mean": self.mean * scale,
            "min": self.min * scale,
            "max": self.max * scale,
        }
        for p in (50, 90, 99):
            out[f"p{p}"] = self.percentile(p) * scale
        return out
