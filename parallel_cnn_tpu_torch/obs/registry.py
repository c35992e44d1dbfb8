"""Process-wide metrics registry with Prometheus-text and JSON exposition
(the port's copy of ``parallel_cnn_tpu/obs/registry.py``).

Three primitive kinds — monotonically increasing :class:`Counter`,
last-value :class:`Gauge`, and the existing streaming
``utils.metrics.Histogram`` (log-binned, O(1) record, mergeable) — plus
*collectors*: callables returning a flat-or-nested dict snapshot, which
is how legacy stat objects (``serve.telemetry.ServeStats``) join the
same exposition path without changing their counter semantics.

Cross-host merge composes from the primitives' own semantics: counters
sum, gauges take the max (the conservative "worst replica" reading for
depth/occupancy-style values), histograms fold via ``Histogram.merge``
(which raises on binning mismatch, so silently incompatible merges are
impossible).
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Callable, Dict, List, Tuple

from parallel_cnn_tpu_torch.utils.metrics import Histogram

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


class Counter:
    """Monotonic counter; ``inc`` is thread-safe."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-value gauge; ``set`` is thread-safe."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


def _flatten(prefix: str, obj: Any, out: Dict[str, float]) -> None:
    """Flatten a nested snapshot dict to dotted numeric leaves."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = float(obj)


class MetricsRegistry:
    """Name → metric map shared by train and serve hot paths."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._collectors: Dict[str, Callable[[], Dict[str, Any]]] = {}

    # -- get-or-create -----------------------------------------------------

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, help)
            return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, help)
            return g

    def histogram(self, name: str, help: str = "", lo: float = 1e-5,
                  hi: float = 100.0, bins: int = 96) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(lo=lo, hi=hi, bins=bins)
            return h

    def attach(self, name: str,
               collect: Callable[[], Dict[str, Any]]) -> None:
        """Register a snapshot provider; its dict is flattened into the
        exposition under ``name.<key>`` leaves at read time."""
        with self._lock:
            self._collectors[name] = collect

    # -- exposition --------------------------------------------------------

    def _snapshot_parts(self) -> Tuple[
        List[Counter], List[Gauge], List[Tuple[str, Histogram]],
        List[Tuple[str, Callable[[], Dict[str, Any]]]],
    ]:
        with self._lock:
            return (
                list(self._counters.values()),
                list(self._gauges.values()),
                list(self._hists.items()),
                list(self._collectors.items()),
            )

    def json_snapshot(self) -> Dict[str, Any]:
        counters, gauges, hists, collectors = self._snapshot_parts()
        out: Dict[str, Any] = {
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "histograms": {name: h.summary() for name, h in hists},
        }
        for name, collect in collectors:
            out.setdefault("collected", {})[name] = collect()
        return out

    def prometheus_text(self) -> str:
        counters, gauges, hists, collectors = self._snapshot_parts()
        lines: List[str] = []
        for c in counters:
            n = _prom_name(c.name)
            if c.help:
                lines.append(f"# HELP {n} {c.help}")
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {c.value}")
        for g in gauges:
            n = _prom_name(g.name)
            if g.help:
                lines.append(f"# HELP {n} {g.help}")
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {g.value}")
        for name, h in hists:
            n = _prom_name(name)
            lines.append(f"# TYPE {n} summary")
            s = h.summary()
            for q in (50, 90, 99):
                if f"p{q}" in s:
                    lines.append(
                        f'{n}{{quantile="0.{q}"}} {s[f"p{q}"]}'
                    )
            lines.append(f"{n}_count {s['count']}")
            lines.append(f"{n}_sum {h.sum}")
        for name, collect in collectors:
            flat: Dict[str, float] = {}
            _flatten(name, collect(), flat)
            for key in sorted(flat):
                n = _prom_name(key)
                lines.append(f"# TYPE {n} gauge")
                lines.append(f"{n} {flat[key]}")
        return "\n".join(lines) + "\n"

    def write_json(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.json_snapshot(), f, indent=2, sort_keys=True)
        return path

    # -- cross-host merge --------------------------------------------------

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another host's registry into this one: counters sum,
        gauges take max, histograms ``Histogram.merge`` (binning
        mismatch raises).  Collectors are process-local and not merged."""
        counters, gauges, hists, _ = other._snapshot_parts()
        for c in counters:
            self.counter(c.name, c.help).inc(c.value)
        for g in gauges:
            mine = self.gauge(g.name, g.help)
            mine.set(max(mine.value, g.value))
        for name, h in hists:
            self.histogram(name, lo=h.lo, hi=h.hi, bins=h.bins).merge(h)
