"""Thread-safe host-side span tracer with Chrome-trace-event export (the
port's copy of ``parallel_cnn_tpu/obs/trace.py``).

Spans wrap *dispatch* on the host: they launch nothing on the device, so
the kernels a path runs are the same with tracing on or off.  Timing uses the monotonic ``time.perf_counter_ns`` clock;
every span records the calling thread, and per-thread/process track
metadata is emitted so the export loads in Perfetto / ``chrome://tracing``
with readable lanes.

Two export shapes are produced in one file:

- ``X`` (complete) events — one per closed span, ``ts``+``dur`` in
  microseconds.  Nesting is implied by containment per thread track and
  checked by :func:`validate_nesting`.
- ``b``/``e`` (async) events — request-flow spans that start and end on
  different threads (serve submit → complete), correlated by ``id``.

When ``mirror=True`` each span also enters a
``torch.profiler.record_function`` so a ``torch.profiler`` trace of the
same run carries the spans' names beside the device's kernels.

The disabled path is a module singleton: :data:`NOOP_TRACER` returns the
same reusable :class:`_NoopSpan` object from every ``span()`` call — no
per-step allocations are retained.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class _NoopSpan:
    """Reusable do-nothing context manager (one instance per process)."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Zero-cost tracer used whenever observability is off."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, cat: str = "step", **args: Any) -> _NoopSpan:
        return _NOOP_SPAN

    def instant(self, name: str, cat: str = "step", **args: Any) -> None:
        return None

    def begin_async(self, name: str, aid: int, cat: str = "req") -> None:
        return None

    def end_async(self, name: str, aid: int, cat: str = "req") -> None:
        return None

    def events(self) -> List[Dict[str, Any]]:
        return []

    def export(self, path: str) -> Optional[str]:
        return None


NOOP_TRACER = NoopTracer()


def _annotation_cls():
    from torch.profiler import record_function

    return record_function


class _Span:
    """One open span; closing records an ``X`` event on the tracer."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0_ns", "_mirror")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0_ns = 0
        self._mirror = None

    def __enter__(self) -> "_Span":
        cls = self._tracer._mirror_cls
        if cls is not None:
            self._mirror = cls(self.name)
            self._mirror.__enter__()
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter_ns()
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
        self._tracer._record_complete(
            self.name, self.cat, self._t0_ns, t1, self.args
        )
        return False


class Tracer:
    """Collects Chrome-trace events from any number of threads."""

    enabled = True

    def __init__(self, process_name: str = "parallel_cnn_tpu_torch",
                 pid: Optional[int] = None, mirror: bool = False,
                 replica: Optional[int] = None):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._pid = os.getpid() if pid is None else int(pid)
        self._named_tids: set = set()
        self._mirror_cls = _annotation_cls() if mirror else None
        track = process_name if replica is None else (
            f"{process_name}/replica{replica}"
        )
        self._events.append({
            "ph": "M", "name": "process_name", "pid": self._pid, "tid": 0,
            "args": {"name": track},
        })

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: str = "step", **args: Any) -> _Span:
        return _Span(self, name, cat, args)

    def _thread_meta_locked(self, tid: int) -> None:
        if tid not in self._named_tids:
            self._named_tids.add(tid)
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": self._pid,
                "tid": tid,
                "args": {"name": threading.current_thread().name},
            })

    def _record_complete(self, name: str, cat: str, t0_ns: int, t1_ns: int,
                         args: Dict[str, Any]) -> None:
        tid = threading.get_ident()
        ev = {
            "ph": "X", "name": name, "cat": cat, "pid": self._pid,
            "tid": tid, "ts": t0_ns / 1e3, "dur": (t1_ns - t0_ns) / 1e3,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._thread_meta_locked(tid)
            self._events.append(ev)

    def instant(self, name: str, cat: str = "step", **args: Any) -> None:
        tid = threading.get_ident()
        ev = {
            "ph": "i", "name": name, "cat": cat, "pid": self._pid,
            "tid": tid, "ts": time.perf_counter_ns() / 1e3, "s": "t",
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._thread_meta_locked(tid)
            self._events.append(ev)

    def _async(self, ph: str, name: str, aid: int, cat: str) -> None:
        tid = threading.get_ident()
        ev = {
            "ph": ph, "name": name, "cat": cat, "pid": self._pid,
            "tid": tid, "ts": time.perf_counter_ns() / 1e3,
            "id": f"{aid:#x}",
        }
        with self._lock:
            self._thread_meta_locked(tid)
            self._events.append(ev)

    def begin_async(self, name: str, aid: int, cat: str = "req") -> None:
        self._async("b", name, aid, cat)

    def end_async(self, name: str, aid: int, cat: str = "req") -> None:
        self._async("e", name, aid, cat)

    # -- export ------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON; returns the path written."""
        payload = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


def validate_nesting(events: List[Dict[str, Any]]) -> List[str]:
    """Check that ``X`` spans nest properly per (pid, tid) track.

    Proper nesting means: for any two spans on one thread, their
    [ts, ts+dur] intervals are either disjoint or one contains the
    other — partial overlap would mean a span closed out of order.
    Returns a list of violation descriptions (empty = valid).
    """
    problems: List[str] = []
    by_track: Dict[tuple, List[Dict[str, Any]]] = {}
    for ev in events:
        if ev.get("ph") == "X":
            by_track.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for track, evs in by_track.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict[str, Any]] = []
        for ev in evs:
            end = ev["ts"] + ev["dur"]
            while stack and ev["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            if stack:
                parent_end = stack[-1]["ts"] + stack[-1]["dur"]
                if end > parent_end:
                    problems.append(
                        f"track {track}: span '{ev['name']}' "
                        f"[{ev['ts']}, {end}] partially overlaps "
                        f"'{stack[-1]['name']}' ending at {parent_end}"
                    )
            stack.append(ev)
    return problems
