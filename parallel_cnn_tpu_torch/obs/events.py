"""Append-only JSONL event journal with deterministic multi-host merge
(the port's copy of ``parallel_cnn_tpu/obs/events.py``).

Every record carries a monotonically increasing per-process sequence id
(``seq``) plus the process index (``proc``), so journals from several
hosts merge deterministically by ``(proc, seq)`` — wall-clock timestamps
(``ts``) ride along for humans but never order the merge (clocks skew;
sequence ids don't).

Event kinds the port's serving stack writes: the request lifecycle
``submit`` / ``shed`` / ``expired`` / ``batch`` / ``complete`` /
``failed`` — whose counts obey the same conservation law as
``ServeStats``: submitted == completed + shed + expired + failed (and
must keep obeying it across a mid-traffic replica death: failover
re-resolves, never duplicates) — the failover path's
``replica_evicted`` / ``failover`` / ``replica_respawned``,
``admission_level`` (degradation-ladder transitions, serve/admission.py),
``scale_up`` / ``scale_down`` (autoscaler decisions,
serve/autoscaler.py) and ``chaos_slow_replica`` (straggler injection).
``conservation(counts, prefix="net_")`` checks the wire tier's
``net_*`` kinds, which the network front door writes in JAX's package.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence


class NoopJournal:
    """Zero-cost journal used whenever observability is off."""

    __slots__ = ()
    enabled = False
    path = None

    def emit(self, kind: str, **fields: Any) -> None:
        return None

    def counts(self) -> Dict[str, int]:
        return {}

    def flush(self) -> None:
        return None

    def close(self) -> None:
        return None


NOOP_JOURNAL = NoopJournal()


class EventJournal:
    """Thread-safe append-only JSONL sink with per-kind counting."""

    enabled = True

    def __init__(self, path: str, process_index: int = 0):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self.process_index = int(process_index)
        self._lock = threading.Lock()
        self._f = open(path, "a")
        self._seq = 0
        self._counts: Dict[str, int] = {}

    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        rec: Dict[str, Any] = dict(fields)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            rec["proc"] = self.process_index
            rec["kind"] = kind
            rec["ts"] = time.time()
            self._f.write(json.dumps(rec) + "\n")
            self._counts[kind] = self._counts.get(kind, 0) + 1
        return rec

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_journal(path: str) -> List[Dict[str, Any]]:
    """Parse one journal file; blank lines are skipped."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def merge_journals(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Deterministic multi-host merge: stable order by ``(proc, seq)``,
    independent of file order and wall-clock skew."""
    records: List[Dict[str, Any]] = []
    for p in paths:
        records.extend(read_journal(p))
    records.sort(key=lambda r: (r.get("proc", 0), r.get("seq", 0)))
    return records


def conservation(counts: Dict[str, int], prefix: str = "") -> Optional[str]:
    """Check the serve lifecycle conservation law over per-kind counts.

    Returns None when conserved (or when no submits were journaled),
    else a human-readable description of the imbalance. ``prefix``
    selects which tier's lifecycle to check: ``""`` for the batcher
    tier (``submit``/``complete``/...), ``"net_"`` for the wire tier
    journaled by serve/net.py (``net_submit``/``net_complete``/...).
    """
    submitted = counts.get(prefix + "submit", 0)
    if submitted == 0:
        return None
    accounted = (
        counts.get(prefix + "complete", 0) + counts.get(prefix + "shed", 0)
        + counts.get(prefix + "expired", 0)
        + counts.get(prefix + "failed", 0)
    )
    if accounted != submitted:
        return (
            f"journal conservation violated: {prefix}submit={submitted} != "
            f"{prefix}complete+shed+expired+failed={accounted}"
        )
    return None
