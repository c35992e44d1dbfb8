"""Observability of the port (the counterpart of ``parallel_cnn_tpu/obs``).

One :class:`Obs` bundle carries the three signal sinks every subsystem
shares — the span :class:`~parallel_cnn_tpu_torch.obs.trace.Tracer`
(Chrome trace / Perfetto export), the
:class:`~parallel_cnn_tpu_torch.obs.registry.MetricsRegistry`
(Prometheus-text + JSON exposition), and the
:class:`~parallel_cnn_tpu_torch.obs.events.EventJournal` (append-only
JSONL with per-process sequence ids).  Hot paths take an ``obs=None``
keyword and normalize with ``obs = obs or NOOP``: the default is the
zero-cost no-op bundle, so nothing is paid unless ``ObsConfig`` turned it
on.

Spans wrap host-side dispatch only: they launch nothing on the device.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from parallel_cnn_tpu_torch.obs.events import (
    NOOP_JOURNAL,
    EventJournal,
    NoopJournal,
    conservation,
    merge_journals,
    read_journal,
)
from parallel_cnn_tpu_torch.obs.registry import Counter, Gauge, MetricsRegistry
from parallel_cnn_tpu_torch.obs.trace import (
    NOOP_TRACER,
    NoopTracer,
    Tracer,
    validate_nesting,
)

__all__ = [
    "Obs", "NOOP", "from_config",
    "Tracer", "NoopTracer", "NOOP_TRACER", "validate_nesting",
    "MetricsRegistry", "Counter", "Gauge",
    "EventJournal", "NoopJournal", "NOOP_JOURNAL",
    "read_journal", "merge_journals", "conservation",
]


class Obs:
    """The bundle threaded through the serving hot paths."""

    __slots__ = ("tracer", "registry", "journal", "cfg", "enabled",
                 "trace_path", "metrics_path")

    def __init__(self, tracer, registry, journal, cfg=None,
                 enabled: bool = False, trace_path: Optional[str] = None,
                 metrics_path: Optional[str] = None):
        self.tracer = tracer
        self.registry = registry
        self.journal = journal
        self.cfg = cfg
        self.enabled = enabled
        self.trace_path = trace_path
        self.metrics_path = metrics_path

    def span(self, name: str, cat: str = "step", **args: Any):
        return self.tracer.span(name, cat, **args)

    def event(self, kind: str, **fields: Any):
        return self.journal.emit(kind, **fields)

    def finish(self) -> Dict[str, str]:
        """Export every configured artifact; returns {kind: path}."""
        out: Dict[str, str] = {}
        if self.trace_path and self.tracer.enabled:
            out["trace"] = self.tracer.export(self.trace_path)
        if self.journal.enabled:
            self.journal.close()
            if self.journal.path:
                out["journal"] = self.journal.path
        if self.metrics_path and self.registry is not None:
            out["metrics"] = self.registry.write_json(self.metrics_path)
        return out


NOOP = Obs(NOOP_TRACER, None, NOOP_JOURNAL, cfg=None, enabled=False)


def from_config(cfg, run: str = "run", process_index: int = 0,
                mirror: Optional[bool] = None) -> Obs:
    """Build the live (or no-op) bundle from an ``ObsConfig``.

    ``cfg`` is ``Optional[config.ObsConfig]`` — ``None`` or a disabled
    config returns the shared :data:`NOOP` singleton.  ``run`` names the
    artifacts (``<dir>/<run>_trace.json`` etc.) so several phases of one
    process don't clobber each other.
    """
    if cfg is None or not cfg.enabled:
        return NOOP
    if mirror is None:
        mirror = cfg.annotations
    if cfg.trace:
        tracer = Tracer(process_name=f"pcnn:{run}", mirror=mirror)
        journal = EventJournal(
            os.path.join(cfg.dir, f"{run}_journal.jsonl"),
            process_index=process_index,
        )
        trace_path = os.path.join(cfg.dir, f"{run}_trace.json")
    else:
        tracer = NOOP_TRACER
        journal = NOOP_JOURNAL
        trace_path = None
    return Obs(
        tracer, MetricsRegistry(), journal, cfg=cfg, enabled=True,
        trace_path=trace_path, metrics_path=cfg.metrics_json,
    )
