"""Predictive capacity planning: chosen serve plan + admission EWMAs →
replicas-needed, the feed-forward half of the autoscaler (the port's copy
of ``parallel_cnn_tpu/serve/capacity.py``).

The reactive loop (serve/autoscaler.py) waits for a *symptom* — windowed
p99 over the SLO or a shed — and then pays hysteresis ticks before it
acts.  Under a flash crowd that is exactly one cooldown too late: the
queue fills, requests shed, and only then does capacity grow.  The
capacity model closes the loop one step earlier by predicting demand
from signals the serving stack already maintains:

- **Arrival rate** λ — the AdmissionController's interarrival EWMA
  (``arrival_rate``), fed by every submit (offered load, so demand is
  visible even while requests are being shed).
- **Per-replica service rate** μ — the chosen serve plan's batch bucket
  divided by that bucket's EWMA device time (``observe_service``
  feedback).  One replica running ``max_batch``-sized batches
  back-to-back completes ``max_batch / service_s`` requests per second;
  smaller observed buckets give proportionally smaller μ, and the
  planner uses the *best* observed bucket (the steady-state shape under
  load) rather than the pessimistic one admission uses for deadlines.
- **Headroom** — utilisation above ``headroom`` (default 0.6) leaves no
  slack for batch-formation gaps and queue draining, so the planner
  sizes for ``λ / (μ · headroom)`` replicas, the classic M/M/c-style
  occupancy guard band.

``replicas_needed`` returns ``None`` while either estimate is cold (no
arrivals yet, or no batch executed yet) — a prediction from nothing is
noise, so the autoscaler falls back to the reactive classifier until
the EWMAs warm up.  The model holds no lock and keeps no state of its
own: it is a pure read of the admission controller's estimators, cheap
enough to evaluate every autoscaler tick.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from parallel_cnn_tpu_torch.serve.admission import AdmissionController


class CapacityModel:
    """Replicas-needed from offered load and per-replica throughput.

    ``max_batch`` is the chosen serve plan's batch bucket (the
    ``DynamicBatcher`` cap — plan_to_configs on the serving side);
    ``headroom`` is the target peak utilisation per replica.
    """

    def __init__(
        self,
        admission: AdmissionController,
        *,
        max_batch: int,
        headroom: float = 0.6,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if not 0.0 < headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], got {headroom}")
        self.admission = admission
        self.max_batch = max_batch
        self.headroom = headroom

    # -- the two rates ---------------------------------------------------

    def arrival_rate(self) -> float:
        """Offered load λ in requests/s (0.0 while cold)."""
        return self.admission.arrival_rate()

    def service_rate(self) -> float:
        """Per-replica throughput μ in requests/s: the best observed
        bucket's ``bucket / service_ewma`` (0.0 while cold).  Buckets
        above ``max_batch`` are ignored — the ladder may have capped the
        effective bucket below what was once observed."""
        snap = self.admission.snapshot()
        best = 0.0
        for bucket, service_ms in snap["service_ewma_ms"].items():
            if bucket > self.max_batch or service_ms <= 0:
                continue
            best = max(best, bucket / (service_ms / 1e3))
        return best

    # -- the verdict -----------------------------------------------------

    def replicas_needed(self) -> Optional[int]:
        """ceil(λ / (μ · headroom)), or ``None`` while either estimate
        is cold (the autoscaler then stays purely reactive)."""
        lam = self.arrival_rate()
        mu = self.service_rate()
        if lam <= 0.0 or mu <= 0.0:
            return None
        return max(1, math.ceil(lam / (mu * self.headroom)))

    def snapshot(self) -> Dict[str, Any]:
        """Planner state for the metrics registry / bench artifacts."""
        return {
            "arrival_rate_rps": round(self.arrival_rate(), 3),
            "service_rate_rps": round(self.service_rate(), 3),
            "max_batch": self.max_batch,
            "headroom": self.headroom,
            "replicas_needed": self.replicas_needed(),
        }

    def attach_registry(self, registry, prefix: str = "capacity") -> None:
        """Expose the planner through an obs.MetricsRegistry (same
        pull-collector convention as the rest of the serving stack)."""
        registry.attach(prefix, self.snapshot)
