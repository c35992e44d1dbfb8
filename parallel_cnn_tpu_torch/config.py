"""Serving configuration of the port.

The port's own copy of the fields of ``parallel_cnn_tpu/config.py``'s
``ServeConfig`` that the serving slice uses, read from the same
``PCNN_SERVE_*`` environment names. Admission control, the autoscaler and
the network front door are not ported yet, so their fields are absent; so is
``conv_backend``, which has one value in the port (``serve.registry.get``
takes it).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

#: Registry names the port serves (serve/registry.py).
SERVE_MODELS = ("resnet18", "resnet34")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Inference-serving policy (serve/)."""

    # Registry name (serve/registry.py).
    model: str = "resnet18"
    # JAX-written zoo checkpoint (.npz) to restore params + BN stats from;
    # None serves seed-initialised weights.
    checkpoint: Optional[str] = None
    # Largest batch the engine runs; a power of two — the top of the
    # bucket ladder 1, 2, 4, …, max_batch.
    max_batch: int = 64
    # Batcher coalescing window: a batch dispatches at max_batch OR when
    # this many ms have passed since its first request, whichever first.
    max_wait_ms: float = 2.0
    # Bounded request queue; a full queue sheds new requests with the
    # typed serve.Overloaded error.
    queue_depth: int = 256
    # Engine replicas pinned round-robin across local devices.
    n_replicas: int = 1
    # Default per-request deadline budget (ms); 0 = no deadline.
    deadline_ms: float = 0.0
    # Run every bucket once at startup so the first requests pay no
    # kernel build or allocator warm-up.
    precompile: bool = True

    def __post_init__(self):
        if self.max_batch < 1 or (self.max_batch & (self.max_batch - 1)):
            raise ValueError(
                f"max_batch must be a power of two >= 1, got {self.max_batch}"
            )
        if self.max_wait_ms < 0 or self.deadline_ms < 0:
            raise ValueError("max_wait_ms/deadline_ms must be >= 0")
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {self.n_replicas}")

    @staticmethod
    def from_env() -> "ServeConfig":
        """ServeConfig with PCNN_SERVE_* environment overrides applied over
        the defaults; the CLI flags then override field by field."""
        e = os.environ.get
        return ServeConfig(
            model=e("PCNN_SERVE_MODEL", "resnet18"),
            checkpoint=e("PCNN_SERVE_CHECKPOINT") or None,
            max_batch=int(e("PCNN_SERVE_MAX_BATCH", "64")),
            max_wait_ms=float(e("PCNN_SERVE_MAX_WAIT_MS", "2.0")),
            queue_depth=int(e("PCNN_SERVE_QUEUE_DEPTH", "256")),
            n_replicas=int(e("PCNN_SERVE_REPLICAS", "1")),
            deadline_ms=float(e("PCNN_SERVE_DEADLINE_MS", "0")),
            precompile=e("PCNN_SERVE_PRECOMPILE", "1") != "0",
        )
