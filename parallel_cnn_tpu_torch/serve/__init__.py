"""Inference serving of the port: shape-bucketed, dynamically batched,
replica-pinned predict on the card (the counterpart of
``parallel_cnn_tpu/serve``).

    registry   name → uniform (build, forward, in_shape) model handle
    engine     per-bucket predict on one device (Engine / ReplicaPool)
    batcher    bounded queue + deadline-aware dynamic batching with
               typed Overloaded backpressure (DynamicBatcher, serve_stack)
    telemetry  latency percentiles, queue depth, occupancy, shed rate
    loadgen    seeded closed-/open-loop in-process traffic
"""

from parallel_cnn_tpu_torch.serve.batcher import (  # noqa: F401
    DeadlineExceeded,
    DynamicBatcher,
    Future,
    Overloaded,
    serve_stack,
)
from parallel_cnn_tpu_torch.serve.engine import (  # noqa: F401
    Engine,
    EngineStats,
    ReplicaDead,
    ReplicaPool,
    bucket_for,
    load_or_init,
)
from parallel_cnn_tpu_torch.serve.registry import ModelHandle, available, get  # noqa: F401
from parallel_cnn_tpu_torch.serve.telemetry import ServeStats  # noqa: F401
