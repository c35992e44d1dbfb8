"""Inference serving of the port: shape-bucketed, dynamically batched,
replica-pinned predict on the card (the counterpart of
``parallel_cnn_tpu/serve``).

    registry   name → uniform (build, forward, in_shape) model handle
    engine     per-bucket predict on one device (Engine / ReplicaPool:
               failover, growth, drain and retire)
    batcher    bounded queue + deadline-aware dynamic batching with
               typed Overloaded backpressure, admission, chaos and
               in-flight failover (DynamicBatcher, serve_stack)
    telemetry  latency percentiles, queue depth, occupancy, shed rate —
               lifetime and windowed (decayed) views
    admission  SLO admission control: EWMA reject-early shedding + the
               graceful-degradation ladder (AdmissionController)
    capacity   predictive capacity planner (CapacityModel)
    autoscaler hysteresis/cooldown control loop growing/draining the
               ReplicaPool from windowed telemetry (AutoScaler)
    scenarios  seeded traffic scenarios with explicit p99/shed gates
               (diurnal, flash-crowd, slow-client, chaos-kill/slow)
               plus the net suites judged at the wire tier
    loadgen    seeded closed-/open-loop traffic + client retry protocol
               (in-process and over the socket transport)
    net        stdlib TCP front door: NDJSON protocol, per-connection
               read/write deadlines, slow-loris reaping, wire-tier
               conservation (NetServer / WireStats)
    supervisor crash-fast respawn with bounded backoff on a stable
               port, and the zero-downtime weight hot_swap roll
"""

from parallel_cnn_tpu_torch.serve.admission import AdmissionController  # noqa: F401
from parallel_cnn_tpu_torch.serve.autoscaler import AutoScaler  # noqa: F401
from parallel_cnn_tpu_torch.serve.capacity import CapacityModel  # noqa: F401
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
from parallel_cnn_tpu_torch.serve.net import NetServer  # noqa: F401
from parallel_cnn_tpu_torch.serve.registry import ModelHandle, available, get  # noqa: F401
from parallel_cnn_tpu_torch.serve.scenarios import (  # noqa: F401
    NET_SCENARIOS,
    SCENARIOS,
    NetScenarioReport,
    ScenarioReport,
)
from parallel_cnn_tpu_torch.serve.supervisor import Supervisor, armed_factory, hot_swap  # noqa: F401
from parallel_cnn_tpu_torch.serve.telemetry import ServeStats, WireStats  # noqa: F401
