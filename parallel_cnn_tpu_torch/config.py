"""Configuration of the port: the trainer's and the server's.

The port's own copies of the parts of ``parallel_cnn_tpu/config.py`` its
slices use. For training: ``DataConfig``, ``TrainConfig``,
``ResilienceConfig``, ``MeshConfig`` (the (data, model) mesh),
``CommConfig`` (psum, the bucketed ring or the hierarchical ring, JAX's
fields, defaults and ``PCNN_COMM_*`` layering), ``FusedStepConfig``
(the fused step, ZeRO-2 and ZeRO-3), ``PipelineConfig`` (stages, split,
wire and act dtypes, ``PCNN_PIPELINE_*``), ``ElasticConfig`` and
``AsyncConfig``, gathered in ``Config`` with JAX's sections; the
``PCNN_*`` names that feed the ExecutionPlan (``present_plan_env``) and
``PCNN_PLAN`` (``plan_path_from_env``). The legality of a combination of
knobs is the plan's (plan/ ``ExecutionPlan.validate``), with JAX's texts.
For serving: the fields of ``ServeConfig`` read from the same
``PCNN_SERVE_*`` environment names, admission control and the autoscaler
included, and the network front door's ``NetConfig``. For
observability: ``ObsConfig`` and its ``PCNN_OBS_*`` names.

Kernel paths: where the JAX package says ``ops="pallas"`` (its Mosaic
kernels), the port says ``ops="cuda"`` (its hand-written CUDA kernels), as
its ``conv_backend="cuda"`` stands for JAX's ``"pallas"`` and
``conv_backend="torch"`` for JAX's ``"xla"``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


class NotPortedError(NotImplementedError):
    """A JAX-package option the port has not reached yet; the message names
    the ROADMAP item that brings it."""


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Where training data comes from (≙ Sequential/Main.cpp:36-42)."""

    train_images: str = "data/train-images.idx3-ubyte"
    train_labels: str = "data/train-labels.idx1-ubyte"
    test_images: str = "data/t10k-images.idx3-ubyte"
    test_labels: str = "data/t10k-labels.idx1-ubyte"
    # Missing idx files → a deterministic synthetic MNIST stand-in
    # (data/synthetic.py), bit-identical to the JAX package's.
    synthetic_fallback: bool = True
    synthetic_train_count: int = 60_000
    synthetic_test_count: int = 10_000
    synthetic_seed: int = 1234
    # "auto" | "numpy" | "synthetic" | "native": "native" parses with the
    # C++ idx parser (data/native.py) and raises MnistError(-5) when it
    # cannot be built; "auto" prefers it and parses with NumPy only then.
    loader: str = "auto"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization contract of the reference trainer.

    The JAX config's ``dtype`` field is absent: the port trains in f32 end
    to end (its fused kernel is f32, as JAX's is), and a bf16 throughput
    mode comes with a later slice.
    """

    # SGD step, applied as `w += dt * g` (Sequential/layer.h:12).
    dt: float = 0.1
    # Stop when the epoch's mean ‖y−ŷ‖₂ falls below it (layer.h:13).
    threshold: float = 0.01
    epochs: int = 1
    # 1 = the reference's per-sample SGD trajectory; >1 = minibatch SGD.
    batch_size: int = 1
    seed: int = 0
    # Epoch shuffling (the reference replays file order: default off).
    shuffle: bool = False
    # Batch order for batch_size > 1:
    #   "auto"   — drop-tail batches in the native C++ prefetch ring's
    #              order (xorshift Fisher–Yates) from its NumPy twin,
    #              gathered from the set on the device;
    #   "native" — the C++ ring's host batches, copied to the device a
    #              batch at a time, raising when it cannot be built;
    #   "off"    — plain NumPy slicing (keep-tail, NumPy PCG shuffle).
    prefetch: str = "auto"
    # Which kernels compute the minibatch step:
    #   "reference" — plain PyTorch ops (≙ JAX's XLA path A);
    #   "cuda"      — the hand-written fused train-step kernel
    #                 (csrc/lenet_fused.cu ≙ JAX's ops="pallas").
    #                 Batched mode only.
    ops: str = "reference"

    def __post_init__(self):
        if self.ops not in ("reference", "cuda"):
            raise ValueError(f"unknown ops path {self.ops!r}")
        if self.ops == "cuda" and self.batch_size == 1:
            raise ValueError(
                "ops='cuda' is the batched kernel path (its grid tiles the "
                "batch); use batch_size>1, or ops='reference' for strict "
                "per-sample parity"
            )
        if self.prefetch not in ("auto", "native", "off"):
            raise ValueError(f"unknown prefetch mode {self.prefetch!r}")


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Fault-tolerance policy of the trainer (resilience/).

    JAX's ``pallas_fallback`` field is absent on purpose. There it lets a
    failing kernel path degrade to the XLA step; in the port a CUDA tensor
    goes through the hand-written kernel or the run raises, so a kernel
    fault is never hidden behind the plain version.
    """

    # What the health sentinel does on a non-finite loss or param:
    # "off", "raise" (DivergenceError), "skip" (drop the epoch's update)
    # or "rollback" (restore last-good, LR × lr_backoff, ≤ max_rollbacks).
    policy: str = "raise"
    max_rollbacks: int = 3
    lr_backoff: float = 0.5
    # Keep the newest N checkpoints in --checkpoint-dir (0 = all).
    ring_size: int = 0
    # Zoo trainer: also check loss/param finiteness every N optimizer
    # steps (0 = epoch boundaries only). Each check is a host sync.
    check_every_steps: int = 0

    def __post_init__(self):
        if self.policy not in ("off", "raise", "skip", "rollback"):
            raise ValueError(f"unknown sentinel policy {self.policy!r}")
        if self.max_rollbacks < 0:
            raise ValueError("max_rollbacks must be >= 0")
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError(
                f"lr_backoff must be in (0, 1], got {self.lr_backoff}"
            )
        if self.ring_size < 0 or self.check_every_steps < 0:
            raise ValueError("ring_size/check_every_steps must be >= 0")


#: Zoo models the trainer builds (train/zoo.py), and its conv backends:
#: "cuda" ≙ JAX's "pallas" (the hand kernels), "torch" ≙ JAX's "xla".
ZOO_MODELS = ("cifar_cnn", "resnet18", "resnet34", "resnet50", "vgg16")
CONV_BACKENDS = ("torch", "cuda")


class MeshLayoutError(ValueError):
    """The mesh cannot run this trainer configuration (an axis that does not
    divide the batch or the filters, or a path that needs one axis)."""


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The (data, model) layout (JAX's ``MeshConfig``, config.py:141): one
    process per rank, data × model ranks (parallel/distributed.py).

    ``data=None`` means every visible card the model axis leaves (on the
    CPU: one data rank). The ``model`` axis splits LeNet-ref's filters
    (parallel/intra_op.py) and, on the zoo's GSPMD path, each layer's
    filters where they divide (parallel/zoo_sharding.py); the zoo's
    explicit collectives (``--comm-impl``) take the data axis only
    (``check_comm_mesh``)."""

    data: Optional[int] = None
    model: int = 1

    def __post_init__(self):
        if self.data is not None and self.data < 1:
            raise ValueError(f"mesh data axis must be >= 1, got {self.data}")
        if self.model < 1:
            raise ValueError(f"mesh model axis must be >= 1, got {self.model}")


#: JAX's refusal of the explicit collectives on a model axis, one of
#: the plan's legality texts (plan/__init__.py).
from parallel_cnn_tpu_torch.plan import COMM_DATA_ONLY_ERROR  # noqa: E402


def check_comm_mesh(mesh: MeshConfig, comm: Optional["CommConfig"]) -> None:
    """The zoo's explicit collectives run over the data axis alone: a
    model axis with ``comm`` raises MeshLayoutError (JAX's
    ``COMM_DATA_ONLY_ERROR``)."""
    if comm is not None and mesh.model > 1:
        raise MeshLayoutError(COMM_DATA_ONLY_ERROR)


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Gradient-collective policy (parallel/collectives.py; JAX's
    ``CommConfig``, config.py:152).

    - ``impl``: "psum" (one all-reduce per gradient leaf), "ring" (the
      grads packed into ``bucket_bytes`` buckets, each reduce-scattered
      and all-gathered over an explicit ring) or "hierarchical" (each
      bucket through the two-level ring of a (host, device) mesh:
      intra-host reduce-scatter, inter-host exchange of the surviving
      chunk, then the two all-gathers; parallel/collectives.py
      ``hier_*``).
    - ``wire_dtype``: the ring hops' payload dtype, "float32" or
      "bfloat16"; sums stay f32.
    - ``overlap``: with the ring and gradient accumulation, reduce-scatter
      each microbatch's buckets as soon as its grads are final.
    - ``hosts``: the host axis of the hierarchical mesh; None is one host
      (the port's ranks all run on one machine). The mesh lays the ranks
      out as ``hosts`` rows (parallel/mesh.py ``make_hier_mesh``).
    """

    impl: str = "psum"
    bucket_bytes: int = 4 * 1024 * 1024
    wire_dtype: str = "float32"
    overlap: bool = True
    hosts: Optional[int] = None

    def __post_init__(self):
        if self.impl not in ("psum", "ring", "hierarchical"):
            raise ValueError(f"unknown comm impl {self.impl!r}")
        if self.hosts is not None and self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")
        if self.bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be > 0, got {self.bucket_bytes}")
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown wire dtype {self.wire_dtype!r} (float32 or bfloat16)"
            )

    @staticmethod
    def from_env() -> Optional["CommConfig"]:
        """CommConfig from PCNN_COMM_IMPL / PCNN_COMM_BUCKET_BYTES /
        PCNN_COMM_WIRE_DTYPE / PCNN_COMM_OVERLAP / PCNN_COMM_HOSTS, or None
        when none is set (no explicit collective path)."""
        e = os.environ.get
        impl, bucket = e("PCNN_COMM_IMPL"), e("PCNN_COMM_BUCKET_BYTES")
        wire, overlap = e("PCNN_COMM_WIRE_DTYPE"), e("PCNN_COMM_OVERLAP")
        hosts = e("PCNN_COMM_HOSTS")
        if (impl is None and bucket is None and wire is None and overlap is None
                and hosts is None):
            return None
        return CommConfig(
            impl=impl or "psum",
            bucket_bytes=int(bucket) if bucket else 4 * 1024 * 1024,
            wire_dtype=wire or "float32",
            overlap=overlap != "0" if overlap is not None else True,
            hosts=int(hosts) if hosts else None,
        )


@dataclasses.dataclass(frozen=True)
class FusedStepConfig:
    """The zoo's fused training step (JAX's ``FusedStepConfig``,
    config.py:231), with JAX's defaults.

    - ``update`` is update-on-arrival over the ring collectives: each
      bucket's reduce-scattered gradient shard updates the rank's
      parameter and momentum shard through the fused SGD-momentum kernel
      (ops/sgd_update.py, csrc/sgd_update.cu), and the updated parameter
      shards are all-gathered (train/zoo.py ``make_fused_train_step``). It
      needs a mesh and ``CommConfig(impl="ring")``; without them the zoo
      trainer drops it with JAX's fallback line.
    - ``tail`` routes a recognised model head through the fused loss tail
      (ops/tail.py, csrc/tail_ce.cu).
    - ``act_dtype``: "bfloat16", JAX's default, casts the input and every
      floating parameter to bf16 at the top of the loss (train/zoo.py
      ``_build_loss_fn``): the conv and tail kernels run their bf16 forms,
      BN's statistics and every master stay f32. "float32" runs the f32
      forms throughout.
    - ``loss_scale``, ``growth_interval``, ``backoff``: the bf16 path's
      loss scale, static (``loss_scale``) on the steps without
      update-on-arrival, dynamic on ``make_fused_train_step`` (backed off
      on overflow, clamped at 1, doubled after ``growth_interval`` clean
      steps; ``FusedOptState.scale``). In f32 the scale is pinned to 1.
    - ``zero``: 2 keeps the momentum as 1/n bucket shards and the params
      replicated; 3 (ZeRO-3, needs ``update``) keeps the params as 1/n
      bucket shards too, gathered just in time at the head of each step
      (always f32 on the wire) and updated in place with no trailing
      all-gather (train/zoo.py ``make_zero3_train_step``).
    """

    update: bool = True
    tail: bool = True
    act_dtype: str = "bfloat16"
    loss_scale: float = 2.0 ** 15
    growth_interval: int = 200
    backoff: float = 0.5
    zero: int = 2

    def __post_init__(self):
        if self.zero not in (2, 3):
            raise ValueError(f"zero level must be 2 or 3, got {self.zero}")
        if self.zero == 3 and not self.update:
            raise ValueError(
                "zero=3 shards params into the update-on-arrival path and "
                "requires update=True"
            )
        if self.act_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown act dtype {self.act_dtype!r} (float32 or bfloat16)"
            )
        if self.loss_scale < 1.0:
            raise ValueError(f"loss_scale must be >= 1, got {self.loss_scale}")
        if self.growth_interval < 1:
            raise ValueError(
                f"growth_interval must be >= 1, got {self.growth_interval}")
        if not 0.0 < self.backoff < 1.0:
            raise ValueError(f"backoff must be in (0, 1), got {self.backoff}")

    @staticmethod
    def from_env() -> Optional["FusedStepConfig"]:
        """FusedStepConfig when PCNN_FUSED_STEP is set truthy, else None.
        PCNN_ACT_DTYPE and PCNN_ZERO_LEVEL refine it; alone they do not
        enable it."""
        enabled = os.environ.get("PCNN_FUSED_STEP")
        if enabled is None or enabled == "0":
            return None
        return FusedStepConfig(
            act_dtype=os.environ.get("PCNN_ACT_DTYPE", "bfloat16"),
            zero=int(os.environ.get("PCNN_ZERO_LEVEL", "2")),
        )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Pipeline-parallelism policy (JAX's ``PipelineConfig``,
    config.py:730): 1F1B microbatch pipelining over a ``(stage, data)``
    mesh of ranks (parallel/pipeline.py, train/pipeline_schedule.py).

    No PipelineConfig at all keeps the zoo trainer on its data-parallel
    paths; one (``--pipeline-stages`` / ``PCNN_PIPELINE_STAGES``) opts it
    into the pipelined step. ``stages=1`` is the degenerate pipeline: the
    flat ring step itself.

    - ``stages``: S, the size of the mesh's ``stage`` axis; the other
      ranks form the data axis (world // S replicas of each stage).
    - ``split``: manual stage boundaries, the comma-separated layer
      indices at which a stage starts ("8,15" for 3 stages); empty means
      the flops-balanced split (parallel/pipeline.py ``split_layers``).
    - ``wire_dtype``: the dtype of the activations and cotangents sent
      between stages, "float32" or "bfloat16" (cast back to f32 on
      arrival).
    - ``act_dtype``: the stages' compute dtype, "float32", or "bfloat16"
      over f32 masters (grads and loss stay f32).
    """

    stages: int = 1
    split: str = ""
    wire_dtype: str = "float32"
    act_dtype: str = "float32"

    def __post_init__(self):
        if self.stages < 1:
            raise ValueError(f"stages must be >= 1, got {self.stages}")
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown pipeline wire dtype {self.wire_dtype!r} "
                "(float32 or bfloat16)"
            )
        if self.act_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown pipeline act dtype {self.act_dtype!r} "
                "(float32 or bfloat16)"
            )
        self.boundaries()  # validate the split grammar eagerly

    def boundaries(self) -> tuple:
        """The parsed manual split: sorted stage-start layer indices, ()
        when ``split`` is empty (the automatic split)."""
        out = []
        for part in filter(None, self.split.split(",")):
            if not part.strip().isdigit() or int(part) < 1:
                raise ValueError(
                    f"bad pipeline split entry {part!r} (want positive "
                    "layer indices, e.g. '8,15' for 3 stages)"
                )
            out.append(int(part))
        if len(set(out)) != len(out):
            raise ValueError(
                f"pipeline split {self.split!r} repeats a boundary"
            )
        if out and len(out) != self.stages - 1:
            raise ValueError(
                f"pipeline split {self.split!r} names {len(out)} "
                f"boundaries but stages={self.stages} needs "
                f"{self.stages - 1}"
            )
        return tuple(sorted(out))

    @staticmethod
    def from_env() -> Optional["PipelineConfig"]:
        """PipelineConfig from PCNN_PIPELINE_STAGES / PCNN_PIPELINE_SPLIT /
        PCNN_PIPELINE_WIRE_DTYPE / PCNN_PIPELINE_ACT_DTYPE, or None when
        none of them is set."""
        stages = os.environ.get("PCNN_PIPELINE_STAGES")
        split = os.environ.get("PCNN_PIPELINE_SPLIT")
        wire = os.environ.get("PCNN_PIPELINE_WIRE_DTYPE")
        act = os.environ.get("PCNN_PIPELINE_ACT_DTYPE")
        if (stages is None and split is None and wire is None
                and act is None):
            return None
        return PipelineConfig(
            stages=int(stages) if stages else 1,
            split=split or "",
            wire_dtype=wire or "float32",
            act_dtype=act or "float32",
        )


#: Registry names the port serves (serve/registry.py).
SERVE_MODELS = ("lenet_ref", "cifar_cnn", "resnet18", "resnet34", "resnet50",
                "vgg16")
#: Conv kernels of the server: "cuda" (the hand kernels with fused eval
#: epilogues, JAX's "pallas") or "xla" (library convs, JAX's "xla"; the
#: trainer calls it "torch"). Only the resnet and vgg families take "cuda".
SERVE_CONV_BACKENDS = ("xla", "cuda")


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
    # Conv kernels for the resnet/vgg families: "cuda" or "xla"; None
    # takes "cuda" for them and "xla" for lenet_ref and cifar_cnn.
    conv_backend: Optional[str] = None
    # Run every bucket once at startup so the first requests pay no
    # kernel build or allocator warm-up.
    precompile: bool = True
    # SLO admission control (serve/admission.py): EWMA reject-early
    # shedding + the graceful-degradation ladder in front of the queue.
    admission: bool = False
    # Completion-time objective (ms): the admission predictor's budget
    # for deadline-less requests, the autoscaler's p99 target.
    slo_ms: float = 100.0
    # Replica autoscaler (serve/autoscaler.py): grow/drain the pool from
    # windowed telemetry between 1 and max_replicas.
    autoscale: bool = False
    # Autoscaler ceiling; 0 = n_replicas (no growth).
    max_replicas: int = 0
    # Exponential-decay time constant (seconds) of the windowed
    # telemetry views the autoscaler reads (serve/telemetry.py).
    window_s: float = 10.0

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
        if self.conv_backend not in (None, *SERVE_CONV_BACKENDS):
            raise ValueError(f"unknown conv backend {self.conv_backend!r}")
        if self.slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {self.slo_ms}")
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        if self.max_replicas < 0:
            raise ValueError(
                f"max_replicas must be >= 0, got {self.max_replicas}"
            )
        if self.max_replicas and self.max_replicas < self.n_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"n_replicas ({self.n_replicas})"
            )

    @property
    def effective_max_replicas(self) -> int:
        """The autoscaler ceiling: max_replicas, or n_replicas when 0."""
        return self.max_replicas or self.n_replicas

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
            conv_backend=e("PCNN_SERVE_CONV_BACKEND") or None,
            precompile=e("PCNN_SERVE_PRECOMPILE", "1") != "0",
            admission=e("PCNN_SERVE_ADMISSION", "0") != "0",
            slo_ms=float(e("PCNN_SERVE_SLO_MS", "100")),
            autoscale=e("PCNN_SERVE_AUTOSCALE", "0") != "0",
            max_replicas=int(e("PCNN_SERVE_MAX_REPLICAS", "0")),
            window_s=float(e("PCNN_SERVE_WINDOW_S", "10")),
        )


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Network front-door policy (serve/net.py + serve/supervisor.py — the
    out-of-process serving tier in front of the DynamicBatcher); JAX's
    fields, defaults, errors and ``PCNN_SERVE_*`` names. A non-None
    ``aot_cache_dir`` is refused where it is used (NotPortedError, ROADMAP
    A12b): the port has no per-bucket executable to write to disk."""

    # Serve over a real TCP listener (serve/net.py) instead of the
    # in-process-only surface.
    listen: bool = False
    # Bind address for the listener. Loopback by default — the front
    # door is an experiment harness, not a hardened public ingress.
    host: str = "127.0.0.1"
    # TCP port; 0 binds an ephemeral port (the bound port is reported
    # on NetServer.port and kept stable across supervisor respawns).
    port: int = 0
    # Per-connection read/write deadline (ms): a socket that stalls
    # mid-request past this budget is reaped as `expired` (the
    # slow-loris defense), and a blocked response write is abandoned
    # the same way. Also the submit() budget inherited by requests
    # that do not carry their own deadline_ms.
    conn_deadline_ms: float = 2000.0
    # JAX's persistent on-disk AOT-executable cache directory; not
    # ported (None = off).
    aot_cache_dir: Optional[str] = None
    # Supervise the endpoint: respawn a killed listener with bounded
    # exponential backoff (resilience/retry.py) and reconcile the
    # journal across the restart.
    supervise: bool = False
    # Supervisor respawn backoff envelope (RetryPolicy fields).
    respawn_attempts: int = 4
    respawn_base_delay_s: float = 0.05
    respawn_max_delay_s: float = 1.0

    def __post_init__(self):
        if not 0 <= self.port <= 65535:
            raise ValueError(f"port must be in [0, 65535], got {self.port}")
        if self.conn_deadline_ms <= 0:
            raise ValueError(
                f"conn_deadline_ms must be > 0, got {self.conn_deadline_ms}"
            )
        if self.respawn_attempts < 1:
            raise ValueError(
                f"respawn_attempts must be >= 1, got {self.respawn_attempts}"
            )
        if self.respawn_base_delay_s < 0 or self.respawn_max_delay_s < 0:
            raise ValueError("respawn delays must be >= 0")

    @staticmethod
    def from_env() -> "NetConfig":
        """NetConfig with PCNN_SERVE_* environment overrides applied over
        the defaults; the CLI flags then override field by field."""
        e = os.environ.get
        return NetConfig(
            listen=e("PCNN_SERVE_LISTEN", "0") != "0",
            host=e("PCNN_SERVE_HOST", "127.0.0.1"),
            port=int(e("PCNN_SERVE_PORT", "0")),
            conn_deadline_ms=float(e("PCNN_SERVE_CONN_DEADLINE_MS", "2000")),
            aot_cache_dir=e("PCNN_SERVE_AOT_CACHE_DIR") or None,
            supervise=e("PCNN_SERVE_SUPERVISE", "0") != "0",
            respawn_attempts=int(e("PCNN_SERVE_RESPAWN_ATTEMPTS", "4")),
            respawn_base_delay_s=float(
                e("PCNN_SERVE_RESPAWN_BASE_DELAY_S", "0.05")
            ),
            respawn_max_delay_s=float(
                e("PCNN_SERVE_RESPAWN_MAX_DELAY_S", "1.0")
            ),
        )


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability policy (obs/: span tracing with Perfetto export, the
    process-wide metrics registry, and the JSONL event journal); JAX's
    fields, defaults and ``PCNN_OBS_*`` names.

    No ObsConfig at all keeps every hot path on the zero-cost no-op
    bundle: no spans, no journal, no files. Constructing one (--trace /
    PCNN_OBS_* env) opts a run in.
    """

    # Emit host-side spans + the event journal and export the Chrome
    # trace at the end of the run.
    trace: bool = True
    # Directory all trace/journal artifacts are written under.
    dir: str = "obs_out"
    # Path for a MetricsRegistry JSON snapshot at the end of the run;
    # None = no snapshot file. Setting only this (trace off) still
    # enables the registry without any span/journal cost.
    metrics_json: Optional[str] = None
    # Mirror every span into torch.profiler.record_function so a profile
    # of the run carries the same names as the host timeline (JAX's
    # jax_annotations, read from the same PCNN_OBS_JAX).
    annotations: bool = True

    def __post_init__(self):
        if not self.dir:
            raise ValueError("ObsConfig.dir must be a non-empty path")

    @property
    def enabled(self) -> bool:
        return self.trace or self.metrics_json is not None

    @staticmethod
    def from_env() -> Optional["ObsConfig"]:
        """ObsConfig from PCNN_OBS_TRACE / PCNN_OBS_DIR /
        PCNN_OBS_METRICS_JSON / PCNN_OBS_JAX, or None when none of them
        is set (→ the no-op bundle everywhere)."""
        trace = os.environ.get("PCNN_OBS_TRACE")
        d = os.environ.get("PCNN_OBS_DIR")
        mj = os.environ.get("PCNN_OBS_METRICS_JSON")
        jx = os.environ.get("PCNN_OBS_JAX")
        if trace is None and d is None and mj is None and jx is None:
            return None
        return ObsConfig(
            trace=(trace if trace is not None else "1") not in ("0", ""),
            dir=d or "obs_out",
            metrics_json=mj or None,
            annotations=(jx or "1") != "0",
        )


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Elastic-training policy (resilience/elastic.py: in-flight re-mesh
    and ZeRO-3 reshard on a resize request, a chaos-injected device loss
    or a device add), JAX's ``ElasticConfig`` field for field.

    No ElasticConfig at all (``Config.elastic`` None) keeps the fixed
    mesh. Constructing one (--elastic / PCNN_ELASTIC=1) opts the ZeRO-3
    zoo trainer into resize-and-continue; it needs the ZeRO-3 step
    (``FusedStepConfig(zero=3)``), whose world-size-independent full view
    is what a resize re-lays out.
    """

    enabled: bool = True
    # Deterministic resize schedule "STEP:WORLD[,STEP:WORLD...]": before
    # optimizer step STEP (0-based, global across epochs) resize the data
    # world to WORLD ranks. Empty = no planned resizes.
    schedule: str = ""
    # "global": the global batch and LR stay fixed (the parity mode);
    # "per-device": the per-device batch stays fixed and the global batch
    # and LR scale linearly with the world.
    scaling: str = "global"
    # Never shrink below this many ranks; a deeper loss is clamped (and
    # the clamp logged).
    min_world: int = 1

    def __post_init__(self):
        if self.scaling not in ("global", "per-device"):
            raise ValueError(
                f"unknown elastic scaling {self.scaling!r} "
                "(global or per-device)"
            )
        if self.min_world < 1:
            raise ValueError(
                f"min_world must be >= 1, got {self.min_world}"
            )
        self.plan()  # validate the schedule grammar eagerly

    def plan(self) -> tuple:
        """The parsed schedule: ((step, world), ...) sorted by step."""
        out = []
        for part in filter(None, self.schedule.split(",")):
            step, sep, world = part.partition(":")
            if not sep or not step.strip().isdigit() \
                    or not world.strip().isdigit():
                raise ValueError(
                    f"bad elastic schedule entry {part!r} "
                    "(want STEP:WORLD, e.g. '40:4,80:8')"
                )
            out.append((int(step), int(world)))
        return tuple(sorted(out))

    @staticmethod
    def from_env() -> Optional["ElasticConfig"]:
        """ElasticConfig from PCNN_ELASTIC / PCNN_ELASTIC_SCHEDULE /
        PCNN_ELASTIC_SCALING / PCNN_ELASTIC_MIN_WORLD, or None when none
        of them is set."""
        enabled = os.environ.get("PCNN_ELASTIC")
        schedule = os.environ.get("PCNN_ELASTIC_SCHEDULE")
        scaling = os.environ.get("PCNN_ELASTIC_SCALING")
        min_world = os.environ.get("PCNN_ELASTIC_MIN_WORLD")
        if (enabled is None and schedule is None and scaling is None
                and min_world is None):
            return None
        return ElasticConfig(
            enabled=(enabled if enabled is not None else "1")
            not in ("0", ""),
            schedule=schedule or "",
            scaling=scaling or "global",
            min_world=int(min_world) if min_world else 1,
        )


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Asynchronous data-parallel policy (train/async_dp.py: bounded
    staleness per arXiv:1711.00705, EASGD per arXiv:1605.08325), JAX's
    ``AsyncConfig`` field for field.

    No AsyncConfig at all (``Config.async_dp`` None) keeps training
    bulk-synchronous. The async modes keep bitwise parity with the sync
    schedule only at mode "stale" with ``staleness_bound=0``.
    """

    # "off" (the sync schedule), "stale" (bounded staleness: a hard
    # barrier only where the bound would be violated) or "easgd"
    # (independent local SGD with a periodic pull toward a center).
    mode: str = "stale"
    # Max optimizer-step age S of the params a gradient may be computed
    # against (mode "stale"); 0 is the synchronous schedule.
    staleness_bound: int = 2
    # Local SGD steps between elastic-averaging rounds (mode "easgd").
    easgd_period: int = 4
    # Elastic-averaging pull strength in (0, 1].
    easgd_rho: float = 0.5
    # Logical workers the virtual-clock scheduler simulates.
    workers: int = 4
    # A completion later than this multiple of the nominal step duration
    # journals a ``straggler_detected`` event.
    straggler_factor: float = 2.0

    def __post_init__(self):
        if self.mode not in ("off", "stale", "easgd"):
            raise ValueError(
                f"unknown async mode {self.mode!r} (off, stale or easgd)"
            )
        if self.staleness_bound < 0:
            raise ValueError(
                f"staleness_bound must be >= 0, got {self.staleness_bound}"
            )
        if self.easgd_period < 1:
            raise ValueError(
                f"easgd_period must be >= 1, got {self.easgd_period}"
            )
        if not (0.0 < self.easgd_rho <= 1.0):
            raise ValueError(
                f"easgd_rho must be in (0, 1], got {self.easgd_rho}"
            )
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor must be > 1, got {self.straggler_factor}"
            )

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @staticmethod
    def from_env() -> Optional["AsyncConfig"]:
        """AsyncConfig from PCNN_ASYNC_MODE / PCNN_ASYNC_STALENESS /
        PCNN_ASYNC_EASGD_PERIOD / PCNN_ASYNC_EASGD_RHO /
        PCNN_ASYNC_WORKERS, or None when none of them is set."""
        mode = os.environ.get("PCNN_ASYNC_MODE")
        bound = os.environ.get("PCNN_ASYNC_STALENESS")
        period = os.environ.get("PCNN_ASYNC_EASGD_PERIOD")
        rho = os.environ.get("PCNN_ASYNC_EASGD_RHO")
        workers = os.environ.get("PCNN_ASYNC_WORKERS")
        if (mode is None and bound is None and period is None
                and rho is None and workers is None):
            return None
        return AsyncConfig(
            mode=mode or "stale",
            staleness_bound=int(bound) if bound else 2,
            easgd_period=int(period) if period else 4,
            easgd_rho=float(rho) if rho else 0.5,
            workers=int(workers) if workers else 4,
        )


@dataclasses.dataclass(frozen=True)
class Config:
    """The trainer's whole configuration, JAX's sections (config.py:889).
    ``cli.config_from_args`` layers flag > env > plan file > default into
    it, and ``plan.build_plan`` turns it into the ExecutionPlan.

    ``fused`` (a ``FusedStepConfig``, None = the unfused step) selects,
    for LeNet-ref, the bucketed update (ops/sgd_update.py) on the
    reference grads; with ``ops="cuda"`` the fused kernel's step keeps
    its own update, as JAX's Pallas step does; on a mesh the LeNet step
    never reads it (JAX's mesh steps apply their own update, and the
    plan refuses a fused update off the ring before the run). For the
    zoo trainer it is the fused step. ``comm`` (a ``CommConfig``; None is
    one psum or JAX's GSPMD path) picks the gradient collective;
    ``mesh`` the (data, model) axis sizes; ``pipeline`` the 1F1B
    pipeline."""

    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()
    resilience: ResilienceConfig = ResilienceConfig()
    comm: Optional[CommConfig] = None
    fused: Optional[FusedStepConfig] = None
    # None = observability off; an ObsConfig opts the run into span
    # tracing, the journal and the metrics snapshot (obs/).
    obs: Optional[ObsConfig] = None
    # None = fixed-mesh training; an ElasticConfig opts the ZeRO-3 zoo
    # trainer into in-flight re-mesh and reshard (resilience/elastic.py).
    elastic: Optional[ElasticConfig] = None
    # None = bulk-synchronous training; an AsyncConfig opts into the
    # bounded-staleness or EASGD modes (train/async_dp.py).
    async_dp: Optional[AsyncConfig] = None
    # None = data-parallel only; a PipelineConfig opts the zoo trainer
    # into 1F1B microbatch pipelining over a (stage, data) mesh.
    pipeline: Optional[PipelineConfig] = None
    model: str = "lenet_ref"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


#: Every PCNN_* variable that feeds an ExecutionPlan knob — the set
#: plan.build_plan consults to label a knob's provenance "env" (JAX's
#: config.py:934-950).
_PLAN_ENV_VARS = (
    "PCNN_COMM_IMPL",
    "PCNN_COMM_BUCKET_BYTES",
    "PCNN_COMM_WIRE_DTYPE",
    "PCNN_COMM_OVERLAP",
    "PCNN_COMM_HOSTS",
    "PCNN_FUSED_STEP",
    "PCNN_ACT_DTYPE",
    "PCNN_ZERO_LEVEL",
    "PCNN_PIPELINE_STAGES",
    "PCNN_PIPELINE_SPLIT",
    "PCNN_PIPELINE_WIRE_DTYPE",
    "PCNN_PIPELINE_ACT_DTYPE",
    "PCNN_SERVE_PRECOMPILE",
    "PCNN_SERVE_AOT_CACHE_DIR",
)


def present_plan_env() -> frozenset:
    """The plan-feeding PCNN_* vars actually set in this environment."""
    return frozenset(v for v in _PLAN_ENV_VARS if os.environ.get(v))


def plan_path_from_env() -> Optional[str]:
    """PCNN_PLAN: path to a plan.json applied under CLI flags (same
    precedence slot as --plan; an explicit --plan flag wins), or None."""
    return os.environ.get("PCNN_PLAN") or None
