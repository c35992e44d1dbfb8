"""Command line of the port (the counterpart of ``parallel_cnn_tpu/cli.py``).

    python -m parallel_cnn_tpu_torch [trainer flags]      # the LeNet-ref trainer
    python -m parallel_cnn_tpu_torch --model resnet18 --conv-backend cuda
    python -m parallel_cnn_tpu_torch serve --model resnet18
    python -m parallel_cnn_tpu_torch loadgen --requests 512 --pattern open

With no subcommand the CLI is the trainer, as in JAX: for ``lenet_ref``
load data → learn → test, printing the reference's lines; for a zoo model
(``cifar_cnn``, ``resnet18``, ``resnet34``, ``resnet50``, ``vgg16``) JAX's
zoo trainer: the
synthetic CIFAR-shape sets, per-epoch ``epoch N: loss L, acc A% (S s)``
lines, checkpoints of the full state and ``--resume``, on one device, on
JAX's GSPMD path over ``--mesh-data N [--mesh-model M]`` (global BN
statistics, each layer's filters split over the model axis where they
divide), or with ``--mesh-data N --comm-impl psum|ring`` data-parallel over
explicit collectives (one process a rank; NCCL, one card per rank, or gloo
with ``--device cpu``), with ``--fused-step`` and the ring as
update-on-arrival. LeNet-ref
takes ``--mesh-data N [--mesh-model M] [--comm-impl psum|ring]``: minibatch
SGD over an N × M mesh of ranks, data-parallel, with the filters split
over the model axis when M > 1 (rank 0 prints, records and checkpoints).
Everything runs on the GPU unless ``--device cpu`` is given. Of the
trainer flags of later slices, ``--comm-hosts``, ``--pipeline-stages``
and ``--elastic`` are typed NotPortedErrors (``--comm-impl`` with a zoo
model axis is JAX's data-only MeshLayoutError); the trainer's chaos,
async, trace and profile are not accepted yet. ``serve`` and ``loadgen``
take JAX's SLO layer: ``--admission``, ``--slo-ms``, ``--autoscale``,
``--max-replicas``, ``--window-s``, ``--scenario``, ``--chaos`` and the obs
flags ``--trace``, ``--trace-dir`` and ``--metrics-json``, and JAX's
network front door: ``--listen`` puts an NDJSON-over-TCP endpoint in front
of the batcher (``--listen-host``, ``--listen-port``,
``--conn-deadline-ms``), ``--supervise`` respawns it when it dies, and the
``net-*`` scenarios drive it through the socket transport
(``--swap-checkpoint`` for the hot swap). JAX's on-disk executable cache
(``--aot-cache-dir``) raises NotPortedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import List, Optional

from parallel_cnn_tpu_torch.config import (
    CONV_BACKENDS,
    SERVE_MODELS,
    ZOO_MODELS,
    CommConfig,
    Config,
    DataConfig,
    FusedStepConfig,
    MeshConfig,
    SERVE_CONV_BACKENDS,
    NetConfig,
    NotPortedError,
    ObsConfig,
    ResilienceConfig,
    ServeConfig,
    TrainConfig,
    check_comm_mesh,
)


def build_parser() -> argparse.ArgumentParser:
    """The trainer's flags: the JAX CLI's lenet_ref and single-device zoo
    flags, with ``--ops cuda`` for JAX's ``--ops pallas`` and
    ``--conv-backend cuda``/``torch`` for its ``pallas``/``xla``, plus
    ``--device``."""
    p = argparse.ArgumentParser(
        prog="parallel_cnn_tpu_torch",
        description="the LeNet-ref and zoo trainers on the GPU (PyTorch + "
                    "hand-written CUDA kernels); subcommands: serve, loadgen",
    )
    d, t, r = DataConfig(), TrainConfig(), ResilienceConfig()
    p.add_argument("--model", default="lenet_ref",
                   choices=["lenet_ref", *ZOO_MODELS],
                   help="lenet_ref = the reference-parity trainer; the rest "
                        "are zoo models on the synthetic CIFAR-shape set")
    p.add_argument("--conv-backend", default="torch", choices=CONV_BACKENDS,
                   help="resnet/vgg models only: the hand-written conv kernels "
                        "(cuda; forward, dgrad, wgrad) or library convs "
                        "(torch)")
    p.add_argument("--lr", type=float, default=0.1,
                   help="zoo models only: SGD learning rate")
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine"],
                   help="zoo models only: cosine decays over the full run "
                        "(epochs x steps); both honor --warmup-steps")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="zoo models only: linear LR warmup steps")
    p.add_argument("--augment", action="store_true",
                   help="zoo models only: random crop + horizontal flip "
                        "(CIFAR recipe) on the device")
    p.add_argument("--accum-steps", type=int, default=None,
                   help="zoo models only: gradient-accumulation "
                        "microbatches (default 1)")
    p.add_argument("--zoo-loader", default="device",
                   choices=["device", "native"],
                   help="zoo models only: batch source — gathers over the "
                        "device-resident set, or the native C++ prefetch ring "
                        "(data/native.py; its NumPy twin where no compiler "
                        "builds it)")
    p.add_argument("--act-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="fused-step activation dtype (default bfloat16: "
                        "bf16 activations on f32 masters, with the loss "
                        "scale)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu, which runs the kernels' "
                        "plain PyTorch versions")
    p.add_argument("--loader", default=d.loader,
                   choices=["auto", "native", "numpy", "synthetic"],
                   help="idx parser: the native C++ one (native raises when "
                        "it cannot be built; auto then takes NumPy's), NumPy's, "
                        "or the synthetic set")
    p.add_argument("--data-dir", default=None,
                   help="directory holding the four idx files "
                        "(defaults to the DataConfig paths)")
    p.add_argument("--epochs", type=int, default=t.epochs)
    # None: lenet_ref defaults to per-sample SGD (1), zoo models to 128.
    p.add_argument("--batch-size", type=int, default=None,
                   help="1 = the reference's per-sample SGD; >1 minibatch")
    p.add_argument("--dt", type=float, default=t.dt,
                   help="SGD step (dt at Sequential/layer.h:12)")
    p.add_argument("--threshold", type=float, default=t.threshold,
                   help="early-stop err threshold (layer.h:13)")
    p.add_argument("--seed", type=int, default=t.seed)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--prefetch", default=t.prefetch,
                   choices=["auto", "native", "off"],
                   help="minibatch order: the native C++ prefetch ring's, "
                        "from the ring itself (native; raises when it cannot "
                        "be built) or from its NumPy twin gathered on the "
                        "device (auto; the same batches), or NumPy slicing (off)")
    p.add_argument("--ops", default=t.ops, choices=["reference", "cuda"],
                   help="plain PyTorch ops, or the hand-written fused "
                        "train-step kernel (csrc/lenet_fused.cu; "
                        "batch_size>1 only)")
    p.add_argument("--synthetic-train-count", type=int,
                   default=d.synthetic_train_count)
    p.add_argument("--synthetic-test-count", type=int,
                   default=d.synthetic_test_count)
    p.add_argument("--mesh-data", type=int, default=None, metavar="N",
                   help="data(-parallel) mesh axis size; setting either "
                        "mesh flag routes minibatch training over the "
                        "device mesh (≙ mpirun -np N, MPI/Main.cpp:44). "
                        "Zoo models: N ranks, one process and one card "
                        "each (gloo ranks with --device cpu): JAX's GSPMD "
                        "path (global BN statistics), or with --comm-impl "
                        "the explicit collectives")
    p.add_argument("--mesh-model", type=int, default=None, metavar="N",
                   help="model (intra-op) mesh axis size. lenet_ref: must "
                        "divide the 6 conv filters (1, 2, 3, 6); filters and "
                        "the FC contraction split over N ranks of each data "
                        "row. Zoo models (GSPMD path, no --comm-impl): each "
                        "layer's filters split over N ranks where they "
                        "divide evenly")
    p.add_argument("--comm-impl", default=None,
                   choices=["psum", "ring", "hierarchical"],
                   help="mesh runs: gradient-collective algorithm "
                        "(parallel/collectives.py) — one all-reduce, or "
                        "bucketed ring reduce-scatter/all-gather over the "
                        "data axis; hierarchical not ported yet (ROADMAP "
                        "A9). Default: PCNN_COMM_IMPL")
    p.add_argument("--comm-bucket-mb", type=float, default=None, metavar="MB",
                   help="ring collective bucket size in MiB "
                        "(PCNN_COMM_BUCKET_BYTES; default 4)")
    p.add_argument("--comm-wire-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="collective payload dtype on the wire; bfloat16 "
                        "halves the bytes, accumulation stays f32 "
                        "(PCNN_COMM_WIRE_DTYPE)")
    p.add_argument("--comm-hosts", type=int, default=None, metavar="N",
                   help="--comm-impl hierarchical: host-axis size; not "
                        "ported yet (ROADMAP A9)")
    p.add_argument("--pipeline-stages", type=int, default=None, metavar="S",
                   help="pipeline parallelism (1F1B); not ported yet "
                        "(ROADMAP A10)")
    p.add_argument("--elastic", action="store_true",
                   help="elastic training; not ported yet (ROADMAP A11)")
    p.add_argument("--fused-step", action="store_true",
                   help="lenet_ref: update through the fused bucketed SGD "
                        "kernel (csrc/sgd_update.cu); zoo: the fused loss "
                        "tail (csrc/tail_ce.cu) and, with --mesh-data and "
                        "--comm-impl ring, update-on-arrival through the "
                        "fused SGD-momentum kernel")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save ckpt_<epoch>.npz per epoch; --resume restarts "
                        "from the latest")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--sentinel", default=r.policy,
                   choices=["off", "raise", "skip", "rollback"],
                   help="health-sentinel policy on a non-finite loss/param")
    p.add_argument("--max-rollbacks", type=int, default=r.max_rollbacks,
                   help="bounded retry budget for --sentinel rollback")
    p.add_argument("--lr-backoff", type=float, default=r.lr_backoff,
                   help="LR multiplier applied per rollback")
    p.add_argument("--keep-checkpoints", type=int, default=r.ring_size,
                   metavar="N",
                   help="prune --checkpoint-dir to the newest N "
                        "checkpoints (0 = keep all)")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append JSONL metrics records to PATH")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    paths = {}
    if args.data_dir:
        paths = dict(
            train_images=os.path.join(args.data_dir, "train-images.idx3-ubyte"),
            train_labels=os.path.join(args.data_dir, "train-labels.idx1-ubyte"),
            test_images=os.path.join(args.data_dir, "t10k-images.idx3-ubyte"),
            test_labels=os.path.join(args.data_dir, "t10k-labels.idx1-ubyte"),
        )
    return Config(
        data=DataConfig(
            loader=args.loader,
            synthetic_train_count=args.synthetic_train_count,
            synthetic_test_count=args.synthetic_test_count,
            **paths,
        ),
        train=TrainConfig(
            dt=args.dt,
            threshold=args.threshold,
            epochs=args.epochs,
            batch_size=1 if args.batch_size is None else args.batch_size,
            seed=args.seed,
            shuffle=args.shuffle,
            prefetch=args.prefetch,
            ops=args.ops,
        ),
        resilience=ResilienceConfig(
            policy=args.sentinel,
            max_rollbacks=args.max_rollbacks,
            lr_backoff=args.lr_backoff,
            ring_size=args.keep_checkpoints,
        ),
        fused=args.fused_step,
        comm=_comm_from_args(args),
    )


def _refuse_later_slices(args: argparse.Namespace) -> None:
    """JAX's flags whose paths are not ported raise a typed error naming
    the ROADMAP item that brings them."""
    if args.comm_hosts is not None:
        raise NotPortedError("--comm-hosts sets the hierarchical ring's host "
                             "axis, which is not ported yet (ROADMAP A9)")
    if args.pipeline_stages is not None:
        raise NotPortedError("--pipeline-stages (1F1B pipeline parallelism) "
                             "is not ported yet (ROADMAP A10)")
    if args.elastic:
        raise NotPortedError("--elastic (in-flight re-mesh with ZeRO-3 "
                             "resharding) is not ported yet (ROADMAP A11)")


def _comm_from_args(args: argparse.Namespace) -> Optional[CommConfig]:
    """PCNN_COMM_* first, then the --comm-* flags field by field, as JAX
    layers them (cli.py:385-400); None when neither sets anything."""
    comm = CommConfig.from_env()
    if (args.comm_impl is not None or args.comm_bucket_mb is not None
            or args.comm_wire_dtype is not None):
        base = comm or CommConfig()
        comm = dataclasses.replace(
            base,
            impl=args.comm_impl or base.impl,
            bucket_bytes=(int(args.comm_bucket_mb * 1024 * 1024)
                          if args.comm_bucket_mb is not None
                          else base.bucket_bytes),
            wire_dtype=args.comm_wire_dtype or base.wire_dtype,
        )
    return comm


def _fused_from_args(args: argparse.Namespace) -> Optional[FusedStepConfig]:
    """PCNN_FUSED_STEP first, then --fused-step; --act-dtype only refines
    an enabled fused step."""
    fused = FusedStepConfig.from_env()
    if args.fused_step:
        fused = fused or FusedStepConfig()
    if args.act_dtype is not None:
        if fused is None:
            raise SystemExit("--act-dtype refines the fused step; enable it "
                             "with --fused-step first")
        fused = dataclasses.replace(fused, act_dtype=args.act_dtype)
    return fused


def _zoo_job(mesh, args: argparse.Namespace, comm: Optional[CommConfig],
             fused: Optional[FusedStepConfig]) -> None:
    """One rank's zoo run (``mesh`` None: the single-device run): the
    model from the seed (the same weights on every rank), the synthetic
    train and eval sets, zoo.train."""
    import torch

    from parallel_cnn_tpu_torch.data import synthetic
    from parallel_cnn_tpu_torch.nn import cifar, resnet, vgg
    from parallel_cnn_tpu_torch.resilience import preempt
    from parallel_cnn_tpu_torch.train import zoo
    from parallel_cnn_tpu_torch.utils.backend import resolve_device
    from parallel_cnn_tpu_torch.utils.metrics import MetricsLogger

    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    factories = {
        "cifar_cnn": lambda: cifar.cifar_cnn(generator=gen),
        "resnet18": lambda: resnet.resnet18(
            10, backend=args.conv_backend, generator=gen),
        "resnet34": lambda: resnet.resnet34(
            10, backend=args.conv_backend, generator=gen),
        "resnet50": lambda: resnet.resnet50(
            10, cifar_stem=True, backend=args.conv_backend, generator=gen),
        "vgg16": lambda: vgg.vgg16(10, backend=args.conv_backend, generator=gen),
    }
    model = factories[args.model]()
    data = DataConfig()
    imgs, labels = synthetic.make_image_dataset(
        args.synthetic_train_count, seed=data.synthetic_seed)
    ev = synthetic.make_image_dataset(
        args.synthetic_test_count, seed=data.synthetic_seed + 1)
    metrics = MetricsLogger(path=args.metrics) if args.metrics and lead else None
    with preempt.PreemptionGuard() as guard:
        zoo.train(
            model, imgs, labels,
            epochs=args.epochs,
            batch_size=args.batch_size or 128,
            lr=args.lr,
            lr_schedule=args.lr_schedule,
            warmup_steps=args.warmup_steps,
            augment=args.augment,
            accum_steps=args.accum_steps or 1,
            mesh=mesh,
            model_axis=(comm is None and mesh is not None
                        and mesh.model.size > 1),
            comm=comm,
            fused=fused,
            seed=args.seed,
            eval_data=ev,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
            metrics=metrics,
            loader=args.zoo_loader,
            resilience=ResilienceConfig(
                policy=args.sentinel, max_rollbacks=args.max_rollbacks,
                ring_size=args.keep_checkpoints),
            device=device,
        )
    if guard.preempted and lead:
        print("preempted: checkpoint flushed; continue with --resume")
    if metrics:
        metrics.close()


def _run_zoo(args: argparse.Namespace) -> int:
    """≙ the JAX CLI's ``_run_zoo``: the synthetic CIFAR-shape train/eval
    sets, zoo.train with per-epoch eval, checkpoints, resume, sentinel and
    preemption; on one device, over a ``--mesh-data N [--mesh-model M]``
    mesh of ranks on JAX's GSPMD path, or over ``--mesh-data N`` ranks with
    ``--comm-impl`` (parallel/distributed.py starts them)."""
    if args.model == "cifar_cnn" and args.conv_backend != "torch":
        raise SystemExit("--conv-backend cuda applies to the resnet/vgg models")
    if args.batch_size == 1:
        raise SystemExit("zoo models train minibatch; use --batch-size > 1")
    _refuse_later_slices(args)
    mesh_cfg = MeshConfig(data=args.mesh_data, model=args.mesh_model or 1)
    comm = _comm_from_args(args)
    check_comm_mesh(mesh_cfg, comm)
    fused = _fused_from_args(args)
    if args.mesh_data is None and mesh_cfg.model == 1:
        if comm is not None:
            raise SystemExit("--comm-impl/PCNN_COMM_* run the explicit "
                             "collectives over a mesh: add --mesh-data N")
        _zoo_job(None, args, comm, fused)
        return 0

    from parallel_cnn_tpu_torch.parallel import distributed

    if comm is None:
        n_data, n_model = distributed.resolve_shape(mesh_cfg, args.device)
        print(f"mesh: {{'data': {n_data}, 'model': {n_model}}}", flush=True)
        distributed.run(_zoo_job, n_data * n_model, device=args.device,
                        args=(args, comm, fused), shape=(n_data, n_model))
        return 0
    world = distributed.resolve_world(mesh_cfg, args.device)
    print(f"mesh: {{'data': {world}, 'model': 1}}", flush=True)
    distributed.run(_zoo_job, world, device=args.device,
                    args=(args, comm, fused))
    return 0


def _lenet_job(mesh, args: argparse.Namespace, cfg: Config) -> int:
    """One rank's LeNet-ref run (``mesh`` None: the single-device run):
    load → learn with a checkpoint per epoch, resume, preemption → test.
    On a mesh every rank trains; rank 0 alone prints the reference's
    lines, records metrics and saves checkpoints (whole params), and every
    rank resumes from the same file."""
    from parallel_cnn_tpu_torch.data import pipeline
    from parallel_cnn_tpu_torch.resilience import preempt
    from parallel_cnn_tpu_torch.resilience.rollback import CheckpointRing
    from parallel_cnn_tpu_torch.train import checkpoint, trainer
    from parallel_cnn_tpu_torch.utils.backend import resolve_device
    from parallel_cnn_tpu_torch.utils.metrics import MetricsLogger, throughput

    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else resolve_device(args.device)
    # Surface the data pipeline's INFO-level evidence (the real-MNIST
    # integrity report) in the CLI's output, once.
    logging.getLogger("parallel_cnn_tpu_torch").setLevel(
        logging.INFO if lead else logging.ERROR)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(levelname)s %(name)s: %(message)s")

    train_ds, test_ds = pipeline.load_train_test(cfg.data)
    ring = None
    if args.checkpoint_dir and lead:
        ring = CheckpointRing(args.checkpoint_dir, keep=cfg.resilience.ring_size)

    params = None
    start_epoch = 0
    error_history: List[float] = []
    if args.checkpoint_dir and args.resume:
        path = checkpoint.latest(args.checkpoint_dir)
        if path:
            like = trainer.init_params(cfg.train.seed, device)
            params, state = checkpoint.restore(path, like)
            start_epoch = state.epoch
            error_history = list(state.epoch_errors)
            if lead:
                print(f"resumed from {path} (epoch {start_epoch})")

    metrics = MetricsLogger(path=args.metrics) if args.metrics and lead else None
    remaining = max(cfg.train.epochs - start_epoch, 0)
    run_cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=remaining))

    def on_epoch(epoch: int, epoch_params, err: float) -> None:
        """Mid-training persistence: a killed run resumes from its last
        finished epoch."""
        error_history.append(err)
        if metrics:
            metrics.record(event="epoch", epoch=epoch, error=err)
        if ring is not None:
            ring.save(epoch, epoch_params,
                      checkpoint.TrainState(epoch=epoch,
                                            epoch_errors=list(error_history)))

    # SIGTERM/SIGINT stop training at the next epoch boundary with the
    # checkpoint already flushed.
    with preempt.PreemptionGuard() as guard:
        result = trainer.learn(
            run_cfg, train_ds, params=params, verbose=lead,
            epoch_offset=start_epoch, epoch_callback=on_epoch, ring=ring,
            device=device, mesh=mesh,
        )

    if result.preempted or guard.preempted:
        if metrics:
            metrics.record(event="preempted",
                           epoch=start_epoch + len(result.epoch_errors))
            metrics.close()
        if lead:
            print("preempted: checkpoint flushed; continue with --resume")
        return 0
    if not lead:
        return 0

    rate = trainer.test(result.params, test_ds)
    if metrics:
        n_images = len(train_ds) * max(len(result.epoch_errors), 1)
        metrics.record(
            event="final",
            error_rate=rate,
            seconds=result.seconds,
            images_per_sec=throughput(n_images, result.seconds),
            steps=result.steps,
        )
        metrics.close()
    return 0


def _run_train(argv: List[str]) -> int:
    """≙ the JAX CLI's trainer: the lenet_ref branch (load → learn with a
    checkpoint per epoch, resume, preemption → test), on one device or
    over a ``--mesh-data``/``--mesh-model`` mesh of ranks
    (parallel/distributed.py starts them), or the zoo branch."""
    args = build_parser().parse_args(argv)
    if args.model != "lenet_ref":
        return _run_zoo(args)
    _refuse_later_slices(args)
    cfg = config_from_args(args)
    mesh_cfg = MeshConfig(data=args.mesh_data, model=args.mesh_model or 1)
    if args.mesh_data is None and mesh_cfg.model == 1:
        if cfg.comm is not None:
            raise SystemExit("--comm-impl/PCNN_COMM_* run the explicit "
                             "collectives over a mesh: add --mesh-data N")
        return _lenet_job(None, args, cfg)

    from parallel_cnn_tpu_torch.parallel import distributed
    from parallel_cnn_tpu_torch.train import trainer

    n_data, n_model = distributed.resolve_shape(mesh_cfg, args.device)
    trainer.check_mesh(cfg.train, n_data, n_model)
    print(f"mesh: {{'data': {n_data}, 'model': {n_model}}}", flush=True)
    distributed.run(_lenet_job, n_data * n_model, device=args.device,
                    args=(args, cfg), shape=(n_data, n_model))
    return 0


SCENARIO_NAMES = ("diurnal", "flash-crowd", "slow-client", "chaos-kill",
                  "chaos-slow")
#: JAX's wire scenarios (serve/scenarios.py NET_SCENARIOS); each needs --listen.
NET_SCENARIO_NAMES = ("net-steady", "net-slow-loris", "net-kill-endpoint",
                      "net-hot-swap-diurnal")


def _add_obs_flags(p: argparse.ArgumentParser) -> None:
    """JAX's observability flags (cli.py:307-342): off by default (the
    zero-cost no-op bundle); PCNN_OBS_* env sets the base and these flags
    override field by field."""
    p.add_argument("--trace", action="store_true",
                   help="record host-side spans and the event journal; "
                        "writes a Perfetto-loadable Chrome trace JSON and "
                        "a JSONL journal under --trace-dir on exit "
                        "[PCNN_OBS_TRACE]")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="artifact directory for the trace + journal "
                        "(implies --trace) [PCNN_OBS_DIR]")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write the metrics-registry JSON snapshot to PATH "
                        "on exit (works without --trace: metrics-only "
                        "mode) [PCNN_OBS_METRICS_JSON]")


def _obs_config_from_args(args: argparse.Namespace) -> Optional[ObsConfig]:
    """Env first, flags override field by field; everything unset → None
    (observability off)."""
    obs_cfg = ObsConfig.from_env()
    if args.trace or args.trace_dir or args.metrics_json:
        base = obs_cfg if obs_cfg is not None else ObsConfig(
            trace=bool(args.trace or args.trace_dir)
        )
        obs_cfg = dataclasses.replace(
            base,
            trace=base.trace or bool(args.trace or args.trace_dir),
            dir=args.trace_dir or base.dir,
            metrics_json=args.metrics_json or base.metrics_json,
        )
    return obs_cfg


def build_serve_parser(cmd: str) -> argparse.ArgumentParser:
    """Flags of `serve` and `loadgen` (JAX's cli.py:590-700); defaults
    come from ServeConfig.from_env() and NetConfig.from_env() (the
    PCNN_SERVE_* names of the JAX package). ``--aot-cache-dir`` parses and
    raises NotPortedError."""
    sc = ServeConfig.from_env()
    p = argparse.ArgumentParser(
        prog=f"parallel_cnn_tpu_torch {cmd}",
        description=(
            "inference serving on the GPU: checkpoint → shape-bucketed, "
            "dynamically batched predict"
            if cmd == "serve"
            else "drive the serving stack with seeded traffic and report "
                 "latency percentiles / shed rate"
        ),
    )
    p.add_argument("--model", default=sc.model, choices=list(SERVE_MODELS),
                   help="registry name [PCNN_SERVE_MODEL]")
    p.add_argument("--checkpoint", default=sc.checkpoint,
                   help="restore params + BN stats from a checkpoint the "
                        "JAX trainer wrote (.npz; a lenet params tree or a "
                        "zoo state, optimizer state ignored) "
                        "[PCNN_SERVE_CHECKPOINT]")
    p.add_argument("--conv-backend", default=sc.conv_backend,
                   choices=list(SERVE_CONV_BACKENDS),
                   help="resnet/vgg only: the hand conv kernels with fused "
                        "eval epilogues (cuda, their default) or library "
                        "convs (xla) [PCNN_SERVE_CONV_BACKEND]")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; every visible card) or cpu, which "
                        "runs the kernels' plain PyTorch versions")
    p.add_argument("--max-batch", type=int, default=sc.max_batch,
                   help="top shape bucket (power of two) "
                        "[PCNN_SERVE_MAX_BATCH]")
    p.add_argument("--max-wait-ms", type=float, default=sc.max_wait_ms,
                   help="batch coalescing window [PCNN_SERVE_MAX_WAIT_MS]")
    p.add_argument("--queue-depth", type=int, default=sc.queue_depth,
                   help="bounded request queue; full → typed Overloaded "
                        "shed [PCNN_SERVE_QUEUE_DEPTH]")
    p.add_argument("--replicas", type=int, default=sc.n_replicas,
                   help="engine replicas pinned round-robin across local "
                        "devices [PCNN_SERVE_REPLICAS]")
    p.add_argument("--deadline-ms", type=float, default=sc.deadline_ms,
                   help="per-request deadline budget (0 = none) "
                        "[PCNN_SERVE_DEADLINE_MS]")
    p.add_argument("--no-precompile", action="store_true",
                   help="warm buckets lazily on first use instead of at "
                        "startup [PCNN_SERVE_PRECOMPILE=0]")
    p.add_argument("--admission", action="store_true",
                   help="SLO admission control in front of the queue: "
                        "EWMA reject-early shedding + the graceful-"
                        "degradation ladder (serve/admission.py) "
                        "[PCNN_SERVE_ADMISSION]")
    p.add_argument("--slo-ms", type=float, default=sc.slo_ms,
                   help="completion-time objective: admission budget for "
                        "deadline-less requests, autoscaler p99 target "
                        "[PCNN_SERVE_SLO_MS]")
    p.add_argument("--autoscale", action="store_true",
                   help="replica autoscaler: grow/drain the pool between 1 "
                        "and --max-replicas from windowed telemetry "
                        "(serve/autoscaler.py) [PCNN_SERVE_AUTOSCALE]")
    p.add_argument("--max-replicas", type=int, default=sc.max_replicas,
                   help="autoscaler ceiling (0 = --replicas: no growth) "
                        "[PCNN_SERVE_MAX_REPLICAS]")
    p.add_argument("--window-s", type=float, default=sc.window_s,
                   help="decay time constant of the windowed telemetry "
                        "the autoscaler reads [PCNN_SERVE_WINDOW_S]")
    p.add_argument("--scenario", default=None,
                   choices=[*SCENARIO_NAMES, *NET_SCENARIO_NAMES],
                   help="drive a seeded SLO-gated traffic scenario "
                        "(serve/scenarios.py) instead of plain loadgen; "
                        "exit code reflects the p99/shed/conservation "
                        "gates (chaos-* scenarios need --chaos; net-* "
                        "scenarios need --listen and judge the wire tier "
                        "too)")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="serving fault injection: kill-replica@SEQ kills "
                        "the replica holding dispatch batch SEQ, "
                        "slow-replica@SEQ:MS stalls it MS ms, "
                        "kill-endpoint@SEQ kills the network endpoint at "
                        "wire request SEQ, slow-loris@SEQ:MS stalls a "
                        "client mid-request for MS ms "
                        "(resilience/chaos.py)")
    nc = NetConfig.from_env()
    g = p.add_argument_group("network front door (serve/net.py)")
    g.add_argument("--listen", action="store_true", default=nc.listen,
                   help="serve over a real TCP socket (NDJSON protocol) "
                        "instead of in-process submit; traffic/scenarios "
                        "are driven through the socket transport "
                        "[PCNN_SERVE_LISTEN]")
    g.add_argument("--listen-host", default=nc.host,
                   help="bind address for --listen [PCNN_SERVE_HOST]")
    g.add_argument("--listen-port", type=int, default=nc.port,
                   help="bind port for --listen; 0 = ephemeral (the "
                        "supervisor respawns on whatever was bound) "
                        "[PCNN_SERVE_PORT]")
    g.add_argument("--conn-deadline-ms", type=float,
                   default=nc.conn_deadline_ms,
                   help="per-connection read/write deadline: a socket "
                        "stalling mid-request past it is reaped as "
                        "expired (slow-loris defense); also the budget "
                        "of deadline-less wire requests "
                        "[PCNN_SERVE_CONN_DEADLINE_MS]")
    g.add_argument("--aot-cache-dir", default=nc.aot_cache_dir,
                   help="JAX's persistent on-disk executable cache: not "
                        "ported, raises NotPortedError "
                        "[PCNN_SERVE_AOT_CACHE_DIR]")
    g.add_argument("--supervise", action="store_true", default=nc.supervise,
                   help="respawn a killed endpoint on the same port with "
                        "bounded exponential backoff "
                        "(serve/supervisor.py) [PCNN_SERVE_SUPERVISE]")
    g.add_argument("--swap-checkpoint", default=None, metavar="PATH",
                   help="net-hot-swap-diurnal: checkpoint to hot-swap in "
                        "mid-peak (default: fresh seed+1 init)")
    p.set_defaults(net_env=nc)
    p.add_argument("--requests", type=int,
                   default=64 if cmd == "serve" else 512,
                   help="traffic volume to drive through the stack")
    p.add_argument("--pattern", default="closed", choices=["closed", "open"],
                   help="arrival pattern (serve/loadgen.py): closed-loop "
                        "concurrency or open-loop Poisson")
    p.add_argument("--concurrency", type=int, default=8,
                   help="closed loop: synchronous client count")
    p.add_argument("--rate", type=float, default=500.0,
                   help="open loop: offered Poisson rate, req/s")
    p.add_argument("--seed", type=int, default=0,
                   help="weights (without --checkpoint), payload and "
                        "arrival-process seed")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the report/telemetry snapshot as JSON")
    _add_obs_flags(p)
    return p


def _refuse_later_serve_slices(args: argparse.Namespace) -> None:
    """JAX's on-disk executable cache raises a typed error naming ROADMAP
    A12b: the port compiles no per-bucket executable to keep on disk."""
    if args.aot_cache_dir is not None:
        raise NotPortedError(
            "--aot-cache-dir needs the persistent executable cache, which "
            "is not ported (ROADMAP A12b)")


def _serve_config_from_args(args: argparse.Namespace) -> ServeConfig:
    env = ServeConfig.from_env()
    return ServeConfig(
        model=args.model,
        checkpoint=args.checkpoint,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        n_replicas=args.replicas,
        deadline_ms=args.deadline_ms,
        conv_backend=args.conv_backend,
        precompile=not args.no_precompile,
        admission=args.admission or env.admission,
        slo_ms=args.slo_ms,
        autoscale=args.autoscale or env.autoscale,
        max_replicas=args.max_replicas,
        window_s=args.window_s,
    )


def _net_config_from_args(args: argparse.Namespace) -> NetConfig:
    """The flags over the NetConfig the parser read from the environment
    (its respawn_* fields have no flag)."""
    return dataclasses.replace(
        args.net_env,
        listen=args.listen,
        host=args.listen_host,
        port=args.listen_port,
        conn_deadline_ms=args.conn_deadline_ms,
        aot_cache_dir=args.aot_cache_dir,
        supervise=args.supervise,
    )


def _listen(args, ncfg: NetConfig, batcher, chaos, obs_bundle):
    """JAX's listen path (cli.py:917-963): the shared WireStats, the chaos
    split — a kill-endpoint monkey arms the SERVER's first incarnation
    only (a respawn must not replay the death), a slow-loris monkey arms
    the CLIENT side of the socket transport — and the supervised or bare
    endpoint. Returns (wire, supervisor or None, endpoint, client chaos)."""
    from parallel_cnn_tpu_torch.resilience.retry import RetryPolicy
    from parallel_cnn_tpu_torch.serve import Supervisor, WireStats, armed_factory

    wire = WireStats()
    if obs_bundle.enabled:
        wire.attach_registry(obs_bundle.registry)
    server_chaos = (
        chaos if chaos is not None and chaos.kill_endpoint_seq is not None
        else None
    )
    client_chaos = (
        chaos if chaos is not None and chaos.slow_loris is not None else None
    )
    factory = armed_factory(batcher, wire, server_chaos, host=ncfg.host,
                            conn_deadline_ms=ncfg.conn_deadline_ms, obs=obs_bundle)

    sup = None
    if ncfg.supervise:
        sup = Supervisor(
            factory,
            policy=RetryPolicy(
                attempts=ncfg.respawn_attempts,
                base_delay=ncfg.respawn_base_delay_s,
                max_delay=ncfg.respawn_max_delay_s,
                seed=args.seed,
            ),
            obs=obs_bundle, port=ncfg.port,
        ).start()
        endpoint = sup.server
    else:
        endpoint = factory(ncfg.port, 0)
    return wire, sup, endpoint, client_chaos


def _scenario_lines(cmd: str, report) -> int:
    """The scenario's verdict lines; returns the exit code (1 on a trip)."""
    gates = report.gates()
    p99 = report.p99_ms
    print(f"[{cmd}] scenario {report.name}: "
          f"{report.completed}/{report.requests} ok, "
          f"shed rate {report.shed_rate:.3f}, "
          f"p99 {p99:.1f} ms" if p99 is not None else
          f"[{cmd}] scenario {report.name}: no completions")
    print(f"[{cmd}] gates {'PASS' if report.passed else 'FAIL'}: "
          + ", ".join(f"{k}={'ok' if v else 'TRIPPED'}"
                      for k, v in gates.items()))
    return 0 if report.passed else 1


def _latency_line(cmd: str, report) -> None:
    lat = report.latency.summary(scale=1e3)
    if lat.get("count"):
        print(f"[{cmd}] latency p50 {lat['p50']:.2f} ms, "
              f"p90 {lat['p90']:.2f} ms, p99 {lat['p99']:.2f} ms")


def padded_bucket_parity(engine, in_shape, seed: int = 0) -> str:
    """Predict n = b−1 samples through the padded bucket b and compare
    with the raw forward on the same bucket: "bit-identical" or a
    MISMATCH line with the largest difference."""
    import numpy as np
    import torch

    from parallel_cnn_tpu_torch.serve import loadgen

    b = min(4, engine.max_batch)
    n = max(b - 1, 1)
    xs = loadgen.make_samples(n, in_shape, seed=seed)
    got = engine.predict(xs)
    full = np.concatenate([xs, np.zeros((b - n, *in_shape), np.float32)])
    ref = engine.forward(torch.from_numpy(full).to(engine.device))
    ref = ref.cpu().numpy()[:n]
    parity = "bit-identical" if np.array_equal(got, ref) else (
        f"MISMATCH (max |Δ| {float(np.max(np.abs(got - ref))):.2e})"
    )
    return f"padded-bucket parity (n={n}→b{b}): {parity}"


def _run_serve(cmd: str, argv: List[str]) -> int:
    """`serve` restores (or initialises) the model, warms the bucket
    ladder, proves the padding parity contract on one padded bucket,
    drives a short run of traffic — or a gated scenario — and prints the
    telemetry. `loadgen` is the same stack under a chosen arrival
    pattern. ``--admission``, ``--autoscale``, ``--chaos`` and the obs
    flags wire JAX's SLO layer in front of it (cli.py:815-1046); a
    scenario whose gate trips exits 1. ``--listen`` puts the network
    front door (serve/net.py) in front of the batcher and drives the same
    traffic through real sockets, optionally supervised (``--supervise``);
    a net-* scenario without ``--listen`` exits 2."""
    args = build_serve_parser(cmd).parse_args(argv)
    _refuse_later_serve_slices(args)
    cfg = _serve_config_from_args(args)
    ncfg = _net_config_from_args(args)
    if args.scenario in NET_SCENARIO_NAMES and not ncfg.listen:
        print(f"[{cmd}] scenario {args.scenario} needs --listen "
              f"(it judges the wire tier)")
        return 2

    from parallel_cnn_tpu_torch import obs as obs_lib
    from parallel_cnn_tpu_torch.ops import tap_conv
    from parallel_cnn_tpu_torch.serve import (
        AutoScaler,
        get,
        loadgen,
        scenarios,
        serve_stack,
    )

    handle = get(cfg.model, conv_backend=cfg.conv_backend)
    obs_bundle = obs_lib.from_config(_obs_config_from_args(args), run=cmd)
    chaos = None
    if args.chaos:
        from parallel_cnn_tpu_torch.resilience.chaos import ChaosMonkey

        chaos = ChaosMonkey.from_spec(args.chaos)
    t0 = time.perf_counter()
    pool, batcher = serve_stack(handle, cfg, device=args.device, seed=args.seed,
                                obs=obs_bundle, chaos=chaos)
    startup = time.perf_counter() - t0
    if obs_bundle.enabled:
        batcher.stats.attach_registry(obs_bundle.registry)
        if batcher.admission is not None:
            batcher.admission.attach_registry(obs_bundle.registry)
    src = cfg.checkpoint or "fresh init (no --checkpoint)"
    print(f"[serve] model={cfg.model} params from {src}")
    print(f"[serve] replicas={cfg.n_replicas} on "
          f"{[str(e.device) for e in pool.engines]}")
    if cfg.admission:
        print(f"[serve] admission control on (SLO {cfg.slo_ms:g} ms)")
    scaler = None
    if cfg.autoscale:
        scaler = AutoScaler(
            pool, batcher,
            min_replicas=1,
            max_replicas=cfg.effective_max_replicas,
            slo_ms=cfg.slo_ms,
            obs=obs_bundle,
        )
        if obs_bundle.enabled:
            scaler.attach_registry(obs_bundle.registry)
        scaler.start()
        print(f"[serve] autoscaler on "
              f"(1..{cfg.effective_max_replicas} replicas, "
              f"p99 target {cfg.slo_ms:g} ms)")
    if cfg.precompile:
        buckets = pool.engines[0].stats.warm_seconds
        table = ", ".join(f"b{b}: {s * 1e3:.0f} ms"
                          for b, s in sorted(buckets.items()))
        print(f"[serve] bucket ladder warmed in {startup:.2f}s ({table})")

    rc = 0
    with batcher:
        if cmd == "serve":
            line = padded_bucket_parity(pool.engines[0], handle.in_shape,
                                        seed=args.seed)
            print(f"[serve] {line}")
            if "MISMATCH" in line:
                rc = 1
        wire = sup = endpoint = client_chaos = None
        if ncfg.listen:
            wire, sup, endpoint, client_chaos = _listen(
                args, ncfg, batcher, chaos, obs_bundle)
            print(f"[{cmd}] listening on {endpoint.host}:{endpoint.port} "
                  f"(conn deadline {ncfg.conn_deadline_ms:g} ms"
                  + (", supervised" if sup is not None else "") + ")")
        if args.scenario in NET_SCENARIO_NAMES:
            swap_model = None
            if args.scenario == "net-hot-swap-diurnal":
                from parallel_cnn_tpu_torch.serve import load_or_init

                swap_model = load_or_init(handle, args.swap_checkpoint,
                                          seed=args.seed + 1)
            report = scenarios.run_net(
                args.scenario, batcher, wire=wire,
                supervisor=sup, server=endpoint, chaos=client_chaos,
                swap_model=swap_model, obs=obs_bundle, seed=args.seed,
            )
            rc = max(rc, _scenario_lines(cmd, report))
        elif args.scenario:
            report = scenarios.run(
                args.scenario, batcher,
                seed=args.seed,
                deadline_ms=args.deadline_ms or None,
            )
            rc = max(rc, _scenario_lines(cmd, report))
        elif ncfg.listen:
            report = loadgen.run_closed_loop_net(
                endpoint.address,
                loadgen.make_samples(
                    min(args.requests, 64), handle.in_shape, seed=args.seed,
                ),
                n_requests=args.requests,
                concurrency=args.concurrency,
                deadline_ms=args.deadline_ms or None,
                seed=args.seed,
                chaos=client_chaos,
            )
            print(f"[{cmd}] closed-net-loop: "
                  f"{report.completed}/{report.requests} ok, "
                  f"{report.throughput:.1f} req/s over the wire, "
                  f"shed rate {report.shed_rate:.3f}")
            _latency_line(cmd, report)
        else:
            report = loadgen.run(
                batcher,
                pattern=args.pattern,
                n_requests=args.requests,
                concurrency=args.concurrency,
                rate=args.rate,
                deadline_ms=args.deadline_ms or None,
                seed=args.seed,
            )
            print(f"[{cmd}] {args.pattern}-loop: "
                  f"{report.completed}/{report.requests} ok, "
                  f"{report.throughput:.1f} req/s, "
                  f"shed rate {report.shed_rate:.3f}")
            _latency_line(cmd, report)
        if ncfg.listen:
            (sup if sup is not None else endpoint).close()
            # A handler records its outcome a beat after its client read
            # the reply: read the counts once they balance (or time out).
            w, balanced = scenarios.settled_wire_delta(wire, {})
            print(f"[{cmd}] wire: {w['submitted']} submitted = "
                  f"{w['completed']} completed + {w['shed']} shed + "
                  f"{w['expired']} expired + {w['failed']} failed "
                  f"({'balanced' if balanced else 'IMBALANCED'}; "
                  f"{w['reaped']} reaped, "
                  f"{w['endpoint_deaths']} endpoint deaths"
                  + (f", {sup.respawns} respawns" if sup is not None
                     else "") + ")")
        if scaler is not None:
            scaler.close()
            snap = scaler.snapshot()
            print(f"[{cmd}] autoscaler: {snap['scale_ups']} up, "
                  f"{snap['scale_downs']} down, "
                  f"{snap['routable']} replicas routable")
        if pool.engines[0].device.type == "cuda":
            print(f"[{cmd}] tap_conv kernel launches: {tap_conv.launches.count}"
                  f" over {batcher.executed} executed batches, {pool.warmups}"
                  f" bucket warm-ups and {2 if cmd == 'serve' else 0} parity"
                  f" forwards")
        print(batcher.stats.render())
        if args.json:
            out = {"config": dataclasses.asdict(cfg),
                   "report": report.to_dict(),
                   "telemetry": batcher.stats.snapshot(),
                   "window": batcher.stats.window_snapshot()}
            if batcher.admission is not None:
                out["admission"] = batcher.admission.snapshot()
            if scaler is not None:
                out["autoscaler"] = scaler.snapshot()
            if wire is not None:
                out["wire"] = wire.snapshot()
            with open(args.json, "w") as f:
                json.dump(out, f, indent=2)
            print(f"[{cmd}] report written to {args.json}")
    for kind, path in obs_bundle.finish().items():
        print(f"[{cmd}] {kind} written to {path}")
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    raw = list(sys.argv[1:] if argv is None else argv)
    if raw and raw[0] in ("serve", "loadgen"):
        return _run_serve(raw[0], raw[1:])
    return _run_train(raw)
