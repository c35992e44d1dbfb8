"""Command line of the port (the counterpart of ``parallel_cnn_tpu/cli.py``).

    python -m parallel_cnn_tpu_torch [trainer flags]      # the LeNet-ref trainer
    python -m parallel_cnn_tpu_torch --model resnet18 --conv-backend cuda
    python -m parallel_cnn_tpu_torch plan show [trainer flags] [--save PATH]
    python -m parallel_cnn_tpu_torch plan diff PLAN_A PLAN_B
    python -m parallel_cnn_tpu_torch tune --model resnet18 --devices 4
    python -m parallel_cnn_tpu_torch serve --model resnet18
    python -m parallel_cnn_tpu_torch loadgen --requests 512 --pattern open

With no subcommand the CLI is the trainer, as in JAX: for ``lenet_ref``
load data → learn → test, printing the reference's lines; for a zoo model
(``cifar_cnn``, ``resnet18``, ``resnet34``, ``resnet50``, ``vgg16``) JAX's
zoo trainer: the synthetic CIFAR-shape sets, per-epoch ``epoch N: loss L,
acc A% (S s)`` lines, checkpoints of the full state and ``--resume``.

Every parallelism knob resolves through the ExecutionPlan (plan/), as in
JAX: ``config_from_args`` layers flag > env > plan file (``--plan PATH``
or ``PCNN_PLAN``) > default, ``plan.build_plan(cfg, args).validate()`` is
the one legality site (its ``PlanError`` texts are JAX's exit texts) and
the plan says how many ranks parallel/distributed.py starts (one process
a rank; NCCL, one card a rank, or gloo with ``--device cpu``) and which
mesh each makes: one device; JAX's GSPMD path over ``--mesh-data N
[--mesh-model M]`` (global BN statistics, each layer's filters split over
the model axis where they divide); ``--mesh-data N --comm-impl psum|ring``
over explicit collectives, with ``--fused-step`` and the ring as
update-on-arrival (ZeRO-2; ZeRO-3 with ``PCNN_FUSED_STEP=1
PCNN_ZERO_LEVEL=3``, as in JAX); ``--comm-impl
hierarchical [--comm-hosts H]`` over JAX's (host, data) mesh of every card
(H rows of cards/H; on the CPU H hosts of two gloo ranks), ZeRO-3 there
with ``PCNN_FUSED_STEP=1 PCNN_ZERO_LEVEL=3``; or ``--pipeline-stages
S`` JAX's 1F1B pipeline over a (stage, data) mesh of every card
(``--accum-steps`` microbatches a step, ``--pipeline-split``,
``--pipeline-wire-dtype``, ``--pipeline-act-dtype``; on the CPU S gloo
ranks). A zoo checkpoint is stamped with the plan's fingerprint, and
``--resume`` refuses a file stamped under another plan unless
``--replan``. ``plan show`` prints the resolved plan (``--save`` writes
it for ``--plan``) and ``plan diff`` compares two plan files; neither
needs a GPU. One departure from JAX: a zoo model's ZeRO-2 fused step with
no ring falls back to the fused tail before the plan is built (JAX's
zoo.train fallback; JAX's CLI refuses it). LeNet-ref takes ``--mesh-data
N [--mesh-model M] [--comm-impl psum|ring]``: minibatch SGD over an N × M
mesh of ranks, data-parallel, with the filters split over the model axis
when M > 1 (rank 0 prints, records and checkpoints). Everything runs on
the GPU unless ``--device cpu`` is given.

``--elastic`` [``--elastic-schedule``, ``--elastic-scaling``,
``--elastic-min-world``] with the ZeRO-3 step resizes the ZeRO-3
world in flight (resilience/elastic.py): one rank for every visible card
is spawned, ``--mesh-data N`` of them train at the start (on the CPU
``--mesh-data`` gloo ranks, all of them). ``--async-mode stale|easgd``
[``--staleness-bound``, ``--easgd-period``, ``--easgd-rho``] runs LeNet-ref
through JAX's virtual-clock async harness (train/async_dp.py; ``--ops
cuda`` takes its gradients from B1). ``--chaos SPEC``,
``--sentinel-every N`` and the obs flags ``--trace``, ``--trace-dir``,
``--metrics-json`` are the trainer's too; JAX's fences refuse
``--async-mode`` on a zoo model and ``--elastic`` on lenet_ref with JAX's
texts. ``--profile`` prints LeNet-ref's per-phase table after training,
and for a zoo model writes a torch.profiler Chrome trace of three steps
(``zoo_xla_trace/trace.json`` under ``--checkpoint-dir``). ``tune`` ranks
the parallelism-plan space against a hardware profile
(analysis/autotune.py) and writes the chosen plan into a cost report;
``--autotune [--autotune-report PATH]`` trains on it, its plan the lowest
layer under env and flags. ``serve`` and ``loadgen``
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
from typing import List, Optional, Tuple

from parallel_cnn_tpu_torch import plan as plan_lib
from parallel_cnn_tpu_torch.config import (
    CONV_BACKENDS,
    AsyncConfig,
    AutotuneConfig,
    ElasticConfig,
    SERVE_MODELS,
    ZOO_MODELS,
    CommConfig,
    Config,
    DataConfig,
    FusedStepConfig,
    MeshConfig,
    MeshLayoutError,
    PipelineConfig,
    SERVE_CONV_BACKENDS,
    NetConfig,
    NotPortedError,
    ObsConfig,
    ResilienceConfig,
    ServeConfig,
    TrainConfig,
    plan_path_from_env,
)


def build_parser() -> argparse.ArgumentParser:
    """The trainer's flags: the JAX CLI's lenet_ref and single-device zoo
    flags, with ``--ops cuda`` for JAX's ``--ops pallas`` and
    ``--conv-backend cuda``/``torch`` for its ``pallas``/``xla``, plus
    ``--device``."""
    p = argparse.ArgumentParser(
        prog="parallel_cnn_tpu_torch",
        description="the LeNet-ref and zoo trainers on the GPU (PyTorch + "
                    "hand-written CUDA kernels); subcommands: plan, tune, "
                    "serve, loadgen",
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
                        "(parallel/collectives.py) — one all-reduce, "
                        "bucketed ring reduce-scatter/all-gather over the "
                        "data axis, or the two-level hierarchical ring over "
                        "a (host, data) mesh of every card, which it builds "
                        "(drop --mesh-data). Default: PCNN_COMM_IMPL")
    p.add_argument("--comm-bucket-mb", type=float, default=None, metavar="MB",
                   help="ring collective bucket size in MiB "
                        "(PCNN_COMM_BUCKET_BYTES; default 4)")
    p.add_argument("--comm-wire-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="collective payload dtype on the wire; bfloat16 "
                        "halves the bytes, accumulation stays f32 "
                        "(PCNN_COMM_WIRE_DTYPE)")
    p.add_argument("--comm-hosts", type=int, default=None, metavar="N",
                   help="--comm-impl hierarchical: host-axis size H of "
                        "the (host, data) mesh (>= 2; the cards split into "
                        "H rows; with --device cpu, H hosts of two gloo "
                        "ranks) [PCNN_COMM_HOSTS]")
    p.add_argument("--autotune", action="store_true",
                   help="zoo mesh runs: apply the cost report's chosen "
                        "parallelism plan (analysis/autotune.py; run "
                        "`python -m parallel_cnn_tpu_torch tune` first) as "
                        "the base layer — explicit --comm-*/--fused-step/"
                        "--pipeline-*/--accum-steps knobs still win "
                        "[PCNN_AUTOTUNE]")
    p.add_argument("--autotune-report", default=None, metavar="PATH",
                   help="cost report the chosen plan is read from "
                        "(default analysis/cost_report.json) "
                        "[PCNN_AUTOTUNE_REPORT]")
    p.add_argument("--pipeline-stages", type=int, default=None, metavar="S",
                   help="zoo models: pipeline parallelism — partition the "
                        "model's layers over S stages of a (stage, data) "
                        "mesh and run the 1F1B microbatch schedule "
                        "(train/pipeline_schedule.py; --accum-steps is the "
                        "microbatch count M). Builds its own mesh over every "
                        "card (S gloo ranks with --device cpu); drop "
                        "--mesh-data/--mesh-model. S=1 is the flat ring step "
                        "[PCNN_PIPELINE_STAGES]")
    p.add_argument("--pipeline-split", default=None, metavar="B1,B2,..",
                   help="manual stage boundaries (layer indices, stages-1 of "
                        "them); default: the flops-balanced split "
                        "[PCNN_PIPELINE_SPLIT]")
    p.add_argument("--pipeline-wire-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="dtype of the activations and cotangents sent between "
                        "stages; accumulation stays f32 "
                        "[PCNN_PIPELINE_WIRE_DTYPE]")
    p.add_argument("--pipeline-act-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="stage-compute activation dtype (params cast per "
                        "stage, grads and loss stay f32) "
                        "[PCNN_PIPELINE_ACT_DTYPE]")
    p.add_argument("--elastic", action="store_true",
                   help="elastic training (PCNN_ELASTIC): on a preemption "
                        "resize request, a chaos resize@ or a schedule entry, "
                        "quiesce at the step boundary, snapshot the ZeRO-3 "
                        "state to its world-size-independent view, re-mesh "
                        "over the surviving ranks, reshard and continue "
                        "(resilience/elastic.py). Needs the ZeRO-3 step "
                        "(PCNN_FUSED_STEP=1 PCNN_ZERO_LEVEL=3 and --comm-impl "
                        "ring/hierarchical); one rank a visible card, "
                        "--mesh-data of them active at the start")
    p.add_argument("--elastic-schedule", default=None, metavar="SPEC",
                   help="planned resizes 'STEP:WORLD[,STEP:WORLD…]' — before "
                        "optimizer step STEP resize the data world to WORLD "
                        "(implies --elastic) [PCNN_ELASTIC_SCHEDULE]")
    p.add_argument("--elastic-scaling", default=None,
                   choices=["global", "per-device"],
                   help="batch/LR response to a resize: global keeps the "
                        "global batch + LR fixed (parity mode), per-device "
                        "keeps the per-rank batch and scales global batch + "
                        "LR with the world [PCNN_ELASTIC_SCALING]")
    p.add_argument("--elastic-min-world", type=int, default=None, metavar="N",
                   help="never shrink the data world below N ranks; deeper "
                        "losses are clamped and logged "
                        "[PCNN_ELASTIC_MIN_WORLD]")
    p.add_argument("--async-mode", default=None,
                   choices=["off", "stale", "easgd"],
                   help="lenet_ref: straggler-tolerant async data parallelism "
                        "on the virtual-clock harness (train/async_dp.py): "
                        "stale = bounded-staleness gradients with a hard "
                        "barrier only at the bound, easgd = local SGD with a "
                        "periodic pull toward a bucketed center; off / unset "
                        "= the bulk-synchronous trainer [PCNN_ASYNC_MODE]")
    p.add_argument("--staleness-bound", type=int, default=None, metavar="S",
                   help="max optimizer-step age of the params a gradient may "
                        "be computed against (--async-mode stale; 0 = the "
                        "synchronous schedule) [PCNN_ASYNC_STALENESS]")
    p.add_argument("--easgd-period", type=int, default=None, metavar="N",
                   help="local SGD steps between elastic-averaging rounds "
                        "(--async-mode easgd) [PCNN_ASYNC_EASGD_PERIOD]")
    p.add_argument("--easgd-rho", type=float, default=None, metavar="RHO",
                   help="elastic-averaging pull strength in (0, 1] "
                        "(--async-mode easgd) [PCNN_ASYNC_EASGD_RHO]")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="fault injection: nan@STEP poisons the update at "
                        "optimizer step STEP; kill@EPOCH / kill9@EPOCH "
                        "delivers SIGTERM / SIGKILL after epoch EPOCH's "
                        "checkpoint; resize@STEP:±K loses/adds K ranks at "
                        "step STEP (needs --elastic); slow-worker@STEP:MS "
                        "stalls the async worker dispatching gradient STEP; "
                        "slow-stage@STEP:MS stalls the pipeline trainer at "
                        "step STEP (resilience/chaos.py has the grammar)")
    p.add_argument("--fused-step", action="store_true",
                   help="lenet_ref: update through the fused bucketed SGD "
                        "kernel (csrc/sgd_update.cu); zoo: the fused loss "
                        "tail (csrc/tail_ce.cu) and, with --mesh-data and "
                        "--comm-impl ring, update-on-arrival through the "
                        "fused SGD-momentum kernel (ZeRO-2; ZeRO-3 with "
                        "PCNN_FUSED_STEP=1 PCNN_ZERO_LEVEL=3, also over "
                        "--comm-impl hierarchical)")
    p.add_argument("--plan", default=None, metavar="PATH",
                   help="execution-plan file (written by `plan show --save`, "
                        "or JAX's): fills every parallelism knob the env and "
                        "explicit flags left unset — flag beats env beats "
                        "plan [PCNN_PLAN]")
    p.add_argument("--replan", action="store_true",
                   help="allow resuming from a checkpoint whose recorded "
                        "plan fingerprint mismatches the live plan "
                        "(re-shard under the live plan instead of refusing "
                        "with PlanMismatchError)")
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
    p.add_argument("--sentinel-every", type=int, default=r.check_every_steps,
                   metavar="N",
                   help="zoo models: also run the sentinel every N optimizer "
                        "steps (0 = epoch boundaries only; each check is a "
                        "host sync)")
    p.add_argument("--keep-checkpoints", type=int, default=r.ring_size,
                   metavar="N",
                   help="prune --checkpoint-dir to the newest N "
                        "checkpoints (0 = keep all)")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append JSONL metrics records to PATH")
    _add_obs_flags(p)
    p.add_argument("--profile", action="store_true",
                   help="lenet_ref: print the per-phase table (paper "
                        "Tables 4-8 shape); zoo models: write a "
                        "torch.profiler Chrome trace of 3 steady-state "
                        "train steps to zoo_xla_trace/trace.json under "
                        "--checkpoint-dir (or cwd)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    """The trainer's Config for every model, layered as JAX's
    (cli.py:380-514): each section env first, then its flags field by
    field; then ``--plan``/``PCNN_PLAN`` fills every parallelism knob the
    env and flags left unset (flag > env > plan > default), and then
    ``--autotune``'s chosen plan fills what is still unset, each recording
    the knobs it filled in ``args._autotune_filled`` so
    ``plan.build_plan`` labels them "autotune", as JAX does."""
    paths = {}
    if args.data_dir:
        paths = dict(
            train_images=os.path.join(args.data_dir, "train-images.idx3-ubyte"),
            train_labels=os.path.join(args.data_dir, "train-labels.idx1-ubyte"),
            test_images=os.path.join(args.data_dir, "t10k-images.idx3-ubyte"),
            test_labels=os.path.join(args.data_dir, "t10k-labels.idx1-ubyte"),
        )
    mesh = MeshConfig(data=args.mesh_data, model=args.mesh_model or 1)
    comm = _comm_from_args(args)
    fused = _fused_from_args(args)
    pipeline = _pipeline_from_args(args)
    args._autotune_filled = set()
    plan_path = getattr(args, "plan", None) or plan_path_from_env()
    if plan_path:
        try:
            eplan = plan_lib.load_plan(plan_path)
        except plan_lib.PlanError as exc:
            raise SystemExit(f"--plan: {exc}")
        if comm is None and eplan.comm_impl is not None:
            comm = eplan.comm_config()
            args._autotune_filled |= {
                "comm_impl", "bucket_bytes", "wire_dtype", "overlap", "hosts"}
        if fused is None and eplan.fused:
            fused = eplan.fused_config()
            args._autotune_filled |= {
                "fused", "fused_update", "fused_tail", "act_dtype", "zero"}
        if pipeline is None and (ppc := eplan.pipeline_config()) is not None:
            pipeline = ppc
            args._autotune_filled |= {
                "pipelined", "stages", "split", "pipe_wire_dtype",
                "pipe_act_dtype"}
        if args.accum_steps is None and eplan.accum > 1:
            args.accum_steps = eplan.accum
            args._autotune_filled.add("accum")
        if args.mesh_data is None and eplan.data is not None \
                and not (eplan.pipelined or eplan.stages > 1
                         or eplan.comm_impl == "hierarchical"):
            args.mesh_data = eplan.data
            mesh = dataclasses.replace(mesh, data=eplan.data)
            args._autotune_filled.add("data")
        if (args.mesh_model or 1) == 1 and eplan.model > 1:
            args.mesh_model = eplan.model
            mesh = dataclasses.replace(mesh, model=eplan.model)
            args._autotune_filled.add("model")
    # --autotune / PCNN_AUTOTUNE*: env sets the base, flags override; the
    # report's chosen plan is the LOWEST layer: it fills every parallelism
    # section the env, the flags and a plan file left untouched (JAX's
    # cli.py:516-581).
    autotune = AutotuneConfig.from_env()
    if args.autotune or args.autotune_report is not None:
        base = autotune or AutotuneConfig()
        autotune = dataclasses.replace(
            base, enabled=True, report=args.autotune_report or base.report)
    if autotune is not None and autotune.enabled:
        from parallel_cnn_tpu_torch.analysis import autotune as autotune_lib

        try:
            chosen, section = autotune_lib.load_chosen_plan(autotune.report)
        except ValueError as exc:  # NoFeasiblePlan / CostSchemaError
            raise SystemExit(f"--autotune: {exc}")
        n_host = int(section.get("n_host", 1) or 1)
        plan_comm, plan_fused, plan_pipe, plan_accum = \
            autotune_lib.plan_to_configs(chosen, n_host=n_host)
        if comm is None and plan_comm is not None:
            comm = plan_comm
            args._autotune_filled |= {
                "comm_impl", "bucket_bytes", "wire_dtype", "overlap", "hosts"}
        if fused is None and plan_fused is not None:
            fused = plan_fused
            args._autotune_filled |= {
                "fused", "fused_update", "fused_tail", "act_dtype", "zero"}
        if pipeline is None and plan_pipe is not None:
            pipeline = plan_pipe
            args._autotune_filled |= {
                "pipelined", "stages", "split", "pipe_wire_dtype",
                "pipe_act_dtype"}
        if args.accum_steps is None:
            args.accum_steps = plan_accum
            if plan_accum and plan_accum > 1:
                args._autotune_filled.add("accum")
        # The scored device count is part of the plan: a flat single-stage
        # plan over more than one device activates pure data parallelism.
        # Pipeline and hierarchical plans build their own meshes, and
        # lenet_ref has no mesh to activate.
        if (args.mesh_data is None and (args.mesh_model or 1) == 1
                and args.model != "lenet_ref"
                and (pipeline is None or pipeline.stages == 1)
                and (comm is None or comm.impl != "hierarchical")):
            plan_dev = int(section.get("n_dev", 0) or 0)
            if plan_dev > 1:
                args.mesh_data = plan_dev
                mesh = dataclasses.replace(mesh, data=plan_dev)
                args._autotune_filled.add("data")
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
        mesh=mesh,
        resilience=_resilience_from_args(args),
        comm=comm,
        fused=fused,
        obs=_obs_config_from_args(args),
        elastic=_elastic_from_args(args),
        async_dp=_async_from_args(args),
        pipeline=pipeline,
        autotune=autotune,
        model=args.model,
    )


def _resilience_from_args(args: argparse.Namespace) -> ResilienceConfig:
    return ResilienceConfig(
        policy=args.sentinel,
        max_rollbacks=args.max_rollbacks,
        lr_backoff=args.lr_backoff,
        ring_size=args.keep_checkpoints,
        check_every_steps=args.sentinel_every,
    )


def _elastic_from_args(args: argparse.Namespace) -> Optional[ElasticConfig]:
    """PCNN_ELASTIC* first, then any --elastic* flag field by field (and
    opting in), as JAX layers them (cli.py:431-448)."""
    elastic = ElasticConfig.from_env()
    if (args.elastic or args.elastic_schedule is not None
            or args.elastic_scaling is not None
            or args.elastic_min_world is not None):
        base = elastic or ElasticConfig()
        elastic = dataclasses.replace(
            base,
            enabled=True,
            schedule=(args.elastic_schedule
                      if args.elastic_schedule is not None else base.schedule),
            scaling=args.elastic_scaling or base.scaling,
            min_world=(args.elastic_min_world
                       if args.elastic_min_world is not None else base.min_world),
        )
    return elastic


def _async_from_args(args: argparse.Namespace) -> Optional[AsyncConfig]:
    """PCNN_ASYNC_* first, then --async-mode/--staleness-bound/--easgd-*
    field by field (and opting in), as JAX layers them (cli.py:449-471);
    ``--async-mode off`` pins the synchronous trainer."""
    async_dp = AsyncConfig.from_env()
    if (args.async_mode is not None or args.staleness_bound is not None
            or args.easgd_period is not None or args.easgd_rho is not None):
        base = async_dp or AsyncConfig()
        async_dp = dataclasses.replace(
            base,
            mode=args.async_mode or base.mode,
            staleness_bound=(args.staleness_bound
                             if args.staleness_bound is not None
                             else base.staleness_bound),
            easgd_period=(args.easgd_period
                          if args.easgd_period is not None else base.easgd_period),
            easgd_rho=(args.easgd_rho
                       if args.easgd_rho is not None else base.easgd_rho),
        )
    return async_dp


#: JAX's fences (cli.py:1301-1316), text for text.
ASYNC_ZOO_ERROR = (
    "--async-mode drives the lenet_ref virtual-clock harness "
    "(train/async_dp.py); zoo models stay bulk-synchronous — "
    "drop --async-mode or use --model lenet_ref")
ELASTIC_LENET_ERROR = (
    "--elastic needs the zoo ZeRO-3 trainer: pick a zoo --model "
    "(e.g. cifar_cnn) with --mesh-data, --comm-impl ring and "
    "--fused-step")
#: JAX's zoo.train fence (zoo.py:1428-1434).
ELASTIC_ZERO3_ERROR = (
    "elastic training requires the ZeRO-3 step (fused.zero=3 "
    "with mesh + ring/hierarchical comm) — its world-size-"
    "independent full view is what makes in-flight resharding "
    "possible; enable it or drop --elastic")


def _print_obs(obs_bundle) -> None:
    """JAX's ``[obs] <kind> written to <path>`` lines."""
    for kind, path in obs_bundle.finish().items():
        print(f"[obs] {kind} written to {path}", flush=True)


def _comm_from_args(args: argparse.Namespace) -> Optional[CommConfig]:
    """PCNN_COMM_* first, then the --comm-* flags field by field, as JAX
    layers them (cli.py:385-400); None when neither sets anything."""
    comm = CommConfig.from_env()
    if (args.comm_impl is not None or args.comm_bucket_mb is not None
            or args.comm_wire_dtype is not None or args.comm_hosts is not None):
        base = comm or CommConfig()
        comm = dataclasses.replace(
            base,
            impl=args.comm_impl or base.impl,
            bucket_bytes=(int(args.comm_bucket_mb * 1024 * 1024)
                          if args.comm_bucket_mb is not None
                          else base.bucket_bytes),
            wire_dtype=args.comm_wire_dtype or base.wire_dtype,
            hosts=args.comm_hosts if args.comm_hosts is not None else base.hosts,
        )
    return comm


def _pipeline_from_args(args: argparse.Namespace) -> Optional[PipelineConfig]:
    """PCNN_PIPELINE_* first, then the --pipeline-* flags field by field
    (and opting in), as JAX layers them (cli.py:414-430); None when
    neither sets anything."""
    pipeline = PipelineConfig.from_env()
    if (args.pipeline_stages is not None
            or args.pipeline_split is not None
            or args.pipeline_wire_dtype is not None
            or args.pipeline_act_dtype is not None):
        base = pipeline or PipelineConfig()
        pipeline = dataclasses.replace(
            base,
            stages=(args.pipeline_stages
                    if args.pipeline_stages is not None else base.stages),
            split=(args.pipeline_split
                   if args.pipeline_split is not None else base.split),
            wire_dtype=args.pipeline_wire_dtype or base.wire_dtype,
            act_dtype=args.pipeline_act_dtype or base.act_dtype,
        )
    return pipeline


def _fused_from_args(args: argparse.Namespace) -> Optional[FusedStepConfig]:
    """PCNN_FUSED_STEP first (refined by PCNN_ACT_DTYPE and
    PCNN_ZERO_LEVEL), then --fused-step, which alone is JAX's
    ``FusedStepConfig()`` (ZeRO-2): as in JAX, PCNN_ZERO_LEVEL counts only
    beside PCNN_FUSED_STEP=1. --act-dtype only refines an enabled fused
    step."""
    fused = FusedStepConfig.from_env()
    if args.fused_step:
        fused = fused or FusedStepConfig()
    if args.act_dtype is not None:
        if fused is None:
            raise SystemExit("--act-dtype refines the fused step; enable it "
                             "with --fused-step first")
        fused = dataclasses.replace(fused, act_dtype=args.act_dtype)
    return fused


#: JAX's zoo.train line when update-on-arrival has no ring (zoo.py:1369).
FUSED_FALLBACK_LINE = ("fused-step: update-on-arrival needs mesh + "
                       "comm.impl='ring'/'hierarchical'; falling back to "
                       "fused tail only")


def _zoo_fallback(cfg: Config) -> Tuple[Config, bool]:
    """(cfg, whether it fell back): a zoo model's ZeRO-2 fused step with no
    ring or hierarchical collective drops update-on-arrival, as JAX's
    zoo.train does (zoo.py:1369-1380), before the plan is built. JAX's CLI
    refuses this plan instead (ZeRO-2 rides the flat ring); the port keeps
    zoo.train's fallback as a recorded departure (ROADMAP Queue C), so the
    plan that is validated, stamped and shown is the plan that runs.
    ZeRO-3 without a ring is left for the plan to refuse."""
    fused, comm = cfg.fused, cfg.comm
    if (cfg.model == "lenet_ref" or fused is None or not fused.update
            or fused.zero != 2
            or (comm is not None and comm.impl in ("ring", "hierarchical"))):
        return cfg, False
    return cfg.replace(fused=dataclasses.replace(fused, update=False)), True


def _validated(eplan: "plan_lib.ExecutionPlan") -> "plan_lib.ExecutionPlan":
    """``eplan.validate()`` with JAX's CLI exits: a PlanError becomes
    ``SystemExit`` of its text. The one exception keeps the port's type:
    the explicit collectives beside a model axis raise MeshLayoutError (a
    ValueError) with JAX's data-only text."""
    try:
        return eplan.validate()
    except plan_lib.PlanError as exc:
        if str(exc) == plan_lib.COMM_DATA_ONLY_ERROR:
            raise MeshLayoutError(str(exc)) from exc
        raise SystemExit(str(exc)) from exc


def _mesh_line(eplan: "plan_lib.ExecutionPlan", shape) -> str:
    """JAX's ``mesh: {dict(mesh.shape)}`` line, with its mode."""
    kind = ("pipeline" if eplan.pipelined or eplan.stages > 1
            else "hierarchical" if eplan.comm_impl == "hierarchical" else None)
    return f"mesh: {shape}" + (f" ({kind})" if kind else "")


def _zoo_job(mesh, args: argparse.Namespace, cfg: Config,
             eplan: "plan_lib.ExecutionPlan",
             elastic_world: Optional[int] = None) -> None:
    """One rank's zoo run (``mesh`` None: the single-device run): the
    model from the seed (the same weights on every rank), the synthetic
    train and eval sets, zoo.train under ``cfg`` and ``eplan`` (what the
    launcher resolved and validated; a rank resolves no flags or
    environment itself). Rank 0 alone traces and journals (``[obs]
    ... written to`` after the run)."""
    import torch

    from parallel_cnn_tpu_torch import obs as obs_lib
    from parallel_cnn_tpu_torch.data import synthetic
    from parallel_cnn_tpu_torch.resilience.chaos import ChaosMonkey
    from parallel_cnn_tpu_torch.nn import cifar, resnet, vgg
    from parallel_cnn_tpu_torch.resilience import preempt
    from parallel_cnn_tpu_torch.train import zoo
    from parallel_cnn_tpu_torch.utils.backend import resolve_device
    from parallel_cnn_tpu_torch.utils.metrics import MetricsLogger

    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else resolve_device(args.device)
    _log_for(lead)
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
    chaos = ChaosMonkey.from_spec(args.chaos) if args.chaos else None
    obs_bundle = (obs_lib.from_config(cfg.obs, run="zoo")
                  if lead else obs_lib.NOOP)
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
            model_axis=mesh is not None and eplan.model > 1,
            comm=cfg.comm,
            fused=cfg.fused,
            pipeline=cfg.pipeline,
            plan=eplan,
            replan=args.replan,
            seed=args.seed,
            eval_data=ev,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
            metrics=metrics,
            loader=args.zoo_loader,
            resilience=cfg.resilience,
            chaos=chaos,
            obs=obs_bundle,
            elastic=cfg.elastic,
            elastic_world=elastic_world,
            # --profile: a torch.profiler trace of 3 steady-state steps of
            # the run's own step (JAX's jax.profiler trace, cli.py:1560).
            profile_trace_dir=(
                os.path.abspath(
                    os.path.join(args.checkpoint_dir or ".", "zoo_xla_trace"))
                if args.profile else None),
            device=device,
        )
    _print_obs(obs_bundle)
    if guard.preempted and lead:
        print("preempted: checkpoint flushed; continue with --resume")
    if metrics:
        metrics.close()


def _run_zoo(args: argparse.Namespace, cfg: Config) -> int:
    """≙ the JAX CLI's ``_run_zoo``: the synthetic CIFAR-shape train/eval
    sets, zoo.train with per-epoch eval, checkpoints, resume, sentinel and
    preemption. ONE resolution, legality and launch site: the plan
    (``build_plan(cfg, args).validate()``) says how many ranks
    parallel/distributed.py starts and which mesh each makes — one
    device, JAX's GSPMD path over ``--mesh-data N [--mesh-model M]``,
    the explicit collectives over ``--mesh-data N --comm-impl``, the
    (host, data) hierarchical mesh, or the (stage, data) pipeline mesh.
    An elastic run spawns one rank a visible card (on the CPU the
    plan's world), the plan's world of them training at the start."""
    if args.model == "cifar_cnn" and args.conv_backend != "torch":
        raise SystemExit("--conv-backend cuda applies to the resnet/vgg models")
    if args.batch_size == 1:
        raise SystemExit("zoo models train minibatch; use --batch-size > 1")
    cfg, fell_back = _zoo_fallback(cfg)
    eplan = _validated(plan_lib.build_plan(cfg, args))
    elastic = cfg.elastic is not None and cfg.elastic.enabled
    if elastic and (eplan.zero != 3 or cfg.comm is None or cfg.pipeline is not None):
        raise ValueError(ELASTIC_ZERO3_ERROR)
    if fell_back:
        print(FUSED_FALLBACK_LINE, flush=True)
    world, shape = eplan.launch(args.device)
    if not shape:
        _zoo_job(None, args, cfg, eplan)
        return 0

    from parallel_cnn_tpu_torch.parallel import distributed
    from parallel_cnn_tpu_torch.utils.backend import resolve_device

    start = None
    if elastic and eplan.comm_impl != "hierarchical":
        # One rank a visible card (the reachable world), the plan's
        # world of them active at the start.
        start = world
        if resolve_device(args.device).type == "cuda":
            import torch

            world = torch.cuda.device_count()
    print(_mesh_line(eplan, shape), flush=True)
    distributed.run(_zoo_job, world, device=args.device,
                    args=(args, cfg, eplan, start), plan=eplan)
    return 0


def _lenet_job(mesh, args: argparse.Namespace, cfg: Config) -> int:
    """One rank's LeNet-ref run (``mesh`` None: the single-device run):
    load → learn with a checkpoint per epoch, resume, preemption → test.
    On a mesh every rank trains; rank 0 alone prints the reference's
    lines, records metrics and saves checkpoints (whole params), and every
    rank resumes from the same file. ``mesh`` may be a ``DataMesh`` (the
    plan's mesh for the explicit collectives): it trains as the world × 1
    mesh."""
    from parallel_cnn_tpu_torch import obs as obs_lib
    from parallel_cnn_tpu_torch.data import pipeline
    from parallel_cnn_tpu_torch.parallel.mesh import as_mesh_2d
    from parallel_cnn_tpu_torch.resilience import preempt
    from parallel_cnn_tpu_torch.resilience.chaos import ChaosMonkey
    from parallel_cnn_tpu_torch.resilience.rollback import CheckpointRing
    from parallel_cnn_tpu_torch.train import checkpoint, trainer
    from parallel_cnn_tpu_torch.utils.backend import resolve_device
    from parallel_cnn_tpu_torch.utils.metrics import MetricsLogger, throughput

    if mesh is not None:
        mesh = as_mesh_2d(mesh)  # the reference trainer's (data, model) view
    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else resolve_device(args.device)
    _log_for(lead)

    train_ds, test_ds = pipeline.load_train_test(cfg.data)
    chaos = ChaosMonkey.from_spec(args.chaos) if args.chaos else None
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
    obs_bundle = obs_lib.from_config(cfg.obs, run="train") if lead else obs_lib.NOOP
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
            epoch_offset=start_epoch, epoch_callback=on_epoch, chaos=chaos,
            ring=ring, obs=obs_bundle, device=device, mesh=mesh,
        )
    _print_obs(obs_bundle)

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
    if args.profile:
        # JAX's per-phase table (cli.py:1400-1405) over the reference ops,
        # on the trained params and max(batch, 256) training images.
        import torch

        from parallel_cnn_tpu_torch.utils import profiling

        bsz = max(cfg.train.batch_size, 256)
        xs = torch.from_numpy(train_ds.images[:bsz]).to(device)
        ys = torch.from_numpy(train_ds.labels[:bsz]).to(device)
        phases = profiling.profile_phases(result.params, xs, ys)
        print(profiling.report(phases, n_images=xs.shape[0]))
    return 0


def _run_train(argv: List[str]) -> int:
    """≙ the JAX CLI's trainer: the lenet_ref branch (load → learn with a
    checkpoint per epoch, resume, preemption → test), on one device or
    over the (data, model) mesh of ranks the validated plan launches
    (parallel/distributed.py starts them), or the zoo branch."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    async_on = cfg.async_dp is not None and cfg.async_dp.enabled
    if args.model != "lenet_ref":
        if async_on:
            raise SystemExit(ASYNC_ZOO_ERROR)
        return _run_zoo(args, cfg)
    if cfg.elastic is not None and cfg.elastic.enabled:
        # The flat LeNet trainer has no sharded optimizer state to re-lay
        # out; only the zoo ZeRO-3 step resizes in flight.
        raise SystemExit(ELASTIC_LENET_ERROR)
    if async_on:
        return _run_async_lenet(args, cfg)
    eplan = plan_lib.build_plan(cfg, args)
    if not (eplan.data is not None or eplan.model > 1 or eplan.pipelined
            or eplan.stages > 1 or eplan.comm_impl is not None):
        # One device: no mesh, and no plan to validate (JAX's trainer
        # validates only a mesh run; a lone --fused-step is the bucketed
        # update on the reference grads).
        return _lenet_job(None, args, cfg)
    eplan = _validated(eplan)
    if eplan.pipelined or eplan.stages > 1 or eplan.comm_impl == "hierarchical":
        axes = "('stage', 'data')" if eplan.comm_impl != "hierarchical" \
            else "('host', 'data')"
        raise ValueError(
            "the reference trainer drives a flat (data, model) mesh only; "
            f"the resolved plan built axes {axes} — drop the "
            "pipeline/hierarchical knobs for this model")

    from parallel_cnn_tpu_torch.parallel import distributed
    from parallel_cnn_tpu_torch.train import trainer

    world, shape = eplan.launch(args.device)
    trainer.check_mesh(cfg.train, shape["data"], shape["model"])
    print(_mesh_line(eplan, shape), flush=True)
    distributed.run(_lenet_job, world, device=args.device, args=(args, cfg),
                    plan=eplan)
    return 0


def _log_for(lead: bool) -> None:
    """Surface the package's INFO lines (the real-MNIST integrity report,
    the elastic resizes) on rank 0, errors only elsewhere."""
    logging.getLogger("parallel_cnn_tpu_torch").setLevel(
        logging.INFO if lead else logging.ERROR)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(levelname)s %(name)s: %(message)s")


def _run_async_lenet(args: argparse.Namespace, cfg: Config) -> int:
    """JAX's async CLI branch (cli.py:1410-1456): the virtual-clock
    harness (train/async_dp.py) over ``AsyncConfig.workers`` logical
    workers, each resident on its own shard of the training set (the
    first workers × batch images), real gradients (``--ops cuda``: B1),
    virtual durations. ``--epochs`` counts server steps (stale) or local
    steps a worker (easgd). Prints JAX's summary line and the test error
    of the result."""
    import torch

    from parallel_cnn_tpu_torch import obs as obs_lib
    from parallel_cnn_tpu_torch.data import pipeline
    from parallel_cnn_tpu_torch.resilience.chaos import ChaosMonkey
    from parallel_cnn_tpu_torch.resilience.sentinel import Sentinel
    from parallel_cnn_tpu_torch.train import async_dp, trainer
    from parallel_cnn_tpu_torch.utils.backend import resolve_device

    _log_for(True)
    device = resolve_device(args.device)
    train_ds, test_ds = pipeline.load_train_test(cfg.data)
    chaos = ChaosMonkey.from_spec(args.chaos) if args.chaos else None
    acfg = cfg.async_dp
    w, b = acfg.workers, cfg.train.batch_size
    if len(train_ds) < w * b:
        raise SystemExit(
            f"async harness wants {w} workers x {b} images, dataset has "
            f"{len(train_ds)}")
    xs = torch.from_numpy(train_ds.images[: w * b]).to(device).reshape(w, b, 28, 28)
    ys = torch.from_numpy(train_ds.labels[: w * b]).to(device).reshape(w, b)
    params = trainer.init_params(cfg.train.seed, device)
    obs_bundle = obs_lib.from_config(cfg.obs, run="train_async")
    result = async_dp.run_async(
        params, xs, ys, cfg=acfg, dt=cfg.train.dt,
        max_server_steps=cfg.train.epochs, chaos=chaos,
        sentinel=Sentinel(), obs=obs_bundle, ops_path=cfg.train.ops,
    )
    _print_obs(obs_bundle)
    print(
        f"async mode={acfg.mode} steps={result.server_steps} "
        f"microbatches={result.microbatches} "
        f"virtual_ms={result.virtual_ms:.0f} "
        f"max_staleness={result.ledger.max_staleness()} "
        f"stragglers={result.stragglers} dropped={result.dropped} "
        f"easgd_rounds={result.easgd_rounds}"
    )
    rate = trainer.test(result.params, test_ds)
    print(f"async test error rate: {rate:.4f}")
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


def _run_tune(argv: List[str]) -> int:
    """``python -m parallel_cnn_tpu_torch tune`` (JAX's ``_run_tune``,
    cli.py:1084-1195): rank the parallelism-plan space against the
    analytic roofline, print the table, merge the autotune section into
    the cost report and embed the chosen plan as an ExecutionPlan
    document, so the report is itself a ``--plan`` file. Pure host
    arithmetic: the model is profiled from shapes on the meta device and
    nothing touches a GPU. ``--devices`` defaults to the visible cards
    (JAX's to its 8 forced CPU devices); with none, it must be given."""
    from parallel_cnn_tpu_torch.analysis import autotune as autotune_lib
    from parallel_cnn_tpu_torch.analysis import hw_profiles

    at = AutotuneConfig.from_env() or AutotuneConfig()
    p = argparse.ArgumentParser(
        prog="parallel_cnn_tpu_torch tune",
        description="cost-model plan autotuner (analysis/autotune.py)",
    )
    p.add_argument("--model", default="cifar_cnn", choices=ZOO_MODELS,
                   help="zoo model the plan space is profiled for")
    p.add_argument("--global-batch", type=int, default=128, metavar="B",
                   help="global batch size every plan must serve")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="device count the plans are laid out over "
                        "(default: the visible cards; required without one)")
    p.add_argument("--hosts", type=int, default=1, metavar="H",
                   help="emulated host count (hierarchical plans need "
                        ">= 2; flat rings spanning hosts are charged at "
                        "NIC speed)")
    p.add_argument("--hw", default=at.hw, metavar="NAME",
                   help="hardware profile scored against "
                        f"({', '.join(sorted(hw_profiles.PROFILES))}) "
                        "[PCNN_HW_PROFILE]")
    p.add_argument("--hbm-budget-mb", type=float, default=None, metavar="MB",
                   help="peak-HBM budget per device; default: the "
                        "profile's capacity [PCNN_AUTOTUNE_HBM_BUDGET]")
    p.add_argument("--top-k", type=int, default=at.top_k,
                   help="ranked plans kept in the report "
                        "[PCNN_AUTOTUNE_TOPK]")
    p.add_argument("--report", default=at.report, metavar="PATH",
                   help="cost report the autotune section is merged into; "
                        "default: the shipped analysis/cost_report.json "
                        "[PCNN_AUTOTUNE_REPORT]")
    p.add_argument("--no-prune", action="store_true",
                   help="score every feasible plan (disable the "
                        "admissible compute-lower-bound prune; results "
                        "are identical by construction — debug only)")
    args = p.parse_args(argv)

    from parallel_cnn_tpu_torch.nn import cifar, resnet, vgg

    n_dev = args.devices
    if not n_dev:
        import torch

        n_dev = torch.cuda.device_count()
        if not n_dev:
            print("tune: no GPU is visible; pass --devices N, the device "
                  "count the plans are laid out over")
            return 2
    factories = {
        "cifar_cnn": lambda: cifar.cifar_cnn(device="meta"),
        "resnet18": lambda: resnet.resnet18(10, device="meta"),
        "resnet34": lambda: resnet.resnet34(10, device="meta"),
        "resnet50": lambda: resnet.resnet50(10, cifar_stem=True, device="meta"),
        "vgg16": lambda: vgg.vgg16(10, device="meta"),
    }
    mp = autotune_lib.profile_module(factories[args.model](), cifar.IN_SHAPE,
                                     name=args.model)
    hw = hw_profiles.get_profile(args.hw)
    budget = (int(args.hbm_budget_mb * 1024 * 1024)
              if args.hbm_budget_mb is not None else at.hbm_budget)
    try:
        result = autotune_lib.search(
            mp, hw=hw, global_batch=args.global_batch, n_dev=n_dev,
            n_host=args.hosts, hbm_budget=budget, top_k=args.top_k,
            prune=not args.no_prune,
        )
    except autotune_lib.NoFeasiblePlan as exc:
        print(f"tune: {exc}")
        return 1
    print(autotune_lib.format_table(result))
    written = autotune_lib.write_section(
        args.report, autotune_lib.build_section(result))
    chosen, section = autotune_lib.load_chosen_plan(written)
    eplan = chosen.to_execution_plan(
        n_host=int(section.get("n_host", 1) or 1),
        n_dev=int(section.get("n_dev", 0) or 0) or None,
    )
    with open(written) as f:
        doc = json.load(f)
    doc["plan"] = eplan.to_json_dict()
    with open(written, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=2)
        f.write("\n")
    print(f"tune: chosen plan written to {written} "
          f"(plan {eplan.fingerprint()}; run with --plan {written})")
    return 0


def _run_plan(argv: List[str]) -> int:
    """``python -m parallel_cnn_tpu_torch plan show|diff`` (JAX's
    cli.py:1198-1250): ``plan show [train flags] [--save PATH]`` resolves
    exactly the plan a train run with those flags would execute (flag >
    env > plan file > default, the zoo's fused-step fallback applied) and
    prints it one knob per line with its provenance, ``ILLEGAL: …`` and
    exit 1 when the matrix refuses it; ``plan diff A B`` prints a field by
    field diff of two plan files (exit 0 when equal, 1 when they differ).
    A usage error or an unreadable file exits 2. Host only: nothing here
    touches a GPU."""
    if not argv or argv[0] not in ("show", "diff"):
        print("usage: parallel_cnn_tpu_torch plan show [train flags] "
              "[--save PATH]\n"
              "       parallel_cnn_tpu_torch plan diff PLAN_A PLAN_B")
        return 2
    if argv[0] == "diff":
        if len(argv) != 3:
            print("usage: parallel_cnn_tpu_torch plan diff PLAN_A PLAN_B")
            return 2
        try:
            a = plan_lib.load_plan(argv[1])
            b = plan_lib.load_plan(argv[2])
        except plan_lib.PlanError as exc:
            print(f"plan diff: {exc}")
            return 2
        out = plan_lib.diff_plans(a, b)
        if not out:
            print(f"plans identical ({a.fingerprint()})")
            return 0
        print(out)
        return 1
    p = build_parser()
    p.add_argument("--save", default=None, metavar="PATH",
                   help="also write the resolved plan as a --plan-loadable "
                        "plan.json")
    args = p.parse_args(argv[1:])
    cfg, _ = _zoo_fallback(config_from_args(args))
    plan = plan_lib.build_plan(cfg, args)
    verdict = ""
    try:
        plan.validate()
    except plan_lib.PlanError as exc:
        verdict = f"\nILLEGAL: {exc}"
    if args.save:
        plan_lib.save_plan(args.save, plan)
    print(plan_lib.format_plan(plan, title=f"resolved plan ({cfg.model})")
          + verdict)
    if args.save:
        print(f"plan written to {args.save}")
    return 1 if verdict else 0


def main(argv: Optional[List[str]] = None) -> int:
    raw = list(sys.argv[1:] if argv is None else argv)
    if raw and raw[0] in ("serve", "loadgen"):
        return _run_serve(raw[0], raw[1:])
    if raw and raw[0] == "tune":
        return _run_tune(raw[1:])
    if raw and raw[0] == "plan":
        return _run_plan(raw[1:])
    return _run_train(raw)
