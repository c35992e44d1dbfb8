"""On-card smoke test of the PyTorch/CUDA port (parallel_cnn_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every kernel of the port from the sources in the checkout (one
nvcc per source, all at once) and holds each kernel against its plain
PyTorch version at the shapes its path gives it. Then it drives the
port's two paths through their user-facing entry points:

- serving: full-width ResNet-18, random weights and BN statistics from a
  seed, restored from a checkpoint in the JAX trainer's format, with the
  answers checked, a profiled second run and a per-bucket breakdown;
- the serving control plane (slo (a)-(f)) on the same checkpoint: the
  flash-crowd scenario with admission control and without, diurnal,
  slow-client, chaos-kill on two replicas (failover, then the respawned
  replica's answers), chaos-slow (its p99 gate must trip) and the
  autoscaler from one replica to two and back, once through the serve
  CLI, each with exact conservation and B10 launches;
- the network front door (net (a)-(f)) on the same checkpoint over
  loopback TCP: net-steady with the wire-served logits against the plain
  model, the closed loop over the wire (its clients in 4 processes of
  their own, then in the server's process) beside the in-process one,
  slow-loris reaped, the endpoint killed with the supervisor (one respawn
  on its port) and without it (the gate trips), a hot swap to new weights
  with no failed request and the card's memory back, and the serve CLI
  with --listen --supervise through a killed endpoint, each tier (wire,
  batcher, journal) on its own conservation law and B10's launches exact;
- training: the LeNet-ref trainer's CLI on the synthetic 60,000/10,000
  MNIST stand-in, through the fused train-step kernel (--ops cuda), the
  fused SGD kernel (--fused-step) and the per-sample plain path, with a
  resumed run held bit for bit against a straight one and a profiled
  epoch of each kernel path;
- mesh training: the same CLI with --mesh-data 1 --ops cuda (a world of
  one rank over NCCL; one card cannot hold two), every step through the
  fused train-step kernel and the data-parallel update, its steps against
  the single-device kernel steps, psum against the ring, a resumed run
  against a straight one, the model-axis step on a 1x1 mesh against the
  data-parallel reference step, and a profiled epoch;
- zoo training: the trainer's CLI on full-width ResNet-18 (CIFAR stem) at
  batch 128 with every conv's forward, input gradient and weight gradient
  through the hand kernels and the loss through the fused tail kernel, a
  resumed run against a straight one, kernel steps against plain steps,
  the CIFAR CNN's fused tail, and a profiled epoch;
- the staged LeNet-ref library: its seven kernels against their plain
  versions, its grads against the fused kernel's, 50 training steps on
  them against 50 fused steps, a profiled epoch, and inference over the
  synthetic test set, with exact launch counts;
- data-parallel zoo training: the trainer's CLI on ResNet-18 with
  --mesh-data 1 --comm-impl ring --fused-step (a world of one rank over
  NCCL; one card cannot hold two), update-on-arrival through one launch
  of the fused SGD-momentum kernel over every bucket, its steps against
  the optax-path steps and the psum step, a resumed run against a
  straight one, and a profiled epoch;
- the probe path: the eight Mosaic probes' kernels (B14–B21; B20/B21 on
  the tensor cores, also at 37 and 10,000 rows) against their plain twins
  on seeded inputs, then the port's probe entry point (python -m
  parallel_cnn_tpu_torch.benches.mosaic_probe) with exact launch counts,
  two head-to-heads of the forms the probes compare, the copies (B15,
  B16) in turns with copy_ and B15 with the L2 cold, and the launch floor
  (an empty kernel, timed as the kernels are).

- ResNet-50 and VGG-16 at full width (zoo50, imagenet, vgg, serve50):
  the trainer's CLI on ResNet-50 (CIFAR stem, b128 in two microbatches)
  and VGG-16 (CIFAR head, b128) with every conv's forward, dgrad and
  wgrad through the hand kernels and the loss through the fused tail,
  exact launch counts derived from the models' convs, a resumed run,
  kernel steps against plain steps, every distinct ResNet-50 conv and the
  ImageNet stem at 224x224 against the plain twins, profiled epochs; the
  library resnet50() at ImageNet shape with its 7x7x2048 -> 1,000 tail
  (B12's tiled form; the CIFAR heads keep the per-image form, both forms
  checked and timed in turns at them), its rows at b1, b7, b32 against
  b128; serving both models from JAX-format checkpoints;
- the native C++ runtime (native): the idx parser against NumPy's, and
  --prefetch native and the zoo's --zoo-loader native against their
  NumPy twin, bit for bit, with the library built from native/*.cc.
- bf16 activations (bf16 (a)-(e)), JAX's default --fused-step: the bf16
  forms of B10 (forward, dgrad), B11 and B12 against their twins at every
  ResNet-18 and ResNet-50 conv and head, the forward, dgrad and wgrad on
  the tensor cores where tap_conv.wgmma_form takes the conv and their FFMA
  forms held and timed beside them, and the host time of a launch of each
  form; ResNet-18 through the CLI with exact bf16 launch counts by form and
  bf16 steps against f32 steps; the update-on-arrival CLI with the dynamic
  loss scale, its resume, and an overflow skipped and backed off, then
  growth; profiled bf16 epochs of ResNet-18 and ResNet-50 beside the f32
  ones.
- ZeRO-3 (zero3 (a)-(d)) on ResNet-18 at b128, world 1: the CLI with
  PCNN_FUSED_STEP=1 PCNN_ZERO_LEVEL=3 and the ring, exact launches
  (dp (b)'s counts, one B13 launch a step over the resident rows), a
  falling loss and the
  checkpoint's zero3 marker; 3 ZeRO-3 steps against 3 ZeRO-2 steps from
  one init in f32 and bf16; a resumed run through restore_sharded
  against the straight one; a profiled epoch beside dp (e)'s.
- the 1F1B pipeline (pipe (a)-(b)) on ResNet-18 at b128, two
  microbatches a step: the CLI at --pipeline-stages 1 bit for bit against
  the flat ring at --mesh-data 1, exact launches; at two and four stages
  (one card cannot hold two ranks) the stage programs the pipelined step
  runs, driven on the card in the schedule's order, their summed grads
  against a single-device step's, BN's statistics updated once a
  microbatch, B10/B11 launches exact at each stage's convs, the ZeRO-2
  tail through B13 and a bf16 case through the tensor-core forms; each
  stage's time beside the bubble share.
- elastic ZeRO-3 (elastic (a)-(b)) on ResNet-18 at b128, world 1: the CLI
  with --elastic, a schedule entry and a chaos resize@ that both clamp to
  the one reachable rank and are skipped as JAX logs them, exact launches
  (zero3 (a)'s), a falling loss, the trace and metrics JSON; the
  controller called directly: a zero-step resize bit for bit, three steps
  after it bit-identical to three without, the ring fallback bit for bit.
- async data parallelism (async (a)-(b)) on LeNet-ref b64, four workers,
  the gradients through B1: stale S=0 against the synchronous schedule,
  stale S=2 under a straggler against the plain ops, EASGD's center
  learning, one B1 launch a gradient; the CLI's two modes.
- the trainer's chaos and obs (chaos (a)): the LeNet-ref trainer with
  nan@ under --sentinel rollback, the rollback journaled, B1 once a step.
- the ExecutionPlan (plan (a)-(b)) on ResNet-18 at b128, f32 ZeRO-3,
  world 1: plan show --save under PCNN_FUSED_STEP=1 PCNN_ZERO_LEVEL=3
  (host only), one
  epoch by the flags and one by --plan alone, bit-identical checkpoints
  stamped with the fingerprint plan show printed and exact, equal
  launches; the file resumed under a changed plan (--accum-steps 2)
  refused with PlanMismatchError, then resumed with --replan, one B13
  launch a step.

The conv forward is also timed at each of its block tiles at every
ResNet-18 conv and four batches, beside the tile the wrapper picks; the
staged conv and FC forwards (B3, B5) in turns with their library calls at
batch 64 and 1000; the staged sigma' kernel (B8) alone there with the L2
warm and cold; the fused SGD (B2) over LeNet's six leaves; tree_sgd in
turns with the parent's packing path (both buckets concatenated before
the launch), host us a call, and the device ops of a --fused-step step
with each.

Each path's launch counts are set to 0 just before it and read just
after. It times every kernel beside its bound, its plain version and a
library call where one exists, and prints one JSON line of kernel records
and, last, one JSON line with the device. Any failure exits non-zero
before the last line. Without a GPU, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import faulthandler
import gc
import io
import itertools
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from parallel_cnn_tpu_torch import cli
from parallel_cnn_tpu_torch import plan as plan_lib
from parallel_cnn_tpu_torch.cli import padded_bucket_parity
from parallel_cnn_tpu_torch.config import (
    CommConfig,
    Config,
    FusedStepConfig,
    ObsConfig,
    PipelineConfig,
    ServeConfig,
    TrainConfig,
)
from parallel_cnn_tpu_torch.benches import mosaic_probe as probe_bench
from parallel_cnn_tpu_torch.data import mnist, native, pipeline, synthetic
from parallel_cnn_tpu_torch.models import lenet_ref
from parallel_cnn_tpu_torch.nn import resnet, vgg
from parallel_cnn_tpu_torch.nn.layers import BatchNorm, Conv2D, ConvBNAct
from parallel_cnn_tpu_torch.nn.resnet import BasicBlock, Bottleneck
from parallel_cnn_tpu_torch.ops import (
    lenet_fused,
    lenet_staged,
    mosaic_probe,
    reference,
    sgd_update,
    tail,
    tap_conv,
    tap_wgrad,
)
from parallel_cnn_tpu_torch.ops._cuda_build import BUILD_DIR
from parallel_cnn_tpu_torch.parallel import collectives, data_parallel, distributed, intra_op
from parallel_cnn_tpu_torch.parallel import pipeline as pipe_lib
from parallel_cnn_tpu_torch.parallel.mesh import DataMesh, make_pipeline_mesh
from parallel_cnn_tpu_torch.ops.activations import apply_grad
from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.resilience.chaos import ChaosMonkey
from parallel_cnn_tpu_torch.resilience.retry import RetryPolicy
from parallel_cnn_tpu_torch.serve import (
    AutoScaler,
    Engine,
    NetServer,
    Supervisor,
    WireStats,
    armed_factory,
    get,
    loadgen,
    scenarios,
    serve_stack,
)
from parallel_cnn_tpu_torch.serve.net import encode_request
from parallel_cnn_tpu_torch.train import pipeline_schedule as pipe_step
from parallel_cnn_tpu_torch.train import step as step_lib
from parallel_cnn_tpu_torch.train import trainer, zoo
from parallel_cnn_tpu_torch.utils.backend import card_name_and_power_limit
from parallel_cnn_tpu_torch.utils.metrics import Histogram
from parallel_cnn_tpu_torch.utils.tree import tree_leaves, tree_map

BATCH = 64
# Published H100 SXM peaks (dense): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# The same sheet's dense bf16 rate in the tensor cores.
PEAK_BF16_FLOPS = 989e12
# Above the H100's top SM clock (1.98 GHz): a spin of c cycles lasts at
# least c / SPIN_HZ seconds.
SPIN_HZ = 2.0e9
# Copies of a 2^20-element (p, g) pair, 8 MB each, that overflow the
# H100's 50 MB L2 when a timing cycles through them.
L2_COPIES = 8
# One conv layer, f32, against the plain version (F.conv2d without cuDNN,
# TF32 off): the two sum K <= 4608 products in different orders, so the
# difference is bounded relative to the output's scale.
CONV_RTOL = 1e-4
# Whole-model logits after 20 such layers.
LOGIT_RTOL = 1e-3
SERVE_REQUESTS = 256
SERVE_CONCURRENCY = 16
KERNEL_MODULES = (tap_conv, tap_wgrad, tail, lenet_fused, sgd_update, lenet_staged,
                  mosaic_probe)
TIME_LIMIT_S = 1100

# The LeNet-ref trainer. B1 (lenet_fused) vs its plain version: f32 on both
# sides, up to 576 products per grad value summed in different orders.
LENET_RTOL = 1e-5
LENET_SIZES = (1, 7, 64, 128, 1000)
# B2 (sgd_update) rounds after each op as its plain version does.
SGD_SIZES = (1, 127, 128, 2343, 5 * 128 + 37, 2**20)
TRAIN_BATCH = 64
TRAIN_COUNT = 60_000
STEPS_PER_EPOCH = TRAIN_COUNT // TRAIN_BATCH  # 937, drop-tail
PER_SAMPLE_COUNT = 6_000
# (e): 50 steps of the kernel step vs the plain step on the card.
STEP_CHECK_STEPS = 50
STEP_CHECK_ATOL = 1e-4
# The mesh phase: LeNet-ref over a (data, model) mesh of one rank.
MESH_CHECK_STEPS = 10
MESH_2D_ATOL = 1e-5
# The (data, model) = (1, 1) mesh those one-rank worlds make.
MESH_1X1 = plan_lib.ExecutionPlan(data=1, model=1)
# The ZeRO-3 step, as JAX's CLI resolves it: PCNN_ZERO_LEVEL refines the
# fused step of PCNN_FUSED_STEP=1 (--fused-step alone is ZeRO-2).
ZERO3_ENV = {"PCNN_FUSED_STEP": "1", "PCNN_ZERO_LEVEL": "3"}
ZERO3_SH = " ".join(f"{k}={v}" for k, v in ZERO3_ENV.items())
# Multiply-adds per image of the LeNet-ref step (csrc/lenet_fused.cu):
# forward conv 86,400, pool 3,456, FC 2,160; backward FC wgrad 2,160, FC dX
# 2,160, pool wgrad 3,456, pool scatter 3,456, conv wgrad 86,400.
LENET_MACS_PER_IMAGE = 189_648

# (name, H, Cin, Cout, k, stride, residual, relu, count in one forward):
# every distinct conv of ResNet-18 on 32x32 input, with its epilogue.
GEOMETRIES = [
    ("stem 3x3/s1 3->64", 32, 3, 64, 3, 1, False, True, 1),
    ("3x3/s1 64 head", 32, 64, 64, 3, 1, False, True, 2),
    ("3x3/s1 64 tail+res", 32, 64, 64, 3, 1, True, True, 2),
    ("3x3/s2 64->128", 32, 64, 128, 3, 2, False, True, 1),
    ("1x1/s2 64->128 proj", 32, 64, 128, 1, 2, False, False, 1),
    ("3x3/s1 128 head", 16, 128, 128, 3, 1, False, True, 1),
    ("3x3/s1 128 tail+res", 16, 128, 128, 3, 1, True, True, 2),
    ("3x3/s2 128->256", 16, 128, 256, 3, 2, False, True, 1),
    ("1x1/s2 128->256 proj", 16, 128, 256, 1, 2, False, False, 1),
    ("3x3/s1 256 head", 8, 256, 256, 3, 1, False, True, 1),
    ("3x3/s1 256 tail+res", 8, 256, 256, 3, 1, True, True, 2),
    ("3x3/s2 256->512", 8, 256, 512, 3, 2, False, True, 1),
    ("1x1/s2 256->512 proj", 8, 256, 512, 1, 2, False, False, 1),
    ("3x3/s1 512 head", 4, 512, 512, 3, 1, False, True, 1),
    ("3x3/s1 512 tail+res", 4, 512, 512, 3, 1, True, True, 2),
]
CONVS_PER_FORWARD = sum(g[-1] for g in GEOMETRIES)  # 1 + 16 + 3 = 20

# The staged LeNet-ref library (lenet_staged, B3-B9). Each kernel against
# its plain version at these batches, with LENET_RTOL; the staged grads
# against B1's at batch 64 within JAX's own tolerances for the two tiers
# (tests/test_ops_pallas.py:100-109); inference against reference.forward.
STAGED_SIZES = (1, 7, 64, 1000)
ANCHOR_ERR_ATOL = 1e-6
ANCHOR_GRAD_TOL = 1e-5  # absolute and relative
TEST_COUNT = 10_000
OUT_ATOL = 1e-5
# A staged prediction may differ from the plain one only where the plain
# outputs' top two are closer than this.
TIE_GAP = 1e-5
STAGED_PER_STEP = {"conv_fwd": 1, "pool_fwd": 1, "fc_fwd": 1, "fc_bwd": 1,
                   "pool_bwd": 1, "sigma_prime": 1, "accum_matmul": 2}
STAGED_PER_FORWARD = {"conv_fwd": 1, "pool_fwd": 1, "fc_fwd": 1}
STAGED_REPLACES = {"conv_fwd": 141, "pool_fwd": 201, "fc_fwd": 238, "fc_bwd": 279,
                   "pool_bwd": 333, "sigma_prime": 413, "accum_matmul": 371}

# The zoo trainer: ResNet-18 at batch 128 on 40 steps per epoch of the
# synthetic CIFAR-shape set; eval in batches of 256 (JAX's default).
ZOO_BATCH = 128
ZOO_STEPS = 40
ZOO_TRAIN_COUNT = ZOO_STEPS * ZOO_BATCH
ZOO_TEST_COUNT = 2560
ZOO_EVAL_BATCH = 256
ZOO_FUSED = FusedStepConfig(update=False, act_dtype="float32")
# K1/K2/K3 vs their plain versions: f32 sums in other orders (wgrad sums
# up to 131,072 products per value), relative to the output's scale.
GRAD_RTOL = 1e-4
# (name, b, h, w, cin, cout, k, stride): shapes beyond ResNet-18's that
# reach the gradient kernels' other paths: many wgrad chunks; a pixel
# count no chunk divides (the last chunk ragged); Cin 3 and 20 and Cout
# 10 (4-byte copies, masked edges); odd sizes at stride 2 with k 3, 5, 7
# (asymmetric SAME phases).
GRAD_CASES = [
    ("3x3/s1 64, 128 chunks", 128, 32, 32, 64, 64, 3, 1),
    ("3x3/s2 b37 ragged chunk", 37, 16, 16, 64, 64, 3, 2),
    ("3x3/s1 Cin 3 Cout 10", 4, 16, 16, 3, 10, 3, 1),
    ("3x3/s2 Cin 20 Cout 10", 4, 16, 16, 20, 10, 3, 2),
    ("3x3/s2 odd 15x15", 3, 15, 15, 16, 24, 3, 2),
    ("5x5/s2 odd 13x11", 3, 13, 11, 8, 16, 5, 2),
    ("7x7/s2 odd 11x13", 2, 11, 13, 8, 16, 7, 2),
]
# The redesign's targets for one ResNet-18 step at b128 (device ms summed
# over its 19 dgrads and 20 wgrads, each 3x3/s2 head, and the share of
# the f32 bound at each 3x3/s1 geometry); reported, not enforced, since
# a card below 700 W runs slower.
TARGET_DGRAD_MS = 6.0
TARGET_WGRAD_MS = 5.0
TARGET_HEAD_MS = 0.45
TARGET_S1_SHARE = 0.45
# The square f32 GEMM timed as the yardstick of the f32 rate.
GEMM_SIZE = 8192
# The forward redesign's targets at b64 (device ms over the 20 convs, and
# the share of the f32 bound at each 3x3/s1 geometry); reported, not
# enforced, as the grad targets.
TARGET_FORWARD_MS = 2.3
TARGET_FORWARD_S1_SHARE = 0.50
# Batches at which the forward's tiles are timed against each other: the
# serving buckets' ends and middle, serving's b64 and the zoo's b128.
TILE_SWEEP_BATCHES = (1, 16, 64, 128)
# Kernel steps vs plain steps (zoo (c)): 3 steps at a gentle LR.
ZOO_CHECK_LR = 0.001
ZOO_LOSS_ATOL = 1e-4
ZOO_PARAM_ATOL = 5e-4
# The data-parallel phase: ResNet-18 at zoo (a)'s cut on a world of one
# rank (NCCL refuses two ranks on one card), update-on-arrival over the
# ring; B13 at odd sizes and at every bucket of ResNet-18's plan.
DP_WORLD = 1
DP_MOMENTUM_ODD_SIZES = (1, 127, 128_037)
DP_LR = 0.1
DP_MOMENTUM = 0.9
DP_COMM = CommConfig(impl="ring")
DP_FUSED = FusedStepConfig(update=True, act_dtype="float32")
Z3_STEPS = 3
# The GSPMD zoo path on one card (a 1x1 mesh): zoo (a)'s cut through the
# CLI at --mesh-data 1, and every ResNet-18 conv at the shard shapes of a
# model axis of these sizes (Cout/M filters a rank).
GSPMD_MODEL_SIZES = (2, 4)
# The probe path. The copies and B18 (each op rounded, as its plain twin)
# must equal their plain twins bit for bit; the products sum up to 128 f32
# products in another order than the plain twins, relative to the output's
# scale. One run of the entry point is a first call and 10 more per probe.
PROBE_EXACT = ("lane_merge", "lane_split", "vpu_conv")
PROBE_RTOL = 1e-5
PROBE_LAUNCHES = 11
# B20/B21 on the tensor cores, at row counts around the 64-row tile and
# past one wave of 132 SMs (10,000 rows: 157 tiles); probe (a) adds the
# last two to the probe's shapes.
DOT_KERNELS = ("pair_dot", "two_dot")
DOT_ROWS = (1, 37, 63, 64, 65, 1024, 10_000)
# The copies (B15, B16) are timed in turns with copy_, the gap between the
# two being a fraction of a microsecond; B15 also with L2 cold, after a
# write of L2_FLUSH_FLOATS f32 (64 MB, past the H100's 50 MB L2).
COPIES = ("lane_merge", "lane_split")
COPY_REPS = 300
L2_FLUSH_FLOATS = 16 * 2**20


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def time_call(fn, reps: int = 20, warmup: int = 3):
    """(device ms, call ms) of fn, each the mean over reps calls.

    Call ms is the host clock over reps calls and a synchronize: what a
    caller that issues the calls one after another pays. Device ms is
    taken between CUDA events around reps calls queued behind a spin
    kernel that outlasts their issue, so the events time the device's
    work and not the host's pace of issuing it (a small kernel's wrapper
    takes longer to issue than the kernel takes to run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * issue_s * SPIN_HZ) + 100_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, issue_s * 1e3 / reps


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over reps launches (see time_call)."""
    return time_call(fn, reps, warmup)[0]


def cold_ms(fn, reps: int = 50) -> float:
    """Mean device time of fn with the L2 cold: a write of L2_FLUSH_FLOATS
    f32 before each launch, outside the events around it. Every flush,
    launch and event is queued behind a spin kernel, with no host wait
    between them, so the card stays busy and its clock does not drop
    between launches."""
    flush = torch.empty(L2_FLUSH_FLOATS, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * SPIN_HZ))
    for start, end in events:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    events[-1][1].synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def in_turns(fa, fb, reps: int):
    """(a ms, b ms): device times of two functions taken in turns, a, b, b,
    a, each the mean of its two turns, so a drift in the card's clock
    weighs on both alike."""
    t = [cuda_ms(f, reps) for f in (fa, fb, fb, fa)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


class plain_reference:
    """Context: plain PyTorch convs as a reference — cuDNN off (PyTorch's
    own im2col + f32 GEMM) and TF32 off."""

    def __enter__(self):
        self._cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False

    def __exit__(self, *exc):
        torch.backends.cudnn.enabled = self._cudnn


def geometry_inputs(h, cin, cout, k, stride, residual, gen):
    dev = "cuda"
    x = torch.randn((BATCH, h, h, cin), generator=gen, device=dev)
    w = torch.randn((k, k, cin, cout), generator=gen, device=dev)
    w *= (2.0 / (k * k * cin)) ** 0.5
    scale = torch.rand((cout,), generator=gen, device=dev) + 0.5
    shift = 0.1 * torch.randn((cout,), generator=gen, device=dev)
    oh = -(-h // stride)
    res = (torch.randn((BATCH, oh, oh, cout), generator=gen, device=dev)
           if residual else None)
    return x, w, scale, shift, res


def lines_read(size, k, stride):
    """Input rows (or columns) a SAME conv reads: all of them, unless the
    stride steps over some, as a 1x1/s2 conv skips every other one."""
    out, pad_lo, _ = tap_conv.same_pads(size, k, stride)
    return len({o * stride - pad_lo + d for o in range(out) for d in range(k)}
               & set(range(size)))


def bound_ms(x, w, stride, out_shape, residual):
    """Least time for the conv on this card: the larger of its operations
    at the f32 peak and its bytes (each input element it reads, once; each
    output once) at the HBM rate."""
    n, oh, ow, cout = out_shape
    _, h, wd, cin = x.shape
    k = w.shape[0]
    flops = 2.0 * n * oh * ow * cout * k * k * cin
    x_read = n * lines_read(h, k, stride) * lines_read(wd, k, stride) * cin
    elems = x_read + w.numel() + 2 * cout + n * oh * ow * cout
    if residual:
        elems += n * oh * ow * cout
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = 4.0 * elems / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_call(x, w, scale, shift, res, stride, relu):
    """cuDNN F.conv2d (f32, TF32 off) on channels-last tensors, padded
    outside the timing, then the epilogue as PyTorch ops: the library
    yardstick for the same function."""
    k = w.shape[0]
    h = x.shape[1]
    _, pt, pb = tap_conv.same_pads(h, k, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (pt, pb, pt, pb)).contiguous(
        memory_format=torch.channels_last)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    sc = scale.view(1, -1, 1, 1)
    sh = shift.view(1, -1, 1, 1)
    rs = None if res is None else res.permute(0, 3, 1, 2)

    def call():
        y = torch.addcmul(sh, F.conv2d(xp, wl, stride=stride), sc)
        if rs is not None:
            y = y + rs
        return torch.relu_(y) if relu else y

    return call


def forward_at_tile(x, w, scale, shift, res, stride, relu, tile):
    """(launch, out): ``launch()`` runs the forward's C entry at block tile
    ``tile`` (the wrapper always takes ``forward_tile``'s) into ``out`` and
    returns its cudaError_t, 0 for a launch that was accepted."""
    k = w.shape[0]
    n, h, wd, cin = x.shape
    oshape = tap_conv.out_shape(x.shape, w.shape, stride)
    out = torch.empty(oshape, device=x.device)
    ptrs = [None if t is None else t.data_ptr() for t in (scale, shift, res)]
    args = (x.data_ptr(), w.data_ptr(), *ptrs, out.data_ptr(), n, h, wd, cin, oshape[1],
            oshape[2], oshape[3], k, stride, tap_conv.same_pads(h, k, stride)[1],
            tap_conv.same_pads(wd, k, stride)[1], int(relu), tile)
    lib = tap_conv.build().get()
    return lambda: lib.tap_conv_forward(*args, torch.cuda.current_stream().cuda_stream), out


def time_forward_tiles() -> None:
    """Each forward tile at each ResNet-18 conv at TILE_SWEEP_BATCHES:
    the 20 convs' sum per tile, and how far ``forward_tile``'s pick is
    from the fastest tile at each conv."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    tiles = range(len(tap_conv.FORWARD_TILES))
    for batch in TILE_SWEEP_BATCHES:
        sums = [0.0 for _ in tiles]
        picked, worst = 0.0, (1.0, "")
        for name, h, cin, cout, k, s, res_on, relu, count in GEOMETRIES:
            x = torch.randn((batch, h, h, cin), generator=gen, device="cuda")
            w = torch.randn((k, k, cin, cout), generator=gen, device="cuda") * 0.1
            scale = torch.rand((cout,), generator=gen, device="cuda") + 0.5
            shift = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
            oh = -(-h // s)
            res = (torch.randn((batch, oh, oh, cout), generator=gen, device="cuda")
                   if res_on else None)
            launches = [forward_at_tile(x, w, scale, shift, res, s, relu, t)[0] for t in tiles]
            if any(launch() for launch in launches):
                fail(f"the forward's C entry refused a tile at {name} b{batch}")
            ms = [cuda_ms(launch, reps=20) for launch in launches]
            pick = tap_conv.forward_tile(batch, oh, oh, cin, cout, k)
            for t in tiles:
                sums[t] += count * ms[t]
            picked += count * ms[pick]
            worst = max(worst, (ms[pick] / min(ms), name))
        print(f"[smoke] time forward tiles b{batch}, {CONVS_PER_FORWARD} convs: picked "
              f"{picked:.4f} ms; " + ", ".join(
                  f"tile {t} {tap_conv.FORWARD_TILES[t]} {sums[t]:.4f}" for t in tiles)
              + f"; the pick at most {worst[0]:.3f}x the fastest tile at a conv "
              f"({worst[1]})", flush=True)


def random_bn(model, seed):
    """Non-trivial BatchNorm statistics and affine parameters from the
    seed, so the served BN fold is put to the test (γ below 1 keeps the
    residual stream O(1) across the 8 blocks)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.scale.uniform_(0.2, 0.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.mean.normal_(0.0, 0.1, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
    return model


def write_jax_checkpoint(model, path):
    """The model's weights in the JAX trainer's zoo checkpoint format
    ('/'-joined params and model_state paths beside a version-1 __meta__
    blob), so the serve stack restores them as it restores a user's
    --checkpoint."""
    arrays = {}
    for key, t in model.state_dict().items():
        tree = "model_state" if key.endswith((".mean", ".var")) else "params"
        arrays[f"{tree}/{key.replace('.', '/')}"] = t.numpy()
    arrays["__meta__"] = np.frombuffer(json.dumps({"version": 1}).encode(),
                                       np.uint8)
    np.savez(path, **arrays)


def plain_forward(model, x):
    """The model's forward with every conv through the plain version of
    the tap-conv kernel and BN folded here from γ, β, mean and var (an
    independent walk of the module tree, not the kernel wrappers nor the
    layers' own fold)."""

    def cba(m, v, residual=None):
        bn = m.bn
        scale = bn.scale / torch.sqrt(bn.var + bn.eps)
        shift = bn.bias - bn.mean * scale
        return tap_conv.conv2d_fused_plain(v, m.conv["w"], scale, shift,
                                           residual, m.stride, m.relu)

    for layer in model:
        if isinstance(layer, ConvBNAct):
            x = cba(layer, x)
        elif isinstance(layer, BasicBlock):
            sc = cba(layer.proj[0], x) if layer.proj is not None else x
            x = cba(layer.main[1], cba(layer.main[0], x), sc)
        else:
            x = layer(x)
    return x


def profiled_serve(batcher) -> None:
    """Where the serving time goes: a second closed-loop run under
    torch.profiler (CUDA activity only) — device time by kernel and the
    device's busy share of the run's wall time."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = loadgen.run(batcher, pattern="closed",
                             n_requests=SERVE_REQUESTS,
                             concurrency=SERVE_CONCURRENCY, seed=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if report.completed != SERVE_REQUESTS:
        fail(f"profiled run: {report.completed}/{SERVE_REQUESTS} completed")
    if dev_ms == 0:
        print("[smoke] profiled closed loop: device time not measured "
              "(the profiler saw no device events)", flush=True)
        return
    print(f"[smoke] profiled closed loop: {report.throughput:.1f} req/s, wall "
          f"{wall_ms:.1f} ms, device busy {dev_ms:.1f} ms "
          f"({dev_ms / wall_ms:.1%}), idle {1 - dev_ms / wall_ms:.1%}",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"[smoke]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)


def bucket_breakdown(engine, in_shape) -> None:
    """Per bucket: predict on the host clock (pad, H2D, forward, D2H,
    unpad) beside the forward's device time (CUDA events)."""
    for b in (1, 4, 16, 64):
        xs = loadgen.make_samples(b, in_shape, seed=2)
        xt = torch.from_numpy(xs).cuda()
        dev = cuda_ms(lambda: engine.forward(xt), reps=10)
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine.predict(xs)
            host.append((time.perf_counter() - t0) * 1e3)
        print(f"[smoke] bucket b{b}: predict {float(np.median(host)):.3f} ms "
              f"(host clock, median of 10), forward {dev:.3f} ms (device)",
              flush=True)


# ---------------------------------------------------------------------------
# The LeNet-ref trainer: kernels B1 (lenet_fused) and B2 (sgd_update)
# ---------------------------------------------------------------------------


def lenet_inputs(n, seed, label_dtype=torch.int32):
    """Random LeNet-ref params from the seed and a batch of n images in
    [0, 1) with labels, on the card."""
    rng = np.random.default_rng(seed)
    params = tree_map(lambda t: t.cuda(),
                      lenet_ref.init(torch.Generator().manual_seed(seed)))
    xs = torch.from_numpy(rng.uniform(0, 1, (n, 28, 28)).astype(np.float32)).cuda()
    ys = torch.from_numpy(rng.integers(0, 10, (n,))).to("cuda", label_dtype)
    return params, xs, ys


def lenet_bound_ms(n):
    """Least time for one B1 call on n images: its operations at the f32
    peak against its bytes (images, int32 labels, params and the grads
    plus err written, each once) at the HBM rate."""
    t_ops = 2.0 * LENET_MACS_PER_IMAGE * n / PEAK_F32_FLOPS * 1e3
    t_bytes = 4.0 * (n * 784 + n + 2 * lenet_fused.ROW - 1) / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sgd_bound_ms(n):
    """B2 on n values: read p and g, write p' (12 bytes), 3 operations."""
    t_ops = 3.0 * n / PEAK_F32_FLOPS * 1e3
    t_bytes = 12.0 * n / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_lenet_fused() -> float:
    """B1 vs its plain version at every batch size, and two launches on the
    same batch bit-identical. Returns the largest difference."""
    max_err = 0.0
    for n in LENET_SIZES:
        params, xs, ys = lenet_inputs(n, n, label_dtype=torch.int64)
        err, grads = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
        err2, grads2 = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
        with plain_reference():
            ref_err, ref = lenet_fused.fused_value_and_ref_grads_plain(params, xs, ys)
        torch.cuda.synchronize()
        worst = 0.0
        ok = True
        for got, want in [(err, ref_err)] + list(zip(tree_leaves(grads),
                                                    tree_leaves(ref))):
            d = float((got - want).abs().max())
            tol = LENET_RTOL * max(1.0, float(want.abs().max()))
            ok = ok and got.shape == want.shape and bool(torch.isfinite(got).all())
            ok = ok and d <= tol
            worst = max(worst, d)
        same = torch.equal(err, err2) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(grads2)))
        print(f"[smoke] lenet_fused n={n:<4d}: max |Δ| vs plain {worst:.3e} "
              f"(tol {LENET_RTOL:.0e}·max(1,|ref|)), relaunch "
              f"{'bit-identical' if same else 'DIFFERS'} "
              f"{'ok' if ok and same else 'FAIL'}", flush=True)
        if not (ok and same):
            fail(f"lenet_fused n={n}: kernel disagrees with its plain version "
                 "or is not deterministic")
        max_err = max(max_err, worst)
    return max_err


# B2's trees: LeNet's params fresh and as views of a bucket after one step
# (leaves at element offsets 0, 6, 156, 166, 2,326 and 2,327), the mixed
# tree of tests/test_fused_step.py (a matrix, a vector and a 0-d leaf) and
# a tree of MAX_LEAVES + 5 leaves (one bucket, two launches).
SGD_TREES = ("lenet", "lenet_views", "mixed", "many")
SGD_LR = -0.1


def sgd_tree(which, dev, seed=0):
    """(params, grads) of one SGD_TREES tree on dev, made from the seed."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(np.asarray(rng.standard_normal(shape), np.float32)).to(dev)

    if which.startswith("lenet"):
        params = tree_map(lambda t: t.to(dev),
                          lenet_ref.init(torch.Generator().manual_seed(seed)))
    elif which == "mixed":
        params = {"a": normal(7, 11), "b": [normal(130), normal()]}
    else:
        params = {f"l{i:02d}": normal((i * 37) % 101 + 1)
                  for i in range(sgd_update.MAX_LEAVES + 3)}
        params.update(m=normal(5, 7), z=normal())
    grads = tree_map(lambda t: normal(*t.shape), params)
    if which == "lenet_views":
        params = sgd_update.tree_sgd(params, grads, lr=SGD_LR, scale=1.0 / TRAIN_BATCH)
    return params, grads


def packing_tree_sgd(params, grads, lr, scale, plain=False):
    """The parent's tree_sgd, composed of the functions that stay: both
    trees packed into their buckets (a torch.cat each), one fused_sgd (or
    its plain version) a bucket, the leaves unpacked as views."""
    plan = collectives.plan_buckets(params, shards=1)
    pb = collectives.flatten_buckets(params, plan)
    gb = collectives.flatten_buckets(grads, plan)
    if plain:
        out = [sgd_update.fused_sgd_plain(p, g, lr, scale) for p, g in zip(pb, gb)]
    else:
        out = [sgd_update.fused_sgd(p, g, lr=lr, scale=scale) for p, g in zip(pb, gb)]
    return collectives.unflatten_buckets(out, plan)


def tree_sgd_launches(params) -> int:
    """B2's launches for one tree_sgd of params on the card: one a bucket's
    MAX_LEAVES leaves."""
    plan = collectives.plan_buckets(params, shards=1)
    return sum(-(-len(m) // sgd_update.MAX_LEAVES) for m in sgd_update.bucket_leaves(plan))


def check_sgd_update() -> float:
    """B2 vs its plain version at every size, and tree_sgd on every
    SGD_TREES tree against the parent's packing composition (flatten,
    fused_sgd_plain, unflatten) with its launches counted: bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in SGD_SIZES:
        p = torch.randn(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda")
        got = sgd_update.fused_sgd(p, g, lr=SGD_LR, scale=1.0 / TRAIN_BATCH)
        want = sgd_update.fused_sgd_plain(p, g, SGD_LR, 1.0 / TRAIN_BATCH)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"[smoke] sgd_update n={n:<8d}: "
              f"{'bit-identical to plain ok' if same else 'DIFFERS from plain FAIL'}",
              flush=True)
        if not same:
            fail(f"sgd_update n={n}: max |Δ| {float((got - want).abs().max()):.3e}")
    for which in SGD_TREES:
        params, grads = sgd_tree(which, "cuda")
        before = sgd_update.launches.count
        got = sgd_update.tree_sgd(params, grads, lr=SGD_LR, scale=1.0 / TRAIN_BATCH)
        launched = sgd_update.launches.count - before
        want = packing_tree_sgd(params, grads, SGD_LR, 1.0 / TRAIN_BATCH, plain=True)
        torch.cuda.synchronize()
        leaves, ref = tree_leaves(got), tree_leaves(want)
        same = len(leaves) == len(ref) and all(
            a.shape == b.shape and torch.equal(a, b) for a, b in zip(leaves, ref))
        buckets = {t.untyped_storage().data_ptr() for t in leaves}
        ok = same and launched == tree_sgd_launches(params) and len(buckets) == 1
        print(f"[smoke] sgd_update tree_sgd {which:<11s}: {len(leaves)} leaves, "
              f"{launched} launch(es), "
              f"{'bit-identical to the packing composition' if same else 'DIFFERS'}, "
              f"leaves views of {len(buckets)} bucket {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"sgd_update tree_sgd {which}: not the packing composition's leaves "
                 "bit for bit in one launch a bucket's MAX_LEAVES leaves")
    return 0.0


def run_cli(argv):
    """cli.main(argv) with its standard output captured and echoed;
    returns the output. A non-zero return fails the smoke."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        if line.strip():
            print(f"[smoke]   | {line}", flush=True)
    if rc != 0:
        fail(f"cli.main({argv}) returned {rc}")
    return out


def epoch_errors(out):
    return [float(line.split()[1].rstrip(",")) for line in out.splitlines()
            if line.startswith("error: ")]


def final_record(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()][-1]


def checkpoint_leaves(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def train_phase(card) -> dict:
    """The LeNet-ref trainer on the card through its CLI: (a) the fused
    train-step kernel, (b) the fused SGD kernel, (c) the per-sample plain
    path, (d) a resumed run against a straight one, (e) the kernel step
    against the plain step. Returns each kernel's launches on its path."""
    work = BUILD_DIR / "smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = ["--batch-size", str(TRAIN_BATCH), "--shuffle"]

    # (a) --ops cuda: every step is one launch of lenet_fused.
    print(f"[smoke] train (a): --ops cuda --epochs 2 on the synthetic "
          f"{TRAIN_COUNT}/10000 sets", flush=True)
    lenet_fused.launches.reset()
    sgd_update.launches.reset()
    out = run_cli(base + ["--ops", "cuda", "--epochs", "2", "--checkpoint-dir",
                          str(work / "straight"), "--metrics", str(work / "a.jsonl")])
    launches = {"lenet_fused": lenet_fused.launches.count,
                "sgd_update_on_a": sgd_update.launches.count}
    errs = epoch_errors(out)
    rec = final_record(work / "a.jsonl")
    print(f"[smoke] train (a): lenet_fused launches {launches['lenet_fused']} "
          f"for {2 * STEPS_PER_EPOCH} steps; epoch errors {errs}; "
          f"{rec['images_per_sec']:.0f} img/s, {rec['seconds'] / 2:.3f} s/epoch, "
          f"error rate {rec['error_rate']:.2f}% on {card}", flush=True)
    if launches["lenet_fused"] != 2 * STEPS_PER_EPOCH or launches["sgd_update_on_a"]:
        fail("--ops cuda did not run every step through lenet_fused")
    rate_a = rec["images_per_sec"]
    if len(errs) != 2 or not errs[1] < errs[0] or "Error Rate: " not in out:
        fail("--ops cuda: the epoch error did not fall or no Error Rate line")

    # (b) --fused-step: every update is one sgd_update launch per bucket.
    print("[smoke] train (b): --fused-step --epochs 1", flush=True)
    sgd_update.launches.reset()
    lenet_fused.launches.reset()
    out = run_cli(base + ["--fused-step", "--epochs", "1", "--metrics",
                          str(work / "b.jsonl")])
    launches["sgd_update"] = sgd_update.launches.count
    rec = final_record(work / "b.jsonl")
    print(f"[smoke] train (b): sgd_update launches {launches['sgd_update']} for "
          f"{STEPS_PER_EPOCH} steps x 1 bucket; {rec['images_per_sec']:.0f} img/s, "
          f"error rate {rec['error_rate']:.2f}% on {card}", flush=True)
    if launches["sgd_update"] != STEPS_PER_EPOCH or lenet_fused.launches.count:
        fail("--fused-step did not run every update through sgd_update")

    # (c) --batch-size 1: the reference's per-sample SGD in plain ops.
    print(f"[smoke] train (c): --batch-size 1 on {PER_SAMPLE_COUNT} samples",
          flush=True)
    out = run_cli(["--batch-size", "1", "--epochs", "1", "--synthetic-train-count",
                   str(PER_SAMPLE_COUNT), "--metrics", str(work / "c.jsonl")])
    rec = final_record(work / "c.jsonl")
    print(f"[smoke] train (c): per-sample {rec['seconds']:.3f} s/epoch, "
          f"{rec['images_per_sec']:.0f} img/s, error rate "
          f"{rec['error_rate']:.2f}% on {card}", flush=True)
    if len(epoch_errors(out)) != 1 or "Error Rate: " not in out:
        fail("--batch-size 1 did not train an epoch")

    # (d) 1 epoch, then --resume to 2: the straight run's params, bit for bit.
    print("[smoke] train (d): 1 epoch + --resume 1 epoch vs (a)", flush=True)
    split = work / "split"
    run_cli(base + ["--ops", "cuda", "--epochs", "1", "--checkpoint-dir", str(split)])
    out = run_cli(base + ["--ops", "cuda", "--epochs", "2", "--checkpoint-dir",
                          str(split), "--resume"])
    a = checkpoint_leaves(work / "straight" / "ckpt_2.npz")
    b = checkpoint_leaves(split / "ckpt_2.npz")
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"[smoke] train (d): resumed params "
          f"{'bit-identical to the straight run' if same else 'DIFFER'}", flush=True)
    if "resumed from" not in out or not same:
        fail("a resumed run is not bit-identical to the straight run")

    # (e) 50 steps: the kernel step against the plain step from the same
    # params and batches, both on the card.
    imgs, labels = synthetic.make_dataset(STEP_CHECK_STEPS * TRAIN_BATCH, seed=7)
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).cuda()
    p_kernel = p_plain = trainer.init_params(0, torch.device("cuda"))
    for i in range(STEP_CHECK_STEPS):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        p_kernel, _ = step_lib.cuda_batched_step(p_kernel, xs[sl], ys[sl], 0.1)
        with plain_reference():
            p_plain, _ = step_lib.batched_step(p_plain, xs[sl], ys[sl], 0.1)
    diff = max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(p_kernel), tree_leaves(p_plain)))
    print(f"[smoke] train (e): {STEP_CHECK_STEPS} steps cuda_batched_step vs the "
          f"plain step: max |Δparams| {diff:.3e} (tol {STEP_CHECK_ATOL:.0e}) "
          f"{'ok' if diff <= STEP_CHECK_ATOL else 'FAIL'}", flush=True)
    if not diff <= STEP_CHECK_ATOL:
        fail("the kernel step drifted from the plain step")
    return launches, rate_a


def mesh_steps_rank(mesh, kind, steps):
    """On one rank: ``steps`` b64 steps on the synthetic set's first
    batches from the seed-0 params, through the data-parallel step on the
    kernel ("dp_cuda", psum; "dp_cuda_ring", the ring), the single-device
    kernel step ("single_cuda"), the data-parallel reference step
    ("dp_reference") or the model-axis step ("2d"). Returns the params on
    the host."""
    imgs, labels = synthetic.make_dataset(steps * TRAIN_BATCH, seed=7)
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).cuda()
    params = trainer.init_params(0, mesh.device)
    if kind == "single_cuda":
        step = lambda p, x, y: step_lib.cuda_batched_step(p, x, y, 0.1)  # noqa: E731
    elif kind == "2d":
        params = intra_op.shard_params(mesh, params)
        step = intra_op.make_2d_step(mesh, 0.1, TRAIN_BATCH)
    else:
        comm = CommConfig(impl="ring") if kind == "dp_cuda_ring" else CommConfig()
        ops = "reference" if kind == "dp_reference" else "cuda"
        step = data_parallel.make_dp_step(mesh, 0.1, TRAIN_BATCH, ops_path=ops,
                                          comm=comm)
    for i in range(steps):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        params, _ = step(params, mesh.shard_rows(xs[sl]), mesh.shard_rows(ys[sl]))
    if kind == "2d":
        params = intra_op.gather_params(mesh, params)
    return tree_map(lambda t: t.cpu(), params)


def mesh_params_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def mesh_phase(card, rate_a) -> dict:
    """The LeNet-ref trainer over a (data, model) mesh of one rank: (a) the
    CLI at --mesh-data 1 --ops cuda, exact B1 launches and no B2 launch,
    img/s beside train (a)'s; (b) 50 data-parallel kernel steps against 50
    single-device kernel steps, psum against the ring; (c) a resumed run
    against the straight one; (d) the model-axis step on a 1x1 mesh against
    the data-parallel reference step. Returns B1's launches on (a)."""
    work = BUILD_DIR / "smoke_mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = ["--mesh-data", "1", "--ops", "cuda", "--batch-size", str(TRAIN_BATCH),
            "--shuffle"]

    # (a) the main path: the counters set to 0 just before, read just after.
    print(f"[smoke] mesh (a): {' '.join(base)} --epochs 2", flush=True)
    lenet_fused.launches.reset()
    sgd_update.launches.reset()
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(work / "straight"),
                          "--metrics", str(work / "a.jsonl")])
    launches = {"lenet_fused": lenet_fused.launches.count,
                "sgd_update": sgd_update.launches.count}
    errs = epoch_errors(out)
    rec = final_record(work / "a.jsonl")
    print(f"[smoke] mesh (a): lenet_fused launches {launches['lenet_fused']} for "
          f"{2 * STEPS_PER_EPOCH} steps, sgd_update launches {launches['sgd_update']}; "
          f"epoch errors {errs}; {rec['images_per_sec']:.0f} img/s against train "
          f"(a)'s {rate_a:.0f} img/s in this run (host clock, first epoch cold), "
          f"error rate {rec['error_rate']:.2f}% on {card}", flush=True)
    if "mesh: {'data': 1, 'model': 1}" not in out:
        fail("the --mesh-data 1 run did not print its mesh")
    if launches["lenet_fused"] != 2 * STEPS_PER_EPOCH or launches["sgd_update"]:
        fail("the mesh path did not run every step through lenet_fused alone")
    if len(errs) != 2 or not errs[1] < errs[0] or "Error Rate: " not in out:
        fail("the mesh path's epoch error did not fall or no Error Rate line")

    # (b) 50 steps each from one init, every run a world of one rank.
    runs = {kind: distributed.run(mesh_steps_rank, 1, device="cuda", plan=MESH_1X1,
                                  args=(kind, STEP_CHECK_STEPS))[0]
            for kind in ("dp_cuda", "dp_cuda_ring", "single_cuda")}
    diff = mesh_params_diff(runs["dp_cuda"], runs["single_cuda"])
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(runs["dp_cuda"]),
                                                  tree_leaves(runs["dp_cuda_ring"])))
    ok = diff <= STEP_CHECK_ATOL and same
    print(f"[smoke] mesh (b): {STEP_CHECK_STEPS} make_dp_step(ops_path='cuda') steps "
          f"vs cuda_batched_step: max |Δparams| {diff:.3e} (tol "
          f"{STEP_CHECK_ATOL:.0e}); comm psum vs ring "
          f"{'bit-identical' if same else 'DIFFER'} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the data-parallel kernel step drifted from the single-device one, "
             "or psum and the ring differ at world 1")

    # (c) 1 epoch, then --resume to 2: the straight run's params, bit for bit.
    print("[smoke] mesh (c): 1 epoch + --resume 1 epoch vs (a)", flush=True)
    split = work / "split"
    run_cli(base + ["--epochs", "1", "--checkpoint-dir", str(split)])
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(split), "--resume"])
    a = checkpoint_leaves(work / "straight" / "ckpt_2.npz")
    b = checkpoint_leaves(split / "ckpt_2.npz")
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"[smoke] mesh (c): resumed params "
          f"{'bit-identical to the straight run' if same else 'DIFFER'}", flush=True)
    if "resumed from" not in out or not same:
        fail("a resumed mesh run is not bit-identical to the straight run")

    # (d) the model-axis step on a 1x1 mesh against the DP reference step.
    ref, two_d = (distributed.run(mesh_steps_rank, 1, device="cuda", plan=MESH_1X1,
                                  args=(kind, MESH_CHECK_STEPS))[0]
                  for kind in ("dp_reference", "2d"))
    diff = mesh_params_diff(two_d, ref)
    print(f"[smoke] mesh (d): {MESH_CHECK_STEPS} make_2d_step steps on a 1x1 mesh vs "
          f"the data-parallel reference step: max |Δparams| {diff:.3e} (tol "
          f"{MESH_2D_ATOL:.0e}) {'ok' if diff <= MESH_2D_ATOL else 'FAIL'}", flush=True)
    if not diff <= MESH_2D_ATOL:
        fail("the model-axis step drifted from the data-parallel reference step")
    return launches


def profiled_mesh_epoch(mesh, ds):
    """(e) on one rank: a profiled --mesh-data 1 --ops cuda epoch."""
    return profiled_epoch(ds, "--mesh-data 1 --ops cuda", Config(
        train=TrainConfig(batch_size=TRAIN_BATCH, ops="cuda", shuffle=True)), mesh=mesh)


def profiled_epoch(ds, label: str, cfg: Config, mesh=None):
    """Where an epoch's time goes: one epoch of trainer.learn (on ``mesh``
    when given) under torch.profiler (CUDA activity only) — device time by
    kernel, launches per step and the device's busy share of the epoch's
    wall time. Returns (us per step, device ops per step, idle share), or
    None when the profiler saw no device events."""
    # warm: allocator, library, caches
    trainer.learn(cfg, ds, verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = trainer.learn(cfg, ds, verbose=False, mesh=mesh)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return report_profile(f"epoch ({label}, b{TRAIN_BATCH}, {res.steps} steps)",
                          kernels, wall_ms, res.steps)


def report_profile(label: str, kernels, wall_ms: float, steps: int, top: int = 8):
    """Print a profiled LeNet epoch's wall time, device busy and idle share,
    device ops and us per step, and its top kernels; returns (us per step,
    ops per step, idle share), or None when no device time was seen."""
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    if dev_ms == 0:
        print(f"[smoke] profiled {label}: device time not measured (the "
              "profiler saw no device events)", flush=True)
        return None
    us, ops, idle = wall_ms / steps * 1e3, n_kernels / steps, 1 - dev_ms / wall_ms
    print(f"[smoke] profiled {label}: wall {wall_ms:.1f} ms, device busy "
          f"{dev_ms:.1f} ms ({dev_ms / wall_ms:.1%}), idle {idle:.1%}; "
          f"{ops:.1f} device ops per step, {us:.1f} us per step", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[smoke]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)
    return us, ops, idle


def device_launches(fn, calls: int = 50) -> str:
    """The CUDA kernels that one call of fn runs, from torch.profiler's
    device events over `calls` calls: each kernel's share of the calls,
    taken against the kernel seen most often (the profiler starts tracing
    a little after it is entered and misses the first few calls)."""
    fn()
    torch.cuda.synchronize()
    counts = {}
    for _ in range(3):  # a session now and then records no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        if counts:
            break
    if not counts:
        return "not measured"
    top = max(counts.values())
    per_call = sum(c / top for c in counts.values())
    names = ", ".join(k.replace("(anonymous namespace)::", "").split("(")[0]
                      .removeprefix("void ").strip() for k in counts)
    return f"{per_call:.2f} ({names}; {top} of {calls} calls seen)"


def device_timeline(fn, calls: int = 20) -> str:
    """The CUDA kernels of fn's last call of `calls` queued behind a spin
    kernel (so the device runs them back to back, as a step does), from
    torch.profiler's device events: each one's start and end in us from
    the first one's start."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile now and then records no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(int(0.02 * SPIN_HZ))
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "spin_kernel" not in e.name), key=lambda e: e.time_range.start)
        if events:
            break
    last = []  # the last call's kernels: back from the end to a repeated name
    for e in reversed(events):
        if any(e.name == f.name for f in last):
            break
        last.insert(0, e)
    if not last:
        return "not measured"
    t0 = last[0].time_range.start
    name = lambda e: (e.name.replace("(anonymous namespace)::", "").split("(")[0]  # noqa: E731
                      .split("<")[0].removeprefix("void "))
    return ", ".join(f"{name(e)} {e.time_range.start - t0:.2f}-{e.time_range.end - t0:.2f}"
                     for e in last)


def sgd_leaf_operands(n, copies, gen):
    """B2's operands as the --fused-step path gives them after a step:
    LeNet's 6 leaves (their lengths scaled to n values in all) as views of
    one buffer at their prefix offsets, the grads as fresh tensors; copies
    of them, and each copy's packed buffers for the library call."""
    sizes = [max(1, k * n // lenet_fused.N_GRADS) for k in (6, 150, 10, 2160, 1, 16)]
    sizes[3] += n - sum(sizes)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    out = []
    for _ in range(copies):
        flat = torch.randn(n, generator=gen, device="cuda")
        ps = [flat[offs[i]:offs[i + 1]] for i in range(len(sizes))]
        gs = [torch.randn(k, generator=gen, device="cuda") for k in sizes]
        out.append((ps, gs, flat, torch.cat(gs)))
    return out


def time_lenet_kernels() -> dict:
    """B1 at batch 64, 128 and 1000 and B2 over LeNet's 6 leaves at 2343
    and 2^20 values: kernel, plain and (B2) library times beside the bound,
    and B1's CUDA launches a call. Returns the main path's shapes' numbers
    (B1 at batch 64, B2 at LeNet's 2343)."""
    out = {}
    for n in (TRAIN_BATCH, 128, 1000):
        params, xs, ys = lenet_inputs(n, 100 + n)
        if n == TRAIN_BATCH:
            print(f"[smoke] lenet_fused b{n}: "
                  f"{device_launches(lambda: lenet_fused.fused_value_and_ref_grads(params, xs, ys))}"
                  " CUDA launches per wrapper call (torch.profiler)", flush=True)
        ms, call = time_call(lambda: lenet_fused.fused_value_and_ref_grads(
            params, xs, ys))
        with plain_reference():
            plain, plain_call = time_call(
                lambda: lenet_fused.fused_value_and_ref_grads_plain(params, xs, ys))
        bound, by = lenet_bound_ms(n)
        print(f"[smoke] time lenet_fused b{n}: kernel {ms:.4f} ms (device; "
              f"{call:.4f} ms per call), plain {plain:.4f} ms (device; "
              f"{plain_call:.4f} ms per call), library none, bound "
              f"{bound:.6f} ms ({by}), {bound / ms:.2%} of bound; "
              f"{TRAIN_COUNT // n} launches per epoch", flush=True)
        if n == TRAIN_BATCH:
            out["lenet_fused"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                      bound_by=by, library_ms=None)
    gen = torch.Generator(device="cuda").manual_seed(1)
    lr, scale = -0.1, 1.0 / TRAIN_BATCH
    for n in (lenet_fused.N_GRADS, 2**20):
        # LeNet's 28 KB bucket stays in L2 from step to step, as in the
        # trainer. At 2^20 the calls cycle through copies that overflow the
        # 50 MB L2, so each one reads and writes device memory.
        copies = 1 if n == lenet_fused.N_GRADS else L2_COPIES
        turn = itertools.cycle(sgd_leaf_operands(n, copies, gen))
        ms, call = time_call(lambda: sgd_update.fused_sgd_leaves(
            *next(turn)[:2], lr=lr, scale=scale), reps=50)
        plain, plain_call = time_call(lambda: sgd_update.fused_sgd_plain(
            *next(turn)[2:], lr, scale), reps=50)
        lib, lib_call = time_call(
            lambda: torch.add(*next(turn)[2:], alpha=-lr * scale), reps=50)
        bound, by = sgd_bound_ms(n)
        print(f"[smoke] time sgd_update n={n} over 6 leaves: kernel {ms:.5f} ms "
              f"(device; {call:.4f} ms per call), plain (packed) {plain:.4f} ms "
              f"({plain_call:.4f}), library (torch.add, packed) {lib:.5f} ms "
              f"({lib_call:.4f}), bound {bound:.6f} ms ({by}), {bound / ms:.2%} of "
              f"bound", flush=True)
        if n == lenet_fused.N_GRADS:
            out["sgd_update"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                     bound_by=by, library_ms=lib)
    time_tree_sgd()
    return out


def step_device_ops(fn, steps: int = 100):
    """Device ops a call of fn (one fused_batched_step), from torch.profiler
    over `steps` calls: every device event counted against the B2 launches
    seen (one a step; the profiler may miss the first calls), or None when
    it saw none."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile now and then records no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum(e.count for e in events if "sgd_leaves_kernel" in e.key)
        if seen:
            return sum(e.count for e in events) / seen
    return None


def time_tree_sgd() -> None:
    """tree_sgd on LeNet's params (views of a bucket, as after a step) in
    turns with the parent's packing composition (packing_tree_sgd), host us
    a call (reps calls back to back, then a synchronize) and device
    us; then the device ops of one b64 fused_batched_step with each, from
    torch.profiler in this process."""
    params, grads = sgd_tree("lenet_views", "cuda")
    scale = 1.0 / TRAIN_BATCH

    def leaf_list():
        return sgd_update.tree_sgd(params, grads, lr=SGD_LR, scale=scale)

    def packing():
        return packing_tree_sgd(params, grads, SGD_LR, scale)

    t = [time_call(f, reps=200) for f in (packing, leaf_list, leaf_list, packing)]
    host = [(t[0][1] + t[3][1]) / 2 * 1e3, (t[1][1] + t[2][1]) / 2 * 1e3]
    dev = [(t[0][0] + t[3][0]) / 2 * 1e3, (t[1][0] + t[2][0]) / 2 * 1e3]
    print(f"[smoke] time tree_sgd on LeNet's params in turns: leaf list {host[1]:.2f} us "
          f"a call on the host clock ({dev[1]:.3f} us device), the parent's packing path "
          f"{host[0]:.2f} us ({dev[0]:.3f} us device): {host[0] - host[1]:.2f} us a call "
          f"faster on the host (rounds {', '.join(f'{r[1] * 1e3:.2f}' for r in t)})",
          flush=True)
    _, xs, ys = lenet_inputs(TRAIN_BATCH, 600)
    p0 = trainer.init_params(0, torch.device("cuda"))
    ops = {}
    for label, fn in (("packing", lambda p, g, *, lr, scale: packing_tree_sgd(p, g, lr, scale)),
                      ("leaf list", sgd_update.tree_sgd)):
        with mock.patch.object(sgd_update, "tree_sgd", fn):
            ops[label] = step_device_ops(lambda: step_lib.fused_batched_step(p0, xs, ys, 0.1))
    if None in ops.values():
        print("[smoke] fused_batched_step device ops: not measured (the profiler saw no "
              "device events)", flush=True)
    else:
        print(f"[smoke] fused_batched_step b{TRAIN_BATCH} device ops a step (torch.profiler): "
              f"leaf list {ops['leaf list']:.2f}, the parent's packing path "
              f"{ops['packing']:.2f}: {ops['packing'] - ops['leaf list']:.2f} fewer",
              flush=True)


# ---------------------------------------------------------------------------
# The staged LeNet-ref library: B3-B9 (lenet_staged)
# ---------------------------------------------------------------------------


def as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


def reset_staged_counts() -> None:
    for counter in lenet_staged.launches.values():
        counter.reset()


def expect_staged_counts(what: str, per: dict, times: int) -> dict:
    """Fail unless the staged counters read exactly per x times (0 for a
    kernel per does not name); returns the counts."""
    got = {k: c.count for k, c in lenet_staged.launches.items()}
    want = {k: per.get(k, 0) * times for k in lenet_staged.KERNELS}
    print(f"[smoke] staged (e): {what}: launches {got} (expected {want}) "
          f"{'ok' if got == want else 'FAIL'}", flush=True)
    if got != want:
        fail(f"staged {what}: the launch counts are not exactly the path's")
    return got


# The staged path's kernel functions by launch counter, and the order of
# its two B9 call sites within one staged_value_and_ref_grads.
STAGE_FUNCTIONS = {"conv_fwd": "conv_fwd", "pool_fwd": "pool_fwd", "fc_fwd": "fc_fwd",
                   "fc_bwd": "fc_bwd", "pool_bwd": "pool_bwd",
                   "sigma_prime": "conv_bwd_dpre", "accum_matmul": "_accum_matmul"}
B9_SITES = ("pool_wgrad", "conv_wgrad")


def stage_cases(params, xs, ys) -> dict:
    """Each kernel function of the staged path, its plain twin and the
    inputs the path gives it for this batch, keyed by launch counter (B9
    once per call site, as accum_matmul/pool_wgrad and
    accum_matmul/conv_wgrad): recorded from one run of
    staged_value_and_ref_grads on the host, through the plain twins, and
    moved to the device of xs. What a check of every kernel against its
    plain twin iterates."""
    calls = []

    def recorder(key, fn):
        def record(*args):
            calls.append((key, fn, args))
            return fn(*args)
        return record

    def host(t):
        return t.cpu()

    with contextlib.ExitStack() as patches:
        for key, attr in STAGE_FUNCTIONS.items():
            fn = getattr(lenet_staged, attr)
            patches.enter_context(mock.patch.object(lenet_staged, attr, recorder(key, fn)))
        lenet_staged.staged_value_and_ref_grads(tree_map(host, params), host(xs), host(ys))
    cases, sites = {}, iter(B9_SITES)
    for key, fn, args in calls:
        if key == "accum_matmul":
            key = f"{key}/{next(sites)}"
        plain = getattr(lenet_staged, fn.__name__ + "_plain")
        cases[key] = (fn, plain, tuple(a.to(xs.device) for a in args))
    return cases


def check_staged_kernels() -> dict:
    """(a) Each staged kernel at the inputs the path gives it, against its
    plain version on the same inputs, at every batch size; a relaunch bit
    for bit. Returns the largest difference of each kernel."""
    errs = dict.fromkeys(lenet_staged.KERNELS, 0.0)
    for n in STAGED_SIZES:
        params, xs, ys = lenet_inputs(n, 200 + n)
        for case, (fn, plain, args) in stage_cases(params, xs, ys).items():
            got, again = as_tuple(fn(*args)), as_tuple(fn(*args))
            want = as_tuple(plain(*args))
            torch.cuda.synchronize()
            worst, ok = 0.0, True
            for g, w in zip(got, want):
                d = float((g - w).abs().max())
                ok = ok and g.shape == w.shape and bool(torch.isfinite(g).all())
                ok = ok and d <= LENET_RTOL * max(1.0, float(w.abs().max()))
                worst = max(worst, d)
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            print(f"[smoke] staged (a) {case:24s} n={n:<4d}: max |Δ| vs plain "
                  f"{worst:.3e} (tol {LENET_RTOL:.0e}·max(1,|ref|)), relaunch "
                  f"{'bit-identical' if same else 'DIFFERS'} "
                  f"{'ok' if ok and same else 'FAIL'}", flush=True)
            if not (ok and same):
                fail(f"staged {case} n={n}: the kernel disagrees with its plain "
                     "version or is not deterministic")
            key = case.split("/")[0]
            errs[key] = max(errs[key], worst)
    return errs


def check_staged_anchor() -> None:
    """(b) The staged grads against B1's (lenet_fused) at batch 64."""
    params, xs, ys = lenet_inputs(TRAIN_BATCH, 300)
    err, grads = lenet_staged.staged_value_and_ref_grads(params, xs, ys)
    ref_err, ref = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
    d_err = abs(float(err) - float(ref_err))
    ok = d_err <= ANCHOR_ERR_ATOL
    d_grad = 0.0
    for g, r in zip(tree_leaves(grads), tree_leaves(ref)):
        d_grad = max(d_grad, float((g - r).abs().max()))
        ok = ok and g.shape == r.shape and bool(
            ((g - r).abs() <= ANCHOR_GRAD_TOL + ANCHOR_GRAD_TOL * r.abs()).all())
    print(f"[smoke] staged (b): staged_value_and_ref_grads vs lenet_fused at "
          f"b{TRAIN_BATCH}: |Δerr| {d_err:.3e} (tol {ANCHOR_ERR_ATOL:.0e}), max "
          f"|Δgrad| {d_grad:.3e} (tol {ANCHOR_GRAD_TOL:.0e} + "
          f"{ANCHOR_GRAD_TOL:.0e}·|ref|) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the staged grads disagree with the fused kernel's")


def staged_step(params, x, y, dt):
    """One minibatch step on the staged grads: p += dt·mean(g)."""
    err, grads = lenet_staged.staged_value_and_ref_grads(params, x, y)
    return apply_grad(params, grads, dt), err


def staged_epoch(params, images, labels, seed):
    """One epoch of staged steps in the trainer's order (the native ring's
    xorshift order, drop-tail), indices copied to the card once; returns
    (params, mean error as a float: the epoch's one readback)."""
    order = pipeline.epoch_order(len(images), TRAIN_BATCH, shuffle=True, seed=seed,
                                 native_semantics=True)
    flat = torch.from_numpy(np.concatenate(order)).cuda()
    errs = []
    for i in range(len(order)):
        j = flat[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
        params, e = staged_step(params, images[j], labels[j], 0.1)
        errs.append(e)
    return params, float(torch.stack(errs).mean())


def staged_phase(card, ds, fused_profile) -> tuple:
    """The staged library's path on the card: (a) each kernel against its
    plain version, (b) the grads against B1's, (c) 50 staged steps against
    50 B1 steps and a profiled epoch, (d) inference over the synthetic
    test set, (e) exact launch counts for (c) and (d). ``ds`` is the
    trainer's synthetic training set. Returns (the largest difference of
    each kernel, the launches of (c) and (d))."""
    errs = check_staged_kernels()
    check_staged_anchor()

    # (c) 50 steps from one init, staged against B1, in the trainer's order.
    images = torch.from_numpy(ds.images).cuda()
    labels = torch.from_numpy(ds.labels).cuda()
    order = pipeline.epoch_order(TRAIN_COUNT, TRAIN_BATCH, shuffle=True, seed=0,
                                 native_semantics=True)
    p_staged = p_fused = trainer.init_params(0, torch.device("cuda"))
    reset_staged_counts()
    for idx in order[:STEP_CHECK_STEPS]:
        j = torch.from_numpy(idx).cuda()
        p_staged, _ = staged_step(p_staged, images[j], labels[j], 0.1)
        p_fused, _ = step_lib.cuda_batched_step(p_fused, images[j], labels[j], 0.1)
    diff = max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(p_staged), tree_leaves(p_fused)))
    print(f"[smoke] staged (c): {STEP_CHECK_STEPS} staged steps vs {STEP_CHECK_STEPS} "
          f"cuda_batched_step (B1) steps from one init: max |Δparams| {diff:.3e} "
          f"(tol {STEP_CHECK_ATOL:.0e}) {'ok' if diff <= STEP_CHECK_ATOL else 'FAIL'}",
          flush=True)
    if not diff <= STEP_CHECK_ATOL:
        fail("the staged steps drifted from the fused kernel's steps")
    launches = expect_staged_counts(f"{STEP_CHECK_STEPS} steps", STAGED_PER_STEP,
                                    STEP_CHECK_STEPS)

    # (c) a warm epoch, then one profiled epoch, on the staged grads.
    reset_staged_counts()
    p_staged, err1 = staged_epoch(p_staged, images, labels, seed=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p_staged, err2 = staged_epoch(p_staged, images, labels, seed=2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"[smoke] staged (c): epoch errors {err1:.6f}, {err2:.6f}", flush=True)
    if not (np.isfinite(err1) and np.isfinite(err2) and err2 < err1):
        fail("the staged epochs' error did not fall")
    staged = report_profile(f"staged epoch (b{TRAIN_BATCH}, {STEPS_PER_EPOCH} steps)",
                            kernels, wall_ms, STEPS_PER_EPOCH, top=16)
    if staged is not None and fused_profile is not None:
        print(f"[smoke] staged (c): staged {staged[0]:.1f} us per step, "
              f"{staged[1]:.1f} device ops, idle {staged[2]:.1%}; --ops cuda "
              f"{fused_profile[0]:.1f} us per step, {fused_profile[1]:.1f} device "
              f"ops, idle {fused_profile[2]:.1%}; staged:fused step time "
              f"{staged[0] / fused_profile[0]:.2f} on {card}", flush=True)
    counts = expect_staged_counts(f"2 epochs of {STEPS_PER_EPOCH} steps",
                                  STAGED_PER_STEP, 2 * STEPS_PER_EPOCH)
    launches = {k: launches[k] + counts[k] for k in launches}

    # (d) forward and predict over the test set, against the plain forward.
    # The trainer's synthetic test split (DataConfig's seed + 1).
    test_imgs, test_labels = synthetic.make_dataset(TEST_COUNT, seed=1235)
    xt = torch.from_numpy(test_imgs).cuda()
    yt = torch.from_numpy(test_labels).cuda()
    batches = -(-TEST_COUNT // TRAIN_BATCH)
    reset_staged_counts()
    out_err, near_ties, wrong, errors = 0.0, 0, 0, 0
    for i in range(batches):
        xb = xt[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
        out_f = lenet_staged.forward(p_staged, xb).out_f
        pred = lenet_staged.predict(p_staged, xb)
        ref_out = reference.forward(p_staged, xb).out_f
        ref_pred = reference.predict(p_staged, xb)
        out_err = max(out_err, float((out_f - ref_out).abs().max()))
        top2 = torch.topk(ref_out, 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) < TIE_GAP
        near_ties += int(tie.sum())
        wrong += int(((pred != ref_pred) & ~tie).sum())
        errors += int((pred != yt[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]).sum())
    ok = out_err <= OUT_ATOL and wrong == 0
    print(f"[smoke] staged (d): forward + predict over {TEST_COUNT} test images in "
          f"{batches} batches: max |Δout_f| vs reference.forward {out_err:.3e} (tol "
          f"{OUT_ATOL:.0e}), predictions differing outside near-ties {wrong}, "
          f"near-ties (top-two gap < {TIE_GAP:.0e}) {near_ties}; error rate "
          f"{100.0 * errors / TEST_COUNT:.2f}% {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the staged forward or predict disagrees with the plain reference")
    counts = expect_staged_counts(f"{batches} forward + {batches} predict calls",
                                  STAGED_PER_FORWARD, 2 * batches)
    launches = {k: launches[k] + counts[k] for k in launches}
    return errs, launches


def staged_bound_ms(name, args, outs):
    """Least time for one staged kernel call: each input and output tensor
    moved once at the HBM rate against its multiply-adds (2 operations) and
    the sigma' chain's 3 operations per element at the f32 peak (sigma's
    own exp and division not counted)."""
    elems = sum(t.numel() for t in args) + sum(t.numel() for t in outs)
    if name == "conv_fwd":
        ops = 2 * 25 * outs[0].numel()
    elif name == "pool_fwd":
        ops = 2 * 16 * outs[0].numel()
    elif name == "fc_fwd":
        ops = 2 * 216 * outs[0].numel()
    elif name == "fc_bwd":
        n = args[0].shape[0]
        ops = 2 * n * 2160 + n * 10 + 2 * n * 216 * 10
    elif name == "pool_bwd":
        ops = 3 * outs[0].numel() + outs[1].numel()
    elif name == "sigma_prime":
        ops = 3 * outs[0].numel()
    else:  # accum_matmul
        ops = 2 * args[0].shape[0] * args[0].shape[1] * args[1].shape[1]
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = 4.0 * elems / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def fc_bwd_block_operands(d, s, w):
    """A (10+n, n+10) and B (n+10, 217) with A.B = [[dT.s, dT.1], [d.w, 0]]:
    B6's three outputs (gw, gb, dout) from one matmul. A = [[dT, 0], [0, d]],
    B = [[s, 1], [w, 0]]; built once, outside any timing."""
    n = d.shape[0]
    a = d.new_zeros((10 + n, n + 10))
    a[:10, :n] = d.T
    a[10:, n:] = d
    b = d.new_zeros((n + 10, 217))
    b[:n, :216] = s
    b[:n, 216] = 1.0
    b[n:, :216] = w
    return a, b


def staged_library_call(case, args):
    """One PyTorch call computing the same function, where there is one
    (the yardstick; the port never calls it): the preactivation of B3, B4
    and B5 (their sigma aside) as cuDNN's conv with bias and as F.linear,
    B6's three outputs as one matmul of block operands
    (fc_bwd_block_operands), and aT.b as one matmul; else None (B7, B8: no
    one call takes the preact's sigma')."""
    if case == "conv_fwd":
        x, w, b = args
        x4, w4 = x.unsqueeze(1), w.unsqueeze(1)
        return lambda: F.conv2d(x4, w4, b)
    if case == "pool_fwd":
        xw, w, b = args
        xt, w1, b1 = xw.transpose(1, 2), w.reshape(1, 16), b.reshape(1)
        return lambda: F.linear(xt, w1, b1)
    if case == "fc_fwd":
        return lambda: F.linear(*args)
    if case == "fc_bwd":
        a, b = fc_bwd_block_operands(*args)
        return lambda: torch.matmul(a, b)
    if case.startswith("accum_matmul"):
        a, b = args
        return lambda: torch.matmul(a.T, b)
    return None


def conv_wgrad_bound_ms(xs):
    """Least time for conv_wgrad's work from its own inputs, x and
    d_pre_c1 (n,6,24,24), to the (6,5,5) gradient: B9's bound without the
    host-side im2col it is fed through."""
    n = xs.shape[0]
    t_bytes = 4.0 * (n * 784 + n * 3456 + 150) / PEAK_HBM_BYTES * 1e3
    t_ops = 2.0 * n * 576 * 150 / PEAK_F32_FLOPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# These staged kernels (B3, B5, B7 and B8 redesigned, B4 whose redesigns
# lost to it) are timed in turns with their library call (B7 and B8, which
# have none, alone), at batch 64 and at this batch.
STAGED_FWD_LARGE = 1000
STAGED_TIMED = ("conv_fwd", "pool_fwd", "fc_fwd", "pool_bwd", "sigma_prime")
L2_BYTES = 50 * 2**20  # an H100's L2


def l2_cold_note(fn, args, bound) -> str:
    """fn(*args) with the L2 cold, as a note: where two copies of the
    input tensors outgrow the L2 the calls take them in turns, else each
    launch follows a flush (cold_ms)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if 2 * 4 * sum(a.numel() for a in tensors) > L2_BYTES:
        turn = itertools.cycle([args, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                            for a in args)])
        ms, how = cuda_ms(lambda: fn(*next(turn)), reps=200), "two input copies in turns"
    else:
        ms, how = cold_ms(lambda: fn(*args)), "flushed before each launch"
    return f"; L2 cold ({how}) {ms:.5f} ms, {bound / ms:.2%} of bound"


def time_against_library(fn, args, lib) -> tuple:
    """B3, B4 or B5 in turns with its library call, or B7 alone (lib None):
    (kernel ms, library ms or None, a note with their ratio and the CUDA
    launches of one wrapper call)."""
    if lib is None:
        ms, lib_ms, note = cuda_ms(lambda: fn(*args), reps=200), None, ""
    else:
        ms, lib_ms = in_turns(lambda: fn(*args), lib, reps=200)
        note = f"; kernel / library {ms / lib_ms:.3f}x in turns"
    return ms, lib_ms, (f"{note}; {device_launches(lambda: fn(*args))} CUDA launches per "
                        f"wrapper call (torch.profiler)")


def time_staged_kernels() -> dict:
    """(f) Each staged kernel at batch 64 at the path's inputs: device ms
    beside its bound, its plain version and the library call; the
    STAGED_TIMED kernels in turns with their library call (B7 alone), and
    again at batch STAGED_FWD_LARGE. B9's record holds the sums over its
    two call sites in one step, named by the site with the larger bound."""
    params, xs, ys = lenet_inputs(TRAIN_BATCH, 400)
    sites = {}
    for case, (fn, plain, args) in stage_cases(params, xs, ys).items():
        plain_ms = cuda_ms(lambda: plain(*args), reps=50)
        lib = staged_library_call(case, args)
        note = ""
        if case in STAGED_TIMED:
            ms, lib_ms, note = time_against_library(fn, args, lib)
            if case == "sigma_prime":
                note += l2_cold_note(fn, args, staged_bound_ms(case, args, (args[0],))[0])
        elif case == "fc_bwd":
            # B6 against its yardstick in turns; the block product checked
            # against the plain twin first, and dT.s alone as a note.
            ms, lib_ms = in_turns(lambda: fn(*args), lib, reps=200)
            gw, gb, dout = plain(*args)
            ab = lib()
            want = torch.cat([torch.cat([gw, gb[:, None]], 1),
                              torch.cat([dout, torch.zeros_like(dout[:, :1])], 1)])
            if not torch.allclose(ab, want, rtol=LENET_RTOL, atol=LENET_RTOL):
                fail("fc_bwd's block-product yardstick does not compute B6's outputs")
            d, s, _ = args
            note = (f"; dT.s alone (the weight grad only) "
                    f"{cuda_ms(lambda: torch.matmul(d.T, s), reps=200):.5f} ms; "
                    f"kernel / library {ms / lib_ms:.3f}x")
        else:
            ms = cuda_ms(lambda: fn(*args), reps=50)
            lib_ms = cuda_ms(lib, reps=50) if lib is not None else None
        if case.startswith("accum_matmul"):
            note = (f"; {device_launches(lambda: fn(*args))} CUDA launches per "
                    f"wrapper call (torch.profiler)")
        bound, by = staged_bound_ms(case.split("/")[0], args, as_tuple(fn(*args)))
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.5f} ms"
        print(f"[smoke] time staged {case:24s} b{TRAIN_BATCH}: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.4f} ms, library {lib_txt}, bound {bound:.6f} ms "
              f"({by}), {bound / ms:.2%} of bound{note}", flush=True)
        sites.setdefault(case.split("/")[0], []).append(
            dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms))
    n = STAGED_FWD_LARGE
    large = stage_cases(*lenet_inputs(n, 400 + n))
    for case in STAGED_TIMED:
        fn, plain, args = large[case]
        plain_ms = cuda_ms(lambda: plain(*args), reps=50)
        ms, lib_ms, note = time_against_library(fn, args, staged_library_call(case, args))
        bound, by = staged_bound_ms(case, args, as_tuple(fn(*args)))
        if case == "sigma_prime":
            note += l2_cold_note(fn, args, bound)
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.5f} ms"
        print(f"[smoke] time staged {case:24s} b{n}: kernel {ms:.5f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_txt}, bound {bound:.6f} ms ({by}), "
              f"{bound / ms:.2%} of bound{note}", flush=True)
    bound, by = conv_wgrad_bound_ms(xs)
    print(f"[smoke] time staged conv_wgrad from x and d_pre_c1 b{TRAIN_BATCH}: bound "
          f"{bound:.6f} ms ({by}), without the im2col that B9's bound above counts",
          flush=True)
    out = {}
    for key, recs in sites.items():
        libs = [r["library_ms"] for r in recs]
        out[key] = dict(
            ms=sum(r["ms"] for r in recs), plain_ms=sum(r["plain_ms"] for r in recs),
            bound_ms=sum(r["bound_ms"] for r in recs),
            bound_by=max(recs, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=None if None in libs else sum(libs))
    return out


# ---------------------------------------------------------------------------
# The zoo trainer: the tap-conv kernel as dgrad, B11 (tap_wgrad) and B12
# (tail_ce)
# ---------------------------------------------------------------------------


def grad_inputs(h, cin, cout, k, stride, gen, batch=ZOO_BATCH):
    """x, w and an output gradient g for one conv geometry at ``batch``."""
    x = torch.randn((batch, h, h, cin), generator=gen, device="cuda")
    w = torch.randn((k, k, cin, cout), generator=gen, device="cuda")
    w *= (2.0 / (k * k * cin)) ** 0.5
    oh = -(-h // stride)
    g = torch.randn((batch, oh, oh, cout), generator=gen, device="cuda")
    return x, w, g


def tail_inputs(pool, gen):
    """The two fused tails of the zoo at ZOO_BATCH: ResNet-18's gap over
    (4,4,512) and the CIFAR CNN's max2 over (8,8,128), ReLU outputs (half
    the max2 windows tie at zero, as in training)."""
    shape = {"gap": (ZOO_BATCH, 4, 4, 512), "max2": (ZOO_BATCH, 8, 8, 128)}[pool]
    x = torch.relu(torch.randn(shape, generator=gen, device="cuda"))
    d = 512 if pool == "gap" else 4 * 4 * 128
    w = torch.randn((d, 10), generator=gen, device="cuda") * d ** -0.5
    b = 0.1 * torch.randn((10,), generator=gen, device="cuda")
    y = torch.randint(0, 10, (ZOO_BATCH,), generator=gen, device="cuda")
    return x, w, b, y


#: The library resnet50()'s head: gap over 7x7x2,048, 1,000 classes.
IMAGENET_HEAD = (7, 7, 2048, 1000)


def imagenet_head_inputs(batch, dtype, gen):
    """Seeded inputs of the ImageNet head at ``batch`` in ``dtype``: ReLU
    features, w scaled by D^-1/2, labels in [0, 1,000)."""
    h, wd, c, k = IMAGENET_HEAD
    x = torch.relu(torch.randn((batch, h, wd, c), generator=gen, device="cuda"))
    w = torch.randn((c, k), generator=gen, device="cuda") * c ** -0.5
    b = 0.1 * torch.randn((k,), generator=gen, device="cuda")
    y = torch.randint(0, k, (batch,), generator=gen, device="cuda")
    return tuple(t.to(dtype) for t in (x, w, b)) + (y,)


def check_head_rows(dtype, gen) -> None:
    """The ImageNet head's rows in ``dtype`` at b1, b7 and b32, each run of
    images a batch of its own, against the same rows of one b128 call (the
    first, a middle and the last places): bit for bit, as the plan is the
    same at every B."""
    x, w, b, y = imagenet_head_inputs(128, dtype, gen)
    whole = tail.tail_forward(x, w, b, y, "gap")
    spans = ((0, 1), (61, 62), (127, 128), (0, 7), (64, 71), (121, 128), (0, 32), (48, 80),
             (96, 128))
    bad = [f"[{lo}:{hi}]" for lo, hi in spans
           if not all(torch.equal(part, rows[lo:hi]) for part, rows in zip(
               tail.tail_forward(x[lo:hi], w, b, y[lo:hi], "gap"), whole))]
    name = str(dtype).replace("torch.", "")
    print(f"[smoke] tail_ce gap 7x7x2048->1000 {name} rows at b1, b7, b32 against b128 "
          f"({tail.tail_plan('gap', *IMAGENET_HEAD, dtype).form} form): "
          f"{'bit-identical ok' if not bad else 'DIFFER at ' + ', '.join(bad) + ' FAIL'}",
          flush=True)
    if bad:
        fail(f"the {name} ImageNet head's rows depend on the batch they came in")


def within(name, got, want, again, rtol=GRAD_RTOL) -> float:
    """Check a kernel result against its plain version (``rtol`` relative
    to the output's scale, in f32; the dtypes equal) and its relaunch (bit
    for bit); returns the largest difference."""
    err = float((got.float() - want.float()).abs().max())
    tol = rtol * max(1.0, float(want.float().abs().max()))
    same = torch.equal(got, again)
    ok = (got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(got).all()) and err <= tol)
    print(f"[smoke] {name}: max |Δ| vs plain {err:.3e} (tol {tol:.1e}), relaunch "
          f"{'bit-identical' if same else 'DIFFERS'} {'ok' if ok and same else 'FAIL'}",
          flush=True)
    if not (ok and same):
        fail(f"{name}: the kernel disagrees with its plain version or is not "
             "deterministic")
    return err


def check_zoo_kernels() -> dict:
    """K1 (dgrad) and K2 (wgrad) at each ResNet-18 conv geometry and K3 in
    both tails, at batch ZOO_BATCH, against their plain versions (cuDNN
    and TF32 off). Returns the largest difference of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {"tap_conv_dgrad": 0.0, "tap_wgrad": 0.0, "tail_ce": 0.0}
    for name, h, cin, cout, k, s, _, _, _ in GEOMETRIES:
        x, w, g = grad_inputs(h, cin, cout, k, s, gen)
        dx = tap_conv.conv2d_dgrad(g, w, x.shape, s)
        dx2 = tap_conv.conv2d_dgrad(g, w, x.shape, s)
        gw = tap_wgrad.conv2d_wgrad(x, g, k, s)
        gw2 = tap_wgrad.conv2d_wgrad(x, g, k, s)
        with plain_reference():
            dx_ref = tap_conv.conv2d_dgrad_plain(g, w, x.shape, s)
            gw_ref = tap_wgrad.conv2d_wgrad_plain(x, g, k, s)
        torch.cuda.synchronize()
        errs["tap_conv_dgrad"] = max(errs["tap_conv_dgrad"], within(
            f"dgrad {name:24s} b{ZOO_BATCH}", dx, dx_ref, dx2))
        errs["tap_wgrad"] = max(errs["tap_wgrad"], within(
            f"wgrad {name:24s} b{ZOO_BATCH}", gw, gw_ref, gw2))
    for name, b, h, wd, cin, cout, k, s in GRAD_CASES:
        x = torch.randn((b, h, wd, cin), generator=gen, device="cuda")
        w = torch.randn((k, k, cin, cout), generator=gen, device="cuda") * 0.1
        g = torch.randn((b, -(-h // s), -(-wd // s), cout), generator=gen, device="cuda")
        dx = tap_conv.conv2d_dgrad(g, w, x.shape, s)
        dx2 = tap_conv.conv2d_dgrad(g, w, x.shape, s)
        gw = tap_wgrad.conv2d_wgrad(x, g, k, s)
        gw2 = tap_wgrad.conv2d_wgrad(x, g, k, s)
        with plain_reference():
            dx_ref = tap_conv.conv2d_dgrad_plain(g, w, x.shape, s)
            gw_ref = tap_wgrad.conv2d_wgrad_plain(x, g, k, s)
        torch.cuda.synchronize()
        shape = f"b{b} {h}x{wd} {cin}->{cout}"
        errs["tap_conv_dgrad"] = max(errs["tap_conv_dgrad"], within(
            f"dgrad {name:24s} {shape}", dx, dx_ref, dx2))
        errs["tap_wgrad"] = max(errs["tap_wgrad"], within(
            f"wgrad {name:24s} {shape}", gw, gw_ref, gw2))
    for pool in ("gap", "max2"):
        x, w, b, y = tail_inputs(pool, gen)
        shape = "x".join(str(d) for d in x.shape)
        for form, plan in tail_forms(pool, x, w):
            loss, dl = tail.tail_forward(x, w, b, y, pool, plan)
            loss2, dl2 = tail.tail_forward(x, w, b, y, pool, plan)
            ref_loss, ref_dl = tail.tail_forward_plain(x, w, b, y, pool)
            torch.cuda.synchronize()
            tag = f"tail_ce {pool} ({shape})->10 {form} form"
            errs["tail_ce"] = max(errs["tail_ce"],
                                  within(f"{tag} loss", loss, ref_loss, loss2),
                                  within(f"{tag} dlogits", dl, ref_dl, dl2))
    return errs


def tail_forms(pool, x, w):
    """B12's two forms for this head, the plan's own first: (form, plan)."""
    shape = (pool, *x.shape[1:], w.shape[1], x.dtype)
    chosen = tail.tail_plan(*shape)
    return [(chosen.form, chosen)] + [(form, tail.tail_plan(*shape, form=form))
                                      for form in tail.FORMS if form != chosen.form]


def epoch_losses(out):
    return [float(line.split()[3].rstrip(",")) for line in out.splitlines()
            if line.startswith("epoch ") and ": loss " in line]


def zoo_counts():
    return {"tap_conv": tap_conv.launches.count,
            "tap_conv_dgrad": tap_conv.dgrad_launches.count,
            "tap_wgrad": tap_wgrad.launches.count, "tail_ce": tail.launches.count}


def reset_zoo_counts():
    """Every counter of the zoo's kernels, the f32 and the bf16 forms (FFMA
    and tensor-core; the tail's tiled form)."""
    for counter in (tap_conv.launches, tap_conv.dgrad_launches,
                    tap_wgrad.launches, tail.launches, tap_conv.bf16_launches,
                    tap_conv.bf16_dgrad_launches, tap_wgrad.bf16_launches,
                    tail.bf16_launches, tap_conv.wgmma_launches,
                    tap_conv.wgmma_dgrad_launches, tap_wgrad.wgmma_launches,
                    tail.tiled_launches, tail.bf16_tiled_launches):
        counter.reset()


def zoo_phase(card) -> dict:
    """The zoo trainer on the card through its CLI: (a) ResNet-18 on the
    kernels with the fused tail, 2 epochs, exact launch counts and a falling
    loss; (b) a resumed run against the straight one; (c) kernel steps
    against plain steps; (d) the CIFAR CNN's fused tail. Returns each
    kernel's launches on the ResNet-18 run (the main path)."""
    work = BUILD_DIR / "smoke_zoo"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = ["--model", "resnet18", "--conv-backend", "cuda", "--fused-step",
            "--act-dtype", "float32", "--batch-size", str(ZOO_BATCH),
            "--synthetic-train-count", str(ZOO_TRAIN_COUNT),
            "--synthetic-test-count", str(ZOO_TEST_COUNT)]

    # (a) the main path: every counter set to 0 just before, read just after.
    print(f"[smoke] zoo (a): {' '.join(base)} --epochs 2", flush=True)
    reset_zoo_counts()
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(work / "straight"),
                          "--metrics", str(work / "a.jsonl")])
    launches = zoo_counts()
    losses = epoch_losses(out)
    steps = 2 * ZOO_STEPS
    evals = 2 * -(-ZOO_TEST_COUNT // ZOO_EVAL_BATCH)
    want = {"tap_conv": CONVS_PER_FORWARD * (steps + evals),
            "tap_conv_dgrad": (CONVS_PER_FORWARD - 1) * steps,
            "tap_wgrad": CONVS_PER_FORWARD * steps, "tail_ce": steps}
    with open(work / "a.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    rates = [round(ZOO_TRAIN_COUNT / r["seconds"]) for r in recs]
    print(f"[smoke] zoo (a): launches {launches} for {steps} steps and {evals} "
          f"eval batches (expected {want}); epoch losses {losses}; img/s per "
          f"epoch {rates} (host clock, first epoch cold); eval accuracy "
          f"{[r['accuracy'] for r in recs]} on {card}", flush=True)
    if launches != want:
        fail("the ResNet-18 zoo run did not launch each kernel exactly as often "
             "as its steps and eval batches need")
    if len(losses) != 2 or not losses[1] < losses[0]:
        fail("the ResNet-18 zoo run's loss did not fall from epoch 1 to 2")

    # (b) 1 epoch, then --resume to 2: the straight run's state, bit for bit.
    print("[smoke] zoo (b): --epochs 1, then --epochs 2 --resume, vs (a)", flush=True)
    split = work / "split"
    run_cli(base + ["--epochs", "1", "--checkpoint-dir", str(split)])
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(split), "--resume"])
    a = checkpoint_leaves(work / "straight" / "ckpt_2.npz")
    b = checkpoint_leaves(split / "ckpt_2.npz")
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"[smoke] zoo (b): resumed state ({len(a)} leaves: params, BN stats, "
          f"momentum) {'bit-identical to the straight run' if same else 'DIFFERS'}",
          flush=True)
    if "resumed from" not in out or not same:
        fail("the resumed zoo run is not bit-identical to the straight run")

    # (c) 3 kernel steps vs 3 plain steps from one state, at a gentle LR:
    # at init the net amplifies f32 rounding from step to step (f32 against
    # f64 on the CPU, batch 64: 1e-3 in the third loss at lr 0.01, 9e-6 at
    # 0.001).
    imgs, labels = synthetic.make_image_dataset(3 * ZOO_BATCH, seed=11)
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).to("cuda", torch.int64)
    opt = zoo.make_optimizer(ZOO_CHECK_LR)
    kern = resnet.resnet18(10, backend="cuda",
                           generator=torch.Generator().manual_seed(0)).cuda()
    plain = resnet.resnet18(10, backend="torch",
                            generator=torch.Generator().manual_seed(0)).cuda()
    sk, sp = zoo.init_state(kern, opt), zoo.init_state(plain, opt)
    step_k = zoo.make_train_step(kern, opt, fused=ZOO_FUSED)
    step_p = zoo.make_train_step(plain, opt)
    loss_diff = 0.0
    for i in range(3):
        sl = slice(i * ZOO_BATCH, (i + 1) * ZOO_BATCH)
        lk = step_k(sk, xs[sl], ys[sl])
        with plain_reference():
            lp = step_p(sp, xs[sl], ys[sl])
        loss_diff = max(loss_diff, abs(float(lk) - float(lp)))
    pk, pp = kern.state_dict(), plain.state_dict()
    param_diff = max(float((pk[n] - pp[n]).abs().max()) for n, _ in kern.named_parameters())
    stat_diff = max(float((pk[n] - pp[n]).abs().max()) for n, _ in kern.named_buffers())
    ok = loss_diff <= ZOO_LOSS_ATOL and param_diff <= ZOO_PARAM_ATOL
    print(f"[smoke] zoo (c): 3 kernel steps vs 3 plain steps (lr {ZOO_CHECK_LR}, "
          f"b{ZOO_BATCH}): max |Δloss| {loss_diff:.3e} (tol {ZOO_LOSS_ATOL:.0e}), "
          f"max |Δparams| {param_diff:.3e} (tol {ZOO_PARAM_ATOL:.0e}), max |ΔBN "
          f"stats| {stat_diff:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the kernel steps drifted from the plain steps")

    # (d) the CIFAR CNN: library convs, its max2 head through the tail kernel.
    tail.launches.reset()
    out = run_cli(["--model", "cifar_cnn", "--fused-step", "--act-dtype", "float32",
                   "--batch-size", str(ZOO_BATCH), "--lr", "0.01", "--epochs", "1",
                   "--synthetic-train-count", str(ZOO_TRAIN_COUNT),
                   "--synthetic-test-count", str(ZOO_TEST_COUNT)])
    print(f"[smoke] zoo (d): cifar_cnn --fused-step: tail_ce launches "
          f"{tail.launches.count} for {ZOO_STEPS} steps", flush=True)
    if tail.launches.count != ZOO_STEPS or len(epoch_losses(out)) != 1:
        fail("the CIFAR CNN's fused step did not run every step through tail_ce")
    return launches


def profiled_zoo_epoch(label: str, backend: str, mesh=None, build=None,
                       batch: int = ZOO_BATCH, steps: int = ZOO_STEPS, accum: int = 1,
                       fused: FusedStepConfig = ZOO_FUSED):
    """Where a zoo training epoch's time goes: one warm epoch of ``steps``
    steps of ``batch`` (``accum`` microbatches each) on the conv
    ``backend`` (batches gathered on the card, one loss readback) under
    torch.profiler (CUDA activity only), through the GSPMD step on
    ``mesh`` when given, with the fused step ``fused`` (f32 activations by
    default). ``build(backend, generator)`` makes the model, ResNet-18 by
    default. Returns (img/s, device ops a step, idle share, device ms a
    step, its dgrad / wgrad / forward / other ms a step), or None when the
    profiler saw no device events."""
    count = steps * batch
    imgs, labels = synthetic.make_image_dataset(count, seed=1234)
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).to("cuda", torch.int64)
    build = build or (lambda b, g: resnet.resnet18(10, backend=b, generator=g))
    model = build(backend, torch.Generator().manual_seed(0)).cuda()
    state = zoo.init_state(model, zoo.make_optimizer(0.1), mesh=mesh)
    step = zoo.make_train_step(model, state.optimizer, accum, fused=fused, mesh=mesh)

    def epoch():
        perm = torch.randperm(count, generator=torch.Generator().manual_seed(0))
        perm = perm.cuda()
        total = torch.zeros((), device="cuda")
        for i in range(steps):
            j = perm[i * batch:(i + 1) * batch]
            total = total + step(state, xs[j], ys[j])
        return float(total) / steps

    epoch()  # warm: allocator, libraries
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_ops = sum(e.count for e in kernels)
    if dev_ms == 0:
        print("[smoke] profiled zoo epoch: device time not measured (the "
              "profiler saw no device events)", flush=True)
        return None
    print(f"[smoke] profiled zoo epoch ({label}, b{batch}, {steps} steps"
          f"{f', {accum} microbatches a step' if accum > 1 else ''}): "
          f"wall {wall_ms:.1f} ms ({count / wall_ms * 1e3:.0f} img/s), "
          f"device busy {dev_ms:.1f} ms ({dev_ms / wall_ms:.1%}), idle "
          f"{1 - dev_ms / wall_ms:.1%}; {n_ops / steps:.1f} device ops per "
          f"step, {wall_ms / steps:.2f} ms per step", flush=True)
    split = dict.fromkeys(("dgrad", "wgrad", "forward", "other"), 0.0)
    for e in kernels:
        part = ("dgrad" if any(k in e.key for k in ("tap_dgrad_kernel",
                                                    "tap_dgrad_wgmma_kernel")) else
                "wgrad" if any(k in e.key for k in ("wgrad_partial_kernel", "wgrad_sum_kernel",
                                                    "wgrad_wgmma_kernel"))
                else "forward" if any(k in e.key for k in ("tap_conv_kernel",
                                                           "tap_conv_wgmma_kernel"))
                else "other")
        split[part] += e.self_device_time_total / 1e3 / steps
    print("[smoke] profiled zoo epoch device ms per step: " + ", ".join(
        f"{part} {ms:.3f}" for part, ms in split.items()), flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[smoke]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)
    return count / wall_ms * 1e3, n_ops / steps, 1 - dev_ms / wall_ms, dev_ms / steps, split


def profiled_gspmd_epoch_rank(mesh):
    """gspmd (e) on one rank: the profiled epoch through the GSPMD step."""
    return profiled_zoo_epoch("ResNet-18, GSPMD step on a 1x1 mesh, conv kernels + "
                              "fused tail", "cuda", mesh=mesh)


def check_shard_shapes() -> dict:
    """gspmd (c): the model axis's shard shapes on one card. For each M of
    GSPMD_MODEL_SIZES and each ResNet-18 conv at ZOO_BATCH, B10's forward,
    B10's dgrad and B11 launched once a shard, on contiguous shard tensors
    of Cout/M filters (w's columns, and the same columns of the output
    gradient), composed as the collectives compose them: forward and wgrad
    columns concatenated in rank order, the dgrads summed in rank order.
    Each against the plain twins on the whole conv and against the
    unsharded launch, within CONV_RTOL / GRAD_RTOL of the output's scale.
    Returns each kernel's largest difference from its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    errs = dict.fromkeys(("tap_conv", "tap_conv_dgrad", "tap_wgrad"), 0.0)
    rtols = (CONV_RTOL, GRAD_RTOL, GRAD_RTOL)
    for name, h, cin, cout, k, s, _, _, _ in GEOMETRIES:
        x, w, g = grad_inputs(h, cin, cout, k, s, gen)
        with torch.no_grad():
            whole = (tap_conv.conv2d(x, w, s), tap_conv.conv2d_dgrad(g, w, x.shape, s),
                     tap_wgrad.conv2d_wgrad(x, g, k, s))
        with plain_reference():
            plain = (tap_conv.conv2d_plain(x, w, s),
                     tap_conv.conv2d_dgrad_plain(g, w, x.shape, s),
                     tap_wgrad.conv2d_wgrad_plain(x, g, k, s))
        for m_size in GSPMD_MODEL_SIZES:
            c = cout // m_size
            ws = [w[..., i * c:(i + 1) * c].contiguous() for i in range(m_size)]
            gs = [g[..., i * c:(i + 1) * c].contiguous() for i in range(m_size)]
            with torch.no_grad():
                fwd = torch.cat([tap_conv.conv2d(x, wi, s) for wi in ws], dim=-1)
                dx = tap_conv.conv2d_dgrad(gs[0], ws[0], x.shape, s)
                for wi, gi in zip(ws[1:], gs[1:]):
                    dx = dx + tap_conv.conv2d_dgrad(gi, wi, x.shape, s)
                gw = torch.cat([tap_wgrad.conv2d_wgrad(x, gi, k, s) for gi in gs], dim=-1)
            torch.cuda.synchronize()
            parts, ok = [], True
            for key, got, ref, un, rtol in zip(errs, (fwd, dx, gw), plain, whole, rtols):
                err = float((got - ref).abs().max())
                err_un = float((got - un).abs().max())
                tol = rtol * max(1.0, float(ref.abs().max()))
                ok &= (got.shape == ref.shape and bool(torch.isfinite(got).all())
                       and err <= tol and err_un <= tol)
                errs[key] = max(errs[key], err)
                parts.append(f"{key} {err:.2e}/{err_un:.2e} (tol {tol:.1e})")
            print(f"[smoke] gspmd (c) {name:24s} M={m_size} ({c} filters a shard): "
                  f"|Δ| vs plain/unsharded {', '.join(parts)} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"{name}: the kernels at the M={m_size} shard shapes, composed, "
                     "disagree with the plain twins or the unsharded launch")
    return errs


def gspmd_phase(card, zoo_launches) -> tuple:
    """The GSPMD zoo path on the card (a 1x1 mesh; more ranks need more
    cards): (a) the CLI at --mesh-data 1, zoo (a)'s cut, its exact launch
    counts and a falling loss; (b) 3 GSPMD steps against 3 single-device
    steps, and the CIFAR CNN's tail; (c) the model axis's shard shapes;
    (d) a resumed run against the straight one. Returns each kernel's
    launches on (a) and the largest differences of (c)."""
    work = BUILD_DIR / "smoke_gspmd"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = ["--model", "resnet18", "--conv-backend", "cuda", "--fused-step",
            "--act-dtype", "float32", "--mesh-data", "1", "--batch-size", str(ZOO_BATCH),
            "--synthetic-train-count", str(ZOO_TRAIN_COUNT),
            "--synthetic-test-count", str(ZOO_TEST_COUNT)]

    # (a) the main path: every counter set to 0 just before, read just after.
    print(f"[smoke] gspmd (a): {' '.join(base)} --epochs 2", flush=True)
    reset_zoo_counts()
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(work / "straight"),
                          "--metrics", str(work / "a.jsonl")])
    launches = zoo_counts()
    losses = epoch_losses(out)
    with open(work / "a.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    rates = [round(ZOO_TRAIN_COUNT / r["seconds"]) for r in recs]
    print(f"[smoke] gspmd (a): launches {launches} (expected zoo (a)'s {zoo_launches}); "
          f"epoch losses {losses}; img/s per epoch {rates} (host clock, first epoch "
          f"cold); eval accuracy {[r['accuracy'] for r in recs]} on {card}", flush=True)
    if launches != zoo_launches:
        fail("the GSPMD run did not launch each kernel exactly as often as zoo (a)")
    if "mesh: {'data': 1, 'model': 1}" not in out:
        fail("the --mesh-data 1 run did not print its mesh")
    if len(losses) != 2 or not losses[1] < losses[0]:
        fail("the GSPMD run's loss did not fall from epoch 1 to 2")

    # (b) 3 steps each from one init at zoo (c)'s gentle LR.
    gspmd_losses, gspmd_sd = distributed.run(dp_step_rank, 1, device="cuda",
                                             args=("gspmd", 3, ZOO_CHECK_LR))[0]
    ref_losses, ref_sd = distributed.run(dp_step_rank, 1, device="cuda",
                                         args=("optax", 3, ZOO_CHECK_LR))[0]
    names = [n for n, _ in resnet.resnet18(10, backend="torch").named_parameters()]
    loss_diff = max(abs(a - b) for a, b in zip(gspmd_losses, ref_losses))
    param_diff = max(float((gspmd_sd[n] - ref_sd[n]).abs().max()) for n in names)
    stat_diff = max(float((gspmd_sd[k] - ref_sd[k]).abs().max())
                    for k in gspmd_sd if k not in names)
    ok = loss_diff <= ZOO_LOSS_ATOL and param_diff <= ZOO_PARAM_ATOL
    print(f"[smoke] gspmd (b): 3 GSPMD steps vs 3 single-device steps (lr "
          f"{ZOO_CHECK_LR}, b{ZOO_BATCH}, the kernels and the fused tail): max |Δloss| "
          f"{loss_diff:.3e} (tol {ZOO_LOSS_ATOL:.0e}), max |Δparams| {param_diff:.3e} "
          f"(tol {ZOO_PARAM_ATOL:.0e}), max |ΔBN stats| {stat_diff:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the GSPMD steps drifted from the single-device steps")
    tail.launches.reset()
    out = run_cli(["--model", "cifar_cnn", "--mesh-data", "1", "--fused-step",
                   "--act-dtype", "float32", "--batch-size", str(ZOO_BATCH), "--lr",
                   "0.01", "--epochs", "1", "--synthetic-train-count", str(ZOO_TRAIN_COUNT),
                   "--synthetic-test-count", str(ZOO_TEST_COUNT)])
    print(f"[smoke] gspmd (b): cifar_cnn --mesh-data 1 --fused-step: tail_ce (max2) "
          f"launches {tail.launches.count} for {ZOO_STEPS} steps", flush=True)
    if tail.launches.count != ZOO_STEPS or len(epoch_losses(out)) != 1:
        fail("the CIFAR CNN's GSPMD step did not run every step through tail_ce")

    # (c) the model axis's shard shapes.
    shard_errs = check_shard_shapes()

    # (d) 1 epoch, then --resume to 2: the straight run's state, bit for bit.
    print("[smoke] gspmd (d): --epochs 1, then --epochs 2 --resume, vs (a)", flush=True)
    split = work / "split"
    run_cli(base + ["--epochs", "1", "--checkpoint-dir", str(split)])
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(split), "--resume"])
    a = checkpoint_leaves(work / "straight" / "ckpt_2.npz")
    b = checkpoint_leaves(split / "ckpt_2.npz")
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"[smoke] gspmd (d): resumed state ({len(a)} leaves) "
          f"{'bit-identical to the straight run' if same else 'DIFFERS'}", flush=True)
    if "resumed from" not in out or not same:
        fail("the resumed GSPMD run is not bit-identical to the straight run")
    return launches, shard_errs


def grad_bound_ms(x_shape, k, cin, cout, stride, dgrad):
    """Least time for one conv gradient on this card: the conv's
    multiply-adds at the f32 peak against its bytes at the HBM rate. dgrad
    reads g and w and writes dx in full; wgrad reads the input pixels the
    conv uses and g, and writes gw."""
    n, h, wd, _ = x_shape
    oh, ow = -(-h // stride), -(-wd // stride)
    flops = 2.0 * n * oh * ow * cout * k * k * cin
    g_elems = n * oh * ow * cout
    w_elems = k * k * cin * cout
    if dgrad:
        elems = g_elems + w_elems + n * h * wd * cin
    else:
        elems = (n * lines_read(h, k, stride) * lines_read(wd, k, stride) * cin
                 + g_elems + w_elems)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = 4.0 * elems / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_grad(x, w, g, stride, dgrad):
    """cuDNN's conv gradient (torch.nn.grad, TF32 off) on the SAME-padded
    channels-last input, padded outside the timing: the yardstick. The port
    never calls it."""
    k = w.shape[0]
    h = x.shape[1]
    _, pt, pb = tap_conv.same_pads(h, k, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (pt, pb, pt, pb)).contiguous(
        memory_format=torch.channels_last)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    gl = g.permute(0, 3, 1, 2)
    if dgrad:
        return lambda: torch.nn.grad.conv2d_input(xp.shape, wl, gl, stride=stride)
    return lambda: torch.nn.grad.conv2d_weight(xp, wl.shape, gl, stride=stride)


def tail_bound_ms(x, w):
    """K3: read x, w, b and the labels, write loss and dlogits, each once;
    2·B·D·K operations for the FC."""
    n = x.shape[0]
    k = w.shape[1]
    nbytes = 4.0 * (x.numel() + w.numel() + k + n + n * k) + 8.0 * n
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 2.0 * n * w.shape[0] * k / PEAK_F32_FLOPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_zoo_kernels() -> dict:
    """K1 and K2 at each ResNet-18 geometry and K3 in both tails, batch
    ZOO_BATCH: device ms beside the bound, the plain version and the
    library call. K1/K2 records hold the sums over one step's convs (19
    dgrads, 20 wgrads); K3's the ResNet-18 gap tail."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    sums = {key: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "ops_ms": 0.0} for key in ("tap_conv_dgrad", "tap_wgrad")}
    heads, s1_shares = [], []
    for name, h, cin, cout, k, s, _, _, count in GEOMETRIES:
        x, w, g = grad_inputs(h, cin, cout, k, s, gen)
        for key, dgrad in (("tap_conv_dgrad", True), ("tap_wgrad", False)):
            if dgrad:
                fn = lambda: tap_conv.conv2d_dgrad(g, w, x.shape, s)  # noqa: E731
                plain_fn = lambda: tap_conv.conv2d_dgrad_plain(g, w, x.shape, s)  # noqa: E731
            else:
                fn = lambda: tap_wgrad.conv2d_wgrad(x, g, k, s)  # noqa: E731
                plain_fn = lambda: tap_wgrad.conv2d_wgrad_plain(x, g, k, s)  # noqa: E731
            ms = cuda_ms(fn, reps=10)
            with plain_reference():
                plain = cuda_ms(plain_fn, reps=5)
            lib = cuda_ms(library_grad(x, w, g, s, dgrad), reps=10)
            bound, by = grad_bound_ms(x.shape, k, cin, cout, s, dgrad)
            print(f"[smoke] time {key:14s} {name:24s} b{ZOO_BATCH}: kernel {ms:.4f} "
                  f"ms, plain {plain:.4f} ms, library {lib:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}), {bound / ms:.1%} of bound", flush=True)
            if k == 3 and s == 2 and dgrad:
                heads.append(ms)
            if k == 3 and s == 1 and not name.startswith("stem"):
                s1_shares.append(bound / ms)
            # The stem's input batch needs no gradient: no dgrad there.
            n = count - (1 if dgrad and name.startswith("stem") else 0)
            rec = sums[key]
            for field, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                             ("bound_ms", bound)):
                rec[field] += n * v
            if by == "operations":
                rec["ops_ms"] += n * bound
    out = {}
    for key, rec in sums.items():
        out[key] = dict(ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                        bound_by=("operations" if rec["ops_ms"] >= rec["bound_ms"] / 2
                                  else "bytes"),
                        library_ms=rec["library_ms"])
        print(f"[smoke] time {key} summed over one ResNet-18 step at b{ZOO_BATCH}: "
              f"kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, library "
              f"{rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms", flush=True)
    # What f32 FFMA reaches on this card through one library call: cuBLAS's
    # f32 GEMM (TF32 off) on a large square product, against the same peak.
    a = torch.randn((GEMM_SIZE, GEMM_SIZE), generator=gen, device="cuda")
    b = torch.randn((GEMM_SIZE, GEMM_SIZE), generator=gen, device="cuda")
    ms = cuda_ms(lambda: a @ b, reps=3, warmup=1)
    rate = 2.0 * GEMM_SIZE ** 3 / ms * 1e3
    print(f"[smoke] time f32 GEMM yardstick {GEMM_SIZE}^3 (torch.matmul, TF32 off): "
          f"{ms:.3f} ms, {rate / 1e12:.1f} TFLOP/s, {rate / PEAK_F32_FLOPS:.1%} of the "
          f"f32 peak", flush=True)
    del a, b
    met = (sums["tap_conv_dgrad"]["ms"] <= TARGET_DGRAD_MS
           and sums["tap_wgrad"]["ms"] <= TARGET_WGRAD_MS
           and max(heads) <= TARGET_HEAD_MS and min(s1_shares) >= TARGET_S1_SHARE)
    print(f"[smoke] time grad targets at b{ZOO_BATCH}: dgrad {sums['tap_conv_dgrad']['ms']:.3f} "
          f"ms (target <= {TARGET_DGRAD_MS}), wgrad {sums['tap_wgrad']['ms']:.3f} ms "
          f"(<= {TARGET_WGRAD_MS}), slowest 3x3/s2 dgrad head {max(heads):.4f} ms "
          f"(<= {TARGET_HEAD_MS}), lowest 3x3/s1 share of the f32 bound "
          f"{min(s1_shares):.1%} (>= {TARGET_S1_SHARE:.0%}): "
          f"{'all met' if met else 'NOT all met'}", flush=True)
    for pool in ("gap", "max2"):
        args = tail_inputs(pool, gen)
        fn = lambda x, w, b, y: tail.tail_forward(x, w, b, y, pool)  # noqa: E731
        (form, plan), (other, other_plan) = tail_forms(pool, *args[:2])
        ms, other_ms = in_turns(lambda: tail.tail_forward(*args, pool, plan),
                                lambda: tail.tail_forward(*args, pool, other_plan), reps=200)
        plain = cuda_ms(lambda: tail.tail_forward_plain(*args, pool), reps=20)
        bound, by = tail_bound_ms(*args[:2])
        note = l2_cold_note(fn, args, bound)
        print(f"[smoke] time tail_ce {pool} b{ZOO_BATCH}: kernel ({form} form, the plan's) "
              f"{ms:.5f} ms, {other} form {other_ms:.5f} ms in turns, plain "
              f"{plain:.4f} ms, library none, bound {bound:.6f} ms ({by}), "
              f"{bound / ms:.1%} of bound{note}; {device_launches(lambda: fn(*args))} CUDA "
              "launches per wrapper call (torch.profiler)", flush=True)
        if pool == "gap":
            out["tail_ce"] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                                  library_ms=None)
    return out


# ---------------------------------------------------------------------------
# The data-parallel zoo path: update-on-arrival through B13 (sgd_momentum)
# ---------------------------------------------------------------------------


def resnet18_bucket_sizes():
    """ResNet-18's bucket plan (JAX's order, 4 MiB buckets) over DP_WORLD."""
    model = resnet.resnet18(10, backend="torch")
    params = [p for _, p in zoo.jax_ordered_params(model)]
    return collectives.plan_buckets(params, DP_COMM.bucket_bytes,
                                    shards=DP_WORLD).bucket_sizes


def momentum_inputs(n, gen):
    return [torch.randn(n, generator=gen, device="cuda") for _ in range(3)]


def check_sgd_momentum(bucket_sizes) -> float:
    """(a) B13 vs its plain version at odd sizes, each alone, and over
    ResNet-18's bucket sizes as the step calls it, one list in one launch:
    both outputs of every bucket bit-identical, and a relaunch too. The
    scale is a device scalar, as the step passes it."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    scale = torch.tensor(1.0 / 3.0, device="cuda")
    cases = [[n] for n in DP_MOMENTUM_ODD_SIZES] + [list(bucket_sizes)]
    for sizes in cases:
        ps, ms, gs = zip(*(momentum_inputs(n, gen) for n in sizes))
        got = sgd_update.fused_sgd_momentum_buckets(ps, ms, gs, lr=DP_LR,
                                                    momentum=DP_MOMENTUM, scale=scale)
        again = sgd_update.fused_sgd_momentum_buckets(ps, ms, gs, lr=DP_LR,
                                                      momentum=DP_MOMENTUM, scale=scale)
        want = [sgd_update.fused_sgd_momentum_plain(p, m, g, DP_LR, DP_MOMENTUM, scale)
                for p, m, g in zip(ps, ms, gs)]
        torch.cuda.synchronize()
        for i, n in enumerate(sizes):
            same = all(torch.equal(got[k][i], want[i][k]) for k in range(2))
            stable = all(torch.equal(got[k][i], again[k][i]) for k in range(2))
            where = f"bucket {i} of {len(sizes)}, n={n}" if len(sizes) > 1 else f"n={n}"
            print(f"[smoke] dp (a) sgd_momentum {where:<28s}: "
                  f"{'bit-identical to plain' if same else 'DIFFERS from plain'}, "
                  f"relaunch {'bit-identical' if stable else 'DIFFERS'} "
                  f"{'ok' if same and stable else 'FAIL'}", flush=True)
            if not (same and stable):
                errs = [float((got[k][i] - want[i][k]).abs().max()) for k in range(2)]
                fail(f"sgd_momentum {where}: max |Δ| (p', m') {errs} vs plain")
    return 0.0


def dp_step_rank(mesh, kind, steps, lr):
    """On one rank: ResNet-18 (seed 0, the card's kernels or its plain
    convs) through ``steps`` steps of the update-on-arrival step
    ("fused"), the unfused psum step ("psum") or the single-device optax
    step ("optax", "optax_plain") or the GSPMD step on the rank's
    mesh ("gspmd", the fused tail); returns (losses, state_dict on the
    host). The batches are the synthetic set's first steps × 128."""
    imgs, labels = synthetic.make_image_dataset(steps * ZOO_BATCH, seed=11)
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).to("cuda", torch.int64)
    backend = "torch" if kind == "optax_plain" else "cuda"
    model = resnet.resnet18(10, backend=backend,
                            generator=torch.Generator().manual_seed(0)).cuda()
    opt = zoo.make_optimizer(lr, DP_MOMENTUM)
    # The optax-path steps: the same fused tail on the kernels; zoo (c)'s
    # plain step (no fused tail) on plain convs.
    fused = None if kind == "optax_plain" else dataclasses.replace(DP_FUSED, update=False)
    if kind == "fused":
        state, _ = zoo.init_fused_state(model, opt, mesh=mesh, fused=DP_FUSED,
                                        bucket_bytes=DP_COMM.bucket_bytes)
        step = zoo.make_fused_train_step(model, lr=lr, momentum=DP_MOMENTUM,
                                         accum_steps=1, mesh=mesh, augment_pad=None,
                                         comm=DP_COMM, fused=DP_FUSED)
    elif kind == "psum":
        state = zoo.init_state(model, opt)
        step = zoo.make_train_step(model, opt, fused=fused, mesh=mesh,
                                   comm=CommConfig(impl="psum"))
    elif kind == "gspmd":
        state = zoo.init_state(model, opt, mesh=mesh)
        step = zoo.make_train_step(model, opt, fused=fused, mesh=mesh)
    else:
        state = zoo.init_state(model, opt)
        step = zoo.make_train_step(model, opt, fused=fused)
    losses = []
    for i in range(steps):
        sl = slice(i * ZOO_BATCH, (i + 1) * ZOO_BATCH)
        if kind == "optax_plain":
            with plain_reference():
                losses.append(float(step(state, xs[sl], ys[sl])))
        else:
            losses.append(float(step(state, xs[sl], ys[sl])))
    return losses, {k: v.cpu() for k, v in model.state_dict().items()}


def dp_phase(card, zoo_launches) -> dict:
    """The data-parallel zoo path on the card: (b) the CLI at --mesh-data 1
    with update-on-arrival over the ring, exact launch counts beside zoo
    (a)'s and a falling loss; (c) 3 update-on-arrival steps against 3
    optax-path steps (the same kernels, then plain convs) and the psum
    step against the ring; (d) a resumed run against the straight one.
    Returns each kernel's launches on the main path (b)."""
    work = BUILD_DIR / "smoke_dp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = ["--model", "resnet18", "--conv-backend", "cuda", "--fused-step",
            "--act-dtype", "float32", "--mesh-data", str(DP_WORLD),
            "--comm-impl", "ring", "--batch-size", str(ZOO_BATCH),
            "--synthetic-train-count", str(ZOO_TRAIN_COUNT),
            "--synthetic-test-count", str(ZOO_TEST_COUNT)]
    n_buckets = len(resnet18_bucket_sizes())

    # (b) the main path: every counter set to 0 just before, read just after.
    print(f"[smoke] dp (b): {' '.join(base)} --epochs 2", flush=True)
    reset_zoo_counts()
    sgd_update.momentum_launches.reset()
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(work / "straight"),
                          "--metrics", str(work / "b.jsonl")])
    launches = dict(zoo_counts(), sgd_momentum=sgd_update.momentum_launches.count)
    losses = epoch_losses(out)
    steps = 2 * ZOO_STEPS
    want = dict(zoo_launches, sgd_momentum=steps)
    with open(work / "b.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    rates = [round(ZOO_TRAIN_COUNT / r["seconds"]) for r in recs]
    print(f"[smoke] dp (b): launches {launches} for {steps} steps (expected "
          f"{want}: zoo (a)'s counts and one launch over {n_buckets} buckets a "
          f"step); "
          f"epoch losses {losses}; img/s per epoch {rates} (host clock, first "
          f"epoch cold); eval accuracy {[r['accuracy'] for r in recs]} on {card}",
          flush=True)
    if launches != want:
        fail("the update-on-arrival run did not launch each kernel exactly as "
             "often as its steps, buckets and eval batches need")
    if "falling back" in out or f"mesh: {{'data': {DP_WORLD}, 'model': 1}}" not in out:
        fail("the --mesh-data run did not take the update-on-arrival path")
    if len(losses) != 2 or not losses[1] < losses[0]:
        fail("the update-on-arrival run's loss did not fall from epoch 1 to 2")

    # (c) 3 steps each from one init at zoo (c)'s gentle LR.
    runs = {kind: distributed.run(dp_step_rank, DP_WORLD, device="cuda",
                                  args=(kind, 3, ZOO_CHECK_LR))[0]
            for kind in ("fused", "optax", "optax_plain", "psum")}
    fused_losses, fused_sd = runs["fused"]
    names = [n for n, _ in resnet.resnet18(10, backend="torch").named_parameters()]
    for ref in ("optax", "optax_plain", "psum"):
        ref_losses, ref_sd = runs[ref]
        loss_diff = max(abs(a - b) for a, b in zip(fused_losses, ref_losses))
        param_diff = max(float((fused_sd[n] - ref_sd[n]).abs().max()) for n in names)
        stat_diff = max(float((fused_sd[k] - ref_sd[k]).abs().max())
                        for k in fused_sd if k not in names)
        ok = loss_diff <= ZOO_LOSS_ATOL and param_diff <= ZOO_PARAM_ATOL
        print(f"[smoke] dp (c): 3 update-on-arrival steps vs 3 {ref} steps (lr "
              f"{ZOO_CHECK_LR}, b{ZOO_BATCH}): max |Δloss| {loss_diff:.3e} (tol "
              f"{ZOO_LOSS_ATOL:.0e}), max |Δparams| {param_diff:.3e} (tol "
              f"{ZOO_PARAM_ATOL:.0e}), max |ΔBN stats| {stat_diff:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the update-on-arrival steps drifted from the {ref} steps")

    # (d) 1 epoch, then --resume to 2: the straight run's state, bit for bit.
    print("[smoke] dp (d): --epochs 1, then --epochs 2 --resume, vs (b)", flush=True)
    split = work / "split"
    run_cli(base + ["--epochs", "1", "--checkpoint-dir", str(split)])
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(split), "--resume"])
    a = checkpoint_leaves(work / "straight" / "ckpt_2.npz")
    b = checkpoint_leaves(split / "ckpt_2.npz")
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    mom = [k for k in a if k.startswith(zoo.MOM_KEY)]
    print(f"[smoke] dp (d): resumed state ({len(a)} leaves: params, BN stats, "
          f"{len(mom)} momentum blocks, loss-scale state) "
          f"{'bit-identical to the straight run' if same else 'DIFFERS'}", flush=True)
    if "resumed from" not in out or not same or len(mom) != n_buckets:
        fail("the resumed update-on-arrival run is not bit-identical to the "
             "straight run")
    return launches


def zero_level_state(model, mesh, fused, lr):
    """The update-on-arrival state and step of ``fused.zero`` (2 or 3) for
    ``model`` on ``mesh`` over the ring, one microbatch a step."""
    opt = zoo.make_optimizer(lr, DP_MOMENTUM)
    kw = dict(lr=lr, momentum=DP_MOMENTUM, accum_steps=1, mesh=mesh,
              augment_pad=None, comm=DP_COMM, fused=fused)
    if fused.zero == 3:
        state, plan = zoo.init_zero3_state(model, opt, mesh=mesh, fused=fused,
                                           bucket_bytes=DP_COMM.bucket_bytes)
        return state, zoo.make_zero3_train_step(model, plan=plan, **kw)
    state, _ = zoo.init_fused_state(model, opt, mesh=mesh, fused=fused,
                                    bucket_bytes=DP_COMM.bucket_bytes)
    return state, zoo.make_fused_train_step(model, **kw)


def zero3_step_rank(mesh, fused, steps, lr):
    """On one rank: ResNet-18 (seed 0, the card's kernels) through ``steps``
    steps of the update-on-arrival step at ``fused.zero``; returns (losses,
    {key: tensor on the host}): the params and BN statistics under the
    full view's keys (a ZeRO-3 state's gathered from its rows), and the
    momentum rows."""
    imgs, labels = synthetic.make_image_dataset(steps * ZOO_BATCH, seed=11)
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).to("cuda", torch.int64)
    model = resnet.resnet18(10, backend="cuda",
                            generator=torch.Generator().manual_seed(0)).cuda()
    state, step = zero_level_state(model, mesh, fused, lr)
    losses = [float(step(state, xs[i * ZOO_BATCH:(i + 1) * ZOO_BATCH],
                         ys[i * ZOO_BATCH:(i + 1) * ZOO_BATCH]))
              for i in range(steps)]
    if fused.zero == 3:
        out = {k: v for k, v in zoo.zero3_full_view(state).items() if "/" in k
               and not k.startswith("mom/")}
    else:
        buffers = {n for n, _ in model.named_buffers()}
        out = {("model_state/" if k in buffers else "params/") + k.replace(".", "/"): v
               for k, v in model.state_dict().items()}
    out.update({f"mom_row/{b}": row for b, row in enumerate(state.fused.mom)})
    return losses, {k: v.detach().cpu() for k, v in out.items()}


def zero3_phase(card, zoo_launches) -> dict:
    """ZeRO-3 on the card at world 1: (a) the CLI with ZERO3_ENV over the
    ring, exact launch counts beside zoo (a)'s and one B13 launch
    a step, a falling loss, the checkpoint's zero3 marker; (b) 3 ZeRO-3
    steps against 3 ZeRO-2 steps from one init, f32 and bf16; (c) a
    resumed run through restore_sharded against the straight one. Returns
    each kernel's launches on the main path (a)."""
    work = BUILD_DIR / "smoke_zero3"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = ["--model", "resnet18", "--conv-backend", "cuda", "--fused-step",
            "--act-dtype", "float32", "--mesh-data", str(DP_WORLD),
            "--comm-impl", "ring", "--batch-size", str(ZOO_BATCH),
            "--synthetic-train-count", str(ZOO_TRAIN_COUNT),
            "--synthetic-test-count", str(ZOO_TEST_COUNT)]
    env = mock.patch.dict(os.environ, ZERO3_ENV)
    n_buckets = len(resnet18_bucket_sizes())

    # (a) the main path: every counter set to 0 just before, read just after.
    print(f"[smoke] zero3 (a): {ZERO3_SH} {' '.join(base)} --epochs 2",
          flush=True)
    reset_zoo_counts()
    sgd_update.momentum_launches.reset()
    with env:
        out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(work / "straight"),
                              "--metrics", str(work / "a.jsonl")])
    launches = dict(zoo_counts(), sgd_momentum=sgd_update.momentum_launches.count)
    losses = epoch_losses(out)
    steps = 2 * ZOO_STEPS
    want = dict(zoo_launches, sgd_momentum=steps)
    with open(work / "a.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    rates = [round(ZOO_TRAIN_COUNT / r["seconds"]) for r in recs]
    meta = checkpoint_meta(work / "straight" / "ckpt_2.npz")
    print(f"[smoke] zero3 (a): launches {launches} for {steps} steps (expected "
          f"{want}: zoo (a)'s counts and one launch over {n_buckets} resident rows "
          f"a step); epoch losses {losses}; img/s per epoch {rates} (host clock, "
          f"first epoch cold); eval accuracy {[r['accuracy'] for r in recs]}; "
          f"checkpoint zero3 marker {meta.get('zero3')} on {card}", flush=True)
    if launches != want:
        fail("the ZeRO-3 run did not launch each kernel exactly as often as its "
             "steps, buckets and eval batches need")
    if "falling back" in out or f"mesh: {{'data': {DP_WORLD}, 'model': 1}}" not in out:
        fail("the ZeRO-3 run did not take the update-on-arrival path")
    if len(losses) != 2 or not losses[1] < losses[0]:
        fail("the ZeRO-3 run's loss did not fall from epoch 1 to 2")
    if meta.get("zero3") != {"world_size": DP_WORLD,
                             "bucket_bytes": DP_COMM.bucket_bytes, "rank": 0}:
        fail("the ZeRO-3 checkpoint does not carry the zero3 marker")

    # (b) 3 steps each from one init at zoo (c)'s gentle LR, f32 and bf16.
    for act in ("float32", "bfloat16"):
        runs = {zero: distributed.run(zero3_step_rank, DP_WORLD, device="cuda", args=(
                    dataclasses.replace(DP_FUSED, act_dtype=act, zero=zero),
                    Z3_STEPS, ZOO_CHECK_LR))[0] for zero in (3, 2)}
        (l3, s3), (l2, s2) = runs[3], runs[2]
        same = (l3 == l2 and sorted(s3) == sorted(s2)
                and all(torch.equal(s3[k], s2[k]) for k in s2))
        loss_diff = max(abs(a - b) for a, b in zip(l3, l2))
        diff = {tree: max(float((s3[k] - s2[k]).abs().max()) for k in s2
                          if k.startswith(tree))
                for tree in ("params/", "model_state/", "mom_row/")}
        ok = same or (loss_diff <= ZOO_LOSS_ATOL and diff["params/"] <= ZOO_PARAM_ATOL)
        print(f"[smoke] zero3 (b) {act}: {Z3_STEPS} ZeRO-3 steps vs {Z3_STEPS} ZeRO-2 "
              f"steps (lr {ZOO_CHECK_LR}, b{ZOO_BATCH}, world {DP_WORLD}): "
              f"{'bit-identical (losses, params, BN stats, momentum rows)' if same else 'NOT bit-identical'}"
              f"; max |Δloss| {loss_diff:.3e}, max |Δparams| {diff['params/']:.3e}, "
              f"max |ΔBN stats| {diff['model_state/']:.3e}, max |Δmomentum| "
              f"{diff['mom_row/']:.3e} (zoo (c)'s bounds {ZOO_LOSS_ATOL:.0e} / "
              f"{ZOO_PARAM_ATOL:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the ZeRO-3 steps drifted from the ZeRO-2 steps ({act})")

    # (c) 1 epoch, then --resume to 2: the straight run's file, bit for bit.
    print("[smoke] zero3 (c): --epochs 1, then --epochs 2 --resume, vs (a)", flush=True)
    split = work / "split"
    with env:
        run_cli(base + ["--epochs", "1", "--checkpoint-dir", str(split)])
        out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(split), "--resume"])
    a = checkpoint_leaves(work / "straight" / "ckpt_2.npz")
    b = checkpoint_leaves(split / "ckpt_2.npz")
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    mom = [k for k in a if k.startswith("mom/")]
    print(f"[smoke] zero3 (c): resumed full view ({len(a)} leaves: params, BN stats, "
          f"{len(mom)} momentum leaves, loss-scale state) "
          f"{'bit-identical to the straight run' if same else 'DIFFERS'}", flush=True)
    if "resumed from" not in out or not same or not mom:
        fail("the resumed ZeRO-3 run is not bit-identical to the straight run")
    return launches


def plan_phase(card) -> dict:
    """The ExecutionPlan on the card, ResNet-18 b128 f32 ZeRO-3 at world 1:
    (a) ``plan show --save`` (host only), then one epoch by the flags and
    one by ``--plan`` alone: every checkpoint array bit-identical, both
    stamped with the fingerprint ``plan show`` printed, launches equal and
    exact (20/19/20/1/1 a step, 20 an eval batch); (b) the plan run's file
    resumed with ``--accum-steps 2`` exits non-zero with the
    PlanMismatchError text (both fingerprints, ``--replan``), and with
    ``--replan`` resumes, finishes the epoch with a finite loss and one B13
    launch a step. Returns the kernels' launches over its three runs."""
    work = BUILD_DIR / "smoke_plan"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data = ["--model", "resnet18", "--conv-backend", "cuda", "--batch-size",
            str(ZOO_BATCH), "--synthetic-train-count", str(ZOO_TRAIN_COUNT),
            "--synthetic-test-count", str(ZOO_TEST_COUNT)]
    knobs = ["--fused-step", "--act-dtype", "float32", "--mesh-data", str(DP_WORLD),
             "--comm-impl", "ring"]
    plan_file = work / "p.json"
    env = mock.patch.dict(os.environ, ZERO3_ENV)
    print(f"[smoke] plan (a): {ZERO3_SH} plan show {' '.join(data + knobs)} "
          f"--save {plan_file}", flush=True)
    with env:
        out = run_cli(["plan", "show", *data, *knobs, "--save", str(plan_file)])
    shown = out.split("fingerprint: ")[1].split()[0]
    saved = plan_lib.load_plan(plan_file)
    if saved.fingerprint() != shown or saved.zero != 3:
        fail("plan show did not save the ZeRO-3 plan it printed")
    evals = -(-ZOO_TEST_COUNT // ZOO_EVAL_BATCH)
    want = {"tap_conv": CONVS_PER_FORWARD * (ZOO_STEPS + evals),
            "tap_conv_dgrad": (CONVS_PER_FORWARD - 1) * ZOO_STEPS,
            "tap_wgrad": CONVS_PER_FORWARD * ZOO_STEPS, "tail_ce": ZOO_STEPS,
            "sgd_momentum": ZOO_STEPS}
    runs, total = {}, dict.fromkeys(want, 0)
    for label, argv, ctx in (("flags", data + knobs, env),
                             ("plan", data + ["--plan", str(plan_file)],
                              contextlib.nullcontext())):
        # Each run is a main path: its counters set to 0 just before it.
        reset_zoo_counts()
        sgd_update.momentum_launches.reset()
        with ctx:
            out = run_cli(argv + ["--epochs", "1", "--checkpoint-dir", str(work / label)])
        launches = dict(zoo_counts(), sgd_momentum=sgd_update.momentum_launches.count)
        total = {k: total[k] + launches[k] for k in total}
        runs[label] = (launches, epoch_losses(out), work / label / "ckpt_1.npz")
        seconds = [line.rsplit("(", 1)[1].rstrip("s)") for line in out.splitlines()
                   if line.startswith("epoch ")]
        print(f"[smoke] plan (a) by {label}: launches {launches} (expected {want}), "
              f"epoch loss {runs[label][1]} in {seconds} s (host clock), checkpoint "
              f"plan {checkpoint_meta(runs[label][2]).get('plan')}", flush=True)
    a, b = (checkpoint_leaves(runs[k][2]) for k in ("flags", "plan"))
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    stamps = {checkpoint_meta(runs[k][2]).get("plan") for k in runs}
    print(f"[smoke] plan (a): --plan run vs flag run: {len(a)} checkpoint leaves "
          f"{'bit-identical' if same else 'DIFFER'}; stamps {sorted(stamps)} vs plan "
          f"show's {shown}; launches equal "
          f"{runs['flags'][0] == runs['plan'][0]} on {card}", flush=True)
    if not same:
        fail("the --plan run is not bit-identical to the flag run")
    if stamps != {shown}:
        fail("the checkpoints are not stamped with the fingerprint plan show printed")
    if not runs["flags"][0] == runs["plan"][0] == want:
        fail("the plan runs did not launch each kernel exactly as their steps need")

    # (b) the plan run's file under a changed plan: refused, then --replan.
    resume = data + ["--plan", str(plan_file), "--epochs", "2", "--resume",
                     "--accum-steps", "2", "--checkpoint-dir", str(work / "plan")]
    print(f"[smoke] plan (b): {' '.join(resume)} (a subprocess)", flush=True)
    proc = subprocess.run([sys.executable, "-m", "parallel_cnn_tpu_torch", *resume],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    print(f"[smoke] plan (b): exit {proc.returncode}: {last}", flush=True)
    if (proc.returncode == 0 or "PlanMismatchError" not in last or shown not in last
            or "--replan" not in last):
        fail("resuming under another plan was not refused with both fingerprints")
    reset_zoo_counts()
    sgd_update.momentum_launches.reset()
    out = run_cli(resume + ["--replan"])
    replan = dict(zoo_counts(), sgd_momentum=sgd_update.momentum_launches.count)
    total = {k: total[k] + replan[k] for k in total}
    losses = epoch_losses(out)
    print(f"[smoke] plan (b): --replan resumed: epoch 2 loss {losses}, launches "
          f"{replan} for {ZOO_STEPS} steps of 2 microbatches", flush=True)
    if ("resumed from" not in out or len(losses) != 1
            or not np.isfinite(losses).all() or replan["sgd_momentum"] != ZOO_STEPS):
        fail("--replan did not resume the epoch with one B13 launch a step")
    return total


def checkpoint_meta(path):
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def profiled_dp_epoch_rank(mesh, zero=2):
    """(e) on one rank: a warm, then a profiled epoch of ZOO_STEPS
    update-on-arrival ResNet-18 steps at ZeRO level ``zero`` (batches
    gathered on the card, one loss readback) under torch.profiler (CUDA
    activity only). Returns (wall ms, device ms, device ops, B13's device
    ms and launches), or None when the profiler saw no device events."""
    imgs, labels = synthetic.make_image_dataset(ZOO_TRAIN_COUNT, seed=1234)
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).to("cuda", torch.int64)
    model = resnet.resnet18(10, backend="cuda",
                            generator=torch.Generator().manual_seed(0)).cuda()
    state, step = zero_level_state(model, mesh, dataclasses.replace(DP_FUSED, zero=zero),
                                   DP_LR)

    def epoch():
        perm = torch.randperm(ZOO_TRAIN_COUNT, generator=torch.Generator().manual_seed(0))
        perm = perm.cuda()
        total = torch.zeros((), device="cuda")
        for i in range(ZOO_STEPS):
            j = perm[i * ZOO_BATCH:(i + 1) * ZOO_BATCH]
            total = total + step(state, xs[j], ys[j])
        return float(total) / ZOO_STEPS

    epoch()  # warm: allocator, libraries, NCCL
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if dev_ms == 0:
        return None
    b13 = [e for e in kernels if "sgd_momentum_kernel" in e.key]
    top = [(e.self_device_time_total / 1e3, e.count, e.key[:90])
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]]
    return dict(wall_ms=wall_ms, dev_ms=dev_ms, ops=sum(e.count for e in kernels),
                b13_ms=sum(e.self_device_time_total for e in b13) / 1e3,
                b13_count=sum(e.count for e in b13), top=top)


def report_zero3_epoch(prof, dp_prof, card) -> None:
    """zero3 (d): the profiled ZeRO-3 epoch beside dp (e)'s ZeRO-2 epoch
    (printed, not gated)."""
    if prof is None or dp_prof is None:
        print("[smoke] zero3 (d): device time not measured (the profiler saw no "
              "device events)", flush=True)
        return
    parts = []
    for name, p in (("ZeRO-3", prof), ("ZeRO-2 (dp (e))", dp_prof)):
        wall, dev = p["wall_ms"], p["dev_ms"]
        parts.append(f"{name} {wall / ZOO_STEPS:.2f} ms a step, "
                     f"{p['ops'] / ZOO_STEPS:.1f} device ops a step, idle "
                     f"{1 - dev / wall:.1%}, B13 x{p['b13_count'] / ZOO_STEPS:.1f} a step")
    print(f"[smoke] zero3 (d) profiled epoch (ResNet-18, world {DP_WORLD}, "
          f"b{ZOO_BATCH}, {ZOO_STEPS} steps): {'; '.join(parts)} (this call, on "
          f"{card})", flush=True)


def momentum_bound_ms(n):
    """B13 on n values: read p, m and g, write p' and m' (20 bytes), 5
    operations."""
    t_ops = 5.0 * n / PEAK_F32_FLOPS * 1e3
    t_bytes = 20.0 * n / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_sgd_momentum(bucket_sizes) -> dict:
    """B13 over one step's buckets (ResNet-18's 12, 223.5 MB that overflow
    the 50 MB L2), one launch as the step calls it: kernel, plain and
    torch._fused_sgd_ (one multi-tensor call over the same buckets, timed
    only) beside the bound."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    sets = [momentum_inputs(n, gen) for n in bucket_sizes]
    scale = torch.tensor(1.0, device="cuda")
    ps, ms_, gs = ([t[i] for t in sets] for i in range(3))

    def kernel():
        sgd_update.fused_sgd_momentum_buckets(ps, ms_, gs, lr=DP_LR,
                                              momentum=DP_MOMENTUM, scale=scale)

    def plain():
        for p, m, g in sets:
            sgd_update.fused_sgd_momentum_plain(p, m, g, DP_LR, DP_MOMENTUM, scale)

    def library():
        torch._fused_sgd_(ps, gs, ms_, weight_decay=0.0, momentum=DP_MOMENTUM,
                          lr=DP_LR, dampening=0.0, nesterov=False, maximize=False,
                          is_first_step=False)

    ms, lib = in_turns(kernel, library, reps=20)
    plain_ms = cuda_ms(plain, reps=10)
    bound, by = momentum_bound_ms(sum(bucket_sizes))
    print(f"[smoke] time sgd_momentum over ResNet-18's {len(bucket_sizes)} buckets "
          f"({sum(bucket_sizes):,} values): kernel {ms:.4f} ms (device, one launch, "
          f"in turns with the library), plain {plain_ms:.4f} ms, library "
          f"(torch._fused_sgd_) {lib:.4f} ms, bound {bound:.4f} ms ({by}), "
          f"{bound / ms:.1%} of bound; kernel / library {ms / lib:.3f}x", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib)


def report_dp_epoch(prof, bucket_sizes, times) -> None:
    """(e): the profiled update-on-arrival epoch's numbers."""
    if prof is None:
        print("[smoke] dp (e): device time not measured (the profiler saw no "
              "device events)", flush=True)
        return
    wall, dev = prof["wall_ms"], prof["dev_ms"]
    bound, _ = momentum_bound_ms(sum(bucket_sizes))
    print(f"[smoke] dp (e) profiled update-on-arrival epoch (ResNet-18, world "
          f"{DP_WORLD}, b{ZOO_BATCH}, {ZOO_STEPS} steps): wall {wall:.1f} ms "
          f"({ZOO_TRAIN_COUNT / wall * 1e3:.0f} img/s), {wall / ZOO_STEPS:.2f} ms per "
          f"step, device busy {dev:.1f} ms ({dev / wall:.1%}), idle "
          f"{1 - dev / wall:.1%}; {prof['ops'] / ZOO_STEPS:.1f} device ops per step; "
          f"B13 {prof['b13_ms'] / ZOO_STEPS * 1e3:.1f} us per step "
          f"(x{prof['b13_count'] / ZOO_STEPS:.1f}) against its bound "
          f"{bound * 1e3:.1f} us and torch._fused_sgd_'s {times['library_ms'] * 1e3:.1f} "
          f"us", flush=True)
    for ms, count, key in prof["top"]:
        print(f"[smoke]   {ms:9.3f} ms x{count:<6d} {key}", flush=True)


# ---------------------------------------------------------------------------
# The probe path: the eight Mosaic probes (B14–B21) through the port's
# entry point, python -m parallel_cnn_tpu_torch.benches.mosaic_probe
# ---------------------------------------------------------------------------


def probe_operands(name, odd, draw, rows=None):
    """The operands of probe kernel ``name`` at the probe's shapes, or at
    odd ones that leave a tail in every grid dimension and copies whose
    length is no multiple of 4; ``draw(shape, dtype)`` makes each tensor.
    ``rows`` sets the dots' row count instead."""
    f32, bf16 = torch.float32, torch.bfloat16
    bb, length, odd_rows = (7, 1003, 37) if odd else (probe_bench.BB, probe_bench.L,
                                                      probe_bench.ROWS)
    rows = rows or odd_rows
    if name == "rank3_dot":
        n, m, k, p = (3, 17, 33, 9) if odd else (4, 64, 128, 64)
        return draw((n, m, k), f32), draw((n, k, p), f32)
    if name == "lane_merge":
        return (draw((25, bb, 575 if odd else 576), f32),)
    if name == "lane_split":
        return draw((1, bb * (13 if odd else 576)), f32), bb
    if name == "mxu_conv_L":
        return draw((6, 25), f32), draw((25, length), bf16)
    if name in ("vpu_conv", "mxu_conv_3d"):
        return draw((6, 25), f32), draw((25, bb, 576), bf16)
    return draw((rows, 64), bf16), draw((64, 128), bf16)  # pair_dot, two_dot


def probe_kernel(name):
    """(wrapper, plain twin) of probe kernel ``name``."""
    return getattr(mosaic_probe, name), getattr(mosaic_probe, f"{name}_plain")


def card_draw(gen):
    """Seeded normals on the card, bf16 ones rounded from f32 normals."""
    def draw(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return draw


def check_probe_kernels() -> dict:
    """(a) Each probe kernel against its plain twin on seeded normals, at
    the probe's shapes and odd ones (the dots also at DOT_ROWS' last, more
    tiles than SMs): the copies and B18 bit for bit, the products within
    PROBE_RTOL of the output's scale; a relaunch bit for bit. Then each
    probe on its all-ones inputs equals its run on the host."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = {}
    for name in mosaic_probe.KERNELS:
        fn, plain = probe_kernel(name)
        shapes = [(False, None), (True, None)]
        if name in DOT_KERNELS:
            shapes.append((False, DOT_ROWS[-1]))
        for odd, rows in shapes:
            args = probe_operands(name, odd, card_draw(gen), rows=rows)
            got, again, want = fn(*args), fn(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            exact = name in PROBE_EXACT
            tol = 0.0 if exact else PROBE_RTOL * max(1.0, float(want.abs().max()))
            ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
                  and (torch.equal(got, want) if exact else err <= tol)
                  and torch.equal(got, again))
            print(f"[smoke] probe (a) {name:12s} {tuple(got.shape)}: max |Δ| vs "
                  f"plain {err:.3e} ({'bit-identical required' if exact else f'tol {tol:.1e}'})"
                  f", relaunch {'bit-identical' if torch.equal(got, again) else 'DIFFERS'} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"probe kernel {name} disagrees with its plain twin or is not "
                     "deterministic")
            errs[name] = max(errs.get(name, 0.0), err)
    for label, probe in probe_bench.PROBES:
        on_card, on_host = probe("cuda"), probe(torch.device("cpu"))
        if not torch.equal(on_card.cpu(), on_host):
            fail(f"probe {label} on ones differs between the card and the host")
    print("[smoke] probe (a) all eight probes on ones: card equals host exactly ok",
          flush=True)
    return errs


def probe_phase() -> tuple:
    """(a) the kernels against their plain twins; (b) the main path: the
    port's probe entry point in-process, every counter set to 0 just
    before and read just after."""
    errs = check_probe_kernels()
    for counter in mosaic_probe.launches.values():
        counter.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = probe_bench.main([])
    counts = {k: c.count for k, c in mosaic_probe.launches.items()}
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[smoke]   | {line}", flush=True)
    names = [line.split("]")[0].lstrip("[") for line in lines]
    want_names = [label for label, _ in probe_bench.PROBES]
    print(f"[smoke] probe (b) entry point: rc {rc}, {len(lines)} lines in JAX's order "
          f"{names == want_names}, launches {counts}", flush=True)
    if rc != 0 or names != want_names or not all(" RAN cuda" in line for line in lines):
        fail("the probe entry point did not print the eight probes in order on the card")
    if counts != {name: PROBE_LAUNCHES for name in mosaic_probe.KERNELS}:
        fail(f"the probe entry point launched {counts}, not {PROBE_LAUNCHES} of each")
    return errs, counts


def probe_library_call(name, args):
    """One PyTorch call computing the same function (timed only): bmm; a
    copy_ into a preallocated output; matmul on x widened to f32 and, for
    the dots, w's halves summed, both prepared outside the timing."""
    if name == "rank3_dot":
        return lambda: torch.bmm(*args)
    if name in ("lane_merge", "lane_split"):
        x = args[0]
        view = x.view(x.shape[0] if name == "lane_merge" else args[1], -1)
        out = torch.empty_like(view)
        return lambda: out.copy_(view)
    if name in ("mxu_conv_L", "vpu_conv", "mxu_conv_3d"):
        w, xf = args[0], args[1].float().reshape(mosaic_probe.TAPS, -1)
        return lambda: torch.matmul(w, xf)
    xf, wf = args[0].float(), args[1].float()
    wsum = wf[:, :mosaic_probe.PAIR_N] + wf[:, mosaic_probe.PAIR_N:]
    return lambda: torch.matmul(xf, wsum)


def probe_bound_ms(name, args, out):
    """Least time for one probe call: each input and output moved once at
    the HBM rate, against its multiply-adds (2 operations) at the peak for
    the products' type (f32 in the batched matmul and the convs, whose w is
    f32; bf16 in the dots)."""
    tensors = [t for t in args if isinstance(t, torch.Tensor)] + [out]
    t_bytes = sum(t.numel() * t.element_size() for t in tensors) / PEAK_HBM_BYTES * 1e3
    if name == "rank3_dot":
        n, m, k = args[0].shape
        t_ops = 2.0 * n * m * k * args[1].shape[2] / PEAK_F32_FLOPS * 1e3
    elif name in ("lane_merge", "lane_split"):
        t_ops = 0.0
    elif name in ("pair_dot", "two_dot"):
        t_ops = 2.0 * args[0].shape[0] * args[0].shape[1] * args[1].shape[1] \
            / PEAK_BF16_FLOPS * 1e3
    else:
        t_ops = 2.0 * out.numel() * mosaic_probe.TAPS / PEAK_F32_FLOPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_probe_kernels() -> dict:
    """(c) Each probe kernel at the probe's shapes on seeded normals:
    device ms beside its plain twin, its library call and its bound; then
    the two head-to-heads the probes were written for."""
    gen = torch.Generator(device="cuda").manual_seed(66)
    times = {}
    for name in mosaic_probe.KERNELS:
        fn, plain = probe_kernel(name)
        args = probe_operands(name, False, card_draw(gen))
        if name in COPIES:
            ms, lib_ms = in_turns(lambda: fn(*args), probe_library_call(name, args), COPY_REPS)
        else:
            ms = cuda_ms(lambda: fn(*args), reps=50)
            lib_ms = cuda_ms(probe_library_call(name, args), reps=50)
        plain_ms = cuda_ms(lambda: plain(*args), reps=10)
        bound, by = probe_bound_ms(name, args, fn(*args))
        note = l2_cold_note(fn, args, bound)
        print(f"[smoke] time probe {name:12s}: kernel {ms:.5f} ms, plain {plain_ms:.4f} "
              f"ms, library {lib_ms:.5f} ms, bound {bound:.6f} ms ({by}), "
              f"{bound / ms:.2%} of bound{note}; {device_launches(lambda: fn(*args))} CUDA "
              "launches per wrapper call (torch.profiler)", flush=True)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                           library_ms=lib_ms)
    floor = cuda_ms(lambda: torch.cuda._sleep(0), reps=50)
    print(f"[smoke] probe (c) launch floor: torch.cuda._sleep(0) {floor:.5f} ms, timed "
          "as the kernels are; share of each probe kernel's time: " + ", ".join(
              f"{name} {floor / v['ms']:.0%}" for name, v in times.items()), flush=True)
    print("[smoke] probe (c) the copies in turns with copy_ (kernel, copy_, copy_, "
          f"kernel; {COPY_REPS} launches a turn): " + ", ".join(
              f"{name} {times[name]['ms'] * 1e3:.3f} us against {times[name]['library_ms'] * 1e3:.3f}"
              f" ({times[name]['ms'] / times[name]['library_ms']:.3f}x)" for name in COPIES),
          flush=True)
    args = probe_operands("lane_merge", False, card_draw(gen))
    cold, cold_lib = cold_ms(lambda: mosaic_probe.lane_merge(*args)), cold_ms(
        probe_library_call("lane_merge", args))
    print(f"[smoke] probe (c) lane_merge with L2 cold (a {L2_FLUSH_FLOATS * 4 >> 20} MB write "
          f"before each launch, outside the events): {cold * 1e3:.3f} us, copy_ "
          f"{cold_lib * 1e3:.3f} us; warm {times['lane_merge']['ms'] * 1e3:.3f} us; the "
          f"bound, {times['lane_merge']['bound_ms'] * 1e3:.3f} us, is its bytes at the HBM rate: "
          "it describes the cold copy, while a warm one reads and writes the 50 MB L2",
          flush=True)
    # B1's conv form and the one-contraction form in turns (vpu, 3d, 3d,
    # vpu) on the same w and x: both read x once, so the ratio is the cost
    # of B1's rounding, a rounded product and sum against one fma.
    w, x = probe_operands("vpu_conv", False, card_draw(gen))
    vpu_ms, contract_ms = in_turns(lambda: mosaic_probe.vpu_conv(w, x),
                                   lambda: mosaic_probe.mxu_conv_3d(w, x), reps=200)
    print(f"[smoke] probe (c) B1's conv form against the one-contraction form, in turns, "
          f"(25,{probe_bench.BB},576) bf16 x, 6 filters, x read once by both: vpu_conv "
          f"(per filter, 25 rounded multiplies and adds) {vpu_ms:.5f} ms, mxu_conv_3d (25 "
          f"fmas) {contract_ms:.5f} ms: per-filter / one-contraction "
          f"{vpu_ms / contract_ms:.3f}x", flush=True)
    # The two forms in turns (pair, two, two, pair) on the same inputs.
    x, w = probe_operands("pair_dot", False, card_draw(gen))
    pair_ms, two_ms = in_turns(lambda: mosaic_probe.pair_dot(x, w),
                               lambda: mosaic_probe.two_dot(x, w), reps=200)
    same = all(torch.equal(mosaic_probe.pair_dot(*args), mosaic_probe.two_dot(*args))
               for args in [(x, w)] + [probe_operands("pair_dot", False, card_draw(gen),
                                                      rows=r) for r in DOT_ROWS])
    print(f"[smoke] probe (c) N-paired taps, ({probe_bench.ROWS},64)·(64,128) bf16 on the "
          f"tensor cores, in turns: pair_dot (one m64n128k16 chain) {pair_ms:.5f} ms, "
          f"two_dot (two m64n64k16 chains) {two_ms:.5f} ms: pair / two "
          f"{pair_ms / two_ms:.3f}x; pair_dot equals two_dot bit for bit at rows "
          f"{probe_bench.ROWS} and {DOT_ROWS}: {'yes' if same else 'no'} (reported, not "
          "gated)", flush=True)
    return times


# ---------------------------------------------------------------------------
# ResNet-50 and VGG-16 at full width (zoo50, imagenet, vgg, serve50), and
# the native C++ idx parser and prefetch ring (native)
# ---------------------------------------------------------------------------

# Every distinct conv of ResNet-50 (CIFAR stem, 32x32 input) with its eval
# epilogue and its count in one forward (name, H, Cin, Cout, k, stride,
# residual, relu, count): the stem, 16 bottlenecks (1x1 reduce, 3x3 mid
# with the stride, 1x1 expand with the residual) and 4 projections.
R50_GEOMETRIES = [
    ("stem 3x3/s1 3->64", 32, 3, 64, 3, 1, False, True, 1),
    ("1x1 64->64 reduce", 32, 64, 64, 1, 1, False, True, 1),
    ("3x3/s1 64 mid", 32, 64, 64, 3, 1, False, True, 3),
    ("1x1 64->256 expand+res", 32, 64, 256, 1, 1, True, True, 3),
    ("1x1 64->256 proj", 32, 64, 256, 1, 1, False, False, 1),
    ("1x1 256->64 reduce", 32, 256, 64, 1, 1, False, True, 2),
    ("1x1 256->128 reduce", 32, 256, 128, 1, 1, False, True, 1),
    ("3x3/s2 128 mid", 32, 128, 128, 3, 2, False, True, 1),
    ("1x1 128->512 expand+res", 16, 128, 512, 1, 1, True, True, 4),
    ("1x1/s2 256->512 proj", 32, 256, 512, 1, 2, False, False, 1),
    ("1x1 512->128 reduce", 16, 512, 128, 1, 1, False, True, 3),
    ("3x3/s1 128 mid", 16, 128, 128, 3, 1, False, True, 3),
    ("1x1 512->256 reduce", 16, 512, 256, 1, 1, False, True, 1),
    ("3x3/s2 256 mid", 16, 256, 256, 3, 2, False, True, 1),
    ("1x1 256->1024 expand+res", 8, 256, 1024, 1, 1, True, True, 6),
    ("1x1/s2 512->1024 proj", 16, 512, 1024, 1, 2, False, False, 1),
    ("1x1 1024->256 reduce", 8, 1024, 256, 1, 1, False, True, 5),
    ("3x3/s1 256 mid", 8, 256, 256, 3, 1, False, True, 5),
    ("1x1 1024->512 reduce", 8, 1024, 512, 1, 1, False, True, 1),
    ("3x3/s2 512 mid", 8, 512, 512, 3, 2, False, True, 1),
    ("1x1 512->2048 expand+res", 4, 512, 2048, 1, 1, True, True, 3),
    ("1x1/s2 1024->2048 proj", 8, 1024, 2048, 1, 2, False, False, 1),
    ("1x1 2048->512 reduce", 4, 2048, 512, 1, 1, False, True, 2),
    ("3x3/s1 512 mid", 4, 512, 512, 3, 1, False, True, 2),
]
# The library resnet50()'s ImageNet stem at 224x224, at its batch.
STEM224 = ("stem 7x7/s2 3->64 at 224", 224, 3, 64, 7, 2, False, True, 1)
STEM224_BATCH = 32
# VGG-16's 13 convs on 32x32 input: no epilogue (the bias is added after
# the kernel; BN and ReLU are layers of their own).
VGG_GEOMETRIES = [
    ("3x3 3->64 at 32", 32, 3, 64, 3, 1, False, False, 1),
    ("3x3 64 at 32", 32, 64, 64, 3, 1, False, False, 1),
    ("3x3 64->128 at 16", 16, 64, 128, 3, 1, False, False, 1),
    ("3x3 128 at 16", 16, 128, 128, 3, 1, False, False, 1),
    ("3x3 128->256 at 8", 8, 128, 256, 3, 1, False, False, 1),
    ("3x3 256 at 8", 8, 256, 256, 3, 1, False, False, 2),
    ("3x3 256->512 at 4", 4, 256, 512, 3, 1, False, False, 1),
    ("3x3 512 at 4", 4, 512, 512, 3, 1, False, False, 2),
    ("3x3 512 at 2", 2, 512, 512, 3, 1, False, False, 3),
]
# zoo50: the CLI on full-width, full-depth ResNet-50 (CIFAR stem) at b128 in
# two microbatches, 2 epochs of Z50_STEPS steps, eval in batches of 256.
Z50_BATCH = 128
Z50_ACCUM = 2
Z50_STEPS = 8
Z50_TRAIN_COUNT = Z50_STEPS * Z50_BATCH
Z50_TEST_COUNT = 512
Z50_LR = 0.05
# imagenet: the library resnet50() (ImageNet stem, 1,000 classes) on 224x224
# images, steps on one batch of 32 in two microbatches.
IMAGENET_BATCH = 32
IMAGENET_ACCUM = 2
IMAGENET_STEPS = 4
IMAGENET_LR = 0.05
# The ImageNet head's B12 time in its per-image form on an H100 (PERF.md)
# and the tiled form's target.
IMAGENET_TAIL_MS = 0.931
TARGET_IMAGENET_TAIL_MS = 0.030
# vgg: the CLI on VGG-16 (CIFAR head) at b128, 2 epochs of VGG_STEPS steps.
VGG_STEPS = 10
VGG_TRAIN_COUNT = VGG_STEPS * ZOO_BATCH
VGG_LR = 0.01
SERVE50_REQUESTS = 128
# native: idx files of this many images, and the zoo's ring on ResNet-18.
NATIVE_IDX_COUNT = 10_000
NATIVE_ZOO_STEPS = 10


def conv_geometries(model, in_shape) -> list:
    """Every distinct conv that one eval forward of ``model`` on one CPU
    image runs, read by hooks: [(H, Cin, Cout, k, stride, residual, relu,
    count)] in first-use order."""
    seen = {}

    def hook(m, args, kwargs, out):
        w = m.conv["w"] if isinstance(m, ConvBNAct) else m.w
        key = (int(args[0].shape[1]), int(w.shape[2]), int(w.shape[3]), int(w.shape[0]),
               m.stride, kwargs.get("residual") is not None,
               isinstance(m, ConvBNAct) and m.relu)
        seen[key] = seen.get(key, 0) + 1

    handles = [m.register_forward_hook(hook, with_kwargs=True) for m in model.modules()
               if isinstance(m, (ConvBNAct, Conv2D))]
    with torch.inference_mode():
        model.eval()(torch.zeros((1,) + tuple(in_shape)))
    for handle in handles:
        handle.remove()
    return [key + (n,) for key, n in seen.items()]


def check_geometry_table(label, model, table) -> int:
    """Fail unless ``table`` lists exactly the convs a forward of ``model``
    runs; returns how many convs a forward runs."""
    walked = sorted(conv_geometries(model, (32, 32, 3)))
    if walked != sorted(g[1:] for g in table):
        fail(f"{label}: the conv table is not the model's convs: {walked}")
    return sum(g[-1] for g in walked)


def geometry_checks(label, geometries, batch, gen) -> tuple:
    """B10's forward (with the geometry's eval epilogue: folded BN,
    residual, ReLU) and dgrad and B11 at each geometry at ``batch``,
    against their plain twins (GRAD_RTOL of the output's scale, relaunch
    bit for bit), and timed beside the plain twin, the library call and the
    bound. A stem's dgrad is not on the path (its input batch needs no
    gradient) and is skipped. Returns each kernel's largest difference and
    its times summed over one forward's or one microbatch's convs."""
    errs = dict.fromkeys(("tap_conv", "tap_conv_dgrad", "tap_wgrad"), 0.0)
    sums = {key: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
            for key in errs}
    for name, h, cin, cout, k, s, res_on, relu, count in geometries:
        x, w, g = grad_inputs(h, cin, cout, k, s, gen, batch)
        scale = torch.rand((cout,), generator=gen, device="cuda") + 0.5
        shift = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
        res = torch.randn_like(g) if res_on else None
        tag = f"{label} {name:26s} b{batch}"
        kinds = [("tap_conv", None)] + ([] if name.startswith("stem") else
                                        [("tap_conv_dgrad", True)]) + [("tap_wgrad", False)]
        for key, dgrad in kinds:
            if key == "tap_conv":
                fn = lambda: tap_conv.conv2d_fused(  # noqa: E731
                    x, w, scale, shift, res, s, relu)
                plain_fn = lambda: tap_conv.conv2d_fused_plain(  # noqa: E731
                    x, w, scale, shift, res, s, relu)
                lib = library_call(x, w, scale, shift, res, s, relu)
                bound, by = bound_ms(x, w, s, tuple(g.shape), res_on)
            elif dgrad:
                fn = lambda: tap_conv.conv2d_dgrad(g, w, x.shape, s)  # noqa: E731
                plain_fn = lambda: tap_conv.conv2d_dgrad_plain(g, w, x.shape, s)  # noqa: E731
                lib = library_grad(x, w, g, s, True)
                bound, by = grad_bound_ms(x.shape, k, cin, cout, s, True)
            else:
                fn = lambda: tap_wgrad.conv2d_wgrad(x, g, k, s)  # noqa: E731
                plain_fn = lambda: tap_wgrad.conv2d_wgrad_plain(x, g, k, s)  # noqa: E731
                lib = library_grad(x, w, g, s, False)
                bound, by = grad_bound_ms(x.shape, k, cin, cout, s, False)
            got, again = fn(), fn()
            with plain_reference():
                want = plain_fn()
            torch.cuda.synchronize()
            errs[key] = max(errs[key], within(f"{tag} {key}", got, want, again))
            ms = cuda_ms(fn, reps=10)
            with plain_reference():
                plain = cuda_ms(plain_fn, reps=3, warmup=1)
            lib_ms = cuda_ms(lib, reps=10)
            print(f"[smoke] time {tag} {key}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"library {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                  f"{bound / ms:.1%} of bound", flush=True)
            for field, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib_ms),
                             ("bound_ms", bound)):
                sums[key][field] += count * v
        del x, w, g, res
    for key, rec in sums.items():
        print(f"[smoke] time {label} {key} summed over the convs of one "
              f"{'forward' if key == 'tap_conv' else 'microbatch'} at b{batch}: "
              + ", ".join(f"{f} {v:.3f}" for f, v in rec.items()), flush=True)
    return errs, sums


def zoo50_phase(card) -> tuple:
    """ResNet-50 (CIFAR stem, 10 classes) on the card: (a) the CLI at full
    width and depth, b128 in two microbatches, its exact launch counts and
    a falling loss; (b) a resumed run against the straight one; (c) 3
    kernel steps against 3 plain steps; (d) every distinct conv at b128
    and the ImageNet stem at 224x224 against the plain twins, timed.
    Returns (launches of (a), the largest differences of (d), the times of
    (d))."""
    work = BUILD_DIR / "smoke_zoo50"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    convs = check_geometry_table("zoo50", resnet.resnet50(10, cifar_stem=True),
                                 R50_GEOMETRIES)
    base = ["--model", "resnet50", "--conv-backend", "cuda", "--fused-step",
            "--act-dtype", "float32", "--accum-steps", str(Z50_ACCUM),
            "--batch-size", str(Z50_BATCH), "--lr", str(Z50_LR),
            "--synthetic-train-count", str(Z50_TRAIN_COUNT),
            "--synthetic-test-count", str(Z50_TEST_COUNT)]

    # (a) the main path: every counter set to 0 just before, read just after.
    print(f"[smoke] zoo50 (a): {' '.join(base)} --epochs 2", flush=True)
    reset_zoo_counts()
    t0 = time.perf_counter()
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(work / "straight"),
                          "--metrics", str(work / "a.jsonl")])
    wall = time.perf_counter() - t0
    launches = zoo_counts()
    losses = epoch_losses(out)
    micro = 2 * Z50_STEPS * Z50_ACCUM
    evals = 2 * -(-Z50_TEST_COUNT // ZOO_EVAL_BATCH)
    # Each microbatch: every conv's forward, dgrad (not the stem's: its
    # input batch needs no gradient) and wgrad, and one fused tail; each
    # eval batch: every conv's fused forward.
    want = {"tap_conv": convs * (micro + evals), "tap_conv_dgrad": (convs - 1) * micro,
            "tap_wgrad": convs * micro, "tail_ce": micro}
    with open(work / "a.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    rates = [round(Z50_TRAIN_COUNT / r["seconds"]) for r in recs]
    print(f"[smoke] zoo50 (a): {convs} convs a forward; {micro} microbatches and "
          f"{evals} eval batches give forward {convs} x ({micro} + {evals}), dgrad "
          f"{convs - 1} x {micro}, wgrad {convs} x {micro}, tail 1 x {micro} = "
          f"{want}; launched {launches}; epoch losses {losses}; img/s per epoch "
          f"{rates} (host clock, first epoch cold); eval accuracy "
          f"{[r['accuracy'] for r in recs]}; {wall:.1f} s for the run on {card}",
          flush=True)
    if launches != want:
        fail("the ResNet-50 run did not launch each kernel exactly as often as its "
             "microbatches and eval batches need")
    if len(losses) != 2 or not all(np.isfinite(losses)) or not losses[1] < losses[0]:
        fail("the ResNet-50 run's loss is not finite or did not fall from epoch 1 to 2")

    # (b) 1 epoch, then --resume to 2: the straight run's state, bit for bit.
    print("[smoke] zoo50 (b): --epochs 1, then --epochs 2 --resume, vs (a)", flush=True)
    split = work / "split"
    run_cli(base + ["--epochs", "1", "--checkpoint-dir", str(split)])
    out = run_cli(base + ["--epochs", "2", "--checkpoint-dir", str(split), "--resume"])
    a = checkpoint_leaves(work / "straight" / "ckpt_2.npz")
    b = checkpoint_leaves(split / "ckpt_2.npz")
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"[smoke] zoo50 (b): resumed state ({len(a)} leaves: params, BN stats, "
          f"momentum) {'bit-identical to the straight run' if same else 'DIFFERS'}",
          flush=True)
    if "resumed from" not in out or not same:
        fail("the resumed ResNet-50 run is not bit-identical to the straight run")

    # (c) 3 kernel steps vs 3 plain steps at zoo (c)'s LR and bounds.
    kern_vs_plain_steps(
        "zoo50 (c)", lambda b: resnet.resnet50(
            10, cifar_stem=True, backend=b, generator=torch.Generator().manual_seed(0)),
        synthetic.make_image_dataset(3 * Z50_BATCH, seed=11), Z50_BATCH, Z50_ACCUM,
        resync=True)

    # (d) every conv at the path's shapes, and the ImageNet stem.
    gen = torch.Generator(device="cuda").manual_seed(50)
    errs, times = geometry_checks("zoo50 (d)", R50_GEOMETRIES, Z50_BATCH, gen)
    stem_errs, _ = geometry_checks("zoo50 (d)", [STEM224], STEM224_BATCH, gen)
    for key, v in stem_errs.items():
        errs[key] = max(errs[key], v)
    return launches, errs, times


def kern_vs_plain_steps(label, build, data, batch, accum, resync=False) -> None:
    """3 steps of the model on the kernels (fused tail) against 3 on the
    plain twins (cuDNN off, TF32 off), from one init at zoo (c)'s LR;
    fails past zoo (c)'s bounds. ``resync`` starts each plain step from the
    kernel path's state (params, BN statistics, momentum): a net whose
    train steps turn f32 rounding into a growing drift (ResNet-50 at init:
    the plain path's own f32 and f64 steps part by 1.4e-2 in the third
    loss) is then held step by step, each step to the same bounds."""
    imgs, labels = data
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).to("cuda", torch.int64)
    opt = zoo.make_optimizer(ZOO_CHECK_LR)
    kern, plain = build("cuda").cuda(), build("torch").cuda()
    sk, sp = zoo.init_state(kern, opt), zoo.init_state(plain, opt)
    step_k = zoo.make_train_step(kern, opt, accum, fused=ZOO_FUSED)
    step_p = zoo.make_train_step(plain, opt, accum)
    loss_diff = param_diff = stat_diff = 0.0
    for i in range(3):
        sl = slice(i * batch, (i + 1) * batch)
        if resync and i:
            sp.load(sk.snapshot())
        lk = step_k(sk, xs[sl], ys[sl])
        with plain_reference():
            lp = step_p(sp, xs[sl], ys[sl])
        loss_diff = max(loss_diff, abs(float(lk) - float(lp)))
        if resync or i == 2:
            pk, pp = kern.state_dict(), plain.state_dict()
            param_diff = max(param_diff, *(float((pk[n] - pp[n]).abs().max())
                                           for n, _ in kern.named_parameters()))
            stat_diff = max(stat_diff, *(float((pk[n] - pp[n]).abs().max())
                                         for n, _ in kern.named_buffers()))
    ok = loss_diff <= ZOO_LOSS_ATOL and param_diff <= ZOO_PARAM_ATOL
    print(f"[smoke] {label}: 3 kernel steps vs 3 plain steps "
          f"{'(each from the kernel path state) ' if resync else ''}(lr {ZOO_CHECK_LR}, "
          f"b{batch}, {accum} microbatch{'es' if accum > 1 else ''}): max |Δloss| "
          f"{loss_diff:.3e} (tol {ZOO_LOSS_ATOL:.0e}), max |Δparams| {param_diff:.3e} "
          f"(tol {ZOO_PARAM_ATOL:.0e}), max |ΔBN stats| {stat_diff:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}: the kernel steps drifted from the plain steps")


def imagenet_phase(card) -> tuple:
    """The library resnet50() (ImageNet stem with its SAME max pool, 1,000
    classes) on 224x224 images: IMAGENET_STEPS steps on one batch in two
    microbatches, exact launch counts, a finite falling loss; then the gap
    tail at 7x7x2048 -> 1,000 on the trained trunk's features against its
    plain twin, its rows at b1, b7, b32 against b128, and its time. Returns
    (launches, the tail's largest difference, the tail's times)."""
    model = resnet.resnet50(generator=torch.Generator().manual_seed(0)).cuda()
    convs = sum(m.__class__ is ConvBNAct for m in model.modules())
    imgs, labels = synthetic.make_image_dataset(IMAGENET_BATCH, hw=(224, 224),
                                                classes=1000, seed=5)
    x = torch.from_numpy(imgs).cuda()
    y = torch.from_numpy(labels).to("cuda", torch.int64)
    opt = zoo.make_optimizer(IMAGENET_LR)
    state = zoo.init_state(model, opt)
    step = zoo.make_train_step(model, opt, IMAGENET_ACCUM, fused=ZOO_FUSED)
    reset_zoo_counts()
    t0 = time.perf_counter()
    losses = [float(step(state, x, y)) for _ in range(IMAGENET_STEPS)]
    wall = time.perf_counter() - t0
    launches = zoo_counts()
    tiled = tail.tiled_launches.count
    micro = IMAGENET_STEPS * IMAGENET_ACCUM
    want = {"tap_conv": convs * micro, "tap_conv_dgrad": (convs - 1) * micro,
            "tap_wgrad": convs * micro, "tail_ce": micro}
    plan = tail.tail_plan("gap", *IMAGENET_HEAD, torch.float32)
    print(f"[smoke] imagenet (a): resnet50() at 224x224, b{IMAGENET_BATCH} in "
          f"{IMAGENET_ACCUM} microbatches, lr {IMAGENET_LR}: losses "
          f"{[round(v, 4) for v in losses]}; launches {launches} (expected {want}; "
          f"tail_ce in its tiled form {tiled} of them); {wall:.2f} s for {IMAGENET_STEPS} "
          f"steps, the first cold, on {card}", flush=True)
    print(f"[smoke] imagenet (a): the tail's plan at gap 7x7x2048->1000: {plan.form} form, "
          f"{plan.chunks} feature chunks of {plan.chunk_features}, {plan.pos_groups} position "
          f"ranges, {plan.scratch_per_image} bytes of scratch an image", flush=True)
    if launches != want or tiled != micro:
        fail("the ImageNet-shape ResNet-50 steps did not launch each kernel as often "
             "as their microbatches need, or the tail not in its tiled form")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("the ImageNet-shape ResNet-50 loss is not finite or did not fall")
    with torch.no_grad():  # the trunk as the step runs it: batch statistics
        feats = x
        for layer in list(model)[:-2]:
            feats = layer(feats)
    dense = model[-1]
    w, b = dense.w.detach(), dense.b.detach()
    if tuple(feats.shape) != (IMAGENET_BATCH, 7, 7, 2048):
        fail(f"the ImageNet trunk gives {tuple(feats.shape)}, not 7x7x2048")
    got, again = tail.tail_forward(feats, w, b, y, "gap"), tail.tail_forward(feats, w, b, y, "gap")
    want_t = tail.tail_forward_plain(feats, w, b, y, "gap")
    torch.cuda.synchronize()
    err = max(within(f"imagenet (a) tail_ce gap 7x7x2048->1000 {part}", g, r, a)
              for part, g, r, a in zip(("loss", "dlogits"), got, want_t, again))
    args = (feats.contiguous(), w, b, y)
    check_head_rows(torch.float32, torch.Generator(device="cuda").manual_seed(27))
    ms = cuda_ms(lambda: tail.tail_forward(*args, "gap"), reps=100)
    plain = cuda_ms(lambda: tail.tail_forward_plain(*args, "gap"), reps=20)
    bound, by = tail_bound_ms(feats, w)
    print(f"[smoke] time imagenet (a) tail_ce gap 7x7x2048->1000 b{IMAGENET_BATCH}: kernel "
          f"({plan.form} form) {ms:.5f} ms, plain {plain:.4f} ms, library none, bound "
          f"{bound:.6f} ms ({by}), {bound / ms:.1%} of bound; {IMAGENET_TAIL_MS / ms:.1f}x "
          f"below the per-image form's {IMAGENET_TAIL_MS} ms (PERF.md), target <= "
          f"{TARGET_IMAGENET_TAIL_MS} {'met' if ms <= TARGET_IMAGENET_TAIL_MS else 'NOT met'}; "
          f"{device_launches(lambda: tail.tail_forward(*args, 'gap'))} CUDA launches per "
          "wrapper call (torch.profiler)", flush=True)
    print(f"[smoke] imagenet (a) tail_ce gap 7x7x2048->1000 b{IMAGENET_BATCH}, the last of 20 "
          "calls queued behind a spin (torch.profiler, us from the first kernel's start): "
          f"{device_timeline(lambda: tail.tail_forward(*args, 'gap'))}", flush=True)
    times = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None)
    return launches, err, tiled, times


def vgg_phase(card) -> dict:
    """VGG-16 (CIFAR head) on the card: (a) the CLI with every conv through
    B10/B11 and the gap head through the fused tail, b128, exact launch
    counts and a falling loss; (b) 3 kernel steps against 3 plain steps on
    noise images (ReLU → max pool windows of the synthetic set's plateaus
    tie up to rounding). Returns the launches of (a)."""
    work = BUILD_DIR / "smoke_vgg"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    convs = check_geometry_table("vgg", vgg.vgg16(10), VGG_GEOMETRIES)
    base = ["--model", "vgg16", "--conv-backend", "cuda", "--fused-step",
            "--act-dtype", "float32", "--batch-size", str(ZOO_BATCH), "--lr", str(VGG_LR),
            "--synthetic-train-count", str(VGG_TRAIN_COUNT),
            "--synthetic-test-count", str(Z50_TEST_COUNT)]
    print(f"[smoke] vgg (a): {' '.join(base)} --epochs 2", flush=True)
    reset_zoo_counts()
    out = run_cli(base + ["--epochs", "2", "--metrics", str(work / "a.jsonl")])
    launches = zoo_counts()
    losses = epoch_losses(out)
    steps = 2 * VGG_STEPS
    evals = 2 * -(-Z50_TEST_COUNT // ZOO_EVAL_BATCH)
    want = {"tap_conv": convs * (steps + evals), "tap_conv_dgrad": (convs - 1) * steps,
            "tap_wgrad": convs * steps, "tail_ce": steps}
    with open(work / "a.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    rates = [round(VGG_TRAIN_COUNT / r["seconds"]) for r in recs]
    print(f"[smoke] vgg (a): {convs} convs; {steps} steps and {evals} eval batches give "
          f"forward {convs} x ({steps} + {evals}), dgrad {convs - 1} x {steps}, wgrad "
          f"{convs} x {steps}, tail 1 x {steps} = {want}; launched {launches}; epoch "
          f"losses {losses}; img/s per epoch {rates} (host clock, first epoch cold) "
          f"on {card}", flush=True)
    if launches != want:
        fail("the VGG-16 run did not launch each kernel exactly as often as its steps "
             "and eval batches need")
    if len(losses) != 2 or not all(np.isfinite(losses)) or not losses[1] < losses[0]:
        fail("the VGG-16 run's loss is not finite or did not fall from epoch 1 to 2")
    rng = np.random.default_rng(16)
    noise = (rng.uniform(0, 1, (3 * ZOO_BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, 3 * ZOO_BATCH).astype(np.int32))
    kern_vs_plain_steps("vgg (b)", lambda b: vgg.vgg16(
        10, backend=b, generator=torch.Generator().manual_seed(0)), noise, ZOO_BATCH, 1)
    return launches


def plain_model_forward(model, x):
    """``plain_forward`` for any zoo model of the port: every conv through
    the plain version of the tap-conv kernel, BN folded here, the
    bottleneck and basic blocks walked by hand."""

    def cba(m, v, residual=None):
        bn = m.bn
        scale = bn.scale / torch.sqrt(bn.var + bn.eps)
        shift = bn.bias - bn.mean * scale
        return tap_conv.conv2d_fused_plain(v, m.conv["w"], scale, shift,
                                           residual, m.stride, m.relu)

    for layer in model:
        if isinstance(layer, ConvBNAct):
            x = cba(layer, x)
        elif isinstance(layer, (BasicBlock, Bottleneck)):
            sc = cba(layer.proj[0], x) if layer.proj is not None else x
            *head, last = layer.main
            for m in head:
                x = cba(m, x)
            x = cba(last, x, sc)
        elif isinstance(layer, Conv2D):
            x = tap_conv.conv2d_plain(x, layer.w, layer.stride) + layer.b
        else:
            x = layer(x)
    return x


def serve50_phase(card) -> tuple:
    """``serve --model resnet50`` and ``--model vgg16`` on the card from a
    JAX-format checkpoint of random weights and BN statistics: the padded
    bucket bit-identical, a closed loop of SERVE50_REQUESTS, and 32 answers
    against the plain forward of the written model. Returns the tap-conv
    launches and the largest logit difference."""
    total, worst = 0, 0.0
    for name in ("resnet50", "vgg16"):
        handle = get(name)
        host = random_bn(handle.init(seed=0), seed=0)
        convs = sum(isinstance(m, (ConvBNAct, Conv2D)) for m in host.modules())
        ckpt = BUILD_DIR / f"smoke_{name}.npz"
        write_jax_checkpoint(host, ckpt)
        cfg = ServeConfig(model=name, checkpoint=str(ckpt), max_batch=64)
        tap_conv.launches.reset()
        t0 = time.perf_counter()
        pool, batcher = serve_stack(handle, cfg, device="cuda", seed=1)
        warm_s = time.perf_counter() - t0
        with batcher:
            e0 = pool.engines[0]
            parity = padded_bucket_parity(e0, handle.in_shape, seed=0)
            report = loadgen.run(batcher, pattern="closed", n_requests=SERVE50_REQUESTS,
                                 concurrency=SERVE_CONCURRENCY, seed=0)
            samples = loadgen.make_samples(32, handle.in_shape, seed=1)
            served = np.stack([f.result(timeout=120)
                               for f in [batcher.submit(s) for s in samples]])
            launches = tap_conv.launches.count
            forwards = e0.stats.warmups + e0.stats.predicts + 1  # +1: parity
        lat = report.latency.summary(scale=1e3)
        with torch.inference_mode(), plain_reference():
            ref = plain_model_forward(host.cuda(), torch.from_numpy(samples).cuda())
            ref = ref.cpu().numpy()
        err = float(np.max(np.abs(served - ref)))
        tol = LOGIT_RTOL * max(1.0, float(np.max(np.abs(ref))))
        print(f"[smoke] serve50 {name}: from {ckpt.name}, buckets {e0.buckets} warmed in "
              f"{warm_s:.2f}s; {parity}; closed loop {report.completed}/{report.requests} "
              f"at concurrency {SERVE_CONCURRENCY}: {report.throughput:.1f} req/s, p50 "
              f"{lat.get('p50', 0):.2f} ms, p99 {lat.get('p99', 0):.2f} ms; tap_conv "
              f"launches {launches} over {forwards} forwards ({convs} convs each); logits "
              f"vs the plain forward max |Δ| {err:.3e} (tol {tol:.1e}) on {card}",
              flush=True)
        if "bit-identical" not in parity:
            fail(f"serve {name}: the padded bucket is not bit-identical")
        if report.completed != SERVE50_REQUESTS:
            fail(f"serve {name}: only {report.completed} requests completed")
        if launches < convs * forwards:
            fail(f"serve {name}: not every conv ran through the kernel")
        if served.shape != (32, 10) or not np.isfinite(served).all() or not err <= tol:
            fail(f"serve {name}: the answers disagree with the plain forward")
        total += launches
        worst = max(worst, err)
    return total, worst


# ---------------------------------------------------------------------------
# The serving control plane: admission, scenarios, chaos, the autoscaler
# ---------------------------------------------------------------------------

SLO_MAX_BATCH = 64
SLO_DIR = BUILD_DIR / "obs"
# (f)'s autoscaler: a p99 target every flash-crowd request misses (the
# coalescing window alone is 2 ms), so the loop scales up under traffic, and
# a window short enough to forget the traffic within a few seconds of its
# end, so it scales back down.
SLO_SCALE_SLO_MS = 1.0
SLO_SCALE_WINDOW_S = 0.2
SLO_SCALE_WAIT_S = 20.0
SLO_KILL_SPEC = "kill-replica@6"
SLO_SLOW_SPEC = "slow-replica@4:400"  # 400 ms > chaos-slow's 150 ms gate


def engine_bytes() -> int:
    """The bytes the card's live tensors asked for, with the cuBLAS
    workspaces dropped: a thread's first cuBLAS call (the head's matmul on
    a new runner thread) takes a workspace of its own (32 MiB on this
    card), which belongs to the thread and not to an engine. Requested,
    not allocated, bytes: the allocator hands a large tensor a whole free
    block when the rest would be under 1 MiB, so the allocated bytes of
    the same tensors depend on where they landed (a hot swap's new
    weights, as many tensors as the old, can read up to a few MiB more).
    Earlier stacks left for the garbage collector are collected first.
    Call it only while no batch runs."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def slo_bundle(run):
    """A live obs bundle (spans, journal, registry) for one slo part."""
    return obs_lib.from_config(ObsConfig(trace=True, dir=str(SLO_DIR)), run=run)


def profiled_scenario(name, batcher, seed):
    """scenarios.run under torch.profiler (CUDA activity): the report and
    the device's idle share of the run's wall time (None when the profiler
    saw no device events)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = scenarios.run(name, batcher, seed=seed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return report, (1 - dev_ms / wall_ms if dev_ms > 0 else None)


#: (journal event, counter) of the serving lifecycle, at either tier.
LIFECYCLE = (("submit", "submitted"), ("complete", "completed"), ("shed", "shed"),
             ("expired", "expired"), ("failed", "failed"))


def settled_journal(bundle, prefix, submitted) -> dict:
    """The journal's counts once its ``prefix`` lifecycle balances at
    ``submitted`` submits: an outcome is journaled a beat after its
    counter moves."""
    return scenarios.settle(
        bundle.journal.counts,
        lambda jc: (obs_lib.conservation(jc, prefix=prefix) is None
                    and jc.get(prefix + "submit", 0) == submitted))[0]


def check_obs(label, bundle, stats, phase="slo") -> None:
    """The journal's lifecycle counts balance and equal ServeStats', the
    registry's serve.* collector equals ServeStats.snapshot(), and the
    trace's spans nest."""
    snap = stats.snapshot()
    jc = settled_journal(bundle, "", snap["submitted"])
    bad = obs_lib.conservation(jc)
    for kind, key in LIFECYCLE:
        if jc.get(kind, 0) != snap[key]:
            bad = f"journal {kind}={jc.get(kind, 0)} != ServeStats {key}={snap[key]}"
    collected = bundle.registry.json_snapshot()["collected"]["serve"]
    if {k: collected[k] for k in snap} != snap:
        bad = "the registry's serve.* counters differ from ServeStats.snapshot()"
    nesting = obs_lib.validate_nesting(bundle.tracer.events())
    if bad or nesting:
        fail(f"{phase} {label}: {bad or nesting[0]}")
    bundle.finish()


def check_slo_launches(label, launches, executed, warmups, extra=0, phase="slo") -> None:
    want = CONVS_PER_FORWARD * (executed + warmups + extra)
    print(f"[smoke] {phase} {label}: tap_conv launches {launches} = {CONVS_PER_FORWARD} x "
          f"({executed} executed batches + {warmups} warm-ups"
          f"{f' + {extra} parity forwards' if extra else ''}): "
          f"{'ok' if launches == want else f'FAIL (want {want})'}", flush=True)
    if launches != want:
        fail(f"{phase} {label}: the batches did not all run through the kernel")


def slo_line(label, report, idle, card) -> None:
    snap = report.server
    lat = report.latency.summary(scale=1e3)
    gates = ", ".join(f"{k}={'ok' if v else 'TRIPPED'}" for k, v in report.gates().items())
    print(f"[smoke] slo {label}: {report.completed}/{report.requests} ok, "
          f"{report.completed / report.seconds:.1f} req/s, p50 {lat.get('p50', 0):.2f} ms, "
          f"p99 {lat.get('p99', 0):.2f} ms, shed rate {report.shed_rate:.3f}, idle "
          f"{'not measured' if idle is None else f'{idle:.1%}'}; server {snap['submitted']} "
          f"submitted = {snap['completed']} + {snap['shed']} shed + {snap['expired']} "
          f"expired + {snap['failed']} failed; gates {'PASS' if report.passed else 'FAIL'} "
          f"({gates}) on {card}", flush=True)
    if not report.conservation_ok or report.errors:
        fail(f"slo {label}: conservation broken ({report.to_dict()})")


def slo_part(label, scenario, cfg, card, seed, chaos=None):
    """One scenario on a fresh ResNet-18 stack from the serve phase's
    checkpoint, its B10 launches checked; returns (batcher, report,
    launches)."""
    bundle = slo_bundle("slo_" + "".join(c for c in label if c.isalnum() or c == "-"))
    tap_conv.launches.reset()
    pool, batcher = serve_stack(get("resnet18"), cfg, device="cuda", seed=1,
                                obs=bundle, chaos=chaos)
    batcher.stats.attach_registry(bundle.registry)
    with batcher:
        report, idle = profiled_scenario(scenario, batcher, seed)
    slo_line(label, report, idle, card)
    check_obs(label, bundle, batcher.stats)
    launches = tap_conv.launches.count
    check_slo_launches(label, launches, batcher.executed, pool.warmups)
    return batcher, report, launches


def served_logits_check(label, batcher, host) -> None:
    samples = loadgen.make_samples(32, (32, 32, 3), seed=5)
    served = np.stack([f.result(timeout=60) for f in [batcher.submit(x) for x in samples]])
    with torch.inference_mode(), plain_reference():
        ref = plain_forward(host.cuda(), torch.from_numpy(samples).cuda()).cpu().numpy()
    err = float(np.max(np.abs(served - ref)))
    tol = LOGIT_RTOL * max(1.0, float(np.max(np.abs(ref))))
    print(f"[smoke] slo {label}: 32 served logits vs the plain model max |Δ| {err:.3e} "
          f"(tol {tol:.1e})", flush=True)
    if served.shape != (32, 10) or not np.isfinite(served).all() or not err <= tol:
        fail(f"slo {label}: served logits disagree with the plain model")


def slo_cli(card, ckpt) -> int:
    """(f) once through ``python -m parallel_cnn_tpu_torch serve``: the
    autoscaler from 1 to 2 replicas through a flash crowd with the trace,
    the journal and the metrics JSON; returns its tap_conv launches."""
    metrics, report_json = SLO_DIR / "slo_cli_metrics.json", SLO_DIR / "slo_cli.json"
    tap_conv.launches.reset()
    out = run_cli(["serve", "--model", "resnet18", "--checkpoint", str(ckpt),
                   "--max-batch", str(SLO_MAX_BATCH), "--autoscale", "--max-replicas", "2",
                   "--slo-ms", str(SLO_SCALE_SLO_MS), "--window-s", str(SLO_SCALE_WINDOW_S),
                   "--scenario", "flash-crowd", "--trace", "--trace-dir", str(SLO_DIR),
                   "--metrics-json", str(metrics), "--json", str(report_json)])
    launches = tap_conv.launches.count
    line = next(ln for ln in out.splitlines() if "tap_conv kernel launches:" in ln).split()
    executed, warmups, parity = int(line[6]), int(line[9]), int(line[13])
    check_slo_launches("(f) CLI", launches, executed, warmups, parity)
    if "gates PASS" not in out or "autoscaler on (1..2 replicas" not in out:
        fail("slo (f) CLI: the scenario's gates or the autoscaler line are missing")
    with open(report_json) as f:
        telemetry = json.load(f)["telemetry"]
    with open(metrics) as f:
        collected = json.load(f)["collected"]["serve"]
    with open(SLO_DIR / "serve_trace.json") as f:
        nesting = obs_lib.validate_nesting(json.load(f)["traceEvents"])
    counts = {}
    for rec in obs_lib.read_journal(str(SLO_DIR / "serve_journal.jsonl")):
        counts[rec["kind"]] = counts.get(rec["kind"], 0) + 1
    if {k: collected[k] for k in telemetry} != telemetry or nesting \
            or obs_lib.conservation(counts) is not None \
            or counts.get("submit") != telemetry["submitted"]:
        fail(f"slo (f) CLI: metrics, trace or journal disagree ({nesting[:1]}, {counts})")
    print(f"[smoke] slo (f) CLI: metrics JSON = telemetry, trace nests, journal "
          f"balanced ({counts.get('submit')} submits, {counts.get('scale_up', 0)} "
          f"scale_up, {counts.get('scale_down', 0)} scale_down) on {card}", flush=True)
    return launches


class _FirstRetireScaler(AutoScaler):
    """slo (f)'s scaler: its loop ends in the tick that retires the first
    replica, so what the phase reads is the state at that retire. A
    retire's drain can outlast the cooldown, after which a scaler left
    running may scale up again on the crowd's window."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.retired = threading.Event()

    def _scale_down(self, now):
        acted = super()._scale_down(now)
        if acted is not None:
            self._stop.set()
            self.retired.set()
        return acted


def slo_phase(card, ckpt, host) -> int:
    """slo (a)-(f): JAX's serving control plane on full-width ResNet-18 from
    the serve phase's checkpoint, every conv through B10. Each part holds
    submitted = completed + shed + expired + failed exactly (client, stats
    and journal), B10's launches at 20 x (executed batches + warm-ups), the
    trace's nesting and the registry against ServeStats. Returns the
    tap_conv launches of the phase."""
    t_phase = time.perf_counter()
    shutil.rmtree(SLO_DIR, ignore_errors=True)
    base = ServeConfig(model="resnet18", checkpoint=str(ckpt), max_batch=SLO_MAX_BATCH)
    total = 0

    # (a) flash-crowd with admission control against without, two stacks.
    for label, cfg in (("(a) flash-crowd, admission", dataclasses.replace(base, admission=True)),
                       ("(a) flash-crowd, no admission", base)):
        total += slo_part(label, "flash-crowd", cfg, card, 0)[2]
    # (b) diurnal, (c) slow-client.
    for label, scenario in (("(b) diurnal", "diurnal"), ("(c) slow-client", "slow-client")):
        total += slo_part(label, scenario, base, card, 0)[2]

    # (d) chaos-kill at two replicas: failover, then the respawn serves.
    cfg = dataclasses.replace(base, n_replicas=2)
    kill = ChaosMonkey.from_spec(SLO_KILL_SPEC)
    bundle = slo_bundle("slo_d")
    tap_conv.launches.reset()
    pool, batcher = serve_stack(get("resnet18"), cfg, device="cuda", seed=1, obs=bundle,
                                chaos=kill)
    batcher.stats.attach_registry(bundle.registry)
    with batcher:
        report, idle = profiled_scenario("chaos-kill", batcher, 0)
        slo_line("(d) chaos-kill", report, idle, card)
        jc = bundle.journal.counts()
        # Every batch that found the replica dead fails over once: the one
        # it died under, and any other already dispatched to it.
        if not kill.kill_replica_fired or not jc.get("failover") \
                or not jc["failover"] == jc.get("replica_evicted") == jc.get("replica_respawned") \
                or pool.routable() != [0, 1]:
            fail(f"slo (d): no failover and respawn ({jc})")
        bundle.journal.flush()
        dead = next(r["replica"] for r in obs_lib.read_journal(bundle.journal.path)
                    if r["kind"] == "replica_evicted")
        parity = padded_bucket_parity(pool.engines[dead], (32, 32, 3), seed=0)
        print(f"[smoke] slo (d) respawned replica {dead}: {parity}", flush=True)
        if "bit-identical" not in parity:
            fail("slo (d): the respawned replica's padded bucket is not bit-identical")
        served_logits_check("(d) after the respawn", batcher, host)
    check_obs("(d)", bundle, batcher.stats)
    check_slo_launches("(d) chaos-kill", tap_conv.launches.count, batcher.executed,
                       pool.warmups, 2)
    total += tap_conv.launches.count

    # (e) chaos-slow with a stall past its 150 ms p99 gate: it MUST fail.
    batcher, report, launches = slo_part("(e) chaos-slow", "chaos-slow", base, card, 0,
                                         chaos=ChaosMonkey.from_spec(SLO_SLOW_SPEC))
    if report.passed or report.gates()["p99"] or not batcher.chaos.slow_replica_fired:
        fail("slo (e): chaos-slow passed its p99 gate through a 400 ms stall")
    total += launches

    # (f) the autoscaler: 1 -> 2 replicas through a flash crowd, then, once
    # the traffic stops, drain -> in-flight 0 -> retire.
    cfg = dataclasses.replace(base, autoscale=True, max_replicas=2,
                              slo_ms=SLO_SCALE_SLO_MS, window_s=SLO_SCALE_WINDOW_S)
    bundle = slo_bundle("slo_f")
    tap_conv.launches.reset()
    pool, batcher = serve_stack(get("resnet18"), cfg, device="cuda", seed=1, obs=bundle)
    batcher.stats.attach_registry(bundle.registry)
    scaler = _FirstRetireScaler(pool, batcher, min_replicas=1, max_replicas=2,
                                slo_ms=cfg.slo_ms, interval_s=0.05, cooldown_s=0.25,
                                obs=bundle)
    scaler.attach_registry(bundle.registry)
    mem0 = engine_bytes()
    with batcher, scaler:
        report, idle = profiled_scenario("flash-crowd", batcher, 1)
        ups = scaler.snapshot()["scale_ups"]
        scaler.retired.wait(SLO_SCALE_WAIT_S)
        scaler.close()  # its loop ended at the first retire; join it
        snap = scaler.snapshot()
    slo_line("(f) autoscale", report, idle, card)
    retired = [i for _, d, i in scaler.actions if d == "down"]
    mem1 = engine_bytes()
    print(f"[smoke] slo (f): {ups} scale-up(s) during the crowd, {snap['scale_downs']} "
          f"drain -> retire after it (replica {retired}, in-flight "
          f"{[batcher.inflight(i) for i in retired]}), {snap['routable']} routable, "
          f"{snap['direction_changes']} direction changes; card memory requested by live "
          f"tensors (cuBLAS workspaces dropped) {mem0} B before, {mem1} B after the retire",
          flush=True)
    if ups < 1 or snap["scale_downs"] < 1 or snap["routable"] != 1 \
            or any(batcher.inflight(i) for i in retired) \
            or any(pool.engines[i].model is not None for i in retired) or mem1 != mem0:
        fail("slo (f): the autoscaler did not scale up and then retire cleanly")
    check_obs("(f)", bundle, batcher.stats)
    check_slo_launches("(f) autoscale", tap_conv.launches.count, batcher.executed,
                       pool.warmups)
    total += tap_conv.launches.count
    total += slo_cli(card, ckpt)
    print(f"[smoke] slo (a)-(f) passed in {time.perf_counter() - t_phase:.1f}s", flush=True)
    return total


# ---------------------------------------------------------------------------
# The network front door: NDJSON over TCP, the supervisor, the hot swap
# ---------------------------------------------------------------------------

NET_DIR = BUILD_DIR / "obs_net"
NET_KILL_SPEC = "kill-endpoint@12"
NET_LORIS_SPEC = "slow-loris@3:400"
# (c)'s read deadline: the 400 ms mid-body stall must outlast it.
NET_LORIS_DEADLINE_MS = 150.0
NET_SWAP_SEED = 7
# (d): the supervisor's respawn backoff, the clients' transport retries
# that ride the respawn, and the control arm's, which give up while the
# endpoint stays dead (tests/test_serve_net.py's policies).
NET_RESPAWN = RetryPolicy(attempts=6, base_delay=0.02, max_delay=0.2, seed=0)
NET_CLIENT_RETRY = RetryPolicy(attempts=8, base_delay=0.05, max_delay=0.5, seed=1)
NET_CONTROL_RETRY = RetryPolicy(attempts=3, base_delay=0.01, max_delay=0.05, seed=1)
# (b): the closed net loop's clients also run in processes of their own,
# as real clients do, so that their JSON encoding and their interpreter
# locks are not the server's. Each process reads "HOST PORT SEED" lines,
# drives its share of the loop once a line and prints one JSON line.
NET_CLIENT_PROCS = 4
WIRE_CLIENT = """
import json, sys, time
from parallel_cnn_tpu_torch.serve import loadgen
n, conc = int(sys.argv[1]), int(sys.argv[2])
samples = loadgen.make_samples(64, (32, 32, 3), seed=0)
print("ready", flush=True)
for line in iter(sys.stdin.readline, ""):
    host, port, seed = line.split()
    t0 = time.monotonic()
    rep = loadgen.run_closed_loop_net((host, int(port)), samples, n_requests=n,
                                      concurrency=conc, seed=int(seed))
    t1 = time.monotonic()
    h = rep.latency
    print(json.dumps({"t0": t0, "t1": t1, "completed": rep.completed, "shed": rep.shed,
                      "expired": rep.expired, "errors": rep.errors, "counts": h.counts,
                      "count": h.count, "sum": h.sum, "min": h.min, "max": h.max}),
          flush=True)
"""


def net_stack(run, cfg):
    """A fresh ResNet-18 stack from the serve phase's checkpoint with a
    live obs bundle, and a WireStats in its registry; the B10 count is
    reset first."""
    bundle = obs_lib.from_config(ObsConfig(trace=True, dir=str(NET_DIR)), run=run)
    tap_conv.launches.reset()
    pool, batcher = serve_stack(get("resnet18"), cfg, device="cuda", seed=1, obs=bundle)
    batcher.stats.attach_registry(bundle.registry)
    wire = WireStats()
    wire.attach_registry(bundle.registry)
    return bundle, pool, batcher, wire


def net_line(label, report, card, must_pass=True) -> None:
    w, snap = report.wire, report.server
    lat = report.latency.summary(scale=1e3)
    gates = ", ".join(f"{k}={'ok' if v else 'TRIPPED'}" for k, v in report.gates().items())
    print(f"[smoke] net {label}: {report.completed}/{report.requests} ok, "
          f"{report.completed / report.seconds:.1f} req/s, p50 {lat.get('p50', 0):.2f} ms, "
          f"p99 {lat.get('p99', 0):.2f} ms, {report.errors} errors; wire {w['submitted']} "
          f"submitted = {w['completed']} + {w['shed']} shed + {w['expired']} expired + "
          f"{w['failed']} failed ({w['reaped']} reaped, {w['endpoint_deaths']} endpoint "
          f"deaths); batcher {snap['submitted']} submitted = {snap['completed']} + "
          f"{snap['shed']} shed + {snap['expired']} expired + {snap['failed']} failed; "
          f"gates {'PASS' if report.passed else 'FAIL'} ({gates}) on {card}", flush=True)
    if not report.wire_ok:
        fail(f"net {label}: the wire does not balance ({w})")
    if must_pass and not report.passed:
        fail(f"net {label}: a gate tripped ({report.to_dict()})")


def check_net(label, bundle, pool, batcher, wire, extra=0) -> int:
    """Each tier held to its own law once the traffic has stopped: the
    wire's counters balance, the journal's net_ lifecycle balances and
    equals them, the registry's wire.* equals WireStats; then the batcher
    tier (check_obs) and B10's launches. Returns the launches."""
    delta, balanced = scenarios.settled_wire_delta(wire, {})
    jc = settled_journal(bundle, "net_", delta["submitted"])
    bad = None if balanced else f"wire imbalanced {delta}"
    bad = bad or obs_lib.conservation(jc, prefix="net_")
    for kind, key in LIFECYCLE:
        if jc.get("net_" + kind, 0) != delta[key]:
            bad = bad or f"journal net_{kind}={jc.get('net_' + kind, 0)} != wire {key}"
    if bundle.registry.json_snapshot()["collected"]["wire"] != wire.snapshot():
        bad = bad or "the registry's wire.* counters differ from WireStats"
    print(f"[smoke] net {label}: wire {delta['submitted']} submitted = {delta['completed']} "
          f"+ {delta['shed']} shed + {delta['expired']} expired + {delta['failed']} failed, "
          f"journal net_submit {jc.get('net_submit', 0)} = net_complete "
          f"{jc.get('net_complete', 0)} + net_shed {jc.get('net_shed', 0)} + net_expired "
          f"{jc.get('net_expired', 0)} + net_failed {jc.get('net_failed', 0)}: "
          f"{'ok' if bad is None else bad}", flush=True)
    if bad is not None:
        fail(f"net {label}: {bad}")
    check_obs(label, bundle, batcher.stats, phase="net")
    launches = tap_conv.launches.count
    check_slo_launches(label, launches, batcher.executed, pool.warmups, extra, phase="net")
    return launches


def wire_logits_check(label, address, model) -> None:
    """32 requests over the wire against the plain-version model on the
    card (a copy: the caller's host model stays where it is)."""
    samples = loadgen.make_samples(32, (32, 32, 3), seed=5)
    with loadgen.NetClient(address, timeout_s=60.0) as nc:
        served = np.stack([nc.request(x) for x in samples])
    with torch.inference_mode(), plain_reference():
        ref = plain_forward(copy.deepcopy(model).cuda(),
                            torch.from_numpy(samples).cuda()).cpu().numpy()
    err = float(np.max(np.abs(served - ref)))
    tol = LOGIT_RTOL * max(1.0, float(np.max(np.abs(ref))))
    print(f"[smoke] net {label}: 32 wire-served logits vs the plain model max |Δ| "
          f"{err:.3e} (tol {tol:.1e})", flush=True)
    if served.shape != (32, 10) or not np.isfinite(served).all() or not err <= tol:
        fail(f"net {label}: wire-served logits disagree with the plain model")


def wire_host_ms(samples) -> str:
    """The interpreter time of one request's JSON at each end of the wire:
    the client's encode (``encode_request``: ``tolist`` + ``json.dumps``)
    and the handler's decode (``json.loads`` + ``np.asarray``), medians
    over the samples, on this machine's host."""
    enc, dec = [], []
    for i, x in enumerate(samples):
        t0 = time.perf_counter()
        line = encode_request(i, x)
        t1 = time.perf_counter()
        back = np.asarray(json.loads(line)["x"], dtype=np.float32)
        dec.append(time.perf_counter() - t1)
        enc.append(t1 - t0)
        if not np.array_equal(back, x):
            fail("net (b): a request's x did not survive its JSON round trip")
    return (f"encode {float(np.median(enc)) * 1e3:.3f} ms (client), decode "
            f"{float(np.median(dec)) * 1e3:.3f} ms (handler), {len(line)} bytes a line")


@contextlib.contextmanager
def wire_client_procs(procs=NET_CLIENT_PROCS):
    """``procs`` client processes running WIRE_CLIENT (the loadgen's
    NetClients; no card), started at once so that their imports overlap
    the caller's work. Yields ``run(address, seed)``: every process drives
    SERVE_REQUESTS/procs requests from SERVE_CONCURRENCY/procs clients at
    the same moment, and one LoadgenReport holds them all, its seconds
    from the first start to the last end (one monotonic clock). Every
    process is stopped on the way out."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    children = [subprocess.Popen(
        [sys.executable, "-c", WIRE_CLIENT, str(SERVE_REQUESTS // procs),
         str(SERVE_CONCURRENCY // procs)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env, text=True,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE) for _ in range(procs)]
    waiting = list(children)

    def read(child):
        line = child.stdout.readline()
        if not line:
            fail(f"net (b): a client process ended (rc {child.poll()})")
        return line

    def run(address, seed):
        while waiting:
            read(waiting.pop())
        for i, child in enumerate(children):
            child.stdin.write(f"{address[0]} {address[1]} {seed * procs + i}\n")
            child.stdin.flush()
        outs = [json.loads(read(child)) for child in children]
        latency = Histogram()
        for o in outs:
            part = Histogram()
            part.counts, part.count, part.sum = o["counts"], o["count"], o["sum"]
            part.min, part.max = o["min"], o["max"]
            latency.merge(part)
        return loadgen.LoadgenReport(
            pattern=f"closed-net from {procs} processes", requests=SERVE_REQUESTS,
            completed=sum(o["completed"] for o in outs), shed=sum(o["shed"] for o in outs),
            expired=sum(o["expired"] for o in outs), errors=sum(o["errors"] for o in outs),
            seconds=max(o["t1"] for o in outs) - min(o["t0"] for o in outs),
            latency=latency)

    try:
        yield run
    finally:
        for child in children:
            with contextlib.suppress(OSError):
                child.stdin.close()
        for child in children:
            try:
                child.wait(timeout=10)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()


def net_cli(card, ckpt) -> int:
    """(f) through ``python -m parallel_cnn_tpu_torch serve --listen
    --supervise``: net-kill-endpoint with the endpoint killed at wire
    request 12; returns its tap_conv launches."""
    tap_conv.launches.reset()
    out = run_cli(["serve", "--model", "resnet18", "--checkpoint", str(ckpt),
                   "--max-batch", str(SLO_MAX_BATCH), "--listen", "--supervise",
                   "--scenario", "net-kill-endpoint", "--chaos", NET_KILL_SPEC])
    launches = tap_conv.launches.count
    line = next(ln for ln in out.splitlines() if "tap_conv kernel launches:" in ln).split()
    executed, warmups, parity = int(line[6]), int(line[9]), int(line[13])
    check_slo_launches("(f) CLI", launches, executed, warmups, parity, phase="net")
    wire = next((ln for ln in out.splitlines() if ln.startswith("[serve] wire: ")), "")
    if "[serve] gates PASS" not in out or "(balanced;" not in wire \
            or not wire.endswith("1 endpoint deaths, 1 respawns)"):
        fail(f"net (f) CLI: no PASS or no balanced wire line with 1 respawn ({wire!r})")
    print(f"[smoke] net (f) CLI: gates PASS, {wire[len('[serve] '):]} on {card}", flush=True)
    return launches


def net_phase(card, ckpt, host) -> int:
    """net (a)-(f): JAX's network front door on full-width ResNet-18 from
    the serve phase's checkpoint, every conv through B10, over loopback
    sockets on ephemeral ports. Each part holds the wire (WireStats and
    the journal's net_ events), the batcher (ServeStats and the journal)
    and B10's launches to their own laws. Returns the phase's tap_conv
    launches."""
    t_phase = time.perf_counter()
    shutil.rmtree(NET_DIR, ignore_errors=True)
    base = ServeConfig(model="resnet18", checkpoint=str(ckpt), max_batch=SLO_MAX_BATCH)
    total = 0

    # (a) net-steady and the wire-served logits; (b) the closed loop over
    # the wire beside the in-process loop, on the same stack.
    bundle, pool, batcher, wire = net_stack("net_ab", base)
    with wire_client_procs() as procs_loop, batcher, \
            NetServer(batcher, wire=wire, obs=bundle).start() as srv:
        report = scenarios.run_net("net-steady", batcher, wire=wire, server=srv,
                                   obs=bundle, seed=0)
        net_line("(a) net-steady", report, card)
        wire_logits_check("(a)", srv.address, host)
        samples = loadgen.make_samples(64, (32, 32, 3), seed=0)
        apart = procs_loop(srv.address, seed=0)
        over = loadgen.run_closed_loop_net(srv.address, samples, n_requests=SERVE_REQUESTS,
                                           concurrency=SERVE_CONCURRENCY, seed=0)
        inproc = loadgen.run(batcher, pattern="closed", n_requests=SERVE_REQUESTS,
                             concurrency=SERVE_CONCURRENCY, seed=0, samples=samples)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            profiled = procs_loop(srv.address, seed=1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    for rep in (apart, over, inproc, profiled):
        if rep.completed != SERVE_REQUESTS or rep.errors:
            fail(f"net (b): {rep.pattern} completed {rep.completed}/{SERVE_REQUESTS}")
    print(f"[smoke] net (b) host time a request, median of 64: {wire_host_ms(samples)}",
          flush=True)
    lat = {rep.pattern: rep.latency.summary(scale=1e3) for rep in (apart, over, inproc)}
    print(f"[smoke] net (b) closed loop, {SERVE_REQUESTS} requests from {SERVE_CONCURRENCY} "
          f"clients on one stack: " + "; ".join(
              f"{where} {rep.throughput:.1f} req/s, p50 {lat[rep.pattern]['p50']:.2f} ms, "
              f"p99 {lat[rep.pattern]['p99']:.2f} ms"
              for where, rep in (
                  (f"over the wire from {NET_CLIENT_PROCS} client processes", apart),
                  ("over the wire from the server's process", over),
                  ("in process", inproc)))
          + f" (wire / in-process {apart.throughput / inproc.throughput:.3f} and "
          f"{over.throughput / inproc.throughput:.3f}); profiled over the wire from "
          f"{NET_CLIENT_PROCS} client processes {profiled.throughput:.1f} req/s, idle "
          f"{'not measured' if dev_ms == 0 else f'{1 - dev_ms / wall_ms:.1%}'} "
          f"(this call, on {card})", flush=True)
    total += check_net("(a)-(b)", bundle, pool, batcher, wire)

    # (c) net-slow-loris: one client stalls mid-request past the read
    # deadline; the server reaps it as expired.
    bundle, pool, batcher, wire = net_stack("net_c", base)
    loris = ChaosMonkey.from_spec(NET_LORIS_SPEC)
    with batcher, NetServer(batcher, wire=wire, obs=bundle,
                            conn_deadline_ms=NET_LORIS_DEADLINE_MS).start() as srv:
        report = scenarios.run_net("net-slow-loris", batcher, wire=wire, server=srv,
                                   chaos=loris, obs=bundle, seed=0)
    net_line("(c) net-slow-loris", report, card)
    if not loris.slow_loris_fired or report.wire["reaped"] < 1:
        fail("net (c): the slow-loris connection was not reaped")
    total += check_net("(c)", bundle, pool, batcher, wire)

    # (d) net-kill-endpoint: supervised, one respawn on the same port and
    # the wire balanced across it; unsupervised, the gate must trip.
    bundle, pool, batcher, wire = net_stack("net_d", base)
    with batcher:
        kill = ChaosMonkey.from_spec(NET_KILL_SPEC)
        sup = Supervisor(armed_factory(batcher, wire, kill, obs=bundle),
                         policy=NET_RESPAWN, obs=bundle).start()
        port = sup.address[1]
        with sup:
            report = scenarios.run_net("net-kill-endpoint", batcher, wire=wire,
                                       supervisor=sup, obs=bundle, seed=0,
                                       retry=NET_CLIENT_RETRY)
            respawned_on = sup.address[1]
        net_line("(d) net-kill-endpoint, supervised", report, card)
        bundle.journal.flush()
        respawn = [r for r in obs_lib.read_journal(bundle.journal.path)
                   if r["kind"] == "endpoint_respawned"]
        print(f"[smoke] net (d): {sup.respawns} respawn on port {respawned_on} (first "
              f"{port}), downtime {respawn[0]['downtime_ms'] if respawn else float('nan'):.1f}"
              f" ms, {report.wire['failed']} in-flight wire requests journaled net_failed",
              flush=True)
        if sup.respawns != 1 or sup.gave_up or respawned_on != port or len(respawn) != 1 \
                or report.wire["endpoint_deaths"] != 1 or report.errors:
            fail("net (d): the supervisor did not respawn the endpoint once on its port")
        # The control arm on the same stack and WireStats (run_net judges
        # its own delta; check_net the sum of both arms).
        kill = ChaosMonkey.from_spec(NET_KILL_SPEC)
        control = Supervisor(armed_factory(batcher, wire, kill, obs=bundle),
                             enabled=False, obs=bundle).start()
        with control:
            report = scenarios.run_net("net-kill-endpoint", batcher, wire=wire,
                                       supervisor=control, obs=bundle, seed=0,
                                       retry=NET_CONTROL_RETRY)
        net_line("(d) net-kill-endpoint, unsupervised", report, card, must_pass=False)
        if report.passed or not report.errors or control.respawns:
            fail("net (d): the unsupervised kill passed its gates")
    total += check_net("(d) both arms", bundle, pool, batcher, wire)

    # (e) net-hot-swap-diurnal: seed-7 weights rolled in mid-peak.
    bundle, pool, batcher, wire = net_stack("net_e", base)
    new = random_bn(get("resnet18").init(seed=NET_SWAP_SEED), seed=NET_SWAP_SEED)
    with batcher, NetServer(batcher, wire=wire, obs=bundle).start() as srv:
        mem0 = engine_bytes()
        report = scenarios.run_net("net-hot-swap-diurnal", batcher, wire=wire, server=srv,
                                   swap_model=new, obs=bundle, seed=0)
        mem1 = engine_bytes()
        net_line("(e) net-hot-swap-diurnal", report, card)
        swap = report.swap
        print(f"[smoke] net (e): swapped {swap['swapped']} -> grown {swap['grown']} in "
              f"{swap['seconds'] * 1e3:.1f} ms, failed_delta {swap['failed_delta']}, stuck "
              f"{swap['stuck']}; card memory requested by live tensors (cuBLAS workspaces "
              f"dropped) {mem0} B before, {mem1} B after the retire", flush=True)
        if swap["failed_delta"] != 0 or swap["stuck"] or not swap["swapped"] \
                or mem1 != mem0 or any(pool.engines[i].model is not None
                                       for i in swap["swapped"]):
            fail("net (e): the hot swap failed a request, stuck, or kept card memory")
        wire_logits_check("(e) after the swap", srv.address, new)
    total += check_net("(e)", bundle, pool, batcher, wire)
    xs = loadgen.make_samples(32, (32, 32, 3), seed=6)
    swapped = pool.engines[swap["grown"][0]].predict(xs)
    fresh = Engine(get("resnet18"), model=new, max_batch=SLO_MAX_BATCH, device="cuda")
    same = np.array_equal(swapped, fresh.predict(xs))
    fresh.release()
    print(f"[smoke] net (e): the swapped replica's b32 logits vs a fresh engine from the "
          f"seed-{NET_SWAP_SEED} weights: {'bit-identical' if same else 'MISMATCH'}",
          flush=True)
    if not same:
        fail("net (e): the swapped replica does not serve the new weights")

    # (f) the CLI, supervised, through a killed endpoint.
    total += net_cli(card, ckpt)
    print(f"[smoke] net (a)-(f) passed in {time.perf_counter() - t_phase:.1f}s", flush=True)
    return total


@contextlib.contextmanager
def without_compiler():
    """$CXX names no compiler inside: the native library cannot be built,
    so the zoo's native loader takes the NumPy twin."""
    prev = os.environ.get("CXX")
    os.environ["CXX"] = "/nonexistent/c++"
    try:
        if native.available():
            fail("the native library still loads without a compiler")
        yield
    finally:
        if prev is None:
            del os.environ["CXX"]
        else:
            os.environ["CXX"] = prev


def native_phase(card) -> None:
    """The native C++ runtime on the card's host: (a) seeded idx files
    through the binding's parser against the NumPy parser; (b) --prefetch
    native LeNet-ref training (--ops cuda, one epoch of the 60,000 set)
    against the NumPy twin's run, bit for bit; (c) the zoo's --zoo-loader
    native on ResNet-18 against the twin, bit for bit. A library that does
    not build fails here: native is asked for by name."""
    t0 = time.perf_counter()
    native.load_lib()
    print(f"[smoke] native: {native.library_path().name} (from native/*.cc, built "
          f"at first use) ready in {time.perf_counter() - t0:.2f}s", flush=True)
    work = BUILD_DIR / "smoke_native"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    imgs, labels = synthetic.make_dataset(NATIVE_IDX_COUNT, seed=3)
    ip, lp = str(work / "imgs.idx3-ubyte"), str(work / "labels.idx1-ubyte")
    mnist.write_idx_images(ip, imgs)
    mnist.write_idx_labels(lp, labels)
    t0 = time.perf_counter()
    got = native.load_pair(ip, lp)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = mnist.load_pair(ip, lp)
    t_numpy = time.perf_counter() - t0
    same = all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))
    print(f"[smoke] native (a): {NATIVE_IDX_COUNT} idx images parsed by the binding "
          f"({t_native * 1e3:.1f} ms) and by NumPy ({t_numpy * 1e3:.1f} ms): "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not same:
        fail("the native idx parser disagrees with the NumPy parser")

    base = ["--batch-size", str(TRAIN_BATCH), "--shuffle", "--ops", "cuda", "--epochs", "1"]
    runs = {}
    for mode in ("native", "twin"):
        lenet_fused.launches.reset()
        ring = native.ring_batches.count
        run_cli(base + ["--prefetch", "native" if mode == "native" else "auto",
                        "--checkpoint-dir", str(work / mode),
                        "--metrics", str(work / f"{mode}.jsonl")])
        runs[mode] = (lenet_fused.launches.count, native.ring_batches.count - ring,
                      final_record(work / f"{mode}.jsonl")["images_per_sec"],
                      checkpoint_leaves(work / mode / "ckpt_1.npz"))
    (nl, nr, nrate, na), (tl, tr, trate, ta) = runs["native"], runs["twin"]
    same = sorted(na) == sorted(ta) and all(np.array_equal(na[k], ta[k]) for k in na)
    print(f"[smoke] native (b): --prefetch native: {nr} ring batches, lenet_fused "
          f"launches {nl}, {nrate:.0f} img/s; --prefetch auto (the NumPy twin's order "
          f"gathered on the card): {tr} ring batches, launches {tl}, {trate:.0f} img/s; params "
          f"{'bit-identical' if same else 'DIFFER'} (this call, on {card})", flush=True)
    if not same or nl != tl or nl != STEPS_PER_EPOCH or nr != STEPS_PER_EPOCH or tr:
        fail("--prefetch native and its twin did not train the same LeNet on the "
             "same launches")

    zoo_base = ["--model", "resnet18", "--conv-backend", "cuda", "--fused-step",
                "--act-dtype", "float32", "--batch-size", str(ZOO_BATCH), "--epochs", "1",
                "--zoo-loader", "native", "--synthetic-train-count",
                str(NATIVE_ZOO_STEPS * ZOO_BATCH), "--synthetic-test-count",
                str(ZOO_EVAL_BATCH)]
    zruns = {}
    for mode in ("native", "twin"):
        ctx = without_compiler() if mode == "twin" else contextlib.nullcontext()
        with ctx:
            ring = native.ring_batches.count
            run_cli(zoo_base + ["--checkpoint-dir", str(work / f"zoo_{mode}")])
            zruns[mode] = (native.ring_batches.count - ring,
                           checkpoint_leaves(work / f"zoo_{mode}" / "ckpt_1.npz"))
    (nr, na), (tr, ta) = zruns["native"], zruns["twin"]
    same = sorted(na) == sorted(ta) and all(np.array_equal(na[k], ta[k]) for k in na)
    print(f"[smoke] native (c): ResNet-18 --zoo-loader native, {NATIVE_ZOO_STEPS} steps: "
          f"{nr} ring batches; the twin {tr}; state ({len(na)} leaves) "
          f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
    if not same or nr != NATIVE_ZOO_STEPS or tr:
        fail("the zoo's native loader and its twin did not train the same ResNet-18")


# ---------------------------------------------------------------------------
# bf16 activations on the zoo's fused step (bf16 (a)-(e)): the bf16 forms of
# B10 (forward and dgrad), B11 and B12, f32 masters, the loss scales
# ---------------------------------------------------------------------------

# A bf16 form against its twin (the f32 function of the same bf16 operands,
# rounded once): one bf16 ulp of the output's scale, the two summing in
# other orders before the one rounding.
BF16_RTOL = 2.0 ** -7
# bf16 (b): 3 bf16 steps against 3 f32 steps from one state, by loss: JAX's
# own bound for its bf16 fused step against the f32 one
# (tests/test_fused_step.py).
BF16_LOSS_RTOL = 1e-2
BF16_FUSED = FusedStepConfig(update=False, act_dtype="bfloat16")
BF16_DP_FUSED = FusedStepConfig(update=True, act_dtype="bfloat16")
# bf16 (d): the dynamic scale's growth through the library entry point (the
# CLI has no flag for it), after this many clean steps.
BF16_GROWTH_INTERVAL = 2
# The per-step launches of ResNet-18's bf16 step, by form: every conv
# forward, dgrad and wgrad, on the tensor cores where tap_conv.wgmma_form
# takes the conv (19) and on the FFMA forms elsewhere (the stem, which has
# no dgrad: its input batch needs no gradient); one tail.
WGMMA_CONVS = sum(g[-1] for g in GEOMETRIES if tap_conv.wgmma_form(g[2], g[3], g[4]))
BF16_PER_STEP = {"tap_conv.wgmma": WGMMA_CONVS, "tap_conv.ffma": CONVS_PER_FORWARD - WGMMA_CONVS,
                 "tap_conv_dgrad.wgmma": WGMMA_CONVS,
                 "tap_conv_dgrad.ffma": CONVS_PER_FORWARD - 1 - WGMMA_CONVS,
                 "tap_wgrad.wgmma": WGMMA_CONVS,
                 "tap_wgrad.ffma": CONVS_PER_FORWARD - WGMMA_CONVS, "tail_ce": 1}


def bf16_counts():
    return {"tap_conv.wgmma": tap_conv.wgmma_launches.count,
            "tap_conv.ffma": tap_conv.bf16_launches.count,
            "tap_conv_dgrad.wgmma": tap_conv.wgmma_dgrad_launches.count,
            "tap_conv_dgrad.ffma": tap_conv.bf16_dgrad_launches.count,
            "tap_wgrad.wgmma": tap_wgrad.wgmma_launches.count,
            "tap_wgrad.ffma": tap_wgrad.bf16_launches.count, "tail_ce": tail.bf16_launches.count}


def bf16_bound_ms(x_shape, k, cin, cout, stride, kind):
    """Least time for one bf16 conv pass on this card: its multiply-adds at
    the dense bf16 tensor-core peak against its bytes (2 a value: each
    input it reads once, its output once) at the HBM rate. ``kind`` is
    "forward" (reads the input pixels the conv uses and w, writes y),
    "dgrad" (reads g and w, writes dx) or "wgrad" (reads the pixels and g,
    writes gw)."""
    n, h, wd, _ = x_shape
    oh, ow = -(-h // stride), -(-wd // stride)
    flops = 2.0 * n * oh * ow * cout * k * k * cin
    g_elems = n * oh * ow * cout
    w_elems = k * k * cin * cout
    x_read = n * lines_read(h, k, stride) * lines_read(wd, k, stride) * cin
    elems = {"forward": x_read + w_elems + g_elems,
             "dgrad": g_elems + w_elems + n * h * wd * cin,
             "wgrad": x_read + g_elems + w_elems}[kind]
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = 2.0 * elems / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bf16_tail_bound_ms(x, w):
    """B12's bf16 form: x, w and b read once (2 bytes a value), the labels
    (8) and loss and dlogits (4, f32) once; 2·B·D·K operations."""
    n, k = x.shape[0], w.shape[1]
    nbytes = 2.0 * (x.numel() + w.numel() + k) + 8.0 * n + 4.0 * (n + n * k)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 2.0 * n * w.shape[0] * k / PEAK_BF16_FLOPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_conv_bf16(x, w, stride):
    """cuDNN's bf16 conv (F.conv2d) on the SAME-padded channels-last input,
    padded outside the timing: the yardstick of the bf16 forward. The port
    never calls it."""
    k = w.shape[0]
    _, pt, pb = tap_conv.same_pads(x.shape[1], k, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (pt, pb, pt, pb)).contiguous(
        memory_format=torch.channels_last)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xp, wl, stride=stride)


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds a call of ``fn`` takes to return (the launch and
    everything the wrapper does before it), the device kept busy behind it
    and synchronised only after the timing."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def bf16_geometry_checks(label, geometries, batch, gen, time_plain) -> tuple:
    """bf16 (a) at each geometry at ``batch``: B10's forward and dgrad (and
    the rows of a 37-image bucket of the same images, bit for bit) and B11
    in bf16 against their twins (BF16_RTOL, relaunch bit for bit), each
    timed beside the bound, cuDNN's bf16 call and, with ``time_plain``,
    the twin. Where ``tap_conv.wgmma_form`` takes the conv, the path's
    forward, dgrad and wgrad run on the tensor cores, and their FFMA forms
    (called through their own functions, for this comparison only) are
    held against the same twins and timed beside them. A stem's dgrad is
    not on the path and is skipped. Returns each kernel's largest difference and its times
    summed over one forward's or one microbatch's convs: the path's forms
    ("ms"), and the FFMA forms at every conv ("ffma_ms")."""
    errs = dict.fromkeys(("tap_conv", "tap_conv_dgrad", "tap_wgrad"), 0.0)
    sums = {key: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
                                "ffma_ms"), 0.0)
            for key in errs}
    bf16 = torch.bfloat16
    for name, h, cin, cout, k, s, _, _, count in geometries:
        x, w, g = (t.to(bf16) for t in grad_inputs(h, cin, cout, k, s, gen, batch))
        tag = f"bf16 {label} {name:26s} b{batch}"
        wgmma = tap_conv.wgmma_form(cin, cout, k)
        kinds = [("tap_conv", "forward")] + ([] if name.startswith("stem") else
                                             [("tap_conv_dgrad", "dgrad")]) + [
            ("tap_wgrad", "wgrad")]
        for key, kind in kinds:
            ffma_fn = None
            if kind == "forward":
                fn = lambda: tap_conv.conv2d(x, w, s)  # noqa: E731
                ffma_fn = lambda: tap_conv.conv2d_bf16_ffma(x, w, s)  # noqa: E731
                plain_fn = lambda: tap_conv.bf16_twin(  # noqa: E731
                    tap_conv.conv2d_plain, x, w, stride=s)
                lib = library_conv_bf16(x, w, s)
            elif kind == "dgrad":
                fn = lambda: tap_conv.conv2d_dgrad(g, w, x.shape, s)  # noqa: E731
                ffma_fn = lambda: tap_conv.conv2d_dgrad_bf16_ffma(  # noqa: E731
                    g, w, x.shape, s)
                plain_fn = lambda: tap_conv.bf16_twin(  # noqa: E731
                    tap_conv.conv2d_dgrad_plain, g, w, x_shape=x.shape, stride=s)
                lib = library_grad(x, w, g, s, True)
            else:
                fn = lambda: tap_wgrad.conv2d_wgrad(x, g, k, s)  # noqa: E731
                ffma_fn = lambda: tap_wgrad.conv2d_wgrad_bf16_ffma(x, g, k, s)  # noqa: E731
                plain_fn = lambda: tap_conv.bf16_twin(  # noqa: E731
                    tap_wgrad.conv2d_wgrad_plain, x, g, k=k, stride=s)
                lib = library_grad(x, w, g, s, False)
            form = "tensor-core" if wgmma and ffma_fn is not None else "FFMA"
            got, again = fn(), fn()
            with plain_reference():
                want = plain_fn()
            torch.cuda.synchronize()
            errs[key] = max(errs[key], within(f"{tag} {key} ({form})", got, want, again,
                                              BF16_RTOL))
            if kind == "forward" and batch > 37:
                rows = tap_conv.conv2d(x[:37], w, s)
            elif kind == "dgrad" and batch > 37:
                rows = tap_conv.conv2d_dgrad(g[:37], w, (37,) + tuple(x.shape[1:]), s)
            else:
                rows = None
            if rows is not None and not torch.equal(rows, got[:37]):
                fail(f"{tag} {key}: a 37-image bucket's rows differ from the same "
                     f"images' rows at b{batch}")
            ms = cuda_ms(fn, reps=10)
            plain = float("nan")
            if time_plain:
                with plain_reference():
                    plain = cuda_ms(plain_fn, reps=3, warmup=1)
            lib_ms = cuda_ms(lib, reps=10)
            bound, by = bf16_bound_ms(x.shape, k, cin, cout, s, kind)
            print(f"[smoke] time {tag} {key} ({form}): kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, cuDNN bf16 {lib_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({by}), {bound / ms:.1%} of bound, {ms / lib_ms:.2f}x cuDNN bf16's "
                  f"time", flush=True)
            ffma_ms = ms
            if form == "tensor-core":
                f_got, f_again = ffma_fn(), ffma_fn()
                torch.cuda.synchronize()
                errs[key] = max(errs[key], within(f"{tag} {key} (FFMA)", f_got, want,
                                                  f_again, BF16_RTOL))
                ffma_ms = cuda_ms(ffma_fn, reps=10)
                print(f"[smoke] time {tag} {key} (FFMA, timed only): kernel {ffma_ms:.4f} "
                      f"ms, {bound / ffma_ms:.1%} of bound, {ffma_ms / lib_ms:.2f}x cuDNN "
                      f"bf16's time; the tensor-core form {ffma_ms / ms:.2f}x faster",
                      flush=True)
            for field, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib_ms),
                             ("bound_ms", bound), ("ffma_ms", ffma_ms)):
                sums[key][field] += count * v
            if by == "operations":
                sums[key]["ops_ms"] += count * bound
        del x, w, g
    for key, rec in sums.items():
        if not rec["ms"]:  # a table of stems alone has no dgrad
            continue
        print(f"[smoke] time bf16 {label} {key} summed over the convs of one "
              f"{'forward' if key == 'tap_conv' else 'microbatch'} at b{batch}: "
              + ", ".join(f"{f} {v:.3f}" for f, v in rec.items() if f != "ops_ms")
              + f"; the path's forms at {rec['bound_ms'] / rec['ms']:.1%} of the bound, "
              f"the FFMA forms at {rec['bound_ms'] / rec['ffma_ms']:.1%}", flush=True)
    return errs, sums


def bf16_host_times(card) -> None:
    """The "time ... host" lines: the host microseconds of one bf16 launch
    of each form of the forward, the dgrad and the wgrad (the wrappers'
    launches, checks, planning and the tensor-core forms' map encodes
    included), in turns (tensor-core, FFMA, FFMA, tensor-core), at
    ResNet-18's 3x3/s1 128 conv at b128; then what the encodes cost: the
    forward's two forms' C entries called alone through ctypes, in turns."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    x, w, g = (t.to(torch.bfloat16)
               for t in grad_inputs(16, 128, 128, 3, 1, gen, ZOO_BATCH + 64))
    xb, gb = x[:ZOO_BATCH], g[:ZOO_BATCH]
    pairs = {"forward": (lambda: tap_conv._launch(xb, w, None, None, None, 1, False),
                         lambda: tap_conv._launch(xb, w, None, None, None, 1, False,
                                                  ffma=True)),
             "dgrad": (lambda: tap_conv._launch_dgrad(gb, w, xb.shape, 1),
                       lambda: tap_conv._launch_dgrad(gb, w, xb.shape, 1, ffma=True)),
             "wgrad": (lambda: tap_wgrad._launch(xb, gb, 3, 1),
                       lambda: tap_wgrad._launch(xb, gb, 3, 1, ffma=True))}
    parts = []
    for kind, (tc_fn, ffma_fn) in pairs.items():
        a1, b1, b2, a2 = host_us(tc_fn), host_us(ffma_fn), host_us(ffma_fn), host_us(tc_fn)
        parts.append(f"{kind} tensor-core {a1:.1f} / {a2:.1f}, FFMA {b1:.1f} / {b2:.1f}")
    print(f"[smoke] time bf16 host us a launch (3x3/s1 128 b{ZOO_BATCH}, in turns, "
          f"wrapper and C entry, the maps' encodes included): {'; '.join(parts)} (this "
          f"call, on {card})", flush=True)
    lib = tap_conv.build().get()
    out = torch.empty((ZOO_BATCH, 16, 16, 128), device="cuda", dtype=torch.bfloat16)
    geo = (xb.data_ptr(), w.data_ptr(), out.data_ptr(), ZOO_BATCH, 16, 16, 128, 16, 16, 128,
           3, 1, 1, 1)
    tile = tap_conv.forward_tile(ZOO_BATCH, 16, 16, 128, 128, 3)
    stream = torch.cuda.current_stream().cuda_stream

    def entry(fn, *extra):
        def call():
            err = fn(*geo, *extra, stream)
            if err:
                fail(f"a bf16 forward C entry refused its launch: cudaError {err}")
        return call

    tc_c = entry(lib.tap_conv_forward_wgmma, *tap_conv.conv_rect(16, 16))
    ffma_c = entry(lib.tap_conv_forward_bf16, tile)
    a1, b1, b2, a2 = host_us(tc_c), host_us(ffma_c), host_us(ffma_c), host_us(tc_c)
    print(f"[smoke] time bf16 host us a forward C entry call, in turns: tensor-core (two "
          f"map encodes and the launch) {a1:.2f} / {a2:.2f}, FFMA (the launch) {b1:.2f} / "
          f"{b2:.2f} (this call, on {card})", flush=True)


def bf16_kernel_phase() -> tuple:
    """bf16 (a): every bf16 form against its twin on the card at the main
    path's shapes: ResNet-18's convs at b128, ResNet-50's 24 distinct convs
    at b128 and its 224x224 stem at b32 (forward, dgrad, wgrad), B12's gap
    at ResNet-18's and ResNet-50's CIFAR heads and the ImageNet head (its
    rows at b1, b7, b32 against b128 too), max2 at the CIFAR CNN's, each
    timed in turns with the f32 form. Returns (largest differences, the records' times: ResNet-18's step sums
    at b128 and its gap tail; and ResNet-50's microbatch sums)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    errs, r18 = bf16_geometry_checks("ResNet-18", GEOMETRIES, ZOO_BATCH, gen, True)
    for table, batch, label in ((R50_GEOMETRIES, Z50_BATCH, "ResNet-50"),
                                ([STEM224], STEM224_BATCH, "ResNet-50 ImageNet")):
        e, sums = bf16_geometry_checks(label, table, batch, gen, False)
        errs = {key: max(errs[key], e[key]) for key in errs}
        if label == "ResNet-50":
            r50 = sums
    times = {}
    for key, rec in r18.items():
        times[key] = dict(ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                          bound_by=("operations" if rec["ops_ms"] >= rec["bound_ms"] / 2
                                    else "bytes"),
                          library_ms=rec["library_ms"])
    errs["tail_ce"] = 0.0
    heads = (("gap", "ResNet-18 head", (ZOO_BATCH, 4, 4, 512), 10),
             ("gap", "ResNet-50 head", (Z50_BATCH, 4, 4, 2048), 10),
             ("max2", "CIFAR CNN head", (ZOO_BATCH, 8, 8, 128), 10),
             ("gap", "ImageNet head", (IMAGENET_BATCH, *IMAGENET_HEAD[:3]), IMAGENET_HEAD[3]))
    for pool, label, shape, k in heads:
        x = torch.relu(torch.randn(shape, generator=gen, device="cuda"))
        d = shape[3] if pool == "gap" else (shape[1] // 2) * (shape[2] // 2) * shape[3]
        w = torch.randn((d, k), generator=gen, device="cuda") * d ** -0.5
        b = 0.1 * torch.randn((k,), generator=gen, device="cuda")
        y = torch.randint(0, k, (shape[0],), generator=gen, device="cuda")
        args = tuple(t.to(torch.bfloat16) for t in (x, w, b)) + (y,)
        form = tail.tail_plan(pool, *shape[1:], k, torch.bfloat16).form
        loss, dl = tail.tail_forward(*args, pool)
        loss2, dl2 = tail.tail_forward(*args, pool)
        ref_loss, ref_dl = tail.tail_forward_plain(*args, pool)
        torch.cuda.synchronize()
        tag = f"bf16 tail_ce {pool} {label} ({'x'.join(map(str, shape))})->{k}"
        errs["tail_ce"] = max(errs["tail_ce"],
                              within(f"{tag} loss", loss, ref_loss, loss2, BF16_RTOL),
                              within(f"{tag} dlogits", dl, ref_dl, dl2, BF16_RTOL))
        # The f32 form at the same shape, in turns: the bf16 form must not
        # be the slower of the two.
        ms, f32_ms = in_turns(lambda: tail.tail_forward(*args, pool),
                              lambda: tail.tail_forward(x, w, b, y, pool), reps=200)
        plain = cuda_ms(lambda: tail.tail_forward_plain(*args, pool), reps=20)
        bound, by = bf16_tail_bound_ms(args[0], args[1])
        print(f"[smoke] time {tag}: kernel ({form} form) {ms:.5f} ms, the f32 form "
              f"{f32_ms:.5f} ms in turns (bf16 / f32 {ms / f32_ms:.3f}), plain {plain:.4f} "
              f"ms, library none, bound {bound:.6f} ms ({by}), {bound / ms:.1%} of bound",
              flush=True)
        if label == "ResNet-18 head":
            times["tail_ce"] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                                    library_ms=None)
        if label == "ImageNet head":
            times["tail_ce"]["tiled_form"] = dict(
                head=f"gap 7x7x2048->1000 b{IMAGENET_BATCH}", ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None)
    check_head_rows(torch.bfloat16, gen)
    return errs, times, r50


def bf16_step_rank(mesh):
    """bf16 (d) on one rank, through the library entry point: ResNet-18's
    update-on-arrival step in bf16 with the dynamic scale at
    ``growth_interval`` BF16_GROWTH_INTERVAL, on a clean batch, the same
    batch with an inf, then two clean ones. Returns each step's (scale,
    good_steps, skipped) and whether the overflow left params, momentum and
    BN statistics bit for bit as they were."""
    imgs, labels = synthetic.make_image_dataset(ZOO_BATCH, seed=13)
    x = torch.from_numpy(imgs).cuda()
    y = torch.from_numpy(labels).to("cuda", torch.int64)
    x_inf = x.clone()
    x_inf[0, 0, 0, 0] = float("inf")
    fused = dataclasses.replace(BF16_DP_FUSED, growth_interval=BF16_GROWTH_INTERVAL)
    model = resnet.resnet18(10, backend="cuda",
                            generator=torch.Generator().manual_seed(0)).cuda()
    opt = zoo.make_optimizer(ZOO_CHECK_LR, DP_MOMENTUM)
    state, _ = zoo.init_fused_state(model, opt, mesh=mesh, fused=fused,
                                    bucket_bytes=DP_COMM.bucket_bytes)
    step = zoo.make_fused_train_step(model, lr=ZOO_CHECK_LR, momentum=DP_MOMENTUM,
                                     accum_steps=1, mesh=mesh, augment_pad=None,
                                     comm=DP_COMM, fused=fused)
    scalars, kept = [], None
    for batch in (x, x_inf, x, x):
        before = {k: v.clone() for k, v in state.arrays().items()}
        step(state, batch, y)
        opt_state = state.fused
        scalars.append((float(opt_state.scale), int(opt_state.good_steps),
                        int(opt_state.skipped)))
        if batch is x_inf:
            after = state.arrays()
            kept = all(torch.equal(before[k], after[k]) for k in before
                       if not k.startswith(zoo._FUSED_SCALARS))
    return scalars, kept


def bf16_phase(card) -> tuple:
    """bf16 (b)-(d): JAX's default --fused-step (bf16 activations on f32
    masters) on the card. (b) ResNet-18 through the CLI at b128, 2 epochs:
    exact bf16 launch counts a step, no f32 gradient or tail launch, a
    falling finite loss; 3 bf16 steps against 3 f32 steps from one state.
    (c)-(d) the update-on-arrival CLI at --mesh-data 1, the dynamic scale:
    its launches, a resumed run against the straight one (the loss-scale
    state included), and through the library entry point one overflow
    skipped bit for bit and backed off, then growth. Returns the bf16
    launches of (b) and (d)'s CLI runs together."""
    work = BUILD_DIR / "smoke_bf16"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data = ["--batch-size", str(ZOO_BATCH), "--synthetic-train-count", str(ZOO_TRAIN_COUNT),
            "--synthetic-test-count", str(ZOO_TEST_COUNT)]
    base = ["--model", "resnet18", "--conv-backend", "cuda", "--fused-step"] + data
    steps = 2 * ZOO_STEPS
    evals = 2 * -(-ZOO_TEST_COUNT // ZOO_EVAL_BATCH)
    want = {key: n * steps for key, n in BF16_PER_STEP.items()}
    want_f32 = {"tap_conv": CONVS_PER_FORWARD * evals, "tap_conv_dgrad": 0,
                "tap_wgrad": 0, "tail_ce": 0}

    # (b) the main path: every counter set to 0 just before, read just after.
    print(f"[smoke] bf16 (b): {' '.join(base)} --epochs 2", flush=True)
    reset_zoo_counts()
    out = run_cli(base + ["--epochs", "2"])
    launches, f32 = bf16_counts(), zoo_counts()
    losses = epoch_losses(out)
    print(f"[smoke] bf16 (b): bf16 launches {launches} for {steps} steps (expected "
          f"{want}); f32 launches {f32} (expected {want_f32}: the eval forward on the f32 "
          f"masters); epoch losses {losses} on {card}", flush=True)
    if launches != want or f32 != want_f32:
        fail("the bf16 zoo run did not launch each bf16 form exactly as often as its "
             "steps need, or launched an f32 gradient or tail kernel")
    if len(losses) != 2 or not all(np.isfinite(losses)) or not losses[1] < losses[0]:
        fail("the bf16 zoo run's loss is not finite or did not fall from epoch 1 to 2")

    imgs, labels = synthetic.make_image_dataset(3 * ZOO_BATCH, seed=11)
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).to("cuda", torch.int64)
    runs = {}
    for label, fused in (("bf16", BF16_FUSED), ("f32", ZOO_FUSED)):
        model = resnet.resnet18(10, backend="cuda",
                                generator=torch.Generator().manual_seed(0)).cuda()
        state = zoo.init_state(model, zoo.make_optimizer(ZOO_CHECK_LR))
        step = zoo.make_train_step(model, state.optimizer, fused=fused)
        runs[label] = [float(step(state, xs[i * ZOO_BATCH:(i + 1) * ZOO_BATCH],
                                  ys[i * ZOO_BATCH:(i + 1) * ZOO_BATCH])) for i in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["bf16"], runs["f32"]))
    print(f"[smoke] bf16 (b): 3 bf16 steps vs 3 f32 steps from one state (lr "
          f"{ZOO_CHECK_LR}, b{ZOO_BATCH}): losses {runs['bf16']} vs {runs['f32']}, max "
          f"relative difference {rel:.3e} (tol {BF16_LOSS_RTOL:.0e}) "
          f"{'ok' if rel <= BF16_LOSS_RTOL else 'FAIL'}", flush=True)
    if not rel <= BF16_LOSS_RTOL:
        fail("the bf16 steps drifted from the f32 steps past JAX's bound")

    # (d) update-on-arrival with the dynamic scale; (c) its resume.
    dp = base + ["--mesh-data", str(DP_WORLD), "--comm-impl", "ring"]
    print(f"[smoke] bf16 (d): {' '.join(dp)} --epochs 2", flush=True)
    reset_zoo_counts()
    sgd_update.momentum_launches.reset()
    out = run_cli(dp + ["--epochs", "2", "--checkpoint-dir", str(work / "straight")])
    dp_launches, f32 = bf16_counts(), zoo_counts()
    momentum = sgd_update.momentum_launches.count
    losses = epoch_losses(out)
    a = checkpoint_leaves(work / "straight" / "ckpt_2.npz")
    scale = [float(a[k]) for k in zoo._FUSED_SCALARS]
    print(f"[smoke] bf16 (d): bf16 launches {dp_launches}, sgd_momentum {momentum} for "
          f"{steps} steps (expected {want} and {steps}); f32 launches {f32}; epoch "
          f"losses {losses}; scale, good steps, skipped after 2 epochs {scale}", flush=True)
    if dp_launches != want or f32 != want_f32 or momentum != steps:
        fail("the bf16 update-on-arrival run did not launch each kernel exactly as "
             "often as its steps need")
    if "falling back" in out or len(losses) != 2 or not all(np.isfinite(losses)):
        fail("the bf16 update-on-arrival run did not take its path or its loss is not "
             "finite")
    print("[smoke] bf16 (c): --epochs 1, then --epochs 2 --resume, vs (d)", flush=True)
    split = work / "split"
    run_cli(dp + ["--epochs", "1", "--checkpoint-dir", str(split)])
    out = run_cli(dp + ["--epochs", "2", "--checkpoint-dir", str(split), "--resume"])
    b = checkpoint_leaves(split / "ckpt_2.npz")
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"[smoke] bf16 (c): resumed state ({len(a)} leaves: params, BN stats, "
          f"momentum, scale, good steps, skipped) "
          f"{'bit-identical to the straight run' if same else 'DIFFERS'}", flush=True)
    if "resumed from" not in out or not same:
        fail("the resumed bf16 run is not bit-identical to the straight run")

    scalars, kept = distributed.run(bf16_step_rank, DP_WORLD, device="cuda")[0]
    s0 = BF16_DP_FUSED.loss_scale
    want_scalars = [(s0, 1, 0), (s0 * BF16_DP_FUSED.backoff, 0, 1),
                    (s0 * BF16_DP_FUSED.backoff, 1, 1), (s0, 0, 1)]
    ok = kept and scalars == want_scalars
    print(f"[smoke] bf16 (d): library step, clean / inf / clean / clean at growth "
          f"interval {BF16_GROWTH_INTERVAL}: (scale, good steps, skipped) {scalars} "
          f"(expected {want_scalars}); the overflow left params, momentum and BN "
          f"statistics {'bit-identical' if kept else 'CHANGED'} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("the dynamic loss scale did not skip, back off and grow as JAX's does")
    return {key: launches[key] + dp_launches[key] for key in launches}


def bf16_profiles(card, f32_profiles, r18_convs, r50_convs) -> None:
    """bf16 (e): warm epochs of ResNet-18 (b128) and ResNet-50 (b128 in two
    microbatches) in bf16 under torch.profiler, beside the f32 epochs of
    this call: device ms a step, idle share, device ops a step, and the
    step's conv kernels against cuDNN's bf16 calls on the same convs (timed
    in (a) at b128, never on the path)."""
    r50 = lambda b, g: resnet.resnet50(10, cifar_stem=True, backend=b, generator=g)  # noqa: E731
    runs = (("ResNet-18", None, ZOO_BATCH, ZOO_STEPS, 1, r18_convs),
            ("ResNet-50", r50, Z50_BATCH, Z50_STEPS, Z50_ACCUM, r50_convs))
    for label, build, batch, steps, accum, convs in runs:
        prof = profiled_zoo_epoch(f"{label}, bf16 activations, conv kernels + fused tail",
                                  "cuda", build=build, batch=batch, steps=steps,
                                  accum=accum, fused=BF16_FUSED)
        f32 = f32_profiles.get(label)
        if prof is None or f32 is None:
            continue
        kern = sum(prof[4][part] for part in ("forward", "dgrad", "wgrad"))
        # (a) timed the convs at the step's whole batch (ResNet-50's two
        # microbatches of 64 as one pass of 128).
        lib = sum(convs[key]["library_ms"] for key in ("tap_conv", "tap_conv_dgrad",
                                                       "tap_wgrad"))
        print(f"[smoke] bf16 (e) {label} b{batch}: device {prof[3]:.3f} ms a step "
              f"(f32 {f32[3]:.3f}), idle {prof[2]:.1%} (f32 {f32[2]:.1%}), "
              f"{prof[1]:.1f} device ops a step (f32 {f32[1]:.1f}); conv kernels "
              f"{kern:.3f} ms a step (f32 {sum(f32[4][p] for p in ('forward', 'dgrad', 'wgrad')):.3f}) "
              f"against cuDNN bf16 on the same convs {lib:.3f} ms (timed only, "
              f"this call, on {card})", flush=True)


# ---------------------------------------------------------------------------
# The pipeline: JAX's 1F1B schedule on ResNet-18 (pipe (a)-(b))
# ---------------------------------------------------------------------------

# ResNet-18 at b128 in f32, M = 2 microbatches a step (--accum-steps 2).
# (a) the CLI at one stage, 8 steps and one eval batch, against the flat
# ring; (b) the stage programs at S = 2 and 4 (the flops-balanced split)
# and one manual split, run on the one card in the schedule's order.
PIPE_ACCUM = 2
PIPE_STEPS = 8
PIPE_TEST_COUNT = 256
PIPE_IN_SHAPE = (32, 32, 3)
PIPE_CASES = ((2, ""), (4, ""), (2, "3"))  # (stages, --pipeline-split)
PIPE_ZERO2 = FusedStepConfig(update=True, tail=False, act_dtype="float32")
PIPE_BF16 = FusedStepConfig(update=False, tail=False, act_dtype="bfloat16")
# Stage times: this many timed runs of the schedule after one warm run.
PIPE_TIMED_RUNS = 3


def pipe_counts():
    return {"tap_conv": tap_conv.launches.count,
            "tap_conv_dgrad": tap_conv.dgrad_launches.count,
            "tap_wgrad": tap_wgrad.launches.count, "tail_ce": tail.launches.count,
            **bf16_counts()}


def pipe_run(stages, plan, x, y, wire=None):
    """Every stage of ``plan`` through one step's ticks on this card, in
    the schedule's order: each tick runs every stage's work, then hands
    each stage what its neighbours sent (the previous stage's activation,
    the next stage's cotangent; cast to ``wire`` and back, as the
    exchange does), and checks that a stage sends exactly where its
    neighbour expects. Returns (runners, each stage's launches, each
    stage's ms: CUDA events around its tick work, the card idle before
    each)."""
    runners = [pipe_step.StageRunner(st, plan, x, y) for st in stages]
    n = len(runners)
    launches = [dict.fromkeys(pipe_counts(), 0) for _ in range(n)]
    ms = [0.0] * n
    for t in range(plan.n_ticks):
        sent = []
        for s, r in enumerate(runners):
            torch.cuda.synchronize()
            before = pipe_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            sent.append(r.tick(t))
            end.record()
            end.synchronize()
            ms[s] += start.elapsed_time(end)
            for key, v in pipe_counts().items():
                launches[s][key] += v - before[key]
        for s, r in enumerate(runners):
            fwd = sent[s - 1][0] if s > 0 else None
            bwd = sent[s + 1][1] if s < n - 1 else None
            if ((fwd is not None), (bwd is not None)) != r.receives(t):
                fail(f"pipe: at tick {t} stage {s} was sent {fwd is not None, bwd is not None}"
                     f" but expected {r.receives(t)}")
            if wire is not None:
                fwd = None if fwd is None else fwd.to(wire).float()
                bwd = None if bwd is None else bwd.to(wire).float()
            r.fwd_in, r.bwd_in = fwd, bwd
    return runners, launches, ms


def pipe_grads(runners):
    """The stages' summed gradients by parameter name."""
    return {name: g for r in runners for name, g in zip(r.stage.names, r.gsum)}


def reference_grads(model, x, y, loss_fn, n_micro):
    """One single-device step's gradients summed over its microbatches
    (the flat step's order; no update), by parameter name."""
    names, params = zip(*model.named_parameters())
    mb = x.shape[0] // n_micro
    gsum = None
    for m in range(n_micro):
        sl = slice(m * mb, (m + 1) * mb)
        g = torch.autograd.grad(loss_fn(model, x[sl], y[sl]), params)
        gsum = list(g) if gsum is None else [a + b for a, b in zip(gsum, g)]
    return dict(zip(names, gsum))


def grads_within(label, got, want, rtol):
    """Max |Δ| over the leaves, each relative to max(1, its largest
    value); fails past ``rtol``."""
    worst = max(float((got[n] - g).abs().max()) / max(1.0, float(g.abs().max()))
                for n, g in want.items())
    if sorted(got) != sorted(want):
        fail(f"{label}: the stages' gradients miss parameters")
    print(f"[smoke] {label}: summed grads vs one single-device step's, max |Δ| of "
          f"the leaf's scale {worst:.3e} (tol {rtol:.1e}) "
          f"{'ok' if worst <= rtol else 'FAIL'}", flush=True)
    if not worst <= rtol:
        fail(f"{label}: the pipelined grads disagree with the single-device step's")
    return worst


def pipe_stage_convs(stages):
    return [sum(isinstance(m, ConvBNAct) for m in st.layers.modules()) for st in stages]


def pipe_phase(card) -> tuple:
    """pipe (a)-(b): JAX's 1F1B pipeline on ResNet-18 at b128 (f32, two
    microbatches). (a) the CLI at --pipeline-stages 1 against the flat ring
    at --mesh-data 1, bit for bit, exact launches; ms a step at one stage.
    (b) at S = 2 and 4 the stage programs make_pipeline_step runs, on this
    one card in the schedule's order: the summed grads against a
    single-device step's, the BN statistics updated once a microbatch,
    B10/B11 launches exact at each stage's shapes, the ZeRO-2 tail through
    B13, a bf16 case through the tensor-core forms; each stage's ms beside
    the bubble share. Returns (f32 launches, B13 launches, bf16 launches)
    of (a) and (b)."""
    work = BUILD_DIR / "smoke_pipe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = ["--model", "resnet18", "--conv-backend", "cuda", "--batch-size",
            str(ZOO_BATCH), "--accum-steps", str(PIPE_ACCUM), "--epochs", "1",
            "--synthetic-train-count", str(PIPE_STEPS * ZOO_BATCH),
            "--synthetic-test-count", str(PIPE_TEST_COUNT)]
    # (a) the main path: every counter set to 0 just before, read just after.
    print(f"[smoke] pipe (a): {' '.join(base)} --pipeline-stages 1", flush=True)
    reset_zoo_counts()
    out = run_cli(base + ["--pipeline-stages", "1", "--checkpoint-dir", str(work / "pipe")])
    got = zoo_counts()
    micro = PIPE_STEPS * PIPE_ACCUM
    evals = -(-PIPE_TEST_COUNT // ZOO_EVAL_BATCH)
    want = {"tap_conv": CONVS_PER_FORWARD * (micro + evals),
            "tap_conv_dgrad": (CONVS_PER_FORWARD - 1) * micro,
            "tap_wgrad": CONVS_PER_FORWARD * micro, "tail_ce": 0}
    losses = epoch_losses(out)
    print(f"[smoke] pipe (a): launches {got} for {PIPE_STEPS} steps of {PIPE_ACCUM} "
          f"microbatches and {evals} eval batch (expected {want}); epoch loss {losses}",
          flush=True)
    if got != want:
        fail("the one-stage pipeline did not launch B10/B11 exactly as its "
             "microbatches and eval batches need")
    if "mesh: {'stage': 1, 'data': 1} (pipeline)" not in out or len(losses) != 1 \
            or not np.isfinite(losses[0]):
        fail("the one-stage pipeline run did not take its path or its loss is not finite")
    run_cli(base + ["--mesh-data", "1", "--comm-impl", "ring", "--checkpoint-dir",
                    str(work / "flat")])
    a = checkpoint_leaves(work / "pipe" / "ckpt_1.npz")
    b = checkpoint_leaves(work / "flat" / "ckpt_1.npz")
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"[smoke] pipe (a): --pipeline-stages 1 vs --mesh-data 1 --comm-impl ring: "
          f"state ({len(a)} leaves) {'bit-identical' if same else 'DIFFERS'}", flush=True)
    if not same:
        fail("the one-stage pipeline is not bit-identical to the flat ring step")
    f32 = {key: got[key] for key in ("tap_conv", "tap_conv_dgrad", "tap_wgrad")}

    imgs, labels = synthetic.make_image_dataset(ZOO_BATCH, seed=11)
    x = torch.from_numpy(imgs).cuda()
    y = torch.from_numpy(labels).to("cuda", torch.int64)

    def fresh():
        return resnet.resnet18(10, backend="cuda",
                               generator=torch.Generator().manual_seed(0)).cuda().train()

    # ms a step at one stage: the flat ring step make_pipeline_step returns.
    model = fresh()
    opt = zoo.make_optimizer(ZOO_CHECK_LR)
    state = zoo.init_state(model, opt)
    step = pipe_step.make_pipeline_step(
        model, opt, accum_steps=PIPE_ACCUM,
        mesh=make_pipeline_mesh(0, 1, torch.device("cuda"), 1),
        pipeline=PipelineConfig(stages=1), in_shape=PIPE_IN_SHAPE, comm=DP_COMM)
    for _ in range(2):
        step(state, x, y)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        step(state, x, y)
    end.record()
    end.synchronize()
    s1_ms = start.elapsed_time(end) / 5
    print(f"[smoke] time pipe (a) S=1 b{ZOO_BATCH} M={PIPE_ACCUM}: {s1_ms:.3f} ms a step "
          f"(CUDA events around 5 steps; the flat ring step) on {card}", flush=True)

    # (b) the stage programs at S = 2 and 4.
    b13 = 0
    bf16 = dict.fromkeys(bf16_counts(), 0)
    for n_stages, split in PIPE_CASES:
        label = f"pipe (b) S={n_stages}" + (f" --pipeline-split {split}" if split else "")
        model = fresh()
        ref = copy.deepcopy(model)
        plan = pipe_step.pipeline_plan(model, PipelineConfig(stages=n_stages, split=split),
                                PIPE_IN_SHAPE, PIPE_ACCUM)
        stages = pipe_step.make_stages(model, plan)
        convs = pipe_stage_convs(stages)
        before = {k: v.clone() for k, v in model.named_buffers()}
        runners, launches, _ = pipe_run(stages, plan, x, y)
        got = pipe_grads(runners)
        grads_within(label, got, reference_grads(
            ref, x, y, lambda m, bx, by: zoo.cross_entropy(m(bx), by), PIPE_ACCUM),
            GRAD_RTOL)
        # BN: each microbatch's forward tick updated the statistics once and
        # the recomputes left them alone, as the flat step's M forwards did.
        mine, theirs = dict(model.named_buffers()), dict(ref.named_buffers())
        stat_err = max(float((mine[k] - v).abs().max()) / max(1.0, float(v.abs().max()))
                       for k, v in theirs.items())
        moved = all(not torch.equal(mine[k], before[k]) for k in theirs)
        print(f"[smoke] {label}: boundaries {plan.boundaries}, convs a stage {convs}, "
              f"A_buf {plan.a_buf}; BN statistics vs the single-device step's M "
              f"forwards max |Δ| of scale {stat_err:.3e}, every one moved {moved}",
              flush=True)
        if not stat_err <= 1e-6 or not moved:
            fail(f"{label}: BN's running statistics were not updated once a microbatch")
        for s, (c, got_s) in enumerate(zip(convs, launches)):
            want_s = {"tap_conv": 2 * c * PIPE_ACCUM,
                      "tap_conv_dgrad": (c - (s == 0)) * PIPE_ACCUM,
                      "tap_wgrad": c * PIPE_ACCUM}
            have = {k: got_s[k] for k in want_s}
            print(f"[smoke] {label}: stage {s} launches {have} (expected {want_s}: the "
                  f"forward ticks and the recompute, {c} convs)", flush=True)
            if have != want_s or any(got_s[k] for k in got_s if k not in want_s):
                fail(f"{label}: stage {s} did not launch B10/B11 exactly at its convs")
            for k in f32:
                f32[k] += got_s[k]
        # Each stage's time, warm, beside the bubble.
        stage_ms = [0.0] * n_stages
        pipe_run(stages, plan, x, y)
        for _ in range(PIPE_TIMED_RUNS):
            stage_ms = [a + b / PIPE_TIMED_RUNS
                        for a, b in zip(stage_ms, pipe_run(stages, plan, x, y)[2])]
        print(f"[smoke] time {label} b{ZOO_BATCH} M={PIPE_ACCUM}: stage ms "
              f"{[round(v, 3) for v in stage_ms]} (events around each stage's ticks, the "
              f"card idle before each; the forward twice, the recompute), max "
              f"{max(stage_ms):.3f} beside S=1's {s1_ms:.3f} ms a step; bubble share "
              f"bubble_fraction({n_stages}, {PIPE_ACCUM}) = "
              f"{pipe_lib.bubble_fraction(n_stages, PIPE_ACCUM):.3f} on {card}", flush=True)
        if (n_stages, split) != PIPE_CASES[0]:
            continue

        # The ZeRO-2 tail at D = 1 on the S = 2 grads: one B13 launch.
        model_z = fresh()
        model_z.load_state_dict(ref.state_dict())
        data = DataMesh(1, 0, torch.device("cuda"))
        zstate, _ = zoo.init_fused_state(model_z, opt, mesh=data, fused=PIPE_ZERO2,
                                         bucket_bytes=DP_COMM.bucket_bytes)
        names, params = zip(*zoo.jax_ordered_params(model_z))
        grads = pipe_grads(runners)
        full = [grads[n] for n in names]
        bplan = collectives.plan_buckets(list(params), DP_COMM.bucket_bytes, shards=1)
        pb = [b.clone() for b in collectives.flatten_buckets(list(params), bplan)]
        gb = collectives.flatten_buckets(full, bplan)
        scale = 1.0 / PIPE_ACCUM
        sgd_update.momentum_launches.reset()
        pipe_step.zero2_tail(zstate, params, full, bplan, data, DP_COMM, lr=DP_LR,
                      momentum=DP_MOMENTUM, scale=scale)
        launches_z = sgd_update.momentum_launches.count
        b13 += launches_z
        with plain_reference():
            plain = [sgd_update.fused_sgd_momentum_plain(p, torch.zeros_like(p), g, DP_LR,
                                                         DP_MOMENTUM, scale)
                     for p, g in zip(pb, gb)]
        after = collectives.flatten_buckets(list(params), bplan)
        same = all(torch.equal(a_, p_[0]) for a_, p_ in zip(after, plain)) and all(
            torch.equal(m[0], p_[1]) for m, p_ in zip(zstate.fused.mom, plain))
        want_z = -(-bplan.n_buckets // sgd_update.MAX_ENTRIES)
        print(f"[smoke] {label}: the ZeRO-2 tail at D=1 over {bplan.n_buckets} buckets: "
              f"sgd_momentum launches {launches_z} (expected {want_z}); params and "
              f"momentum {'bit-identical to' if same else 'DIFFER from'} the plain update",
              flush=True)
        if launches_z != want_z or not same:
            fail("the pipeline's ZeRO-2 tail did not run once through B13 or disagrees "
                 "with the plain update")

        # bf16 activations and wire through the tensor-core forms.
        model_b = fresh()
        ref_b = copy.deepcopy(model_b)
        stages_b = pipe_step.make_stages(model_b, plan, "bfloat16")
        start = bf16_counts()
        runners_b, _, _ = pipe_run(stages_b, plan, x, y, wire=torch.bfloat16)
        got_b = {k: v - start[k] for k, v in bf16_counts().items()}
        for k in bf16:
            bf16[k] += got_b[k]
        want_b = {"tap_conv.wgmma": 2 * WGMMA_CONVS * PIPE_ACCUM,
                  "tap_conv.ffma": 2 * (CONVS_PER_FORWARD - WGMMA_CONVS) * PIPE_ACCUM,
                  "tap_conv_dgrad.wgmma": WGMMA_CONVS * PIPE_ACCUM,
                  "tap_conv_dgrad.ffma": (CONVS_PER_FORWARD - 1 - WGMMA_CONVS) * PIPE_ACCUM,
                  "tap_wgrad.wgmma": WGMMA_CONVS * PIPE_ACCUM,
                  "tap_wgrad.ffma": (CONVS_PER_FORWARD - WGMMA_CONVS) * PIPE_ACCUM,
                  "tail_ce": 0}
        print(f"[smoke] {label} bf16 (act and wire): bf16 launches {got_b} (expected "
              f"{want_b})", flush=True)
        if got_b != want_b:
            fail("the bf16 pipeline did not launch each bf16 form exactly at its convs")
        grads_within(f"{label} bf16", pipe_grads(runners_b), reference_grads(
            ref_b, x, y, zoo._build_loss_fn(ref_b, PIPE_BF16), PIPE_ACCUM), BF16_RTOL)
    return f32, b13, bf16


# ---------------------------------------------------------------------------
# Elastic ZeRO-3, async data parallelism, the trainer's chaos and obs
# ---------------------------------------------------------------------------

ELASTIC_SCHEDULE = "3:2"
ELASTIC_CHAOS = "resize@5:+1"
ELASTIC_STEPS = 2  # (b): steps before the resize, and after it
ELASTIC_AFTER = 3
ASYNC_WORKERS = 4
ASYNC_BATCH = 64
ASYNC_STEPS = 5
ASYNC_SLOW = "slow-worker@3:400"
# B1 against the plain ops over a few async steps: the f32 sums differ in
# order, as train (d)'s 50 kernel steps against plain steps.
ASYNC_TOL = 1e-4
ASYNC_CLI_COUNT = 1024
CHAOS_TRAIN_COUNT = 6400
CHAOS_NAN_STEP = 50


class _Records(logging.Handler):
    """Collects the log records of a logger (the elastic controller's
    clamp, no-op and resize lines)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def obs_artifacts(trace_dir, metrics_json, run):
    """(nesting problems of the trace, the journal's counts, the metrics
    JSON) a CLI run wrote."""
    with open(trace_dir / f"{run}_trace.json") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    counts = collections.Counter(r["kind"] for r in obs_lib.read_journal(
        str(trace_dir / f"{run}_journal.jsonl")))
    with open(metrics_json) as f:
        metrics = json.load(f)
    return obs_lib.validate_nesting(events), dict(counts), metrics


def elastic_phase(card, zoo_launches) -> dict:
    """elastic (a)-(b) on one card. (a) the CLI at world 1 with
    ZERO3_ENV and --elastic, a schedule entry and a chaos resize@,
    traced: both triggers clamp to the one reachable rank and are skipped
    as no-ops (logged as JAX logs them), launches exact beside zoo (a)'s
    and one B13 launch a step, the loss falls, the trace nests and the
    metrics JSON is the run's story. (b) the library: a resize with no
    step between keeps the view bit for bit, three steps after it are
    bit-identical to three without it, and a failed live snapshot
    restores the ring's newest file bit for bit. Returns (a)'s launches."""
    work = BUILD_DIR / "smoke_elastic"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    argv = ["--model", "resnet18", "--conv-backend", "cuda", "--fused-step",
            "--act-dtype", "float32", "--mesh-data", str(DP_WORLD),
            "--comm-impl", "ring", "--batch-size", str(ZOO_BATCH),
            "--synthetic-train-count", str(ZOO_TRAIN_COUNT),
            "--synthetic-test-count", str(ZOO_TEST_COUNT), "--epochs", "2",
            "--elastic", "--elastic-schedule", ELASTIC_SCHEDULE,
            "--chaos", ELASTIC_CHAOS, "--trace-dir", str(work / "obs"),
            "--metrics-json", str(work / "metrics.json")]
    print(f"[smoke] elastic (a): {ZERO3_SH} {' '.join(argv)}", flush=True)
    logs = _Records()
    logger = logging.getLogger("parallel_cnn_tpu_torch.resilience.elastic")
    logger.addHandler(logs)
    reset_zoo_counts()
    sgd_update.momentum_launches.reset()
    try:
        with mock.patch.dict(os.environ, ZERO3_ENV):
            out = run_cli(argv)
    finally:
        logger.removeHandler(logs)
    launches = dict(zoo_counts(), sgd_momentum=sgd_update.momentum_launches.count)
    steps = 2 * ZOO_STEPS
    want = dict(zoo_launches, sgd_momentum=steps)
    losses = epoch_losses(out)
    skipped = [ln for ln in logs.lines if "clamped" in ln or "no-op" in ln]
    print(f"[smoke] elastic (a): launches {launches} for {steps} steps (expected "
          f"{want}); epoch losses {losses}; the controller's lines {skipped} on "
          f"{card}", flush=True)
    expect = ["elastic: resize request to 2 clamped to 1 (min_world=1, reachable=1)",
              "elastic: resize to 1 is a no-op at world 1 — skipped"] * 2
    if skipped != expect or any("resized" in ln for ln in logs.lines):
        fail("elastic (a): the schedule and chaos triggers were not clamped and "
             "skipped as JAX logs them")
    if launches != want:
        fail("elastic (a): the run did not launch each kernel exactly as often as "
             "its steps, buckets and eval batches need")
    if len(losses) != 2 or not losses[1] < losses[0]:
        fail("elastic (a): the loss did not fall from epoch 1 to 2")
    nesting, counts, metrics = obs_artifacts(work / "obs", work / "metrics.json", "zoo")
    story = {"epochs": 2, "steps": steps, "resizes": 0}
    print(f"[smoke] chaos (a) ResNet-18 obs: trace nesting problems {nesting[:2]}, "
          f"journal {counts}, metrics JSON collected {metrics.get('collected')}",
          flush=True)
    if nesting or counts.get("epoch") != 2 or counts.get("comm_plan") != 1 \
            or "resize_begin" in counts or metrics.get("collected", {}).get("zoo") != story:
        fail("elastic (a): the trace, the journal or the metrics JSON disagree with "
             "the run")

    # (b) the library at world 1.
    print(f"[smoke] elastic (b): ResNet-18 b{ZOO_BATCH} f32 ZeRO-3 at world "
          f"{DP_WORLD}, the controller called directly", flush=True)
    res = distributed.run(elastic_library_rank, DP_WORLD, device="cuda",
                          args=(str(work / "ring"),))[0]
    print(f"[smoke] elastic (b): zero-step resize view "
          f"{'bit-identical' if res['zero_step'] else 'DIFFERS'} ({res['leaves']} leaves, "
          f"{res['resize_s'] * 1e3:.1f} ms); {ELASTIC_AFTER} steps after it vs "
          f"{ELASTIC_AFTER} without: losses {res['after']} vs {res['without']}, "
          f"{'bit-identical' if res['same_after'] else 'DIFFER'}; ring fallback: "
          f"from_ring={res['from_ring']}, view "
          f"{'bit-identical to the ring file' if res['ring_same'] else 'DIFFERS'}",
          flush=True)
    if not (res["zero_step"] and res["same_after"] and res["from_ring"]
            and res["ring_same"]):
        fail("elastic (b): a resize moved the state, or the ring fallback did not "
             "restore the ring's file")
    return launches


def _elastic_state(mesh):
    model = resnet.resnet18(10, backend="cuda",
                            generator=torch.Generator().manual_seed(0)).cuda()
    state, step = zero_level_state(model, mesh, dataclasses.replace(DP_FUSED, zero=3),
                                   DP_LR)
    return model, state, step


def _views_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def elastic_library_rank(mesh, ring_dir):
    """elastic (b) on the rank: two ResNet-18s from one seed take the same
    batches; one is resized with no step between (its view checked bit for
    bit), and both take three more steps. Then a resize whose live
    snapshot fails restores the ring's file."""
    from parallel_cnn_tpu_torch.config import ElasticConfig
    from parallel_cnn_tpu_torch.resilience.elastic import ElasticController
    from parallel_cnn_tpu_torch.resilience.rollback import CheckpointRing
    from parallel_cnn_tpu_torch.train import checkpoint

    n = ELASTIC_STEPS + ELASTIC_AFTER
    imgs, labels = synthetic.make_image_dataset(n * ZOO_BATCH, seed=13)
    xs = torch.from_numpy(imgs).cuda()
    ys = torch.from_numpy(labels).to("cuda", torch.int64)
    batch = [(xs[i * ZOO_BATCH:(i + 1) * ZOO_BATCH], ys[i * ZOO_BATCH:(i + 1) * ZOO_BATCH])
             for i in range(n)]
    _, plain, plain_step = _elastic_state(mesh)
    model, state, step = _elastic_state(mesh)
    for bx, by in batch[:ELASTIC_STEPS]:
        plain_step(plain, bx, by)
        step(state, bx, by)
    before = {k: v.clone() for k, v in zoo.zero3_full_view(state).items()}
    ctl = ElasticController(ElasticConfig(), world=mesh.world, device=mesh.device)
    ctl.meshes[(mesh.world, 1)] = mesh
    t0 = time.perf_counter()
    state, plan, new_mesh, comm = ctl.resize(ELASTIC_STEPS, mesh.world, state=state,
                                             comm=DP_COMM)
    resize_s = time.perf_counter() - t0
    after_view = zoo.zero3_full_view(state)
    step = zoo.make_zero3_train_step(model, lr=ctl.lr_for(DP_LR), momentum=DP_MOMENTUM,
                                     accum_steps=1, mesh=new_mesh, augment_pad=None,
                                     comm=comm, fused=dataclasses.replace(DP_FUSED, zero=3),
                                     plan=plan)
    after = [float(step(state, bx, by)) for bx, by in batch[ELASTIC_STEPS:]]
    without = [float(plain_step(plain, bx, by)) for bx, by in batch[ELASTIC_STEPS:]]
    same_after = after == without and _views_equal(zoo.zero3_full_view(state),
                                                   zoo.zero3_full_view(plain))
    # The ring fallback: the newest ring file is the state now; the live
    # snapshot is made to fail.
    view = zoo.zero3_full_view(state)
    ring = CheckpointRing(ring_dir, keep=0)
    checkpoint.save_sharded(ring.path_for(0), view, world_size=mesh.world,
                            bucket_bytes=DP_COMM.bucket_bytes)
    ctl = ElasticController(ElasticConfig(), world=mesh.world, ring=ring,
                            device=mesh.device)
    ctl.meshes[(mesh.world, 1)] = mesh
    ctl.register_template(view)

    def lost(*a, **k):
        raise RuntimeError("shard buffers deleted (device lost)")

    with mock.patch.object(zoo, "zero3_full_view", lost):
        state, *_ = ctl.resize(n, mesh.world, state=state, comm=comm)
    return dict(zero_step=_views_equal(before, after_view), leaves=len(before),
                resize_s=resize_s, after=after, without=without, same_after=same_after,
                from_ring=ctl.events[-1].from_ring,
                ring_same=_views_equal(zoo.zero3_full_view(state), view))


def async_data(n_workers, batch, seed=1234):
    imgs, labels = synthetic.make_dataset(n_workers * batch, seed=seed)
    xs = torch.from_numpy(imgs).cuda().reshape(n_workers, batch, 28, 28)
    ys = torch.from_numpy(labels).cuda().reshape(n_workers, batch)
    return xs, ys


def async_phase(card) -> int:
    """async (a)-(b): JAX's virtual-clock harness on LeNet-ref b64 with 4
    workers, the gradients through B1. (a) the library: stale S=0
    bit-identical to mode off; stale S=2 under a 400 ms straggler, its
    schedule equal to the same run on the plain ops and its losses and
    params within ASYNC_TOL; EASGD's center below its start; B1 launched
    once a gradient computed. (b) the CLI's two modes with JAX's summary
    line. Returns B1's launches over (a) and (b)."""
    from parallel_cnn_tpu_torch.config import AsyncConfig
    from parallel_cnn_tpu_torch.train import async_dp

    xs, ys = async_data(ASYNC_WORKERS, ASYNC_BATCH)
    params = trainer.init_params(0, torch.device("cuda"))
    ex, ey = xs.reshape(-1, 28, 28), ys.reshape(-1)

    def run(mode, path, chaos=None, **kw):
        cfg = AsyncConfig(mode=mode, workers=ASYNC_WORKERS, **kw)
        return async_dp.run_async(params, xs, ys, cfg=cfg, max_server_steps=ASYNC_STEPS,
                                  chaos=ChaosMonkey.from_spec(chaos) if chaos else None,
                                  ops_path=path)

    def sched(r):
        return (r.virtual_ms, r.microbatches, r.server_steps, r.stragglers, r.dropped,
                r.easgd_rounds, r.ledger.entries)

    def params_diff(a, b):
        return max(float((a[k][j] - b[k][j]).abs().max()) for k in a for j in a[k])

    lenet_fused.launches.reset()
    off = run("off", "cuda")
    s0 = run("stale", "cuda", staleness_bound=0)
    stale = run("stale", "cuda", ASYNC_SLOW, staleness_bound=2)
    easgd = run("easgd", "cuda", easgd_period=2, easgd_rho=0.5)
    launches = lenet_fused.launches.count
    grads = off.microbatches + s0.microbatches + stale.microbatches + easgd.microbatches
    with plain_reference():
        plain = run("stale", "reference", ASYNC_SLOW, staleness_bound=2)
    same0 = off.losses == s0.losses and all(
        torch.equal(off.params[k][j], s0.params[k][j]) for k in off.params
        for j in off.params[k])
    dloss = max(abs(a - b) for a, b in zip(stale.losses, plain.losses))
    dparams = params_diff(stale.params, plain.params)
    start = float(async_dp.eval_err(params, ex, ey))
    center = float(async_dp.eval_err(easgd.params, ex, ey))
    print(f"[smoke] async (a): b{ASYNC_BATCH} x {ASYNC_WORKERS} workers, {ASYNC_STEPS} "
          f"steps each through B1: stale S=0 vs off "
          f"{'bit-identical' if same0 else 'DIFFERS'}; stale S=2 under {ASYNC_SLOW}: "
          f"schedule {sched(stale)[:6]} ledger {stale.ledger.entries}, plain ops "
          f"{'the same schedule' if sched(stale) == sched(plain) else 'ANOTHER schedule'}, "
          f"max |Δloss| {dloss:.3e}, max |Δparams| {dparams:.3e} (tol {ASYNC_TOL:.0e}); "
          f"easgd center err {center:.6f} from {start:.6f}; B1 launches {launches} for "
          f"{grads} gradients on {card}", flush=True)
    if not same0 or sched(stale) != sched(plain) or dloss > ASYNC_TOL \
            or dparams > ASYNC_TOL or not center < start or launches != grads \
            or stale.stragglers < 1 or stale.ledger.max_staleness() < 1:
        fail("async (a): the async runs disagree with the sync schedule, the plain "
             "ops or the launch count")

    # (b) the CLI, both modes.
    total = launches
    for mode in (["--async-mode", "stale", "--chaos", ASYNC_SLOW],
                 ["--async-mode", "easgd"]):
        argv = ["--ops", "cuda", "--batch-size", str(ASYNC_BATCH), "--epochs",
                str(ASYNC_STEPS), "--synthetic-train-count", str(ASYNC_CLI_COUNT),
                "--synthetic-test-count", "512", *mode]
        print(f"[smoke] async (b): {' '.join(argv)}", flush=True)
        lenet_fused.launches.reset()
        out = run_cli(argv)
        summary = [ln for ln in out.splitlines() if ln.startswith("async mode=")]
        fields = dict(kv.split("=") for kv in summary[0].split()[1:]) if summary else {}
        computed = int(fields.get("microbatches", -1)) + int(fields.get("dropped", 0))
        n = lenet_fused.launches.count
        if len(summary) != 1 or "async test error rate: " not in out or n != computed:
            fail(f"async (b): no summary line, no test error, or B1 launches {n} for "
                 f"{computed} gradients")
        total += n
    return total


def chaos_phase(card) -> int:
    """chaos (a): the LeNet-ref trainer through B1 with nan@ poisoning a
    step under --sentinel rollback, traced: the epoch is rolled back and
    retried, the journal holds the chaos, verdict and rollback, B1
    launched once a step (the retried epoch's too), and the metrics JSON
    is the run's story. Returns B1's launches."""
    work = BUILD_DIR / "smoke_chaos"
    shutil.rmtree(work, ignore_errors=True)
    steps = CHAOS_TRAIN_COUNT // TRAIN_BATCH
    argv = ["--ops", "cuda", "--batch-size", str(TRAIN_BATCH), "--epochs", "2",
            "--synthetic-train-count", str(CHAOS_TRAIN_COUNT), "--synthetic-test-count",
            "1000", "--chaos", f"nan@{CHAOS_NAN_STEP}", "--sentinel", "rollback",
            "--trace-dir", str(work), "--metrics-json", str(work / "metrics.json")]
    print(f"[smoke] chaos (a): {' '.join(argv)}", flush=True)
    lenet_fused.launches.reset()
    out = run_cli(argv)
    launches = lenet_fused.launches.count
    errs = epoch_errors(out)
    nesting, counts, metrics = obs_artifacts(work, work / "metrics.json", "train")
    story = {"epochs": 2, "steps": 3 * steps, "rollbacks": 1}
    print(f"[smoke] chaos (a): epoch errors {errs}; journal {counts}; metrics JSON "
          f"collected {metrics.get('collected')}; B1 launches {launches} for "
          f"{3 * steps} steps (an epoch rolled back and retried) on {card}", flush=True)
    if len(errs) != 2 or not all(np.isfinite(errs)) or nesting \
            or counts.get("chaos") != 1 or counts.get("verdict") != 1 \
            or counts.get("rollback") != 1 or counts.get("epoch") != 2 \
            or metrics.get("collected", {}).get("train") != story \
            or launches != 3 * steps:
        fail("chaos (a): the poisoned epoch was not rolled back and journaled, or B1 "
             "was not launched once a step")
    return launches


def main() -> int:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t_start = time.perf_counter()
    laps = [t_start]

    def clock(label):
        """Print the host seconds of the phase that just ended, and since
        the start: where the smoke's time goes."""
        laps.append(time.perf_counter())
        print(f"[smoke] clock: {label} {laps[-1] - laps[-2]:.1f} s "
              f"(at {laps[-1] - t_start:.1f} s)", flush=True)

    # -- 1. the card -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs a GPU")
    kind = torch.cuda.get_device_name(0)
    card = card_name_and_power_limit()
    if card is None:
        fail("nvidia-smi could not read the card's name and power limit")
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s); TF32 off", flush=True)

    # -- 2. build every kernel, one nvcc per source, all at once ----------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_MODULES)) as ex:
        libs = list(ex.map(lambda m: m.build(), KERNEL_MODULES))
    print(f"[smoke] built {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    for lib in libs:
        for line in lib.compiler_output.splitlines():
            # The tail's lines name their kernel too (its forms' registers
            # and spills, per instantiation).
            named = lib.source.name == "tail_ce.cu" and "Function properties" in line
            if "registers" in line or "spill" in line or "wgmma" in line or named:
                print(f"[smoke] ptxas {lib.path.name}: {line.strip()}")

    clock("1-2 card, build")

    # -- 3. kernel vs plain version at every ResNet-18 conv geometry -------
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    max_err = 0.0
    for name, h, cin, cout, k, s, res_on, relu, count in GEOMETRIES:
        x, w, scale, shift, res = geometry_inputs(h, cin, cout, k, s, res_on, gen)
        got = tap_conv.conv2d_fused(x, w, scale, shift, res, s, relu)
        with plain_reference():
            ref = tap_conv.conv2d_fused_plain(x, w, scale, shift, res, s, relu)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        tol = CONV_RTOL * max(1.0, float(ref.abs().max()))
        ok = bool(torch.isfinite(got).all()) and err <= tol
        print(f"[smoke] conv {name:24s} b{BATCH}: max |Δ| {err:.3e} "
              f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name}: kernel disagrees with its plain version")
        max_err = max(max_err, err)
        cases.append((name, count, x, w, scale, shift, res, s, relu, got.shape))
    # conv2d (no epilogue) goes through the same kernel.
    x, w = cases[1][2], cases[1][3]
    got = tap_conv.conv2d(x, w, 1)
    with plain_reference():
        ref = tap_conv.conv2d_plain(x, w, 1)
    err = float((got - ref).abs().max())
    tol = CONV_RTOL * max(1.0, float(ref.abs().max()))
    print(f"[smoke] conv2d (no epilogue) 3x3/s1 64: max |Δ| {err:.3e} "
          f"(tol {tol:.1e}) {'ok' if err <= tol else 'FAIL'}", flush=True)
    if not err <= tol:
        fail("conv2d disagrees with its plain version")
    max_err = max(max_err, err)

    # -- 3b. the LeNet-ref trainer's kernels vs their plain versions -----
    lenet_err = check_lenet_fused()
    sgd_err = check_sgd_update()

    # -- 3c. the zoo trainer's kernels vs their plain versions -----------
    zoo_errs = check_zoo_kernels()
    # -- 3d. B13 at ResNet-18's bucket sizes (dp (a)) ---------------------
    bucket_sizes = resnet18_bucket_sizes()
    momentum_err = check_sgd_momentum(bucket_sizes)

    clock("3 kernels vs plain")

    # -- 4. the serving path: serve full-width ResNet-18 -----------------
    handle = get("resnet18", conv_backend="cuda")
    host = random_bn(handle.init(seed=0), seed=0)
    ckpt = BUILD_DIR / "smoke_resnet18.npz"
    write_jax_checkpoint(host, ckpt)
    cfg = ServeConfig(model="resnet18", checkpoint=str(ckpt), max_batch=64,
                      precompile=True)
    tap_conv.launches.reset()
    t0 = time.perf_counter()
    # seed=1: every weight served must come from the checkpoint.
    pool, batcher = serve_stack(handle, cfg, device="cuda", seed=1)
    warm_s = time.perf_counter() - t0
    with batcher:
        e0 = pool.engines[0]
        print(f"[smoke] serve_stack(resnet18, device='cuda') on {e0.device} "
              f"from {ckpt.name} (random BN stats, seed 0): buckets "
              f"{e0.buckets} warmed in {warm_s:.2f}s", flush=True)
        parity = padded_bucket_parity(e0, handle.in_shape, seed=0)
        print(f"[smoke] {parity}", flush=True)
        if "bit-identical" not in parity:
            fail("padded bucket is not bit-identical to the direct forward")
        report = loadgen.run(batcher, pattern="closed",
                             n_requests=SERVE_REQUESTS,
                             concurrency=SERVE_CONCURRENCY, seed=0)
        lat = report.latency.summary(scale=1e3)
        print(f"[smoke] closed loop: {report.completed}/{report.requests} "
              f"completed at concurrency {SERVE_CONCURRENCY}, "
              f"{report.throughput:.1f} req/s, p50 {lat.get('p50', 0):.2f} ms, "
              f"p99 {lat.get('p99', 0):.2f} ms on {card}", flush=True)
        if report.completed != SERVE_REQUESTS:
            fail(f"only {report.completed}/{SERVE_REQUESTS} requests completed")
        samples = loadgen.make_samples(32, handle.in_shape, seed=1)
        futs = [batcher.submit(s) for s in samples]
        served = np.stack([f.result(timeout=60) for f in futs])
        launches = tap_conv.launches.count
        forwards = e0.stats.warmups + e0.stats.predicts + 1  # +1: parity
        print(f"[smoke] tap_conv launches on the serve path: {launches} over "
              f"{forwards} forwards ({CONVS_PER_FORWARD} convs each)",
              flush=True)
        if launches == 0 or launches < CONVS_PER_FORWARD * forwards:
            fail("the serve path did not run every conv through the kernel")
        snap = batcher.stats.snapshot()
        if snap["submitted"] != (snap["completed"] + snap["shed"]
                                 + snap["expired"] + snap["failed"]):
            fail(f"serve conservation broken: {snap}")
        print(f"[smoke] closed loop: {snap['batches']} batches, occupancy "
              f"{snap['batch_occupancy']:.3f}, mean batch "
              f"{snap['completed'] / max(snap['batches'], 1):.2f}", flush=True)
        profiled_serve(batcher)

    if served.shape != (32, handle.n_outputs) or not np.isfinite(served).all():
        fail(f"served logits have shape {served.shape} or are not finite")
    with torch.inference_mode(), plain_reference():
        ref = plain_forward(host.cuda(), torch.from_numpy(samples).cuda())
        ref = ref.cpu().numpy()
    err = float(np.max(np.abs(served - ref)))
    tol = LOGIT_RTOL * max(1.0, float(np.max(np.abs(ref))))
    print(f"[smoke] served logits vs the written model through the plain "
          f"version on the card: "
          f"max |Δ| {err:.3e} (tol {tol:.1e}), argmax agree "
          f"{int((served.argmax(1) == ref.argmax(1)).sum())}/32", flush=True)
    if not err <= tol:
        fail("served logits disagree with the plain-version model")

    clock("4 serve")

    # -- 4'. the serving control plane: slo (a)-(f) -----------------------
    slo_launches = slo_phase(card, ckpt, host)
    clock("4' slo")
    # -- 4''. the network front door: net (a)-(f) --------------------------
    net_launches = net_phase(card, ckpt, host)
    clock("4'' net")

    # -- 4b. the training path: the LeNet-ref trainer's CLI ---------------
    train_launches, rate_a = train_phase(card)
    ds = pipeline.Dataset(*synthetic.make_dataset(TRAIN_COUNT, seed=1234))
    epoch_profiles = {}
    for label, ops, fused in (("--ops cuda", "cuda", False),
                              ("--fused-step", "reference", True)):
        epoch_profiles[label] = profiled_epoch(ds, label, Config(
            train=TrainConfig(batch_size=TRAIN_BATCH, ops=ops, shuffle=True),
            fused=FusedStepConfig() if fused else None))

    clock("4b train")

    # -- 4b''. the mesh path: LeNet-ref over a (data, model) mesh ----------
    mesh_phase(card, rate_a)
    distributed.run(profiled_mesh_epoch, 1, device="cuda", plan=MESH_1X1, args=(ds,))

    clock("4b'' mesh")

    # -- 4b'. the staged LeNet-ref library: B3-B9 ---------------------------
    staged_errs, staged_launches = staged_phase(card, ds,
                                                   epoch_profiles["--ops cuda"])

    clock("4b' staged")

    # -- 4c. the zoo path: ResNet-18 and the CIFAR CNN through the CLI ----
    zoo_launches = zoo_phase(card)
    zoo_profile = profiled_zoo_epoch("ResNet-18, conv kernels + fused tail", "cuda")
    # The same epoch on cuDNN's convs (TF32 off), JAX's "xla" backend: the
    # end-to-end yardstick of the conv kernels.
    profiled_zoo_epoch("ResNet-18, library convs + fused tail", "torch")

    clock("4c zoo")

    # -- 4d. the data-parallel path: update-on-arrival over the ring ------
    dp_launches = dp_phase(card, zoo_launches)
    dp_profile = distributed.run(profiled_dp_epoch_rank, DP_WORLD, device="cuda")[0]

    clock("4d dp")

    # -- 4d''. ZeRO-3: the params as resident rows, gathered each step ------
    z3_launches = zero3_phase(card, zoo_launches)
    z3_profile = distributed.run(profiled_dp_epoch_rank, DP_WORLD, device="cuda",
                                 args=(3,))[0]
    report_zero3_epoch(z3_profile, dp_profile, card)

    clock("4d'' zero3")

    # -- 4d'''. the ExecutionPlan: --plan, stamped checkpoints, --replan --
    plan_launches = plan_phase(card)

    clock("4d''' plan")

    # -- 4d'. the GSPMD zoo path: global BN statistics, the model axis ----
    gspmd_launches, shard_errs = gspmd_phase(card, zoo_launches)
    gspmd_profile = distributed.run(profiled_gspmd_epoch_rank, 1, device="cuda",
                                    plan=MESH_1X1)[0]
    if zoo_profile is not None and gspmd_profile is not None:
        print("[smoke] gspmd (e): profiled epoch, GSPMD step on a 1x1 mesh "
              f"{gspmd_profile[0]:.0f} img/s, {gspmd_profile[1]:.1f} device ops a "
              f"step, idle {gspmd_profile[2]:.1%}; beside zoo (a)'s single-device "
              f"step {zoo_profile[0]:.0f} img/s, {zoo_profile[1]:.1f} device ops a "
              f"step, idle {zoo_profile[2]:.1%} (this call, on {card})", flush=True)

    clock("4d' gspmd")

    # -- 4e. the probe path: the eight Mosaic probes, B14-B21 -------------
    probe_errs, probe_launches = probe_phase()

    clock("4e probe")

    # -- 4f. ResNet-50 and VGG-16 at full width, and their serving --------
    z50_launches, z50_errs, _ = zoo50_phase(card)
    r50 = lambda b, g: resnet.resnet50(10, cifar_stem=True, backend=b, generator=g)  # noqa: E731
    r50_profile = profiled_zoo_epoch("ResNet-50, conv kernels + fused tail", "cuda",
                                     build=r50, batch=Z50_BATCH, steps=Z50_STEPS,
                                     accum=Z50_ACCUM)
    img_launches, img_tail_err, img_tiled, img_tail_times = imagenet_phase(card)
    vgg_launches = vgg_phase(card)
    profiled_zoo_epoch("VGG-16, conv kernels + fused tail", "cuda",
                       build=lambda b, g: vgg.vgg16(10, backend=b, generator=g),
                       steps=VGG_STEPS)
    serve50_launches, _ = serve50_phase(card)

    clock("4f resnet50, imagenet, vgg, serve50")

    # -- 4g. the native C++ idx parser and prefetch ring ------------------
    native_phase(card)

    clock("4g native")

    # -- 4h. bf16 activations: JAX's default --fused-step -----------------
    bf16_errs, bf16_times, r50_bf16 = bf16_kernel_phase()
    bf16_host_times(card)
    bf16_launches = bf16_phase(card)
    bf16_profiles(card, {"ResNet-18": zoo_profile, "ResNet-50": r50_profile},
                  bf16_times, r50_bf16)

    clock("4h bf16")

    # -- 4i. the pipeline: JAX's 1F1B schedule on ResNet-18 ----------------
    pipe_f32, pipe_b13, pipe_bf16 = pipe_phase(card)
    bf16_launches = {key: n + pipe_bf16[key] for key, n in bf16_launches.items()}

    clock("4i pipe")

    # -- 4j. elastic ZeRO-3, async data parallelism, the trainer's chaos --
    elastic_launches = elastic_phase(card, zoo_launches)
    async_b1 = async_phase(card)
    chaos_b1 = chaos_phase(card)

    clock("4j elastic, async, chaos")

    # -- 5. time every kernel: kernel, plain, library, bound --------------
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0, "ops_ms": 0.0}
    s1_shares = []
    for name, count, x, w, scale, shift, res, s, relu, oshape in cases:
        ms = cuda_ms(lambda: tap_conv.conv2d_fused(x, w, scale, shift, res, s, relu))
        with plain_reference():
            plain = cuda_ms(lambda: tap_conv.conv2d_fused_plain(
                x, w, scale, shift, res, s, relu))
        lib = cuda_ms(library_call(x, w, scale, shift, res, s, relu))
        bound, by = bound_ms(x, w, s, oshape, res is not None)
        print(f"[smoke] time {name:24s} b{BATCH}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, library {lib:.4f} ms, bound {bound:.4f} ms "
              f"({by}), {bound / ms:.1%} of bound", flush=True)
        if w.shape[0] == 3 and s == 1 and not name.startswith("stem"):
            s1_shares.append(bound / ms)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bound)):
            totals[key] += count * v
        if by == "operations":
            totals["ops_ms"] += count * bound
    bucket_breakdown(e0, handle.in_shape)
    xb = torch.from_numpy(loadgen.make_samples(BATCH, handle.in_shape)).cuda()
    fwd_ms = cuda_ms(lambda: e0.forward(xb), reps=10)
    print(f"[smoke] ResNet-18 forward b{BATCH} through the kernels: "
          f"{fwd_ms:.3f} ms ({BATCH / fwd_ms * 1e3:.0f} img/s); its "
          f"{CONVS_PER_FORWARD} convs: kernel {totals['ms']:.3f} ms, plain "
          f"{totals['plain_ms']:.3f} ms, library {totals['library_ms']:.3f} "
          f"ms, bound {totals['bound_ms']:.3f} ms (the record's times are "
          f"these sums)", flush=True)
    met = totals["ms"] <= TARGET_FORWARD_MS and min(s1_shares) >= TARGET_FORWARD_S1_SHARE
    print(f"[smoke] time forward targets at b{BATCH}: {CONVS_PER_FORWARD} convs "
          f"{totals['ms']:.3f} ms (target <= {TARGET_FORWARD_MS}), {totals['bound_ms'] / totals['ms']:.1%}"
          f" of their bound, lowest 3x3/s1 share of the f32 bound {min(s1_shares):.1%} "
          f"(>= {TARGET_FORWARD_S1_SHARE:.0%}): {'all met' if met else 'NOT all met'}",
          flush=True)
    time_forward_tiles()
    lenet_times = time_lenet_kernels()
    zoo_times = time_zoo_kernels()
    staged_times = time_staged_kernels()
    momentum_times = time_sgd_momentum(bucket_sizes)
    report_dp_epoch(dp_profile, bucket_sizes, momentum_times)
    probe_times = time_probe_kernels()
    clock("5 kernel times")

    records = [{
        "name": "tap_conv",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/tap_conv.cu",
        "replaces": "parallel_cnn_tpu/ops/pallas_conv.py:228",
        "launches": (launches + gspmd_launches["tap_conv"] + z50_launches["tap_conv"]
                     + img_launches["tap_conv"] + vgg_launches["tap_conv"]
                     + serve50_launches + slo_launches + net_launches
                     + pipe_f32["tap_conv"] + z3_launches["tap_conv"]
                     + elastic_launches["tap_conv"] + plan_launches["tap_conv"]),
        "max_abs_err": max(max_err, shard_errs["tap_conv"], z50_errs["tap_conv"]),
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("operations" if totals["ops_ms"] >= totals["bound_ms"] / 2
                     else "bytes"),
        "library_ms": totals["library_ms"],
    }, {
        "name": "tap_conv_dgrad",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/tap_conv.cu",
        "replaces": "parallel_cnn_tpu/ops/pallas_conv.py:228",
        "launches": sum(run["tap_conv_dgrad"] for run in (
            zoo_launches, gspmd_launches, z50_launches, img_launches, vgg_launches,
            pipe_f32, z3_launches, elastic_launches, plan_launches)),
        "max_abs_err": max(zoo_errs["tap_conv_dgrad"], shard_errs["tap_conv_dgrad"],
                           z50_errs["tap_conv_dgrad"]),
        **zoo_times["tap_conv_dgrad"],
    }, {
        "name": "tap_wgrad",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/tap_wgrad.cu",
        "replaces": "parallel_cnn_tpu/ops/pallas_conv.py:321",
        "launches": sum(run["tap_wgrad"] for run in (
            zoo_launches, gspmd_launches, z50_launches, img_launches, vgg_launches,
            pipe_f32, z3_launches, elastic_launches, plan_launches)),
        "max_abs_err": max(zoo_errs["tap_wgrad"], shard_errs["tap_wgrad"],
                           z50_errs["tap_wgrad"]),
        **zoo_times["tap_wgrad"],
    }, {
        "name": "tail_ce",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/tail_ce.cu",
        "replaces": "parallel_cnn_tpu/ops/pallas_tail.py:152",
        "launches": sum(run["tail_ce"] for run in (
            zoo_launches, gspmd_launches, z50_launches, img_launches, vgg_launches,
            z3_launches, elastic_launches, plan_launches)),
        # The per-image form at the 10-class heads, the tiled one at the
        # ImageNet head (imagenet (a) reads its launches): the record's
        # times are ResNet-18's head's, the tiled form's beside them.
        "launches_by_form": {
            "image": sum(run["tail_ce"] for run in (
                zoo_launches, gspmd_launches, z50_launches, img_launches, vgg_launches,
                z3_launches, elastic_launches, plan_launches))
            - img_tiled,
            "tiled": img_tiled},
        "max_abs_err": max(zoo_errs["tail_ce"], img_tail_err),
        **zoo_times["tail_ce"],
        "tiled_form": {"head": f"gap 7x7x2048->1000 b{IMAGENET_BATCH}", **img_tail_times},
    }, {
        "name": "lenet_fused",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/lenet_fused.cu",
        "replaces": "parallel_cnn_tpu/ops/pallas.py:589",
        "launches": train_launches["lenet_fused"] + async_b1 + chaos_b1,
        "max_abs_err": lenet_err,
        **lenet_times["lenet_fused"],
    }, {
        "name": "sgd_update",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/sgd_update.cu",
        "replaces": "parallel_cnn_tpu/ops/pallas_update.py:54",
        "launches": train_launches["sgd_update"],
        "max_abs_err": sgd_err,
        **lenet_times["sgd_update"],
    }, {
        "name": "sgd_momentum",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/sgd_update.cu",
        "replaces": "parallel_cnn_tpu/ops/pallas_update.py:58",
        "launches": (dp_launches["sgd_momentum"] + pipe_b13 + z3_launches["sgd_momentum"]
                     + elastic_launches["sgd_momentum"] + plan_launches["sgd_momentum"]),
        "max_abs_err": momentum_err,
        **momentum_times,
    }] + [{
        "name": f"{name}.bf16",
        "route": "cuda",
        "source": f"parallel_cnn_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": sum(n for key, n in bf16_launches.items() if key.split(".")[0] == name),
        **({"launches_by_form": {form: bf16_launches[f"{name}.{form}"]
                                 for form in ("wgmma", "ffma")}}
           if f"{name}.wgmma" in bf16_launches else {}),
        "max_abs_err": bf16_errs[name],
        **bf16_times[name],
    } for name, source, replaces in (
        ("tap_conv", "tap_conv.cu", "parallel_cnn_tpu/ops/pallas_conv.py:228"),
        ("tap_conv_dgrad", "tap_conv.cu", "parallel_cnn_tpu/ops/pallas_conv.py:228"),
        ("tap_wgrad", "tap_wgrad.cu", "parallel_cnn_tpu/ops/pallas_conv.py:321"),
        ("tail_ce", "tail_ce.cu", "parallel_cnn_tpu/ops/pallas_tail.py:152"))] + [{
        "name": f"lenet_staged.{name}",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/lenet_staged.cu",
        "replaces": f"parallel_cnn_tpu/ops/pallas.py:{STAGED_REPLACES[name]}",
        "launches": staged_launches[name],
        "max_abs_err": staged_errs[name],
        **staged_times[name],
    } for name in lenet_staged.KERNELS] + [{
        "name": f"mosaic_probe.{name}",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/mosaic_probe.cu",
        "replaces": f"benches/mosaic_probe.py:{mosaic_probe.REPLACES[name][1]}",
        "launches": probe_launches[name],
        "max_abs_err": probe_errs[name],
        **probe_times[name],
    } for name in mosaic_probe.KERNELS]
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
