"""Trainer for the model zoo (CIFAR CNN, ResNet-18/34/50, VGG-16): the port of
``parallel_cnn_tpu/train/zoo.py`` on one device, over JAX's GSPMD mesh
(data and model axes, ``mesh=`` without ``comm``) and data-parallel over
the explicit collectives (``comm=``).

Softmax cross-entropy and SGD with momentum written out as optax computes
them (``make_optimizer``: ``m ← g + β·m``, no dampening, weight decay added
to ``g`` before the momentum, ``p ← p − lr(count)·m`` with the schedule read
at the count before its increment), gradient accumulation over
microbatches with the BN state threaded through them, the fused loss tail
(``FusedStepConfig.tail``, ops/tail.py), per-epoch eval, an atomic
checkpoint ring in the JAX package's ``ZooState`` format (a file either
package writes, the other restores), the health sentinel with skip or
rollback, and a preemption stop at the epoch boundary.

The port's state is a module (its parameters and BN buffers) plus the
momentum trace and the schedule count; a train step updates them in
place. JAX's ``ZooState(params, model_state, opt_state)`` is what
``ZooState.arrays()`` writes and ``ZooState.load()`` reads, under JAX's
checkpoint keys (``.params/3/main/0/conv/w``,
``.model_state/3/main/0/bn/mean``, ``.opt_state/0/0/.trace/...``,
``.opt_state/0/1/.count``).

The GSPMD path. Under JAX's GSPMD the step is the single-device step on
the global batch, and XLA places the collectives. ``train(..., mesh=)``
without ``comm`` is its port (``_make_gspmd_step``): one process per rank
of a ``Mesh2D`` (parallel/mesh.py), each drawing the same global batches.
``init_state(..., mesh=, model_axis=)`` places the model on the rank
(parallel/zoo_sharding.py): BatchNorm takes the global batch's statistics
(two all-reduced passes over the data axis) and, with ``model_axis``,
each leaf that JAX's ``leaf_spec`` splits is this rank's block of it, the
layers gathering activations over the model axis where the next layer
needs every channel (nn/core.py). Each microbatch of the global batch
gives each rank its rows; the loss is each rank's sum over its rows ÷ the
global microbatch, its gradient summed over the data axis in buckets
after the backward; each rank updates its own shards and their momentum.
Augmentation draws once for the global batch from the single-device
stream, and each rank crops its rows. A checkpoint gathers every leaf
whole (JAX's format, any mesh resumes it), and eval runs the whole
(gathered) model over each data rank's share of the eval rows.

Data parallelism over explicit collectives. ``train(..., mesh=, comm=)``
runs on every rank of a world that parallel/distributed.py started; each
rank draws the same global batches and trains on its rows
(``DataMesh.shard_rows``, JAX's ``P(DATA_AXIS)``). ``_make_comm_step`` is
JAX's explicit-collective step:
BatchNorm normalises over the rank's microbatch (per-shard statistics,
not SyncBN), the grads are summed over ranks by psum or the bucketed ring
(reduce-scattered per microbatch with ``comm.overlap``) and divided by
``accum·n``, and the loss and BN running statistics are averaged over
ranks. ``make_fused_train_step`` is update-on-arrival: after the last
microbatch's reduce-scatter each rank updates the parameter and momentum
shard of each bucket it owns with the fused SGD-momentum kernel
(ops/sgd_update.py), skips the update on every rank when any gradient
shard is not finite, and all-gathers the updated parameter shards,
always in f32. Its optimizer state is ``FusedOptState``: the momentum as
one ``(n_data, L)`` row block per bucket, of which rank r holds row r.

Batch order. ``loader="native"`` gives the native C++ ring's batches
(data/native.py, seeded ``seed + epoch + 1``; its NumPy twin where the
ring cannot be built, as in JAX), so both packages train on the same
batches. ``loader="device"`` draws each epoch's
permutation from ``torch.Generator().manual_seed(seed + epoch)``, which
cannot reproduce JAX's threefry permutation: the two packages shuffle
differently, each reproducibly, so resume is exact on both. Augmentation
likewise draws from a generator seeded by the epoch (and, on the explicit
collective path, the rank).

bf16 activations (``FusedStepConfig.act_dtype="bfloat16"``, JAX's
default for ``--fused-step``). The loss casts the input and every floating
parameter to bf16 at its top (``_build_loss_fn``, JAX's zoo.py:104-111):
the layers run in bf16, the conv and tail kernels in their bf16 forms,
BatchNorm's statistics and running state in f32, and autograd of the cast
carries each gradient back to its f32 master. The loss is scaled before
the backward: by the static ``loss_scale`` on ``make_train_step`` (single
device, GSPMD and the explicit collectives), each microbatch's grads
multiplied by the exact ``1/scale`` before they are summed; by the
dynamic scale of ``FusedOptState`` on update-on-arrival, backed off on an
overflow (clamped at 1) and doubled after ``growth_interval`` clean
steps, on the device. Evaluation runs the f32 masters.

Pipeline parallelism. ``train(..., mesh=, pipeline=)`` on a ``(stage,
data)`` mesh (``PipelineMesh``) is JAX's 1F1B path
(train/pipeline_schedule.py): the layers split over the stage axis,
``accum_steps`` microbatches through the schedule a step, the data axis
the ring, the optimizer or the ZeRO-2 tail.

The hierarchical ring. On a ``(host, data)`` mesh (``HierMesh``) the
batch shards over both axes (rank r takes block r), ``comm.impl=
"hierarchical"`` reduces each bucket through the two-level ring
(parallel/collectives.py ``hier_*``) and "psum" over the whole world; the
flat ring is refused there, as in JAX.

ZeRO-3 (``FusedStepConfig(zero=3)``, JAX's ``make_zero3_train_step``,
zoo.py:918-1128). The parameters live as this rank's ``(1, L)`` row of
each bucket, as the momentum does (``Zero3Params``, rows in
``hier_shard_rows`` order, so a rank's row is the chunk its ring
delivers). Each step all-gathers every bucket into the module's
parameters (f32 on the wire), reduce-scatters each microbatch's
gradients, agrees on finiteness, updates the resident rows with one B13
launch over all buckets and gathers nothing after: the module's parameter
storage is released after the update and refilled at the next head, so
between steps a rank holds 1/n of the parameters. Evaluation and
checkpoints gather them (``zero3_params``, ``zero3_full_view``: every
rank calls them); a checkpoint is JAX's sharded file, the full view that
``zero3_from_view`` lays out for any mesh.

Elastic ZeRO-3 (``train(..., elastic=)``, JAX's zoo.py:1633-1800 with
resilience/elastic.py): the world resizes in flight over the spawned
ranks, the state resharded through the full view. The trainer's chaos
(``nan@``, ``kill@``, ``resize@``, ``slow-stage@``), the per-step sentinel
cadence and JAX's obs spans and events ride the same loop.

The ExecutionPlan (``train(..., plan=, replan=)``, plan/): its
fingerprint stamps every checkpoint and gates every resume, and under
elastic training each resize is a plan derivation whose result keys the
step cache. Not here (ROADMAP A13b): profiling.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import re
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch import plan as plan_lib
from parallel_cnn_tpu_torch.config import (
    CommConfig,
    ElasticConfig,
    FusedStepConfig,
    ResilienceConfig,
)
from parallel_cnn_tpu_torch.data import augment as aug_lib
from parallel_cnn_tpu_torch.data import native, pipeline
from parallel_cnn_tpu_torch.nn.core import whole
from parallel_cnn_tpu_torch.ops import sgd_update, tail
from parallel_cnn_tpu_torch.parallel import collectives, zoo_sharding
from parallel_cnn_tpu_torch.parallel.mesh import (
    DataMesh,
    HierMesh,
    Mesh2D,
    PipelineMesh,
    as_mesh_2d,
)
from parallel_cnn_tpu_torch.resilience import preempt
from parallel_cnn_tpu_torch.resilience.rollback import (
    CheckpointRing,
    RollbackController,
    tree_copy,
)
from parallel_cnn_tpu_torch.resilience.sentinel import DivergenceError, Sentinel, Verdict
from parallel_cnn_tpu_torch.train import checkpoint
from parallel_cnn_tpu_torch.utils.backend import DeviceLike, resolve_device

LOADERS = ("device", "native")
SCHEDULES = ("constant", "cosine")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return F.cross_entropy(logits.float(), labels.long())


# ---------------------------------------------------------------------------
# Optimizer: optax.chain([add_decayed_weights], sgd(lr | schedule, momentum))
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with momentum, optional weight decay and an LR schedule, as
    ``make_optimizer`` builds it with optax. Stateless: the trace and the
    count live in ``ZooState``."""

    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: Optional[int] = None

    @property
    def scheduled(self) -> bool:
        """optax keeps a step count only for a schedule (cosine, or a
        warmup), not for a constant LR."""
        return self.schedule == "cosine" or self.warmup_steps > 0

    @property
    def chain_index(self) -> int:
        """Index of the sgd transform in the optax chain (the decayed
        weights come first)."""
        return 1 if self.weight_decay else 0

    def learning_rate(self, count: int) -> np.float32:
        """The LR at step ``count``, in f32 as optax computes it."""
        f32 = np.float32
        lr, w = f32(self.lr), self.warmup_steps

        def warmup(c):  # optax.linear_schedule(0, lr, w)
            frac = f32(1) - f32(min(max(c, 0), w)) / f32(w)
            return f32(-lr) * frac + lr

        if self.schedule == "constant":
            return warmup(count) if w else lr
        if count < w:
            return warmup(count)
        decay = float(self.total_steps - w)  # optax.cosine_decay_schedule
        c = f32(min(float(count - w), decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return lr * cosine

    def apply(self, state: "ZooState", grads: Sequence[torch.Tensor]) -> None:
        """One update of ``state``'s parameters and trace, in place."""
        names, params = zip(*state.model.named_parameters())
        traces = [state.trace[n] for n in names]
        grads = list(grads)
        if self.weight_decay:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(list(params), self.weight_decay))
        torch._foreach_mul_(traces, self.momentum)
        torch._foreach_add_(traces, grads)
        step = -float(self.learning_rate(state.count))
        torch._foreach_add_(list(params), torch._foreach_mul(traces, step))
        if self.scheduled:
            state.count += 1


def make_optimizer(lr: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 0.0, schedule: str = "constant",
                   warmup_steps: int = 0,
                   total_steps: Optional[int] = None) -> SGD:
    """SGD(+momentum, +weight decay) with "constant" (optional linear
    warmup) or "cosine" (warmup, then cosine decay to 0 at
    ``total_steps``) LR."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("schedule='cosine' needs total_steps")
        if total_steps <= warmup_steps:
            raise ValueError("cosine decay needs total_steps > warmup_steps")
    return SGD(lr, momentum, weight_decay, schedule, warmup_steps, total_steps)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def _jax_path(key: str) -> str:
    return key.replace(".", "/")


def jax_ordered_params(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """``model.named_parameters()`` in the order JAX flattens its params
    tree: sequence indices in order, dict keys sorted (a ConvBNAct's
    ``bn.bias, bn.scale, conv.w``). The bucket plans, and so the shard
    each rank owns, follow this order, as JAX's do."""
    def key(item):
        return tuple((0, int(c)) if c.isdigit() else (1, c)
                     for c in item[0].split("."))

    return sorted(model.named_parameters(), key=key)


#: Checkpoint keys of a ``FusedOptState`` (JAX's dataclass fields).
MOM_KEY = ".opt_state/.mom/"
_TRACE_KEY = re.compile(r"^\.opt_state/\d+/0/\.trace/")


def _state_key(key: str) -> Optional[str]:
    """The state_dict key of the parameter or buffer behind checkpoint
    ``key`` (a momentum trace's is its parameter's), else None."""
    for prefix in (".params/", ".model_state/"):
        if key.startswith(prefix):
            return key[len(prefix):].replace("/", ".")
    m = _TRACE_KEY.match(key)
    return key[m.end():].replace("/", ".") if m else None
_FUSED_SCALARS = (".opt_state/.scale", ".opt_state/.good_steps",
                  ".opt_state/.skipped")


@dataclasses.dataclass
class FusedOptState:
    """Optimizer state of the update-on-arrival step (JAX's
    ``FusedOptState``, zoo.py:50-66).

    The momentum lives sharded: per collectives bucket one ``(n_data, L)``
    f32 block, of which this rank holds its own row as ``mom[b]`` of shape
    ``(1, L)``, because the step only ever updates the local shard. The
    loss-scale state rides beside it (f32: the scale stays 1)."""

    mom: List[torch.Tensor]   # this rank's (1, L) row per bucket, f32
    scale: torch.Tensor       # () f32: the current loss scale
    good_steps: torch.Tensor  # () int32: clean steps since the last change
    skipped: torch.Tensor     # () int32: updates dropped on overflow


@dataclasses.dataclass
class Zero3Params:
    """A ZeRO-3 state's parameters (JAX's ``ZooState.params`` of
    ``init_zero3_state``): this rank's ``(1, L)`` f32 row of each bucket of
    ``plan`` (the params in JAX's order, padded to ``plan.shards`` =
    H·D), row r of ``hier_shard_rows`` on rank r."""

    rows: List[torch.Tensor]
    plan: collectives.BucketPlan


@dataclasses.dataclass
class ZooState:
    """The model (parameters and BN buffers), the momentum trace per
    parameter name and the schedule count: what a step updates. With
    ``fused`` the optimizer state is a ``FusedOptState`` instead of the
    trace and count; ``mesh`` is the rank's data axis (or its
    ``HierMesh``), which a fused state's checkpoint gathers over, or the
    GSPMD path's ``Mesh2D`` with ``plan``, the model's placement on it
    (parallel/zoo_sharding.py): the parameters, BN buffers and traces are
    then this rank's shards. With ``zero3`` the parameters are the rows
    of ``Zero3Params``, and the module's parameters hold no storage
    between steps."""

    model: nn.Module
    optimizer: SGD
    trace: Dict[str, torch.Tensor]
    count: int = 0
    fused: Optional[FusedOptState] = None
    mesh: Optional[Union[DataMesh, Mesh2D, HierMesh]] = None
    plan: Optional[zoo_sharding.ShardPlan] = None
    zero3: Optional[Zero3Params] = None

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The live tensors under the JAX package's checkpoint keys (a
        fused state's momentum as this rank's rows; a ZeRO-3 state's
        parameters as its rows, ``.params/<b>``)."""
        buffers = {n for n, _ in self.model.named_buffers()}
        out = {}
        for key, t in self.model.state_dict().items():
            if key in buffers:
                out[".model_state/" + _jax_path(key)] = t
            elif self.zero3 is None:
                out[".params/" + _jax_path(key)] = t
        if self.zero3 is not None:
            for b, row in enumerate(self.zero3.rows):
                out[f".params/{b}"] = row
        if self.fused is not None:
            for b, row in enumerate(self.fused.mom):
                out[f"{MOM_KEY}{b}"] = row
            opt = self.fused
            out.update(zip(_FUSED_SCALARS, (opt.scale, opt.good_steps, opt.skipped)))
            return out
        prefix = f".opt_state/{self.optimizer.chain_index}"
        for key, t in self.trace.items():
            out[f"{prefix}/0/.trace/{_jax_path(key)}"] = t
        if self.optimizer.scheduled:
            out[f"{prefix}/1/.count"] = torch.tensor(self.count, dtype=torch.int32)
        return out

    def checkpoint_arrays(self) -> Dict[str, torch.Tensor]:
        """``arrays()`` as a checkpoint holds them: each momentum block
        whole, ``(n_data, L)``, its rows gathered from every rank; each
        leaf split over a model axis whole, gathered in the rank's model
        row; a ZeRO-3 state's full view (``zero3_full_view``). Every rank
        calls it (a collective when the world is larger than one)."""
        if self.zero3 is not None:
            return zero3_full_view(self)
        out = self.arrays()
        plan = self.plan
        if plan is not None and plan.split:
            out = {k: plan.gather(_state_key(k), t) if _state_key(k) else t
                   for k, t in out.items()}
        mesh = self.mesh
        if self.fused is not None and mesh is not None and mesh.world > 1:
            for b, row in enumerate(self.fused.mom):
                rows = [torch.empty_like(row) for _ in range(mesh.world)]
                dist.all_gather(rows, row.contiguous(), group=mesh.group)
                out[f"{MOM_KEY}{b}"] = torch.cat(rows)
        return out

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """A copy of ``arrays()`` that nothing else aliases."""
        return tree_copy(self.arrays())

    def load(self, arrays: Dict[str, torch.Tensor]) -> None:
        """Copy ``arrays`` (tensors or numpy arrays under the keys of
        ``arrays()``) into the state, in place. Keys, shapes and dtypes
        must match exactly, except that a momentum block may come whole,
        ``(n_data, L)`` as a checkpoint holds it, and a leaf split over a
        model axis may come whole: this rank takes its row or block."""
        want = self.arrays()
        if set(arrays) != set(want):
            raise ValueError(
                f"zoo state mismatch: missing={sorted(set(want) - set(arrays))} "
                f"surplus={sorted(set(arrays) - set(want))}")
        with torch.no_grad():
            for key, dst in want.items():
                src = arrays[key]
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src, copy=True))
                if (key.startswith(MOM_KEY) and self.mesh is not None
                        and src.dim() == 2 and src.shape[0] == self.mesh.world
                        and dst.shape[0] == 1):
                    src = src[self.mesh.rank:self.mesh.rank + 1]
                if self.plan is not None and _state_key(key):
                    src = self.plan.local(_state_key(key), src, dst)
                if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                    raise ValueError(
                        f"zoo state leaf '{key}' is {tuple(src.shape)}/{src.dtype}, "
                        f"expected {tuple(dst.shape)}/{dst.dtype}")
                if key.endswith("/.count"):
                    self.count = int(src)
                else:
                    dst.copy_(src)


    def eval_model(self) -> nn.Module:
        """The model with every leaf whole, for the evaluation forward (on
        a split model, gathered into its whole copy: a collective over the
        model axis)."""
        return self.plan.whole_model(self.model) if self.plan else self.model


def init_state(model: nn.Module, optimizer: SGD, mesh=None,
               model_axis: bool = False) -> ZooState:
    """A fresh state for ``model`` (its weights are the init): zero
    momentum on the parameters' devices, count 0. With ``mesh`` (the GSPMD
    path: a ``Mesh2D``, or a ``DataMesh`` as a data × 1 mesh) the model is
    first placed on this rank, in place (``zoo_sharding.shard_model``:
    with ``model_axis``, its split leaves become this rank's blocks), and
    the momentum shards with the parameters."""
    plan = None
    if mesh is not None:
        mesh = as_mesh_2d(mesh)
        plan = zoo_sharding.shard_model(model, mesh, model_axis)
    trace = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return ZooState(model, optimizer, trace, mesh=mesh, plan=plan)


def init_fused_state(model: nn.Module, optimizer: SGD, *, mesh: DataMesh,
                     fused: FusedStepConfig,
                     bucket_bytes: int) -> Tuple[ZooState, int]:
    """(ZooState for the update-on-arrival step, bucket count), as JAX's
    ``init_fused_state`` (zoo.py:186-220): zero momentum in its sharded
    layout, one ``(1, L)`` row per bucket of the params' plan (the
    gradients' plan is the same: same leaves in the same order), the loss
    scale at ``fused.loss_scale`` for bf16 and 1 for f32."""
    params = [p for _, p in jax_ordered_params(model)]
    plan = collectives.plan_buckets(params, bucket_bytes, shards=mesh.world)
    dev = params[0].device
    mom = [torch.zeros((1, size // mesh.world), dtype=torch.float32, device=dev)
           for size in plan.bucket_sizes]
    scale0 = fused.loss_scale if fused.act_dtype == "bfloat16" else 1.0
    opt = FusedOptState(
        mom=mom,
        scale=torch.tensor(scale0, dtype=torch.float32, device=dev),
        good_steps=torch.zeros((), dtype=torch.int32, device=dev),
        skipped=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return ZooState(model, optimizer, {}, fused=opt, mesh=mesh), plan.n_buckets


# ---------------------------------------------------------------------------
# ZeRO-3: the parameters as resident bucket rows
# ---------------------------------------------------------------------------


def _mesh_shape(mesh: Union[DataMesh, HierMesh]) -> Tuple[int, int]:
    """(H, D) of the batch-parallel mesh: a ``HierMesh``'s axes, or one
    host of the data axis."""
    if isinstance(mesh, HierMesh):
        return mesh.host.size, mesh.data.size
    return 1, mesh.world


def _ring_axes(mesh: Union[DataMesh, HierMesh]):
    """(device axis, host axis or None) the bucket collectives take."""
    if isinstance(mesh, HierMesh):
        return mesh.data, mesh.host
    return mesh, None


def _release_params(params: Sequence[torch.Tensor]) -> None:
    """Free each parameter's storage, keeping the parameter itself (its
    shape, its place in the module, autograd's leaf)."""
    for p in params:
        p.data.untyped_storage().resize_(0)


def _fill_params(params: Sequence[torch.Tensor],
                 values: Sequence[torch.Tensor]) -> None:
    """Give each released parameter its storage back and copy its value
    in (under no_grad; the copy moves each parameter's version, which
    caches keyed on it, such as the eval BN fold, read)."""
    for p in params:
        p.data.untyped_storage().resize_(p.numel() * p.element_size())
    _copy_into(list(params), values)


def _own_storage(params: Sequence[torch.Tensor]) -> None:
    """Make every parameter the sole, compact owner of its storage, so
    that releasing it frees exactly its bytes (a released one already
    is)."""
    for p in params:
        if p.untyped_storage().nbytes() == 0 < p.numel():
            continue
        if (p.storage_offset() or not p.is_contiguous()
                or p.untyped_storage().nbytes() != p.numel() * p.element_size()):
            p.data = p.data.clone()


def _rows_of(buckets: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """This rank's ``(1, L)`` row of each bucket, copied out (a view would
    keep the whole bucket alive)."""
    n_host, n_data = _mesh_shape(mesh)
    r = mesh.rank
    return [collectives.hier_shard_rows(b, n_host, n_data)[r:r + 1].clone()
            for b in buckets]


def _full_buckets(rows: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each bucket whole on every rank, all-gathered from the ranks'
    ``(1, L)`` rows over the mesh's ring (the flat ring, or a
    ``HierMesh``'s two-level ring: the exact inverse of the placement that
    ``hier_shard_rows`` lays out), always f32 on the wire. A collective:
    every rank calls it."""
    axis, host = _ring_axes(mesh)
    return collectives.all_gather_buckets([r[0] for r in rows], axis, None, host=host)


def _gather_params(params: Sequence[torch.Tensor], z3: "Zero3Params", mesh) -> None:
    """Just-in-time gathering: the resident rows into the module's
    (released) parameters, in JAX's order."""
    with torch.no_grad():
        _fill_params(params, collectives.unflatten_buckets(
            _full_buckets(z3.rows, mesh), z3.plan))


def init_zero3_state(model: nn.Module, optimizer: SGD, *,
                     mesh: Union[DataMesh, HierMesh], fused: FusedStepConfig,
                     bucket_bytes: int) -> Tuple[ZooState, collectives.BucketPlan]:
    """(ZooState for the ZeRO-3 step, its bucket plan), as JAX's
    ``init_zero3_state`` (zoo.py:809-848): the parameters (JAX's order)
    planned into buckets padded to H·D shards, this rank's ``(1, L)`` row
    of each kept (``hier_shard_rows`` order), zero momentum in the same
    rows, the loss scale at ``fused.loss_scale`` for bf16 and 1 for f32.
    The module's parameter storage is released: the step gathers it."""
    params = [p for _, p in jax_ordered_params(model)]
    n_host, n_data = _mesh_shape(mesh)
    plan = collectives.plan_buckets(params, bucket_bytes, shards=n_host * n_data)
    with torch.no_grad():
        rows = _rows_of(collectives.flatten_buckets(params, plan), mesh)
    dev = params[0].device
    scale0 = fused.loss_scale if fused.act_dtype == "bfloat16" else 1.0
    opt = FusedOptState(
        mom=[torch.zeros_like(r, dtype=torch.float32) for r in rows],
        scale=torch.tensor(scale0, dtype=torch.float32, device=dev),
        good_steps=torch.zeros((), dtype=torch.int32, device=dev),
        skipped=torch.zeros((), dtype=torch.int32, device=dev),
    )
    _own_storage(params)
    _release_params(params)
    return (ZooState(model, optimizer, {}, fused=opt, mesh=mesh,
                     zero3=Zero3Params(rows, plan)), plan)


def _param_paths(model: nn.Module) -> List[str]:
    return [_jax_path(n) for n, _ in jax_ordered_params(model)]


def zero3_full_params(state: ZooState) -> Dict[str, torch.Tensor]:
    """The parameters whole, by JAX path (``3/main/0/conv/w``), gathered
    from every rank's rows (JAX's ``zero3_full_params``, there a reshuffle
    of one global array, here an all-gather over the world: every rank
    calls it). Exact."""
    z3 = state.zero3
    full = collectives.unflatten_buckets(_full_buckets(z3.rows, state.mesh), z3.plan)
    return dict(zip(_param_paths(state.model), full))


def zero3_full_view(state: ZooState) -> Dict[str, torch.Tensor]:
    """The world-size-independent view of a ZeRO-3 state (JAX's
    ``zero3_full_view``), under JAX's keys: ``params/<path>``,
    ``model_state/<path>`` (the BN statistics), ``mom/<path>`` (the
    momentum unflattened through the params' plan, so its leaves mirror
    the params), ``scale``, ``good_steps``, ``skipped``. What
    ``checkpoint.save_sharded`` writes; ``zero3_from_view`` lays it out
    for any mesh, bit for bit. A collective: every rank calls it."""
    z3, opt = state.zero3, state.fused
    paths = _param_paths(state.model)
    mom = collectives.unflatten_buckets(_full_buckets(opt.mom, state.mesh), z3.plan)
    view = {f"params/{k}": v for k, v in zero3_full_params(state).items()}
    buffers = {n for n, _ in state.model.named_buffers()}
    view.update({f"model_state/{_jax_path(k)}": t.detach().clone()
                 for k, t in state.model.state_dict().items() if k in buffers})
    view.update({f"mom/{k}": v for k, v in zip(paths, mom)})
    view.update(scale=opt.scale.clone(), good_steps=opt.good_steps.clone(),
                skipped=opt.skipped.clone())
    return view


def zero3_from_view(state: ZooState, view: Dict[str, torch.Tensor]) -> None:
    """Load a full view (``zero3_full_view``, from any world) into the
    ZeRO-3 ``state`` for its own mesh, in place (JAX's
    ``zero3_from_view``): the params and momentum flattened through the
    state's plan and this rank's rows taken, the BN statistics and the
    loss-scale scalars copied. Keys and shapes must match the state's
    model exactly."""
    z3, opt, model = state.zero3, state.fused, state.model
    named = jax_ordered_params(model)
    buffers = {n for n, _ in model.named_buffers()}
    want = {f"{tree}/{_jax_path(n)}": tuple(p.shape)
            for n, p in named for tree in ("params", "mom")}
    bufs = {k: t for k, t in model.state_dict().items() if k in buffers}
    want.update({f"model_state/{_jax_path(k)}": tuple(t.shape) for k, t in bufs.items()})
    want.update(scale=(), good_steps=(), skipped=())
    if set(view) != set(want):
        raise ValueError(
            f"zero3 view mismatch: missing={sorted(set(want) - set(view))} "
            f"surplus={sorted(set(view) - set(want))}")
    for k, shape in want.items():
        if tuple(view[k].shape) != shape:
            raise ValueError(f"zero3 view leaf '{k}' is {tuple(view[k].shape)}, "
                             f"expected {shape}")
    dev = opt.scale.device

    def leaves(tree):
        return [torch.as_tensor(view[f"{tree}/{_jax_path(n)}"]).to(dev, torch.float32)
                for n, _ in named]

    with torch.no_grad():
        z3.rows = _rows_of(collectives.flatten_buckets(leaves("params"), z3.plan),
                           state.mesh)
        opt.mom = _rows_of(collectives.flatten_buckets(leaves("mom"), z3.plan),
                           state.mesh)
        for k, t in bufs.items():
            t.copy_(torch.as_tensor(view[f"model_state/{_jax_path(k)}"]))
    opt.scale = torch.as_tensor(view["scale"]).to(dev, torch.float32).clone()
    opt.good_steps = torch.as_tensor(view["good_steps"]).to(dev, torch.int32).clone()
    opt.skipped = torch.as_tensor(view["skipped"]).to(dev, torch.int32).clone()


def zero3_view_like(model: nn.Module, device=None) -> Dict[str, torch.Tensor]:
    """A zero tree of ``zero3_full_view``'s keys, shapes and dtypes for
    ``model`` (on ``device``, default its buffers' or the CPU): what a
    rank that holds no state receives a view into, and the structure a
    sharded checkpoint is read against. Reads no parameter's storage."""
    bufs = {k: t for k, t in model.state_dict().items()
            if k in {n for n, _ in model.named_buffers()}}
    if device is None:
        device = next(iter(bufs.values())).device if bufs else torch.device("cpu")
    view = {}
    for n, p in jax_ordered_params(model):
        for tree in ("params", "mom"):
            view[f"{tree}/{_jax_path(n)}"] = torch.zeros(
                tuple(p.shape), dtype=torch.float32, device=device)
    for k, t in bufs.items():
        view[f"model_state/{_jax_path(k)}"] = torch.zeros(
            tuple(t.shape), dtype=t.dtype, device=device)
    view.update(scale=torch.zeros((), dtype=torch.float32, device=device),
                good_steps=torch.zeros((), dtype=torch.int32, device=device),
                skipped=torch.zeros((), dtype=torch.int32, device=device))
    return view


def zero3_state_from_view(model: nn.Module, optimizer: SGD, view, *,
                          mesh: Union[DataMesh, HierMesh],
                          bucket_bytes: int) -> Tuple[ZooState, collectives.BucketPlan]:
    """(ZooState, plan) for ``mesh`` laid out from a full view: JAX's
    ``zero3_from_view(view, n_data=, bucket_bytes=, n_host=)``, which
    builds the state from the view alone (the port's state also holds
    ``model``, whose parameters' storage is released here, and
    ``optimizer``). The loss-scale state comes from the view. Bit-exact:
    ``zero3_full_view`` of the result is ``view``."""
    params = [p for _, p in jax_ordered_params(model)]
    n_host, n_data = _mesh_shape(mesh)
    plan = collectives.plan_buckets(params, bucket_bytes, shards=n_host * n_data)
    dev = mesh.device
    rows = [torch.zeros((1, size // (n_host * n_data)), dtype=torch.float32, device=dev)
            for size in plan.bucket_sizes]
    opt = FusedOptState(
        mom=[torch.zeros_like(r) for r in rows],
        scale=torch.ones((), dtype=torch.float32, device=dev),
        good_steps=torch.zeros((), dtype=torch.int32, device=dev),
        skipped=torch.zeros((), dtype=torch.int32, device=dev),
    )
    _own_storage(params)
    _release_params(params)
    state = ZooState(model, optimizer, {}, fused=opt, mesh=mesh,
                     zero3=Zero3Params(rows, plan))
    zero3_from_view(state, view)
    return state, plan


@contextlib.contextmanager
def zero3_params(state: ZooState):
    """The module's parameters whole inside the block (a ZeRO-3 state's
    rows all-gathered into them, for evaluation), released after. A
    collective: every rank enters it. A state without ZeRO-3 is left as
    it is."""
    if state.zero3 is None:
        yield state.model
        return
    params = [p for _, p in jax_ordered_params(state.model)]
    _gather_params(params, state.zero3, state.mesh)
    try:
        yield state.model
    finally:
        _release_params(params)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


class _Bound(nn.Module):
    """``loss(m, x, y)`` as a module holding ``m``, so that
    ``torch.func.functional_call`` can run it on substituted parameters."""

    def __init__(self, loss: Callable, m: nn.Module):
        super().__init__()
        self.loss = loss
        self.m = m

    def forward(self, x, y):
        return self.loss(self.m, x, y)


def _cast_to_bf16(loss: Callable) -> Callable:
    """JAX's cast at the top of the loss (zoo.py:104-111): ``x`` and every
    floating parameter in bf16 for the call. The buffers (BatchNorm's
    running statistics) stay the module's own f32 tensors, which its
    layers update in place; the gradient of each cast parameter flows
    through the cast back to its f32 master as f32, as through JAX's
    transpose."""
    def loss_fn(m, x, y):
        params = {f"m.{n}": p.to(torch.bfloat16)
                  for n, p in m.named_parameters() if p.is_floating_point()}
        return torch.func.functional_call(_Bound(loss, m), params,
                                          (x.to(torch.bfloat16), y))

    return loss_fn


def _static_scale(fused: Optional[FusedStepConfig]) -> float:
    """JAX's static loss scale: ``fused.loss_scale`` on the bf16 path, else
    1."""
    if fused is not None and fused.act_dtype == "bfloat16":
        return float(fused.loss_scale)
    return 1.0


def _scaled_grads(loss: torch.Tensor, params, scale: float) -> List[torch.Tensor]:
    """The grads of ``loss`` through ``loss · scale``, multiplied by
    ``1/scale``: an exact power of two for JAX's scales, so the unscale
    loses no bit (zoo.py:289-312)."""
    if scale == 1.0:
        return list(torch.autograd.grad(loss, params))
    grads = torch.autograd.grad(loss * scale, params)
    return torch._foreach_mul(list(grads), 1.0 / scale)


def _build_loss_fn(model: nn.Module, fused: Optional[FusedStepConfig]) -> Callable:
    """loss(model, x, y) with the fused-step refinements: ``fused.tail``
    routes a recognised pool → flatten → Dense suffix through the fused
    loss tail, keeping the unfused composition (with a note) when the
    head does not match; ``fused.act_dtype="bfloat16"`` runs it all on
    bf16 casts of the input and the parameters."""
    loss_fn = _uncast_loss_fn(model, fused)
    if fused is not None and fused.act_dtype == "bfloat16":
        return _cast_to_bf16(loss_fn)
    return loss_fn


def _uncast_loss_fn(model: nn.Module, fused: Optional[FusedStepConfig]) -> Callable:
    split = tail.split_tail(model) if fused is not None and fused.tail else None
    if fused is not None and fused.tail and split is None:
        print("fused-step: model tail not fusable; keeping unfused tail")
    if split is None:
        return lambda m, x, y: cross_entropy(m(x), y)

    def loss_fn(m, x, y):
        dense = m[-1]
        w, b = dense.w, dense.b
        sh = m.sharding
        if sh is None:
            feats = x
            for layer in list(m)[: split.trunk]:
                feats = layer(feats)
        else:
            # The tail needs every feature and every class: the trunk's
            # output and a head split by class are gathered, and the
            # gathered head's gradient is whole on every rank.
            feats, feats_split = m.forward_split(x, False, split.trunk)
            feats = whole(feats, feats_split, False, sh.model)
            if dense.sharding.split:
                w = collectives.gather_last(w, sh.model, partial=False)
                b = collectives.gather_last(b, sh.model, partial=False)
        return tail.fused_tail_loss(feats, w, b, y, pool=split.pool)

    return loss_fn


def make_train_step(model: nn.Module, optimizer: SGD, accum_steps: int = 1,
                    augment_pad: Optional[int] = None,
                    fused: Optional[FusedStepConfig] = None,
                    mesh: Optional[Union[DataMesh, Mesh2D]] = None,
                    comm: Optional[CommConfig] = None,
                    model_axis: bool = False) -> Callable:
    """step(state, x, y, aug=None) → loss (a device scalar), updating
    ``state`` in place: grads of the (microbatch-averaged) loss, then one
    optimizer update. ``accum_steps > 1`` splits the batch into that many
    microbatches, in order, threading the BN state through them.
    ``augment_pad`` set means the step crops and flips ``x`` with the
    draws ``aug = (offsets, flips)`` first. ``comm`` (with ``mesh``) is
    JAX's explicit-collective data-parallel step (``_make_comm_step``):
    ``x``, ``y`` are then the global batch, and ``aug`` the draws for this
    rank's rows. ``mesh`` without ``comm`` is JAX's GSPMD step
    (``_make_gspmd_step``; ``model_axis`` splits the filters over the
    mesh's model axis): ``x``, ``y`` and ``aug`` are the global batch and
    its draws, and ``state`` comes from ``init_state`` with the same mesh
    and ``model_axis``. ``fused.update`` is not taken here:
    update-on-arrival is ``make_fused_train_step`` (``train`` dispatches
    to it)."""
    if model_axis and mesh is None:
        raise ValueError("model_axis=True requires a mesh")
    if fused is not None and fused.update:
        raise ValueError(
            "fused.update (update-on-arrival) requires the explicit "
            "ring-collective step — use make_fused_train_step / "
            "train(..., fused=...), or pass fused with update=False")
    if comm is not None:
        if mesh is None:
            raise ValueError("comm (explicit collectives) requires a mesh")
        if model_axis:
            raise ValueError(
                "comm is the explicit data-parallel collective path; "
                "model_axis sharding stays on the GSPMD path (comm=None)")
        return _make_comm_step(model, optimizer, accum_steps, augment_pad,
                               fused, mesh, comm)
    if mesh is not None:
        return _make_gspmd_step(model, optimizer, accum_steps, augment_pad,
                                fused, as_mesh_2d(mesh), model_axis)
    loss_fn = _build_loss_fn(model, fused)
    scale = _static_scale(fused)

    def grad_fn(m, params, x, y):
        loss = loss_fn(m, x, y)
        return loss.detach(), _scaled_grads(loss, params, scale)

    def step(state: ZooState, x, y, aug=None):
        if augment_pad is not None:
            if aug is None:
                raise ValueError("this step was built with augmentation; "
                                 "call it as step(state, x, y, aug)")
            x = aug_lib.crop_flip(x, *aug, pad=augment_pad)
        m = state.model
        m.train()
        params = [p for _, p in m.named_parameters()]
        if accum_steps == 1:
            loss, grads = grad_fn(m, params, x, y)
        else:
            if x.shape[0] % accum_steps:
                raise ValueError(
                    f"batch size {x.shape[0]} must be a multiple of "
                    f"accum_steps {accum_steps} (no silent sample dropping)")
            mb = x.shape[0] // accum_steps
            loss, grads = grad_fn(m, params, x[:mb], y[:mb])
            for i in range(1, accum_steps):
                sl = slice(i * mb, (i + 1) * mb)
                li, gi = grad_fn(m, params, x[sl], y[sl])
                torch._foreach_add_(grads, list(gi))
                loss = loss + li
            torch._foreach_div_(grads, float(accum_steps))
            loss = loss / accum_steps
        with torch.no_grad():
            state.optimizer.apply(state, grads)
        return loss

    return step


def gspmd_rows(mesh: Mesh2D, x, y, aug, augment_pad: Optional[int], sl: slice):
    """This rank's rows of microbatch ``sl`` of the global batch ``x``,
    ``y``: its data row's block, cropped and flipped (``augment_pad`` set)
    with the same block of the global batch's draws ``aug``."""
    bx, by = mesh.shard_rows(x[sl]), mesh.shard_rows(y[sl])
    if augment_pad is not None:
        bx = aug_lib.crop_flip(bx, mesh.shard_rows(aug[0][sl]),
                               mesh.shard_rows(aug[1][sl]), pad=augment_pad)
    return bx, by


def _make_gspmd_step(model: nn.Module, optimizer: SGD, accum_steps: int,
                     augment_pad: Optional[int], fused: Optional[FusedStepConfig],
                     mesh: Mesh2D, model_axis: bool) -> Callable:
    """JAX's GSPMD step (zoo.py:353-393) on this rank of ``mesh``: the
    single-device step on the global batch ``x``, ``y``.

    Microbatch i is rows ``[i·mb, (i+1)·mb)`` of the global batch, and this
    rank takes its data row's block of it (with the same block of the
    augmentation draws ``aug``). Its loss is the microbatch mean over this
    rank's rows × rows/mb, so that the losses of the data ranks sum to the
    global mean; BatchNorm's statistics are the global microbatch's. After
    the last backward the gradients, summed over microbatches, are summed
    over the data axis in buckets and divided by ``accum_steps``, the
    losses likewise; every rank then updates its own shards and their
    momentum. Over the model axis the activations' collectives run inside
    the forward and backward (nn/core.py), so the gradient of each shard is
    already whole."""
    loss_fn = _build_loss_fn(model, fused)
    scale = _static_scale(fused)
    split_model = model_axis and mesh.model.size > 1

    def step(state: ZooState, x, y, aug=None):
        plan = state.plan
        if plan is None or plan.mesh != mesh or (plan.model is not None) != split_model:
            raise ValueError(
                "the GSPMD step takes the state that init_state(model, "
                "optimizer, mesh=..., model_axis=...) built for the same mesh "
                "and model_axis")
        if augment_pad is not None and aug is None:
            raise ValueError("this step was built with augmentation; "
                             "call it as step(state, x, y, aug)")
        if x.shape[0] % accum_steps:
            raise ValueError(
                f"batch size {x.shape[0]} must be a multiple of "
                f"accum_steps {accum_steps} (no silent sample dropping)")
        mb = x.shape[0] // accum_steps
        m = state.model
        m.train()
        params = [p for _, p in m.named_parameters()]
        lsum = torch.zeros((), dtype=torch.float32, device=x.device)
        gsum = None
        for i in range(accum_steps):
            bx, by = gspmd_rows(mesh, x, y, aug, augment_pad,
                                slice(i * mb, (i + 1) * mb))
            loss = loss_fn(m, bx, by) * (bx.shape[0] / mb)
            grads = _scaled_grads(loss, params, scale)
            lsum = lsum + loss.detach()
            if gsum is None:
                gsum = grads
            else:
                with torch.no_grad():
                    torch._foreach_add_(gsum, grads)
        with torch.no_grad():
            grads = collectives.all_reduce_buckets(gsum, mesh.data)
            if accum_steps > 1:
                grads = torch._foreach_div(grads, float(accum_steps))
            loss = collectives.all_reduce_sum(lsum, mesh.data) / accum_steps
            state.optimizer.apply(state, grads)
        return loss

    return step


def _microbatch(x: torch.Tensor, accum_steps: int) -> int:
    if x.shape[0] % accum_steps:
        raise ValueError(
            f"per-device batch {x.shape[0]} must be a multiple of "
            f"accum_steps {accum_steps} (no silent sample dropping)")
    return x.shape[0] // accum_steps


def _rank_batch(mesh: DataMesh, x, y, aug, augment_pad):
    """This rank's rows of the global batch, augmented with ``aug``."""
    x, y = mesh.shard_rows(x), mesh.shard_rows(y)
    if augment_pad is not None:
        if aug is None:
            raise ValueError("this step was built with augmentation; "
                             "call it as step(state, x, y, aug)")
        x = aug_lib.crop_flip(x, *aug, pad=augment_pad)
    return x, y


def _copy_into(dsts: List[torch.Tensor], srcs: Sequence[torch.Tensor]) -> None:
    """Copy each source into its destination, in place: one multi-tensor
    launch rather than one copy per leaf (a model may have no buffers)."""
    if dsts:
        torch._foreach_copy_(dsts, list(srcs))


def _mean_loss(lsum: torch.Tensor, accum_steps: int, mesh: DataMesh) -> torch.Tensor:
    """JAX's ``pmean(lsum / accum_steps)``."""
    loss = lsum / accum_steps
    return collectives.all_reduce_sum(loss, mesh) / mesh.world


def _make_comm_step(model: nn.Module, optimizer: SGD, accum_steps: int,
                    augment_pad: Optional[int], fused: Optional[FusedStepConfig],
                    mesh: DataMesh, comm: CommConfig) -> Callable:
    """JAX's explicit-collective data-parallel step (zoo.py:398-604) on
    this rank: the microbatch loop over the rank's rows, then the gradient
    sum over ranks — psum, or the ring per bucket; with the ring,
    ``comm.overlap`` and ``accum_steps > 1`` each microbatch's buckets are
    reduce-scattered as soon as its grads are final and the shards summed,
    with one all-gather at the end. psum and ring run the same body, so
    comparing them isolates the collective.

    BatchNorm normalises over the rank's microbatch (per-shard statistics,
    not SyncBN); the running statistics and the loss are averaged over
    ranks; the grads are divided by ``accum_steps · n``; then the
    optimizer runs on every rank alike.

    On a ``HierMesh`` (JAX's zoo.py:433-461) the batch shards over both
    axes, "hierarchical" runs each bucket through the two-level ring
    (the overlap schedule too), "psum" reduces over both axes, and the
    flat "ring" is refused."""
    hier = isinstance(mesh, HierMesh)
    if comm.impl == "hierarchical" and not hier:
        raise ValueError(
            "comm.impl='hierarchical' needs a (host, device) mesh — build "
            "it with mesh.make_hier_mesh (comm.hosts / PCNN_COMM_HOSTS "
            "emulates the host axis inside one process)")
    if comm.impl == "ring" and hier:
        raise ValueError(
            "comm.impl='ring' is the flat single-axis ring; on a "
            "(host, device) mesh use impl='hierarchical' (or 'psum')")
    if comm.impl not in ("psum", "ring", "hierarchical"):
        raise ValueError(f"unknown comm impl {comm.impl!r}")
    n = mesh.world
    axis, host = _ring_axes(mesh)
    wire = collectives.wire_dtype_arg(comm)
    overlap = comm.impl != "psum" and comm.overlap and accum_steps > 1
    loss_fn = _build_loss_fn(model, fused)
    scale = _static_scale(fused)
    names, params = zip(*jax_ordered_params(model))
    pos = {name: i for i, name in enumerate(names)}
    module_order = [pos[name] for name, _ in model.named_parameters()]
    plan = collectives.plan_buckets(list(params), comm.bucket_bytes, shards=n)

    def step(state: ZooState, x, y, aug=None):
        x, y = _rank_batch(mesh, x, y, aug, augment_pad)
        m = state.model
        m.train()
        mb = _microbatch(x, accum_steps)
        lsum = torch.zeros((), dtype=torch.float32, device=x.device)
        gsum = shard_acc = None
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            loss = loss_fn(m, x[sl], y[sl])
            grads = _scaled_grads(loss, params, scale)
            lsum = lsum + loss.detach()
            with torch.no_grad():
                if overlap:
                    shards = collectives.reduce_scatter_buckets(
                        collectives.flatten_buckets(grads, plan), axis, wire,
                        host=host)
                    shard_acc = shards if shard_acc is None else [
                        a + b for a, b in zip(shard_acc, shards)]
                elif gsum is None:
                    gsum = grads
                else:
                    torch._foreach_add_(gsum, grads)
        with torch.no_grad():
            if overlap:
                grads = collectives.unflatten_buckets(
                    collectives.all_gather_buckets(shard_acc, axis, wire,
                                                   host=host), plan)
            else:
                grads = collectives.tree_all_reduce(gsum, axis, comm, host=host)
            # Each microbatch's grads are a mean over the rank's rows; the
            # collective summed over n ranks.
            grads = torch._foreach_div(list(grads), float(accum_steps * n))
            loss = _mean_loss(lsum, accum_steps, mesh)
            bufs = [b for _, b in m.named_buffers()]
            _copy_into(bufs, collectives.tree_mean(bufs, mesh))
            state.optimizer.apply(state, [grads[i] for i in module_order])
        return loss

    return step


def make_fused_train_step(model: nn.Module, *, lr: float, momentum: float,
                          accum_steps: int, mesh: DataMesh,
                          augment_pad: Optional[int], comm: CommConfig,
                          fused: FusedStepConfig) -> Callable:
    """Update-on-arrival (JAX's ``make_fused_train_step``, zoo.py:607-805):
    step(state, x, y, aug=None) → loss, ``state`` from ``init_fused_state``.

    The ring overlap schedule of ``_make_comm_step`` carried past the
    gradient: when the last microbatch's reduce-scatter lands, this rank
    holds the summed gradient shard of every bucket, and updates the
    parameter and momentum shards it owns with ONE fused SGD-momentum
    launch over all buckets (ops/sgd_update.py, its scalar
    ``1/(scale·accum·n)`` computed on the device). The updated parameter shards are all-gathered,
    always in f32 whatever ``comm.wire_dtype`` (the masters stay exact).
    Every rank checks its gradient shards for non-finite values and one
    all-reduce MIN agrees: on overflow every rank keeps its params,
    momentum and BN statistics bit-identical (``torch.where``, no host
    sync) and counts the skip. With bf16 activations the scale is dynamic
    (JAX's zoo.py:750-757, on the device): an overflow backs it off by
    ``fused.backoff`` (clamped at 1) and zeroes ``good_steps``; after
    ``fused.growth_interval`` clean steps in a row it doubles and
    ``good_steps`` restarts. Constant-LR SGD with momentum only: ``lr`` and
    ``momentum`` are the kernel's scalars."""
    if comm is None or comm.impl != "ring":
        raise ValueError(
            "update-on-arrival requires comm.impl='ring' (the bucketed "
            "reduce-scatter is what produces the per-rank shards)")
    n = mesh.world
    wire = collectives.wire_dtype_arg(comm)
    loss_fn = _build_loss_fn(model, fused)
    dynamic = fused.act_dtype == "bfloat16"
    params = [p for _, p in jax_ordered_params(model)]
    plan = collectives.plan_buckets(params, comm.bucket_bytes, shards=n)
    # The BN running statistics, one buffer per dtype.
    buf_plan = collectives.plan_buckets([b for _, b in model.named_buffers()],
                                        sys.maxsize)

    def step(state: ZooState, x, y, aug=None):
        x, y = _rank_batch(mesh, x, y, aug, augment_pad)
        m = state.model
        m.train()
        opt = state.fused
        scale = opt.scale
        bufs = [b for _, b in m.named_buffers()]
        # The BN state before the step, packed (one copy per dtype), for
        # the skip.
        old_bufs = collectives.flatten_buckets(bufs, buf_plan)
        mb = _microbatch(x, accum_steps)
        lsum = torch.zeros((), dtype=torch.float32, device=x.device)
        shard_acc = None
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            loss = loss_fn(m, x[sl], y[sl])
            grads = list(torch.autograd.grad(loss * scale, params))
            lsum = lsum + loss.detach()  # the unscaled loss, for reporting
            with torch.no_grad():
                shards = collectives.reduce_scatter_buckets(
                    collectives.flatten_buckets(grads, plan), mesh, wire)
                shard_acc = shards if shard_acc is None else [
                    a + b for a, b in zip(shard_acc, shards)]
        with torch.no_grad():
            # Every rank must take the same branch, or params diverge.
            finite = torch.stack([torch.isfinite(s).all() for s in shard_acc]).all()
            ok_i = finite.to(torch.int32)
            dist.all_reduce(ok_i, op=dist.ReduceOp.MIN)
            ok = ok_i > 0
            gscale = 1.0 / (scale * (accum_steps * n))
            pshards = [pb.view(n, -1)[mesh.rank]
                       for pb in collectives.flatten_buckets(params, plan)]
            mshards = [mom[0] for mom in opt.mom]
            p_news, m_news = sgd_update.fused_sgd_momentum_buckets(
                pshards, mshards, shard_acc, lr=lr, momentum=momentum, scale=gscale)
            new_pb, new_mom = [], []
            for psh, msh, p_new, m_new in zip(pshards, mshards, p_news, m_news):
                p_new = torch.where(ok, p_new, psh)
                new_mom.append(torch.where(ok, m_new, msh)[None])
                new_pb.append(collectives.ring_all_gather(p_new, mesh, None))
            _copy_into(params, collectives.unflatten_buckets(new_pb, plan))
            new_bufs = [collectives.all_reduce_sum(b, mesh) / n
                        for b in collectives.flatten_buckets(bufs, buf_plan)]
            _copy_into(bufs, collectives.unflatten_buckets(
                [torch.where(ok, new, old) for new, old in zip(new_bufs, old_bufs)],
                buf_plan))
            loss = _mean_loss(lsum, accum_steps, mesh)
            if dynamic:
                new_scale = torch.where(ok, scale, torch.clamp_min(scale * fused.backoff, 1.0))
                good = torch.where(ok, opt.good_steps + 1, torch.zeros_like(opt.good_steps))
                grow = good >= fused.growth_interval
                opt.scale = torch.where(grow, new_scale * 2.0, new_scale)
                opt.good_steps = torch.where(grow, torch.zeros_like(good), good)
            opt.mom = new_mom
            opt.skipped = opt.skipped + (1 - ok_i)
        return loss

    return step


def make_zero3_train_step(model: nn.Module, *, lr: float, momentum: float,
                          accum_steps: int, mesh: Union[DataMesh, HierMesh],
                          augment_pad: Optional[int], comm: CommConfig,
                          fused: FusedStepConfig,
                          plan: collectives.BucketPlan) -> Callable:
    """ZeRO-3 (JAX's ``make_zero3_train_step``, zoo.py:918-1128):
    step(state, x, y, aug=None) → loss, ``state`` from ``init_zero3_state``
    (or laid out by ``zero3_from_view``) for ``mesh`` and ``plan``.

    The head all-gathers every bucket from the ranks' resident rows,
    always in f32 (the master weights; ``comm.wire_dtype`` compresses
    gradients only), over the flat ring (a ``DataMesh``, "ring") or the
    two-level ring (a ``HierMesh``, "hierarchical"), into the module's
    parameters. The microbatch loop reduce-scatters each microbatch's
    gradient buckets and sums the shards. One all-reduce MIN agrees on
    finiteness; then ONE fused SGD-momentum launch over all buckets
    (ops/sgd_update.py) updates this rank's parameter and momentum rows,
    which are the next step's resident state: no trailing all-gather, and
    the module's parameter storage is released. On overflow every rank
    keeps its rows, momentum and BN statistics bit for bit and counts the
    skip; the BN statistics and the loss are averaged over the world; with
    bf16 the dynamic scale moves as in ``make_fused_train_step``."""
    if comm is None or comm.impl not in ("ring", "hierarchical"):
        raise ValueError(
            "ZeRO-3 requires the explicit bucketed collectives — "
            "comm.impl='ring' or 'hierarchical'")
    hier = isinstance(mesh, HierMesh)
    if comm.impl == "hierarchical" and not hier:
        raise ValueError(
            "comm.impl='hierarchical' needs a (host, device) mesh — build "
            "it with mesh.make_hier_mesh")
    if comm.impl == "ring" and hier:
        raise ValueError(
            "comm.impl='ring' is the flat single-axis ring; on a "
            "(host, device) mesh use impl='hierarchical'")
    n_total = mesh.world
    if plan.shards != n_total:
        raise ValueError(
            f"bucket plan was laid out for {plan.shards} shards but the "
            f"mesh has {n_total} batch-parallel devices — rebuild with "
            "init_zero3_state/zero3_from_view for this mesh")
    axis, host = _ring_axes(mesh)
    wire = collectives.wire_dtype_arg(comm)
    loss_fn = _build_loss_fn(model, fused)
    dynamic = fused.act_dtype == "bfloat16"
    params = [p for _, p in jax_ordered_params(model)]
    buf_plan = collectives.plan_buckets([b for _, b in model.named_buffers()],
                                        sys.maxsize)

    def step(state: ZooState, x, y, aug=None):
        if state.zero3 is None or state.zero3.plan != plan:
            raise ValueError(
                "the ZeRO-3 step takes the state that init_zero3_state (or "
                "zero3_from_view) laid out for its plan")
        x, y = _rank_batch(mesh, x, y, aug, augment_pad)
        m = state.model
        m.train()
        opt, z3 = state.fused, state.zero3
        scale = opt.scale
        bufs = [b for _, b in m.named_buffers()]
        old_bufs = collectives.flatten_buckets(bufs, buf_plan)
        _gather_params(params, z3, mesh)
        mb = _microbatch(x, accum_steps)
        lsum = torch.zeros((), dtype=torch.float32, device=x.device)
        shard_acc = None
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            loss = loss_fn(m, x[sl], y[sl])
            grads = list(torch.autograd.grad(loss * scale, params))
            lsum = lsum + loss.detach()  # the unscaled loss, for reporting
            with torch.no_grad():
                shards = collectives.reduce_scatter_buckets(
                    collectives.flatten_buckets(grads, plan), axis, wire, host=host)
                shard_acc = shards if shard_acc is None else [
                    a + b for a, b in zip(shard_acc, shards)]
            del grads
        with torch.no_grad():
            _release_params(params)
            finite = torch.stack([torch.isfinite(s).all() for s in shard_acc]).all()
            ok_i = finite.to(torch.int32)
            if n_total > 1:
                dist.all_reduce(ok_i, op=dist.ReduceOp.MIN, group=mesh.group)
            ok = ok_i > 0
            gscale = 1.0 / (scale * (accum_steps * n_total))
            pshards = [r[0] for r in z3.rows]
            mshards = [mom[0] for mom in opt.mom]
            p_news, m_news = sgd_update.fused_sgd_momentum_buckets(
                pshards, mshards, shard_acc, lr=lr, momentum=momentum, scale=gscale)
            z3.rows = [torch.where(ok, p_new, psh)[None]
                       for psh, p_new in zip(pshards, p_news)]
            opt.mom = [torch.where(ok, m_new, msh)[None]
                       for msh, m_new in zip(mshards, m_news)]
            new_bufs = [collectives.all_reduce_sum(b, mesh) / n_total
                        for b in collectives.flatten_buckets(bufs, buf_plan)]
            _copy_into(bufs, collectives.unflatten_buckets(
                [torch.where(ok, new, old) for new, old in zip(new_bufs, old_bufs)],
                buf_plan))
            loss = _mean_loss(lsum, accum_steps, mesh)
            if dynamic:
                new_scale = torch.where(ok, scale, torch.clamp_min(scale * fused.backoff, 1.0))
                good = torch.where(ok, opt.good_steps + 1, torch.zeros_like(opt.good_steps))
                grow = good >= fused.growth_interval
                opt.scale = torch.where(grow, new_scale * 2.0, new_scale)
                opt.good_steps = torch.where(grow, torch.zeros_like(good), good)
            opt.skipped = opt.skipped + (1 - ok_i)
        return loss

    return step


def evaluate(model: nn.Module, images: torch.Tensor, labels: torch.Tensor,
             batch_size: int = 256, data=None) -> float:
    """Accuracy (%) of ``model`` in eval mode over an on-device split, in
    batches; one readback at the end. The ResNets' eval forward on the
    "cuda" backend is one fused kernel launch per conv. With ``data`` (a
    mesh axis) each of its ranks takes its contiguous share of the rows and
    the correct counts are summed over the axis (every rank calls it)."""
    n = images.shape[0]
    if data is not None and data.size > 1:
        lo, hi = n * data.index // data.size, n * (data.index + 1) // data.size
        images, labels = images[lo:hi], labels[lo:hi]
    was_training = model.training
    model.eval()
    correct = torch.zeros((), dtype=torch.int64, device=images.device)
    with torch.no_grad():
        for i in range(0, images.shape[0], batch_size):
            logits = model(images[i:i + batch_size])
            correct += (logits.argmax(dim=-1) == labels[i:i + batch_size]).sum()
    model.train(was_training)
    if data is not None:
        collectives.all_reduce_sum(correct, data)
    return int(correct) / n * 100.0


# ---------------------------------------------------------------------------
# Epoch driver
# ---------------------------------------------------------------------------


def _aug_generator(seed: int, epoch: int, rank: int = 0) -> torch.Generator:
    """The epoch's augmentation stream; each rank of a mesh draws its own
    (JAX folds the device index into the key, zoo.py:672-673)."""
    return torch.Generator().manual_seed(
        (seed ^ 0x5EED) * 1_000_003 + epoch + (rank << 32))


def _native_epoch_batches(np_images, np_labels, batch_size, steps, seed):
    """One epoch of host batches from the C++ prefetch ring (views into its
    slots, which ``pipeline.device_batches`` copies out before it asks for
    the next), or from its bit-identical NumPy twin where the ring cannot
    be built (JAX's ``_native_epoch_batches``)."""
    if not native.available():
        yield from itertools.islice(pipeline.native_semantics_batches(
            pipeline.Dataset(np_images, np_labels), batch_size, shuffle=True,
            seed=seed), steps)
        return
    with native.Batcher(np_images, np_labels, batch_size, seed=seed,
                        shuffle=True, copy=False) as ring:
        yield from itertools.islice(ring, steps)


def _epoch_batches(loader, images, labels, np_data, batch, steps, seed, epoch,
                   dev):
    """(x, y) pairs of one epoch on ``dev``."""
    if loader == "native":
        yield from pipeline.device_batches(
            _native_epoch_batches(*np_data, batch, steps, seed + epoch + 1),
            dev, torch.int64)
        return
    perm = torch.randperm(images.shape[0],
                          generator=torch.Generator().manual_seed(seed + epoch))
    perm = perm.to(dev)  # one copy per epoch, not one per step
    for i in range(steps):
        j = perm[i * batch:(i + 1) * batch]
        yield images[j], labels[j]


def train(
    model: nn.Module,
    images: np.ndarray,
    labels: np.ndarray,
    *,
    epochs: int = 1,
    batch_size: int = 128,
    lr: float = 0.1,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    augment: bool = False,
    augment_pad: int = 4,
    accum_steps: int = 1,
    mesh: Optional[Union[DataMesh, Mesh2D, PipelineMesh, HierMesh]] = None,
    model_axis: bool = False,
    comm: Optional[CommConfig] = None,
    fused: Optional[FusedStepConfig] = None,
    pipeline=None,
    seed: int = 0,
    verbose: bool = True,
    eval_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    eval_batch_size: int = 256,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    metrics=None,
    loader: str = "device",
    resilience: Optional[ResilienceConfig] = None,
    chaos=None,
    obs=None,
    elastic: Optional[ElasticConfig] = None,
    elastic_world: Optional[int] = None,
    plan=None,
    replan: bool = False,
    device: DeviceLike = None,
) -> Tuple[ZooState, List[float]]:
    """Epoch driver for a zoo model on an in-memory NHWC dataset (JAX's
    ``zoo.train``). ``model`` carries the initial weights and
    is trained in place on ``device`` (None = the GPU; "cpu" runs the
    kernels' plain versions).

    Per epoch: the shuffled steps (``len(images) // batch_size``, drop
    tail), the mean loss read back once, the sentinel's verdict
    (``resilience.policy``: "raise", "skip" the epoch, or "rollback" and
    retry it at the same LR), eval accuracy on ``eval_data``, a metrics
    record, the checkpoint ``ckpt_<epoch>.npz`` (full state) and the line
    ``epoch N: loss L, acc A% (S s)``. ``resume`` restarts from the newest
    checkpoint in ``checkpoint_dir`` (one the JAX trainer wrote included);
    a preemption signal stops at the next epoch boundary, after the
    checkpoint. Returns (state, per-epoch mean losses).

    On a mesh every rank of a world that parallel/distributed.py started
    calls ``train`` with its ``mesh`` (then ``device`` is the mesh's);
    ``batch_size`` is the global batch. Without ``comm`` it is JAX's GSPMD
    path (``_make_gspmd_step``; ``model_axis`` splits the filters over the
    ``Mesh2D``'s model axis): augmentation draws for the global batch,
    every rank evaluates its share of the eval rows with the whole model,
    a checkpoint holds every leaf whole. With a ``comm`` (``CommConfig``;
    psum or ring, JAX's ``_make_comm_step``) each rank trains on its rows
    of a data-only mesh. ``fused.update`` with the ring is update-on-arrival
    (``make_fused_train_step``: constant-LR SGD with momentum, no weight
    decay); without a mesh and the ring it is dropped with JAX's fallback
    line. Rank 0 alone prints, records metrics and writes checkpoints (on
    the explicit path it alone evaluates, over the whole eval set with the
    replicated params); a fused state's momentum rows, or a split leaf's
    blocks, are gathered for it first. The sentinel's verdict is agreed
    over the world. Under update-on-arrival the sentinel treats a skipped
    overflow as handled (``Sentinel.check_scaled``).

    On a ``HierMesh`` (with a ``comm``: "hierarchical" or "psum") each
    rank trains on its block of the global batch over both axes.
    ``fused.zero=3`` with the ring or the hierarchical ring is ZeRO-3
    (``make_zero3_train_step``): the parameters live as each rank's bucket
    rows; every rank takes part in evaluation's and the checkpoint's
    gathers (``zero3_params``, ``zero3_full_view``); the checkpoint is
    JAX's sharded file (``checkpoint.save_sharded``) and resume lays its
    full view out for this run's mesh (``restore_sharded``,
    ``zero3_from_view``). ZeRO-2 on a hierarchical mesh, and ZeRO-3 beside
    the pipeline, raise JAX's errors.

    ``pipeline`` (a ``config.PipelineConfig``; ``mesh`` this rank's
    ``PipelineMesh``) is JAX's 1F1B pipeline (``make_pipeline_step``):
    ``accum_steps`` is the microbatch count, the data axis reduces over
    ``comm`` (the ring by default), ``fused.update`` with the ring is the
    ZeRO-2 tail, and any other fused config is dropped (the schedule
    computes its own loss; bf16 stage compute is ``pipeline.act_dtype``).
    It takes no model axis and no augmentation. Parameters stay
    replicated on every rank; rank 0 (stage 0's first data rank)
    evaluates and writes the checkpoints. ``chaos`` ``slow-stage@STEP:MS``
    stalls it once at the step-STEP dispatch (journaled
    ``chaos_slow_stage``).

    ``elastic`` (a ``config.ElasticConfig``; needs ZeRO-3) is JAX's
    in-flight re-mesh (resilience/elastic.py): before each optimizer step
    every rank polls the ``ElasticController`` (rank 0's preempt resize
    request, then chaos ``resize@STEP:±K``, then the schedule); on a
    trigger the state is resharded over the first N ranks of ``mesh``
    (the spawned world, the reachable ranks) and the ZeRO-3 step rebuilt
    at ``lr_for(lr)``. ``elastic_world`` ranks train at the start
    (default all); a rank outside the world holds no state, walks the
    same batches and rejoins when it grows. ``scaling="per-device"``
    rescales the global batch at epoch boundaries. The augmentation of a
    step draws from a stream seeded by the optimizer step and the rank.

    ``plan`` (a ``plan.ExecutionPlan``, JAX's): the execution contract
    the run trains under. Its fingerprint is stamped into every
    checkpoint, and resume refuses a file stamped under another plan
    (``PlanMismatchError``) unless ``replan`` (the CLI's ``--replan``);
    the elastic run's sharded resume always waives it (it reshards from
    the world-size-independent view anyway). Under elastic training the
    starting mesh and every resize are plan derivations
    (``plan.derive_resized``), and the derived plan with the LR keys a
    step cache: a resize back to a topology already seen reuses the step
    built for it (journaled ``plan_step_cache`` with ``hit``, ``plan``
    and ``world``).

    ``chaos`` (a ``ChaosMonkey``): ``nan@STEP`` poisons the state after
    optimizer step STEP (every floating leaf, as JAX's ``after_step``
    does to its state tree; journaled ``chaos``), ``kill@``/``kill9@``
    signal the process after an epoch, ``resize@`` feeds ``elastic``.
    ``resilience.check_every_steps`` adds the sentinel every N steps (a
    host sync each, agreed over the world). ``obs`` (an ``obs.Obs``, rank
    0's; None is the no-op bundle): JAX's ``zoo.data``, ``zoo.dispatch``
    and ``zoo.readback`` spans and its ``comm_plan``, ``comm_bucket``,
    ``loss_scale``, ``step_loss``, ``verdict``, ``rollback``, ``epoch``,
    ``checkpoint``, ``preempt`` and resize events, and a ``zoo`` collector
    (epochs, optimizer steps, resizes) on its metrics registry.
    """
    if loader not in LOADERS:
        raise ValueError(f"unknown loader {loader!r}")
    # The resolved ExecutionPlan travels under a distinct name: z3_plan
    # below is the ZeRO-3 bucket plan, a different object.
    exec_plan = plan
    plan_fp = exec_plan.fingerprint() if exec_plan is not None else None
    pipe = pipeline is not None
    if pipe:
        if not isinstance(mesh, PipelineMesh):
            raise ValueError(
                "pipeline training requires a (stage, data) mesh — "
                "build it with mesh.make_pipeline_mesh(pipeline.stages)")
        if model_axis:
            raise ValueError(
                "pipeline partitions layers over the stage axis; "
                "model_axis filter sharding stays on the GSPMD path "
                "(drop one of the two)")
        if augment:
            raise ValueError(
                "pipeline training does not thread augmentation keys "
                "through the 1F1B schedule yet — drop --augment")
    if isinstance(mesh, HierMesh) and comm is None:
        raise ValueError("a (host, data) mesh runs the explicit collectives: "
                         "pass comm (hierarchical or psum)")
    gspmd = mesh is not None and comm is None and not pipe
    if model_axis and not gspmd:
        raise ValueError("model_axis filter sharding is the GSPMD path: it "
                         "needs a mesh and no comm")
    if mesh is not None:
        device = mesh.device
    if gspmd:
        mesh = as_mesh_2d(mesh)
    dev = resolve_device(device)
    rank = mesh.rank if mesh is not None else 0
    world = mesh.world if mesh is not None else 1
    # An elastic run starts on the first ``elastic_world`` ranks.
    start_world = (elastic_world if elastic is not None and elastic.enabled
                   and elastic_world else world)
    n_data = mesh.data.size if gspmd or pipe else start_world
    lead = rank == 0
    verbose = verbose and lead
    steps = images.shape[0] // batch_size
    if steps == 0:
        raise ValueError(f"dataset of {images.shape[0]} samples yields zero "
                         f"batches of {batch_size}")
    if batch_size % (n_data * accum_steps if gspmd else n_data):
        raise ValueError(f"global batch {batch_size} does not divide over "
                         f"{n_data} data ranks"
                         + (f" × {accum_steps} microbatches" if gspmd else ""))
    if fused is not None and fused.update:
        if mesh is None or comm is None or comm.impl not in ("ring", "hierarchical"):
            if verbose:
                print("fused-step: update-on-arrival needs mesh + "
                      "comm.impl='ring'/'hierarchical'; falling back to "
                      "fused tail only")
            # zero=3 requires update=True: the fallback drops both.
            fused = dataclasses.replace(fused, update=False, zero=2)
        elif comm.impl == "hierarchical" and fused.zero != 3:
            raise ValueError(
                "ZeRO-2 update-on-arrival rides the flat ring; on a "
                "hierarchical mesh use fused.zero=3 (whose resident "
                "shards follow the two-level ring), or comm.impl='ring' "
                "on a flat mesh")
        elif lr_schedule != "constant" or warmup_steps or weight_decay:
            raise ValueError(
                "fused.update supports constant-LR SGD(+momentum) only — "
                "lr schedules/warmup/weight decay need the optax path "
                "(set update=False)")
    use_fused_update = fused is not None and fused.update
    use_zero3 = use_fused_update and fused.zero == 3
    if pipe and use_zero3:
        raise ValueError(
            "pipeline composes with ZeRO-2 only: ZeRO-3's just-in-"
            "time head gathers contradict per-stage param residency "
            "(docs/pipeline.md)")
    use_elastic = elastic is not None and elastic.enabled
    if use_elastic and not use_zero3:
        raise ValueError(
            "elastic training requires the ZeRO-3 step (fused.zero=3 "
            "with mesh + ring/hierarchical comm) — its world-size-"
            "independent full view is what makes in-flight resharding "
            "possible; enable it or drop --elastic")
    if pipe and fused is not None and not use_fused_update:
        # The fused tail and bf16 cast ride the flat step's loss, which
        # the per-stage schedule replaces (bf16 stage compute is
        # pipeline.act_dtype instead).
        fused = None
    optimizer = make_optimizer(
        lr, momentum, weight_decay, schedule=lr_schedule,
        warmup_steps=warmup_steps,
        total_steps=steps * epochs if lr_schedule == "cosine" else None,
    )
    model.to(dev)
    obs = obs if obs is not None else obs_lib.NOOP
    pad = augment_pad if augment else None
    # Elastic: the ranks of ``mesh`` are the reachable ones; the run trains
    # on the first ``start_world`` of them (``active``, None on the rest),
    # meshes cached per topology from the spawned one on.
    active = mesh
    mesh_cache = start_plan = None
    if use_elastic:
        hosts0 = mesh.host.size if isinstance(mesh, HierMesh) else 1
        mesh_cache = {(world, hosts0): mesh}
        start_plan = plan_lib.derive_resized(
            exec_plan or plan_lib.ExecutionPlan(), start_world, n_hosts=hosts0)
        active = start_plan.make_mesh(rank, world, dev, cache=mesh_cache)
    z3_plan = None
    if pipe:
        from parallel_cnn_tpu_torch.train.pipeline_schedule import make_pipeline_step

        if use_fused_update:
            state, _ = init_fused_state(model, optimizer, mesh=mesh.data_mesh(),
                                        fused=fused, bucket_bytes=comm.bucket_bytes)
        else:
            state = init_state(model, optimizer)
        step = make_pipeline_step(
            model, None if use_fused_update else optimizer,
            accum_steps=accum_steps, mesh=mesh, pipeline=pipeline,
            in_shape=tuple(images.shape[1:]), comm=comm,
            fused=fused if use_fused_update else None, lr=lr, momentum=momentum)
    elif use_zero3 and active is None:
        # A rank outside the elastic world: the module alone, no rows.
        state, step = ZooState(model, optimizer, {}), None
    elif use_zero3:
        state, z3_plan = init_zero3_state(model, optimizer, mesh=active, fused=fused,
                                          bucket_bytes=comm.bucket_bytes)
        step = make_zero3_train_step(
            model, lr=lr, momentum=momentum, accum_steps=accum_steps,
            mesh=active, augment_pad=pad, comm=comm, fused=fused, plan=z3_plan)
    elif use_fused_update:
        state, _ = init_fused_state(model, optimizer, mesh=mesh, fused=fused,
                                    bucket_bytes=comm.bucket_bytes)
        step = make_fused_train_step(
            model, lr=lr, momentum=momentum, accum_steps=accum_steps,
            mesh=mesh, augment_pad=pad, comm=comm, fused=fused)
    else:
        state = init_state(model, optimizer, mesh=mesh if gspmd else None,
                           model_axis=model_axis)
        step = make_train_step(model, optimizer, accum_steps, pad, fused,
                               mesh=mesh, comm=comm, model_axis=model_axis)

    def live() -> bool:
        """Whether this rank holds training state (a rank outside the
        elastic world holds none)."""
        return step is not None

    if obs.enabled and comm is not None and comm.impl in ("ring", "hierarchical"):
        # The bucket schedule, once, from the planner the step uses.
        n_shards = active.world if active is not None else start_world
        _plan = collectives.plan_buckets([p for _, p in jax_ordered_params(model)],
                                         comm.bucket_bytes, shards=n_shards)
        obs.event("comm_plan", impl=comm.impl, n_buckets=_plan.n_buckets,
                  bucket_bytes=comm.bucket_bytes, shards=n_shards)
        for _bi, (_sz, _dt) in enumerate(zip(_plan.bucket_sizes, _plan.bucket_dtypes)):
            obs.event("comm_bucket", bucket=_bi, elements=_sz, dtype=_dt)

    res = resilience
    sentinel = Sentinel() if res is not None and res.policy != "off" else None
    controller = None
    if sentinel is not None and res.policy == "rollback":
        controller = RollbackController(max_rollbacks=res.max_rollbacks)
    ring = None
    if checkpoint_dir and lead:
        saver = None
        if use_zero3:
            # The ring's files carry the full view (every rank gathered it),
            # marked sharded: resume lays it out for its own mesh, and
            # restore / load_params refuse it. The world is the plan's when
            # the file is written (after an elastic resize, the new one).
            saver = lambda path, view, tstate: checkpoint.save_sharded(  # noqa: E731
                path, view, tstate, world_size=z3_plan.shards,
                bucket_bytes=comm.bucket_bytes, rank=rank,
                plan_fingerprint=plan_fp)
        elif plan_fp:
            saver = lambda path, arrays, tstate: checkpoint.save(  # noqa: E731
                path, arrays, tstate, plan_fingerprint=plan_fp)
        ring = CheckpointRing(checkpoint_dir,
                              keep=res.ring_size if res is not None else 0,
                              saver=saver)

    start_epoch = 0
    losses: List[float] = []
    accs: List[float] = []
    if checkpoint_dir and resume:
        path = checkpoint.latest(checkpoint_dir)
        if path:
            if use_zero3:
                # The elastic reshard path recomputes the layout from the
                # world-size-independent view: exempt from the plan gate.
                view, tstate, _ = checkpoint.restore_sharded(
                    path, zero3_view_like(model, dev), plan_fingerprint=plan_fp,
                    replan=replan or use_elastic)
                if live():
                    zero3_from_view(state, view)
            else:
                arrays, tstate = checkpoint.restore(
                    path, state.checkpoint_arrays(), plan_fingerprint=plan_fp,
                    replan=replan)
                state.load(arrays)
            start_epoch = tstate.epoch
            losses = list(tstate.epoch_errors)
            accs = list(tstate.extra.get("epoch_accs", []))
            if verbose:
                print(f"resumed from {path} (epoch {start_epoch})")

    ectl = None
    if use_elastic:
        from parallel_cnn_tpu_torch.resilience.elastic import ElasticController

        # Built after the ring and the resume, as JAX's: the ring is the
        # snapshot fallback, the template the state that will train.
        ectl = ElasticController(elastic, world=start_world, n_hosts=hosts0,
                                 chaos=chaos, ring=ring, obs=obs, reachable=world,
                                 device=dev, exec_plan=exec_plan)
        ectl.meshes = mesh_cache
        if live():
            ectl.register_template(zero3_full_view(state))
    # Built steps keyed by (the derived ExecutionPlan, LR), primed with the
    # starting topology's: a resize back to a world already seen reuses its
    # step. Every rank takes the same hit/miss decision (derive_resized is
    # deterministic); a rank outside the world keeps no step.
    step_cache: dict = {}
    if ectl is not None and exec_plan is not None and step is not None:
        step_cache[(start_plan, lr)] = step

    np_data = None
    if loader == "native":
        np_data = (np.ascontiguousarray(images, dtype=np.float32),
                   np.ascontiguousarray(labels, dtype=np.int32))
        d_images = d_labels = None
    else:
        d_images = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
        d_labels = torch.from_numpy(np.asarray(labels)).to(dev, torch.int64)
    ev = None
    if eval_data is not None and (lead or gspmd):
        ev = (torch.from_numpy(np.asarray(eval_data[0], np.float32)).to(dev),
              torch.from_numpy(np.asarray(eval_data[1])).to(dev, torch.int64))

    skip_seen = int(state.fused.skipped) if use_fused_update and live() else 0

    def health_check(loss_val: float):
        # Under update-on-arrival a non-finite gradient the step already
        # skipped (skip counter advanced, masters finite) is handled.
        nonlocal skip_seen
        if not live():
            return Verdict(True, "")
        params = state.zero3.rows if use_zero3 else list(state.model.parameters())
        if not use_fused_update:
            return sentinel.check(loss=loss_val, params=params)
        now = int(state.fused.skipped)
        if obs.enabled and now != skip_seen:
            obs.event("loss_scale", skipped=now, scale=float(state.fused.scale))
        verdict = sentinel.check_scaled(
            loss=loss_val, params=params, skipped_before=skip_seen,
            skipped_now=now, scale=float(state.fused.scale))
        skip_seen = now
        if verdict.healthy and verdict.reason and verbose:
            print(f"sentinel: {verdict.reason}")
        return verdict

    def agreed(verdict):
        if _agree(not verdict.healthy, mesh) and verdict.healthy:
            # A shard elsewhere diverged: this rank follows its verdict.
            return Verdict(False, "non-finite params on another rank")
        return verdict

    def commit_last_good():
        snap = state.snapshot() if live() else {}
        if controller is not None:
            controller.commit(snap)
        return snap

    last_good = commit_last_good() if sentinel is not None else None
    # The GSPMD step crops its rows of the global batch's draws, from the
    # single-device stream; the explicit path's ranks draw their own.
    aug_batch, aug_rank = (batch_size, 0) if gspmd else (batch_size // world, rank)
    n = images.shape[0]
    epoch = start_epoch
    # The optimizer step across epochs (and rollback retries): what
    # resize@STEP, schedule STEP:WORLD and slow-stage@STEP name.
    opt_steps = start_epoch * steps
    chaos_logged = False
    if obs.enabled and obs.registry is not None:
        # The run's progress, pulled when the metrics snapshot is written.
        obs.registry.attach("zoo", lambda: {
            "epochs": len(losses), "steps": opt_steps,
            "resizes": len(ectl.events) if ectl is not None else 0})
    while epoch < epochs:
        t0 = time.perf_counter()
        # The epoch's batch geometry: fixed unless the elastic
        # "per-device" policy rescales the global batch with the world
        # (at epoch boundaries only).
        if ectl is not None:
            ebatch = min(ectl.global_batch_for(batch_size), n)
            esteps = max(n // ebatch, 1)
        else:
            ebatch, esteps = batch_size, steps
        aug = None
        if augment and ectl is None:
            offsets, flips = aug_lib.draw(_aug_generator(seed, epoch, aug_rank),
                                          steps * aug_batch, augment_pad)
            aug = (offsets.to(dev).view(steps, aug_batch, 2),
                   flips.to(dev).view(steps, aug_batch))
        epoch_loss = torch.zeros((), dtype=torch.float32, device=dev)
        batch_iter = enumerate(_epoch_batches(loader, d_images, d_labels, np_data,
                                              ebatch, esteps, seed, epoch, dev))
        diverged = None
        while True:
            with obs.span("zoo.data", cat="data"):
                item = next(batch_iter, None)
            if item is None:
                break
            i, (bx, by) = item
            if ectl is not None:
                target = ectl.pending(opt_steps)
                if target is not None and ebatch % target:
                    # JAX's step refuses the batch on the new mesh
                    # (shard_map's divisibility error); every rank raises
                    # here, before the resize's collectives.
                    raise ValueError(
                        f"global batch {ebatch} does not divide over {target} "
                        "ranks (no silent sample dropping)")
                if target is not None:
                    # Step-boundary resize: the state resharded for the
                    # new world, the step rebuilt for it.
                    state, z3_plan, active, comm = ectl.resize(
                        opt_steps, target, state=state if live() else None,
                        comm=comm, model=model, optimizer=optimizer)
                    ckey = None
                    if exec_plan is not None:
                        # The controller's plan is now derive_resized's.
                        ckey = (ectl.exec_plan, ectl.lr_for(lr))
                        if obs.enabled:
                            obs.event("plan_step_cache", hit=ckey in step_cache,
                                      plan=ckey[0].fingerprint(), world=target)
                    if active is None:
                        state, step = ZooState(model, optimizer, {}), None
                    else:
                        step = step_cache.get(ckey)
                        if step is None:
                            step = make_zero3_train_step(
                                model, lr=ectl.lr_for(lr), momentum=momentum,
                                accum_steps=accum_steps, mesh=active,
                                augment_pad=pad, comm=comm, fused=fused,
                                plan=z3_plan)
                            if ckey is not None:
                                step_cache[ckey] = step
                    epoch_loss = torch.tensor(float(epoch_loss), device=dev)
                    skip_seen = int(state.fused.skipped) if live() else 0
                    if sentinel is not None:
                        # The old layout's snapshot cannot load into the new
                        # one: a rollback returns to this resize.
                        last_good = commit_last_good()
            a = None
            if aug is not None:
                a = (aug[0][i], aug[1][i])
            elif augment and live():
                o, f = aug_lib.draw(_aug_generator(seed, opt_steps, active.rank),
                                    ebatch // active.world, augment_pad)
                a = (o.to(dev), f.to(dev))
            if chaos is not None and pipe:
                stall = chaos.slow_stage_at(opt_steps)
                if stall is not None:
                    time.sleep(stall / 1000.0)
                    if obs.enabled:
                        obs.event("chaos_slow_stage", step=opt_steps, ms=stall)
            with obs.span("zoo.dispatch", cat="step"):
                if live():
                    loss = step(state, bx, by, a)
                else:
                    loss = torch.zeros((), dtype=torch.float32, device=dev)
            opt_steps += 1
            if chaos is not None:
                fired = chaos.nan_fired
                arrays, loss = chaos.after_step(state.arrays() if live() else {}, loss)
                if chaos.nan_fired and not fired and live():
                    state.load(arrays)
                if obs.enabled and chaos.nan_fired and not chaos_logged:
                    chaos_logged = True
                    obs.event("chaos", injected="nan", step=i, epoch=epoch + 1)
            epoch_loss = epoch_loss + loss
            if (sentinel is not None and res.check_every_steps
                    and (i + 1) % res.check_every_steps == 0):
                step_loss = float(loss)
                if obs.enabled:
                    obs.event("step_loss", epoch=epoch + 1, step=i, loss=step_loss)
                verdict = agreed(health_check(step_loss))
                if not verdict.healthy:
                    diverged = f"step {i} of epoch {epoch + 1}: {verdict.reason}"
                    break
        with obs.span("zoo.readback", cat="step"):
            mean_loss = float(epoch_loss) / esteps  # the epoch's one readback
        if diverged is None and sentinel is not None:
            verdict = agreed(health_check(mean_loss))
            if not verdict.healthy:
                diverged = f"epoch {epoch + 1}: {verdict.reason}"
        if diverged is not None:
            if obs.enabled:
                obs.event("verdict", healthy=False, epoch=epoch + 1,
                          reason=diverged, policy=res.policy)
            if res.policy == "raise":
                raise DivergenceError(diverged)
            if res.policy == "skip":
                if verbose:
                    print(f"sentinel: {diverged} — epoch discarded")
                if live():
                    state.load(last_good)
                epoch += 1
                continue
            # rollback: the last-good state, the same epoch again (the
            # same seed gives the same batches and augmentation).
            snap, _ = controller.rollback(reason=diverged)
            if live():
                state.load(snap)
            if obs.enabled:
                obs.event("rollback", epoch=epoch + 1, rollbacks=controller.rollbacks)
            if verbose:
                print(f"sentinel: {diverged} — rolled back "
                      f"({controller.rollbacks}/{controller.max_rollbacks})")
            continue
        if sentinel is not None:
            last_good = commit_last_good()
        losses.append(mean_loss)
        seconds = time.perf_counter() - t0
        if obs.enabled:
            obs.event("epoch", epoch=epoch + 1, loss=mean_loss, seconds=seconds)
        if eval_data is not None and live():
            with zero3_params(state):  # ZeRO-3: every rank gathers
                if ev is not None:
                    accs.append(evaluate(state.eval_model(), *ev,
                                         batch_size=eval_batch_size,
                                         data=mesh.data if gspmd else None))
        if metrics is not None and lead:
            rec = dict(event="zoo_epoch", epoch=epoch + 1, loss=losses[-1],
                       seconds=seconds)
            if ev is not None:
                rec["accuracy"] = accs[-1]
            metrics.record(**rec)
        if checkpoint_dir and live():
            arrays = state.checkpoint_arrays()
            if ring is not None:
                ring.save(epoch + 1, arrays, checkpoint.TrainState(
                    epoch=epoch + 1, epoch_errors=list(losses),
                    extra={"epoch_accs": list(accs)}))
                if obs.enabled:
                    obs.event("checkpoint", epoch=epoch + 1)
        if verbose:
            acc_txt = f", acc {accs[-1]:.2f}%" if ev is not None else ""
            print(f"epoch {epoch + 1}: loss {losses[-1]:.4f}{acc_txt} "
                  f"({seconds:.2f}s)")
        if chaos is not None:
            chaos.at_epoch(epoch + 1)
        if _agree(preempt.requested(), mesh):
            if obs.enabled:
                obs.event("preempt", epoch=epoch + 1)
            if verbose:
                print(f"preemption: stopping after epoch {epoch + 1}")
            break
        epoch += 1
    if mesh is not None and mesh.world > 1:
        dist.barrier()  # rank 0's last checkpoint is on disk for every rank
    return state, losses


def _agree(flag: bool, mesh) -> bool:
    """True on every rank when it is true on any (one stop for all)."""
    if mesh is None or mesh.world == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
