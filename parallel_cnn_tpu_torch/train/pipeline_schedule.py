"""1F1B pipeline-parallel train step over a (stage, data) mesh of ranks
(the port of ``parallel_cnn_tpu/train/pipeline_schedule.py``).

JAX traces one SPMD program over the mesh, the stage's layers chosen by
``lax.switch`` on the device's stage coordinate; the port runs one
process per rank (parallel/distributed.py), and each rank runs its own
stage (``Stage``) through the same tick table (parallel/pipeline.py): the
forward of microbatch m at stage s at tick s + 2m, its backward at tick
2S − 1 − s + 2m. Between ticks the activations go one stage on and the
cotangents one stage back, both in one ``collectives.stage_exchange``;
the hops JAX sends only to mask them out (the wrap-around and idle ones)
are left out on both ends, from the schedule both ends know.

Each stage stashes the input of each live microbatch (at most S, slot
m mod S, packed into JAX's ``(S, mb, A_buf)`` f32 buffer) and nothing
else: the forward tick runs without autograd, and the backward recomputes
the stage from its stashed input (activation remat) and takes the
gradients of its parameters and of that input. The recompute normalises
with the batch's statistics and leaves BatchNorm's running statistics as
the forward tick left them (``nn.layers.running_stats_frozen``; JAX's
recompute throws its new state away), so each microbatch updates them
once, in order, as the flat step does.

After the last tick: the gradients are summed over the stage axis (each
parameter's are nonzero on its own stage only, so the sum adds exact
zeros), reduced over the data axis by the same bucketed ring the flat
step uses (``collectives.tree_all_reduce``) and divided by M·D; the loss
(the last stage's) is summed over the stage axis and averaged over the
data axis; each BN statistic is taken from its owner stage, then
averaged over the data axis. Then the optimizer, or (``fused``, ZeRO-2,
f32 only) JAX's update-on-arrival tail: each bucket reduce-scattered
over the data axis, the rank's parameter and momentum shards through the
fused SGD-momentum kernel (B13, ops/sgd_update.py) in one launch over
the buckets, the updated shards all-gathered in f32.

Parity: the data axis shards the batch as the flat data-parallel step
does, every stage visits its microbatches in the same order, the stage
sum adds exact zeros and the data reduce is the same ring, so S ≥ 2
matches the flat ring at D ranks up to the order of its sums, and S = 1
is the flat ring step itself (``zoo.make_train_step(..., comm=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from parallel_cnn_tpu_torch.config import CommConfig
from parallel_cnn_tpu_torch.nn.layers import running_stats_frozen
from parallel_cnn_tpu_torch.ops import sgd_update
from parallel_cnn_tpu_torch.parallel import collectives
from parallel_cnn_tpu_torch.parallel import pipeline as pp
from parallel_cnn_tpu_torch.parallel.mesh import pipeline_axis_sizes
from parallel_cnn_tpu_torch.train import zoo


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """The static half of a pipelined step: where the stages start and
    end, each stage's per-sample input shape, the wire width A_buf and the
    (T, S) tick tables, for M microbatches."""

    n_stages: int
    n_micro: int
    boundaries: Tuple[int, ...]
    assign: np.ndarray          # layer -> stage
    starts: Tuple[int, ...]
    ends: Tuple[int, ...]
    stage_in: Tuple[Tuple[int, ...], ...]
    a_buf: int
    fwd_mb: np.ndarray
    fwd_valid: np.ndarray
    bwd_mb: np.ndarray
    bwd_valid: np.ndarray

    @property
    def n_ticks(self) -> int:
        return self.fwd_mb.shape[0]


def pipeline_plan(model: nn.Module, pipeline, in_shape: Sequence[int],
                  n_micro: int) -> PipelinePlan:
    """The plan of ``pipeline`` (a ``config.PipelineConfig``) over
    ``model``'s layers: its manual split, or the flops-balanced one."""
    n_stages = int(pipeline.stages)
    in_shape = tuple(in_shape)
    boundaries = pp.split_layers(model, n_stages, in_shape, microbatch=1,
                                 boundaries=pipeline.boundaries())
    bshapes = pp.boundary_shapes(model, in_shape, boundaries, 1)
    return PipelinePlan(
        n_stages=n_stages, n_micro=int(n_micro), boundaries=boundaries,
        assign=pp.stage_assignment(len(model), boundaries),
        starts=(0,) + tuple(boundaries), ends=tuple(boundaries) + (len(model),),
        stage_in=(in_shape,) + tuple(sh[1:] for sh in bshapes),
        a_buf=pp.wire_numel(model, in_shape, boundaries, 1),
        **dict(zip(("fwd_mb", "fwd_valid", "bwd_mb", "bwd_valid"),
                   pp.schedule_arrays(n_stages, n_micro))),
    )


class Stage:
    """Layers [start, end) of the model, the program of stage ``index``
    (JAX's ``run_stage`` and its forward and backward branches). The
    layers are the model's own modules: their parameters and BN buffers
    are the model's."""

    def __init__(self, model: nn.Module, plan: PipelinePlan, index: int,
                 act_dtype: str = "float32"):
        start, end = plan.starts[index], plan.ends[index]
        self.index = index
        self.last = index == plan.n_stages - 1
        self.a_buf = plan.a_buf
        self.in_shape = plan.stage_in[index]
        self.layers = nn.Sequential(*list(model)[start:end])
        named = [(n, p) for n, p in model.named_parameters()
                 if start <= int(n.split(".", 1)[0]) < end]
        self.names = [n for n, _ in named]  # the model's names, in module order
        self.params = [p for _, p in named]
        self.act_dtype = getattr(torch, act_dtype)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """The stage's layers on ``x``, in f32 or on bf16 casts of ``x``
        and of the parameters (the gradients reach the f32 masters through
        the casts), the output back in f32."""
        if self.act_dtype == torch.float32:
            return self.layers(x)
        params = {n: p.to(self.act_dtype)
                  for n, p in self.layers.named_parameters() if p.is_floating_point()}
        y = torch.func.functional_call(self.layers, params, (x.to(self.act_dtype),))
        return y.to(torch.float32)

    def forward(self, inp: torch.Tensor, labels: torch.Tensor):
        """The forward tick: (the packed output for the next stage, None),
        or on the last stage (None, the microbatch's mean cross-entropy).
        No autograd; BatchNorm updates its running statistics."""
        with torch.no_grad():
            out = self.run(inp)
            if self.last:
                return None, zoo.cross_entropy(out, labels)
            return pp.pack_acts(out, self.a_buf), None

    def backward(self, inp: torch.Tensor, labels: torch.Tensor,
                 cot: Optional[torch.Tensor]):
        """The backward tick: the stage recomputed from its stashed input
        ``inp`` with BatchNorm's running statistics left alone, then (the
        packed gradient of ``inp`` for the previous stage, the gradients of
        the stage's parameters). The last stage differentiates its loss,
        the others take the next stage's packed cotangent ``cot``. Stage 0
        sends nothing back, so it takes no input gradient."""
        need_dx = self.index > 0
        with torch.enable_grad(), running_stats_frozen(self.layers):
            xi = inp.detach().requires_grad_(need_dx)
            out = self.run(xi)
            wrt = self.params + ([xi] if need_dx else [])
            if self.last:
                grads = torch.autograd.grad(zoo.cross_entropy(out, labels), wrt)
            else:
                grads = torch.autograd.grad(
                    out, wrt, grad_outputs=pp.unpack_acts(cot, out.shape))
        d_inp = pp.pack_acts(grads[-1], self.a_buf) if need_dx else None
        return d_inp, list(grads[:len(self.params)])


def make_stages(model: nn.Module, plan: PipelinePlan,
                act_dtype: str = "float32") -> List[Stage]:
    """Every stage's program over ``model`` (a rank runs one of them; the
    card's smoke runs them all in one process)."""
    return [Stage(model, plan, s, act_dtype) for s in range(plan.n_stages)]


class StageRunner:
    """One stage's side of one step: the tick loop's state (the stash,
    what arrived on the two wires, the gradient and loss sums) over this
    data rank's rows ``x``, ``y``. ``tick(t)`` runs the stage's work of
    tick t and returns what it sends (activations on, cotangents back;
    None where nothing goes); the caller sets ``fwd_in`` / ``bwd_in`` to
    what arrives before the next tick."""

    def __init__(self, stage: Stage, plan: PipelinePlan, x: torch.Tensor,
                 y: torch.Tensor):
        self.stage, self.plan = stage, plan
        self.x, self.y = x, y
        self.mb = zoo._microbatch(x, plan.n_micro)
        self.stash = torch.zeros((plan.n_stages, self.mb, plan.a_buf),
                                 dtype=torch.float32, device=x.device)
        self.fwd_in: Optional[torch.Tensor] = None
        self.bwd_in: Optional[torch.Tensor] = None
        self.gsum: Optional[List[torch.Tensor]] = None
        self.lsum = torch.zeros((), dtype=torch.float32, device=x.device)

    def _rows(self, m: int) -> slice:
        return slice(m * self.mb, (m + 1) * self.mb)

    def receives(self, t: int) -> Tuple[bool, bool]:
        """Whether an activation (from the previous stage) and a cotangent
        (from the next) arrive after tick t."""
        s, p = self.stage.index, self.plan
        return (s > 0 and bool(p.fwd_valid[t, s - 1]),
                s < p.n_stages - 1 and bool(p.bwd_valid[t, s + 1]))

    def tick(self, t: int):
        s, p = self.stage.index, self.plan
        sent_fwd = sent_bwd = None
        if p.fwd_valid[t, s]:
            m = int(p.fwd_mb[t, s])
            rows = self._rows(m)
            if s == 0:
                inp = self.x[rows]
            else:
                inp = pp.unpack_acts(self.fwd_in, (self.mb,) + self.stage.in_shape)
            sent_fwd, loss = self.stage.forward(inp, self.y[rows])
            self.stash[m % p.n_stages].copy_(pp.pack_acts(inp, p.a_buf))
            if loss is not None:
                self.lsum = self.lsum + loss
        if p.bwd_valid[t, s]:
            m = int(p.bwd_mb[t, s])
            inp = pp.unpack_acts(self.stash[m % p.n_stages],
                                 (self.mb,) + self.stage.in_shape)
            sent_bwd, grads = self.stage.backward(inp, self.y[self._rows(m)],
                                                  self.bwd_in)
            if self.gsum is None:
                self.gsum = grads
            elif grads:  # a stage of pools and ReLUs has no parameters
                with torch.no_grad():
                    torch._foreach_add_(self.gsum, grads)
        return sent_fwd, sent_bwd


def _default_comm() -> CommConfig:
    """The data-axis reduce without a CommConfig: the bucketed ring."""
    return CommConfig(impl="ring")


def make_pipeline_step(model: nn.Module, optimizer: Optional[zoo.SGD], *,
                       accum_steps: int, mesh, pipeline, in_shape: Sequence[int],
                       comm: Optional[CommConfig] = None, fused=None,
                       lr: float = 0.1, momentum: float = 0.9) -> Callable:
    """The 1F1B step on this rank: step(state, x, y) → loss, updating
    ``state`` in place (JAX's ``make_pipeline_step``).

    ``pipeline`` is a ``config.PipelineConfig`` and ``mesh`` this rank's
    ``make_pipeline_mesh`` view, whose stage axis is ``pipeline.stages``.
    ``accum_steps`` is the microbatch count M: the global batch ``x``,
    ``y`` divides over the data axis and each rank's rows into M
    microbatches. ``fused`` (a ``FusedStepConfig``: update, ZeRO-2, f32)
    replaces the optimizer with the update-on-arrival tail; ``state`` then
    comes from ``zoo.init_fused_state`` over the rank's data row
    (``mesh.data_mesh()``). ``stages=1`` returns the flat ring step
    (``zoo.make_train_step(..., comm=)`` on the data row)."""
    comm = comm or _default_comm()
    n_stages = int(pipeline.stages)
    s_mesh, n_data = pipeline_axis_sizes(mesh)
    if fused is not None:
        if fused.zero != 2:
            raise ValueError(
                "pipeline composes with ZeRO-2 only: ZeRO-3's "
                "just-in-time head gathers contradict per-stage param "
                "residency (docs/pipeline.md)")
        if not fused.update:
            raise ValueError(
                "pipeline fused mode is the ZeRO-2 update-on-arrival "
                "tail and requires fused.update=True")
        if pipeline.act_dtype != "float32":
            raise ValueError(
                "pipeline fused (ZeRO-2) mode is f32-only — bf16 stage "
                "compute composes with the plain optax tail instead")
    if n_stages == 1:
        if fused is not None:
            raise ValueError(
                "stages=1 delegates to the zoo step — use "
                "make_fused_train_step for the ZeRO-2 path there")
        return zoo.make_train_step(model, optimizer, accum_steps,
                                   mesh=mesh.data_mesh(), comm=comm)

    if s_mesh != n_stages:
        raise ValueError(
            f"mesh stage axis is {s_mesh} but pipeline.stages is "
            f"{n_stages} — build the mesh with "
            f"make_pipeline_mesh({n_stages})")
    n_micro = int(accum_steps)
    # Under NCCL the first call on a group that a batch_isend_irecv uses
    # must include every rank of the group, and the first ticks involve
    # two stages: one sum over the stage axis first.
    collectives.all_reduce_sum(torch.zeros((), device=mesh.device), mesh.stage)
    plan = pipeline_plan(model, pipeline, in_shape, n_micro)
    my = mesh.stage.index
    stage = make_stages(model, plan, pipeline.act_dtype)[my]
    data = mesh.data_mesh()
    wire = None if pipeline.wire_dtype == "float32" else pipeline.wire_dtype
    names, params = zip(*zoo.jax_ordered_params(model))
    pos = {name: i for i, name in enumerate(names)}
    module_order = [pos[name] for name, _ in model.named_parameters()]
    own = [pos[name] for name in stage.names]
    # Each BN statistic's owner: the stage of its layer.
    buf_owned = [int(plan.assign[int(name.split(".", 1)[0])]) == my
                 for name, _ in model.named_buffers()]
    bucket_plan = collectives.plan_buckets(list(params), comm.bucket_bytes,
                                           shards=n_data)

    def step(state: zoo.ZooState, x, y, aug=None):
        if aug is not None:
            raise ValueError("pipeline training does not thread augmentation "
                             "keys through the 1F1B schedule yet")
        model.train()
        runner = StageRunner(stage, plan, mesh.shard_rows(x), mesh.shard_rows(y))
        like = runner.stash[0]
        for t in range(plan.n_ticks):
            sent_fwd, sent_bwd = runner.tick(t)
            recv_fwd, recv_bwd = runner.receives(t)
            runner.fwd_in, runner.bwd_in = collectives.stage_exchange(
                sent_fwd, sent_bwd, mesh.stage, recv_fwd=recv_fwd,
                recv_bwd=recv_bwd, like=like, wire_dtype=wire)
        with torch.no_grad():
            full = [torch.zeros_like(p) for p in params]
            for i, g in zip(own, runner.gsum):
                full[i] = g
            # Each gradient is nonzero on its own stage only: the stage sum
            # adds exact zeros.
            gsum = collectives.tree_all_reduce(full, mesh.stage)
            loss = zoo._mean_loss(
                collectives.all_reduce_sum(runner.lsum, mesh.stage), n_micro, data)
            bufs = [b for _, b in model.named_buffers()]
            picked = [b if mine else torch.zeros_like(b)
                      for b, mine in zip(bufs, buf_owned)]
            zoo._copy_into(bufs, collectives.tree_mean(
                collectives.tree_all_reduce(picked, mesh.stage), data))
            if fused is None:
                grads = collectives.tree_all_reduce(gsum, mesh.data, comm)
                grads = torch._foreach_div(list(grads), float(n_micro * n_data))
                state.optimizer.apply(state, [grads[i] for i in module_order])
                return loss
            zero2_tail(state, params, gsum, bucket_plan, data, comm,
                       lr=lr, momentum=momentum, scale=1.0 / (n_micro * n_data))
        return loss

    return step


def zero2_tail(state: zoo.ZooState, params, gsum, plan, data, comm, *,
               lr: float, momentum: float, scale: float) -> None:
    """JAX's ZeRO-2 tail (pipeline_schedule.py:335-376), in place on
    ``params`` (jax order) and ``state.fused``: each bucket of the
    stage-summed gradient ``gsum`` reduce-scattered over the data row
    ``data``, this rank's parameter and momentum shards updated by B13 in
    one launch over the buckets (m' = β·m + g·scale, p' = p − lr·m'), the
    updated shards all-gathered in f32."""
    with torch.no_grad():
        gshards = collectives.reduce_scatter_buckets(
            collectives.flatten_buckets(gsum, plan), data,
            collectives.wire_dtype_arg(comm))
        pshards = [pb.view(data.world, -1)[data.rank]
                   for pb in collectives.flatten_buckets(list(params), plan)]
        opt = state.fused
        p_news, m_news = sgd_update.fused_sgd_momentum_buckets(
            pshards, [m[0] for m in opt.mom], gshards, lr=lr, momentum=momentum,
            scale=scale)
        zoo._copy_into(list(params), collectives.unflatten_buckets(
            collectives.all_gather_buckets(p_news, data), plan))
        opt.mom = [m[None] for m in m_news]


def stage_plan(model: nn.Module, pipeline, in_shape: Sequence[int]):
    """(boundaries, assignment, per-stage flops): JAX's audit surface."""
    boundaries = pp.split_layers(model, pipeline.stages, tuple(in_shape),
                                 microbatch=1, boundaries=pipeline.boundaries())
    costs = pp.layer_costs(model, tuple(in_shape), microbatch=1)
    assign = pp.stage_assignment(len(model), boundaries)
    flops = [0] * pipeline.stages
    for c in costs:
        flops[int(assign[c.index])] += c.flops
    return boundaries, assign, tuple(flops)
