"""Rank programs for the port's pipeline tests (test_torch_pipeline.py).
parallel/distributed.run spawns one gloo world of 4 ranks and calls
``pipeline_cases`` on every rank; the module imports torch and the port
only, since a spawned rank imports it afresh. Each case builds its own
mesh over the world (``make_pipeline_mesh``: S stages × 4/S data ranks).
Inputs arrive as numpy arrays and results go back as numpy arrays."""

import dataclasses

import numpy as np
import torch

from parallel_cnn_tpu_torch.config import CommConfig, FusedStepConfig, PipelineConfig
from parallel_cnn_tpu_torch.nn import BatchNorm, Conv2D, Dense, Flatten, MaxPool, ReLU, Sequential
from parallel_cnn_tpu_torch.parallel.mesh import DataMesh, make_pipeline_mesh
from parallel_cnn_tpu_torch.train import zoo
from parallel_cnn_tpu_torch.train.pipeline_schedule import make_pipeline_step

IN_SHAPE = (8, 8, 3)
ACCUM, BATCH, STEPS = 2, 32, 3
LR, MOMENTUM = 0.1, 0.9
WORLD = 4
RING = CommConfig(impl="ring")
ZERO2 = FusedStepConfig(update=True, tail=False, act_dtype="float32")


def small_model() -> Sequential:
    """JAX's ``tests/test_pipeline.py`` ``small_model``: conv → BN → ReLU →
    2x2 max pool → conv → ReLU → flatten → Dense 10 on 8x8x3 inputs."""
    return Sequential(Conv2D(3, 4), BatchNorm(4), ReLU(), MaxPool(), Conv2D(4, 8),
                      ReLU(), Flatten(), Dense(4 * 4 * 8, 10))


def model_from(sd) -> Sequential:
    model = small_model()
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    return model


def _numpy(arrays):
    return {k: v.detach().cpu().numpy().copy() for k, v in arrays.items()}


def _run(state, step, X, Y, steps=STEPS):
    """``steps`` steps on the global batches: the losses and the whole state
    (checkpoint keys) after the last."""
    losses = []
    for i in range(steps):
        losses.append(float(step(state, torch.from_numpy(X[i]),
                                 torch.from_numpy(Y[i]).long())))
    return losses, _numpy(state.checkpoint_arrays())


def flat_ring(mesh, sd, X, Y, steps=STEPS):
    """The port's flat data-parallel ring step on ``mesh`` (a data row)."""
    model = model_from(sd)
    opt = zoo.make_optimizer(LR, MOMENTUM)
    state = zoo.init_state(model, opt)
    step = zoo.make_train_step(model, opt, ACCUM, mesh=mesh, comm=RING)
    return _run(state, step, X, Y, steps)


def pipelined(mesh, sd, X, Y, pipeline, fused=None, steps=STEPS):
    """The port's pipelined step on ``mesh``; with ``fused`` the ZeRO-2
    tail, its state over the rank's data row."""
    model = model_from(sd)
    opt = zoo.make_optimizer(LR, MOMENTUM)
    if fused is None:
        state = zoo.init_state(model, opt)
    else:
        state, _ = zoo.init_fused_state(model, opt, mesh=mesh.data_mesh(), fused=fused,
                                        bucket_bytes=RING.bucket_bytes)
    step = make_pipeline_step(model, None if fused else opt, accum_steps=ACCUM,
                              mesh=mesh, pipeline=pipeline, in_shape=IN_SHAPE,
                              comm=RING, fused=fused, lr=LR, momentum=MOMENTUM)
    return _run(state, step, X, Y, steps)


def _buffers(result):
    return {k: v for k, v in result[1].items() if k.startswith(".model_state/")}


def pipeline_cases(mesh: DataMesh, spec):
    """Every case on this rank of the world of 4; returns {case: (losses,
    arrays)} (the BN cases: their buffers after one step)."""
    rank, dev = mesh.rank, mesh.device
    sd, X, Y = spec["sd"], spec["X"], spec["Y"]
    out = {}
    # S = 1 over 4 data ranks against the flat ring over the same 4.
    m1 = make_pipeline_mesh(rank, WORLD, dev, 1)
    out["s1"] = pipelined(m1, sd, X, Y, PipelineConfig(stages=1))
    out["flat4"] = flat_ring(mesh, sd, X, Y)
    # S = 2 x D = 2: f32, bf16 wire and act, the ZeRO-2 tail; the flat ring
    # over each data row.
    m2 = make_pipeline_mesh(rank, WORLD, dev, 2)
    out["s2"] = pipelined(m2, sd, X, Y, PipelineConfig(stages=2))
    out["s2_bf16"] = pipelined(m2, sd, X, Y, PipelineConfig(
        stages=2, wire_dtype="bfloat16", act_dtype="bfloat16"))
    out["s2_zero2"] = pipelined(m2, sd, X, Y, PipelineConfig(stages=2), fused=ZERO2)
    out["flat2"] = flat_ring(m2.data_mesh(), sd, X, Y)
    # S = 4 x D = 1 (a manual split too) against one device.
    m4 = make_pipeline_mesh(rank, WORLD, dev, 4)
    out["s4"] = pipelined(m4, sd, X, Y, PipelineConfig(stages=4))
    out["s4_split"] = pipelined(m4, sd, X, Y, PipelineConfig(stages=4, split="2,4,6"))
    out["flat1"] = flat_ring(DataMesh(1, 0, dev), sd, X, Y)
    # The BN running statistics after one step, pipelined and flat.
    out["bn_s2"] = _buffers(pipelined(m2, sd, X, Y, PipelineConfig(stages=2), steps=1))
    out["bn_flat2"] = _buffers(flat_ring(m2.data_mesh(), sd, X, Y, steps=1))
    return out


def fused_zero3():
    """The ZeRO-2 tail's fused config at zero=3, which the pipeline
    refuses."""
    return dataclasses.replace(ZERO2, zero=3)
