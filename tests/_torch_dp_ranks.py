"""Rank programs for the port's data-parallel tests (test_torch_comm.py,
test_torch_dp.py). parallel/distributed.run spawns each world of ranks
and calls one of these on every rank; the module imports torch and the
port only, since a spawned rank imports it afresh. Inputs arrive as numpy
arrays and results go back as numpy arrays."""

import numpy as np
import torch

from parallel_cnn_tpu_torch.config import CommConfig, FusedStepConfig
from parallel_cnn_tpu_torch.nn import BatchNorm, Conv2D, Dense, Flatten, MaxPool, ReLU, Sequential
from parallel_cnn_tpu_torch.parallel import collectives
from parallel_cnn_tpu_torch.train import checkpoint, zoo

# The JAX fused-step tests' tiny model and schedule
# (tests/test_fused_step.py:377-425): 8x8x3 inputs, batch 16, accum 2,
# 2048-byte buckets, lr 0.05, momentum 0.9.
TINY_SHAPE = (8, 8, 3)
ACCUM = 2
BUCKET_BYTES = 2048
LR = 0.05
MOMENTUM = 0.9
RING = CommConfig(impl="ring", bucket_bytes=BUCKET_BYTES, overlap=True)
PSUM = CommConfig(impl="psum", bucket_bytes=BUCKET_BYTES)
FUSED = FusedStepConfig(update=True, tail=True, act_dtype="float32")


def tiny_model(bn: bool = True, seed: int = 0) -> Sequential:
    """Conv 4x3x3 (+ BatchNorm) → ReLU → 2x2 max pool → Dense 10."""
    gen = torch.Generator().manual_seed(seed)
    layers = [Conv2D(3, 4, 3, generator=gen)]
    if bn:
        layers.append(BatchNorm(4))
    layers += [ReLU(), MaxPool(), Flatten(), Dense(64, 10, generator=gen)]
    return Sequential(*layers)


def _np_state(model):
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def comm_cases(mesh, cases):
    """Each case ``(op, per_rank_inputs, wire)`` on this rank's input:
    op "rs", "ag", "ar" (the ring), "tree_ring" / "tree_psum"
    (``tree_all_reduce`` of ``{"a": x[:37], "b": x[37:40]·2, "c": x[40]·3}``).
    Returns the numpy results in case order."""
    torch.set_num_threads(1)
    out = []
    for op, inputs, wire in cases:
        x = torch.from_numpy(np.array(inputs[mesh.rank], copy=True))
        if op == "rs":
            got = collectives.ring_reduce_scatter(x, mesh, wire)
        elif op == "ag":
            got = collectives.ring_all_gather(x, mesh, wire)
        elif op == "ar":
            got = collectives.ring_all_reduce(x, mesh, wire)
        else:
            tree = {"a": x[:37], "b": x[37:40] * 2.0, "c": x[40] * 3.0}
            impl = "ring" if op == "tree_ring" else "psum"
            got = collectives.tree_all_reduce(
                tree, mesh, CommConfig(impl=impl, bucket_bytes=64))
            got = {k: v.numpy().copy() for k, v in got.items()}
            out.append(got)
            continue
        out.append(got.numpy().copy())
    return out


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _fused(model, mesh):
    state, _ = zoo.init_fused_state(model, zoo.make_optimizer(LR, MOMENTUM),
                                    mesh=mesh, fused=FUSED,
                                    bucket_bytes=BUCKET_BYTES)
    step = zoo.make_fused_train_step(
        model, lr=LR, momentum=MOMENTUM, accum_steps=ACCUM, mesh=mesh,
        augment_pad=None, comm=RING, fused=FUSED)
    return state, step


def _unfused(model, mesh, comm):
    opt = zoo.make_optimizer(LR, MOMENTUM)
    state = zoo.init_state(model, opt)
    return state, zoo.make_train_step(model, opt, ACCUM, mesh=mesh, comm=comm)


def _model_from(sd, bn=True):
    model = tiny_model(bn)
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    return model


def _run(state, step, x, y, steps):
    return [float(step(state, x, y)) for _ in range(steps)]


def dp_steps(mesh, spec):
    """The update-on-arrival, ring and psum steps on the tiny models, the
    overflow skip, and a checkpoint round trip. ``spec`` holds the conv-BN
    model's state_dict ``sd`` (JAX's init), the BN-free one's ``sd_nobn``,
    the batch ``x``/``y``, the batch with an inf ``x_inf``, and ``ckpt``,
    the path rank 0 writes the fused state to after 3 steps."""
    torch.set_num_threads(1)
    x = torch.from_numpy(spec["x"])
    y = torch.from_numpy(spec["y"]).long()
    res = {}

    # Update-on-arrival: 3 steps, a checkpoint, 2 more; then the checkpoint
    # restored into a fresh state and the same 2 steps.
    model = _model_from(spec["sd"])
    state, step = _fused(model, mesh)
    res["fused_losses"] = _run(state, step, x, y, 3)
    res["fused_state"] = _np_state(model)
    arrays = state.checkpoint_arrays()  # a collective: every rank
    res["fused_arrays"] = {k: v.detach().cpu().numpy().copy()
                           for k, v in arrays.items()}
    if mesh.rank == 0:
        checkpoint.save(spec["ckpt"], arrays, checkpoint.TrainState(epoch=3))
    torch.distributed.barrier()
    res["cont_losses"] = _run(state, step, x, y, 2)
    res["cont_arrays"] = {k: v.detach().cpu().numpy().copy()
                          for k, v in state.checkpoint_arrays().items()}
    fresh, fresh_step = _fused(_model_from(spec["sd"]), mesh)
    loaded, tstate = checkpoint.restore(spec["ckpt"], fresh.checkpoint_arrays())
    fresh.load(loaded)
    res["resumed_epoch"] = tstate.epoch
    res["resumed_losses"] = _run(fresh, fresh_step, x, y, 2)
    res["resumed_arrays"] = {k: v.detach().cpu().numpy().copy()
                             for k, v in fresh.checkpoint_arrays().items()}

    # The unfused explicit-collective step, ring and psum.
    for name, comm in (("ring", RING), ("psum", PSUM)):
        model = _model_from(spec["sd"])
        state, step = _unfused(model, mesh, comm)
        res[f"{name}_losses"] = _run(state, step, x, y, 3)
        res[f"{name}_state"] = _np_state(model)
        res[f"{name}_trace"] = {k: v.numpy().copy() for k, v in state.trace.items()}
        model = _model_from(spec["sd_nobn"], bn=False)
        state, step = _unfused(model, mesh, comm)
        res[f"{name}_nobn_losses"] = _run(state, step, x, y, 3)
        res[f"{name}_nobn_state"] = _np_state(model)

    # Overflow: an inf in x skips the update on every rank, bit for bit.
    model = _model_from(spec["sd"])
    state, step = _fused(model, mesh)
    _run(state, step, x, y, 1)  # momentum nonzero before the skip
    before = {k: v.detach().cpu().numpy().copy() for k, v in state.arrays().items()}
    res["inf_loss"] = float(step(state, torch.from_numpy(spec["x_inf"]), y))
    res["inf_before"] = before
    res["inf_after"] = {k: v.detach().cpu().numpy().copy()
                        for k, v in state.arrays().items()}
    float(step(state, x, y))
    res["clean_after"] = {k: v.detach().cpu().numpy().copy()
                          for k, v in state.arrays().items()}
    return res
