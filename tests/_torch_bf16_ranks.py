"""Rank programs for the port's bf16 tests (test_torch_bf16.py).
parallel/distributed.run calls ``bf16_world`` on every rank of a world of
one (in the calling process) or two (spawned); the module imports torch
and the port only, since a spawned rank imports it afresh. Inputs arrive
as numpy arrays and results go back as numpy arrays."""

import numpy as np
import torch

import _torch_dp_ranks as dp_ranks
from parallel_cnn_tpu_torch.config import FusedStepConfig
from parallel_cnn_tpu_torch.nn import ConvBNAct, Dense, GlobalAvgPool, Sequential, resnet
from parallel_cnn_tpu_torch.parallel.mesh import as_mesh_2d
from parallel_cnn_tpu_torch.train import zoo

#: The dynamic scale's schedule in the tests: small enough that three
#: overflows reach the clamp at 1, and growth after two clean steps.
SCALED = FusedStepConfig(update=True, tail=True, act_dtype="bfloat16", loss_scale=4.0,
                         growth_interval=2, backoff=0.5)
#: The GSPMD step's fused config: bf16 activations, the static scale.
GSPMD_FUSED = FusedStepConfig(update=False, act_dtype="bfloat16")
GSPMD_LR = 0.01


def small_resnet() -> Sequential:
    """A ResNet of widths 8 and 16, one block a stage (the second at
    stride 2), the gap head: ResNet-18's layers at a CPU test's size."""
    return Sequential(ConvBNAct(3, 8, backend="cuda"),
                      resnet.BasicBlock(8, 8, 1, "cuda"),
                      resnet.BasicBlock(8, 16, 2, "cuda"),
                      GlobalAvgPool(), Dense(16, 10))


def _arrays(state):
    return {k: v.detach().cpu().numpy().copy() for k, v in state.arrays().items()}


def _model(build, sd):
    model = build()
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    return model


def bf16_world(mesh, spec):
    """On this rank: the update-on-arrival step in bf16 on the tiny conv-BN
    model over ``spec["batches"]`` (each "x" or "x_inf"), its state after
    each step; and, on a world of two, two GSPMD bf16 steps of the small
    ResNet."""
    torch.set_num_threads(1)
    y = torch.from_numpy(spec["y"]).long()
    model = _model(dp_ranks.tiny_model, spec["sd"])
    state, _ = zoo.init_fused_state(model, zoo.make_optimizer(dp_ranks.LR, dp_ranks.MOMENTUM),
                                    mesh=mesh, fused=SCALED,
                                    bucket_bytes=dp_ranks.BUCKET_BYTES)
    step = zoo.make_fused_train_step(
        model, lr=dp_ranks.LR, momentum=dp_ranks.MOMENTUM, accum_steps=dp_ranks.ACCUM,
        mesh=mesh, augment_pad=None, comm=dp_ranks.RING, fused=SCALED)
    res = {"arrays": [_arrays(state)], "losses": []}
    for name in spec["batches"]:
        res["losses"].append(float(step(state, torch.from_numpy(spec[name]), y)))
        res["arrays"].append(_arrays(state))
    if mesh.world > 1:
        mesh2 = as_mesh_2d(mesh)
        model = _model(small_resnet, spec["resnet_sd"])
        opt = zoo.make_optimizer(GSPMD_LR)
        gstate = zoo.init_state(model, opt, mesh=mesh2)
        gstep = zoo.make_train_step(model, opt, fused=GSPMD_FUSED, mesh=mesh2)
        rx = torch.from_numpy(spec["rx"])
        ry = torch.from_numpy(spec["ry"]).long()
        res["gspmd_losses"] = [float(gstep(gstate, rx, ry)) for _ in range(2)]
    return res
