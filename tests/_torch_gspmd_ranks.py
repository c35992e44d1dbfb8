"""Rank programs for the port's GSPMD zoo tests (test_torch_gspmd.py).
parallel/distributed.run spawns each world of ranks with the plan of its
(data, model) mesh and calls one of these on every rank; the module imports torch
and the port only, since a spawned rank imports it afresh. Inputs arrive
as numpy arrays and results go back as numpy arrays."""

import contextlib
import io

import numpy as np
import torch

from parallel_cnn_tpu_torch import cli
from parallel_cnn_tpu_torch import plan as pplan
from parallel_cnn_tpu_torch.data import augment as aug_lib
from parallel_cnn_tpu_torch.nn import (BatchNorm, Conv2D, ConvBNAct, Dense, Flatten,
                                       GlobalAvgPool, MaxPool, ReLU, Sequential, cifar,
                                       resnet, vgg)
from parallel_cnn_tpu_torch.parallel import mesh as mesh_lib
from parallel_cnn_tpu_torch.train import checkpoint, zoo

SHAPE = (8, 8, 3)
LR = 0.01
MOMENTUM = 0.9
STEPS = 2
PAD = 2


def two_conv(widths=(4, 8)) -> Sequential:
    """Conv → BN → ReLU → Conv → BN → ReLU → 2x2 max pool → Dense 10 on
    8x8x3 inputs. ``(4, 6)`` is the mixed case: at a model axis of 4 the
    first conv splits, the second and the head stay whole."""
    a, b = widths
    return Sequential(Conv2D(3, a), BatchNorm(a), ReLU(), Conv2D(a, b), BatchNorm(b),
                      ReLU(), MaxPool(), Flatten(), Dense(16 * b, 10))


MODELS = {
    "two_conv": two_conv,
    "mixed": lambda: two_conv((4, 6)),
    "cifar_cnn": lambda: cifar.cifar_cnn(in_shape=SHAPE),
    "resnet18": lambda: resnet.resnet18(10, backend="cuda"),
}


def model_from(name, sd, dtype=torch.float32):
    model = MODELS[name]()
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    return model.to(dtype)


def numpy_arrays(arrays):
    return {k: v.detach().cpu().numpy().copy() for k, v in arrays.items()}


def gspmd(mesh, name, sd, accum=1, model_axis=None, augment_pad=None,
          dtype=torch.float32):
    """(state, step) of the GSPMD path for model ``name`` from ``sd``;
    ``model_axis`` defaults to the mesh having a model axis."""
    if model_axis is None:
        model_axis = mesh.model.size > 1
    model = model_from(name, sd, dtype)
    opt = zoo.make_optimizer(LR, MOMENTUM)
    state = zoo.init_state(model, opt, mesh=mesh, model_axis=model_axis)
    step = zoo.make_train_step(model, opt, accum, augment_pad, mesh=mesh,
                               model_axis=model_axis)
    return state, step


def run_steps(state, step, x, y, steps=STEPS, aug=None):
    """``steps`` steps on the global batch: the losses and the whole state
    (checkpoint keys) after each."""
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    losses, arrays = [], []
    for _ in range(steps):
        losses.append(float(step(state, xt, yt, aug)))
        arrays.append(numpy_arrays(state.checkpoint_arrays()))
    return losses, arrays


def _local(state):
    """Each leaf as this rank holds it: values, and whether it is a
    contiguous tensor of its own."""
    arrays = state.arrays()
    own = {k: bool(t.is_contiguous() and t._base is None) for k, t in arrays.items()}
    return numpy_arrays(arrays), own


def dp_cases(mesh, spec):
    """On a (2, 1) mesh: each model of ``spec["models"]`` with accum 1 and
    2; the rows the step crops from the global draws; zoo.train with
    augmentation, straight and resumed; the CLI's job."""
    torch.set_num_threads(1)
    x, y = spec["x"], spec["y"]
    res = {}
    for name, sd in spec["models"].items():
        for accum in (1, 2):
            state, step = gspmd(mesh, name, sd, accum)
            res[(name, accum)] = run_steps(state, step, x, y)

    # The rows of microbatch 1 of 2 that this rank crops, from the global
    # batch's draws.
    xt = torch.from_numpy(x)
    offsets, flips = aug_lib.draw(torch.Generator().manual_seed(3), x.shape[0], PAD)
    res["aug_rows"] = zoo.gspmd_rows(mesh, xt, torch.from_numpy(y), (offsets, flips),
                                     PAD, slice(8, 16))[0].numpy()

    kw = dict(batch_size=8, lr=LR, augment=True, augment_pad=PAD, seed=1,
              verbose=False, eval_data=(spec["ex"], spec["ey"]), device="cpu",
              mesh=mesh)
    _, res["train_losses"] = zoo.train(model_from("two_conv", spec["models"]["two_conv"]),
                                       spec["tx"], spec["ty"], epochs=2,
                                       checkpoint_dir=spec["straight"], **kw)
    zoo.train(model_from("two_conv", spec["models"]["two_conv"]), spec["tx"], spec["ty"],
              epochs=1, checkpoint_dir=spec["split"], **kw)
    zoo.train(model_from("two_conv", spec["models"]["two_conv"]), spec["tx"], spec["ty"],
              epochs=2, checkpoint_dir=spec["split"], resume=True, **kw)

    args = cli.build_parser().parse_args(
        ["--device", "cpu", "--model", "cifar_cnn", "--mesh-data", "2", "--batch-size",
         "16", "--lr", "0.01", "--epochs", "2", "--synthetic-train-count", "64",
         "--synthetic-test-count", "32"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cfg, _ = cli._zoo_fallback(cli.config_from_args(args))
        cli._zoo_job(mesh, args, cfg, pplan.build_plan(cfg, args))
    res["cli"] = out.getvalue()
    return res


def hybrid_cases(mesh, spec):
    """On a (2, 2) mesh: the two-conv model and ResNet-18 with the model
    axis, each rank's local leaves, and the two-conv state written after
    STEPS steps (rank 0) and carried one step further."""
    torch.set_num_threads(1)
    x, y = spec["x"], spec["y"]
    res = {}
    for name, sd in spec["models"].items():
        state, step = gspmd(mesh, name, sd)
        res[name] = run_steps(state, step, x, y)
        res[f"{name}_local"] = _local(state)
        if name == "two_conv":
            arrays = state.checkpoint_arrays()
            if mesh.rank == 0:
                checkpoint.save(spec["ckpt"], arrays, checkpoint.TrainState(epoch=STEPS))
            res["after_ckpt"] = run_steps(state, step, x, y, steps=1)
    # ResNet-18 in f64: what is left against one device is f64 rounding.
    state, step = gspmd(mesh, "resnet18", spec["models"]["resnet18"],
                        dtype=torch.float64)
    res["resnet18_f64"] = run_steps(state, step, x.astype(np.float64), y)
    return res


def mixed_cases(mesh, spec):
    """On a (1, 4) mesh: the mixed model (first conv split, second conv and
    head replicated), and the same model without the model axis."""
    torch.set_num_threads(1)
    x, y = spec["x"], spec["y"]
    res = {}
    for model_axis in (True, False):
        state, step = gspmd(mesh, "mixed", spec["sd"], model_axis=model_axis)
        res[model_axis] = run_steps(state, step, x, y)
        res[(model_axis, "local")] = _local(state)
    return res


def resume_on_one(mesh, spec):
    """On a (1, 1) mesh: the two-conv model from the 2 x 2 checkpoint,
    one step further."""
    state, step = gspmd(mesh, "two_conv", spec["sd"])
    arrays, tstate = checkpoint.restore(spec["ckpt"], state.checkpoint_arrays())
    state.load(arrays)
    return tstate.epoch, run_steps(state, step, spec["x"], spec["y"], steps=1)


# ---------------------------------------------------------------------------
# ResNet-50's Bottleneck and VGG-16 on the mesh (test_torch_gspmd_zoo50.py)
# ---------------------------------------------------------------------------


def mixed50() -> Sequential:
    """A 3x3 ConvBNAct to 8, three Bottlenecks of width 6 (a projection at
    stride 1, a projection at stride 2, an identity), the gap head. At a
    model axis of 4 the 8- and 24-wide convs split and the 6-wide ones stay
    whole; at 3 the 6- and 24-wide ones split and the stem stays whole."""
    return Sequential(ConvBNAct(3, 8, backend="cuda"),
                      resnet.Bottleneck(8, 6, 1, "cuda"),
                      resnet.Bottleneck(24, 6, 2, "cuda"),
                      resnet.Bottleneck(24, 6, 1, "cuda"),
                      GlobalAvgPool(), Dense(24, 10))


MODELS.update({
    "resnet50_reduced": lambda: resnet._resnet(resnet.Bottleneck, (1, 1, 1, 1), 10,
                                               True, "cuda", None, None),
    "vgg16": lambda: vgg.vgg16(10),
    "mixed50": mixed50,
})


def zoo50_cases(mesh, spec):
    """On each (data, model) mesh of ``spec["shapes"]`` over this world
    (one spawn serves every shape of its size): each model of
    ``spec["models"]`` (name → state_dict, images, labels), STEPS GSPMD
    steps with the model axis where the mesh has one, and each rank's local
    leaves; the models of ``spec["f64"]`` also in f64. Results by shape."""
    torch.set_num_threads(1)
    out = {}
    for shape in spec["shapes"]:
        if shape == (mesh.data.size, mesh.model.size):
            m = mesh
        else:
            m = mesh_lib.make_mesh_2d(mesh.rank, mesh.world, mesh.device, *shape)
        res = out[shape] = {}
        for name, (sd, x, y) in spec["models"].items():
            state, step = gspmd(m, name, sd)
            res[name] = run_steps(state, step, x, y)
            res[f"{name}_local"] = _local(state)
            if name in spec["f64"]:
                state, step = gspmd(m, name, sd, dtype=torch.float64)
                res[f"{name}_f64"] = run_steps(state, step, x.astype(np.float64), y)
    return out
