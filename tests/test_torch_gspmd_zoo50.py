"""ResNet-50's Bottleneck and VGG-16 on the port's GSPMD zoo path against
the JAX package on the CPU: ``zoo.make_train_step(mesh=..., model_axis=...)``
on spawned gloo worlds (``tests/_torch_gspmd_ranks.py``) against JAX's
``make_train_step(mesh=..., model_axis=...)`` on a mesh of the same shape
over the 8-device host platform, and against the port's own single-device
step.

- 2 × 1 and 1 × 2: the reduced-depth ResNet-50 (``_resnet(Bottleneck, (1,
  1, 1, 1))``, CIFAR stem, 8x8 noise images) and full VGG-16 (CIFAR head,
  32x32 noise images, biased convs on the kernels' path);
- 1 × 4 and 1 × 3: three bottlenecks of width 6 behind an 8-wide stem,
  whose convs the model axis splits differently (at 4: the stem and the
  24-wide convs, not the 6-wide ones; at 3: the 6- and 24-wide ones, not
  the stem), so a conv whose input arrives in the other layout, or a
  shortcut added to the wrong block, shows.

Weights are JAX's init distribution drawn with numpy from a seed
(``tests/_torch_jax_init.py``), carried across by ``convert.from_jax``;
lr 0.01. The 2 × 1 and 1 × 2 meshes share one spawn of two ranks.
The small bottleneck net is held as test_torch_gspmd.py holds its models:
after one step every leaf and the loss within 1e-5 abs + 1e-5 rel, the
momentum trace (the first gradient) within 2e-4 of max(1, the leaf's
largest value); after the second step JAX's bounds for GSPMD against one
device (loss rtol 5e-4, leaves atol 5e-3).

The reduced ResNet-50 and VGG-16 are chaotic at init in train mode: BN
over 8 values a channel at 1x1 (ResNet-50's last stage) and ReLU → max
pool near-ties (VGG) turn f32 rounding into first gradients that differ
by 0.5% (ResNet-50: JAX's f32 step against the port's f64 step, while the
port's f32 step is within 5e-6 of it; at another seed the other way round)
and 3% (VGG-16: the port's own f32 step against its f64 step, whose
second loss then differs by 4.8e-3 relative). So they are held against
JAX by the losses (rtol 5e-4; VGG-16's 1e-2, twice that f32 floor) and
every parameter and BN statistic within JAX's GSPMD bound (atol 5e-3)
after each step, the momentum trace (that first gradient) not compared;
and against the port's single device in f64, where every leaf, trace
included, agrees within 1e-10 after each step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gspmd_ranks as ranks
from parallel_cnn_tpu.config import MeshConfig as JaxMeshConfig
from parallel_cnn_tpu.nn import core as jax_core
from parallel_cnn_tpu.nn import layers as jax_layers
from parallel_cnn_tpu.nn import resnet as jax_resnet
from parallel_cnn_tpu.nn import vgg as jax_vgg
from parallel_cnn_tpu.parallel import mesh as jax_mesh
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch import convert
from parallel_cnn_tpu_torch import plan as pplan
from _torch_jax_init import jax_init
from parallel_cnn_tpu_torch.parallel import distributed
from parallel_cnn_tpu_torch.train import zoo

ATOL = RTOL = 1e-5
LOSS_RTOL_2 = 5e-4
LEAF_ATOL_2 = 5e-3
GRAD_SCALE = 2e-4
F64_ATOL = 1e-10
WORLD_TIMEOUT_S = 300
# Chaotic at init in f32 (module docstring): held without the trace, the
# losses within these relative bounds.
DEEP = {"resnet50_reduced": LOSS_RTOL_2, "vgg16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_mixed50():
    L = jax_layers
    return jax_core.Sequential([
        L.ConvBNAct(8), jax_resnet.Bottleneck(6), jax_resnet.Bottleneck(6, 2),
        jax_resnet.Bottleneck(6), L.GlobalAvgPool(), L.Dense(10)])


JAX_MODELS = {
    "resnet50_reduced": lambda: jax_resnet._resnet(jax_resnet.Bottleneck, (1, 1, 1, 1),
                                                   10, True),
    "vgg16": lambda: jax_vgg.vgg16(10),
    "mixed50": _jax_mixed50,
}
SHAPES = {"resnet50_reduced": (8, 8, 3), "vgg16": (32, 32, 3), "mixed50": (8, 8, 3)}


@functools.cache
def _case(name, seed):
    """(JAX's init distribution drawn with numpy, the port's state_dict,
    images, labels)."""
    init = jax_init(JAX_MODELS[name](), SHAPES[name], seed + 100)
    rng = np.random.default_rng(seed + 10)
    x = rng.uniform(0.0, 1.0, (8,) + SHAPES[name]).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    sd = {k: v.numpy() for k, v in convert.from_jax(*init).items()}
    return init, sd, x, y


def _jax_steps(name, init, x, y, data, model):
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=data, model=model))
    opt = jax_zoo.make_optimizer(lr=ranks.LR, momentum=ranks.MOMENTUM)
    params, state = jax.tree_util.tree_map(jnp.asarray, init)
    st = jax_zoo.ZooState(params, state, opt.init(params))
    step = jax_zoo.make_train_step(JAX_MODELS[name](), opt, mesh=mesh,
                                   model_axis=model > 1)
    losses, arrays = [], []
    for _ in range(ranks.STEPS):
        st, loss = step(st, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
        arrays.append({k: np.asarray(v) for k, v in jax_checkpoint._flatten(st).items()})
    return losses, arrays


@functools.cache
def _single(name, seed, dtype=torch.float32):
    """The port's single-device steps on ``_case(name, seed)``, once a
    module for the worlds that share the case."""
    _, sd, x, y = _case(name, seed)
    if dtype == torch.float64:
        x = x.astype(np.float64)
    model = ranks.model_from(name, sd, dtype)
    opt = zoo.make_optimizer(ranks.LR, ranks.MOMENTUM)
    state = zoo.init_state(model, opt)
    return ranks.run_steps(state, zoo.make_train_step(model, opt), x, y)


def _assert_steps(got, want, what):
    (g_losses, g_arrays), (w_losses, w_arrays) = got, want
    np.testing.assert_allclose(g_losses[0], w_losses[0], atol=ATOL, rtol=RTOL,
                               err_msg=f"{what} loss 1")
    np.testing.assert_allclose(g_losses[1], w_losses[1], rtol=LOSS_RTOL_2,
                               err_msg=f"{what} loss 2")
    for i, (atol, rtol) in enumerate(((ATOL, RTOL), (LEAF_ATOL_2, 0.0))):
        assert sorted(g_arrays[i]) == sorted(w_arrays[i]), what
        for k, v in w_arrays[i].items():
            tol = atol
            if i == 0 and ".trace/" in k:
                tol = GRAD_SCALE * max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(g_arrays[i][k], v, atol=tol, rtol=rtol,
                                       err_msg=f"{what} step {i + 1} {k}")


WORLDS = {  # (data, model): the models each world trains
    (2, 1): ("resnet50_reduced", "vgg16"),
    (1, 2): ("resnet50_reduced", "vgg16"),
    (1, 4): ("mixed50",),
    (1, 3): ("mixed50",),
}
CASES = [(shape, name) for shape, names in WORLDS.items() for name in names]
IDS = [f"{d}x{m}-{name}" for (d, m), name in CASES]
SEEDS = {name: seed for names in WORLDS.values() for seed, name in enumerate(names)}


@pytest.fixture(scope="module")
def worlds():
    """Every world once, those of one size in one spawn (2×1 and 1×2 share
    theirs): {shape: (cases, per-rank results)}."""
    sizes = {}
    for shape, names in WORLDS.items():
        sizes.setdefault(shape[0] * shape[1], []).append(shape)
    out = {}
    for size, shapes in sizes.items():
        names = WORLDS[shapes[0]]
        assert all(WORLDS[s] == names for s in shapes)
        cases = {name: _case(name, SEEDS[name]) for name in names}
        spec = dict(models={n: c[1:] for n, c in cases.items()}, f64=tuple(DEEP),
                    shapes=shapes)
        results = distributed.run(ranks.zoo50_cases, size, device="cpu", args=(spec,),
                                  timeout=WORLD_TIMEOUT_S,
                                  plan=pplan.ExecutionPlan(data=shapes[0][0],
                                                           model=shapes[0][1]))
        for shape in shapes:
            out[shape] = cases, [res[shape] for res in results]
    return out


def _assert_deep_steps(got, want, what, loss_rtol):
    """Both steps' losses within ``loss_rtol``, every leaf but the
    momentum trace within atol 5e-3 after each step."""
    (g_losses, g_arrays), (w_losses, w_arrays) = got, want
    np.testing.assert_allclose(g_losses, w_losses, rtol=loss_rtol,
                               err_msg=f"{what} losses")
    for i in range(ranks.STEPS):
        assert sorted(g_arrays[i]) == sorted(w_arrays[i]), what
        for k, v in w_arrays[i].items():
            if ".trace/" not in k:
                np.testing.assert_allclose(g_arrays[i][k], v, atol=LEAF_ATOL_2,
                                           err_msg=f"{what} step {i + 1} {k}")


@pytest.mark.parametrize("shape,name", CASES, ids=IDS)
def test_step_matches_jax(worlds, host_devices, shape, name):
    cases, results = worlds[shape]
    init, _, x, y = cases[name]
    want = _jax_steps(name, init, x, y, *shape)
    for r, res in enumerate(results):
        if name in DEEP:
            _assert_deep_steps(res[name], want, f"{name} {shape} rank {r}", DEEP[name])
        else:
            _assert_steps(res[name], want, f"{name} {shape} rank {r}")


@pytest.mark.parametrize("shape,name", CASES, ids=IDS)
def test_step_matches_the_single_device_step(worlds, shape, name):
    """The small net in f32; the deep ones in f64, where what is left to
    differ is the mesh: its collectives, global statistics and split
    layers."""
    _, results = worlds[shape]
    if name not in DEEP:
        want = _single(name, SEEDS[name])
        for r, res in enumerate(results):
            _assert_steps(res[name], want, f"{name} {shape} rank {r}")
        return
    w_losses, w_arrays = _single(name, SEEDS[name], torch.float64)
    for r, res in enumerate(results):
        losses, arrays = res[f"{name}_f64"]
        np.testing.assert_allclose(losses, w_losses, atol=ATOL, rtol=RTOL)  # f32 CE
        for i in range(ranks.STEPS):
            assert sorted(arrays[i]) == sorted(w_arrays[i])
            for k, v in w_arrays[i].items():
                assert arrays[i][k].dtype == np.float64, k
                np.testing.assert_allclose(
                    arrays[i][k], v, atol=F64_ATOL, rtol=0,
                    err_msg=f"{name} {shape} rank {r} step {i + 1} {k}")


@pytest.mark.parametrize("model,split", [
    (4, {"0/conv/w": 2, "1/main/0/conv/w": 6, "1/main/1/conv/w": 6,
         "1/main/2/conv/w": 6, "1/proj/0/conv/w": 6, "3/main/2/conv/w": 6,
         "5/w": 10}),
    (3, {"0/conv/w": 8, "1/main/0/conv/w": 2, "1/main/1/conv/w": 2,
         "1/main/2/conv/w": 8, "1/proj/0/conv/w": 8, "3/main/2/conv/w": 8,
         "5/w": 10}),
], ids=["model4", "model3"])
def test_bottleneck_widths_split_differently(worlds, model, split):
    """Each rank's output features of each conv: a block where the width
    divides the model axis, whole where it does not; the blocks are the
    whole leaves' (the single-device state after the steps, gathered)."""
    _, results = worlds[(1, model)]
    for r, res in enumerate(results):
        local, own = res["mixed50_local"]
        whole = res["mixed50"][1][-1]
        for leaf, width in split.items():
            k = f".params/{leaf}"
            assert local[k].shape[-1] == width and own[k], (r, k)
            full = whole[k].shape[-1]
            lo = r * width if width < full else 0
            assert np.array_equal(local[k], whole[k][..., lo:lo + width]), (r, k)


def test_vgg16_on_the_model_axis_splits_its_biased_convs(worlds):
    """At a model axis of 2 every VGG conv, its bias and its BN split; the
    10-class head too (10 divides by 2)."""
    _, results = worlds[(1, 2)]
    for r, res in enumerate(results):
        local, _ = res["vgg16_local"]
        assert local[".params/0/w"].shape == (3, 3, 3, 32)
        assert local[".params/0/b"].shape == (32,)
        assert local[".params/1/scale"].shape == (32,)
        assert local[".model_state/1/mean"].shape == (32,)
        assert local[".params/45/w"].shape == (512, 5)
