"""The port's GSPMD zoo path against the JAX package on the CPU:
``parallel_cnn_tpu_torch/train/zoo.py``'s ``make_train_step(mesh=...,
model_axis=...)`` (with ``parallel/zoo_sharding.py`` and the mesh-aware
layers) against JAX's ``make_train_step(mesh=..., model_axis=...)`` on a
mesh of the same shape over the 8-device host platform, and against the
port's own single-device step.

Three spawned gloo worlds, every case of a world in one spawn
(``tests/_torch_gspmd_ranks.py``):

- 2 × 1: the two-conv model and the CIFAR CNN, plain and with
  ``accum_steps=2``; the rows each rank crops from the global draws;
  ``zoo.train`` with augmentation, straight and resumed; the CLI's
  ``--mesh-data 2`` job;
- 2 × 2: the two-conv model and ResNet-18 (CIFAR stem, 8x8 images) with
  the model axis; each rank's blocks of the split leaves; a checkpoint
  that JAX restores and the port resumes on one rank;
- 1 × 4, the mixed case: the first conv splits, the second conv and the
  head stay whole, so an adjoint off by the model axis's size shows.

Weights are JAX's init carried across by ``convert.from_jax``, inputs
seeded uniform noise (no max-pool near-ties). Tolerances: after one step
every leaf and the loss within 1e-5 abs + 1e-5 rel; after the second
(momentum) step JAX's own bounds for GSPMD against one device
(``tests/test_zoo_sharding.py``: loss rtol 5e-4, leaves atol 5e-3). The
ranks sum BN statistics and gradients in another order than one device
or XLA does, so the paths agree to rounding, not bit for bit. Bit for
bit: the augmented rows, the ranks of a data-only mesh, resume, the
checkpoint JAX reads."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gspmd_ranks as ranks
from parallel_cnn_tpu.config import MeshConfig as JaxMeshConfig
from parallel_cnn_tpu.nn import cifar as jax_cifar
from parallel_cnn_tpu.nn import core as jax_core
from parallel_cnn_tpu.nn import layers as jax_layers
from parallel_cnn_tpu.nn import resnet as jax_resnet
from parallel_cnn_tpu.parallel import mesh as jax_mesh
from parallel_cnn_tpu.parallel import zoo_sharding as jax_zoo_sharding
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch import plan as pplan
from parallel_cnn_tpu_torch.config import COMM_DATA_ONLY_ERROR, MeshLayoutError
from parallel_cnn_tpu_torch.data import augment as aug_lib
from parallel_cnn_tpu_torch.parallel import distributed, zoo_sharding
from parallel_cnn_tpu_torch.parallel import mesh as mesh_lib
from parallel_cnn_tpu_torch.train import zoo

ATOL = RTOL = 1e-5
LOSS_RTOL_2 = 5e-4
LEAF_ATOL_2 = 5e-3
# ResNet-18's first gradient (its momentum trace after one step) runs
# through 17 BatchNorms, and the order of its f32 sums moves it: JAX's
# single-device step and the port's differ by up to 7e-5 of a leaf's
# largest value (1.3e-4 in a 7th-block conv whose largest is 1.8). It is
# held within DEEP_GRAD_SCALE of max(1, the leaf's largest value); in f64
# the GSPMD step equals one device within F64_ATOL.
DEEP_GRAD_SCALE = 2e-4
F64_ATOL = 1e-10
WORLD_TIMEOUT_S = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_two_conv(widths=(4, 8)):
    a, b = widths
    L = jax_layers
    return jax_core.Sequential([L.Conv2D(a), L.BatchNorm(), L.ReLU(), L.Conv2D(b),
                                L.BatchNorm(), L.ReLU(), L.MaxPool(), L.Flatten(),
                                L.Dense(10)])


JAX_MODELS = {
    "two_conv": _jax_two_conv,
    "mixed": lambda: _jax_two_conv((4, 6)),
    "cifar_cnn": jax_cifar.cifar_cnn,
    "resnet18": lambda: jax_resnet.resnet18(10, cifar_stem=True),
}


def _init(name, seed=0):
    params, state, _ = JAX_MODELS[name]().init(jax.random.key(seed), ranks.SHAPE)
    return jax.tree_util.tree_map(np.asarray, (params, state))


def _sd(init):
    return {k: v.numpy() for k, v in convert.from_jax(*init).items()}


def _batch(seed, n=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n,) + ranks.SHAPE).astype(np.float32)
    return x, rng.integers(0, 10, n).astype(np.int32)


def _jax_steps(name, init, x, y, data, model, accum=1):
    """JAX's GSPMD step on a data × model mesh: the losses and the flat
    state after each of ranks.STEPS steps."""
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=data, model=model))
    opt = jax_zoo.make_optimizer(lr=ranks.LR, momentum=ranks.MOMENTUM)
    params, state = jax.tree_util.tree_map(jnp.asarray, init)
    st = jax_zoo.ZooState(params, state, opt.init(params))
    step = jax_zoo.make_train_step(JAX_MODELS[name](), opt, accum_steps=accum,
                                   mesh=mesh, model_axis=model > 1)
    losses, arrays = [], []
    for _ in range(ranks.STEPS):
        st, loss = step(st, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
        arrays.append({k: np.asarray(v) for k, v in jax_checkpoint._flatten(st).items()})
    return losses, arrays


def _single(name, sd, x, y, accum=1, dtype=torch.float32):
    """The port's single-device step, ranks.STEPS steps."""
    model = ranks.model_from(name, sd, dtype)
    opt = zoo.make_optimizer(ranks.LR, ranks.MOMENTUM)
    state = zoo.init_state(model, opt)
    return ranks.run_steps(state, zoo.make_train_step(model, opt, accum), x, y)


def _assert_steps(got, want, what, grad_scale=None):
    """One step within ATOL + RTOL (with ``grad_scale``, the momentum trace,
    the first gradient, within grad_scale · max(1, its largest value)), the
    second within JAX's bounds."""
    (g_losses, g_arrays), (w_losses, w_arrays) = got, want
    np.testing.assert_allclose(g_losses[0], w_losses[0], atol=ATOL, rtol=RTOL,
                               err_msg=f"{what} loss 1")
    np.testing.assert_allclose(g_losses[1], w_losses[1], rtol=LOSS_RTOL_2,
                               err_msg=f"{what} loss 2")
    for i, (atol, rtol) in enumerate(((ATOL, RTOL), (LEAF_ATOL_2, 0.0))):
        assert sorted(g_arrays[i]) == sorted(w_arrays[i]), what
        for k, v in w_arrays[i].items():
            tol = atol
            if grad_scale is not None and i == 0 and ".trace/" in k:
                tol = grad_scale * max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(g_arrays[i][k], v, atol=tol, rtol=rtol,
                                       err_msg=f"{what} step {i + 1} {k}")


# ---------------------------------------------------------------------------
# World 2 × 1: the data axis, accumulation, augmentation, resume, the CLI
# ---------------------------------------------------------------------------

DP_MODELS = ("two_conv", "cifar_cnn")


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd2")
    inits = {name: _init(name) for name in DP_MODELS}
    x, y = _batch(1)
    tx, ty = _batch(2, 32)
    ex, ey = _batch(3, 12)
    spec = dict(models={n: _sd(i) for n, i in inits.items()}, x=x, y=y, tx=tx, ty=ty,
                ex=ex, ey=ey, straight=str(tmp / "straight"), split=str(tmp / "split"))
    results = distributed.run(ranks.dp_cases, 2, device="cpu", args=(spec,),
                              timeout=WORLD_TIMEOUT_S,
                              plan=pplan.ExecutionPlan(data=2, model=1))
    return inits, spec, results


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", DP_MODELS)
def test_data_axis_step_matches_jax(dp_world, host_devices, name, accum):
    inits, spec, results = dp_world
    want = _jax_steps(name, inits[name], spec["x"], spec["y"], 2, 1, accum)
    for r in range(2):
        _assert_steps(results[r][(name, accum)], want, f"{name} accum {accum} rank {r}")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", DP_MODELS)
def test_data_axis_step_matches_the_single_device_step(dp_world, name, accum):
    """Global BN statistics: two ranks train as one device on the global
    batch (per-rank statistics would not), the running statistics too."""
    _, spec, results = dp_world
    want = _single(name, spec["models"][name], spec["x"], spec["y"], accum)
    for r in range(2):
        _assert_steps(results[r][(name, accum)], want, f"{name} accum {accum} rank {r}")
    assert any(k.startswith(".model_state/") for k in want[1][0])


def test_data_axis_ranks_end_with_the_same_state(dp_world):
    _, _, results = dp_world
    for key in [(n, a) for n in DP_MODELS for a in (1, 2)]:
        (la, aa), (lb, ab) = results[0][key], results[1][key]
        assert la == lb
        assert all(np.array_equal(aa[-1][k], ab[-1][k]) for k in aa[-1]), key


def test_each_rank_crops_its_rows_of_the_global_draws(dp_world):
    """The single-device stream's draws for the global batch, rank r's
    block of microbatch 1 of 2, bit for bit."""
    _, spec, results = dp_world
    offsets, flips = aug_lib.draw(torch.Generator().manual_seed(3), 16, ranks.PAD)
    want = aug_lib.crop_flip(torch.from_numpy(spec["x"]), offsets, flips,
                             ranks.PAD)[8:16].numpy()
    for r in range(2):
        assert np.array_equal(results[r]["aug_rows"], want[4 * r:4 * (r + 1)])


def test_augmented_training_matches_the_single_device(dp_world, tmp_path):
    """zoo.train with augmentation: the same draws, the same epochs."""
    _, spec, results = dp_world
    _, losses = zoo.train(
        ranks.model_from("two_conv", spec["models"]["two_conv"]), spec["tx"],
        spec["ty"], epochs=2, batch_size=8, lr=ranks.LR, augment=True,
        augment_pad=ranks.PAD, seed=1, verbose=False, device="cpu",
        eval_data=(spec["ex"], spec["ey"]), checkpoint_dir=str(tmp_path))
    for res in results:
        np.testing.assert_allclose(res["train_losses"], losses, rtol=LOSS_RTOL_2)
    with np.load(tmp_path / "ckpt_2.npz") as one, \
            np.load(os.path.join(spec["straight"], "ckpt_2.npz")) as two:
        assert sorted(one.files) == sorted(two.files)
        for k in one.files:
            if k != "__meta__":
                np.testing.assert_allclose(two[k], one[k], atol=LEAF_ATOL_2, err_msg=k)


def test_resume_at_world_2_is_bit_identical(dp_world):
    _, spec, _ = dp_world
    with np.load(os.path.join(spec["straight"], "ckpt_2.npz")) as a, \
            np.load(os.path.join(spec["split"], "ckpt_2.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert np.array_equal(a[k], b[k]), k


def test_cli_job_trains_on_the_data_axis(dp_world):
    _, _, results = dp_world
    lines = results[0]["cli"].splitlines()
    epochs = [ln for ln in lines if ln.startswith("epoch ")]
    assert [ln.split(":")[0] for ln in epochs] == ["epoch 1", "epoch 2"]
    assert all(", acc " in ln for ln in epochs)
    assert results[1]["cli"] == ""  # rank 0 alone prints


# ---------------------------------------------------------------------------
# World 2 × 2: the model axis with the data axis
# ---------------------------------------------------------------------------

HYBRID_MODELS = ("two_conv", "resnet18")
GRAD_SCALE = {"two_conv": None, "resnet18": DEEP_GRAD_SCALE}


@pytest.fixture(scope="module")
def hybrid_world(tmp_path_factory):
    inits = {name: _init(name, 1) for name in HYBRID_MODELS}
    x, y = _batch(4, 8)
    spec = dict(models={n: _sd(i) for n, i in inits.items()}, x=x, y=y,
                ckpt=str(tmp_path_factory.mktemp("gspmd22") / "ckpt_2.npz"))
    results = distributed.run(ranks.hybrid_cases, 4, device="cpu", args=(spec,),
                              timeout=WORLD_TIMEOUT_S,
                              plan=pplan.ExecutionPlan(data=2, model=2))
    return inits, spec, results


@pytest.mark.parametrize("name", HYBRID_MODELS)
def test_hybrid_step_matches_jax(hybrid_world, host_devices, name):
    inits, spec, results = hybrid_world
    want = _jax_steps(name, inits[name], spec["x"], spec["y"], 2, 2)
    for r in range(4):
        _assert_steps(results[r][name], want, f"{name} rank {r}", GRAD_SCALE[name])


@pytest.mark.parametrize("name", HYBRID_MODELS)
def test_hybrid_step_matches_the_single_device_step(hybrid_world, name):
    _, spec, results = hybrid_world
    want = _single(name, spec["models"][name], spec["x"], spec["y"])
    for r in range(4):
        _assert_steps(results[r][name], want, f"{name} rank {r}", GRAD_SCALE[name])


def test_hybrid_resnet18_in_f64_is_the_single_device_step(hybrid_world):
    _, spec, results = hybrid_world
    want_losses, want_arrays = _single("resnet18", spec["models"]["resnet18"],
                                       spec["x"].astype(np.float64), spec["y"],
                                       dtype=torch.float64)
    for r, res in enumerate(results):
        losses, arrays = res["resnet18_f64"]
        np.testing.assert_allclose(losses, want_losses, atol=ATOL, rtol=RTOL)  # f32 CE
        for i in range(ranks.STEPS):
            for k, v in want_arrays[i].items():
                assert arrays[i][k].dtype == np.float64
                np.testing.assert_allclose(arrays[i][k], v, atol=F64_ATOL, rtol=0,
                                           err_msg=f"rank {r} step {i + 1} {k}")


@pytest.mark.parametrize("name", HYBRID_MODELS)
def test_each_rank_holds_its_block_of_every_divisible_leaf(hybrid_world, name):
    """Rank (d, m) holds block m of 2 of every leaf whose trailing axis
    divides (params, BN statistics, momentum), each a contiguous tensor of
    its own, and every other leaf whole."""
    _, _, results = hybrid_world
    kinds = set()
    for r, res in enumerate(results):
        whole = res[name][1][-1]
        local, own = res[f"{name}_local"]
        m = r % 2
        assert sorted(local) == sorted(whole)
        for k, w in whole.items():
            assert own[k], (r, k)
            if w.ndim and w.shape[-1] % 2 == 0:
                h = w.shape[-1] // 2
                assert local[k].shape == w.shape[:-1] + (h,), (r, k)
                assert np.array_equal(local[k], w[..., m * h:(m + 1) * h]), (r, k)
                kinds.add(k.split("/")[0])
            else:
                assert np.array_equal(local[k], w), (r, k)
    assert kinds == {".params", ".model_state", ".opt_state"}


def test_hybrid_checkpoint_restores_in_jax(hybrid_world):
    """The file rank 0 wrote from the gathered leaves is JAX's ZooState."""
    inits, spec, results = hybrid_world
    opt = jax_zoo.make_optimizer(lr=ranks.LR, momentum=ranks.MOMENTUM)
    params, state = jax.tree_util.tree_map(jnp.asarray, inits["two_conv"])
    template = jax_zoo.ZooState(params, state, opt.init(params))
    restored, tstate = jax_checkpoint.restore(spec["ckpt"], template)
    assert tstate.epoch == ranks.STEPS
    flat = jax_checkpoint._flatten(restored)
    want = results[0]["two_conv"][1][-1]
    assert sorted(flat) == sorted(want)
    for k, v in flat.items():
        assert np.array_equal(np.asarray(v), want[k]), k


def test_hybrid_checkpoint_resumes_on_one_rank(hybrid_world):
    """The 2 × 2 file resumed on a 1 × 1 mesh: the next step as the
    2 × 2 world took it, within one step's tolerance."""
    _, spec, results = hybrid_world
    (epoch, got), = distributed.run(
        ranks.resume_on_one, 1, device="cpu",
        plan=pplan.ExecutionPlan(data=1, model=1),
        args=(dict(spec, sd=spec["models"]["two_conv"]),))
    assert epoch == ranks.STEPS
    for res in results:
        (w_losses, w_arrays) = res["after_ckpt"]
        np.testing.assert_allclose(got[0], w_losses, atol=ATOL, rtol=RTOL)
        for k, v in w_arrays[0].items():
            np.testing.assert_allclose(got[1][0][k], v, atol=ATOL, rtol=RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# World 1 × 4: the mixed case
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_world():
    init = _init("mixed", 2)
    x, y = _batch(5, 8)
    spec = dict(sd=_sd(init), x=x, y=y)
    results = distributed.run(ranks.mixed_cases, 4, device="cpu", args=(spec,),
                              timeout=WORLD_TIMEOUT_S,
                              plan=pplan.ExecutionPlan(data=1, model=4))
    return init, spec, results


def test_mixed_step_matches_jax(mixed_world, host_devices):
    init, spec, results = mixed_world
    want = _jax_steps("mixed", init, spec["x"], spec["y"], 1, 4)
    for r in range(4):
        _assert_steps(results[r][True], want, f"mixed rank {r}")


@pytest.mark.parametrize("model_axis", [True, False], ids=["split", "replicated"])
def test_mixed_step_matches_the_single_device_step(mixed_world, model_axis):
    """A wrong adjoint gives grads off by exactly 4 in the first conv (or
    in the second conv and the head): far outside the bound."""
    _, spec, results = mixed_world
    want = _single("mixed", spec["sd"], spec["x"], spec["y"])
    for r in range(4):
        _assert_steps(results[r][model_axis], want, f"mixed rank {r}")


def test_mixed_split_and_replicated_leaves(mixed_world):
    """At a model axis of 4 the first conv and its BN split (one channel a
    rank); the second conv (6 filters), its BN and the head stay whole."""
    _, _, results = mixed_world
    for r, res in enumerate(results):
        local, _ = res[(True, "local")]
        assert local[".params/0/w"].shape == (3, 3, 3, 1)
        assert local[".model_state/1/mean"].shape == (1,)
        assert local[".params/3/w"].shape == (3, 3, 4, 6)
        assert local[".params/4/scale"].shape == (6,)
        assert local[".params/8/w"].shape == (96, 10)
        whole = res[True][1][-1]
        assert np.array_equal(local[".params/0/w"], whole[".params/0/w"][..., r:r + 1])
        local_off, _ = res[(False, "local")]
        assert local_off[".params/0/w"].shape == (3, 3, 3, 4)


# ---------------------------------------------------------------------------
# No spawn: the leaf rule, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,model_size", [
    ((3, 3, 16, 32), 2), ((64,), 4), ((512, 10), 4), ((), 2), ((8,), 1),
    ((10,), 2), ((0,), 2), ((3, 3, 4, 6), 4),
])
def test_leaf_spec_is_jaxs(shape, model_size):
    """JAX's cases (tests/test_zoo_sharding.py) and a few more: the split
    dimension is where JAX's PartitionSpec puts the model axis."""
    spec = jax_zoo_sharding.leaf_spec(jnp.zeros(shape), model_size)
    want = next((i for i, a in enumerate(spec) if a == jax_mesh.MODEL_AXIS), None)
    assert zoo_sharding.leaf_spec(torch.zeros(shape), model_size) == want


def test_a_one_rank_mesh_keeps_the_module_whole_and_refuses_a_second_placement():
    model = ranks.two_conv()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = mesh_lib.make_mesh_2d(0, 1, torch.device("cpu"), 1, 1)
    plan = zoo_sharding.shard_model(model, m, model_axis=True)
    assert plan.model is None and plan.split == {} and plan.whole is None
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert all(layer.sharding is not None and not layer.sharding.split
               for layer in model)
    with pytest.raises(ValueError, match="already placed"):
        zoo_sharding.shard_model(model, m, model_axis=True)
    with pytest.raises(ValueError, match="built for the same mesh"):
        zoo.make_train_step(model, zoo.make_optimizer(), mesh=m)(
            zoo.init_state(ranks.two_conv(), zoo.make_optimizer()),
            torch.zeros((2,) + ranks.SHAPE), torch.zeros(2, dtype=torch.long))


def test_cli_trains_a_2x2_mesh_and_refuses_the_ring_on_it():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"  # test workers share the machine
    argv = ["--device", "cpu", "--model", "cifar_cnn", "--mesh-data", "2",
            "--mesh-model", "2", "--batch-size", "16", "--epochs", "2",
            "--synthetic-train-count", "64", "--synthetic-test-count", "32"]
    proc = subprocess.run([sys.executable, "-m", "parallel_cnn_tpu_torch", *argv],
                          capture_output=True, text=True, timeout=WORLD_TIMEOUT_S,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "mesh: {'data': 2, 'model': 2}"
    losses = [float(ln.split()[3].rstrip(",")) for ln in lines if ln.startswith("epoch ")]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "falling back" not in proc.stdout
    with pytest.raises(MeshLayoutError) as info:
        cli.main(argv + ["--comm-impl", "ring"])
    assert str(info.value) == COMM_DATA_ONLY_ERROR
