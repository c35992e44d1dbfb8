"""Slice 3, zoo training, against the JAX package on the CPU: train-mode
BatchNorm, the optimizer (optax's SGD with momentum, schedules, weight
decay), one full-width ResNet-18 step through the Pallas conv kernels
(interpret mode), fused-tail CIFAR-CNN steps, gradient accumulation, a
two-epoch trajectory, checkpoints both ways, augmentation, eval after
training and the CLI. Weights cross over through ``convert``; inputs are
numpy arrays from a seed. Tolerances are JAX's own where it states them
(test_pallas_conv.py: loss 1e-5, params 5e-4 after a ResNet step).

The parity runs use gentle learning rates: at init these nets amplify f32
rounding from step to step (f32 against f64 on the CPU, ResNet-18 at
batch 64: 1e-3 in the third step's loss at lr 0.01, 9e-6 at lr 0.001)."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parallel_cnn_tpu.config import FusedStepConfig as JaxFusedStepConfig
from parallel_cnn_tpu.data import augment as jax_augment
from parallel_cnn_tpu.data import synthetic as jax_synthetic
from parallel_cnn_tpu.nn import cifar as jax_cifar
from parallel_cnn_tpu.nn import layers as jax_layers
from parallel_cnn_tpu.nn import resnet as jax_resnet
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch.config import (
    FusedStepConfig,
    MeshLayoutError,
    NotPortedError,
    ResilienceConfig,
)
from parallel_cnn_tpu_torch.data import augment, synthetic
from parallel_cnn_tpu_torch.nn import BatchNorm, Dense, cifar, resnet
from parallel_cnn_tpu_torch.resilience.sentinel import DivergenceError
from parallel_cnn_tpu_torch.train import zoo
from parallel_cnn_tpu_torch.utils.backend import NoGpuError

LOSS_ATOL = 1e-5
PARAM_ATOL = 5e-4
STATE_ATOL = 1e-5
TRAJ_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(build, params, state):
    model = build()
    model.load_state_dict(convert.from_jax(params, state))
    return model


def _assert_state_close(port_state, jax_state):
    """Params within PARAM_ATOL, BN running statistics within STATE_ATOL.
    (The momentum is a gradient, which a flipped near-tie moves by more;
    test_optimizer_matches_optax holds the optimizer state itself.)"""
    got = {k: v for k, v in convert.zoo_to_jax(port_state).items()
           if not k.startswith(".opt_state")}
    want = {k: v for k, v in jax_checkpoint._flatten(jax_state).items()
            if not k.startswith(".opt_state")}
    assert sorted(got) == sorted(want)
    for k in want:
        atol = STATE_ATOL if k.startswith(".model_state") else PARAM_ATOL
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


# The CIFAR CNN's parity runs take 8x8 images (its widths unchanged): fewer
# pooling windows, so fewer near-ties (below) per step.
SMALL = (8, 8, 3)


def _cifar_batch(n, seed, shape=SMALL):
    """Uniform noise images with random labels. Not the synthetic set for
    the max-pool nets: its clipped, 4x-upsampled plateaus give pooling
    windows whose values tie up to rounding, and each framework's rounding
    then picks its own maximum (a different, equally valid gradient; one
    such flip moved a conv weight's gradient by 7% in a CIFAR-CNN step)."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0.0, 1.0, (n, *shape)).astype(np.float32)
    return imgs, rng.integers(0, 10, n).astype(np.int32)


# ---------------------------------------------------------------------------
# Data, BatchNorm, optimizer
# ---------------------------------------------------------------------------


def test_image_dataset_is_bit_identical_to_jax():
    for kw in (dict(count=37, seed=5), dict(count=8, hw=(10, 14), channels=2)):
        ri, rl = jax_synthetic.make_image_dataset(**kw)
        gi, gl = synthetic.make_image_dataset(**kw)
        assert gi.dtype == ri.dtype and gl.dtype == rl.dtype
        assert np.array_equal(gi, ri) and np.array_equal(gl, rl)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 3, 5, 6)) * 2 + 0.5).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    state = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    y_ref, st_ref = jax_layers.BatchNorm().apply(params, state, jnp.asarray(x), train)
    bn = BatchNorm(6)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **state}.items()})
    bn.train(train)
    y = bn(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=STATE_ATOL)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(st_ref["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(st_ref["var"]), atol=1e-6)


def test_batchnorm_is_not_torch_batchnorm():
    """Biased batch variance in the running statistics, and momentum 0.9
    weighting the OLD value: nn.BatchNorm2d keeps the unbiased variance and
    reads momentum as the weight of the new one."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 2, 2, 3)).astype(np.float32))
    bn = BatchNorm(3)
    assert not isinstance(bn, torch.nn.modules.batchnorm._BatchNorm)
    bn.train()
    bn(x)
    flat = x.reshape(-1, 3)
    biased = flat.var(dim=0, unbiased=False)
    torch.testing.assert_close(bn.var, 0.9 * torch.ones(3) + 0.1 * biased)
    torch.testing.assert_close(bn.mean, 0.1 * flat.mean(dim=0))
    ref = torch.nn.BatchNorm2d(3, momentum=0.9)  # as if momentum meant the same
    ref(x.permute(0, 3, 1, 2))
    assert not torch.allclose(ref.running_var, bn.var, atol=1e-3)
    assert not torch.allclose(ref.running_mean, bn.mean, atol=1e-3)


OPT_CASES = {
    "constant": dict(),
    "warmup": dict(warmup_steps=5),
    "cosine": dict(schedule="cosine", warmup_steps=3, total_steps=20),
    "weight-decay": dict(weight_decay=1e-3),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = OPT_CASES[case]
    rng = np.random.default_rng(3)
    dense = Dense(6, 4)
    params = {"w": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    dense.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    tx = jax_zoo.make_optimizer(0.1, **kw)
    opt = zoo.make_optimizer(0.1, **kw)
    ost = tx.init(params)
    state = zoo.init_state(dense, opt)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for _ in range(20):
        grads = {"w": rng.standard_normal((6, 4)).astype(np.float32),
                 "b": rng.standard_normal(4).astype(np.float32)}
        updates, ost = tx.update(grads, ost, jparams)
        jparams = optax.apply_updates(jparams, updates)
        with torch.no_grad():
            opt.apply(state, [torch.from_numpy(grads["w"]), torch.from_numpy(grads["b"])])
    np.testing.assert_allclose(dense.w.detach().numpy(), np.asarray(jparams["w"]), atol=1e-6)
    np.testing.assert_allclose(dense.b.detach().numpy(), np.asarray(jparams["b"]), atol=1e-6)
    jax_arrays = jax_checkpoint._flatten(ost)
    port_arrays = {k[len(".opt_state/"):]: v for k, v in convert.zoo_to_jax(state).items()
                   if k.startswith(".opt_state/")}
    assert sorted(port_arrays) == sorted(jax_arrays)
    for k, v in jax_arrays.items():
        np.testing.assert_allclose(port_arrays[k], v, atol=1e-6, err_msg=k)


def test_cosine_needs_its_horizon():
    with pytest.raises(ValueError, match="total_steps"):
        zoo.make_optimizer(0.1, schedule="cosine")
    with pytest.raises(ValueError, match="unknown schedule"):
        zoo.make_optimizer(0.1, schedule="step")


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def test_resnet18_step_matches_jax_pallas():
    """One step of full-width ResNet-18, every conv on the JAX side
    through the Pallas kernels (interpret mode), the port's through the
    plain versions of the forward, dgrad and wgrad kernels."""
    imgs, labels = jax_synthetic.make_image_dataset(8, hw=(16, 16), seed=0)
    jm = jax_resnet.resnet18(10, cifar_stem=True, conv_backend="pallas")
    jopt = jax_zoo.make_optimizer(0.05)
    jst = jax_zoo.init_state(jm, jax.random.key(0), (16, 16, 3), jopt)
    pm = _port_model(lambda: resnet.resnet18(10, backend="cuda"),
                     _np(jst.params), _np(jst.model_state))
    jst, jloss = jax_zoo.make_train_step(jm, jopt)(jst, jnp.asarray(imgs),
                                                   jnp.asarray(labels))
    state = zoo.init_state(pm, zoo.make_optimizer(0.05))
    loss = zoo.make_train_step(pm, state.optimizer)(
        state, torch.from_numpy(imgs), torch.from_numpy(labels).long())
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    _assert_state_close(state, jst)


def _small_cnn(**kw):
    return cifar.cifar_cnn(in_shape=SMALL, **kw)


def _cifar_pair(seed=0):
    jm = jax_cifar.cifar_cnn()
    params, mstate, _ = jm.init(jax.random.key(seed), SMALL)
    pm = _port_model(_small_cnn, _np(params), _np(mstate))
    return jm, params, mstate, pm


def test_cifar_cnn_fused_tail_steps_match_jax():
    """Three --fused-step (f32, fused max2 tail) steps of the CIFAR CNN."""
    imgs, labels = _cifar_batch(48, 1)
    jm, params, mstate, pm = _cifar_pair()
    jopt = jax_zoo.make_optimizer(0.01)
    jst = jax_zoo.ZooState(params, mstate, jopt.init(params))
    jstep = jax_zoo.make_train_step(
        jm, jopt, fused=JaxFusedStepConfig(update=False, act_dtype="float32"))
    state = zoo.init_state(pm, zoo.make_optimizer(0.01))
    step = zoo.make_train_step(pm, state.optimizer,
                               fused=FusedStepConfig(update=False, act_dtype="float32"))
    for i in range(3):
        sl = slice(16 * i, 16 * (i + 1))
        jst, jloss = jstep(jst, jnp.asarray(imgs[sl]), jnp.asarray(labels[sl]))
        loss = step(state, torch.from_numpy(imgs[sl]),
                    torch.from_numpy(labels[sl]).long())
        assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    _assert_state_close(state, jst)


def test_grad_accumulation_matches_jax():
    """accum_steps=2: the mean of the microbatch grads and losses, the BN
    state threaded through both microbatches."""
    imgs, labels = _cifar_batch(16, 2)
    jm, params, mstate, pm = _cifar_pair(1)
    jopt = jax_zoo.make_optimizer(0.01)
    jst = jax_zoo.ZooState(params, mstate, jopt.init(params))
    jst, jloss = jax_zoo.make_train_step(jm, jopt, accum_steps=2)(
        jst, jnp.asarray(imgs), jnp.asarray(labels))
    state = zoo.init_state(pm, zoo.make_optimizer(0.01))
    loss = zoo.make_train_step(pm, state.optimizer, accum_steps=2)(
        state, torch.from_numpy(imgs), torch.from_numpy(labels).long())
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    _assert_state_close(state, jst)
    with pytest.raises(ValueError, match="multiple of accum_steps"):
        zoo.make_train_step(pm, state.optimizer, accum_steps=3)(
            state, torch.from_numpy(imgs), torch.from_numpy(labels).long())


# ---------------------------------------------------------------------------
# Epochs and checkpoints (native-loader batch order, shared by both)
# ---------------------------------------------------------------------------

TRAIN_KW = dict(batch_size=16, lr=0.01, warmup_steps=2, seed=0,
                loader="native", verbose=False)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX zoo.train on 64 images: two straight epochs, and a run stopped
    after epoch 1 with its checkpoint."""
    imgs, labels = _cifar_batch(64, 5)
    kw = dict(in_shape=SMALL, **TRAIN_KW)
    straight, losses = jax_zoo.train(jax_cifar.cifar_cnn(), imgs, labels,
                                     epochs=2, **kw)
    ckdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    jax_zoo.train(jax_cifar.cifar_cnn(), imgs, labels, epochs=1,
                  checkpoint_dir=ckdir, **kw)
    return imgs, labels, straight, losses, ckdir


def _port_cifar_from_jax_init():
    params, mstate, _ = jax_cifar.cifar_cnn().init(jax.random.key(0), SMALL)
    return _port_model(_small_cnn, _np(params), _np(mstate))


def test_two_epoch_trajectory_matches_jax(jax_runs):
    imgs, labels, straight, losses, _ = jax_runs
    state, got = zoo.train(_port_cifar_from_jax_init(), imgs, labels, epochs=2,
                           device="cpu", **TRAIN_KW)
    np.testing.assert_allclose(got, losses, atol=TRAJ_ATOL)
    _assert_state_close(state, straight)


def test_jax_checkpoint_resumes_in_the_port(jax_runs, tmp_path):
    """The port restores the full ZooState JAX wrote (params, BN stats,
    momentum, schedule count) and its next epoch is JAX's second."""
    imgs, labels, _, losses, ckdir = jax_runs
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, got = zoo.train(_small_cnn(), imgs, labels, epochs=2,
                           checkpoint_dir=ckdir, resume=True, device="cpu",
                           **{**TRAIN_KW, "verbose": True})
    assert "resumed from" in out.getvalue()
    assert len(got) == 2 and got[0] == losses[0]
    assert abs(got[1] - losses[1]) <= TRAJ_ATOL


def test_port_checkpoint_restores_in_jax(tmp_path):
    imgs, labels = _cifar_batch(32, 6)
    state, _ = zoo.train(_small_cnn(), imgs, labels, epochs=1,
                         checkpoint_dir=str(tmp_path), device="cpu",
                         weight_decay=1e-4, **TRAIN_KW)
    jopt = jax_zoo.make_optimizer(0.01, weight_decay=1e-4, warmup_steps=2)
    template = jax_zoo.init_state(jax_cifar.cifar_cnn(), jax.random.key(1),
                                  SMALL, jopt)
    restored, tstate = jax_checkpoint.restore(str(tmp_path / "ckpt_1.npz"), template)
    assert tstate.epoch == 1
    got = jax_checkpoint._flatten(restored)
    want = convert.zoo_to_jax(state)
    assert sorted(got) == sorted(want) and int(got[".opt_state/1/1/.count"]) == 2
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # And back: the JAX tree loads into a fresh port state, leaf for leaf.
    fresh = zoo.init_state(_small_cnn(), state.optimizer)
    convert.zoo_from_jax(fresh, _np(restored))
    assert all(np.array_equal(v, want[k])
               for k, v in convert.zoo_to_jax(fresh).items())


def test_kill_and_resume_equals_the_straight_run(tmp_path):
    """Device loader and augmentation: the resumed run is bit-identical to
    the straight one (the batches and draws are seeded by the epoch)."""
    imgs, labels = _cifar_batch(32, 7)
    kw = dict(batch_size=16, lr=0.01, augment=True, seed=3, verbose=False,
              device="cpu", lr_schedule="cosine")
    build = lambda: _small_cnn(generator=torch.Generator().manual_seed(3))  # noqa: E731
    straight, s_losses = zoo.train(build(), imgs, labels, epochs=2, **kw)
    # A two-epoch run (the same cosine horizon) killed after its epoch 1:
    # its second checkpoint never got written.
    ck = tmp_path / "ck"
    zoo.train(build(), imgs, labels, epochs=2, checkpoint_dir=str(ck), **kw)
    os.remove(ck / "ckpt_2.npz")
    resumed, r_losses = zoo.train(build(), imgs, labels, epochs=2,
                                  checkpoint_dir=str(ck), resume=True, **kw)
    assert r_losses == s_losses
    a, b = straight.arrays(), resumed.arrays()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_sentinel_raises_or_skips_a_diverged_epoch():
    imgs, labels = _cifar_batch(32, 8)
    kw = dict(batch_size=16, lr=1e12, verbose=False, device="cpu")
    with pytest.raises(DivergenceError):
        zoo.train(_small_cnn(), imgs, labels,
                  resilience=ResilienceConfig(policy="raise"), **kw)
    model = _small_cnn()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, losses = zoo.train(model, imgs, labels,
                              resilience=ResilienceConfig(policy="skip"), **kw)
    assert losses == []
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


# ---------------------------------------------------------------------------
# Augmentation, eval
# ---------------------------------------------------------------------------


def test_crop_flip_equals_numpy():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 6, 7, 2)).astype(np.float32)
    offsets = rng.integers(0, 7, (5, 2))
    flips = rng.random(5) < 0.5
    got = augment.crop_flip(torch.from_numpy(x), torch.from_numpy(offsets),
                            torch.from_numpy(flips), pad=3).numpy()
    xp = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)))
    for i in range(5):
        want = xp[i, offsets[i, 0]:offsets[i, 0] + 6, offsets[i, 1]:offsets[i, 1] + 7]
        if flips[i]:
            want = want[:, ::-1]
        assert np.array_equal(got[i], want)


def test_random_crop_flip_contract():
    """The contract of JAX's test_augment_random_crop_flip_contract: shape
    and dtype kept, seeded determinism, pad=0 is flip-only, crops are
    translations of the zero-padded input in [-pad, pad]."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(8, 16, 16, 3)).astype(np.float32))
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    out = augment.random_crop_flip(gen(7), x, pad=2)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.equal(out, augment.random_crop_flip(gen(7), x, pad=2))
    assert not torch.equal(out, augment.random_crop_flip(gen(8), x, pad=2))
    f = augment.random_crop_flip(gen(7), x, pad=0)
    for i in range(8):
        assert torch.equal(f[i], x[i]) or torch.equal(f[i], x[i].flip(1))
    ramp = (torch.arange(16)[:, None] * 100 + torch.arange(16)[None, :]).float()
    c = augment.random_crop_flip(gen(3), ramp[None, :, :, None].expand(4, 16, 16, 1)
                                 .contiguous(), pad=2)
    for i in range(4):
        img = c[i, :, :, 0]
        found = False
        for cand in (img, img.flip(1)):
            v = int(cand[8, 8])
            dy, dx = v // 100 - 8, v % 100 - 8
            if abs(dy) <= 2 and abs(dx) <= 2 and int(cand[9, 9]) == v + 101:
                found = True
        assert found
    # JAX's augment is the same transform (its own draws): shapes agree.
    j = jax_augment.random_crop_flip(jax.random.key(0), jnp.asarray(x.numpy()), pad=2)
    assert j.shape == tuple(out.shape)


def test_eval_after_training_uses_fresh_folds():
    """After a train step, the eval forward through conv2d_fused (BN
    folded, the fold cached) equals the unfused eval forward of the same
    weights: the optimizer's and BN's in-place updates invalidate the
    cache."""
    imgs, labels = jax_synthetic.make_image_dataset(8, hw=(8, 8), seed=10)
    gen = torch.Generator().manual_seed(5)
    model = resnet.resnet18(10, backend="cuda", generator=gen)
    x = torch.from_numpy(imgs)
    model.eval()
    with torch.no_grad():
        model(x)  # fills every fold cache
    state = zoo.init_state(model, zoo.make_optimizer(0.05))
    zoo.make_train_step(model, state.optimizer)(state, x, torch.from_numpy(labels).long())
    unfused = resnet.resnet18(10, backend="torch")
    unfused.load_state_dict(model.state_dict())
    model.eval()
    unfused.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), unfused(x), rtol=1e-4, atol=1e-4)
    acc = zoo.evaluate(model, x, torch.from_numpy(labels).long(), batch_size=3)
    assert 0.0 <= acc <= 100.0 and not model.training


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

CLI_BASE = ["--device", "cpu", "--batch-size", "16", "--synthetic-train-count",
            "64", "--synthetic-test-count", "32"]


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_cli_trains_resnet18_on_the_kernel_backend(tmp_path):
    metrics = tmp_path / "m.jsonl"
    rc, out = _cli(CLI_BASE + ["--model", "resnet18", "--conv-backend", "cuda",
                               "--epochs", "2", "--metrics", str(metrics)])
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    assert [ln.split(":")[0] for ln in lines] == ["epoch 1", "epoch 2"]
    assert all(", acc " in ln and ln.endswith("s)") for ln in lines)
    recs = [json.loads(ln) for ln in open(metrics)]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert all(r["event"] == "zoo_epoch" and "accuracy" in r for r in recs)


def test_cli_cifar_cnn_fused_step_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    args = CLI_BASE + ["--model", "cifar_cnn", "--fused-step", "--act-dtype",
                       "float32", "--lr", "0.01", "--checkpoint-dir", ck]
    rc, out = _cli(args + ["--epochs", "1"])
    assert rc == 0 and "falling back to fused tail only" in out
    rc, out = _cli(args + ["--epochs", "2", "--resume"])
    assert rc == 0 and "resumed from" in out and "epoch 2:" in out
    assert "epoch 1:" not in out


@pytest.mark.parametrize("argv", [
    ["--fused-step"],
    ["--fused-step", "--act-dtype", "bfloat16"],
], ids=["fused-default-bf16", "bf16"])
def test_cli_trains_the_bf16_fused_step(argv):
    """``--fused-step`` (bf16, JAX's default) and its explicit form train
    ResNet-18 on the kernels' plain twins for two epochs."""
    rc, out = _cli(CLI_BASE + ["--model", "resnet18", "--conv-backend", "cuda",
                               "--epochs", "2"] + argv)
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    assert [ln.split(":")[0] for ln in lines] == ["epoch 1", "epoch 2"]
    losses = [float(ln.split("loss ")[1].split(",")[0]) for ln in lines]
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("argv,err,item", [
    (["--model", "resnet18", "--act-dtype", "float32"], SystemExit, None),
    # The explicit collectives refuse a model axis (JAX's data-only error);
    # comm without a mesh has nothing to run over.
    (["--model", "resnet18", "--mesh-model", "2", "--comm-impl", "ring"],
     MeshLayoutError, "data-parallel only"),
    (["--model", "resnet18", "--comm-impl", "ring"], SystemExit, None),
    (["--model", "cifar_cnn", "--conv-backend", "cuda"], SystemExit, None),
    (["--model", "resnet18", "--batch-size", "1"], SystemExit, None),
], ids=["act-without-fused", "mesh", "comm", "cifar-kernels", "per-sample"])
def test_cli_refuses_what_is_not_ported(argv, err, item):
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(err) as info:
        cli.main(["--device", "cpu"] + argv)
    if err in (NotPortedError, MeshLayoutError):
        assert item in str(info.value)


def test_cli_needs_a_gpu_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(NoGpuError):
        cli.main(["--model", "cifar_cnn", "--synthetic-train-count", "32",
                  "--synthetic-test-count", "8", "--batch-size", "16"])
