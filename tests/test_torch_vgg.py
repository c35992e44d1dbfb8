"""VGG-16 (configuration D) in the port against the JAX package on the CPU,
and the CLI lines that train and serve VGG-16 and ResNet-50.

Weights are JAX's init and cross over through ``convert.from_jax``; JAX's
eval forwards run under ``jax.jit``; inputs are uniform noise from a seed (VGG's ReLU → MaxPool windows tie exactly only at zeros, whose
gradient the ReLU stops; noise keeps other near-ties away). The port's
``"cuda"`` backend runs the plain versions of the conv kernels on CPU
tensors, JAX its ``"xla"`` backend. Tolerances (f32): eval logits within
1e-4 · max(1, max|logit|) through 13 convs; one train step's loss within
1e-5 and its params within 5e-4 (the zoo's ResNet-18 step bounds); the
fused tail against the unfused composition within 1e-5 (one CE in another
order)."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.config import FusedStepConfig as JaxFusedStepConfig
from parallel_cnn_tpu.nn import vgg as jax_vgg
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch.config import FusedStepConfig
from parallel_cnn_tpu_torch.nn import Conv2D, resnet, vgg
from parallel_cnn_tpu_torch.ops import tail
from parallel_cnn_tpu_torch.train import zoo

LOGIT_RTOL = 1e-4
LOSS_ATOL = 1e-5
PARAM_ATOL = 5e-4
TAIL_ATOL = 1e-5
LR = 0.01
FUSED = FusedStepConfig(update=False, act_dtype="float32")
JAX_FUSED = JaxFusedStepConfig(update=False, act_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _noise(n, seed, shape=(32, 32, 3)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n,) + shape).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _pair(cifar_head=True, seed=0):
    jm = jax_vgg.vgg16(10, cifar_head=cifar_head)
    params, state, _ = jm.init(jax.random.key(seed), (32, 32, 3))
    params, state = _np(params), _np(state)
    pm = vgg.vgg16(10, cifar_head=cifar_head, in_shape=(32, 32, 3))
    pm.load_state_dict(convert.from_jax(params, state))
    return jm, params, state, pm


def _jax_eval(module, params, state, x):
    return np.asarray(jax.jit(lambda p, s, xx: module.apply(p, s, xx, train=False)[0])(
        params, state, jnp.asarray(x)))


def _assert_state_close(port_state, jax_state):
    got = {k: v for k, v in convert.zoo_to_jax(port_state).items()
           if not k.startswith(".opt_state")}
    want = {k: np.asarray(v) for k, v in jax_checkpoint._flatten(jax_state).items()
            if not k.startswith(".opt_state")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("batch_norm,count", [(False, 138_357_544),
                                              (True, 138_365_992)])
def test_vgg16_param_counts_are_torchvisions(batch_norm, count):
    """JAX's tests/test_zoo.py counts, at 224² with the full head; the
    module tree is JAX's, leaf for leaf."""
    model = vgg.vgg16(1000, batch_norm=batch_norm, cifar_head=False)
    assert resnet.num_params(model) == count
    tree = jax.eval_shape(lambda: jax_vgg.vgg16(
        1000, batch_norm=batch_norm, cifar_head=False).init(
            jax.random.key(0), (224, 224, 3))[:2])
    want = convert.from_jax(*jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), tree))
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(isinstance(m, Conv2D) and m.b is not None for m in model) == 13


def test_vgg16_eval_logits_match_jax():
    """Running statistics (random), 13 biased convs through the forward
    kernel's plain version."""
    jm, params, state, _ = _pair()
    rng = np.random.default_rng(4)
    state = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), state)
    pm = vgg.vgg16(10)
    pm.load_state_dict(convert.from_jax(params, state))
    x, _ = _noise(4, 1)
    want = _jax_eval(jm, params, state, x)
    with torch.inference_mode():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want,
                               atol=LOGIT_RTOL * max(1.0, float(np.abs(want).max())))
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused-tail"])
def test_vgg16_train_step_matches_jax(fused):
    """One step at b4, 32², lr 0.01: the loss, the params and the BN
    statistics; with the fused tail's ``gap`` mode over 512 features on
    both sides."""
    jm, params, state, pm = _pair(seed=1)
    x, y = _noise(4, 2)
    jopt = jax_zoo.make_optimizer(LR)
    jst = jax_zoo.ZooState(params, state, jopt.init(params))
    jst, jloss = jax_zoo.make_train_step(jm, jopt, fused=JAX_FUSED if fused else None)(
        jst, jnp.asarray(x), jnp.asarray(y))
    st = zoo.init_state(pm, zoo.make_optimizer(LR))
    loss = zoo.make_train_step(pm, st.optimizer, fused=FUSED if fused else None)(
        st, torch.from_numpy(x), torch.from_numpy(y).long())
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    _assert_state_close(st, jst)


def test_fused_gap_tail_equals_the_unfused_composition():
    """The CIFAR head is GAP → Dense, the tail's ``gap`` mode: the same
    loss and gradients as the composed head."""
    assert tail.split_tail(vgg.vgg16(10)) == tail.TailSplit(len(vgg.vgg16(10)) - 2, "gap")
    _, params, state, _ = _pair(seed=2)
    x, y = _noise(4, 3)
    results = []
    for fused in (None, FUSED):
        pm = vgg.vgg16(10)
        pm.load_state_dict(convert.from_jax(params, state))
        st = zoo.init_state(pm, zoo.make_optimizer(LR))
        loss = zoo.make_train_step(pm, st.optimizer, fused=fused)(
            st, torch.from_numpy(x), torch.from_numpy(y).long())
        results.append((float(loss), {k: v.detach().clone()
                                      for k, v in pm.state_dict().items()}))
    (l0, s0), (l1, s1) = results
    assert abs(l0 - l1) <= TAIL_ATOL
    for k, v in s0.items():
        torch.testing.assert_close(s1[k], v, atol=TAIL_ATOL, rtol=0, msg=k)


def test_full_head_runs_unfused_as_jax_does(capsys):
    """Flatten → 4096 → ReLU → 4096 → ReLU → Dense has no fusable suffix:
    the fused step keeps the unfused tail, with JAX's note, and takes
    JAX's step."""
    assert tail.split_tail(vgg.vgg16(10, cifar_head=False, in_shape=(32, 32, 3))) is None
    jm, params, state, pm = _pair(cifar_head=False, seed=3)
    x, y = _noise(4, 4)
    jopt = jax_zoo.make_optimizer(LR)
    jst = jax_zoo.ZooState(params, state, jopt.init(params))
    jst, jloss = jax_zoo.make_train_step(jm, jopt, fused=JAX_FUSED)(
        jst, jnp.asarray(x), jnp.asarray(y))
    st = zoo.init_state(pm, zoo.make_optimizer(LR))
    loss = zoo.make_train_step(pm, st.optimizer, fused=FUSED)(
        st, torch.from_numpy(x), torch.from_numpy(y).long())
    assert "model tail not fusable; keeping unfused tail" in capsys.readouterr().out
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    _assert_state_close(st, jst)


def test_jax_checkpoint_of_vgg16_restores_in_the_port(tmp_path):
    """A JAX-format ZooState checkpoint (optimizer state included) of
    ``vgg16(10)``: the port's ``load_jax_checkpoint`` gives JAX's eval
    logits, and the serve registry's handle takes the same file."""
    from parallel_cnn_tpu_torch.serve import get

    jm, params, state, _ = _pair(seed=5)
    state = jax.tree_util.tree_map(
        lambda v: np.random.default_rng(5).uniform(0.5, 1.5, v.shape).astype(np.float32),
        state)
    path = str(tmp_path / "vgg.npz")
    opt_state = {"mom": jax.tree_util.tree_map(np.zeros_like, params)}
    jax_checkpoint.save(path, jax_zoo.ZooState(params, state, opt_state))
    x, _ = _noise(2, 6)
    want = _jax_eval(jm, params, state, x)
    for model in (vgg.vgg16(10), get("vgg16").init(seed=9)):
        convert.load_jax_checkpoint(path, model)
        with torch.inference_mode():
            got = model.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want,
                                   atol=LOGIT_RTOL * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# The CLI on the CPU
# ---------------------------------------------------------------------------

CLI_RUNS = {
    "resnet50": ["--accum-steps", "2", "--lr", "0.001",
                 "--synthetic-train-count", "32"],
    "vgg16": ["--lr", "0.01", "--synthetic-train-count", "64"],
}


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("model", list(CLI_RUNS))
def test_cli_trains_on_the_kernels_paths_with_a_falling_loss(model):
    """``--conv-backend cuda --fused-step --act-dtype float32`` on the
    synthetic CIFAR-shape set, two epochs (the kernels' plain versions)."""
    rc, out = _run(["--device", "cpu", "--model", model, "--conv-backend", "cuda",
                    "--fused-step", "--act-dtype", "float32", "--batch-size", "16",
                    "--epochs", "2", "--synthetic-test-count", "16", *CLI_RUNS[model]])
    assert rc == 0
    losses = [float(ln.split()[3].rstrip(",")) for ln in out.splitlines()
              if ln.startswith("epoch ")]
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[1] < losses[0], out
    assert "falling back to fused tail only" in out
    assert "not fusable" not in out


@pytest.mark.parametrize("model", list(CLI_RUNS))
def test_serve_keeps_padded_bucket_parity(model):
    rc, out = _run(["serve", "--device", "cpu", "--model", model, "--requests", "8",
                    "--max-batch", "4"])
    assert rc == 0
    assert "[serve] padded-bucket parity (n=3→b4): bit-identical" in out
    assert "8/8 ok" in out


def test_the_smokes_conv_tables_are_the_models_convs():
    """chip_smoke.py checks B10/B11 at each conv of these tables and derives
    the launch counts from them: they list every conv a forward of
    ResNet-50 (CIFAR stem) and of VGG-16 runs, with its count."""
    from chip_smoke import R50_GEOMETRIES, VGG_GEOMETRIES, conv_geometries

    for model, table, convs in ((resnet.resnet50(10, cifar_stem=True), R50_GEOMETRIES, 53),
                                (vgg.vgg16(10), VGG_GEOMETRIES, 13)):
        walked = conv_geometries(model, (32, 32, 3))
        assert sorted(walked) == sorted(g[1:] for g in table)
        assert sum(g[-1] for g in walked) == convs
