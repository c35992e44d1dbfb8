"""ResNet-50 (the Bottleneck family, the ImageNet stem with its SAME 3×3/s2
max pool, ``AvgPool``) in the port against the JAX package on the CPU.

Weights are JAX's init distribution drawn with numpy from a seed
(``tests/_torch_jax_init.py``) and cross over through ``convert.from_jax``;
inputs are numpy arrays from a seed. JAX's forwards and gradients run
under ``jax.jit`` (one compile a graph, not one a primitive and shape). The port's ``"cuda"`` backend runs the plain versions of the
conv kernels on CPU tensors; the JAX side runs its ``"xla"`` backend, or
its Pallas kernels in interpret mode where stated. Depth is reduced
everywhere except the parameter count and the full-depth eval-mode
forward: an untrained ResNet-50 in training mode amplifies f32 rounding
(JAX's tests/test_pallas_conv.py measured XLA against XLA at ~7% of
max|g| after a 1e-6 input change), so training is held on one Bottleneck
and on a (1, 1, 1, 1)-stage net.

Tolerances (f32 throughout; the frameworks sum products in other orders):
a block's forward, input gradient and weight gradients within 1e-5 abs +
1e-4 rel; the pools within 1e-6 (one sum or max per output); the stem and
block at 64² within 1e-4; the full-depth logits within 1e-3 · max(1,
max|logit|) at random BN statistics (JAX's own XLA-against-Pallas check
at this depth uses atol 5e-3); the reduced-depth train steps' losses within 1e-5 · max(1, loss)
(ResNet-50's untrained head gives losses near 3.2) and params as the
zoo's ResNet-18 step (5e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.config import FusedStepConfig as JaxFusedStepConfig
from parallel_cnn_tpu.nn import core as jax_core
from parallel_cnn_tpu.nn import layers as jax_layers
from parallel_cnn_tpu.nn import resnet as jax_resnet
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch import convert
from _torch_jax_init import jax_init
from parallel_cnn_tpu_torch.config import FusedStepConfig
from parallel_cnn_tpu_torch.nn import (AvgPool, ConvBNAct, Dense, GlobalAvgPool,
                                       MaxPool, Sequential, resnet)
from parallel_cnn_tpu_torch.serve import get
from parallel_cnn_tpu_torch.train import zoo

BLOCK_ATOL, BLOCK_RTOL = 1e-5, 1e-4
POOL_ATOL = 1e-6
STEM_ATOL = 1e-4
DEEP_RTOL = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4
# At lr 0.01 the (1, 1, 1, 1) net with two microbatches of 4 (BN over 4
# values a channel at 1x1) moves its params by 7.5e-4 between the port in
# f32 and in f64 after two steps: conditioning, not the port. At 0.001 the
# f32 paths agree with f64 to 1e-6.
LR = 0.001


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_bn(tree, rng):
    """Non-trivial BN statistics and affine parameters (γ below 1 keeps
    the residual stream O(1) through 16 blocks)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "scale":
                out[k] = rng.uniform(0.2, 0.5, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("bias", "mean") and np.ndim(v) == 1:
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = _randomize_bn(v, rng)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_randomize_bn(v, rng) for v in tree)
    return np.asarray(tree)


def _port(module, params, state):
    module.load_state_dict(convert.from_jax(params, state))
    return module


def _close(got, want, atol, rtol, what):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def _jax_vjp(module, params, state, x, cot, train, jit=True):
    """JAX's forward, and the gradients of <out, cot> in x and the params
    (eager with ``jit=False``: JAX's AvgPool has no gradient under jit)."""
    def f(p, xx):
        y, _ = module.apply(p, state, xx, train=train)
        return jnp.sum(y * cot), y

    vg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
    (_, y), (gp, gx) = (jax.jit(vg) if jit else vg)(params, jnp.asarray(x))
    return np.asarray(y), np.asarray(gx), convert.from_jax(_np(gp), {})


def _jax_eval(module, params, state, x):
    return jax.jit(lambda p, s, xx: module.apply(p, s, xx, train=False)[0])(
        params, state, jnp.asarray(x))


def _port_vjp(module, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = module(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    grads = {k: p.grad for k, p in module.named_parameters()}
    return y.detach().numpy(), xt.grad.numpy(), grads


# ---------------------------------------------------------------------------
# Shape of the model
# ---------------------------------------------------------------------------


def test_resnet50_param_count_is_jaxs():
    """25,557,032 (JAX's tests/test_zoo.py, torchvision's resnet50), 53
    convs: the stem, 16 blocks of three, four projections."""
    model = resnet.resnet50(1000)
    assert resnet.num_params(model) == 25_557_032
    convs = [m for m in model.modules() if isinstance(m, ConvBNAct)]
    assert len(convs) == 1 + 16 * 3 + 4
    assert isinstance(model[1], MaxPool) and model[1].padding == "SAME"
    tree = jax.eval_shape(lambda: jax_resnet.resnet50(1000).init(
        jax.random.key(0), (224, 224, 3))[:2])
    want = convert.from_jax(*jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), tree))
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# One Bottleneck
# ---------------------------------------------------------------------------

BLOCKS = {  # name: (in width, bottleneck width, stride)
    "projection": (16, 8, 1),
    "stride2": (32, 8, 2),
    "identity": (32, 8, 1),
}


def _block_pair(name, backend, seed=0):
    cin, f, stride = BLOCKS[name]
    jb = jax_resnet.Bottleneck(f, stride, "pallas" if backend == "cuda" else "xla")
    params, state = jax_init(jb, (8, 8, cin), seed + 100)
    rng = np.random.default_rng(seed)
    params = _randomize_bn(params, rng)
    state = _randomize_bn(state, rng)
    pb = _port(resnet.Bottleneck(cin, f, stride, backend), params, state)
    assert (pb.proj is None) == (name == "identity")
    x = rng.standard_normal((4, 8, 8, cin)).astype(np.float32)
    oh = 8 // stride
    cot = rng.standard_normal((4, oh, oh, 4 * f)).astype(np.float32)
    return jb, params, state, pb, x, cot


@pytest.mark.parametrize("name", list(BLOCKS))
def test_bottleneck_train_mode_matches_jax(name):
    """Batch statistics: forward, input gradient, every weight gradient and
    the running statistics each BN writes."""
    jb, params, state, pb, x, cot = _block_pair(name, "cuda")
    jb = jax_resnet.Bottleneck(jb.features, jb.stride, "xla")
    y, gx, grads = _jax_vjp(jb, params, state, x, cot, True)
    _, new_state = jax.jit(lambda p, s, xx: jb.apply(p, s, xx, train=True))(
        params, state, jnp.asarray(x))
    py, pgx, pgrads = _port_vjp(pb.train(), x, cot)
    _close(py, y, BLOCK_ATOL, BLOCK_RTOL, f"{name} forward")
    _close(pgx, gx, BLOCK_ATOL, BLOCK_RTOL, f"{name} dx")
    assert sorted(pgrads) == sorted(grads)
    for k, g in grads.items():
        _close(pgrads[k].numpy(), g.numpy(), BLOCK_ATOL, BLOCK_RTOL, f"{name} d{k}")
    buffers = dict(pb.named_buffers())
    for k, v in convert.from_jax({}, _np(new_state)).items():
        _close(buffers[k].numpy(), v.numpy(), BLOCK_ATOL, BLOCK_RTOL, f"{name} {k}")


@pytest.mark.parametrize("name", list(BLOCKS))
def test_bottleneck_eval_mode_matches_jax(name):
    """Running statistics: the fused eval forward (the forward kernel's
    plain version with BN folded, residual and ReLU in its epilogue) against
    JAX's Pallas kernels in interpret mode; the gradients through the
    unfused composition (backend "torch", JAX's "xla")."""
    jb, params, state, pb, x, cot = _block_pair(name, "cuda")
    want = np.asarray(_jax_eval(jb, params, state, x))
    with torch.inference_mode():
        got = pb.eval()(torch.from_numpy(x)).numpy()
    _close(got, want, BLOCK_ATOL, BLOCK_RTOL, f"{name} fused forward")
    cin, f, stride = BLOCKS[name]
    jx = jax_resnet.Bottleneck(f, stride, "xla")
    y, gx, grads = _jax_vjp(jx, params, state, x, cot, False)
    px = _port(resnet.Bottleneck(cin, f, stride, "torch"), params, state).eval()
    py, pgx, pgrads = _port_vjp(px, x, cot)
    _close(py, y, BLOCK_ATOL, BLOCK_RTOL, f"{name} forward")
    _close(pgx, gx, BLOCK_ATOL, BLOCK_RTOL, f"{name} dx")
    for k, g in grads.items():
        _close(pgrads[k].numpy(), g.numpy(), BLOCK_ATOL, BLOCK_RTOL, f"{name} d{k}")


# ---------------------------------------------------------------------------
# Pools
# ---------------------------------------------------------------------------

POOLS = [  # (size, window, stride, padding)
    (112, 3, 2, "SAME"), (13, 3, 2, "SAME"), (7, 3, 2, "SAME"),
    (13, 2, 2, "VALID"), (7, 3, 1, "SAME"), (12, 3, 2, "VALID"),
]


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("size,window,stride,padding", POOLS)
def test_pool_matches_jax(kind, size, window, stride, padding):
    """Forward and gradient. XLA's SAME puts the odd pad after: at 112 the
    3×3/s2 pool gives 56 outputs from windows starting at rows 0, 2, …;
    an AvgPool window over the pad divides by its count of real cells."""
    rng = np.random.default_rng(size + window)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    jcls, pcls = ((jax_layers.MaxPool, MaxPool) if kind == "max"
                  else (jax_layers.AvgPool, AvgPool))
    jp = jcls(window=(window, window), strides=(stride, stride), padding=padding)
    out_shape = jp.init(None, x.shape[1:])[2]
    cot = rng.standard_normal((2,) + out_shape).astype(np.float32)
    y, gx, _ = _jax_vjp(jp, {}, {}, x, cot, False, jit=False)
    py, pgx, _ = _port_vjp(pcls(window, stride, padding), x, cot)
    assert py.shape == y.shape == (2,) + out_shape
    _close(py, y, POOL_ATOL, 0, f"{kind} forward")
    _close(pgx, gx, POOL_ATOL, 0, f"{kind} dx")


def test_same_max_pool_differs_from_symmetric_padding():
    """At 112 the SAME windows start at rows and columns 0, 2, …, 110 (the
    last one over the pad after); F.max_pool2d(padding=1) starts them one
    earlier and gives other values."""
    x = torch.randn((1, 112, 112, 1), generator=torch.Generator().manual_seed(0))
    got = MaxPool(3, 2, "SAME")(x)
    assert got.shape == (1, 56, 56, 1)
    for i, j in ((0, 0), (10, 20), (55, 55), (55, 0)):
        assert float(got[0, i, j, 0]) == float(x[0, 2 * i:2 * i + 3, 2 * j:2 * j + 3, 0].max())
    sym = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1)
    assert sym.shape == (1, 1, 56, 56)
    assert not torch.equal(got.permute(0, 3, 1, 2), sym)


def test_max_pool_gradient_takes_the_first_maximum_of_a_tied_window():
    """A window of equal values (zeros after a ReLU) sends its gradient to
    the first cell in row-major order, as XLA routes it."""
    x = np.zeros((1, 7, 7, 2), np.float32)
    cot = np.arange(1, 1 + 4 * 4 * 2, dtype=np.float32).reshape(1, 4, 4, 2)
    jp = jax_layers.MaxPool(window=(3, 3), strides=(2, 2), padding="SAME")
    _, gx, _ = _jax_vjp(jp, {}, {}, x, cot, False, jit=False)
    _, pgx, _ = _port_vjp(MaxPool(3, 2, "SAME"), x, cot)
    np.testing.assert_array_equal(pgx, gx)


# ---------------------------------------------------------------------------
# The ImageNet stem and the whole net
# ---------------------------------------------------------------------------


def _stem_pair(seed=0):
    """JAX's ImageNet stem and one stride-1 bottleneck, then the head."""
    L = jax_layers
    jm = jax_core.Sequential([
        L.ConvBNAct(64, kernel=(7, 7), strides=(2, 2)),
        L.MaxPool(window=(3, 3), strides=(2, 2), padding="SAME"),
        jax_resnet.Bottleneck(64), L.GlobalAvgPool(), L.Dense(10)])
    params, state = jax_init(jm, (64, 64, 3), seed + 100)
    pm = Sequential(ConvBNAct(3, 64, 7, 2, backend="cuda"), MaxPool(3, 2, "SAME"),
                    resnet.Bottleneck(64, 64, 1, "cuda"), GlobalAvgPool(),
                    Dense(256, 10))
    return jm, params, state, _port(pm, params, state)


def test_imagenet_stem_and_block_at_64_match_jax():
    """Train mode: logits, input gradient, every weight gradient; eval mode
    (running statistics after the step, fused kernels' plain versions):
    logits."""
    jm, params, state, pm = _stem_pair()
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 10)).astype(np.float32)
    y, gx, grads = _jax_vjp(jm, params, state, x, cot, True)
    py, pgx, pgrads = _port_vjp(pm.train(), x, cot)
    _close(py, y, STEM_ATOL, 0, "logits")
    _close(pgx, gx, STEM_ATOL, 0, "dx")
    for k, g in grads.items():
        scale = max(1.0, float(g.abs().max()))
        _close(pgrads[k].numpy(), g.numpy(), STEM_ATOL * scale, 0, f"d{k}")
    _, new_state = jax.jit(lambda p, s, xx: jm.apply(p, s, xx, train=True))(
        params, state, jnp.asarray(x))
    want = np.asarray(_jax_eval(jm, params, _np(new_state), x))
    with torch.inference_mode():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    _close(got, want, STEM_ATOL, 0, "eval logits")


@pytest.fixture(scope="module")
def deep():
    """Full-depth ResNet-50 (ImageNet stem, 10 classes) with random BN, its
    JAX eval logits at b4 and 64²."""
    jm = jax_resnet.resnet50(10, cifar_stem=False)
    params, state = jax_init(jm, (64, 64, 3), 100)
    rng = np.random.default_rng(0)
    params = _randomize_bn(params, rng)
    state = _randomize_bn(state, rng)
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    logits = np.asarray(_jax_eval(jm, params, state, x))
    return params, state, x, logits


def _deep_close(got, want):
    _close(got, want, DEEP_RTOL * max(1.0, float(np.abs(want).max())), 0, "logits")
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_full_depth_resnet50_eval_logits_match_jax(deep):
    params, state, x, want = deep
    model = _port(resnet.resnet50(10), params, state).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 10) and np.isfinite(got).all()
    _deep_close(got, want)


def test_jax_checkpoint_of_resnet50_restores_in_the_port(deep, tmp_path):
    """A JAX-format ZooState checkpoint (optimizer state included) restored
    by ``load_jax_checkpoint``: bit for bit the weights passed directly,
    and JAX's logits."""
    params, state, x, want = deep
    path = str(tmp_path / "r50.npz")
    opt_state = {"mom": jax.tree_util.tree_map(np.zeros_like, params)}
    jax_checkpoint.save(path, jax_zoo.ZooState(params, state, opt_state))
    loaded = convert.load_jax_checkpoint(path, resnet.resnet50(10)).eval()
    direct = _port(resnet.resnet50(10), params, state).eval()
    with torch.inference_mode():
        got = loaded(torch.from_numpy(x)).numpy()
        assert np.array_equal(got, direct(torch.from_numpy(x)).numpy())
    _deep_close(got, want)


def test_served_resnet50_handle_restores_a_jax_checkpoint(tmp_path):
    """The serve registry's ResNet-50 (CIFAR stem, 10 classes) takes a JAX
    zoo checkpoint of ``resnet50(10, cifar_stem=True)``."""
    jm = jax_resnet.resnet50(10, cifar_stem=True)
    params, state = jax_init(jm, (32, 32, 3), 101)
    state = _randomize_bn(state, np.random.default_rng(1))
    path = str(tmp_path / "r50c.npz")
    jax_checkpoint.save(path, jax_zoo.ZooState(params, state, {}))
    handle = get("resnet50")
    assert handle.in_shape == (32, 32, 3) and handle.n_outputs == 10
    model = convert.load_jax_checkpoint(path, handle.init(seed=5))
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(_jax_eval(jm, params, state, x))
    with torch.inference_mode():
        got = handle.forward(model, torch.from_numpy(x)).numpy()
    _deep_close(got, want)


# ---------------------------------------------------------------------------
# Training at reduced depth
# ---------------------------------------------------------------------------


def _reduced_pair(seed=0):
    jm = jax_resnet._resnet(jax_resnet.Bottleneck, (1, 1, 1, 1), 10, True, "xla")
    params, state = jax_init(jm, (8, 8, 3), seed + 100)
    pm = resnet._resnet(resnet.Bottleneck, (1, 1, 1, 1), 10, True, "cuda", None, None)
    return jm, params, state, _port(pm, params, state)


@pytest.mark.parametrize("accum,fused", [(1, False), (2, False), (2, True)],
                         ids=["plain", "accum2", "accum2-fused-tail"])
def test_reduced_depth_train_steps_match_jax(accum, fused):
    """Two steps of ``_resnet(Bottleneck, (1, 1, 1, 1))`` at lr 0.001 on
    noise images: losses, params and BN statistics; the fused tail's
    ``gap`` mode over 2,048 features on both sides."""
    jm, params, state, pm = _reduced_pair()
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 8, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, (2, 8)).astype(np.int32)
    jopt = jax_zoo.make_optimizer(LR)
    jst = jax_zoo.ZooState(params, state, jopt.init(params))
    jfused = JaxFusedStepConfig(update=False, act_dtype="float32") if fused else None
    jstep = jax_zoo.make_train_step(jm, jopt, accum_steps=accum, fused=jfused)
    st = zoo.init_state(pm, zoo.make_optimizer(LR))
    pfused = FusedStepConfig(update=False, act_dtype="float32") if fused else None
    step = zoo.make_train_step(pm, st.optimizer, accum, fused=pfused)
    for i in range(2):
        jst, jloss = jstep(jst, jnp.asarray(x[i]), jnp.asarray(y[i]))
        loss = step(st, torch.from_numpy(x[i]), torch.from_numpy(y[i]).long())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL, err_msg=f"loss {i + 1}")
    got = {k: v for k, v in convert.zoo_to_jax(st).items()
           if not k.startswith(".opt_state")}
    want = {k: np.asarray(v) for k, v in jax_checkpoint._flatten(jst).items()
            if not k.startswith(".opt_state")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _close(got[k], v, PARAM_ATOL, 0, k)
