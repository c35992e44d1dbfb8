"""bf16 activations (the zoo's ``--fused-step`` default) in the port
against the JAX package on the CPU. The same numpy inputs go to both.

- Each bf16 twin (the plain versions beside the bf16 forms of B10's
  forward and dgrad, B11 and B12) against JAX's Pallas function on bf16
  operands, run in interpret mode under ``jax.jit`` as
  tests/test_pallas_conv.py runs it in bf16: within ``2⁻⁷·max(1, max|ref|)``
  (one bf16 ulp of the output's scale: the two frameworks round at other
  points), with JAX's output dtypes. The tail also at 100 and 1,000
  classes, and through JAX's XLA twin (``PCNN_TAIL_KERNEL=0``) as well.
- BatchNorm's train-mode forward and gradients on bf16 against JAX's
  (its parameters' gradients, which XLA sums in bf16, within two ulps),
  the running statistics in f32 within 1e-6.
- One static-scale step of a small ResNet (widths 8 and 16, one block a
  stage, 8×8 images, batch 8) against JAX's ``make_train_step(fused=...)``:
  the loss within JAX's own bf16 bound (rtol 1e-2, tests/test_fused_step.py),
  each parameter's update within 0.1 of its largest (``UPDATE_RTOL``: the
  bf16 step's own noise is larger).
- The dynamic scale of update-on-arrival in gloo worlds of one and two
  ranks against JAX's ``make_fused_train_step`` on meshes of one and two
  devices: overflows skip bit for bit and back off to the clamp at 1,
  clean steps grow the scale at ``growth_interval=2``; ``scale``,
  ``good_steps`` and ``skipped`` equal JAX's exactly after every step.
- The GSPMD step in bf16 on a 2×1 world against JAX's on a 2-device mesh,
  by loss; and the CLI."""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bf16_ranks as ranks
import _torch_dp_ranks as dp_ranks
from _torch_jax_init import jax_init
from parallel_cnn_tpu.config import CommConfig as JaxCommConfig
from parallel_cnn_tpu.config import FusedStepConfig as JaxFusedStepConfig
from parallel_cnn_tpu.config import MeshConfig as JaxMeshConfig
from parallel_cnn_tpu.nn import core as jax_core
from parallel_cnn_tpu.nn import layers as jax_layers
from parallel_cnn_tpu.nn import resnet as jax_resnet
from parallel_cnn_tpu.ops import pallas_conv, pallas_tail
from parallel_cnn_tpu.parallel import mesh as jax_mesh
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch.config import FusedStepConfig, NotPortedError
from parallel_cnn_tpu_torch.nn import BatchNorm
from parallel_cnn_tpu_torch.ops import tail, tap_conv, tap_wgrad
from parallel_cnn_tpu_torch.parallel import distributed
from parallel_cnn_tpu_torch.train import zoo

BF16 = torch.bfloat16
#: One bf16 ulp at 1: the bound of every layer-by-layer comparison, times
#: max(1, max|ref|).
ULP = 2.0 ** -7
#: BatchNorm's parameter gradients: JAX accumulates them in bf16 (see
#: test_batchnorm_bf16_matches_jax).
REDUCTION_ULPS = 2
LOSS_RTOL = 1e-2
#: A parameter's bf16 update against JAX's, as a share of its largest. A
#: bf16 step is defined only to its rounding noise: on the small ResNet's
#: first step JAX's bf16 update moves from its f32 one by 2-31% of a
#: leaf's largest (the port's by 2-34% from its f64 step), and the port's
#: bf16 update lies within 0.1-8.5% of JAX's (all measured on the CPU).
UPDATE_RTOL = 0.1
STATS_ATOL = 1e-6
WORLD_TIMEOUT_S = 300
SMALL = (8, 8, 3)

# (b, h, w, cin, cout, k, s): 3x3/s1, 3x3/s2 even, 1x1/s1, 1x1/s2.
GEOMETRIES = [
    (2, 8, 8, 8, 16, 3, 1),
    (2, 8, 8, 8, 16, 3, 2),
    (2, 8, 8, 8, 16, 1, 1),
    (2, 8, 8, 8, 16, 1, 2),
]
TAIL_SHAPES = {"max2": (4, 4, 4, 16), "gap": (4, 4, 4, 32), "none": (4, 2, 2, 8)}
#: The many-class tails (K = 100 and 1,000: the kernel's tiled form).
MANY_TAIL_SHAPES = {"max2": (6, 4, 4, 16), "gap": (6, 3, 3, 64), "none": (6, 3, 3, 8)}
#: The tail's cases: (pool, K, JAX leg). 10 classes through JAX's Pallas
#: kernel keep their first ids; JAX's XLA twin (PCNN_TAIL_KERNEL=0) and the
#: many-class heads through both legs beside them.
TAIL_CASES = [pytest.param(pool, 10, "1", id=pool) for pool in ("gap", "max2", "none")] + [
    pytest.param(pool, k, leg, id=f"{pool}{'' if k == 10 else f'-k{k}'}-"
                                  f"{'pallas-interpret' if leg == '1' else 'xla'}")
    for k, leg in ((10, "0"), (100, "1"), (100, "0"), (1000, "1"), (1000, "0"))
    for pool in ("gap", "max2", "none")]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bf16_np(a):
    """numpy f32 values rounded to bf16 (returned as f32, exactly)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _f32(a):
    """A JAX array or a torch tensor as numpy f32."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _assert_ulp_close(got, want, what, ulps=1):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    bound = ulps * ULP * max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= bound, f"{what}: {err} > {bound}"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# The bf16 twins against JAX's Pallas functions
# ---------------------------------------------------------------------------


@functools.cache
def _conv_inputs(b, h, w, cin, cout, k, s):
    rng = np.random.default_rng(b * h + cin + k * 7 + s)
    oh, ow = -(-h // s), -(-w // s)
    x = _bf16_np(rng.standard_normal((b, h, w, cin)))
    wt = _bf16_np(rng.standard_normal((k, k, cin, cout)) * 0.1)
    g = _bf16_np(rng.standard_normal((b, oh, ow, cout)))
    return x, wt, g


@functools.cache
def _jax_conv(geometry):
    """JAX's bf16 forward, dgrad and wgrad (its custom VJP), jitted."""
    x, wt, g = _conv_inputs(*geometry)
    s = geometry[-1]

    @jax.jit
    def f(x, w, g):
        y, vjp = jax.vjp(lambda a, c: pallas_conv.conv2d(a, c, s), x, w)
        return (y, *vjp(g))

    return tuple(np.asarray(a) for a in f(_j(x), _j(wt), _j(g)))


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"k{g[5]}s{g[6]}")
def test_conv_forward_twin_matches_jax(geometry):
    x, wt, _ = _conv_inputs(*geometry)
    y_ref = _jax_conv(geometry)[0]
    before = (tap_conv.launches.count, tap_conv.bf16_launches.count)
    y = tap_conv.conv2d(_t(x), _t(wt), geometry[-1])
    assert y.dtype == BF16 and y_ref.dtype == jnp.bfloat16
    _assert_ulp_close(y, y_ref, "forward")
    # The CPU path runs the twin and launches nothing.
    assert (tap_conv.launches.count, tap_conv.bf16_launches.count) == before


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"k{g[5]}s{g[6]}")
def test_conv_dgrad_twin_matches_jax(geometry):
    x, wt, g = _conv_inputs(*geometry)
    dx_ref = _jax_conv(geometry)[1]
    dx = tap_conv.conv2d_dgrad(_t(g), _t(wt), x.shape, geometry[-1])
    assert dx.dtype == BF16 and dx_ref.dtype == jnp.bfloat16
    _assert_ulp_close(dx, dx_ref, "dgrad")


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"k{g[5]}s{g[6]}")
def test_conv_wgrad_twin_matches_jax(geometry):
    x, wt, g = _conv_inputs(*geometry)
    dw_ref = _jax_conv(geometry)[2]
    dw = tap_wgrad.conv2d_wgrad(_t(x), _t(g), geometry[5], geometry[-1])
    assert dw.dtype == BF16 and dw_ref.dtype == jnp.bfloat16
    _assert_ulp_close(dw, dw_ref, "wgrad")


def test_conv_autograd_runs_the_bf16_twins():
    """The autograd Function's backward on bf16 equals the two twins."""
    geometry = GEOMETRIES[1]
    x, wt, g = _conv_inputs(*geometry)
    xt, wtt = _t(x).requires_grad_(True), _t(wt).requires_grad_(True)
    y = tap_conv.conv2d(xt, wtt, 2)
    dx, dw = torch.autograd.grad(y, (xt, wtt), _t(g))
    assert dx.dtype == dw.dtype == BF16
    assert torch.equal(dx, tap_conv.conv2d_dgrad(_t(g), _t(wt), x.shape, 2))
    assert torch.equal(dw, tap_wgrad.conv2d_wgrad(_t(x), _t(g), 3, 2))


def test_mixed_dtypes_and_the_bf16_epilogue_raise():
    x, wt, g = _conv_inputs(*GEOMETRIES[0])
    with pytest.raises(TypeError, match="one element type"):
        tap_conv.conv2d(_t(x), torch.from_numpy(wt), 1)
    with pytest.raises(TypeError, match="one element type"):
        tap_conv.conv2d_dgrad(_t(g), torch.from_numpy(wt), x.shape, 1)
    with pytest.raises(TypeError, match="one element type"):
        tap_wgrad.conv2d_wgrad(torch.from_numpy(x), _t(g), 3, 1)
    ones = torch.ones(16)
    with torch.no_grad(), pytest.raises(NotPortedError, match="Queue B"):
        tap_conv.conv2d_fused(_t(x), _t(wt), ones, ones)
    xt, wt_, bt = (_t(a) for a in (np.ones((2, 2, 2, 4)), np.ones((16, 10)), np.ones(10)))
    with pytest.raises(TypeError, match="share a dtype"):
        tail.fused_tail_loss(xt, wt_, bt.float(), torch.zeros(2, dtype=torch.int64),
                             pool="none")


@functools.cache
def _tail_inputs(pool, k=10):
    rng = np.random.default_rng({"max2": 1, "gap": 2, "none": 3}[pool] + (0 if k == 10 else k))
    shape = TAIL_SHAPES[pool] if k == 10 else MANY_TAIL_SHAPES[pool]
    _, h, wd, c = shape
    d = {"max2": (h // 2) * (wd // 2) * c, "gap": c, "none": h * wd * c}[pool]
    x = _bf16_np(rng.standard_normal(shape))
    w = _bf16_np(rng.standard_normal((d, k)) * 0.1)
    b = _bf16_np(rng.standard_normal(k) * 0.1)
    y = rng.integers(0, k, shape[0])
    return x, w, b, y


@functools.cache
def _jax_tail(pool, k=10, leg="1"):
    x, w, b, y = _tail_inputs(pool, k)
    with pytest.MonkeyPatch.context() as mp:
        # "1": the Pallas kernel, interpreted; "0": its XLA twin.
        mp.setenv("PCNN_TAIL_KERNEL", leg)

        @jax.jit
        def f(x, w, b):
            return jax.value_and_grad(
                lambda *a: pallas_tail.fused_tail_loss(
                    *a, jnp.asarray(y, jnp.int32), pool=pool),
                argnums=(0, 1, 2))(x, w, b)

        loss, grads = f(_j(x), _j(w), _j(b))
        return np.asarray(loss), [np.asarray(a) for a in grads]


@pytest.mark.parametrize("pool,k,leg", TAIL_CASES)
def test_tail_twin_and_backward_match_jax(pool, k, leg):
    x, w, b, y = _tail_inputs(pool, k)
    loss_ref, grads_ref = _jax_tail(pool, k, leg)
    ts = [_t(a).requires_grad_(True) for a in (x, w, b)]
    before = (tail.launches.count, tail.bf16_launches.count)
    loss = tail.fused_tail_loss(*ts, torch.from_numpy(y), pool=pool)
    grads = torch.autograd.grad(loss, ts)
    assert loss.dtype == torch.float32 and loss_ref.dtype == np.float32
    _assert_ulp_close(loss, loss_ref, "loss")
    for name, got, want in zip(("dx", "dw", "db"), grads, grads_ref):
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16, name
        _assert_ulp_close(got, want, name)
    assert (tail.launches.count, tail.bf16_launches.count) == before


def test_tail_forward_writes_f32():
    x, w, b, y = _tail_inputs("gap")
    loss_i, dl = tail.tail_forward(_t(x), _t(w), _t(b), torch.from_numpy(y), "gap")
    assert loss_i.dtype == dl.dtype == torch.float32


# ---------------------------------------------------------------------------
# BatchNorm in bf16
# ---------------------------------------------------------------------------


def test_batchnorm_bf16_matches_jax():
    rng = np.random.default_rng(11)
    x = _bf16_np(rng.standard_normal((4, 4, 4, 8)) * 2.0 + 1.5)
    scale = _bf16_np(1.0 + 0.3 * rng.standard_normal(8))
    bias = _bf16_np(0.3 * rng.standard_normal(8))
    g = _bf16_np(rng.standard_normal(x.shape))
    mean0 = (0.1 * rng.standard_normal(8)).astype(np.float32)
    var0 = (1.0 + 0.1 * rng.random(8)).astype(np.float32)

    jbn = jax_layers.BatchNorm()
    state = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    @jax.jit
    def f(x, params, g):
        (y, st), vjp = jax.vjp(lambda a, p: jbn.apply(p, state, a, train=True), x, params)
        return y, st, vjp((g, jax.tree_util.tree_map(jnp.zeros_like, st)))

    y_ref, st_ref, (dx_ref, dp_ref) = f(_j(x), {"scale": _j(scale), "bias": _j(bias)},
                                        _j(g))

    bn = BatchNorm(8)
    bn.mean.copy_(torch.from_numpy(mean0))
    bn.var.copy_(torch.from_numpy(var0))
    bn.train()
    xt, st, bt = (_t(a).requires_grad_(True) for a in (x, scale, bias))
    y = torch.func.functional_call(bn, {"scale": st, "bias": bt}, (xt,))
    dx, dscale, dbias = torch.autograd.grad(y, (xt, st, bt), _t(g))
    assert y.dtype == dx.dtype == dscale.dtype == BF16
    _assert_ulp_close(y, y_ref, "y")
    _assert_ulp_close(dx, dx_ref, "dx")
    # The parameters' gradients are sums over N·H·W. XLA reduces the
    # transpose of a bf16 broadcast in bf16, one rounding an add (its dbias
    # equals a sequential bf16 sum bit for bit, 2 ulps from the exact sum
    # here); PyTorch sums in f32 and rounds once. So the port's dbias is the
    # exact sum rounded once, and both reductions are held to JAX's within
    # REDUCTION_ULPS ulps of the scale.
    exact = torch.from_numpy(g.astype(np.float64).sum(axis=(0, 1, 2))).to(BF16)
    assert torch.equal(dbias, exact)
    _assert_ulp_close(dscale, dp_ref["scale"], "dscale", REDUCTION_ULPS)
    _assert_ulp_close(dbias, dp_ref["bias"], "dbias", REDUCTION_ULPS)
    for name in ("mean", "var"):
        got = getattr(bn, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(st_ref[name]), rtol=0,
                                   atol=STATS_ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _jax_small_resnet():
    return jax_core.Sequential([
        jax_layers.ConvBNAct(8, backend="pallas"),
        jax_resnet.BasicBlock(8, 1, "pallas"),
        jax_resnet.BasicBlock(16, 2, "pallas"),
        jax_layers.GlobalAvgPool(), jax_layers.Dense(10)])


@functools.cache
def _resnet_case():
    params, state = jax_init(_jax_small_resnet(), SMALL, 21)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((8,) + SMALL).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    return params, state, x, y


def _sd(params, state):
    return {k: v.numpy() for k, v in convert.from_jax(params, state).items()}


def test_static_scale_step_matches_jax():
    params, state, x, y = _resnet_case()
    jm = _jax_small_resnet()
    jopt = jax_zoo.make_optimizer(ranks.GSPMD_LR)
    jst = jax_zoo.ZooState(jax.tree_util.tree_map(jnp.asarray, params),
                           jax.tree_util.tree_map(jnp.asarray, state),
                           jopt.init(jax.tree_util.tree_map(jnp.asarray, params)))
    jstep = jax_zoo.make_train_step(
        jm, jopt, fused=JaxFusedStepConfig(update=False, act_dtype="bfloat16"))
    jst, jloss = jstep(jst, jnp.asarray(x), jnp.asarray(y))

    model = ranks._model(ranks.small_resnet, _sd(params, state))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    pstate = zoo.init_state(model, zoo.make_optimizer(ranks.GSPMD_LR))
    step = zoo.make_train_step(model, pstate.optimizer,
                               fused=FusedStepConfig(update=False, act_dtype="bfloat16"))
    loss = step(pstate, torch.from_numpy(x), torch.from_numpy(y).long())
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)

    after = model.state_dict()
    want = _sd(jax.tree_util.tree_map(np.asarray, jst.params),
               jax.tree_util.tree_map(np.asarray, jst.model_state))
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k  # the masters stay f32
        d_got = (after[k] - before[k]).numpy()
        d_want = want[k] - before[k].numpy()
        bound = UPDATE_RTOL * float(np.max(np.abs(d_want)))
        assert float(np.max(np.abs(d_got - d_want))) <= bound, k


#: The dynamic scale's batches: three overflows down to the clamp at 1,
#: two clean steps (growth at the second), an overflow after growth.
BATCHES = ("x_inf", "x", "x", "x_inf", "x_inf", "x_inf", "x")


@functools.cache
def _dp_case():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16,) + dp_ranks.TINY_SHAPE).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    x_inf = x.copy()
    x_inf[0, 0, 0, 0] = np.inf
    layers = [jax_layers.Conv2D(4, (3, 3)), jax_layers.BatchNorm(), jax_layers.ReLU(),
              jax_layers.MaxPool(), jax_layers.Flatten(), jax_layers.Dense(10)]
    params, state = jax_init(jax_core.Sequential(layers), dp_ranks.TINY_SHAPE, 7)
    return layers, params, state, x, y, x_inf


def _jax_scaled_run(world):
    layers, params, state, x, y, x_inf = _dp_case()
    model = jax_core.Sequential(layers)
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=world, model=1))
    comm = JaxCommConfig(impl="ring", bucket_bytes=dp_ranks.BUCKET_BYTES, overlap=True)
    s = ranks.SCALED
    fused = JaxFusedStepConfig(update=True, tail=True, act_dtype="bfloat16",
                               loss_scale=s.loss_scale, growth_interval=s.growth_interval,
                               backoff=s.backoff)
    st, nb = jax_zoo.init_fused_state(model, jax.random.key(7), dp_ranks.TINY_SHAPE,
                                      n_data=world, fused=fused,
                                      bucket_bytes=comm.bucket_bytes)
    st = jax_zoo.ZooState(jax.tree_util.tree_map(jnp.asarray, params),
                          jax.tree_util.tree_map(jnp.asarray, state), st.opt_state)
    step = jax_zoo.make_fused_train_step(
        model, lr=dp_ranks.LR, momentum=dp_ranks.MOMENTUM, accum_steps=dp_ranks.ACCUM,
        mesh=mesh, augment=None, comm=comm, fused=fused, n_buckets=nb)
    counters, losses = [], []
    for name in BATCHES:
        st, loss = step(st, jnp.asarray({"x": x, "x_inf": x_inf}[name]), jnp.asarray(y))
        opt = st.opt_state
        counters.append((float(opt.scale), int(opt.good_steps), int(opt.skipped)))
        losses.append(float(loss))
    return counters, losses


@pytest.fixture(scope="module")
def bf16_worlds(host_devices):
    """Every rank's results of ``bf16_world`` in worlds of one and two."""
    layers, params, state, x, y, x_inf = _dp_case()
    rparams, rstate, rx, ry = _resnet_case()
    spec = dict(sd=_sd(params, state), x=x, y=y, x_inf=x_inf, batches=BATCHES,
                resnet_sd=_sd(rparams, rstate), rx=rx, ry=ry)
    return {world: distributed.run(ranks.bf16_world, world, device="cpu", args=(spec,),
                                   timeout=WORLD_TIMEOUT_S)
            for world in (1, 2)}


def _counters(arrays):
    return (float(arrays[".opt_state/.scale"]), int(arrays[".opt_state/.good_steps"]),
            int(arrays[".opt_state/.skipped"]))


@pytest.mark.parametrize("world", [1, 2])
def test_dynamic_scale_counters_equal_jax(bf16_worlds, world):
    want, want_losses = _jax_scaled_run(world)
    assert [c[0] for c in want] == [2.0, 2.0, 4.0, 2.0, 1.0, 1.0, 1.0]  # the schedule
    for r, res in enumerate(bf16_worlds[world]):
        got = [_counters(a) for a in res["arrays"][1:]]
        assert got == want, f"rank {r}"
        assert _counters(res["arrays"][0]) == (ranks.SCALED.loss_scale, 0, 0)
        for i, name in enumerate(BATCHES):
            if name == "x":
                np.testing.assert_allclose(res["losses"][i], want_losses[i],
                                           rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", [1, 2])
def test_overflow_skips_bit_for_bit_then_trains(bf16_worlds, world):
    """A skipped step leaves params, momentum and BN statistics as they
    were; a clean one moves every parameter and momentum leaf."""
    for res in bf16_worlds[world]:
        arrays = res["arrays"]
        for i, name in enumerate(BATCHES):
            before, after = arrays[i], arrays[i + 1]
            kept = [k for k in before if not k.startswith(
                (".opt_state/.scale", ".opt_state/.good_steps", ".opt_state/.skipped"))]
            moved = [k for k in kept if k.startswith((".params", ".opt_state/.mom"))
                     and not np.array_equal(before[k], after[k])]
            if name == "x_inf":
                assert not np.isfinite(res["losses"][i])
                for k in kept:
                    assert np.array_equal(before[k], after[k]), (i, k)
            else:
                assert len(moved) == len([k for k in kept if k.startswith(
                    (".params", ".opt_state/.mom"))]), i
            assert all(a.dtype == np.float32 for k, a in after.items()
                       if k.startswith(".params"))


def test_gspmd_bf16_step_matches_jax(bf16_worlds, host_devices):
    params, state, x, y = _resnet_case()
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=2, model=1))
    jopt = jax_zoo.make_optimizer(ranks.GSPMD_LR)
    jst = jax_zoo.ZooState(jax.tree_util.tree_map(jnp.asarray, params),
                           jax.tree_util.tree_map(jnp.asarray, state),
                           jopt.init(jax.tree_util.tree_map(jnp.asarray, params)))
    jstep = jax_zoo.make_train_step(
        _jax_small_resnet(), jopt, mesh=mesh,
        fused=JaxFusedStepConfig(update=False, act_dtype="bfloat16"))
    want = []
    for _ in range(2):
        jst, loss = jstep(jst, jnp.asarray(x), jnp.asarray(y))
        want.append(float(loss))
    for res in bf16_worlds[2]:
        np.testing.assert_allclose(res["gspmd_losses"], want, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--model", "resnet18", "--conv-backend", "cuda", "--fused-step"],
    ["--model", "cifar_cnn", "--mesh-data", "1", "--comm-impl", "ring", "--fused-step"],
], ids=["single-device", "update-on-arrival"])
def test_cli_trains_bf16(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--device", "cpu", "--batch-size", "16", "--lr", "0.01",
                       "--epochs", "2", "--synthetic-train-count", "32",
                       "--synthetic-test-count", "16"] + argv)
    assert rc == 0
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("epoch ")]
    assert [ln.split(":")[0] for ln in lines] == ["epoch 1", "epoch 2"]
