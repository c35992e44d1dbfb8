"""The port's 1F1B pipeline (``parallel_cnn_tpu_torch/parallel/pipeline.py``,
``train/pipeline_schedule.py``, ``train.zoo.train(pipeline=)``, the CLI's
``--pipeline-*`` flags) against the JAX package on the CPU.

- The tick tables, ``stash_high_water`` and ``bubble_fraction`` equal JAX's
  at every (S, M) of ``tests/test_pipeline.py``.
- ``layer_costs`` (shape-only in the port, JAX's ``measured_flops`` of each
  layer's jaxpr) and ``split_layers`` equal JAX's row for row on
  ``small_model``, ResNet-18, the CIFAR CNN, VGG-16 and ResNet-50 (both
  stems), on small inputs. JAX's tables come from a shape-only init
  (``jax.eval_shape``, zeros): its eager init compiles every initializer.
- ``PipelineConfig``, ``pack_acts``/``unpack_acts``, the mesh helpers, and
  JAX's fences of ``make_pipeline_step`` and ``zoo.train``, with JAX's
  error texts.
- The step, in one spawned gloo world of 4 (``tests/_torch_pipeline_ranks.py``),
  3 steps of JAX's small model at M = 2, lr 0.1, weights from JAX's init:
  S = 1 bit for bit the flat ring over the same 4 ranks; S = 2 × D = 2 and
  S = 4 × D = 1 within 1e-5 of the flat ring at D and of JAX's
  ``make_pipeline_step`` on host meshes of the same shape (losses and
  every leaf; a manual S = 4 split against the flat ring); bf16 wire and
  activations within 1e-2 (the momentum traces within 0.1 of the leaf's
  scale); the ZeRO-2 tail (B13's plain twin here) within 1e-5. The BN
  running statistics after a pipelined step equal the flat ring step's; a
  stage's recompute leaves them as its forward tick did.
- The CLI on the CPU (two gloo ranks), its refusals, and its refusal of
  two stages on one card.

Never held against JAX's psum comm step (ROADMAP Queue C): the JAX
references here are the pipeline step and its ring."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_pipeline_ranks as ranks
from parallel_cnn_tpu.config import CommConfig as JaxCommConfig
from parallel_cnn_tpu.config import FusedStepConfig as JaxFusedStepConfig
from parallel_cnn_tpu.config import PipelineConfig as JaxPipelineConfig
from parallel_cnn_tpu.nn import cifar as jax_cifar
from parallel_cnn_tpu.nn import core as jax_core
from parallel_cnn_tpu.nn import layers as JL
from parallel_cnn_tpu.nn import resnet as jax_resnet
from parallel_cnn_tpu.nn import vgg as jax_vgg
from parallel_cnn_tpu.parallel import mesh as jax_mesh
from parallel_cnn_tpu.parallel import pipeline as jax_pp
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu.train.pipeline_schedule import make_pipeline_step as jax_make_pipeline_step
from parallel_cnn_tpu.train.pipeline_schedule import stage_plan as jax_stage_plan
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch.config import FusedStepConfig, PipelineConfig
from parallel_cnn_tpu_torch.nn import cifar, resnet, vgg
from parallel_cnn_tpu_torch.parallel import distributed
from parallel_cnn_tpu_torch.parallel import pipeline as pp
from parallel_cnn_tpu_torch.parallel.mesh import (
    DataMesh,
    make_pipeline_mesh,
    pipeline_axis_sizes,
)
from parallel_cnn_tpu_torch.train import pipeline_schedule as ps
from parallel_cnn_tpu_torch.train import zoo

TOL = 1e-5
BF16_TOL = 1e-2
WORLD_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_small_model():
    return jax_core.Sequential([
        JL.Conv2D(4, (3, 3)), JL.BatchNorm(), JL.ReLU(), JL.MaxPool(),
        JL.Conv2D(8, (3, 3)), JL.ReLU(), JL.Flatten(), JL.Dense(10),
    ])


# ---------------------------------------------------------------------------
# The 1F1B tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,m", [(1, 1), (1, 4), (2, 2), (2, 4), (2, 8), (4, 2),
                                 (4, 4), (4, 8), (8, 3)])
def test_schedule_equals_jax(s, m):
    assert pp.n_ticks(s, m) == jax_pp.n_ticks(s, m)
    assert ([tuple(e) for e in pp.schedule_events(s, m)]
            == [tuple(e) for e in jax_pp.schedule_events(s, m)])
    for got, want in zip(pp.schedule_arrays(s, m), jax_pp.schedule_arrays(s, m)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert pp.stash_high_water(s, m) == jax_pp.stash_high_water(s, m) <= s
    assert pp.bubble_fraction(s, m) == jax_pp.bubble_fraction(s, m)


def test_schedule_rejects_bad_sizes():
    for s, m in ((0, 4), (2, 0)):
        with pytest.raises(ValueError) as want:
            jax_pp.schedule_events(s, m)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            pp.schedule_events(s, m)


# ---------------------------------------------------------------------------
# The cost table and the split
# ---------------------------------------------------------------------------

def _shape_only(model):
    """JAX ``model`` whose ``init`` gives zeros of the init's shapes (the
    cost walk reads shapes only)."""
    init = model.init

    def zeros_init(key, shape):
        params, state, out = jax.eval_shape(lambda: init(key, shape))
        zeros = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.zeros(a.shape, a.dtype), t)
        return zeros(params), zeros(state), out

    object.__setattr__(model, "init", zeros_init)
    return model


COST_MODELS = {
    "small_model": (jax_small_model, ranks.small_model, (8, 8, 3)),
    "resnet18": (lambda: jax_resnet.resnet18(10, cifar_stem=True),
                 lambda: resnet.resnet18(10, backend="cuda"), (8, 8, 3)),
    "cifar_cnn": (jax_cifar.cifar_cnn, lambda: cifar.cifar_cnn(in_shape=(8, 8, 3)),
                  (8, 8, 3)),
    "vgg16": (jax_vgg.vgg16, lambda: vgg.vgg16(10, backend="cuda"), (32, 32, 3)),
    "resnet50": (lambda: jax_resnet.resnet50(10, cifar_stem=True),
                 lambda: resnet.resnet50(10, cifar_stem=True, backend="cuda"),
                 (8, 8, 3)),
    "resnet50_imagenet": (jax_resnet.resnet50, lambda: resnet.resnet50(backend="cuda"),
                          (32, 32, 3)),
}


@pytest.fixture
def jax_costs_once(monkeypatch):
    """JAX's ``layer_costs`` traced once per (model, shape, microbatch):
    its split, wire and stage-plan helpers each call it again."""
    memo, traced = {}, jax_pp.layer_costs

    def layer_costs(model, in_shape, microbatch=1):
        key = (id(model), tuple(in_shape), microbatch)
        if key not in memo:
            memo[key] = traced(model, in_shape, microbatch)
        return memo[key]

    monkeypatch.setattr(jax_pp, "layer_costs", layer_costs)


@pytest.mark.parametrize("name", sorted(COST_MODELS))
def test_layer_costs_and_split_equal_jax(name, jax_costs_once):
    jax_build, build, shape = COST_MODELS[name]
    jm, tm = _shape_only(jax_build()), build()
    for mb in (1, 2):
        want = [tuple(vars(c).values()) for c in jax_pp.layer_costs(jm, shape, mb)]
        got = [tuple(vars(c).values()) for c in pp.layer_costs(tm, shape, mb)]
        assert got == want
    for s in (2, 4):
        b = jax_pp.split_layers(jm, s, shape)
        assert pp.split_layers(tm, s, shape) == b
        assert pp.wire_numel(tm, shape, b, 1) == jax_pp.wire_numel(jm, shape, b, 1)
        assert pp.boundary_shapes(tm, shape, b, 2) == jax_pp.boundary_shapes(jm, shape, b, 2)
        cfg = (PipelineConfig(stages=s), JaxPipelineConfig(stages=s))
        got, want = ps.stage_plan(tm, cfg[0], shape), jax_stage_plan(jm, cfg[1], shape)
        assert got[0] == want[0] and np.array_equal(got[1], want[1]) and got[2] == want[2]


def test_split_layers_manual_and_rejects():
    jm, tm = _shape_only(jax_small_model()), ranks.small_model()
    assert pp.split_layers(tm, 2, ranks.IN_SHAPE, boundaries=(3,)) == (3,)
    for s, b in ((2, (0,)), (2, (3, 5)), (9, ())):
        with pytest.raises(ValueError) as want:
            jax_pp.split_layers(jm, s, ranks.IN_SHAPE, boundaries=b)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            pp.split_layers(tm, s, ranks.IN_SHAPE, boundaries=b)
    assert np.array_equal(pp.stage_assignment(8, (3, 5)),
                          jax_pp.stage_assignment(8, (3, 5)))


def test_pack_unpack_roundtrip():
    x = torch.arange(24.0).reshape(2, 3, 4)
    buf = pp.pack_acts(x, 20)
    want = jax_pp.pack_acts(jnp.arange(24.0).reshape(2, 3, 4), 20)
    assert buf.shape == (2, 20) and np.array_equal(buf.numpy(), np.asarray(want))
    assert torch.equal(pp.unpack_acts(buf, (2, 3, 4)), x)
    assert pp.pack_acts(x, 12) is not None
    with pytest.raises(ValueError, match="exceeds wire width"):
        pp.pack_acts(x, 11)


# ---------------------------------------------------------------------------
# PipelineConfig, the mesh, the fences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(stages=0), dict(stages=2, wire_dtype="float16"),
                                dict(stages=2, act_dtype="int8"),
                                dict(stages=2, split="3,3"), dict(stages=2, split="x"),
                                dict(stages=3, split="4")])
def test_pipeline_config_rejects_as_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxPipelineConfig(**kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        PipelineConfig(**kw)


def test_pipeline_config_surface_and_env(monkeypatch):
    assert PipelineConfig().stages == 1
    assert PipelineConfig(stages=3, split="5,2").boundaries() == (2, 5)
    names = ("PCNN_PIPELINE_STAGES", "PCNN_PIPELINE_SPLIT",
             "PCNN_PIPELINE_WIRE_DTYPE", "PCNN_PIPELINE_ACT_DTYPE")
    for var in names:
        monkeypatch.delenv(var, raising=False)
    assert PipelineConfig.from_env() is None is JaxPipelineConfig.from_env()
    monkeypatch.setenv("PCNN_PIPELINE_STAGES", "4")
    monkeypatch.setenv("PCNN_PIPELINE_WIRE_DTYPE", "bfloat16")
    assert PipelineConfig.from_env() == PipelineConfig(stages=4, wire_dtype="bfloat16")
    assert vars(PipelineConfig.from_env()) == vars(JaxPipelineConfig.from_env())
    # The flags override the environment field by field, as JAX's CLI.
    args = cli.build_parser().parse_args(["--pipeline-act-dtype", "bfloat16"])
    assert cli._pipeline_from_args(args) == PipelineConfig(
        stages=4, wire_dtype="bfloat16", act_dtype="bfloat16")


def test_mesh_helpers():
    cpu = torch.device("cpu")
    # Meshes whose axes are one rank or the whole world need no groups.
    assert pipeline_axis_sizes(make_pipeline_mesh(1, 2, cpu, 2)) == (2, 1)
    m4 = make_pipeline_mesh(3, 4, cpu, 4)
    assert pipeline_axis_sizes(m4) == (4, 1)
    assert (m4.stage.index, m4.data.index, m4.stage.ranks) == (3, 0, (0, 1, 2, 3))
    assert m4.shape == {"stage": 4, "data": 1}
    m1 = make_pipeline_mesh(2, 3, cpu, 1)
    assert pipeline_axis_sizes(m1) == (1, 3) and m1.data_mesh().rank == 2
    with pytest.raises(ValueError, match="stage"):
        pipeline_axis_sizes(DataMesh(2, 0, cpu))
    with pytest.raises(ValueError, match="does not divide"):
        make_pipeline_mesh(0, 4, cpu, 3)


def test_make_pipeline_step_fences():
    model, cpu = ranks.small_model(), torch.device("cpu")
    mesh = make_pipeline_mesh(0, 2, cpu, 2)
    opt = zoo.make_optimizer(0.1, 0.9)
    kw = dict(accum_steps=2, in_shape=ranks.IN_SHAPE)
    with pytest.raises(ValueError, match="ZeRO-2 only"):
        ps.make_pipeline_step(model, None, mesh=mesh, pipeline=PipelineConfig(stages=2),
                              fused=ranks.fused_zero3(), **kw)
    with pytest.raises(ValueError, match="requires fused.update=True"):
        ps.make_pipeline_step(model, None, mesh=mesh, pipeline=PipelineConfig(stages=2),
                              fused=FusedStepConfig(update=False, act_dtype="float32"),
                              **kw)
    with pytest.raises(ValueError, match="f32-only"):
        ps.make_pipeline_step(model, None, mesh=mesh,
                              pipeline=PipelineConfig(stages=2, act_dtype="bfloat16"),
                              fused=ranks.ZERO2, **kw)
    with pytest.raises(ValueError, match=re.escape(
            "mesh stage axis is 2 but pipeline.stages is 4")):
        ps.make_pipeline_step(model, opt, mesh=mesh, pipeline=PipelineConfig(stages=4),
                              **kw)
    with pytest.raises(ValueError, match="stages=1 delegates"):
        ps.make_pipeline_step(model, None, mesh=make_pipeline_mesh(0, 1, cpu, 1),
                              pipeline=PipelineConfig(stages=1), fused=ranks.ZERO2, **kw)
    with pytest.raises(ValueError, match="no 'stage' axis"):
        ps.make_pipeline_step(model, opt, mesh=DataMesh(1, 0, cpu),
                              pipeline=PipelineConfig(stages=2), **kw)


def test_zoo_train_pipeline_fences():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(16,) + ranks.IN_SHAPE).astype(np.float32)
    Y = rng.integers(0, 10, size=(16,)).astype(np.int32)
    kw = dict(epochs=1, batch_size=8, device="cpu", pipeline=PipelineConfig(stages=2))
    with pytest.raises(ValueError, match=re.escape(
            "pipeline training requires a (stage, data) mesh")):
        zoo.train(ranks.small_model(), X, Y, **kw)
    mesh = make_pipeline_mesh(0, 2, torch.device("cpu"), 2)
    with pytest.raises(ValueError, match="model_axis"):
        zoo.train(ranks.small_model(), X, Y, mesh=mesh, model_axis=True, **kw)
    with pytest.raises(ValueError, match="does not thread augmentation keys"):
        zoo.train(ranks.small_model(), X, Y, mesh=mesh, augment=True, **kw)
    # ZeRO-3 is refused beside the pipeline, with JAX's text.
    with pytest.raises(ValueError, match=re.escape(
            "pipeline composes with ZeRO-2 only: ZeRO-3's just-in-time head "
            "gathers contradict per-stage param residency")):
        zoo.train(ranks.small_model(), X, Y, mesh=mesh, comm=ranks.RING,
                  fused=ranks.fused_zero3(), **kw)


# ---------------------------------------------------------------------------
# BatchNorm's running statistics and the recompute
# ---------------------------------------------------------------------------

def test_recompute_leaves_running_stats_as_the_forward_tick_did():
    torch.manual_seed(0)
    model = ranks.small_model().train()
    plan = ps.pipeline_plan(model, PipelineConfig(stages=2, split="2"), ranks.IN_SHAPE, 2)
    stage = ps.make_stages(model, plan)[0]
    x = torch.randn((4,) + ranks.IN_SHAPE)
    bn = model[1]
    before = (bn.mean.clone(), bn.var.clone())
    out, _ = stage.forward(x, None)
    after = (bn.mean.clone(), bn.var.clone())
    assert not torch.equal(before[0], after[0]) and not torch.equal(before[1], after[1])
    cot = torch.randn_like(out)
    d_inp, grads = stage.backward(x, None, cot)
    assert torch.equal(bn.mean, after[0]) and torch.equal(bn.var, after[1])
    assert d_inp is None and len(grads) == len(stage.params) == 4
    # The recompute's gradients are those of the forward on the batch's
    # statistics: a plain autograd pass over the same layers.
    ref = torch.autograd.grad(
        pp.pack_acts(torch.nn.Sequential(*list(model)[:2])(x), plan.a_buf), stage.params,
        grad_outputs=cot)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The step in a world of 4 gloo ranks, against the flat ring and JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipe_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(ranks.STEPS, ranks.BATCH) + ranks.IN_SHAPE).astype(np.float32)
    Y = rng.integers(0, 10, size=(ranks.STEPS, ranks.BATCH)).astype(np.int32)
    init = jax_small_model().init(jax.random.PRNGKey(7), ranks.IN_SHAPE)[:2]
    init = jax.tree_util.tree_map(np.asarray, init)
    sd = {k: v.numpy() for k, v in convert.from_jax(*init).items()}
    return X, Y, init, sd


@pytest.fixture(scope="module")
def world(pipe_data):
    X, Y, _, sd = pipe_data
    return distributed.run(ranks.pipeline_cases, ranks.WORLD, device="cpu",
                           args=(dict(sd=sd, X=X, Y=Y),), timeout=WORLD_TIMEOUT_S)


def _jax_pipeline(pipe_data, n_stages, fused=False, **pipe_kw):
    """JAX's make_pipeline_step on a (stage, data) mesh of 4 host devices:
    its losses and its flat state after ranks.STEPS steps."""
    X, Y, (params, state), _ = pipe_data
    mesh = jax_mesh.make_pipeline_mesh(n_stages, devices=jax.devices()[:ranks.WORLD])
    comm = JaxCommConfig(impl="ring")
    pipeline = JaxPipelineConfig(stages=n_stages, **pipe_kw)
    model = jax_small_model()
    params, state = jax.tree_util.tree_map(jnp.asarray, (params, state))
    if not fused:
        opt = jax_zoo.make_optimizer(lr=ranks.LR, momentum=ranks.MOMENTUM)
        st = jax_zoo.ZooState(params, state, opt.init(params))
        step = jax_make_pipeline_step(model, opt, accum_steps=ranks.ACCUM, mesh=mesh,
                                      pipeline=pipeline, in_shape=ranks.IN_SHAPE,
                                      comm=comm)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        cfg = JaxFusedStepConfig(update=True, tail=False, act_dtype="float32")
        n_data = ranks.WORLD // n_stages
        st, _ = jax_zoo.init_fused_state(model, jax.random.PRNGKey(7), ranks.IN_SHAPE,
                                         n_data=n_data, fused=cfg,
                                         bucket_bytes=comm.bucket_bytes)
        put = lambda t, spec: jax.device_put(t, NamedSharding(mesh, spec))  # noqa: E731
        opt = st.opt_state
        st = jax_zoo.ZooState(
            params=put(params, P()), model_state=put(state, P()),
            opt_state=jax_zoo.FusedOptState(
                mom=[put(m, P("data")) for m in opt.mom], scale=put(opt.scale, P()),
                good_steps=put(opt.good_steps, P()), skipped=put(opt.skipped, P())))
        step = jax_make_pipeline_step(model, None, accum_steps=ranks.ACCUM, mesh=mesh,
                                      pipeline=pipeline, in_shape=ranks.IN_SHAPE,
                                      comm=comm, fused=cfg, lr=ranks.LR,
                                      momentum=ranks.MOMENTUM)
    losses = []
    for i in range(ranks.STEPS):
        st, loss = step(st, jnp.asarray(X[i]), jnp.asarray(Y[i]))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in jax_checkpoint._flatten(st).items()}


def _assert_close(got, want, tol, what, trace_scale=None):
    """Losses and every leaf within ``tol``; with ``trace_scale``, the
    momentum traces (the summed gradients) within trace_scale × max(1, the
    leaf's largest value) instead."""
    (g_losses, g_arrays), (w_losses, w_arrays) = got, want
    np.testing.assert_allclose(g_losses, w_losses, atol=tol, rtol=0,
                               err_msg=f"{what} losses")
    assert sorted(g_arrays) == sorted(w_arrays), what
    for k, v in w_arrays.items():
        atol = tol
        if trace_scale is not None and "/.trace/" in k:
            atol = trace_scale * max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(g_arrays[k], v, atol=atol, rtol=0,
                                   err_msg=f"{what} {k}")


def _assert_replicated(world, case):
    """Every rank ends a step with the same params and BN statistics."""
    ref = world[0][case][1]
    for r in range(1, ranks.WORLD):
        for k, v in world[r][case][1].items():
            if not k.startswith(".opt_state/.mom/"):
                assert np.array_equal(v, ref[k]), (case, r, k)


def test_one_stage_is_the_flat_ring_bit_for_bit(world):
    for r in range(ranks.WORLD):
        got, want = world[r]["s1"], world[r]["flat4"]
        assert got[0] == want[0]
        assert all(np.array_equal(got[1][k], v) for k, v in want[1].items())


@pytest.mark.parametrize("case,n_stages,flat", [("s2", 2, "flat2"), ("s4", 4, "flat1"),
                                               ("s4_split", 4, "flat1")])
def test_stages_match_the_flat_ring_and_jax(world, pipe_data, case, n_stages, flat):
    _assert_replicated(world, case)
    got = world[0][case]
    # The pipelined step and the flat ring at D ranks: the same optax state.
    _assert_close(got, world[0][flat], TOL, f"{case} vs {flat}")
    if case != "s4_split":  # JAX's step at S = 4 takes ~10 s to compile
        _assert_close(got, _jax_pipeline(pipe_data, n_stages), TOL, f"{case} vs JAX")


def test_bf16_wire_and_activations(world, pipe_data):
    _assert_replicated(world, "s2_bf16")
    got = world[0]["s2_bf16"]
    # A bf16 gradient rounds differently in XLA (it sums a broadcast's
    # transpose in bf16) than in the port: the summed gradients, the
    # momentum traces, are held to the bf16 step test's bound
    # (tests/test_torch_bf16.py), 0.1 of the leaf's scale.
    _assert_close(got, _jax_pipeline(pipe_data, 2, wire_dtype="bfloat16",
                                     act_dtype="bfloat16"), BF16_TOL, "bf16 vs JAX",
                  trace_scale=0.1)
    # JAX's contract: the bf16 pipeline's losses within 1e-2 of the f32 ring's.
    np.testing.assert_allclose(got[0], world[0]["flat2"][0], atol=BF16_TOL, rtol=0)


def test_zero2_tail(world, pipe_data):
    _assert_replicated(world, "s2_zero2")
    got = world[0]["s2_zero2"]
    want = _jax_pipeline(pipe_data, 2, fused=True)
    # Each data rank holds its momentum row; rank 0's checkpoint gathers them.
    _assert_close(got, want, TOL, "zero2 vs JAX")
    np.testing.assert_allclose(got[0], world[0]["flat2"][0], atol=TOL, rtol=0)
    for k, v in world[0]["flat2"][1].items():
        if k.startswith((".params/", ".model_state/")):
            np.testing.assert_allclose(got[1][k], v, atol=TOL, rtol=0, err_msg=k)


def test_running_stats_after_a_step_equal_the_flat_ring(world):
    for r in range(ranks.WORLD):
        got, want = world[r]["bn_s2"], world[r]["bn_flat2"]
        assert sorted(got) == sorted(want) and got
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_trains_resnet18_over_two_stages(capfd):
    # Rank 0 is a spawned gloo rank: its lines reach the captured fd 1.
    assert cli.main(["--device", "cpu", "--model", "resnet18", "--conv-backend", "cuda",
                     "--pipeline-stages", "2", "--accum-steps", "2", "--batch-size", "8",
                     "--lr", "0.01", "--epochs", "1", "--synthetic-train-count", "8",
                     "--synthetic-test-count", "8"]) == 0
    lines = capfd.readouterr().out.splitlines()
    assert lines[0] == "mesh: {'stage': 2, 'data': 1} (pipeline)"
    epochs = [ln for ln in lines if ln.startswith("epoch ")]
    assert len(epochs) == 1, lines
    assert re.fullmatch(r"epoch 1: loss \d+\.\d{4}, acc \d+\.\d\d% \(\d+\.\d\ds\)",
                        epochs[0]), epochs


def test_cli_refuses_two_stages_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(distributed.MeshSizeError, match="2 cards"):
        cli.main(["--model", "resnet18", "--conv-backend", "cuda",
                  "--pipeline-stages", "2", "--accum-steps", "2"])
    assert distributed.resolve_pipeline_shape(1, "cuda") == (1, 1)
    assert distributed.resolve_pipeline_shape(2, "cpu") == (2, 1)


def test_cli_pipeline_refusals():
    base = ["--device", "cpu", "--model", "cifar_cnn"]
    with pytest.raises(SystemExit, match=re.escape(
            "--pipeline-stages builds its own (stage, data) mesh over all devices; "
            "drop --mesh-data/--mesh-model")):
        cli.main(base + ["--pipeline-stages", "2", "--mesh-data", "2"])
    with pytest.raises(ValueError, match="reference trainer drives a flat"):
        cli.main(["--device", "cpu", "--pipeline-stages", "2"])
