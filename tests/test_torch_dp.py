"""Data-parallel zoo training in the port against the JAX package on the
CPU: B13's plain version against JAX's ``fused_sgd_momentum`` (interpret
mode), and, in one spawned gloo world of two ranks
(``tests/_torch_dp_ranks.dp_steps``), on the tiny conv-BN model of
``tests/test_fused_step.py:377-425`` (8×8×3, batch 16, accum 2, 2048-byte
buckets, lr 0.05, momentum 0.9, 3 steps) against a 2-device JAX mesh:

- update-on-arrival against JAX's ``make_fused_train_step``;
- the unfused ring step against JAX's unfused ring step;
- the port's psum against the port's ring;
- on a BN-free model, psum and ring against the port's single-device
  step;
- an f32 overflow skipped bit for bit, then a clean step;
- a checkpoint the port wrote read by JAX's checkpoint code and continued
  by JAX's fused step, and resumed inside the port bit for bit;
- the CLI and the typed errors.

Loss, params and BN statistics within 1e-5, JAX's own bound for these
steps. Nothing is held against JAX's ``impl="psum"`` step: on jax 0.9.0 it
applies the summed gradient n_data times over (a BN-free model on 8
devices: loss 5.8889 at step 2 against 1.9767 for one device, GSPMD and
the ring; ROADMAP Queue C has the table)."""

import os
import re
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_ranks as ranks
from parallel_cnn_tpu.config import CommConfig as JaxCommConfig
from parallel_cnn_tpu.config import FusedStepConfig as JaxFusedStepConfig
from parallel_cnn_tpu.config import MeshConfig as JaxMeshConfig
from parallel_cnn_tpu.nn import core as jax_core
from parallel_cnn_tpu.nn import layers as jax_layers
from parallel_cnn_tpu.ops import pallas_update
from parallel_cnn_tpu.parallel import mesh as jax_mesh
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch.config import (
    COMM_DATA_ONLY_ERROR,
    CommConfig,
    FusedStepConfig,
    MeshConfig,
    MeshLayoutError,
    check_comm_mesh,
)
from parallel_cnn_tpu_torch.ops import sgd_update
from parallel_cnn_tpu_torch.parallel import distributed
from parallel_cnn_tpu_torch.parallel.mesh import DataMesh
from parallel_cnn_tpu_torch.train import zoo

ATOL = 1e-5
WORLD_TIMEOUT_S = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ---------------------------------------------------------------------------
# B13's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,scale", [(1, 1.0), (3 * 128 + 5, 0.25), (5130, 1 / 3)])
def test_sgd_momentum_plain_matches_jax(n, scale):
    rng = np.random.default_rng(n)
    p, m, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    want_p, want_m = pallas_update.fused_sgd_momentum(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(g), lr=0.05, momentum=0.9,
        scale=jnp.float32(scale))
    got_p, got_m = sgd_update.fused_sgd_momentum(
        torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(g), lr=0.05,
        momentum=0.9, scale=torch.tensor(scale, dtype=torch.float32))
    # tests/test_fused_step.py:77's bounds: the kernels compile apart, so
    # an FMA contraction may move an ulp.
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=3e-7, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=3e-7, atol=1e-6)


@pytest.mark.parametrize("sizes", [(1, 3, 127), (5, 1001, 2, 4099)])
def test_sgd_momentum_buckets_match_jax_per_bucket(sizes):
    """The list form (one launch over all buckets on the card; the plain
    version per bucket here) against JAX's one-bucket kernel on each."""
    rng = np.random.default_rng(sum(sizes))
    bufs = [[rng.standard_normal(n).astype(np.float32) for n in sizes] for _ in range(3)]
    got_p, got_m = sgd_update.fused_sgd_momentum_buckets(
        *([torch.from_numpy(a) for a in arrays] for arrays in bufs), lr=0.05,
        momentum=0.9, scale=torch.tensor(0.25, dtype=torch.float32))
    assert len(got_p) == len(got_m) == len(sizes)
    for i, (p, m, g) in enumerate(zip(*bufs)):
        want_p, want_m = pallas_update.fused_sgd_momentum(
            jnp.asarray(p), jnp.asarray(m), jnp.asarray(g), lr=0.05, momentum=0.9,
            scale=jnp.float32(0.25))
        # The bounds of test_sgd_momentum_plain_matches_jax above.
        np.testing.assert_allclose(got_m[i].numpy(), np.asarray(want_m), rtol=3e-7,
                                   atol=1e-6)
        np.testing.assert_allclose(got_p[i].numpy(), np.asarray(want_p), rtol=3e-7,
                                   atol=1e-6)


def test_wrapper_max_entries_is_the_kernel_sources():
    """The wrapper cuts a list into launches of MAX_ENTRIES, the size of the
    kernel's parameter struct in csrc/sgd_update.cu; the library reports its
    own, which the wrapper checks when it loads it."""
    with open(os.path.join(REPO, "parallel_cnn_tpu_torch/csrc/sgd_update.cu")) as f:
        src = f.read()
    assert re.findall(r"constexpr int MAX_ENTRIES = (\d+);", src) == [
        str(sgd_update.MAX_ENTRIES)]
    assert "sgd_momentum_max_entries" in sgd_update._library.symbols
    assert "sgd_momentum_max_entries()" in src


def test_sgd_momentum_buckets_refuse_what_the_kernel_does_not_take():
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="non-empty lists"):
        sgd_update.fused_sgd_momentum_buckets([], [], [], lr=0.1, momentum=0.9)
    with pytest.raises(ValueError, match="non-empty lists"):
        sgd_update.fused_sgd_momentum_buckets([p, p], [p], [p, p], lr=0.1, momentum=0.9)
    with pytest.raises(ValueError, match="matching"):
        sgd_update.fused_sgd_momentum_buckets([p, p], [p, torch.zeros(3)], [p, p],
                                              lr=0.1, momentum=0.9)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="must lie on"):
        sgd_update.fused_sgd_momentum_buckets([p, p], [p, meta], [p, p], lr=0.1,
                                              momentum=0.9)


def _counted_fused_steps(mesh, steps):
    """On one rank: ``steps`` update-on-arrival steps of the tiny conv-BN
    model; returns the bucket count of every fused_sgd_momentum_buckets
    call and the momentum blocks of the state."""
    calls = []
    real = sgd_update.fused_sgd_momentum_buckets

    def counting(ps, ms, gs, **kw):
        calls.append(len(ps))
        return real(ps, ms, gs, **kw)

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((16, *ranks.TINY_SHAPE)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 16))
    with mock.patch.object(sgd_update, "fused_sgd_momentum_buckets", counting):
        state, step = ranks._fused(ranks.tiny_model(), mesh)
        for _ in range(steps):
            step(state, x, y)
    return calls, len(state.fused.mom)


def test_update_on_arrival_updates_every_bucket_in_one_call():
    """The step hands every bucket shard to one list call a step (one
    kernel launch on the card), not one call a bucket."""
    calls, n_buckets = distributed.run(_counted_fused_steps, 1, device="cpu",
                                       args=(3,))[0]
    assert n_buckets > 1
    assert calls == [n_buckets] * 3


def test_sgd_momentum_wrapper_refuses_what_the_kernel_does_not_take():
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="matching"):
        sgd_update.fused_sgd_momentum(p, torch.zeros(5), p, lr=0.1, momentum=0.9)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sgd_update.fused_sgd_momentum(meta, meta, meta, lr=0.1, momentum=0.9)


# ---------------------------------------------------------------------------
# One world of two ranks against a 2-device JAX mesh
# ---------------------------------------------------------------------------


def _jax_tiny(bn=True):
    layers = [jax_layers.Conv2D(4, (3, 3))]
    if bn:
        layers.append(jax_layers.BatchNorm())
    layers += [jax_layers.ReLU(), jax_layers.MaxPool(), jax_layers.Flatten(),
               jax_layers.Dense(10)]
    return jax_core.Sequential(layers)


JAX_COMM = dict(impl="ring", bucket_bytes=ranks.BUCKET_BYTES, overlap=True)


@pytest.fixture(scope="module")
def jax_mesh2(host_devices):
    return jax_mesh.make_mesh(JaxMeshConfig(data=2, model=1))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16,) + ranks.TINY_SHAPE).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def jax_init():
    model = _jax_tiny()
    params, state, _ = model.init(jax.random.key(7), ranks.TINY_SHAPE)
    return jax.tree_util.tree_map(np.asarray, (params, state))


def _sd(params, state):
    return {k: v.numpy() for k, v in convert.from_jax(params, state).items()}


@pytest.fixture(scope="module")
def dp(tmp_path_factory, batch, jax_init):
    """Every rank's results of ``dp_steps`` from one spawned world of 2."""
    x, y = batch
    x_inf = x.copy()
    x_inf[0, 0, 0, 0] = np.inf
    nobn = ranks.tiny_model(bn=False, seed=3)
    spec = dict(sd=_sd(*jax_init),
                sd_nobn={k: v.numpy() for k, v in nobn.state_dict().items()},
                x=x, y=y, x_inf=x_inf,
                ckpt=str(tmp_path_factory.mktemp("dp") / "ckpt_3.npz"))
    results = distributed.run(ranks.dp_steps, 2, device="cpu", args=(spec,),
                              timeout=WORLD_TIMEOUT_S)
    return spec, results


def _jax_fused(mesh, params, state):
    comm = JaxCommConfig(**JAX_COMM)
    fused = JaxFusedStepConfig(update=True, tail=True, act_dtype="float32")
    st, nb = jax_zoo.init_fused_state(_jax_tiny(), jax.random.key(7), ranks.TINY_SHAPE,
                                      n_data=2, fused=fused,
                                      bucket_bytes=comm.bucket_bytes)
    st = jax_zoo.ZooState(jax.tree_util.tree_map(jnp.asarray, params),
                          jax.tree_util.tree_map(jnp.asarray, state), st.opt_state)
    step = jax_zoo.make_fused_train_step(
        _jax_tiny(), lr=ranks.LR, momentum=ranks.MOMENTUM, accum_steps=ranks.ACCUM,
        mesh=mesh, augment=None, comm=comm, fused=fused, n_buckets=nb)
    return st, step


def _jax_steps(st, step, x, y, n):
    losses = []
    for _ in range(n):
        st, loss = step(st, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return st, losses


def _assert_state_close(port_sd, jax_params, jax_state):
    want = _sd(jax.tree_util.tree_map(np.asarray, jax_params),
               jax.tree_util.tree_map(np.asarray, jax_state))
    assert sorted(port_sd) == sorted(want)
    for k in want:
        assert _max_diff(port_sd[k], want[k]) <= ATOL, k


def test_update_on_arrival_matches_jax_fused_step(dp, jax_mesh2, batch, jax_init):
    _, results = dp
    x, y = batch
    st, step = _jax_fused(jax_mesh2, *jax_init)
    st, losses = _jax_steps(st, step, x, y, 3)
    for r in range(2):
        assert _max_diff(results[r]["fused_losses"], losses) <= ATOL
        _assert_state_close(results[r]["fused_state"], st.params, st.model_state)
    # The momentum rows, gathered whole, as JAX's (2, L) blocks hold them.
    mom = results[0]["fused_arrays"]
    for b, block in enumerate(st.opt_state.mom):
        assert mom[f".opt_state/.mom/{b}"].shape == block.shape
        assert _max_diff(mom[f".opt_state/.mom/{b}"], block) <= ATOL


def test_unfused_ring_matches_jax_ring(dp, jax_mesh2, batch, jax_init):
    _, results = dp
    x, y = batch
    params, state = jax_init
    opt = jax_zoo.make_optimizer(lr=ranks.LR, momentum=ranks.MOMENTUM)
    st = jax_zoo.ZooState(jax.tree_util.tree_map(jnp.asarray, params),
                          jax.tree_util.tree_map(jnp.asarray, state),
                          opt.init(jax.tree_util.tree_map(jnp.asarray, params)))
    step = jax_zoo.make_train_step(_jax_tiny(), opt, accum_steps=ranks.ACCUM,
                                   mesh=jax_mesh2, comm=JaxCommConfig(**JAX_COMM))
    st, losses = _jax_steps(st, step, x, y, 3)
    for r in range(2):
        assert _max_diff(results[r]["ring_losses"], losses) <= ATOL
        _assert_state_close(results[r]["ring_state"], st.params, st.model_state)


def test_psum_matches_ring(dp):
    _, results = dp
    for r in range(2):
        res = results[r]
        assert _max_diff(res["psum_losses"], res["ring_losses"]) <= ATOL
        for k in res["ring_state"]:
            assert _max_diff(res["psum_state"][k], res["ring_state"][k]) <= ATOL, k


def test_bn_free_psum_and_ring_match_the_single_device_step(dp, batch):
    """Without BN the sharding is invisible: world 2 equals one device on
    the whole batch. (Not JAX's psum: see the module docstring.)"""
    spec, results = dp
    x, y = batch
    model = ranks._model_from(spec["sd_nobn"], bn=False)
    opt = zoo.make_optimizer(ranks.LR, ranks.MOMENTUM)
    state = zoo.init_state(model, opt)
    step = zoo.make_train_step(model, opt, ranks.ACCUM)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    losses = [float(step(state, xt, yt)) for _ in range(3)]
    want = ranks._np_state(model)
    for r in range(2):
        for name in ("psum", "ring"):
            assert _max_diff(results[r][f"{name}_nobn_losses"], losses) <= ATOL
            got = results[r][f"{name}_nobn_state"]
            for k in want:
                assert _max_diff(got[k], want[k]) <= ATOL, (name, k)


def test_overflow_skips_bit_for_bit_then_trains(dp):
    _, results = dp
    for r in range(2):
        res = results[r]
        before, after, clean = res["inf_before"], res["inf_after"], res["clean_after"]
        assert not np.isfinite(res["inf_loss"])
        for k in before:
            if k == ".opt_state/.skipped":
                continue
            assert np.array_equal(after[k], before[k]), k
        assert int(before[".opt_state/.skipped"]) == 0
        assert int(after[".opt_state/.skipped"]) == 1
        assert int(clean[".opt_state/.skipped"]) == 1
        assert float(after[".opt_state/.scale"]) == 1.0  # f32 pins the scale
        moved = [k for k in before if k.startswith((".params", ".opt_state/.mom"))
                 and not np.array_equal(clean[k], after[k])]
        assert len(moved) == len([k for k in before if k.startswith(
            (".params", ".opt_state/.mom"))])


def test_resume_in_the_port_is_bit_identical(dp):
    _, results = dp
    for r in range(2):
        res = results[r]
        assert res["resumed_epoch"] == 3
        assert res["resumed_losses"] == res["cont_losses"]
        for k, v in res["cont_arrays"].items():
            assert np.array_equal(res["resumed_arrays"][k], v), k


def test_port_checkpoint_continues_under_jax(dp, jax_mesh2, batch, jax_init):
    """The file rank 0 wrote after 3 fused steps is read by JAX's
    ``checkpoint.restore`` into its fused state (momentum as (2, L)
    blocks) and continued 2 steps by JAX's fused step."""
    spec, results = dp
    x, y = batch
    template, step = _jax_fused(jax_mesh2, *jax_init)
    st, tstate = jax_checkpoint.restore(spec["ckpt"], template)
    assert tstate.epoch == 3
    st, losses = _jax_steps(st, step, x, y, 2)
    res = results[0]
    assert _max_diff(res["cont_losses"], losses) <= ATOL
    flat = jax_checkpoint._flatten(st)
    assert sorted(flat) == sorted(res["cont_arrays"])
    for k, v in flat.items():
        assert _max_diff(res["cont_arrays"][k], v) <= ATOL, k


# ---------------------------------------------------------------------------
# The CLI and the typed errors
# ---------------------------------------------------------------------------


def test_cli_trains_update_on_arrival_over_two_gloo_ranks(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "2"  # test workers share the machine
    argv = [sys.executable, "-m", "parallel_cnn_tpu_torch", "--device", "cpu",
            "--model", "cifar_cnn", "--mesh-data", "2", "--comm-impl", "ring",
            "--fused-step", "--act-dtype", "float32", "--batch-size", "16",
            "--lr", "0.01", "--epochs", "2", "--synthetic-train-count", "64",
            "--synthetic-test-count", "32", "--checkpoint-dir", str(tmp_path)]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=WORLD_TIMEOUT_S,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert "mesh: {'data': 2, 'model': 1}" in lines
    epochs = [ln for ln in lines if ln.startswith("epoch ")]
    assert len(epochs) == 2 and all("acc" in ln for ln in epochs)
    assert "falling back" not in proc.stdout
    with np.load(tmp_path / "ckpt_2.npz") as z:
        assert z[".opt_state/.mom/0"].shape[0] == 2  # both ranks' rows


@pytest.mark.parametrize("argv,err,match", [
    # The hierarchical ring builds its own (host, device) mesh: JAX's plan
    # refuses --mesh-data beside it.
    (["--comm-impl", "hierarchical"], SystemExit, re.escape(
        "--comm-impl hierarchical builds its own (host, device) mesh over all "
        "devices; drop --mesh-data/--mesh-model (size the host axis with "
        "--comm-hosts)")),
    # A zoo model axis is the GSPMD path; the explicit collectives refuse
    # it with JAX's data-only error.
    (["--mesh-model", "2", "--comm-impl", "ring"], MeshLayoutError,
     "data-parallel only"),
    # JAX runs --comm-hosts 2 beside a flat mesh (psum, the host axis
    # unused); a host axis below one is JAX's CommConfig error.
    (["--comm-hosts", "0"], ValueError, "hosts must be >= 1, got 0"),
    # The pipeline builds its own (stage, data) mesh: JAX's plan refuses
    # --mesh-data beside it.
    (["--pipeline-stages", "2"], SystemExit, r"builds its own \(stage, data\) mesh"),
    # --elastic on lenet_ref: JAX's fence (cli.py:1309-1316).
    (["--model", "lenet_ref", "--elastic"], SystemExit, re.escape(
        "--elastic needs the zoo ZeRO-3 trainer: pick a zoo --model "
        "(e.g. cifar_cnn) with --mesh-data, --comm-impl ring and "
        "--fused-step")),
])
def test_cli_refuses_unported_paths(argv, err, match):
    with pytest.raises(err, match=match):
        cli.main(["--device", "cpu", "--model", "cifar_cnn", "--mesh-data", "2",
                  *argv])


def test_typed_config_errors():
    with pytest.raises(ValueError, match="hosts must be >= 1, got 0"):
        CommConfig(hosts=0)
    # A zoo model axis is JAX's GSPMD path; only the explicit collectives
    # (comm) refuse it, with JAX's data-only error.
    assert MeshConfig(data=2, model=2).model == 2
    assert check_comm_mesh(MeshConfig(data=2, model=2), None) is None
    with pytest.raises(MeshLayoutError, match=re.escape(COMM_DATA_ONLY_ERROR)):
        check_comm_mesh(MeshConfig(data=2, model=2), CommConfig(impl="ring"))
    with pytest.raises(ValueError, match="zero=3 shards params into the "
                       "update-on-arrival path and requires update=True"):
        FusedStepConfig(update=False, zero=3)
    with pytest.raises(ValueError, match="zero level"):
        FusedStepConfig(zero=1)


def test_mesh_data_above_the_card_count_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(distributed.MeshSizeError, match="2 cards"):
        distributed.resolve_world(MeshConfig(data=2), "cuda")
    assert distributed.resolve_world(MeshConfig(data=None), "cuda") == 1
    assert distributed.resolve_world(MeshConfig(data=3), "cpu") == 3


def test_fused_update_without_the_ring_falls_back(capsys):
    model = ranks.tiny_model()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32,) + ranks.TINY_SHAPE).astype(np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)
    zoo.train(model, x, y, batch_size=16, lr=0.01, device="cpu",
              fused=FusedStepConfig(act_dtype="float32"))
    assert "falling back to fused tail only" in capsys.readouterr().out


def test_fused_update_refuses_schedules_and_the_gspmd_path():
    x = np.zeros((16,) + ranks.TINY_SHAPE, np.float32)
    y = np.zeros(16, np.int32)
    mesh = DataMesh(1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="constant-LR"):
        zoo.train(ranks.tiny_model(), x, y, batch_size=16, device="cpu", mesh=mesh,
                  comm=CommConfig(impl="ring"), lr_schedule="cosine",
                  fused=FusedStepConfig(act_dtype="float32"))
    # A mesh without comm is the GSPMD step (a data-only mesh of one rank).
    assert callable(zoo.make_train_step(ranks.tiny_model(), zoo.make_optimizer(),
                                        mesh=mesh))
    with pytest.raises(ValueError, match="model_axis sharding stays on the GSPMD"):
        zoo.make_train_step(ranks.tiny_model(), zoo.make_optimizer(), mesh=mesh,
                            comm=CommConfig(impl="ring"), model_axis=True)
    with pytest.raises(ValueError, match="requires a mesh"):
        zoo.make_train_step(ranks.tiny_model(), zoo.make_optimizer(),
                            comm=CommConfig(impl="ring"))
