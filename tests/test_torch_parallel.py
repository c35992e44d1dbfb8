"""The port's mesh-routed LeNet-ref training against the JAX package on the
CPU: ``parallel_cnn_tpu_torch/parallel/{mesh,data_parallel,intra_op}.py``
against ``parallel_cnn_tpu/parallel/`` on meshes of the same shape over the
8-device host platform.

Three spawned gloo worlds, every case of a world in one spawn
(``tests/_torch_parallel_ranks.py``):

- 2 × 1: ``make_dp_step`` with comm None, psum, the ring and the ring with
  a bf16 wire (held against JAX's ``make_dp_step`` with the same comm),
  ``make_dp_eval`` with a pad mask, ``make_dp_epoch``, and the CLI's job
  run straight and resumed;
- 1 × 3: ``make_2d_step`` and ``make_2d_forward``, ``shard_params`` and
  its inverse;
- 2 × 2: ``make_2d_step`` with the ring, a checkpoint written from the
  split params that JAX's ``checkpoint.restore`` reads, and a NaN in one
  rank's shard rolled back by every rank.

Weights are JAX's ``lenet_ref.init`` through ``convert.lenet_from_jax``,
inputs a seeded numpy batch of 16; params and errors within 1e-5 abs +
1e-5 rel (JAX's own bound in ``tests/test_parallel.py``). The port sums
over a batch dimension where JAX vmaps, and sums the pool grads over the
batch before their model-axis psum, so the two agree to rounding, not bit
for bit. Bit-exact: the gathered params, every rank's copy, resume."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_parallel_ranks as ranks
from parallel_cnn_tpu.config import CommConfig as JaxCommConfig
from parallel_cnn_tpu.config import MeshConfig as JaxMeshConfig
from parallel_cnn_tpu.models import lenet_ref as jlenet
from parallel_cnn_tpu.ops import reference as jref
from parallel_cnn_tpu.parallel import data_parallel as jdp
from parallel_cnn_tpu.parallel import intra_op as jio
from parallel_cnn_tpu.parallel import mesh as jmesh
from parallel_cnn_tpu.train import checkpoint as jcheckpoint
from parallel_cnn_tpu.train import step as jstep
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch import plan as pplan
from parallel_cnn_tpu_torch.config import MeshConfig, MeshLayoutError
from parallel_cnn_tpu_torch.data import synthetic
from parallel_cnn_tpu_torch.ops import reference
from parallel_cnn_tpu_torch.parallel import distributed, intra_op
from parallel_cnn_tpu_torch.parallel import mesh as mesh_lib

ATOL = RTOL = 1e-5
WORLD_TIMEOUT_S = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_params(seed=7):
    return jax.tree_util.tree_map(np.asarray, jlenet.init(jax.random.key(seed)))


def _port_params(jp):
    return {k: {n: t.numpy() for n, t in v.items()}
            for k, v in convert.lenet_from_jax(jp).items()}


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def _assert_close(got, want, what=""):
    for layer in want:
        for name in want[layer]:
            np.testing.assert_allclose(np.asarray(got[layer][name]),
                                       np.asarray(want[layer][name]), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{what} {layer}/{name}")


def _jax_mesh(data, model):
    return jmesh.make_mesh(JaxMeshConfig(data=data, model=model))


def _jax_comm(name):
    comm = ranks.COMMS[name]
    if comm is None:
        return None
    return JaxCommConfig(impl=comm.impl, bucket_bytes=comm.bucket_bytes,
                         wire_dtype=comm.wire_dtype)


def _jax_steps(step, params, x, y, steps=ranks.STEPS):
    errs = []
    for _ in range(steps):
        params, e = step(params, x, y)
        errs.append(float(e))
    return params, errs


def _on_device(tree, device):
    """The value a (replicated) JAX output holds on one device. A ring with
    a bf16 wire leaves each rank its own: its chunk of each bucket summed
    in f32, the others as they arrived in bf16."""
    def one(a):
        (piece,) = [s.data for s in a.addressable_shards if s.device == device]
        return np.asarray(piece)
    return jax.tree_util.tree_map(one, tree)


def _assert_coords(results, data, model):
    """Rank r sits at (r // M, r % M) of JAX's reshape(data, model) layout;
    its axes' ranks are its row and column of that grid."""
    grid = np.arange(data * model).reshape(data, model)
    for r, res in enumerate(results):
        c = res["coords"]
        d, m = divmod(r, model)
        assert c["rank"] == r
        assert c["data"] == (d, tuple(grid[:, m]))
        assert c["model"] == (m, tuple(grid[d]))


# ---------------------------------------------------------------------------
# World 2 × 1: the data-parallel step, eval and epoch, the CLI's resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jp = _jax_params()
    x, y = _batch(123)
    y_bad = y.copy()
    y_bad[8:] = (y_bad[8:] + 1) % 10
    ex, ey = _batch(5, 2 * 8)
    tmp = tmp_path_factory.mktemp("dp2")
    spec = dict(params=_port_params(jp), x=x, y=y, y_bad=y_bad,
                mask=np.arange(B) < 8, epoch_x=ex.reshape(2, 8, 28, 28),
                epoch_y=ey.reshape(2, 8), straight=str(tmp / "straight"),
                split=str(tmp / "split"))
    results = distributed.run(ranks.dp_cases, 2, device="cpu", args=(spec,),
                              timeout=WORLD_TIMEOUT_S,
                              plan=pplan.ExecutionPlan(data=2, model=1))
    return jp, spec, results


@pytest.mark.parametrize("comm", list(ranks.COMMS))
def test_dp_step_matches_jax(world2, host_devices, comm):
    jp, spec, results = world2
    m = _jax_mesh(2, 1)
    step = jdp.make_dp_step(m, ranks.DT, global_batch=B, comm=_jax_comm(comm))
    xs, ys = jmesh.shard_batch(m, (jnp.asarray(spec["x"]), jnp.asarray(spec["y"])))
    want, want_errs = _jax_steps(step, jmesh.replicate(m, jp), xs, ys)
    for r in range(2):
        got, errs = results[r][comm]
        np.testing.assert_allclose(errs, want_errs, atol=ATOL, rtol=RTOL)
        _assert_close(got, _on_device(want, m.devices[r, 0]), f"{comm} rank {r}")


@pytest.mark.parametrize("comm", ["none", "psum", "ring"])
def test_dp_ranks_end_every_step_with_the_same_params(world2, comm):
    """An f32 all-reduce leaves every rank the same params, bit for bit."""
    _, _, results = world2
    _assert_coords(results, 2, 1)
    a, b = results[0][comm][0], results[1][comm][0]
    assert all(np.array_equal(a[k][n], b[k][n]) for k in a for n in a[k])
    assert results[0][comm][1] == results[1][comm][1]


def test_dp_step_refuses_another_global_batch(world2):
    _, _, results = world2
    for res in results:
        assert res["batch_error"] == f"batch {B} != global_batch {2 * B}"


def test_dp_eval_masks_the_padding_as_jax_does(world2, host_devices):
    jp, spec, results = world2
    m = _jax_mesh(2, 1)
    ev = jdp.make_dp_eval(m)
    args = jmesh.shard_batch(m, tuple(jnp.asarray(spec[k]) for k in ("x", "y_bad", "mask")))
    want = int(ev(jmesh.replicate(m, jp), *args))
    assert want == int(jstep.error_count(jp, jnp.asarray(spec["x"][:8]),
                                         jnp.asarray(spec["y"][:8])))
    assert [res["eval"] for res in results] == [want, want]


def test_dp_epoch_matches_jax(world2, host_devices):
    jp, spec, results = world2
    m = _jax_mesh(2, 1)
    epoch = jdp.make_dp_epoch(m, ranks.DT, global_batch=8)
    want_p, want_e = epoch(jmesh.replicate(m, jp), jnp.asarray(spec["epoch_x"]),
                           jnp.asarray(spec["epoch_y"]))
    want_p = jax.tree_util.tree_map(np.asarray, want_p)
    for r in range(2):
        got_p, got_e = results[r]["epoch"]
        np.testing.assert_allclose(got_e, float(want_e), atol=ATOL, rtol=RTOL)
        _assert_close(got_p, want_p, f"rank {r}")


def test_resume_at_world_2_is_bit_identical(world2):
    _, spec, _ = world2
    with np.load(os.path.join(spec["straight"], "ckpt_2.npz")) as a, \
            np.load(os.path.join(spec["split"], "ckpt_2.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert np.array_equal(a[k], b[k]), k
    assert sorted(os.listdir(spec["split"])) == ["ckpt_1.npz", "ckpt_2.npz"]


# ---------------------------------------------------------------------------
# Worlds 1 × 3 and 2 × 2: the model axis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_worlds(tmp_path_factory):
    jp = _jax_params(11)
    x, y = _batch(17)
    train_x, train_y = synthetic.make_dataset(64, seed=3)
    out = {}
    for shape, comm in (((1, 3), "none"), ((2, 2), "ring")):
        spec = dict(params=_port_params(jp), x=x, y=y, comm=comm)
        if shape == (2, 2):
            spec.update(ckpt=str(tmp_path_factory.mktemp("mp") / "ckpt_1.npz"),
                        train_x=train_x, train_y=train_y,
                        poison_at=len(train_x) // B - 1)
        out[shape] = (spec, distributed.run(
            ranks.model_axis_cases, shape[0] * shape[1], device="cpu", args=(spec,),
            timeout=WORLD_TIMEOUT_S,
            plan=pplan.ExecutionPlan(data=shape[0], model=shape[1])))
    return jp, out


@pytest.mark.parametrize("shape", [(1, 3), (2, 2)], ids=["1x3", "2x2-ring"])
def test_2d_step_matches_jax(model_worlds, host_devices, shape):
    jp, worlds = model_worlds
    spec, results = worlds[shape]
    _assert_coords(results, *shape)
    m = _jax_mesh(*shape)
    step = jio.make_2d_step(m, ranks.DT, global_batch=B, comm=_jax_comm(spec["comm"]))
    xs, ys = jmesh.shard_batch(m, (jnp.asarray(spec["x"]), jnp.asarray(spec["y"])))
    want, want_errs = _jax_steps(step, jio.shard_params(m, jp), xs, ys)
    want = jax.tree_util.tree_map(np.asarray, want)
    for r, res in enumerate(results):
        got, errs = res["step"]
        np.testing.assert_allclose(errs, want_errs, atol=ATOL, rtol=RTOL)
        _assert_close(got, want, f"{shape} rank {r}")


def test_2d_forward_matches_jax(model_worlds, host_devices):
    jp, worlds = model_worlds
    spec, results = worlds[(1, 3)]
    m = _jax_mesh(1, 3)
    want = np.asarray(jio.make_2d_forward(m)(jio.shard_params(m, jp),
                                             jmesh.shard_batch(m, jnp.asarray(spec["x"]))))
    for res in results:
        np.testing.assert_allclose(res["forward"], want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(1, 3), (2, 2)], ids=["1x3", "2x2"])
def test_shards_are_jaxs_and_gather_is_exact(model_worlds, host_devices, shape):
    """Each rank's shard is the block JAX's PARAM_SPECS puts on the device
    at its (data, model) position, and gather_params gives the whole tree
    back bit for bit."""
    jp, worlds = model_worlds
    _, results = worlds[shape]
    m = _jax_mesh(*shape)
    sharded = jio.shard_params(m, jp)
    for r, res in enumerate(results):
        assert res["gather_exact"]
        d, mm = divmod(r, shape[1])
        device = m.devices[d, mm]
        for layer in jp:
            for name in jp[layer]:
                (piece,) = [s.data for s in sharded[layer][name].addressable_shards
                            if s.device == device]
                assert np.array_equal(res["shard"][layer][name], np.asarray(piece)), \
                    (r, layer, name)


def test_model_axis_checkpoint_reads_back_in_jax(model_worlds):
    """trainer.learn on the 2 × 2 mesh hands its epoch callback the whole
    (gathered) params; the file rank 0 saved from them is JAX's format."""
    jp, worlds = model_worlds
    spec, results = worlds[(2, 2)]
    assert all(res["ckpt_exists"] for res in results)
    restored, state = jcheckpoint.restore(spec["ckpt"], jp)
    assert state.epoch == 1 and len(state.epoch_errors) == 1
    for res in results:
        for layer in jp:
            for name in jp[layer]:
                assert np.array_equal(np.asarray(restored[layer][name]),
                                      res["learned"][layer][name]), (layer, name)


def test_a_nan_in_one_shard_rolls_back_every_rank(model_worlds):
    _, worlds = model_worlds
    _, results = worlds[(2, 2)]
    first = results[0]["rollback"]
    assert first["rollbacks"] == 1 and len(first["errors"]) == 2
    assert all(np.isfinite(first["errors"]))
    for res in results[1:]:
        rb = res["rollback"]
        assert rb["rollbacks"] == 1 and rb["errors"] == first["errors"]
        for layer in rb["params"]:
            for name in rb["params"][layer]:
                assert np.array_equal(rb["params"][layer][name],
                                      first["params"][layer][name])


# ---------------------------------------------------------------------------
# No spawn: the layout, the layer helpers, the mesh's arithmetic
# ---------------------------------------------------------------------------


def test_param_specs_are_jaxs():
    def dim(spec):
        axes = [i for i, a in enumerate(spec) if a == jmesh.MODEL_AXIS]
        return axes[0] if axes else None

    for layer, leaves in jio.PARAM_SPECS.items():
        for name, spec in leaves.items():
            assert isinstance(spec, P)
            assert intra_op.PARAM_SPECS[layer][name] == dim(spec), (layer, name)


@pytest.mark.parametrize("n_model", [2, 3, 6])
def test_shard_params_is_a_contiguous_block_per_model_rank(n_model):
    """On a 1 × 1 view with a fake model index: shard m of M is the m-th
    block of c1 (dim 0) and of f.w's columns; the rest is whole."""
    p = convert.lenet_from_jax(_jax_params(3))
    for m in range(n_model):
        view = mesh_lib.Mesh2D(
            world=n_model, rank=m, device=torch.device("cpu"),
            data=mesh_lib.AxisView(1, 0, (m,)),
            model=mesh_lib.AxisView(n_model, m, tuple(range(n_model))))
        s = intra_op.shard_params(view, p)
        k = 6 // n_model
        assert torch.equal(s["c1"]["w"], p["c1"]["w"][m * k:(m + 1) * k])
        assert torch.equal(s["c1"]["b"], p["c1"]["b"][m * k:(m + 1) * k])
        assert torch.equal(s["f"]["w"], p["f"]["w"][:, m * 36 * k:(m + 1) * 36 * k])
        assert s["f"]["w"].is_contiguous()
        for layer, name in (("s1", "w"), ("s1", "b"), ("f", "b")):
            assert torch.equal(s[layer][name], p[layer][name])


def test_layer_helpers_match_jax_and_keep_forward_bits():
    jp = _jax_params(5)
    p = convert.lenet_from_jax(jp)
    x, _ = _batch(9, 5)
    xt = torch.from_numpy(x)
    pre = reference.conv_c1_forward(xt, p["c1"]["w"], p["c1"]["b"])
    want = jax.vmap(lambda s: jref.conv_c1_forward(s, jp["c1"]["w"], jp["c1"]["b"]))(x)
    np.testing.assert_allclose(pre.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    out = torch.sigmoid(pre)
    pool = reference.pool_s1_forward(out, p["s1"]["w"], p["s1"]["b"])
    want = jax.vmap(lambda o: jref.pool_s1_forward(o, jp["s1"]["w"], jp["s1"]["b"]))(
        out.numpy())
    np.testing.assert_allclose(pool.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # A model-axis shard of the filters is the same rows of the whole conv.
    half = reference.conv_c1_forward(xt, p["c1"]["w"][3:], p["c1"]["b"][3:])
    assert torch.equal(half, pre[:, 3:])
    acts = reference.forward(p, xt)
    assert torch.equal(acts.pre_c1, pre)
    assert torch.equal(acts.pre_s1,
                       reference.pool_s1_forward(acts.out_c1, p["s1"]["w"], p["s1"]["b"]))
    patches = jax.vmap(lambda s: jax.lax.conv_general_dilated_patches(
        s[None, None], (5, 5), (1, 1), "VALID")[0])(x)
    assert np.array_equal(reference.patches(xt).numpy(),
                          np.asarray(patches).reshape(5, 25, 576))


@pytest.mark.parametrize("n,k", [(1, 1), (16, 2), (17, 2), (10_000, 3), (5, 8)])
def test_mesh_arithmetic_is_jaxs(n, k):
    assert mesh_lib.pad_to_multiple(n, k) == jmesh.pad_to_multiple(n, k)


def test_shard_batch_and_replicate_on_a_single_device_mesh():
    m = mesh_lib.make_mesh_2d(0, 1, torch.device("cpu"), 1, 1)
    assert (m.data.size, m.model.size, m.data.group, m.model.group) == (1, 1, None, None)
    x = torch.arange(12.0).reshape(6, 2)
    (xs,) = mesh_lib.shard_batch(m, (x,))
    assert torch.equal(xs, x)
    rep = mesh_lib.replicate(m, {"a": x})
    assert torch.equal(rep["a"], x) and rep["a"].data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.Mesh2D(world=2, rank=1, device=torch.device("cpu"),
                        data=mesh_lib.AxisView(4, 1, (0, 1, 2, 3)),
                        model=mesh_lib.AxisView(1, 0, (1,))).shard_rows(x)


def test_resolve_shape_takes_data_times_model_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert distributed.resolve_shape(MeshConfig(model=2), "cuda") == (2, 2)
    assert distributed.resolve_world(MeshConfig(data=2, model=2), "cuda") == 4
    with pytest.raises(distributed.MeshSizeError, match="needs 6 cards"):
        distributed.resolve_shape(MeshConfig(data=2, model=3), "cuda")
    assert distributed.resolve_shape(MeshConfig(data=3, model=2), "cpu") == (3, 2)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_trains_over_two_gloo_ranks():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "2"  # test workers share the machine
    argv = [sys.executable, "-m", "parallel_cnn_tpu_torch", "--device", "cpu",
            "--mesh-data", "2", "--batch-size", "16", "--epochs", "2",
            "--synthetic-train-count", "512", "--synthetic-test-count", "128"]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=WORLD_TIMEOUT_S,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "mesh: {'data': 2, 'model': 1}"
    assert lines.count("Learning") == 1  # rank 0 alone prints
    assert len([ln for ln in lines if ln.startswith("error: ")]) == 2
    assert any(ln.startswith(" Time - ") for ln in lines)
    assert len([ln for ln in lines if ln.startswith("Error Rate: ")]) == 1


@pytest.mark.parametrize("argv,match", [
    (["--mesh-model", "2", "--ops", "cuda", "--batch-size", "16"], "data axis only"),
    (["--mesh-model", "4", "--batch-size", "16"], "divide the 6 conv filters"),
    (["--mesh-data", "3", "--batch-size", "16"], "divide evenly over the data axis"),
    (["--mesh-data", "2", "--batch-size", "1"], "minibatch"),
], ids=["cuda-model-axis", "model-4", "indivisible-batch", "per-sample"])
def test_cli_refuses_a_mesh_it_cannot_run(argv, match):
    with pytest.raises(MeshLayoutError, match=match):
        cli.main(["--device", "cpu", "--loader", "synthetic", *argv])
