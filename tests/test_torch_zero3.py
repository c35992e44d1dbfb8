"""ZeRO-3 and the hierarchical (host × device) ring of the port
(``parallel/collectives.py`` ``hier_*``, ``parallel/mesh.py`` ``HierMesh``,
``train/zoo.py`` ``make_zero3_train_step`` and the views,
``train/checkpoint.py`` ``save_sharded``/``restore_sharded``, the CLI's
``--comm-impl hierarchical`` and ``PCNN_ZERO_LEVEL=3``) against the JAX
package on the CPU.

- ``hier_shard_rows``/``hier_unshard_rows`` equal JAX's at (H, D) = (1, 4),
  (2, 2), (4, 1), (2, 3), with JAX's error on a bucket that does not
  divide; the ``HierMesh`` rank layout and its batch rows equal JAX's
  ``make_hier_mesh`` and ``P((host, data))``.
- In one spawned gloo world of 4 (``tests/_torch_zero3_ranks.py``): the
  hierarchical collectives at 2 × 2 bit for bit JAX's in f32 (within 2⁻⁷
  of scale on a bf16 wire), the row a rank ends with row d·H + h of the
  natural reshape; 3 ZeRO-3 steps of JAX's tiny BN model (JAX's init,
  batch 16, accum 2, 2048-byte buckets, lr 0.05) at JAX's bounds
  (tests/test_fused_step.py:548-572): against the port's ZeRO-2 (losses
  1e-6, params and BN statistics 1e-5), against JAX's
  ``make_zero3_train_step`` on 4 host devices (every leaf 1e-5), the
  hierarchical 2 × 2 against the flat 4 (1e-5), bf16 against the unfused
  step (1e-2); an overflow skipped bit for bit; the resident rows (1, L)
  and no parameter storage between steps; the hierarchical comm step
  against JAX's and the flat ring (1e-5); the full view laid out on worlds
  1, 2, 4 and hosts 2 and gathered back bit for bit; a sharded file
  written at world 4 restored at 2, and files crossing packages.
- The plain readers' refusal of a sharded file with JAX's text, the CLI on
  the CPU.

Never held against JAX's psum comm step (ROADMAP Queue C)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _torch_zero3_ranks as ranks
from parallel_cnn_tpu import config as jax_config
from parallel_cnn_tpu.nn import core as jax_core
from parallel_cnn_tpu.nn import layers as JL
from parallel_cnn_tpu.parallel import collectives as jax_coll
from parallel_cnn_tpu.parallel import mesh as jax_mesh
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch.config import CommConfig, FusedStepConfig
from parallel_cnn_tpu_torch.parallel import collectives, distributed
from parallel_cnn_tpu_torch.parallel.mesh import (
    DataMesh,
    make_hier_mesh,
    make_mesh_2d,
    hier_axis_sizes,
)
from parallel_cnn_tpu_torch.resilience.rollback import CheckpointRing
from parallel_cnn_tpu_torch.train import checkpoint, zoo

TOL = 1e-5
BF16_TOL = 1e-2
WORLD_TIMEOUT_S = 300
HOST, DATA = jax_mesh.HOST_AXIS, jax_mesh.DATA_AXIS
CHUNK = 24  # elements of one rank's shard in the collective cases


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)),
                        initial=0.0))


def jax_tiny():
    return jax_core.Sequential([JL.Conv2D(4, (3, 3)), JL.BatchNorm(), JL.ReLU(),
                                JL.MaxPool(), JL.Flatten(), JL.Dense(10)])


def _jax_hier_mesh():
    return jax_mesh.make_hier_mesh(n_hosts=2, devices=jax.devices()[:ranks.WORLD])


# ---------------------------------------------------------------------------
# Layout, config and mesh (no world)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_host,n_dev", [(1, 4), (2, 2), (4, 1), (2, 3)])
def test_hier_shard_rows_equal_jax(n_host, n_dev):
    bucket = np.arange(n_host * n_dev * 5, dtype=np.float32) * 0.5 - 3.0
    want = np.asarray(jax_coll.hier_shard_rows(jnp.asarray(bucket), n_host, n_dev))
    got = collectives.hier_shard_rows(torch.from_numpy(bucket), n_host, n_dev)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    back = collectives.hier_unshard_rows(got, n_host, n_dev)
    assert np.array_equal(back.numpy(), bucket)
    assert np.array_equal(back.numpy(), np.asarray(
        jax_coll.hier_unshard_rows(jnp.asarray(want), n_host, n_dev)))
    # Row h·D + d is row d·H + h of the natural reshape.
    natural = bucket.reshape(n_host * n_dev, -1)
    for h in range(n_host):
        for d in range(n_dev):
            assert np.array_equal(got[h * n_dev + d].numpy(), natural[d * n_host + h])
    odd = np.zeros(n_host * n_dev * 5 + 1, np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_coll.hier_shard_rows(jnp.asarray(odd), n_host, n_dev)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        collectives.hier_shard_rows(torch.from_numpy(odd), n_host, n_dev)


def test_config_errors_are_jax_s(monkeypatch):
    for kw in (dict(hosts=0), dict(impl="hierarchical", hosts=-1)):
        with pytest.raises(ValueError) as want:
            jax_config.CommConfig(**kw)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            CommConfig(**kw)
    assert CommConfig(impl="hierarchical", hosts=2).hosts == 2
    with pytest.raises(ValueError) as want:
        jax_config.FusedStepConfig(update=False, zero=3)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        FusedStepConfig(update=False, zero=3)
    assert FusedStepConfig(zero=3).zero == 3
    monkeypatch.setenv("PCNN_COMM_HOSTS", "2")
    monkeypatch.setenv("PCNN_COMM_IMPL", "hierarchical")
    assert CommConfig.from_env() == CommConfig(impl="hierarchical", hosts=2)
    assert jax_config.CommConfig.from_env().hosts == 2
    monkeypatch.setenv("PCNN_FUSED_STEP", "1")
    monkeypatch.setenv("PCNN_ZERO_LEVEL", "3")
    assert FusedStepConfig.from_env().zero == jax_config.FusedStepConfig.from_env().zero == 3


def test_mesh_errors_are_jax_s():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError) as want:
        jax_mesh.make_hier_mesh(n_hosts=3, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        make_hier_mesh(0, 4, cpu, 3)
    flat = jax_mesh.make_mesh(jax_config.MeshConfig(data=2, model=1),
                              devices=jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        jax_mesh.hier_axis_sizes(flat)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        hier_axis_sizes(make_mesh_2d(0, 1, cpu, 1, 1))
    # A host axis over the whole world or of one rank makes no group.
    assert hier_axis_sizes(make_hier_mesh(0, 1, cpu, 1)) == (1, 1)
    assert hier_axis_sizes(make_hier_mesh(1, 2, cpu, 2)) == (2, 1)
    assert distributed.resolve_hier_shape(2, "cpu") == (2, distributed.CPU_RANKS_PER_HOST)
    assert distributed.resolve_hier_shape(None, "cpu") == (1, distributed.CPU_RANKS_PER_HOST)


def test_hier_card_shapes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert distributed.resolve_hier_shape(2, "cuda") == (2, 2)
    assert distributed.resolve_hier_shape(None, "cuda") == (1, 4)
    with pytest.raises(distributed.MeshSizeError, match="8 cards"):
        distributed.resolve_hier_shape(8, "cuda")
    with pytest.raises(ValueError, match="host axis 3 does not divide device count 4"):
        distributed.resolve_hier_shape(3, "cuda")


# ---------------------------------------------------------------------------
# One world of 4 against JAX on 4 host devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16,) + ranks.TINY_SHAPE).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    x_inf = x.copy()
    x_inf[0, 0, 0, 0] = np.inf
    params, state, _ = jax_tiny().init(jax.random.key(7), ranks.TINY_SHAPE)
    params, state = jax.tree_util.tree_map(np.asarray, (params, state))
    sd = {k: v.numpy() for k, v in convert.from_jax(params, state).items()}
    full = [rng.standard_normal(ranks.WORLD * CHUNK).astype(np.float32)
            for _ in range(ranks.WORLD)]
    shard = [rng.standard_normal(CHUNK).astype(np.float32) for _ in range(ranks.WORLD)]
    return dict(x=x, y=y, x_inf=x_inf, params=params, state=state, sd=sd,
                full=full, shard=shard)


def _jax_zero3(mesh, data, impl="ring", hosts=None):
    """JAX's ZeRO-3 state (from JAX's init, laid out by zero3_from_view)
    and step on ``mesh``, its plan, and its bucket count."""
    params = jax.tree_util.tree_map(jnp.asarray, data["params"])
    view = dict(params=params,
                model_state=jax.tree_util.tree_map(jnp.asarray, data["state"]),
                mom=jax.tree_util.tree_map(jnp.zeros_like, params),
                scale=jnp.float32(1.0), good_steps=jnp.int32(0), skipped=jnp.int32(0))
    n_host = hosts or 1
    st, plan = jax_zoo.zero3_from_view(view, n_data=ranks.WORLD // n_host,
                                       bucket_bytes=ranks.BUCKET_BYTES, n_host=n_host)
    comm = jax_config.CommConfig(impl=impl, bucket_bytes=ranks.BUCKET_BYTES,
                                 overlap=True, hosts=hosts)
    fused = jax_config.FusedStepConfig(update=True, tail=True, act_dtype="float32",
                                       zero=3)
    step = jax_zoo.make_zero3_train_step(jax_tiny(), lr=ranks.LR, momentum=ranks.MOMENTUM,
                                         accum_steps=ranks.ACCUM, mesh=mesh,
                                         augment=None, comm=comm, fused=fused, plan=plan)
    return st, step, plan


@pytest.fixture(scope="module")
def jax_flat(data, tmp_path_factory, host_devices):
    """JAX's ZeRO-3 at D = 4: 3 steps; its losses, full view, rows, and the
    sharded file it writes."""
    mesh = jax_mesh.make_mesh(jax_config.MeshConfig(data=ranks.WORLD, model=1),
                              devices=jax.devices()[:ranks.WORLD])
    st, step, plan = _jax_zero3(mesh, data)
    losses = []
    for _ in range(ranks.STEPS):
        st, loss = step(st, jnp.asarray(data["x"]), jnp.asarray(data["y"]))
        losses.append(float(loss))
    view = jax_zoo.zero3_full_view(st, plan)
    path = str(tmp_path_factory.mktemp("zero3_jax") / "ckpt_3.npz")
    jax_checkpoint.save_sharded(path, view, jax_checkpoint.TrainState(epoch=3),
                                world_size=ranks.WORLD, bucket_bytes=ranks.BUCKET_BYTES)
    flat = {k: np.asarray(v) for k, v in jax_checkpoint._flatten(view).items()}
    return dict(losses=losses, view=view, flat=flat, path=path,
                rows=[np.asarray(r) for r in st.params])


@pytest.fixture(scope="module")
def world(data, jax_flat, tmp_path_factory):
    spec = dict(sd=data["sd"], x=data["x"], y=data["y"], x_inf=data["x_inf"],
                full=data["full"], shard=data["shard"], jax_ckpt=jax_flat["path"],
                ckpt=str(tmp_path_factory.mktemp("zero3_port") / "ckpt_3.npz"))
    results = distributed.run(ranks.zero3_cases, ranks.WORLD, device="cpu",
                              args=(spec,), timeout=WORLD_TIMEOUT_S)
    return spec, results


def _jax_hier_per_device(fn, xs):
    """fn on each device of JAX's 2 × 2 (host, data) mesh, device (h, d)
    given xs[h·D + d]; the per-device results stacked in that order."""
    spec = P((HOST, DATA))
    body = jax_mesh.shard_map(
        lambda s: jax.tree_util.tree_map(lambda v: v[None], fn(s)),
        mesh=_jax_hier_mesh(), in_specs=(spec,), out_specs=spec, check_vma=False)
    out = jax.jit(body)(jnp.asarray(np.concatenate(xs)))
    return jax.tree_util.tree_map(np.asarray, out)


def test_hier_mesh_layout_and_rows_equal_jax(world):
    _, results = world
    mesh = _jax_hier_mesh()
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    rows = jax.device_put(jnp.arange(16), NamedSharding(mesh, P((HOST, DATA))))
    jax_rows = {s.device.id: np.asarray(s.data) for s in rows.addressable_shards}
    for r in range(ranks.WORLD):
        h, d = map(int, np.argwhere(ids == r)[0])
        assert results[r]["layout"] == (2, h, tuple(ids[:, d]), 2, d, tuple(ids[h, :]))
        assert np.array_equal(results[r]["batch_rows"], jax_rows[r])


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_hier_collectives_equal_jax(world, data, wire):
    _, results = world
    H = D = 2
    ops = {
        "rs": (lambda s: jax_coll.hier_reduce_scatter(s, HOST, H, DATA, D, wire), "full"),
        "ag": (lambda s: jax_coll.hier_all_gather(s, HOST, H, DATA, D, wire), "shard"),
        "ar": (lambda s: jax_coll.hier_all_reduce(s, HOST, H, DATA, D, wire), "full"),
    }
    exact = np.sum(np.asarray(data["full"], np.float64), axis=0)
    for op, (fn, src) in ops.items():
        want = _jax_hier_per_device(fn, data[src])
        for r in range(ranks.WORLD):
            got = results[r]["coll"][f"{op}_{wire or 'f32'}"]
            if wire is None:
                assert np.array_equal(got, want[r]), (op, r)
            else:
                scale = max(1.0, float(np.abs(want[r]).max()))
                assert _max_diff(got, want[r]) <= 2.0 ** -7 * scale, (op, r)
        if op == "rs":
            # Rank (h, d) holds row d·H + h of the summed bucket.
            natural = exact.reshape(H * D, -1)
            for r in range(ranks.WORLD):
                h, d = divmod(r, D)
                got = results[r]["coll"][f"rs_{wire or 'f32'}"]
                tol = 1e-5 if wire is None else 2.0 ** -7 * max(1.0, np.abs(natural).max())
                assert _max_diff(got, natural[d * H + h]) <= tol, r


def test_tree_all_reduce_hier_equals_jax(world, data):
    _, results = world
    comm = jax_config.CommConfig(impl="hierarchical", bucket_bytes=64, hosts=2)

    def body(s):
        tree = {"a": s[:37], "b": s[37:40]}
        return jax_coll.tree_all_reduce(tree, DATA, 2, comm, host_axis=HOST, host_size=2)

    want = _jax_hier_per_device(body, data["full"])
    for r in range(ranks.WORLD):
        for k in ("a", "b"):
            assert np.array_equal(results[r]["coll"][f"tree_{k}"], want[k][r]), (r, k)


def _view_close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        assert _max_diff(got[k], v) <= tol, (what, k)


def test_zero3_matches_zero2(world):
    """Same schedule, same kernels: only when the params are gathered
    moves (JAX's 1e-6 on the losses, 1e-5 on params and BN)."""
    _, results = world
    for r in range(ranks.WORLD):
        res = results[r]
        assert _max_diff(res["z3_losses"], res["z2_losses"]) <= 1e-6
        for k, v in res["z2_sd"].items():
            tree = "model_state" if k.endswith(("mean", "var")) else "params"
            assert _max_diff(res["z3_view"][f"{tree}/{k.replace('.', '/')}"], v) <= TOL, k


def test_zero3_matches_jax(world, jax_flat):
    _, results = world
    for r in range(ranks.WORLD):
        res = results[r]
        assert _max_diff(res["z3_losses"], jax_flat["losses"]) <= TOL
        _view_close(res["z3_view"], jax_flat["flat"], TOL, f"rank {r}")
        # The resident rows: rank r holds JAX's row r.
        for b, row in enumerate(res["z3_rows"]):
            assert row.shape == (1, jax_flat["rows"][b].shape[1])
            assert _max_diff(row[0], jax_flat["rows"][b][r]) <= TOL, (r, b)


def test_zero3_hier_matches_flat(world):
    _, results = world
    for r in range(ranks.WORLD):
        res = results[r]
        assert _max_diff(res["hier_losses"], res["z3_losses"]) <= TOL
        _view_close(res["hier_view"], res["z3_view"], TOL, f"rank {r}")
    # Every rank gathers the same view.
    for r in range(1, ranks.WORLD):
        for k, v in results[0]["hier_view"].items():
            assert np.array_equal(results[r]["hier_view"][k], v), (r, k)


def test_zero3_bf16_within_bound(world):
    _, results = world
    for r in range(ranks.WORLD):
        res = results[r]
        assert np.all(np.isfinite(res["bf16_losses"]))
        assert _max_diff(res["bf16_losses"], res["unfused_losses"]) <= BF16_TOL


def test_zero3_overflow_skips_bit_for_bit(world):
    _, results = world
    for r in range(ranks.WORLD):
        res = results[r]
        before, after, clean = res["inf_before"], res["inf_after"], res["clean_after"]
        assert not np.isfinite(res["inf_loss"])
        scalars = (".opt_state/.skipped", ".opt_state/.scale", ".opt_state/.good_steps")
        for k in before:
            if k not in scalars:
                assert np.array_equal(after[k], before[k]), k
        assert int(after[".opt_state/.skipped"]) == int(before[".opt_state/.skipped"]) + 1
        assert float(after[".opt_state/.scale"]) == float(before[".opt_state/.scale"]) * 0.5
        assert int(after[".opt_state/.good_steps"]) == 0
        rows = [k for k in before if k.startswith((".params/", ".opt_state/.mom/"))]
        assert rows and all(not np.array_equal(clean[k], after[k]) for k in rows)


def test_resident_rows_are_one_quarter_and_storage_is_released(world):
    _, results = world
    for r in range(ranks.WORLD):
        res = results[r]
        want = [(1, n // ranks.WORLD) for n in res["bucket_sizes"]]
        assert len(want) > 1
        assert res["rows_shapes"] == want and res["mom_shapes"] == want
        assert all(res["storage_free"])  # after init and after every step


def _jax_comm_hier(data):
    mesh = _jax_hier_mesh()
    opt = jax_zoo.make_optimizer(lr=ranks.LR, momentum=ranks.MOMENTUM)
    params = jax.tree_util.tree_map(jnp.asarray, data["params"])
    st = jax_zoo.ZooState(params, jax.tree_util.tree_map(jnp.asarray, data["state"]),
                          opt.init(params))
    step = jax_zoo.make_train_step(
        jax_tiny(), opt, accum_steps=ranks.ACCUM, mesh=mesh,
        comm=jax_config.CommConfig(impl="hierarchical", bucket_bytes=ranks.BUCKET_BYTES,
                                   overlap=True, hosts=2))
    losses = []
    for _ in range(ranks.STEPS):
        st, loss = step(st, jnp.asarray(data["x"]), jnp.asarray(data["y"]))
        losses.append(float(loss))
    sd = {k: v.numpy() for k, v in convert.from_jax(
        jax.tree_util.tree_map(np.asarray, st.params),
        jax.tree_util.tree_map(np.asarray, st.model_state)).items()}
    return losses, sd


def test_hier_comm_step_matches_jax_and_the_flat_ring(world, data):
    """impl="hierarchical" at 2 × 2 against JAX's and the flat ring at 4;
    psum over both axes against the flat ring (not JAX's psum: Queue
    C)."""
    _, results = world
    want_losses, want_sd = _jax_comm_hier(data)
    for r in range(ranks.WORLD):
        losses, sd = results[r]["comm_hier"]
        flat_losses, flat_sd = results[r]["comm_flat"]
        psum_losses, psum_sd = results[r]["comm_hier_psum"]
        assert _max_diff(losses, want_losses) <= TOL
        assert _max_diff(losses, flat_losses) <= TOL
        assert _max_diff(psum_losses, flat_losses) <= TOL
        assert sorted(sd) == sorted(want_sd)
        for k, v in want_sd.items():
            assert _max_diff(sd[k], v) <= TOL, k
            assert _max_diff(sd[k], flat_sd[k]) <= TOL, k
            assert _max_diff(psum_sd[k], flat_sd[k]) <= TOL, k


@pytest.mark.parametrize("name,n_host,n_data", [("world1", 1, 1), ("world2", 1, 2),
                                                ("world4", 1, 4), ("hosts2", 2, 2)])
def test_view_round_trip_is_bit_exact_across_world_sizes(world, jax_flat, name, n_host,
                                                          n_data):
    """The flat-4 state's full view laid out on another mesh and gathered
    back, bit for bit; the rows are JAX's ``zero3_from_view`` rows."""
    _, results = world
    view = results[0]["z3_view"]
    jax_view = jax_checkpoint._unflatten_into(jax_flat["view"], view)
    jst, _ = jax_zoo.zero3_from_view(jax_view, n_data=n_data,
                                     bucket_bytes=ranks.BUCKET_BYTES, n_host=n_host)
    for r in range(ranks.WORLD):
        rows, back = results[r]["round_trip"][name]
        assert sorted(back) == sorted(view)
        for k, v in view.items():
            assert np.array_equal(back[k], v), (name, r, k)
        index = r % (n_host * n_data)
        for b, row in enumerate(rows):
            assert np.array_equal(row[0], np.asarray(jst.params[b])[index]), (name, r, b)


def test_sharded_checkpoint_written_at_4_restores_at_2(world):
    _, results = world
    for r in range(ranks.WORLD):
        epoch, zmeta, view = results[r]["restored_at_2"]
        assert epoch == 3
        assert zmeta == {"world_size": 4, "bucket_bytes": 2048, "rank": 0}
        for k, v in results[0]["z3_view"].items():
            assert np.array_equal(view[k], v), (r, k)


def test_jax_file_restores_in_the_port(world, jax_flat):
    """JAX wrote at world 4; the port reads it key for key and lays it out
    at 2 × 2 as JAX's ``zero3_from_view`` does."""
    _, results = world
    jst, _ = jax_zoo.zero3_from_view(jax_flat["view"], n_data=2,
                                     bucket_bytes=ranks.BUCKET_BYTES, n_host=2)
    for r in range(ranks.WORLD):
        got, zmeta, rows = results[r]["jax_file"]
        assert zmeta == {"world_size": 4, "bucket_bytes": 2048, "rank": 0}
        assert sorted(got) == sorted(jax_flat["flat"])
        for k, v in jax_flat["flat"].items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        for b, row in enumerate(rows):
            assert np.array_equal(row[0], np.asarray(jst.params[b])[r]), (r, b)


def test_port_file_restores_in_jax(world, jax_flat):
    spec, results = world
    view, tstate, zmeta = jax_checkpoint.restore_sharded(spec["ckpt"], jax_flat["view"])
    assert tstate.epoch == 3
    assert zmeta == {"world_size": 4, "bucket_bytes": 2048, "rank": 0}
    flat = jax_checkpoint._flatten(view)
    port = results[0]["z3_view"]
    assert sorted(flat) == sorted(port)
    for k, v in port.items():
        assert np.asarray(flat[k]).dtype == v.dtype
        assert np.array_equal(np.asarray(flat[k]), v), k


def test_plain_readers_refuse_a_sharded_file(world, tmp_path):
    spec, results = world
    like = {k: torch.from_numpy(v) for k, v in results[0]["z3_view"].items()}
    for reader, fn in (("restore", checkpoint.restore),
                       ("load_params", checkpoint.load_params)):
        with pytest.raises(ValueError) as want:
            getattr(jax_checkpoint, reader)(spec["ckpt"], {})
        assert "use restore_sharded" in str(want.value)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            fn(spec["ckpt"], like)
    plain = str(tmp_path / "ckpt_1.npz")
    checkpoint.save(plain, like)
    with pytest.raises(checkpoint.ShardedCheckpointError) as got:
        checkpoint.restore_sharded(plain, like)
    with pytest.raises(jax_checkpoint.ShardedCheckpointError) as want:
        jax_checkpoint.restore_sharded(plain, {})
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_ring_restores_the_newest_sharded_file(world, tmp_path):
    """``CheckpointRing(saver=save_sharded)`` writes JAX's sharded files;
    ``restore_latest_sharded`` skips a torn newer one, and the plain
    ``restore_latest`` refuses them all."""
    _, results = world
    view = {k: torch.from_numpy(v) for k, v in results[0]["z3_view"].items()}
    ring = CheckpointRing(str(tmp_path), keep=2, saver=lambda path, v, st: (
        checkpoint.save_sharded(path, v, st, world_size=4, bucket_bytes=2048)))
    ring.save(1, view, checkpoint.TrainState(epoch=1))
    ring.save(2, view, checkpoint.TrainState(epoch=2))
    with open(ring.path_for(3), "wb") as f:
        f.write(b"torn")
    got, tstate, zmeta, path = ring.restore_latest_sharded(view)
    assert path == ring.path_for(2) and tstate.epoch == 2 and zmeta["world_size"] == 4
    assert all(torch.equal(got[k], v) for k, v in view.items())
    assert ring.restore_latest(view) is None


def test_step_and_trainer_fences_are_jax_s():
    """JAX's errors of the ZeRO-3 step, the comm step on the wrong mesh,
    and zoo.train's ZeRO-2 on a hierarchical mesh (meshes of one rank: no
    process group)."""
    cpu = torch.device("cpu")
    flat, hier = DataMesh(1, 0, cpu), make_hier_mesh(0, 1, cpu, 1)
    model = ranks.tiny_model()
    state, plan = zoo.init_zero3_state(model, zoo.make_optimizer(0.1, 0.9), mesh=flat,
                                       fused=ranks.Z3, bucket_bytes=2048)
    kw = dict(lr=0.1, momentum=0.9, accum_steps=1, augment_pad=None, fused=ranks.Z3,
              plan=plan)
    with pytest.raises(ValueError, match="ZeRO-3 requires the explicit bucketed"):
        zoo.make_zero3_train_step(model, mesh=flat, comm=CommConfig(impl="psum"), **kw)
    with pytest.raises(ValueError, match=re.escape(
            "comm.impl='hierarchical' needs a (host, device) mesh")):
        zoo.make_zero3_train_step(model, mesh=flat, comm=ranks.HIER, **kw)
    with pytest.raises(ValueError, match="comm.impl='ring' is the flat single-axis ring"):
        zoo.make_zero3_train_step(model, mesh=hier, comm=ranks.RING, **kw)
    with pytest.raises(ValueError, match="bucket plan was laid out for 1 shards but "
                       "the mesh has 2"):
        zoo.make_zero3_train_step(model, mesh=DataMesh(2, 0, cpu), comm=ranks.RING, **kw)
    opt = zoo.make_optimizer(0.1, 0.9)
    with pytest.raises(ValueError, match=re.escape(
            "comm.impl='hierarchical' needs a (host, device) mesh")):
        zoo.make_train_step(ranks.tiny_model(), opt, mesh=flat, comm=ranks.HIER)
    with pytest.raises(ValueError, match="comm.impl='ring' is the flat single-axis ring"):
        zoo.make_train_step(ranks.tiny_model(), opt, mesh=hier, comm=ranks.RING)
    X = np.zeros((4,) + ranks.TINY_SHAPE, np.float32)
    Y = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="ZeRO-2 update-on-arrival rides the flat "
                       "ring; on a hierarchical mesh use fused.zero=3"):
        zoo.train(ranks.tiny_model(), X, Y, batch_size=4, mesh=hier, comm=ranks.HIER,
                  fused=ranks.Z2, device="cpu")


# ---------------------------------------------------------------------------
# The CLI on the CPU
# ---------------------------------------------------------------------------

def _cli(capfd, argv):
    """The CLI in this process on the CIFAR CNN (its ranks are spawned gloo
    processes, whose lines reach the captured fd 1)."""
    capfd.readouterr()
    assert cli.main(["--device", "cpu", "--model", "cifar_cnn", "--batch-size", "16",
                     "--lr", "0.01", "--synthetic-train-count", "64",
                     "--synthetic-test-count", "32", *argv]) == 0
    return capfd.readouterr().out.splitlines()


def _epoch_losses(lines):
    return [float(re.match(r"epoch \d+: loss (\S+),", ln).group(1))
            for ln in lines if ln.startswith("epoch ")]


def test_cli_hierarchical_two_hosts(capfd):
    lines = _cli(capfd, ["--comm-impl", "hierarchical", "--comm-hosts", "2",
                         "--epochs", "2"])
    assert lines[0] == "mesh: {'host': 2, 'data': 2} (hierarchical)"
    losses = _epoch_losses(lines)
    assert len(losses) == 2 and losses[1] < losses[0], lines


def test_cli_zero3_ring_resume_is_bit_identical(capfd, monkeypatch, tmp_path):
    monkeypatch.setenv("PCNN_FUSED_STEP", "1")
    monkeypatch.setenv("PCNN_ZERO_LEVEL", "3")
    base = ["--mesh-data", "2", "--comm-impl", "ring", "--fused-step",
            "--act-dtype", "float32"]
    lines = _cli(capfd, base + ["--epochs", "2", "--checkpoint-dir", str(tmp_path / "a")])
    assert "mesh: {'data': 2, 'model': 1}" in lines and "falling back" not in " ".join(lines)
    assert len(_epoch_losses(lines)) == 2
    _cli(capfd, base + ["--epochs", "1", "--checkpoint-dir", str(tmp_path / "b")])
    lines = _cli(capfd, base + ["--epochs", "2", "--resume", "--checkpoint-dir",
                                str(tmp_path / "b")])
    assert any(ln.startswith("resumed from") for ln in lines)
    straight, resumed = (checkpoint._read_arrays(str(tmp_path / d / "ckpt_2.npz"))
                         for d in ("a", "b"))
    assert straight[1]["zero3"] == {"world_size": 2, "bucket_bytes": 4 * 1024 * 1024,
                                    "rank": 0}
    assert sorted(straight[0]) == sorted(resumed[0])
    assert any(k.startswith("mom/") for k in straight[0])
    for k, v in straight[0].items():
        assert np.array_equal(resumed[0][k], v), k
    assert straight[1]["epoch_errors"] == resumed[1]["epoch_errors"]


@pytest.mark.parametrize("argv,env,match", [
    (["--comm-impl", "hierarchical", "--comm-hosts", "1"], {},
     "hierarchical comm needs a host axis of >= 2 (got hosts=1)"),
    (["--comm-impl", "hierarchical", "--fused-step"], {},
     "ZeRO-2 update-on-arrival rides the flat ring"),
    (["--mesh-data", "2", "--comm-impl", "psum", "--fused-step"],
     {"PCNN_FUSED_STEP": "1", "PCNN_ZERO_LEVEL": "3"},
     "ZeRO-3 needs the explicit ring or hierarchical"),
    (["--pipeline-stages", "2", "--comm-impl", "hierarchical"], {},
     "pipeline gradients reduce over the flat data axis"),
    (["--pipeline-stages", "2", "--comm-impl", "ring", "--fused-step"],
     {"PCNN_FUSED_STEP": "1", "PCNN_ZERO_LEVEL": "3"},
     "pipeline composes with ZeRO-2 only"),
])
def test_cli_legality_texts_are_jax_s(monkeypatch, argv, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=re.escape(match)):
        cli.main(["--device", "cpu", "--model", "cifar_cnn", *argv])


def test_lenet_refuses_the_hierarchical_mesh():
    with pytest.raises(ValueError, match=re.escape("axes ('host', 'data')")):
        cli.main(["--device", "cpu", "--comm-impl", "hierarchical", "--comm-hosts", "2"])
