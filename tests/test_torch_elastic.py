"""Elastic ZeRO-3 training of the port (``resilience/elastic.py``,
``parallel/mesh.py`` ``make_elastic_mesh``, ``train/zoo.py``
``train(elastic=, chaos=, obs=)``, ``config.ElasticConfig``,
``resilience/preempt.py``'s resize channel, the CLI's ``--elastic*``)
against the JAX package on the CPU, mirroring tests/test_elastic.py.

- Config, schedule grammar, scaling math and the controller's decisions
  (priority signal > chaos > schedule, the clamp, consume-once, the no-op
  skip) equal JAX's over one scripted trigger sequence.
- In one spawned gloo world of 4 (``tests/_torch_elastic_ranks.py``), on
  JAX's BN-free tiny model from JAX's init: the lap (1,4) → (2,2) →
  (1,2) → (1,4) with 2-step legs within 1e-5 of the fixed world-4 run
  and of JAX's own lap on 4 host devices, its groups made once per
  topology; zero-step reshards across worlds 4, 2, (2,2), 1 bit-exact,
  and equal to JAX's view; the ring fallback bit for bit, and JAX's
  ElasticError without a ring; the resize journal events; ``zoo.train``
  with a schedule within 1e-5 of the fixed run and of JAX's
  ``zoo.train`` on the same native-ring batches, and with chaos
  ``resize@``.
- JAX's zero3 fence and the CLI: ``--elastic`` on lenet_ref refused with
  JAX's text, and an elastic run of 2 gloo ranks.

Parity needs f32 activations and a model without BatchNorm (ring-comm BN
statistics are per shard, so a BN model depends on the world)."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_elastic_ranks as ranks
from parallel_cnn_tpu import cli as jax_cli
from parallel_cnn_tpu import config as jax_config
from parallel_cnn_tpu.nn import core as jax_core
from parallel_cnn_tpu.nn import layers as JL
from parallel_cnn_tpu.parallel import mesh as jax_mesh
from parallel_cnn_tpu.resilience import chaos as jax_chaos
from parallel_cnn_tpu.resilience import elastic as jax_elastic
from parallel_cnn_tpu.resilience import preempt as jax_preempt
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch.config import ElasticConfig
from parallel_cnn_tpu_torch.parallel import distributed
from parallel_cnn_tpu_torch.resilience import chaos, preempt
from parallel_cnn_tpu_torch.resilience.elastic import ElasticController
from parallel_cnn_tpu_torch.train import zoo

TOL = 1e-5
WORLD_TIMEOUT_S = 300
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)),
                        initial=0.0))


def jax_nobn():
    return jax_core.Sequential([JL.Conv2D(4, (3, 3)), JL.ReLU(), JL.MaxPool(),
                                JL.Flatten(), JL.Dense(10)])


# ---------------------------------------------------------------------------
# Config, scaling and the controller's decisions (no world)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["", "40:4,80:8", "5:2,1:4", " 3:1"])
def test_schedule_grammar_equals_jax(schedule):
    assert ElasticConfig(schedule=schedule).plan() == \
        jax_config.ElasticConfig(schedule=schedule).plan()


@pytest.mark.parametrize("kw", [dict(schedule="4"), dict(schedule="a:2"),
                                dict(schedule="3:x"), dict(scaling="bogus"),
                                dict(min_world=0)])
def test_config_errors_are_jax_s(kw):
    with pytest.raises(ValueError) as want:
        jax_config.ElasticConfig(**kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        ElasticConfig(**kw)


def test_config_from_env_equals_jax(monkeypatch):
    names = ("PCNN_ELASTIC", "PCNN_ELASTIC_SCHEDULE", "PCNN_ELASTIC_SCALING",
             "PCNN_ELASTIC_MIN_WORLD")
    for v in names:
        monkeypatch.delenv(v, raising=False)
    assert ElasticConfig.from_env() is None is jax_config.ElasticConfig.from_env()
    for env in ({"PCNN_ELASTIC": "1"}, {"PCNN_ELASTIC_SCHEDULE": "2:4"},
                {"PCNN_ELASTIC": "0", "PCNN_ELASTIC_SCALING": "per-device",
                 "PCNN_ELASTIC_MIN_WORLD": "2"}):
        for v in names:
            monkeypatch.delenv(v, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got, want = ElasticConfig.from_env(), jax_config.ElasticConfig.from_env()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("scaling", ["global", "per-device"])
@pytest.mark.parametrize("world", [2, 4, 16])
def test_scaling_math_equals_jax(scaling, world):
    port = ElasticController(ElasticConfig(scaling=scaling), world=8, reachable=16)
    want = jax_elastic.ElasticController(jax_config.ElasticConfig(scaling=scaling),
                                         world=8)
    port.world = want.world = world
    for lr in (0.1, 0.05):
        assert port.lr_for(lr) == want.lr_for(lr)
    for batch in (64, 128, 7):
        assert port.global_batch_for(batch) == want.global_batch_for(batch)


def _decisions(ctl, request_resize, clear_resize, steps):
    """pending(step) for each step, the source of each answer, with the
    world moved to each target (as a resize would) and a preempt request
    made before step 4."""
    out = []
    for step in steps:
        if step == 4:
            request_resize(3)
        target = ctl.pending(step)
        out.append((step, target, ctl._last_source if target is not None else None))
        if target is not None:
            ctl.world = target
    clear_resize()
    return out


@pytest.mark.parametrize("spec,cfg", [
    ("resize@3:-3", dict(schedule="2:4,5:1,7:3", min_world=2)),
    ("resize@0:+4", dict(schedule="1:2,6:4")),
    ("resize@5:-1", dict(schedule="0:4,8:1", min_world=1)),
])
def test_controller_decisions_equal_jax(spec, cfg, host_devices):
    """Signal beats chaos beats schedule; targets clamp to [min_world, 4
    reachable]; each trigger is consumed once; a target equal to the world
    is skipped."""
    steps = range(10)
    port = ElasticController(ElasticConfig(**cfg), world=4,
                             chaos=chaos.ChaosMonkey.from_spec(spec), reachable=4)
    want = jax_elastic.ElasticController(
        jax_config.ElasticConfig(**cfg), world=4,
        chaos=jax_chaos.ChaosMonkey.from_spec(spec), devices=jax.devices()[:4])
    got = _decisions(port, preempt.request_resize, preempt.clear_resize, steps)
    exp = _decisions(want, jax_preempt.request_resize, jax_preempt.clear_resize, steps)
    assert got == exp
    assert any(t is not None for _, t, _ in got)


def test_preempt_resize_channel_equals_jax():
    for mod in (preempt, jax_preempt):
        assert mod.resize_requested() is None
        mod.request_resize(4)
        mod.request_resize(2)  # the newest wins
        assert mod.resize_requested() == 2 and not mod.requested()
        assert mod.clear_resize() == 2 and mod.clear_resize() is None
    with pytest.raises(ValueError) as want:
        jax_preempt.request_resize(0)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        preempt.request_resize(0)


def test_zoo_train_elastic_requires_zero3():
    """JAX's fence text, from zoo.train (tests/test_elastic.py:399)."""
    x = np.zeros((32,) + ranks.TINY_SHAPE, np.float32)
    y = np.zeros(32, np.int32)
    with pytest.raises(ValueError) as want:
        jax_zoo.train(jax_nobn(), jnp.asarray(x), jnp.asarray(y),
                      in_shape=ranks.TINY_SHAPE, epochs=1, batch_size=16,
                      verbose=False, elastic=jax_config.ElasticConfig())
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        zoo.train(ranks.nobn_model(), x, y, epochs=1, batch_size=16, verbose=False,
                  elastic=ElasticConfig(), device="cpu")


# ---------------------------------------------------------------------------
# One world of 4 against JAX on 4 host devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(96,) + ranks.TINY_SHAPE).astype(np.float32)
    y = rng.integers(0, 10, (96,)).astype(np.int32)
    params, state, _ = jax_nobn().init(jax.random.key(7), ranks.TINY_SHAPE)
    params, state = jax.tree_util.tree_map(np.asarray, (params, state))
    sd = {k: v.numpy() for k, v in convert.from_jax(params, state).items()}
    # zoo.train's own init draws from key(seed): the training cases start
    # from JAX's key(0).
    p0, s0, _ = jax_nobn().init(jax.random.key(0), ranks.TINY_SHAPE)
    p0, s0 = jax.tree_util.tree_map(np.asarray, (p0, s0))
    sd0 = {k: v.numpy() for k, v in convert.from_jax(p0, s0).items()}
    return dict(x=x, y=y, params=params, state=state, sd=sd, sd0=sd0)


def _jax_comm():
    return jax_config.CommConfig(impl="ring", bucket_bytes=ranks.BUCKET_BYTES,
                                 overlap=True)


_JAX_FUSED = jax_config.FusedStepConfig(update=True, tail=True, act_dtype="float32",
                                        zero=3)


def _jax_state(data):
    params = jax.tree_util.tree_map(jnp.asarray, data["params"])
    view = dict(params=params,
                model_state=jax.tree_util.tree_map(jnp.asarray, data["state"]),
                mom=jax.tree_util.tree_map(jnp.zeros_like, params),
                scale=jnp.float32(1.0), good_steps=jnp.int32(0), skipped=jnp.int32(0))
    return jax_zoo.zero3_from_view(view, n_data=ranks.WORLD,
                                   bucket_bytes=ranks.BUCKET_BYTES)


def _jax_step(mesh, comm, plan):
    return jax_zoo.make_zero3_train_step(
        jax_nobn(), lr=ranks.LR, momentum=ranks.MOMENTUM, accum_steps=ranks.ACCUM,
        mesh=mesh, augment=None, comm=comm, fused=_JAX_FUSED, plan=plan)


def _flat(view):
    return {k: np.asarray(v) for k, v in jax_checkpoint._flatten(view).items()}


@pytest.fixture(scope="module")
def jax_runs(data, host_devices):
    """JAX's lap on 4 host devices, its init view and one-step view, and
    its zoo.train with the schedule on the native ring's batches."""
    devs = jax.devices()[:ranks.WORLD]
    mesh4 = jax_mesh.make_mesh(jax_config.MeshConfig(data=ranks.WORLD, model=1),
                               devices=devs)
    comm = _jax_comm()
    st, plan = _jax_state(data)
    out = {"view0": _flat(jax_zoo.zero3_full_view(st, plan))}
    step = _jax_step(mesh4, comm, plan)
    st1, _ = step(st, jnp.asarray(data["x"][:16]), jnp.asarray(data["y"][:16]), None)
    out["view1"] = _flat(jax_zoo.zero3_full_view(st1, plan))
    ctl = jax_elastic.ElasticController(jax_config.ElasticConfig(), world=ranks.WORLD,
                                        devices=devs)
    st, plan = _jax_state(data)
    mesh, ecomm, n_host = mesh4, comm, 1
    step = _jax_step(mesh, comm, plan)
    losses = []
    for i in range(6):
        if i in ranks.LAPS:
            world, hosts = ranks.LAPS[i]
            st, plan, mesh, ecomm = ctl.resize(i, world, state=st, plan=plan,
                                               comm=ecomm, n_hosts=hosts)
            n_host = ctl.n_hosts
            step = _jax_step(mesh, ecomm, plan)
        st, loss = step(st, jnp.asarray(data["x"][i * 16:(i + 1) * 16]),
                        jnp.asarray(data["y"][i * 16:(i + 1) * 16]), None)
        losses.append(float(loss))
    st, plan, mesh, ecomm = ctl.resize(6, ranks.CLOSE[0], state=st, plan=plan,
                                       comm=ecomm, n_hosts=ranks.CLOSE[1])
    out["lap"] = losses
    out["lap_events"] = [(e.new_world, e.new_hosts) for e in ctl.events]
    out["lap_params"] = _flat(jax_zoo.zero3_full_params(st, plan, n_host=ctl.n_hosts))
    _, hist = jax_zoo.train(
        jax_nobn(), jnp.asarray(data["x"][:64]), jnp.asarray(data["y"][:64]),
        in_shape=ranks.TINY_SHAPE, epochs=2, batch_size=16, lr=ranks.LR,
        momentum=ranks.MOMENTUM, accum_steps=ranks.ACCUM, mesh=mesh4, comm=comm,
        fused=_JAX_FUSED, seed=0, verbose=False, loader="native",
        elastic=jax_config.ElasticConfig(schedule="2:2,5:4"))
    out["train_schedule"] = [float(h) for h in hist]
    return out


@pytest.fixture(scope="module")
def world(data, tmp_path_factory):
    spec = dict(sd=data["sd"], sd0=data["sd0"], x=data["x"], y=data["y"],
                ring_dir=str(tmp_path_factory.mktemp("elastic_ring")),
                obs_dir=str(tmp_path_factory.mktemp("elastic_obs")))
    return distributed.run(ranks.elastic_cases, ranks.WORLD, device="cpu",
                           args=(spec,), timeout=WORLD_TIMEOUT_S)


def _params_close(got, want_flat, what):
    """A port full-params dict (module paths) against JAX's flat params."""
    for k, v in got.items():
        assert _max_diff(v, want_flat[k]) <= TOL, (what, k)


def test_make_elastic_mesh_layout_equals_jax(world, host_devices):
    """Each topology's rank layout is JAX's mesh over the first ``world``
    devices; a host count that does not divide the world is a flat ring;
    a topology seen before returns its view again."""
    devs = jax.devices()[:ranks.WORLD]
    for r, res in enumerate(world):
        top = res["topologies"]
        for (w, h), got in top["layouts"].items():
            m = jax_mesh.make_elastic_mesh(w, n_hosts=h, devices=devs)
            ids = np.vectorize(lambda d: d.id)(m.devices)
            if r >= w:
                assert got is None
            elif jax_mesh.HOST_AXIS in m.axis_names:
                hh, dd = map(int, np.argwhere(ids == r)[0])
                assert got == ("hier", h, hh, tuple(ids[:, dd]), w // h, dd,
                               tuple(ids[hh, :])), (w, h)
            else:
                assert got == ("flat", w, r, tuple(ids.reshape(-1))), (w, h)
        assert top["cached"] == [True, True]
        with pytest.raises(ValueError) as want:
            jax_mesh.make_elastic_mesh(5, devices=devs)
        assert top["too_big"] == str(want.value)


def test_resize_lap_matches_fixed_world_and_jax(world, jax_runs):
    """(1,4) → (2,2) → (1,2) → (1,4): within 1e-5 of the fixed world and of
    JAX's lap, the events JAX's, the groups made once per topology."""
    for r, res in enumerate(world):
        lap = res["lap"]
        assert [e[:2] for e in lap["events"]] == jax_runs["lap_events"] == \
            [(4, 2), (2, 1), (4, 1)]
        assert lap["comm"] == ("ring", None)
        if r == 0:
            assert _max_diff(lap["elastic"], lap["fixed"]) <= TOL
            assert _max_diff(lap["elastic"], jax_runs["lap"]) <= TOL
        elif r >= 2:  # ranks 2, 3 sat out the flat-2 leg
            assert lap["elastic"][4:] == [None, None]
        for k, v in lap["elastic_params"].items():
            assert _max_diff(v, lap["fixed_params"][k]) <= TOL, k
        # (4, 2): two host columns, two data rows; (2, 1): one pair. The
        # closing (4, 1) is the spawned world's, seeded, so no group.
        assert lap["new_groups"] == 5
        assert lap["topologies"] == [(2, 1), (4, 1), (4, 2)]
    _params_close(world[0]["lap"]["elastic_params"], jax_runs["lap_params"], "jax lap")


@pytest.mark.parametrize("chain,tol", [("chain0", 0.0), ("chain1", TOL)])
def test_zero_step_reshard_is_bit_exact_and_jax_s(world, jax_runs, chain, tol):
    """4 → 2 → (2, 2) → 1 → 4 with no step between: every view bit for bit
    the first; that one equals JAX's view (bit for bit at init, 1e-5 after
    a step); the comm switches to the hierarchical ring and back."""
    res = world[0][chain]
    first = res["views"][0]
    assert len(res["views"]) == 5
    for v in res["views"][1:]:
        assert sorted(v) == sorted(first)
        assert all(np.array_equal(v[k], first[k]) for k in first)
    want = jax_runs["view0" if chain == "chain0" else "view1"]
    assert sorted(first) == sorted(want)
    for k in first:
        assert _max_diff(first[k], want[k]) <= tol, k
    assert res["impls"] == [("ring", None, "DataMesh"), ("hierarchical", 2, "HierMesh"),
                            ("ring", None, "DataMesh"), ("ring", None, "DataMesh")]
    for r in (1, 2, 3):  # outside the world-1 leg: no mesh there
        assert world[r][chain]["impls"][2] == ("ring", None, "NoneType")


def test_resize_falls_back_to_the_ring(world):
    """The live snapshot fails on every rank: the resize reshards rank 0's
    newest ring file, flagged from_ring, bit for bit; without a ring,
    JAX's ElasticError on every rank."""
    for r, res in enumerate(world):
        ring = res["ring"]
        assert ring["from_ring"] is True
        assert "checkpoint ring" in ring["no_ring"]
        if r < 2:
            assert ring["shards"] == 2
            assert all(np.array_equal(ring["restored"][k], ring["view"][k])
                       for k in ring["view"])
        else:
            assert ring["shards"] is None and "restored" not in ring


def test_resize_events_in_journal(world):
    recs = world[0]["journal"]
    begins = [r for r in recs if r["kind"] == "resize_begin"]
    dones = [r for r in recs if r["kind"] == "resize_done"]
    assert len(begins) == len(dones) == 2
    assert begins[0]["old_world"] == 4 and begins[0]["new_world"] == 2
    assert dones[1]["old_world"] == 2 and dones[1]["new_world"] == 4
    assert all(r["source"] == "direct" for r in begins)
    assert not any(r["from_ring"] for r in dones)
    assert all(world[r]["journal"] is None for r in (1, 2, 3))


def test_zoo_train_schedule_matches_fixed_and_jax(world, jax_runs):
    """zoo.train with the schedule 2:2,5:4 on the native ring's batches:
    per-epoch losses within 1e-5 of the fixed world and of JAX's
    zoo.train with the same schedule; the final params of the fixed run."""
    fixed, ela = world[0]["train_fixed"], world[0]["train_schedule"]
    assert _max_diff(ela["losses"], fixed["losses"]) <= TOL
    assert _max_diff(ela["losses"], jax_runs["train_schedule"]) <= TOL
    for r in range(ranks.WORLD):
        for k, v in world[r]["train_schedule"]["params"].items():
            assert _max_diff(v, world[r]["train_fixed"]["params"][k]) <= TOL, k


def test_zoo_train_chaos_resize(world):
    """chaos resize@1:-2 shrinks the world to 2: finite losses, a 2-shard
    layout on ranks 0 and 1, no state on 2 and 3."""
    for r, res in enumerate(world):
        got = res["train_chaos"]
        assert len(got["losses"]) == 2 and all(np.isfinite(got["losses"]))
        if r < 2:
            assert got["shards"] == 2 and all(s[0] == 1 for s in got["rows"])
        else:
            assert got["shards"] is None and got["params"] is None


def test_zoo_train_world_that_does_not_divide_the_batch_raises(world, data, host_devices):
    """A resize to 3 ranks under a global batch of 16: JAX's step raises
    ValueError on its 3-device mesh; every port rank raises ValueError at
    the resize (no padding, no rank left waiting)."""
    comm = _jax_comm()
    mesh4 = jax_mesh.make_mesh(jax_config.MeshConfig(data=ranks.WORLD, model=1),
                               devices=jax.devices()[:ranks.WORLD])
    with pytest.raises(ValueError, match="divisible"):
        jax_zoo.train(jax_nobn(), jnp.asarray(data["x"][:64]), jnp.asarray(data["y"][:64]),
                      in_shape=ranks.TINY_SHAPE, epochs=1, batch_size=16, mesh=mesh4,
                      comm=comm, fused=_JAX_FUSED, verbose=False,
                      elastic=jax_config.ElasticConfig(schedule="1:3"))
    for res in world:
        assert res["train_world3"] == ("global batch 16 does not divide over 3 ranks "
                                       "(no silent sample dropping)")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_elastic_on_lenet_is_jax_s_fence(capsys):
    with pytest.raises(SystemExit) as want:
        jax_cli.main(["--elastic", "--synthetic-train-count", "64"])
    with pytest.raises(SystemExit, match=re.escape(str(want.value.code))):
        cli.main(["--device", "cpu", "--elastic", "--synthetic-train-count", "64"])


def test_cli_elastic_two_ranks(tmp_path):
    """An elastic run of 2 gloo ranks: the schedule shrinks it to 1 and
    grows it back; both resizes are logged as JAX logs them, two epochs
    train, and the trace and journal are written."""
    env = dict(os.environ, PCNN_FUSED_STEP="1", PCNN_ZERO_LEVEL="3",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "parallel_cnn_tpu_torch", "--device", "cpu",
         "--model", "cifar_cnn", "--batch-size", "16", "--epochs", "2",
         "--synthetic-train-count", "64", "--synthetic-test-count", "32",
         "--mesh-data", "2", "--comm-impl", "ring", "--fused-step",
         "--act-dtype", "float32", "--elastic", "--elastic-schedule", "1:1,5:2",
         "--chaos", "resize@6:+3", "--trace-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout + proc.stderr
    assert "mesh: {'data': 2, 'model': 1}" in proc.stdout
    assert "elastic: resized 1x2 -> 1x1 at step 1 (schedule" in out
    assert "elastic: resized 1x1 -> 1x2 at step 5 (schedule" in out
    # chaos +3 at world 2 clamps to the 2 reachable ranks: a no-op.
    assert "elastic: resize request to 5 clamped to 2 (min_world=1, reachable=2)" in out
    assert "elastic: resize to 2 is a no-op at world 2" in out
    assert len([ln for ln in proc.stdout.splitlines() if ln.startswith("epoch ")]) == 2
    assert "[obs] journal written to" in proc.stdout
