"""The port's SLO-guarded serving layer against the JAX package's,
mirroring tests/test_serve_slo.py: the chaos grammar and its errors, the
admission controller, capacity model and autoscaler fed one scripted clock
and observation stream (their decisions must be JAX's), the end-to-end
scenario paths on a tiny handle on the CPU, the serve CLI's SLO flags, and
the lenet_ref, cifar_cnn and ResNet-18 "xla" handles served against JAX's
on the same weights."""

import contextlib
import dataclasses
import io
import json
import signal
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.resilience import chaos as jax_chaos
from parallel_cnn_tpu.serve import admission as jax_admission
from parallel_cnn_tpu.serve import autoscaler as jax_autoscaler
from parallel_cnn_tpu.serve import capacity as jax_capacity
from parallel_cnn_tpu_torch import cli
from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.config import NotPortedError, ServeConfig
from parallel_cnn_tpu_torch.nn import ConvBNAct, Dense, GlobalAvgPool, Sequential
from parallel_cnn_tpu_torch.obs.events import EventJournal, conservation
from parallel_cnn_tpu_torch.obs.registry import MetricsRegistry
from parallel_cnn_tpu_torch.resilience import chaos
from parallel_cnn_tpu_torch.serve import (
    AdmissionController,
    AutoScaler,
    CapacityModel,
    Engine,
    ModelHandle,
    Overloaded,
    ReplicaPool,
    get,
    loadgen,
    scenarios,
    serve_stack,
)

pytestmark = pytest.mark.serve_slo

TINY_SHAPE = (8, 8, 3)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny_build(generator):
    return Sequential(
        ConvBNAct(3, 8, generator=generator),
        GlobalAvgPool(),
        Dense(8, 8, generator=generator),
    ).eval()


TINY = ModelHandle("tiny", TINY_SHAPE, 8, _tiny_build)


def tiny_cfg(**kw):
    base = dict(max_batch=4, max_wait_ms=5.0, queue_depth=64, precompile=False)
    base.update(kw)
    return ServeConfig(**base)


def _stack(**kw):
    stack_kw = {k: kw.pop(k) for k in ("admission", "chaos", "obs") if k in kw}
    return serve_stack(TINY, tiny_cfg(**kw), device="cpu", **stack_kw)


# ---------------------------------------------------------------------------
# the chaos grammar


MONKEY_FIELDS = ("nan_step", "kill_epoch", "kill_signal", "resize_delta",
                 "kill_replica_seq", "slow_replica", "slow_worker", "slow_stage",
                 "kill_endpoint_seq", "slow_loris")
VALID_SPECS = ["nan@3", "kill@1", "kill9@2", "resize@40:-4", "resize@5:+2",
               "kill-replica@7", "slow-replica@3:250", "slow-worker@2:100",
               "slow-stage@4:50.5", "kill-endpoint@9", "slow-loris@1:300"]
BAD_SPECS = ["nan", "nan@", "@3", "nan@x", "nan@-1", "bogus@3", "kill-replica@1.5",
             "slow-replica@3", "slow-replica@3:", "slow-replica@3:0",
             "slow-replica@3:-5", "slow-replica@x:100", "slow-loris@1",
             "slow-worker@2:nan?", "slow-stage@:5", "resize@4", "resize@4:0",
             "resize@x:1", "resize@3:+"]


def test_spec_kinds_and_grammar_equal_jax():
    assert chaos.SPEC_KINDS == jax_chaos.SPEC_KINDS
    assert chaos._GRAMMAR == jax_chaos._GRAMMAR
    # Every form of the grammar has a valid example here.
    assert {s.split("@")[0] for s in VALID_SPECS} == {
        k.split("@")[0] for k in chaos.SPEC_KINDS}


@pytest.mark.parametrize("spec", VALID_SPECS)
def test_from_spec_matches_jax(spec):
    port, ref = chaos.ChaosMonkey.from_spec(spec), jax_chaos.ChaosMonkey.from_spec(spec)
    assert {f: getattr(port, f) for f in MONKEY_FIELDS} == {
        f: getattr(ref, f) for f in MONKEY_FIELDS}
    # The one-shot hooks fire at the same sequence numbers, once.
    for hook in ("kill_replica_at", "slow_replica_at", "slow_worker_at",
                 "slow_stage_at", "kill_endpoint_at", "slow_loris_at",
                 "resize_at"):
        assert [getattr(port, hook)(i) for i in range(12)] == [
            getattr(ref, hook)(i) for i in range(12)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_spec_rejected_with_jax_message(spec):
    with pytest.raises(ValueError) as port:
        chaos.ChaosMonkey.from_spec(spec)
    with pytest.raises(ValueError) as ref:
        jax_chaos.ChaosMonkey.from_spec(spec)
    assert str(port.value) == str(ref.value)


def test_kill_signal_and_after_step_poison():
    assert chaos.ChaosMonkey.from_spec("kill9@2").kill_signal == signal.SIGKILL
    m = chaos.ChaosMonkey(nan_step=1)
    tree = {"w": torch.ones(3), "n": torch.tensor([4], dtype=torch.int32),
            "s": [torch.zeros(2, dtype=torch.float64)]}
    same, _ = m.after_step(tree, 0.5)
    assert same is tree
    poisoned, loss = m.after_step(tree, 0.5)
    assert loss == 0.5 and m.nan_fired
    assert torch.isnan(poisoned["w"]).all() and torch.isnan(poisoned["s"][0]).all()
    assert poisoned["s"][0].dtype == torch.float64
    assert torch.equal(poisoned["n"], tree["n"])
    assert m.after_step(tree, 0.5)[0] is tree  # one-shot


def test_poison_tree_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal(3).astype(np.float32),
            "b": [np.arange(4, dtype=np.int32), rng.standard_normal((2, 2))]}
    port = chaos.poison_tree({"a": torch.from_numpy(tree["a"]),
                              "b": [torch.from_numpy(v) for v in tree["b"]]})
    ref = jax_chaos.poison_tree(tree)
    for p, r in zip((port["a"], *port["b"]), (ref["a"], *ref["b"])):
        r = np.asarray(r)
        np.testing.assert_array_equal(np.isnan(p.numpy()), np.isnan(r))
        if not np.isnan(r).any():
            np.testing.assert_array_equal(p.numpy(), r)


def test_file_damage_matches_jax(tmp_path):
    data = bytes(range(256)) * 8
    for fn, kw in ((chaos.truncate_file, {"keep_bytes": 16}),
                   (chaos.corrupt_file, {"seed": 3, "n_bytes": 64})):
        a, b = tmp_path / "a", tmp_path / "b"
        a.write_bytes(data)
        b.write_bytes(data)
        fn(str(a), **kw)
        getattr(jax_chaos, fn.__name__)(str(b), **kw)
        assert a.read_bytes() == b.read_bytes() != data


def test_hidden_native_lib_is_not_ported():
    with pytest.raises(NotPortedError, match="A6c"):
        with chaos.hidden_native_lib():
            pass


# ---------------------------------------------------------------------------
# admission, capacity and the autoscaler: one script, both packages


def _admission_script(seed, n=400):
    """(clock, op, args) steps: queue-wait and service observations and
    admits at rising and falling queue depths, both priorities, with and
    without deadlines."""
    rng = np.random.default_rng(seed)
    t, steps = 100.0, []
    for i in range(n):
        t += float(rng.exponential(0.002))
        r = rng.random()
        if r < 0.15:
            steps.append((t, "qwait", (float(rng.uniform(0, 0.3)),)))
        elif r < 0.3:
            steps.append((t, "service", (int(2 ** rng.integers(0, 4)),
                                         float(rng.uniform(0.001, 0.08)))))
        else:
            depth = int(100 * (0.5 + 0.5 * np.sin(i / 25.0)) * rng.uniform(0.8, 1.0))
            prio = "best-effort" if rng.random() < 0.3 else "guaranteed"
            deadline = t + float(rng.uniform(0.01, 0.4)) if rng.random() < 0.4 else None
            steps.append((t, "admit", (prio, deadline, depth, rng.random() < 0.5)))
    return steps


def _replay(ctrl, steps, clock):
    out = []
    for t, op, args in steps:
        clock[0] = t
        if op == "qwait":
            ctrl.observe_queue_wait(*args)
        elif op == "service":
            ctrl.observe_service(*args)
        else:
            prio, deadline, depth, pass_now = args
            verdict = ctrl.admit(priority=prio, deadline=deadline,
                                 now=t if pass_now else None, queue_depth=depth)
            out.append((verdict, ctrl.level, ctrl.level_name,
                        ctrl.predicted_wait_s(), ctrl.arrival_rate(),
                        ctrl.effective_wait_s(0.008), ctrl.effective_max_batch(64)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_equal_jax(seed, tmp_path):
    steps = _admission_script(seed)
    clock = [0.0]
    journal = EventJournal(str(tmp_path / "a.jsonl"))
    bundle = obs_lib.Obs(obs_lib.NOOP_TRACER, MetricsRegistry(), journal, enabled=True)
    port = AdmissionController(slo_ms=60.0, queue_depth=100, obs=bundle,
                               clock=lambda: clock[0])
    ref = jax_admission.AdmissionController(slo_ms=60.0, queue_depth=100,
                                            clock=lambda: clock[0])
    got, want = _replay(port, steps, clock), _replay(ref, steps, clock)
    assert got == want
    assert port.snapshot() == ref.snapshot()
    snap = port.snapshot()
    assert snap["rejected_late"] > 0 and snap["rejected_ladder"] > 0 and snap["admitted"] > 0
    levels = [g[1] for g in got]
    changes = sum(a != b for a, b in zip(levels, levels[1:]))
    assert changes > 0 and journal.counts()["admission_level"] == changes
    reg = MetricsRegistry()
    port.attach_registry(reg)
    assert reg.json_snapshot()["collected"]["admission"] == snap


@pytest.mark.parametrize("headroom", [0.6, 1.0])
def test_capacity_model_equal_jax(headroom):
    clock = [0.0]
    steps = _admission_script(7, n=200)
    port_ac = AdmissionController(slo_ms=100.0, queue_depth=100, clock=lambda: clock[0])
    ref_ac = jax_admission.AdmissionController(slo_ms=100.0, queue_depth=100,
                                               clock=lambda: clock[0])
    port = CapacityModel(port_ac, max_batch=4, headroom=headroom)
    ref = jax_capacity.CapacityModel(ref_ac, max_batch=4, headroom=headroom)
    assert port.replicas_needed() is None and ref.replicas_needed() is None
    for step in steps:
        _replay(port_ac, [step], clock)
        _replay(ref_ac, [step], clock)
        assert port.arrival_rate() == pytest.approx(ref.arrival_rate(), rel=1e-12, abs=1e-12)
        assert port.service_rate() == pytest.approx(ref.service_rate(), rel=1e-12, abs=1e-12)
        assert port.replicas_needed() == ref.replicas_needed()
    assert port.snapshot() == ref.snapshot()
    with pytest.raises(ValueError):
        CapacityModel(port_ac, max_batch=0)


class _ScriptedStats:
    def __init__(self):
        self.shed, self.p99, self.occ = 0.0, None, None

    def window_shed_rate(self):
        return self.shed

    def window_p99_ms(self):
        return self.p99

    def window_occupancy(self):
        return self.occ


class _FakePool:
    def __init__(self, n=1, cap=4):
        self.slots = [True] * n + [False] * (cap - n)
        self.draining = [False] * cap

    @property
    def n_replicas(self):
        return len(self.slots)

    def routable(self):
        return [i for i, a in enumerate(self.slots) if a and not self.draining[i]]

    def grow(self, device=None):
        i = self.slots.index(False)
        self.slots[i] = True
        return i

    def drain(self, i):
        self.draining[i] = True

    def retire(self, i):
        self.slots[i] = False
        self.draining[i] = False

    def respawn(self, i, device=None):
        self.slots[i] = True
        self.draining[i] = False


class _FakeBatcher:
    def __init__(self, stats):
        self.stats = stats
        self.n_runners = 1

    def add_runner(self):
        self.n_runners += 1

    def inflight(self, replica):
        return 0


def _autoscaler_run(mod, cap_mod, adm_mod, seed, predictive):
    rng = np.random.default_rng(seed)
    t = [0.0]
    stats = _ScriptedStats()
    pool = _FakePool(n=1, cap=4)
    capacity = None
    ac = None
    if predictive:
        ac = adm_mod.AdmissionController(slo_ms=100.0, queue_depth=64,
                                         clock=lambda: t[0])
        capacity = cap_mod.CapacityModel(ac, max_batch=8)
    sc = mod.AutoScaler(pool, _FakeBatcher(stats), min_replicas=1, max_replicas=3,
                        hysteresis=2, cooldown_s=0.5, capacity=capacity,
                        clock=lambda: t[0])
    trace = []
    for i in range(300):
        t[0] += 0.05
        phase = (i // 20) % 3
        if phase == 0:
            stats.shed, stats.p99, stats.occ = float(rng.uniform(0.1, 0.5)), 400.0, 0.9
        elif phase == 1:
            stats.shed, stats.p99, stats.occ = 0.0, float(rng.uniform(1, 40)), 0.05
        else:
            stats.shed = 0.0
            stats.p99 = float(rng.uniform(20, 150))
            stats.occ = float(rng.uniform(0, 1))
        if ac is not None:
            # Bursts of arrivals in the overloaded phase: the planner's
            # offered load runs ahead of the fleet.
            for k in range(20 if phase == 0 else 1):
                ac.admit(priority="guaranteed", deadline=None,
                         now=t[0] + 0.0005 * k, queue_depth=0)
            ac.observe_service(8, float(rng.uniform(0.01, 0.1)))
        trace.append((sc.tick(), tuple(pool.routable())))
    return trace, sc.actions, sc.snapshot()


@pytest.mark.parametrize("predictive", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_autoscaler_ticks_equal_jax(seed, predictive):
    import parallel_cnn_tpu_torch.serve.admission as adm
    import parallel_cnn_tpu_torch.serve.autoscaler as auto
    import parallel_cnn_tpu_torch.serve.capacity as cap

    got = _autoscaler_run(auto, cap, adm, seed, predictive)
    want = _autoscaler_run(jax_autoscaler, jax_capacity, jax_admission, seed, predictive)
    assert got == want
    trace, actions, snap = got
    assert snap["scale_ups"] >= 1 and snap["scale_downs"] >= 1
    times = [a[0] for a in actions]
    assert all(b - a >= 0.5 - 1e-9 for a, b in zip(times, times[1:]))
    if predictive:
        assert snap["predictive_ups"] >= 1


def test_autoscaler_hysteresis_blocks_oscillation():
    stats = _ScriptedStats()
    t = [0.0]
    sc = AutoScaler(_FakePool(), _FakeBatcher(stats), max_replicas=3,
                    hysteresis=2, cooldown_s=1.0, clock=lambda: t[0])
    for i in range(40):
        t[0] += 0.1
        if i % 2 == 0:
            stats.shed, stats.p99, stats.occ = 0.5, 500.0, 0.9
        else:
            stats.shed, stats.p99, stats.occ = 0.0, 1.0, 0.05
        sc.tick()
    assert sc.actions == [] and sc.direction_changes() == 0


# ---------------------------------------------------------------------------
# the pool's state machine on the CPU


def test_pool_grow_drain_retire_respawn():
    pool = ReplicaPool(TINY, n_replicas=1, max_batch=4, device="cpu")
    x = loadgen.make_samples(3, TINY_SHAPE, seed=1)
    base = pool.engines[0].predict(x)
    assert pool.grow() == 1 and pool.routable() == [0, 1]
    np.testing.assert_array_equal(pool.engines[1].predict(x), base)
    assert [pool.next_replica() for _ in range(4)] == [0, 1, 0, 1]
    pool.drain(1)
    assert pool.routable() == [0] and pool.alive() == [0, 1]
    assert [pool.next_replica() for _ in range(3)] == [0, 0, 0]
    pool.undrain(1)
    assert pool.routable() == [0, 1]
    pool.drain(1)
    pool.retire(1)
    assert pool.alive() == [0] and pool.engines[1].model is None
    with pytest.raises(Exception):
        pool.predict(x, replica=1)
    assert pool.grow() == 1  # the free slot is revived
    np.testing.assert_array_equal(pool.predict(x, replica=1)[0], base)
    pool.kill(0)
    assert pool.respawn(0) == 0 and pool.routable() == [0, 1]
    np.testing.assert_array_equal(pool.predict(x, replica=0)[0], base)
    # set_weights: replicas built from now on serve the new weights, live
    # ones keep theirs until retired.
    pool.set_weights(TINY.init(seed=5))
    assert pool.grow() == 2
    fresh = Engine(TINY, model=TINY.init(seed=5), max_batch=4, device="cpu")
    np.testing.assert_array_equal(pool.predict(x, replica=2)[0], fresh.predict(x))
    np.testing.assert_array_equal(pool.predict(x, replica=0)[0], base)
    assert pool.warmups == 0  # built without precompile


# ---------------------------------------------------------------------------
# end to end on the tiny handle


def test_reject_early_vs_no_admission():
    ac = AdmissionController(slo_ms=50.0, queue_depth=64)
    ac.observe_queue_wait(10.0)
    _, ba = _stack(admission=ac)
    _, bb = _stack()
    x = np.zeros(TINY_SHAPE, np.float32)
    with ba, bb:
        with pytest.raises(Overloaded, match="admission rejected"):
            ba.submit(x)
        assert bb.submit(x).result(timeout=30).shape == (8,)
        with pytest.raises(ValueError, match="priority"):
            bb.submit(x, priority="urgent")
    snap = ba.stats.snapshot()
    assert snap["submitted"] == snap["shed"] == 1 and snap["completed"] == 0


def test_flash_crowd_conservation_under_admission_shedding():
    ac = AdmissionController(slo_ms=15.0, queue_depth=64)
    ac.observe_queue_wait(0.050)
    _, b = _stack(max_wait_ms=2.0, admission=ac)
    with b:
        rep = scenarios.run("flash-crowd", b, seed=11, retry_attempts=1)
    assert rep.conservation_ok, rep.to_dict()
    assert rep.server["shed"] > 0 and rep.errors == 0
    assert rep.requests == rep.completed + rep.shed + rep.expired + rep.errors
    assert set(rep.gates()) == {"p99", "shed_rate", "conservation"}
    assert not rep.gates()["shed_rate"]  # a primed controller sheds: the gate trips


def test_scale_down_drain_loses_nothing():
    pool, b = _stack(n_replicas=2, max_wait_ms=1.0)
    sc = AutoScaler(pool, b, min_replicas=1, max_replicas=2, hysteresis=1,
                    cooldown_s=0.0, slo_ms=1e6, occupancy_low=2.0)
    x = np.zeros(TINY_SHAPE, np.float32)
    futures = []
    stop = threading.Event()

    def feeder():
        while not stop.is_set():
            try:
                futures.append(b.submit(x))
            except Overloaded:
                pass
            time.sleep(0.001)

    with b:
        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        time.sleep(0.05)
        deadline = time.monotonic() + 10.0
        while len(pool.routable()) > 1:
            sc.tick()
            if time.monotonic() > deadline:
                pytest.fail("scale-down never completed")
            time.sleep(0.005)
        time.sleep(0.05)
        stop.set()
        th.join(timeout=5)
        for f in futures:
            assert f.result(timeout=30).shape == (8,)
    assert sc.snapshot()["scale_downs"] == 1
    assert pool.engines[1].model is None  # the retired replica holds nothing
    snap = b.stats.snapshot()
    assert snap["failed"] == 0 and snap["completed"] == len(futures)


def test_autoscaler_grow_adds_a_runner_that_serves():
    pool, b = _stack(n_replicas=1, max_wait_ms=1.0)
    sc = AutoScaler(pool, b, min_replicas=1, max_replicas=2)
    with b:
        assert sc._scale_up(0.0) == "up"
        assert b.n_runners == pool.n_replicas == 2
        futs = [b.submit(x) for x in loadgen.make_samples(16, TINY_SHAPE)]
        assert all(f.result(timeout=30).shape == (8,) for f in futs)
    assert {f.replica for f in futs} == {0, 1}


def test_slow_replica_trips_p99_gate():
    _, b = _stack(max_wait_ms=1.0, chaos=chaos.ChaosMonkey.from_spec("slow-replica@3:400"))
    with b:
        rep = scenarios.run("chaos-slow", b, seed=2)
    assert b.chaos.slow_replica_fired
    assert not rep.gates()["p99"] and not rep.passed, rep.to_dict()
    assert rep.conservation_ok and rep.errors == 0
    assert rep.p99_ms is not None and rep.p99_ms > 150.0


def test_chaos_kill_failover_resolves_each_request_once(tmp_path):
    journal = EventJournal(str(tmp_path / "j.jsonl"))
    bundle = obs_lib.Obs(obs_lib.NOOP_TRACER, MetricsRegistry(), journal, enabled=True)
    pool, b = _stack(n_replicas=2, max_wait_ms=1.0, obs=bundle,
                     chaos=chaos.ChaosMonkey.from_spec("kill-replica@5"))
    with b:
        rep = scenarios.run("chaos-kill", b, seed=4)
    assert b.chaos.kill_replica_fired
    assert rep.conservation_ok and rep.errors == 0, rep.to_dict()
    jc = journal.counts()
    assert jc["failover"] == jc["replica_evicted"] == jc["replica_respawned"] >= 1
    assert conservation(jc) is None and jc["submit"] == rep.server["submitted"]
    journal.close()
    terminal = {}
    for rec in obs_lib.read_journal(journal.path):
        if rec["kind"] in ("complete", "shed", "expired", "failed"):
            terminal[rec["req"]] = terminal.get(rec["req"], 0) + 1
    assert len(terminal) == jc["submit"] and set(terminal.values()) == {1}
    assert pool.routable() == [0, 1]


def test_chaos_scenario_refuses_unarmed_batcher():
    _, b = _stack()
    with b:
        with pytest.raises(ValueError, match="slow-replica"):
            scenarios.run("chaos-slow", b, seed=0)
    with pytest.raises(ValueError, match="unknown scenario"):
        scenarios.run("net-steady", b)


def test_scenario_specs_equal_jax():
    from parallel_cnn_tpu.serve import scenarios as jax_scenarios

    assert {k: dataclasses.asdict(v) for k, v in scenarios.SCENARIOS.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_scenarios.SCENARIOS.items()}
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for spec in scenarios.SCENARIOS.values():
        if spec.phases:
            assert scenarios._phase_offsets(spec.phases, rng_a) == \
                jax_scenarios._phase_offsets(spec.phases, rng_b)


def test_serve_stack_cache_dir_is_not_ported():
    with pytest.raises(NotPortedError, match="A12b"):
        serve_stack(TINY, tiny_cfg(), device="cpu", cache_dir="/nowhere")


# ---------------------------------------------------------------------------
# the CLI


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def test_cli_flash_crowd_with_admission_autoscaler_and_trace(tmp_path):
    mj = str(tmp_path / "m.json")
    rc, out = _cli(["serve", "--device", "cpu", "--model", "lenet_ref",
                    "--max-batch", "8", "--admission", "--autoscale",
                    "--max-replicas", "2", "--scenario", "flash-crowd",
                    "--trace", "--trace-dir", str(tmp_path / "obs"),
                    "--metrics-json", mj, "--json", str(tmp_path / "r.json")])
    # The p99 and shed gates depend on this host's speed under load; the
    # verdict line, its exit code and conservation do not.
    assert rc == (0 if "[serve] gates PASS: " in out else 1), out
    assert "conservation=ok" in out and "[serve] gates " in out
    assert "[serve] admission control on (SLO 100 ms)" in out
    assert "[serve] autoscaler on (1..2 replicas, p99 target 100 ms)" in out
    assert "[serve] autoscaler: " in out
    with open(tmp_path / "obs" / "serve_trace.json") as f:
        assert obs_lib.validate_nesting(json.load(f)["traceEvents"]) == []
    with open(tmp_path / "r.json") as f:
        report = json.load(f)
    assert {"admission", "autoscaler", "window"} <= set(report)
    with open(mj) as f:
        collected = json.load(f)["collected"]
    assert collected["serve"]["submitted"] == report["telemetry"]["submitted"]


def test_cli_chaos_slow_exits_one():
    rc, out = _cli(["serve", "--device", "cpu", "--model", "lenet_ref",
                    "--max-batch", "8", "--scenario", "chaos-slow",
                    "--chaos", "slow-replica@3:400"])
    assert rc == 1
    assert "[serve] gates FAIL: p99=TRIPPED" in out


@pytest.mark.parametrize("extra", [["--aot-cache-dir", "/tmp/aot"]])
def test_cli_wire_flags_raise_not_ported(extra):
    with pytest.raises(NotPortedError, match="A12b"):
        cli.main(["serve", "--device", "cpu", *extra])


def _free_port() -> int:
    """A port the OS has just handed out and taken back: no fixed number
    that another process on the host may hold."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("extra", [
    ["--listen"], ["--listen-port", "FREE"], ["--listen-host", "0.0.0.0"],
    ["--conn-deadline-ms", "100"], ["--supervise"],
    ["--swap-checkpoint", "x.npz"],
    ["--scenario", "net-steady"], ["--scenario", "net-hot-swap-diurnal"],
])
def test_cli_wire_flags_serve_over_the_wire(extra):
    """The front door's flags, each with --listen, on lenet_ref: the
    endpoint's line, the traffic or the scenario's gates over the socket,
    and JAX's wire line, balanced. --listen-port gets a port the OS says
    is free, never a fixed one."""
    if extra[0] == "--listen-port":
        extra = ["--listen-port", str(_free_port())]
    rc, out = _cli(["serve", "--device", "cpu", "--model", "lenet_ref", "--max-batch",
                    "8", "--requests", "16", "--listen", *extra])
    assert rc == 0, out
    host = extra[1] if extra[0] == "--listen-host" else "127.0.0.1"
    port = extra[1] if extra[0] == "--listen-port" else ""
    deadline = extra[1] if extra[0] == "--conn-deadline-ms" else "2000"
    supervised = ", supervised" if extra[0] == "--supervise" else ""
    assert f"[serve] listening on {host}:{port}" in out, out
    assert f"(conn deadline {deadline} ms{supervised})" in out, out
    if extra[0] == "--scenario":
        assert f"[serve] scenario {extra[1]}: " in out and "[serve] gates PASS: " in out
        assert "wire_conservation=ok" in out
    else:
        assert "[serve] closed-net-loop: " in out and "req/s over the wire" in out
    wire = next(ln for ln in out.splitlines() if ln.startswith("[serve] wire: "))
    assert "(balanced; 0 reaped, 0 endpoint deaths" in wire, wire
    assert wire.endswith(", 0 respawns)" if supervised else "endpoint deaths)"), wire


def test_cli_net_scenario_without_listen_exits_two():
    rc, out = _cli(["serve", "--device", "cpu", "--model", "lenet_ref",
                    "--scenario", "net-slow-loris", "--chaos", "slow-loris@3:400"])
    assert rc == 2
    assert "[serve] scenario net-slow-loris needs --listen (it judges the wire tier)" in out


def test_serve_config_slo_fields_from_env(monkeypatch):
    from parallel_cnn_tpu.config import ServeConfig as JaxServeConfig

    env = {"PCNN_SERVE_ADMISSION": "1", "PCNN_SERVE_SLO_MS": "40",
           "PCNN_SERVE_AUTOSCALE": "1", "PCNN_SERVE_MAX_REPLICAS": "3",
           "PCNN_SERVE_WINDOW_S": "2.5"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = ServeConfig.from_env(), JaxServeConfig.from_env()
    for f in ("admission", "slo_ms", "autoscale", "max_replicas", "window_s"):
        assert getattr(port, f) == getattr(ref, f)
    assert port.effective_max_replicas == ref.effective_max_replicas == 3
    with pytest.raises(ValueError):
        ServeConfig(n_replicas=2, max_replicas=1)
    with pytest.raises(ValueError):
        ServeConfig(slo_ms=0)


# ---------------------------------------------------------------------------
# lenet_ref, cifar_cnn and ResNet-18 "xla" against JAX's handles


def _jax_weights(name, tmp_path):
    """A JAX-written checkpoint of seeded weights (random BN statistics for
    the zoo models) and JAX's logits on 4 samples."""
    from parallel_cnn_tpu.serve import registry as jax_registry
    from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
    from parallel_cnn_tpu.train.zoo import ZooState

    handle = jax_registry.get(name, conv_backend="xla")
    rng = np.random.default_rng(0)
    if name == "lenet_ref":
        params = jax.tree_util.tree_map(np.asarray, handle.init(jax.random.key(0))[0])
        state = {}
        path = str(tmp_path / "lenet.npz")
        jax_checkpoint.save(path, params)
    else:
        from parallel_cnn_tpu.nn import cifar as jax_cifar
        from parallel_cnn_tpu.nn import resnet as jax_resnet
        from tests._torch_jax_init import jax_init

        module = (jax_cifar.cifar_cnn() if name == "cifar_cnn"
                  else jax_resnet.resnet18(10, cifar_stem=True, conv_backend="xla"))
        params, state = jax_init(module, handle.in_shape, seed=0)

        def bn(tree):
            if isinstance(tree, dict):
                out = {}
                for k, v in tree.items():
                    if k in ("scale", "var"):
                        out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                    elif k in ("bias", "mean") and np.ndim(v) == 1:
                        out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                    else:
                        out[k] = bn(v)
                return out
            if isinstance(tree, (list, tuple)):
                return type(tree)(bn(v) for v in tree)
            return tree

        params, state = bn(params), bn(state)
        path = str(tmp_path / f"{name}.npz")
        jax_checkpoint.save(path, ZooState(params, state, {}))
    x = rng.uniform(0.0, 1.0, (4, *handle.in_shape)).astype(np.float32)
    logits = np.asarray(jax.jit(handle.forward)(params, state, x))
    return path, x, logits


@pytest.mark.parametrize("name,backend", [
    ("lenet_ref", None), ("cifar_cnn", "xla"), ("resnet18", "xla")])
def test_served_handles_match_jax(name, backend, tmp_path):
    path, x, ref = _jax_weights(name, tmp_path)
    handle = get(name, conv_backend=backend)
    pool = ReplicaPool(handle, checkpoint=path, max_batch=4, device="cpu", seed=9)
    eng = pool.engines[0]
    got = eng.predict(x)
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    line = cli.padded_bucket_parity(eng, handle.in_shape, seed=0)
    assert line == "padded-bucket parity (n=3→b4): bit-identical"


def test_registry_backend_rules():
    for name in ("lenet_ref", "cifar_cnn"):
        with pytest.raises(ValueError, match="resnet/vgg"):
            get(name, conv_backend="cuda")
    assert get("lenet_ref").in_shape == (28, 28)
    assert get("cifar_cnn", conv_backend="xla").in_shape == (32, 32, 3)
    with pytest.raises(ValueError):
        get("resnet18", conv_backend="pallas")
    kernel = get("resnet18").init(0)
    library = get("resnet18", conv_backend="xla").init(0)
    assert kernel[0].backend == "cuda" and library[0].backend == "torch"
    for a, b in zip(kernel.state_dict().values(), library.state_dict().values()):
        assert torch.equal(a, b)
