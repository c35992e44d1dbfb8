"""The port's observability layer (parallel_cnn_tpu_torch.obs) against the
JAX package's (parallel_cnn_tpu.obs), mirroring tests/test_obs.py: the
tracer's Chrome trace and nesting check, the journal's sequence ids, merge
and conservation law (also under a kill-replica@ failover), the metrics
registry's Prometheus text byte for byte and its JSON snapshot, and the
ObsConfig gating."""

import json
import threading

import numpy as np
import pytest
import torch

from parallel_cnn_tpu import obs as jax_obs
from parallel_cnn_tpu.config import ObsConfig as JaxObsConfig
from parallel_cnn_tpu.serve.telemetry import ServeStats as JaxServeStats
from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.config import ObsConfig, ServeConfig
from parallel_cnn_tpu_torch.nn import ConvBNAct, Dense, GlobalAvgPool, Sequential
from parallel_cnn_tpu_torch.obs.events import EventJournal, conservation, merge_journals
from parallel_cnn_tpu_torch.obs.registry import MetricsRegistry
from parallel_cnn_tpu_torch.obs.trace import NOOP_TRACER, Tracer, validate_nesting
from parallel_cnn_tpu_torch.resilience.chaos import ChaosMonkey
from parallel_cnn_tpu_torch.serve import ModelHandle, ServeStats, loadgen, serve_stack

pytestmark = pytest.mark.obs

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
        Dense(8, 10, generator=generator),
    ).eval()


TINY = ModelHandle("tiny", TINY_SHAPE, 10, _tiny_build)


# ------------------------------------------------------------------ tracer


def test_span_nesting_valid_across_threads():
    tracer = Tracer(process_name="test")
    barrier = threading.Barrier(8)

    def worker(tid):
        barrier.wait()
        rng = np.random.default_rng((7, tid))
        for i in range(20):
            with tracer.span("outer", cat="t", tid=tid, i=i):
                for _ in range(int(rng.integers(1, 4))):
                    with tracer.span("inner", cat="t"):
                        with tracer.span("leaf", cat="t"):
                            pass

    threads = [threading.Thread(target=worker, args=(t,), name=f"obs-{t}")
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    events = tracer.events()
    assert validate_nesting(events) == []
    assert jax_obs.validate_nesting(events) == []
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) >= 8 * 20 * 3 and all(e["dur"] >= 0 for e in xs)
    assert sum(e["ph"] == "M" and e["name"] == "thread_name" for e in events) == 8


def test_validate_nesting_matches_jax():
    good = [
        {"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "b", "pid": 1, "tid": 1, "ts": 2.0, "dur": 3.0},
        {"ph": "X", "name": "c", "pid": 1, "tid": 1, "ts": 6.0, "dur": 2.0},
    ]
    bad = good + [{"ph": "X", "name": "z", "pid": 1, "tid": 1, "ts": 9.0, "dur": 5.0}]
    other = good + [{"ph": "X", "name": "z", "pid": 1, "tid": 2, "ts": 9.0, "dur": 5.0}]
    for events in (good, bad, other):
        got = validate_nesting([dict(e) for e in events])
        assert got == jax_obs.validate_nesting([dict(e) for e in events])
    assert len(validate_nesting(bad)) == 1 and "'z'" in validate_nesting(bad)[0]


def test_tracer_export_is_loadable_chrome_trace(tmp_path):
    tracer = Tracer(process_name="pcnn:test", mirror=True)
    with tracer.span("step", cat="serve", epoch=1):
        pass
    tracer.begin_async("request", 0xBEEF)
    tracer.end_async("request", 0xBEEF)
    tracer.instant("marker", cat="serve")
    with open(tracer.export(str(tmp_path / "t" / "trace.json"))) as f:
        payload = json.load(f)
    assert payload["displayTimeUnit"] == "ms"
    evs = payload["traceEvents"]
    assert {"M", "X", "b", "e", "i"} <= {e["ph"] for e in evs}
    proc = [e for e in evs if e["ph"] == "M" and e["name"] == "process_name"]
    assert proc[0]["args"]["name"] == "pcnn:test"
    assert next(e for e in evs if e["ph"] == "X")["args"] == {"epoch": 1}
    b = next(e for e in evs if e["ph"] == "b")
    assert b["id"] == "0xbeef" and b["cat"] == "req"
    assert jax_obs.validate_nesting(evs) == []


# ----------------------------------------------------------------- journal


def _strip_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def test_journal_records_and_merge_match_jax(tmp_path):
    """The same emits give the same records (timestamps aside), counts and
    (proc, seq) merge in both packages."""
    paths = {}
    for pkg, cls in (("port", EventJournal), ("jax", jax_obs.EventJournal)):
        j0 = cls(str(tmp_path / pkg / "h0.jsonl"), process_index=0)
        j1 = cls(str(tmp_path / pkg / "h1.jsonl"), process_index=1)
        j1.emit("epoch", epoch=1)
        j0.emit("epoch", epoch=1, loss=0.5)
        j0.emit("checkpoint", epoch=2)
        j1.emit("epoch", epoch=2)
        assert j0.counts() == {"epoch": 1, "checkpoint": 1}
        j0.close()
        j1.close()
        paths[pkg] = (j0.path, j1.path)
    port = merge_journals(list(paths["port"]))
    assert port == merge_journals(list(reversed(paths["port"])))
    assert _strip_ts(port) == _strip_ts(jax_obs.merge_journals(list(paths["jax"])))
    assert [(r["proc"], r["seq"]) for r in port] == [(0, 1), (0, 2), (1, 1), (1, 2)]


@pytest.mark.parametrize("counts", [
    {}, {"epoch": 5},
    {"submit": 10, "complete": 7, "shed": 1, "expired": 1, "failed": 1},
    {"submit": 10, "complete": 7},
    {"net_submit": 3, "net_complete": 2}, {"net_submit": 3, "net_failed": 3},
])
def test_conservation_law_matches_jax(counts):
    for prefix in ("", "net_"):
        assert conservation(counts, prefix) == jax_obs.conservation(counts, prefix)


def test_journal_conservation_under_kill_replica(tmp_path):
    """Traffic through a two-replica stack with kill-replica@2 armed: the
    replica dies with a batch in flight, the batch is retried on the
    survivor, and the journal's lifecycle counts balance and equal
    ServeStats' counters, with one terminal event per request."""
    tracer = Tracer(process_name="chaos")
    journal = EventJournal(str(tmp_path / "serve.jsonl"))
    bundle = obs_lib.Obs(tracer, MetricsRegistry(), journal, enabled=True)
    cfg = ServeConfig(max_batch=4, max_wait_ms=1.0, queue_depth=64,
                      n_replicas=2, precompile=False)
    pool, batcher = serve_stack(TINY, cfg, device="cpu", obs=bundle,
                                chaos=ChaosMonkey.from_spec("kill-replica@2"))
    xs = loadgen.make_samples(48, TINY_SHAPE, seed=3)
    with batcher:
        futs = [batcher.submit(x) for x in xs]
        outs = np.stack([f.result(timeout=30) for f in futs])
    assert batcher.chaos.kill_replica_fired
    ref = np.concatenate([pool.engines[0].predict(xs[i:i + 4])
                          for i in range(0, 48, 4)])
    np.testing.assert_allclose(outs, ref, rtol=0, atol=1e-5)
    jc = journal.counts()
    assert jc["submit"] == 48 and conservation(jc) is None
    # One failover per batch that found the replica dead (the batch it died
    # under, and any other already dispatched to it).
    assert jc["replica_evicted"] == jc["failover"] == jc["replica_respawned"] >= 1
    snap = batcher.stats.snapshot()
    for kind, key in (("submit", "submitted"), ("complete", "completed"),
                      ("shed", "shed"), ("expired", "expired"),
                      ("failed", "failed")):
        assert jc.get(kind, 0) == snap[key]
    journal.close()
    terminal = {}
    for rec in obs_lib.read_journal(journal.path):
        if rec["kind"] in ("complete", "shed", "expired", "failed"):
            terminal[rec["req"]] = terminal.get(rec["req"], 0) + 1
    assert sorted(terminal.values()) == [1] * 48
    assert validate_nesting(tracer.events()) == []
    assert pool.alive() == [0, 1]


# ---------------------------------------------------------------- registry


def _fill(reg):
    reg.counter("train.steps", help="total steps").inc(3)
    reg.gauge("queue.depth").set(2)
    h = reg.histogram("lat")
    for v in (0.5, 0.002, 0.04):
        h.record(v)
    reg.attach("serve", lambda: {"submitted": 4, "latency_ms": {"count": 2},
                                 "ok": True, "name": "x"})


def test_prometheus_text_byte_equal_to_jax():
    port, ref = MetricsRegistry(), jax_obs.MetricsRegistry()
    _fill(port)
    _fill(ref)
    assert port.prometheus_text() == ref.prometheus_text()
    assert port.json_snapshot() == ref.json_snapshot()
    empty = MetricsRegistry()
    assert empty.prometheus_text() == jax_obs.MetricsRegistry().prometheus_text()


def test_prometheus_text_golden():
    reg = MetricsRegistry()
    reg.counter("train.steps", help="total steps").inc(3)
    reg.gauge("queue.depth").set(2)
    reg.histogram("lat").record(0.5)
    assert reg.prometheus_text() == (
        "# HELP train_steps total steps\n"
        "# TYPE train_steps counter\n"
        "train_steps 3\n"
        "# TYPE queue_depth gauge\n"
        "queue_depth 2.0\n"
        "# TYPE lat summary\n"
        'lat{quantile="0.50"} 0.5\n'
        'lat{quantile="0.90"} 0.5\n'
        'lat{quantile="0.99"} 0.5\n'
        "lat_count 1\n"
        "lat_sum 0.5\n"
    )


def test_serve_stats_collector_text_equal_to_jax():
    """ServeStats fed the same script on one fake clock expose the same
    Prometheus text through either registry."""
    t = [0.0]
    stats = {"port": ServeStats(window_s=2.0, clock=lambda: t[0]),
             "jax": JaxServeStats(window_s=2.0, clock=lambda: t[0])}
    rng = np.random.default_rng(5)
    for _ in range(50):
        t[0] += float(rng.uniform(0, 0.05))
        for s in stats.values():
            s.on_submit()
        kind = int(rng.integers(4))
        lat = float(rng.uniform(1e-4, 0.2))
        for s in stats.values():
            if kind == 0:
                s.on_shed()
            elif kind == 1:
                s.on_expired(1)
            else:
                s.on_batch(n=3, bucket=4, replica=kind - 2, queue_depth=2)
                s.on_complete(lat)
    port, ref = MetricsRegistry(), jax_obs.MetricsRegistry()
    stats["port"].attach_registry(port)
    stats["jax"].attach_registry(ref)
    assert port.prometheus_text() == ref.prometheus_text()
    # Live, not cached.
    stats["port"].on_submit()
    assert port.json_snapshot()["collected"]["serve"]["submitted"] == 51


def test_registry_merge_two_hosts():
    host0, host1 = MetricsRegistry(), MetricsRegistry()
    host0.counter("steps").inc(5)
    host1.counter("steps").inc(7)
    host1.counter("only_h1").inc(1)
    host0.gauge("depth").set(2)
    host1.gauge("depth").set(9)
    host0.histogram("lat").record(0.1)
    host1.histogram("lat").record(0.3)
    host0.merge(host1)
    assert host0.counter("steps").value == 12
    assert host0.counter("only_h1").value == 1
    assert host0.gauge("depth").value == 9.0
    assert host0.histogram("lat").count == 2
    a, b = MetricsRegistry(), MetricsRegistry()
    a.histogram("h", lo=1e-5, hi=100.0, bins=96)
    b.histogram("h", lo=1e-3, hi=10.0, bins=32).record(0.5)
    with pytest.raises(ValueError, match="binning mismatch"):
        a.merge(b)


def test_write_json(tmp_path):
    reg = MetricsRegistry()
    reg.counter("c").inc(2)
    with open(reg.write_json(str(tmp_path / "m" / "metrics.json"))) as f:
        assert json.load(f)["counters"] == {"c": 2}


# ------------------------------------------------------------------ gating


@pytest.mark.parametrize("env", [
    {}, {"PCNN_OBS_TRACE": "1"}, {"PCNN_OBS_TRACE": "0"},
    {"PCNN_OBS_TRACE": "0", "PCNN_OBS_METRICS_JSON": "/tmp/m.json",
     "PCNN_OBS_DIR": "elsewhere", "PCNN_OBS_JAX": "0"},
    {"PCNN_OBS_DIR": "d"},
])
def test_obsconfig_from_env_matches_jax(monkeypatch, env):
    for var in ("PCNN_OBS_TRACE", "PCNN_OBS_DIR", "PCNN_OBS_METRICS_JSON",
                "PCNN_OBS_JAX"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = ObsConfig.from_env(), JaxObsConfig.from_env()
    assert (port is None) == (ref is None)
    if port is not None:
        assert (port.trace, port.dir, port.metrics_json, port.annotations,
                port.enabled) == (ref.trace, ref.dir, ref.metrics_json,
                                  ref.jax_annotations, ref.enabled)


def test_from_config_gating_and_noop_identity(tmp_path):
    assert obs_lib.from_config(None) is obs_lib.NOOP
    assert obs_lib.from_config(ObsConfig(trace=False)) is obs_lib.NOOP
    noop = obs_lib.NOOP
    assert noop.span("a") is noop.span("b")
    assert not noop.enabled and noop.event("epoch", epoch=1) is None
    assert noop.finish() == {} and noop.tracer.events() == []
    mj = str(tmp_path / "m.json")
    bundle = obs_lib.from_config(ObsConfig(trace=False, metrics_json=mj), run="x")
    assert bundle.enabled and bundle.tracer is NOOP_TRACER
    assert not bundle.journal.enabled
    bundle.registry.counter("c").inc()
    assert set(bundle.finish()) == {"metrics"}
    full = obs_lib.from_config(ObsConfig(trace=True, dir=str(tmp_path)), run="phase1")
    with full.span("s"):
        pass
    full.event("epoch", epoch=1)
    arts = full.finish()
    assert arts["trace"].endswith("phase1_trace.json")
    assert arts["journal"].endswith("phase1_journal.jsonl")
