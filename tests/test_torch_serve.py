"""The port's serving stack on the CPU (parallel_cnn_tpu_torch.serve):
bucket ladder, padded-bucket parity, batcher conservation and typed
backpressure, deadlines, replica failover, the load generator, the CLI,
and the GPU-by-default rule of every entry point."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_cnn_tpu_torch.cli import padded_bucket_parity
from parallel_cnn_tpu_torch.config import ServeConfig
from parallel_cnn_tpu_torch.nn import ConvBNAct, Dense, GlobalAvgPool, Sequential
from parallel_cnn_tpu_torch.serve import (
    DeadlineExceeded,
    DynamicBatcher,
    Engine,
    ModelHandle,
    Overloaded,
    ReplicaDead,
    ReplicaPool,
    bucket_for,
    get,
    loadgen,
    serve_stack,
)
from parallel_cnn_tpu_torch.utils.backend import NoGpuError, resolve_device
from parallel_cnn_tpu_torch.utils.metrics import Histogram

REPO = Path(__file__).resolve().parent.parent
TINY_SHAPE = (8, 8, 3)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: keep PyTorch's
    CPU kernels to two threads each, as the JAX tests beside them expect."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny_build(generator):
    return Sequential(
        ConvBNAct(3, 8, generator=generator),
        ConvBNAct(8, 16, stride=2, generator=generator),
        GlobalAvgPool(),
        Dense(16, 10, generator=generator),
    ).eval()


TINY = ModelHandle("tiny", TINY_SHAPE, 10, _tiny_build)


@pytest.mark.parametrize(
    "n,max_batch,want",
    [(1, 8, 1), (2, 8, 2), (3, 8, 4), (5, 8, 8), (8, 8, 8), (33, 64, 64)],
)
def test_bucket_for(n, max_batch, want):
    assert bucket_for(n, max_batch) == want


@pytest.mark.parametrize("n", [0, 9])
def test_bucket_for_rejects(n):
    with pytest.raises(ValueError):
        bucket_for(n, 8)


def test_engine_buckets_and_precompile():
    eng = Engine(TINY, max_batch=8, device="cpu", precompile=True)
    assert eng.buckets == [1, 2, 4, 8]
    assert sorted(eng.stats.warm_seconds) == [1, 2, 4, 8]
    assert eng.stats.warmups == 4
    eng.precompile()  # idempotent
    assert eng.stats.warmups == 4


def test_engine_rejects_non_power_of_two_max_batch():
    with pytest.raises(ValueError, match="power of two"):
        Engine(TINY, max_batch=6, device="cpu")


def test_padded_bucket_parity_bit_identical_resnet18():
    """Full-width ResNet-18 on the CPU: n=3 padded into bucket 4 gives the
    same bits as the direct bucket-4 forward."""
    eng = Engine(get("resnet18"), max_batch=4, device="cpu")
    line = padded_bucket_parity(eng, eng.handle.in_shape, seed=0)
    assert line == "padded-bucket parity (n=3→b4): bit-identical"


def test_predict_pads_and_unpads():
    eng = Engine(TINY, max_batch=8, device="cpu")
    xs = loadgen.make_samples(5, TINY_SHAPE, seed=1)
    got = eng.predict(xs)
    assert got.shape == (5, 10)
    full = np.concatenate([xs, np.zeros((3, *TINY_SHAPE), np.float32)])
    ref = eng.forward(torch.from_numpy(full)).numpy()[:5]
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="expected"):
        eng.predict(np.zeros((2, 4, 4, 3), np.float32))


def _stack(**kw):
    cfg = ServeConfig(model="resnet18", max_batch=kw.pop("max_batch", 4),
                      queue_depth=kw.pop("queue_depth", 8),
                      max_wait_ms=kw.pop("max_wait_ms", 1.0),
                      n_replicas=kw.pop("n_replicas", 1), precompile=False)
    return serve_stack(TINY, cfg, device="cpu", **kw)


def _conserved(stats):
    s = stats.snapshot()
    return s["submitted"] == s["completed"] + s["shed"] + s["expired"] + s["failed"]


def test_batcher_overloaded_then_conservation():
    pool, batcher = _stack(queue_depth=4, start=False)
    xs = loadgen.make_samples(6, TINY_SHAPE, seed=2)
    futs = [batcher.submit(x) for x in xs[:4]]
    with pytest.raises(Overloaded):
        batcher.submit(xs[4])
    with pytest.raises(Overloaded):
        batcher.submit(xs[5])
    with batcher:
        batcher.start()
        outs = np.stack([f.result(timeout=30) for f in futs])
    np.testing.assert_allclose(outs, pool.engines[0].predict(xs[:4]), atol=1e-6)
    s = batcher.stats.snapshot()
    assert (s["submitted"], s["completed"], s["shed"]) == (6, 4, 2)
    assert _conserved(batcher.stats)


def test_batcher_expires_overdue_requests():
    _, batcher = _stack(start=False)
    xs = loadgen.make_samples(3, TINY_SHAPE, seed=3)
    late = [batcher.submit(x, deadline_ms=1) for x in xs[:2]]
    ok = batcher.submit(xs[2], deadline_ms=0)  # 0: no deadline
    time.sleep(0.02)
    with batcher:
        batcher.start()
        assert ok.result(timeout=30).shape == (10,)
        for f in late:
            with pytest.raises(DeadlineExceeded):
                f.result(timeout=30)
    s = batcher.stats.snapshot()
    assert (s["completed"], s["expired"]) == (1, 2)
    assert _conserved(batcher.stats)


def test_batcher_rejects_wrong_sample_shape():
    _, batcher = _stack(start=False)
    with batcher, pytest.raises(ValueError, match="single sample"):
        batcher.submit(np.zeros((1, *TINY_SHAPE), np.float32))


def test_killed_replica_is_skipped_and_respawned():
    pool, batcher = _stack(n_replicas=2)
    assert [pool.next_replica() for _ in range(4)] == [0, 1, 0, 1]
    pool.kill(1)
    assert pool.alive() == [0]
    assert [pool.next_replica() for _ in range(3)] == [0, 0, 0]
    with batcher:
        futs = [batcher.submit(x) for x in loadgen.make_samples(8, TINY_SHAPE)]
        assert all(f.result(timeout=30).shape == (10,) for f in futs)
    assert pool.respawn(1) == 1 and pool.alive() == [0, 1]
    assert _conserved(batcher.stats)


def test_requests_fail_typed_when_every_replica_is_dead():
    pool, batcher = _stack()
    pool.kill(0)
    with batcher:
        fut = batcher.submit(loadgen.make_samples(1, TINY_SHAPE)[0])
        with pytest.raises(ReplicaDead):
            fut.result(timeout=30)
    assert batcher.stats.snapshot()["failed"] == 1
    assert _conserved(batcher.stats)


@pytest.mark.parametrize("pattern", ["closed", "open"])
def test_loadgen_run_completes_everything(pattern):
    _, batcher = _stack(max_batch=8, queue_depth=64)
    with batcher:
        report = loadgen.run(batcher, pattern=pattern, n_requests=48,
                             concurrency=4, rate=2000.0, seed=0)
    assert report.requests == 48
    assert report.completed == 48 and report.shed == 0 and report.errors == 0
    assert report.latency.summary()["count"] == 48
    assert report.to_dict()["throughput_rps"] > 0
    assert _conserved(batcher.stats)


def test_open_loop_latency_runs_to_resolution_not_to_observation():
    """The open loop drains its futures after the whole schedule
    (``loadgen._wait_all``); each latency must run from the request's due
    time to its resolution (``Future.t_done``), not to that later
    observation. The futures here were resolved at known instants 1-40 ms
    after their due times, all of them 10 s before the drain observes
    them: every recorded latency is exactly t_done - t_due, whatever the
    machine's load, and the p50 is 20 ms, where observation would read 10 s."""
    from parallel_cnn_tpu_torch.serve.batcher import DeadlineExceeded, Future

    class Recording(Histogram):
        def record(self, v):
            seen.append(v)
            super().record(v)

    seen = []
    now = time.monotonic()
    pairs, want = [], []
    for i in range(40):
        t_due = now - 10.0 - 0.05 * (40 - i)
        fut = Future()
        fut._resolve(np.zeros(1, np.float32))
        fut.t_done = t_due + 0.001 * (i + 1)
        pairs.append((t_due, fut))
        want.append(fut.t_done - t_due)
    expired = Future()
    expired._fail(DeadlineExceeded("late"))
    pairs.append((now - 10.0, expired))
    counters = {"completed": 0, "shed": 0, "expired": 0, "errors": 0}
    latency = Recording()
    loadgen._wait_all(pairs, counters, latency, threading.Lock())
    assert counters == {"completed": 40, "shed": 0, "expired": 1, "errors": 0}
    assert seen == want  # exactly t_done - t_due, in submission order
    assert latency.summary()["p50"] < 0.05
    assert latency.summary()["max"] == pytest.approx(0.040)


def test_make_samples_is_seeded():
    a = loadgen.make_samples(4, TINY_SHAPE, seed=5)
    assert a.shape == (4, *TINY_SHAPE) and a.dtype == np.float32
    np.testing.assert_array_equal(a, loadgen.make_samples(4, TINY_SHAPE, seed=5))


def test_histogram_percentiles_within_a_bin():
    from parallel_cnn_tpu_torch.utils.metrics import Histogram

    h = Histogram()
    assert h.summary() == {"count": 0} and h.percentile(50) is None
    h.record(0.0042)
    assert h.percentile(99) == pytest.approx(0.0042)  # clamped to [min, max]
    for v in np.linspace(0.001, 0.1, 1000):
        h.record(v)
    s = h.summary(scale=1e3)
    assert s["count"] == 1001 and s["max"] == pytest.approx(100.0)
    for p, want in ((50, 50.5), (90, 90.1), (99, 99.0)):
        assert abs(s[f"p{p}"] / want - 1) < 0.1  # bins span a factor of 1.18
    with pytest.raises(ValueError):
        h.percentile(101)


def test_serve_stats_window_decays_with_the_clock():
    from parallel_cnn_tpu_torch.serve import ServeStats

    now = [0.0]
    stats = ServeStats(window_s=1.0, clock=lambda: now[0])
    for _ in range(4):
        stats.on_submit()
    stats.on_shed()
    stats.on_batch(n=3, bucket=4, replica=0, queue_depth=0)
    assert stats.window_shed_rate() == pytest.approx(0.25)
    assert stats.window_occupancy() == pytest.approx(0.75)
    now[0] = 10.0  # ten time constants later: the window is empty
    assert stats.window_shed_rate() == 0.0 and stats.window_occupancy() is None
    assert stats.shed_rate() == pytest.approx(0.25)  # lifetime view stays


def test_serve_config_from_env(monkeypatch):
    monkeypatch.setenv("PCNN_SERVE_MAX_BATCH", "16")
    monkeypatch.setenv("PCNN_SERVE_QUEUE_DEPTH", "32")
    monkeypatch.setenv("PCNN_SERVE_PRECOMPILE", "0")
    cfg = ServeConfig.from_env()
    assert (cfg.max_batch, cfg.queue_depth, cfg.precompile) == (16, 32, False)
    with pytest.raises(ValueError):
        ServeConfig(max_batch=12)
    with pytest.raises(ValueError):
        ServeConfig(queue_depth=0)


def test_registry():
    for name in ("resnet34", "resnet50", "vgg16"):
        h = get(name)
        assert h.in_shape == (32, 32, 3) and h.n_outputs == 10
    with pytest.raises(KeyError):
        get("resnet101")
    with pytest.raises(ValueError):
        get("resnet18", conv_backend="pallas")


def test_serve_cli_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p
    )
    proc = subprocess.run(
        [sys.executable, "-m", "parallel_cnn_tpu_torch", "serve",
         "--device", "cpu", "--requests", "16", "--max-batch", "8"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "[serve] model=resnet18 params from fresh init" in out
    assert "[serve] padded-bucket parity (n=3→b4): bit-identical" in out
    assert "[serve] closed-loop: 16/16 ok" in out
    assert "requests: 16 submitted, 16 ok" in out


# -- the GPU-by-default rule --------------------------------------------


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_without_device_raises_without_gpu(no_gpu):
    with pytest.raises(NoGpuError, match="device='cpu'"):
        Engine(TINY)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_resolve_device_never_falls_back(no_gpu, device):
    with pytest.raises(NoGpuError):
        resolve_device(device)
    assert resolve_device("cpu") == torch.device("cpu")


def test_pool_and_stack_default_to_cuda(no_gpu):
    with pytest.raises(NoGpuError):
        ReplicaPool(TINY)
    with pytest.raises(NoGpuError):
        serve_stack(TINY, ServeConfig(precompile=False))


def test_cli_defaults_to_cuda(no_gpu):
    from parallel_cnn_tpu_torch import cli

    with pytest.raises(NoGpuError):
        cli.main(["serve", "--requests", "1", "--max-batch", "1"])


def test_batcher_runs_engine_predict():
    """The batcher's workers run the engine's predict, so every request
    goes through the conv path (here: the plain version on the CPU)."""
    pool, batcher = _stack()
    assert isinstance(batcher, DynamicBatcher)
    with batcher:
        fut = batcher.submit(loadgen.make_samples(1, TINY_SHAPE)[0])
        fut.result(timeout=30)
    assert pool.engines[0].stats.predicts == 1
