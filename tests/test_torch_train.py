"""Differential tests of the port's LeNet-ref trainer: its steps, its epoch
loop, its resilience and its CLI, held against the JAX package's on the
same numpy inputs from a seed (params carried across with
``convert.lenet_from_jax``). The port runs on the CPU here
(``device="cpu"``), where its kernel paths take their plain versions; the
JAX package's Pallas paths run in interpret mode.
"""

import inspect
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.config import Config as JConfig
from parallel_cnn_tpu.config import TrainConfig as JTrainConfig
from parallel_cnn_tpu.data import pipeline as jpipe
from parallel_cnn_tpu.data import synthetic as jsyn
from parallel_cnn_tpu.models import lenet_ref as jlenet
from parallel_cnn_tpu.train import step as jstep
from parallel_cnn_tpu.train import trainer as jtrainer
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch.config import (
    Config,
    DataConfig,
    MeshLayoutError,
    ResilienceConfig,
    TrainConfig,
)
from parallel_cnn_tpu_torch.data import native, pipeline
from parallel_cnn_tpu_torch.resilience import preempt
from parallel_cnn_tpu_torch.resilience.rollback import CheckpointRing
from parallel_cnn_tpu_torch.resilience.sentinel import (
    DivergenceError,
    RetriesExhaustedError,
)
from parallel_cnn_tpu_torch.train import checkpoint, step, trainer
from parallel_cnn_tpu_torch.utils.backend import NoGpuError
from parallel_cnn_tpu_torch.utils.tree import tree_leaves

# One step, or one scan of per-sample steps, f32 on both sides.
STEP_ATOL = 1e-5
# Whole-epoch errors over many steps.
LEARN_RTOL = 1e-4
LEARN_PARAM_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: keep PyTorch's
    CPU kernels to two threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_params(seed):
    return jax.tree_util.tree_map(np.asarray, jlenet.init(jax.random.key(seed)))


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def batch(seed, n):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (n, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, (n,)).astype(np.int32)
    return xs, ys


def assert_tree_close(got, want, atol, rtol=0.0):
    for layer in want:
        for k in want[layer]:
            g = np.asarray(got[layer][k])
            w = np.asarray(want[layer][k])
            assert g.shape == w.shape, f"{layer}/{k}"
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                       err_msg=f"{layer}/{k}")


def tree_bitequal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def dataset(n, seed=3):
    imgs, labels = jsyn.make_dataset(n, seed=seed)
    return pipeline.Dataset(imgs, labels), jpipe.Dataset(imgs, labels)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port_step,jax_step", [
    (step.batched_step, jstep.batched_step),
    (step.fused_batched_step, jstep.fused_batched_step),
    (step.cuda_batched_step, jstep.pallas_batched_step),
], ids=["batched", "fused", "cuda-vs-pallas"])
def test_minibatch_step_matches_jax(port_step, jax_step):
    jp = jax_params(1)
    xs, ys = batch(2, 16)
    want_p, want_e = jax_step(jx(jp), jnp.asarray(xs), jnp.asarray(ys), 0.1)
    got_p, got_e = port_step(convert.lenet_from_jax(jp), torch.from_numpy(xs),
                             torch.from_numpy(ys), 0.1)
    np.testing.assert_allclose(float(got_e), float(want_e), atol=STEP_ATOL)
    assert_tree_close(got_p, want_p, STEP_ATOL)


def test_fused_step_is_bit_identical_to_the_unfused_step():
    """As the JAX package pins (tests/test_fused_step.py): at n = 8 the
    bucketed p − (−dt)·(g·1/n) is exactly p + dt·(g/n)."""
    tp = convert.lenet_from_jax(jax_params(3))
    xs, ys = batch(4, 8)
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    p_ref, e_ref = step.batched_step(tp, x, y, 0.1)
    p_fused, e_fused = step.fused_batched_step(tp, x, y, 0.1)
    assert float(e_ref) == float(e_fused)
    assert tree_bitequal(p_ref, p_fused)


def test_steps_leave_their_inputs_as_they_are():
    tp = convert.lenet_from_jax(jax_params(3))
    before = [t.clone() for t in tree_leaves(tp)]
    xs, ys = batch(4, 8)
    for fn in (step.batched_step, step.fused_batched_step, step.cuda_batched_step):
        fn(tp, torch.from_numpy(xs), torch.from_numpy(ys), 0.1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), before))


@pytest.mark.parametrize("ops_path", ["reference", "cuda"])
def test_local_grad_sums_match_jax(ops_path):
    jp = jax_params(5)
    xs, ys = batch(6, 12)
    want_e, want_g = jstep.local_grad_sums(jx(jp), jnp.asarray(xs), jnp.asarray(ys))
    got_e, got_g = step.local_grad_sums(convert.lenet_from_jax(jp),
                                        torch.from_numpy(xs),
                                        torch.from_numpy(ys), ops_path=ops_path)
    np.testing.assert_allclose(float(got_e), float(want_e), rtol=1e-5)
    assert_tree_close(got_g, want_g, atol=1e-4, rtol=1e-5)


def test_scan_epoch_matches_jax():
    jp = jax_params(7)
    xs, ys = batch(8, 64)
    want_p, want_e = jstep.scan_epoch(jx(jp), jnp.asarray(xs), jnp.asarray(ys), 0.1)
    got_p, got_e = step.scan_epoch(convert.lenet_from_jax(jp), torch.from_numpy(xs),
                                   torch.from_numpy(ys), 0.1)
    np.testing.assert_allclose(float(got_e), float(want_e), atol=STEP_ATOL)
    assert_tree_close(got_p, want_p, STEP_ATOL)


def test_classify_and_error_count_match_jax():
    jp = jax_params(9)
    xs, ys = batch(10, 40)
    tp = convert.lenet_from_jax(jp)
    np.testing.assert_array_equal(
        step.classify_batch(tp, torch.from_numpy(xs)).numpy(),
        np.asarray(jstep.classify_batch(jx(jp), jnp.asarray(xs))))
    assert int(step.error_count(tp, torch.from_numpy(xs), torch.from_numpy(ys))) == int(
        jstep.error_count(jx(jp), jnp.asarray(xs), jnp.asarray(ys)))


@pytest.mark.parametrize("ops_path,fused,want", [
    ("reference", False, "batched_step"),
    ("reference", True, "fused_batched_step"),
    ("cuda", False, "cuda_batched_step"),
    ("cuda", True, "cuda_batched_step"),
])
def test_batched_step_fn_picks_the_step_without_a_fallback(ops_path, fused, want):
    """As batched_step_fn in JAX (the kernel path keeps its own update),
    but with no ``fallback`` argument: the kernel path launches its kernel
    or raises, and the config has no switch that degrades it."""
    assert step.batched_step_fn(ops_path, fused=fused).__name__ == want
    assert "fallback" not in inspect.signature(step.batched_step_fn).parameters
    assert not hasattr(ResilienceConfig(), "pallas_fallback")


# ---------------------------------------------------------------------------
# The epoch loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ops_path,jax_ops", [("reference", "reference"),
                                              ("cuda", "pallas")])
def test_learn_matches_jax(ops_path, jax_ops):
    """Two shuffled epochs of 512 samples at batch 32: the native ring's
    order (prefetch auto), per-epoch seeds, one update per batch."""
    tds, jds = dataset(512)
    jp = jax_params(0)
    want = jtrainer.learn(
        JConfig(train=JTrainConfig(epochs=2, batch_size=32, ops=jax_ops, shuffle=True)),
        jds, params=jx(jp), verbose=False)
    got = trainer.learn(
        Config(train=TrainConfig(epochs=2, batch_size=32, ops=ops_path, shuffle=True)),
        tds, params=convert.lenet_from_jax(jp), verbose=False, device="cpu")
    np.testing.assert_allclose(got.epoch_errors, want.epoch_errors, rtol=LEARN_RTOL)
    assert_tree_close(got.params, want.params, LEARN_PARAM_ATOL)
    assert got.steps == 2 * 16


def test_learn_keep_tail_order_matches_jax():
    """prefetch off: NumPy PCG order, the tail batch at its own size, the
    epoch error weighted by batch size."""
    tds, jds = dataset(500)
    jp = jax_params(2)
    kw = dict(epochs=1, batch_size=32, prefetch="off", shuffle=True)
    want = jtrainer.learn(JConfig(train=JTrainConfig(**kw)), jds, params=jx(jp),
                          verbose=False)
    got = trainer.learn(Config(train=TrainConfig(**kw)), tds,
                        params=convert.lenet_from_jax(jp), verbose=False,
                        device="cpu")
    np.testing.assert_allclose(got.epoch_errors, want.epoch_errors, rtol=LEARN_RTOL)
    assert_tree_close(got.params, want.params, LEARN_PARAM_ATOL)
    assert got.steps == 16


def test_learn_per_sample_matches_jax():
    tds, jds = dataset(64, seed=5)
    jp = jax_params(4)
    kw = dict(epochs=2, batch_size=1, shuffle=True)
    want = jtrainer.learn(JConfig(train=JTrainConfig(**kw)), jds, params=jx(jp),
                          verbose=False)
    got = trainer.learn(Config(train=TrainConfig(**kw)), tds,
                        params=convert.lenet_from_jax(jp), verbose=False,
                        device="cpu")
    np.testing.assert_allclose(got.epoch_errors, want.epoch_errors, rtol=LEARN_RTOL)
    assert_tree_close(got.params, want.params, LEARN_PARAM_ATOL)
    assert got.steps == 128


def test_learn_prints_the_reference_lines_and_stops_at_the_threshold(capsys):
    tds, _ = dataset(64)
    cfg = Config(train=TrainConfig(epochs=5, batch_size=16, threshold=10.0))
    seen = []
    res = trainer.learn(cfg, tds, device="cpu", epoch_offset=3,
                        epoch_callback=lambda e, p, err: seen.append((e, err)))
    out = capsys.readouterr().out
    assert res.stopped_early and len(res.epoch_errors) == 1
    assert seen == [(4, res.epoch_errors[0])]  # global, 1-based epoch
    assert out.startswith("Learning\n")
    assert f"error: {res.epoch_errors[0]:e}, time_on_cpu: " in out
    assert "Training complete, error less than threshold" in out
    assert "\n Time - " in out


def test_learn_refuses_native_prefetch_naming_its_roadmap_item(monkeypatch):
    """The native ring is bound (ROADMAP A2); where its library cannot be
    built (no compiler), prefetch="native" raises instead of taking the
    NumPy twin."""
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    tds, _ = dataset(64)
    cfg = Config(train=TrainConfig(batch_size=16, prefetch="native"))
    with pytest.raises(native.NativeBuildError, match="not found"):
        trainer.learn(cfg, tds, verbose=False, device="cpu")


def test_learn_and_run_default_to_the_gpu():
    tds, _ = dataset(32)
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without a GPU")
    with pytest.raises(NoGpuError):
        trainer.learn(Config(), tds, verbose=False)
    with pytest.raises(NoGpuError):
        trainer.run(Config())


def test_run_and_test_match_jax(capsys):
    tds, jds = dataset(48, seed=12)
    jp = jax_params(6)
    rate = trainer.test(convert.lenet_from_jax(jp), tds, batch_size=20)
    assert rate == jtrainer.test(jx(jp), jds, batch_size=20, verbose=False)
    assert f"Error Rate: {rate:.2f}%" in capsys.readouterr().out
    cfg = Config(data=DataConfig(loader="synthetic", synthetic_train_count=64,
                                 synthetic_test_count=32),
                 train=TrainConfig(batch_size=16))
    assert 0.0 <= trainer.run(cfg, verbose=False, device="cpu") <= 100.0


def _poisoned(n=64):
    tds, _ = dataset(n)
    images = tds.images.copy()
    images[0, 0, 0] = np.nan
    return pipeline.Dataset(images, tds.labels)


def test_sentinel_raise_policy_stops_a_diverged_run():
    cfg = Config(train=TrainConfig(batch_size=16))
    with pytest.raises(DivergenceError, match="epoch 1: non-finite loss"):
        trainer.learn(cfg, _poisoned(), verbose=False, device="cpu")


def test_sentinel_skip_policy_keeps_the_last_good_params():
    cfg = Config(train=TrainConfig(batch_size=16, epochs=2),
                 resilience=ResilienceConfig(policy="skip"))
    params = convert.lenet_from_jax(jax_params(1))
    res = trainer.learn(cfg, _poisoned(), params=params, verbose=False, device="cpu")
    assert res.epoch_errors == []
    assert tree_bitequal(res.params, params)


def test_sentinel_rollback_policy_is_bounded():
    cfg = Config(train=TrainConfig(batch_size=16),
                 resilience=ResilienceConfig(policy="rollback", max_rollbacks=2))
    with pytest.raises(RetriesExhaustedError, match="after 2 rollbacks"):
        trainer.learn(cfg, _poisoned(), verbose=False, device="cpu")


def test_preemption_stops_at_the_epoch_boundary():
    tds, _ = dataset(64)
    cfg = Config(train=TrainConfig(batch_size=16, epochs=3))
    preempt.reset()
    try:
        with preempt.PreemptionGuard() as guard:
            res = trainer.learn(
                cfg, tds, verbose=False, device="cpu",
                epoch_callback=lambda *a: os.kill(os.getpid(), signal.SIGTERM))
        assert guard.installed and guard.preempted
        assert res.preempted and len(res.epoch_errors) == 1
    finally:
        preempt.reset()


def test_checkpoint_ring_prunes_and_skips_a_torn_newest(tmp_path):
    ring = CheckpointRing(str(tmp_path), keep=2)
    params = convert.lenet_from_jax(jax_params(8))
    for epoch in (1, 2, 3):
        ring.save(epoch, params, checkpoint.TrainState(epoch=epoch))
    assert ring.tags() == [3, 2]
    path3 = tmp_path / "ckpt_3.npz"
    path3.write_bytes(path3.read_bytes()[:100])
    got, state, path = ring.restore_latest(params)
    assert state.epoch == 2 and path.endswith("ckpt_2.npz")
    assert tree_bitequal(got, params)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

CPU_RUN = ["--device", "cpu", "--loader", "synthetic",
           "--synthetic-train-count", "256", "--synthetic-test-count", "64"]


def _ckpt_leaves(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def test_cli_trains_on_the_kernel_path_and_prints_the_reference_lines(capsys, tmp_path):
    metrics = tmp_path / "m.jsonl"
    assert cli.main(CPU_RUN + ["--batch-size", "32", "--ops", "cuda", "--epochs", "2",
                               "--metrics", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Learning\n")
    assert out.count("error: ") == 2 and "time_on_cpu: " in out
    assert "\n Time - " in out and "Error Rate: " in out
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["event"] for r in records] == ["epoch", "epoch", "final"]
    assert records[-1]["steps"] == 2 * 8


def test_cli_fused_step_prints_the_unfused_run_bit_for_bit(capsys):
    """The JAX package's round-7 contract at the CLI: --fused-step gives
    the same error lines, to every printed digit."""
    base = CPU_RUN + ["--batch-size", "32", "--epochs", "2"]

    def error_lines():
        return [ln.split(", time_on_cpu")[0] for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("error: ") or ln.startswith("Error Rate")]

    assert cli.main(base) == 0
    plain = error_lines()
    assert cli.main(base + ["--fused-step"]) == 0
    assert error_lines() == plain and len(plain) == 3


def test_cli_resume_continues_bit_exactly(capsys, tmp_path):
    base = CPU_RUN + ["--batch-size", "32", "--ops", "cuda", "--shuffle"]
    straight, split = tmp_path / "a", tmp_path / "b"
    assert cli.main(base + ["--epochs", "2", "--checkpoint-dir", str(straight)]) == 0
    assert cli.main(base + ["--epochs", "1", "--checkpoint-dir", str(split)]) == 0
    capsys.readouterr()
    assert cli.main(base + ["--epochs", "2", "--checkpoint-dir", str(split),
                            "--resume"]) == 0
    assert f"resumed from {split / 'ckpt_1.npz'} (epoch 1)" in capsys.readouterr().out
    a, b = _ckpt_leaves(straight / "ckpt_2.npz"), _ckpt_leaves(split / "ckpt_2.npz")
    assert sorted(a) == sorted(b) == ["c1/b", "c1/w", "f/b", "f/w", "s1/b", "s1/w"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _, state = checkpoint.restore(str(split / "ckpt_2.npz"),
                                  convert.lenet_from_jax(jax_params(0)))
    assert state.epoch == 2 and len(state.epoch_errors) == 2


def test_cli_keep_checkpoints_prunes_the_ring(tmp_path):
    ck = tmp_path / "ck"
    assert cli.main(CPU_RUN + ["--batch-size", "64", "--epochs", "3",
                               "--checkpoint-dir", str(ck),
                               "--keep-checkpoints", "1"]) == 0
    assert sorted(os.listdir(ck)) == ["ckpt_3.npz"]


def test_cli_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without a GPU")
    with pytest.raises(NoGpuError):
        cli.main(["--loader", "synthetic", "--synthetic-train-count", "64",
                  "--batch-size", "16"])


@pytest.mark.parametrize("argv,err", [
    (["--batch-size", "1", "--ops", "cuda"], ValueError),
    # No compiler (below): the native ring cannot be built.
    (["--batch-size", "16", "--prefetch", "native"], native.NativeBuildError),
    (["--ops", "pallas"], SystemExit),
    # A mesh trains minibatch SGD; the default batch size 1 is refused.
    (["--mesh-data", "2"], MeshLayoutError),
    # The CIFAR CNN's convs are library convs, as in JAX.
    (["--model", "cifar_cnn", "--conv-backend", "cuda"], SystemExit),
], ids=["per-sample-cuda", "native-prefetch", "pallas-name", "mesh-flag", "zoo-model"])
def test_cli_refuses_what_the_port_does_not_run(argv, err, capsys, monkeypatch):
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    with pytest.raises(err):
        cli.main(CPU_RUN + argv)


# ---------------------------------------------------------------------------
# Timing and metrics
# ---------------------------------------------------------------------------


def test_stopwatch_accumulates_spans_as_jax_does():
    from parallel_cnn_tpu.utils.timing import Stopwatch as JStopwatch
    from parallel_cnn_tpu_torch.utils.timing import Stopwatch

    for sw in (Stopwatch(), JStopwatch()):
        assert (sw.total, sw.spans) == (0.0, 0)
        with sw:
            pass
        first = sw.total
        with sw:
            pass
        assert sw.spans == 2 and sw.total >= first >= 0.0


def test_metrics_logger_writes_the_jax_records(tmp_path):
    from parallel_cnn_tpu.utils.metrics import MetricsLogger as JLogger
    from parallel_cnn_tpu_torch.utils.metrics import MetricsLogger

    values = dict(event="epoch", epoch=np.int64(2), error=torch.tensor(0.25),
                  rate=np.float32(0.5), note=None)
    jvalues = dict(values, error=jnp.asarray(0.25))
    records = []
    for cls, vals, name in ((MetricsLogger, values, "port"), (JLogger, jvalues, "jax")):
        path = tmp_path / f"{name}.jsonl"
        with cls(path=str(path)) as log:
            rec = log.record(**vals)
            assert log.records == [rec]
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert lines == [rec]
        records.append({k: v for k, v in rec.items() if k != "ts"})
    assert records[0] == records[1]


@pytest.mark.parametrize("n,seconds", [(60_000, 0.5), (10, 0.0)])
def test_throughput_matches_jax(n, seconds):
    from parallel_cnn_tpu.utils.metrics import throughput as jthroughput
    from parallel_cnn_tpu_torch.utils.metrics import throughput

    assert throughput(n, seconds) == jthroughput(n, seconds)
