"""The port's profiling (utils/profiling.py, the trainers' ``--profile``)
against the JAX package's (parallel_cnn_tpu/utils/profiling.py), on the
CPU: the five phase functions' outputs on the same seeded LeNet-ref
params and batch, the table's text, and the CLI's ``--profile`` on
LeNet-ref (the table) and on a zoo model (the trace directory, its line
and a Chrome trace that parses), on one device and on a world of two
gloo ranks."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.ops import reference as jops
from parallel_cnn_tpu.utils import profiling as jprof
from parallel_cnn_tpu_torch import cli
from parallel_cnn_tpu_torch.utils import profiling

N = 32
PHASES = ("conv", "pool", "fc", "grad", "total_forward")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "c1": {"w": rng.normal(0, 0.5, (6, 5, 5)), "b": rng.normal(0, 0.5, (6,))},
        "s1": {"w": rng.normal(0, 0.5, (4, 4)), "b": rng.normal(0, 0.5, ())},
        "f": {"w": rng.normal(0, 0.5, (10, 216)), "b": rng.normal(0, 0.5, (10,))},
    }
    params = {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
              for k, d in params.items()}
    xs = rng.uniform(0.0, 1.0, (N, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, (N,)).astype(np.int32)
    return params, xs, ys


def _jax_phases(params, xs, ys):
    """JAX's profile_phases closures (utils/profiling.py:108-129), run once."""
    p = jax.tree_util.tree_map(jnp.asarray, params)
    x, y = jnp.asarray(xs), jnp.asarray(ys)
    sigmoid = jax.nn.sigmoid
    conv = sigmoid(jax.vmap(
        lambda s: jops.conv_c1_forward(s, p["c1"]["w"], p["c1"]["b"]))(x))
    pool = sigmoid(jax.vmap(
        lambda s: jops.pool_s1_forward(s, p["s1"]["w"], p["s1"]["b"]))(conv))
    fc = sigmoid(jax.vmap(lambda s: jops.fc_forward(s, p["f"]["w"], p["f"]["b"]))(pool))
    fwd = jax.vmap(lambda s: jops.forward(p, s).out_f)(x)
    _, grads = jax.vmap(jops.value_and_ref_grads, in_axes=(None, 0, 0))(p, x, y)
    grads = jax.tree_util.tree_map(lambda g: jnp.mean(g, axis=0), grads)
    return conv, pool, fc, fwd, grads


def test_phase_outputs_equal_jax():
    params, xs, ys = _inputs()
    tp = {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in params.items()}
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys).long()
    conv = profiling.conv_phase(tx, tp)
    pool = profiling.pool_phase(conv, tp)
    fc = profiling.fc_phase(pool, tp)
    fwd = profiling.forward_phase(tx, tp)
    grads = profiling.grad_phase(tx, tp, ty)
    jconv, jpool, jfc, jfwd, jgrads = _jax_phases(params, xs, ys)
    for got, want in ((conv, jconv), (pool, jpool), (fc, jfc), (fwd, jfwd)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for layer, leaves in jgrads.items():
        for name, want in leaves.items():
            got = grads[layer][name].numpy()
            assert got.shape == want.shape, (layer, name)
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_profile_phases_and_report_text():
    params, xs, ys = _inputs(1)
    tp = {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in params.items()}
    phases = profiling.profile_phases(tp, torch.from_numpy(xs),
                                      torch.from_numpy(ys).long(), repeats=2)
    assert tuple(phases) == PHASES
    assert all(v > 0 for v in phases.values())
    for table in (phases, {"conv": 1.5e-3, "pool": 0.0, "fc": 2e-6,
                           "grad": 0.25, "total_forward": 3.3e-3}):
        assert profiling.report(table, n_images=256) == jprof.report(table, n_images=256)


def _main(capfd, argv):
    """cli.main's output, the spawned ranks' included (fd-level capture)."""
    capfd.readouterr()
    assert cli.main(argv) == 0
    return capfd.readouterr().out


def test_cli_lenet_profile_prints_the_table(capfd):
    out = _main(capfd, ["--device", "cpu", "--loader", "synthetic", "--batch-size",
                        "64", "--epochs", "1", "--synthetic-train-count", "640",
                        "--synthetic-test-count", "64", "--profile"])
    lines = out.splitlines()
    head = lines.index(f"{'phase':<14}{'ms/batch':>12}{'images/sec':>14}")
    rows = [line.split() for line in lines[head + 1:head + 6]]
    assert [r[0] for r in rows] == list(PHASES)
    assert all(float(r[1]) > 0 for r in rows)


def _trace_events(trace_dir):
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("mesh", [[], ["--mesh-data", "2", "--comm-impl", "ring"]],
                         ids=["one-device", "two-ranks"])
def test_cli_zoo_profile_writes_a_trace(capfd, tmp_path, mesh):
    ck = tmp_path / "ck"
    out = _main(capfd, ["--device", "cpu", "--model", "cifar_cnn", "--batch-size",
                        "16", "--epochs", "1", "--synthetic-train-count", "64",
                        "--synthetic-test-count", "32", "--checkpoint-dir", str(ck),
                        "--profile", *mesh])
    want = f"xla trace (3 steps) written to {ck / 'zoo_xla_trace'}"
    assert out.count(want) == 1, out
    events = _trace_events(ck / "zoo_xla_trace")
    assert len(events) > 0
    assert not (tmp_path / "zoo_xla_trace").exists()


def test_profiled_state_includes_the_four_steps(tmp_path):
    """The returned state is the checkpointed epoch's plus the four
    profiled steps, as in JAX."""
    from parallel_cnn_tpu_torch.data import synthetic
    from parallel_cnn_tpu_torch.nn import cifar
    from parallel_cnn_tpu_torch.train import checkpoint, zoo

    imgs, labels = synthetic.make_image_dataset(32, seed=3)
    runs = {}
    for tag, trace in (("plain", None), ("profiled", str(tmp_path / "t"))):
        model = cifar.cifar_cnn(generator=torch.Generator().manual_seed(0))
        state, losses = zoo.train(model, imgs, labels, epochs=1, batch_size=16,
                                  lr=0.01, checkpoint_dir=str(tmp_path / tag),
                                  profile_trace_dir=trace, verbose=False,
                                  device="cpu")
        runs[tag] = (state.checkpoint_arrays(), losses)
    assert runs["plain"][1] == runs["profiled"][1]
    saved = checkpoint.restore(str(tmp_path / "profiled" / "ckpt_1.npz"),
                               runs["plain"][0])[0]
    moved = [k for k in runs["plain"][0]
             if not torch.equal(torch.as_tensor(saved[k]),
                                torch.as_tensor(runs["profiled"][0][k]))]
    assert moved, "the profiled steps did not advance the state"
    assert all(torch.equal(torch.as_tensor(saved[k]), torch.as_tensor(v))
               for k, v in runs["plain"][0].items())
    assert os.path.exists(tmp_path / "t" / profiling.TRACE_FILE)
