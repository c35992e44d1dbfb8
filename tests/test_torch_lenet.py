"""Differential tests of the LeNet-ref slice's data, model and reference
ops: the port (parallel_cnn_tpu_torch) against the JAX package on the
same numpy inputs from a seed, params carried across with
``convert.lenet_from_jax``, and against the float64 loop oracle
(tests/oracle.py). The port runs on the CPU here (``device="cpu"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from parallel_cnn_tpu.data import mnist as jmnist
from parallel_cnn_tpu.data import pipeline as jpipe
from parallel_cnn_tpu.data import synthetic as jsyn
from parallel_cnn_tpu.models import lenet_ref as jlenet
from parallel_cnn_tpu.ops import reference as jref
from parallel_cnn_tpu.train import checkpoint as jckpt
from parallel_cnn_tpu_torch import convert
from parallel_cnn_tpu_torch.config import DataConfig, TrainConfig
from parallel_cnn_tpu_torch.data import mnist, pipeline, synthetic
from parallel_cnn_tpu_torch.models import lenet_ref
from parallel_cnn_tpu_torch.ops import activations, reference
from parallel_cnn_tpu_torch.train import checkpoint

# Reference ops against the JAX reference (both f32 on the CPU).
ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: keep PyTorch's
    CPU kernels to two threads each, as the JAX tests beside them expect."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_params(seed):
    return jax.tree_util.tree_map(np.asarray, jlenet.init(jax.random.key(seed)))


def batch(seed, n):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (n, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, (n,)).astype(np.int32)
    return xs, ys


def assert_tree_close(got, want, atol=ATOL, rtol=RTOL):
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(
                np.asarray(got[layer][k]), np.asarray(want[layer][k]),
                atol=atol, rtol=rtol, err_msg=f"{layer}/{k}",
            )


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1234, 1235])
def test_synthetic_dataset_bit_equal(seed):
    gi, gl = synthetic.make_dataset(300, seed=seed)
    wi, wl = jsyn.make_dataset(300, seed=seed)
    assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("n,seed", [(1, 0), (97, 0), (97, 5), (256, 2**63 + 11)])
def test_xorshift_permutation_bit_equal(n, seed):
    np.testing.assert_array_equal(pipeline.xorshift_permutation(n, seed),
                                  jpipe.xorshift_permutation(n, seed))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop", [False, True])
def test_epoch_batches_same_order(shuffle, drop):
    imgs, labels = jsyn.make_dataset(70, seed=3)
    got = list(pipeline.epoch_batches(pipeline.Dataset(imgs, labels), 16,
                                      shuffle=shuffle, seed=4, drop_remainder=drop))
    want = list(jpipe.epoch_batches(jpipe.Dataset(imgs, labels), 16,
                                    shuffle=shuffle, seed=4, drop_remainder=drop))
    assert len(got) == len(want) == (4 if drop else 5)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_semantics_batches_same_order(shuffle):
    imgs, labels = jsyn.make_dataset(70, seed=3)
    got = list(pipeline.native_semantics_batches(
        pipeline.Dataset(imgs, labels), 16, shuffle=shuffle, seed=9))
    want = list(jpipe.native_semantics_batches(
        jpipe.Dataset(imgs, labels), 16, shuffle=shuffle, seed=9))
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx, wx)


def test_pad_to_batch_matches_jax():
    imgs, labels = jsyn.make_dataset(5, seed=1)
    got = pipeline.pad_to_batch(imgs, labels, 8)
    want = jpipe.pad_to_batch(imgs, labels, 8)
    assert got[2] == want[2] == 5
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_jax_written_idx_files_read_back_equal(tmp_path):
    imgs, labels = jsyn.make_dataset(20, seed=8)
    ip, lp = str(tmp_path / "i.idx3-ubyte"), str(tmp_path / "l.idx1-ubyte")
    jmnist.write_idx_images(ip, imgs)
    jmnist.write_idx_labels(lp, labels)
    gi, gl = mnist.load_pair(ip, lp)
    wi, wl = jmnist.load_pair(ip, lp)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    # ... and the port writes what JAX reads.
    mnist.write_idx_images(ip, gi)
    np.testing.assert_array_equal(jmnist.load_idx_images(ip), gi)
    rep = mnist.integrity_report(ip, lp)
    assert rep["count"] == 20 and rep == jmnist.integrity_report(ip, lp)


def test_mnist_errors_are_typed(tmp_path):
    with pytest.raises(mnist.MnistError) as e:
        mnist.load_idx_images(str(tmp_path / "missing"))
    assert e.value.code == -1
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x00\x00\x08\x01" + b"\x00" * 12)
    with pytest.raises(mnist.MnistError) as e:
        mnist.load_idx_images(str(bad))
    assert e.value.code == -2


def test_missing_files_fall_back_to_the_same_synthetic_set(tmp_path):
    kw = dict(train_images=str(tmp_path / "a"), train_labels=str(tmp_path / "b"),
              test_images=str(tmp_path / "c"), test_labels=str(tmp_path / "d"),
              synthetic_train_count=40, synthetic_test_count=10)
    from parallel_cnn_tpu.config import DataConfig as JaxDataConfig

    got = pipeline.load_train_test(DataConfig(**kw))
    want = jpipe.load_train_test(JaxDataConfig(loader="numpy", **kw))
    for g, w in zip(got, want):
        assert g.source == w.source == "synthetic"
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
    with pytest.raises(mnist.MnistError):
        pipeline.load_train_test(DataConfig(synthetic_fallback=False, **kw))


def test_native_loader_is_a_typed_error_naming_its_roadmap_item(tmp_path, monkeypatch):
    """The native parser is bound (data/native.py, ROADMAP A2); where its
    library cannot be built (no compiler), loader="native" is the typed
    MnistError(-5), never another parser."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    cfg = DataConfig(loader="native", synthetic_fallback=False,
                     train_images=str(tmp_path / "a"))
    with pytest.raises(mnist.MnistError, match="native loader unavailable") as e:
        pipeline.load_split(cfg, cfg.train_images, cfg.train_labels, 10, 1)
    assert e.value.code == -5


# ---------------------------------------------------------------------------
# Model and config
# ---------------------------------------------------------------------------


def test_init_follows_the_jax_tree():
    p = lenet_ref.init(torch.Generator().manual_seed(0))
    j = jax_params(0)
    assert lenet_ref.num_params(p) == jlenet.num_params(j) == 2343
    for layer in j:
        for k in j[layer]:
            t = p[layer][k]
            assert tuple(t.shape) == j[layer][k].shape and t.dtype == torch.float32
            assert float(t.min()) >= -0.5 and float(t.max()) < 0.5
    again = lenet_ref.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[a][b], again[a][b]) for a in p for b in p[a])


def test_lenet_from_jax_checks_keys_and_shapes():
    j = jax_params(1)
    p = convert.lenet_from_jax(j)
    np.testing.assert_array_equal(p["f"]["w"].numpy(), j["f"]["w"])
    assert p["s1"]["b"].shape == ()
    with pytest.raises(ValueError, match="shape"):
        convert.lenet_from_jax({**j, "f": {"w": j["f"]["w"][:, :10], "b": j["f"]["b"]}})
    with pytest.raises(ValueError, match="layers"):
        convert.lenet_from_jax({"c1": j["c1"], "f": j["f"]})


@pytest.mark.parametrize(
    "kw",
    [dict(ops="cuda", batch_size=1), dict(ops="pallas", batch_size=8)],
    ids=["cuda-per-sample", "unknown-ops"],
)
def test_train_config_rules(kw):
    with pytest.raises(ValueError):
        TrainConfig(**kw)


# ---------------------------------------------------------------------------
# Reference ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True], ids=["sample", "batch"])
def test_forward_matches_jax(batched):
    jp = jax_params(3)
    tp = convert.lenet_from_jax(jp)
    xs, _ = batch(0, 5)
    if batched:
        want = jax.vmap(lambda x: jref.forward(jp, x))(xs)
        got = reference.forward(tp, torch.from_numpy(xs))
    else:
        want = jref.forward(jp, xs[2])
        got = reference.forward(tp, torch.from_numpy(xs[2]))
    for name, g, w in zip(reference.Activations._fields, got, want):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("batched", [False, True], ids=["sample", "batch"])
def test_value_and_ref_grads_match_jax(batched):
    jp = jax_params(4)
    tp = convert.lenet_from_jax(jp)
    xs, ys = batch(1, 6)
    if batched:
        want_e, want_g = jax.vmap(jref.value_and_ref_grads, in_axes=(None, 0, 0))(
            jp, xs, ys)
        got_e, got_g = reference.batched_value_and_ref_grads(
            tp, torch.from_numpy(xs), torch.from_numpy(ys))
    else:
        want_e, want_g = jref.value_and_ref_grads(jp, xs[0], ys[0])
        got_e, got_g = reference.value_and_ref_grads(
            tp, torch.from_numpy(xs[0]), torch.tensor(ys[0]))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=ATOL, rtol=RTOL)
    for layer in want_g:
        for k in want_g[layer]:
            assert tuple(got_g[layer][k].shape) == np.shape(want_g[layer][k])
    assert_tree_close(got_g, want_g)


def test_predict_matches_jax():
    jp = jax_params(5)
    tp = convert.lenet_from_jax(jp)
    xs, _ = batch(2, 16)
    want = jax.vmap(lambda x: jref.predict(jp, x))(xs)
    np.testing.assert_array_equal(
        reference.predict(tp, torch.from_numpy(xs)).numpy(), np.asarray(want))


def test_value_and_ref_grads_match_float64_oracle():
    """The bounds of tests/test_ops_reference.py's oracle tests."""
    rng = np.random.default_rng(11)
    params = oracle.random_params(rng)
    x = rng.uniform(0.0, 1.0, (28, 28))
    acts = oracle.forward(params, x)
    want_err, want_g = oracle.backward(params, acts, 3)
    tp = convert.lenet_from_jax(params)
    got_acts = reference.forward(tp, torch.from_numpy(x.astype(np.float32)))
    for name, atol in (("pre_c1", 1e-4), ("out_c1", 1e-5), ("pre_s1", 1e-4),
                       ("out_s1", 1e-5), ("pre_f", 1e-4), ("out_f", 1e-5)):
        np.testing.assert_allclose(getattr(got_acts, name).numpy(), acts[name],
                                   rtol=0, atol=atol, err_msg=name)
    err, g = reference.value_and_ref_grads(
        tp, torch.from_numpy(x.astype(np.float32)), torch.tensor(3))
    assert abs(float(err) - want_err) < 1e-5
    assert_tree_close(g, want_g, atol=2e-4, rtol=0)


def test_out_of_range_label_has_a_zero_one_hot_as_in_jax():
    out = torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]])
    got = activations.make_error(out, torch.tensor([10]))
    want = jax.nn.one_hot(jnp.asarray([10]), 10) - out.numpy()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Checkpoints: one format, read and written by both packages
# ---------------------------------------------------------------------------


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jp = jlenet.init(jax.random.key(6))
    path = str(tmp_path / "ckpt_3.npz")
    jckpt.save(path, jp, jckpt.TrainState(epoch=3, epoch_errors=[0.5, 0.4, 0.3]))
    like = lenet_ref.init(torch.Generator().manual_seed(0))
    got, state = checkpoint.restore(path, like)
    assert state.epoch == 3 and state.epoch_errors == [0.5, 0.4, 0.3]
    assert_tree_close(got, jax.tree_util.tree_map(np.asarray, jp), atol=0, rtol=0)
    assert got["s1"]["b"].shape == ()
    assert checkpoint.latest(str(tmp_path)) == path


def test_port_checkpoint_restores_in_jax(tmp_path):
    tp = lenet_ref.init(torch.Generator().manual_seed(7))
    path = str(tmp_path / "ckpt_1.npz")
    checkpoint.save(path, tp, checkpoint.TrainState(epoch=1, epoch_errors=[0.25],
                                                    extra={"k": 1}))
    got, state = jckpt.restore(path, jlenet.init(jax.random.key(0)))
    assert state.epoch == 1 and state.epoch_errors == [0.25] and state.extra == {"k": 1}
    assert_tree_close(got, {a: {b: t.numpy() for b, t in v.items()}
                            for a, v in tp.items()}, atol=0, rtol=0)


def test_torn_corrupt_versioned_and_sharded_checkpoints_raise(tmp_path):
    tp = lenet_ref.init(torch.Generator().manual_seed(7))
    path = tmp_path / "ckpt_1.npz"
    checkpoint.save(str(path), tp)
    data = path.read_bytes()
    torn = tmp_path / "torn.npz"
    torn.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="corrupted or unreadable"):
        checkpoint.restore(str(torn), tp)
    meta = np.frombuffer(b'{"version": 2}', np.uint8)
    np.savez(tmp_path / "v2.npz", __meta__=meta)
    with pytest.raises(ValueError, match="version"):
        checkpoint.restore(str(tmp_path / "v2.npz"), tp)
    meta = np.frombuffer(b'{"version": 1, "zero3": {"world_size": 4}}', np.uint8)
    np.savez(tmp_path / "z3.npz", __meta__=meta)
    with pytest.raises(ValueError, match="ZeRO-3"):
        checkpoint.restore(str(tmp_path / "z3.npz"), tp)
    other = dict(tp, f={"w": tp["f"]["w"][:, :5].contiguous(), "b": tp["f"]["b"]})
    with pytest.raises(ValueError, match="f/w"):
        checkpoint.restore(str(path), other)
    (tmp_path / "ckpt_9.tmp.npz").write_bytes(b"")
    assert checkpoint.latest(str(tmp_path)) == str(path)
