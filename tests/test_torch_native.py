"""The port's binding of the native C++ data runtime
(``parallel_cnn_tpu_torch/data/native.py``) against the JAX package's
(``parallel_cnn_tpu/data/native.py``) and the NumPy parsers and twins of
both, on idx files written from a seed: the parsed arrays, the error
codes, the prefetch ring's batches and their order, the LeNet-ref
trainer's ``prefetch`` modes and the zoo's native loader. Everything here
is exact: the same bytes, the same batches, bit-identical params.

The port builds its library into its own ``_build/`` directory; the JAX
package builds ``native/libpcnn_native.so`` with ``make -C native`` when
it is imported. A build that cannot run (here: ``$CXX`` names no
compiler) makes ``prefetch="native"`` and ``loader="native"`` raise, and
``loader="auto"`` take the NumPy parser; ``prefetch="auto"`` gathers the
twin's order on the device either way."""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_cnn_tpu.data import mnist as jax_mnist
from parallel_cnn_tpu.data import native as jax_native
from parallel_cnn_tpu.data import pipeline as jax_pipeline
from parallel_cnn_tpu.data import synthetic as jax_synthetic
from parallel_cnn_tpu.train import zoo as jax_zoo
from parallel_cnn_tpu_torch.config import Config, DataConfig, TrainConfig
from parallel_cnn_tpu_torch.data import mnist, native, pipeline, synthetic
from parallel_cnn_tpu_torch.train import trainer, zoo

REPO = Path(__file__).resolve().parent.parent
# JAX's `make -C native` output, which the JAX package's own import and
# tests may write at any time under the test workers; the port never does.
JAX_LIB = "libpcnn_native.so"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def no_compiler(monkeypatch):
    """The native library cannot be built: $CXX names no compiler."""
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    assert not native.available()


@pytest.fixture(scope="module")
def idx_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("idx")
    imgs, labels = synthetic.make_dataset(64, seed=3)
    ip, lp = str(d / "imgs.idx3-ubyte"), str(d / "labels.idx1-ubyte")
    mnist.write_idx_images(ip, imgs)
    mnist.write_idx_labels(lp, labels)
    return ip, lp


def _native_listing():
    return {p.name: p.stat().st_mtime_ns for p in (REPO / "native").iterdir()
            if p.name != JAX_LIB}


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def test_build_goes_to_the_ports_build_dir_and_writes_nothing_under_native(
        monkeypatch, tmp_path):
    """A fresh build (into an empty build directory) from the sources under
    native/, with the Makefile's flags, leaves native/ as it was."""
    before = _native_listing()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    path = native.library_path()
    assert path.parent == tmp_path and not path.exists()
    lib = native.load_lib()
    assert path.exists() and native.load_lib() is lib
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [path.name, "libpcnn_native.lock"])
    assert _native_listing() == before
    assert "-O3" in native.CXXFLAGS and "-pthread" in native.LDFLAGS
    assert native.library_path().parent == tmp_path
    assert native.BUILD_DIR != REPO / "native"


def test_concurrent_builders_each_load_a_whole_library(tmp_path):
    """Four processes build into one empty directory at once: one compiles
    under the lock, the rest wait and load its library."""
    code = ("import sys; from pathlib import Path\n"
            "from parallel_cnn_tpu_torch.data import native\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "lib = native.load_lib()\n"
            "print(lib.pcnn_mnist_image_count(b'/nonexistent'))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert [o.strip() for o, _ in outs] == ["-1"] * 4
    assert len(list(tmp_path.glob("libpcnn_native-*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp*"))


def test_a_build_that_cannot_run_raises(no_compiler):
    with pytest.raises(native.NativeBuildError, match="not found"):
        native.load_lib()
    with pytest.raises(native.NativeBuildError):
        native.Batcher(np.zeros((4, 2), np.float32), np.zeros(4, np.int32), 2)


# ---------------------------------------------------------------------------
# The idx parser
# ---------------------------------------------------------------------------


def test_load_pair_is_jaxs_and_both_numpy_parsers(idx_files):
    ip, lp = idx_files
    got = native.load_pair(ip, lp)
    for want in (jax_native.load_pair(ip, lp), mnist.load_pair(ip, lp),
                 jax_mnist.load_pair(ip, lp)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32


def _bad_files(tmp_path, idx_files):
    ip, _ = idx_files
    bad = tmp_path / "bad.idx"
    bad.write_bytes(b"\x00\x00\x00\x00garbage")
    short = tmp_path / "short.idx1-ubyte"
    mnist.write_idx_labels(str(short), np.zeros(3, dtype=np.int32))
    return {
        -1: ("load_idx_images", (str(tmp_path / "missing"),)),
        -2: ("load_idx_images", (str(bad),)),
        -3: ("load_idx_labels", (str(bad),)),
        -4: ("load_pair", (ip, str(short))),
    }


@pytest.mark.parametrize("code", [-1, -2, -3, -4])
def test_error_codes_are_jaxs(tmp_path, idx_files, code):
    fn, args = _bad_files(tmp_path, idx_files)[code]
    with pytest.raises(mnist.MnistError) as got:
        getattr(native, fn)(*args)
    with pytest.raises(jax_mnist.MnistError) as want:
        getattr(jax_native, fn)(*args)
    assert got.value.code == want.value.code == code
    assert str(got.value) == str(want.value)


def test_pipeline_loaders(idx_files, monkeypatch):
    """"native" and "auto" parse through the binding, "numpy" through NumPy:
    the same arrays, the source "mnist"."""
    ip, lp = idx_files
    want = jax_mnist.load_pair(ip, lp)
    calls, parse = [], native.load_pair
    monkeypatch.setattr(native, "load_pair", lambda *a: calls.append(a) or parse(*a))
    for loader, via_native in (("native", True), ("auto", True), ("numpy", False)):
        calls.clear()
        cfg = DataConfig(loader=loader, synthetic_fallback=False)
        ds = pipeline.load_split(cfg, ip, lp, 10, 1)
        assert ds.source == "mnist" and bool(calls) == via_native, loader
        np.testing.assert_array_equal(ds.images, want[0])
        np.testing.assert_array_equal(ds.labels, want[1])


def test_loaders_without_the_library(idx_files, no_compiler):
    """"native" raises MnistError(-5), with the synthetic fallback on too;
    "auto" parses with NumPy."""
    ip, lp = idx_files
    for fallback in (False, True):
        cfg = DataConfig(loader="native", synthetic_fallback=fallback)
        with pytest.raises(mnist.MnistError, match="native loader unavailable") as e:
            pipeline.load_split(cfg, ip, lp, 10, 1)
        assert e.value.code == -5
    ds = pipeline.load_split(DataConfig(loader="auto", synthetic_fallback=False),
                             ip, lp, 10, 1)
    np.testing.assert_array_equal(ds.images, mnist.load_pair(ip, lp)[0])


# ---------------------------------------------------------------------------
# The prefetch ring
# ---------------------------------------------------------------------------


def _ring(mod, images, labels, bs, steps, **kw):
    with mod.Batcher(images, labels, bs, **kw) as it:
        return [(x.copy(), y.copy()) for x, y in itertools.islice(it, steps)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


SETS = {
    "mnist": lambda: synthetic.make_dataset(64, seed=3),
    "cifar": lambda: synthetic.make_image_dataset(40, seed=6),
}


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("seed", [0, 7, 1 << 60])
@pytest.mark.parametrize("data", list(SETS))
def test_batcher_is_jaxs_and_the_twins(data, seed, shuffle):
    """Two epochs and a bit at a ragged batch (drop tail): the port's ring,
    JAX's ring and the NumPy twin give the same batches in the same order,
    epoch 2 reshuffled by the ring's own generator."""
    images, labels = SETS[data]()
    bs = 7
    steps = len(labels) // bs
    got = _ring(native, images, labels, bs, 2 * steps + 1, seed=seed, shuffle=shuffle)
    _assert_batches_equal(got, _ring(jax_native, images, labels, bs, 2 * steps + 1,
                                     seed=seed, shuffle=shuffle))
    twin = list(pipeline.native_semantics_batches(
        pipeline.Dataset(images, labels), bs, shuffle=shuffle, seed=seed))
    _assert_batches_equal(got[:steps], twin)
    assert got[0][0].shape == (bs,) + images.shape[1:]


def test_batcher_counts_its_batches_and_refuses_a_batch_larger_than_the_set():
    images, labels = synthetic.make_dataset(16, seed=1)
    before = native.ring_batches.count
    _ring(native, images, labels, 4, 5)
    assert native.ring_batches.count == before + 5
    with pytest.raises(ValueError, match="exceeds dataset size"):
        native.Batcher(images, labels, 17)
    with pytest.raises(ValueError, match="count mismatch"):
        native.Batcher(images, labels[:15], 4)


def test_views_stay_valid_until_the_next_batch():
    images, labels = synthetic.make_dataset(32, seed=2)
    with native.Batcher(images, labels, 4, depth=8, seed=1, copy=False) as it:
        x, y = next(it)
        snap = x.copy(), y.copy()
        import time

        time.sleep(0.05)  # the producer may run ahead; this slot stays held
        np.testing.assert_array_equal(x, snap[0])
        np.testing.assert_array_equal(y, snap[1])


def test_device_batches_on_the_cpu_are_the_host_batches():
    images, labels = synthetic.make_dataset(16, seed=2)
    host = _ring(native, images, labels, 4, 3, seed=3)
    got = list(pipeline.device_batches(iter(host), "cpu", torch.int64))
    for (x, y), (hx, hy) in zip(got, host):
        assert y.dtype == torch.int64
        np.testing.assert_array_equal(x.numpy(), hx)
        np.testing.assert_array_equal(y.numpy(), hy)


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------


def _learn(prefetch, ds):
    cfg = Config(train=TrainConfig(epochs=2, batch_size=32, prefetch=prefetch,
                                   shuffle=True))
    return trainer.learn(cfg, ds, verbose=False, device="cpu")


def test_prefetch_native_and_the_twin_train_bit_identical_lenets(monkeypatch):
    """prefetch="native" through the ring (its host batches copied to the
    device) and prefetch="auto" (the twin's order gathered on the device,
    with the library or without it): the same epochs, bit for bit."""
    ds = pipeline.Dataset(*synthetic.make_dataset(200, seed=4))
    before = native.ring_batches.count
    ring = _learn("native", ds)
    assert native.ring_batches.count - before == 2 * (200 // 32)
    assert ring.steps == 2 * (200 // 32)
    with monkeypatch.context() as m:
        m.setenv("CXX", "/nonexistent/c++")
        before = native.ring_batches.count
        twin = _learn("auto", ds)
        assert native.ring_batches.count == before
    assert ring.epoch_errors == twin.epoch_errors
    for layer in ring.params:
        for k, v in ring.params[layer].items():
            assert torch.equal(v, twin.params[layer][k]), (layer, k)
    before = native.ring_batches.count
    auto = _learn("auto", ds)  # the library builds; auto still gathers on the device
    assert native.ring_batches.count == before
    assert auto.epoch_errors == ring.epoch_errors


def test_prefetch_native_raises_without_the_library(no_compiler):
    ds = pipeline.Dataset(*synthetic.make_dataset(64, seed=4))
    with pytest.raises(native.NativeBuildError):
        _learn("native", ds)
    assert _learn("off", ds).steps == 2 * 2


def test_zoo_native_loader_gives_jaxs_first_batches():
    """The zoo's loader="native" (seed + epoch + 1) against JAX's
    ``_native_epoch_batches`` on the synthetic CIFAR-shape set; without
    the library the twin gives the same."""
    images, labels = jax_synthetic.make_image_dataset(48, seed=5)
    want = list(jax_zoo._native_epoch_batches(images, labels, 16, 3, 12))
    # The port's ring hands out views into its slots, valid until the next.
    got = [(x.copy(), y.copy())
           for x, y in zoo._native_epoch_batches(images, labels, 16, 3, 12)]
    _assert_batches_equal(got, want)
    dev = list(zoo._epoch_batches("native", None, None, (images, labels), 16, 3, 10,
                                  1, torch.device("cpu")))
    for (x, y), (wx, wy) in zip(dev, want):
        assert y.dtype == torch.int64
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)


def test_zoo_native_loader_without_the_library_takes_the_twin(no_compiler):
    images, labels = jax_synthetic.make_image_dataset(48, seed=5)
    want = list(jax_pipeline.native_semantics_batches(
        jax_pipeline.Dataset(images, labels), 16, shuffle=True, seed=12))
    _assert_batches_equal(list(zoo._native_epoch_batches(images, labels, 16, 3, 12)),
                          want)
