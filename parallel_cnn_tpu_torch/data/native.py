"""ctypes bindings for the repo's native C++ data runtime (``native/*.cc``):
the port's own copy of ``parallel_cnn_tpu/data/native.py``.

Two components:

- **idx loader** (``native/mnist_loader.cc`` ≙ Sequential/mnist.h:79-160):
  the magic, big-endian, 28×28 and error-code contract of the NumPy parser
  in ``data/mnist.py``, raised as the same typed ``MnistError`` with the
  same codes. The Python side owns every allocation: the C side fills
  NumPy buffers the caller made.
- **prefetching batcher** (``native/batcher.cc``): a worker thread
  assembles shuffled batches into a ring of slots while the device trains;
  ``Batcher`` wraps acquire and release into an iterator of batches.

The shared library is built on first use, never at import, with the
flags of ``native/Makefile`` (``-O3 -std=c++17 -fPIC -shared -pthread``;
the compiler is ``$CXX``, else ``g++``, as make picks it) into the port's
``_build/`` directory, which git ignores. Nothing is written under
``native/``. The library's name carries a digest of the two sources, the
compiler and the flags, so an edited source builds anew and a stale
library is never loaded. Concurrent builders (several test workers) take
a file lock, build to a temporary name and ``os.replace`` it into place,
so no process loads a half-written file. A build that fails raises
``NativeBuildError``; ``available()`` says whether the library can be
loaded, for the ``"auto"`` modes that prefer it. ``PCNN_DISABLE_NATIVE=1``
makes it unavailable (``load_lib``).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np

from parallel_cnn_tpu_torch.data.mnist import MnistError
from parallel_cnn_tpu_torch.ops._cuda_build import BUILD_DIR, LaunchCounter

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("mnist_loader.cc", "batcher.cc")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-pthread")

#: Batches the native ring has handed out in this process.
ring_batches = LaunchCounter()

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded (no compiler, no
    sources beside the package, or a compile error)."""


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise NativeBuildError(f"C++ compiler {cxx!r} not found")
    return found


def library_path() -> Path:
    """Where the library for the current sources, compiler and flags lives
    (built or not)."""
    return _library_path(_compiler(), BUILD_DIR)


@functools.cache
def _library_path(compiler: str, build_dir: Path) -> Path:
    """The sources are read and hashed once a process per compiler and
    build directory."""
    try:
        src = b"".join((NATIVE_DIR / s).read_bytes() for s in SOURCES)
    except OSError as e:
        raise NativeBuildError(f"native sources unavailable: {e}") from e
    key = src + " ".join((compiler,) + CXXFLAGS + LDFLAGS).encode()
    return build_dir / f"libpcnn_native-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libpcnn_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder; the rest wait, then load
        if path.exists():
            return
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_compiler(), *CXXFLAGS, *(str(NATIVE_DIR / s) for s in SOURCES),
               *LDFLAGS, "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"native build failed (rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)


def load_lib() -> ctypes.CDLL:
    """The native library, built if needed and loaded once per process;
    raises NativeBuildError when it cannot be, or while
    ``PCNN_DISABLE_NATIVE=1`` (JAX's chaos escape hatch,
    resilience/chaos.py ``hidden_native_lib``: every caller then takes
    the NumPy twins, as without a compiler). JAX reads the variable when
    the module is imported; the port imports this module eagerly and
    builds lazily, so it reads it at each load."""
    if os.environ.get("PCNN_DISABLE_NATIVE") == "1":
        raise NativeBuildError("native runtime disabled via PCNN_DISABLE_NATIVE=1")
    path = library_path()
    with _lock:
        lib = _libs.get(path)
        if lib is None:
            if not path.exists():
                _build(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeBuildError(f"cannot load {path.name}: {e}") from e
            _declare(lib)
            _libs[path] = lib
        return lib


def available() -> bool:
    """Whether the native library can be built and loaded here."""
    try:
        load_lib()
    except NativeBuildError:
        return False
    return True


def _declare(lib: ctypes.CDLL) -> None:
    """The C signatures (native/mnist_loader.cc, native/batcher.cc)."""
    c_long, c_char_p = ctypes.c_long, ctypes.c_char_p
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    sigs = {
        "pcnn_mnist_image_count": ([c_char_p], c_long),
        "pcnn_mnist_load_images": ([c_char_p, f32p, c_long], c_long),
        "pcnn_mnist_label_count": ([c_char_p], c_long),
        "pcnn_mnist_load_labels": ([c_char_p, i32p, c_long], c_long),
        # images, labels, n, sample_size, batch, depth, seed, shuffle
        "pcnn_batcher_create": ([f32p, i32p, c_long, c_long, c_long, c_long,
                                 ctypes.c_uint64, ctypes.c_int], ctypes.c_void_p),
        "pcnn_batcher_acquire": ([ctypes.c_void_p, ctypes.POINTER(f32p),
                                  ctypes.POINTER(i32p)], c_long),
        "pcnn_batcher_release": ([ctypes.c_void_p], None),
        "pcnn_batcher_destroy": ([ctypes.c_void_p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


_ERROR_MESSAGES = {
    -1: "no such file",
    -2: "not a valid image file",
    -3: "not a valid label file",
    -4: "element counts mismatch",
}


def _check(code: int, path: str) -> None:
    if code < 0:
        raise MnistError(code, f"{_ERROR_MESSAGES.get(code, 'error')}: {path}")


def load_idx_images(path: str) -> np.ndarray:
    """(N, 28, 28) float32 in [0, 1] through the native parser."""
    lib = load_lib()
    cpath = os.fsencode(path)
    n = lib.pcnn_mnist_image_count(cpath)
    _check(n, path)
    out = np.empty((n, 28, 28), dtype=np.float32)
    _check(lib.pcnn_mnist_load_images(
        cpath, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n), path)
    return out


def load_idx_labels(path: str) -> np.ndarray:
    """(N,) int32 through the native parser."""
    lib = load_lib()
    cpath = os.fsencode(path)
    n = lib.pcnn_mnist_label_count(cpath)
    _check(n, path)
    out = np.empty((n,), dtype=np.int32)
    _check(lib.pcnn_mnist_load_labels(
        cpath, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n), path)
    return out


def load_pair(image_path: str, label_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """≙ mnist_load(image_file, label_file, …) with the count-mismatch check
    (Sequential/mnist.h:118-121)."""
    images = load_idx_images(image_path)
    labels = load_idx_labels(label_path)
    if images.shape[0] != labels.shape[0]:
        raise MnistError(-4, f"element counts mismatch: {images.shape[0]} images "
                             f"vs {labels.shape[0]} labels")
    return images, labels


class Batcher:
    """Iterator over prefetched (images, labels) batches from the native
    ring: batches are assembled on a C++ worker thread while the consumer
    works. It runs forever (epochs wrap, reshuffling when ``shuffle``);
    bound it with ``itertools.islice``. Its batch order is that of
    ``pipeline.native_semantics_batches`` (xorshift Fisher–Yates, drop
    tail), batch for batch.

    Shape-generic: images may be (N, 28, 28) MNIST, (N, 32, 32, 3) CIFAR or
    any (N, ...) float32 array; the ring copies flat samples and each batch
    comes back in the per-sample shape.

    ``copy=True`` (default) hands out arrays of their own, safe for a
    consumer that copies to the device asynchronously; ``copy=False`` hands
    out views into the ring slot, valid only until the next ``next()``.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int, *,
                 depth: int = 4, seed: int = 0, shuffle: bool = True,
                 copy: bool = True):
        self._handle = None
        self._lib = load_lib()
        self._images = np.ascontiguousarray(images, dtype=np.float32)
        self._labels = np.ascontiguousarray(labels, dtype=np.int32)
        if self._images.shape[0] != self._labels.shape[0]:
            raise ValueError("images/labels count mismatch")
        if batch_size > self._images.shape[0]:
            # The ring would wrap mid-batch and repeat samples within one.
            raise ValueError(f"batch_size {batch_size} exceeds dataset size "
                             f"{self._images.shape[0]}")
        self.batch_size = batch_size
        self._sample_shape = self._images.shape[1:]
        self._handle = self._lib.pcnn_batcher_create(
            self._images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._images.shape[0], int(np.prod(self._sample_shape)), batch_size,
            depth, seed, int(shuffle))
        if not self._handle:
            raise RuntimeError("pcnn_batcher_create failed")
        self._copy = copy
        self._pending_release = False
        # The ring's slots stay where create() put them: one view pair a
        # slot address, made once (np.ctypeslib.as_array builds a ctypes
        # array type per call, tens of µs).
        self._views: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._handle is None:
            raise StopIteration
        # The previous batch's views stay valid until the next is asked for.
        if self._pending_release:
            self._lib.pcnn_batcher_release(self._handle)
            self._pending_release = False
        xp = ctypes.POINTER(ctypes.c_float)()
        yp = ctypes.POINTER(ctypes.c_int32)()
        if self._lib.pcnn_batcher_acquire(self._handle, ctypes.byref(xp),
                                          ctypes.byref(yp)) != 0:
            raise StopIteration
        addr = ctypes.cast(xp, ctypes.c_void_p).value
        views = self._views.get(addr)
        if views is None:
            views = (np.ctypeslib.as_array(xp, shape=(self.batch_size,) + self._sample_shape),
                     np.ctypeslib.as_array(yp, shape=(self.batch_size,)))
            self._views[addr] = views
        x, y = views
        if self._copy:
            x, y = x.copy(), y.copy()
            self._lib.pcnn_batcher_release(self._handle)
        else:
            self._pending_release = True
        ring_batches.add()
        return x, y

    def close(self) -> None:
        if self._handle is not None:
            self._lib.pcnn_batcher_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "Batcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self.close()
