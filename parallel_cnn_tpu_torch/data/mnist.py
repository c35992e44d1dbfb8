"""idx-ubyte MNIST reader and writer: the port's copy of
``parallel_cnn_tpu/data/mnist.py`` (≙ the reference's C loader,
Sequential/mnist.h:79-160).

Same format contract as ``mnist_load``: image magic 2051, label magic 2049,
big-endian u32 header fields, image/label count mismatch is an error,
images must be 28×28, pixels scaled /255.0 into float32. The reference's
negative return codes are raised as the typed ``MnistError``. Parsing is
one vectorized ``frombuffer``.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

IMAGE_MAGIC = 2051
LABEL_MAGIC = 2049


class MnistError(Exception):
    """Loader failure; `code` mirrors mnist.h's negative return codes."""

    def __init__(self, code: int, msg: str):
        super().__init__(f"[{code}] {msg}")
        self.code = code


def _read_u32be(f) -> int:
    raw = f.read(4)
    if len(raw) != 4:
        raise MnistError(-2, "truncated header")
    return struct.unpack(">I", raw)[0]


def load_idx_images(path: str) -> np.ndarray:
    """Parse an idx3-ubyte image file → (N, 28, 28) float32 in [0, 1]."""
    if not os.path.exists(path):
        raise MnistError(-1, f"no such file: {path}")
    with open(path, "rb") as f:
        if _read_u32be(f) != IMAGE_MAGIC:
            raise MnistError(-2, f"not a valid image file: {path}")
        count = _read_u32be(f)
        rows, cols = _read_u32be(f), _read_u32be(f)
        if (rows, cols) != (28, 28):
            raise MnistError(-2, f"not 28x28: {path} is {rows}x{cols}")
        raw = np.frombuffer(f.read(count * rows * cols), dtype=np.uint8)
        if raw.size != count * rows * cols:
            raise MnistError(-2, f"truncated image data: {path}")
    return (raw.astype(np.float32) / 255.0).reshape(count, rows, cols)


def load_idx_labels(path: str) -> np.ndarray:
    """Parse an idx1-ubyte label file → (N,) int32 in [0, 9]."""
    if not os.path.exists(path):
        raise MnistError(-1, f"no such file: {path}")
    with open(path, "rb") as f:
        if _read_u32be(f) != LABEL_MAGIC:
            raise MnistError(-3, f"not a valid label file: {path}")
        count = _read_u32be(f)
        raw = np.frombuffer(f.read(count), dtype=np.uint8)
        if raw.size != count:
            raise MnistError(-3, f"truncated label data: {path}")
    return raw.astype(np.int32)


def load_pair(image_path: str, label_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """≙ mnist_load(image_file, label_file, &data, &count) — both files,
    with the count-mismatch check (mnist.h:118-121)."""
    images = load_idx_images(image_path)
    labels = load_idx_labels(label_path)
    if images.shape[0] != labels.shape[0]:
        raise MnistError(
            -4,
            f"element counts mismatch: {images.shape[0]} images vs "
            f"{labels.shape[0]} labels",
        )
    return images, labels


def integrity_report(
    image_path: str, label_path: str, images=None, labels=None
) -> dict:
    """Structural + statistical integrity evidence for a real idx pair.

    The reference snapshot ships genuine labels but no image blobs
    (SURVEY.md B15), so accuracy claims on "real MNIST" hinge on the files a
    user supplies. This report makes the claim checkable: file checksums
    (compare against any published MNIST mirror), per-class label counts
    (MNIST trains ~5.4-6.7k per digit), and the pixel mean (canonical MNIST
    train mean ≈ 0.1307). Logged by the pipeline whenever real files load;
    see README "Running on real MNIST".

    Pass the already-parsed arrays when available so the report describes
    EXACTLY the data the pipeline trains on (and the files aren't re-read);
    only the checksums always stream the files.
    """
    import hashlib

    def sha256(path):
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    if images is None:
        images = load_idx_images(image_path)
    if labels is None:
        labels = load_idx_labels(label_path)
    images, labels = np.asarray(images), np.asarray(labels)
    hist = np.bincount(labels, minlength=10)
    return {
        "count": int(images.shape[0]),
        "sha256_images": sha256(image_path),
        "sha256_labels": sha256(label_path),
        "label_counts": hist.tolist(),
        "all_classes_present": bool((hist > 0).all()),
        "pixel_mean": round(float(images.mean()), 5),
    }


def write_idx_images(path: str, images: np.ndarray) -> None:
    """Inverse of `load_idx_images` (for fixtures & the synthetic fallback)."""
    images = np.asarray(images)
    n, r, c = images.shape
    u8 = np.clip(np.round(images * 255.0), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", IMAGE_MAGIC, n, r, c))
        f.write(u8.tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    labels = np.asarray(labels)
    with open(path, "wb") as f:
        f.write(struct.pack(">II", LABEL_MAGIC, labels.shape[0]))
        f.write(labels.astype(np.uint8).tobytes())
