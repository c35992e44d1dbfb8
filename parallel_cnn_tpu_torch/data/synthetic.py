"""Deterministic synthetic data sets: the port's copies of ``make_dataset``
(the MNIST stand-in) and ``make_image_dataset`` (the CIFAR-shape stand-in)
in ``parallel_cnn_tpu/data/synthetic.py``, bit-identical to them (the same
NumPy generators, seeds and operations).

When the real idx image files are absent, the trainer synthesizes a
learnable, MNIST-shaped dataset: 10 fixed class prototypes (seeded blobs
of strokes) plus per-sample jitter and noise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _prototypes(rng: np.random.Generator) -> np.ndarray:
    """10 class-distinct 28×28 prototypes built from random soft strokes."""
    protos = np.zeros((10, 28, 28), dtype=np.float32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    for cls in range(10):
        img = np.zeros((28, 28), dtype=np.float32)
        # 3-5 gaussian "strokes" at class-specific positions
        n_strokes = 3 + cls % 3
        for _ in range(n_strokes):
            cy, cx = rng.uniform(6, 22, size=2)
            sy, sx = rng.uniform(1.5, 4.0, size=2)
            theta = rng.uniform(0, np.pi)
            dy, dx = yy - cy, xx - cx
            u = dy * np.cos(theta) + dx * np.sin(theta)
            v = -dy * np.sin(theta) + dx * np.cos(theta)
            img += np.exp(-(u**2 / (2 * sy**2) + v**2 / (2 * (sx / 2) ** 2)))
        protos[cls] = np.clip(img / img.max(), 0.0, 1.0)
    return protos


def make_dataset(
    count: int, seed: int = 1234, noise: float = 0.15, proto_seed: int = 99
) -> Tuple[np.ndarray, np.ndarray]:
    """Generate (images (N,28,28) float32 in [0,1], labels (N,) int32).

    `proto_seed` fixes the 10 class prototypes independently of `seed`, so
    train/test splits generated with different `seed`s still come from the
    SAME class-conditional distribution (different samples, same classes).
    Same (seed, proto_seed) ⇒ identical data on every host/process —
    important for the multi-host data-parallel path, where each process
    slices one global dataset by its process index.
    """
    rng = np.random.default_rng(seed)
    protos = _prototypes(np.random.default_rng(proto_seed))
    labels = rng.integers(0, 10, size=count).astype(np.int32)
    images = protos[labels]
    # per-sample integer jitter (±2 px roll) + additive noise
    shifts = rng.integers(-2, 3, size=(count, 2))
    out = np.empty_like(images)
    # vectorized roll: group samples by (dy,dx) so we do ≤25 rolls, not N
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            mask = (shifts[:, 0] == dy) & (shifts[:, 1] == dx)
            if mask.any():
                out[mask] = np.roll(images[mask], (dy, dx), axis=(1, 2))
    out += rng.normal(0.0, noise, size=out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0), labels


def make_image_dataset(
    count: int,
    hw: Tuple[int, int] = (32, 32),
    channels: int = 3,
    classes: int = 10,
    seed: int = 1234,
    noise: float = 0.1,
    proto_seed: int = 99,
) -> Tuple[np.ndarray, np.ndarray]:
    """NHWC synthetic image classification set, the CIFAR stand-in of the
    zoo trainer (no CIFAR files ship): per-class smooth prototypes (low-res
    noise upsampled 4×) plus Gaussian noise. Bit-identical to the JAX
    package's ``make_image_dataset``.

    Returns (images (N,H,W,C) float32 in [0,1], labels (N,) int32).
    """
    h, w = hw
    prng = np.random.default_rng(proto_seed)
    # ceil-divide so the 4× kron always covers (h, w) before the crop.
    low = prng.uniform(0, 1, size=(classes, -(-h // 4), -(-w // 4), channels))
    protos = np.stack([
        np.stack([np.kron(low[c, :, :, ch], np.ones((4, 4)))[:h, :w]
                  for ch in range(channels)], axis=-1)
        for c in range(classes)
    ]).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, size=count).astype(np.int32)
    images = protos[labels] + rng.normal(
        0, noise, size=(count, h, w, channels)).astype(np.float32)
    return np.clip(images, 0.0, 1.0), labels
