"""Dataset assembly and epoch order: the port's copy of
``parallel_cnn_tpu/data/pipeline.py`` (≙ loaddata(), Sequential/Main.cpp:36-42).

A split is loaded to host memory once, through the native C++ parser
(data/native.py) or the NumPy one (data/mnist.py), as ``DataConfig.loader``
says. The trainer then places it on the device once and gathers each batch
there by index (``epoch_order`` gives the indices), or takes host batches
from the native prefetch ring and copies each to the device
(``device_batches``); the iterators below give the same batches as host
arrays, in the same order as their JAX counterparts.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from parallel_cnn_tpu_torch.config import DataConfig
from parallel_cnn_tpu_torch.data import mnist, native, synthetic

log = logging.getLogger(__name__)


@dataclass
class Dataset:
    """One split, fully materialized on host."""

    images: np.ndarray  # (N, 28, 28) float32 in [0, 1]
    labels: np.ndarray  # (N,) int32
    # "mnist" when parsed from real idx files, "synthetic" for the stand-in.
    source: str = "synthetic"

    def __len__(self) -> int:
        return self.images.shape[0]


def _parse(cfg: DataConfig, images_path: str, labels_path: str):
    if cfg.loader == "numpy":
        return mnist.load_pair(images_path, labels_path)
    # "auto" prefers the native parser and takes NumPy's only where the
    # library cannot be built; "native" never takes another parser.
    if cfg.loader == "auto" and not native.available():
        return mnist.load_pair(images_path, labels_path)
    return native.load_pair(images_path, labels_path)


def load_split(
    cfg: DataConfig, images_path: str, labels_path: str, synth_count: int, seed: int
) -> Dataset:
    """Try real idx files; fall back to the deterministic synthetic set.
    ``loader="native"`` whose library cannot be built raises
    ``MnistError(-5)``, whatever ``synthetic_fallback`` says."""
    if cfg.loader == "synthetic":
        imgs, labels = synthetic.make_dataset(synth_count, seed=seed)
        return Dataset(imgs, labels)
    if cfg.loader == "native":
        try:
            native.load_lib()
        except native.NativeBuildError as e:
            raise mnist.MnistError(-5, f"native loader unavailable: {e}") from e
    try:
        imgs, labels = _parse(cfg, images_path, labels_path)
        if log.isEnabledFor(logging.INFO):  # sha256 streams both files
            try:
                rep = mnist.integrity_report(
                    images_path, labels_path, images=imgs, labels=labels
                )
                log.info("real MNIST idx verified: %s", rep)
            except Exception:  # the report is evidence, never a failure mode
                log.exception("integrity report failed for %s", images_path)
        return Dataset(imgs, labels, source="mnist")
    except mnist.MnistError as e:
        if not cfg.synthetic_fallback:
            raise
        log.warning(
            "idx files unavailable (%s); using synthetic MNIST stand-in", e
        )
        imgs, labels = synthetic.make_dataset(synth_count, seed=seed)
        return Dataset(imgs, labels)


def load_train_test(cfg: DataConfig) -> Tuple[Dataset, Dataset]:
    train = load_split(
        cfg, cfg.train_images, cfg.train_labels, cfg.synthetic_train_count,
        cfg.synthetic_seed,
    )
    test = load_split(
        cfg, cfg.test_images, cfg.test_labels, cfg.synthetic_test_count,
        cfg.synthetic_seed + 1,
    )
    return train, test


_U64 = (1 << 64) - 1
_XORSHIFT_DEFAULT_SEED = 0x9E3779B97F4A7C15
_XORSHIFT_MULT = 0x2545F4914F6CDD1D


def xorshift_permutation(n: int, seed: int) -> np.ndarray:
    """Bit-identical twin of the native batcher's epoch permutation
    (native/batcher.cc: XorShift64 + descending Fisher–Yates), as the JAX
    package's ``xorshift_permutation``."""
    perm = np.arange(n, dtype=np.int64)
    s = seed & _U64
    if s == 0:
        s = _XORSHIFT_DEFAULT_SEED
    for i in range(n - 1, 0, -1):
        s ^= s >> 12
        s = (s ^ (s << 25)) & _U64
        s ^= s >> 27
        j = ((s * _XORSHIFT_MULT) & _U64) % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return perm


def epoch_order(
    n: int,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    native_semantics: bool = False,
    drop_remainder: bool = True,
) -> List[np.ndarray]:
    """The index arrays of one epoch's batches.

    ``native_semantics`` is the native ring's order (xorshift Fisher–Yates,
    always drop-tail); otherwise NumPy's PCG shuffle, keep-tail unless
    ``drop_remainder``. The reference never shuffles (it replays file
    order every epoch, Sequential/Main.cpp:157); shuffle is opt-in.
    """
    if native_semantics:
        idx = (xorshift_permutation(n, seed) if shuffle
               else np.arange(n, dtype=np.int64))
        drop_remainder = True
    else:
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_remainder else n
    return [idx[i : i + batch_size] for i in range(0, end, batch_size)]


def epoch_batches(
    ds: Dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Host-side batch iterator (NumPy PCG shuffle when ``shuffle``)."""
    for j in epoch_order(len(ds), batch_size, shuffle=shuffle, seed=seed,
                         drop_remainder=drop_remainder):
        yield ds.images[j], ds.labels[j]


def native_semantics_batches(
    ds: Dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of batches with the native ring's exact semantics:
    drop-tail (fixed shapes) and the xorshift Fisher–Yates order — the
    ``prefetch="auto"`` order."""
    for j in epoch_order(len(ds), batch_size, shuffle=shuffle, seed=seed,
                         native_semantics=True):
        yield ds.images[j], ds.labels[j]


def pad_to_batch(
    images: np.ndarray, labels: np.ndarray, batch_size: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad a ragged tail batch up to `batch_size`; returns the valid count."""
    valid = images.shape[0]
    if valid == batch_size:
        return images, labels, valid
    pad = batch_size - valid
    images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
    labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
    return images, labels, valid


def device_batches(
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    device,
    label_dtype: torch.dtype = torch.int32,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Host (images, labels) batches as tensors on ``device``, in order.
    Each batch is copied out of its arrays before the next is asked for
    (a copy from pageable memory has read its source when it returns), so
    the source may hand out views that the next batch overwrites (the
    native Batcher's ``copy=False``)."""
    dev = torch.device(device)
    for x, y in batches:
        yield (torch.from_numpy(x).to(dev, torch.float32, copy=True),
               torch.from_numpy(y).to(dev, label_dtype, copy=True))
