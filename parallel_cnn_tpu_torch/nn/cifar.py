"""CIFAR-10 input geometry (``parallel_cnn_tpu/nn/cifar.py``)."""

from __future__ import annotations

IN_SHAPE = (32, 32, 3)
NUM_CLASSES = 10
