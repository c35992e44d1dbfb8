"""CIFAR-10 input geometry and the 3-conv-block CIFAR CNN (the port's
counterpart of ``parallel_cnn_tpu/nn/cifar.py``).

As in the JAX package, the CNN's convs are library convs (JAX's ``"xla"``
backend, the port's ``"torch"``); its ``MaxPool → Flatten → Dense`` head
is what ``--fused-step`` routes through the fused loss tail's ``max2``
mode. Child indices match the JAX Sequential's layer list, so a JAX tree
path ``3/w`` is the state_dict key ``3.w``.
"""

from __future__ import annotations

from typing import Optional

import torch

from parallel_cnn_tpu_torch.nn.core import Sequential
from parallel_cnn_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    Flatten,
    MaxPool,
    ReLU,
)

IN_SHAPE = (32, 32, 3)
NUM_CLASSES = 10


def cifar_cnn(num_classes: int = NUM_CLASSES, *, in_shape=IN_SHAPE,
              generator: Optional[torch.Generator] = None,
              device=None) -> Sequential:
    """conv-bn-relu ×2 per block, 3 blocks (32→64→128 channels), a 2×2 max
    pool after each, dense head. ``in_shape`` (H, W, C), H and W multiples
    of 8, sizes the head as JAX's ``init(key, in_shape)`` does."""
    kw = dict(generator=generator, device=device)
    layers = []
    h, w, cin = in_shape
    for ch in (32, 64, 128):
        layers += [
            Conv2D(cin, ch, **kw), BatchNorm(ch, device=device), ReLU(),
            Conv2D(ch, ch, **kw), BatchNorm(ch, device=device), ReLU(),
            MaxPool(),
        ]
        cin = ch
    layers += [Flatten(), Dense((h // 8) * (w // 8) * cin, num_classes, **kw)]
    return Sequential(*layers)
