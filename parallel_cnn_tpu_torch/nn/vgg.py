"""VGG-16 (Simonyan & Zisserman 2014, configuration D), the port's
counterpart of ``parallel_cnn_tpu/nn/vgg.py``: thirteen 3×3 SAME convs in
five max-pooled stages, then the classifier.

Two heads, as in the JAX package:

- ``cifar_head=True`` (default): GlobalAvgPool → Dense(num_classes), which
  the fused loss tail takes as its ``gap`` mode;
- ``cifar_head=False``: Flatten → 4096 → ReLU → 4096 → ReLU → classes, with
  no dropout (it carries no parameters), sized from ``in_shape``. No fused
  tail matches it, so the zoo trainer runs it unfused, as JAX does.

The convs keep a bias even under BatchNorm (torchvision's VGG, so the
parameter counts line up): ``Conv2D(use_bias=True)``, whose ``"cuda"``
backend runs the conv through the tap-conv kernels and adds ``b`` after.
Child indices are the JAX Sequential's: the stateless layers (ReLU,
MaxPool, GlobalAvgPool, Flatten) hold their places, so a JAX tree path
``3/w`` is the state_dict key ``3.w``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from parallel_cnn_tpu_torch.nn.core import Sequential
from parallel_cnn_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    Flatten,
    GlobalAvgPool,
    MaxPool,
    ReLU,
)

# Configuration D: channels per conv, "M" = 2×2 max pool.
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M")


def vgg16(num_classes: int = 10, batch_norm: bool = True, cifar_head: bool = True,
          *, in_shape: Optional[Tuple[int, int, int]] = None, backend: str = "cuda",
          generator: Optional[torch.Generator] = None, device=None) -> Sequential:
    """``in_shape`` (H, W, C) sizes the full head as JAX's ``init(key,
    in_shape)`` does; by default (32, 32, 3) with the CIFAR head and
    (224, 224, 3) with the full one."""
    if in_shape is None:
        in_shape = (32, 32, 3) if cifar_head else (224, 224, 3)
    h, w, cin = in_shape
    kw = dict(generator=generator, device=device)
    layers = []
    for v in VGG16:
        if v == "M":
            layers.append(MaxPool(2, 2))
            h, w = h // 2, w // 2
            continue
        layers.append(Conv2D(cin, v, backend=backend, **kw))
        if batch_norm:
            layers.append(BatchNorm(v, device=device))
        layers.append(ReLU())
        cin = v
    if cifar_head:
        layers += [GlobalAvgPool(), Dense(cin, num_classes, **kw)]
    else:
        layers += [Flatten(), Dense(h * w * cin, 4096, **kw), ReLU(),
                   Dense(4096, 4096, **kw), ReLU(), Dense(4096, num_classes, **kw)]
    return Sequential(*layers)
