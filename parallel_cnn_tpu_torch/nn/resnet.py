"""ResNet-18/34 with the CIFAR stem (the port's counterpart of
``parallel_cnn_tpu/nn/resnet.py``), built from ``ConvBNAct`` units so each
block's tail — BN, shortcut add and post-add ReLU — runs in the conv
kernel's epilogue in eval mode, and as JAX's unfused composition (batch
statistics) in training mode. ``backend`` picks the conv of every unit:
``"cuda"`` (the hand kernels, JAX's ``"pallas"``) or ``"torch"`` (the
library conv, JAX's ``"xla"``).

The module tree mirrors the JAX pytree: the stem is child ``0``, the
blocks follow, then ``GlobalAvgPool`` and ``Dense``; a block holds
``main.0``/``main.1`` and, where ``stride != 1`` or the width changes,
``proj.0`` (a 1×1 ConvBNAct without ReLU). The ImageNet stem (7×7/s2 conv
+ max pool) and the Bottleneck family (ResNet-50) wait for a later slice.

On a mesh whose model axis splits the block's filters (nn/core.py), the
block gathers its input once for both of its first convs, and the
identity shortcut is added to the tail conv's block of channels as the
same block of the gathered input: every rank's gradient of that input is
then a partial one (its filters' part and its channels' shortcut part),
which the gather's adjoint sums and slices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from parallel_cnn_tpu_torch.nn.core import Sequential, whole
from parallel_cnn_tpu_torch.nn.layers import ConvBNAct, Dense, GlobalAvgPool

WIDTHS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    """Two 3×3 convs + identity/projection shortcut; the shortcut is the
    tail conv's fused residual."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 backend: str = "cuda", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(backend=backend, generator=generator, device=device)
        self.main = nn.ModuleList([
            ConvBNAct(in_features, features, 3, stride, **kw),
            ConvBNAct(features, features, 3, 1, **kw),
        ])
        self.proj = None
        if stride != 1 or in_features != features:
            self.proj = nn.ModuleList([
                ConvBNAct(in_features, features, 1, stride, relu=False, **kw)
            ])

    sharding = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = self.proj[0](x) if self.proj is not None else x
        y = self.main[0](x)
        return self.main[1](y, residual=sc)

    def forward_split(self, x: torch.Tensor, split: bool):
        """The block on a mesh: (output, whether it is split). The three
        convs have one width, so they split alike."""
        first, tail = self.main
        sh = first.sharding
        x = whole(x, split, sh.split, sh.model)
        if self.proj is not None:
            sc = self.proj[0](x)
        elif sh.split:
            k = x.shape[-1] // sh.model.size
            sc = x[..., sh.model.index * k:(sh.model.index + 1) * k]
        else:
            sc = x
        y = whole(first(x), sh.split, tail.sharding.split, sh.model)
        return tail(y, residual=sc), tail.sharding.split


def _resnet(stage_sizes: Sequence[int], num_classes: int, backend: str,
            generator, device) -> Sequential:
    kw = dict(generator=generator, device=device)
    layers = [ConvBNAct(3, WIDTHS[0], backend=backend, **kw)]
    in_features = WIDTHS[0]
    for i, (features, count) in enumerate(zip(WIDTHS, stage_sizes)):
        for j in range(count):
            stride = 2 if (i > 0 and j == 0) else 1
            layers.append(BasicBlock(in_features, features, stride, backend, **kw))
            in_features = features
    layers += [GlobalAvgPool(), Dense(in_features, num_classes, **kw)]
    return Sequential(*layers)


def resnet18(num_classes: int = 10, *, backend: str = "cuda",
             generator: Optional[torch.Generator] = None,
             device=None) -> Sequential:
    return _resnet((2, 2, 2, 2), num_classes, backend, generator, device)


def resnet34(num_classes: int = 10, *, backend: str = "cuda",
             generator: Optional[torch.Generator] = None,
             device=None) -> Sequential:
    return _resnet((3, 4, 6, 3), num_classes, backend, generator, device)


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
