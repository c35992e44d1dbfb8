"""ResNet-18/34 with the CIFAR stem (the port's counterpart of
``parallel_cnn_tpu/nn/resnet.py``), built from ``ConvBNAct`` units so each
block's tail — BN, shortcut add and post-add ReLU — runs in the conv
kernel's epilogue.

The module tree mirrors the JAX pytree: the stem is child ``0``, the
blocks follow, then ``GlobalAvgPool`` and ``Dense``; a block holds
``main.0``/``main.1`` and, where ``stride != 1`` or the width changes,
``proj.0`` (a 1×1 ConvBNAct without ReLU). The ImageNet stem (7×7/s2 conv
+ max pool) and the Bottleneck family (ResNet-50) wait for a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from parallel_cnn_tpu_torch.nn.core import Sequential
from parallel_cnn_tpu_torch.nn.layers import ConvBNAct, Dense, GlobalAvgPool

WIDTHS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    """Two 3×3 convs + identity/projection shortcut; the shortcut is the
    tail conv's fused residual."""

    def __init__(self, in_features: int, features: int, stride: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.main = nn.ModuleList([
            ConvBNAct(in_features, features, 3, stride, **kw),
            ConvBNAct(features, features, 3, 1, **kw),
        ])
        self.proj = None
        if stride != 1 or in_features != features:
            self.proj = nn.ModuleList([
                ConvBNAct(in_features, features, 1, stride, relu=False, **kw)
            ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = self.proj[0](x) if self.proj is not None else x
        y = self.main[0](x)
        return self.main[1](y, residual=sc)


def _resnet(stage_sizes: Sequence[int], num_classes: int, generator,
            device) -> Sequential:
    kw = dict(generator=generator, device=device)
    layers = [ConvBNAct(3, WIDTHS[0], **kw)]
    in_features = WIDTHS[0]
    for i, (features, count) in enumerate(zip(WIDTHS, stage_sizes)):
        for j in range(count):
            stride = 2 if (i > 0 and j == 0) else 1
            layers.append(BasicBlock(in_features, features, stride, **kw))
            in_features = features
    layers += [GlobalAvgPool(), Dense(in_features, num_classes, **kw)]
    return Sequential(*layers)


def resnet18(num_classes: int = 10, *,
             generator: Optional[torch.Generator] = None,
             device=None) -> Sequential:
    return _resnet((2, 2, 2, 2), num_classes, generator, device)


def resnet34(num_classes: int = 10, *,
             generator: Optional[torch.Generator] = None,
             device=None) -> Sequential:
    return _resnet((3, 4, 6, 3), num_classes, generator, device)


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
