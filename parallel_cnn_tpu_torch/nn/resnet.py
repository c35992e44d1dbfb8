"""ResNet-18/34/50 (the port's counterpart of
``parallel_cnn_tpu/nn/resnet.py``), built from ``ConvBNAct`` units so each
block's tail — BN, shortcut add and post-add ReLU — runs in the conv
kernel's epilogue in eval mode, and as JAX's unfused composition (batch
statistics) in training mode. ``backend`` picks the conv of every unit:
``"cuda"`` (the hand kernels, JAX's ``"pallas"``) or ``"torch"`` (the
library conv, JAX's ``"xla"``).

The module tree mirrors the JAX pytree: the stem is child ``0`` (the CIFAR
stem, a 3×3/s1 ConvBNAct) or children ``0`` and ``1`` (the ImageNet stem, a
7×7/s2 ConvBNAct and a 3×3/s2 SAME max pool), the blocks follow, then
``GlobalAvgPool`` and ``Dense``. A ``BasicBlock`` holds ``main.0``/``main.1``,
a ``Bottleneck`` ``main.0``/``main.1``/``main.2`` (reduce 1×1, mid 3×3 with
the stride, expand 1×1 to 4× the width), and either, where ``stride != 1``
or the width changes, ``proj.0`` (a 1×1 ConvBNAct with the stride and
without ReLU).

On a mesh whose model axis splits the block's filters (nn/core.py), the
block gathers its input once for both of its first convs, and the
identity shortcut is added to the tail conv's block of channels as the
same block of the gathered input: every rank's gradient of that input is
then a partial one (its filters' part and its channels' shortcut part),
which the gather's adjoint sums and slices. A bottleneck's convs have
widths f, f and 4f, which the model axis may split differently, so each
conv takes its input in its own layout (``whole``); an identity shortcut,
as wide as the expand conv, is split exactly where that conv's output is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from parallel_cnn_tpu_torch.nn.core import Sequential, whole
from parallel_cnn_tpu_torch.nn.layers import ConvBNAct, Dense, GlobalAvgPool, MaxPool

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


class Bottleneck(nn.Module):
    """1×1 reduce → 3×3 mid (with the stride) → 1×1 expand to 4× the width,
    + identity/projection shortcut (ResNet-50); the expand conv's epilogue
    carries the shortcut add and the ReLU."""

    EXPANSION = 4

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 backend: str = "cuda", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(backend=backend, generator=generator, device=device)
        out = features * self.EXPANSION
        self.main = nn.ModuleList([
            ConvBNAct(in_features, features, 1, 1, **kw),
            ConvBNAct(features, features, 3, stride, **kw),
            ConvBNAct(features, out, 1, 1, **kw),
        ])
        self.proj = None
        if stride != 1 or in_features != out:
            self.proj = nn.ModuleList([
                ConvBNAct(in_features, out, 1, stride, relu=False, **kw)
            ])

    sharding = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = self.proj[0](x) if self.proj is not None else x
        reduce, mid, expand = self.main
        return expand(mid(reduce(x)), residual=sc)

    def forward_split(self, x: torch.Tensor, split: bool):
        """The block on a mesh: (output, whether it is split). Each conv
        takes its input whole and computes its own block of filters where
        its width divides; the widths differ, so the layouts may too."""
        reduce, mid, expand = self.main
        model = reduce.sharding.model
        if self.proj is not None:
            proj = self.proj[0]
            sc = proj(whole(x, split, proj.sharding.split, model))
        else:
            # An identity shortcut is as wide as the expand conv, so it is
            # split exactly where that conv's output is: each rank adds its
            # own block of x.
            sc = x
        y = reduce(whole(x, split, reduce.sharding.split, model))
        y = mid(whole(y, reduce.sharding.split, mid.sharding.split, model))
        y = whole(y, mid.sharding.split, expand.sharding.split, model)
        return expand(y, residual=sc), expand.sharding.split


def _resnet(block, stage_sizes: Sequence[int], num_classes: int,
            cifar_stem: bool, backend: str, generator, device) -> Sequential:
    """JAX's ``_resnet``: the stem, the four stages (the first block of
    stages 2-4 with stride 2), global average pool, Dense."""
    kw = dict(generator=generator, device=device)
    if cifar_stem:
        layers = [ConvBNAct(3, WIDTHS[0], backend=backend, **kw)]
    else:
        layers = [ConvBNAct(3, WIDTHS[0], 7, 2, backend=backend, **kw),
                  MaxPool(3, 2, "SAME")]
    in_features = WIDTHS[0]
    expansion = getattr(block, "EXPANSION", 1)
    for i, (features, count) in enumerate(zip(WIDTHS, stage_sizes)):
        for j in range(count):
            stride = 2 if (i > 0 and j == 0) else 1
            layers.append(block(in_features, features, stride, backend, **kw))
            in_features = features * expansion
    layers += [GlobalAvgPool(), Dense(in_features, num_classes, **kw)]
    return Sequential(*layers)


def resnet18(num_classes: int = 10, *, backend: str = "cuda",
             generator: Optional[torch.Generator] = None,
             device=None) -> Sequential:
    return _resnet(BasicBlock, (2, 2, 2, 2), num_classes, True, backend, generator,
                   device)


def resnet34(num_classes: int = 10, *, backend: str = "cuda",
             generator: Optional[torch.Generator] = None,
             device=None) -> Sequential:
    return _resnet(BasicBlock, (3, 4, 6, 3), num_classes, True, backend, generator,
                   device)


def resnet50(num_classes: int = 1000, cifar_stem: bool = False, *,
             backend: str = "cuda", generator: Optional[torch.Generator] = None,
             device=None) -> Sequential:
    """JAX's defaults: 1,000 classes and the ImageNet stem (224² inputs);
    the zoo trainer and the server build ``resnet50(10, cifar_stem=True)``."""
    return _resnet(Bottleneck, (3, 4, 6, 3), num_classes, cifar_stem, backend,
                   generator, device)


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
