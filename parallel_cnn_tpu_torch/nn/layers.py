"""Layers of the serving slice, NHWC (the port's counterpart of
``parallel_cnn_tpu/nn/layers.py``).

Only inference is ported: BatchNorm evaluates from its running statistics,
and ``ConvBNAct`` folds them, once, into a per-channel scale/shift that rides the
conv kernel's epilogue (``ops.tap_conv.conv2d_fused``) together with the
residual add and the ReLU. Train-mode BatchNorm comes with the training
slice; a module in training mode raises rather than compute the wrong
statistics.

Parameters are created on the CPU from an explicit ``torch.Generator``
(He-normal conv and Dense weights, BN at identity) and moved to
``device``. Layouts match the JAX package: conv weights HWIO
``(k, k, Cin, Cout)``, Dense ``w`` as ``(d, features)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from parallel_cnn_tpu_torch.ops import tap_conv


def _he_normal(shape, fan_in: int, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__} is ported for inference only; call "
            f".eval() (train-mode BatchNorm statistics come with the "
            f"training slice)"
        )


class BatchNorm(nn.Module):
    """Running-statistics batch norm over the last (channel) axis, eval
    only. ``scale``/``bias`` are the trainables, ``mean``/``var`` the
    running statistics, as in the JAX tree."""

    def __init__(self, features: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def fold(self):
        """(scale, shift) with ``bn(x) == x·scale + shift``:
        ``scale = γ·rsqrt(var+ε)``, ``shift = β − mean·scale``."""
        scale = self.scale * torch.rsqrt(self.var + self.eps)
        return scale, self.bias - self.mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        return (x - self.mean) * inv + self.bias


class ConvBNAct(nn.Module):
    """SAME conv (no bias) → BatchNorm → (+ residual) → optional ReLU as
    one kernel launch: the folded BN, the residual add and the ReLU run on
    the conv's f32 accumulator before its only store.

    ``forward(x, residual=sc)`` computes ``relu?(bn(conv(x)) + sc)``
    through the hand-written tap-conv kernel; on a CPU tensor it runs the
    kernel's plain PyTorch version."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int = 3,
        stride: int = 1,
        relu: bool = True,
        eps: float = 1e-5,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if kernel not in tap_conv.SUPPORTED_K or stride not in tap_conv.SUPPORTED_STRIDES:
            raise ValueError(
                f"the tap-conv kernel does not cover kernel={kernel} "
                f"stride={stride}"
            )
        self.stride = stride
        self.relu = relu
        w = _he_normal((kernel, kernel, in_features, features),
                       kernel * kernel * in_features, generator)
        self.conv = nn.ParameterDict({"w": nn.Parameter(w.to(device))})
        self.bn = BatchNorm(features, eps, device=device)
        self._fold = None

    def folded_bn(self):
        """The BN fold ``(scale, shift)``, computed once and reused until a
        BN tensor is replaced (``.to()``, ``load_state_dict`` with
        ``assign``) or changed in place (``load_state_dict``): the eval
        statistics are fixed, so a forward launches no fold kernels."""
        bn = self.bn
        tensors = (bn.scale, bn.bias, bn.mean, bn.var)
        key = tuple(id(t) for t in tensors) + tuple(t._version for t in tensors)
        fold = self._fold
        if fold is None or fold[1] != key:
            # Normal tensors without autograd history, even when the first
            # forward runs under inference_mode. The cache holds `tensors`
            # so their ids stay unique while it lives.
            with torch.inference_mode(False), torch.no_grad():
                fold = (tensors, key, *bn.fold())
            self._fold = fold
        return fold[2], fold[3]

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        _eval_only(self)
        scale, shift = self.folded_bn()
        return tap_conv.conv2d_fused(
            x, self.conv["w"], scale, shift, residual, self.stride, self.relu
        )


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` of shape (d, features)."""

    def __init__(self, in_features: int, features: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        w = _he_normal((in_features, features), in_features, generator)
        self.w = nn.Parameter(w.to(device))
        self.b = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class GlobalAvgPool(nn.Module):
    """Mean over H and W: (N, H, W, C) → (N, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2))
