"""Layers of the port, NHWC (the port's counterpart of
``parallel_cnn_tpu/nn/layers.py``).

Train and eval follow the JAX package's ``apply(..., train=...)``, read
from the module's ``training`` flag:

- ``BatchNorm`` in training mode normalises with the batch's statistics
  (mean and **biased** variance over N, H, W, in f32 for a bf16 input)
  and updates its running statistics in place as
  ``0.9·old + 0.1·batch``, as JAX's BatchNorm does; in eval mode it uses
  the running statistics. The normalisation itself runs in the input's
  dtype (bf16 under the zoo's bf16 cast), in JAX's order. It is not
  ``nn.BatchNorm2d``: that keeps an unbiased running variance and reads
  its momentum the other way round. Under ``running_stats_frozen`` a
  training-mode forward still normalises with the batch's statistics but
  leaves the running ones alone: the pipeline's backward recomputes a
  stage whose forward tick already updated them (JAX's recompute throws
  its new state away).
- ``ConvBNAct`` in training mode runs JAX's unfused composition: conv
  (``ops.tap_conv.conv2d``, whose backward is the dgrad and wgrad kernels)
  → BatchNorm → (+ residual) → optional ReLU. In eval mode with the
  ``"cuda"`` backend it folds BN, once, into a per-channel scale/shift
  that rides the conv kernel's epilogue (``ops.tap_conv.conv2d_fused``)
  together with the residual add and the ReLU.

Conv backends: ``"cuda"`` is the port's name for JAX's ``"pallas"`` (every
conv through the hand kernels; their plain versions for CPU tensors);
``"torch"`` is its name for ``"xla"`` (a library conv, which the JAX
package also leaves to its compiler).

Parameters are created on the CPU from an explicit ``torch.Generator``
(He-normal conv and Dense weights, BN at identity) and moved to
``device``. Layouts match the JAX package: conv weights HWIO
``(k, k, Cin, Cout)``, Dense ``w`` as ``(d, features)``.

On a mesh (``sharding`` set by parallel/zoo_sharding.py; nn/core.py has
the rule): in training mode ``BatchNorm`` takes the statistics of the
global batch, in two passes as ``jnp.var`` does (Σx and the count give the
mean, then Σ(x − mean)² the biased variance, each summed over the data
axis by an all-reduce whose backward all-reduces the gradient), and
updates its running statistics from them; ``Conv2D``, ``ConvBNAct`` and
``Dense`` take a whole input and compute their own block of output
features when their leaves are split over the model axis.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
from torch import nn

import torch.nn.functional as F

from parallel_cnn_tpu_torch.config import CONV_BACKENDS
from parallel_cnn_tpu_torch.nn.core import Sharding, whole
from parallel_cnn_tpu_torch.ops import tap_conv
from parallel_cnn_tpu_torch.parallel import collectives


def _he_normal(shape, fan_in: int, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)


def _conv_fn(backend: str):
    """The SAME conv of a backend: the kernels' autograd Function, or the
    library conv."""
    if backend not in CONV_BACKENDS:
        raise ValueError(f"unknown conv backend {backend!r}; one of {CONV_BACKENDS}")
    return tap_conv.conv2d if backend == "cuda" else tap_conv.conv2d_plain


class _Sharded(nn.Module):
    """A layer that needs every input channel and may compute a block of
    its output features (``sharding.split``)."""

    sharding: Optional[Sharding] = None

    def forward_split(self, x: torch.Tensor, split: bool):
        sh = self.sharding
        return self(whole(x, split, sh.split, sh.model)), sh.split


def _global_stats(x: torch.Tensor, data):
    """(mean, biased variance) over every axis but the last, of the batch
    whose rows lie on the ranks of ``data``: two passes, each sum
    all-reduced (the ranks hold equal row counts)."""
    axes = tuple(range(x.dim() - 1))
    count = x.numel() // x.shape[-1] * data.size
    mean = collectives.all_reduce(x.sum(dim=axes), data) / count
    d = x - mean
    var = collectives.all_reduce((d * d).sum(dim=axes), data) / count
    return mean, var


class BatchNorm(nn.Module):
    """Batch norm over the last (channel) axis. ``scale``/``bias`` are the
    trainables, ``mean``/``var`` the running statistics, as in the JAX
    tree."""

    sharding: Optional[Sharding] = None
    #: False under ``running_stats_frozen``.
    update_stats: bool = True

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 *, device=None):
        super().__init__()
        self.momentum = momentum
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
        if self.training:
            # The statistics are f32 for a bf16 x (JAX takes them of
            # x.astype(f32)); an f32 or f64 x is taken as it is.
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            sh = self.sharding
            if sh is not None and sh.data is not None:
                mean, var = _global_stats(xf, sh.data)
            else:
                axes = tuple(range(x.dim() - 1))
                mean = xf.mean(dim=axes)
                var = xf.var(dim=axes, unbiased=False)
            if self.update_stats:
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        # inv in f32 (from a bf16 scale under the bf16 cast), then JAX's
        # elementwise order in x's dtype: subtract, multiply, add. Each
        # operand is cast explicitly: PyTorch would promote the product of
        # bf16 x and a (C,) f32 tensor to f32.
        inv = torch.rsqrt(var + self.eps) * self.scale
        dt = x.dtype
        return (x - mean.to(dt)) * inv.to(dt) + self.bias.to(dt)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module) -> Iterator[None]:
    """Every BatchNorm under ``module`` keeps its running statistics as
    they are for the duration (training mode still normalises with the
    batch's statistics)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


class Conv2D(_Sharded):
    """SAME conv with an optional bias (``w`` HWIO, ``b``), as JAX's
    ``Conv2D(features, kernel, strides, use_bias, backend)``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True, backend: str = "torch",
                 *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.stride = stride
        self.backend = backend
        self._conv = _conv_fn(backend)
        w = _he_normal((kernel, kernel, in_features, features),
                       kernel * kernel * in_features, generator)
        self.w = nn.Parameter(w.to(device))
        self.b = (nn.Parameter(torch.zeros(features, device=device))
                  if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(x, self.w, self.stride)
        return y if self.b is None else y + self.b


class ConvBNAct(_Sharded):
    """SAME conv (no bias) → BatchNorm → (+ residual) → optional ReLU.

    ``forward(x, residual=sc)`` computes ``relu?(bn(conv(x)) + sc)``. In
    training mode that is the unfused composition with batch statistics;
    in eval mode on the ``"cuda"`` backend it is one kernel launch, the
    folded BN, the residual add and the ReLU running on the conv's f32
    accumulator before its only store (on a CPU tensor, the kernel's plain
    version)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int = 3,
        stride: int = 1,
        relu: bool = True,
        eps: float = 1e-5,
        backend: str = "cuda",
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
        self.backend = backend
        self._conv = _conv_fn(backend)
        w = _he_normal((kernel, kernel, in_features, features),
                       kernel * kernel * in_features, generator)
        self.conv = nn.ParameterDict({"w": nn.Parameter(w.to(device))})
        self.bn = BatchNorm(features, eps=eps, device=device)
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
        if not self.training and self.backend == "cuda":
            scale, shift = self.folded_bn()
            return tap_conv.conv2d_fused(
                x, self.conv["w"], scale, shift, residual, self.stride, self.relu
            )
        y = self.bn(self._conv(x, self.conv["w"], self.stride))
        if residual is not None:
            y = y + residual
        return torch.relu(y) if self.relu else y


class Dense(_Sharded):
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


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)


def _pool_pads(x: torch.Tensor, window: int, stride: int, padding: str):
    """F.pad's (left, right, top, bottom) for a pool over NHWC ``x``: none
    for VALID, XLA's SAME split (the odd cell after) for SAME."""
    if padding == "VALID":
        return (0, 0, 0, 0)
    _, pt, pb = tap_conv.same_pads(int(x.shape[1]), window, stride)
    _, pl, pr = tap_conv.same_pads(int(x.shape[2]), window, stride)
    return (pl, pr, pt, pb)


class _Pool(nn.Module):
    """Window, stride and padding ("VALID" or "SAME", XLA's split) of a
    square pool over H and W, as JAX's ``MaxPool``/``AvgPool`` hold them."""

    def __init__(self, window: int = 2, stride: int = 2, padding: str = "VALID"):
        super().__init__()
        if padding not in ("VALID", "SAME"):
            raise ValueError(f"pool padding must be VALID or SAME, got {padding!r}")
        self.window = window
        self.stride = stride
        self.padding = padding


class MaxPool(_Pool):
    """Max pool over H and W, window 2×2 and stride 2, VALID, by default (the
    CIFAR CNN's); SAME pads with −inf, XLA's odd cell after (the ImageNet
    stem's 3×3/s2 pool takes 112 to 56 from windows starting at rows 0, 2,
    …, where ``F.max_pool2d(padding=1)`` would start them at −1). Its
    gradient goes to the first maximum of a window in row-major order, as
    XLA's select-and-scatter routes it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _pool_pads(x, self.window, self.stride, self.padding)
        xn = x.permute(0, 3, 1, 2)
        if any(pads):
            xn = F.pad(xn, pads, value=float("-inf"))
        y = F.max_pool2d(xn, self.window, self.stride)
        return y.permute(0, 2, 3, 1)


class AvgPool(_Pool):
    """Mean pool over H and W (JAX's ``AvgPool``): VALID divides each
    window's sum by window², SAME by the count of the window's cells that
    lie inside the input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _pool_pads(x, self.window, self.stride, self.padding)
        xn = F.pad(x.permute(0, 3, 1, 2), pads)
        sums = F.avg_pool2d(xn, self.window, self.stride, divisor_override=1)
        if self.padding == "SAME":
            ones = F.pad(x.new_ones((1, 1) + tuple(x.shape[1:3])), pads)
            counts = F.avg_pool2d(ones, self.window, self.stride, divisor_override=1)
            y = sums / counts
        else:
            y = sums / (self.window * self.window)
        return y.permute(0, 2, 3, 1)


class Flatten(nn.Module):
    """(N, H, W, C) → (N, H·W·C) in (y, x, c) order."""

    sharding: Optional[Sharding] = None

    def forward_split(self, x: torch.Tensor, split: bool):
        return self(whole(x, split, False, self.sharding.model)), False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)
