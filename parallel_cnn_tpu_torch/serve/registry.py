"""Model registry: name → a uniform inference handle (the port's
counterpart of ``parallel_cnn_tpu/serve/registry.py``).

``conv_backend="cuda"`` is the port's counterpart of the JAX package's
``"pallas"``: every conv runs through the hand-written tap-conv kernel
(``ops/tap_conv.py``, ``csrc/tap_conv.cu``) with BN, residual and ReLU
fused into its epilogue, and through that kernel's plain PyTorch version
when the model lives on the CPU. JAX's unfused ``"xla"`` backend, and the
``lenet_ref``, ``cifar_cnn``, ``vgg16`` and ``resnet50`` handles, come
with later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from parallel_cnn_tpu_torch.config import SERVE_MODELS

#: Conv kernel libraries the port has: "cuda" is the counterpart of JAX's
#: "pallas" (hand kernels with fused eval epilogues).
CONV_BACKENDS = ("cuda",)


@dataclasses.dataclass(frozen=True)
class ModelHandle:
    """Uniform inference surface over one model family member.

    - ``build(generator)`` — a fresh model on the CPU in eval mode, its
      weights drawn from ``generator``; also the restore template for
      checkpoint loading.
    - ``forward(model, x)`` — batched forward ``(n, *in_shape) →
      (n, n_outputs)`` on ``x``'s device; callers wrap it in
      ``torch.inference_mode()``.
    - ``in_shape`` — per-sample input shape (no batch dim), NHWC.
    """

    name: str
    in_shape: Tuple[int, ...]
    n_outputs: int
    build: Callable[[Optional[torch.Generator]], nn.Module]

    def init(self, seed: int = 0) -> nn.Module:
        """A fresh model from ``seed`` (on the CPU, eval mode)."""
        return self.build(torch.Generator().manual_seed(seed))

    @staticmethod
    def forward(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return model(x)


def available() -> Tuple[str, ...]:
    return SERVE_MODELS


def get(name: str, conv_backend: str = "cuda") -> ModelHandle:
    """Handle for a registered model name."""
    from parallel_cnn_tpu_torch.nn import cifar, resnet

    if conv_backend not in CONV_BACKENDS:
        raise ValueError(
            f"unknown conv backend {conv_backend!r}; ported: {CONV_BACKENDS}"
        )
    zoo: Dict[str, Callable] = {
        "resnet18": resnet.resnet18,
        "resnet34": resnet.resnet34,
    }
    if name not in zoo:
        raise KeyError(
            f"unknown model {name!r}; registered: {', '.join(available())}"
        )
    factory = zoo[name]

    def build(generator: Optional[torch.Generator]) -> nn.Module:
        return factory(cifar.NUM_CLASSES, generator=generator).eval()

    return ModelHandle(name, cifar.IN_SHAPE, cifar.NUM_CLASSES, build)
