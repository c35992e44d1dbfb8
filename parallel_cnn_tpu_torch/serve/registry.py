"""Model registry: name → a uniform inference handle (the port's
counterpart of ``parallel_cnn_tpu/serve/registry.py``).

``conv_backend="cuda"`` is the port's counterpart of the JAX package's
``"pallas"``: every conv runs through the hand-written tap-conv kernel
(``ops/tap_conv.py``, ``csrc/tap_conv.cu``) with BN, residual and ReLU
fused into its epilogue, and through that kernel's plain PyTorch version
when the model lives on the CPU. VGG-16's convs carry a bias and are
followed by a separate BatchNorm, as in JAX: its convs run through the same
kernel without an epilogue. ``conv_backend="xla"`` is JAX's unfused
``"xla"``: library convs (cuDNN on the card, TF32 off; the trainer's
``"torch"``). As in JAX, only the resnet and vgg families take ``"cuda"``:
``cifar_cnn`` runs library convs and ``lenet_ref`` the plain reference
forward of ``ops/reference.py``, with no kernel, as JAX serves it. Every
zoo handle takes the CIFAR shape, as JAX's registry builds them
(``resnet50(10, cifar_stem=True)``, ``vgg16(10)``); ``lenet_ref`` takes
(28, 28).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from parallel_cnn_tpu_torch.config import SERVE_CONV_BACKENDS, SERVE_MODELS

#: Conv kernels the server has: "cuda" (hand kernels with fused eval
#: epilogues, JAX's "pallas") and "xla" (library convs).
CONV_BACKENDS = SERVE_CONV_BACKENDS
#: The families "cuda" applies to.
KERNEL_MODELS = ("resnet18", "resnet34", "resnet50", "vgg16")


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
    - ``load(path, model)`` — fill ``model`` from a JAX-written
      checkpoint; None takes ``convert.load_jax_checkpoint``.
    """

    name: str
    in_shape: Tuple[int, ...]
    n_outputs: int
    build: Callable[[Optional[torch.Generator]], nn.Module]
    load: Optional[Callable[[str, nn.Module], nn.Module]] = None

    def init(self, seed: int = 0) -> nn.Module:
        """A fresh model from ``seed`` (on the CPU, eval mode)."""
        return self.build(torch.Generator().manual_seed(seed))

    @staticmethod
    def forward(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return model(x)


class LeNetRef(nn.Module):
    """The LeNet-ref params tree as a module, so an engine can copy it to a
    device: layer ``c1``'s ``w`` is the buffer ``c1.w``. Its forward is
    the plain reference forward (``ops/reference.py``), the network's
    output σ(pre_f) per sample."""

    def __init__(self, params):
        super().__init__()
        for layer in sorted(params):
            m = nn.Module()
            for k in sorted(params[layer]):
                m.register_buffer(k, params[layer][k])
            self.add_module(layer, m)

    def params(self):
        return {layer: dict(m.named_buffers()) for layer, m in self.named_children()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from parallel_cnn_tpu_torch.ops import reference

        return reference.forward(self.params(), x).out_f


def _load_lenet(path: str, model: LeNetRef) -> LeNetRef:
    """Both of JAX's dialects, as its ``load_or_init`` reads them: a bare
    params tree (the LeNet trainer's) or a wrapped ZooState."""
    from parallel_cnn_tpu_torch.convert import lenet_from_jax, load_jax_checkpoint
    from parallel_cnn_tpu_torch.train.checkpoint import _read_arrays, _reject_sharded
    from parallel_cnn_tpu_torch.utils.tree import tree_paths

    stored, meta = _read_arrays(path)
    _reject_sharded(path, meta, "serve")
    keys = tree_paths(model.params())
    if not all(k in stored for k in keys):
        return load_jax_checkpoint(path, model)
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for k in keys:
        layer, leaf = k.split("/")
        tree.setdefault(layer, {})[leaf] = stored[k]
    model.load_state_dict({f"{layer}.{leaf}": t for layer, leaves
                           in lenet_from_jax(tree).items() for leaf, t in leaves.items()})
    return model


def available() -> Tuple[str, ...]:
    return SERVE_MODELS


def get(name: str, conv_backend: Optional[str] = None) -> ModelHandle:
    """Handle for a registered model name. ``conv_backend`` applies to the
    resnet/vgg families; ``lenet_ref`` and ``cifar_cnn`` take "xla" (or
    None), as in JAX. None picks "cuda" where it applies."""
    from parallel_cnn_tpu_torch.models import lenet_ref
    from parallel_cnn_tpu_torch.nn import cifar, resnet, vgg

    if conv_backend is not None and conv_backend not in CONV_BACKENDS:
        raise ValueError(
            f"unknown conv backend {conv_backend!r}; ported: {CONV_BACKENDS}"
        )
    if name not in SERVE_MODELS:
        raise KeyError(
            f"unknown model {name!r}; registered: {', '.join(available())}"
        )
    if name not in KERNEL_MODELS:
        if conv_backend not in (None, "xla"):
            raise ValueError(
                f"conv_backend={conv_backend!r} applies to the resnet/vgg models"
            )
        if name == "lenet_ref":
            return ModelHandle(
                name, (28, 28), 10,
                lambda g: LeNetRef(lenet_ref.init(g)).eval(), load=_load_lenet)
        return ModelHandle(
            name, cifar.IN_SHAPE, cifar.NUM_CLASSES,
            lambda g: cifar.cifar_cnn(generator=g).eval())
    backend = "torch" if conv_backend == "xla" else "cuda"
    zoo: Dict[str, Callable] = {
        "resnet18": resnet.resnet18,
        "resnet34": resnet.resnet34,
        "resnet50": lambda n, **kw: resnet.resnet50(n, cifar_stem=True, **kw),
        "vgg16": vgg.vgg16,
    }
    factory = zoo[name]

    def build(generator: Optional[torch.Generator]) -> nn.Module:
        return factory(cifar.NUM_CLASSES, backend=backend,
                       generator=generator).eval()

    return ModelHandle(name, cifar.IN_SHAPE, cifar.NUM_CLASSES, build)
