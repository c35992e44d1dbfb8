"""Sequential combinator and mesh placement (the port's counterpart of
``parallel_cnn_tpu/nn/core.py``).

JAX's modules are values with ``init``/``apply`` over separate params and
state trees; here a layer is a ``torch.nn.Module`` that owns its
parameters (trainables) and buffers (BatchNorm running statistics).
JAX's ``apply(..., train=...)`` is the module's ``training`` flag, which
``.train()``/``.eval()`` set for every child, and the new BN state JAX
threads out of ``apply`` is written into the buffers in place. The
module tree is named like the JAX pytree — a Sequential's children are
``0``, ``1``, …, a residual block's are ``main.0``, ``main.1``,
``proj.0`` — so a JAX tree path ``3/main/0/conv/w`` is the state_dict key
``3.main.0.conv.w`` (see convert.py).

On a mesh. Under JAX's GSPMD one program runs over the whole batch and
XLA places the collectives; the port runs one process per rank, and
parallel/zoo_sharding.py sets each layer's ``sharding``: BatchNorm sums
its statistics over the data axis, and a layer whose leaves split over the
model axis computes its own block of output features. An activation is
then *split* (each rank holds its block of channels) or whole; a layer
that needs every input channel (a conv, a Dense, Flatten) takes
``whole(x, ...)`` first, and channelwise layers (BatchNorm, ReLU, the
pools) keep the activation as it comes. ``forward_split(layer, x, split)``
is that rule for one layer. Without a sharding a module runs exactly as
it does off the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn

from parallel_cnn_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a layer runs on one rank of a (data, model) mesh: BatchNorm's
    statistics over the ``data`` axis (None: the rank's rows), the
    ``model`` axis (None: none), and whether the layer's output features
    are ``split`` over it."""

    data: Any = None
    model: Any = None
    split: bool = False


def whole(x: torch.Tensor, split: bool, consumer_split: bool,
          model) -> torch.Tensor:
    """``x`` with every channel, as a consumer needs it. A split ``x`` is
    all-gathered; the adjoint is chosen by the consumer: one split over the
    model axis yields a partial gradient on each rank, to be summed and
    sliced, a replicated one the whole gradient, to be sliced. A whole
    ``x`` feeding a split consumer has its gradient summed over the axis."""
    if model is None or not (split or consumer_split):
        return x
    if split:
        return collectives.gather_last(x, model, partial=consumer_split)
    return collectives.sum_grad(x, model)


def forward_split(layer: nn.Module, x: torch.Tensor,
                  split: bool) -> Tuple[torch.Tensor, bool]:
    """(``layer``'s output, whether it is split over the model axis) for an
    input that is split or not; a layer without ``forward_split`` is
    channelwise and keeps its input's layout."""
    f = getattr(layer, "forward_split", None)
    if f is not None:
        return f(x, split)
    return layer(x), split


class Sequential(nn.Sequential):
    """Compose modules; children are named by their index."""

    sharding: Optional[Sharding] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sharding is None:
            return super().forward(x)
        x, split = self.forward_split(x, False)
        return whole(x, split, False, self.sharding.model)

    def forward_split(self, x: torch.Tensor, split: bool,
                      stop: Optional[int] = None) -> Tuple[torch.Tensor, bool]:
        """The children up to ``stop`` (all by default) on a mesh."""
        for layer in list(self)[:stop]:
            x, split = forward_split(layer, x, split)
        return x, split
