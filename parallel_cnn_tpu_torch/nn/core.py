"""Sequential combinator (the port's counterpart of
``parallel_cnn_tpu/nn/core.py``).

JAX's modules are values with ``init``/``apply`` over separate params and
state trees; here a layer is a ``torch.nn.Module`` that owns its
parameters (trainables) and buffers (BatchNorm running statistics). The
module tree is named like the JAX pytree — a Sequential's children are
``0``, ``1``, …, a residual block's are ``main.0``, ``main.1``,
``proj.0`` — so a JAX tree path ``3/main/0/conv/w`` is the state_dict key
``3.main.0.conv.w`` (see convert.py).
"""

from __future__ import annotations

from torch import nn


class Sequential(nn.Sequential):
    """Compose modules; children are named by their index."""
