"""Neural-network layers of the port as ``torch.nn.Module``s, NHWC
activations and HWIO conv weights as in the JAX package."""

from parallel_cnn_tpu_torch.nn.core import Sequential  # noqa: F401
from parallel_cnn_tpu_torch.nn.layers import (  # noqa: F401
    BatchNorm,
    ConvBNAct,
    Dense,
    GlobalAvgPool,
)
