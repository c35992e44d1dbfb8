"""Neural-network layers of the port as ``torch.nn.Module``s, NHWC
activations and HWIO conv weights as in the JAX package."""

from parallel_cnn_tpu_torch.nn.core import Sequential  # noqa: F401
from parallel_cnn_tpu_torch.nn.layers import (  # noqa: F401
    AvgPool,
    BatchNorm,
    Conv2D,
    ConvBNAct,
    Dense,
    Flatten,
    GlobalAvgPool,
    MaxPool,
    ReLU,
)
from parallel_cnn_tpu_torch.nn import cifar, resnet, vgg  # noqa: F401,E402
