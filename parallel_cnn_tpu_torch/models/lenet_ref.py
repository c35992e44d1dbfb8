"""The reference LeNet-style model as a params tree of tensors (the port's
``parallel_cnn_tpu/models/lenet_ref.py``).

≙ the four global `Layer` objects (Sequential/Main.cpp:17-20): conv 6
filters 5×5 → (6, 24, 24); trainable pool, one shared 4×4 kernel at
stride 4 → (6, 6, 6); dense 216→10. The tree and its layouts are the JAX
package's, so checkpoints and parity tests line up leaf for leaf.

Init contract (Sequential/layer.h:48-54): weights AND biases uniform on
[−0.5, 0.5), drawn from an explicit ``torch.Generator``. The draws differ
from ``jax.random``'s for the same seed; distribution parity is the
contract.
"""

from __future__ import annotations

from typing import Dict

import torch

from parallel_cnn_tpu_torch.utils.tree import tree_leaves

Params = Dict[str, Dict[str, torch.Tensor]]

SHAPES = {
    "c1": {"w": (6, 5, 5), "b": (6,)},
    "s1": {"w": (4, 4), "b": ()},
    "f": {"w": (10, 216), "b": (10,)},
}


def init(generator: torch.Generator, dtype=torch.float32) -> Params:
    """U(−0.5, 0.5) init for every weight and bias (layer.h:48-54), on the
    generator's device, one draw per leaf in the tree's flatten order."""
    dev = generator.device
    return {
        layer: {
            k: torch.rand(SHAPES[layer][k], generator=generator, dtype=dtype,
                          device=dev) - 0.5
            for k in sorted(SHAPES[layer])
        }
        for layer in sorted(SHAPES)
    }


def num_params(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
