"""JAX's initialisation of a zoo model, drawn with numpy (torch-free, JAX
only for the tree's shape).

``module.init`` (``parallel_cnn_tpu/nn/layers.py``) draws every weight as
He-normal over its fan-in and sets biases to 0 and BatchNorm to γ = 1,
β = 0, mean 0, var 1. Run eagerly on the CPU it compiles each initializer
at each shape (about 14 s for ResNet-50, 6 s for VGG-16). ``jax_init``
takes the tree from ``jax.eval_shape``, which compiles nothing, and draws
the same distribution from a numpy generator."""

import jax
import numpy as np


def jax_init(module, in_shape, seed):
    """(params, state) as numpy trees with JAX's init distribution."""
    params, state = jax.eval_shape(
        lambda: module.init(jax.random.key(0), in_shape)[:2])
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "w":  # (kh, kw, cin, cout) or (d, features)
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(s.dtype)
        if name in ("scale", "var"):
            return np.ones(s.shape, s.dtype)
        assert name in ("b", "bias", "mean"), name
        return np.zeros(s.shape, s.dtype)

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map_with_path(leaf, state))
