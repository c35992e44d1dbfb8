"""Activation and loss-gradient utilities (the port's
``parallel_cnn_tpu/ops/activations.py``; ≙ Sequential/layer.h:81-101).

The reference's "step_function" is a logistic sigmoid; ``makeError`` gives
the (onehot − output) error vector fed straight into backprop as
d_preact; ``apply_grad`` is the `w += dt * g` SGD step.
"""

from __future__ import annotations

import torch

from parallel_cnn_tpu_torch.utils.tree import tree_map


def sigmoid(v: torch.Tensor) -> torch.Tensor:
    """≙ step_function (Sequential/layer.h:81-83): 1/(1+exp(−v))."""
    return torch.sigmoid(v)


def sigmoid_grad_from_preact(preact: torch.Tensor) -> torch.Tensor:
    """σ′(preact) = σ·(1−σ), recomputed from preact as the reference's
    backward kernels do (e.g. bp_preact_s1, Sequential/layer.h:265-266)."""
    s = torch.sigmoid(preact)
    return s * (1.0 - s)


def make_error(output: torch.Tensor, label: torch.Tensor,
               num_classes: int = 10) -> torch.Tensor:
    """≙ makeError (Sequential/layer.h:91-95): onehot(label) − output over
    the last axis. A label outside [0, num_classes) has an all-zero one-hot,
    as ``jax.nn.one_hot`` gives it."""
    classes = torch.arange(num_classes, device=output.device)
    onehot = (label.unsqueeze(-1) == classes).to(output.dtype)
    return onehot - output


def error_norm(err: torch.Tensor) -> torch.Tensor:
    """≙ vectorNorm (Sequential/Main.cpp:28-34): ‖err‖₂ over the last axis."""
    return torch.sqrt(torch.sum(err * err, dim=-1))


def apply_grad(params, grads, dt: float):
    """≙ apply_grad (Sequential/layer.h:97-101): p += dt·g over a tree (new
    tensors; the inputs are left as they are)."""
    return tree_map(lambda p, g: p + dt * g, params, grads)
