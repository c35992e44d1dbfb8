"""Data-parallel LeNet-ref training over the mesh's ``data`` axis (the port
of ``parallel_cnn_tpu/parallel/data_parallel.py``).

JAX runs each step as one ``shard_map`` program over the mesh; here every
rank of a world that parallel/distributed.py started runs the same step on
its own rows of the global batch:

- each rank computes the reference-contract grads SUMMED over its rows
  (``train/step.py`` ``local_grad_sums``: the plain ops, or the fused
  train-step kernel, csrc/lenet_fused.cu, with ``ops_path="cuda"``),
- one all-reduce of the error sum and one of the grad tree over ``data``
  (``collectives.tree_all_reduce``: psum, or the bucketed ring, optionally
  bf16 on the wire), so every rank ends the step with the same params,
- the sums divided by the GLOBAL batch and applied as ``p += dt·g``.

Minibatch SGD: it cannot reproduce the reference's per-sample trajectory,
which stays on one device (train/step.py ``scan_epoch``).

A step takes this rank's rows (``mesh.shard_rows`` of the global batch,
JAX's ``P(DATA_AXIS)``) and the whole params, and returns new params and
the global batch's mean error, both the same on every rank. On a CUDA
tensor ``ops_path="cuda"`` launches the kernel or raises.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from parallel_cnn_tpu_torch.ops import reference
from parallel_cnn_tpu_torch.ops.activations import apply_grad
from parallel_cnn_tpu_torch.parallel import collectives
from parallel_cnn_tpu_torch.train.step import local_grad_sums
from parallel_cnn_tpu_torch.utils.tree import tree_map

Params = reference.Params
Step = Callable[[Params, torch.Tensor, torch.Tensor], Tuple[Params, torch.Tensor]]


def psum_scalar(t: torch.Tensor, axis) -> torch.Tensor:
    """JAX's ``psum`` of a 0-d tensor over ``axis`` (a new 0-d tensor)."""
    return collectives.all_reduce_sum(t.reshape(1).clone(), axis)[0]


def check_global_batch(local: int, n_data: int, global_batch: int) -> None:
    """A batch that does not match the global batch a step was built for
    would silently mis-scale the grad mean: ValueError."""
    if local * n_data != global_batch:
        raise ValueError(f"batch {local * n_data} != global_batch {global_batch}")


def _dp_update(params: Params, x: torch.Tensor, y: torch.Tensor, dt: float,
               global_batch: int, data_axis, ops_path: str = "reference",
               comm=None) -> Tuple[Params, torch.Tensor]:
    """One DP update on this rank's rows: local grad sums → the error sum
    and the grads all-reduced over ``data`` (``comm`` picks the algorithm;
    None is one psum) → ÷ global batch → ``p += dt·g``."""
    err_sum, grad_sum = local_grad_sums(params, x, y, ops_path)
    err_sum = psum_scalar(err_sum, data_axis)
    grad_sum = collectives.tree_all_reduce(grad_sum, data_axis, comm)
    mean_grads = tree_map(lambda g: g / global_batch, grad_sum)
    return apply_grad(params, mean_grads, dt), err_sum / global_batch


def make_dp_step(mesh, dt: float, global_batch: int, ops_path: str = "reference",
                 comm=None) -> Step:
    """The DP train step for a fixed global batch: ``step(params, x, y) ->
    (params, mean_err)`` with x (B/n, 28, 28) and y (B/n,) this rank's rows.
    ``comm`` (a ``config.CommConfig``) picks the gradient all-reduce; None
    is one psum."""
    axis = mesh.data

    def step(params: Params, x: torch.Tensor, y: torch.Tensor):
        check_global_batch(x.shape[0], axis.size, global_batch)
        return _dp_update(params, x, y, dt, global_batch, axis, ops_path, comm)

    return step


def make_dp_eval(mesh) -> Callable:
    """The sharded misclassification count: ``eval(params, x, y, mask)``
    classifies this rank's rows and sums the errors over ``data`` (≙ test(),
    Sequential/Main.cpp:202-211). ``mask`` marks the real rows, so a set
    padded to an even split (``mesh.pad_to_multiple``) never counts its
    pad rows. Returns a 0-d int64 tensor, the same on every rank."""
    axis = mesh.data

    def evaluate(params: Params, x: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        pred = reference.predict(params, x)
        count = torch.sum((pred != y) & mask.to(torch.bool)).to(torch.int64)
        return psum_scalar(count, axis)

    return evaluate


def make_dp_epoch(mesh, dt: float, global_batch: int) -> Callable:
    """A whole DP epoch over pre-sharded batches: ``epoch(params, images,
    labels) -> (params, mean_err)`` with images (S, B/n, 28, 28) and labels
    (S, B/n) this rank's rows of each step (JAX's ``P(None, DATA_AXIS)``);
    the reference ops and one psum a step, as in JAX (its ``lax.scan``)."""
    axis = mesh.data

    def epoch(params: Params, images: torch.Tensor, labels: torch.Tensor):
        check_global_batch(images.shape[1], axis.size, global_batch)
        errs = []
        for x, y in zip(images, labels):
            params, e = _dp_update(params, x, y, dt, global_batch, axis)
            errs.append(e)
        return params, torch.mean(torch.stack(errs))

    return epoch
