"""Train steps of the LeNet-ref trainer (the port of
``parallel_cnn_tpu/train/step.py``; ≙ the body of learn(),
Sequential/Main.cpp:146-184).

- **Strict parity** (``scan_epoch`` / ``sgd_step``): batch size 1, weights
  updated after every sample — the reference's exact trajectory. JAX runs
  the epoch as one ``lax.scan``; here it is a loop of per-sample steps over
  device-resident images.
- **Throughput** (``batched_step`` and its variants): per-sample reference
  grads averaged over the batch, one update per batch.

Each step takes params and returns new params (the inputs are left as
they are) and the step's mean error as a 0-d tensor on the device; nothing
here reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from parallel_cnn_tpu_torch.ops import lenet_fused, reference, sgd_update
from parallel_cnn_tpu_torch.ops.activations import apply_grad
from parallel_cnn_tpu_torch.utils.tree import tree_map

Params = reference.Params
Step = Callable[[Params, torch.Tensor, torch.Tensor, float], Tuple[Params, torch.Tensor]]


def local_grad_sums(params: Params, x: torch.Tensor, y: torch.Tensor,
                    ops_path: str = "reference") -> Tuple[torch.Tensor, Params]:
    """Reference-contract grads SUMMED over a batch: (err_sum, grad_sums).

    ``ops_path="cuda"`` computes them in the fused train-step kernel
    (ops/lenet_fused.py), which gives the batch mean; it is scaled back to
    a sum here, as the JAX package does for its Pallas kernel.
    """
    if ops_path == "cuda":
        n = x.shape[0]
        err_mean, mean_grads = lenet_fused.fused_value_and_ref_grads(params, x, y)
        return err_mean * n, tree_map(lambda g: g * n, mean_grads)
    errs, grads = reference.batched_value_and_ref_grads(params, x, y)
    return torch.sum(errs), tree_map(lambda g: torch.sum(g, dim=0), grads)


def sgd_step(params: Params, x: torch.Tensor, y: torch.Tensor,
             dt: float) -> Tuple[Params, torch.Tensor]:
    """One per-sample step: forward → hand-written backward → p += dt·g
    (≙ one iteration of the loop at Sequential/Main.cpp:157-171)."""
    err, grads = reference.value_and_ref_grads(params, x, y)
    return apply_grad(params, grads, dt), err


def scan_epoch(params: Params, images: torch.Tensor, labels: torch.Tensor,
               dt: float) -> Tuple[Params, torch.Tensor]:
    """A full per-sample-SGD epoch (strict parity mode): (params, mean
    err-norm), the per-epoch metric of learn() (`err /= train_cnt`,
    Sequential/Main.cpp:173-174)."""
    errs = torch.empty((images.shape[0],), dtype=torch.float32,
                       device=images.device)
    for i in range(images.shape[0]):
        params, errs[i] = sgd_step(params, images[i], labels[i], dt)
    return params, torch.mean(errs)


def batched_step(params: Params, x: torch.Tensor, y: torch.Tensor,
                 dt: float) -> Tuple[Params, torch.Tensor]:
    """Minibatch step: per-sample reference grads, mean-reduced over the
    batch, p += dt·mean(g). x: (B, 28, 28), y: (B,)."""
    err_sum, grad_sums = local_grad_sums(params, x, y)
    n = x.shape[0]
    mean_grads = tree_map(lambda g: g / n, grad_sums)
    return apply_grad(params, mean_grads, dt), err_sum / n


def fused_batched_step(params: Params, x: torch.Tensor, y: torch.Tensor,
                       dt: float) -> Tuple[Params, torch.Tensor]:
    """`batched_step` with the fused bucket update: the same grad sums, and
    the per-leaf `p += dt·g` pass replaced by ONE sgd_update kernel per
    bucket (tree_sgd), with the batch mean in its scale (1/B) and the
    ascent convention as lr = −dt."""
    err_sum, grad_sums = local_grad_sums(params, x, y)
    n = x.shape[0]
    params = sgd_update.tree_sgd(params, grad_sums, lr=-dt, scale=1.0 / n)
    return params, err_sum / n


def cuda_batched_step(params: Params, x: torch.Tensor, y: torch.Tensor,
                      dt: float) -> Tuple[Params, torch.Tensor]:
    """`batched_step` on the fused train-step kernel (≙ the JAX package's
    `pallas_batched_step`): the step's forward, error and reference
    backward are one launch of csrc/lenet_fused.cu on a CUDA tensor."""
    err, mean_grads = lenet_fused.fused_value_and_ref_grads(params, x, y)
    return apply_grad(params, mean_grads, dt), err


def batched_step_fn(ops_path: str, fused: bool = False) -> Step:
    """The minibatch step for a TrainConfig.ops value. ``fused`` (the
    --fused-step switch) selects the bucketed update on the reference grad
    engine; the kernel path keeps its own update. There is no fallback:
    the kernel path launches its kernel or raises."""
    if ops_path != "cuda":
        return fused_batched_step if fused else batched_step
    return cuda_batched_step


def classify_batch(params: Params, x: torch.Tensor) -> torch.Tensor:
    """≙ classify() (Sequential/Main.cpp:186-200), batched: argmax of the
    10 sigmoid outputs."""
    return reference.predict(params, x)


def error_count(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Misclassification count on a batch (≙ test()'s error accumulation,
    Sequential/Main.cpp:202-211)."""
    return torch.sum(classify_batch(params, x) != y)
