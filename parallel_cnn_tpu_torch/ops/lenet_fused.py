"""The LeNet-ref train step's math (forward, error, reference backward,
batch mean) in one kernel launch.

The port's counterpart of ``fused_value_and_ref_grads`` in
``parallel_cnn_tpu/ops/pallas.py`` (TPU kernel ``_fused_kernel`` at
pallas.py:589). On a CUDA tensor ``fused_value_and_ref_grads`` launches
the hand kernel in ``csrc/lenet_fused.cu``; on a CPU tensor it runs the
plain PyTorch version beside it (``ops/reference.py``'s per-sample grads,
averaged). There is no other route: a CUDA call the kernel does not take
raises, and nothing falls back to the plain version on the card.

Contract (as pallas.py:762): ``xs`` (n, 28, 28) f32 and ``ys`` (n,) integer
labels give ``(err_mean, grads)`` with ``err_mean = Σ_b ‖onehot(y_b) −
out_f,b‖₂ / n`` and ``grads`` the batch MEAN of the per-sample reference
grads, in the params tree. The mean divides by the real n.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from parallel_cnn_tpu_torch.models.lenet_ref import SHAPES
from parallel_cnn_tpu_torch.ops import reference
from parallel_cnn_tpu_torch.ops._cuda_build import (
    Library,
    LaunchCounter,
    check_operand,
    launch_stream,
    raise_on_error,
)

Params = reference.Params

#: Leaves of the params tree in flatten order: the kernel's output layout.
LEAVES = (("c1", "b"), ("c1", "w"), ("f", "b"), ("f", "w"), ("s1", "b"), ("s1", "w"))
N_GRADS = 2343
ROW = N_GRADS + 1  # the grads, then err
#: One image's row of pass 1 in the workspace (s1, d_pre_f, err, the conv
#: and pool grads; csrc/lenet_fused.cu's ROW_PASS1).
ROW_PASS1 = 404

#: Launches of the fused train-step kernel (one per call on a CUDA tensor;
#: the call is two CUDA launches, the per-image pass and the batch sum).
launches = LaunchCounter()

_library = Library("lenet_fused.cu", {
    "lenet_fused_step": ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p],
                         ctypes.c_int),
    "lenet_fused_dim": ([ctypes.c_int], ctypes.c_int),
}, headers=("ffma_tile.cuh",))


def build() -> Library:
    """Compile (if needed) and load the kernel library; returns its record
    (``path``, ``build_seconds``, ``compiler_output``)."""
    _library.get()
    return _library


def fused_value_and_ref_grads_plain(params: Params, xs: torch.Tensor,
                                    ys: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Plain version: per-sample reference grads (ops/reference.py), summed
    over the batch and multiplied by 1/n, as the kernel finishes them."""
    n = xs.shape[0]
    errs, grads = reference.batched_value_and_ref_grads(params, xs, ys)
    inv_n = 1.0 / n
    mean = {layer: {k: g.sum(0) * inv_n for k, g in leaves.items()}
            for layer, leaves in grads.items()}
    return errs.sum() * inv_n, mean


def _unflatten(flat: torch.Tensor) -> Params:
    grads: Params = {}
    off = 0
    for layer, name in LEAVES:
        shape = SHAPES[layer][name]
        size = 1
        for d in shape:
            size *= d
        grads.setdefault(layer, {})[name] = flat[off:off + size].view(shape)
        off += size
    return grads


def _launch(params: Params, xs: torch.Tensor,
            ys: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    if xs.dim() != 3 or tuple(xs.shape[1:]) != (28, 28) or xs.shape[0] < 1:
        raise ValueError(f"xs must be (n, 28, 28) with n >= 1, got {tuple(xs.shape)}")
    n = int(xs.shape[0])
    if n > 2**31 - 1:
        raise ValueError(f"batch of {n} images exceeds the kernel's int32 grid")
    dev = xs.device
    check_operand("xs", xs, dev, (n, 28, 28), torch.float32)
    if ys.dtype == torch.int64:
        ys = ys.to(torch.int32)  # once per call; the kernel reads int32
    check_operand("ys", ys, dev, (n,), torch.int32)
    for layer, name in LEAVES:
        check_operand(f"{layer}/{name}", params[layer][name], dev,
                      SHAPES[layer][name], torch.float32)
    lib = _library.get()
    if (lib.lenet_fused_dim(0), lib.lenet_fused_dim(1)) != (ROW, ROW_PASS1):
        raise RuntimeError("csrc/lenet_fused.cu and its wrapper disagree on the row widths")
    with torch.cuda.device(dev):
        # One allocation: the (n, ROW_PASS1) workspace, then the output row.
        buf = torch.empty((n * ROW_PASS1 + ROW,), device=dev, dtype=torch.float32)
        workspace, out = buf[:n * ROW_PASS1], buf[n * ROW_PASS1:]
        p = {key: params[key[0]][key[1]].data_ptr() for key in LEAVES}
        err = lib.lenet_fused_step(
            xs.data_ptr(), ys.data_ptr(),
            p["c1", "w"], p["c1", "b"], p["s1", "w"], p["s1", "b"],
            p["f", "w"], p["f", "b"],
            workspace.data_ptr(), out.data_ptr(), n, launch_stream(dev),
        )
    raise_on_error("lenet_fused", err)
    launches.add()
    return out[N_GRADS], _unflatten(out)


def fused_value_and_ref_grads(params: Params, xs: torch.Tensor,
                              ys: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """(err_mean, batch-mean reference grads) of a batch: one kernel launch
    on a CUDA tensor, the plain version on a CPU tensor."""
    if xs.device.type == "cpu":
        return fused_value_and_ref_grads_plain(params, xs, ys)
    if xs.device.type != "cuda":
        raise ValueError(f"lenet_fused runs on cuda or cpu tensors, got {xs.device}")
    return _launch(params, xs, ys)
