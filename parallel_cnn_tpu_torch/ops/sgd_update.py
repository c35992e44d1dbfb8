"""Fused SGD update over 1-D gradient buckets (the port of ``fused_sgd``
and ``tree_sgd`` in ``parallel_cnn_tpu/ops/pallas_update.py``, TPU kernel
``_sgd_kernel`` at pallas_update.py:54).

    fused_sgd:  p' = p − lr · (g · scale)

On a CUDA tensor ``fused_sgd`` launches the hand kernel in
``csrc/sgd_update.cu``, which rounds after each of the three operations
and so agrees bit for bit with the plain PyTorch version; on a CPU tensor
it runs that plain version. A CUDA call the kernel does not take raises.
``tree_sgd`` packs a params tree into ``parallel.collectives`` buckets and
runs one ``fused_sgd`` per bucket; the LeNet trainer's ascent convention
``p += dt·mean(g)`` is ``lr = −dt, scale = 1/n``
(train/step.py:fused_batched_step). ``fused_sgd_momentum`` joins it with
the zoo trainer.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from parallel_cnn_tpu_torch.ops._cuda_build import (
    Library,
    LaunchCounter,
    check_operand,
    launch_stream,
    raise_on_error,
)
from parallel_cnn_tpu_torch.parallel import collectives

#: Launches of the SGD kernel (one per bucket on a CUDA tensor).
launches = LaunchCounter()

_library = Library(
    "sgd_update.cu",
    {"sgd_update": ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float,
                                             ctypes.c_float, ctypes.c_void_p],
                    ctypes.c_int)},
    # The source rounds each op with intrinsics; keep every other multiply
    # and add unfused as well.
    extra_flags=("-fmad=false",),
)


def build() -> Library:
    """Compile (if needed) and load the kernel library; returns its record
    (``path``, ``build_seconds``, ``compiler_output``)."""
    _library.get()
    return _library


def fused_sgd_plain(p: torch.Tensor, g: torch.Tensor, lr: float,
                    scale: float = 1.0) -> torch.Tensor:
    """Plain version: three elementwise ops, each rounded to f32."""
    return p - lr * (g * scale)


def _launch(p: torch.Tensor, g: torch.Tensor, lr: float, scale: float) -> torch.Tensor:
    dev = p.device
    n = int(p.shape[0])
    check_operand("p", p, dev, (n,), torch.float32)
    check_operand("g", g, dev, (n,), torch.float32)
    lib = _library.get()
    with torch.cuda.device(dev):
        out = torch.empty_like(p)
        err = lib.sgd_update(p.data_ptr(), g.data_ptr(), out.data_ptr(), n,
                             float(lr), float(scale), launch_stream(dev))
    raise_on_error("sgd_update", err)
    launches.add()
    return out


def fused_sgd(p: torch.Tensor, g: torch.Tensor, *, lr: float,
              scale: float = 1.0) -> torch.Tensor:
    """p − lr·(g·scale) for 1-D f32 buffers of equal length, one kernel."""
    if p.shape != g.shape or p.dim() != 1 or p.shape[0] == 0:
        raise ValueError(f"expected matching non-empty 1-D buffers, got "
                         f"{tuple(p.shape)} vs {tuple(g.shape)}")
    if p.device.type == "cpu":
        return fused_sgd_plain(p, g, lr, scale)
    if p.device.type != "cuda":
        raise ValueError(f"sgd_update runs on cuda or cpu tensors, got {p.device}")
    return _launch(p, g, lr, scale)


def tree_sgd(params, grads, *, lr: float, scale: float = 1.0,
             bucket_bytes: int = collectives.DEFAULT_BUCKET_BYTES):
    """Tree-wide fused SGD through the bucket machinery: the tree is packed
    into ``collectives.plan_buckets`` buckets, each updated by ONE
    ``fused_sgd``, and unpacked (the exact round trip)."""
    plan = collectives.plan_buckets(params, bucket_bytes, shards=1)
    pb = collectives.flatten_buckets(params, plan)
    gb = collectives.flatten_buckets(grads, plan)
    out: List[torch.Tensor] = [
        fused_sgd(p, g, lr=lr, scale=scale) for p, g in zip(pb, gb)
    ]
    return collectives.unflatten_buckets(out, plan)
