"""Fused SGD updates over 1-D gradient buckets (the port of
``parallel_cnn_tpu/ops/pallas_update.py``: ``fused_sgd`` and ``tree_sgd``
over TPU kernel ``_sgd_kernel`` at :54, ``fused_sgd_momentum`` and its
list form ``fused_sgd_momentum_buckets`` over ``_sgd_momentum_kernel`` at
:58).

    fused_sgd:           p' = p − lr · (g · scale)
    fused_sgd_momentum:  m' = β·m + g·scale;   p' = p − lr · m'

On a CUDA tensor each launches its hand kernel in ``csrc/sgd_update.cu``,
which rounds after every operation and so agrees bit for bit with the
plain PyTorch version; on a CPU tensor it runs that plain version. A call
the kernel does not take raises. ``tree_sgd`` packs a params tree into
``parallel.collectives`` buckets and runs one ``fused_sgd`` per bucket;
the LeNet trainer's ascent convention ``p += dt·mean(g)`` is
``lr = −dt, scale = 1/n`` (train/step.py:fused_batched_step).
``fused_sgd_momentum_buckets`` is the zoo's update-on-arrival step
(train/zoo.py:make_fused_train_step): one launch over all of a step's
bucket shards (up to ``MAX_ENTRIES`` a launch), out of place, with
``scale`` a device scalar (the step folds the loss scale, accumulation
and world size into it without a host sync); ``fused_sgd_momentum``, JAX's
one-bucket entry, is its list of one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import torch

from parallel_cnn_tpu_torch.ops._cuda_build import (
    Library,
    LaunchCounter,
    check_operand,
    launch_stream,
    on_cuda,
    raise_on_error,
)
from parallel_cnn_tpu_torch.parallel import collectives

#: Launches of the SGD kernel (one per bucket on a CUDA tensor).
launches = LaunchCounter()
#: Launches of the SGD-momentum kernel (one per MAX_ENTRIES bucket shards
#: on CUDA tensors).
momentum_launches = LaunchCounter()
#: Bucket shards one SGD-momentum launch takes (csrc/sgd_update.cu's
#: MAX_ENTRIES, checked against the library when it loads); a longer list is
#: cut into launches of this many, in order.
MAX_ENTRIES = 32

_library = Library(
    "sgd_update.cu",
    {"sgd_update": ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float,
                                             ctypes.c_float, ctypes.c_void_p],
                    ctypes.c_int),
     "sgd_momentum_update": ([ctypes.POINTER(ctypes.c_void_p),
                              ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                              ctypes.c_void_p],
                             ctypes.c_int),
     "sgd_momentum_max_entries": ([], ctypes.c_int)},
    # The source rounds each op with intrinsics; keep every other multiply
    # and add unfused as well.
    extra_flags=("-fmad=false",),
)


def build() -> Library:
    """Compile (if needed) and load the kernel library; returns its record
    (``path``, ``build_seconds``, ``compiler_output``)."""
    _lib()
    return _library


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded library, its MAX_ENTRIES checked against the wrapper's
    once (a failed check is not cached, so every later launch raises too)."""
    lib = _library.get()
    got = lib.sgd_momentum_max_entries()
    if got != MAX_ENTRIES:
        raise RuntimeError(f"csrc/sgd_update.cu takes {got} entries a launch, "
                           f"its wrapper {MAX_ENTRIES}")
    return lib


def fused_sgd_plain(p: torch.Tensor, g: torch.Tensor, lr: float,
                    scale: float = 1.0) -> torch.Tensor:
    """Plain version: three elementwise ops, each rounded to f32."""
    return p - lr * (g * scale)


def _launch(p: torch.Tensor, g: torch.Tensor, lr: float, scale: float) -> torch.Tensor:
    dev = p.device
    n = int(p.shape[0])
    check_operand("p", p, dev, (n,), torch.float32)
    check_operand("g", g, dev, (n,), torch.float32)
    lib = _lib()
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


def fused_sgd_momentum_plain(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                             lr: float, momentum: float, scale):
    """Plain version: five elementwise ops, each rounded to f32."""
    m2 = momentum * m + g * scale
    return p - lr * m2, m2


def _scale_operand(scale, dev) -> torch.Tensor:
    """``scale`` as one f32 on ``dev``: a tensor is checked, a number is
    written there (no host sync either way)."""
    if not isinstance(scale, torch.Tensor):
        return torch.full((1,), float(scale), dtype=torch.float32, device=dev)
    if scale.numel() != 1 or scale.dtype != torch.float32 or scale.device != dev:
        raise ValueError(f"scale must be one f32 on {dev}, got "
                         f"{tuple(scale.shape)}/{scale.dtype} on {scale.device}")
    return scale.reshape(1).contiguous()


def _launch_momentum(ps, ms, gs, lr, momentum, scale):
    dev = ps[0].device
    for i, (p, m, g) in enumerate(zip(ps, ms, gs)):
        n = int(p.shape[0])
        for name, t in (("p", p), ("m", m), ("g", g)):
            check_operand(f"{name}[{i}]", t, dev, (n,), torch.float32)
    s = _scale_operand(scale, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        p_outs = [torch.empty_like(p) for p in ps]
        m_outs = [torch.empty_like(m) for m in ms]
        stream = launch_stream(dev)
        for lo in range(0, len(ps), MAX_ENTRIES):
            group = range(lo, min(lo + MAX_ENTRIES, len(ps)))
            ptrs = (ctypes.c_void_p * (5 * len(group)))(*[
                t.data_ptr() for i in group
                for t in (ps[i], ms[i], gs[i], p_outs[i], m_outs[i])])
            lens = (ctypes.c_longlong * len(group))(*[int(ps[i].shape[0]) for i in group])
            err = lib.sgd_momentum_update(ptrs, lens, len(group), s.data_ptr(),
                                          float(lr), float(momentum), stream)
            raise_on_error("sgd_momentum_update", err)
            momentum_launches.add()
    return p_outs, m_outs


def fused_sgd_momentum_buckets(ps, ms, gs, *, lr: float, momentum: float, scale=1.0):
    """([p'], [m']) with m' = β·m + g·scale and p' = p − lr·m' for each
    bucket (p, m, g) of the three lists: 1-D f32 buffers of equal length
    per bucket, all on one device. On CUDA tensors one kernel launch per
    ``MAX_ENTRIES`` buckets; on CPU tensors the plain version per bucket.
    ``scale`` is a one-element f32 tensor on their device (read there by
    the kernel) or a number."""
    ps, ms, gs = list(ps), list(ms), list(gs)
    if not ps or not len(ps) == len(ms) == len(gs):
        raise ValueError(f"expected three equally long non-empty lists of buckets, "
                         f"got {len(ps)} / {len(ms)} / {len(gs)}")
    dev = ps[0].device
    for p, m, g in zip(ps, ms, gs):
        if not (p.shape == m.shape == g.shape) or p.dim() != 1 or p.shape[0] == 0:
            raise ValueError(f"expected matching non-empty 1-D buffers, got "
                             f"{tuple(p.shape)} / {tuple(m.shape)} / {tuple(g.shape)}")
        if not p.device == m.device == g.device == dev:
            raise ValueError(f"every bucket must lie on {dev}, got {p.device} / "
                             f"{m.device} / {g.device}")
    if not on_cuda("sgd_momentum_update", ps[0]):
        outs = [fused_sgd_momentum_plain(p, m, g, lr, momentum, scale)
                for p, m, g in zip(ps, ms, gs)]
        return [o[0] for o in outs], [o[1] for o in outs]
    return _launch_momentum(ps, ms, gs, lr, momentum, scale)


def fused_sgd_momentum(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor, *,
                       lr: float, momentum: float, scale=1.0):
    """(p', m') with m' = β·m + g·scale and p' = p − lr·m', one kernel, for
    1-D f32 buffers of equal length: ``fused_sgd_momentum_buckets`` on the
    list of one."""
    ps, ms = fused_sgd_momentum_buckets([p], [m], [g], lr=lr, momentum=momentum,
                                        scale=scale)
    return ps[0], ms[0]


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
