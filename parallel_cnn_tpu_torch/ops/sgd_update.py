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
the kernel does not take raises. ``tree_sgd`` updates a params tree
through ``parallel.collectives`` buckets, one launch per bucket: on the
card it no longer packs the tree (JAX's two concatenations a bucket) but
hands the kernel the bucket's leaves where they lie
(``fused_sgd_leaves``, up to ``MAX_LEAVES`` a launch), which writes the
packed bucket; on the host it packs, runs the plain version and unpacks.
The new leaves are views into the output buckets either way. The LeNet
trainer's ascent convention ``p += dt·mean(g)`` is ``lr = −dt, scale =
1/n`` (train/step.py:fused_batched_step). ``fused_sgd``, JAX's one-bucket
entry, is the leaf list of one.
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
from typing import List, Sequence, Tuple

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
from parallel_cnn_tpu_torch.utils.tree import tree_flatten, tree_unflatten

#: Launches of the SGD kernel (one per bucket of at most MAX_LEAVES leaves
#: on CUDA tensors).
launches = LaunchCounter()
#: Launches of the SGD-momentum kernel (one per MAX_ENTRIES bucket shards
#: on CUDA tensors).
momentum_launches = LaunchCounter()
#: Bucket shards one SGD-momentum launch takes (csrc/sgd_update.cu's
#: MAX_ENTRIES, checked against the library when it loads); a longer list is
#: cut into launches of this many, in order.
MAX_ENTRIES = 32
#: Bucket leaves one SGD launch takes (csrc/sgd_update.cu's MAX_LEAVES,
#: checked against the library when it loads); a longer list is cut into
#: launches of this many, in order, each writing its span of the bucket.
MAX_LEAVES = 16

_library = Library(
    "sgd_update.cu",
    {"sgd_update_leaves": ([ctypes.POINTER(ctypes.c_void_p),
                            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                            ctypes.c_void_p],
                           ctypes.c_int),
     "sgd_update_max_leaves": ([], ctypes.c_int),
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
    """The loaded library, its MAX_ENTRIES and MAX_LEAVES checked against
    the wrapper's once (a failed check is not cached, so every later launch
    raises too)."""
    lib = _library.get()
    for what, got, want in (("entries", lib.sgd_momentum_max_entries(), MAX_ENTRIES),
                            ("leaves", lib.sgd_update_max_leaves(), MAX_LEAVES)):
        if got != want:
            raise RuntimeError(f"csrc/sgd_update.cu takes {got} {what} a launch, "
                               f"its wrapper {want}")
    return lib


def fused_sgd_plain(p: torch.Tensor, g: torch.Tensor, lr: float,
                    scale: float = 1.0) -> torch.Tensor:
    """Plain version: three elementwise ops, each rounded to f32."""
    return p - lr * (g * scale)


def leaf_launches(sizes: Sequence[int]) -> List[Tuple[int, Tuple[int, ...]]]:
    """The launches over one bucket's leaves of these lengths, in order:
    (the first element of the launch's span of the bucket, its leaves'
    lengths), at most MAX_LEAVES leaves each. The kernel places leaf k of
    a launch at the span's start plus the lengths before it."""
    sizes = [int(n) for n in sizes]
    out = []
    for lo in range(0, len(sizes), MAX_LEAVES):
        out.append((sum(sizes[:lo]), tuple(sizes[lo:lo + MAX_LEAVES])))
    return out


def _launch_leaves(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor], lr: float,
                   scale: float) -> torch.Tensor:
    """The packed bucket from leaves of any shape (p and g alike), each
    contiguous f32 on one device, read in place."""
    dev = ps[0].device
    for i, (p, g) in enumerate(zip(ps, gs)):
        for name, t in (("p", p), ("g", g)):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                check_operand(f"{name}[{i}]", t, dev, tuple(t.shape), torch.float32)
        if g.shape != p.shape:
            raise ValueError(f"g[{i}] has shape {tuple(g.shape)}, expected {tuple(p.shape)}")
    lib = _lib()
    sizes = [p.numel() for p in ps]
    ptrs = [t.data_ptr() for p, g in zip(ps, gs) for t in (p, g)]
    with torch.cuda.device(dev):
        out = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        stream = launch_stream(dev)
        lo = 0
        for start, lens in leaf_launches(sizes):
            k = len(lens)
            err = lib.sgd_update_leaves((ctypes.c_void_p * (2 * k))(*ptrs[2 * lo:2 * (lo + k)]),
                                        (ctypes.c_longlong * k)(*lens), k,
                                        out.data_ptr() + 4 * start, float(lr), float(scale),
                                        stream)
            raise_on_error("sgd_update", err)
            launches.add()
            lo += k
    return out


def fused_sgd_leaves(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor], *,
                     lr: float, scale: float = 1.0) -> torch.Tensor:
    """The packed bucket p − lr·(g·scale) over leaves (p, g) of the two
    lists, in order: 1-D f32 buffers of equal length per leaf, all on one
    device. On CUDA tensors one kernel launch per ``MAX_LEAVES`` leaves
    reads each leaf where it lies; on CPU tensors the plain version runs
    on the packed buffers."""
    ps, gs = list(ps), list(gs)
    if not ps or len(ps) != len(gs):
        raise ValueError(f"expected two equally long non-empty lists of leaves, "
                         f"got {len(ps)} / {len(gs)}")
    for p, g in zip(ps, gs):
        if p.shape != g.shape or p.dim() != 1 or p.shape[0] == 0:
            raise ValueError(f"expected matching non-empty 1-D buffers, got "
                             f"{tuple(p.shape)} vs {tuple(g.shape)}")
    if not on_cuda("sgd_update", ps[0]):
        return fused_sgd_plain(torch.cat(ps), torch.cat(gs), lr, scale)
    return _launch_leaves(ps, gs, lr, scale)


def fused_sgd(p: torch.Tensor, g: torch.Tensor, *, lr: float,
              scale: float = 1.0) -> torch.Tensor:
    """p − lr·(g·scale) for 1-D f32 buffers of equal length, one kernel:
    ``fused_sgd_leaves`` on the list of one."""
    if p.shape != g.shape or p.dim() != 1 or p.shape[0] == 0:
        raise ValueError(f"expected matching non-empty 1-D buffers, got "
                         f"{tuple(p.shape)} vs {tuple(g.shape)}")
    if not on_cuda("sgd_update", p):
        return fused_sgd_plain(p, g, lr, scale)
    return _launch_leaves([p], [g], lr, scale)


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


def bucket_leaves(plan: collectives.BucketPlan) -> List[List[int]]:
    """Each bucket's leaves, as indices into the plan's slots (the tree's
    flatten order), in the order they are packed."""
    members: List[List[int]] = [[] for _ in plan.bucket_sizes]
    for i, slot in enumerate(plan.slots):
        if slot.bucket >= 0:
            members[slot.bucket].append(i)
    return members


@functools.lru_cache(maxsize=64)
def _tensor_tree_plan(treedef, shapes, dtypes, bucket_bytes: int):
    """``plan_buckets(tree, bucket_bytes, shards=1)`` and its buckets'
    leaves for any tree of tensors with this structure, leaf shapes and
    dtypes: the same for every step of a run, so planned once."""
    tree = tree_unflatten(treedef, [torch.empty(s, dtype=d, device="meta")
                                    for s, d in zip(shapes, dtypes)])
    plan = collectives.plan_buckets(tree, bucket_bytes, shards=1)
    return plan, bucket_leaves(plan)


def tree_sgd(params, grads, *, lr: float, scale: float = 1.0,
             bucket_bytes: int = collectives.DEFAULT_BUCKET_BYTES):
    """Tree-wide fused SGD through the bucket machinery: the tree's
    ``collectives.plan_buckets`` buckets (no padding), each updated by ONE
    kernel launch of at most ``MAX_LEAVES`` leaves, and the new leaves
    returned as views into the output buckets. On the card each bucket's
    leaves are read where they lie (the plan cached by the tree's
    structure, shapes and dtypes); on the host the tree is packed, updated
    by the plain version and unpacked."""
    leaves, treedef = tree_flatten(params)
    first = next((t for t in leaves if isinstance(t, torch.Tensor)), None)
    if first is None or not on_cuda("sgd_update", first):
        plan = collectives.plan_buckets(params, bucket_bytes, shards=1)
        pb = collectives.flatten_buckets(params, plan)
        gb = collectives.flatten_buckets(grads, plan)
        out = [fused_sgd_plain(p, g, lr, scale) for p, g in zip(pb, gb)]
        return collectives.unflatten_buckets(out, plan)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError("tree_sgd on the card takes a tree of tensors")
    grad_leaves = tree_flatten(grads)[0]
    if len(grad_leaves) != len(leaves):
        raise ValueError(f"grads have {len(grad_leaves)} leaves, params {len(leaves)}")
    plan, members = _tensor_tree_plan(treedef, tuple(tuple(t.shape) for t in leaves),
                                      tuple(t.dtype for t in leaves), bucket_bytes)
    out = [_launch_leaves([leaves[i] for i in m], [grad_leaves[i] for i in m], lr, scale)
           for m in members]
    return collectives.unflatten_buckets(out, plan)
