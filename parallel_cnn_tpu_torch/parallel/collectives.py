"""Gradient buckets: a tree of tensors packed into fixed-byte 1-D buffers
and back, exactly (the bucket half of ``parallel_cnn_tpu/parallel/
collectives.py``; the ring collectives come with the data-parallel slice).

Leaves are grouped by dtype (a bucket never mixes dtypes, so the
concatenation round-trips bit-exactly with no casts) and packed in the
tree's flatten order (JAX's: dict keys sorted), scalars raveled in,
zero-size leaves carried in metadata only, each bucket zero-padded to a
multiple of ``shards``. The single-device consumer is the fused bucket
update (ops/sgd_update.py): one kernel launch per bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch

from parallel_cnn_tpu_torch.utils.tree import TreeDef, tree_flatten, tree_unflatten

DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024  # PCNN_COMM_BUCKET_BYTES default


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one tree leaf lives inside the bucket list.

    ``bucket == -1`` marks a zero-size leaf: it occupies no bucket space
    and is rebuilt from (shape, dtype) alone at unflatten time.
    """

    bucket: int
    offset: int  # element offset within the bucket
    size: int    # element count (product of shape)
    shape: Tuple[int, ...]
    dtype: str   # dtype name, as numpy spells it ("float32")


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static flattening recipe for one tree structure."""

    treedef: TreeDef
    slots: Tuple[LeafSlot, ...]
    bucket_sizes: Tuple[int, ...]   # padded element counts, per bucket
    bucket_dtypes: Tuple[str, ...]  # one dtype per bucket (grouped fill)
    shards: int                     # every bucket_size is a multiple of this

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)


def _ceil_to(n: int, k: int) -> int:
    return k * ((n + k - 1) // k)


def _as_tensor(leaf) -> torch.Tensor:
    """A leaf as a tensor; a Python float is f32, as JAX (no x64) makes it."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, float):
        return torch.tensor(leaf, dtype=torch.float32)
    return torch.as_tensor(leaf)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def plan_buckets(tree: Any, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 shards: int = 1) -> BucketPlan:
    """Greedy fixed-byte bucket assignment for a tree's leaves.

    Leaves go in flatten order into buckets of at most ``bucket_bytes``
    payload per dtype; a leaf larger than the budget gets a bucket of its
    own rather than being split. Each bucket's element count is padded up
    to a multiple of ``shards``.
    """
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    if shards <= 0:
        raise ValueError(f"shards must be > 0, got {shards}")
    leaves, treedef = tree_flatten(tree)
    slots: List[LeafSlot] = []
    sizes: List[int] = []      # unpadded fill, per open/closed bucket
    dtypes: List[str] = []
    open_bucket: dict = {}     # dtype name -> bucket index still accepting
    for leaf in leaves:
        t = _as_tensor(leaf)
        shape = tuple(int(d) for d in t.shape)
        name = _dtype_name(t.dtype)
        size = int(t.numel())
        if size == 0:
            slots.append(LeafSlot(-1, 0, 0, shape, name))
            continue
        cap = max(1, bucket_bytes // t.element_size())
        b = open_bucket.get(name)
        if b is None or sizes[b] + size > cap:
            b = len(sizes)
            sizes.append(0)
            dtypes.append(name)
            # An oversized leaf fills (and closes) its own bucket.
            open_bucket[name] = b if size < cap else None
        slots.append(LeafSlot(b, sizes[b], size, shape, name))
        sizes[b] += size
        if sizes[b] >= cap:
            open_bucket[name] = None
    return BucketPlan(
        treedef=treedef,
        slots=tuple(slots),
        bucket_sizes=tuple(_ceil_to(s, shards) for s in sizes),
        bucket_dtypes=tuple(dtypes),
        shards=shards,
    )


def flatten_buckets(tree: Any, plan: BucketPlan) -> List[torch.Tensor]:
    """Pack a tree (matching the plan's structure) into its buckets."""
    leaves = tree_flatten(tree)[0]
    if len(leaves) != len(plan.slots):
        raise ValueError(
            f"tree has {len(leaves)} leaves but plan was built for "
            f"{len(plan.slots)}"
        )
    parts: List[List[torch.Tensor]] = [[] for _ in plan.bucket_sizes]
    fill = [0] * plan.n_buckets
    device = None
    for leaf, slot in zip(leaves, plan.slots):
        if slot.bucket < 0:
            continue
        t = _as_tensor(leaf)
        device = t.device
        parts[slot.bucket].append(t.reshape(-1))
        fill[slot.bucket] += slot.size
    out: List[torch.Tensor] = []
    for b, chunks in enumerate(parts):
        pad = plan.bucket_sizes[b] - fill[b]
        if pad:
            chunks = chunks + [torch.zeros((pad,), dtype=chunks[0].dtype,
                                           device=device)]
        out.append(torch.cat(chunks) if len(chunks) > 1 else chunks[0].clone())
    return out


def unflatten_buckets(buckets: Sequence[torch.Tensor], plan: BucketPlan) -> Any:
    """Exact inverse of `flatten_buckets` (padding discarded); the leaves
    are views into the buckets."""
    if len(buckets) != plan.n_buckets:
        raise ValueError(
            f"{len(buckets)} buckets given, plan has {plan.n_buckets}"
        )
    leaves = []
    for slot in plan.slots:
        dtype = getattr(torch, slot.dtype)
        if slot.bucket < 0:
            device = buckets[0].device if buckets else None
            leaves.append(torch.zeros(slot.shape, dtype=dtype, device=device))
            continue
        flat = buckets[slot.bucket][slot.offset:slot.offset + slot.size]
        leaves.append(flat.view(slot.shape).to(dtype))
    return tree_unflatten(plan.treedef, leaves)
