"""Bucketed gradient collectives over a mesh axis: the port of
``parallel_cnn_tpu/parallel/collectives.py``.

Buckets. A tree of tensors is packed into fixed-byte 1-D buffers and back,
exactly. Leaves are grouped by dtype (a bucket never mixes dtypes, so the
concatenation round-trips bit-exactly with no casts) and packed in the
tree's flatten order (JAX's: dict keys sorted), scalars raveled in,
zero-size leaves carried in metadata only, each bucket zero-padded to a
multiple of ``shards`` so a ring's chunks stay even. The single-device
consumer is the fused bucket update (ops/sgd_update.py): one kernel launch
per bucket.

Ring collectives. ``ring_reduce_scatter``, ``ring_all_gather`` and
``ring_all_reduce`` run JAX's ring hop for hop over one mesh axis (a
``DataMesh``, or an ``AxisView`` of a ``Mesh2D``; parallel/mesh.py): JAX's
``lax.ppermute`` to the next device is here one ``dist.batch_isend_irecv``
that sends to the axis's next rank and receives from its previous one, as
global ranks, in the axis's group (NCCL on the card, gloo on the CPU). An
axis of one rank sends nothing: a sum over one rank is its value.
``stage_exchange`` is the pipeline's tick: both stage-axis wires in one
``batch_isend_irecv``. Sums
accumulate in f32; only hop payloads are cast to the wire dtype. Every
hop's requests are waited on before its result is read: on NCCL the wait
orders PyTorch's current stream behind NCCL's, so a kernel launched next
on the current stream sees the received data. ``tree_all_reduce`` picks
psum (one ``dist.all_reduce`` over the tree packed into one buffer per
dtype), the ring or the hierarchical ring, per a ``config.CommConfig``.

The hierarchical (two-level) ring over a (host, device) mesh
(``mesh.HierMesh``; arXiv:1810.11112): ``hier_reduce_scatter`` rings the
device axis (the ranks of one host), then rings the surviving chunk over
the host axis, so the links between hosts carry (H−1)/(H·D) of a bucket
a rank instead of a flat ring's (N−1)/N. Rank (h, d) ends with row
d·H + h of ``x.view(H·D, -1)``; ``hier_all_gather`` inverts exactly that
placement, and ``hier_shard_rows`` / ``hier_unshard_rows`` lay a bucket
out as (H·D, L) rows in rank order (JAX's ``P((host, data))``), so that
ZeRO-3's resident row of rank r is what the rings deliver to it.

Collectives inside the forward (the GSPMD zoo path, nn/core.py), each an
autograd Function with its adjoint: ``all_reduce`` (the backward
all-reduces the gradient: BatchNorm's global sums), ``sum_grad``
(identity, the gradient summed), ``gather_last`` (an all-gather along the
channel axis whose backward sums and slices, or only slices, as its
consumer needs). ``all_reduce_buckets`` sums the grads over the data axis
after the backward. Every sum is one ``dist.all_reduce`` (NCCL's or
gloo's fixed order): nothing depends on arrival order.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from parallel_cnn_tpu_torch.parallel.mesh import AxisView, DataMesh, HierMesh
from parallel_cnn_tpu_torch.utils.tree import TreeDef, tree_flatten, tree_unflatten

#: What the collectives run over: the zoo's one-axis mesh, one axis of a
#: two-axis mesh, or a (host, data) mesh as the whole world.
Axis = Union[DataMesh, AxisView, HierMesh]

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


# ---------------------------------------------------------------------------
# Ring collectives (called by every rank of the mesh, in the same order)
# ---------------------------------------------------------------------------


def _wire(x_dtype: torch.dtype, wire_dtype) -> Optional[torch.dtype]:
    """The on-wire dtype: only floats compress, and a cast to the native
    dtype is skipped."""
    if wire_dtype is None or not x_dtype.is_floating_point:
        return None
    w = getattr(torch, wire_dtype) if isinstance(wire_dtype, str) else wire_dtype
    return None if w == x_dtype else w


def _acc(x_dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f32 for floats (the wire may be bf16, sums never
    are), the native dtype for exact integer addition."""
    return torch.float32 if x_dtype.is_floating_point else x_dtype


def _ppermute(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """JAX's ``ppermute`` with perm ``i → i+1`` over ``axis``: send ``t`` to
    the axis's next rank, return what its previous rank sent."""
    n, i = axis.size, axis.index
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), axis.ranks[(i + 1) % n],
                      group=axis.group),
           dist.P2POp(dist.irecv, out, axis.ranks[(i - 1) % n], group=axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def stage_exchange(fwd: Optional[torch.Tensor], bwd: Optional[torch.Tensor],
                   axis: Axis, *, recv_fwd: bool, recv_bwd: bool,
                   like: torch.Tensor, wire_dtype=None
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One tick of the pipeline's two stage-axis wires (JAX's two
    ppermutes, train/pipeline_schedule.py:302-307: activations to the
    next stage, cotangents to the previous) as ONE ``batch_isend_irecv``:
    two blocking exchanges posted in different orders by neighbouring
    stages could wait on each other under NCCL.

    ``fwd`` goes to the axis's next rank and ``bwd`` to its previous one
    (None: nothing to send this tick); ``recv_fwd`` / ``recv_bwd`` say
    whether the previous / next rank sends this tick. JAX sends both full
    rings every tick and masks the hops no one reads; here the caller
    leaves those hops out on both ends alike, from the schedule both ends
    know. The payloads travel in ``wire_dtype`` (None: as they are) and
    return as f32 tensors shaped like ``like``: (what the previous rank
    sent forward, what the next rank sent back), None where nothing
    came. The fwd ops are posted before the bwd ops on every rank, so two
    messages between one pair of ranks meet in order."""
    n, i = axis.size, axis.index
    wire = _wire(like.dtype, wire_dtype) or like.dtype
    ops, got = [], {}
    for payload, peer_to, incoming, peer_from, key in (
            (fwd, (i + 1) % n, recv_fwd, (i - 1) % n, "fwd"),
            (bwd, (i - 1) % n, recv_bwd, (i + 1) % n, "bwd")):
        if payload is not None:
            ops.append(dist.P2POp(dist.isend, payload.to(wire).contiguous(),
                                  axis.ranks[peer_to], group=axis.group))
        if incoming:
            got[key] = torch.empty(like.shape, dtype=wire, device=like.device)
            ops.append(dist.P2POp(dist.irecv, got[key], axis.ranks[peer_from],
                                  group=axis.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(got[k].to(torch.float32) if k in got else None
                 for k in ("fwd", "bwd"))


def ring_reduce_scatter(x: torch.Tensor, mesh: Axis,
                        wire_dtype=None) -> torch.Tensor:
    """Ring reduce-scatter of a 1-D buffer: rank ``r`` returns the fully
    summed chunk ``r`` of ``x.view(n, -1)``.

    n−1 hops, each carrying 1/n of the payload: before hop s a rank holds
    the partial sum of chunk (r−s−1) mod n, sends it on, and adds its own
    copy of chunk (r−s−2) mod n to what arrives."""
    n, idx = mesh.size, mesh.index
    if x.dim() != 1:
        raise ValueError(f"expected a 1-D bucket, got shape {tuple(x.shape)}")
    if x.shape[0] % n:
        raise ValueError(
            f"bucket of {x.shape[0]} elements does not divide over {n} "
            "shards (plan_buckets pads for this)")
    acc = _acc(x.dtype)
    chunks = x.view(n, -1).to(acc)
    if n == 1:
        return chunks[0].to(x.dtype)
    wire = _wire(x.dtype, wire_dtype)
    send = chunks[(idx - 1) % n]
    for s in range(n - 1):
        payload = send.to(wire) if wire is not None else send
        recvd = _ppermute(payload, mesh).to(acc)
        send = recvd + chunks[(idx - s - 2) % n]
    return send.to(x.dtype)


def ring_all_gather(shard: torch.Tensor, mesh: Axis,
                    wire_dtype=None) -> torch.Tensor:
    """Ring all-gather: the rank at axis index ``r`` contributes chunk
    ``r``; every rank returns the concatenation of all chunks along dim 0
    (n−1 forwarding hops)."""
    n, idx = mesh.size, mesh.index
    if n == 1:
        return shard
    wire = _wire(shard.dtype, wire_dtype)
    out = torch.zeros((n,) + tuple(shard.shape), dtype=shard.dtype,
                      device=shard.device)
    out[idx] = shard
    send = shard
    for s in range(n - 1):
        payload = send.to(wire) if wire is not None else send
        recvd = _ppermute(payload, mesh).to(shard.dtype)
        out[(idx - s - 1) % n] = recvd
        send = recvd
    return out.view((n * shard.shape[0],) + tuple(shard.shape[1:]))


def ring_all_reduce(x: torch.Tensor, mesh: Axis,
                    wire_dtype=None) -> torch.Tensor:
    """Reduce-scatter, then all-gather: 2(n−1)/n of the payload per rank
    on the wire."""
    shard = ring_reduce_scatter(x, mesh, wire_dtype)
    return ring_all_gather(shard, mesh, wire_dtype)


# ---------------------------------------------------------------------------
# Hierarchical (two-level) collectives over a (host, device) mesh
# ---------------------------------------------------------------------------


def hier_reduce_scatter(x: torch.Tensor, host: Axis, dev: Axis,
                        wire_dtype=None) -> torch.Tensor:
    """Two-level reduce-scatter: the ring over the device axis, then the
    ring of the surviving chunk over the host axis. Rank (h, d) returns the
    summed row ``d·H + h`` of ``x.view(H·D, -1)``."""
    local = ring_reduce_scatter(x, dev, wire_dtype)
    return ring_reduce_scatter(local, host, wire_dtype)


def hier_all_gather(shard: torch.Tensor, host: Axis, dev: Axis,
                    wire_dtype=None) -> torch.Tensor:
    """Exact inverse of ``hier_reduce_scatter``: the all-gather over the
    host axis rebuilds each rank's device chunk, then the all-gather over
    the device axis the whole bucket."""
    chunk = ring_all_gather(shard, host, wire_dtype)
    return ring_all_gather(chunk, dev, wire_dtype)


def hier_all_reduce(x: torch.Tensor, host: Axis, dev: Axis,
                    wire_dtype=None) -> torch.Tensor:
    """Hierarchical all-reduce of a 1-D bucket (reduce-scatter, then
    all-gather, each over both levels)."""
    shard = hier_reduce_scatter(x, host, dev, wire_dtype)
    return hier_all_gather(shard, host, dev, wire_dtype)


def hier_shard_rows(bucket: torch.Tensor, n_host: int, n_dev: int) -> torch.Tensor:
    """A 1-D bucket as (n_host·n_dev, L) rows in rank order (JAX's
    ``P((host, data))``): row ``h·n_dev + d`` is the chunk the hierarchical
    rings place on rank (h, d), row ``d·n_host + h`` of the natural
    reshape. With n_host = 1, ``bucket.view(n_dev, -1)`` (the flat ring's
    layout)."""
    if bucket.shape[0] % (n_host * n_dev):
        raise ValueError(
            f"bucket of {bucket.shape[0]} elements does not divide over "
            f"{n_host}x{n_dev} shards")
    if n_host == 1:
        return bucket.reshape(n_dev, -1)
    return (bucket.reshape(n_dev, n_host, -1).transpose(0, 1)
            .reshape(n_host * n_dev, -1))


def hier_unshard_rows(rows: torch.Tensor, n_host: int, n_dev: int) -> torch.Tensor:
    """Exact inverse of ``hier_shard_rows``: the rows back to the 1-D
    bucket."""
    if n_host == 1:
        return rows.reshape(-1)
    return rows.reshape(n_host, n_dev, -1).transpose(0, 1).reshape(-1)


def all_reduce_sum(t: torch.Tensor, mesh: Axis) -> torch.Tensor:
    """JAX's ``psum`` of one buffer over an axis: the sum over its ranks,
    in place (over one rank, ``t`` as it is)."""
    if mesh.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def tree_mean(tree: Any, mesh: Axis) -> Any:
    """JAX's ``pmean`` of a tree: the leaves packed into one buffer per
    dtype, summed over ranks, divided by the axis size."""
    plan = plan_buckets(tree, sys.maxsize)
    buckets = [all_reduce_sum(b, mesh) / mesh.size
               for b in flatten_buckets(tree, plan)]
    return unflatten_buckets(buckets, plan)


# ---------------------------------------------------------------------------
# Tree-level API (what the trainers call)
# ---------------------------------------------------------------------------


def wire_dtype_arg(comm) -> Optional[str]:
    """The wire dtype the ring takes, from a ``config.CommConfig``
    ("float32" means no compression → None)."""
    if comm is None or comm.wire_dtype in (None, "float32"):
        return None
    return comm.wire_dtype


def tree_all_reduce(tree: Any, mesh: Axis, comm=None, *,
                    host: Optional[Axis] = None) -> Any:
    """SUM-allreduce a tree over an axis, per the comm config; with
    ``host`` (the host axis of a (host, device) mesh, ``mesh`` its device
    axis) over both axes.

    ``comm=None`` or impl "psum": the leaves packed into one buffer per
    dtype and one ``dist.all_reduce`` each (JAX's monolithic ``lax.psum``),
    over the device axis and then the host axis. impl "ring": the tree
    bucketed (``comm.bucket_bytes``, padded to the axis size) and each
    bucket through ``ring_all_reduce``, optionally bf16 on the wire. impl
    "hierarchical": the buckets padded to H·D shards, each through
    ``hier_all_reduce``."""
    if comm is None or comm.impl == "psum":
        plan = plan_buckets(tree, sys.maxsize)
        buckets = [all_reduce_sum(b, mesh) for b in flatten_buckets(tree, plan)]
        if host is not None:
            buckets = [all_reduce_sum(b, host) for b in buckets]
        return unflatten_buckets(buckets, plan)
    wire = wire_dtype_arg(comm)
    if comm.impl == "hierarchical":
        if host is None:
            raise ValueError(
                "impl='hierarchical' needs a (host, device) mesh — pass "
                "host= (mesh.make_hier_mesh builds the mesh)")
        plan = plan_buckets(tree, comm.bucket_bytes, shards=host.size * mesh.size)
        buckets = [hier_all_reduce(b, host, mesh, wire)
                   for b in flatten_buckets(tree, plan)]
        return unflatten_buckets(buckets, plan)
    if comm.impl != "ring":
        raise ValueError(f"unknown comm impl {comm.impl!r}")
    plan = plan_buckets(tree, comm.bucket_bytes, shards=mesh.size)
    buckets = [ring_all_reduce(b, mesh, wire) for b in flatten_buckets(tree, plan)]
    return unflatten_buckets(buckets, plan)


def reduce_scatter_buckets(buckets: Sequence[torch.Tensor], mesh: Axis,
                           wire_dtype=None, *,
                           host: Optional[Axis] = None) -> List[torch.Tensor]:
    """Reduce-scatter each bucket: this rank's shard of each. The buckets
    must be planned with ``shards=mesh.size``; with ``host`` the two-level
    ring runs instead of the flat one (``shards=host.size·mesh.size``)."""
    if host is not None:
        return [hier_reduce_scatter(b, host, mesh, wire_dtype) for b in buckets]
    return [ring_reduce_scatter(b, mesh, wire_dtype) for b in buckets]


def all_gather_buckets(shards: Sequence[torch.Tensor], mesh: Axis,
                       wire_dtype=None, *,
                       host: Optional[Axis] = None) -> List[torch.Tensor]:
    """Inverse of ``reduce_scatter_buckets``: the full buckets again."""
    if host is not None:
        return [hier_all_gather(s, host, mesh, wire_dtype) for s in shards]
    return [ring_all_gather(s, mesh, wire_dtype) for s in shards]


# ---------------------------------------------------------------------------
# Collectives inside the forward, with their adjoints (the GSPMD zoo path)
# ---------------------------------------------------------------------------


def _summed(t: torch.Tensor, mesh: Axis) -> torch.Tensor:
    """A new tensor holding the sum of ``t`` over the axis's ranks."""
    out = t.contiguous().clone()
    return all_reduce_sum(out, mesh)


def _last_chunk(t: torch.Tensor, mesh: Axis) -> torch.Tensor:
    """This rank's block of ``t``'s last axis, as a tensor of its own."""
    k = t.shape[-1] // mesh.size
    return t[..., mesh.index * k:(mesh.index + 1) * k].contiguous()


class _AllReduce(torch.autograd.Function):
    """y = Σ_ranks x on every rank. Each rank's y feeds only its own part
    of the loss, so the gradient of y is a partial one on each rank and
    the adjoint sums it over the axis too."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _summed(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh), None


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis.
    For a tensor that every rank holds whole and that feeds a layer split
    over the axis: each rank's gradient is the part from its own filters."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh), None


class _GatherLast(torch.autograd.Function):
    """All-gather over the axis along the last dimension (rank i's block
    i). The backward is the adjoint that matches the consumer: summed over
    the axis and sliced (a reduce-scatter) when the consumer is split over
    the axis, so that each rank's gradient is partial; sliced alone when
    the consumer is replicated, so that each rank's gradient is whole."""

    @staticmethod
    def forward(ctx, x, mesh, partial):
        ctx.mesh, ctx.partial = mesh, partial
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _summed(g, ctx.mesh)
        return _last_chunk(g, ctx.mesh), None, None


def all_reduce(x: torch.Tensor, mesh: Axis) -> torch.Tensor:
    """The sum of ``x`` over the axis, differentiable: the backward
    all-reduces the incoming gradient (BatchNorm's global sums). Over one
    rank, ``x`` itself."""
    if mesh.size == 1:
        return x
    return _AllReduce.apply(x, mesh)


def sum_grad(x: torch.Tensor, mesh: Axis) -> torch.Tensor:
    """``x`` as it is, with its gradient summed over the axis (see
    ``_SumGrad``). Over one rank, ``x`` itself."""
    if mesh.size == 1:
        return x
    return _SumGrad.apply(x, mesh)


def gather_last(x: torch.Tensor, mesh: Axis, partial: bool) -> torch.Tensor:
    """Every rank's block of the last dimension, concatenated in axis order
    (see ``_GatherLast`` for ``partial``). Over one rank, ``x`` itself."""
    if mesh.size == 1:
        return x
    return _GatherLast.apply(x, mesh, partial)


def all_reduce_buckets(tensors: Sequence[torch.Tensor], mesh: Axis,
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES
                       ) -> List[torch.Tensor]:
    """The sum of each tensor over the axis (no gradient): the tensors
    packed into ``bucket_bytes`` buckets in their order, one
    ``dist.all_reduce`` a bucket, unpacked. Over one rank, the tensors as
    they are."""
    tensors = list(tensors)
    if mesh.size == 1:
        return tensors
    plan = plan_buckets(tensors, bucket_bytes)
    buckets = [all_reduce_sum(b, mesh) for b in flatten_buckets(tensors, plan)]
    return unflatten_buckets(buckets, plan)
