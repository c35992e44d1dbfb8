"""The port's device mesh (the counterpart of
``parallel_cnn_tpu/parallel/mesh.py``).

JAX builds one ``Mesh`` of devices inside one process and runs a step as a
``shard_map`` over it. The port runs one process per rank instead, each
with a ``torch.distributed`` process group (parallel/distributed.py
starts them), and a mesh object is what one rank knows of the whole.

- ``DataMesh``: the one-axis (``data``) mesh of the zoo trainer: the world
  size, this rank and its device. Its collectives run over the default
  process group, which holds every rank.
- ``Mesh2D``: JAX's ``(data, model)`` mesh. JAX lays the devices out as
  ``reshape(data, model)`` (``make_mesh``), so global rank r sits at
  (d, m) = (r // M, r % M). It holds one ``AxisView`` per axis: the axis
  size, this rank's index on it, the axis's global ranks in axis order and
  the ``torch.distributed`` group its collectives run over.

- ``PipelineMesh``: JAX's ``(stage, data)`` pipeline mesh
  (``make_pipeline_mesh``): the world's ranks as S rows of D, rank
  r = s·D + d at stage s, data index d (JAX's ``reshape(n_stages, n //
  n_stages)``). Its ``stage`` axis is the rank's column (the ranks that
  hold the other stages of its data replica), its ``data`` axis the
  rank's row (the replicas of its stage).

- ``HierMesh``: JAX's ``(host, data)`` mesh of the hierarchical ring
  (``make_hier_mesh``): the world's ranks as H rows of D = world // H,
  rank r = h·D + d on host h at device index d (JAX's ``reshape(n_hosts,
  n // n_hosts)``). Its ``host`` axis is the rank's column (the ranks with
  the same d, one on each host), its ``data`` axis the rank's row (the
  ranks of its host). It is also an axis view over the whole world (JAX's
  reduction over both axes, ``(host, data)``), and its ``shard_rows``
  takes block r of H·D (JAX's ``P((host, data))``).

- ``make_elastic_mesh``: JAX's re-mesh of an elastic run over its first
  ``world`` surviving ranks, a ``HierMesh`` while the host count divides
  the world and a flat ``DataMesh`` otherwise. The survivors are a prefix
  of the spawned ranks, so a survivor's rank in the new mesh is its
  global rank; the mesh's groups are sub-groups of the spawned world, and
  a ``cache`` keeps one mesh view per (world, hosts) topology, so a lap
  back to a topology already seen makes no new group.

A ``DataMesh`` is an axis view of its own (``size``, ``index``, ``ranks``,
``group``): the collectives of parallel/collectives.py take either. A
``DataMesh`` may also stand for one line of a larger mesh (``line``,
``line_group``: a pipeline mesh's data row, ``PipelineMesh.data_mesh``);
its ``world`` and ``rank`` are then the line's size and the rank's index
on it. An axis of one rank needs no group (a sum over one rank is that
rank's value); an axis that spans the world uses the default group.

``shard_batch`` takes a rank's rows of a global batch, which is what JAX's
``P(DATA_AXIS)`` gives the device at (d, m): rows ``[d·B/n, (d+1)·B/n)``,
the same rows for every model rank of a data row.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from parallel_cnn_tpu_torch.utils.tree import tree_map

def _rows(x: torch.Tensor, index: int, size: int) -> torch.Tensor:
    n = x.shape[0]
    if n % size:
        raise ValueError(
            f"global batch {n} does not divide over {size} ranks "
            "(no silent sample dropping)"
        )
    per = n // size
    return x[index * per:(index + 1) * per]


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data axis. The collectives run over the
    default process group, which holds every rank, or, for a line of a
    larger mesh, over ``line_group`` (the line's global ranks ``line``)."""

    world: int
    rank: int
    device: torch.device
    line: Optional[Tuple[int, ...]] = None
    line_group: Any = None

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of {self.world}")

    # The axis-view interface (AxisView's fields): the one-axis case.
    @property
    def size(self) -> int:
        return self.world

    @property
    def index(self) -> int:
        return self.rank

    @property
    def ranks(self) -> Tuple[int, ...]:
        return self.line if self.line is not None else tuple(range(self.world))

    @property
    def group(self):
        return self.line_group

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of rows of a global batch."""
        return _rows(x, self.rank, self.world)


@dataclasses.dataclass(frozen=True)
class AxisView:
    """One mesh axis as one rank sees it. ``group`` None means the default
    process group (an axis over the whole world) or, for an axis of one
    rank, no group at all."""

    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Any = None


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """One rank's view of the (data, model) mesh."""

    world: int
    rank: int
    device: torch.device
    data: AxisView
    model: AxisView

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch (its data row's block)."""
        return _rows(x, self.data.index, self.data.size)


def _axis_groups(axes, world: int):
    """One group per axis line, made on every rank in the same order (the
    data lines for m = 0..M-1, then the model lines for d = 0..D-1), as
    ``dist.new_group`` requires. Lines of one rank and lines over the whole
    world make no group."""
    groups = {}
    for lines in axes:
        for line in lines:
            if 1 < len(line) < world:
                groups[line] = dist.new_group(list(line))
    return groups


def make_mesh_2d(rank: int, world: int, device: torch.device, n_data: int,
                 n_model: int) -> Mesh2D:
    """This rank's view of a ``n_data × n_model`` mesh over ``world`` ranks,
    called by every rank after ``init_process_group`` when an axis has more
    than one rank and fewer than the world (a 1×1 mesh needs no process
    group: its collectives make no call)."""
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(
            f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks, "
            f"the world has {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    d, m = divmod(rank, n_model)
    data_lines = [tuple(dd * n_model + mm for dd in range(n_data))
                  for mm in range(n_model)]
    model_lines = [tuple(dd * n_model + mm for mm in range(n_model))
                   for dd in range(n_data)]
    groups = _axis_groups((data_lines, model_lines), world)
    return Mesh2D(
        world=world, rank=rank, device=device,
        data=AxisView(n_data, d, data_lines[m], groups.get(data_lines[m])),
        model=AxisView(n_model, m, model_lines[d], groups.get(model_lines[d])),
    )


#: The pipeline and hierarchical meshes' axis names, in JAX's order
#: (parallel/mesh.py).
STAGE_AXIS, DATA_AXIS, HOST_AXIS = "stage", "data", "host"


@dataclasses.dataclass(frozen=True)
class PipelineMesh:
    """One rank's view of the (stage, data) pipeline mesh."""

    world: int
    rank: int
    device: torch.device
    stage: AxisView
    data: AxisView

    @property
    def shape(self):
        """JAX's ``dict(mesh.shape)``: ``{'stage': S, 'data': D}``."""
        return {STAGE_AXIS: self.stage.size, DATA_AXIS: self.data.size}

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch: its data index's block, the
        same rows for every stage (JAX's ``P(DATA_AXIS)``)."""
        return _rows(x, self.data.index, self.data.size)

    def data_mesh(self) -> DataMesh:
        """The rank's data row as a ``DataMesh`` (the flat ring's mesh)."""
        d = self.data
        return DataMesh(world=d.size, rank=d.index, device=self.device,
                        line=d.ranks, line_group=d.group)


def make_pipeline_mesh(rank: int, world: int, device: torch.device,
                       n_stages: int) -> PipelineMesh:
    """This rank's view of JAX's ``make_pipeline_mesh(n_stages)`` over
    ``world`` ranks: S rows of D = world // S, rank r = s·D + d. Every rank
    calls it after ``init_process_group`` (it makes the axis groups, the
    stage columns then the data rows, in the same order on every rank)."""
    if n_stages < 1 or world % n_stages != 0:
        raise ValueError(
            f"stage axis {n_stages} does not divide device count {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    n_data = world // n_stages
    s, d = divmod(rank, n_data)
    stage_lines = [tuple(ss * n_data + dd for ss in range(n_stages))
                   for dd in range(n_data)]
    data_lines = [tuple(s_ * n_data + dd for dd in range(n_data))
                  for s_ in range(n_stages)]
    groups = _axis_groups((stage_lines, data_lines), world)
    return PipelineMesh(
        world=world, rank=rank, device=device,
        stage=AxisView(n_stages, s, stage_lines[d], groups.get(stage_lines[d])),
        data=AxisView(n_data, d, data_lines[s], groups.get(data_lines[s])),
    )


def pipeline_axis_sizes(mesh) -> Tuple[int, int]:
    """(n_stages, n_data) of a ``make_pipeline_mesh`` mesh."""
    if not isinstance(mesh, PipelineMesh):
        raise ValueError(
            f"mesh {_axis_names(mesh)} has no {STAGE_AXIS!r} axis — build it "
            "with make_pipeline_mesh")
    return mesh.stage.size, mesh.data.size


@dataclasses.dataclass(frozen=True)
class HierMesh:
    """One rank's view of the (host, data) mesh of the hierarchical ring,
    and an axis view over the whole world (``size``, ``index``, ``ranks``,
    ``group``: the default group)."""

    world: int
    rank: int
    device: torch.device
    host: AxisView
    data: AxisView
    # The group over the whole mesh when it is a prefix of a larger
    # spawned world (make_elastic_mesh); None is the default group.
    world_group: Any = None

    @property
    def shape(self):
        """JAX's ``dict(mesh.shape)``: ``{'host': H, 'data': D}``."""
        return {HOST_AXIS: self.host.size, DATA_AXIS: self.data.size}

    # The axis-view interface: the whole world, in rank order.
    @property
    def size(self) -> int:
        return self.world

    @property
    def index(self) -> int:
        return self.rank

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(range(self.world))

    @property
    def group(self):
        return self.world_group

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch: block h·D + d of H·D (JAX's
        ``P((host, data))``)."""
        return _rows(x, self.rank, self.world)


def make_hier_mesh(rank: int, world: int, device: torch.device,
                   n_hosts: int) -> HierMesh:
    """This rank's view of JAX's ``make_hier_mesh(n_hosts)`` over ``world``
    ranks: H = ``n_hosts`` rows of D = world // H, rank r = h·D + d. Every
    rank calls it after ``init_process_group`` (it makes the axis groups,
    the host columns then the data rows, in the same order on every
    rank)."""
    if n_hosts < 1 or world % n_hosts != 0:
        raise ValueError(
            f"host axis {n_hosts} does not divide device count {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    n_data = world // n_hosts
    h, d = divmod(rank, n_data)
    host_lines = [tuple(hh * n_data + dd for hh in range(n_hosts))
                  for dd in range(n_data)]
    data_lines = [tuple(hh * n_data + dd for dd in range(n_data))
                  for hh in range(n_hosts)]
    groups = _axis_groups((host_lines, data_lines), world)
    return HierMesh(
        world=world, rank=rank, device=device,
        host=AxisView(n_hosts, h, host_lines[d], groups.get(host_lines[d])),
        data=AxisView(n_data, d, data_lines[h], groups.get(data_lines[h])),
    )


def spawned() -> Tuple[int, int]:
    """(this process's rank, the spawned world) of the default group; (0,
    1) outside any."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _prefix_group(line: Tuple[int, ...], reachable: int):
    """The group of a line of the spawned world: none for one rank, the
    default group for all of them, else a new one (every spawned rank
    calls this, in the same order)."""
    if len(line) <= 1 or len(line) == reachable:
        return None
    return dist.new_group(list(line))


def make_elastic_mesh(world: int, *, n_hosts: int = 1,
                      device: Optional[torch.device] = None,
                      cache: Optional[dict] = None):
    """This rank's view of JAX's ``make_elastic_mesh(world, n_hosts=)``:
    the mesh over the first ``world`` ranks of the spawned world (rank
    order is JAX's (process_index, id) order), hierarchical
    (``HierMesh``, H = ``n_hosts`` rows) when ``n_hosts > 1`` divides
    ``world``, a flat ``DataMesh`` otherwise; None on a rank outside the
    survivors. Every spawned rank calls it with the same arguments (it
    makes the mesh's groups). ``cache`` (a dict the caller keeps) holds
    one view per (world, hosts): a topology already seen makes no new
    group."""
    rank, reachable = spawned()
    if world < 1:
        raise ValueError(f"elastic world must be >= 1, got {world}")
    if world > reachable:
        raise ValueError(
            f"elastic world {world} exceeds the {reachable} "
            "reachable devices")
    hier = n_hosts > 1 and world % n_hosts == 0
    key = (world, n_hosts if hier else 1)
    if cache is not None and key in cache:
        return cache[key]
    device = device if device is not None else torch.device("cpu")
    mesh = None
    if hier:
        n_data = world // n_hosts
        host_lines = [tuple(hh * n_data + dd for hh in range(n_hosts))
                      for dd in range(n_data)]
        data_lines = [tuple(hh * n_data + dd for dd in range(n_data))
                      for hh in range(n_hosts)]
        lines = dict.fromkeys((*host_lines, *data_lines, tuple(range(world))))
        groups = {line: _prefix_group(line, reachable) for line in lines}
        if rank < world:
            h, d = divmod(rank, n_data)
            mesh = HierMesh(
                world=world, rank=rank, device=device,
                host=AxisView(n_hosts, h, host_lines[d], groups[host_lines[d]]),
                data=AxisView(n_data, d, data_lines[h], groups[data_lines[h]]),
                world_group=groups[tuple(range(world))])
    else:
        line = tuple(range(world))
        group = _prefix_group(line, reachable)
        if rank < world:
            whole = world == reachable
            mesh = DataMesh(world=world, rank=rank, device=device,
                            line=None if whole else line,
                            line_group=None if whole else group)
    if cache is not None:
        cache[key] = mesh
    return mesh


def _axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, Mesh2D):
        return (DATA_AXIS, "model")
    if isinstance(mesh, PipelineMesh):
        return (STAGE_AXIS, DATA_AXIS)
    if isinstance(mesh, HierMesh):
        return (HOST_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def hier_axis_sizes(mesh) -> Tuple[int, int]:
    """(n_hosts, n_devices_per_host) of a ``make_hier_mesh`` mesh."""
    if not isinstance(mesh, HierMesh):
        raise ValueError(
            f"mesh {_axis_names(mesh)} has no {HOST_AXIS!r} axis — build it "
            "with make_hier_mesh")
    return mesh.host.size, mesh.data.size


def as_mesh_2d(mesh) -> Mesh2D:
    """``mesh`` as a ``Mesh2D``: itself, or a ``DataMesh`` as the
    ``world × 1`` mesh (its data axis over the default group)."""
    if isinstance(mesh, Mesh2D):
        return mesh
    return Mesh2D(world=mesh.world, rank=mesh.rank, device=mesh.device,
                  data=AxisView(mesh.world, mesh.rank, mesh.ranks, None),
                  model=AxisView(1, 0, (mesh.rank,)))


def shard_batch(mesh, batch: Any) -> Any:
    """This rank's rows of each tensor of a (tree of) global batch(es)
    (JAX's ``shard_batch``, ``P(DATA_AXIS)``), on the rank's device."""
    return tree_map(lambda x: mesh.shard_rows(x).to(mesh.device), batch)


def replicate(mesh, tree: Any) -> Any:
    """A copy of ``tree`` on the rank's device (JAX's ``replicate``: every
    rank holds the whole tree). Always a copy, so the caller's tensors are
    never the step's."""
    return tree_map(lambda x: x.detach().to(mesh.device).clone(), tree)


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k ≥ n (batch padding for even data-axis shards)."""
    return k * math.ceil(n / k)

