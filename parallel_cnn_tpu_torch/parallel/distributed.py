"""Start a mesh of ranks: one process per rank, each with a
``torch.distributed`` process group (the port's counterpart of
``parallel_cnn_tpu/parallel/distributed.py``, JAX's multi-process
bring-up, and of the device mesh JAX builds inside one process).

``run(fn, world, device=...)`` calls ``fn(mesh, *args)`` on every rank and
returns each rank's result, rank 0's first. ``mesh`` is the rank's
``DataMesh`` or, with ``plan=`` (an ``ExecutionPlan``, pickled into every
rank), the mesh the plan makes (``ExecutionPlan.make_mesh``: the pipeline's ``PipelineMesh``,
the hierarchical ring's ``HierMesh``, a ``Mesh2D`` or a ``DataMesh``; the
axis groups made on every rank). The trainer's CLI launches every mesh
from its validated plan, so a rank never re-resolves flags or
environment. The rendezvous is explicit: a
``file://`` store in a fresh temporary directory, with the world size and
each rank given by the launcher; nothing is read from the environment.
The backend is NCCL on cuda, rank r on ``cuda:r``, and gloo on the CPU.

A world of one runs in the calling process, so what it counts (kernel
launches) stays readable there. A larger world is spawned with
``torch.multiprocessing``; a rank that raises fails the whole run (the
others are stopped) and ``run`` raises, and ``timeout`` bounds the wait.
More ranks than cards is an error (``MeshSizeError``): NCCL refuses two
ranks on one card, and the port never falls back to the CPU. A mesh of
data × model ranks takes data × model cards.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from parallel_cnn_tpu_torch.config import MeshConfig
from parallel_cnn_tpu_torch.parallel.mesh import DataMesh
from parallel_cnn_tpu_torch.utils.backend import DeviceLike, resolve_device

#: How long a collective may wait for a peer before the group gives up.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)

#: Gloo ranks a host of the hierarchical mesh on the CPU (``--device cpu``
#: emulates H hosts of this many ranks on one machine).
CPU_RANKS_PER_HOST = 2


class MeshSizeError(ValueError):
    """The mesh asks for more ranks than there are cards."""


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def resolve_shape(mesh: MeshConfig, device: DeviceLike = None) -> Tuple[int, int]:
    """(data, model) for ``mesh`` on ``device`` (the LeNet mesh and the
    zoo's GSPMD mesh alike: data × model ranks): ``data=None`` means every
    visible card the model axis leaves (on the CPU: one data rank). Raises
    MeshSizeError above the card count."""
    dev = resolve_device(device)
    model = mesh.model
    if dev.type == "cpu":
        return mesh.data or 1, model
    cards = torch.cuda.device_count()
    data = mesh.data or max(cards // model, 1)
    world = data * model
    if world > cards:
        raise MeshSizeError(
            f"--mesh-data {data} --mesh-model {model} needs {world} cards but "
            f"{cards} {'is' if cards == 1 else 'are'} visible: NCCL takes one "
            "rank per card (no oversubscription, no CPU fallback)"
        )
    return data, model


def resolve_pipeline_shape(n_stages: int, device: DeviceLike = None) -> Tuple[int, int]:
    """(stages, data) of JAX's ``make_pipeline_mesh(n_stages)`` over every
    visible card: D = cards // S (on the CPU: one data rank, S gloo ranks).
    More stages than cards raises MeshSizeError; a stage count that does
    not divide the cards, JAX's ValueError."""
    if n_stages < 1:
        raise ValueError(f"stages must be >= 1, got {n_stages}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return n_stages, 1
    cards = torch.cuda.device_count()
    if n_stages > cards:
        raise MeshSizeError(
            f"--pipeline-stages {n_stages} needs {n_stages} cards (a rank a "
            f"stage) but {cards} {'is' if cards == 1 else 'are'} visible: NCCL "
            "takes one rank per card (no oversubscription, no CPU fallback)")
    if cards % n_stages:
        raise ValueError(
            f"stage axis {n_stages} does not divide device count {cards}")
    return n_stages, cards // n_stages


def resolve_hier_shape(hosts: Optional[int], device: DeviceLike = None
                       ) -> Tuple[int, int]:
    """(hosts, data) of JAX's ``make_hier_mesh(hosts)`` over every visible
    card: H rows of D = cards // H, one NCCL rank a card (``hosts`` None
    is one host: every card in one row). On the CPU, H hosts of
    ``CPU_RANKS_PER_HOST`` gloo ranks each. More hosts than cards raises
    MeshSizeError; a host count that does not divide the cards, JAX's
    ValueError."""
    n_hosts = 1 if hosts is None else hosts
    if n_hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {n_hosts}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return n_hosts, CPU_RANKS_PER_HOST
    cards = torch.cuda.device_count()
    if n_hosts > cards:
        raise MeshSizeError(
            f"--comm-hosts {n_hosts} needs at least {n_hosts} cards (a rank a "
            f"card) but {cards} {'is' if cards == 1 else 'are'} visible: NCCL "
            "takes one rank per card (no oversubscription, no CPU fallback)")
    if cards % n_hosts:
        raise ValueError(
            f"host axis {n_hosts} does not divide device count {cards}")
    return n_hosts, cards // n_hosts


def resolve_world(mesh: MeshConfig, device: DeviceLike = None) -> int:
    """The number of ranks for ``mesh`` on ``device``: data × model (see
    ``resolve_shape``)."""
    data, model = resolve_shape(mesh, device)
    return data * model


def _init_rank(rank: int, world: int, init_method: str, device_type: str,
               plan):
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        if world > 1:  # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(backend_for(device_type), init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    if plan is not None:
        return plan.make_mesh(rank, world, device)
    return DataMesh(world=world, rank=rank, device=device)


def _run_rank(rank: int, fn: Callable, world: int, init_method: str,
              device_type: str, args: Sequence[Any], plan) -> Any:
    mesh = _init_rank(rank, world, init_method, device_type, plan)
    try:
        return fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def _spawned_rank(rank: int, fn: Callable, world: int, init_method: str,
                  device_type: str, args: Sequence[Any], out_dir: str,
                  plan) -> None:
    result = _run_rank(rank, fn, world, init_method, device_type, args, plan)
    tmp = Path(out_dir) / f"result_{rank}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, Path(out_dir) / f"result_{rank}.pkl")


def run(fn: Callable, world: int, *, device: DeviceLike = None,
        args: Sequence[Any] = (), timeout: Optional[float] = None,
        plan=None) -> List[Any]:
    """``fn(mesh, *args)`` on each of ``world`` ranks; their results in rank
    order. ``plan`` (an ``ExecutionPlan``) gives each rank the mesh
    ``plan.make_mesh`` makes for it, no plan a ``DataMesh``. ``fn`` and ``args`` must pickle (a
    module-level function) when ``world > 1``. Raises what a rank raised,
    or TimeoutError after ``timeout`` seconds (the ranks are stopped either
    way)."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise MeshSizeError(
            f"a world of {world} needs {world} cards, "
            f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="pcnn_dp_") as tmp:
        init_method = Path(tmp, "rendezvous").as_uri()
        if world == 1:
            return [_run_rank(0, fn, 1, init_method, dev.type, args, plan)]
        ctx = torch.multiprocessing.start_processes(
            _spawned_rank, args=(fn, world, init_method, dev.type, tuple(args), tmp,
                                 plan),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a world of {world} ranks did not finish in "
                        f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(timeout=30)
        results = []
        for rank in range(world):
            with open(Path(tmp) / f"result_{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
