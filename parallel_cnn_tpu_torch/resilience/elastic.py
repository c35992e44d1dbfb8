"""Elastic training runtime: in-flight re-mesh and ZeRO-3 reshard (the
port of ``parallel_cnn_tpu/resilience/elastic.py``).

On a resize request (``preempt.request_resize``), a chaos-injected device
loss or add (``resize@STEP:±K``) or a schedule entry, the
``ElasticController``:

1. **quiesces** at the optimizer-step boundary (the trainer polls
   ``pending()`` before each step; ``resize()`` opens with a device
   synchronize, so the last step has landed);
2. **snapshots** the state through ``zoo.zero3_full_view``, the
   world-size-independent full view; when that fails it **falls back** to
   the newest loadable sharded checkpoint in the ring
   (``CheckpointRing.restore_latest_sharded``), losing the steps since the
   ring's last save;
3. **re-meshes** over the surviving ranks: the resize is a plan
   derivation (``plan.derive_resized``: the first ``world`` ranks,
   hierarchical while the host count divides the world, a flat ring
   otherwise), and the derived plan builds the mesh
   (``ExecutionPlan.make_mesh``, ``mesh.make_elastic_mesh`` underneath);
4. **reshards** the parameters and momentum for the new world
   (``zoo.zero3_state_from_view``) and hands the trainer the new (state,
   plan, mesh, comm) to rebuild its step from, with the LR and global
   batch of the scaling policy.

A resize that takes zero optimizer steps is bit-exact, and under the
"global" policy a resized run follows the fixed-world run to reduction-
order roundoff (on a model without BatchNorm: ring-comm BN statistics are
per shard, so a BN model genuinely depends on the world).

One process a rank. JAX's controller lives in the one process that owns
every device; the port's runs on every spawned rank, and the ranks agree:

- **Reachable ranks** are the spawned world (one rank a card on the GPU,
  ``--mesh-data`` gloo ranks on the CPU; JAX's ``len(jax.devices())``). A
  rank outside the current world holds no state, walks the same steps and
  rejoins when the world grows. Survivors are the first ranks, so rank 0
  always survives and stays the lead.
- **Triggers.** The schedule and chaos are deterministic on every rank
  (each rank's monkey consumes its trigger once); the preempt channel is
  per process, so rank 0's request is broadcast each step over a gloo
  control group (one int; only while the controller exists).
- **The snapshot** is a collective over the old world: leaving ranks take
  part. Whether every rank's snapshot succeeded is agreed; on a failure
  rank 0 alone restores from its ring. The view is then broadcast from
  rank 0 to every spawned rank when a rank joins or the view came from
  the ring (a rank that stays already holds the identical gathered view).
- **Groups** come from the derived plan's ``make_mesh`` with the
  controller's cache: a topology seen before reuses its groups.

The controller carries the run's ExecutionPlan (``exec_plan``, JAX's),
and after each resize the derived one; with none it derives from an
empty plan, as JAX does. The trainer keys its step cache on the same
derivation (train/zoo.py, ``plan_step_cache`` events), so a resize back
to a topology already seen reuses both the groups and the step.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.config import CommConfig, ElasticConfig
from parallel_cnn_tpu_torch.parallel import mesh as mesh_lib
from parallel_cnn_tpu_torch.resilience import preempt

log = logging.getLogger(__name__)


class ElasticError(RuntimeError):
    """A resize could not complete (no live state AND no loadable ring
    checkpoint): the run cannot continue on the surviving topology."""


@dataclasses.dataclass
class ResizeEvent:
    """One completed resize, as recorded on ``ElasticController.events``."""

    step: int
    old_world: int
    new_world: int
    old_hosts: int
    new_hosts: int
    source: str  # "schedule" | "chaos" | "signal" | "direct"
    from_ring: bool = False
    seconds: float = 0.0


def _materialize(view) -> Dict[str, torch.Tensor]:
    """A host copy of a full view: every tensor read now (JAX's numpy
    copy), and the ring fallback's restore template."""
    return {k: torch.as_tensor(v).detach().cpu().clone() for k, v in view.items()}


class ElasticController:
    """Consumes resize triggers and rebuilds (state, plan, mesh, comm).

    Trigger sources, polled per optimizer step in priority order: the
    preempt resize channel (rank 0's, agreed), the chaos harness
    (``ChaosMonkey(resize_delta=(step, ±k))``), the schedule
    (``ElasticConfig.schedule``). Targets are clamped to
    [``cfg.min_world``, reachable ranks], the clamp logged. The
    controller owns no step: the trainer rebuilds its step from what
    ``resize()`` returns.

    ``reachable`` is the spawned world (default: the default group's
    size, 1 outside any); ``world`` the ranks active at the start (the
    first ``world``); ``device`` this rank's (default: its card under
    NCCL, else the host).
    """

    def __init__(
        self,
        cfg: ElasticConfig,
        *,
        world: int,
        n_hosts: int = 1,
        chaos=None,
        ring=None,
        obs: Optional["obs_lib.Obs"] = None,
        reachable: Optional[int] = None,
        device: Optional[torch.device] = None,
        exec_plan=None,
    ):
        self.cfg = cfg
        self.world = world
        self.n_hosts = n_hosts
        # The ExecutionPlan this run resolved (plan/): a resize is
        # derive_resized(plan, new_world) → make_mesh, so the topology
        # decision lives in one place.
        self.exec_plan = exec_plan
        self.world0 = world  # scaling baseline for "per-device" policy
        self.chaos = chaos
        self.ring = ring
        self.obs = obs if obs is not None else obs_lib.NOOP
        self.rank, spawned = mesh_lib.spawned()
        self.reachable = reachable if reachable is not None else spawned
        if device is None:  # the rank's card under NCCL, else the host
            nccl = dist.is_initialized() and dist.get_backend() == "nccl"
            device = (torch.device("cuda", torch.cuda.current_device()) if nccl
                      else torch.device("cpu"))
        self.device = device
        self.events: List[ResizeEvent] = []
        self._schedule = list(cfg.plan())
        self._last_source = "direct"
        self._template = None  # host full view for the ring fallback
        # One mesh view per (world, hosts) topology (the derived plans'
        # make_mesh).
        self.meshes: Dict[Tuple[int, int], Any] = {}
        # Host-side agreement among the spawned ranks (a few ints a step).
        self._ctl = (dist.new_group(backend="gloo")
                     if spawned > 1 else None)

    # -- scaling policy -------------------------------------------------

    def lr_for(self, base_lr: float) -> float:
        """The LR the rebuilt step should use: the base LR under "global";
        scaled linearly with the world under "per-device"."""
        if self.cfg.scaling == "per-device":
            return base_lr * self.world / self.world0
        return base_lr

    def global_batch_for(self, base_batch: int) -> int:
        """The global batch for the current world: fixed under "global";
        under "per-device" the original per-rank batch times the world."""
        if self.cfg.scaling == "per-device":
            return max(1, base_batch // self.world0) * self.world
        return base_batch

    # -- agreement among the spawned ranks ------------------------------

    def _broadcast_int(self, value: int) -> int:
        """Rank 0's ``value`` on every spawned rank."""
        if self._ctl is None:
            return value
        t = torch.tensor([value], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self._ctl)
        return int(t.item())

    def _all(self, flag: bool) -> bool:
        """True on every spawned rank iff true on all of them."""
        if self._ctl is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._ctl)
        return bool(t.item())

    def _poll_signal(self) -> Optional[int]:
        """Rank 0's pending preempt resize request, consumed (a request
        made on another rank is dropped: the channel is rank 0's)."""
        local = preempt.clear_resize()
        if self.rank != 0:
            local = None
        got = self._broadcast_int(local or 0)
        return got or None

    # -- trigger polling ------------------------------------------------

    def _n_reachable(self) -> int:
        return self.reachable

    def _clamp(self, world: int) -> int:
        return max(self.cfg.min_world, min(world, self._n_reachable()))

    def pending(self, step: int) -> Optional[int]:
        """The target world size to resize to before optimizer step
        ``step``, or None. Consumes the trigger it reports; the same
        answer on every spawned rank."""
        requested = self._poll_signal()
        if requested is not None:
            self._last_source = "signal"
        elif self.chaos is not None:
            delta = self.chaos.resize_at(step)
            if delta is not None:
                requested = self.world + delta
                self._last_source = "chaos"
        if requested is None and self._schedule \
                and step >= self._schedule[0][0]:
            requested = self._schedule.pop(0)[1]
            self._last_source = "schedule"
        if requested is None:
            return None
        target = self._clamp(requested)
        if target != requested:
            log.warning(
                "elastic: resize request to %d clamped to %d "
                "(min_world=%d, reachable=%d)",
                requested, target, self.cfg.min_world, self._n_reachable(),
            )
        if target == self.world:
            log.info(
                "elastic: resize to %d is a no-op at world %d — skipped",
                target, self.world,
            )
            return None
        self._requested = requested
        return target

    # -- the resize itself ----------------------------------------------

    def plan_for(self, world: int, n_hosts: int = 1):
        """The ExecutionPlan a resize to ``world`` lands on
        (``derive_resized`` of the run's plan; an empty plan without one)."""
        from parallel_cnn_tpu_torch import plan as plan_lib

        return plan_lib.derive_resized(
            self.exec_plan or plan_lib.ExecutionPlan(), world, n_hosts=n_hosts)

    def mesh_for(self, world: int, n_hosts: int = 1):
        """This rank's mesh over the first ``world`` ranks (None outside
        them): the derived plan's, from the topology cache; every spawned
        rank calls it."""
        return self.plan_for(world, n_hosts).make_mesh(
            self.rank, world, self.device, cache=self.meshes)

    def register_template(self, view) -> None:
        """Seed the ring-fallback restore template from a healthy full
        view (world-size independent, so it never goes stale). Rank 0
        alone keeps it: the ring is rank 0's."""
        if self.rank == 0:
            self._template = _materialize(view)

    def _snapshot(self, state) -> Tuple[Optional[Dict[str, torch.Tensor]], bool]:
        """(full view on this rank, from_ring). Live state first, agreed
        over the spawned ranks; the checkpoint ring (rank 0's) when any
        rank's live snapshot failed. A rank outside the old world
        contributes no view."""
        from parallel_cnn_tpu_torch.train import zoo

        view, ok = None, True
        if state is not None and state.zero3 is not None:
            try:
                view = zoo.zero3_full_view(state)
            except Exception as e:  # lost shards, a failed collective
                ok = False
                log.warning(
                    "elastic: live snapshot failed (%s: %s) — falling back "
                    "to the checkpoint ring", type(e).__name__, e,
                )
        if self._all(ok):
            return view, False
        restored = None
        if self.rank == 0 and self.ring is not None and self._template is not None:
            restored = self.ring.restore_latest_sharded(self._template)
        if self.rank == 0 and (self.ring is None or self._template is None):
            have = -1
        else:
            have = int(restored is not None)
        have = self._broadcast_int(have)
        if have == -1:
            raise ElasticError(
                "resize needs a state snapshot, but the live shards are "
                "unreachable and no checkpoint ring is configured — "
                "train with checkpoint_dir to make device loss survivable"
            )
        if have == 0:
            raise ElasticError(
                "resize needs a state snapshot, but the live shards are "
                "unreachable and no ring checkpoint loads (see the "
                "skipped-file warnings above for per-file rank/world "
                "coordinates)"
            )
        if restored is not None:
            view, _state, _zmeta, path = restored
            log.warning("elastic: resharding from ring checkpoint %s", path)
        return view, True

    def _share(self, view, like) -> Dict[str, torch.Tensor]:
        """Rank 0's view on every spawned rank (``like`` the structure
        on ranks that hold none), on this rank's device."""
        if view is None:
            view = like
        view = {k: torch.as_tensor(v).to(self.device) for k, v in view.items()}
        if self.reachable > 1:
            for k in sorted(view):
                view[k] = view[k].contiguous()
                dist.broadcast(view[k], src=0)
        return view

    def resize(
        self,
        step: int,
        world: int,
        *,
        state,
        plan=None,
        comm: CommConfig,
        n_hosts: Optional[int] = None,
        model=None,
        optimizer=None,
    ):
        """Reshard for ``world`` ranks; (state, plan, mesh, comm), with
        state, plan and mesh None on a rank outside the new world.

        ``state`` is this rank's ZeRO-3 ``ZooState`` (None on a rank that
        holds none; then ``model`` and ``optimizer`` say what a joining
        rank builds). ``plan`` (the ZeRO-3 bucket plan) is accepted for
        JAX's signature: the port's state carries it. The new topology is
        ``derive_resized`` of the controller's ExecutionPlan, which it
        keeps (``exec_plan``). ``n_hosts`` pins the new host-axis
        size; the default keeps the current host count while it divides
        the new world, else a flat ring. The returned comm has its impl
        switched to the new topology (ring ↔ hierarchical), every other
        knob kept. Every spawned rank calls it, with the same arguments
        but its own state."""
        from parallel_cnn_tpu_torch.train import zoo

        if n_hosts is None:
            n_hosts = self.n_hosts if (
                self.n_hosts > 1 and world % self.n_hosts == 0
            ) else 1
        if world % n_hosts != 0:
            raise ValueError(
                f"elastic world {world} is not divisible by "
                f"n_hosts {n_hosts}"
            )
        if world > self.reachable:
            raise ValueError(
                f"elastic world {world} exceeds the {self.reachable} "
                "reachable devices")
        if state is not None:
            model, optimizer = state.model, state.optimizer
        if model is None:
            raise ValueError("a rank without state needs model= and optimizer=")
        t0 = time.perf_counter()
        old_world, old_hosts = self.world, self.n_hosts
        source = self._last_source
        self._last_source = "direct"
        if self.obs.enabled:
            self.obs.event(
                "resize_begin", step=step, old_world=old_world,
                new_world=world, old_hosts=old_hosts, new_hosts=n_hosts,
                requested=getattr(self, "_requested", world),
                source=source,
            )
        with self.obs.span(
            "train.resize", cat="train",
            old_world=old_world, new_world=world,
        ):
            # Quiesce: every launched step has landed before the resident
            # rows are read.
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            view, from_ring = self._snapshot(state)
            if from_ring or world > old_world:
                view = self._share(view, zoo.zero3_view_like(model, self.device))
            new_exec_plan = self.plan_for(world, n_hosts)
            mesh = new_exec_plan.make_mesh(self.rank, world, self.device,
                                           cache=self.meshes)
            has_host = new_exec_plan.comm_impl == "hierarchical"
            new_comm = dataclasses.replace(
                comm,
                impl="hierarchical" if has_host else "ring",
                hosts=n_hosts if has_host else None,
            )
            new_hosts = n_hosts if has_host else 1
            new_state = new_plan = None
            if mesh is not None:
                new_state, new_plan = zoo.zero3_state_from_view(
                    model, optimizer, view, mesh=mesh,
                    bucket_bytes=comm.bucket_bytes)
        self.world, self.n_hosts = world, new_hosts
        self.exec_plan = new_exec_plan
        if view is not None and self._template is None:
            # JAX re-registers the view after every resize; its structure
            # is all the fallback reads, and it never changes, so the
            # host copy (most of a resize's time on rank 0) is made once.
            self.register_template(view)
        ev = ResizeEvent(
            step=step, old_world=old_world, new_world=world,
            old_hosts=old_hosts, new_hosts=new_hosts, source=source,
            from_ring=from_ring, seconds=time.perf_counter() - t0,
        )
        self.events.append(ev)
        if self.obs.enabled:
            self.obs.event(
                "resize_done", step=step, old_world=old_world,
                new_world=world, old_hosts=old_hosts,
                new_hosts=new_hosts, from_ring=from_ring,
                seconds=round(ev.seconds, 6), source=source,
            )
        if self.rank == 0:
            log.warning(
                "elastic: resized %dx%d -> %dx%d at step %d (%s%s, %.3fs)",
                old_hosts, old_world // max(old_hosts, 1), new_hosts,
                world // new_hosts, step, source,
                ", from ring" if from_ring else "", ev.seconds,
            )
        return new_state, new_plan, mesh, new_comm
