"""Straggler-tolerant asynchronous data parallelism (the port of
``parallel_cnn_tpu/train/async_dp.py``).

Every other training mode is bulk-synchronous: the optimizer step is a
barrier, so one slow worker stalls the ring. ``config.AsyncConfig``
(``--async-mode`` / ``PCNN_ASYNC_MODE``) selects the two escapes:

- **Bounded staleness** (mode ``stale``, arXiv:1711.00705): a server holds
  the params at version V (one a step). A worker snapshots them at
  dispatch and computes its gradient on the snapshot; the server applies
  it only while the snapshot is at most ``staleness_bound`` (S) versions
  old, holding ready gradients (the hard barrier) only when advancing V
  would push an in-flight worker past S. A :class:`StalenessLedger`
  records every applied staleness and raises past S. S = 0 is the
  synchronous schedule, bit-exact with mode ``off``: both run one
  combine-and-apply over the same per-worker sums in worker-id order.
- **EASGD** (mode ``easgd``, arXiv:1605.08325): each worker runs its own
  local SGD and every ``easgd_period`` local steps pulls against a center
  held in the bucket layout of parallel/collectives.py (``x_i ← x_i −
  ρ(x_i − c)``, ``c ← c + ρ(x_i − c)``). :func:`easgd_round_sharded` is
  the round a deployment of several ranks runs: the center's shards
  all-gathered and the deltas reduce-scattered over the ring, f32 on the
  wire.

**The schedule is a deterministic virtual clock**: N logical workers with
real gradients and virtual durations (``step_ms`` a dispatch, plus a
chaos ``slow-worker@STEP:MS`` stall, keyed on the global dispatch
sequence), completions taken in (virtual time, worker id) order. The
schedule (virtual_ms, microbatches, steps, stragglers, ledger) is JAX's
exactly; the losses and params carry float roundoff.

Gradients: ``ops_path="reference"`` the plain ops (``step.local_grad_sums``,
as JAX's CLI runs it), ``"cuda"`` the fused LeNet kernel (B1,
csrc/lenet_fused.cu; JAX's ``"pallas"``), one launch a gradient on a CUDA
tensor. A NaN (chaos ``nan@K`` poisons the K-th computed gradient) is
caught by the sentinel before the server or center sees it: stale drops
it and re-dispatches the worker, easgd drops it and resets the worker
from the center.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Tuple

import torch

from parallel_cnn_tpu_torch.config import AsyncConfig
from parallel_cnn_tpu_torch.obs import NOOP
from parallel_cnn_tpu_torch.ops.activations import apply_grad
from parallel_cnn_tpu_torch.parallel import collectives
from parallel_cnn_tpu_torch.train import step as step_lib
from parallel_cnn_tpu_torch.utils.tree import tree_map


# --------------------------------------------------------------------------
# Staleness ledger
# --------------------------------------------------------------------------


class StalenessLedger:
    """Per-worker record of the staleness of every *applied* gradient;
    ``record`` raises if a gap ever exceeds the bound."""

    def __init__(self, workers: int, bound: int):
        self.bound = bound
        self.entries: List[List[int]] = [[] for _ in range(workers)]

    def record(self, worker: int, staleness: int) -> None:
        if staleness < 0 or staleness > self.bound:
            raise RuntimeError(
                f"staleness bound violated: worker {worker} applied a "
                f"gradient {staleness} versions old (bound {self.bound})"
            )
        self.entries[worker].append(staleness)

    def max_staleness(self) -> int:
        return max((max(e) for e in self.entries if e), default=0)

    def total_applied(self) -> int:
        return sum(len(e) for e in self.entries)


@dataclasses.dataclass
class AsyncRunResult:
    """What one virtual-clock training run produced."""

    params: Any                 # final authoritative params (server/center)
    ledger: StalenessLedger     # empty for easgd (no versioned server)
    virtual_ms: float           # virtual time consumed
    microbatches: int           # gradient microbatches applied
    server_steps: int           # optimizer steps (stale/sync) / rounds sum
    losses: List[float]         # per-apply mean err (stale/sync)
    stragglers: int             # straggler_detected count
    dropped: int                # NaN contributions dropped by the sentinel
    easgd_rounds: int           # elastic-averaging rounds executed

    def throughput(self) -> float:
        """Microbatches per virtual millisecond (0 if nothing ran)."""
        return self.microbatches / self.virtual_ms if self.virtual_ms else 0.0


# --------------------------------------------------------------------------
# Numerics: shared by every mode, so the parity claims are structural
# --------------------------------------------------------------------------


def _grad_sums(params, x, y, ops_path="reference"):
    return step_lib.local_grad_sums(params, x, y, ops_path=ops_path)


def _apply_mean(params, grad_sums, n: int, dt: float):
    return apply_grad(params, tree_map(lambda g: g / n, grad_sums), dt)


def _tree_add(a, b):
    return tree_map(torch.add, a, b)


def _easgd_pull(worker_buckets, center_buckets, rho):
    """One elastic round on the bucket layout: the worker and the center
    each move ρ of the way toward the other (arXiv:1605.08325 eq. 5/6)."""
    deltas = [rho * (w - c) for w, c in zip(worker_buckets, center_buckets)]
    new_w = [w - d for w, d in zip(worker_buckets, deltas)]
    new_c = [c + d for c, d in zip(center_buckets, deltas)]
    return new_w, new_c


def eval_err(params, x, y) -> torch.Tensor:
    """Mean err of ``params`` on a fixed batch (plain ops): the loss the
    sync-vs-async comparisons use."""
    err_sum, _ = step_lib.local_grad_sums(params, x, y)
    return err_sum / x.shape[0]


def easgd_round_sharded(worker_flat: torch.Tensor, center_shard: torch.Tensor,
                        rho: torch.Tensor, *, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """One elastic round over a data axis (``mesh``, a ``DataMesh`` or
    ``AxisView``; JAX's ``axis_name``/``axis_size``), on every rank of it.

    Each rank holds its worker's whole flat params (``worker_flat``,
    ``n · shard_len``) and its 1/n row shard of the center. Pull: the ring
    all-gathers the center and the worker moves ρ toward it. Push: the
    deltas are ring reduce-scattered onto the shards, so the center moves
    ρ toward the mean worker. Both f32 on the wire (the center is master
    state)."""
    center = collectives.ring_all_gather(center_shard, mesh)
    delta = rho * (worker_flat - center)
    new_worker = worker_flat - delta
    d_shard = collectives.ring_reduce_scatter(delta, mesh)
    new_center_shard = center_shard + d_shard / float(mesh.size)
    return new_worker, new_center_shard


# --------------------------------------------------------------------------
# Virtual-clock scheduler
# --------------------------------------------------------------------------


def _healthy(sentinel, grads) -> bool:
    if sentinel is None:
        return True
    return bool(sentinel.check(grads=grads).healthy)


class _Dispatcher:
    """Per-run dispatch bookkeeping: the global dispatch sequence the
    chaos hook keys on, straggler detection, and the journal."""

    def __init__(self, step_ms: float, factor: float, chaos, obs):
        self.step_ms = step_ms
        self.factor = factor
        self.chaos = chaos
        self.obs = obs
        self.seq = 0
        self.stragglers = 0

    def duration(self, worker: int) -> float:
        """Virtual duration of the next dispatch (nominal + chaos stall),
        advancing the global dispatch sequence."""
        seq, self.seq = self.seq, self.seq + 1
        stall = self.chaos.slow_worker_at(seq) if self.chaos else None
        if stall:
            if self.obs.enabled:
                self.obs.event(
                    "chaos_slow_worker", seq=seq, worker=worker, ms=stall
                )
            return self.step_ms + stall
        return self.step_ms

    def completed(self, worker: int, duration: float) -> None:
        if duration > self.factor * self.step_ms:
            self.stragglers += 1
            if self.obs.enabled:
                self.obs.event(
                    "straggler_detected", worker=worker, ms=duration,
                    nominal_ms=self.step_ms,
                )


def run_async(
    params: Any,
    xs: torch.Tensor,
    ys: torch.Tensor,
    *,
    cfg: AsyncConfig,
    dt: float = 0.05,
    step_ms: float = 100.0,
    horizon_ms: Optional[float] = None,
    max_server_steps: Optional[int] = None,
    chaos=None,
    sentinel=None,
    obs=None,
    ops_path: str = "reference",
) -> AsyncRunResult:
    """Run the virtual-clock async/sync trainer to a horizon.

    ``xs``/``ys`` carry one microbatch per worker, ``(workers, b, ...)`` /
    ``(workers, b)``, on the device the gradients run on; each worker
    re-reads its shard every local step. Exactly one of ``horizon_ms``
    (throughput runs) and ``max_server_steps`` (loss-trajectory runs:
    optimizer steps for sync/stale, local steps a worker for easgd) must
    be given. Gradients are real, time is virtual (module docstring).
    """
    if (horizon_ms is None) == (max_server_steps is None):
        raise ValueError("give exactly one of horizon_ms/max_server_steps")
    if xs.shape[0] != cfg.workers or ys.shape[0] != cfg.workers:
        raise ValueError(
            f"data leading dim {xs.shape[0]} != workers {cfg.workers}"
        )
    obs = obs or NOOP
    if cfg.mode == "easgd":
        return _run_easgd(
            params, xs, ys, cfg=cfg, dt=dt, step_ms=step_ms,
            horizon_ms=horizon_ms, max_local_steps=max_server_steps,
            chaos=chaos, sentinel=sentinel, obs=obs, ops_path=ops_path,
        )
    return _run_stale(
        params, xs, ys, cfg=cfg, dt=dt, step_ms=step_ms,
        horizon_ms=horizon_ms, max_server_steps=max_server_steps,
        chaos=chaos, sentinel=sentinel, obs=obs, ops_path=ops_path,
    )


def _run_stale(
    params, xs, ys, *, cfg, dt, step_ms, horizon_ms, max_server_steps,
    chaos, sentinel, obs, ops_path,
) -> AsyncRunResult:
    """Bounded-staleness server (with mode="off", the synchronous
    reference: S=0 forces the barrier every step, lockstep rounds)."""
    w = cfg.workers
    bound = 0 if cfg.mode == "off" else cfg.staleness_bound
    disp = _Dispatcher(step_ms, cfg.straggler_factor, chaos, obs)
    ledger = StalenessLedger(w, bound)
    b = int(xs.shape[1])

    version = 0
    losses: List[float] = []
    dropped = 0
    microbatches = 0
    virtual_ms = 0.0

    # (completion_time, worker) min-heap; per-worker in-flight snapshots.
    heap: List[Tuple[float, int]] = []
    snap_params: Dict[int, Any] = {}
    snap_version: Dict[int, int] = {}
    dispatch_at: Dict[int, float] = {}
    # Completed-but-held contributions: worker -> (version, err_sum, grads)
    held: Dict[int, Tuple[int, Any, Any]] = {}

    def dispatch(worker: int, now: float) -> None:
        dur = disp.duration(worker)
        done = now + dur
        if horizon_ms is not None and done > horizon_ms:
            return  # would complete past the measurement horizon
        snap_params[worker] = params
        snap_version[worker] = version
        dispatch_at[worker] = now
        heapq.heappush(heap, (done, worker))

    for i in range(w):
        dispatch(i, 0.0)

    while heap:
        if max_server_steps is not None and version >= max_server_steps:
            break
        t_now, _ = heap[0]
        # Drain the whole group of completions at this virtual instant
        # (worker-id order is the heap tiebreak).
        group: List[int] = []
        while heap and heap[0][0] == t_now:
            _, worker = heapq.heappop(heap)
            group.append(worker)
        for worker in group:
            disp.completed(worker, t_now - dispatch_at[worker])
            err_sum, grads = _grad_sums(
                snap_params[worker], xs[worker], ys[worker], ops_path=ops_path,
            )
            if chaos is not None:
                grads, err_sum = chaos.after_step(grads, err_sum)
            if not _healthy(sentinel, grads):
                dropped += 1
                if obs.enabled:
                    obs.event(
                        "sentinel_drop", worker=worker,
                        version=snap_version[worker],
                    )
                # Re-snapshot healthy server params and go again.
                dispatch(worker, t_now)
                continue
            held[worker] = (snap_version[worker], err_sum, grads)

        # Hard barrier: applying a step bumps version; if that would doom
        # any still-in-flight snapshot past the bound, hold everything
        # until the laggard completes.
        in_flight = {wk for _, wk in heap}
        blocked = any(
            version + 1 - snap_version[j] > bound for j in in_flight
        )
        if blocked:
            if obs.enabled and held:
                obs.event(
                    "staleness", step=version, barrier=1,
                    held=len(held), t_ms=t_now,
                )
            virtual_ms = t_now
            continue
        if not held:
            virtual_ms = max(virtual_ms, t_now)
            continue

        # One optimizer step per virtual instant: combine every held
        # contribution in worker-id order and apply once.
        order = sorted(held)
        total_err = None
        total_grads = None
        group_stale = 0
        for worker in order:
            v, err_sum, grads = held[worker]
            staleness = version - v
            ledger.record(worker, staleness)
            group_stale = max(group_stale, staleness)
            total_err = err_sum if total_err is None else total_err + err_sum
            total_grads = (
                grads if total_grads is None else _tree_add(total_grads, grads)
            )
        n_total = b * len(order)
        params = _apply_mean(params, total_grads, n=n_total, dt=dt)
        version += 1
        microbatches += len(order)
        virtual_ms = t_now
        losses.append(float(total_err) / n_total)
        if obs.enabled:
            obs.event(
                "staleness", step=version, barrier=0,
                max_staleness=group_stale, workers=len(order), t_ms=t_now,
            )
        held.clear()
        if max_server_steps is not None and version >= max_server_steps:
            break
        for worker in order:
            dispatch(worker, t_now)

    return AsyncRunResult(
        params=params, ledger=ledger, virtual_ms=virtual_ms,
        microbatches=microbatches, server_steps=version, losses=losses,
        stragglers=disp.stragglers, dropped=dropped, easgd_rounds=0,
    )


def _run_easgd(
    params, xs, ys, *, cfg, dt, step_ms, horizon_ms, max_local_steps,
    chaos, sentinel, obs, ops_path,
) -> AsyncRunResult:
    """Elastic averaging: independent local SGD per worker, a ρ-pull
    against the bucketed center every ``easgd_period`` local steps. No
    inter-worker gate: the straggler delays only its own stream."""
    w = cfg.workers
    disp = _Dispatcher(step_ms, cfg.straggler_factor, chaos, obs)
    b = int(xs.shape[1])
    rho = torch.tensor(cfg.easgd_rho, dtype=torch.float32, device=xs.device)

    plan = collectives.plan_buckets(params, shards=w)
    center = [c.to(torch.float32)
              for c in collectives.flatten_buckets(params, plan)]
    worker_params = [params for _ in range(w)]
    local_steps = [0] * w
    dropped = 0
    rounds = 0
    microbatches = 0
    virtual_ms = 0.0

    heap: List[Tuple[float, int]] = []

    def dispatch(worker: int, now: float) -> None:
        if max_local_steps is not None \
                and local_steps[worker] >= max_local_steps:
            return
        dur = disp.duration(worker)
        done = now + dur
        if horizon_ms is not None and done > horizon_ms:
            return
        heapq.heappush(heap, (done, worker))

    dispatch_at: Dict[int, float] = {}
    for i in range(w):
        dispatch_at[i] = 0.0
        dispatch(i, 0.0)

    while heap:
        t_now, worker = heapq.heappop(heap)
        disp.completed(worker, t_now - dispatch_at[worker])
        err_sum, grads = _grad_sums(
            worker_params[worker], xs[worker], ys[worker], ops_path=ops_path
        )
        if chaos is not None:
            grads, err_sum = chaos.after_step(grads, err_sum)
        if not _healthy(sentinel, grads):
            # Poisoned local gradient: drop it and reset the worker from
            # the (never-poisoned) center.
            dropped += 1
            worker_params[worker] = collectives.unflatten_buckets(center, plan)
            if obs.enabled:
                obs.event(
                    "sentinel_drop", worker=worker,
                    local_step=local_steps[worker],
                )
        else:
            worker_params[worker] = _apply_mean(
                worker_params[worker], grads, n=b, dt=dt
            )
            local_steps[worker] += 1
            microbatches += 1
            if local_steps[worker] % cfg.easgd_period == 0:
                with obs.span("train.easgd_round", cat="comm",
                              worker=worker):
                    wb = collectives.flatten_buckets(worker_params[worker], plan)
                    new_w, center = _easgd_pull(wb, center, rho)
                    worker_params[worker] = collectives.unflatten_buckets(
                        new_w, plan
                    )
                rounds += 1
                if obs.enabled:
                    obs.event(
                        "easgd_round", worker=worker, round=rounds,
                        local_step=local_steps[worker], t_ms=t_now,
                    )
        virtual_ms = max(virtual_ms, t_now)
        dispatch_at[worker] = t_now
        dispatch(worker, t_now)

    return AsyncRunResult(
        params=collectives.unflatten_buckets(center, plan),
        ledger=StalenessLedger(w, 0), virtual_ms=virtual_ms,
        microbatches=microbatches, server_steps=rounds, losses=[],
        stragglers=disp.stragglers, dropped=dropped, easgd_rounds=rounds,
    )
