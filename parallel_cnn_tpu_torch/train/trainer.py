"""Epoch loops (the port of ``parallel_cnn_tpu/train/trainer.py``;
≙ learn() / test(), Sequential/Main.cpp:146-214).

Reproduces the reference's observable behaviour — "Learning", per-epoch
`error: %e, time_on_cpu: %f` lines, the threshold stop, `Time - %f` and
the final `Error Rate: %.2f%%` — with the epoch timed up to a readback of
its error from the device. The train split is placed on the device once
and each batch is gathered there by index.

Mesh routing (JAX's ``_maybe_mesh``): ``learn`` given a rank's ``Mesh2D``
(parallel/mesh.py) trains minibatch SGD over it — data-parallel
(parallel/data_parallel.py) when the model axis is 1, the hybrid
DP × model-parallel step (parallel/intra_op.py) otherwise. Every rank
draws the same fixed-shape (drop-tail) batch order from the epoch seed and
takes its rows; every verdict that stops or rolls back a run is agreed
over the world, so the ranks never part at a collective.

Chaos and obs (JAX's trainer.py:142, :269-335): a ``ChaosMonkey`` is
consulted after every optimizer step (the per-sample epoch counts as
one: ``nan@STEP`` poisons the params) and at every epoch boundary
(``kill@``/``kill9@``); an ``obs.Obs`` bundle gets JAX's ``train.epoch``
and ``train.readback`` spans, its ``verdict``, ``rollback``, ``epoch``,
``chaos`` and ``preempt`` events, and a ``train`` collector (epochs,
steps, rollbacks) on its metrics registry.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.config import Config, MeshLayoutError, TrainConfig
from parallel_cnn_tpu_torch.data import native, pipeline
from parallel_cnn_tpu_torch.models import lenet_ref
from parallel_cnn_tpu_torch.parallel import data_parallel, intra_op
from parallel_cnn_tpu_torch.resilience import preempt
from parallel_cnn_tpu_torch.resilience.rollback import RollbackController, tree_copy
from parallel_cnn_tpu_torch.resilience.sentinel import DivergenceError, Sentinel, Verdict
from parallel_cnn_tpu_torch.train import step as step_lib
from parallel_cnn_tpu_torch.utils.backend import DeviceLike, resolve_device
from parallel_cnn_tpu_torch.utils.timing import Stopwatch
from parallel_cnn_tpu_torch.utils.tree import tree_map

log = logging.getLogger(__name__)


@dataclass
class TrainResult:
    params: step_lib.Params
    epoch_errors: List[float] = field(default_factory=list)
    seconds: float = 0.0
    stopped_early: bool = False
    # How many divergences were rolled back, and whether a preemption
    # signal stopped the run (the last finished epoch is checkpointed).
    rollbacks: int = 0
    preempted: bool = False
    # Optimizer steps taken (per-sample steps in strict-parity mode).
    steps: int = 0


def init_params(seed: int, device: torch.device) -> step_lib.Params:
    """LeNet-ref params from ``seed`` (a CPU generator, so the same seed
    gives the same weights on every device), placed on ``device``."""
    params = lenet_ref.init(torch.Generator().manual_seed(seed))
    return tree_map(lambda t: t.to(device), params)


def check_mesh(tc: TrainConfig, n_data: int, n_model: int) -> None:
    """JAX's ``_maybe_mesh`` checks for a (n_data, n_model) mesh:
    MeshLayoutError unless the mesh can run this trainer config."""
    if tc.batch_size == 1:
        raise MeshLayoutError(
            "mesh training is the minibatch throughput mode; batch_size=1 "
            "strict parity is inherently sequential and single-device")
    if tc.ops == "cuda" and n_model > 1:
        raise MeshLayoutError(
            "ops='cuda' composes with the data axis only (the fused kernel is "
            "batch-local); use --mesh-model 1 or ops='reference'")
    if 6 % n_model:
        raise MeshLayoutError(
            f"model axis {n_model} must divide the 6 conv filters (legal: 1, 2, "
            "3, 6 — parallel/intra_op.py PARAM_SPECS)")
    if tc.batch_size % n_data:
        raise MeshLayoutError(
            f"batch_size {tc.batch_size} must divide evenly over the data axis "
            f"({n_data})")


def _agree(flag: bool, mesh) -> bool:
    """True on every rank when it is true on any (one verdict for all)."""
    if mesh is None or mesh.world == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _whole(params, mesh):
    """The whole params tree (a collective over the model axis when it is
    split)."""
    if mesh is not None and mesh.model.size > 1:
        return intra_op.gather_params(mesh, params)
    return params


def _native_batcher_cls(tc: TrainConfig):
    """The native Batcher class when the config asks for the ring
    (``prefetch="native"``; NativeBuildError when it cannot be built), else
    None. ``"auto"`` gathers the ring's order from the set already on the
    device, the same batches without a host copy a step, whether or not
    the ring builds; ``"off"`` and per-sample training never take it."""
    if tc.batch_size <= 1 or tc.prefetch != "native":
        return None
    native.load_lib()
    return native.Batcher


def _fixed_shape_batches(train, tc: TrainConfig, epoch_seed: int, batcher_cls,
                         steps_per_epoch: int):
    """One epoch of fixed-shape (drop-tail) host batches from the native
    ring (``batcher_cls``), seeded with the epoch's seed, as JAX's
    ``_fixed_shape_batches`` draws them: views into the ring's slots, which
    ``pipeline.device_batches`` copies out before it asks for the next."""
    with batcher_cls(train.images, train.labels, tc.batch_size,
                     seed=epoch_seed, shuffle=tc.shuffle, copy=False) as batcher:
        for _ in range(steps_per_epoch):
            yield next(batcher)


def learn(
    cfg: Config,
    train: pipeline.Dataset,
    params: Optional[step_lib.Params] = None,
    verbose: bool = True,
    epoch_offset: int = 0,
    epoch_callback=None,
    chaos=None,
    ring=None,
    obs=None,
    device: DeviceLike = None,
    mesh=None,
) -> TrainResult:
    """≙ learn() (Sequential/Main.cpp:146-184): epoch loop with the mean
    err-norm metric and the threshold stop.

    batch_size == 1 → strict-parity per-sample SGD; batch_size > 1 →
    minibatch steps (``cfg.train.ops`` picks the kernel path,
    a ``cfg.fused`` the bucketed update, ``cfg.train.prefetch`` the batch
    source: ``"native"`` the native C++ ring's host batches, ``"auto"``
    its NumPy twin's order gathered on the device, the same batches in the
    same order either way). ``epoch_offset`` shifts the
    per-epoch seeds so a resumed run shuffles exactly like the continuous
    run it restarts. ``epoch_callback(epoch, params, err)`` (global,
    1-based epoch) fires after every epoch. Each epoch's loss and params
    pass the health sentinel (cfg.resilience); a preemption signal stops
    the loop at the next epoch boundary, after the callback. ``chaos`` (a
    resilience.ChaosMonkey) is consulted after every optimizer step and
    at every epoch boundary; ``obs`` (an obs.Obs) takes the spans and
    events. ``device=None`` means the GPU; only ``"cpu"`` runs on the host.

    ``mesh`` (this rank's ``Mesh2D``; every rank calls ``learn`` with the
    same arguments) trains over the mesh on its device: ``params`` and the
    callback's and result's params are whole trees; a split model axis
    holds a shard of them between epochs. ``cfg.comm`` picks the grads'
    all-reduce over the data axis; the step applies its own update and
    does not read ``cfg.fused``. The CLI validates the plan first, as JAX
    does (train/trainer.py ``_maybe_mesh``): a fused step on a mesh asks
    for update-on-arrival, which needs the ring, so ``--fused-step``
    without ``--comm-impl ring`` exits with JAX's PlanLegalityError text.
    Each rank rolls back to its own in-memory last-good state (``ring`` is
    not read there).
    """
    tc = cfg.train
    res = cfg.resilience
    obs = obs if obs is not None else obs_lib.NOOP
    dev = mesh.device if mesh is not None else resolve_device(device)
    batcher_cls = _native_batcher_cls(tc)
    if params is None:
        params = init_params(tc.seed, dev)
    else:
        params = tree_map(lambda t: t.detach().to(dev, torch.float32).clone(), params)
    if verbose:
        print("Learning")

    result = TrainResult(params)
    sw = Stopwatch()
    images = torch.from_numpy(train.images).to(dev)
    labels = torch.from_numpy(train.labels).to(dev)
    steps_per_epoch = len(train) // tc.batch_size if tc.batch_size > 1 else 0
    batched_step = step_lib.batched_step_fn(tc.ops, fused=cfg.fused is not None)

    # dt is a local because auto-rollback may scale it (res.lr_backoff).
    dt = tc.dt
    build_mesh_step = mesh_step = None
    if mesh is not None:
        n_data, n_model = mesh.data.size, mesh.model.size
        check_mesh(tc, n_data, n_model)
        if steps_per_epoch == 0:
            raise ValueError(
                f"batch_size {tc.batch_size} exceeds dataset size {len(train)}")
        if n_model > 1:
            params = intra_op.shard_params(mesh, params)

            def build_mesh_step(dt_):
                return intra_op.make_2d_step(mesh, dt_, tc.batch_size, comm=cfg.comm)
        else:
            def build_mesh_step(dt_):
                return data_parallel.make_dp_step(mesh, dt_, tc.batch_size,
                                                  ops_path=tc.ops, comm=cfg.comm)
        mesh_step = build_mesh_step(dt)
        ring = None
    sentinel = Sentinel() if res.policy != "off" else None
    controller = None
    if res.policy == "rollback":
        controller = RollbackController(
            max_rollbacks=res.max_rollbacks, lr_backoff=res.lr_backoff, ring=ring,
        )
    last_good = None
    if sentinel is not None:
        # The pre-training state is the first "last good".
        last_good = tree_copy(params)
        if controller is not None:
            controller.commit(params)

    def chaos_step(p, e):
        return chaos.after_step(p, e) if chaos is not None else (p, e)

    if obs.enabled and obs.registry is not None:
        # The run's progress, pulled when the metrics snapshot is written.
        obs.registry.attach("train", lambda: {
            "epochs": len(result.epoch_errors), "steps": result.steps,
            "rollbacks": result.rollbacks})

    epoch = 0
    chaos_logged = False
    while epoch < tc.epochs:
        # Per-epoch derived seed: every epoch reshuffles, and a resumed run
        # draws the same order as the continuous one.
        epoch_seed = tc.seed + epoch_offset + epoch
        with sw, obs.span("train.epoch", cat="train",
                          epoch=epoch_offset + epoch + 1):
            if tc.batch_size == 1:
                if tc.shuffle:
                    perm = np.random.default_rng(epoch_seed).permutation(len(train))
                    perm = torch.from_numpy(perm).to(dev)
                    ex, ey = images[perm], labels[perm]
                else:
                    ex, ey = images, labels
                params, err = chaos_step(*step_lib.scan_epoch(params, ex, ey, dt))
                result.steps += len(train)
            elif batcher_cls is not None and steps_per_epoch > 0:
                # The native prefetch ring: its host batches, each copied to
                # the device (a mesh rank takes its rows of every one).
                errs = []
                for bx, by in pipeline.device_batches(_fixed_shape_batches(
                        train, tc, epoch_seed, batcher_cls, steps_per_epoch), dev):
                    if mesh_step is not None:
                        params, e = chaos_step(*mesh_step(params, mesh.shard_rows(bx),
                                                          mesh.shard_rows(by)))
                    else:
                        params, e = chaos_step(*batched_step(params, bx, by, dt))
                    errs.append(e)
                result.steps += steps_per_epoch
                err = torch.mean(torch.stack(errs))
            else:
                # prefetch "auto" and a full batch to take: drop-tail
                # batches in the ring's order (its NumPy twin), gathered on
                # the device. Otherwise ("off", or fewer samples
                # than one batch) keep-tail NumPy order, the tail at its own
                # size, the error weighted by batch size. A mesh always takes
                # fixed-shape (drop-tail) batches, each rank its rows of
                # every one.
                fixed = steps_per_epoch > 0 and (
                    tc.prefetch == "auto" or mesh is not None)
                order = pipeline.epoch_order(
                    len(train), tc.batch_size, shuffle=tc.shuffle,
                    seed=epoch_seed,
                    native_semantics=fixed and tc.prefetch == "auto",
                    drop_remainder=fixed,
                )
                if mesh is not None:
                    order = [mesh.shard_rows(idx) for idx in order]
                # One copy of the epoch's indices to the device: a copy
                # from pageable host memory per step would wait for the
                # stream, so the host could never run ahead of the card.
                flat = torch.from_numpy(np.concatenate(order)).to(dev)
                errs, weights = [], []
                start = 0
                for idx in order:
                    j = flat[start:start + len(idx)]
                    start += len(idx)
                    if mesh_step is not None:
                        params, e = chaos_step(*mesh_step(params, images[j], labels[j]))
                    else:
                        params, e = chaos_step(*batched_step(params, images[j],
                                                             labels[j], dt))
                    errs.append(e)
                    weights.append(len(idx))
                result.steps += len(order)
                errs = torch.stack(errs)
                if fixed:
                    err = torch.mean(errs)
                else:
                    w = torch.tensor(weights, dtype=torch.float32, device=dev)
                    err = torch.sum(errs * w) / torch.sum(w)
            with obs.span("train.readback", cat="train"):
                err = float(err)  # blocks: everything above is asynchronous

        if sentinel is not None:
            verdict = sentinel.check(loss=err, params=params)
            if _agree(not verdict.healthy, mesh) and verdict.healthy:
                # A shard elsewhere diverged: this rank follows its verdict.
                verdict = Verdict(False, "non-finite params on another rank")
            if not verdict.healthy:
                g_epoch = epoch_offset + epoch + 1
                if obs.enabled:
                    obs.event("verdict", healthy=False, epoch=g_epoch,
                              reason=verdict.reason, policy=res.policy)
                if res.policy == "raise":
                    raise DivergenceError(f"epoch {g_epoch}: {verdict.reason}")
                if res.policy == "skip":
                    log.warning(
                        "sentinel: %s at epoch %d — discarding the epoch's "
                        "update, continuing from last-good",
                        verdict.reason, g_epoch,
                    )
                    params = tree_copy(last_good)
                    epoch += 1
                    continue
                # rollback: restore the newest healthy state, scale the LR,
                # retry the SAME epoch (bounded by max_rollbacks).
                params, _ = controller.rollback(
                    like=params, reason=f"epoch {g_epoch}: {verdict.reason}"
                )
                result.rollbacks = controller.rollbacks
                if obs.enabled:
                    obs.event("rollback", epoch=g_epoch,
                              rollbacks=controller.rollbacks,
                              lr_scale=controller.lr_scale)
                new_dt = tc.dt * controller.lr_scale
                if new_dt != dt and build_mesh_step is not None:
                    mesh_step = build_mesh_step(new_dt)
                dt = new_dt
                continue
            last_good = tree_copy(params)
            if controller is not None:
                controller.commit(params)

        result.epoch_errors.append(err)
        if obs.enabled:
            obs.event("epoch", epoch=epoch_offset + epoch + 1, loss=err,
                      seconds=sw.total)
        if epoch_callback is not None:
            epoch_callback(epoch_offset + epoch + 1, _whole(params, mesh), err)
        if chaos is not None:
            if obs.enabled and chaos.nan_fired and not chaos_logged:
                chaos_logged = True
                obs.event("chaos", injected="nan", epoch=epoch_offset + epoch + 1)
            chaos.at_epoch(epoch_offset + epoch + 1)
        if verbose:
            # ≙ fprintf at Sequential/Main.cpp:174
            print(f"error: {err:e}, time_on_cpu: {sw.total:f}")
        if err < tc.threshold:
            result.stopped_early = True
            if verbose:
                # ≙ Sequential/Main.cpp:177
                print("Training complete, error less than threshold\n")
            break
        if _agree(preempt.requested(), mesh):
            # epoch_callback already flushed this epoch's checkpoint.
            result.preempted = True
            if obs.enabled:
                obs.event("preempt", epoch=epoch_offset + epoch + 1)
            if verbose:
                print(f"preemption: stopping after epoch "
                      f"{epoch_offset + epoch + 1} (checkpoint flushed)")
            break
        epoch += 1

    result.params = _whole(params, mesh)
    result.seconds = sw.total
    if verbose:
        print(f"\n Time - {sw.total:f}")  # ≙ Sequential/Main.cpp:183
    return result


def test(
    params: step_lib.Params,
    test_ds: pipeline.Dataset,
    batch_size: int = 1000,
    verbose: bool = True,
) -> float:
    """≙ test() (Sequential/Main.cpp:202-214): % misclassified on the test
    split, evaluated in batches on the params' device."""
    dev = params["f"]["w"].device
    n = len(test_ds)
    errors = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(0, n, batch_size):
        x = torch.from_numpy(test_ds.images[i : i + batch_size]).to(dev)
        y = torch.from_numpy(test_ds.labels[i : i + batch_size]).to(dev)
        errors += step_lib.error_count(params, x, y)
    rate = int(errors) / n * 100.0
    if verbose:
        print(f"Error Rate: {rate:.2f}%")  # ≙ Sequential/Main.cpp:212-213
    return rate


def run(cfg: Config, verbose: bool = True, device: DeviceLike = None) -> float:
    """≙ main() (Sequential/Main.cpp:44-57): loaddata → learn → test."""
    dev = resolve_device(device)
    train_ds, test_ds = pipeline.load_train_test(cfg.data)
    result = learn(cfg, train_ds, verbose=verbose, device=dev)
    return test(result.params, test_ds, verbose=verbose)
