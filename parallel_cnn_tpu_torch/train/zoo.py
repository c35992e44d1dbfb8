"""Single-device trainer for the model zoo (CIFAR CNN, ResNet-18/34): the
port of ``parallel_cnn_tpu/train/zoo.py`` with ``mesh=None``.

Softmax cross-entropy and SGD with momentum written out as optax computes
them (``make_optimizer``: ``m ← g + β·m``, no dampening, weight decay added
to ``g`` before the momentum, ``p ← p − lr(count)·m`` with the schedule read
at the count before its increment), gradient accumulation over
microbatches with the BN state threaded through them, the fused loss tail
(``FusedStepConfig.tail``, ops/tail.py), per-epoch eval, an atomic
checkpoint ring in the JAX package's ``ZooState`` format (a file either
package writes, the other restores), the health sentinel with skip or
rollback, and a preemption stop at the epoch boundary.

The port's state is a module (its parameters and BN buffers) plus the
momentum trace and the schedule count; a train step updates them in
place. JAX's ``ZooState(params, model_state, opt_state)`` is what
``ZooState.arrays()`` writes and ``ZooState.load()`` reads, under JAX's
checkpoint keys (``.params/3/main/0/conv/w``,
``.model_state/3/main/0/bn/mean``, ``.opt_state/0/0/.trace/...``,
``.opt_state/0/1/.count``).

Batch order. ``loader="native"`` gives the native ring's batches
(``seed + epoch + 1``, the NumPy twin of JAX's C++ ring), so both packages
train on the same batches. ``loader="device"`` draws each epoch's
permutation from ``torch.Generator().manual_seed(seed + epoch)``, which
cannot reproduce JAX's threefry permutation: the two packages shuffle
differently, each reproducibly, so resume is exact on both. Augmentation
likewise draws from a generator seeded by the epoch.

Not here (ROADMAP): mesh/GSPMD and explicit-collective data parallelism,
update-on-arrival and ZeRO (A9), bf16 activations with loss scaling (A8b),
pipeline, elastic and chaos, the per-step sentinel cadence, profiling.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from parallel_cnn_tpu_torch.config import FusedStepConfig, ResilienceConfig
from parallel_cnn_tpu_torch.data import augment as aug_lib
from parallel_cnn_tpu_torch.data import pipeline
from parallel_cnn_tpu_torch.ops import tail
from parallel_cnn_tpu_torch.resilience import preempt
from parallel_cnn_tpu_torch.resilience.rollback import (
    CheckpointRing,
    RollbackController,
    tree_copy,
)
from parallel_cnn_tpu_torch.resilience.sentinel import DivergenceError, Sentinel
from parallel_cnn_tpu_torch.train import checkpoint
from parallel_cnn_tpu_torch.utils.backend import DeviceLike, resolve_device

LOADERS = ("device", "native")
SCHEDULES = ("constant", "cosine")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return F.cross_entropy(logits.float(), labels.long())


# ---------------------------------------------------------------------------
# Optimizer: optax.chain([add_decayed_weights], sgd(lr | schedule, momentum))
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with momentum, optional weight decay and an LR schedule, as
    ``make_optimizer`` builds it with optax. Stateless: the trace and the
    count live in ``ZooState``."""

    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: Optional[int] = None

    @property
    def scheduled(self) -> bool:
        """optax keeps a step count only for a schedule (cosine, or a
        warmup), not for a constant LR."""
        return self.schedule == "cosine" or self.warmup_steps > 0

    @property
    def chain_index(self) -> int:
        """Index of the sgd transform in the optax chain (the decayed
        weights come first)."""
        return 1 if self.weight_decay else 0

    def learning_rate(self, count: int) -> np.float32:
        """The LR at step ``count``, in f32 as optax computes it."""
        f32 = np.float32
        lr, w = f32(self.lr), self.warmup_steps

        def warmup(c):  # optax.linear_schedule(0, lr, w)
            frac = f32(1) - f32(min(max(c, 0), w)) / f32(w)
            return f32(-lr) * frac + lr

        if self.schedule == "constant":
            return warmup(count) if w else lr
        if count < w:
            return warmup(count)
        decay = float(self.total_steps - w)  # optax.cosine_decay_schedule
        c = f32(min(float(count - w), decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return lr * cosine

    def apply(self, state: "ZooState", grads: Sequence[torch.Tensor]) -> None:
        """One update of ``state``'s parameters and trace, in place."""
        names, params = zip(*state.model.named_parameters())
        traces = [state.trace[n] for n in names]
        grads = list(grads)
        if self.weight_decay:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(list(params), self.weight_decay))
        torch._foreach_mul_(traces, self.momentum)
        torch._foreach_add_(traces, grads)
        step = -float(self.learning_rate(state.count))
        torch._foreach_add_(list(params), torch._foreach_mul(traces, step))
        if self.scheduled:
            state.count += 1


def make_optimizer(lr: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 0.0, schedule: str = "constant",
                   warmup_steps: int = 0,
                   total_steps: Optional[int] = None) -> SGD:
    """SGD(+momentum, +weight decay) with "constant" (optional linear
    warmup) or "cosine" (warmup, then cosine decay to 0 at
    ``total_steps``) LR."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("schedule='cosine' needs total_steps")
        if total_steps <= warmup_steps:
            raise ValueError("cosine decay needs total_steps > warmup_steps")
    return SGD(lr, momentum, weight_decay, schedule, warmup_steps, total_steps)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def _jax_path(key: str) -> str:
    return key.replace(".", "/")


@dataclasses.dataclass
class ZooState:
    """The model (parameters and BN buffers), the momentum trace per
    parameter name and the schedule count: what a step updates."""

    model: nn.Module
    optimizer: SGD
    trace: Dict[str, torch.Tensor]
    count: int = 0

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The live tensors under the JAX package's checkpoint keys."""
        buffers = {n for n, _ in self.model.named_buffers()}
        out = {}
        for key, t in self.model.state_dict().items():
            tree = ".model_state/" if key in buffers else ".params/"
            out[tree + _jax_path(key)] = t
        prefix = f".opt_state/{self.optimizer.chain_index}"
        for key, t in self.trace.items():
            out[f"{prefix}/0/.trace/{_jax_path(key)}"] = t
        if self.optimizer.scheduled:
            out[f"{prefix}/1/.count"] = torch.tensor(self.count, dtype=torch.int32)
        return out

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """A copy of ``arrays()`` that nothing else aliases."""
        return tree_copy(self.arrays())

    def load(self, arrays: Dict[str, torch.Tensor]) -> None:
        """Copy ``arrays`` (tensors or numpy arrays under the keys of
        ``arrays()``) into the state, in place. Keys, shapes and dtypes
        must match exactly."""
        want = self.arrays()
        if set(arrays) != set(want):
            raise ValueError(
                f"zoo state mismatch: missing={sorted(set(want) - set(arrays))} "
                f"surplus={sorted(set(arrays) - set(want))}")
        with torch.no_grad():
            for key, dst in want.items():
                src = arrays[key]
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src, copy=True))
                if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                    raise ValueError(
                        f"zoo state leaf '{key}' is {tuple(src.shape)}/{src.dtype}, "
                        f"expected {tuple(dst.shape)}/{dst.dtype}")
                if key.endswith("/.count"):
                    self.count = int(src)
                else:
                    dst.copy_(src)


def init_state(model: nn.Module, optimizer: SGD) -> ZooState:
    """A fresh state for ``model`` (its weights are the init): zero
    momentum on the parameters' devices, count 0."""
    trace = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return ZooState(model, optimizer, trace)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _build_loss_fn(model: nn.Module, fused: Optional[FusedStepConfig]) -> Callable:
    """loss(model, x, y) with the fused-step refinements: ``fused.tail``
    routes a recognised pool → flatten → Dense suffix through the fused
    loss tail, keeping the unfused composition (with a note) when the
    head does not match."""
    if fused is not None:
        fused.check_ported()
    split = tail.split_tail(model) if fused is not None and fused.tail else None
    if fused is not None and fused.tail and split is None:
        print("fused-step: model tail not fusable; keeping unfused tail")
    if split is None:
        return lambda m, x, y: cross_entropy(m(x), y)

    def loss_fn(m, x, y):
        feats = x
        for layer in list(m)[: split.trunk]:
            feats = layer(feats)
        dense = m[-1]
        return tail.fused_tail_loss(feats, dense.w, dense.b, y, pool=split.pool)

    return loss_fn


def make_train_step(model: nn.Module, optimizer: SGD, accum_steps: int = 1,
                    augment_pad: Optional[int] = None,
                    fused: Optional[FusedStepConfig] = None) -> Callable:
    """step(state, x, y, aug=None) → loss (a device scalar), updating
    ``state`` in place: grads of the (microbatch-averaged) loss, then one
    optimizer update. ``accum_steps > 1`` splits the batch into that many
    microbatches, in order, threading the BN state through them.
    ``augment_pad`` set means the step crops and flips ``x`` with the
    draws ``aug = (offsets, flips)`` first. ``fused.update`` is not taken
    here (it needs a mesh; ``train`` drops it)."""
    if fused is not None and fused.update:
        raise ValueError(
            "fused.update (update-on-arrival) needs the ring-collective "
            "step (ROADMAP A9); pass fused with update=False")
    loss_fn = _build_loss_fn(model, fused)

    def grad_fn(m, params, x, y):
        loss = loss_fn(m, x, y)
        return loss.detach(), torch.autograd.grad(loss, params)

    def step(state: ZooState, x, y, aug=None):
        if augment_pad is not None:
            if aug is None:
                raise ValueError("this step was built with augmentation; "
                                 "call it as step(state, x, y, aug)")
            x = aug_lib.crop_flip(x, *aug, pad=augment_pad)
        m = state.model
        m.train()
        params = [p for _, p in m.named_parameters()]
        if accum_steps == 1:
            loss, grads = grad_fn(m, params, x, y)
        else:
            if x.shape[0] % accum_steps:
                raise ValueError(
                    f"batch size {x.shape[0]} must be a multiple of "
                    f"accum_steps {accum_steps} (no silent sample dropping)")
            mb = x.shape[0] // accum_steps
            loss, grads = grad_fn(m, params, x[:mb], y[:mb])
            grads = list(grads)
            for i in range(1, accum_steps):
                sl = slice(i * mb, (i + 1) * mb)
                li, gi = grad_fn(m, params, x[sl], y[sl])
                torch._foreach_add_(grads, list(gi))
                loss = loss + li
            torch._foreach_div_(grads, float(accum_steps))
            loss = loss / accum_steps
        with torch.no_grad():
            state.optimizer.apply(state, grads)
        return loss

    return step


def evaluate(model: nn.Module, images: torch.Tensor, labels: torch.Tensor,
             batch_size: int = 256) -> float:
    """Accuracy (%) of ``model`` in eval mode over an on-device split, in
    batches; one readback at the end. The ResNets' eval forward on the
    "cuda" backend is one fused kernel launch per conv."""
    was_training = model.training
    model.eval()
    correct = torch.zeros((), dtype=torch.int64, device=images.device)
    with torch.no_grad():
        for i in range(0, images.shape[0], batch_size):
            logits = model(images[i:i + batch_size])
            correct += (logits.argmax(dim=-1) == labels[i:i + batch_size]).sum()
    model.train(was_training)
    return int(correct) / images.shape[0] * 100.0


# ---------------------------------------------------------------------------
# Epoch driver
# ---------------------------------------------------------------------------


def _aug_generator(seed: int, epoch: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed ^ 0x5EED) * 1_000_003 + epoch)


def _epoch_batches(loader, images, labels, np_data, batch, steps, seed, epoch,
                   dev):
    """(x, y) pairs of one epoch on ``dev``."""
    if loader == "native":
        ds = pipeline.Dataset(*np_data)
        for bx, by in itertools.islice(pipeline.native_semantics_batches(
                ds, batch, shuffle=True, seed=seed + epoch + 1), steps):
            yield (torch.from_numpy(bx).to(dev),
                   torch.from_numpy(by).to(dev, torch.int64))
        return
    perm = torch.randperm(images.shape[0],
                          generator=torch.Generator().manual_seed(seed + epoch))
    perm = perm.to(dev)  # one copy per epoch, not one per step
    for i in range(steps):
        j = perm[i * batch:(i + 1) * batch]
        yield images[j], labels[j]


def train(
    model: nn.Module,
    images: np.ndarray,
    labels: np.ndarray,
    *,
    epochs: int = 1,
    batch_size: int = 128,
    lr: float = 0.1,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    augment: bool = False,
    augment_pad: int = 4,
    accum_steps: int = 1,
    fused: Optional[FusedStepConfig] = None,
    seed: int = 0,
    verbose: bool = True,
    eval_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    eval_batch_size: int = 256,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    metrics=None,
    loader: str = "device",
    resilience: Optional[ResilienceConfig] = None,
    device: DeviceLike = None,
) -> Tuple[ZooState, List[float]]:
    """Epoch driver for a zoo model on an in-memory NHWC dataset (JAX's
    ``zoo.train`` on one device). ``model`` carries the initial weights and
    is trained in place on ``device`` (None = the GPU; "cpu" runs the
    kernels' plain versions).

    Per epoch: the shuffled steps (``len(images) // batch_size``, drop
    tail), the mean loss read back once, the sentinel's verdict
    (``resilience.policy``: "raise", "skip" the epoch, or "rollback" and
    retry it at the same LR), eval accuracy on ``eval_data``, a metrics
    record, the checkpoint ``ckpt_<epoch>.npz`` (full state) and the line
    ``epoch N: loss L, acc A% (S s)``. ``resume`` restarts from the newest
    checkpoint in ``checkpoint_dir`` (one the JAX trainer wrote included);
    a preemption signal stops at the next epoch boundary, after the
    checkpoint. Returns (state, per-epoch mean losses).
    """
    if loader not in LOADERS:
        raise ValueError(f"unknown loader {loader!r}")
    dev = resolve_device(device)
    steps = images.shape[0] // batch_size
    if steps == 0:
        raise ValueError(f"dataset of {images.shape[0]} samples yields zero "
                         f"batches of {batch_size}")
    if fused is not None and fused.update:
        if verbose:
            print("fused-step: update-on-arrival needs mesh + "
                  "comm.impl='ring'/'hierarchical'; falling back to "
                  "fused tail only")
        fused = dataclasses.replace(fused, update=False)
    optimizer = make_optimizer(
        lr, momentum, weight_decay, schedule=lr_schedule,
        warmup_steps=warmup_steps,
        total_steps=steps * epochs if lr_schedule == "cosine" else None,
    )
    model.to(dev)
    state = init_state(model, optimizer)
    step = make_train_step(model, optimizer, accum_steps,
                           augment_pad if augment else None, fused)

    res = resilience
    sentinel = Sentinel() if res is not None and res.policy != "off" else None
    controller = None
    if sentinel is not None and res.policy == "rollback":
        controller = RollbackController(max_rollbacks=res.max_rollbacks)
    ring = None
    if checkpoint_dir:
        ring = CheckpointRing(checkpoint_dir,
                              keep=res.ring_size if res is not None else 0)

    start_epoch = 0
    losses: List[float] = []
    accs: List[float] = []
    if checkpoint_dir and resume:
        path = checkpoint.latest(checkpoint_dir)
        if path:
            arrays, tstate = checkpoint.restore(path, state.arrays())
            state.load(arrays)
            start_epoch = tstate.epoch
            losses = list(tstate.epoch_errors)
            accs = list(tstate.extra.get("epoch_accs", []))
            if verbose:
                print(f"resumed from {path} (epoch {start_epoch})")

    np_data = None
    if loader == "native":
        np_data = (np.ascontiguousarray(images, dtype=np.float32),
                   np.ascontiguousarray(labels, dtype=np.int32))
        d_images = d_labels = None
    else:
        d_images = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
        d_labels = torch.from_numpy(np.asarray(labels)).to(dev, torch.int64)
    ev = None
    if eval_data is not None:
        ev = (torch.from_numpy(np.asarray(eval_data[0], np.float32)).to(dev),
              torch.from_numpy(np.asarray(eval_data[1])).to(dev, torch.int64))

    last_good = None
    if sentinel is not None:
        last_good = state.snapshot()
        if controller is not None:
            controller.commit(last_good)
    epoch = start_epoch
    while epoch < epochs:
        t0 = time.perf_counter()
        aug = None
        if augment:
            offsets, flips = aug_lib.draw(_aug_generator(seed, epoch),
                                          steps * batch_size, augment_pad)
            aug = (offsets.to(dev).view(steps, batch_size, 2),
                   flips.to(dev).view(steps, batch_size))
        epoch_loss = torch.zeros((), dtype=torch.float32, device=dev)
        batches = _epoch_batches(loader, d_images, d_labels, np_data,
                                 batch_size, steps, seed, epoch, dev)
        for i, (bx, by) in enumerate(batches):
            loss = step(state, bx, by,
                        None if aug is None else (aug[0][i], aug[1][i]))
            epoch_loss = epoch_loss + loss
        mean_loss = float(epoch_loss) / steps  # the epoch's one readback
        if sentinel is not None:
            verdict = sentinel.check(loss=mean_loss,
                                     params=list(state.model.parameters()))
            if not verdict.healthy:
                diverged = f"epoch {epoch + 1}: {verdict.reason}"
                if res.policy == "raise":
                    raise DivergenceError(diverged)
                if res.policy == "skip":
                    if verbose:
                        print(f"sentinel: {diverged} — epoch discarded")
                    state.load(last_good)
                    epoch += 1
                    continue
                # rollback: the last-good state, the same epoch again (the
                # same seed gives the same batches and augmentation).
                snap, _ = controller.rollback(like=state.arrays(),
                                              reason=diverged)
                state.load(snap)
                if verbose:
                    print(f"sentinel: {diverged} — rolled back "
                          f"({controller.rollbacks}/{controller.max_rollbacks})")
                continue
            last_good = state.snapshot()
            if controller is not None:
                controller.commit(last_good)
        losses.append(mean_loss)
        seconds = time.perf_counter() - t0
        if ev is not None:
            accs.append(evaluate(state.model, *ev, batch_size=eval_batch_size))
        if metrics is not None:
            rec = dict(event="zoo_epoch", epoch=epoch + 1, loss=losses[-1],
                       seconds=seconds)
            if ev is not None:
                rec["accuracy"] = accs[-1]
            metrics.record(**rec)
        if ring is not None:
            ring.save(epoch + 1, state.arrays(), checkpoint.TrainState(
                epoch=epoch + 1, epoch_errors=list(losses),
                extra={"epoch_accs": list(accs)}))
        if verbose:
            acc_txt = f", acc {accs[-1]:.2f}%" if ev is not None else ""
            print(f"epoch {epoch + 1}: loss {losses[-1]:.4f}{acc_txt} "
                  f"({seconds:.2f}s)")
        if preempt.requested():
            if verbose:
                print(f"preemption: stopping after epoch {epoch + 1}")
            break
        epoch += 1
    return state, losses
