"""Inference engine: weights → per-bucket predict on one device (the
port's counterpart of ``parallel_cnn_tpu/serve/engine.py``).

- **Restore** reads a JAX-written zoo checkpoint (convert.py) into the
  handle's fresh model, or keeps the seed-initialised weights.
- **Buckets**: requests pad into the nearest power-of-two batch bucket
  (1, 2, 4, …, max_batch), so the device only ever sees a fixed ladder of
  shapes. PyTorch runs eagerly and compiles nothing per shape; ``precompile``
  runs every bucket once so the first requests pay neither the kernel
  build nor the caching allocator's first allocations. (JAX's
  ahead-of-time executables, their disk cache and CUDA graphs are later
  work.)
- **Device pinning**: each engine owns a copy of the weights on its
  device and runs under ``torch.cuda.device(dev)``, so ReplicaPool can run
  engines on batcher worker threads round-robin across local cards. On
  one card every replica shares it; each runner thread launches on its
  current stream, and the one wait a batch makes is the copy of its
  logits to the host.
- **Failover and scaling** (ReplicaPool): kill/evict, respawn, grow,
  drain, undrain and retire, JAX's state machine. A respawned or grown
  replica copies the pool's host weights to the card anew; a retired one
  drops its device weights, so the card's allocated memory returns to
  its level before the replica was grown.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from parallel_cnn_tpu_torch.utils.backend import (
    DeviceLike,
    local_devices,
    resolve_device,
)


@dataclasses.dataclass
class EngineStats:
    """Counters of one engine; mutated under the engine's lock."""

    warmups: int = 0
    predicts: int = 0
    warm_seconds: Dict[int, float] = dataclasses.field(default_factory=dict)


class ReplicaDead(RuntimeError):
    """A replica is gone (killed). Carries the replica index."""

    def __init__(self, replica: int, message: str = ""):
        super().__init__(message or f"replica {replica} is dead")
        self.replica = replica


def load_or_init(handle, checkpoint: Optional[str] = None,
                 seed: int = 0) -> nn.Module:
    """The handle's model on the CPU — restored from a JAX-written zoo
    checkpoint when given, else fresh from ``seed``."""
    model = handle.init(seed)
    if checkpoint is not None:
        from parallel_cnn_tpu_torch.convert import load_jax_checkpoint

        (handle.load or load_jax_checkpoint)(checkpoint, model)
    return model


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest power-of-two bucket holding n requests."""
    if n < 1:
        raise ValueError(f"need at least one request, got {n}")
    b = 1 << (n - 1).bit_length()
    if b > max_batch:
        raise ValueError(
            f"batch of {n} exceeds max_batch={max_batch}; split upstream"
        )
    return b


class Engine:
    """Single-replica engine: pad → forward on the device → unpad.

    Thread-safe: concurrent ``predict`` calls share the weights read-only
    and run on the device's current stream."""

    def __init__(
        self,
        handle,
        *,
        model: Optional[nn.Module] = None,
        checkpoint: Optional[str] = None,
        max_batch: int = 64,
        device: DeviceLike = None,
        seed: int = 0,
        precompile: bool = False,
    ):
        if max_batch < 1 or (max_batch & (max_batch - 1)):
            raise ValueError(
                f"max_batch must be a power of two >= 1, got {max_batch}"
            )
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # Library convs (the "xla" backend, cifar_cnn) in full f32,
            # as the plain references they are held against.
            torch.backends.cudnn.allow_tf32 = False
        self.handle = handle
        self.max_batch = max_batch
        if model is None:
            model = load_or_init(handle, checkpoint, seed)
        # Each engine owns its device copy of the weights.
        self.model = copy.deepcopy(model).to(self.device).eval()
        self.stats = EngineStats()
        self._lock = threading.Lock()
        if precompile:
            self.precompile()

    @property
    def buckets(self) -> List[int]:
        """The bucket ladder: 1, 2, 4, …, max_batch."""
        return [1 << i for i in range(self.max_batch.bit_length())]

    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.max_batch)

    def _device_ctx(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The raw batched forward on a tensor already on this device (no
        padding) — the reference the padded-bucket parity probe holds
        ``predict`` against."""
        with self._device_ctx(), torch.inference_mode():
            return self.handle.forward(self.model, x)

    def _run(self, x: np.ndarray) -> np.ndarray:
        model = self.model
        if model is None:
            raise ReplicaDead(-1, "the engine was retired")
        with self._device_ctx(), torch.inference_mode():
            xt = torch.from_numpy(x).to(self.device)
            return self.handle.forward(model, xt).cpu().numpy()

    def release(self) -> None:
        """Drop this engine's device weights (the replica was retired); a
        later predict raises ReplicaDead."""
        with self._lock:
            self.model = None

    def precompile(self) -> Dict[int, float]:
        """Run every bucket once now (kernel build included on the first);
        returns {bucket: seconds}. Idempotent."""
        for b in self.buckets:
            with self._lock:
                if b in self.stats.warm_seconds:
                    continue
            t0 = time.perf_counter()
            self._run(np.zeros((b, *self.handle.in_shape), np.float32))
            dt = time.perf_counter() - t0
            with self._lock:
                self.stats.warm_seconds.setdefault(b, dt)
                self.stats.warmups += 1
        return dict(self.stats.warm_seconds)

    def predict(self, x) -> np.ndarray:
        """(n, *in_shape) float32 → (n, n_outputs) float32.

        Pads to the nearest bucket, runs the forward on this engine's
        device, and slices the padding back off. Zero rows are safe: no
        eval-mode op mixes information across the batch, and the conv
        kernel sums each output in an order that does not depend on its
        batch position."""
        x = np.asarray(x, dtype=np.float32)
        if x.shape[1:] != tuple(self.handle.in_shape):
            raise ValueError(
                f"expected (n, {', '.join(map(str, self.handle.in_shape))}), "
                f"got {x.shape}"
            )
        n = x.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            pad = np.zeros((bucket - n, *x.shape[1:]), x.dtype)
            x = np.concatenate([x, pad], axis=0)
        y = self._run(np.ascontiguousarray(x))
        with self._lock:
            self.stats.predicts += 1
        return y[:n]


class ReplicaPool:
    """n_replicas engine copies pinned round-robin across local devices.

    Weights are restored or initialised ONCE on the host and copied to
    each replica's device. Replica selection is a deterministic
    round-robin over routable replicas (alive and not draining). ``kill``
    (alias ``evict``) marks a replica dead: its predict raises
    ReplicaDead and round-robin skips it. ``respawn`` builds a fresh
    Engine from the host copy; ``grow`` revives a dead slot that way or
    appends a new replica; ``drain`` / ``retire`` are the scale-down's
    two steps, and ``set_weights`` swaps the host copy later replicas are
    built from (JAX's ``ReplicaPool``, serve/engine.py:551-692)."""

    def __init__(
        self,
        handle,
        *,
        n_replicas: int = 1,
        checkpoint: Optional[str] = None,
        max_batch: int = 64,
        device: DeviceLike = None,
        devices=None,
        seed: int = 0,
        precompile: bool = False,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.devices = (
            [resolve_device(d) for d in devices] if devices is not None
            else local_devices(device)
        )
        # Kept host-side for respawn and growth.
        self._model = load_or_init(handle, checkpoint, seed)
        self._precompile = precompile
        self.handle = handle
        self.max_batch = max_batch
        self._lock = threading.Lock()
        # Bucket warm-ups of every engine this pool built, respawned and
        # grown ones included: each is one forward on the device.
        self.warmups = 0
        self.engines = [self._engine(self.devices[i % len(self.devices)])
                        for i in range(n_replicas)]
        self._rr = 0
        self._alive = [True] * n_replicas
        self._draining = [False] * n_replicas

    def _engine(self, device) -> Engine:
        with self._lock:
            model = self._model
        eng = Engine(
            self.handle,
            model=model,
            max_batch=self.max_batch,
            device=device,
            precompile=self._precompile,
        )
        with self._lock:
            self.warmups += eng.stats.warmups
        return eng

    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    def alive(self) -> List[int]:
        """Indices of live replicas (draining ones included — they are
        still serving their in-flight batches)."""
        with self._lock:
            return [i for i, a in enumerate(self._alive) if a]

    def routable(self) -> List[int]:
        """Indices round-robin will hand out: alive and not draining —
        the pool's serving capacity (the autoscaler's sizing input)."""
        with self._lock:
            return [
                i for i, a in enumerate(self._alive)
                if a and not self._draining[i]
            ]

    def kill(self, i: int) -> None:
        """Mark replica ``i`` dead until ``respawn``: the chaos injection
        point (``kill-replica@SEQ``), and what ``evict`` does after an
        observed failure."""
        with self._lock:
            self._alive[i] = False
            self._draining[i] = False

    evict = kill

    def respawn(self, i: int, device=None) -> int:
        """Re-pin a replacement for replica ``i`` from the host weights
        (on ``device``, else the slot's own ``devices[i % len(devices)]``);
        returns ``i`` (live again). The old engine's device weights go
        with it."""
        eng = self._engine(resolve_device(device) if device is not None
                           else self.devices[i % len(self.devices)])
        with self._lock:
            old, self.engines[i] = self.engines[i], eng
            self._alive[i] = True
            self._draining[i] = False
        old.release()
        return i

    def grow(self, device=None) -> int:
        """Add one serving replica; returns its slot index. A dead slot
        (killed or retired) is revived through ``respawn``; with none, a
        new Engine is appended on the next device of the round-robin
        placement (or ``device``). The Engine builds outside the pool
        lock and is published at once; slot indices never move."""
        with self._lock:
            free = [i for i, a in enumerate(self._alive) if not a]
        if free:
            return self.respawn(free[0], device=device)
        eng = self._engine(resolve_device(device) if device is not None
                           else self.devices[len(self.engines) % len(self.devices)])
        with self._lock:
            self.engines.append(eng)
            self._alive.append(True)
            self._draining.append(False)
            return len(self.engines) - 1

    def set_weights(self, model: nn.Module) -> None:
        """Swap the pool's host weights: every replica built from now on
        (grow / respawn) serves ``model``; live replicas keep theirs until
        retired (the hot-swap primitive)."""
        with self._lock:
            self._model = model

    def drain(self, i: int) -> None:
        """Make replica ``i`` unroutable while leaving it alive: batches
        already dispatched to it still run. ``retire`` completes the
        scale-down once its in-flight count is zero."""
        with self._lock:
            self._draining[i] = True

    def undrain(self, i: int) -> None:
        """Abort a drain: a still-alive replica returns to rotation."""
        with self._lock:
            if self._alive[i]:
                self._draining[i] = False

    def retire(self, i: int) -> None:
        """Free a drained slot: the replica is gone (predict raises
        ReplicaDead), its device weights are dropped, and the slot is
        free for a later ``grow``."""
        with self._lock:
            self._alive[i] = False
            self._draining[i] = False
            eng = self.engines[i]
        eng.release()

    def next_replica(self) -> int:
        """Deterministic round-robin over routable replicas (dead and
        draining slots are skipped without consuming a turn)."""
        with self._lock:
            for _ in range(len(self.engines)):
                i = self._rr
                self._rr = (self._rr + 1) % len(self.engines)
                if self._alive[i] and not self._draining[i]:
                    return i
        raise ReplicaDead(-1, "no live replicas in the pool")

    def precompile(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for e in self.engines:
            out.update(e.precompile())
        return out

    def predict(self, x, replica: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """Run one batch on a replica (round-robin unless pinned); returns
        (outputs, replica index). A pinned dead replica raises
        ReplicaDead before anything runs — the batcher's failover
        trigger."""
        i = self.next_replica() if replica is None else replica
        with self._lock:
            if not self._alive[i]:
                raise ReplicaDead(i)
            eng = self.engines[i]
        return eng.predict(x), i
