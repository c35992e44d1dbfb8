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
  engines on batcher worker threads round-robin across local cards.
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

        load_jax_checkpoint(checkpoint, model)
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
        with self._device_ctx(), torch.inference_mode():
            xt = torch.from_numpy(x).to(self.device)
            return self.handle.forward(self.model, xt).cpu().numpy()

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
    round-robin. ``kill`` marks a replica dead (its predict raises
    ReplicaDead, round-robin skips it); ``respawn`` builds a fresh Engine
    from the host copy. In-flight failover, autoscaler growth, draining
    and hot swap come with a later slice."""

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
        # Kept host-side for respawn.
        self._model = load_or_init(handle, checkpoint, seed)
        self._precompile = precompile
        self.handle = handle
        self.max_batch = max_batch
        self.engines = [self._engine(i) for i in range(n_replicas)]
        self._rr = 0
        self._alive = [True] * n_replicas
        self._lock = threading.Lock()

    def _engine(self, i: int) -> Engine:
        return Engine(
            self.handle,
            model=self._model,
            max_batch=self.max_batch,
            device=self.devices[i % len(self.devices)],
            precompile=self._precompile,
        )

    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    def alive(self) -> List[int]:
        with self._lock:
            return [i for i, a in enumerate(self._alive) if a]

    def kill(self, i: int) -> None:
        """Mark replica ``i`` dead until ``respawn``."""
        with self._lock:
            self._alive[i] = False

    def respawn(self, i: int) -> int:
        """Re-pin a replacement for replica ``i`` from the host weights;
        returns ``i`` (live again)."""
        eng = self._engine(i)
        with self._lock:
            self.engines[i] = eng
            self._alive[i] = True
        return i

    def next_replica(self) -> int:
        """Deterministic round-robin over live replicas."""
        with self._lock:
            for _ in range(len(self.engines)):
                i = self._rr
                self._rr = (self._rr + 1) % len(self.engines)
                if self._alive[i]:
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
        ReplicaDead."""
        i = self.next_replica() if replica is None else replica
        with self._lock:
            if not self._alive[i]:
                raise ReplicaDead(i)
        return self.engines[i].predict(x), i
