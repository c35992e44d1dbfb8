"""Deterministic chaos / fault-injection harness (the port's copy of
``parallel_cnn_tpu/resilience/chaos.py``: the whole spec grammar, with
JAX's error text, and the one-shot hooks).

The port wires every fault JAX does: ``kill-replica@`` and
``slow-replica@`` (serve/batcher.py), ``kill-endpoint@`` (serve/net.py),
``slow-loris@`` (serve/loadgen.py's socket client), and the trainer's
``--chaos``: ``nan@``, ``kill@`` and ``kill9@`` (train/trainer.py,
train/zoo.py), ``resize@`` (resilience/elastic.py), ``slow-worker@``
(train/async_dp.py) and ``slow-stage@`` (train/zoo.py's pipeline).
Faults:

- **NaN at step k** (``ChaosMonkey(nan_step=k)``): after the k-th
  optimizer step (host-side, 0-based, counted across epochs), the
  inexact leaves of the returned state are replaced with NaN — exactly
  the state a NaN gradient produces (``p += dt * NaN == NaN``), injected
  at the same host boundary the sentinel polls. One-shot: the retried
  epoch after a rollback is NOT re-poisoned, so bounded recovery can be
  asserted deterministically.
- **Kill at an epoch boundary** (``kill_epoch=e``): after epoch ``e``'s
  checkpoint callback ran, deliver a real signal to this process —
  SIGTERM exercises the graceful preempt path, SIGKILL the torn-process
  + ``--resume`` path (subprocess tests only, naturally).
- **Checkpoint corruption** (``truncate_file`` / ``corrupt_file``):
  deterministic byte-level damage, for proving restore() fails loudly
  and the CheckpointRing falls through to the previous healthy file.
- **Native library loss** (``hidden_native_lib``): inside the window
  ``PCNN_DISABLE_NATIVE=1`` makes ``data/native.py`` unavailable, so the
  NumPy twins are exercised; the variable is restored on exit.
- **Device add/remove at step N** (``resize_delta=(N, ±k)``, spec
  ``resize@N:±k``): before optimizer step N (host-side, 0-based, counted
  across epochs) the elastic controller is told the data-parallel world
  changed by k devices — the in-flight re-mesh + ZeRO-3 reshard path
  (resilience/elastic.py). One-shot, like ``nan@``.
- **Replica death at batch N** (``kill_replica_seq=N``, spec
  ``kill-replica@N``): the serving replica about to execute dispatched
  batch N dies (serve.ReplicaDead) — the ReplicaPool failover path:
  evict, retry the in-flight batch on a survivor, re-pin a replacement.
  One-shot.
- **Replica straggler at batch N** (``slow_replica=(N, MS)``, spec
  ``slow-replica@N:MS``): the serving replica about to execute
  dispatched batch N stalls for MS milliseconds before its predict —
  the tail-latency fault the serving SLO gate exists to catch (and the
  harness for training straggler ablations later). One-shot, journaled
  by the batcher like ``kill-replica@``.
- **Training-worker straggler at step N** (``slow_worker=(N, MS)``, spec
  ``slow-worker@N:MS``): the data-parallel worker dispatching its N-th
  gradient computation stalls for MS milliseconds — the training twin of
  ``slow-replica@``, injected at the microbatch dispatch boundary so the
  sync ring visibly stalls while the bounded-staleness/EASGD modes
  (train/async_dp.py) visibly don't. One-shot, journaled
  ``chaos_slow_worker``.
- **Endpoint death at wire request N** (``kill_endpoint_seq=N``, spec
  ``kill-endpoint@N``): the serving network endpoint (serve/net.py)
  dies the moment it has accepted wire request N — in-flight wire
  requests are journaled ``failed`` (never silently lost) and the
  supervisor's bounded-backoff respawn path (serve/supervisor.py) is
  what keeps conservation across the restart. One-shot.
- **Slow-loris client at wire request N** (``slow_loris=(N, MS)``, spec
  ``slow-loris@N:MS``): the loadgen socket client sending wire request
  N stalls MS milliseconds mid-body — past the server's per-connection
  read deadline the half-read request must be reaped as ``expired``,
  not hang a handler thread. One-shot, client-side injection.

The full CLI spec grammar (``_GRAMMAR`` below, consumed by
``from_spec``): ``nan@STEP`` | ``kill@EPOCH`` | ``kill9@EPOCH`` |
``resize@STEP:±K`` | ``kill-replica@SEQ`` | ``slow-replica@SEQ:MS`` |
``slow-worker@STEP:MS`` | ``slow-stage@STEP:MS`` |
``kill-endpoint@SEQ`` | ``slow-loris@SEQ:MS``.

No wall clocks, no unseeded randomness — a chaos run replays exactly.
"""

from __future__ import annotations

import contextlib
import os
import random
import signal
from typing import Any, Optional, Tuple

import torch

from parallel_cnn_tpu_torch.utils.tree import tree_map

# Every spec kind ``from_spec`` accepts, in docstring order.  New kinds
# register here so the grammar-error message (``_GRAMMAR``) names them
# automatically — the two raise sites below share this one constant.
SPEC_KINDS: Tuple[str, ...] = (
    "nan@STEP",
    "kill@EPOCH",
    "kill9@EPOCH",
    "resize@STEP:±K",
    "kill-replica@SEQ",
    "slow-replica@SEQ:MS",
    "slow-worker@STEP:MS",
    "slow-stage@STEP:MS",
    "kill-endpoint@SEQ",
    "slow-loris@SEQ:MS",
)

_GRAMMAR = "expected " + ", ".join(SPEC_KINDS[:-1]) + f" or {SPEC_KINDS[-1]}"


def poison_tree(tree: Any) -> Any:
    """NaN every floating leaf (ints/bools — e.g. optimizer step counters —
    stay intact, as a real NaN gradient would leave them); each leaf keeps
    its device and dtype."""
    return tree_map(
        lambda a: (
            torch.full_like(a, float("nan"))
            if torch.is_tensor(a) and (a.is_floating_point() or a.is_complex())
            else a
        ),
        tree,
    )


class ChaosMonkey:
    """One-shot fault injector threaded through the epoch drivers.

    The trainers call ``after_step`` once per optimizer step (the
    strict-parity scan counts as one step — the whole epoch is one
    program) and ``at_epoch`` once per completed epoch, after the
    checkpoint callback.
    """

    def __init__(
        self,
        nan_step: Optional[int] = None,
        kill_epoch: Optional[int] = None,
        kill_signal: int = signal.SIGTERM,
        resize_delta: Optional[Tuple[int, int]] = None,
        kill_replica_seq: Optional[int] = None,
        slow_replica: Optional[Tuple[int, float]] = None,
        slow_worker: Optional[Tuple[int, float]] = None,
        slow_stage: Optional[Tuple[int, float]] = None,
        kill_endpoint_seq: Optional[int] = None,
        slow_loris: Optional[Tuple[int, float]] = None,
    ):
        self.nan_step = nan_step
        self.kill_epoch = kill_epoch
        self.kill_signal = kill_signal
        # (step, ±k): before optimizer step `step`, the world gains/loses
        # k devices (resilience/elastic.py polls resize_at each step).
        self.resize_delta = resize_delta
        # Dispatched-batch sequence number at which the executing serve
        # replica dies (serve/batcher.py polls kill_replica_at).
        self.kill_replica_seq = kill_replica_seq
        # (seq, ms): the replica executing dispatched batch `seq` stalls
        # for `ms` milliseconds (serve/batcher.py polls slow_replica_at).
        self.slow_replica = slow_replica
        # (step, ms): the training worker dispatching gradient step
        # `step` stalls `ms` milliseconds (train/async_dp.py polls
        # slow_worker_at at the microbatch dispatch boundary).
        self.slow_worker = slow_worker
        # (step, ms): the pipelined trainer dispatching optimizer step
        # `step` stalls `ms` milliseconds at a stage boundary
        # (train/zoo.py polls slow_stage_at before the step dispatch).
        self.slow_stage = slow_stage
        # Wire-request sequence number at which the serving network
        # endpoint dies (serve/net.py polls kill_endpoint_at).
        self.kill_endpoint_seq = kill_endpoint_seq
        # (seq, ms): the loadgen socket client sending wire request
        # `seq` stalls `ms` milliseconds mid-body (serve/loadgen.py's
        # socket transport polls slow_loris_at before each send).
        self.slow_loris = slow_loris
        self.steps_seen = 0
        self.nan_fired = False
        self.kill_fired = False
        self.resize_fired = False
        self.kill_replica_fired = False
        self.slow_replica_fired = False
        self.slow_worker_fired = False
        self.slow_stage_fired = False
        self.kill_endpoint_fired = False
        self.slow_loris_fired = False

    def after_step(self, tree: Any, loss: Any) -> Tuple[Any, Any]:
        """Post-step hook: returns (possibly poisoned) (tree, loss)."""
        step = self.steps_seen
        self.steps_seen += 1
        if (
            self.nan_step is not None
            and step == self.nan_step
            and not self.nan_fired
        ):
            self.nan_fired = True
            return poison_tree(tree), loss
        return tree, loss

    def at_epoch(self, epoch: int) -> None:
        """Epoch-boundary hook: deliver the configured kill signal."""
        if (
            self.kill_epoch is not None
            and epoch >= self.kill_epoch
            and not self.kill_fired
        ):
            self.kill_fired = True
            os.kill(os.getpid(), self.kill_signal)

    def resize_at(self, step: int) -> Optional[int]:
        """Pre-step hook (elastic controller): the one-shot world-size
        delta (±k) to apply before optimizer step ``step``, else None."""
        if (
            self.resize_delta is not None
            and not self.resize_fired
            and step >= self.resize_delta[0]
        ):
            self.resize_fired = True
            return self.resize_delta[1]
        return None

    def kill_replica_at(self, seq: int) -> bool:
        """Dispatch hook (serve batcher): True exactly once, for the
        replica about to execute dispatched batch ``seq``."""
        if (
            self.kill_replica_seq is not None
            and not self.kill_replica_fired
            and seq >= self.kill_replica_seq
        ):
            self.kill_replica_fired = True
            return True
        return False

    def slow_replica_at(self, seq: int) -> Optional[float]:
        """Dispatch hook (serve batcher): the straggler stall in
        milliseconds, exactly once, for the replica about to execute
        dispatched batch ``seq``; None otherwise."""
        if (
            self.slow_replica is not None
            and not self.slow_replica_fired
            and seq >= self.slow_replica[0]
        ):
            self.slow_replica_fired = True
            return self.slow_replica[1]
        return None

    def slow_worker_at(self, step: int) -> Optional[float]:
        """Dispatch hook (async trainer): the straggler stall in
        milliseconds, exactly once, for the worker dispatching gradient
        step ``step``; None otherwise."""
        if (
            self.slow_worker is not None
            and not self.slow_worker_fired
            and step >= self.slow_worker[0]
        ):
            self.slow_worker_fired = True
            return self.slow_worker[1]
        return None

    def slow_stage_at(self, step: int) -> Optional[float]:
        """Dispatch hook (pipelined trainer): the stage-boundary stall
        in milliseconds, exactly once, for the trainer dispatching
        optimizer step ``step``; None otherwise."""
        if (
            self.slow_stage is not None
            and not self.slow_stage_fired
            and step >= self.slow_stage[0]
        ):
            self.slow_stage_fired = True
            return self.slow_stage[1]
        return None

    def kill_endpoint_at(self, seq: int) -> bool:
        """Wire hook (serve net endpoint): True exactly once, for the
        endpoint that has just accepted wire request ``seq``."""
        if (
            self.kill_endpoint_seq is not None
            and not self.kill_endpoint_fired
            and seq >= self.kill_endpoint_seq
        ):
            self.kill_endpoint_fired = True
            return True
        return False

    def slow_loris_at(self, seq: int) -> Optional[float]:
        """Client hook (loadgen socket transport): the mid-body stall in
        milliseconds, exactly once, for the client sending wire request
        ``seq``; None otherwise."""
        if (
            self.slow_loris is not None
            and not self.slow_loris_fired
            and seq >= self.slow_loris[0]
        ):
            self.slow_loris_fired = True
            return self.slow_loris[1]
        return None

    @classmethod
    def from_spec(cls, spec: str) -> "ChaosMonkey":
        """Parse a CLI fault spec (full grammar in ``SPEC_KINDS``):
        ``nan@STEP``, ``kill@EPOCH`` (SIGTERM), ``kill9@EPOCH`` (SIGKILL),
        ``resize@STEP:±K`` (elastic world-size delta at step STEP),
        ``kill-replica@SEQ`` (serve replica death at dispatched batch
        SEQ), ``slow-replica@SEQ:MS`` (serve replica stalls MS ms at
        dispatched batch SEQ), ``slow-worker@STEP:MS`` (training
        worker stalls MS ms dispatching gradient step STEP),
        ``slow-stage@STEP:MS`` (pipelined trainer stalls MS ms at a
        stage boundary dispatching optimizer step STEP),
        ``kill-endpoint@SEQ`` (serving network endpoint dies at wire
        request SEQ), or ``slow-loris@SEQ:MS`` (loadgen socket client
        stalls MS ms mid-body sending wire request SEQ)."""
        kind, sep, arg = spec.partition("@")
        if not sep or not arg:
            raise ValueError(f"bad chaos spec {spec!r}; {_GRAMMAR}")
        if kind in ("slow-replica", "slow-worker", "slow-stage",
                    "slow-loris"):
            seq, ssep, ms = arg.partition(":")
            try:
                if not ssep:
                    raise ValueError(arg)
                delay = float(ms)
                if delay <= 0:
                    raise ValueError(arg)
                if kind == "slow-worker":
                    return cls(slow_worker=(int(seq), delay))
                if kind == "slow-stage":
                    return cls(slow_stage=(int(seq), delay))
                if kind == "slow-loris":
                    return cls(slow_loris=(int(seq), delay))
                return cls(slow_replica=(int(seq), delay))
            except ValueError:
                raise ValueError(
                    f"bad chaos spec {spec!r}; {kind} wants "
                    f"{kind}@SEQ:MS with positive MS "
                    f"(e.g. {kind}@2:250)"
                ) from None
        if kind == "resize":
            step, ssep, delta = arg.partition(":")
            try:
                if not ssep:
                    raise ValueError(arg)
                d = int(delta)  # accepts +k / -k
                if d == 0:
                    raise ValueError(arg)
                return cls(resize_delta=(int(step), d))
            except ValueError:
                raise ValueError(
                    f"bad chaos spec {spec!r}; resize wants "
                    "resize@STEP:±K with nonzero K (e.g. resize@40:-4)"
                ) from None
        if not arg.isdigit():
            raise ValueError(f"bad chaos spec {spec!r}; {_GRAMMAR}")
        n = int(arg)
        if kind == "nan":
            return cls(nan_step=n)
        if kind == "kill":
            return cls(kill_epoch=n, kill_signal=signal.SIGTERM)
        if kind == "kill9":
            return cls(kill_epoch=n, kill_signal=signal.SIGKILL)
        if kind == "kill-replica":
            return cls(kill_replica_seq=n)
        if kind == "kill-endpoint":
            return cls(kill_endpoint_seq=n)
        raise ValueError(f"unknown chaos fault {kind!r} in {spec!r}")


def truncate_file(path: str, keep_bytes: int = 16) -> None:
    """Truncate a file to its first ``keep_bytes`` bytes (a torn write)."""
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)


def corrupt_file(path: str, *, seed: int = 0, n_bytes: int = 64) -> None:
    """Deterministically overwrite ``n_bytes`` in the middle of a file
    (bit-rot / partial overwrite, size preserved)."""
    size = os.path.getsize(path)
    start = max(0, size // 2 - n_bytes // 2)
    junk = bytes(random.Random(seed).randrange(256) for _ in range(n_bytes))
    with open(path, "r+b") as f:
        f.seek(start)
        f.write(junk[: max(0, size - start)])


@contextlib.contextmanager
def hidden_native_lib():
    """Make the native C++ runtime unavailable for the duration.

    Sets ``PCNN_DISABLE_NATIVE=1`` (``data/native.py``'s ``load_lib``
    raises NativeBuildError before touching the toolchain, and
    ``available()`` is False), so the NumPy fallback paths are
    exercised; restores the variable on exit. JAX also evicts its
    cached module, since it reads the variable at import; the port's
    reads it at each load."""
    saved_env = os.environ.get("PCNN_DISABLE_NATIVE")
    os.environ["PCNN_DISABLE_NATIVE"] = "1"
    try:
        yield
    finally:
        if saved_env is None:
            os.environ.pop("PCNN_DISABLE_NATIVE", None)
        else:
            os.environ["PCNN_DISABLE_NATIVE"] = saved_env
