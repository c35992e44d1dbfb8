"""Last-good checkpoint ring and bounded auto-rollback (the port's
``parallel_cnn_tpu/resilience/rollback.py``).

- ``CheckpointRing`` — a pruned on-disk ring over train/checkpoint.py's
  atomic .npz files: keep the newest ``keep``, restore the newest one that
  loads (a torn or corrupt file is logged and skipped). ``saver`` swaps
  the writer (the ZeRO-3 trainer's ``checkpoint.save_sharded``), and
  ``restore_latest_sharded`` reads such a ring.
- ``RollbackController`` — commit() snapshots the last state the sentinel
  judged healthy; rollback() hands back a fresh copy, counts against
  ``max_rollbacks`` (RetriesExhaustedError past it) and exposes the
  cumulative LR backoff factor. It prefers its in-memory snapshot and
  falls back to the ring, the same files --resume reads.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Optional, Tuple

from parallel_cnn_tpu_torch.resilience.sentinel import RetriesExhaustedError
from parallel_cnn_tpu_torch.utils.tree import tree_map

log = logging.getLogger(__name__)


def _checkpoint():
    # Imported when first used: train/ imports this package.
    from parallel_cnn_tpu_torch.train import checkpoint

    return checkpoint


def tree_copy(tree: Any) -> Any:
    """A fresh-buffer copy of every tensor leaf (a snapshot nothing else
    aliases)."""
    return tree_map(lambda t: t.clone(), tree)


class CheckpointRing:
    """Bounded ring of ``<prefix><tag>.npz`` checkpoints in a directory;
    ``keep <= 0`` disables pruning. ``saver`` is the write hook, with
    ``checkpoint.save``'s ``(path, tree, state)`` signature (None:
    ``checkpoint.save``)."""

    def __init__(self, directory: str, keep: int = 3, prefix: str = "ckpt_",
                 saver=None):
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        self.saver = saver

    def path_for(self, tag: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}{tag}.npz")

    def tags(self) -> List[int]:
        """Existing checkpoint tags, newest first."""
        if not os.path.isdir(self.directory):
            return []
        found = []
        for name in os.listdir(self.directory):
            if not (name.startswith(self.prefix) and name.endswith(".npz")):
                continue
            if name.endswith(".tmp.npz"):
                continue  # torn atomic-write leftover, never a checkpoint
            try:
                found.append(int(name[len(self.prefix):-4]))
            except ValueError:
                continue
        return sorted(found, reverse=True)

    def save(self, tag: int, params, state=None) -> str:
        path = self.path_for(tag)
        (self.saver or _checkpoint().save)(path, params, state)
        self._prune()
        return path

    def _prune(self) -> None:
        if self.keep <= 0:
            return
        for tag in self.tags()[self.keep:]:
            try:
                os.unlink(self.path_for(tag))
            except OSError:  # already gone — pruning is best-effort
                pass

    def restore_latest(self, like) -> Optional[Tuple[Any, Any, str]]:
        """(params, state, path) from the newest checkpoint that loads."""
        for tag in self.tags():
            path = self.path_for(tag)
            try:
                params, state = _checkpoint().restore(path, like)
                return params, state, path
            except ValueError as e:
                log.warning("skipping unusable checkpoint %s: %s", path, e)
        return None

    def restore_latest_sharded(self, like) -> Optional[Tuple[Any, Any, dict, str]]:
        """(view, state, zero3 metadata, path) from the newest sharded
        checkpoint that loads into ``like`` (a ``zero3_full_view``-shaped
        tree), or None: the twin of ``restore_latest`` for a ring that
        ``save_sharded`` wrote, which ``restore`` refuses. Unreadable,
        unsharded or mismatched files are logged and skipped."""
        for tag in self.tags():
            path = self.path_for(tag)
            try:
                view, state, zmeta = _checkpoint().restore_sharded(path, like)
                return view, state, zmeta, path
            except ValueError as e:
                log.warning("skipping unusable sharded checkpoint %s: %s", path, e)
        return None


class RollbackController:
    """Bounded auto-rollback to the last sentinel-approved state."""

    def __init__(
        self,
        max_rollbacks: int = 3,
        lr_backoff: float = 0.5,
        ring: Optional[CheckpointRing] = None,
    ):
        self.max_rollbacks = max_rollbacks
        self.lr_backoff = lr_backoff
        self.ring = ring
        self.rollbacks = 0
        self._snapshot: Any = None
        self._meta: Any = None

    @property
    def lr_scale(self) -> float:
        """Cumulative LR factor after the rollbacks so far."""
        return self.lr_backoff**self.rollbacks

    def commit(self, tree: Any, meta: Any = None) -> None:
        """Snapshot a state the sentinel judged healthy."""
        self._snapshot = tree_copy(tree)
        self._meta = meta

    def rollback(self, like: Any = None, reason: str = "") -> Tuple[Any, Any]:
        """(state, meta) of the newest healthy snapshot; counts a retry."""
        if self.rollbacks >= self.max_rollbacks:
            raise RetriesExhaustedError(
                f"divergence recurred after {self.rollbacks} rollbacks "
                f"(max_rollbacks={self.max_rollbacks}): {reason}"
            )
        self.rollbacks += 1
        if self._snapshot is not None:
            log.warning(
                "rollback %d/%d (%s): restoring in-memory last-good state"
                " (lr scale %.3g)",
                self.rollbacks, self.max_rollbacks, reason, self.lr_scale,
            )
            return tree_copy(self._snapshot), self._meta
        if self.ring is not None and like is not None:
            restored = self.ring.restore_latest(like)
            if restored is not None:
                params, state, path = restored
                log.warning(
                    "rollback %d/%d (%s): restored %s",
                    self.rollbacks, self.max_rollbacks, reason, path,
                )
                return params, state
        raise RetriesExhaustedError(
            f"nothing to roll back to (no healthy snapshot or readable "
            f"checkpoint): {reason}"
        )
