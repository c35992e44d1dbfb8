"""Checkpoint and resume in the JAX package's format (the port of
``parallel_cnn_tpu/train/checkpoint.py``).

One .npz per checkpoint: the params tree flattened to '/'-joined key paths
(``c1/w``, ``c1/b``, …, a 0-d ``s1/b``) plus a ``__meta__`` JSON blob
(format version 1, epoch, epoch errors, extra). The write is atomic (tmp +
rename), so a killed process never leaves a torn checkpoint. A file either
package writes, the other reads: ``restore`` here reads what JAX's
``checkpoint.save`` wrote, and JAX's ``restore`` reads what ``save`` here
writes.

A ZeRO-3 checkpoint (``save_sharded``) holds the world-size-independent
full view of the state (train/zoo.py ``zero3_full_view``: ``params/…``,
``model_state/…``, ``mom/…`` trees and the loss-scale scalars) and a
``zero3`` entry in the metadata (the writer's world size, bucket budget
and rank), JAX's keys and marker: ``restore_sharded`` reads it for any
world, and ``restore`` and ``load_params`` refuse it with JAX's text.

A writer may stamp the ExecutionPlan it ran under (``plan_fingerprint=``,
the metadata's ``plan`` entry, JAX's key). A reader that passes its live
fingerprint refuses a file stamped with another one (plan/
``PlanMismatchError``, naming both and ``--replan``); ``replan=True``
waives the check, and a file without a stamp always loads.

The zoo trainer saves its whole state through the same two functions: the
tree it passes is ``train.zoo.ZooState.arrays()``, a flat dict whose keys
are already JAX's ``ZooState`` paths (``.params/...``, ``.model_state/...``,
``.opt_state/0/0/.trace/...``, ``.opt_state/0/1/.count``), so the file is
the one JAX's ``zoo.train`` writes and restores. The update-on-arrival
step's ``FusedOptState`` is saved the same way, under ``.opt_state/.mom/<b>``
(each bucket's momentum whole, ``(n_data, L)``), ``.opt_state/.scale``,
``.opt_state/.good_steps`` and ``.opt_state/.skipped``
(``ZooState.checkpoint_arrays``).
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from parallel_cnn_tpu_torch.utils.tree import tree_flatten, tree_paths, tree_unflatten

FORMAT_VERSION = 1


class ShardedCheckpointError(ValueError):
    """A ZeRO-3 sharded checkpoint could not serve the requesting mesh
    (JAX's type and message): a ValueError that names the file, the rank
    that wrote it and the world size it was written at."""

    def __init__(self, message: str, *, path: str,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None):
        coords = [f"path={path!r}"]
        if rank is not None:
            coords.append(f"writer rank={rank}")
        if world_size is not None:
            coords.append(f"expected world size={world_size}")
        super().__init__(f"{message} [{', '.join(coords)}]")
        self.path = path
        self.rank = rank
        self.world_size = world_size


@dataclass
class TrainState:
    """What resume needs beyond the weights."""

    epoch: int = 0
    epoch_errors: List[float] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)


def _flatten(params) -> Dict[str, np.ndarray]:
    leaves = tree_flatten(params)[0]
    return {
        key: (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
              else np.asarray(leaf))
        for key, leaf in zip(tree_paths(params), leaves)
    }


def _write_atomic(path: str, params, meta: Dict[str, Any]) -> None:
    arrays = _flatten(params)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _meta_for(state: Optional[TrainState],
              plan_fingerprint: Optional[str] = None) -> Dict[str, Any]:
    state = state or TrainState()
    meta = {
        "version": FORMAT_VERSION,
        "epoch": state.epoch,
        "epoch_errors": state.epoch_errors,
        "extra": state.extra,
    }
    if plan_fingerprint:
        meta["plan"] = plan_fingerprint
    return meta


def _check_plan(path: str, meta: Dict[str, Any],
                plan_fingerprint: Optional[str], replan: bool) -> None:
    """Refuse a checkpoint written under a different ExecutionPlan (JAX's
    ``_check_plan``): only when the reader passes its live fingerprint;
    files without a stamp always load, and ``replan=True`` waives it."""
    if plan_fingerprint is None or replan:
        return
    stored = meta.get("plan")
    if stored is not None and stored != plan_fingerprint:
        from parallel_cnn_tpu_torch.plan import PlanMismatchError

        raise PlanMismatchError(stored=stored, live=plan_fingerprint, path=path)


def save(path: str, params, state: Optional[TrainState] = None, *,
         plan_fingerprint: Optional[str] = None) -> None:
    """Atomically write params (+ train state) to `path` (.npz), stamped
    with ``plan_fingerprint`` when given."""
    _write_atomic(path, params, _meta_for(state, plan_fingerprint))


def save_sharded(path: str, view, state: Optional[TrainState] = None, *,
                 world_size: int, bucket_bytes: int, rank: int = 0,
                 plan_fingerprint: Optional[str] = None) -> None:
    """Atomically write a ZeRO-3 training state's full view (train/zoo.py
    ``zero3_full_view``: world-size independent, not the resident rows,
    whose padding bakes the world size in) with JAX's ``zero3`` marker:
    the world size and bucket budget that produced it and the writer's
    ``rank``. ``restore_sharded`` re-shards it for any mesh."""
    meta = _meta_for(state, plan_fingerprint)
    meta["zero3"] = {"world_size": world_size, "bucket_bytes": bucket_bytes,
                     "rank": rank}
    _write_atomic(path, view, meta)


def _read_arrays(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Parse a checkpoint npz into (stored arrays, metadata).

    The single home of the torn/corrupt/version-mismatch contract: a
    truncated file, a corrupted zip member, missing or unparseable metadata
    or a format-version mismatch all raise ValueError, which every caller
    (restore, the ring, --resume, convert.load_jax_checkpoint) can catch.
    """
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            stored = {k: z[k] for k in z.files if k != "__meta__"}
    except (zipfile.BadZipFile, EOFError, OSError, KeyError, ValueError) as e:
        raise ValueError(f"corrupted or unreadable checkpoint {path!r}: {e}") from e
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint version {meta.get('version')} != {FORMAT_VERSION}"
        )
    return stored, meta


def _reject_sharded(path: str, meta: Dict[str, Any], reader: str) -> None:
    if meta.get("zero3"):
        z = meta["zero3"]
        raise ValueError(
            f"{path!r} is a sharded (ZeRO-3) checkpoint (world_size="
            f"{z.get('world_size')}), use restore_sharded — "
            f"{reader} reads unsharded trees only"
        )


def _train_state(meta: Dict[str, Any]) -> TrainState:
    return TrainState(epoch=meta["epoch"],
                      epoch_errors=list(meta["epoch_errors"]),
                      extra=dict(meta["extra"]))


def _mismatch(stored, keys) -> Optional[str]:
    if set(stored) == set(keys):
        return None
    return (f"missing={sorted(set(keys) - set(stored))} "
            f"surplus={sorted(set(stored) - set(keys))}")


def _load_like(stored: Dict[str, np.ndarray], like):
    """``like``'s tree with each leaf read from ``stored`` under its path,
    on its ``like`` leaf's device; shapes and dtypes must match."""
    like_leaves, treedef = tree_flatten(like)
    leaves = []
    for key, leaf in zip(tree_paths(like), like_leaves):
        a = stored[key]
        want = leaf.detach().cpu().numpy()
        if a.shape != want.shape or a.dtype != want.dtype:
            raise ValueError(
                f"checkpoint leaf '{key}' is {a.shape}/{a.dtype}, expected "
                f"{want.shape}/{want.dtype}"
            )
        leaves.append(torch.from_numpy(np.array(a, copy=True)).to(leaf.device))
    return tree_unflatten(treedef, leaves)


def restore(path: str, like, *, plan_fingerprint: Optional[str] = None,
            replan: bool = False) -> Tuple[Any, TrainState]:
    """Load a checkpoint into the structure of `like` (a params tree of
    tensors); each leaf lands on its `like` leaf's device.

    The stored keys, shapes and dtypes must match `like` exactly: a renamed
    layer or changed shape is a hard error, not a partial load. A ZeRO-3
    sharded checkpoint raises JAX's "use restore_sharded" error; a file
    stamped with another plan than ``plan_fingerprint``, PlanMismatchError
    (``replan=True`` waives it)."""
    stored, meta = _read_arrays(path)
    _reject_sharded(path, meta, "restore")
    _check_plan(path, meta, plan_fingerprint, replan)
    bad = _mismatch(stored, tree_paths(like))
    if bad:
        raise ValueError(f"checkpoint structure mismatch: {bad}")
    return _load_like(stored, like), _train_state(meta)


def load_params(path: str, like, *, plan_fingerprint: Optional[str] = None,
                replan: bool = False):
    """Inference-only restore (JAX's ``load_params``): ``like``'s leaves
    out of a checkpoint, without the TrainState; surplus stored keys (an
    optimizer's state) are ignored, missing ones and mismatched shapes
    raise. A ZeRO-3 sharded checkpoint raises JAX's "use restore_sharded"
    error, a plan mismatch PlanMismatchError, as ``restore``."""
    stored, meta = _read_arrays(path)
    _reject_sharded(path, meta, "load_params")
    _check_plan(path, meta, plan_fingerprint, replan)
    missing = set(tree_paths(like)) - set(stored)
    if missing:
        raise ValueError(
            f"checkpoint {path!r} lacks required leaves: {sorted(missing)}")
    return _load_like(stored, like)


def restore_sharded(path: str, like, *, plan_fingerprint: Optional[str] = None,
                    replan: bool = False
                    ) -> Tuple[Any, TrainState, Dict[str, Any]]:
    """Load a ZeRO-3 sharded checkpoint's full view into the structure of
    ``like`` (a ``zero3_full_view``-shaped tree): (view, TrainState, the
    ``zero3`` metadata). The view does not depend on the world that wrote
    it; ``zoo.zero3_from_view`` lays it out for this run's mesh. A plan
    mismatch raises PlanMismatchError first (``replan=True`` waives it), as
    JAX's; an unsharded file, or a view that does not match ``like``,
    ``ShardedCheckpointError``."""
    stored, meta = _read_arrays(path)
    _check_plan(path, meta, plan_fingerprint, replan)
    if not meta.get("zero3"):
        raise ShardedCheckpointError(
            "not a sharded checkpoint (no zero3 metadata) — "
            "use restore/load_params", path=path)
    z = meta["zero3"]
    where = dict(path=path, rank=z.get("rank"), world_size=z.get("world_size"))
    bad = _mismatch(stored, tree_paths(like))
    if bad:
        raise ShardedCheckpointError(
            f"sharded checkpoint structure mismatch: {bad}", **where)
    try:
        view = _load_like(stored, like)
    except ValueError as e:
        raise ShardedCheckpointError(str(e), **where) from e
    return view, _train_state(meta), dict(z)


def latest(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Path of the highest-epoch checkpoint in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(directory):
        if name.endswith(".tmp.npz"):
            continue  # torn in-flight write (save() died pre-rename)
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                epoch = int(name[len(prefix):-4])
            except ValueError:
                continue
            if epoch > best_epoch:
                best, best_epoch = os.path.join(directory, name), epoch
    return best
