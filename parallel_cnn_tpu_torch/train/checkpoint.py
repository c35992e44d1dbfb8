"""Checkpoint and resume in the JAX package's format (the port of
``parallel_cnn_tpu/train/checkpoint.py``).

One .npz per checkpoint: the params tree flattened to '/'-joined key paths
(``c1/w``, ``c1/b``, …, a 0-d ``s1/b``) plus a ``__meta__`` JSON blob
(format version 1, epoch, epoch errors, extra). The write is atomic (tmp +
rename), so a killed process never leaves a torn checkpoint. A file either
package writes, the other reads: ``restore`` here reads what JAX's
``checkpoint.save`` wrote, and JAX's ``restore`` reads what ``save`` here
writes. A ZeRO-3 sharded checkpoint is refused with a typed error.

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


def save(path: str, params, state: Optional[TrainState] = None) -> None:
    """Atomically write params (+ train state) to `path` (.npz)."""
    state = state or TrainState()
    _write_atomic(path, params, {
        "version": FORMAT_VERSION,
        "epoch": state.epoch,
        "epoch_errors": state.epoch_errors,
        "extra": state.extra,
    })


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
        raise ValueError(
            f"{path!r} is a sharded (ZeRO-3) checkpoint (world_size="
            f"{meta['zero3'].get('world_size')}); {reader} reads unsharded "
            f"trees only"
        )


def restore(path: str, like) -> Tuple[Any, TrainState]:
    """Load a checkpoint into the structure of `like` (a params tree of
    tensors); each leaf lands on its `like` leaf's device.

    The stored keys, shapes and dtypes must match `like` exactly: a renamed
    layer or changed shape is a hard error, not a partial load."""
    stored, meta = _read_arrays(path)
    _reject_sharded(path, meta, "restore")
    like_leaves, treedef = tree_flatten(like)
    keys = tree_paths(like)
    if set(stored) != set(keys):
        missing = set(keys) - set(stored)
        surplus = set(stored) - set(keys)
        raise ValueError(
            f"checkpoint structure mismatch: missing={sorted(missing)} "
            f"surplus={sorted(surplus)}"
        )
    leaves = []
    for key, leaf in zip(keys, like_leaves):
        a = stored[key]
        want = leaf.detach().cpu().numpy()
        if a.shape != want.shape or a.dtype != want.dtype:
            raise ValueError(
                f"checkpoint leaf '{key}' is {a.shape}/{a.dtype}, expected "
                f"{want.shape}/{want.dtype}"
            )
        leaves.append(torch.from_numpy(np.array(a, copy=True)).to(leaf.device))
    state = TrainState(
        epoch=meta["epoch"],
        epoch_errors=list(meta["epoch_errors"]),
        extra=dict(meta["extra"]),
    )
    return tree_unflatten(treedef, leaves), state


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
