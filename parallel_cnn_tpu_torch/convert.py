"""Weights written by the JAX package, carried into the port's modules.

The JAX zoo models keep two pytrees: ``params`` (a list per Sequential
layer; a ConvBNAct is ``{"conv": {"w"}, "bn": {"scale", "bias"}}``, a
residual block ``{"main": [...], "proj": [...]}``, a Dense ``{"w", "b"}``)
and ``model_state`` (BatchNorm running stats ``{"bn": {"mean", "var"}}``).
The port's module tree is named the same way, so a tree path
``3/main/0/bn/scale`` is the state_dict key ``3.main.0.bn.scale`` — in
both trees the arrays keep their JAX layouts (HWIO conv weights, Dense
``w`` as (d, features)).

``load_jax_checkpoint`` reads the JAX package's checkpoint format with
numpy alone (the port's copy of the reader in
``parallel_cnn_tpu/train/checkpoint.py``): an ``.npz`` whose keys are the
'/'-joined tree paths of a ``ZooState(params, model_state, opt_state)``
plus a ``__meta__`` JSON blob carrying ``version`` 1. Optimizer leaves are
ignored, as ``checkpoint.load_params`` ignores them.
"""

from __future__ import annotations

import json
import zipfile
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

FORMAT_VERSION = 1


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def from_jax(params: Any, model_state: Any) -> Dict[str, torch.Tensor]:
    """A state_dict for the port's model from the JAX package's
    ``(params, model_state)`` trees (numpy arrays, or anything numpy can
    read). Load it with ``model.load_state_dict(sd)``, which checks that
    every key and shape matches."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    _flatten(model_state, "", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def _read_npz(path: str):
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            stored = {k: z[k] for k in z.files if k != "__meta__"}
    except (zipfile.BadZipFile, EOFError, OSError, KeyError,
            json.JSONDecodeError) as e:
        raise ValueError(f"corrupted or unreadable checkpoint {path!r}: {e}") from e
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint version {meta.get('version')} != {FORMAT_VERSION}"
        )
    if meta.get("zero3"):
        raise ValueError(
            f"{path!r} is a sharded (ZeRO-3) checkpoint; the port reads "
            f"unsharded zoo checkpoints only"
        )
    return stored


def load_jax_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Fill ``model`` (in place) from a zoo checkpoint the JAX trainer
    wrote; returns ``model``. Missing leaves and shape or dtype mismatches
    raise ValueError; surplus leaves (optimizer state) are ignored."""
    stored = _read_npz(path)
    by_key: Dict[str, np.ndarray] = {}
    for k, v in stored.items():
        head, _, rest = k.lstrip(".").partition("/")
        if head in ("params", "model_state") and rest:
            by_key[rest.replace("/", ".")] = v
    want = model.state_dict()
    missing = sorted(set(want) - set(by_key))
    if missing:
        raise ValueError(f"checkpoint {path!r} lacks required leaves: {missing}")
    for k, t in want.items():
        a = by_key[k]
        if tuple(a.shape) != tuple(t.shape) or a.dtype != np.float32:
            raise ValueError(
                f"checkpoint leaf '{k}' is {a.shape}/{a.dtype}, expected "
                f"{tuple(t.shape)}/float32"
            )
    model.load_state_dict(
        {k: torch.from_numpy(np.array(by_key[k], copy=True)) for k in want}
    )
    return model
