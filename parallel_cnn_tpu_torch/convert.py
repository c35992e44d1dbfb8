"""Weights written by the JAX package, carried into the port's modules.

The JAX zoo models keep two pytrees: ``params`` (a list per Sequential
layer; a ConvBNAct is ``{"conv": {"w"}, "bn": {"scale", "bias"}}``, a
residual block ``{"main": [...], "proj": [...]}``, a Dense ``{"w", "b"}``)
and ``model_state`` (BatchNorm running stats ``{"bn": {"mean", "var"}}``).
The port's module tree is named the same way, so a tree path
``3/main/0/bn/scale`` is the state_dict key ``3.main.0.bn.scale`` — in
both trees the arrays keep their JAX layouts (HWIO conv weights, Dense
``w`` as (d, features)).

``load_jax_checkpoint`` reads the JAX package's checkpoint format through
the reader the port's trainer uses (``train/checkpoint.py``): an ``.npz``
whose keys are the '/'-joined tree paths of a ``ZooState(params,
model_state, opt_state)`` plus a ``__meta__`` JSON blob carrying
``version`` 1. Optimizer leaves are ignored, as ``checkpoint.load_params``
ignores them.

``lenet_from_jax`` carries the LeNet-ref params tree across: the port keeps
it as it is, ``{"c1": {"w", "b"}, "s1": {"w", "b"}, "f": {"w", "b"}}``.

``zoo_from_jax`` / ``zoo_to_jax`` carry a whole zoo training state across
(JAX's ``ZooState(params, model_state, opt_state)``: the weights, the BN
running statistics, the optax momentum trace and schedule count, or the
update-on-arrival step's ``FusedOptState``) under the JAX checkpoint's
keys (``.params/0/w``, ``.opt_state/0/0/.trace/0/w``,
``.opt_state/0/1/.count``; ``.opt_state/.mom/0``, ``.opt_state/.scale``),
the keys ``train.zoo.ZooState.arrays()`` uses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from parallel_cnn_tpu_torch.models.lenet_ref import SHAPES
from parallel_cnn_tpu_torch.train.checkpoint import _read_arrays, _reject_sharded


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _flatten_jax(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Leaves under JAX's key paths: a dict key, a sequence index, or
    ``.field`` for a named tuple's field (optax states) or a dataclass's
    (``FusedOptState``)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten_jax(getattr(tree, f.name), f"{prefix}.{f.name}/", out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_jax(v, f"{prefix}{k}/", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            _flatten_jax(v, f"{prefix}.{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_jax(v, f"{prefix}{i}/", out)
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)


def zoo_from_jax(state, jax_state):
    """Load a JAX ``ZooState`` (any object with ``params``,
    ``model_state`` and ``opt_state``, numpy leaves or anything numpy
    reads) into the port's ``train.zoo.ZooState``, in place; returns it.
    Every key, shape and dtype must match the port's state."""
    arrays: Dict[str, np.ndarray] = {}
    for name in ("params", "model_state", "opt_state"):
        _flatten_jax(getattr(jax_state, name), f".{name}/", arrays)
    state.load(arrays)
    return state


def zoo_to_jax(state) -> Dict[str, np.ndarray]:
    """The port's zoo state as numpy arrays under JAX's checkpoint keys (a
    JAX ``ZooState`` template's flattened paths), a fused state's momentum
    blocks whole (every rank calls it: ``ZooState.checkpoint_arrays``)."""
    return {k: v.detach().cpu().numpy()
            for k, v in state.checkpoint_arrays().items()}


def from_jax(params: Any, model_state: Any) -> Dict[str, torch.Tensor]:
    """A state_dict for the port's model from the JAX package's
    ``(params, model_state)`` trees (numpy arrays, or anything numpy can
    read). Load it with ``model.load_state_dict(sd)``, which checks that
    every key and shape matches."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    _flatten(model_state, "", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def lenet_from_jax(params: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's LeNet-ref params (f32 tensors on the CPU) from the JAX
    package's tree (numpy arrays, or anything numpy reads). Keys and shapes
    must be exactly those of ``models.lenet_ref.SHAPES``."""
    if set(params) != set(SHAPES):
        raise ValueError(f"LeNet params have layers {sorted(params)}, "
                         f"expected {sorted(SHAPES)}")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer, shapes in SHAPES.items():
        if set(params[layer]) != set(shapes):
            raise ValueError(f"LeNet layer {layer!r} has leaves "
                             f"{sorted(params[layer])}, expected {sorted(shapes)}")
        out[layer] = {}
        for name, shape in shapes.items():
            a = np.asarray(params[layer][name], dtype=np.float32)
            if a.shape != shape:
                raise ValueError(f"LeNet leaf {layer}/{name} has shape "
                                 f"{a.shape}, expected {shape}")
            out[layer][name] = torch.from_numpy(np.array(a, copy=True))
    return out


def load_jax_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Fill ``model`` (in place) from a zoo checkpoint the JAX trainer
    wrote; returns ``model``. Missing leaves and shape or dtype mismatches
    raise ValueError; surplus leaves (optimizer state) are ignored."""
    stored, meta = _read_arrays(path)
    _reject_sharded(path, meta, "load_jax_checkpoint")
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
