"""Model-axis (filter/channel) sharding of the zoo's state (the port of
``parallel_cnn_tpu/parallel/zoo_sharding.py``).

JAX states one rule per leaf (``leaf_spec``: the trailing axis over the
mesh's ``model`` axis when it divides evenly, replicated otherwise) and
lets GSPMD place the collectives. The port runs one process per rank, so
the rule is applied here once, to the module itself: each leaf the rule
splits is replaced by this rank's block of it, stored as a tensor of its
own (contiguous, so the conv kernels take their vector paths), and every
layer is told how it runs on the mesh (``nn.layers.Sharding``). The
layers then gather activations over the model axis where the next layer
needs all of its input channels (nn/layers.py); the momentum trace is made
from the sharded parameters, so it shards with them.

Trailing-axis-by-rule, in the port's layouts (JAX's):

- conv ``w`` (kh, kw, cin, cout) → cout split (filter sharding);
- conv ``b`` and BatchNorm scale/bias/mean/var (c,) → channel split;
- Dense ``w`` (d, features) → features split (column parallel);
- a leaf whose trailing axis does not divide (a 10-class head on a model
  axis of 4) → whole on every rank.

Without a model axis (``model_axis=False``, or a model axis of one rank),
every leaf stays whole on every rank: JAX's ``constrain_replicated``, the
data-parallel GSPMD step.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn


def leaf_spec(leaf: Any, model_size: int) -> Optional[int]:
    """The dimension of ``leaf`` split over the model axis, or None for a
    replicated leaf: the trailing one when it is non-zero and divides
    evenly by ``model_size`` (JAX's ``leaf_spec``)."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) >= 1 and _divides(shape[-1], model_size):
        return len(shape) - 1
    return None


def _divides(n: int, model_size: int) -> bool:
    return n > 0 and n % model_size == 0


def shard_leaf(t: torch.Tensor, axis) -> torch.Tensor:
    """This rank's block of ``t``'s trailing axis as a contiguous tensor of
    its own (never a strided view of ``t``)."""
    k = t.shape[-1] // axis.size
    return t[..., axis.index * k:(axis.index + 1) * k].contiguous().clone()


def gather_leaf(t: torch.Tensor, axis) -> torch.Tensor:
    """The whole leaf from every rank's block of its trailing axis (a
    collective over ``axis``; no gradient)."""
    if axis.size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=axis.group)
    return torch.cat(parts, dim=-1)


def _features(module: nn.Module) -> Optional[int]:
    """A layer's output features (the trailing axis of its leaves), or
    None for a layer without leaves of its own."""
    from parallel_cnn_tpu_torch.nn import layers

    if isinstance(module, (layers.Conv2D, layers.Dense)):
        return int(module.w.shape[-1])
    if isinstance(module, layers.ConvBNAct):
        return int(module.conv["w"].shape[-1])
    if isinstance(module, layers.BatchNorm):
        return int(module.scale.shape[-1])
    return None


@dataclasses.dataclass
class ShardPlan:
    """What ``shard_model`` did to a module: the mesh, the model axis the
    leaves split over (None: every leaf whole), the split leaves by
    state_dict key with their dimension, and a whole copy of the module
    for the evaluation forward (None when nothing is split)."""

    mesh: Any
    model: Any
    split: Dict[str, int]
    whole: Optional[nn.Module] = None

    def gather(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf under state_dict ``key`` (collective over the
        model axis for a split leaf)."""
        return gather_leaf(t, self.model) if key in self.split else t

    def local(self, key: str, whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``whole`` for the leaf ``key`` whose local
        tensor is ``like``: its block when the leaf is split and ``whole``
        is the whole leaf, else ``whole``."""
        if (key in self.split and whole.dim() == like.dim() and whole.dim() > 0
                and whole.shape[-1] == like.shape[-1] * self.model.size):
            return shard_leaf(whole, self.model)
        return whole

    def whole_model(self, model: nn.Module) -> nn.Module:
        """``model`` with every leaf whole: the module itself when nothing
        is split, else the whole copy, loaded with the gathered leaves (a
        collective over the model axis)."""
        if self.whole is None:
            return model
        sd = {k: self.gather(k, v) for k, v in model.state_dict().items()}
        self.whole.load_state_dict(sd)
        return self.whole


def shard_model(model: nn.Module, mesh, model_axis: bool) -> ShardPlan:
    """Put ``model`` on one rank of a ``Mesh2D``, in place: every layer's
    ``sharding`` set (BatchNorm's statistics over ``mesh.data``; with
    ``model_axis`` and a model axis of more than one rank, each layer's
    output features split where ``leaf_spec`` splits its leaves), and each
    split parameter and buffer replaced by this rank's block."""
    from parallel_cnn_tpu_torch.nn import layers

    if getattr(model, "sharding", None) is not None:
        raise ValueError("this module is already placed on a mesh")
    model_ax = mesh.model if model_axis and mesh.model.size > 1 else None
    split: Dict[str, int] = {}
    if model_ax is not None:
        for key, t in model.state_dict().items():
            dim = leaf_spec(t, model_ax.size)
            if dim is not None:
                split[key] = dim
    whole = copy.deepcopy(model) if split else None
    for _, module in model.named_modules():
        if isinstance(module, (nn.ModuleList, nn.ParameterDict)):
            continue
        feats = _features(module)
        module.sharding = layers.Sharding(
            data=mesh.data, model=model_ax,
            split=model_ax is not None and feats is not None
            and _divides(feats, model_ax.size))
    if split:
        for prefix, module in model.named_modules():
            pre = f"{prefix}." if prefix else ""
            for name, p in list(module._parameters.items()):
                if p is not None and pre + name in split:
                    module._parameters[name] = nn.Parameter(
                        shard_leaf(p.detach(), model_ax))
            for name, b in list(module._buffers.items()):
                if b is not None and pre + name in split:
                    module._buffers[name] = shard_leaf(b, model_ax)
    return ShardPlan(mesh=mesh, model=model_ax, split=split, whole=whole)
