"""Intra-op (model-axis) decomposition of LeNet-ref, composed with data
parallelism on the (data, model) mesh (the port of
``parallel_cnn_tpu/parallel/intra_op.py``).

- conv c1: the 6 filters are split over ``model``; each rank computes its
  feature maps only (≙ the MPI backend's split of fp_c1's output space,
  MPI/layer.h:162-201).
- pool s1: channel-local, so it keeps the conv's channel split with no
  communication.
- fc f: the 216-wide contraction is split over ``model`` (the flattened
  (6, 6, 6) input is channel-major, so a channel shard IS a contiguous
  column block of ``f.w``); the partial products are summed over
  ``model`` (≙ MPI/layer.h:345-368, with the broadcast back).

Backward follows the same split. Per step there are three collectives:
the forward's psum of ``pre_f`` and the backward's one psum of the shared
pool kernel's grads (``g_w_s1``, ``g_b_s1``), both over ``model`` and
always psum (small and latency-bound), and the grads' all-reduce over
``data`` with ``comm``. JAX ``vmap``s a per-sample body; here the batch is
a tensor dimension, and the pool grads are summed over the batch before
their model-axis psum.

Legal model-axis sizes divide 6 (the filter count): 1, 2, 3, 6. Every
rank holds its shard of the params (``shard_params``); ``gather_params``
is the inverse, for checkpoints and ``test()``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from parallel_cnn_tpu_torch.ops import reference
from parallel_cnn_tpu_torch.ops.activations import (
    apply_grad,
    error_norm,
    make_error,
    sigmoid,
    sigmoid_grad_from_preact,
)
from parallel_cnn_tpu_torch.parallel import collectives
from parallel_cnn_tpu_torch.parallel.data_parallel import check_global_batch, psum_scalar
from parallel_cnn_tpu_torch.utils.tree import tree_map

Params = reference.Params

#: How the params are laid out over the mesh: the dim of each leaf that is
#: split over ``model`` (JAX's PARAM_SPECS: ``P(MODEL_AXIS)`` is dim 0,
#: ``P(None, MODEL_AXIS)`` dim 1), None for a replicated leaf.
PARAM_SPECS: Dict[str, Dict[str, Optional[int]]] = {
    "c1": {"w": 0, "b": 0},
    "s1": {"w": None, "b": None},
    "f": {"w": 1, "b": None},
}


def shard_params(mesh, params: Params) -> Params:
    """This rank's shard of a whole params tree (JAX's ``shard_params``),
    copied onto the rank's device: model rank m of M holds block m of each
    split leaf."""
    axis = mesh.model

    def shard(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        t = t.detach().to(mesh.device)
        if dim is None:
            return t.clone()
        if t.shape[dim] % axis.size:
            raise ValueError(f"model axis {axis.size} does not divide a leaf "
                             f"of shape {tuple(t.shape)} on dim {dim}")
        return t.chunk(axis.size, dim)[axis.index].contiguous()

    return {layer: {name: shard(t, PARAM_SPECS[layer][name]) for name, t in leaves.items()}
            for layer, leaves in params.items()}


def gather_params(mesh, params: Params) -> Params:
    """The whole params tree from every model rank's shard (the inverse of
    ``shard_params``; a collective over ``model``, bit-exact copies)."""
    axis = mesh.model

    def gather(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        if dim is None or axis.size == 1:
            return t.clone()
        moved = t.movedim(dim, 0).contiguous()
        whole = collectives.ring_all_gather(moved, axis)
        return whole.movedim(0, dim).contiguous()

    return {layer: {name: gather(t, PARAM_SPECS[layer][name]) for name, t in leaves.items()}
            for layer, leaves in params.items()}


def _forward_local(params: Params, x: torch.Tensor, model_axis) -> Tuple:
    """The forward on one (data, model) shard, batched: x (b, 28, 28), the
    same on every model rank; ``c1.w`` is (6/M, 5, 5), ``f.w`` (10, 216/M)."""
    pre_c1 = reference.conv_c1_forward(x, params["c1"]["w"], params["c1"]["b"])
    out_c1 = sigmoid(pre_c1)                        # (b, 6/M, 24, 24)
    pre_s1 = reference.pool_s1_forward(out_c1, params["s1"]["w"], params["s1"]["b"])
    out_s1 = sigmoid(pre_s1)                        # (b, 6/M, 6, 6)
    # The split 216-contraction: a partial product per rank, then psum.
    partial = out_s1.reshape(x.shape[0], -1) @ params["f"]["w"].T
    pre_f = collectives.all_reduce_sum(partial, model_axis) + params["f"]["b"]
    out_f = sigmoid(pre_f)
    return pre_c1, out_c1, pre_s1, out_s1, pre_f, out_f


def _local_grad_sums(params: Params, x: torch.Tensor, y: torch.Tensor,
                     model_axis) -> Tuple[torch.Tensor, Params]:
    """(err sum, grads summed over the rows) on one shard: the reference
    backward (ops/reference.py ``backward``) under the model split, with
    one psum over ``model`` for the shared pool kernel's grads."""
    pre_c1, out_c1, pre_s1, out_s1, pre_f, out_f = _forward_local(params, x, model_axis)
    b, cm = out_c1.shape[:2]

    d_pre_f = make_error(out_f, y)                  # the same on every model rank
    err = error_norm(d_pre_f)

    # FC grads: the outer product is split over the contraction like w_f.
    g_w_f = d_pre_f[:, :, None] * out_s1.reshape(b, 1, -1)
    g_b_f = d_pre_f

    # Pool backward: each model rank needs only ITS columns of w_f.
    d_out_s1 = (d_pre_f @ params["f"]["w"]).reshape(b, cm, 6, 6)
    d_pre_s1 = d_out_s1 * sigmoid_grad_from_preact(pre_s1)
    # The shared 4×4 kernel and scalar bias contract over ALL channels:
    # psum over model (≙ MPI bp_weight_s1's reduce).
    windows = out_c1.reshape(b, cm, 6, 4, 6, 4)
    pool = {
        "w": torch.einsum("bmxy,bmxiyj->ij", d_pre_s1, windows),
        "b": torch.sum(d_pre_s1) / reference.POOL_BIAS_NORM,
    }
    pool = collectives.tree_all_reduce(pool, model_axis)

    # Conv backward: channel-local throughout (the filters are split).
    d_out_c1 = torch.einsum("bmxy,ij->bmxiyj", d_pre_s1,
                            params["s1"]["w"]).reshape(b, cm, 24, 24)
    d_pre_c1 = d_out_c1 * sigmoid_grad_from_preact(pre_c1)
    g_w_c1 = torch.einsum(
        "bmp,bkp->bmk", d_pre_c1.reshape(b, cm, 576), reference.patches(x)
    ).reshape(b, cm, 5, 5) / reference.CONV_NORM
    g_b_c1 = torch.sum(d_pre_c1, dim=(2, 3)) / reference.CONV_NORM

    per_sample = {"c1": {"w": g_w_c1, "b": g_b_c1}, "f": {"w": g_w_f, "b": g_b_f}}
    sums = tree_map(lambda g: torch.sum(g, dim=0), per_sample)
    sums["s1"] = pool
    return torch.sum(err), sums


def make_2d_step(mesh, dt: float, global_batch: int, comm=None) -> Callable:
    """The hybrid DP × model-parallel train step: ``step(params, x, y) ->
    (params, mean_err)`` with params this rank's shard (``shard_params``)
    and x (B/n_data, 28, 28), y this rank's rows (the same on every model
    rank of a data row). Grads are all-reduced over ``data`` with ``comm``
    (None is one psum); the model-axis collectives stay psum."""
    data_axis, model_axis = mesh.data, mesh.model

    def step(params: Params, x: torch.Tensor, y: torch.Tensor):
        check_global_batch(x.shape[0], data_axis.size, global_batch)
        err_sum, local = _local_grad_sums(params, x, y, model_axis)
        err_sum = psum_scalar(err_sum, data_axis)
        grad_sum = collectives.tree_all_reduce(local, data_axis, comm)
        mean_grads = tree_map(lambda g: g / global_batch, grad_sum)
        return apply_grad(params, mean_grads, dt), err_sum / global_batch

    return step


def make_2d_forward(mesh) -> Callable:
    """Batched model-parallel inference: ``forward(params, x)`` → the (b, 10)
    outputs of this rank's rows, from its params shard."""

    def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
        return _forward_local(params, x, mesh.model)[-1]

    return forward
