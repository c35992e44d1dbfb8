"""Reference-semantics forward and hand-written backward in plain PyTorch
(the port of ``parallel_cnn_tpu/ops/reference.py``).

This is the parity surface: it reproduces the numerics contract of the
reference's Sequential kernels, including the parts that are NOT the true
gradient of any loss:

- the /576 normalization of the conv weight and bias grads
  (bp_weight_c1 / bp_bias_c1, Sequential/layer.h:381,389,402,412),
- the /216 normalization of the pool bias grad (bp_bias_s1, layer.h:304-316),
- unnormalized FC grads (bp_weight_f, layer.h:214-227),
- the (onehot − output) error used directly as d_preact of the final layer,
  with no σ′ factor (makeError, layer.h:91-95).

So the backward is written by hand, not taken from autograd. Every
function takes one sample (``x`` of shape (28, 28), a 0-d label) or a batch
(``x`` of shape (B, 28, 28), labels (B,)); a batch gives per-sample results
with a leading B axis, the port of ``jax.vmap`` over the single-sample JAX
functions. Convolutions are an unfold and a matrix product, so on the card
this plain version reaches neither cuDNN nor TF32 (with TF32 matmul off).

Shapes, channel-major like the reference:
    x: (28, 28) → c1: (6, 24, 24) → s1: (6, 6, 6) → f: (10,)
Weights: w_c1 (6, 5, 5), b_c1 (6,); w_s1 (4, 4), b_s1 (); w_f (10, 216),
b_f (10,).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from parallel_cnn_tpu_torch.ops.activations import (
    error_norm,
    make_error,
    sigmoid,
    sigmoid_grad_from_preact,
)

Params = Dict[str, Dict[str, torch.Tensor]]

CONV_NORM = 24.0 * 24.0  # `d` in bp_weight_c1/bp_bias_c1 (layer.h:381,402)
POOL_BIAS_NORM = 6.0 * 6.0 * 6.0  # `total_elements` in bp_bias_s1 (layer.h:304)


class Activations(NamedTuple):
    """Saved forward state (what the reference keeps in each Layer's
    output/preact buffers between forward_pass and back_pass)."""

    x: torch.Tensor        # (28, 28)
    pre_c1: torch.Tensor   # (6, 24, 24)
    out_c1: torch.Tensor   # (6, 24, 24)
    pre_s1: torch.Tensor   # (6, 6, 6)
    out_s1: torch.Tensor   # (6, 6, 6)
    pre_f: torch.Tensor    # (10,)
    out_f: torch.Tensor    # (10,)


def _batched(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    if x.dim() == 2:
        return x.unsqueeze(0), True
    if x.dim() != 3:
        raise ValueError(f"x must be (28, 28) or (B, 28, 28), got {tuple(x.shape)}")
    return x, False


def patches(xb: torch.Tensor) -> torch.Tensor:
    """(B, 25, 576): row p = 5i+j holds x[r+i, c+j] at column 24r+c (JAX's
    ``conv_general_dilated_patches`` of each image, flattened).

    Strided views and one copy: ``F.unfold`` on a CUDA tensor launches one
    im2col kernel per image."""
    b = xb.shape[0]
    windows = xb.unfold(1, 5, 1).unfold(2, 5, 1)  # [b, r, c, i, j] = x[b, r+i, c+j]
    return windows.reshape(b, 576, 25).transpose(1, 2)


def _unbatch(t, single: bool):
    return t.squeeze(0) if single else t


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def conv_c1_forward(xb: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """fp_c1 on a batch (B, 28, 28): valid 5×5 conv + per-filter bias →
    (B, c, 24, 24) for the c filters of ``w`` (c, 5, 5), all 6 or a
    model-axis shard of them (JAX's ``conv_c1_forward``)."""
    c = w.shape[0]
    pre = (w.reshape(c, 25) @ patches(xb)).reshape(xb.shape[0], c, 24, 24)
    return pre + b[:, None, None]


def pool_s1_forward(out_c1: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """fp_s1 on (B, c, 24, 24): ONE shared 4×4 kernel, stride 4, per
    feature map, + scalar bias → (B, c, 6, 6); channel-local, so it takes
    any number of maps (JAX's ``pool_s1_forward``)."""
    n, c = out_c1.shape[:2]
    # windows[b, m, x, i, y, j] = out_c1[b, m, 4x+i, 4y+j]
    windows = out_c1.reshape(n, c, 6, 4, 6, 4)
    return torch.einsum("bmxiyj,ij->bmxy", windows, w) + b


def forward(params: Params, x: torch.Tensor) -> Activations:
    """≙ forward_pass (Sequential/Main.cpp:59-105): conv→σ→pool→σ→FC→σ,
    returning every preact/output buffer for the hand-written backward."""
    xb, single = _batched(x)
    b = xb.shape[0]
    pre_c1 = conv_c1_forward(xb, params["c1"]["w"], params["c1"]["b"])
    out_c1 = sigmoid(pre_c1)
    pre_s1 = pool_s1_forward(out_c1, params["s1"]["w"], params["s1"]["b"])
    out_s1 = sigmoid(pre_s1)
    # fp_preact_f + fp_bias_f: dense 216→10 over the C-order flatten.
    pre_f = out_s1.reshape(b, 216) @ params["f"]["w"].T + params["f"]["b"]
    out_f = sigmoid(pre_f)
    acts = (xb, pre_c1, out_c1, pre_s1, out_s1, pre_f, out_f)
    return Activations(*(_unbatch(t, single) for t in acts))


def predict(params: Params, x: torch.Tensor) -> torch.Tensor:
    """≙ classify (Sequential/Main.cpp:186-200): argmax over the 10 outputs."""
    return torch.argmax(forward(params, x).out_f, dim=-1)


# ---------------------------------------------------------------------------
# Backward — hand-written to the reference contract
# ---------------------------------------------------------------------------


def backward(params: Params, acts: Activations,
             label: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """≙ makeError + back_pass (Sequential/Main.cpp:107-144,167).

    Returns ``(err_norm, grads)`` where the reference's update is exactly
    ``p += dt * g`` for every weight AND bias (it updates biases inside its
    backward kernels with the same form)."""
    single = acts.x.dim() == 2
    if single:
        acts = Activations(*(t.unsqueeze(0) for t in acts))
        label = label.reshape(1)
    b = acts.x.shape[0]
    w_f, w_s1 = params["f"]["w"], params["s1"]["w"]

    # makeError: d_preact_f = onehot(Y) − output; vectorNorm.
    d_pre_f = make_error(acts.out_f, label)
    err = error_norm(d_pre_f)

    # bp_weight_f (outer product, unnormalized); bp_bias_f: g = d_preact.
    g_w_f = d_pre_f[:, :, None] * acts.out_s1.reshape(b, 1, 216)
    g_b_f = d_pre_f

    # bp_output_s1: Wᵀ·d_preact_f; bp_preact_s1: × σ′(preact).
    d_out_s1 = (d_pre_f @ w_f).reshape(b, 6, 6, 6)
    d_pre_s1 = d_out_s1 * sigmoid_grad_from_preact(acts.pre_s1)
    # bp_weight_s1: correlate d_preact with the conv output's windows.
    windows = acts.out_c1.reshape(b, 6, 6, 4, 6, 4)
    g_w_s1 = torch.einsum("bmxy,bmxiyj->bij", d_pre_s1, windows)
    # bp_bias_s1: bias += dt * sum/216.
    g_b_s1 = torch.sum(d_pre_s1, dim=(1, 2, 3)) / POOL_BIAS_NORM

    # bp_output_c1: scatter the pool grads back through the shared kernel
    # (an exact stride-4 un-pool, since the windows tile 24 = 6·4).
    d_out_c1 = torch.einsum("bmxy,ij->bmxiyj", d_pre_s1, w_s1).reshape(b, 6, 24, 24)
    # bp_preact_c1: × σ′(preact).
    d_pre_c1 = d_out_c1 * sigmoid_grad_from_preact(acts.pre_c1)
    # bp_weight_c1: /576-normalized correlation with the input patches.
    g_w_c1 = torch.einsum(
        "bmp,bkp->bmk", d_pre_c1.reshape(b, 6, 576), patches(acts.x)
    ).reshape(b, 6, 5, 5) / CONV_NORM
    # bp_bias_c1: bias += dt * sum/576.
    g_b_c1 = torch.sum(d_pre_c1, dim=(2, 3)) / CONV_NORM

    grads: Params = {
        "c1": {"w": g_w_c1, "b": g_b_c1},
        "s1": {"w": g_w_s1, "b": g_b_s1},
        "f": {"w": g_w_f, "b": g_b_f},
    }
    if single:
        err = err.squeeze(0)
        grads = {k: {n: g.squeeze(0) for n, g in v.items()} for k, v in grads.items()}
    return err, grads


def value_and_ref_grads(params: Params, x: torch.Tensor,
                        label: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """(err-norm, reference grads) of one sample, or per sample of a batch:
    forward + hand-written backward (Sequential/Main.cpp:157-171)."""
    return backward(params, forward(params, x), label)


#: Per-sample (errs (B,), grads with a leading B axis) of a batch: the port
#: of ``jax.vmap(ops.reference.value_and_ref_grads, in_axes=(None, 0, 0))``.
batched_value_and_ref_grads = value_and_ref_grads
