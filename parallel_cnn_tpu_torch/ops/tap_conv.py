"""SAME NHWC convolution with a fused BN/residual/ReLU epilogue, and its
gradients.

The port's counterpart of ``parallel_cnn_tpu/ops/pallas_conv.py``
(``conv2d`` with its custom VJP, and ``conv2d_fused``; the TPU kernels are
``_tap_kernel`` at pallas_conv.py:228, which serves the forward and the
input gradient, and ``_wgrad_tap_kernel`` at :321 for the weight gradient).
On a CUDA tensor every function here launches a hand kernel: the forward
and the input gradient (dgrad) are in ``csrc/tap_conv.cu``, the weight
gradient in ``csrc/tap_wgrad.cu`` (``ops/tap_wgrad.py``). On a CPU tensor
they run the plain PyTorch versions beside them. There is no other route:
a CUDA tensor that a kernel does not take raises.

``conv2d`` is a ``torch.autograd.Function``: its forward launches the
kernel without an epilogue and saves ``x`` and ``w``; its backward launches
the dgrad kernel (skipped where ``x`` needs no gradient, as for the stem's
input batch) and the wgrad kernel. ``conv2d_fused`` is forward-only, the
eval path with BN folded, and refuses autograd.

Layouts follow the JAX package: activations NHWC, weights HWIO
``(k, k, Cin, Cout)``, per-channel ``scale``/``shift`` of shape ``(Cout,)``.
Padding is XLA's SAME split (``pad_lo = pad_total // 2``), which for a
3x3/stride-2 conv on an even size puts no padding above and to the left:
output ``o`` centres on input ``2o + 1``, where PyTorch's ``padding=1``
would centre on ``2o``.

The kernels are compiled on first use by the port's one builder
(``ops/_cuda_build.py``). Nothing is built or imported from CUDA when this
module is imported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from parallel_cnn_tpu_torch.ops import tap_wgrad
from parallel_cnn_tpu_torch.ops._cuda_build import (
    Library,
    LaunchCounter,
    check_operand,
    launch_stream,
    raise_on_error,
)

SUPPORTED_K = (1, 3, 5, 7)
SUPPORTED_STRIDES = (1, 2)
_INT32_MAX = 2**31 - 1

#: Launches of the tap-conv forward kernel in this process (``conv2d`` and
#: ``conv2d_fused`` share the kernel and the count).
launches = LaunchCounter()
#: Launches of the dgrad kernel (``conv2d``'s backward).
dgrad_launches = LaunchCounter()


# ---------------------------------------------------------------------------
# Geometry and the plain version
# ---------------------------------------------------------------------------


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int, int]:
    """(out, pad_lo, pad_hi) of XLA's SAME padding along one dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def _check_geometry(w: torch.Tensor, stride: int) -> int:
    if w.dim() != 4 or w.shape[0] != w.shape[1]:
        raise ValueError(f"weights must be (k, k, Cin, Cout), got {tuple(w.shape)}")
    k = int(w.shape[0])
    if k not in SUPPORTED_K:
        raise ValueError(f"kernel size {k} not in {SUPPORTED_K}")
    if stride not in SUPPORTED_STRIDES:
        raise ValueError(f"stride {stride} not in {SUPPORTED_STRIDES}")
    return k


def out_shape(x_shape, w_shape, stride: int) -> Tuple[int, int, int, int]:
    n, h, wd, _ = x_shape
    k, cout = w_shape[0], w_shape[3]
    return (n, same_pads(h, k, stride)[0], same_pads(wd, k, stride)[0], cout)


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain PyTorch SAME conv: explicit pad to XLA's split, then
    ``F.conv2d(padding=0)`` on NCHW views. On the card, the caller turns
    TF32 off (``torch.backends.cudnn.allow_tf32 = False``) when this is a
    reference."""
    k = _check_geometry(w, stride)
    _, h, wd, _ = x.shape
    _, pt, pb = same_pads(h, k, stride)
    _, pl, pr = same_pads(wd, k, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_fused_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    stride: int = 1,
    relu: bool = True,
) -> torch.Tensor:
    """Plain version of ``conv2d_fused``: the conv, then the epilogue in
    f32 — ``relu?(conv·scale + shift [+ residual])``."""
    z = conv2d_plain(x, w, stride) * scale + shift
    if residual is not None:
        z = z + residual
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z


def conv2d_dgrad_plain(g: torch.Tensor, w: torch.Tensor, x_shape,
                       stride: int = 1) -> torch.Tensor:
    """Plain version of the dgrad kernel: autograd of ``conv2d_plain`` with
    respect to ``x`` (the conv is linear in ``x``, so the input's values do
    not matter and zeros stand in for it)."""
    x = torch.zeros(tuple(x_shape), dtype=g.dtype, device=g.device,
                    requires_grad=True)
    with torch.enable_grad():
        y = conv2d_plain(x, w.detach(), stride)
        (dx,) = torch.autograd.grad(y, x, g)
    return dx


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

_library = Library("tap_conv.cu", {
    "tap_conv_forward": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "tap_conv_dgrad": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
})


def build() -> Library:
    """Compile (if needed) and load the kernel library; returns its record
    (``path``, ``build_seconds``, ``compiler_output``)."""
    _library.get()
    return _library


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   shape: Tuple[int, ...]) -> None:
    check_operand(name, t, device, shape, torch.float32)
    if t.numel() > _INT32_MAX:
        raise ValueError(f"{name} has {t.numel()} elements; the kernel indexes in int32")


def _launch(x, w, scale, shift, residual, stride: int, relu: bool) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    k = int(w.shape[0])
    n, h, wd, cin = (int(d) for d in x.shape)
    oshape = out_shape(x.shape, w.shape, stride)
    cout = oshape[3]
    dev = x.device
    _check_operand("x", x, dev, (n, h, wd, cin))
    _check_operand("w", w, dev, (k, k, cin, cout))
    if scale is not None:
        _check_operand("scale", scale, dev, (cout,))
        _check_operand("shift", shift, dev, (cout,))
    if residual is not None:
        _check_operand("residual", residual, dev, oshape)
    if oshape[0] * oshape[1] * oshape[2] * cout > _INT32_MAX:
        raise ValueError("output too large for int32 indexing")
    if _records_grad(x, w, scale, shift, residual):
        raise RuntimeError(
            "the raw tap-conv launch has no backward: train through "
            "tap_conv.conv2d, whose autograd Function carries it"
        )
    lib = _library.get()
    out = torch.empty(oshape, device=dev, dtype=torch.float32)
    _, pt, _ = same_pads(h, k, stride)
    _, pl, _ = same_pads(wd, k, stride)
    with torch.cuda.device(dev):
        err = lib.tap_conv_forward(
            _ptr(x), _ptr(w), _ptr(scale), _ptr(shift), _ptr(residual),
            _ptr(out), n, h, wd, cin, oshape[1], oshape[2], cout, k, stride,
            pt, pl, int(relu), launch_stream(dev),
        )
    raise_on_error("tap_conv", err)
    launches.add()
    return out


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"tap_conv runs on cuda or cpu tensors, got {x.device}")
    return x.device.type == "cuda"


def _dispatch(x, w, scale, shift, residual, stride, relu, plain):
    _check_geometry(w, stride)
    if not _on_cuda(x):
        return plain()
    return _launch(x, w, scale, shift, residual, stride, relu)


def _launch_dgrad(g: torch.Tensor, w: torch.Tensor, x_shape,
                  stride: int) -> torch.Tensor:
    k = int(w.shape[0])
    n, h, wd, cin = (int(d) for d in x_shape)
    oshape = out_shape(x_shape, w.shape, stride)
    cout = oshape[3]
    dev = g.device
    _check_operand("g", g, dev, oshape)
    _check_operand("w", w, dev, (k, k, cin, cout))
    if n * h * wd * cin > _INT32_MAX:
        raise ValueError("dx too large for int32 indexing")
    lib = _library.get()
    dx = torch.empty((n, h, wd, cin), device=dev, dtype=torch.float32)
    _, pt, _ = same_pads(h, k, stride)
    _, pl, _ = same_pads(wd, k, stride)
    with torch.cuda.device(dev):
        err = lib.tap_conv_dgrad(
            _ptr(g), _ptr(w), _ptr(dx), n, h, wd, cin, oshape[1], oshape[2],
            cout, k, stride, pt, pl, launch_stream(dev),
        )
    raise_on_error("tap_conv_dgrad", err)
    dgrad_launches.add()
    return dx


def conv2d_dgrad(g: torch.Tensor, w: torch.Tensor, x_shape,
                 stride: int = 1) -> torch.Tensor:
    """dx = ∂⟨conv2d(x, w, stride), g⟩/∂x for an input of shape
    ``x_shape``: the dgrad kernel on a CUDA tensor, autograd of the plain
    version on a CPU one."""
    _check_geometry(w, stride)
    if not _on_cuda(g):
        return conv2d_dgrad_plain(g, w, x_shape, stride)
    return _launch_dgrad(g, w, x_shape, stride)


class _Conv2d(torch.autograd.Function):
    """≙ pallas_conv.conv2d's custom VJP (pallas_conv.py:995-1063): the
    forward kernel, then the dgrad and wgrad kernels in the backward."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w)
        return _dispatch(x, w, None, None, None, stride, False,
                         lambda: conv2d_plain(x, w, stride))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_dgrad(g, w, x.shape, ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = tap_wgrad.conv2d_wgrad(x, g, int(w.shape[0]), ctx.stride)
        return dx, dw, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv, NHWC × HWIO → NHWC; stride ∈ {1, 2}, odd k ∈ {1,3,5,7}.
    Differentiable in ``x`` and ``w`` through the dgrad and wgrad kernels."""
    _check_geometry(w, stride)
    return _Conv2d.apply(x, w, stride)


def conv2d_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    stride: int = 1,
    relu: bool = True,
) -> torch.Tensor:
    """``relu?(conv2d(x, w, stride)·scale + shift [+ residual])`` with the
    whole tail applied to the kernel's f32 accumulator before its single
    store. Fold inference-mode BN as ``scale = γ·rsqrt(var+ε)``,
    ``shift = β − mean·scale``; ``residual`` has the output's shape.
    Forward-only: it refuses tensors that would record a gradient."""
    if _records_grad(x, w, scale, shift, residual):
        raise RuntimeError(
            "conv2d_fused is the forward-only eval path (BN folded): call it "
            "under torch.no_grad() or torch.inference_mode(); training goes "
            "through conv2d, which has a backward"
        )
    return _dispatch(
        x, w, scale, shift, residual, stride, relu,
        lambda: conv2d_fused_plain(x, w, scale, shift, residual, stride, relu),
    )
