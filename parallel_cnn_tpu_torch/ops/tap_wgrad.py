"""Weight gradient of the SAME NHWC convolution (the port's counterpart of
``_wgrad_s1`` / ``_wgrad_s2_even`` / ``_wgrad_1x1`` in
``parallel_cnn_tpu/ops/pallas_conv.py``, whose TPU kernel is
``_wgrad_tap_kernel`` at pallas_conv.py:321).

``conv2d_wgrad(x, g, k, stride)`` returns
``gw[dy,dx,ci,co] = Σ_{n,oy,ox} x[n, oy·s−pt+dy, ox·s−pl+dx, ci] · g[n,oy,ox,co]``
as f32 ``(k, k, Cin, Cout)`` with XLA's SAME split. On a CUDA tensor it
launches the hand kernel in ``csrc/tap_wgrad.cu`` (chunks of the pixel
axis sized per shape by ``wgrad_plan``, summed into scratch, then summed
in chunk order: no float atomics, bit-identical relaunches); on a CPU
tensor it runs the plain version, autograd of ``tap_conv.conv2d_plain``
with respect to ``w``.
``tap_conv.conv2d``'s backward calls it.

The bf16 form (bf16 ``x`` and ``g``, JAX's bf16 activations) writes f32
partials and sums them in the same shape-only chunk order in f32, then
rounds each sum to bf16 once: ``gw`` is bf16, as JAX rounds its kernel's
f32 output to ``w.dtype`` (pallas_conv.py:663, :1047). Its plain twin is
the f32 plain version on the widened operands, rounded once. It has two
hand kernels, chosen by shape (``tap_conv.wgmma_form``): the tensor-core
form (wgmma fed by TMA, chunks of 64-pixel rectangles by ``wgmma_plan``)
for Cin and Cout multiples of 64 at k 1 or 3, the FFMA form elsewhere
(the stems).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from parallel_cnn_tpu_torch.ops._cuda_build import (
    Library,
    LaunchCounter,
    check_operand,
    launch_stream,
    raise_on_error,
)

_INT32_MAX = 2**31 - 1

#: Launches of the wgrad kernel's f32 form in this process (one per call:
#: its two passes are one launch of the C entry point), of its bf16 FFMA
#: form, and of its bf16 tensor-core form.
launches = LaunchCounter()
bf16_launches = LaunchCounter()
wgmma_launches = LaunchCounter()

_WGRAD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_library = Library("tap_wgrad.cu", {
    "tap_wgrad_stage_pixels": ([], ctypes.c_int),
    "tap_conv_wgrad": (_WGRAD_ARGS, ctypes.c_int),
    "tap_conv_wgrad_bf16": (_WGRAD_ARGS, ctypes.c_int),
    "tap_conv_wgrad_wgmma": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + [ctypes.c_void_p], ctypes.c_int),
}, headers=("ffma_tile.cuh", "wgmma_tile.cuh", "wgmma_conv.cuh"))

#: Pixels per stage of the kernel's ring (``tap_wgrad_stage_pixels()``):
#: every chunk is a multiple of it.
STAGE_PIXELS = 16
#: Rows and channels of the kernel's block tile (csrc/tap_wgrad.cu).
TILE = (64, 64)
#: The grid the plan aims at: about this many blocks of 128 threads (the
#: best chunk counts of a sweep on an H100 at ResNet-18's 3x3 wgrads, b128).
TARGET_BLOCKS = 1152
#: The fewest pixels a chunk holds, unless the whole reduction is fewer.
MIN_CHUNK_PIXELS = 128
#: The most chunks the second pass sums per element.
MAX_CHUNKS = 512
#: Scratch for the partial sums stays within this, so the H100's 50 MB L2
#: holds it between the two passes.
SCRATCH_CAP_BYTES = 32 << 20


class WgradPlan(NamedTuple):
    chunk_pixels: int   # pixels per partial sum, a multiple of STAGE_PIXELS
    chunks: int         # ceil(pixels / chunk_pixels)


def wgrad_plan(n: int, oh: int, ow: int, rows: int, cout: int) -> WgradPlan:
    """How the wgrad kernel splits its reduction over the N·OH·OW output
    pixels, from the shape alone: as many chunks as bring the grid (tiles
    of rows × Cout, times chunks) to about TARGET_BLOCKS, within
    MAX_CHUNKS, chunks of at least MIN_CHUNK_PIXELS and SCRATCH_CAP_BYTES
    of scratch; each chunk a whole number of stages, the last one ragged."""
    pixels = n * oh * ow
    tiles = -(-rows // TILE[0]) * -(-cout // TILE[1])
    cap = min(SCRATCH_CAP_BYTES // (4 * rows * cout), MAX_CHUNKS,
              pixels // MIN_CHUNK_PIXELS)
    want = max(1, min(cap, round(TARGET_BLOCKS / tiles)))
    chunk = -(-(-(-pixels // want)) // STAGE_PIXELS) * STAGE_PIXELS
    return WgradPlan(chunk, -(-pixels // chunk))


#: The tensor-core form's grid target: about two blocks an SM in one wave
#: (a block of 3 taps holds a 96 KB ring, so two fit an SM).
WGMMA_TARGET_BLOCKS = 264
#: The fewest 64-pixel rectangles a tensor-core chunk holds, unless the
#: reduction has fewer: a block fills its ring and writes its partial
#: tiles once a chunk.
WGMMA_MIN_CHUNK_RECTS = 4


class WgmmaPlan(NamedTuple):
    rect: tuple         # (bn, bh, bw): tap_conv.conv_rect(OH, OW)
    chunk_rects: int    # rectangles a partial sum covers
    chunks: int         # ceil(rectangles / chunk_rects)


def wgmma_taps(k: int) -> int:
    """Taps one tensor-core wgrad block owns: a row of a 3x3 conv's taps
    (one box of g serves three of x), or a 1x1 conv's one."""
    return 3 if k == 3 else 1


@functools.lru_cache(maxsize=None)
def wgmma_plan(n: int, oh: int, ow: int, cin: int, cout: int, k: int) -> WgmmaPlan:
    """How the tensor-core wgrad walks and splits its reduction, from the
    shape alone: the output pixels as ``conv_rect`` rectangles in (image
    group, row group, column group) order, cut into chunks of whole
    rectangles, as many as bring the grid (tap groups × Cin/64 × Cout/64
    tiles, times chunks) to about WGMMA_TARGET_BLOCKS, within MAX_CHUNKS, chunks of at least
    WGMMA_MIN_CHUNK_RECTS and SCRATCH_CAP_BYTES of f32 partials; the last
    chunk ragged. Pass two sums the chunks in order. Cached per shape."""
    tc = _conv()
    rect = tc.conv_rect(oh, ow)
    bn, bh, bw = rect
    rects = -(-n // bn) * -(-oh // bh) * -(-ow // bw)
    tiles = (k * k // wgmma_taps(k)) * (cin // tc.WGMMA_CHANNELS) * (cout // tc.WGMMA_CHANNELS)
    cap = min(SCRATCH_CAP_BYTES // (4 * k * k * cin * cout), MAX_CHUNKS,
              rects // WGMMA_MIN_CHUNK_RECTS)
    want = max(1, min(cap, round(WGMMA_TARGET_BLOCKS / tiles)))
    chunk = -(-rects // want)
    return WgmmaPlan(rect, chunk, -(-rects // chunk))


def build() -> Library:
    """Compile (if needed) and load the kernel library; returns its record."""
    _library.get()
    return _library


def _conv():
    # tap_conv imports this module for its backward.
    from parallel_cnn_tpu_torch.ops import tap_conv

    return tap_conv


def conv2d_wgrad_plain(x: torch.Tensor, g: torch.Tensor, k: int,
                       stride: int = 1) -> torch.Tensor:
    """Plain version: autograd of ``conv2d_plain`` with respect to ``w``
    (linear in ``w``, so zeros stand in for its values)."""
    w = torch.zeros((k, k, x.shape[3], g.shape[3]), dtype=g.dtype,
                    device=g.device, requires_grad=True)
    with torch.enable_grad():
        y = _conv().conv2d_plain(x.detach(), w, stride)
        (gw,) = torch.autograd.grad(y, w, g)
    return gw


def _launch(x: torch.Tensor, g: torch.Tensor, k: int, stride: int,
            ffma: bool = False) -> torch.Tensor:
    tc = _conv()
    n, h, wd, cin = (int(d) for d in x.shape)
    oshape = tc.out_shape(x.shape, (k, k, cin, g.shape[3]), stride)
    cout = oshape[3]
    dev = x.device
    dtype = x.dtype
    if dtype not in tc.DTYPES:
        raise TypeError(f"x must be one of {tc.DTYPES}, got {dtype}")
    check_operand("x", x, dev, (n, h, wd, cin), dtype)
    check_operand("g", g, dev, oshape, dtype)
    if max(x.numel(), g.numel()) > _INT32_MAX:
        raise ValueError("x or g too large for int32 indexing")
    lib = _library.get()
    rows = k * k * cin
    bf16 = dtype == torch.bfloat16
    gw = torch.empty((k, k, cin, cout), device=dev, dtype=dtype)
    _, pt, _ = tc.same_pads(h, k, stride)
    _, pl, _ = tc.same_pads(wd, k, stride)
    if bf16 and not ffma and tc.wgmma_form(cin, cout, k):
        tplan = wgmma_plan(n, oshape[1], oshape[2], cin, cout, k)
        partial = torch.empty((tplan.chunks, rows, cout), device=dev, dtype=torch.float32)
        x, g = tc.tma_ready(x), tc.tma_ready(g)
        with torch.cuda.device(dev):
            err = lib.tap_conv_wgrad_wgmma(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(), gw.data_ptr(),
                n, h, wd, cin, oshape[1], oshape[2], cout, k, stride, pt, pl,
                *tplan.rect, tplan.chunk_rects, launch_stream(dev),
            )
        raise_on_error("tap_conv_wgrad", err)
        wgmma_launches.add()
        return gw
    plan = wgrad_plan(n, oshape[1], oshape[2], rows, cout)
    # The bf16 form always sums its f32 partials in pass two, one chunk too.
    partial = (torch.empty((plan.chunks, rows, cout), device=dev, dtype=torch.float32)
               if plan.chunks > 1 or bf16 else None)
    entry = lib.tap_conv_wgrad_bf16 if bf16 else lib.tap_conv_wgrad
    with torch.cuda.device(dev):
        err = entry(
            x.data_ptr(), g.data_ptr(),
            None if partial is None else partial.data_ptr(), gw.data_ptr(),
            n, h, wd, cin, oshape[1], oshape[2], cout, k, stride, pt, pl,
            plan.chunk_pixels, launch_stream(dev),
        )
    raise_on_error("tap_conv_wgrad", err)
    (bf16_launches if bf16 else launches).add()
    return gw


def conv2d_wgrad_bf16_ffma(x: torch.Tensor, g: torch.Tensor, k: int,
                           stride: int = 1) -> torch.Tensor:
    """The bf16 wgrad's FFMA form at any shape, the tensor-core form's
    yardstick (chip_smoke.py times the two side by side). The training
    path reaches it only through ``conv2d_wgrad``, at the shapes
    ``tap_conv.wgmma_form`` refuses. bf16 CUDA tensors only."""
    tc = _conv()
    if k not in tc.SUPPORTED_K or stride not in tc.SUPPORTED_STRIDES:
        raise ValueError(f"kernel size {k} / stride {stride} not supported")
    if tc.same_dtype("x", x, "g", g) != torch.bfloat16 or not tc._on_cuda(x):
        raise TypeError("conv2d_wgrad_bf16_ffma launches the bf16 FFMA kernel: bf16 "
                        "CUDA tensors only")
    return _launch(x, g, k, stride, ffma=True)


def conv2d_wgrad(x: torch.Tensor, g: torch.Tensor, k: int,
                 stride: int = 1) -> torch.Tensor:
    """∂⟨conv2d(x, w, stride), g⟩/∂w for a ``k``×``k`` kernel, in the
    operands' dtype: the wgrad kernel on a CUDA tensor, the plain version
    (for bf16, its twin) on a CPU one."""
    tc = _conv()
    if k not in tc.SUPPORTED_K or stride not in tc.SUPPORTED_STRIDES:
        raise ValueError(f"kernel size {k} / stride {stride} not supported")
    dtype = tc.same_dtype("x", x, "g", g)
    if not tc._on_cuda(x):
        if dtype == torch.bfloat16:
            return tc.bf16_twin(conv2d_wgrad_plain, x, g, k=k, stride=stride)
        return conv2d_wgrad_plain(x, g, k, stride)
    return _launch(x, g, k, stride)
