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

Element types. Each kernel has an f32 form and a bf16 form (JAX's bf16
activations: ``FusedStepConfig.act_dtype="bfloat16"``). The bf16 forms
take bf16 operands, sum in f32 and round each output once, as the TPU
kernel's ``preferred_element_type=f32`` dot and its store in x's dtype do
(pallas_conv.py:285-306): the forward and dgrad write bf16, the wgrad its
f32 chunk sum rounded to bf16 once (pallas_conv.py:663, :1047). Their
plain twins compute the f32 function of the bf16 operands and round the
result once. The bf16 forward, dgrad and wgrad have two hand kernels
each, chosen by shape (``wgmma_form``): where Cin and Cout are multiples of
64 and k is 1 or 3 (every conv of ResNet-18, ResNet-50 and VGG-16 but the
stems, which have no dgrad on the path), a tensor-core kernel (wgmma fed by
TMA); elsewhere the FFMA form on the f32 core. ``x`` and ``w`` (or ``g``
and ``w``) must share their dtype; mixed operands raise TypeError. The
bf16 ``conv2d_fused`` (an epilogue on bf16) is reached by no path, JAX's
eval being f32, and raises NotPortedError. Each form has its own launch
counter.

The kernels are compiled on first use by the port's one builder
(``ops/_cuda_build.py``). Nothing is built or imported from CUDA when this
module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from parallel_cnn_tpu_torch.config import NotPortedError
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

#: The element types the kernels take (a CPU tensor runs the plain twins
#: in any floating dtype).
DTYPES = (torch.float32, torch.bfloat16)

#: Launches of the tap-conv forward kernel's f32 form in this process
#: (``conv2d`` and ``conv2d_fused`` share the kernel and the count).
launches = LaunchCounter()
#: Launches of the dgrad kernel's f32 form (``conv2d``'s backward).
dgrad_launches = LaunchCounter()
#: Launches of the bf16 forms of the forward (its FFMA form) and of the
#: dgrad kernel.
bf16_launches = LaunchCounter()
bf16_dgrad_launches = LaunchCounter()
#: Launches of the bf16 forward's and the bf16 dgrad's tensor-core forms.
wgmma_launches = LaunchCounter()
wgmma_dgrad_launches = LaunchCounter()


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


def same_dtype(a_name: str, a: torch.Tensor, b_name: str, b: torch.Tensor) -> torch.dtype:
    """The dtype two operands share; mixed dtypes raise TypeError."""
    if a.dtype != b.dtype:
        raise TypeError(f"{a_name} is {a.dtype} and {b_name} is {b.dtype}: the "
                        "conv kernels take one element type")
    return a.dtype


def bf16_twin(fn, *tensors, **kw) -> torch.Tensor:
    """The plain twin of a bf16 form: ``fn`` on the bf16 operands widened
    to f32 (exactly), its result rounded to bf16 once."""
    return fn(*(t.float() for t in tensors), **kw).to(torch.bfloat16)


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


class DgradPhase(NamedTuple):
    """One parity phase of dx for the dgrad kernel: the input pixels
    ``(j·s + py, i·s + px)`` for ``j < hp``, ``i < wp``, and the taps that
    reach them, as ``(slot, ay, ax)`` with ``slot = dy·k + dx`` ascending:
    pixel ``(j, i)`` takes ``g[j + ay, i + ax]`` (zero outside g)."""

    py: int
    px: int
    hp: int
    wp: int
    taps: Tuple[Tuple[int, int, int], ...]


def _phase_offsets(size: int, k: int, stride: int, parity: int):
    """(d, a) along one dim for the phase ``parity``: the tap offsets d whose
    output position ``(j·s + parity + pad_lo − d) / s`` is a whole stride
    step, with that step's shift ``a``, kept where some pixel of the phase
    lands inside the output."""
    out, lo, _ = same_pads(size, k, stride)
    count = len(range(parity, size, stride))
    return [(d, (parity + lo - d) // stride) for d in range(k)
            if (parity + lo - d) % stride == 0
            and -count < (parity + lo - d) // stride < out]


def dgrad_phase_taps(h: int, w: int, k: int, stride: int) -> Tuple[DgradPhase, ...]:
    """The dgrad kernel's phase tables under XLA's SAME split: ``stride²``
    phases in parity order ``py·stride + px`` (one at stride 1). Every
    nonzero (pixel, tap) pair of the conv's input gradient lies in exactly
    one phase, and no tap is listed for a phase none of whose pixels it
    reaches; a phase with no tap is all zeros (a 1×1/s2 conv's odd rows
    and columns). ≙ pallas_conv._s2_phase_taps(k, inverse=True) at even
    sizes, for odd sizes too."""
    phases = []
    for py in range(stride):
        ys = _phase_offsets(h, k, stride, py)
        for px in range(stride):
            xs = _phase_offsets(w, k, stride, px)
            phases.append(DgradPhase(
                py, px, len(range(py, h, stride)), len(range(px, w, stride)),
                tuple((dy * k + dx, ay, ax) for dy, ay in ys for dx, ax in xs)))
    return tuple(phases)


#: Block tiles of the dgrad kernel (csrc/tap_conv.cu DTile0-1), by id:
#: (pixels, channels) of the output tile a block owns.
DGRAD_TILES = ((128, 128), (128, 64))
#: SMs of the H100.
SMS = 132
_MAX_TAPS = 49
_MAX_PHASES = 4


def _phase_blocks(n: int, phase: DgradPhase, cin: int, tile: int) -> int:
    bm, bn = DGRAD_TILES[tile]
    return -(-(n * phase.hp * phase.wp) // bm) * -(-cin // bn)


def dgrad_tile(n: int, phases, cin: int) -> int:
    """The dgrad kernel's block tile for this shape: 128×128 where Cin is at
    least 128, every phase carries as many taps (stride 1, so the blocks
    take equal time) and the grid still gives nearly every SM a block;
    else 128×64. (The rule that picked the faster of the two at every
    ResNet-18 dgrad at batch 128 in a sweep on an H100.)"""
    live = [p for p in phases if p.hp and p.wp]
    even = len({len(p.taps) for p in live}) == 1
    blocks = sum(_phase_blocks(n, p, cin, 0) for p in live)
    return 0 if cin >= 128 and even and blocks >= 0.9 * SMS else 1


@functools.lru_cache(maxsize=None)
def _dgrad_launch_plan(n: int, h: int, w: int, cin: int, k: int, stride: int):
    """(tile, table) for one dgrad shape, built once per shape."""
    phases = dgrad_phase_taps(h, w, k, stride)
    tile = dgrad_tile(n, phases, cin)
    return tile, _dgrad_table(n, phases, cin, tile)


def _dgrad_table(n: int, phases, cin: int, tile: int):
    """The FFMA kernel's DgradPlan (csrc/tap_conv.cu) as int32s: the phases
    that have pixels, most taps first, their blocks, parities, sizes and
    taps."""
    return _phase_table(phases, -(-cin // DGRAD_TILES[tile][1]),
                        lambda p: _phase_blocks(n, p, cin, tile))


def _phase_table(phases, n_tiles: int, blocks):
    """A DgradPlan as int32s, for either dgrad kernel: the phases that have
    pixels, most taps first (ties in parity order), ``blocks(phase)``
    blocks each, ``n_tiles`` channel tiles a phase's pixel tile."""
    live = sorted((p for p in phases if p.hp and p.wp), key=lambda p: -len(p.taps))
    block_begin, tap_begin = [0], [0]
    for p in live:
        block_begin.append(block_begin[-1] + blocks(p))
        tap_begin.append(tap_begin[-1] + len(p.taps))
    taps = [t for p in live for t in p.taps]
    assert len(live) <= _MAX_PHASES and len(taps) <= _MAX_TAPS

    def field(values, size):
        return list(values) + [0] * (size - len(values))

    vals = ([len(live), n_tiles]
            + field(block_begin, _MAX_PHASES + 1)
            + field([p.py for p in live], _MAX_PHASES)
            + field([p.px for p in live], _MAX_PHASES)
            + field([p.hp for p in live], _MAX_PHASES)
            + field([p.wp for p in live], _MAX_PHASES)
            + field(tap_begin, _MAX_PHASES + 1)
            + field([t[0] for t in taps], _MAX_TAPS)
            + field([t[1] for t in taps], _MAX_TAPS)
            + field([t[2] for t in taps], _MAX_TAPS))
    return (ctypes.c_int * len(vals))(*vals)


#: Block tiles of the forward kernel (csrc/tap_conv.cu FTile0-3), by id:
#: (pixels, channels) of the output tile a block owns. Tiles 0-2 keep 8×8
#: or 8×4 outputs a thread; tile 3 keeps 4×4, for a depth of one stage.
FORWARD_TILES = ((128, 128), (64, 64), (32, 64), (64, 64))
#: Depth values a stage of the forward kernel (every FTile's BK).
FORWARD_STAGE = 32


def forward_blocks(n: int, oh: int, ow: int, cout: int, tile: int) -> Tuple[int, int]:
    """The forward kernel's grid for this tile: (pixel tiles, channel
    tiles), block (i, j) owning pixels [i·BM, (i+1)·BM) and channels
    [j·BN, (j+1)·BN) of the (N·OH·OW, Cout) output, clipped at its edge."""
    bm, bn = FORWARD_TILES[tile]
    return -(-(n * oh * ow) // bm), -(-cout // bn)


def forward_tile(n: int, oh: int, ow: int, cin: int, cout: int, k: int) -> int:
    """The forward kernel's block tile for this shape. A depth k·k·Cin of
    one stage (the CIFAR stem) takes tile 3; else the largest tile whose
    grid still gives nearly every SM a block (128×128 only from 128 output
    channels on, as a narrower Cout would leave half its columns empty),
    else the smallest. (The rule read from a sweep of the tiles at every
    ResNet-18 conv at batch 1, 4, 16, 64 and 128 on an H100; chip_smoke's
    "time forward tiles" lines repeat it and say how far each pick is from
    the fastest tile.) Every output sums the same terms in the same order
    whatever its tile, so the tile may follow the batch."""
    if k * k * cin <= FORWARD_STAGE:
        return 3
    for tile in ((0, 1) if cout >= 128 else (1,)):
        mt, nt = forward_blocks(n, oh, ow, cout, tile)
        if mt * nt >= 0.9 * SMS:
            return tile
    return 2


#: Channels a TMA box of the tensor-core forms holds (csrc/wgmma_conv.cuh
#: CH): their Cin and Cout are multiples of it.
WGMMA_CHANNELS = 64
#: Kernel sizes the tensor-core forms take: the wgrad form keeps a row of
#: a 3x3 conv's taps (3 accumulator tiles) or a 1x1's one in registers.
WGMMA_K = (1, 3)
#: Output pixels a block's rectangle covers: wgmma's 64 rows.
WGMMA_ROWS = 64


def wgmma_form(cin: int, cout: int, k: int) -> bool:
    """True where the bf16 forward, dgrad and weight gradient take their
    tensor-core kernels (wgmma fed by TMA: ``tap_conv_wgmma_kernel``,
    ``tap_dgrad_wgmma_kernel``, ``wgrad_wgmma_kernel``): Cin and Cout
    multiples of 64 and k 1 or 3.
    That is every conv of ResNet-18, ResNet-50 and VGG-16 but the stems
    (Cin 3, bound by their bytes), which keep the FFMA form, as any other
    shape does. A choice between two hand kernels by shape: both raise on
    a failed build or launch."""
    return cin % WGMMA_CHANNELS == 0 and cout % WGMMA_CHANNELS == 0 and k in WGMMA_K


@functools.lru_cache(maxsize=None)
def conv_rect(oh: int, ow: int) -> Tuple[int, int, int]:
    """The rectangle of output pixels one tensor-core block covers, (bn
    images, bh rows, bw columns) with bn·bh·bw = 64, from (OH, OW) alone:
    the one that covers an image with the fewest pixels past its edge, then
    the widest, then the tallest (1×2×32 at 32², 1×4×16 at 16², 1×8×8 at
    8², 4×4×4 at 4², 16×2×2 at 2²). The rectangles tile (N, OH, OW) in
    (image group, row group, column group) order (csrc/wgmma_conv.cuh
    ``Rect``). Cached per shape: the search is host time on every launch."""
    best = None
    for bw in (1 << i for i in range(7)):
        for bh in (1 << i for i in range(7)):
            if bw * bh > WGMMA_ROWS:
                continue
            area = -(-oh // bh) * bh * -(-ow // bw) * bw
            key = (area, -bw, -bh)
            if best is None or key < best[0]:
                best = (key, (WGMMA_ROWS // (bw * bh), bh, bw))
    return best[1]


@functools.lru_cache(maxsize=None)
def wgmma_dgrad_plan(n: int, h: int, w: int, cin: int, k: int, stride: int):
    """(rect, table) of the bf16 dgrad's tensor-core kernel for one shape,
    built once per shape: ``rect`` = ``conv_rect`` of the largest phase
    (⌈H/s⌉ × ⌈W/s⌉, the conv's output size), the 64 phase pixels a block
    covers in every phase; ``table`` the DgradPlan (csrc/tap_conv.cu) of
    ``dgrad_phase_taps``' phases with ``Cin / 64`` channel tiles and, for
    each phase, one block a rectangle of its (N, hp, wp) grid and channel
    tile."""
    rect = conv_rect(-(-h // stride), -(-w // stride))
    bn, bh, bw = rect
    tiles = cin // WGMMA_CHANNELS
    table = _phase_table(dgrad_phase_taps(h, w, k, stride), tiles,
                         lambda p: -(-n // bn) * -(-p.hp // bh) * -(-p.wp // bw) * tiles)
    return rect, table


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

_DGRAD_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
               + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_library = Library("tap_conv.cu", {
    "tap_conv_forward": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "tap_conv_forward_bf16": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "tap_conv_forward_wgmma": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "tap_conv_dgrad": (_DGRAD_ARGS, ctypes.c_int),
    "tap_conv_dgrad_bf16": (_DGRAD_ARGS, ctypes.c_int),
    "tap_conv_dgrad_wgmma": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}, headers=("ffma_tile.cuh", "wgmma_tile.cuh", "wgmma_conv.cuh"))


def build() -> Library:
    """Compile (if needed) and load the kernel library; returns its record
    (``path``, ``build_seconds``, ``compiler_output``)."""
    _library.get()
    return _library


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   shape: Tuple[int, ...], dtype=torch.float32) -> None:
    check_operand(name, t, device, shape, dtype)
    if t.numel() > _INT32_MAX:
        raise ValueError(f"{name} has {t.numel()} elements; the kernel indexes in int32")


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t``, or for a view off the 16-byte boundary (TMA reads from
    16-byte aligned bases only) a copy of it into a fresh, aligned buffer:
    the tensor-core forms take any contiguous operand."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w, scale, shift, residual, stride: int, relu: bool,
            ffma: bool = False) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    k = int(w.shape[0])
    n, h, wd, cin = (int(d) for d in x.shape)
    oshape = out_shape(x.shape, w.shape, stride)
    cout = oshape[3]
    dev = x.device
    dtype = x.dtype
    if dtype not in DTYPES:
        raise TypeError(f"x must be one of {DTYPES}, got {dtype}")
    _check_operand("x", x, dev, (n, h, wd, cin), dtype)
    _check_operand("w", w, dev, (k, k, cin, cout), dtype)
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
    out = torch.empty(oshape, device=dev, dtype=dtype)
    _, pt, _ = same_pads(h, k, stride)
    _, pl, _ = same_pads(wd, k, stride)
    wgmma = dtype == torch.bfloat16 and not ffma and wgmma_form(cin, cout, k)
    tile = None if wgmma else forward_tile(n, oshape[1], oshape[2], cin, cout, k)
    with torch.cuda.device(dev):
        if wgmma:
            x, w = tma_ready(x), tma_ready(w)
            err = lib.tap_conv_forward_wgmma(
                _ptr(x), _ptr(w), _ptr(out), n, h, wd, cin, oshape[1], oshape[2],
                cout, k, stride, pt, pl, *conv_rect(oshape[1], oshape[2]),
                launch_stream(dev),
            )
        elif dtype == torch.bfloat16:
            err = lib.tap_conv_forward_bf16(
                _ptr(x), _ptr(w), _ptr(out), n, h, wd, cin, oshape[1], oshape[2],
                cout, k, stride, pt, pl, tile, launch_stream(dev),
            )
        else:
            err = lib.tap_conv_forward(
                _ptr(x), _ptr(w), _ptr(scale), _ptr(shift), _ptr(residual),
                _ptr(out), n, h, wd, cin, oshape[1], oshape[2], cout, k, stride,
                pt, pl, int(relu), tile, launch_stream(dev),
            )
    raise_on_error("tap_conv", err)
    (wgmma_launches if wgmma else bf16_launches if dtype == torch.bfloat16
     else launches).add()
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
    same_dtype("x", x, "w", w)
    if not _on_cuda(x):
        return plain()
    return _launch(x, w, scale, shift, residual, stride, relu)


def _launch_dgrad(g: torch.Tensor, w: torch.Tensor, x_shape,
                  stride: int, ffma: bool = False) -> torch.Tensor:
    k = int(w.shape[0])
    n, h, wd, cin = (int(d) for d in x_shape)
    oshape = out_shape(x_shape, w.shape, stride)
    cout = oshape[3]
    dev = g.device
    dtype = g.dtype
    if dtype not in DTYPES:
        raise TypeError(f"g must be one of {DTYPES}, got {dtype}")
    _check_operand("g", g, dev, oshape, dtype)
    _check_operand("w", w, dev, (k, k, cin, cout), dtype)
    if n * h * wd * cin > _INT32_MAX:
        raise ValueError("dx too large for int32 indexing")
    lib = _library.get()
    dx = torch.empty((n, h, wd, cin), device=dev, dtype=dtype)
    bf16 = dtype == torch.bfloat16
    wgmma = bf16 and not ffma and wgmma_form(cin, cout, k)
    with torch.cuda.device(dev):
        if wgmma:
            rect, table = wgmma_dgrad_plan(n, h, wd, cin, k, stride)
            g, w = tma_ready(g), tma_ready(w)
            err = lib.tap_conv_dgrad_wgmma(
                _ptr(g), _ptr(w), _ptr(dx), n, h, wd, cin, oshape[1], oshape[2],
                cout, k, stride, table, len(table), *rect, launch_stream(dev),
            )
        else:
            tile, table = _dgrad_launch_plan(n, h, wd, cin, k, stride)
            entry = lib.tap_conv_dgrad_bf16 if bf16 else lib.tap_conv_dgrad
            err = entry(
                _ptr(g), _ptr(w), _ptr(dx), n, h, wd, cin, oshape[1], oshape[2],
                cout, stride, table, len(table), tile, launch_stream(dev),
            )
    raise_on_error("tap_conv_dgrad", err)
    (wgmma_dgrad_launches if wgmma else bf16_dgrad_launches if bf16
     else dgrad_launches).add()
    return dx


def conv2d_dgrad(g: torch.Tensor, w: torch.Tensor, x_shape,
                 stride: int = 1) -> torch.Tensor:
    """dx = ∂⟨conv2d(x, w, stride), g⟩/∂x for an input of shape
    ``x_shape``: the dgrad kernel on a CUDA tensor, autograd of the plain
    version on a CPU one (for bf16, its twin: f32 on the widened operands,
    rounded once)."""
    _check_geometry(w, stride)
    dtype = same_dtype("g", g, "w", w)
    if not _on_cuda(g):
        if dtype == torch.bfloat16:
            return bf16_twin(conv2d_dgrad_plain, g, w, x_shape=x_shape, stride=stride)
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
                         lambda: conv2d_forward_plain(x, w, stride))

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


def conv2d_forward_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The forward kernel's plain twin in x's dtype: ``conv2d_plain``, or
    for bf16 the f32 conv of the widened operands rounded once."""
    if x.dtype == torch.bfloat16:
        return bf16_twin(conv2d_plain, x, w, stride=stride)
    return conv2d_plain(x, w, stride)


def conv2d_bf16_ffma(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The bf16 forward's FFMA form at any shape, the tensor-core form's
    yardstick (chip_smoke.py times the two side by side). The training
    path reaches the FFMA form only through ``conv2d``, at the shapes
    ``wgmma_form`` refuses. Forward only; bf16 CUDA tensors only."""
    _check_geometry(w, stride)
    if same_dtype("x", x, "w", w) != torch.bfloat16 or not _on_cuda(x):
        raise TypeError("conv2d_bf16_ffma launches the bf16 FFMA kernel: bf16 CUDA "
                        "tensors only")
    return _launch(x, w, None, None, None, stride, False, ffma=True)


def conv2d_dgrad_bf16_ffma(g: torch.Tensor, w: torch.Tensor, x_shape,
                           stride: int = 1) -> torch.Tensor:
    """The bf16 dgrad's FFMA form at any shape, the tensor-core form's
    yardstick (chip_smoke.py times the two side by side). The training
    path reaches the FFMA form only through ``conv2d_dgrad``, at the shapes
    ``wgmma_form`` refuses. bf16 CUDA tensors only."""
    _check_geometry(w, stride)
    if same_dtype("g", g, "w", w) != torch.bfloat16 or not _on_cuda(g):
        raise TypeError("conv2d_dgrad_bf16_ffma launches the bf16 FFMA kernel: bf16 CUDA "
                        "tensors only")
    return _launch_dgrad(g, w, x_shape, stride, ffma=True)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv, NHWC × HWIO → NHWC; stride ∈ {1, 2}, odd k ∈ {1,3,5,7}.
    Differentiable in ``x`` and ``w`` through the dgrad and wgrad kernels;
    f32 or bf16 (``x`` and ``w`` alike)."""
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
    Forward-only: it refuses tensors that would record a gradient. f32
    only: the bf16 form has no epilogue (ROADMAP Queue B)."""
    if x.dtype == torch.bfloat16 or w.dtype == torch.bfloat16:
        raise NotPortedError(
            "conv2d_fused in bf16 (the epilogue on bf16 activations) is not "
            "ported: no path reaches it, JAX's eval forward being f32 "
            "(ROADMAP Queue B)")
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
