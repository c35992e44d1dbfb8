"""The eight Mosaic probes as kernels: the port of the Pallas kernels of the
JAX package's ``benches/mosaic_probe.py`` (B14–B21), each a hand kernel of
``csrc/mosaic_probe.cu`` with a plain PyTorch twin.

========================  ==============================================  ==============
function                  TPU kernel (benches/mosaic_probe.py)            ``launches``
========================  ==============================================  ==============
``rank3_dot``             B14 ``probe_rank3_dot.kernel`` :62              ``rank3_dot``
``lane_merge``            B15 ``probe_lane_merge.kernel`` :79             ``lane_merge``
``lane_split``            B16 ``probe_lane_split.kernel`` :90             ``lane_split``
``mxu_conv_L``            B17 ``_mxu_conv_L_kernel`` :100                 ``mxu_conv_L``
``vpu_conv``              B18 ``_vpu_conv_kernel`` :107                   ``vpu_conv``
``mxu_conv_3d``           B19 ``_mxu_conv_3d_kernel`` :116                ``mxu_conv_3d``
``pair_dot``              B20 ``_pair_dot_kernel`` :168                   ``pair_dot``
``two_dot``               B21 ``_two_dot_kernel`` :189                    ``two_dot``
========================  ==============================================  ==============

Each function checks its operands first, on whatever device they lie:
dtype, shape and contiguity, raising on a mismatch (it never makes a copy
contiguous). Then a CPU tensor takes the plain twin ``<name>_plain``, a
CUDA tensor launches the kernel or raises, and any other device raises.
The contraction sizes are the probes' (25 taps, 6 filters, depth 64, w of
2 × 64 columns); the batch, row, length and bb sizes may be any ≥ 1, so the
kernels' tails can be tested.

Types follow JAX's promotion in the probes: in the convs w is f32 and x
bf16, in the dots both are bf16, and every product and sum is f32 of the
exactly widened values. The plain twins spell each sum out in PyTorch ops
(no matmul); ``vpu_conv_plain`` rounds each multiply and add as the kernel
does, so the two agree bit for bit.

The dots (B20, B21) run on the tensor cores and stage x and w by TMA, whose
tensor maps need 16-byte aligned bases: on a CUDA tensor ``pair_dot`` and
``two_dot`` raise ValueError for a view that starts elsewhere
(``check_tma_aligned``), and never copy it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from parallel_cnn_tpu_torch.ops._cuda_build import (
    Library,
    LaunchCounter,
    check_operand,
    launch_stream,
    on_cuda,
    raise_on_error,
)

F32 = torch.float32
BF16 = torch.bfloat16
#: (taps, filters, the dots' depth, each half's width): the sizes the
#: kernels index by, checked against the library.
LAYOUT = (25, 6, 64, 64)
TAPS, FILTERS, PAIR_K, PAIR_N = LAYOUT

#: Each kernel by the name of its launch counter, with the TPU kernel it
#: replaces as (function, line of benches/mosaic_probe.py).
REPLACES = {
    "rank3_dot": ("probe_rank3_dot.kernel", 62),
    "lane_merge": ("probe_lane_merge.kernel", 79),
    "lane_split": ("probe_lane_split.kernel", 90),
    "mxu_conv_L": ("_mxu_conv_L_kernel", 100),
    "vpu_conv": ("_vpu_conv_kernel", 107),
    "mxu_conv_3d": ("_mxu_conv_3d_kernel", 116),
    "pair_dot": ("_pair_dot_kernel", 168),
    "two_dot": ("_two_dot_kernel", 189),
}
KERNELS = tuple(REPLACES)
#: Launches of each kernel (one per wrapper call on a CUDA tensor).
launches = {name: LaunchCounter() for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_library = Library("mosaic_probe.cu", {
    "mosaic_probe_dim": ([_I], _I),
    "probe_rank3_dot": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "probe_lane_merge": ([_P, _P, _L, _P], _I),
    "probe_lane_split": ([_P, _P, _L, _P], _I),
    "probe_mxu_conv_L": ([_P] * 3 + [_L, _P], _I),
    "probe_vpu_conv": ([_P] * 3 + [_L, _P], _I),
    "probe_mxu_conv_3d": ([_P] * 3 + [_L, _P], _I),
    "probe_pair_dot": ([_P] * 3 + [_I, _P], _I),
    "probe_two_dot": ([_P] * 3 + [_I, _P], _I),
}, headers=("ffma_tile.cuh", "wgmma_tile.cuh"))
_INT_MAX = 2**31 - 1


def build() -> Library:
    """Compile (if needed) and load the kernel library, and check its
    layout; returns its record (``path``, ``build_seconds``,
    ``compiler_output``)."""
    _lib()
    return _library


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded library, its layout checked once (a failed check is not
    cached, so every later launch raises too)."""
    lib = _library.get()
    got = tuple(lib.mosaic_probe_dim(i) for i in range(len(LAYOUT)))
    if got != LAYOUT:
        raise RuntimeError(f"csrc/mosaic_probe.cu has layout {got}, its wrapper {LAYOUT}")
    return lib


def _dims(name: str, t: torch.Tensor, rank: int) -> tuple:
    """The shape of ``t``, checked to have ``rank`` dims, each ≥ 1."""
    if t.dim() != rank or min(t.shape) < 1:
        raise ValueError(f"{name} must have {rank} non-empty dims, got {tuple(t.shape)}")
    return tuple(int(s) for s in t.shape)


def _launch(name: str, dev: torch.device, shape, call) -> torch.Tensor:
    """Allocate the f32 output, launch ``call(lib, out, stream)``, count."""
    lib = _lib()
    with torch.cuda.device(dev):
        out = torch.empty(shape, device=dev, dtype=F32)
        err = call(lib, out.data_ptr(), launch_stream(dev))
    raise_on_error(f"mosaic_probe {name}", err)
    launches[name].add()
    return out


# ---------------------------------------------------------------------------
# B14: rank3-dot
# ---------------------------------------------------------------------------


def rank3_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i] = a[i] @ b[i]: a broadcast multiply summed over K."""
    return (a[:, :, :, None] * b[:, None, :, :]).sum(2)


def rank3_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, m, k) @ (n, k, p) → (n, m, p), f32, batched over dim 0."""
    n, m, k = _dims("a", a, 3)
    p = _dims("b", b, 3)[2]
    check_operand("a", a, a.device, (n, m, k), F32)
    check_operand("b", b, a.device, (n, k, p), F32)
    if not on_cuda("rank3_dot", a):
        return rank3_dot_plain(a, b)
    return _launch("rank3_dot", a.device, (n, m, p), lambda lib, out, s: lib.probe_rank3_dot(
        a.data_ptr(), b.data_ptr(), out, n, m, k, p, s))


# ---------------------------------------------------------------------------
# B15, B16: lane-merge and lane-split (flat copies)
# ---------------------------------------------------------------------------


def lane_merge_plain(x: torch.Tensor) -> torch.Tensor:
    t, bb, c = x.shape
    return x.reshape(t, bb * c).clone()


def lane_merge(x: torch.Tensor) -> torch.Tensor:
    """(t, bb, c) → (t, bb·c), f32, into a new tensor."""
    t, bb, c = _dims("x", x, 3)
    check_operand("x", x, x.device, (t, bb, c), F32)
    if not on_cuda("lane_merge", x):
        return lane_merge_plain(x)
    return _launch("lane_merge", x.device, (t, bb * c), lambda lib, out, s:
                   lib.probe_lane_merge(x.data_ptr(), out, x.numel(), s))


def lane_split_plain(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.reshape(rows, x.shape[1] // rows).clone()


def lane_split(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(1, L) → (rows, L / rows), f32, into a new tensor."""
    length = _dims("x", x, 2)[1]
    if rows < 1 or length % rows:
        raise ValueError(f"cannot split {length} lanes into {rows} rows")
    check_operand("x", x, x.device, (1, length), F32)
    if not on_cuda("lane_split", x):
        return lane_split_plain(x, rows)
    return _launch("lane_split", x.device, (rows, length // rows), lambda lib, out, s:
                   lib.probe_lane_split(x.data_ptr(), out, length, s))


# ---------------------------------------------------------------------------
# B17–B19: the conv, (6, 25) · (25, ...) with w f32 and x bf16
# ---------------------------------------------------------------------------


def _conv_operands(w: torch.Tensor, x: torch.Tensor, rank: int) -> tuple:
    """The output shape, after checking w (6, 25) f32 and x (25, ...) bf16."""
    shape = _dims("x", x, rank)
    check_operand("w", w, x.device, (FILTERS, TAPS), F32)
    check_operand("x", x, x.device, (TAPS,) + shape[1:], BF16)
    return (FILTERS,) + shape[1:]


def mxu_conv_L_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """All filters at once: acc = acc + w[:, t]·x[t] for t = 0…24."""
    xf = x.float()
    lead = (FILTERS,) + (1,) * (x.dim() - 1)
    acc = torch.zeros((FILTERS,) + tuple(x.shape[1:]), dtype=F32, device=x.device)
    for t in range(TAPS):
        acc = acc + w[:, t].reshape(lead) * xf[t]
    return acc


def mxu_conv_L(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(6, 25) f32 · (25, L) bf16 → (6, L) f32: one contraction over taps."""
    shape = _conv_operands(w, x, 2)
    if not on_cuda("mxu_conv_L", x):
        return mxu_conv_L_plain(w, x)
    return _launch("mxu_conv_L", x.device, shape, lambda lib, out, s: lib.probe_mxu_conv_L(
        w.data_ptr(), x.data_ptr(), out, shape[1], s))


mxu_conv_3d_plain = mxu_conv_L_plain


def mxu_conv_3d(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(6, 25) f32 · (25, bb, c) bf16 → (6, bb, c) f32, with no reshape."""
    shape = _conv_operands(w, x, 3)
    if not on_cuda("mxu_conv_3d", x):
        return mxu_conv_3d_plain(w, x)
    return _launch("mxu_conv_3d", x.device, shape, lambda lib, out, s: lib.probe_mxu_conv_3d(
        w.data_ptr(), x.data_ptr(), out, shape[1] * shape[2], s))


def vpu_conv_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per filter m: acc = acc + w[m, t]·x[t] for t = 0…24, each op rounded."""
    xf = x.float()
    out = torch.empty((FILTERS,) + tuple(x.shape[1:]), dtype=F32, device=x.device)
    for m in range(FILTERS):
        acc = torch.zeros(x.shape[1:], dtype=F32, device=x.device)
        for t in range(TAPS):
            acc = acc + w[m, t] * xf[t]
        out[m] = acc
    return out


def vpu_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The same conv as B1 computes it, each filter's 25 multiply-adds in
    tap order with every product and sum rounded on its own: (6, 25) f32,
    (25, bb, c) bf16 → (6, bb, c) f32."""
    shape = _conv_operands(w, x, 3)
    if not on_cuda("vpu_conv", x):
        return vpu_conv_plain(w, x)
    return _launch("vpu_conv", x.device, shape, lambda lib, out, s: lib.probe_vpu_conv(
        w.data_ptr(), x.data_ptr(), out, shape[1] * shape[2], s))


# ---------------------------------------------------------------------------
# B20, B21: x·w over two 64-column halves of w, summed
# ---------------------------------------------------------------------------


#: TMA reads a tensor from a base aligned to this many bytes.
TMA_ALIGN = 16


def check_tma_aligned(name: str, t: torch.Tensor) -> None:
    """Raise ValueError unless ``t``'s first element lies on a TMA_ALIGN-byte
    boundary (on any device; the wrappers ask it only of CUDA tensors)."""
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"{name} starts {t.data_ptr() % TMA_ALIGN} bytes past a "
                         f"{TMA_ALIGN}-byte boundary; the kernel's TMA loads need "
                         "an aligned base")


def _dot_operands(x: torch.Tensor, w: torch.Tensor) -> int:
    rows = _dims("x", x, 2)[0]
    if rows > _INT_MAX:
        raise ValueError(f"x has {rows} rows, more than the kernel indexes")
    check_operand("x", x, x.device, (rows, PAIR_K), BF16)
    check_operand("w", w, x.device, (PAIR_K, 2 * PAIR_N), BF16)
    if x.device.type == "cuda":
        check_tma_aligned("x", x)
        check_tma_aligned("w", w)
    return rows


def _products_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xf[r, k]·wf[k, n] summed over k, in f32."""
    return (x.float()[:, :, None] * w.float()[None, :, :]).sum(1)


def pair_dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One product over N = 128, then its two halves added."""
    out = _products_plain(x, w)
    return out[:, :PAIR_N] + out[:, PAIR_N:]


def pair_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(rows, 64) bf16 · (64, 128) bf16 in f32, then out[:, :64] +
    out[:, 64:] → (rows, 64) f32."""
    rows = _dot_operands(x, w)
    if not on_cuda("pair_dot", x):
        return pair_dot_plain(x, w)
    return _launch("pair_dot", x.device, (rows, PAIR_N), lambda lib, out, s:
                   lib.probe_pair_dot(x.data_ptr(), w.data_ptr(), out, rows, s))


def two_dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Two products, one per column half of w, added."""
    return _products_plain(x, w[:, :PAIR_N]) + _products_plain(x, w[:, PAIR_N:])


def two_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x·w[:, :64] + x·w[:, 64:] for (rows, 64) and (64, 128) bf16 →
    (rows, 64) f32."""
    rows = _dot_operands(x, w)
    if not on_cuda("two_dot", x):
        return two_dot_plain(x, w)
    return _launch("two_dot", x.device, (rows, PAIR_N), lambda lib, out, s:
                   lib.probe_two_dot(x.data_ptr(), w.data_ptr(), out, rows, s))
