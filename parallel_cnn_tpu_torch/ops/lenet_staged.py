"""The staged LeNet-ref kernel library: one kernel launch per stage of the
forward and of the reference backward, device memory in between.

The port's counterpart of the per-op tier of ``parallel_cnn_tpu/ops/pallas.py``
(pallas.py:141-446; entry points ``forward`` :467, ``predict`` :492 and
``staged_value_and_ref_grads`` :497). Its seven TPU kernels are the seven
hand kernels of ``csrc/lenet_staged.cu``:

========================  ===================================  ===============
function                  TPU kernel (pallas.py)               ``launches``
========================  ===================================  ===============
``conv_fwd``              B3 ``_conv_fwd_kernel`` :141         ``conv_fwd``
``pool_fwd``              B4 ``_pool_fwd_kernel`` :201         ``pool_fwd``
``fc_fwd``                B5 ``_fc_fwd_kernel`` :238           ``fc_fwd``
``fc_bwd``                B6 ``_fc_bwd_kernel`` :279           ``fc_bwd``
``pool_bwd``              B7 ``_pool_bwd_kernel`` :333         ``pool_bwd``
``conv_bwd_dpre``         B8 ``_sigma_prime_kernel`` :413      ``sigma_prime``
``_accum_matmul``         B9 ``_accum_matmul_kernel`` :371     ``accum_matmul``
========================  ===================================  ===============

``pool_wgrad`` and ``conv_wgrad`` reach B9 through ``_accum_matmul``. Each
kernel function has a plain twin ``<name>_plain`` in PyTorch ops. Routing
is ``ops/lenet_fused.py``'s: a CPU tensor takes the plain twin, a CUDA
tensor launches the kernel or raises, any other device raises. The window
packing, the im2col of ``conv_wgrad``, the error vector, the bias sums and
the 1/n mean are PyTorch ops here, as they were XLA ops outside every TPU
kernel. The batch needs no padding: a CUDA grid takes any n ≥ 1.

σ(v) = 1/(1+exp(−v)) throughout: the kernels evaluate it with IEEE
``expf`` and division, the plain twins call ``activations.sigmoid``
(``torch.sigmoid``, which computes that expression on a CUDA tensor).

A forward is 3 launches (B3, B4, B5); ``staged_value_and_ref_grads`` 8
(B3, B4, B5, B6, B7, B9, B8, B9). Each is one CUDA launch: B9 finishes its
sum over blocks in its last block to arrive (``accum_plan``,
``accum_matmul_order``). B3 is bit for bit its plain twin; B5 sums in the
fixed order ``fc_fwd_order`` emulates.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from parallel_cnn_tpu_torch.ops import reference
from parallel_cnn_tpu_torch.ops._cuda_build import (
    Library,
    LaunchCounter,
    check_operand,
    launch_stream,
    on_cuda,
    raise_on_error,
)
from parallel_cnn_tpu_torch.ops.activations import error_norm, make_error, sigmoid

Params = reference.Params
F32 = torch.float32

#: The kernels of csrc/lenet_staged.cu, by the name of their launch counter.
KERNELS = ("conv_fwd", "pool_fwd", "fc_fwd", "fc_bwd", "pool_bwd",
           "sigma_prime", "accum_matmul")
#: Launches of each kernel (one per wrapper call on a CUDA tensor).
launches = {name: LaunchCounter() for name in KERNELS}

#: (image pixels, conv outputs, pool lanes, pool taps, classes, the least
#: rows of a B9 block): the constants the kernels index by, checked against
#: the library.
LAYOUT = (784, 3456, 216, 16, 10, 32)
ACCUM_ROWS = LAYOUT[5]
#: B9's plan constants (csrc/lenet_staged.cu): a warp's output tile
#: ACCUM_TA x ACCUM_TB, at most ACCUM_BLOCKS blocks, a block's rows a
#: multiple of ACCUM_ROW_ALIGN, two stages of rows in ACCUM_SMEM_FLOATS.
ACCUM_CONSTS = (8, 4, 132, 4, 12288)
ACCUM_TA, ACCUM_TB, ACCUM_BLOCKS, ACCUM_ROW_ALIGN, ACCUM_SMEM_FLOATS = ACCUM_CONSTS
#: B5's k a lane (csrc/lenet_staged.cu FC_K): lane l of an image's warp
#: sums k = FC_K·l .. FC_K·l + FC_K − 1.
FC_K = 8
# What lenet_accum_matmul refuses with cudaErrorInvalidValue.
_ACCUM_LIMITS = ("needs 1 <= rows <= 2^31 - 1, ka*kb <= 256 and "
                 "ka + kb <= 48 (two stages of 128 rows in 48 KB of shared memory)")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_library = Library("lenet_staged.cu", {
    "lenet_conv_fwd": ([_P] * 5 + [_I, _P], _I),
    "lenet_pool_fwd": ([_P] * 5 + [_I, _P], _I),
    "lenet_fc_fwd": ([_P] * 5 + [_I, _P], _I),
    "lenet_fc_bwd": ([_P] * 6 + [_I, _P], _I),
    "lenet_pool_bwd": ([_P] * 5 + [_I, _P], _I),
    "lenet_sigma_prime": ([_P] * 3 + [_I, _P], _I),
    "lenet_accum_matmul": ([_P, _P, _L, _L, _L, _P, _P, _P, _P], _I),
    "lenet_accum_plan": ([_L, _L, _L, _P], _I),
    "lenet_staged_dim": ([_I], _I),
}, headers=("ffma_tile.cuh",))


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
    want = LAYOUT + ACCUM_CONSTS + (FC_K,)
    got = tuple(lib.lenet_staged_dim(i) for i in range(len(want)))
    if got != want:
        raise RuntimeError(f"csrc/lenet_staged.cu has layout {got}, its wrapper {want}")
    return lib


def _batch(t: torch.Tensor) -> int:
    """The leading extent of ``t`` (0 for a scalar): check_operand then
    checks the whole shape, and the launcher refuses n < 1."""
    return int(t.shape[0]) if t.dim() else 0


def _launch(name: str, dev: torch.device, call, hint: str = "") -> None:
    lib = _lib()
    with torch.cuda.device(dev):
        err = call(lib, launch_stream(dev))
    raise_on_error(f"lenet_staged {name}", err, hint)
    launches[name].add()


def _empty(dev, *shape) -> torch.Tensor:
    return torch.empty(shape, device=dev, dtype=F32)


# ---------------------------------------------------------------------------
# Window layout (PyTorch ops, as the TPU tier's XLA glue, pallas.py:182-198)
# ---------------------------------------------------------------------------


def pack_pool_windows(out_c1: torch.Tensor) -> torch.Tensor:
    """(n,6,24,24) → (n,16,216): the stride-4 4×4 windows, tap-major
    (t = 4i+j), lane = m·36 + x·6 + y."""
    n = out_c1.shape[0]
    win = out_c1.reshape(n, 6, 6, 4, 6, 4)          # (n, m, x, i, y, j)
    return win.permute(0, 3, 5, 1, 2, 4).reshape(n, 16, 216)


def unpack_pool_windows(d_xw: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_pool_windows: (n,16,216) → (n,6,24,24)."""
    n = d_xw.shape[0]
    win = d_xw.reshape(n, 4, 4, 6, 6, 6)            # (n, i, j, m, x, y)
    return win.permute(0, 3, 4, 1, 5, 2).reshape(n, 6, 24, 24)


# ---------------------------------------------------------------------------
# Forward kernels
# ---------------------------------------------------------------------------


def conv_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B3: the bias, then the 25 taps in (i, j) order, each
    product and sum rounded to f32 on its own, as the kernel adds them."""
    n = x.shape[0]
    acc = b.view(1, 6, 1, 1).expand(n, 6, 24, 24)
    xs = x.unsqueeze(1)
    for i in range(5):
        for j in range(5):
            acc = acc + w[:, i, j].view(1, 6, 1, 1) * xs[:, :, i:i + 24, j:j + 24]
    return acc, sigmoid(acc)


def conv_fwd(x: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,28,28)·(6,5,5)+(6,) → (pre_c1, out_c1), both (n,6,24,24)."""
    if not on_cuda("conv_fwd", x):
        return conv_fwd_plain(x, w, b)
    n = _batch(x)
    dev = x.device
    check_operand("x", x, dev, (n, 28, 28), F32)
    check_operand("w", w, dev, (6, 5, 5), F32)
    check_operand("b", b, dev, (6,), F32)
    pre, out = _empty(dev, n, 6, 24, 24), _empty(dev, n, 6, 24, 24)
    _launch("conv_fwd", dev, lambda lib, s: lib.lenet_conv_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), pre.data_ptr(), out.data_ptr(), n, s))
    return pre, out


def pool_fwd_plain(xw: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B4: the bias, then the 16 taps in t order."""
    taps = w.reshape(16)
    acc = b.expand(xw.shape[0], 216)
    for t in range(16):
        acc = acc + taps[t] * xw[:, t, :]
    return acc, sigmoid(acc)


def pool_fwd(xw: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,16,216)·(4,4)+() → (pre_s1, out_s1), both (n,216) channel-major."""
    if not on_cuda("pool_fwd", xw):
        return pool_fwd_plain(xw, w, b)
    n = _batch(xw)
    dev = xw.device
    check_operand("xw", xw, dev, (n, 16, 216), F32)
    check_operand("w", w, dev, (4, 4), F32)
    check_operand("b", b, dev, (), F32)
    pre, out = _empty(dev, n, 216), _empty(dev, n, 216)
    _launch("pool_fwd", dev, lambda lib, s: lib.lenet_pool_fwd(
        xw.data_ptr(), w.data_ptr(), b.data_ptr(), pre.data_ptr(), out.data_ptr(), n, s))
    return pre, out


def fc_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B5: x·wᵀ in f32 (TF32 off on the card), then + b."""
    pre = x @ w.T + b
    return pre, sigmoid(pre)


def fc_fwd_order(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """B5's pre_f as the kernel sums it, in float32 numpy, so the card's
    equals this bit for bit: an image's warp has lane l < 216 / FC_K sum
    x[k]·w[o, k] for k = FC_K·l upward, one fmaf a term from 0 (the other
    lanes hold 0); the 32 lanes add in the xor butterfly's pairing (16, 8,
    4, 2, 1); then + b[o]. The same order for every image and every n."""
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    n, lanes = x.shape[0], LAYOUT[2] // FC_K
    xs = x.reshape(n, 1, lanes, FC_K)
    ws = w.reshape(1, LAYOUT[4], lanes, FC_K)
    acc = np.zeros((n, LAYOUT[4], 32), np.float32)
    for k in range(FC_K):
        acc[:, :, :lanes] = fma_f32(xs[..., k], ws[..., k], acc[:, :, :lanes])
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, np.arange(32) ^ off]
    return acc[:, :, 0] + np.asarray(b, np.float32)


def fc_fwd(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,216)·(10,216)ᵀ+(10,) → (pre_f, out_f), both (n,10)."""
    if not on_cuda("fc_fwd", x):
        return fc_fwd_plain(x, w, b)
    n = _batch(x)
    dev = x.device
    check_operand("x", x, dev, (n, 216), F32)
    check_operand("w", w, dev, (10, 216), F32)
    check_operand("b", b, dev, (10,), F32)
    pre, out = _empty(dev, n, 10), _empty(dev, n, 10)
    _launch("fc_fwd", dev, lambda lib, s: lib.lenet_fc_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), pre.data_ptr(), out.data_ptr(), n, s))
    return pre, out


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------


def fc_bwd_plain(d_pre_f: torch.Tensor, out_s1: torch.Tensor,
                 w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of B6: dᵀ·s, Σ_b d and d·w."""
    return d_pre_f.T @ out_s1, d_pre_f.sum(0), d_pre_f @ w


def fc_bwd(d_pre_f: torch.Tensor, out_s1: torch.Tensor,
           w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n,10),(n,216),(10,216) → (g_w_f (10,216) summed over the batch,
    g_b_f (10,) summed, d_out_s1 (n,216))."""
    if not on_cuda("fc_bwd", d_pre_f):
        return fc_bwd_plain(d_pre_f, out_s1, w)
    n = _batch(d_pre_f)
    dev = d_pre_f.device
    check_operand("d_pre_f", d_pre_f, dev, (n, 10), F32)
    check_operand("out_s1", out_s1, dev, (n, 216), F32)
    check_operand("w", w, dev, (10, 216), F32)
    gw, gb, dout = _empty(dev, 10, 216), _empty(dev, 10), _empty(dev, n, 216)
    _launch("fc_bwd", dev, lambda lib, s: lib.lenet_fc_bwd(
        d_pre_f.data_ptr(), out_s1.data_ptr(), w.data_ptr(), gw.data_ptr(),
        gb.data_ptr(), dout.data_ptr(), n, s))
    return gw, gb, dout


def pool_bwd_plain(d_out_s1: torch.Tensor, pre_s1: torch.Tensor,
                   w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of B7: σ′ from the preact, d·s·(1−s) left to right, then
    one row per tap scaled by its weight."""
    s = sigmoid(pre_s1)
    dpre = d_out_s1 * s * (1.0 - s)
    return dpre, w.reshape(1, 16, 1) * dpre.unsqueeze(1)


def pool_bwd(d_out_s1: torch.Tensor, pre_s1: torch.Tensor,
             w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,216),(n,216),(4,4) → (d_pre_s1 (n,216), d_xw (n,16,216))."""
    if not on_cuda("pool_bwd", d_out_s1):
        return pool_bwd_plain(d_out_s1, pre_s1, w)
    n = _batch(d_out_s1)
    dev = d_out_s1.device
    check_operand("d_out_s1", d_out_s1, dev, (n, 216), F32)
    check_operand("pre_s1", pre_s1, dev, (n, 216), F32)
    check_operand("w", w, dev, (4, 4), F32)
    dpre, dxw = _empty(dev, n, 216), _empty(dev, n, 16, 216)
    _launch("pool_bwd", dev, lambda lib, s: lib.lenet_pool_bwd(
        d_out_s1.data_ptr(), pre_s1.data_ptr(), w.data_ptr(), dpre.data_ptr(),
        dxw.data_ptr(), n, s))
    return dpre, dxw


def _accum_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of B9: aᵀ·b in f32 (TF32 off on the card)."""
    return a.T @ b


class AccumPlan(NamedTuple):
    """B9's grid for one shape: ``shard`` rows a block, ``blocks``,
    ``stage_rows`` a stage of shared memory, ``threads`` a block (one warp
    per ACCUM_TA × ACCUM_TB output tile)."""

    shard: int
    blocks: int
    stage_rows: int
    threads: int


def accum_plan(rows: int, ka: int, kb: int) -> AccumPlan:
    """B9's grid from the shape alone (csrc/lenet_staged.cu's accum_plan):
    the fewest rows a block, a multiple of ACCUM_ROW_ALIGN and at least
    ACCUM_ROWS, that cover ``rows`` with at most ACCUM_BLOCKS blocks."""
    shard = -(-rows // ACCUM_BLOCKS)
    shard = max(ACCUM_ROWS, -(-shard // ACCUM_ROW_ALIGN) * ACCUM_ROW_ALIGN)
    tiles = -(-ka // ACCUM_TA) * -(-kb // ACCUM_TB)
    return AccumPlan(shard, -(-rows // shard),
                     ACCUM_SMEM_FLOATS // (2 * (ka + kb)) // 32 * 32, 32 * tiles)


def fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fmaf(a, b, c) on f32 numpy arrays, rounded once: a·b is exact in f64,
    TwoSum gives the f64 sum's error, and that error decides the one case
    where rounding the f64 sum to f32 could round the wrong way (the sum
    lying exactly halfway between two f32 values)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r.astype(np.float64), np.inf, -np.inf)
                         .astype(np.float32))
    tie = (r.astype(np.float64) + other.astype(np.float64)) / 2 == s
    up, down = np.maximum(r, other), np.minimum(r, other)
    return np.where(tie & (err > 0), up, np.where(tie & (err < 0), down, r))


def accum_matmul_order(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """B9's result as the kernel sums it, in float32 numpy: the same fixed
    order, so the card's output equals this bit for bit. Block g's lane l
    sums rows g·shard + l + 32k, k ascending, one fmaf a term from 0; the
    32 lanes add in the xor butterfly's pairing (16, 8, 4, 2, 1); the last
    block sums the blocks' partials in S = threads // (ka·kb) shards (shard
    s takes blocks s, s+S, … in order), then the shards in order."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    (rows, ka), kb = a.shape, b.shape[1]
    plan = accum_plan(rows, ka, kb)
    g = np.arange(plan.blocks)[:, None]
    lane = np.arange(32)[None, :]
    acc = np.zeros((plan.blocks, 32, ka, kb), np.float32)
    for k in range(-(-plan.shard // 32)):
        off = lane + 32 * k
        r = g * plan.shard + off
        valid = ((off < plan.shard) & (r < rows))[:, :, None, None]
        r = np.where(valid[:, :, 0, 0], r, 0)
        acc = np.where(valid, fma_f32(a[r][:, :, :, None], b[r][:, :, None, :], acc), acc)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, np.arange(32) ^ off]
    part = acc[:, 0].reshape(plan.blocks, ka * kb)
    shards = max(1, plan.threads // (ka * kb))
    red = []
    for s in range(shards):
        total = np.zeros(ka * kb, np.float32)
        for blk in range(s, plan.blocks, shards):
            total = part[blk].copy() if blk == s else total + part[blk]
        red.append(total)
    out = red[0]
    for total in red[1:]:
        out = out + total
    return out.reshape(ka, kb)


_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
_tickets_lock = threading.Lock()


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    """B9's ticket for launches on ``stream``: one int32, zeroed once here
    and left 0 by every launch (its last block wraps it). One a stream, so
    launches that may run at once never share one."""
    key = (dev.index, stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None:
            t = _tickets[key] = torch.zeros(1, device=dev, dtype=torch.int32)
        return t


def _accum_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,ka),(N,kb) → (ka,kb) = Σ_r a[r,:]ᵀ b[r,:]: on the card one launch,
    summing in accum_matmul_order's fixed order."""
    if not on_cuda("accum_matmul", a):
        return _accum_matmul_plain(a, b)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a and b must be 2-d, got {tuple(a.shape)} and {tuple(b.shape)}")
    (rows, ka), kb = a.shape, b.shape[1]
    dev = a.device
    check_operand("a", a, dev, (rows, ka), F32)
    check_operand("b", b, dev, (rows, kb), F32)
    plan = accum_plan(max(rows, 1), max(ka, 1), max(kb, 1))  # sizes; C checks limits
    partials, out = _empty(dev, plan.blocks, ka * kb), _empty(dev, ka, kb)

    def call(lib, s):
        return lib.lenet_accum_matmul(a.data_ptr(), b.data_ptr(), rows, ka, kb,
                                      partials.data_ptr(), _ticket(dev, s).data_ptr(),
                                      out.data_ptr(), s)

    _launch("accum_matmul", dev, call, _ACCUM_LIMITS)
    return out


def pool_wgrad(out_c1_windows: torch.Tensor, d_pre_s1: torch.Tensor) -> torch.Tensor:
    """g_w_s1[i,j] = Σ_{b,l} d_pre_s1[b,l] · windows[b,4i+j,l], summed over
    the batch: one (216n,16)ᵀ·(216n,1) B9 product."""
    n = out_c1_windows.shape[0]
    # Contiguous: at n = 1 the transposed reshape is a strided view.
    a = out_c1_windows.transpose(1, 2).reshape(n * 216, 16).contiguous()
    return _accum_matmul(a, d_pre_s1.reshape(n * 216, 1)).reshape(4, 4)


def conv_bwd_dpre_plain(d_out_c1: torch.Tensor, pre_c1: torch.Tensor) -> torch.Tensor:
    """Plain twin of B8: d·s·(1−s) left to right, s = σ(pre)."""
    s = sigmoid(pre_c1)
    return d_out_c1 * s * (1.0 - s)


def conv_bwd_dpre(d_out_c1: torch.Tensor, pre_c1: torch.Tensor) -> torch.Tensor:
    """(n,6,24,24) σ′ chain through the conv preact, elementwise."""
    if not on_cuda("sigma_prime", d_out_c1):
        return conv_bwd_dpre_plain(d_out_c1, pre_c1)
    n = _batch(d_out_c1)
    dev = d_out_c1.device
    check_operand("d_out_c1", d_out_c1, dev, (n, 6, 24, 24), F32)
    check_operand("pre_c1", pre_c1, dev, (n, 6, 24, 24), F32)
    out = _empty(dev, n, 6, 24, 24)
    _launch("sigma_prime", dev, lambda lib, s: lib.lenet_sigma_prime(
        d_out_c1.data_ptr(), pre_c1.data_ptr(), out.data_ptr(), n, s))
    return out


def conv_wgrad(x: torch.Tensor, d_pre_c1: torch.Tensor) -> torch.Tensor:
    """The /576-normalised correlation of d_pre_c1 with the input patches,
    summed over the batch: one (576n,6)ᵀ·(576n,25) B9 product. Rows are
    (b, r, c), features 5i+j, as JAX's transpose(0,2,3,1) of both."""
    n = x.shape[0]
    d = d_pre_c1.permute(0, 2, 3, 1).reshape(n * 576, 6).contiguous()
    pm = reference.patches(x).transpose(1, 2).reshape(n * 576, 25)  # the im2col
    return _accum_matmul(d, pm).reshape(6, 5, 5) / reference.CONV_NORM


# ---------------------------------------------------------------------------
# The staged path's entry points
# ---------------------------------------------------------------------------


def _forward_flat(params: Params, xs: torch.Tensor):
    """The three forward stages, pool and FC in the flat (n,216) layout:
    (pre_c1, out_c1, xw, pre_s1, out_s1, pre_f, out_f)."""
    pre_c1, out_c1 = conv_fwd(xs, params["c1"]["w"], params["c1"]["b"])
    xw = pack_pool_windows(out_c1)
    pre_s1, out_s1 = pool_fwd(xw, params["s1"]["w"], params["s1"]["b"])
    pre_f, out_f = fc_fwd(out_s1, params["f"]["w"], params["f"]["b"])
    return pre_c1, out_c1, xw, pre_s1, out_s1, pre_f, out_f


def forward(params: Params, xs: torch.Tensor) -> reference.Activations:
    """The batched forward through B3, B4 and B5: the Activations of
    ``reference.forward`` (pool stages reshaped back to (n,6,6,6))."""
    n = xs.shape[0]
    pre_c1, out_c1, _, pre_s1, out_s1, pre_f, out_f = _forward_flat(params, xs)
    return reference.Activations(xs, pre_c1, out_c1, pre_s1.reshape(n, 6, 6, 6),
                                 out_s1.reshape(n, 6, 6, 6), pre_f, out_f)


def predict(params: Params, xs: torch.Tensor) -> torch.Tensor:
    """≙ classify: the argmax of the staged forward's outputs."""
    return torch.argmax(forward(params, xs).out_f, dim=-1)


def staged_value_and_ref_grads(params: Params, xs: torch.Tensor,
                               ys: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """(err_mean, batch-mean reference grads) through the kernel library:
    one launch per stage, 8 in all. The same contract as
    ``lenet_fused.fused_value_and_ref_grads``, its differential anchor."""
    n = xs.shape[0]
    pre_c1, out_c1, xw, pre_s1, out_s1, pre_f, out_f = _forward_flat(params, xs)

    d_pre_f = make_error(out_f, ys)
    err_mean = torch.sum(error_norm(d_pre_f)) / n

    g_w_f, g_b_f, d_out_s1 = fc_bwd(d_pre_f, out_s1, params["f"]["w"])
    d_pre_s1, d_xw = pool_bwd(d_out_s1, pre_s1, params["s1"]["w"])
    g_w_s1 = pool_wgrad(xw, d_pre_s1)
    g_b_s1 = torch.sum(d_pre_s1) / reference.POOL_BIAS_NORM

    d_out_c1 = unpack_pool_windows(d_xw)
    d_pre_c1 = conv_bwd_dpre(d_out_c1, pre_c1)
    g_w_c1 = conv_wgrad(xs, d_pre_c1)
    g_b_c1 = torch.sum(d_pre_c1, dim=(0, 2, 3)) / reference.CONV_NORM

    inv_n = 1.0 / n
    grads: Params = {
        "c1": {"w": g_w_c1 * inv_n, "b": g_b_c1 * inv_n},
        "s1": {"w": g_w_s1 * inv_n, "b": g_b_s1 * inv_n},
        "f": {"w": g_w_f * inv_n, "b": g_b_f * inv_n},
    }
    return err_mean, grads

