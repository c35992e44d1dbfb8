"""SAME NHWC convolution with a fused BN/residual/ReLU epilogue.

The port's counterpart of ``parallel_cnn_tpu/ops/pallas_conv.py``
(``conv2d`` and ``conv2d_fused``, whose TPU kernel is ``_tap_kernel`` at
pallas_conv.py:228). On a CUDA tensor both functions launch the hand
kernel in ``csrc/tap_conv.cu``; on a CPU tensor they run the plain PyTorch
version beside it. There is no other route: a CUDA tensor that the kernel
does not take raises.

Layouts follow the JAX package: activations NHWC, weights HWIO
``(k, k, Cin, Cout)``, per-channel ``scale``/``shift`` of shape ``(Cout,)``.
Padding is XLA's SAME split (``pad_lo = pad_total // 2``), which for a
3x3/stride-2 conv on an even size puts no padding above and to the left:
output ``o`` centres on input ``2o + 1``, where PyTorch's ``padding=1``
would centre on ``2o``.

The kernel is compiled with ``nvcc`` on first use into ``_build/`` beside
the package (a directory git ignores), as a shared library with a plain C
interface loaded through ctypes. Nothing is built or imported from CUDA
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tap_conv.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

SUPPORTED_K = (1, 3, 5, 7)
SUPPORTED_STRIDES = (1, 2)
_INT32_MAX = 2**31 - 1


class LaunchCounter:
    """Counts kernel launches (thread-safe). The serving path runs convs
    on batcher worker threads, so increments take a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0


#: Launches of the tap-conv kernel in this process (``conv2d`` and
#: ``conv2d_fused`` share the kernel and the count).
launches = LaunchCounter()


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


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc"
    ]:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the tap-conv kernel is built "
            "from csrc/tap_conv.cu on first use"
        )
    return found


class _Library:
    """The compiled kernel library: built once per source digest, loaded
    once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.path: Optional[Path] = None
        self.build_seconds: Optional[float] = None
        self.compiler_output = ""

    def get(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self):
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        path = BUILD_DIR / f"libtap_conv-{digest}.so"
        t0 = time.perf_counter()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {SOURCE.name} (rc {proc.returncode}):\n"
                    f"{proc.stderr}"
                )
            self.compiler_output = proc.stderr
            os.replace(tmp, path)  # atomic: a racing process sees all or none
        self.build_seconds = time.perf_counter() - t0
        self.path = path
        lib = ctypes.CDLL(str(path))
        fn = lib.tap_conv_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return lib


_library = _Library()


def build() -> _Library:
    """Compile (if needed) and load the kernel library; returns its record
    (``path``, ``build_seconds``, ``compiler_output``)."""
    _library.get()
    return _library


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   shape: Tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
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
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, scale, shift, residual)
    ):
        raise RuntimeError(
            "the tap-conv kernel has no backward yet: call it under "
            "torch.inference_mode() or torch.no_grad()"
        )
    lib = _library.get()
    out = torch.empty(oshape, device=dev, dtype=torch.float32)
    _, pt, _ = same_pads(h, k, stride)
    _, pl, _ = same_pads(wd, k, stride)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tap_conv_forward(
            _ptr(x), _ptr(w), _ptr(scale), _ptr(shift), _ptr(residual),
            _ptr(out), n, h, wd, cin, oshape[1], oshape[2], cout, k, stride,
            pt, pl, int(relu), stream,
        )
    if err != 0:
        raise RuntimeError(f"tap_conv kernel launch failed: cudaError {err}")
    launches.add()
    return out


def _dispatch(x, w, scale, shift, residual, stride, relu, plain):
    _check_geometry(w, stride)
    if x.device.type == "cpu":
        return plain()
    if x.device.type != "cuda":
        raise ValueError(f"tap_conv runs on cuda or cpu tensors, got {x.device}")
    return _launch(x, w, scale, shift, residual, stride, relu)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv, NHWC × HWIO → NHWC; stride ∈ {1, 2}, odd k ∈ {1,3,5,7}."""
    return _dispatch(
        x, w, None, None, None, stride, False,
        lambda: conv2d_plain(x, w, stride),
    )


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
    ``shift = β − mean·scale``; ``residual`` has the output's shape."""
    return _dispatch(
        x, w, scale, shift, residual, stride, relu,
        lambda: conv2d_fused_plain(x, w, scale, shift, residual, stride, relu),
    )
