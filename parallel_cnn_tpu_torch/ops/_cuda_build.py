"""One builder for every CUDA kernel library of the port.

Each kernel source in ``csrc/`` is compiled with ``nvcc`` on first use into
``_build/`` beside the package (a directory git ignores), as a shared
library with a plain C interface loaded through ctypes. The file name
carries a digest of the source and the flags, so an edited source or a
changed flag builds anew and a stale library is never loaded. Nothing is
built when a module is imported: the CPU tests import every module on a
machine without ``nvcc``.
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
from typing import Dict, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: ctypes signature of one exported C function: (argtypes, restype).
Signature = Tuple[Sequence[type], type]


class LaunchCounter:
    """Counts kernel launches (thread-safe). The serving path launches from
    batcher worker threads, so increments take a lock."""

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


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc"
    ]:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's kernels are built "
            "from csrc/*.cu on first use"
        )
    return found


class Library:
    """A compiled kernel library: built once per source digest, loaded once
    per process. ``symbols`` names each exported C function with its ctypes
    signature; ``extra_flags`` are this kernel's own nvcc flags; ``headers``
    the ``csrc/`` headers the source includes (they join the digest)."""

    def __init__(self, source: str, symbols: Dict[str, Signature],
                 extra_flags: Sequence[str] = (), headers: Sequence[str] = ()):
        self.source = CSRC / source
        self.headers = tuple(CSRC / h for h in headers)
        self.symbols = dict(symbols)
        self.flags = NVCC_FLAGS + tuple(extra_flags)
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
        src = b"".join(p.read_bytes() for p in (self.source, *self.headers))
        digest = hashlib.sha256(src + " ".join(self.flags).encode()).hexdigest()[:16]
        path = BUILD_DIR / f"lib{self.source.stem}-{digest}.so"
        t0 = time.perf_counter()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run(
                [nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source.name} (rc {proc.returncode}):\n"
                    f"{proc.stderr}"
                )
            self.compiler_output = proc.stderr
            os.replace(tmp, path)  # atomic: a racing process sees all or none
        self.build_seconds = time.perf_counter() - t0
        self.path = path
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in self.symbols.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        return lib


def check_operand(name: str, t, device, shape, dtype) -> None:
    """Raise unless ``t`` lies on ``device`` with this dtype and shape and
    is contiguous: what every kernel wrapper checks before it launches."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cuda(name: str, t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain twin); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")
    return True


def launch_stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(kernel: str, err: int, hint: str = "") -> None:
    """Raise for a launcher's nonzero cudaError_t; ``hint`` names what the
    launcher refuses, for its cudaErrorInvalidValue (1)."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}"
                           + (f" ({hint})" if hint else ""))
