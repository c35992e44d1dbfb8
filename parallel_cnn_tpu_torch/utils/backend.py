"""Device resolution and card identification.

The port's counterpart of ``parallel_cnn_tpu/utils/backend.py``. Every
entry point of the port runs on the card unless the caller asks for the
CPU: ``resolve_device(None)`` means CUDA and raises where there is none.
"""

from __future__ import annotations

import subprocess
from typing import List, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


class NoGpuError(RuntimeError):
    """A CUDA device was asked for (explicitly or by default) and none is
    present."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``None`` and ``"cuda"`` mean the
    current CUDA device, ``"cpu"`` the host. Raises NoGpuError when CUDA is
    asked for and absent — it never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoGpuError(
                "no CUDA device is available; the port runs on the GPU by "
                "default — pass device='cpu' (CLI: --device cpu) to run the "
                "plain PyTorch path on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """Devices replicas are pinned across: every visible card for CUDA
    without an index, else just the resolved device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and (device is None or torch.device(device).index is None):
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def card_name_and_power_limit() -> Optional[str]:
    """The line ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints for the first card, or None when
    nvidia-smi is absent or fails."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0 or not proc.stdout.strip():
        return None
    return proc.stdout.strip().splitlines()[0]
