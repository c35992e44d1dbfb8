"""Named hardware roofline profiles (the port of
``parallel_cnn_tpu/analysis/hw_profiles.py``; the same fields, lookup and
environment variable).

Every profile is an analytic *yardstick* — per-device peak matmul
throughput, per-direction link bandwidth, NIC bandwidth, device memory
capacity and per-hop collective launch latency — not a measured
calibration. Only the RATIOS matter for which roofline term binds and for
how the autotuner (``analysis/autotune.py``) ranks plans.

Selection order: explicit ``get_profile(name)`` argument, else the
``PCNN_HW_PROFILE`` environment variable, else :data:`DEFAULT_PROFILE`
(``h100-sxm``, the card the port runs on).

Profiles:

- ``h100-sxm`` — NVIDIA H100 SXM5 80 GB (the datasheet): the dense bf16
  tensor-core peak, NVLink 4's 900 GB/s counted one direction, one
  400 Gb/s NIC per card, and the device memory PyTorch reports for the
  card (``torch.cuda.get_device_properties(0).total_memory``).
- ``cpu-emu`` — one *virtual* device of a host-CPU emulation. Compute and
  "link" numbers are deliberately modest and comm-heavy so
  schedule-level differences (accumulation factor, pipeline bubble)
  dominate the ranking.
- ``pcie-gpu`` — A100-class PCIe part: NVLink-ish intra-host links over a
  200 Gb/s NIC.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

_GIB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class HwProfile:
    """One device's analytic roofline row.

    ``ici_hop_s`` / ``dcn_hop_s`` charge a fixed launch latency per ring
    pass per bucket hop — the term that makes bucket size matter to the
    autotuner (many small buckets pay many hops).
    """

    name: str
    description: str
    peak_flops: float        # flop/s, per device (bf16 matmul peak)
    ici_bytes_per_s: float   # bytes/s, per-direction intra-host link
    dcn_bytes_per_s: float   # bytes/s, inter-host NIC
    hbm_bytes: int           # per-device memory capacity (HBM budget)
    ici_hop_s: float = 1.0e-6
    dcn_hop_s: float = 25.0e-6

    def __post_init__(self):
        for field in ("peak_flops", "ici_bytes_per_s", "dcn_bytes_per_s",
                      "hbm_bytes"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{self.name}: {field} must be positive")


PROFILES: Dict[str, HwProfile] = {
    p.name: p
    for p in (
        HwProfile(
            name="h100-sxm",
            description=("NVIDIA H100 SXM5 80 GB: dense bf16 tensor-core "
                         "peak, NVLink 4 per direction, one 400 Gb/s NIC "
                         "per card"),
            peak_flops=989e12,
            ici_bytes_per_s=4.5e11,
            dcn_bytes_per_s=5.0e10,
            # torch.cuda.get_device_properties(0).total_memory on an
            # NVIDIA H100 80GB HBM3 (chip_smoke.py prints it).
            hbm_bytes=85_017_493_504,
            # The hop latencies keep the JAX package's yardsticks (1 us a
            # link hop, 25 us a NIC hop); they are not measured here.
        ),
        HwProfile(
            name="cpu-emu",
            description=("one virtual device of the 8-way host-CPU "
                         "emulation: modest compute, comm-heavy ratios "
                         "so schedule-level differences dominate"),
            peak_flops=5e9,
            ici_bytes_per_s=2e9,
            dcn_bytes_per_s=1e9,
            hbm_bytes=2 * _GIB,
            ici_hop_s=5.0e-6,
            dcn_hop_s=50.0e-6,
        ),
        HwProfile(
            name="pcie-gpu",
            description=("A100-class PCIe part: NVLink-ish intra-host "
                         "links, 200 Gb/s NIC, 40 GiB HBM"),
            peak_flops=312e12,
            ici_bytes_per_s=2.0e11,
            dcn_bytes_per_s=2.5e10,
            hbm_bytes=40 * _GIB,
        ),
    )
}

DEFAULT_PROFILE = "h100-sxm"


def get_profile(name: Optional[str] = None) -> HwProfile:
    """Resolve a profile by name; ``None``/empty falls back to the
    ``PCNN_HW_PROFILE`` env var, then :data:`DEFAULT_PROFILE`. Unknown
    names fail loudly with the full menu."""
    resolved = name or os.environ.get("PCNN_HW_PROFILE") or DEFAULT_PROFILE
    try:
        return PROFILES[resolved]
    except KeyError:
        raise ValueError(
            f"unknown hardware profile {resolved!r} "
            f"(known: {', '.join(sorted(PROFILES))})"
        ) from None


def active_profile() -> HwProfile:
    """The profile the current process resolves to (env-aware)."""
    return get_profile(None)
