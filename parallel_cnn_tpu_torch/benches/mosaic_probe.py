"""The Mosaic probes of the JAX package's ``benches/mosaic_probe.py``, run
on the port's kernels (``ops/mosaic_probe.py``, ``csrc/mosaic_probe.cu``).

    python -m parallel_cnn_tpu_torch.benches.mosaic_probe [--device cpu]

Each ``probe_*(device)`` builds the same all-ones inputs as the JAX probe
of the same name, on that device, and calls its kernel wrapper. ``main``
runs the eight in the JAX script's order and prints one line per probe,
``[name] RAN <device> first=…ms steady=…us``: one first call, then the
mean of 10 calls, each timing ended by a synchronize on a card. One run on
the card launches each kernel 11 times.

The device defaults to cuda and raises ``NoGpuError`` where there is none;
``--device cpu`` runs the plain twins on the host. On the TPU each probe
asked whether Mosaic lowers a form, so the JAX script caught a rejection
and printed ``REJECTED``. Here there is no such branch: a kernel that
fails to build or launch is a bug, its exception propagates, and the
script exits non-zero.
"""

from __future__ import annotations

import argparse
import time

import torch

from parallel_cnn_tpu_torch.ops import mosaic_probe
from parallel_cnn_tpu_torch.utils.backend import resolve_device

BB = 128
L = BB * 576
ROWS = 1024


def _ones(shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def probe_rank3_dot(device):
    # (4, 64, 128) @ (4, 128, 64) batched over dim 0
    a = _ones((4, 64, 128), torch.float32, device)
    b = _ones((4, 128, 64), torch.float32, device)
    return mosaic_probe.rank3_dot(a, b)


def probe_lane_merge(device):
    return mosaic_probe.lane_merge(_ones((25, BB, 576), torch.float32, device))


def probe_lane_split(device):
    return mosaic_probe.lane_split(_ones((1, L), torch.float32, device), BB)


def probe_mxu_conv_3d(device):
    w = _ones((6, 25), torch.float32, device)
    x = _ones((25, BB, 576), torch.bfloat16, device)
    return mosaic_probe.mxu_conv_3d(w, x)


def probe_mxu_conv_L(device):
    w = _ones((6, 25), torch.float32, device)
    x = _ones((25, L), torch.bfloat16, device)
    return mosaic_probe.mxu_conv_L(w, x)


def probe_vpu_conv_baseline(device):
    w = _ones((6, 25), torch.float32, device)
    x = _ones((25, BB, 576), torch.bfloat16, device)
    return mosaic_probe.vpu_conv(w, x)


def probe_pair_dot_laneslice(device):
    x = _ones((ROWS, 64), torch.bfloat16, device)
    w = _ones((64, 128), torch.bfloat16, device)
    return mosaic_probe.pair_dot(x, w)


def probe_two_dot_baseline(device):
    x = _ones((ROWS, 64), torch.bfloat16, device)
    w = _ones((64, 128), torch.bfloat16, device)
    return mosaic_probe.two_dot(x, w)


#: The probes in the JAX script's order, under its names.
PROBES = (
    ("rank3-dot", probe_rank3_dot),
    ("lane-merge", probe_lane_merge),
    ("lane-split", probe_lane_split),
    ("vpu-conv-baseline", probe_vpu_conv_baseline),
    ("mxu-conv-L", probe_mxu_conv_L),
    ("mxu-conv-3d", probe_mxu_conv_3d),
    ("pair-dot-laneslice", probe_pair_dot_laneslice),
    ("two-dot-baseline", probe_two_dot_baseline),
)


def _run(name, fn, device):
    """One first call of ``fn(device)``, then 10; prints the probe's line
    and returns the last output."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    out = fn(device)
    sync()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(10):
        out = fn(device)
    sync()
    steady = (time.perf_counter() - t0) / 10
    print(f"[{name}] RAN {device} first={first * 1e3:.1f}ms "
          f"steady={steady * 1e6:.0f}us", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m parallel_cnn_tpu_torch.benches.mosaic_probe",
        description="Run the eight Mosaic probes on the port's kernels.")
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a GPU) or cpu "
                             "(the plain twins)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    for name, fn in PROBES:
        _run(name, fn, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
