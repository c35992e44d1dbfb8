"""The LeNet-ref trainer's CLI over meshes of several cards, one
configuration after another:

    python -m parallel_cnn_tpu_torch.benches.mesh_lenet [--epochs 2]

For each configuration of ``CONFIGS`` that the visible cards can hold
(data × model ≤ the card count) it runs ``python -m
parallel_cnn_tpu_torch`` with ``--batch-size 64 --shuffle`` on the
synthetic 60,000/10,000 MNIST stand-in, in a process of its own, and reads
rank 0's lines: the epoch errors with the epoch loop's cumulative seconds
(``error: E, time_on_cpu: T``) and the error rate. It prints one line a
configuration: the flags, the epoch errors, the error rate, the first
epoch's seconds (it pays the ranks' start-up, and the first
configuration's the kernels' build), the last epoch's seconds and its
img/s (937 steps × 64 images, host clock), and the largest difference of
the epoch errors from the first configuration's (the single-device kernel
run: the same global batches in the same order, so the mesh runs differ
from it by f32 rounding and, with a bf16 wire, by the wire's). The card's
name and power limit come first. Exits non-zero when a run fails or the
error does not fall from the first epoch to the last.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys

import torch

from parallel_cnn_tpu_torch.utils.backend import card_name_and_power_limit

#: (flags, ranks): the single-device kernel path first, the reference.
CONFIGS = [
    (["--ops", "cuda"], 1),
    (["--mesh-data", "1", "--ops", "cuda"], 1),
    (["--mesh-data", "2", "--ops", "cuda"], 2),
    (["--mesh-data", "2", "--ops", "cuda", "--comm-impl", "ring"], 2),
    (["--mesh-data", "2", "--ops", "cuda", "--comm-impl", "ring",
      "--comm-wire-dtype", "bfloat16"], 2),
    (["--mesh-data", "4", "--ops", "cuda"], 4),
    (["--ops", "reference"], 1),
    (["--mesh-data", "2", "--mesh-model", "2"], 4),
    (["--mesh-data", "1", "--mesh-model", "3"], 3),
]
BATCH = 64
TRAIN_COUNT = 60_000
EPOCH_LINE = re.compile(r"^error: (\S+), time_on_cpu: (\S+)$", re.M)
RATE_LINE = re.compile(r"^Error Rate: (\S+)%$", re.M)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mesh_lenet", description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    args = p.parse_args(argv)
    if args.epochs < 2:
        p.error("--epochs must be >= 2 (the last epoch is the warm one)")
    if not torch.cuda.is_available():
        print("mesh_lenet: no CUDA card", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    print(f"{card_name_and_power_limit()} x{cards}", flush=True)
    images = TRAIN_COUNT // BATCH * BATCH  # a drop-tail epoch's images
    base_errs = None
    rc = 0
    for flags, ranks in CONFIGS:
        name = " ".join(flags)
        if ranks > cards:
            print(f"[mesh_lenet] {name}: skipped ({ranks} ranks, {cards} card(s))",
                  flush=True)
            continue
        proc = subprocess.run(
            [sys.executable, "-m", "parallel_cnn_tpu_torch", *flags, "--batch-size",
             str(BATCH), "--shuffle", "--epochs", str(args.epochs)],
            capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        epochs = [(float(e), float(t)) for e, t in EPOCH_LINE.findall(proc.stdout)]
        rate = RATE_LINE.findall(proc.stdout)
        errs = [e for e, _ in epochs]
        if (proc.returncode != 0 or len(epochs) != args.epochs or len(rate) != 1
                or not errs[-1] < errs[0]):
            rc = 1
            print(f"[mesh_lenet] {name}: FAIL (rc {proc.returncode}, {len(epochs)} "
                  "epoch lines)", flush=True)
            continue
        if base_errs is None:
            base_errs = errs
        drift = max(abs(a - b) for a, b in zip(errs, base_errs))
        first, last = epochs[0][1], epochs[-1][1] - epochs[-2][1]
        print(f"[mesh_lenet] {name}: epoch errors {errs}, error rate {rate[0]}%, "
              f"first epoch {first:.3f} s, last epoch {last:.3f} s = "
              f"{images / last:.0f} img/s, max |Δerror| vs {' '.join(CONFIGS[0][0])} "
              f"{drift:.3e}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
