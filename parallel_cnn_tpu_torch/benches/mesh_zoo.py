"""The zoo trainer's CLI over meshes of several cards, one configuration
after another:

    python -m parallel_cnn_tpu_torch.benches.mesh_zoo [--epochs 2]

For each configuration of ``CONFIGS`` that the visible cards can hold
(data × model ≤ the card count) it runs ``python -m
parallel_cnn_tpu_torch`` with ``--batch-size 128`` on 40 steps an epoch of
the synthetic CIFAR-shape set (5,120 images, 2,560 to evaluate) at
``--lr 0.01`` (where f32 rounding stays small from step to step), in a
process of its own, and reads rank 0's epoch records (``--metrics``: the
mean loss unrounded, the accuracy, the epoch's seconds). The
configurations: full-width ResNet-18 on the conv kernels with
the fused tail on one card, then on JAX's GSPMD path (``--mesh-data`` 1, 2
and 4, 2 × 2 and 1 × 4 with the model axis), then the explicit collectives
at 2 and 4 ranks (``--comm-impl psum``: the unfused step; ``ring``:
update-on-arrival); the CIFAR CNN on one card and over ``--mesh-data 4``
(BASELINE config #3). It prints one line a configuration: the flags, the
epoch losses and accuracies, the first epoch's seconds (it pays the ranks'
start-up, and the first configuration's the kernels' build), the last
epoch's seconds and its img/s (host clock), the largest difference of the
epoch losses from the model's single-card run relative to it (the GSPMD
path takes global BN statistics, so it trains as one card does up to
rounding; the explicit collectives take each rank's statistics, and
differ by more), and for the ring its difference from the psum run at the
same size. The card's name and power limit come first. Exits non-zero
when a run fails or its loss does not fall from the first epoch to the
last. ``--device cpu`` runs the same configurations over gloo ranks (the
kernels' plain versions), at ``--train-count``/``--test-count``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from parallel_cnn_tpu_torch.utils.backend import card_name_and_power_limit

RESNET = ["--model", "resnet18", "--conv-backend", "cuda", "--fused-step",
          "--act-dtype", "float32"]
CIFAR = ["--model", "cifar_cnn"]
#: (model flags, mesh flags, ranks): each model's single-card run first,
#: the reference of the ones after it.
CONFIGS = [
    (RESNET, [], 1),
    (RESNET, ["--mesh-data", "1"], 1),
    (RESNET, ["--mesh-data", "2"], 2),
    (RESNET, ["--mesh-data", "4"], 4),
    (RESNET, ["--mesh-data", "2", "--mesh-model", "2"], 4),
    (RESNET, ["--mesh-data", "1", "--mesh-model", "4"], 4),
    (RESNET, ["--mesh-data", "2", "--comm-impl", "psum"], 2),
    (RESNET, ["--mesh-data", "2", "--comm-impl", "ring"], 2),
    (RESNET, ["--mesh-data", "4", "--comm-impl", "psum"], 4),
    (RESNET, ["--mesh-data", "4", "--comm-impl", "ring"], 4),
    (CIFAR, [], 1),
    (CIFAR, ["--mesh-data", "4"], 4),
]
BATCH = 128
LR = 0.01
TRAIN_COUNT = 40 * BATCH
TEST_COUNT = 2560


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mesh_zoo", description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--train-count", type=int, default=TRAIN_COUNT)
    p.add_argument("--test-count", type=int, default=TEST_COUNT)
    args = p.parse_args(argv)
    if args.epochs < 2:
        p.error("--epochs must be >= 2 (the last epoch is the warm one)")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("mesh_zoo: no CUDA card", file=sys.stderr)
            return 1
        cards = torch.cuda.device_count()
        print(f"{card_name_and_power_limit()} x{cards}", flush=True)
    else:
        cards = 4
    images = args.train_count // BATCH * BATCH  # a drop-tail epoch's images
    reference, psum = {}, {}
    rc = 0
    for model, mesh, ranks in CONFIGS:
        name = " ".join(model[:2] + mesh)
        if ranks > cards:
            print(f"[mesh_zoo] {name}: skipped ({ranks} ranks, {cards} card(s))",
                  flush=True)
            continue
        with tempfile.TemporaryDirectory(prefix="mesh_zoo_") as tmp:
            metrics = Path(tmp) / "epochs.jsonl"
            proc = subprocess.run(
                [sys.executable, "-m", "parallel_cnn_tpu_torch", "--device",
                 args.device, *model, *mesh, "--batch-size", str(BATCH), "--lr",
                 str(LR), "--epochs", str(args.epochs), "--synthetic-train-count",
                 str(args.train_count), "--synthetic-test-count", str(args.test_count),
                 "--metrics", str(metrics)],
                capture_output=True, text=True)
            recs = ([json.loads(ln) for ln in metrics.read_text().splitlines() if ln]
                    if metrics.exists() else [])
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        epochs = [(r["loss"], r["accuracy"], r["seconds"]) for r in recs]
        losses = [e[0] for e in epochs]
        if (proc.returncode != 0 or len(epochs) != args.epochs
                or not losses[-1] < losses[0]):
            rc = 1
            print(f"[mesh_zoo] {name}: FAIL (rc {proc.returncode}, {len(epochs)} "
                  "epoch lines)", flush=True)
            continue
        key = model[1]
        ref = reference.setdefault(key, losses)
        drift = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        first, last = epochs[0][2], epochs[-1][2]
        line = (f"[mesh_zoo] {name}: epoch losses {losses}, accuracies "
                f"{[e[1] for e in epochs]}%, first epoch {first:.3f} s, last epoch "
                f"{last:.3f} s = {images / last:.0f} img/s, max |Δloss|/loss vs "
                f"{key} on one card {drift:.3e}")
        if "--comm-impl" in mesh:
            n = mesh[mesh.index("--mesh-data") + 1]
            if mesh[-1] == "psum":
                psum[n] = losses
            elif n in psum:
                ring = max(abs(a - b) / abs(b) for a, b in zip(losses, psum[n]))
                line += f", vs psum at {n} ranks {ring:.3e}"
        print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
