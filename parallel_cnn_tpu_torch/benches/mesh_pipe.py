"""The zoo trainer's 1F1B pipeline over several cards, beside the flat ring
at the same data-axis size:

    python -m parallel_cnn_tpu_torch.benches.mesh_pipe [--epochs 2]

``--pipeline-stages S`` takes every visible card: S stages × cards/S data
ranks. For each configuration of ``CONFIGS`` it runs ``python -m
parallel_cnn_tpu_torch`` on full-width ResNet-18 with the conv kernels,
``--accum-steps 2`` (M = 2 microbatches a step), ``--batch-size 128`` on
40 steps an epoch of the synthetic CIFAR-shape set (5,120 images, 2,560
to evaluate) at ``--lr 0.01``, in a process of its own, and reads rank 0's
epoch records (``--metrics``). First the flat ring (``--mesh-data N
--comm-impl ring``) at each data-axis size the cards allow, then the
pipeline at S = 1, 2 and 4 (f32; the bf16 wire and activations and the
ZeRO-2 tail at S = 2). One line a configuration: the flags, the epoch
losses and accuracies, the first epoch's seconds (the ranks' start-up,
and the first configuration's kernel build), the last epoch's seconds and
img/s (host clock), the bubble share (S−1)/(S−1+M), and the largest
difference of the epoch losses from the flat ring's at the same data-axis
size, relative to it. The card's name and power limit come first. Exits
non-zero when a run fails or its loss does not fall from the first epoch
to the last. ``--device cpu`` runs the same over gloo ranks (the kernels'
plain versions; one data rank, S gloo ranks), at
``--train-count``/``--test-count``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from parallel_cnn_tpu_torch.parallel.pipeline import bubble_fraction
from parallel_cnn_tpu_torch.utils.backend import card_name_and_power_limit

ACCUM = 2
MODEL = ["--model", "resnet18", "--conv-backend", "cuda", "--accum-steps", str(ACCUM)]
#: (flags, stages; 0 for the flat ring, whose data-axis size is its
#: --mesh-data).
CONFIGS = [
    (["--mesh-data", "1", "--comm-impl", "ring"], 0),
    (["--mesh-data", "2", "--comm-impl", "ring"], 0),
    (["--mesh-data", "4", "--comm-impl", "ring"], 0),
    (["--pipeline-stages", "1"], 1),
    (["--pipeline-stages", "2"], 2),
    (["--pipeline-stages", "4"], 4),
    (["--pipeline-stages", "2", "--pipeline-wire-dtype", "bfloat16",
      "--pipeline-act-dtype", "bfloat16"], 2),
    (["--pipeline-stages", "2", "--comm-impl", "ring", "--fused-step",
      "--act-dtype", "float32"], 2),
]
BATCH = 128
LR = 0.01
TRAIN_COUNT = 40 * BATCH
TEST_COUNT = 2560


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mesh_pipe", description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--train-count", type=int, default=TRAIN_COUNT)
    p.add_argument("--test-count", type=int, default=TEST_COUNT)
    args = p.parse_args(argv)
    if args.epochs < 2:
        p.error("--epochs must be >= 2 (the last epoch is the warm one)")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("mesh_pipe: no CUDA card", file=sys.stderr)
            return 1
        cards = torch.cuda.device_count()
        print(f"{card_name_and_power_limit()} x{cards}", flush=True)
    else:
        cards = 4
    images = args.train_count // BATCH * BATCH  # a drop-tail epoch's images
    flat = {}  # data-axis size -> the flat ring's epoch losses
    rc = 0
    for mesh, stages in CONFIGS:
        name = " ".join(mesh)
        if stages:
            ranks = cards if args.device == "cuda" else stages
            n_data = ranks // stages
        else:
            ranks = n_data = int(mesh[1])
        if ranks > cards or ranks % max(stages, 1):
            print(f"[mesh_pipe] {name}: skipped ({ranks} ranks, {cards} card(s))",
                  flush=True)
            continue
        with tempfile.TemporaryDirectory(prefix="mesh_pipe_") as tmp:
            metrics = Path(tmp) / "epochs.jsonl"
            proc = subprocess.run(
                [sys.executable, "-m", "parallel_cnn_tpu_torch", "--device",
                 args.device, *MODEL, *mesh, "--batch-size", str(BATCH), "--lr",
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
            print(f"[mesh_pipe] {name}: FAIL (rc {proc.returncode}, {len(epochs)} "
                  "epoch lines)", flush=True)
            continue
        first, last = epochs[0][2], epochs[-1][2]
        line = (f"[mesh_pipe] {name}: {ranks} rank(s), data axis {n_data}; epoch "
                f"losses {losses}, accuracies {[e[1] for e in epochs]}%, first epoch "
                f"{first:.3f} s, last epoch {last:.3f} s = {images / last:.0f} img/s")
        if not stages:
            flat[n_data] = losses
        else:
            line += f", bubble share {bubble_fraction(stages, ACCUM):.3f}"
            if n_data in flat:
                drift = max(abs(a - b) / abs(b) for a, b in zip(losses, flat[n_data]))
                line += f", max |Δloss|/loss vs the flat ring at {n_data} {drift:.3e}"
        print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
