"""The plan autotuner's ranking against measured throughput over four cards
(the counterpart of the JAX package's ``bench_autotune`` leg 1), and a
``tune`` report trained through ``--autotune`` on four ranks:

    python -m parallel_cnn_tpu_torch.benches.mesh_tune [--epochs 2]

Leg 1: the four candidate plans of JAX's leg (a ring in f32, overlapped,
at k = 2 and k = 8; the post-loop ring under the 1F1B pipeline at k = 4
with S = 2 and S = 4 stages) are scored for full-width ResNet-18 at a
global batch of 128 over the visible cards under the ``h100-sxm`` profile
(``analysis/autotune.py`` ``score_plan``), then each is timed for real:
``python -m parallel_cnn_tpu_torch`` in a process of its own with the
conv kernels, ``--batch-size 128`` on 40 steps an epoch of the synthetic
CIFAR-shape set (5,120 images, 2,560 to evaluate), the last epoch's img/s
from rank 0's epoch records (host clock; the first epoch is the warm
one). It prints one line a candidate (predicted and measured img/s), then
``order_gate``'s verdict on the table and on the doctored table (every
prediction inverted), which must fail. A FAIL of the first is a finding
about the cost model on this card, not a fault of the run.

Leg 2: ``tune --model resnet18 --devices N`` writes a report; the
trainer runs one epoch by ``--autotune --autotune-report R`` and one by
the chosen plan's own flags with ``--mesh-data N`` (the mesh
``--autotune`` fills; the plan's overlap through PCNN_COMM_OVERLAP, which
has no flag), and every checkpoint leaf must be bit-identical under one
plan stamp.

The card's name and power limit come first. Exits non-zero when a run
fails, its loss is not finite, the doctored table passes, or leg 2 is not
bit for bit. ``--device cpu`` runs the same over four gloo ranks (the
kernels' plain versions) at ``--train-count``/``--test-count``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from parallel_cnn_tpu_torch.analysis import autotune, hw_profiles
from parallel_cnn_tpu_torch.nn import cifar, resnet
from parallel_cnn_tpu_torch.utils.backend import card_name_and_power_limit

WORLD = 4
BATCH = 128
LR = 0.01
TRAIN_COUNT = 40 * BATCH
TEST_COUNT = 2560
HW = "h100-sxm"
MODEL = ["--model", "resnet18", "--conv-backend", "cuda"]
#: JAX's four candidates (benches/run.py bench_autotune leg 1).
CANDIDATES = (
    autotune.Plan(comm_impl="ring", wire_dtype="float32", overlap=True, accum=2),
    autotune.Plan(comm_impl="ring", wire_dtype="float32", overlap=True, accum=8),
    autotune.Plan(comm_impl="ring", wire_dtype="float32", overlap=False, accum=4,
                  stages=2),
    autotune.Plan(comm_impl="ring", wire_dtype="float32", overlap=False, accum=4,
                  stages=4),
)


def candidate_flags(p: autotune.Plan, world: int) -> list:
    """The trainer flags that run candidate ``p`` over ``world`` ranks."""
    flags = p.flags()
    if p.stages == 1:
        flags = ["--mesh-data", str(world)] + flags
    return flags


def _train(device, flags, epochs, train_count, test_count, workdir, env=None):
    """One trainer run in a process of its own: (rc, epoch records,
    checkpoint path, output)."""
    metrics = Path(workdir) / "epochs.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "parallel_cnn_tpu_torch", "--device", device, *MODEL,
         *flags, "--batch-size", str(BATCH), "--lr", str(LR), "--epochs", str(epochs),
         "--synthetic-train-count", str(train_count), "--synthetic-test-count",
         str(test_count), "--metrics", str(metrics), "--checkpoint-dir",
         str(Path(workdir) / "ck")],
        capture_output=True, text=True, env={**os.environ, **(env or {})})
    recs = ([json.loads(ln) for ln in metrics.read_text().splitlines() if ln]
            if metrics.exists() else [])
    sys.stderr.write(proc.stderr[-4000:])
    return proc.returncode, recs, Path(workdir) / "ck" / f"ckpt_{epochs}.npz", proc.stdout


def _leaves(path):
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        return {k: z[k] for k in z.files if k != "__meta__"}, meta.get("plan")


def rank_leg(args, world) -> int:
    mp = autotune.profile_module(resnet.resnet18(10, device="meta"), cifar.IN_SHAPE,
                                 name="resnet18")
    hw = hw_profiles.get_profile(HW)
    images = args.train_count // BATCH * BATCH
    predicted, measured, rc = [], [], 0
    for p in CANDIDATES:
        pred = autotune.score_plan(p, mp, hw, global_batch=BATCH, n_dev=world).img_s
        flags = candidate_flags(p, world)
        with tempfile.TemporaryDirectory(prefix="mesh_tune_") as tmp:
            code, recs, _, _ = _train(args.device, flags, args.epochs,
                                      args.train_count, args.test_count, tmp)
        losses = [r["loss"] for r in recs]
        if code != 0 or len(recs) != args.epochs or not all(map(math.isfinite, losses)):
            print(f"[mesh_tune] {p.label()}: FAIL (rc {code}, {len(recs)} epoch "
                  "records)", flush=True)
            return 1
        meas = images / recs[-1]["seconds"]
        predicted.append(pred)
        measured.append(meas)
        print(f"[mesh_tune] {p.label()} ({' '.join(flags)}): predicted {pred:.1f} "
              f"img/s ({HW}), measured {meas:.1f} img/s (last epoch "
              f"{recs[-1]['seconds']:.3f} s); epoch losses {losses}", flush=True)
    ok, summary = autotune.order_gate(predicted, measured)
    doctored, dsummary = autotune.order_gate([1.0 / v for v in predicted], measured)
    print(f"[mesh_tune] order gate: {'PASS' if ok else 'FAIL'} ({summary})", flush=True)
    print(f"[mesh_tune] doctored table: {'PASS' if doctored else 'FAIL'} ({dsummary})"
          + ("" if not doctored else " — the gate is vacuous"), flush=True)
    if doctored:
        rc = 1
    return rc


def autotune_leg(args, world) -> int:
    with tempfile.TemporaryDirectory(prefix="mesh_tune_") as tmp:
        report = Path(tmp) / "cost_report.json"
        proc = subprocess.run(
            [sys.executable, "-m", "parallel_cnn_tpu_torch", "tune", "--model",
             "resnet18", "--global-batch", str(BATCH), "--devices", str(world),
             "--hw", HW, "--report", str(report)], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            print(f"[mesh_tune] tune: FAIL (rc {proc.returncode})", flush=True)
            return 1
        chosen, section = autotune.load_chosen_plan(report)
        eplan = chosen.to_execution_plan(n_host=1, n_dev=world)
        runs = {}
        for label, flags, env in (
                ("autotune", ["--autotune", "--autotune-report", str(report)], None),
                ("flags", candidate_flags(chosen, world),
                 {"PCNN_COMM_OVERLAP": "1" if eplan.overlap else "0"})):
            work = Path(tmp) / label
            work.mkdir()
            code, recs, ckpt, _ = _train(args.device, flags, 1, args.train_count,
                                         args.test_count, work, env)
            if code != 0 or not ckpt.exists():
                print(f"[mesh_tune] --autotune leg, {label}: FAIL (rc {code})",
                      flush=True)
                return 1
            runs[label] = (_leaves(ckpt), [r["loss"] for r in recs], flags)
    (a, sa), (b, sb) = runs["autotune"][0], runs["flags"][0]
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    print(f"[mesh_tune] --autotune {chosen.label()} over {world} ranks vs its flags "
          f"({' '.join(runs['flags'][2])}): {len(a)} checkpoint leaves "
          f"{'bit-identical' if same else 'DIFFER'}, stamps {sa} / {sb} (tune: "
          f"{eplan.fingerprint()}), epoch losses {runs['autotune'][1]} / "
          f"{runs['flags'][1]}", flush=True)
    return 0 if same and sa == sb == eplan.fingerprint() else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mesh_tune", description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--train-count", type=int, default=TRAIN_COUNT)
    p.add_argument("--test-count", type=int, default=TEST_COUNT)
    args = p.parse_args(argv)
    if args.epochs < 2:
        p.error("--epochs must be >= 2 (the last epoch is the warm one)")
    world = WORLD
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("mesh_tune: no CUDA card", file=sys.stderr)
            return 1
        cards = torch.cuda.device_count()
        print(f"{card_name_and_power_limit()} x{cards}", flush=True)
        if cards < WORLD:
            print(f"[mesh_tune] skipped: {WORLD} ranks need {WORLD} cards, {cards} "
                  "visible", flush=True)
            return 1
    return rank_leg(args, world) | autotune_leg(args, world)


if __name__ == "__main__":
    sys.exit(main())
