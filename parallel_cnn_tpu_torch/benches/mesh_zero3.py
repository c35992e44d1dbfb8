"""ZeRO-3 and the hierarchical ring over four cards, beside ZeRO-2 and the
flat ring:

    python -m parallel_cnn_tpu_torch.benches.mesh_zero3 [--epochs 2]

For each configuration of ``CONFIGS`` it trains full-width ResNet-18 with
the conv kernels (``zoo.train``, the CLI's trainer) at ``--batch-size
128`` on 40 steps an epoch of the synthetic CIFAR-shape set (5,120 images,
2,560 to evaluate) at lr 0.01 over a world of 4 ranks, one process and
one card each (``distributed.run``): the flat ring (the unfused step, the
reference), ZeRO-2 and ZeRO-3 over the flat ring at D = 4, ZeRO-3 over the
hierarchical ring at 2 hosts × 2 (``HierMesh``), and the hierarchical
comm step (unfused) at 2 × 2; f32 throughout. One line a configuration:
the epoch losses and accuracies, the largest difference of the epoch
losses from the flat ring's relative to it, the last epoch's seconds and
img/s (host clock; the first epoch is the warm one), and each rank's
resident parameter bytes between steps (a ZeRO-3 rank's bucket rows, else
the module's parameters) and ``torch.cuda.max_memory_allocated`` over the
run. The card's name and power limit come first. Exits non-zero when a
run fails or its loss does not fall from the first epoch to the last.
``--device cpu`` runs the same over four gloo ranks (the kernels' plain
versions; no memory figure), at ``--train-count``/``--test-count`` and
``--batch-size``.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from typing import Dict, List, Optional

import torch

from parallel_cnn_tpu_torch import plan as plan_lib
from parallel_cnn_tpu_torch.config import CommConfig, FusedStepConfig
from parallel_cnn_tpu_torch.data import synthetic
from parallel_cnn_tpu_torch.nn import resnet
from parallel_cnn_tpu_torch.parallel import distributed
from parallel_cnn_tpu_torch.train import zoo
from parallel_cnn_tpu_torch.utils.backend import card_name_and_power_limit

WORLD = 4
BATCH = 128
LR = 0.01
TRAIN_COUNT = 40 * BATCH
TEST_COUNT = 2560
RING = CommConfig(impl="ring")
HIER = CommConfig(impl="hierarchical", hosts=2)
ZERO2 = FusedStepConfig(update=True, act_dtype="float32")
ZERO3 = FusedStepConfig(update=True, act_dtype="float32", zero=3)
#: (name, comm, fused, hosts; 0 for the flat data axis).
CONFIGS = [
    ("flat ring D=4", RING, None, 0),
    ("ZeRO-2 flat ring D=4", RING, ZERO2, 0),
    ("ZeRO-3 flat ring D=4", RING, ZERO3, 0),
    ("ZeRO-3 hierarchical 2x2", HIER, ZERO3, 2),
    ("hierarchical comm step 2x2", HIER, None, 2),
]


class _Records:
    """The trainer's metrics sink: the epoch records, kept in memory."""

    def __init__(self):
        self.records: List[Dict] = []

    def record(self, **rec) -> None:
        self.records.append(rec)


def _resident_bytes(state: zoo.ZooState) -> int:
    """The parameter bytes a rank holds between steps: a ZeRO-3 state's
    bucket rows, else the module's parameters."""
    if state.zero3 is not None:
        return sum(r.numel() * r.element_size() for r in state.zero3.rows)
    return sum(p.numel() * p.element_size() for p in state.model.parameters())


def _rank(mesh, comm, fused, epochs, batch, train_count, test_count) -> Dict:
    cuda = mesh.device.type == "cuda"
    model = resnet.resnet18(10, backend="cuda",
                            generator=torch.Generator().manual_seed(0))
    imgs, labels = synthetic.make_image_dataset(train_count, seed=1234)
    ev = synthetic.make_image_dataset(test_count, seed=1235)
    records = _Records()
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    state, losses = zoo.train(model, imgs, labels, epochs=epochs, batch_size=batch,
                              lr=LR, mesh=mesh, comm=comm, fused=fused, eval_data=ev,
                              metrics=records, verbose=False, device=mesh.device)
    return dict(losses=losses, records=records.records,
                resident=_resident_bytes(state),
                peak=torch.cuda.max_memory_allocated(mesh.device) if cuda else None)


def _line(name: str, results: List[Dict], flat: Optional[List[float]],
          images: int) -> str:
    lead = results[0]
    losses = lead["losses"]
    recs = lead["records"]
    last = recs[-1]["seconds"]
    line = (f"[mesh_zero3] {name}: epoch losses {losses}, accuracies "
            f"{[r.get('accuracy') for r in recs]}%, last epoch {last:.3f} s = "
            f"{images / last:.0f} img/s; resident param bytes a rank "
            f"{[r['resident'] for r in results]}")
    if results[0]["peak"] is not None:
        line += f", max_memory_allocated a rank {[r['peak'] for r in results]} B"
    if flat is not None and name != CONFIGS[0][0]:
        drift = max(abs(a - b) / abs(b) for a, b in zip(losses, flat))
        line += f"; max |Δloss|/loss vs the flat ring {drift:.3e}"
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mesh_zero3", description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch-size", type=int, default=BATCH)
    p.add_argument("--train-count", type=int, default=TRAIN_COUNT)
    p.add_argument("--test-count", type=int, default=TEST_COUNT)
    args = p.parse_args(argv)
    if args.epochs < 2:
        p.error("--epochs must be >= 2 (the last epoch is the warm one)")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("mesh_zero3: no CUDA card", file=sys.stderr)
            return 1
        cards = torch.cuda.device_count()
        print(f"{card_name_and_power_limit()} x{cards}", flush=True)
        if cards < WORLD:
            print(f"[mesh_zero3] skipped: a world of {WORLD} needs {WORLD} cards, "
                  f"{cards} visible", flush=True)
            return 1
    images = args.train_count // args.batch_size * args.batch_size
    flat = None
    rc = 0
    for name, comm, fused, hosts in CONFIGS:
        mesh = dict(plan=plan_lib.ExecutionPlan(comm_impl="hierarchical", hosts=hosts)
                    ) if hosts else {}
        try:
            results = distributed.run(
                _rank, WORLD, device=args.device, timeout=1800,
                args=(comm, fused, args.epochs, args.batch_size, args.train_count,
                      args.test_count), **mesh)
        except Exception as e:  # a failed run is reported and counted, then the next
            traceback.print_exc()
            print(f"[mesh_zero3] {name}: FAIL ({type(e).__name__}: {e})", flush=True)
            rc = 1
            continue
        losses = results[0]["losses"]
        if flat is None:
            flat = losses
        print(_line(name, results, flat, images), flush=True)
        if len(losses) != args.epochs or not losses[-1] < losses[0]:
            print(f"[mesh_zero3] {name}: FAIL (the loss did not fall)", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
