"""Elastic ZeRO-3 over four cards: a resize lap beside the fixed world.

    python -m parallel_cnn_tpu_torch.benches.mesh_elastic [--steps 10]

One world of 4 ranks, one process and one card each (``distributed.run``),
runs two laps of the elastic controller (resilience/elastic.py), each leg
``--steps`` optimizer steps, the world resized before each leg: flat 4 →
(2 hosts × 2) → flat 2 → flat 4 (the hosts pinned, as JAX's tests pin
them; ranks 2 and 3 sit out the flat-2 leg and rejoin):

- full-width ResNet-18 with the conv kernels, ZeRO-3, f32, at a global
  batch of 128 on the synthetic CIFAR-shape set, lr 0.01. One line a leg:
  its world and hosts, its first step's ms (a topology's first
  collectives set its NCCL communicators up) and the img/s of the rest on
  the host clock (synchronized at both ends; a short fixed run warms the
  card first), the losses; one line a resize: its seconds, each rank's
  resident parameter bytes (its bucket rows) after it and
  ``torch.cuda.max_memory_allocated`` over the leg before it. Beside it
  the same steps on the fixed world of 4: BatchNorm's statistics are per
  shard, so the losses differ with the world; the lap is held to
  finite losses that fall;
- JAX's BN-free tiny model (8x8x3, batch 16, two microbatches, lr 0.05):
  the lap's losses against the fixed world's, held within 1e-5.

Each lap's controller holds an ExecutionPlan (plan/, ZeRO-3 over the
flat ring of 4): every resize builds the mesh of ``derive_resized`` of
it. Then the trainer itself (``zoo.train``) runs full-width ResNet-18
under that plan with an elastic schedule 4 → 2 → 4 (the trainer keeps
its hosts), rank 0 journaling: one line prints its ``plan_step_cache``
records (world, hit or miss, the derived plan's fingerprint), held to a
miss at world 2 and a hit back at world 4, each fingerprint that of
``derive_resized(plan, world)``, and finite epoch losses.

The card's name and power limit come first. Exits non-zero when a check
fails. ``--device cpu`` runs the same over four gloo ranks (the kernels'
plain versions; no memory figure) at ``--batch-size``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Dict

import torch
import torch.distributed as dist

from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch import plan as plan_lib
from parallel_cnn_tpu_torch.config import (CommConfig, ElasticConfig, FusedStepConfig,
                                           ObsConfig)
from parallel_cnn_tpu_torch.data import synthetic
from parallel_cnn_tpu_torch.nn import Conv2D, Dense, Flatten, MaxPool, ReLU, Sequential, resnet
from parallel_cnn_tpu_torch.parallel import distributed
from parallel_cnn_tpu_torch.resilience.elastic import ElasticController
from parallel_cnn_tpu_torch.train import zoo
from parallel_cnn_tpu_torch.utils.backend import card_name_and_power_limit

WORLD = 4
BATCH = 128
LR = 0.01
MOMENTUM = 0.9
#: The lap: (world, hosts) of each leg.
LEGS = ((4, 1), (4, 2), (2, 1), (4, 1))
COMM = CommConfig(impl="ring")
ZERO3 = FusedStepConfig(update=True, act_dtype="float32", zero=3)
TINY_SHAPE = (8, 8, 3)
TINY_BATCH = 16
TINY_LR = 0.05
TINY_COMM = CommConfig(impl="ring", bucket_bytes=2048, overlap=True)
TINY_TOL = 1e-5
#: The trainer's lap: its worlds after each resize, and its step cache's
#: (world, hit) records: a miss at the new world, a hit back at 4.
TRAINER_WORLDS = (2, 4)
CACHE_WANT = [(2, False), (4, True)]


def _exec_plan(comm: CommConfig, accum: int) -> "plan_lib.ExecutionPlan":
    """The lap's ExecutionPlan: ZeRO-3 in f32 over the flat ring of 4."""
    return plan_lib.ExecutionPlan(
        data=WORLD, comm_impl=comm.impl, bucket_bytes=comm.bucket_bytes,
        overlap=comm.overlap, zero=3, fused=True, fused_update=True,
        act_dtype=ZERO3.act_dtype, accum=accum, param_sharding="zero3",
        opt_sharding="zero3").validate()


def _tiny() -> Sequential:
    return Sequential(Conv2D(3, 4, 3), ReLU(), MaxPool(), Flatten(), Dense(64, 10))


def _resident(state) -> int:
    return sum(r.numel() * r.element_size() for r in state.zero3.rows) if state else 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lap(mesh, build, batches, lr, accum, comm, elastic: bool) -> Dict:
    """The lap (``elastic``) or the fixed world over ``batches``: per leg
    (world, hosts, seconds, losses), per resize (seconds, resident bytes,
    peak memory of the leg before it)."""
    dev = mesh.device
    cuda = dev.type == "cuda"
    model = build().to(dev)
    opt = zoo.make_optimizer(lr, MOMENTUM)
    state, plan = zoo.init_zero3_state(model, opt, mesh=mesh, fused=ZERO3,
                                       bucket_bytes=comm.bucket_bytes)
    eplan = _exec_plan(comm, accum)
    ctl = (ElasticController(ElasticConfig(), world=WORLD, device=dev, exec_plan=eplan)
           if elastic else None)
    if ctl is not None:
        ctl.meshes[(WORLD, 1)] = mesh
    active, legs, resizes = mesh, [], []
    per_leg = len(batches) // len(LEGS)
    for leg, (world, hosts) in enumerate(LEGS):
        if elastic and leg:
            peak = torch.cuda.max_memory_allocated(dev) if cuda else None
            state, plan, active, comm = ctl.resize(
                leg * per_leg, world, state=state, comm=comm, n_hosts=hosts,
                model=model, optimizer=opt)
            resizes.append(dict(seconds=ctl.events[-1].seconds, resident=_resident(state),
                                peak=peak, to=(world, ctl.n_hosts)))
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        step = None
        if state is not None:
            step = zoo.make_zero3_train_step(model, lr=lr, momentum=MOMENTUM,
                                             accum_steps=accum, mesh=active,
                                             augment_pad=None, comm=comm, fused=ZERO3,
                                             plan=plan)
        _sync(dev)
        dist.barrier()
        stamps = [time.perf_counter()]
        losses = []
        for bx, by in batches[leg * per_leg:(leg + 1) * per_leg]:
            if step is not None:
                losses.append(step(state, bx, by))
            if len(stamps) == 1:  # the first step: a new group's set-up
                _sync(dev)
                stamps.append(time.perf_counter())
        _sync(dev)
        stamps.append(time.perf_counter())
        legs.append(dict(world=world if elastic else WORLD,
                         hosts=ctl.n_hosts if elastic else 1,
                         first=stamps[1] - stamps[0], seconds=stamps[2] - stamps[1],
                         losses=[float(v) for v in losses],
                         resident=_resident(state)))
        dist.barrier()
    return dict(legs=legs, resizes=resizes)


def _trainer_lap(mesh, steps: int, batch: int) -> Dict:
    """``zoo.train`` on full-width ResNet-18 under the ZeRO-3 plan over
    one epoch of 3 × ``steps`` steps, resized 4 → 2 → 4 by its schedule;
    rank 0 traces and returns its ``plan_step_cache`` and resize journal
    records, every rank its epoch loss."""
    n = 3 * steps * batch
    imgs, labels = synthetic.make_image_dataset(n, seed=99)
    schedule = ",".join(f"{(i + 1) * steps}:{w}" for i, w in enumerate(TRAINER_WORLDS))
    model = resnet.resnet18(10, backend="cuda", generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory(prefix="mesh_elastic_obs_") as obs_dir:
        bundle = (obs_lib.from_config(ObsConfig(trace=True, dir=obs_dir), run="lap")
                  if mesh.rank == 0 else obs_lib.NOOP)
        _, losses = zoo.train(
            model, imgs, labels, epochs=1, batch_size=batch, lr=LR, momentum=MOMENTUM,
            mesh=mesh, comm=COMM, fused=ZERO3, seed=0, verbose=False, obs=bundle,
            elastic=ElasticConfig(schedule=schedule), plan=_exec_plan(COMM, 1),
            device=mesh.device)
        paths = bundle.finish()
        out = {"losses": losses}
        if mesh.rank == 0:
            recs = obs_lib.read_journal(paths["journal"])
            out["cache"] = [r for r in recs if r["kind"] == "plan_step_cache"]
            out["resizes"] = [(r["old_world"], r["new_world"]) for r in recs
                              if r["kind"] == "resize_done"]
    return out


def _rank(mesh, steps: int, batch: int) -> Dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    n = steps * len(LEGS)
    imgs, labels = synthetic.make_image_dataset(n * batch, seed=1234)
    xs = torch.from_numpy(imgs).to(dev)
    ys = torch.from_numpy(labels).to(dev, torch.int64)
    batches = [(xs[i * batch:(i + 1) * batch], ys[i * batch:(i + 1) * batch])
               for i in range(n)]

    def r18():
        return resnet.resnet18(10, backend="cuda",
                               generator=torch.Generator().manual_seed(0))

    # Warm: the allocator, the kernels' first launches, NCCL's groups of
    # the spawned world (one step a leg, not reported).
    _lap(mesh, r18, batches[:len(LEGS)], LR, 1, COMM, False)
    out = {"r18_lap": _lap(mesh, r18, batches, LR, 1, COMM, True),
           "r18_fixed": _lap(mesh, r18, batches, LR, 1, COMM, False)}
    gen = torch.Generator().manual_seed(7)
    tx = torch.randn((n * TINY_BATCH,) + TINY_SHAPE, generator=gen).to(dev)
    ty = torch.randint(0, 10, (n * TINY_BATCH,), generator=gen).to(dev)
    tiny = [(tx[i * TINY_BATCH:(i + 1) * TINY_BATCH], ty[i * TINY_BATCH:(i + 1) * TINY_BATCH])
            for i in range(n)]

    def tiny_model():
        torch.manual_seed(7)
        return _tiny()

    out["tiny_lap"] = _lap(mesh, tiny_model, tiny, TINY_LR, 2, TINY_COMM, True)
    out["tiny_fixed"] = _lap(mesh, tiny_model, tiny, TINY_LR, 2, TINY_COMM, False)
    out["trainer"] = _trainer_lap(mesh, steps, batch)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mesh_elastic", description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=10, help="optimizer steps a leg (>= 2)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch-size", type=int, default=BATCH)
    args = p.parse_args(argv)
    if args.steps < 2:
        p.error("--steps must be >= 2 (the first step of a leg is timed apart)")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("mesh_elastic: no CUDA card", file=sys.stderr)
            return 1
        cards = torch.cuda.device_count()
        print(f"{card_name_and_power_limit()} x{cards}", flush=True)
        if cards < WORLD:
            print(f"[mesh_elastic] skipped: a world of {WORLD} needs {WORLD} cards, "
                  f"{cards} visible", flush=True)
            return 1
    res = distributed.run(_rank, WORLD, device=args.device, timeout=1800,
                          args=(args.steps, args.batch_size))
    lead = res[0]
    rc = 0
    for name, imgs in (("ResNet-18", args.batch_size), ("tiny BN-free", TINY_BATCH)):
        key = "r18" if name == "ResNet-18" else "tiny"
        lap, fixed = lead[f"{key}_lap"], lead[f"{key}_fixed"]
        rest = args.steps - 1
        for leg, fleg in zip(lap["legs"], fixed["legs"]):
            print(f"[mesh_elastic] {name} leg {leg['world']} ranks x{leg['hosts']} "
                  f"host(s): first step {leg['first'] * 1e3:.1f} ms, then "
                  f"{imgs * rest / leg['seconds']:.0f} img/s ({leg['seconds']:.3f} s for "
                  f"{rest} steps), losses {leg['losses']}; fixed world 4: first step "
                  f"{fleg['first'] * 1e3:.1f} ms, then {imgs * rest / fleg['seconds']:.0f} "
                  f"img/s, losses {fleg['losses']}", flush=True)
        for i, rz in enumerate(lap["resizes"]):
            resident = [r[f"{key}_lap"]["resizes"][i]["resident"] for r in res]
            peaks = [r[f"{key}_lap"]["resizes"][i]["peak"] for r in res]
            print(f"[mesh_elastic] {name} resize to {rz['to'][0]} ranks x{rz['to'][1]} "
                  f"host(s): {rz['seconds']:.4f} s on rank 0 "
                  f"({[r[f'{key}_lap']['resizes'][i]['seconds'] for r in res]} a rank); "
                  f"resident param bytes a rank after it {resident}"
                  + (f"; max_memory_allocated a rank over the leg before it {peaks} B"
                     if peaks[0] is not None else ""), flush=True)
        got = [v for leg in lap["legs"] for v in leg["losses"]]
        want = [v for leg in fixed["legs"] for v in leg["losses"]]
        drift = max(abs(a - b) for a, b in zip(got, want))
        ok = all(v == v and abs(v) < float("inf") for v in got)
        if key == "tiny":
            ok = ok and drift <= TINY_TOL
            print(f"[mesh_elastic] tiny BN-free lap vs fixed world 4: max |Δloss| "
                  f"{drift:.3e} (tol {TINY_TOL:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
        else:
            first, last = sum(got[:args.steps]), sum(got[-args.steps:])
            ok = ok and last < first
            print(f"[mesh_elastic] ResNet-18 lap: finite losses, mean of the last leg "
                  f"{last / args.steps:.4f} from the first's {first / args.steps:.4f}; "
                  f"max |Δloss| vs the fixed world {drift:.3e} (BN statistics are per "
                  f"shard: not gated) {'ok' if ok else 'FAIL'}", flush=True)
        rc |= 0 if ok else 1
    lap = lead["trainer"]
    eplan = _exec_plan(COMM, 1)
    fps = [plan_lib.derive_resized(eplan, w).fingerprint() for w, _ in CACHE_WANT]
    losses = [float(v) for r in res for v in r["trainer"]["losses"]]
    ok = ([(r["world"], r["hit"]) for r in lap["cache"]] == CACHE_WANT
          and [r["plan"] for r in lap["cache"]] == fps
          and lap["resizes"] == [(WORLD, 2), (2, WORLD)]
          and all(v == v and abs(v) < float("inf") for v in losses))
    print("[mesh_elastic] trainer ResNet-18 plan_step_cache: "
          + "; ".join(f"world {r['world']} {'hit' if r['hit'] else 'miss'} {r['plan']}"
                      for r in lap["cache"])
          + f" (derive_resized: {fps}); resizes {lap['resizes']}; epoch loss a rank "
          f"{losses} {'ok' if ok else 'FAIL'}", flush=True)
    return rc | (0 if ok else 1)


if __name__ == "__main__":
    sys.exit(main())
