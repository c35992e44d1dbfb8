"""Rank programs for the port's LeNet-ref mesh tests (test_torch_parallel.py).
parallel/distributed.run spawns each world of ranks with the plan of its
(data, model) mesh and calls one of these on every rank; the module imports torch
and the port only, since a spawned rank imports it afresh. Inputs arrive
as numpy arrays and results go back as numpy arrays."""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from parallel_cnn_tpu_torch import cli
from parallel_cnn_tpu_torch.config import CommConfig, Config, TrainConfig
from parallel_cnn_tpu_torch.data import pipeline
from parallel_cnn_tpu_torch.parallel import data_parallel, intra_op
from parallel_cnn_tpu_torch.train import checkpoint, trainer

DT = 0.1
STEPS = 2
BUCKET_BYTES = 2048  # a few buckets over LeNet's 2,572 grads
COMMS = {
    "none": None,
    "psum": CommConfig(impl="psum"),
    "ring": CommConfig(impl="ring", bucket_bytes=BUCKET_BYTES),
    "ring_bf16": CommConfig(impl="ring", bucket_bytes=BUCKET_BYTES,
                            wire_dtype="bfloat16"),
}


def _tensors(tree):
    return {k: {n: torch.from_numpy(np.array(v, copy=True)) for n, v in leaves.items()}
            for k, leaves in tree.items()}


def _numpy(tree):
    return {k: {n: v.detach().cpu().numpy().copy() for n, v in leaves.items()}
            for k, leaves in tree.items()}


def _coords(mesh):
    return dict(rank=mesh.rank, data=(mesh.data.index, mesh.data.ranks),
                model=(mesh.model.index, mesh.model.ranks))


def _steps(step, params, x, y, steps=STEPS):
    errs = []
    for _ in range(steps):
        params, e = step(params, x, y)
        errs.append(float(e))
    return params, errs


def _cli_args(argv):
    args = cli.build_parser().parse_args(argv)
    return args, cli.config_from_args(args)


def dp_cases(mesh, spec):
    """On a (2, 1) mesh: ``make_dp_step`` STEPS steps with every comm of
    COMMS, ``make_dp_eval`` with a pad mask, ``make_dp_epoch``, and the
    CLI's LeNet job run straight for 2 epochs and as 1 epoch + resume."""
    torch.set_num_threads(1)
    params = _tensors(spec["params"])
    x = mesh.shard_rows(torch.from_numpy(spec["x"]))
    y = mesh.shard_rows(torch.from_numpy(spec["y"]))
    res = {"coords": _coords(mesh)}
    for name, comm in COMMS.items():
        step = data_parallel.make_dp_step(mesh, DT, spec["x"].shape[0], comm=comm)
        p, errs = _steps(step, params, x, y)
        res[name] = (_numpy(p), errs)
    try:
        data_parallel.make_dp_step(mesh, DT, 2 * spec["x"].shape[0])(params, x, y)
    except ValueError as e:
        res["batch_error"] = str(e)

    ev = data_parallel.make_dp_eval(mesh)
    res["eval"] = int(ev(params, x, mesh.shard_rows(torch.from_numpy(spec["y_bad"])),
                         mesh.shard_rows(torch.from_numpy(spec["mask"]))))

    epoch = data_parallel.make_dp_epoch(mesh, DT, spec["epoch_x"].shape[1])
    ex = torch.stack([mesh.shard_rows(b) for b in torch.from_numpy(spec["epoch_x"])])
    ey = torch.stack([mesh.shard_rows(b) for b in torch.from_numpy(spec["epoch_y"])])
    p, err = epoch(params, ex, ey)
    res["epoch"] = (_numpy(p), float(err))

    # Resume through the CLI's job: 2 epochs straight, then 1 + 1 resumed.
    base = ["--device", "cpu", "--loader", "synthetic", "--batch-size", "16",
            "--shuffle", "--synthetic-train-count", "256",
            "--synthetic-test-count", "64", "--comm-impl", "ring"]
    for argv in (["--epochs", "2", "--checkpoint-dir", spec["straight"]],
                 ["--epochs", "1", "--checkpoint-dir", spec["split"]],
                 ["--epochs", "2", "--checkpoint-dir", spec["split"], "--resume"]):
        cli._lenet_job(mesh, *_cli_args(base + argv))
        dist.barrier()  # rank 0's checkpoint is on disk for every rank
    return res


def model_axis_cases(mesh, spec):
    """On a mesh with a model axis: ``shard_params`` and its inverse, and
    ``make_2d_step`` (STEPS steps, ``spec["comm"]``) and ``make_2d_forward``
    from the whole params; with ``spec["ckpt"]``, one epoch of
    ``trainer.learn`` on the mesh whose epoch callback saves the whole
    params there from rank 0."""
    torch.set_num_threads(1)
    whole = _tensors(spec["params"])
    params = intra_op.shard_params(mesh, whole)
    x = mesh.shard_rows(torch.from_numpy(spec["x"]))
    y = mesh.shard_rows(torch.from_numpy(spec["y"]))
    res = {"coords": _coords(mesh), "shard": _numpy(params)}
    gathered = intra_op.gather_params(mesh, params)
    res["gather_exact"] = all(torch.equal(gathered[k][n], whole[k][n])
                              for k in whole for n in whole[k])
    comm = COMMS[spec["comm"]]
    step = intra_op.make_2d_step(mesh, DT, spec["x"].shape[0], comm=comm)
    p, errs = _steps(step, params, x, y)
    res["step"] = (_numpy(intra_op.gather_params(mesh, p)), errs)
    res["forward"] = intra_op.make_2d_forward(mesh)(params, x).numpy().copy()
    if spec.get("ckpt"):
        cfg = Config(train=TrainConfig(batch_size=16, epochs=1, shuffle=True),
                     comm=comm)
        ds = pipeline.Dataset(spec["train_x"], spec["train_y"])

        def save(epoch, whole_params, err):
            if mesh.rank == 0:
                checkpoint.save(spec["ckpt"], whole_params,
                                checkpoint.TrainState(epoch=epoch, epoch_errors=[err]))

        out = trainer.learn(cfg, ds, params=whole, verbose=False, epoch_callback=save,
                            device="cpu", mesh=mesh)
        res["learned"] = _numpy(out.params)
        dist.barrier()
        res["ckpt_exists"] = os.path.exists(spec["ckpt"])
    if spec.get("poison_at") is not None:
        res["rollback"] = _rollback(mesh, spec)
    return res


def _rollback(mesh, spec):
    """Two epochs under the rollback policy, a NaN written into the last
    rank's params shard alone after step ``spec["poison_at"]`` (the last of
    epoch 1, so the loss stays finite): the verdict is agreed over the
    world, so every rank rolls the epoch back and retries it at half the
    step."""
    cfg = Config(train=TrainConfig(batch_size=16, epochs=2),
                 resilience=dataclasses.replace(Config().resilience, policy="rollback"))
    ds = pipeline.Dataset(spec["train_x"], spec["train_y"])
    calls = []
    real = intra_op.make_2d_step

    def poisoning(*a, **kw):
        step = real(*a, **kw)

        def poisoned_step(p, x, y):
            p, e = step(p, x, y)
            if len(calls) == spec["poison_at"] and mesh.rank == mesh.world - 1:
                p["c1"]["w"][0, 0, 0] = float("nan")
            calls.append(1)
            return p, e
        return poisoned_step

    intra_op.make_2d_step = poisoning
    try:
        out = trainer.learn(cfg, ds, params=_tensors(spec["params"]), verbose=False,
                            device="cpu", mesh=mesh)
    finally:
        intra_op.make_2d_step = real
    return dict(rollbacks=out.rollbacks, errors=out.epoch_errors,
                params=_numpy(out.params))


