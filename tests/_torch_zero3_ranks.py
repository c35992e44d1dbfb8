"""Rank programs for the port's ZeRO-3 and hierarchical-ring tests
(test_torch_zero3.py). parallel/distributed.run spawns one gloo world of
4 ranks and calls ``zero3_cases`` on every rank; the module imports torch
and the port only, since a spawned rank imports it afresh. Each case
builds its own mesh over the world: the flat data axis of 4, the (host,
data) mesh 2 × 2 (``make_hier_mesh``), the pairs (0, 1) and (2, 3) as
data axes of 2, and each rank alone. Inputs arrive as numpy arrays and
results go back as numpy arrays."""

import dataclasses

import torch
import torch.distributed as dist

from parallel_cnn_tpu_torch.config import CommConfig, FusedStepConfig
from parallel_cnn_tpu_torch.nn import BatchNorm, Conv2D, Dense, Flatten, MaxPool, ReLU, Sequential
from parallel_cnn_tpu_torch.parallel import collectives
from parallel_cnn_tpu_torch.parallel.mesh import DataMesh, make_hier_mesh
from parallel_cnn_tpu_torch.train import checkpoint, zoo

# JAX's ZeRO-3 tests' tiny model and schedule (tests/test_fused_step.py:
# 377-425, 509-530): 8x8x3 inputs, batch 16, accum 2, 2048-byte buckets,
# lr 0.05, momentum 0.9, 3 steps.
TINY_SHAPE = (8, 8, 3)
WORLD = 4
ACCUM, STEPS = 2, 3
BUCKET_BYTES = 2048
LR, MOMENTUM = 0.05, 0.9
RING = CommConfig(impl="ring", bucket_bytes=BUCKET_BYTES, overlap=True)
HIER = CommConfig(impl="hierarchical", bucket_bytes=BUCKET_BYTES, overlap=True,
                  hosts=2)
Z2 = FusedStepConfig(update=True, tail=True, act_dtype="float32")
Z3 = dataclasses.replace(Z2, zero=3)
Z3_BF16 = dataclasses.replace(Z3, act_dtype="bfloat16")


def tiny_model() -> Sequential:
    """Conv 4x3x3 → BatchNorm → ReLU → 2x2 max pool → Dense 10."""
    return Sequential(Conv2D(3, 4, 3), BatchNorm(4), ReLU(), MaxPool(), Flatten(),
                      Dense(64, 10))


def model_from(sd) -> Sequential:
    model = tiny_model()
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    return model


def _numpy(arrays):
    return {k: v.detach().cpu().numpy().copy() for k, v in arrays.items()}


def _steps(state, step, x, y, n=STEPS):
    return [float(step(state, x, y)) for _ in range(n)]


def zero3(mesh, sd, comm, fused=Z3):
    """A ZeRO-3 state and step for the tiny model from ``sd`` on ``mesh``."""
    model = model_from(sd)
    state, plan = zoo.init_zero3_state(model, zoo.make_optimizer(LR, MOMENTUM),
                                       mesh=mesh, fused=fused,
                                       bucket_bytes=BUCKET_BYTES)
    step = zoo.make_zero3_train_step(model, lr=LR, momentum=MOMENTUM,
                                     accum_steps=ACCUM, mesh=mesh, augment_pad=None,
                                     comm=comm, fused=fused, plan=plan)
    return state, step


def _storage_free(model) -> bool:
    return all(p.untyped_storage().nbytes() == 0 for p in model.parameters())


def _collective_cases(hier, spec):
    """The hierarchical collectives at 2 × 2 on this rank's inputs, f32
    and a bf16 wire."""
    r = dist.get_rank()
    out = {}
    for wire in (None, "bfloat16"):
        x = torch.from_numpy(spec["full"][r].copy())
        s = torch.from_numpy(spec["shard"][r].copy())
        tag = wire or "f32"
        out[f"rs_{tag}"] = collectives.hier_reduce_scatter(x, hier.host, hier.data, wire)
        out[f"ag_{tag}"] = collectives.hier_all_gather(s, hier.host, hier.data, wire)
        out[f"ar_{tag}"] = collectives.hier_all_reduce(x, hier.host, hier.data, wire)
    tree = {"a": torch.from_numpy(spec["full"][r][:37].copy()),
            "b": torch.from_numpy(spec["full"][r][37:40].copy())}
    got = collectives.tree_all_reduce(tree, hier.data, CommConfig(
        impl="hierarchical", bucket_bytes=64, hosts=2), host=hier.host)
    out.update({f"tree_{k}": v for k, v in got.items()})
    return _numpy(out)


def _round_trip(sd, view, meshes):
    """``view`` laid out on each mesh (a fresh ZeRO-3 state there) and
    gathered back: {name: (this rank's rows, the view again)}."""
    out = {}
    for name, mesh, comm in meshes:
        fresh, _ = zero3(mesh, sd, comm)
        zoo.zero3_from_view(fresh, view)
        rows = [r.numpy().copy() for r in fresh.zero3.rows]
        out[name] = (rows, _numpy(zoo.zero3_full_view(fresh)))
    return out


def zero3_cases(mesh: DataMesh, spec):
    """Every case on this rank of the world of 4; returns {case: result}."""
    torch.set_num_threads(1)
    rank, dev = mesh.rank, mesh.device
    hier = make_hier_mesh(rank, WORLD, dev, 2)
    # The pairs (0, 1) and (2, 3) as data axes of 2; made on every rank.
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = DataMesh(2, rank % 2, dev, line=(rank - rank % 2, rank - rank % 2 + 1),
                    line_group=pairs[rank // 2])
    alone = DataMesh(1, 0, dev)
    sd = spec["sd"]
    x = torch.from_numpy(spec["x"])
    y = torch.from_numpy(spec["y"]).long()
    out = {"layout": (hier.host.size, hier.host.index, hier.host.ranks,
                      hier.data.size, hier.data.index, hier.data.ranks),
           "batch_rows": hier.shard_rows(torch.arange(16)).numpy()}
    out["coll"] = _collective_cases(hier, spec)

    # ZeRO-3 flat at D = 4, f32: 3 steps; the rows and storage between
    # steps; the full view.
    state, step = zero3(mesh, sd, RING)
    out["rows_shapes"] = [tuple(r.shape) for r in state.zero3.rows]
    out["mom_shapes"] = [tuple(m.shape) for m in state.fused.mom]
    out["bucket_sizes"] = state.zero3.plan.bucket_sizes
    free = [_storage_free(state.model)]
    out["z3_losses"] = []
    for _ in range(STEPS):
        out["z3_losses"].append(float(step(state, x, y)))
        free.append(_storage_free(state.model))
    out["storage_free"] = free
    view = zoo.zero3_full_view(state)
    out["z3_view"] = _numpy(view)
    out["z3_rows"] = [r.numpy().copy() for r in state.zero3.rows]

    # ZeRO-2 at D = 4 from the same init.
    model = model_from(sd)
    z2, _ = zoo.init_fused_state(model, zoo.make_optimizer(LR, MOMENTUM), mesh=mesh,
                                 fused=Z2, bucket_bytes=BUCKET_BYTES)
    z2_step = zoo.make_fused_train_step(model, lr=LR, momentum=MOMENTUM,
                                        accum_steps=ACCUM, mesh=mesh, augment_pad=None,
                                        comm=RING, fused=Z2)
    out["z2_losses"] = _steps(z2, z2_step, x, y)
    out["z2_sd"] = _numpy(model.state_dict())

    # Hierarchical ZeRO-3 at 2 x 2.
    hstate, hstep = zero3(hier, sd, HIER)
    out["hier_losses"] = _steps(hstate, hstep, x, y)
    out["hier_view"] = _numpy(zoo.zero3_full_view(hstate))
    out["hier_rows"] = [r.numpy().copy() for r in hstate.zero3.rows]

    # bf16 activations (dynamic scale) at D = 4, and the unfused ring step.
    bstate, bstep = zero3(mesh, sd, RING, Z3_BF16)
    out["bf16_losses"] = _steps(bstate, bstep, x, y)
    model = model_from(sd)
    opt = zoo.make_optimizer(LR, MOMENTUM)
    ustate = zoo.init_state(model, opt)
    ustep = zoo.make_train_step(model, opt, ACCUM, mesh=mesh, comm=RING)
    out["unfused_losses"] = _steps(ustate, ustep, x, y)

    # Overflow (bf16): one clean step, then an inf in x, then a clean step.
    ostate, ostep = zero3(mesh, sd, RING, Z3_BF16)
    ostep(ostate, x, y)
    out["inf_before"] = _numpy(ostate.arrays())
    out["inf_loss"] = float(ostep(ostate, torch.from_numpy(spec["x_inf"]), y))
    out["inf_after"] = _numpy(ostate.arrays())
    ostep(ostate, x, y)
    out["clean_after"] = _numpy(ostate.arrays())

    # The hierarchical comm step (not fused) at 2 x 2, psum over its two
    # axes, and the flat ring at 4.
    for name, m, comm in (("comm_hier", hier, HIER), ("comm_flat", mesh, RING),
                          ("comm_hier_psum", hier, CommConfig(impl="psum"))):
        model = model_from(sd)
        opt = zoo.make_optimizer(LR, MOMENTUM)
        st = zoo.init_state(model, opt)
        stp = zoo.make_train_step(model, opt, ACCUM, mesh=m, comm=comm)
        out[name] = (_steps(st, stp, x, y), _numpy(model.state_dict()))

    # Views: the flat-4 view laid out on worlds 1, 2, 4 and hosts 2, and
    # gathered back.
    out["round_trip"] = _round_trip(sd, view, (
        ("world1", alone, RING), ("world2", pair, RING), ("world4", mesh, RING),
        ("hosts2", hier, HIER)))

    # A sharded checkpoint written at world 4, restored at world 2.
    if rank == 0:
        checkpoint.save_sharded(spec["ckpt"], view, checkpoint.TrainState(epoch=3),
                                world_size=WORLD, bucket_bytes=BUCKET_BYTES)
    dist.barrier()
    pstate, _ = zero3(pair, sd, RING)
    got, tstate, zmeta = checkpoint.restore_sharded(spec["ckpt"], zoo.zero3_full_view(pstate))
    zoo.zero3_from_view(pstate, got)
    out["restored_at_2"] = (tstate.epoch, zmeta, _numpy(zoo.zero3_full_view(pstate)))
    # A JAX-written file, laid out at 2 x 2.
    jstate, _ = zero3(hier, sd, HIER)
    got, tstate, zmeta = checkpoint.restore_sharded(spec["jax_ckpt"],
                                                    zoo.zero3_full_view(jstate))
    zoo.zero3_from_view(jstate, got)
    out["jax_file"] = (_numpy(got), zmeta, [r.numpy().copy() for r in jstate.zero3.rows])
    return out
