"""Rank programs for the port's elastic tests (test_torch_elastic.py).
parallel/distributed.run spawns one gloo world of 4 ranks and calls
``elastic_cases`` on every rank; the module imports torch and the port
only, since a spawned rank imports it afresh. Every resize is made by
every rank (the controller's agreement and group creation are
collectives over the spawned world); a rank outside the world holds no
state. Inputs arrive as numpy arrays and results go back as numpy
arrays."""

import torch
import torch.distributed as dist

from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.config import (
    CommConfig,
    ElasticConfig,
    FusedStepConfig,
    ObsConfig,
)
from parallel_cnn_tpu_torch.nn import Conv2D, Dense, Flatten, MaxPool, ReLU, Sequential
from parallel_cnn_tpu_torch.parallel import mesh as mesh_lib
from parallel_cnn_tpu_torch.resilience import chaos as chaos_lib
from parallel_cnn_tpu_torch.resilience.elastic import ElasticController, ElasticError
from parallel_cnn_tpu_torch.resilience.rollback import CheckpointRing
from parallel_cnn_tpu_torch.train import checkpoint, zoo

# JAX's elastic tests' tiny BN-free model and schedule
# (tests/test_elastic.py:51-95): 8x8x3 inputs, batch 16, accum 2,
# 2048-byte buckets, lr 0.05, momentum 0.9, f32 activations.
TINY_SHAPE = (8, 8, 3)
WORLD = 4
ACCUM = 2
BUCKET_BYTES = 2048
LR, MOMENTUM = 0.05, 0.9
COMM = CommConfig(impl="ring", bucket_bytes=BUCKET_BYTES, overlap=True)
FUSED = FusedStepConfig(update=True, tail=True, act_dtype="float32", zero=3)
# The lap: before step 2 to (host 2 x 2), before step 4 to a flat 2, and
# back to a flat 4 after the last step (tests/test_elastic.py:119-160 on
# a world of 4 for JAX's 8).
LAPS = {2: (4, 2), 4: (2, 1)}
CLOSE = (4, 1)


def nobn_model() -> Sequential:
    """Conv 4x3x3 → ReLU → 2x2 max pool → Dense 10 (no BatchNorm: the
    second parity precondition)."""
    return Sequential(Conv2D(3, 4, 3), ReLU(), MaxPool(), Flatten(), Dense(64, 10))


def model_from(sd) -> Sequential:
    model = nobn_model()
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    return model


def _np(tree):
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def _init(mesh, sd):
    model = model_from(sd)
    opt = zoo.make_optimizer(LR, MOMENTUM)
    state, plan = zoo.init_zero3_state(model, opt, mesh=mesh, fused=FUSED,
                                       bucket_bytes=BUCKET_BYTES)
    return model, opt, state, plan


def _step(model, mesh, comm, plan, lr=LR):
    return zoo.make_zero3_train_step(model, lr=lr, momentum=MOMENTUM, accum_steps=ACCUM,
                                     mesh=mesh, augment_pad=None, comm=comm,
                                     fused=FUSED, plan=plan)


def _controller(mesh, **kw):
    ctl = ElasticController(ElasticConfig(), world=WORLD, **kw)
    ctl.meshes[(WORLD, 1)] = mesh
    return ctl


def _resize(ctl, step, world, state, model, opt, comm, n_hosts=None):
    """One resize on every rank: (state or None, plan, mesh, comm)."""
    return ctl.resize(step, world, state=state, comm=comm, n_hosts=n_hosts,
                      model=model, optimizer=opt)


def _lap(mesh, spec):
    """Six steps with the LAPS resizes and the closing one, against the
    same six on the fixed world of 4."""
    batches = [(torch.from_numpy(spec["x"][i * 16:(i + 1) * 16]),
                torch.from_numpy(spec["y"][i * 16:(i + 1) * 16]).long())
               for i in range(6)]
    model, _, st, plan = _init(mesh, spec["sd"])
    step = _step(model, mesh, COMM, plan)
    fixed = [float(step(st, bx, by)) for bx, by in batches]
    fixed_params = _np(zoo.zero3_full_params(st))

    model, opt, st, plan = _init(mesh, spec["sd"])
    ctl = _controller(mesh)
    groups = []
    real_new_group = dist.new_group

    def counting_new_group(*a, **kw):
        groups.append(a[0] if a else kw.get("ranks"))
        return real_new_group(*a, **kw)

    dist.new_group = counting_new_group
    try:
        step, comm, elastic = _step(model, mesh, COMM, plan), COMM, []
        for i, (bx, by) in enumerate(batches):
            if i in LAPS:
                world, hosts = LAPS[i]
                st, plan, m, comm = _resize(ctl, i, world, st, model, opt, comm,
                                            n_hosts=hosts)
                step = _step(model, m, comm, plan) if m is not None else None
            elastic.append(float(step(st, bx, by)) if step is not None else None)
        st, plan, m, comm = _resize(ctl, 6, CLOSE[0], st, model, opt, comm,
                                    n_hosts=CLOSE[1])
    finally:
        dist.new_group = real_new_group
    return dict(fixed=fixed, fixed_params=fixed_params, elastic=elastic,
                events=[(e.new_world, e.new_hosts, e.source) for e in ctl.events],
                elastic_params=_np(zoo.zero3_full_params(st)),
                comm=(comm.impl, comm.hosts), new_groups=len(groups),
                topologies=sorted(ctl.meshes))


def _reshard_chain(mesh, spec, steps):
    """``steps`` steps at 4, then zero-step resizes 4 → 2 → (2, 2) → 1 →
    4: rank 0's view after each (the lead is always in the world)."""
    model, opt, st, plan = _init(mesh, spec["sd"])
    step = _step(model, mesh, COMM, plan)
    x, y = torch.from_numpy(spec["x"][:16]), torch.from_numpy(spec["y"][:16]).long()
    for _ in range(steps):
        step(st, x, y)
    ctl = _controller(mesh)
    views = [_np(zoo.zero3_full_view(st))]
    comm, impls = COMM, []
    for world, hosts in ((2, 1), (4, 2), (1, 1), (4, 1)):
        st, plan, m, comm = _resize(ctl, 0, world, st, model, opt, comm, n_hosts=hosts)
        impls.append((comm.impl, comm.hosts, type(m).__name__))
        if st is not None:
            views.append(_np(zoo.zero3_full_view(st)))
    return dict(views=views, impls=impls)


def _ring_fallback(mesh, spec):
    """A live snapshot made to fail: the resize restores the ring's newest
    sharded file (rank 0's ring), bit for bit; with no ring, JAX's
    ElasticError on every rank."""
    rank = dist.get_rank()
    model, opt, st, plan = _init(mesh, spec["sd"])
    x, y = torch.from_numpy(spec["x"][:16]), torch.from_numpy(spec["y"][:16]).long()
    _step(model, mesh, COMM, plan)(st, x, y)
    view = zoo.zero3_full_view(st)
    ring = None
    if rank == 0:
        ring = CheckpointRing(spec["ring_dir"], keep=0)
        checkpoint.save_sharded(ring.path_for(0), view, world_size=WORLD,
                                bucket_bytes=BUCKET_BYTES)
    dist.barrier()
    ctl = _controller(mesh, ring=ring)
    ctl.register_template(view)
    real = zoo.zero3_full_view

    def boom(*a, **k):
        raise RuntimeError("shard buffers deleted (device lost)")

    zoo.zero3_full_view = boom
    try:
        st2, plan2, m2, comm2 = _resize(ctl, 1, 2, st, model, opt, COMM)
    finally:
        zoo.zero3_full_view = real
    out = dict(from_ring=ctl.events[-1].from_ring, shards=plan2.shards if plan2 else None,
               view=_np(view))
    if st2 is not None:
        out["restored"] = _np(zoo.zero3_full_view(st2))
    # No ring at all: every rank raises the typed error.
    model, opt, st, plan = _init(mesh, spec["sd"])
    ctl2 = _controller(mesh)
    zoo.zero3_full_view = boom
    try:
        _resize(ctl2, 1, 2, st, model, opt, COMM)
        out["no_ring"] = None
    except ElasticError as e:
        out["no_ring"] = str(e)
    finally:
        zoo.zero3_full_view = real
    return out


def _journal(mesh, spec):
    """resize_begin / resize_done across 4 → 2 → 4 (rank 0 journals)."""
    rank = dist.get_rank()
    bundle = (obs_lib.from_config(ObsConfig(trace=True, dir=spec["obs_dir"]),
                                  run="elastic") if rank == 0 else obs_lib.NOOP)
    model, opt, st, plan = _init(mesh, spec["sd"])
    ctl = _controller(mesh, obs=bundle)
    st, plan, _, comm = _resize(ctl, 0, 2, st, model, opt, COMM)
    _resize(ctl, 1, 4, st, model, opt, comm)
    paths = bundle.finish()
    if rank != 0:
        return None
    recs = obs_lib.read_journal(paths["journal"])
    return [r for r in recs if r["kind"].startswith("resize_")]


def _trained(mesh, spec, **kw):
    model = model_from(spec["sd0"])
    st, losses = zoo.train(model, spec["x"][:64], spec["y"][:64], epochs=2,
                           batch_size=16, lr=LR, momentum=MOMENTUM,
                           accum_steps=ACCUM, mesh=mesh, comm=COMM, fused=FUSED,
                           seed=0, verbose=False, loader="native", **kw)
    params = _np(zoo.zero3_full_params(st)) if st.zero3 is not None else None
    return dict(losses=losses, params=params,
                shards=st.zero3.plan.shards if st.zero3 is not None else None,
                rows=[tuple(r.shape) for r in st.zero3.rows] if st.zero3 else None)


def _topologies(spec):
    """Each (world, hosts) mesh's layout on this rank, and the cache:
    the second call of a topology returns the same view, making no
    group."""
    cache = {}
    out = {}
    for world, hosts in ((1, 1), (2, 1), (3, 1), (4, 1), (2, 2), (4, 2), (3, 2)):
        m = mesh_lib.make_elastic_mesh(world, n_hosts=hosts, cache=cache)
        if m is None:
            out[(world, hosts)] = None
        elif isinstance(m, mesh_lib.HierMesh):
            out[(world, hosts)] = ("hier", m.host.size, m.host.index, m.host.ranks,
                                   m.data.size, m.data.index, m.data.ranks)
        else:
            out[(world, hosts)] = ("flat", m.size, m.index, m.ranks)
    again = [mesh_lib.make_elastic_mesh(w, n_hosts=h, cache=cache) is cache[(w, h if w % h == 0 else 1)]
             for w, h in ((2, 1), (4, 2))]
    try:
        mesh_lib.make_elastic_mesh(5)
        too_big = None
    except ValueError as e:
        too_big = str(e)
    return dict(layouts=out, cached=again, too_big=too_big)


def elastic_cases(mesh, spec):
    """Every case on this rank of the world of 4; returns {case: result}."""
    torch.set_num_threads(1)
    out = {"topologies": _topologies(spec)}
    out["lap"] = _lap(mesh, spec)
    out["chain0"] = _reshard_chain(mesh, spec, 0)
    out["chain1"] = _reshard_chain(mesh, spec, 1)
    out["ring"] = _ring_fallback(mesh, spec)
    out["journal"] = _journal(mesh, spec)
    out["train_fixed"] = _trained(mesh, spec)
    out["train_schedule"] = _trained(mesh, spec,
                                     elastic=ElasticConfig(schedule="2:2,5:4"))
    out["train_chaos"] = _trained(mesh, spec, elastic=ElasticConfig(),
                                  chaos=chaos_lib.ChaosMonkey.from_spec("resize@1:-2"))
    try:  # a world of 3 cannot take the global batch of 16
        _trained(mesh, spec, elastic=ElasticConfig(schedule="1:3"))
        out["train_world3"] = None
    except ValueError as e:
        out["train_world3"] = str(e)
    return out
