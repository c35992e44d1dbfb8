"""Rank program for the port's async tests (test_torch_async.py):
parallel/distributed.run spawns one gloo world of 4 ranks and calls
``easgd_round_case`` on every rank. Torch and the port only."""

import torch

from parallel_cnn_tpu_torch.train import async_dp


def easgd_round_case(mesh, spec):
    """One sharded elastic round on this rank's worker params and center
    shard: (new worker params, new center shard) as numpy arrays."""
    torch.set_num_threads(1)
    r = mesh.rank
    w = torch.from_numpy(spec["worker"][r].copy())
    c = torch.from_numpy(spec["center"][r].copy())
    nw, nc = async_dp.easgd_round_sharded(
        w, c, torch.tensor(spec["rho"], dtype=torch.float32), mesh=mesh)
    return nw.numpy().copy(), nc.numpy().copy()
