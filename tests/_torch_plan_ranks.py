"""Rank program for the port's ExecutionPlan tests (test_torch_plan.py).
parallel/distributed.run spawns one gloo world of 4 ranks, each making
its mesh from the plan it was handed (``plan=``), and calls
``elastic_step_cache`` on every rank; the module imports torch and the
port only, since a spawned rank imports it afresh."""

import torch

import _torch_elastic_ranks as eranks
from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.config import ElasticConfig, ObsConfig
from parallel_cnn_tpu_torch.train import zoo

#: A 4 → 2 → 4 lap over the 8 optimizer steps of 2 epochs of 64 images.
SCHEDULE = "2:2,5:4"


def elastic_step_cache(mesh, spec):
    """zoo.train under ``spec["plan"]`` on JAX's tiny BN-free model with
    the lap, then the same lap with no plan (no step cache); rank 0
    returns its ``plan_step_cache`` and resize journal records, every rank
    both runs' epoch losses."""
    torch.set_num_threads(1)
    rank = mesh.rank
    bundle = (obs_lib.from_config(ObsConfig(trace=True, dir=spec["obs_dir"]),
                                  run="plan") if rank == 0 else obs_lib.NOOP)
    _, losses = zoo.train(
        eranks.model_from(spec["sd0"]), spec["x"], spec["y"], epochs=2,
        batch_size=16, lr=eranks.LR, momentum=eranks.MOMENTUM,
        accum_steps=eranks.ACCUM, mesh=mesh, comm=eranks.COMM,
        fused=eranks.FUSED, seed=0, verbose=False, obs=bundle,
        elastic=ElasticConfig(schedule=SCHEDULE), plan=spec["plan"],
        loader="native", device="cpu")
    paths = bundle.finish()
    # The same lap without a plan rebuilds the step at every resize.
    _, rebuilt = zoo.train(
        eranks.model_from(spec["sd0"]), spec["x"], spec["y"], epochs=2,
        batch_size=16, lr=eranks.LR, momentum=eranks.MOMENTUM,
        accum_steps=eranks.ACCUM, mesh=mesh, comm=eranks.COMM,
        fused=eranks.FUSED, seed=0, verbose=False,
        elastic=ElasticConfig(schedule=SCHEDULE), loader="native", device="cpu")
    out = {"losses": losses, "rebuilt": rebuilt, "mesh": type(mesh).__name__}
    if rank == 0:
        recs = obs_lib.read_journal(paths["journal"])
        out["cache"] = [r for r in recs if r["kind"] == "plan_step_cache"]
        out["resizes"] = [(r["old_world"], r["new_world"]) for r in recs
                          if r["kind"] == "resize_done"]
    return out
