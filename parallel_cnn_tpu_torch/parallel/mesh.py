"""The port's data-parallel "mesh" (the counterpart of
``parallel_cnn_tpu/parallel/mesh.py`` for its ``data`` axis).

JAX builds one ``Mesh`` of devices inside one process and runs a step as a
``shard_map`` over it. The port runs one process per rank instead, each
with a ``torch.distributed`` process group (parallel/distributed.py
starts them), and a ``DataMesh`` is what one rank knows of the whole: the
world size, its rank and its device. ``shard_rows`` takes the rank's
contiguous block of a global batch, which is what JAX's ``P(DATA_AXIS)``
gives device ``r``: rows ``[r·B/n, (r+1)·B/n)``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data axis. The collectives run over the
    default process group, which holds every rank."""

    world: int
    rank: int
    device: torch.device

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of {self.world}")

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of rows of a global batch."""
        n = x.shape[0]
        if n % self.world:
            raise ValueError(
                f"global batch {n} does not divide over {self.world} ranks "
                "(no silent sample dropping)"
            )
        per = n // self.world
        return x[self.rank * per:(self.rank + 1) * per]
