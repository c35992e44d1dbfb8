"""Image augmentation for the zoo trainer: CIFAR-style random crop and
horizontal flip (the port's counterpart of
``parallel_cnn_tpu/data/augment.py``).

JAX draws the crop offsets and flips from a ``jax.random`` key inside the
jitted step. The port splits the transform in two so both packages can be
fed the same draws: ``crop_flip(x, offsets, flips)`` is the deterministic
transform (gathers on ``x``'s device, no atomics), and
``random_crop_flip(generator, x, pad)`` draws its inputs from a
``torch.Generator``. The generators differ, so the two packages augment
the same seed differently; each is reproducible on its own.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def crop_flip(x: torch.Tensor, offsets: torch.Tensor, flips: torch.Tensor,
              pad: int = 4) -> torch.Tensor:
    """Zero-pad each side of NHWC ``x`` by ``pad``, take image i's H×W
    window at ``offsets[i] = (row, col)`` (each in [0, 2·pad]), then mirror
    the images whose ``flips[i]`` is true. Shape and dtype are kept."""
    b, h, w, _ = x.shape
    if pad:
        xp = F.pad(x, (0, 0, pad, pad, pad, pad))
        rows = offsets[:, :1] + torch.arange(h, device=x.device)      # (b, h)
        cols = offsets[:, 1:] + torch.arange(w, device=x.device)      # (b, w)
    else:
        xp = x
        rows = torch.arange(h, device=x.device).expand(b, h)
        cols = torch.arange(w, device=x.device).expand(b, w)
    cols = torch.where(flips[:, None], cols.flip(1), cols)
    idx = torch.arange(b, device=x.device)[:, None, None]
    return xp[idx, rows[:, :, None], cols[:, None, :]]


def draw(generator: torch.Generator, batch: int,
         pad: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets (batch, 2) int64 in [0, 2·pad], flips (batch,) bool), drawn
    on the CPU from ``generator``."""
    offsets = torch.randint(0, 2 * pad + 1, (batch, 2), generator=generator)
    flips = torch.rand((batch,), generator=generator) < 0.5
    return offsets, flips


def random_crop_flip(generator: torch.Generator, x: torch.Tensor,
                     pad: int = 4) -> torch.Tensor:
    """Pad-and-random-crop by ``pad`` pixels plus a 50% horizontal mirror,
    the draws from ``generator`` (``pad=0`` is flip-only)."""
    offsets, flips = draw(generator, x.shape[0], pad)
    return crop_flip(x, offsets.to(x.device), flips.to(x.device), pad)
