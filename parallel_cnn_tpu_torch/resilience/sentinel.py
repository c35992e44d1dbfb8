"""Health sentinel: finiteness checks over loss, grads and params (the
port's ``parallel_cnn_tpu/resilience/sentinel.py``).

A NaN loss compares false against the stop threshold, so the reference
keeps training a dead model. The sentinel makes non-finiteness a detected
event; the trainer owns the response (config.ResilienceConfig.policy):
"raise" (DivergenceError), "skip" or "rollback" (resilience/rollback.py).
The tree check is one all-finite reduce per leaf and one readback, at the
epoch boundary where the trainer already synchronises. ``check_scaled`` is
the verdict for the update-on-arrival step, which skips a non-finite
update itself: a skip it counted, with the params still finite, is
healthy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from parallel_cnn_tpu_torch.utils.tree import tree_leaves


class DivergenceError(RuntimeError):
    """Training produced a non-finite loss/grad/param and policy='raise'."""


class RetriesExhaustedError(RuntimeError):
    """Auto-rollback gave up: the divergence recurred past max_rollbacks."""


def tree_all_finite(tree: Any) -> bool:
    """Every floating leaf of ``tree`` is finite (integer and bool leaves are
    finite by construction and skipped)."""
    checks = [
        torch.isfinite(leaf).all()
        for leaf in tree_leaves(tree)
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
    ]
    return bool(torch.stack(checks).all()) if checks else True


@dataclasses.dataclass(frozen=True)
class Verdict:
    healthy: bool
    reason: str = ""

    def __bool__(self) -> bool:
        return self.healthy


class Sentinel:
    """Stateless health checker. Cheapest first: the loss is a host float
    the epoch loop already read; the tree reduces run only when it is
    finite."""

    def check(
        self,
        *,
        loss: Optional[float] = None,
        grads: Any = None,
        params: Any = None,
    ) -> Verdict:
        if loss is not None and not math.isfinite(float(loss)):
            return Verdict(False, f"non-finite loss ({float(loss)})")
        for name, tree in (("grads", grads), ("params", params)):
            if tree is not None and not tree_all_finite(tree):
                return Verdict(False, f"non-finite {name}")
        return Verdict(True)

    def check_scaled(
        self,
        *,
        loss: Optional[float] = None,
        params: Any = None,
        skipped_before: int = 0,
        skipped_now: int = 0,
        scale: float = 1.0,
    ) -> Verdict:
        """``check`` for the update-on-arrival step (JAX's
        ``Sentinel.check_scaled``). The step drops an update whose
        gradient is not finite, in place, and counts it; if the skip
        counter advanced and the params are still finite, the non-finite
        loss was handled: healthy, with the reason attached. Anything the
        step did not absorb falls through to the usual verdict."""
        base = self.check(loss=loss, params=params)
        if base.healthy:
            return base
        if skipped_now > skipped_before and (
            params is None or tree_all_finite(params)
        ):
            return Verdict(
                True,
                "loss-scale overflow handled in-step: update skipped "
                f"({skipped_now - skipped_before}x), scale now {scale:g}",
            )
        return base
