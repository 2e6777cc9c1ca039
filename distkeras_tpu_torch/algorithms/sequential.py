"""Sequential (no-op) and one-shot-averaging rules — the port of
:mod:`distkeras_tpu.algorithms.sequential`.

``Sequential`` backs ``SingleTrainer`` (plain local SGD, no parameter
server).  ``OneShotAverage`` averages the workers' weights once.
"""

from __future__ import annotations

import dataclasses

from distkeras_tpu_torch.algorithms.base import CommitCtx, CommitResult, UpdateRule
from distkeras_tpu_torch.utils.pytree import tree_map

__all__ = ["Sequential", "OneShotAverage"]


@dataclasses.dataclass(frozen=True)
class Sequential(UpdateRule):
    """No commits: pure local training (the reference's SequentialWorker)."""

    communication_window: int = 0  # 0 => never commit mid-training
    pulls: bool = False

    def commit(self, ctx: CommitCtx, local_params, center_params, local_state, center_state):
        return CommitResult(local_params, local_params, local_state, center_state)


@dataclasses.dataclass(frozen=True)
class OneShotAverage(UpdateRule):
    """Single synchronous weight average at end of training."""

    communication_window: int = 0
    pulls: bool = True

    def commit(self, ctx: CommitCtx, local_params, center_params, local_state, center_state):
        mean = tree_map(lambda x: x / ctx.num_workers, ctx.psum(local_params))
        new_center_state = {
            "num_updates": center_state["num_updates"] + self._count_commits(ctx)
        }
        return CommitResult(mean, mean, local_state, new_center_state)
