"""DynSGD — staleness-aware dynamic-learning-rate SGD (Jiang et al., SIGMOD
2017) — the port of :mod:`distkeras_tpu.algorithms.dynsgd`.

Each commit carries the worker's update clock; the center applies
``center += delta / (staleness + 1)`` with ``staleness = num_updates −
clock``, counted against ``num_updates`` from *before* the commits of this
boundary, as the JAX rule does: every worker committing at one boundary
races the same center.  Under uniform windows every staleness is 0 (DynSGD
is DOWNPOUR); the engine's staleness simulation (``commit_schedule``) gives
slow committers positive staleness.
"""

from __future__ import annotations

import dataclasses

import torch

from distkeras_tpu_torch.algorithms.base import CommitCtx, CommitResult, UpdateRule
from distkeras_tpu_torch.utils.pytree import tree_add, tree_sub, tree_where

__all__ = ["DynSGD"]


@dataclasses.dataclass(frozen=True)
class DynSGD(UpdateRule):
    communication_window: int = 5

    def init_local_state(self, params):
        return {"anchor": params, "clock": torch.zeros((), dtype=torch.int32)}

    def dynamics(self, ctx: CommitCtx, local_params, center_params, local_state, center_state):
        """Expose the staleness the next commit will damp by: the gap between
        the update counter and each worker's clock, and the resulting
        ``1/(staleness+1)`` scale."""
        del ctx, local_params, center_params
        staleness = (center_state["num_updates"] - local_state["clock"]).to(torch.float32)
        return {"rule_staleness": staleness, "rule_scale": 1.0 / (staleness + 1.0)}

    def _commit(self, ctx: CommitCtx, commit_mask, local_params, center_params, local_state,
                center_state):
        """The DynSGD commit with the workers of ``commit_mask`` reaching
        the center; every worker of ``ctx.mask`` pulls and re-anchors.
        Returns the result and the new update count."""
        num_updates = center_state["num_updates"]
        staleness = (num_updates - local_state["clock"]).to(torch.float32)
        delta = self._scaled(1.0 / (staleness + 1.0),
                             tree_sub(local_params, local_state["anchor"]))
        gated = ctx._replace(mask=commit_mask)
        new_center = tree_add(center_params, ctx.psum(self._masked(gated, delta)))
        new_num_updates = num_updates + self._count_commits(gated)
        new_local = self._pull(ctx, new_center, local_params)
        new_state = {
            "anchor": tree_where(ctx.mask, new_center, local_state["anchor"]),
            "clock": torch.where(ctx.mask, new_num_updates, local_state["clock"]),
        }
        return CommitResult(new_local, new_center, new_state, center_state), new_num_updates

    def commit(self, ctx: CommitCtx, local_params, center_params, local_state, center_state):
        res, num_updates = self._commit(ctx, ctx.mask, local_params, center_params,
                                        local_state, center_state)
        return res._replace(center_state={"num_updates": num_updates})
