"""ADAG — accumulated-gradient normalisation (Hermans, arXiv:1710.02368) —
the port of :mod:`distkeras_tpu.algorithms.adag`.

As DOWNPOUR, but the residual gathered since the anchor is divided by the
local steps in the window before it is committed:
``center += psum((local − anchor) / steps_in_window)``; committing workers
pull the new center and re-anchor on it.
"""

from __future__ import annotations

import dataclasses

from distkeras_tpu_torch.algorithms.base import CommitCtx, CommitResult, UpdateRule
from distkeras_tpu_torch.utils.pytree import tree_add, tree_sub, tree_where

__all__ = ["Adag"]


@dataclasses.dataclass(frozen=True)
class Adag(UpdateRule):
    communication_window: int = 12

    def init_local_state(self, params):
        return {"anchor": params}

    def commit(self, ctx: CommitCtx, local_params, center_params, local_state, center_state):
        residual = tree_sub(local_params, local_state["anchor"])
        residual = self._scaled(1.0 / ctx.steps_in_window, residual)
        summed = ctx.psum(self._masked(ctx, residual))
        new_center = tree_add(center_params, summed)
        new_local = self._pull(ctx, new_center, local_params)
        new_anchor = tree_where(ctx.mask, new_center, local_state["anchor"])
        new_center_state = {
            "num_updates": center_state["num_updates"] + self._count_commits(ctx)
        }
        return CommitResult(new_local, new_center, {"anchor": new_anchor}, new_center_state)
