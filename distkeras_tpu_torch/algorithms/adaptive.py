"""Adaptive-staleness DynSGD — the port of the update rule of
:mod:`distkeras_tpu.algorithms.adaptive`.

:class:`AdaptiveDynSGD` is DynSGD whose center state carries a
``staleness_bound`` (an f32 scalar, ``inf`` by default).  A commit whose
staleness exceeds the bound is dropped: its delta never reaches the center
and it does not count as an update, but the worker still pulls the fresh
center and re-anchors (SSP-style bounded staleness).  With the bound at
``inf`` the rule is DynSGD.  The host-side ``AdaptiveBound`` policy that
retunes the bound between epochs reads the dynamics telemetry, which comes
with ROADMAP Queue A item 19.
"""

from __future__ import annotations

import dataclasses

import torch

from distkeras_tpu_torch.algorithms.base import CommitCtx
from distkeras_tpu_torch.algorithms.dynsgd import DynSGD

__all__ = ["AdaptiveDynSGD", "BOUND_KEY"]

BOUND_KEY = "staleness_bound"


@dataclasses.dataclass(frozen=True)
class AdaptiveDynSGD(DynSGD):
    communication_window: int = 5
    #: initial staleness bound; ``inf`` = plain DynSGD
    initial_bound: float = float("inf")

    def init_center_state(self):
        state = super().init_center_state()
        state[BOUND_KEY] = torch.tensor(self.initial_bound, dtype=torch.float32)
        return state

    def commit(self, ctx: CommitCtx, local_params, center_params, local_state, center_state):
        staleness = (center_state["num_updates"] - local_state["clock"]).to(torch.float32)
        # the SSP gate: an over-bound commit reaches nothing, but the worker
        # still re-anchors on the original boundary mask
        commit_mask = ctx.mask & (staleness <= center_state[BOUND_KEY])
        res, num_updates = self._commit(ctx, commit_mask, local_params, center_params,
                                        local_state, center_state)
        return res._replace(center_state={"num_updates": num_updates,
                                          BOUND_KEY: center_state[BOUND_KEY]})
