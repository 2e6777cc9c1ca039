"""Adaptive-staleness DynSGD — the port of
:mod:`distkeras_tpu.algorithms.adaptive`.

* :class:`AdaptiveDynSGD` is DynSGD whose center state carries a
  ``staleness_bound`` (an f32 scalar, ``inf`` by default).  A commit whose
  staleness exceeds the bound is dropped: its delta never reaches the
  center and it does not count as an update, but the worker still pulls
  the fresh center and re-anchors (SSP-style bounded staleness).  With the
  bound at ``inf`` the rule is DynSGD.
* :class:`AdaptiveBound` is the host-side policy (copied): between epochs
  it reads the dynamics summary (``divergence_max``,
  ``rule_staleness_max``), tightens the bound multiplicatively when
  divergence spikes against its running median and loosens it gently while
  training is stable.  The trainers apply the bound it returns by writing
  the ``staleness_bound`` leaf (``staleness_policy=``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import torch

from distkeras_tpu_torch.algorithms.base import CommitCtx
from distkeras_tpu_torch.algorithms.dynsgd import DynSGD

__all__ = ["AdaptiveBound", "AdaptiveDynSGD", "BOUND_KEY"]

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

    def dynamics(self, ctx: CommitCtx, local_params, center_params, local_state, center_state):
        out = super().dynamics(ctx, local_params, center_params, local_state, center_state)
        staleness = out["rule_staleness"]
        bound = center_state[BOUND_KEY]
        out["rule_bound"] = torch.broadcast_to(bound, staleness.shape)
        out["rule_dropped"] = (staleness > bound).to(torch.float32)
        return out

    def commit(self, ctx: CommitCtx, local_params, center_params, local_state, center_state):
        staleness = (center_state["num_updates"] - local_state["clock"]).to(torch.float32)
        # the SSP gate: an over-bound commit reaches nothing, but the worker
        # still re-anchors on the original boundary mask
        commit_mask = ctx.mask & (staleness <= center_state[BOUND_KEY])
        res, num_updates = self._commit(ctx, commit_mask, local_params, center_params,
                                        local_state, center_state)
        return res._replace(center_state={"num_updates": num_updates,
                                          BOUND_KEY: center_state[BOUND_KEY]})


class AdaptiveBound:
    """Host-side bound controller, applied between epochs.

    ``observe(summary)`` consumes one epoch's dynamics summary
    (:func:`distkeras_tpu_torch.telemetry.dynamics.summarize` keys) and returns
    the bound the next epoch should run under:

    * divergence above ``divergence_factor`` x its running median →
      **tighten** (``bound *= tighten``, floored at ``min_bound``) — stale
      commits are hurting, gate them harder;
    * stable divergence → **loosen** (``bound *= loosen``, capped at
      ``max_bound``) — admit more asynchrony while it is safe.

    The bound also never tightens below the observed median staleness + 1:
    a bound under what healthy workers actually exhibit would starve the
    center entirely.
    """

    def __init__(self, initial: float = 16.0, min_bound: float = 1.0,
                 max_bound: float = 256.0, tighten: float = 0.5,
                 loosen: float = 1.25, divergence_factor: float = 2.0,
                 history: int = 8):
        self.bound = float(initial)
        self.min_bound = float(min_bound)
        self.max_bound = float(max_bound)
        self.tighten = float(tighten)
        self.loosen = float(loosen)
        self.divergence_factor = float(divergence_factor)
        self._divergences: deque = deque(maxlen=int(history))
        self.tightened = 0
        self.loosened = 0

    @staticmethod
    def _median(values) -> Optional[float]:
        if not values:
            return None
        ordered = sorted(values)
        mid = len(ordered) // 2
        if len(ordered) % 2:
            return ordered[mid]
        return 0.5 * (ordered[mid - 1] + ordered[mid])

    def observe(self, summary: dict) -> float:
        div = summary.get("divergence_max")
        staleness = summary.get("rule_staleness_mean",
                                summary.get("rule_staleness"))
        baseline = self._median(list(self._divergences))
        if div is not None:
            self._divergences.append(float(div))
        if (div is not None and baseline is not None and baseline > 0
                and float(div) > self.divergence_factor * baseline):
            self.bound = max(self.min_bound, self.bound * self.tighten)
            self.tightened += 1
        else:
            self.bound = min(self.max_bound, self.bound * self.loosen)
            self.loosened += 1
        if staleness is not None:
            # never gate below what live workers actually exhibit
            self.bound = max(self.bound, float(staleness) + 1.0)
        self.bound = min(self.bound, self.max_bound)
        return self.bound
