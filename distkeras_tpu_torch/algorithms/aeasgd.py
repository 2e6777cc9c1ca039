"""AEASGD / EAMSGD — (momentum) asynchronous elastic averaging SGD (Zhang,
Choromanska & LeCun, NIPS 2015) — the port of
:mod:`distkeras_tpu.algorithms.aeasgd`.

Every ``communication_window`` steps each worker computes the elastic
difference ``E = α·(x − center)`` with ``α = learning_rate·ρ``, subtracts it
from its local variable and commits it: ``center += psum(E)``.  Workers
never pull; the elastic force is the only coupling.  EAMSGD commits as
AEASGD does; its momentum lives in the worker optimizer (Nesterov SGD).
"""

from __future__ import annotations

import dataclasses

from distkeras_tpu_torch.algorithms.base import CommitCtx, CommitResult, UpdateRule
from distkeras_tpu_torch.utils.pytree import tree_add, tree_map, tree_sub

__all__ = ["Aeasgd", "Eamsgd"]


@dataclasses.dataclass(frozen=True)
class Aeasgd(UpdateRule):
    communication_window: int = 32
    rho: float = 5.0
    learning_rate: float = 0.1
    pulls: bool = False

    @property
    def alpha(self) -> float:
        return self.learning_rate * self.rho

    def commit(self, ctx: CommitCtx, local_params, center_params, local_state, center_state):
        alpha = self.alpha
        elastic = tree_map(lambda x, c: alpha * (x - c), local_params, center_params)
        elastic = self._masked(ctx, elastic)
        new_local = tree_sub(local_params, elastic)
        new_center = tree_add(center_params, ctx.psum(elastic))
        new_center_state = {
            "num_updates": center_state["num_updates"] + self._count_commits(ctx)
        }
        return CommitResult(new_local, new_center, local_state, new_center_state)


@dataclasses.dataclass(frozen=True)
class Eamsgd(Aeasgd):
    """EAMSGD: AEASGD's commit; trainers pair it with a Nesterov-momentum
    worker optimizer (the reference's explicit velocity update)."""

    momentum: float = 0.9
