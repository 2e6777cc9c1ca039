"""Update-rule interface: the pure-function form of the reference's
parameter-server protocols.

The port of :mod:`distkeras_tpu.algorithms.base`.  A rule's ``commit`` runs
at a window boundary: the worker-side delta, then the server-side "apply to
center" as a ``psum`` over workers followed by the center update.  In the
port, workers are stacked along a leading dim of every per-worker tensor
(``[num_workers, ...]``) and ``psum`` sums over that dim, so one ``commit``
call commits every worker on the card at once; the sum across cards comes
with the multi-GPU slice.  Every rule is a pure function of name -> tensor
dicts, testable against the closed-form math with ``psum`` = identity on a
single unstacked worker.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from distkeras_tpu_torch.utils.pytree import bcast, tree_map, tree_where

__all__ = ["CommitCtx", "CommitResult", "UpdateRule", "make_ctx", "stacked_ctx"]


class CommitCtx(NamedTuple):
    """Execution context handed to ``commit`` at a window boundary.

    ``psum``  — sum over workers (identity when testing a single worker).
    ``mask``  — bool: does each worker commit at this boundary?  A scalar
                for a single worker, ``[num_workers]`` for stacked workers.
                In the uniform-window engine every worker commits; in the
                staleness simulation the mask is each worker's own commit
                schedule.
    ``steps_in_window`` — local optimizer steps since the last commit: a
                scalar, or one count per worker in the staleness simulation.
    """

    psum: Callable[[Any], Any]
    mask: torch.Tensor
    steps_in_window: torch.Tensor
    num_workers: int


class CommitResult(NamedTuple):
    local_params: Any
    center_params: Any
    local_state: Any
    center_state: Any


def make_ctx(mask=True, steps_in_window=1, num_workers=1) -> CommitCtx:
    """Single-worker context: ``psum`` is the identity."""
    return CommitCtx(
        psum=lambda t: t,
        mask=torch.as_tensor(mask),
        steps_in_window=torch.as_tensor(steps_in_window, dtype=torch.float32),
        num_workers=num_workers,
    )


def stacked_ctx(num_workers: int, steps_in_window, device, mask=None) -> CommitCtx:
    """Context for ``num_workers`` workers stacked on one device:
    ``psum`` sums each leaf over its leading worker dim.  Every worker
    commits unless ``mask`` (``[num_workers]`` bool) says otherwise."""
    if mask is None:
        mask = torch.ones(num_workers, dtype=torch.bool, device=device)
    if isinstance(steps_in_window, torch.Tensor):
        steps = steps_in_window.to(device, torch.float32)
    else:  # a fill, not a copy from the host: a captured window may hold it
        steps = torch.full((), float(steps_in_window), dtype=torch.float32, device=device)
    return CommitCtx(
        psum=lambda t: tree_map(lambda x: x.sum(dim=0), t),
        mask=mask,
        steps_in_window=steps,
        num_workers=num_workers,
    )


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """Base class: one async-SGD variant = one subclass.

    ``communication_window`` mirrors the reference trainers' kwarg of the
    same name: number of local steps between commits.
    """

    communication_window: int = 5

    #: do committing workers re-pull (adopt) the center after commit?
    pulls: bool = True

    def init_local_state(self, params) -> Any:
        """Per-worker rule state (anchors, clocks); params = initial center."""
        return ()

    def init_center_state(self) -> Any:
        """Center-side state (update counters)."""
        return {"num_updates": torch.zeros((), dtype=torch.int32)}

    def commit(
        self, ctx: CommitCtx, local_params, center_params, local_state, center_state
    ) -> CommitResult:
        raise NotImplementedError

    # -- shared helpers ----------------------------------------------------
    @staticmethod
    def _masked(ctx: CommitCtx, tree):
        return UpdateRule._scaled(ctx.mask.to(torch.float32), tree)

    @staticmethod
    def _scaled(scale: torch.Tensor, tree):
        """Each leaf times ``scale``: a scalar, or one value per worker."""
        return tree_map(lambda x: x * bcast(scale, x), tree)

    @staticmethod
    def _count_commits(ctx: CommitCtx):
        return ctx.psum(ctx.mask.to(torch.int32))

    @staticmethod
    def _pull(ctx: CommitCtx, new_center, local_params):
        """Committing workers adopt the fresh center (the reference's ``pull``)."""
        return tree_where(ctx.mask, new_center, local_params)
