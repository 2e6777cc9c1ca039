"""Async-SGD update rules — the port of :mod:`distkeras_tpu.algorithms` as
far as this slice goes: ``Sequential``, ``OneShotAverage`` and ``Downpour``.
AEASGD, EAMSGD, ADAG and DynSGD come with ROADMAP Queue A item 9."""

from distkeras_tpu_torch.algorithms.base import (
    CommitCtx,
    CommitResult,
    UpdateRule,
    make_ctx,
    stacked_ctx,
)
from distkeras_tpu_torch.algorithms.downpour import Downpour
from distkeras_tpu_torch.algorithms.sequential import OneShotAverage, Sequential

__all__ = [
    "UpdateRule",
    "CommitCtx",
    "CommitResult",
    "make_ctx",
    "stacked_ctx",
    "Downpour",
    "Sequential",
    "OneShotAverage",
]
