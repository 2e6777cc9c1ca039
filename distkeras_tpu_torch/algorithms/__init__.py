"""Async-SGD update rules — the port of :mod:`distkeras_tpu.algorithms`:
the pure-function form of the reference's worker/parameter-server pairs,
and the host-side ``AdaptiveBound`` staleness policy."""

from distkeras_tpu_torch.algorithms.adag import Adag
from distkeras_tpu_torch.algorithms.adaptive import AdaptiveBound, AdaptiveDynSGD
from distkeras_tpu_torch.algorithms.aeasgd import Aeasgd, Eamsgd
from distkeras_tpu_torch.algorithms.base import (
    CommitCtx,
    CommitResult,
    UpdateRule,
    make_ctx,
    mesh_ctx,
    stacked_ctx,
)
from distkeras_tpu_torch.algorithms.downpour import Downpour
from distkeras_tpu_torch.algorithms.dynsgd import DynSGD
from distkeras_tpu_torch.algorithms.sequential import OneShotAverage, Sequential

__all__ = [
    "UpdateRule",
    "CommitCtx",
    "CommitResult",
    "make_ctx",
    "mesh_ctx",
    "stacked_ctx",
    "Downpour",
    "Adag",
    "Aeasgd",
    "Eamsgd",
    "DynSGD",
    "AdaptiveDynSGD",
    "AdaptiveBound",
    "Sequential",
    "OneShotAverage",
]
