"""Worker definitions — reference-parity naming over the engine's rules.

The port of :mod:`distkeras_tpu.workers`.  A Worker is the *specification*
of the training loop the engine runs: which update rule runs at commit
boundaries and which local optimizer runs between them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from distkeras_tpu_torch.algorithms import (
    Adag,
    AdaptiveDynSGD,
    Aeasgd,
    Downpour,
    DynSGD,
    Eamsgd,
    OneShotAverage,
    Sequential,
    UpdateRule,
)

__all__ = [
    "Worker",
    "SequentialWorker",
    "AveragingWorker",
    "DOWNPOURWorker",
    "AEASGDWorker",
    "EAMSGDWorker",
    "ADAGWorker",
    "DynSGDWorker",
    "AdaptiveDynSGDWorker",
]


@dataclasses.dataclass
class Worker:
    """Specification of the per-worker training loop.

    ``optimizer`` — the local (worker-side) optimizer spec.
    """

    optimizer: Any = "sgd"
    batch_size: int = 32
    features_col: str = "features"
    label_col: str = "label"
    rule: UpdateRule = dataclasses.field(default_factory=Sequential)


class SequentialWorker(Worker):
    """Plain local training, no parameter server (reference: SequentialWorker)."""

    def __init__(self, optimizer="sgd", batch_size=32, features_col="features", label_col="label"):
        super().__init__(optimizer, batch_size, features_col, label_col, Sequential())


class AveragingWorker(Worker):
    """Independent local training; weights averaged once at the end."""

    def __init__(self, optimizer="sgd", batch_size=32, features_col="features", label_col="label"):
        super().__init__(optimizer, batch_size, features_col, label_col, OneShotAverage())


class DOWNPOURWorker(Worker):
    def __init__(self, optimizer="sgd", batch_size=32, features_col="features",
                 label_col="label", communication_window=5):
        super().__init__(optimizer, batch_size, features_col, label_col,
                         Downpour(communication_window))


class AEASGDWorker(Worker):
    def __init__(self, optimizer="sgd", batch_size=32, features_col="features",
                 label_col="label", communication_window=32, rho=5.0, learning_rate=0.1):
        super().__init__(optimizer, batch_size, features_col, label_col,
                         Aeasgd(communication_window=communication_window, rho=rho,
                                learning_rate=learning_rate))


class EAMSGDWorker(Worker):
    """``optimizer=None`` is Nesterov-momentum SGD at the rule's learning
    rate and momentum (the reference's explicit velocity update)."""

    def __init__(self, optimizer=None, batch_size=32, features_col="features",
                 label_col="label", communication_window=32, rho=5.0,
                 learning_rate=0.1, momentum=0.9):
        if optimizer is None:
            optimizer = ("sgd", {"learning_rate": learning_rate, "momentum": momentum,
                                 "nesterov": True})
        super().__init__(optimizer, batch_size, features_col, label_col,
                         Eamsgd(communication_window=communication_window, rho=rho,
                                learning_rate=learning_rate, momentum=momentum))


class ADAGWorker(Worker):
    def __init__(self, optimizer="sgd", batch_size=32, features_col="features",
                 label_col="label", communication_window=12):
        super().__init__(optimizer, batch_size, features_col, label_col,
                         Adag(communication_window))


class DynSGDWorker(Worker):
    def __init__(self, optimizer="sgd", batch_size=32, features_col="features",
                 label_col="label", communication_window=5):
        super().__init__(optimizer, batch_size, features_col, label_col,
                         DynSGD(communication_window))


class AdaptiveDynSGDWorker(Worker):
    def __init__(self, optimizer="sgd", batch_size=32, features_col="features",
                 label_col="label", communication_window=5, initial_bound=float("inf")):
        super().__init__(optimizer, batch_size, features_col, label_col,
                         AdaptiveDynSGD(communication_window, initial_bound=initial_bound))
