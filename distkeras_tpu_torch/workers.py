"""Worker definitions — reference-parity naming over the engine's rules.

The port of :mod:`distkeras_tpu.workers` for the rules of this slice.  A
Worker is the *specification* of the training loop the engine runs: which
update rule runs at commit boundaries and which local optimizer runs
between them.  The AEASGD, EAMSGD, ADAG and DynSGD workers come with their
rules (ROADMAP Queue A item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from distkeras_tpu_torch.algorithms import Downpour, OneShotAverage, Sequential, UpdateRule

__all__ = ["Worker", "SequentialWorker", "AveragingWorker", "DOWNPOURWorker"]


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
