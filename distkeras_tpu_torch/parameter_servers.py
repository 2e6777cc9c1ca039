"""Parameter servers — the center-variable facade.

The port of :mod:`distkeras_tpu.parameter_servers`.  The center variable
lives on the card, in the engine's state, and commits run inside the
training loop; these classes keep the reference's parameter-server
lifecycle and observability API (``start``/``stop``/``get_model``/
``num_updates``) over that state.
"""

from __future__ import annotations

from typing import Any

import torch

from distkeras_tpu_torch.algorithms import Adag, Downpour, DynSGD

__all__ = [
    "ParameterServer",
    "SocketParameterServer",
    "DeltaParameterServer",
    "ADAGParameterServer",
    "DynSGDParameterServer",
]


class ParameterServer:
    """Facade over the engine's center variable."""

    #: update rule applied at commit boundaries (subclass responsibility).
    rule_class = Downpour

    def __init__(self, model: Any = None, master_port: int = 5000):
        self.model = model
        self.master_port = master_port  # kept for API compat; no socket is opened
        self.center_params: Any = None
        self.center_model_state: Any = None
        self._num_updates: int = 0
        self._live_updates: Any = None  # copy of the on-card counter mid-fit
        self.running = False

    # -- lifecycle (reference parity: initialize/start/run/stop) ------------
    def initialize(self) -> None:
        """Reference parity: bound a listening socket.  Here: nothing to do."""

    def start(self) -> None:
        self.running = True

    def run(self) -> None:
        self.running = True

    def stop(self) -> None:
        self.running = False

    # -- state --------------------------------------------------------------
    def attach(self, center_params, center_rule_state, center_model_state=None) -> None:
        """Called by the trainer after training: adopt the final center
        state (the equivalent of the PS holding the trained model)."""
        self.center_params = center_params
        self.center_model_state = center_model_state
        num = center_rule_state.get("num_updates") if isinstance(center_rule_state, dict) else None
        if num is not None:
            self._num_updates = int(num)
        self._live_updates = None  # final count wins over the mid-fit copy

    def track(self, center_rule_state) -> None:
        """Called by the trainer at every epoch boundary while training
        runs: keep a copy of the on-card commit counter, read back only if
        :attr:`num_updates` is asked for."""
        num = center_rule_state.get("num_updates") if isinstance(center_rule_state, dict) else None
        if num is not None:
            self._live_updates = torch.clone(num)

    @property
    def num_updates(self) -> int:
        """Total commits applied to the center variable, live during a fit."""
        if self._live_updates is not None:
            return int(self._live_updates)
        return self._num_updates

    def get_model(self):
        """The trained center model (reference parity: ``get_model``)."""
        return self.model


class SocketParameterServer(ParameterServer):
    """Name-parity alias: the reference's TCP accept-loop server."""


class DeltaParameterServer(SocketParameterServer):
    """``center += delta`` (DOWNPOUR / AEASGD / EAMSGD commits)."""

    rule_class = Downpour


class ADAGParameterServer(SocketParameterServer):
    """Window-normalised delta (``center += delta / window``)."""

    rule_class = Adag


class DynSGDParameterServer(SocketParameterServer):
    """Staleness-aware: ``center += delta / (staleness + 1)`` with per-worker
    update clocks (see :class:`distkeras_tpu_torch.algorithms.DynSGD`)."""

    rule_class = DynSGD
