"""What the benchmark takes from the program under test,
``distkeras_tpu_torch``: its model classes, its trainers and its serving
engine.  The benchmark builds each module on the ``meta`` device (no
weights are drawn there) and hands the program the weights it made from the
seed (:mod:`portbench.weights`), after checking that the module names and
shapes its parameters as the benchmark laid them out."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from distkeras_tpu_torch.models import TorchModel


def build(config: dict) -> torch.nn.Module:
    """The configuration's model as the port builds it, on ``meta``."""
    from distkeras_tpu_torch import models

    with torch.device("meta"):
        if config["port_class"] != "TransformerLM":
            raise KeyError(f"the benchmark builds no {config['port_class']}")
        return models.TransformerLM(
            config["vocab_size"], dim=config["n_embd"], heads=config["n_head"],
            num_layers=config["n_layer"], max_len=config["n_positions"],
            dropout=config["resid_pdrop"])


def check_layout(module: torch.nn.Module, table) -> None:
    """Refuse a module whose parameters are not the table's, or that has
    buffers (state the benchmark would not hand over)."""
    for kind, got, want in (("parameters", module.named_parameters(), table),
                            ("buffers", module.named_buffers(), [])):
        got = {(n, tuple(t.shape)) for n, t in got}
        want = {(n, tuple(s)) for n, s in want}
        if got != want:
            raise ValueError(f"the program's {kind} differ from the benchmark's layout: "
                             f"{sorted(got ^ want)[:4]}")


@dataclasses.dataclass
class SeededModel(TorchModel):
    """The port's adapter over ``module``, whose ``init`` hands over the
    benchmark's weights (once) instead of drawing its own."""

    weights: Dict[str, torch.Tensor] = None

    def init(self, generator, sample_input):
        del generator, sample_input
        if self.weights is None:
            raise RuntimeError("the benchmark's weights were handed over already")
        params, self.weights = dict(self.weights), None
        return params, {}


def trainer(traffic: dict, module, weights, seed: int, on_engine: Callable,
            device) -> "object":
    """The traffic's trainer class of the port over ``module`` with the
    benchmark's weights, training for as many epochs as it is let run.
    ``on_engine(engine)`` sees the engine the trainer builds."""
    import distkeras_tpu_torch as dk

    base = getattr(dk, traffic["trainer"])

    class Driven(base):
        def _make_engine(self, *args, **kwargs):
            engine = super()._make_engine(*args, **kwargs)
            on_engine(engine)
            return engine

    adapter = SeededModel(module=module, weights=weights)
    return Driven(adapter, loss=traffic["loss"], worker_optimizer=tuple(traffic["optimizer"]),
                  num_workers=traffic["num_workers"], batch_size=traffic["batch_size"],
                  num_epoch=10 ** 9, seed=seed, compute_dtype=traffic["compute_dtype"],
                  unroll=traffic["unroll"], device=device, **traffic["trainer_kwargs"])


def frame(features, labels):
    """The port's ``from_numpy`` frame."""
    import distkeras_tpu_torch as dk

    return dk.from_numpy(features, labels)
