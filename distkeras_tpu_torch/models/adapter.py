"""Model adapters: one functional interface over PyTorch modules.

The port of :mod:`distkeras_tpu.models.adapter`.  A model is driven as a
function ``(params, state, inputs) -> outputs``, where ``params`` and
``state`` are name -> tensor dicts (a module's parameters and buffers), so
trainers and predictors can hold, move and swap weights without touching
the module itself.  :class:`TorchModel` wraps an ``nn.Module`` through
``torch.func.functional_call``, the counterpart of the JAX package's
``FlaxModel``; :class:`FunctionalModel` wraps a plain ``(init_fn,
apply_fn)`` pair.  Dropout randomness is an explicit ``torch.Generator``
(JAX's ``rng``).  :func:`as_adapter` wraps a Keras 3 model (torch backend)
in :class:`~distkeras_tpu_torch.models.keras_adapter.KerasModel`; Hugging
Face adapters come with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.parallel.mesh import resolve_device

__all__ = [
    "FunctionalModel",
    "ModelAdapter",
    "TorchModel",
    "TrainedModel",
    "as_adapter",
    "to_device",
]


class ModelAdapter:
    """Functional model interface.

    ``params`` — trainable tensors, by name.
    ``state``  — non-trainable tensors (buffers), by name; may be empty.
    """

    #: whether ``apply`` outputs are logits (True for the in-tree models)
    outputs_logits: bool = True

    #: model emits per-token outputs trained against per-token labels
    #: (language models)
    per_token_labels: bool = False

    def init(self, generator: torch.Generator, sample_input: np.ndarray) -> Tuple[Dict, Dict]:
        raise NotImplementedError

    def apply(self, params, state, inputs, training: bool = False,
              generator: Optional[torch.Generator] = None) -> Tuple[Any, Dict]:
        """``(outputs, new_state)``.  ``generator`` carries the dropout
        randomness of a training step (JAX's ``rng``)."""
        raise NotImplementedError

    def aux_loss(self, state):
        """Auxiliary training loss carried in the post-``apply`` state; the
        engine adds it to the objective each step.  0 for models without
        one."""
        del state
        return 0.0


@dataclasses.dataclass
class TorchModel(ModelAdapter):
    """Adapter over an ``nn.Module`` whose ``forward(inputs, training=...)``
    follows the in-tree models' signature."""

    module: nn.Module
    outputs_logits: bool = True

    @property
    def per_token_labels(self) -> bool:
        """Inherited from the wrapped module (TransformerLM sets it)."""
        return bool(getattr(self.module, "per_token_labels", False))

    def init(self, generator, sample_input):
        """Draw fresh parameters from ``generator`` with the module's
        ``reset_parameters(generator)`` and return ``(params, buffers)``.
        ``sample_input`` is unused: a torch module fixes its shapes when it
        is built."""
        del sample_input
        self.module.reset_parameters(generator)
        params = {name: p.detach() for name, p in self.module.named_parameters()}
        return params, dict(self.module.named_buffers())

    def apply(self, params, state, inputs, training=False, generator=None):
        """Run the module on ``params`` and ``state``.  A training call works
        on a copy of the buffers, which the module may update in place
        (running statistics), and returns that copy as the new state."""
        if training and state:
            state = {name: t.clone() for name, t in state.items()}
        kwargs = {"training": training}
        if generator is not None:
            kwargs["generator"] = generator
        out = torch.func.functional_call(self.module, {**params, **state}, (inputs,), kwargs)
        return out, state


@dataclasses.dataclass
class FunctionalModel(ModelAdapter):
    """Adapter over a plain ``(init_fn, apply_fn)`` pair:
    ``init_fn(generator, sample) -> params`` and
    ``apply_fn(params, inputs) -> outputs``."""

    init_fn: Callable
    apply_fn: Callable
    outputs_logits: bool = True

    def init(self, generator, sample_input):
        return self.init_fn(generator, torch.as_tensor(sample_input)), {}

    def apply(self, params, state, inputs, training=False, generator=None):
        return self.apply_fn(params, inputs), state


def to_device(tensors: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """A name -> tensor dict with every tensor on ``device`` (no copy for
    tensors already there)."""
    return {name: t.to(device) for name, t in tensors.items()}


class TrainedModel:
    """Parameters plus the adapter that runs them, on one device: what the
    trainers return, and what :class:`~distkeras_tpu_torch.predictors.ModelPredictor`
    takes.  ``history`` is the training history of the trainer that made
    it.  ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(self, adapter: ModelAdapter, params, state=None, device="cuda", history=None):
        self.adapter = adapter
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.state = to_device(state or {}, self.device)
        self.history = history or {}

    def __call__(self, inputs) -> torch.Tensor:
        """Raw model outputs (logits) for one batch, on :attr:`device`."""
        with torch.inference_mode():
            x = torch.as_tensor(inputs, device=self.device)
            return self.adapter.apply(self.params, self.state, x, training=False)[0]

    def predict(self, inputs, batch_size: int = 1024) -> np.ndarray:
        """Outputs for ``inputs`` in batches, as numpy; logits with more than
        one class become softmax probabilities."""
        inputs = np.asarray(inputs)
        outs = [self(inputs[i : i + batch_size]).cpu() for i in range(0, len(inputs), batch_size)]
        if not outs:
            return np.empty((0,))
        out = torch.cat(outs)
        if self.adapter.outputs_logits and out.ndim > 1 and out.shape[-1] > 1:
            out = torch.softmax(out, dim=-1)
        return out.numpy()


def as_adapter(model) -> ModelAdapter:
    """Coerce user input (a Keras 3 model, an ``nn.Module`` or an adapter)
    to an adapter."""
    if isinstance(model, ModelAdapter):
        return model
    # Keras model? Checked first: on the torch backend a Keras layer is an
    # nn.Module too.  (Lazy import: keras is heavy.)
    if type(model).__module__.split(".")[0] in ("keras", "tf_keras", "tensorflow"):
        from distkeras_tpu_torch.models.keras_adapter import KerasModel

        return KerasModel(model)
    if isinstance(model, nn.Module):
        return TorchModel(model)
    raise TypeError(
        f"cannot adapt {type(model)!r}: pass a Keras 3 model, a torch.nn.Module "
        "or a distkeras_tpu_torch ModelAdapter"
    )
