"""Keras 3 (torch backend) adapter — the port of
:mod:`distkeras_tpu.models.keras_adapter`.

The reference's whole API takes compiled Keras models
(``distkeras/trainers.py :: Trainer.__init__(keras_model, ...)``).  Keras 3
runs on PyTorch and exposes ``model.stateless_call`` — a pure function over
explicit trainable and non-trainable variable lists — which is the
:class:`~distkeras_tpu_torch.models.adapter.ModelAdapter` contract.  The
port's engine carries parameters as name -> tensor dicts, so the adapter
keys them by each variable's path, in ``trainable_variables`` (and
``non_trainable_variables``) order.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

os.environ.setdefault("KERAS_BACKEND", "torch")

from distkeras_tpu_torch.models.adapter import ModelAdapter  # noqa: E402

__all__ = ["KerasModel", "assign_keras_weights"]


def _paths(variables) -> list:
    paths = [v.path for v in variables]
    if len(set(paths)) != len(paths):
        raise ValueError(f"Keras variable paths are not unique: {paths}")
    return paths


class KerasModel(ModelAdapter):
    """Wrap a Keras 3 model as a pure functional adapter via ``stateless_call``."""

    # Keras models conventionally end in softmax/sigmoid activations.
    outputs_logits = False

    def __init__(self, model):
        import keras

        if keras.backend.backend() != "torch":
            raise RuntimeError(
                "distkeras_tpu_torch requires the Keras torch backend; set "
                "KERAS_BACKEND=torch before importing keras"
            )
        self.model = model

    def init(self, generator, sample_input):
        """The model's current variables as ``(params, state)`` dicts keyed by
        variable path (the model is built from ``sample_input``'s shape if it
        is not built yet).  ``generator`` is unused: Keras draws its initial
        weights when it builds the model."""
        del generator
        if not self.model.built:
            self.model.build(np.asarray(sample_input).shape)
        params = {path: v.value.detach().clone()
                  for path, v in zip(_paths(self.model.trainable_variables),
                                     self.model.trainable_variables)}
        state = {path: v.value.detach().clone()
                 for path, v in zip(_paths(self.model.non_trainable_variables),
                                    self.model.non_trainable_variables)}
        return params, state

    def apply(self, params, state, inputs, training=False, generator=None):
        trainable = [params[path] for path in _paths(self.model.trainable_variables)]
        ntv_paths = _paths(self.model.non_trainable_variables)
        outputs, ntv = self.model.stateless_call(
            trainable, [state[path] for path in ntv_paths], inputs, training=training
        )
        return outputs, dict(zip(ntv_paths, ntv))

    def assign(self, params, state=None):
        """Write trained values back onto the Keras model (what ``train`` returns)."""
        return assign_keras_weights(self.model, params, state)


def _values(values) -> list:
    """A list of values in variable order: a dict (the adapter's params or
    state) is read in its order, which is the model's."""
    return list(values.values()) if isinstance(values, Mapping) else list(values)


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def assign_keras_weights(model, trainable_values, non_trainable_values=None):
    """Assign values to a Keras model's variables, in variable order: lists,
    or dicts keyed as :class:`KerasModel` keys them (a clone of the model,
    whose paths differ, takes the same dicts)."""
    for var, val in zip(model.trainable_variables, _values(trainable_values)):
        var.assign(_numpy(val))
    if non_trainable_values is not None:
        for var, val in zip(model.non_trainable_variables, _values(non_trainable_values)):
            var.assign(_numpy(val))
    return model
