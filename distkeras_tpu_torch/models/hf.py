"""HuggingFace ``transformers`` adapter — train PyTorch checkpoints through
any trainer and parallelism axis.

The port of :mod:`distkeras_tpu.models.hf`, in the mirror image: the JAX
package adapts ``transformers`` **Flax** models and refuses PyTorch ones;
the port adapts **PyTorch** ones (``GPT2LMHeadModel``,
``*ForSequenceClassification``, ...) and refuses Flax ones (ROADMAP Queue
C, C17).  An HF PyTorch model is an ``nn.Module``, so the adapter runs it
through ``torch.func.functional_call`` with the parameters threaded
explicitly, as :class:`~distkeras_tpu_torch.models.TorchModel` does, and the
checkpoint's weights ride along as the initial center variable —
fine-tuning is the training path.

* ``init`` adopts the model's own parameters (``named_parameters()``, which
  lists a tied ``lm_head`` once, under ``transformer.wte``); the state is
  empty.  ``functional_call`` ties the head back to the embedding it is
  given (``tie_weights=True``), so the head trains with the embedding.
* The module's buffers (GPT-2's causal-mask constants) are not state: they
  are handed to each call, copied once to each device a call runs on.
* ``apply`` sets the module's mode (``train()``/``eval()``) from
  ``training`` — ``functional_call`` does not — and returns the logits
  (``out.logits``, or ``out[0]`` under ``return_dict=False``).
* HF's dropout draws from the device's default generator, not from the
  worker's explicit one.  A training call with a ``generator`` therefore
  runs with the default generator set to the worker generator's state,
  then hands the advanced state back to the worker generator and restores
  the default one: the masks come from the worker's stream and the
  process's global stream is left as it was.  Both are host-side state
  copies (no sync); inside a captured window the default generator is
  the graph's own and the masks come from it.

No ``transformers`` import happens here: the adapter only touches the
instance the user built, so the dependency stays optional.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from distkeras_tpu_torch.models.adapter import ModelAdapter

__all__ = ["HuggingFaceModel"]

#: class-name fragments that mark per-token (causal/masked LM) heads —
#: their labels shard over the sequence axis with the tokens
_LM_HEAD_MARKERS = ("LMHeadModel", "ForCausalLM", "ForMaskedLM")


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index or 0]
    return torch.default_generator


@dataclasses.dataclass
class HuggingFaceModel(ModelAdapter):
    """Adapter over a ``transformers`` **PyTorch** model instance.

    ``per_token_labels`` defaults from the head type: LM heads
    (``*LMHeadModel`` / ``*ForCausalLM`` / ``*ForMaskedLM``) train against
    per-token targets (use ``loss="token_crossentropy"``), classification
    heads against per-sequence ones.  Pass it explicitly to override.
    """

    model: Any
    per_token_labels: Any = None
    outputs_logits: bool = True

    def __post_init__(self):
        name = type(self.model).__name__
        if self.per_token_labels is None:
            self.per_token_labels = any(m in name for m in _LM_HEAD_MARKERS)
        self.per_token_labels = bool(self.per_token_labels)
        if not isinstance(self.model, torch.nn.Module):
            raise TypeError(
                f"{name} does not look like a transformers PyTorch model (an "
                "nn.Module); Flax transformers models run on the JAX package "
                "(distkeras_tpu.models.HuggingFaceModel), the port adapts the "
                "PyTorch ones"
            )
        self._buffers = {}

    def init(self, generator, sample_input):
        """Adopt the model's own parameters (random per its constructor, or
        pretrained via ``from_pretrained``) — fine-tuning keeps the
        checkpoint; ``generator`` and ``sample_input`` are unused because HF
        models own their initialisation."""
        del generator, sample_input
        return {name: p.detach().clone() for name, p in self.model.named_parameters()}, {}

    def _buffers_on(self, device: torch.device) -> dict:
        if device not in self._buffers:
            self._buffers[device] = {name: b.detach().to(device)
                                     for name, b in self.model.named_buffers()}
        return self._buffers[device]

    def apply(self, params, state, inputs, training=False, generator=None):
        inputs = torch.as_tensor(inputs)
        self.model.train(bool(training))
        tensors = {**self._buffers_on(inputs.device), **params}
        if not (training and generator is not None) or (
                inputs.is_cuda and torch.cuda.is_current_stream_capturing()):
            out = torch.func.functional_call(self.model, tensors, (inputs,))
        else:
            default = _default_generator(inputs.device)
            saved = default.get_state()
            default.set_state(generator.get_state())
            try:
                out = torch.func.functional_call(self.model, tensors, (inputs,))
                generator.set_state(default.get_state())
            finally:
                default.set_state(saved)
        # configs carried over from other codebases often set
        # return_dict=False, where forward returns a (logits, ...) tuple
        logits = out.logits if hasattr(out, "logits") else out[0]
        return logits, state
