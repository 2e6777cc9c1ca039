"""KV-cached greedy decoding for the LM family.

The port of :mod:`distkeras_tpu.models.generate`.  The prefill runs the
whole prompt through the model as one chunk; every further token is a
single-token step through the :class:`~distkeras_tpu_torch.models.transformer.KVCache`
(attention per step is O(context), not O(context²) like full-context
recompute).  The steps run back to back on the device: each step's argmax
stays there and feeds the next, and the tokens come to the host in one copy
at the end.  Padded cache positions mask to ``exp(-inf) = 0`` exactly, so
cached decode emits the tokens of the recompute path.

Supports ``TransformerLM`` (through a ``TrainedModel``, or a module and its
parameters with :func:`greedy_generate_module`).  ``StagedLM`` and
``pipelined=True`` come with the pipeline slice (ROADMAP Queue A item 15).
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from distkeras_tpu_torch.models.adapter import TorchModel, TrainedModel, to_device
from distkeras_tpu_torch.parallel.mesh import resolve_device

__all__ = ["greedy_generate", "greedy_generate_module"]

_STAGED = "StagedLM decode and pipelined=True come with the pipeline slice (ROADMAP Queue A item 15)"


def _resolve(model) -> tuple:
    """(module, params, device) from a TrainedModel over a decodable LM."""
    if not isinstance(model, TrainedModel):
        raise TypeError(
            "greedy_generate expects the TrainedModel a trainer returned "
            f"(got {type(model).__name__}); for raw params use "
            "greedy_generate_module"
        )
    adapter = model.adapter
    if hasattr(adapter, "decode_step"):  # StagedLM
        raise NotImplementedError(_STAGED)
    module = getattr(adapter, "module", None)
    # decode capability, not just LM shape: a classifier also has max_len
    # but its forward takes no decode kwarg — reject it here by name
    if (
        isinstance(adapter, TorchModel)
        and module is not None
        and hasattr(module, "max_len")
        and "decode" in inspect.signature(type(module).forward).parameters
    ):
        return module, model.params, model.device
    raise TypeError(
        f"model {type(adapter).__name__}"
        f"({type(module).__name__ if module is not None else ''}) has no "
        "KV-cache decode path (supported: TransformerLM)"
    )


def greedy_generate(model, prompt, steps: int, *, pipelined: bool = False) -> np.ndarray:
    """Greedily extend ``prompt`` ``[batch, prompt_len]`` by ``steps`` tokens
    with a carried KV cache, on the model's device; returns ``[batch,
    prompt_len + steps]`` int32 (prompt included)."""
    if pipelined:
        raise NotImplementedError(_STAGED)
    module, params, device = _resolve(model)
    return greedy_generate_module(module, params, prompt, steps, device=device)


def _check(prompt, steps, max_len) -> np.ndarray:
    prompt = np.asarray(prompt, np.int32)
    if prompt.ndim != 2:
        raise ValueError(f"prompt must be [batch, len], got {prompt.shape}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if prompt.shape[1] + steps > max_len:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + steps ({steps}) exceeds the "
            f"model's max_len ({max_len}) — the KV cache is sized to it"
        )
    return prompt


def greedy_generate_module(module, params, prompt, steps: int, device="cuda") -> np.ndarray:
    """KV-cached greedy decode of a causal LM with ``decode`` support
    (``TransformerLM``) on ``params`` (name -> tensor): the prefill chunk,
    then ``steps - 1`` single-token steps, on ``device`` (default the card;
    pass ``device="cpu"`` for the CPU)."""
    prompt = _check(prompt, steps, module.max_len)
    if steps == 0:
        return prompt
    device = resolve_device(device)
    params = to_device(params, device)
    dtype = params["tok_embed.weight"].dtype
    cache = module.init_cache(prompt.shape[0], device=device, dtype=dtype)

    def step(tokens):
        logits = torch.func.functional_call(
            module, params, (tokens,), {"decode": True, "cache": cache})
        return torch.argmax(logits[:, -1], -1)

    with torch.no_grad():
        tok = step(torch.from_numpy(prompt).to(device))
        out = [tok]
        for _ in range(steps - 1):
            tok = step(tok[:, None])
            out.append(tok)
        generated = torch.stack(out, 1).to(torch.int32).cpu().numpy()
    return np.concatenate([prompt, generated], axis=1)
