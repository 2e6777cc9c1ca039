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
parameters with :func:`greedy_generate_module`) and ``StagedLM``:
sequentially on one rank (:func:`greedy_generate_staged`), or with
``pipelined=True`` down the stages of a pipeline grid
(:func:`greedy_generate_staged_pipelined`), each rank holding one stage's
blocks and one stage's KV cache, so that a model whose block stack does not
fit one card decodes from ``num_stages`` cards.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from distkeras_tpu_torch.models.adapter import TorchModel, TrainedModel, to_device
from distkeras_tpu_torch.parallel.mesh import (
    PP_AXIS,
    WORKER_AXIS,
    broadcast,
    make_mesh_grid,
    ppermute,
    resolve_axis,
    resolve_device,
)

__all__ = ["greedy_generate", "greedy_generate_module", "greedy_generate_staged",
           "greedy_generate_staged_pipelined"]


def _resolve(model) -> tuple:
    """``(kind, target, params, device)`` from a TrainedModel over a
    decodable LM: ``("staged", the StagedLM adapter, ...)`` or
    ``("module", the TransformerLM module, ...)``."""
    if not isinstance(model, TrainedModel):
        raise TypeError(
            "greedy_generate expects the TrainedModel a trainer returned "
            f"(got {type(model).__name__}); for raw params use "
            "greedy_generate_module"
        )
    adapter = model.adapter
    if hasattr(adapter, "decode_step"):  # StagedLM
        return "staged", adapter, model.params, model.device
    module = getattr(adapter, "module", None)
    # decode capability, not just LM shape: a classifier also has max_len
    # but its forward takes no decode kwarg — reject it here by name
    if (
        isinstance(adapter, TorchModel)
        and module is not None
        and hasattr(module, "max_len")
        and "decode" in inspect.signature(type(module).forward).parameters
    ):
        return "module", module, model.params, model.device
    raise TypeError(
        f"model {type(adapter).__name__}"
        f"({type(module).__name__ if module is not None else ''}) has no "
        "KV-cache decode path (supported: TransformerLM, StagedLM)"
    )


def greedy_generate(model, prompt, steps: int, *, pipelined: bool = False) -> np.ndarray:
    """Greedily extend ``prompt`` ``[batch, prompt_len]`` by ``steps`` tokens
    with a carried KV cache, on the model's device; returns ``[batch,
    prompt_len + steps]`` int32 (prompt included).

    ``pipelined=True`` (StagedLM only) decodes down the stages of the
    process group's pipeline grid, one stage of blocks and cache a rank,
    instead of the sequential executor on one rank."""
    kind, target, params, device = _resolve(model)
    if kind == "staged":
        if pipelined:
            return greedy_generate_staged_pipelined(target, params, prompt, steps,
                                                    device=device)
        return greedy_generate_staged(target, params, prompt, steps, device=device)
    if pipelined:
        raise TypeError(
            f"pipelined decode needs a StagedLM (got {type(target).__name__})"
        )
    return greedy_generate_module(target, params, prompt, steps, device=device)


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

    def step(tokens, pos):
        logits = torch.func.functional_call(
            module, params, (tokens,), {"decode": True, "cache": cache})
        return torch.argmax(logits[:, -1], -1)

    return _greedy(step, prompt, steps, device)


def _greedy(step, prompt: np.ndarray, steps: int, device) -> np.ndarray:
    """The prefill chunk, then ``steps - 1`` one-token steps, back to back
    on the device (``step(tokens, first position)`` returns each row's next
    token); the tokens come to the host in one copy at the end."""
    with torch.no_grad():
        tok = step(torch.from_numpy(prompt).to(device), 0)
        out = [tok]
        for i in range(steps - 1):
            tok = step(tok[:, None], prompt.shape[1] + i)
            out.append(tok)
        generated = torch.stack(out, 1).to(torch.int32).cpu().numpy()
    return np.concatenate([prompt, generated], axis=1)


def greedy_generate_staged(staged, params, prompt, steps: int, device="cuda") -> np.ndarray:
    """KV-cached greedy decode of a ``StagedLM`` on ``params`` (its staged
    tree) through its sequential executor (:meth:`StagedLM.decode_step`),
    on ``device``."""
    prompt = _check(prompt, steps, staged.max_len)
    if steps == 0:
        return prompt
    device = resolve_device(device)
    params = to_device(params, device)
    cache = staged.init_cache(prompt.shape[0], dtype=params["embed"]["tok_embed.weight"].dtype,
                              device=device)

    def step(tokens, pos):
        logits, _ = staged.decode_step(params, cache, tokens, pos)
        return torch.argmax(logits[:, -1], -1)

    return _greedy(step, prompt, steps, device)


def _stages_grid(num_stages: int):
    """A ``(workers, stages)`` grid over the process group's ranks, one row
    of ``num_stages`` ranks a replica of the decode."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world < num_stages:
        raise ValueError(
            f"{num_stages} pipeline stages need >= {num_stages} devices (one rank a "
            f"stage), got {world}"
        )
    return make_mesh_grid(world // num_stages, num_stages, axis_names=(WORKER_AXIS, PP_AXIS))


def greedy_generate_staged_pipelined(staged, params, prompt, steps: int, mesh=None,
                                     device="cuda") -> np.ndarray:
    """KV-cached greedy decode of a ``StagedLM`` down the ``stages`` axis of
    ``mesh`` (default: the process group's ranks as a ``(workers, stages)``
    grid): every rank of it makes the call with the whole ``params`` (a
    trainer's model, gathered) and keeps one stage's blocks and one stage's
    KV cache on ``device``.

    Each decode chunk runs the stages in turn: stage 0 embeds it and
    applies its blocks, and ``num_stages - 1`` ring shifts over ``stages``
    hand the activation on, each stage applying its blocks on its turn
    (the others idle, where the JAX package's SPMD ring computes and
    discards); the last stage applies the head and takes the argmax, and
    the token reaches every stage rank by a broadcast.  The same stage
    applies in the same order as the sequential executor, on the same
    values: the tokens are its tokens."""
    prompt = _check(prompt, steps, staged.max_len)
    S = staged.num_stages
    mesh = _stages_grid(S) if mesh is None else mesh
    if mesh.get_group(0) is not None and mesh.get_coordinate() is None:
        raise ValueError(f"this process is not a rank of {mesh}")
    ax = resolve_axis(PP_AXIS, mesh)
    if ax.size != S:
        raise ValueError(f"{S} pipeline stages need a stages axis of {S} ranks, got {ax.size}")
    if steps == 0:
        return prompt
    device = resolve_device(device)
    s = ax.index
    embed = to_device(params["embed"], device)
    head = to_device(params["head"], device)
    blocks = {k: v[s].to(device) for k, v in params["blocks"].items()}
    dtype = embed["tok_embed.weight"].dtype
    cache = staged.init_cache(prompt.shape[0], dtype=dtype, device=device,
                              blocks=staged.blocks_per_stage)

    def step(tokens, pos):
        if s == 0:
            h = staged.embed(embed, tokens, offset=pos)
        else:
            h = torch.zeros(tokens.shape + (staged.dim,), dtype=dtype, device=device)
        for turn in range(S):
            if turn == s:
                h = staged.decode_blocks(blocks, cache, h)
            if turn < S - 1:
                h = ppermute(h, PP_AXIS, 1, mesh)
        cache.index += tokens.shape[1]
        tok = (torch.argmax(staged.head(head, h)[:, -1], -1) if s == S - 1
               else torch.zeros(tokens.shape[0], dtype=torch.int64, device=device))
        return broadcast([tok], S - 1, ax.group)[0]

    return _greedy(step, prompt, steps, device)
