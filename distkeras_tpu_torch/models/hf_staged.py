"""Pretrained GPT-2 -> :class:`StagedLM`: HuggingFace checkpoints on the
pipeline mesh.

The port of :mod:`distkeras_tpu.models.hf_staged`, over PyTorch's
``GPT2LMHeadModel``.  :class:`~distkeras_tpu_torch.models.hf.HuggingFaceModel`
already trains any ``transformers`` model through the data and tensor axes,
but an HF module is a black box to the PIPELINE engine, which needs the
staged ``{"embed", "blocks", "head"}`` layout with homogeneous blocks
stacked ``[num_stages, blocks_per_stage, ...]``.  GPT-2's architecture is
exactly the port's :class:`TransformerEncoderBlock` — pre-LN, tanh-GELU 4x
MLP, learned positions, final LayerNorm, causal attention at
``1/sqrt(head_dim)`` — so a checkpoint converts by pure weight re-layout:

  * ``wte``/``wpe``            -> ``embed`` ``tok_embed``/``pos_embed``
  * per block: ``ln_1``        -> ``ln1``
  *   ``attn.c_attn`` [d, 3d]  -> ``attn.qkv``  [3d, d]
  *   ``attn.c_proj`` [d, d]   -> ``attn.proj`` [d, d]
  *   ``ln_2``                 -> ``ln2``
  *   ``mlp.c_fc/c_proj``      -> ``fc1`` / ``fc2``
  * ``ln_f``                   -> ``head.ln``
  * ``wte`` (tied) or the checkpoint's own ``lm_head`` (untied —
    ``tie_word_embeddings=False``) -> ``head.out``; either way the staged
    layout is untied from here on: fine-tuning trains embed and head
    independently

HF's PyTorch ``Conv1D`` stores ``weight`` as ``(in, out)`` and computes
``x @ weight + bias``; ``nn.Linear`` stores ``(out, in)``, hence the ``.T`` on
every ``Conv1D`` weight (the JAX package's ``.T`` undoes Flax's ``(out,
in)`` kernels into flax's ``(in, out)``; the two transposes are different
re-layouts).  ``c_attn``'s outputs are ordered ``(q|k|v, head,
head_dim)``, the port's ``qkv`` order.  ``lm_head`` is an ``nn.Linear``
already.  GPT-2's LayerNorms use ``layer_norm_epsilon`` (1e-5), passed as
``ln_eps``.  Equality is asserted, not assumed: ``tests/test_torch_hf.py``
checks converted logits against the HF model's own forward.

:func:`gpt2_to_staged` checks that it is handed a ``GPT2LMHeadModel`` and
passes its ``config`` and ``state_dict()`` to :func:`gpt2_state_to_staged`,
which needs no ``transformers``: a config with GPT-2's field names (an
object or a dict) and tensors under GPT-2's state-dict names convert the
same way.

The returned adapter's ``init`` adopts the converted weights (the
:class:`HuggingFaceModel` convention), so the checkpoint becomes the
initial center variable for any trainer — including ``pipeline_stages=S,
fsdp=True``, where the ``[vocab, dim]`` embedding and head this conversion
produces are exactly the leaves the stage-sharding exists for.
``greedy_generate`` and the serving engine decode it unchanged.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Optional

import torch

from distkeras_tpu_torch.models.staged import StagedLM, stack_block_params

__all__ = ["PretrainedStagedLM", "gpt2_state_to_staged", "gpt2_to_staged"]

#: tanh-approximation GELU names (== F.gelu(approximate="tanh"))
_TANH_GELUS = ("gelu_new", "gelu_pytorch_tanh")


@dataclasses.dataclass
class PretrainedStagedLM(StagedLM):
    """A :class:`StagedLM` whose ``init`` adopts converted pretrained
    weights instead of sampling fresh ones (the generator is unused, like
    :meth:`HuggingFaceModel.init`)."""

    def init(self, generator, sample_input):
        del generator, sample_input
        if getattr(self, "_pretrained", None) is None:
            raise RuntimeError("construct via gpt2_to_staged()")
        # host tensors, one dict a part: the engines copy them onto their
        # device (and into their shard layout) themselves
        return {part: dict(leaves) for part, leaves in self._pretrained.items()}, {}


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def gpt2_to_staged(model, num_stages: int,
                   blocks_per_stage: Optional[int] = None,
                   seq_axis: Optional[str] = None) -> PretrainedStagedLM:
    """Convert a ``GPT2LMHeadModel`` (pretrained or fresh) into a
    pipeline-ready :class:`PretrainedStagedLM`.

    ``seq_axis`` builds the ring-attention variant for pp x sp fine-tuning
    (``pipeline_stages=S, seq_shards=k``) — set it here rather than via
    ``dataclasses.replace`` afterwards, which would drop the attached
    ``_pretrained`` checkpoint (replace builds a fresh instance)."""
    _require(
        type(model).__name__ == "GPT2LMHeadModel",
        f"gpt2_to_staged converts GPT2LMHeadModel, got {type(model).__name__}",
    )
    return gpt2_state_to_staged(model.config, model.state_dict(), num_stages,
                                blocks_per_stage, seq_axis)


def gpt2_state_to_staged(config, state_dict, num_stages: int,
                         blocks_per_stage: Optional[int] = None,
                         seq_axis: Optional[str] = None) -> PretrainedStagedLM:
    """:func:`gpt2_to_staged` from a GPT-2 ``config`` (a ``GPT2Config``, or
    any object or dict with its field names) and a ``state_dict`` under
    ``GPT2LMHeadModel``'s names (``transformer.wte.weight``, ...)."""
    cfg = types.SimpleNamespace(**config) if isinstance(config, dict) else config
    activation = getattr(cfg, "activation_function", "gelu_new")
    _require(
        activation in _TANH_GELUS,
        f"block uses tanh-GELU; checkpoint has {activation!r}",
    )
    n_inner = getattr(cfg, "n_inner", None)
    _require(
        n_inner is None or n_inner == 4 * cfg.n_embd,
        f"block MLP is 4x wide; checkpoint has n_inner={n_inner}",
    )
    _require(
        getattr(cfg, "scale_attn_weights", True)
        and not getattr(cfg, "scale_attn_by_inverse_layer_idx", False)
        and not getattr(cfg, "reorder_and_upcast_attn", False),
        "checkpoint uses non-standard attention scaling",
    )
    n_layer = int(cfg.n_layer)
    if blocks_per_stage is None:
        _require(
            n_layer % num_stages == 0,
            f"n_layer={n_layer} does not divide into {num_stages} stages",
        )
        blocks_per_stage = n_layer // num_stages
    _require(
        num_stages * blocks_per_stage == n_layer,
        f"{num_stages} x {blocks_per_stage} != n_layer={n_layer}",
    )

    dim, heads = int(cfg.n_embd), int(cfg.n_head)
    f32 = lambda name: state_dict[name].detach().to("cpu", torch.float32).clone()
    conv = lambda name: f32(name).T.contiguous()  # Conv1D (in, out) -> Linear (out, in)

    def block_params(i):
        pre = f"transformer.h.{i}."
        return {
            "ln1.weight": f32(pre + "ln_1.weight"), "ln1.bias": f32(pre + "ln_1.bias"),
            "attn.qkv.weight": conv(pre + "attn.c_attn.weight"),
            "attn.qkv.bias": f32(pre + "attn.c_attn.bias"),
            "attn.proj.weight": conv(pre + "attn.c_proj.weight"),
            "attn.proj.bias": f32(pre + "attn.c_proj.bias"),
            "ln2.weight": f32(pre + "ln_2.weight"), "ln2.bias": f32(pre + "ln_2.bias"),
            "fc1.weight": conv(pre + "mlp.c_fc.weight"), "fc1.bias": f32(pre + "mlp.c_fc.bias"),
            "fc2.weight": conv(pre + "mlp.c_proj.weight"),
            "fc2.bias": f32(pre + "mlp.c_proj.bias"),
        }

    blocks = stack_block_params([block_params(i) for i in range(n_layer)], num_stages,
                                blocks_per_stage)
    wte = f32("transformer.wte.weight")
    vocab = wte.shape[0]
    if getattr(cfg, "tie_word_embeddings", True):
        head_weight = wte.clone()
    else:
        # untied checkpoints carry their own head (GPT2LMHeadModel's lm_head
        # is then a separate nn.Linear, already (out, in) — no transpose)
        head_weight = f32("lm_head.weight")
        _require(
            tuple(head_weight.shape) == (vocab, dim),
            f"untied lm_head weight has shape {tuple(head_weight.shape)}, "
            f"expected {(vocab, dim)}",
        )
    params = {
        "embed": {"tok_embed.weight": wte, "pos_embed.weight": f32("transformer.wpe.weight")},
        "blocks": blocks,
        "head": {"ln.weight": f32("transformer.ln_f.weight"),
                 "ln.bias": f32("transformer.ln_f.bias"),
                 "out.weight": head_weight, "out.bias": torch.zeros(vocab)},
    }
    staged = PretrainedStagedLM(
        vocab_size=vocab, dim=dim, heads=heads,
        num_stages=num_stages, blocks_per_stage=blocks_per_stage,
        max_len=int(cfg.n_positions), ln_eps=float(cfg.layer_norm_epsilon),
        seq_axis=seq_axis,
    )
    staged._pretrained = params
    return staged
