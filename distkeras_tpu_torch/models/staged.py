"""Pipeline-staged transformers: the model half of pipeline parallelism.

The port of :mod:`distkeras_tpu.models.staged`.  A stack of homogeneous
pre-LayerNorm encoder blocks (the port's
:class:`~distkeras_tpu_torch.models.transformer.TransformerEncoderBlock`)
is split into ``num_stages`` stages of ``blocks_per_stage`` blocks, and
every block parameter is *stacked* along leading ``[num_stages,
blocks_per_stage]`` dims, so that a stage rank holds a block of those
leaves (:mod:`distkeras_tpu_torch.parallel.pipeline`).  The parameters are
a tree of name -> tensor dicts::

    {"embed": {"tok_embed.weight", "pos_embed.weight"},
     "blocks": {<a block's parameter names>: [S, per_stage, ...]},
     "head": {"ln.weight", "ln.bias", "out.weight", "out.bias"}}

``embed``, ``stage`` and ``head`` are plain functions of explicit
parameters, with no dropout (the JAX package's staged blocks carry none);
``apply`` runs the stages **sequentially**, the one-rank reference that
initialisation, prediction, decode and the equivalence tests use.  The
pipelined schedule is another executor of the same parameters, not another
model.  Every LayerNorm takes ``ln_eps``.

``seq_axis`` (pipeline x sequence parallelism, ``PipelineEngine(
seq_shards=k)``): the blocks run ring attention over that mesh axis
(:func:`~distkeras_tpu_torch.parallel.ring.ring_attention`), on this rank's
block of the sequence, and the engine embeds it at its offset
(``embed(offset=)``).  Decode and serving take the ``seq_axis=None`` twin,
``dataclasses.replace(model, seq_axis=None)``, on the same parameters (the
trainers hand it back).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from distkeras_tpu_torch.models.adapter import ModelAdapter
from distkeras_tpu_torch.models.transformer import (
    KVCache,
    TransformerEncoderBlock,
    _lecun_normal_,
    _normal_,
    packed_positions,
    take_rows,
)

__all__ = ["StagedLM", "StagedTransformer", "stack_block_params"]


def stack_block_params(per_block, num_stages: int, blocks_per_stage: int) -> Dict[str, Any]:
    """Fold a list of per-block parameter dicts (name -> tensor or numpy
    array) into the staged ``[num_stages, blocks_per_stage, ...]`` leaf
    layout: the contract the pipeline engine's stage placement relies on,
    kept in one place so that init and checkpoint conversion cannot drift."""
    def tensor(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))

    out = {}
    for name in per_block[0]:
        stacked = torch.stack([tensor(b[name]) for b in per_block])
        out[name] = stacked.reshape((num_stages, blocks_per_stage) + tuple(stacked.shape[1:]))
    return out


@dataclasses.dataclass
class StagedTransformer(ModelAdapter):
    """Token classifier over ``[batch, seq]`` int inputs with its encoder
    blocks stacked ``[num_stages, blocks_per_stage, ...]`` for pipelining;
    per-token logits mean-pooled over the sequence, ``[batch,
    num_classes]``."""

    vocab_size: int
    num_classes: int = 2
    dim: int = 128
    heads: int = 4
    num_stages: int = 2
    blocks_per_stage: int = 1
    max_len: int = 2048
    ln_eps: float = 1e-6
    seq_axis: Optional[str] = None
    outputs_logits: bool = True

    #: whether the blocks attend causally (the LM's do)
    causal = False

    def __post_init__(self):
        # a template the stage functions call with each block's parameters;
        # on the meta device it holds no memory of its own
        with torch.device("meta"):
            self._block = TransformerEncoderBlock(self.dim, self.heads, seq_axis=self.seq_axis,
                                                  causal=self.causal, ln_eps=self.ln_eps)

    @property
    def num_blocks(self) -> int:
        return self.num_stages * self.blocks_per_stage

    @property
    def _out_width(self) -> int:
        return self.num_classes

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, sample_input) -> Tuple[Dict, Dict]:
        """Fresh parameters from ``generator`` (a CPU ``torch.Generator``),
        drawn as the JAX package's flax initialisers draw them: embeddings
        normal with std ``1/sqrt(dim)``, dense kernels lecun-normal with
        zero bias, LayerNorms at identity.  ``sample_input`` is unused: the
        shapes are fixed by the fields."""
        del sample_input
        embed = {}
        for name, rows in (("tok_embed.weight", self.vocab_size),
                           ("pos_embed.weight", self.max_len)):
            embed[name] = torch.empty(rows, self.dim)
            _normal_(embed[name], math.sqrt(1.0 / self.dim), generator)
        per_block = []
        for _ in range(self.num_blocks):
            block = {}
            for name, p in self._block.named_parameters():
                block[name] = torch.empty(p.shape)
                if p.dim() == 2:
                    _lecun_normal_(block[name], p.shape[1], generator)
                elif name.startswith("ln") and name.endswith(".weight"):
                    block[name].fill_(1.0)
                else:
                    block[name].zero_()
            per_block.append(block)
        out = torch.empty(self._out_width, self.dim)
        _lecun_normal_(out, self.dim, generator)
        head = {"ln.weight": torch.ones(self.dim), "ln.bias": torch.zeros(self.dim),
                "out.weight": out, "out.bias": torch.zeros(self._out_width)}
        blocks = stack_block_params(per_block, self.num_stages, self.blocks_per_stage)
        return {"embed": embed, "blocks": blocks, "head": head}, {}

    # --------------------------------------------- stage pieces (the engine's)
    def embed(self, embed_params, tokens, offset=0, positions=None):
        """Token plus positional embeddings ``[batch, seq, dim]``: positions
        ``offset + arange(seq)``, or the given ``[batch, seq]`` ones
        (sequence packing)."""
        tokens = torch.as_tensor(tokens).long()
        x = take_rows(embed_params["tok_embed.weight"], tokens)
        table = embed_params["pos_embed.weight"]
        if positions is not None:
            return x + take_rows(table, torch.as_tensor(positions).long())
        pos = offset + torch.arange(tokens.shape[1], device=tokens.device)
        return x + take_rows(table, pos)[None]

    def _run_block(self, params, h, **kwargs):
        return torch.func.functional_call(self._block, params, (h,), kwargs)

    def stage(self, stage_params, h, segment_ids=None):
        """One stage: its ``blocks_per_stage`` blocks in turn, their leaves
        carrying a leading ``[blocks_per_stage]`` dim.  ``segment_ids``
        (sequence packing) reaches every block's attention mask."""
        for i in range(next(iter(stage_params.values())).shape[0]):
            h = self._run_block({k: v[i] for k, v in stage_params.items()}, h,
                                segment_ids=segment_ids)
        return h

    def head(self, head_params, h):
        """The final LayerNorm and the output projection, mean-pooled over
        the sequence: ``[batch, num_classes]``."""
        logits = self._token_logits(head_params, h)
        return logits.sum(dim=1) / h.shape[1]

    def _token_logits(self, head_params, h):
        h = F.layer_norm(h, (h.shape[-1],), head_params["ln.weight"], head_params["ln.bias"],
                         self.ln_eps)
        return F.linear(h, head_params["out.weight"], head_params["out.bias"])

    # ----------------------------------------------------------- sequential
    def apply(self, params, state, inputs, training=False, generator=None):
        """The sequential executor: embed, every stage in order, head.
        ``training`` and ``generator`` change nothing (no dropout)."""
        del training, generator
        h = self.embed(params["embed"], inputs)
        for s in range(self.num_stages):
            h = self.stage({k: v[s] for k, v in params["blocks"].items()}, h)
        return self.head(params["head"], h), state


@dataclasses.dataclass
class StagedLM(StagedTransformer):
    """Pipeline-staged causal language model: the staged layout of
    :class:`StagedTransformer` with causal blocks and a per-token vocab
    head, ``[batch, seq, vocab_size]``, trained with
    ``loss="token_crossentropy"`` against per-token labels.  The inherited
    ``num_classes`` does not apply.

    ``packed=True`` consumes sequence-packed ``[batch, width, 2]`` input
    (token and segment-ID channels) through the *sequential* executor:
    per-segment positions, intra-segment attention, trained with
    ``loss="masked_token_crossentropy"``.  The pipeline schedule threads no
    segment IDs, as in the JAX package."""

    per_token_labels: bool = True
    packed: bool = False

    causal = True

    def __post_init__(self):
        if self.num_classes != type(self).num_classes:
            raise ValueError(
                "StagedLM outputs vocab_size-wide logits; num_classes does "
                "not apply — did you mean StagedTransformer?"
            )
        super().__post_init__()

    @property
    def _out_width(self) -> int:
        return self.vocab_size

    def head(self, head_params, h):
        """The final LayerNorm and the vocab projection, per token."""
        return self._token_logits(head_params, h)

    # ----------------------------------------------------------- sequential
    def apply(self, params, state, inputs, training=False, generator=None):
        if not self.packed:
            return super().apply(params, state, inputs, training, generator)
        inputs = torch.as_tensor(inputs)
        tokens, segment_ids = inputs[..., 0], inputs[..., 1].to(torch.int32)
        h = self.embed(params["embed"], tokens, positions=packed_positions(segment_ids))
        for s in range(self.num_stages):
            h = self.stage({k: v[s] for k, v in params["blocks"].items()}, h,
                           segment_ids=segment_ids)
        return self.head(params["head"], h), state

    # ------------------------------------------------------- KV-cache decode
    def init_cache(self, batch_size: int, dtype=torch.float32, device=None,
                   blocks: Optional[int] = None) -> KVCache:
        """Zeroed KV caches for ``blocks`` blocks (every block by default;
        one stage's for the pipelined decode): per block a key and a value
        buffer ``[batch, max_len, heads, head_dim]``."""
        n = self.num_blocks if blocks is None else int(blocks)
        shape = (int(batch_size), self.max_len, self.heads, self.dim // self.heads)
        return KVCache([torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)],
                       [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)])

    def decode_blocks(self, stage_params, cache: KVCache, h):
        """``h`` through the blocks of ``stage_params`` (leaves ``[n, ...]``)
        in decode mode, block ``i`` with the cache's block ``i``, written at
        the cache's cursor (which this does not move)."""
        for i in range(next(iter(stage_params.values())).shape[0]):
            kv = (cache.keys[i], cache.values[i])
            h = self._run_block({k: v[i] for k, v in stage_params.items()}, h, decode=True,
                                kv=kv, index=cache.index)
        return h

    def decode_step(self, params, cache: KVCache, tokens, pos_offset):
        """One decode chunk (the prompt at prefill, then one token a step)
        through the sequential stage stack with the per-block KV caches:
        ``(logits [batch, chunk, vocab], cache)``, the cache written in
        place and its cursor advanced.  The same math as the full-context
        ``apply`` on the prefix."""
        tokens = torch.as_tensor(tokens)
        h = self.embed(params["embed"], tokens, offset=pos_offset)
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in params["blocks"].items()}
        h = self.decode_blocks(flat, cache, h)
        cache.index += tokens.shape[1]
        return self.head(params["head"], h), cache

    def decode_spec(self, params):
        """The staged parameters in the serving engine's layout
        (:mod:`distkeras_tpu_torch.serving.engine`): the ``[S, per_stage,
        ...]`` block stack unfolds into a flat per-block list (the order of
        :meth:`decode_step`), the head splits into the final LayerNorm and
        the vocab projection.  Serving runs the sequential executor."""
        n = self.num_blocks
        flat = {k: v.reshape((n,) + tuple(v.shape[2:])) for k, v in params["blocks"].items()}
        head = params["head"]
        return {
            "config": {
                "dim": self.dim, "heads": self.heads, "head_dim": self.dim // self.heads,
                "num_layers": n, "max_len": self.max_len, "vocab_size": self.vocab_size,
                "ln_eps": self.ln_eps,
            },
            "embed": {"tok": params["embed"]["tok_embed.weight"],
                      "pos": params["embed"]["pos_embed.weight"]},
            "blocks": [{k: v[i] for k, v in flat.items()} for i in range(n)],
            "final_ln": {"weight": head["ln.weight"], "bias": head["ln.bias"]},
            "head": {"weight": head["out.weight"], "bias": head["out.bias"]},
        }
