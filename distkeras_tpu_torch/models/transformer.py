"""Transformer classifier and language model.

The port of :mod:`distkeras_tpu.models.transformer` for the single-device,
non-decode forward: pre-LayerNorm encoder blocks whose attention goes
through :func:`distkeras_tpu_torch.parallel.ring.attention`, so a CUDA input
runs the flash-attention kernel, forward and backward.  Dropout draws its
masks from the ``torch.Generator`` a training call passes in (flax's
``dropout`` rng), never from torch's global generator.  KV-cache decode,
sequence parallelism
(``seq_axis``) and sequence packing (``packed=True``) raise
``NotImplementedError`` naming the ROADMAP item that brings them.

Out-of-range ids gather as the JAX package's flax ``nn.Embed`` does
(``jnp.take`` in its ``"fill"`` mode), on the device and without a host
sync: a token in ``[-vocab, 0)`` wraps to row ``vocab + token``, a token
outside ``[-vocab, vocab)`` and a position at or past ``max_len`` read a
row of NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.parallel.ring import attention

__all__ = ["TransformerClassifier", "TransformerEncoderBlock", "TransformerLM"]

_LN_EPS = 1e-6  # flax LayerNorm's default, used by the blocks and the final LN
# flax's lecun_normal draws from a normal truncated at two standard
# deviations, scaled up by 1 / this to keep the requested variance
_TRUNC_STD_CORRECTION = 0.87962566103423978

_DECODE = "KV-cache decode comes with the serving slice (ROADMAP Queue A item 16)"
_SEQ_AXIS = "seq_axis (ring attention) comes with sequence parallelism (ROADMAP Queue A item 14)"
_PACKED = "packed=True comes with datapipe sequence packing (ROADMAP Queue A item 11)"


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
    draw = torch.empty(weight.shape, dtype=weight.dtype)
    nn.init.trunc_normal_(draw, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    weight.copy_(draw)


def _dropout(x: torch.Tensor, rate: float, training: bool, generator) -> torch.Tensor:
    """flax ``nn.Dropout``: in training keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``.  The mask is
    drawn with ``torch.rand`` from ``generator`` (``F.dropout`` takes none)."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError(
            "dropout in training draws from a torch.Generator: pass "
            "apply(..., training=True, generator=g)"
        )
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def _take_fill(embed: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``embed(ids)`` with ``jnp.take(table, ids, axis=0)``'s ``"fill"``
    semantics: ids in ``[-n, 0)`` wrap to ``n + id``, ids outside
    ``[-n, n)`` give a NaN row.  Computed on the device, with no host sync."""
    n = embed.num_embeddings
    rows = embed(ids.remainder(n))
    valid = (ids >= -n) & (ids < n)
    return torch.where(valid[..., None], rows, float("nan"))


def _normal_(weight: torch.Tensor, std: float, generator) -> None:
    draw = torch.empty(weight.shape, dtype=weight.dtype)
    nn.init.normal_(draw, std=std, generator=generator)
    weight.copy_(draw)


class _SelfAttention(nn.Module):
    """Multi-head self-attention: fused QKV projection, attention over
    ``[batch, seq, heads, head_dim]``, output projection."""

    def __init__(self, dim: int, heads: int, seq_axis: Optional[str] = None,
                 causal: bool = False):
        super().__init__()
        if seq_axis is not None:
            raise NotImplementedError(_SEQ_AXIS)
        self.heads = heads
        self.head_dim = dim // heads
        self.causal = causal
        self.qkv = nn.Linear(dim, 3 * heads * self.head_dim)
        self.proj = nn.Linear(heads * self.head_dim, dim)

    def forward(self, x, training: bool = False, decode: bool = False, segment_ids=None):
        if decode:
            raise NotImplementedError(_DECODE)
        b, l, _ = x.shape
        # [b, l, 3, h, hd]: q, k and v are strided views the kernel reads as is
        q, k, v = self.qkv(x).view(b, l, 3, self.heads, self.head_dim).unbind(2)
        out = attention(q, k, v, causal=self.causal, segment_ids=segment_ids)
        return self.proj(out.reshape(b, l, self.heads * self.head_dim))


class TransformerEncoderBlock(nn.Module):
    """Pre-LayerNorm block: ``x + attn(ln(x))``, then ``x + mlp(ln(x))``
    with a tanh-approximated GELU (flax's ``nn.gelu``)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 seq_axis: Optional[str] = None, causal: bool = False,
                 dropout: float = 0.0, ln_eps: float = _LN_EPS):
        super().__init__()
        self.dropout = dropout
        self.ln1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = _SelfAttention(dim, heads, seq_axis, causal)
        self.ln2 = nn.LayerNorm(dim, eps=ln_eps)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x, training: bool = False, decode: bool = False, segment_ids=None,
                generator: Optional[torch.Generator] = None):
        h = self.attn(self.ln1(x), training, decode, segment_ids=segment_ids)
        x = x + _dropout(h, self.dropout, training, generator)
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + _dropout(h, self.dropout, training, generator)


class _TokenEncoder(nn.Module):
    """Shared classifier/LM trunk: token + positional embeddings, the block
    stack and the final LayerNorm (flax's ``_encode_tokens``)."""

    def __init__(self, vocab_size: int, dim: int, heads: int, num_layers: int,
                 max_len: int, seq_axis: Optional[str], causal: bool, dropout: float):
        super().__init__()
        if seq_axis is not None:
            raise NotImplementedError(_SEQ_AXIS)
        self.vocab_size = vocab_size
        self.dim = dim
        self.heads = heads
        self.num_layers = num_layers
        self.max_len = max_len
        self.tok_embed = nn.Embedding(vocab_size, dim)
        self.pos_embed = nn.Embedding(max_len, dim)
        self.blocks = nn.ModuleList(
            TransformerEncoderBlock(dim, heads, causal=causal, dropout=dropout)
            for _ in range(num_layers)
        )
        self.final_ln = nn.LayerNorm(dim, eps=_LN_EPS)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every weight as the JAX package's flax initialisers do:
        embeddings normal with std ``1/sqrt(dim)``, dense kernels
        lecun-normal with zero bias, LayerNorms at identity.  ``generator``
        (a CPU ``torch.Generator``) makes the draw reproducible."""
        for embed in (self.tok_embed, self.pos_embed):
            _normal_(embed.weight, math.sqrt(1.0 / self.dim), generator)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, module.in_features, generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()

    def encode(self, tokens, training: bool = False, generator=None):
        if tokens.dim() != 2:
            raise ValueError(f"tokens must be [batch, seq], got shape {tuple(tokens.shape)}")
        tokens = tokens.long()
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = _take_fill(self.tok_embed, tokens) + _take_fill(self.pos_embed, pos)[None]
        for block in self.blocks:
            x = block(x, training, generator=generator)
        return self.final_ln(x)


class TransformerLM(_TokenEncoder):
    """Causal language model over ``[batch, seq]`` int tokens, emitting
    per-token next-token logits ``[batch, seq, vocab]``."""

    #: trained against per-token labels ``[batch, seq]``
    per_token_labels = True

    def __init__(self, vocab_size: int, dim: int = 128, heads: int = 4,
                 num_layers: int = 2, max_len: int = 2048,
                 seq_axis: Optional[str] = None, dropout: float = 0.0,
                 packed: bool = False, generator: Optional[torch.Generator] = None):
        if packed:
            raise NotImplementedError(_PACKED)
        super().__init__(vocab_size, dim, heads, num_layers, max_len, seq_axis,
                         causal=True, dropout=dropout)
        self.lm_head = nn.Linear(dim, vocab_size)
        self.reset_parameters(generator)

    def forward(self, tokens, training: bool = False, decode: bool = False, generator=None):
        if decode:
            raise NotImplementedError(_DECODE)
        return self.lm_head(self.encode(tokens, training, generator))

    def decode_spec(self, params):
        """Slice ``params`` (parameter name -> tensor) into the layout the
        serving engine consumes: embedding tables, per-block subtrees, final
        LayerNorm, LM head, plus static config.  Kept next to the model so
        the serving slice cannot drift from the names this module builds."""

        def sub(prefix):
            return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}

        return {
            "config": {
                "dim": self.dim, "heads": self.heads,
                "head_dim": self.dim // self.heads,
                "num_layers": self.num_layers, "max_len": self.max_len,
                "vocab_size": self.vocab_size,
                "ln_eps": _LN_EPS,
            },
            "embed": {
                "tok": params["tok_embed.weight"],
                "pos": params["pos_embed.weight"],
            },
            "blocks": [sub(f"blocks.{i}.") for i in range(self.num_layers)],
            "final_ln": sub("final_ln."),
            "head": sub("lm_head."),
        }


class TransformerClassifier(_TokenEncoder):
    """Sequence classifier over ``[batch, seq]`` int tokens: per-token
    logits mean-pooled over the sequence, ``[batch, num_classes]``."""

    def __init__(self, vocab_size: int, num_classes: int = 2, dim: int = 128,
                 heads: int = 4, num_layers: int = 2, max_len: int = 2048,
                 seq_axis: Optional[str] = None, causal: bool = False,
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__(vocab_size, dim, heads, num_layers, max_len, seq_axis,
                         causal=causal, dropout=dropout)
        self.num_classes = num_classes
        self.head = nn.Linear(dim, num_classes)
        self.reset_parameters(generator)

    def forward(self, tokens, training: bool = False, generator=None):
        token_logits = self.head(self.encode(tokens, training, generator))  # [b, seq, C]
        return token_logits.sum(dim=1) / tokens.shape[1]
