"""Mixture-of-experts models and the expert-parallel placement.

The port of :mod:`distkeras_tpu.models.moe`: a Switch-style sparse MoE
transformer whose expert FFNs are *stacked* along a leading
``[num_experts]`` dim, formulated the GShard/Switch way (static-shape
one-hot dispatch and combine products with a per-expert token capacity),
so no shape depends on the routing.

Routing is top-k: ``top_k=1`` (the default) is Switch, each token going to
its argmax expert scaled by the router probability (the gradient path to
the router); ``top_k > 1`` is GShard-style, each token visiting its k best
experts with renormalised gate weights.  Per-expert capacity is
``ceil(capacity_factor * top_k * N / E)`` slots, filled rank-major (first
choices always outrank second choices); assignments beyond capacity are
dropped.  Ties between equal gates go to the lower expert index, as
``jax.lax.top_k`` orders them.

The load-balance loss ``aux_weight * E * sum_e f_e * P_e`` is written by a
training forward into the ``losses.load_balance`` buffer of each
:class:`MoEFeedForward`; :meth:`~distkeras_tpu_torch.models.TorchModel.apply`
returns it in the post-apply state with its graph to the router, and the
engines add :meth:`~distkeras_tpu_torch.models.TorchModel.aux_loss` (the
sum of every ``losses`` entry) to the objective, as the JAX package's
mutable ``losses`` collection.

Expert parallelism: :func:`expert_partition` is a ``spec_fn`` for
:class:`~distkeras_tpu_torch.parallel.GSPMDEngine` that places dim 0 of the
stacked expert leaves on the model axis.  The expert products go through
one function, :func:`expert_ffn`, which dispatches through
``__torch_function__``: the engine's tensor-parallel mode then sees all
four split leaves in one call and computes only its rank's experts on its
block of the dispatched input, gathering the outputs over the axis once a
layer.  Unsplit (one rank, or any other placement), the plain body runs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function

from distkeras_tpu_torch.models.transformer import (
    _LN_EPS,
    _SelfAttention,
    _lecun_normal_,
    _normal_,
    _take_fill,
)

__all__ = ["MoEEncoderBlock", "MoEFeedForward", "MoETransformerClassifier", "expert_ffn",
           "expert_partition"]

#: the stacked expert leaves of a :class:`MoEFeedForward`
EXPERT_PARAM_NAMES = frozenset({"w1", "b1", "w2", "b2"})


def expert_partition(num_experts: int, axis: str = "model"):
    """``spec_fn(shape, name)`` for :class:`~distkeras_tpu_torch.parallel.GSPMDEngine`:
    dim 0 of every ``w1``/``b1``/``w2``/``b2`` leaf of a
    :class:`MoEFeedForward` (a parameter named ``<...>.moe.<leaf>``, as a
    :class:`MoEEncoderBlock` names it) whose dim 0 is ``num_experts`` goes
    on ``axis``; every other leaf returns ``None`` (the engine's default
    rule).

    Matched by module and leaf name, not by shape alone: a bare-shape rule
    would also capture an attention leaf whose dim 0 happens to equal
    ``num_experts``."""

    def spec_fn(shape, name=None):
        parts = str(name or "").split(".")
        in_moe = len(parts) >= 2 and parts[-2] == "moe"  # MoEEncoderBlock.moe
        if (in_moe and parts[-1] in EXPERT_PARAM_NAMES and len(shape) >= 2
                and shape[0] == num_experts):
            return (axis,)
        return None

    return spec_fn


def _expert_ffn(xin, w1, b1, w2, b2):
    """The expert FFNs over their dispatched tokens: ``xin [E, C, d]``
    through ``w1 [E, d, h]``, ``b1 [E, h]``, tanh-GELU, ``w2 [E, h, d]``,
    ``b2 [E, d]``; ``[E, C, d]`` out."""
    h = F.gelu(torch.einsum("ecd,edh->ech", xin, w1) + b1[:, None], approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None]


def expert_ffn(xin, w1, b1, w2, b2):
    """The expert products of one :class:`MoEFeedForward` as one call that
    a ``TorchFunctionMode`` can take whole (the GSPMD engine's expert
    parallelism); its plain body otherwise."""
    args = (xin, w1, b1, w2, b2)
    if has_torch_function(args):
        return handle_torch_function(expert_ffn, args, *args)
    return _expert_ffn(*args)


def _top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last dim, in
    descending order, equal values in ascending index order."""
    values, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class _Losses(nn.Module):
    """Holds the ``load_balance`` buffer (the JAX ``losses`` collection's
    leaf), so that its state name is ``<...>.losses.load_balance``."""

    def __init__(self):
        super().__init__()
        self.register_buffer("load_balance", torch.zeros(()))


class MoEFeedForward(nn.Module):
    """Routed FFN bank with static-shape dispatch and combine products.

    ``top_k=1`` is Switch (output scaled by the chosen expert's softmax
    probability); ``top_k > 1`` is GShard-style (combine weights are the
    top-k gates renormalised to sum to 1).  Capacity is per expert,
    ``ceil(capacity_factor * top_k * N / E)`` slots, filled rank-major.
    The stacked expert leaves keep the JAX package's layout: ``w1 [E, d,
    h]``, ``b1 [E, h]``, ``w2 [E, h, d]``, ``b2 [E, d]``."""

    def __init__(self, dim: int, num_experts: int, mlp_ratio: int = 4, top_k: int = 1,
                 capacity_factor: float = 1.25, aux_weight: float = 1e-2):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts={num_experts}]")
        self.dim, self.num_experts, self.top_k = dim, num_experts, top_k
        self.capacity_factor, self.aux_weight = capacity_factor, aux_weight
        hidden = dim * mlp_ratio
        self.router = nn.Linear(dim, num_experts)
        self.w1 = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(num_experts, hidden))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(num_experts, dim))
        self.losses = _Losses()
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers: the router and the expert stacks
        lecun-normal (a stack's fan-in counts its expert dim, as flax's
        ``_compute_fans`` does), biases zero."""
        e, d, h = self.w1.shape
        _lecun_normal_(self.router.weight, d, generator)
        self.router.bias.zero_()
        _lecun_normal_(self.w1, e * d, generator)
        _lecun_normal_(self.w2, e * h, generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x, training: bool = False):
        b, t, d = x.shape
        e, k = self.num_experts, self.top_k
        n = b * t
        capacity = max(1, math.ceil(self.capacity_factor * k * n / e))

        tokens = x.reshape(n, d)
        gates = torch.softmax(self.router(tokens).float(), dim=-1)  # [N, E]
        top_gates, top_idx = _top_k(gates, k)  # [N, k]
        onehots = F.one_hot(top_idx, e).float()  # [N, k, E]

        # capacity accounting, rank-major: every rank-0 assignment queues
        # before any rank-1 assignment
        oh_flat = onehots.transpose(0, 1).reshape(k * n, e)  # [kN, E]
        pos = (torch.cumsum(oh_flat, dim=0) - 1.0) * oh_flat
        keep = (pos < capacity).float() * oh_flat
        # jax.nn.one_hot: an index past the capacity is a row of zeros
        slot_ix = pos.sum(-1).long()[:, None]
        slot = (slot_ix == torch.arange(capacity, device=x.device)).float()  # [kN, C]
        disp_ranks = (keep[:, :, None] * slot[:, None, :]).reshape(k, n, e, capacity)
        dispatch = disp_ranks.sum(0)  # [N, E, C]

        scale = top_gates if k == 1 else top_gates / top_gates.sum(-1, keepdim=True)
        combine = torch.einsum("rnec,nr->nec", disp_ranks, scale)

        xin = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), tokens)
        out = expert_ffn(xin, self.w1.to(x.dtype), self.b1.to(x.dtype), self.w2.to(x.dtype),
                         self.b2.to(x.dtype))
        y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), out)

        if training:
            # Switch balance term over rank-0 assignments: 1.0 x aux_weight
            # at perfect balance.  Written in place into the state the
            # adapter passed in, so the post-apply state carries it with its
            # graph (JAX's mutable ``losses`` collection)
            frac = onehots[:, 0].mean(0)
            prob = gates.mean(0)
            self.losses.load_balance.copy_(self.aux_weight * e * torch.sum(frac * prob))
        return y.reshape(b, t, d)


class MoEEncoderBlock(nn.Module):
    """Pre-LayerNorm block: ``x + attn(ln(x))``, then ``x + moe(ln(x))``.
    The attention is the transformer's (the flash kernels on a card)."""

    def __init__(self, dim: int, heads: int, num_experts: int, mlp_ratio: int = 4,
                 top_k: int = 1, capacity_factor: float = 1.25, aux_weight: float = 1e-2,
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.attn = _SelfAttention(dim, heads, seq_axis)
        self.ln2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.moe = MoEFeedForward(dim, num_experts, mlp_ratio, top_k, capacity_factor,
                                  aux_weight)

    def forward(self, x, training: bool = False):
        x = x + self.attn(self.ln1(x), training)
        return x + self.moe(self.ln2(x), training)


class MoETransformerClassifier(nn.Module):
    """Token classifier with MoE encoder blocks: ``[batch, seq]`` int
    tokens in, per-token logits mean-pooled over the sequence out."""

    def __init__(self, vocab_size: int, num_classes: int = 2, dim: int = 64, heads: int = 2,
                 num_layers: int = 2, num_experts: int = 4, mlp_ratio: int = 4,
                 top_k: int = 1, capacity_factor: float = 1.25, aux_weight: float = 1e-2,
                 max_len: int = 2048, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size, self.num_classes, self.dim = vocab_size, num_classes, dim
        self.heads, self.num_layers, self.max_len = heads, num_layers, max_len
        self.tok_embed = nn.Embedding(vocab_size, dim)
        self.pos_embed = nn.Embedding(max_len, dim)
        self.blocks = nn.ModuleList(
            MoEEncoderBlock(dim, heads, num_experts, mlp_ratio, top_k, capacity_factor,
                            aux_weight)
            for _ in range(num_layers)
        )
        self.final_ln = nn.LayerNorm(dim, eps=_LN_EPS)
        self.head = nn.Linear(dim, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Every weight as the JAX package's flax initialisers draw it:
        embeddings normal with std ``1/sqrt(dim)``, dense kernels and expert
        stacks lecun-normal with zero bias, LayerNorms at identity."""
        for embed in (self.tok_embed, self.pos_embed):
            _normal_(embed.weight, math.sqrt(1.0 / self.dim), generator)
        routers = {id(m.router) for m in self.modules() if isinstance(m, MoEFeedForward)}
        for module in self.modules():
            if isinstance(module, MoEFeedForward):
                module.reset_parameters(generator)
            elif isinstance(module, nn.Linear) and id(module) not in routers:
                _lecun_normal_(module.weight, module.in_features, generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()

    def forward(self, tokens, training: bool = False, generator=None):
        """Logits ``[batch, num_classes]``.  ``generator`` is accepted for
        the engines' training call and unused: the model has no dropout."""
        del generator
        if tokens.dim() != 2:
            raise ValueError(f"tokens must be [batch, seq], got shape {tuple(tokens.shape)}")
        tokens = tokens.long()
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = _take_fill(self.tok_embed, tokens) + _take_fill(self.pos_embed, positions)[None]
        for block in self.blocks:
            x = block(x, training)
        token_logits = self.head(self.final_ln(x))
        return token_logits.sum(dim=1) / tokens.shape[1]
