"""Loss registry with Keras-string parity.

The port of :mod:`distkeras_tpu.ops.losses`: the same strings resolve to
functions ``loss(preds, labels) -> scalar tensor``, each in a logits and a
probabilities form, with the same formulas (optax's for the logits forms).
``labels`` may be a tensor or a numpy array; it is moved to ``preds``'s
device.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["get_loss"]

_EPS = 1e-7


def _labels(labels, preds, dtype=None) -> torch.Tensor:
    return torch.as_tensor(labels, device=preds.device, dtype=dtype)


def _one_hot(idx: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot rows; an index outside ``[0, num_classes)`` gives a row of
    zeros, as ``jax.nn.one_hot`` does (``F.one_hot`` would raise)."""
    classes = torch.arange(num_classes, device=idx.device)
    return (idx[..., None] == classes).to(torch.float32)


def _maybe_onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """A float label of width ``num_classes`` is a soft target and passes
    through; anything else is one-hot encoded from its first entry per row
    (``labels.reshape(B, -1)[..., 0]``)."""
    if labels.dim() >= 1 and labels.shape[-1] == num_classes and labels.is_floating_point():
        return labels
    return _one_hot(labels.reshape(labels.shape[0], -1)[..., 0].to(torch.int32), num_classes)


def _categorical_crossentropy(from_logits: bool):
    def loss(preds, labels):
        labels = _maybe_onehot(_labels(labels, preds), preds.shape[-1])
        if from_logits:
            return -(labels * F.log_softmax(preds, dim=-1)).sum(-1).mean()
        p = preds.clamp(_EPS, 1.0 - _EPS)
        return -(labels * torch.log(p)).sum(-1).mean()

    return loss


def _binary_crossentropy(from_logits: bool):
    def loss(preds, labels):
        preds = preds.reshape(preds.shape[0], -1)
        labels = _labels(labels, preds, preds.dtype).reshape(preds.shape)
        if from_logits:
            return -(labels * F.logsigmoid(preds) + (1 - labels) * F.logsigmoid(-preds)).mean()
        p = preds.clamp(_EPS, 1.0 - _EPS)
        return -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p)).mean()

    return loss


def _mse(preds, labels):
    labels = _labels(labels, preds, preds.dtype).reshape(preds.shape)
    return torch.mean(torch.square(preds - labels))


def _mae(preds, labels):
    labels = _labels(labels, preds, preds.dtype).reshape(preds.shape)
    return torch.mean(torch.abs(preds - labels))


def _per_token(preds, labels, from_logits: bool) -> torch.Tensor:
    """Per-token negative log-likelihood of ``labels`` (in range) under
    ``preds`` ``[B, T, V]``."""
    if from_logits:
        logp = F.log_softmax(preds, dim=-1)
        return -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    p = preds.clamp(_EPS, 1.0 - _EPS)
    return -torch.log(torch.gather(p, -1, labels[..., None].long())[..., 0])


def _token_crossentropy(from_logits: bool):
    """Per-token LM crossentropy: preds [B, T, V], labels int [B, T]; mean
    over batch and tokens."""

    def loss(preds, labels):
        labels = _labels(labels, preds).to(torch.int32)
        return _per_token(preds, labels, from_logits).mean()

    return loss


def _masked_token_crossentropy(from_logits: bool):
    """:func:`_token_crossentropy` with an ignore label: positions whose
    label is ``< 0`` (the sequence-packing convention) contribute nothing,
    and the mean runs over real tokens only."""

    def loss(preds, labels):
        labels = _labels(labels, preds).to(torch.int32)
        mask = (labels >= 0).to(preds.dtype)
        per_tok = _per_token(preds, labels.clamp(min=0), from_logits)
        return (per_tok * mask).sum() / mask.sum().clamp(min=1.0)

    return loss


def get_loss(spec, from_logits: bool = True) -> Callable:
    """Resolve a Keras-style loss string (or pass through a callable)."""
    if callable(spec):
        return spec
    name = str(spec).lower()
    if name in ("token_crossentropy", "lm_crossentropy"):
        return _token_crossentropy(from_logits)
    if name in ("masked_token_crossentropy", "packed_crossentropy"):
        return _masked_token_crossentropy(from_logits)
    if name in ("categorical_crossentropy", "sparse_categorical_crossentropy", "crossentropy"):
        return _categorical_crossentropy(from_logits)
    if name in ("binary_crossentropy",):
        return _binary_crossentropy(from_logits)
    if name in ("mse", "mean_squared_error"):
        return _mse
    if name in ("mae", "mean_absolute_error"):
        return _mae
    raise ValueError(f"unknown loss {spec!r}")
