"""Metric functions — the port of :mod:`distkeras_tpu.ops.metrics`
(``metrics=['accuracy']`` and the per-token LM accuracy)."""

from __future__ import annotations

import torch

__all__ = ["accuracy", "token_accuracy", "get_metric", "per_token_metric_names"]

#: every alias get_metric resolves to the classifier accuracy — kept in one
#: place so the per-token rewrite below can't drift from the registry
_ACCURACY_ALIASES = ("accuracy", "acc", "categorical_accuracy")


def per_token_metric_names(metrics):
    """Canonicalise a metrics spec for per-token (LM) models: any classifier
    accuracy alias becomes ``token_accuracy``.  Callables pass through."""
    return tuple(
        "token_accuracy"
        if isinstance(m, str) and m.lower() in _ACCURACY_ALIASES
        else m
        for m in metrics
    )


def accuracy(preds, labels):
    """Top-1 accuracy; labels may be class indices or one-hot/prob vectors."""
    preds = torch.as_tensor(preds)
    labels = torch.as_tensor(labels, device=preds.device)
    if preds.dim() > 1 and preds.shape[-1] > 1:
        pred_idx = torch.argmax(preds, dim=-1)
    else:
        pred_idx = (preds.reshape(-1) > 0.5).to(torch.int32)
    if labels.dim() > 1 and labels.shape[-1] > 1:
        label_idx = torch.argmax(labels, dim=-1)
    else:
        label_idx = labels.reshape(-1).to(torch.int32)
    return torch.mean((pred_idx == label_idx).to(torch.float32))


def token_accuracy(preds, labels):
    """Next-token top-1 accuracy: preds [B, T, V], labels int [B, T]."""
    preds = torch.as_tensor(preds)
    labels = torch.as_tensor(labels, device=preds.device).to(torch.int32)
    return torch.mean((torch.argmax(preds, dim=-1) == labels).to(torch.float32))


def get_metric(spec):
    if callable(spec):
        return spec
    name = str(spec).lower()
    if name in _ACCURACY_ALIASES:
        return accuracy
    if name in ("token_accuracy", "lm_accuracy"):
        return token_accuracy
    raise ValueError(f"unknown metric {spec!r}")
