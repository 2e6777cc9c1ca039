"""Tree arithmetic for the update rules and the engine.

The port of :mod:`distkeras_tpu.utils.pytree` as far as the ported rules
need it.  Parameters are name -> tensor dicts here; a tree is a tensor, or
a dict, list or tuple of trees, and every helper maps over the tensors.
"""

from __future__ import annotations

import torch

__all__ = [
    "bcast", "tree_add", "tree_leaves", "tree_map", "tree_sub", "tree_where", "tree_zeros_like",
]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a tree, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def bcast(value: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``value`` with trailing unit dims so that it broadcasts over ``x``: a
    scalar as is, one value per worker (``[n]``: a mask, a staleness)
    against ``[n, ...]`` leaves."""
    return value.reshape(value.shape + (1,) * (x.dim() - value.dim()))


def tree_where(pred, a, b):
    """Per-leaf select.  ``pred`` is a bool scalar, or one bool per worker
    (``[n]``) when the leaves of ``b`` carry a leading worker dim."""
    pred = torch.as_tensor(pred)
    return tree_map(lambda x, y: torch.where(bcast(pred.to(y.device), y), x, y), a, b)
