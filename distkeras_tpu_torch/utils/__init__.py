"""Utilities: tree arithmetic over name -> tensor dicts (the port of
:mod:`distkeras_tpu.utils` as far as the ported rules need it)."""

from distkeras_tpu_torch.utils.pytree import (
    tree_add,
    tree_leaves,
    tree_map,
    tree_sub,
    tree_where,
    tree_zeros_like,
)

__all__ = ["tree_add", "tree_leaves", "tree_map", "tree_sub", "tree_where", "tree_zeros_like"]
