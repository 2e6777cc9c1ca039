"""Model / weight serialization — the port of
:mod:`distkeras_tpu.utils.serialization`.

Mirrors ``distkeras/utils.py :: serialize_keras_model`` /
``deserialize_keras_model`` (architecture JSON + weight arrays in a dict),
for Keras 3 models, plus numpy-native (de)serialization of the port's
parameter trees (name -> tensor dicts).  Nothing here uses pickle for model
weights: weights travel as raw numpy arrays inside an ``.npz`` blob.

A blob holds the tree's leaves as ``leaf_0, leaf_1, ...`` in the order
``jax.tree.flatten`` gives them (a dict's keys sorted), beside a
``__treedef__`` entry that describes the tree.  The port writes the same
leaf order, so a flat dict of arrays written by either package loads leaf
by leaf into the other.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict

import numpy as np
import torch

__all__ = [
    "serialize_keras_model",
    "deserialize_keras_model",
    "uniform_weights",
    "params_to_bytes",
    "params_from_bytes",
    "history_to_json",
]


def serialize_keras_model(model) -> Dict[str, Any]:
    """Architecture-JSON + weights dict, like the reference's utils.

    Reference parity: ``distkeras/utils.py :: serialize_keras_model`` returns
    ``{'model': model.to_json(), 'weights': model.get_weights()}``.
    """
    return {"model": model.to_json(), "weights": [np.asarray(w) for w in model.get_weights()]}


def deserialize_keras_model(blob: Dict[str, Any]):
    """Rebuild a Keras model from :func:`serialize_keras_model` output."""
    import keras  # lazy: keras is optional for the in-tree model path

    model = keras.models.model_from_json(blob["model"])
    model.set_weights(blob["weights"])
    return model


def uniform_weights(model, bounds=(-0.5, 0.5), seed: int | None = None):
    """Re-initialise all model weights uniformly in ``bounds`` (reference parity:
    ``distkeras/utils.py :: uniform_weights``)."""
    rng = np.random.default_rng(seed)
    lo, hi = bounds
    model.set_weights([rng.uniform(lo, hi, w.shape).astype(w.dtype) for w in model.get_weights()])
    return model


# -- parameter trees <-> bytes ------------------------------------------------

def _flatten(tree):
    """Leaves and a structure description, in ``jax.tree.flatten``'s order:
    dict keys sorted, lists and tuples in order, anything else a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, children = [], []
        for key in keys:
            sub_leaves, sub_def = _flatten(tree[key])
            leaves += sub_leaves
            children.append(sub_def)
        return leaves, ("dict", keys, children)
    if isinstance(tree, (list, tuple)):
        leaves, children = [], []
        for item in tree:
            sub_leaves, sub_def = _flatten(item)
            leaves += sub_leaves
            children.append(sub_def)
        return leaves, (type(tree).__name__, None, children)
    return [tree], ("leaf", None, None)


def _unflatten(treedef, leaves):
    kind, keys, children = treedef
    if kind == "leaf":
        return next(leaves)
    items = [_unflatten(child, leaves) for child in children]
    if kind == "dict":
        return dict(zip(keys, items))
    return tuple(items) if kind == "tuple" else items


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def params_to_bytes(params) -> bytes:
    """Flatten a tree of tensors (or arrays) to a self-describing npz blob."""
    leaves, treedef = _flatten(params)
    buf = io.BytesIO()
    np.savez(
        buf,
        __treedef__=np.frombuffer(repr(treedef).encode(), dtype=np.uint8),
        **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)},
    )
    return buf.getvalue()


def params_from_bytes(blob: bytes, like) -> Any:
    """Rebuild a tree from :func:`params_to_bytes` output (the port's or the
    JAX package's), using ``like``'s structure: each leaf becomes a tensor
    on the device and of the dtype of ``like``'s leaf where that is a
    tensor, else a numpy array."""
    data = np.load(io.BytesIO(blob), allow_pickle=False)
    like_leaves, treedef = _flatten(like)
    n = len(data.files) - 1
    if n != len(like_leaves):
        raise ValueError(f"the blob holds {n} leaves, the tree given has {len(like_leaves)}")
    leaves = []
    for i, ref in enumerate(like_leaves):
        value = data[f"leaf_{i}"]
        if isinstance(ref, torch.Tensor):
            value = torch.from_numpy(np.array(value)).to(device=ref.device, dtype=ref.dtype)
        leaves.append(value)
    return _unflatten(treedef, iter(leaves))


def history_to_json(history) -> str:
    return json.dumps(history, default=float)
