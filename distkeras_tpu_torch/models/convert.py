"""Carry weights from the JAX package's flax models into the port's modules.

The JAX models and their ports initialise from different random streams, so
a parity check builds the parameters once in flax and loads them here:
:func:`params_from_flax` for the transformers, :func:`variables_from_flax`
for the model zoo, whose BatchNorm statistics come along as buffers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.models import zoo

__all__ = ["params_from_flax", "variables_from_flax"]


def params_from_flax(module, flax_params):
    """Load the flax parameter tree of a ``TransformerLM`` or
    ``TransformerClassifier`` (``variables["params"]`` or the whole
    variables dict, as numpy or JAX arrays) into the matching port module
    ``module`` and return its parameters as a name -> tensor dict.

    Layout hazards handled here:

    * ``qkv`` is a DenseGeneral with kernel ``[D, 3, H, hd]`` and bias
      ``[3, H, hd]``; the port's Linear takes ``[3*H*hd, D]``.
    * ``proj`` has kernel ``[H, hd, D]``; the port's Linear takes ``[D, H*hd]``.
    * flax Dense kernels are ``[in, out]``; torch Linear weights ``[out, in]``.
    * LayerNorm ``scale`` is torch's ``weight``.
    * The final LayerNorm is the top-level ``LayerNorm_0``, whose name
      collides with each block's own ``LayerNorm_0``.
    """
    tree = flax_params.get("params", flax_params)

    def arr(x):
        return torch.tensor(np.asarray(x))  # a writable copy

    def dense(prefix, node):
        return {prefix + "weight": arr(np.asarray(node["kernel"]).T),
                prefix + "bias": arr(node["bias"])}

    def layer_norm(prefix, node):
        return {prefix + "weight": arr(node["scale"]), prefix + "bias": arr(node["bias"])}

    sd = {
        "tok_embed.weight": arr(tree["tok_embed"]["embedding"]),
        "pos_embed.weight": arr(tree["pos_embed"]["embedding"]),
    }
    for i in range(len(module.blocks)):
        node, pre = tree[f"block_{i}"], f"blocks.{i}."
        attn = node["_SelfAttention_0"]
        qkv_kernel = np.asarray(attn["qkv"]["kernel"])        # [D, 3, H, hd]
        proj_kernel = np.asarray(attn["proj"]["kernel"])      # [H, hd, D]
        dim = qkv_kernel.shape[0]
        sd[pre + "attn.qkv.weight"] = arr(qkv_kernel.reshape(dim, -1).T)
        sd[pre + "attn.qkv.bias"] = arr(np.asarray(attn["qkv"]["bias"]).reshape(-1))
        sd[pre + "attn.proj.weight"] = arr(proj_kernel.reshape(-1, dim).T)
        sd[pre + "attn.proj.bias"] = arr(attn["proj"]["bias"])
        sd.update(layer_norm(pre + "ln1.", node["LayerNorm_0"]))
        sd.update(layer_norm(pre + "ln2.", node["LayerNorm_1"]))
        sd.update(dense(pre + "fc1.", node["Dense_0"]))
        sd.update(dense(pre + "fc2.", node["Dense_1"]))
    sd.update(layer_norm("final_ln.", tree["LayerNorm_0"]))
    head = "lm_head" if hasattr(module, "lm_head") else "head"
    sd.update(dense(head + ".", tree[head]))
    module.load_state_dict(sd, strict=True)
    return {name: p.detach() for name, p in module.named_parameters()}


def _zoo_paths(module) -> dict:
    """The port's layer names of a zoo model -> the flax module path of the
    same layer, in the JAX model's auto-naming."""
    if isinstance(module, zoo.MLP):
        paths = {f"hidden.{i}": (f"Dense_{i}",) for i in range(len(module.hidden))}
        paths["head"] = (f"Dense_{len(module.hidden)}",)
        return paths
    if isinstance(module, (zoo.MNISTCNN, zoo.CIFARCNN)):
        paths = {f"convs.{i}": (f"Conv_{i}",) for i in range(len(module.convs))}
        return {**paths, "fc": ("Dense_0",), "head": ("Dense_1",)}
    if isinstance(module, zoo.ResNet20):
        paths = {"stem": ("Conv_0",), "stem_bn": ("BatchNorm_0",), "head": ("Dense_0",)}
        for i, block in enumerate(module.blocks):
            node = f"_ResBlock_{i}"
            paths.update({f"blocks.{i}.conv1": (node, "Conv_0"),
                          f"blocks.{i}.bn1": (node, "BatchNorm_0"),
                          f"blocks.{i}.conv2": (node, "Conv_1"),
                          f"blocks.{i}.bn2": (node, "BatchNorm_1")})
            if block.proj is not None:
                paths[f"blocks.{i}.proj"] = (node, "Conv_2")
        return paths
    if isinstance(module, zoo.TextCNN):
        paths = {f"convs.{i}": (f"Conv_{i}",) for i in range(len(module.convs))}
        return {**paths, "embed": ("Embed_0",), "head": ("Dense_0",)}
    raise TypeError(f"no flax layout known for {type(module).__name__}")


def variables_from_flax(module, variables):
    """Load a zoo model's flax variables (``{"params": ..., "batch_stats":
    ...}``, as numpy or JAX arrays) into the matching port module ``module``
    and return ``(params, buffers)`` as name -> tensor dicts, the state the
    port's engine and ``TrainedModel`` take.

    Layouts: a flax ``Conv`` kernel ``[*kernel, in, out]`` becomes ``[out,
    in, *kernel]`` (HWIO -> OIHW; ``[k, in, out]`` -> ``[out, in, k]``); a
    ``Dense`` kernel ``[in, out]`` becomes ``[out, in]``; BatchNorm's
    ``scale``/``bias`` are its parameters and ``batch_stats``
    ``mean``/``var`` its ``running_mean``/``running_var`` buffers; an
    ``Embed``'s ``embedding`` is the table as is.
    """
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {})

    def node(tree, path):
        for key in path:
            tree = tree[key]
        return {k: np.asarray(v) for k, v in tree.items()}

    sd = {}
    layers = dict(module.named_modules())
    for name, path in _zoo_paths(module).items():
        layer, p = layers[name], node(params, path)
        if isinstance(layer, nn.Linear):
            sd[name + ".weight"], sd[name + ".bias"] = p["kernel"].T, p["bias"]
        elif isinstance(layer, zoo.Conv):
            kernel = p["kernel"]
            spatial = kernel.ndim - 2
            sd[name + ".weight"] = kernel.transpose((spatial + 1, spatial, *range(spatial)))
            if layer.bias is not None:
                sd[name + ".bias"] = p["bias"]
        elif isinstance(layer, zoo.BatchNorm):
            s = node(stats, path)
            sd.update({name + ".weight": p["scale"], name + ".bias": p["bias"],
                       name + ".running_mean": s["mean"], name + ".running_var": s["var"]})
        elif isinstance(layer, nn.Embedding):
            sd[name + ".weight"] = p["embedding"]
    module.load_state_dict({k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()},
                           strict=True)
    return ({name: p.detach() for name, p in module.named_parameters()},
            {name: b.detach().clone() for name, b in module.named_buffers()})
