"""Carry weights from the JAX package's flax models into the port's modules.

The JAX models and their ports initialise from different random streams, so
a parity check builds the parameters once in flax and loads them here.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_flax"]


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
