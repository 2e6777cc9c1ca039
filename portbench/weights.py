"""Weights from ``--seed``, made on the card in one draw.

The benchmark lays out each configuration's parameters itself (names and
shapes as the port's modules name them; a driver checks that the two
agree), draws every value in one ``torch.randn`` call from a generator on
the card seeded with ``--seed``, and scales each leaf in place.  The same
seed on the same card gives the same weights, so the reference makes them
again after the window instead of keeping a copy.

Scales: embeddings ``N(0, 1/d)``, matrices ``N(0, 1/fan_in)``, biases and
LayerNorm offsets ``N(0, 0.02^2)``, LayerNorm scales ``1 + N(0, 0.02^2)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

Table = List[Tuple[str, Tuple[int, ...]]]

#: spread of biases and LayerNorm offsets and scales
SMALL = 0.02


def _block(prefix: str, d: int) -> Table:
    return [(f"{prefix}ln1.weight", (d,)), (f"{prefix}ln1.bias", (d,)),
            (f"{prefix}attn.qkv.weight", (3 * d, d)), (f"{prefix}attn.qkv.bias", (3 * d,)),
            (f"{prefix}attn.proj.weight", (d, d)), (f"{prefix}attn.proj.bias", (d,)),
            (f"{prefix}ln2.weight", (d,)), (f"{prefix}ln2.bias", (d,))]


def table(config: dict) -> Table:
    """Every parameter of the configuration, in the port's names."""
    if config["port_class"] == "TransformerLM":
        d, ff, v = config["n_embd"], config["n_inner"], config["vocab_size"]
        out = [("tok_embed.weight", (v, d)), ("pos_embed.weight", (config["n_positions"], d))]
        for i in range(config["n_layer"]):
            p = f"blocks.{i}."
            out += _block(p, d)
            out += [(f"{p}fc1.weight", (ff, d)), (f"{p}fc1.bias", (ff,)),
                    (f"{p}fc2.weight", (d, ff)), (f"{p}fc2.bias", (d,))]
        return out + [("final_ln.weight", (d,)), ("final_ln.bias", (d,)),
                      ("lm_head.weight", (v, d)), ("lm_head.bias", (v,))]
    raise KeyError(f"no parameter table for {config['port_class']}")


def scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """``(mean, std)`` of one leaf's draw."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return 0.0, SMALL
    if len(shape) == 1:  # a LayerNorm's scale
        return 1.0, SMALL
    return 0.0, 1.0 / math.sqrt(shape[-1])  # an embedding's width, a matrix's fan-in


def make(config: dict, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """The configuration's float32 weights from ``seed``, on ``device``:
    views of one buffer drawn in one call."""
    import torch

    leaves = table(config)
    sizes = [math.prod(shape) for _, shape in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape), n in zip(leaves, sizes):
        mean, std = scale(name, shape)
        view = flat[at:at + n].view(shape)
        view.mul_(std).add_(mean)
        out[name] = view
        at += n
    return out

