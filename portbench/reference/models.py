"""The architecture as the configuration states it, in plain PyTorch over
a name -> tensor dict of weights (the port's parameter names).

GPT-2 as ``TransformerLM`` runs it: learned token and position embeddings,
pre-LayerNorm blocks (fused QKV laid out ``[3, heads, head_dim]``, causal
softmax attention, output projection; a tanh-GELU MLP), a final LayerNorm
and an untied head with a bias.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _ln(x, w, p, eps):
    return F.layer_norm(x, (x.shape[-1],), w[p + ".weight"], w[p + ".bias"], eps)


def _attention(x, w, p, heads, mm):
    b, l, d = x.shape
    hd = d // heads
    qkv = mm.linear(x, w[p + "attn.qkv.weight"], w[p + "attn.qkv.bias"]).view(b, l, 3, heads, hd)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # [b, heads, l, hd]
    s = mm.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    hidden = torch.ones(l, l, dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(hidden, float("-inf"))
    o = mm.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, l, d)
    return mm.linear(o, w[p + "attn.proj.weight"], w[p + "attn.proj.bias"])


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def lm_logits(w, tokens, config, mm):
    """GPT-2's next-token logits ``[batch, seq, vocab]`` for ``tokens``."""
    eps, heads = config["layer_norm_epsilon"], config["n_head"]
    x = w["tok_embed.weight"][tokens] + w["pos_embed.weight"][: tokens.shape[1]][None]
    for i in range(config["n_layer"]):
        p = f"blocks.{i}."
        x = x + _attention(_ln(x, w, p + "ln1", eps), w, p, heads, mm)
        h = _gelu(mm.linear(_ln(x, w, p + "ln2", eps), w[p + "fc1.weight"], w[p + "fc1.bias"]))
        x = x + mm.linear(h, w[p + "fc2.weight"], w[p + "fc2.bias"])
    return mm.linear(_ln(x, w, "final_ln", eps), w["lm_head.weight"], w["lm_head.bias"])


def lm_loss(w, tokens, labels, config, mm):
    """Mean next-token cross-entropy over every position."""
    logits = lm_logits(w, tokens, config, mm).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long()).mean()


def loss_fn(config):
    """The configuration's training loss ``(weights, x, y, products)``."""
    if config["port_class"] != "TransformerLM":
        raise KeyError(f"no reference for {config['port_class']}")
    return lambda w, x, y, mm: lm_loss(w, x, y, config, mm)
