"""The model FLOPs of one trained sample, which ``train_mfu`` and
``step_mfu.train`` divide by the card's peak.

FLOPs = 6 x the parameters of the matrix products x tokens (forward and
backward), plus attention's two products QK^T and PV (4 FLOPs per head dim
per attended pair forward, three times that with the backward; causal
attention attends about half its pairs).  Not counted: embedding look-ups,
norms, softmax and any recomputation.  So a program that does the same model's work in
less time reads higher, and one that adds work reads no higher.
"""

from __future__ import annotations


def _attention_pairs(seq: int, causal: bool) -> float:
    """Attended (query, key) pairs a sequence, the diagonal included."""
    return seq * (seq + 1) / 2 if causal else float(seq * seq)


def product_params(config: dict) -> int:
    """Parameters of the matrix products one token goes through."""
    if config["port_class"] == "TransformerLM":
        d, layers, ff = config["n_embd"], config["n_layer"], config["n_inner"]
        block = 3 * d * d + d * d + 2 * d * ff  # qkv, proj, fc1, fc2
        return layers * block + d * config["vocab_size"]  # the untied head
    raise KeyError(f"no FLOP count for {config['port_class']}")


def attention_flops_per_sample(config: dict, seq: int) -> float:
    """Attention's QK^T and PV products of one sample, forward and
    backward (3 x the forward's 4 FLOPs per head dim per pair)."""
    d, layers = config["n_embd"], config["n_layer"]
    return 3 * 4 * d * _attention_pairs(seq, True) * layers


def train_flops_per_sample(config: dict, seq: int) -> float:
    """Model FLOPs of one trained sample of ``seq`` tokens."""
    return 6.0 * product_params(config) * seq + attention_flops_per_sample(config, seq)


def attention_shape(config: dict, traffic: dict) -> dict:
    """One attention call of a training step: ``batch``, ``seq``,
    ``heads``, ``head_dim``, ``causal``, the ``dtype`` of its operands, and
    the ``layers`` that each make one such call a step."""
    d, heads = config["n_embd"], config["n_head"]
    return {"batch": traffic["batch_size"], "seq": traffic["seq_len"], "heads": heads,
            "head_dim": d // heads, "causal": True, "dtype": traffic["compute_dtype"],
            "layers": config["n_layer"]}


def attention_pairs(shape: dict) -> float:
    """Attended (query, key) pairs of one call, over its batch and heads."""
    return shape["batch"] * shape["heads"] * _attention_pairs(shape["seq"], shape["causal"])
