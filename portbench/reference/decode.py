"""Greedy decoding judged by the full forward.

For a served request, the reference runs GPT-2 once over the prompt and
the served tokens and reads, at each position that produced a served
token, by how much that token's logit lies below the best one.  A greedy
server that computes the model's function serves the reference's best
token, or one within rounding of it.
"""

from __future__ import annotations

import torch

from portbench.reference.models import lm_logits
from portbench.reference.products import products


def _rows(w, config, prompt, tokens, mm):
    seq = torch.as_tensor(list(prompt) + list(tokens[:-1]), dtype=torch.long,
                          device=w["tok_embed.weight"].device)
    logits = lm_logits(w, seq[None], config, mm)[0].float()
    return logits[len(prompt) - 1:]  # the rows that produced tokens[0], tokens[1], ...


@torch.no_grad()
def served_gaps(w, config, prompt, tokens, mm) -> torch.Tensor:
    """Per served token, the reference's best logit minus the served
    token's."""
    rows = _rows(w, config, prompt, tokens, mm)
    served = torch.as_tensor(tokens, dtype=torch.long, device=rows.device)
    return rows.max(dim=-1).values - rows.gather(1, served[:, None])[:, 0]


@torch.no_grad()
def control_gaps(w, config, prompt, tokens, low_mode: str) -> torch.Tensor:
    """Per position, the float32 reference's best logit minus its logit of
    the token that products at ``low_mode``'s precision put first."""
    with products("float32") as mm:
        ref = _rows(w, config, prompt, tokens, mm)
    with products(low_mode) as mm:
        low = _rows(w, config, prompt, tokens, mm)
    return ref.max(dim=-1).values - ref.gather(1, low.argmax(dim=-1)[:, None])[:, 0]
