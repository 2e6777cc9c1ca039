"""The first commit window of a trainer, worked out again.

One worker takes ``window`` local steps with Adam (optax's ``adam``: bias
correction from the step count, epsilon outside the root) from the initial
weights, each step on its own batch, then the rule commits: DOWNPOUR adds
the worker's change to the center.  What the
check compares, per leaf: the norm of Adam's first moment after the window
(the gradients as the optimizer got them) and the norm of the center's
change; and the window's mean loss.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

RULES = ("DOWNPOUR",)


def first_window(w0: Dict[str, torch.Tensor], batches: List[Tuple[torch.Tensor, torch.Tensor]],
                 loss: Callable, mm, rule: str, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> dict:
    """Run the window; returns ``{"loss": mean step loss, "mu": {leaf:
    first moment}, "change": {leaf: center - w0}}``."""
    if rule not in RULES:
        raise ValueError(f"no reference for the rule {rule!r}")
    names = list(w0)
    params = {k: w0[k].detach().clone() for k in names}
    mu = {k: torch.zeros_like(params[k]) for k in names}
    nu = {k: torch.zeros_like(params[k]) for k in names}
    losses = []
    for count, (x, y) in enumerate(batches, start=1):
        leaves = {k: params[k].requires_grad_(True) for k in names}
        value = loss(leaves, x, y, mm)
        grads = torch.autograd.grad(value, [leaves[k] for k in names], allow_unused=True)
        losses.append(float(value.detach()))
        with torch.no_grad():
            bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
            for k, g in zip(names, grads):
                g = torch.zeros_like(params[k]) if g is None else g
                mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
                nu[k].mul_(b2).add_(g * g, alpha=1.0 - b2)
                step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                params[k] = (params[k].detach() - lr * step)
        del grads, value, leaves
    change = {k: params[k] - w0[k] for k in names}
    return {"loss": sum(losses) / len(losses), "mu": mu, "change": change}

