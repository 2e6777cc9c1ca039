"""Worker-optimizer registry.

The port of :mod:`distkeras_tpu.ops.optimizers`.  The same specs (a name, or
``(name, kwargs)``) with the same default learning rates resolve to a
functional optimizer over name -> tensor dicts, each written from optax's
formulas:

* ``init(params) -> state``
* ``update(grads, state, params) -> (updates, state)``; the new parameters
  are ``params + updates`` (:func:`apply_updates`).

``torch.optim`` is not used: its ``adagrad`` starts the accumulator at 0
with eps 1e-10 outside the root and its ``rmsprop`` decays by 0.99 with eps
outside the root, where optax starts at 0.1 with eps 1e-7 inside, and decays
by 0.9 with eps inside.  States are dicts of tensors (a step count is a
0-dim int32 tensor), so the engine can stack them over workers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from distkeras_tpu_torch.utils.pytree import tree_leaves, tree_map

__all__ = ["GradientTransformation", "apply_updates", "get_optimizer"]

_DEFAULT_LR = {
    "sgd": 0.01,
    "momentum": 0.01,
    "adam": 0.001,
    "adagrad": 0.01,
    "rmsprop": 0.001,
    "adamw": 0.001,
}


class GradientTransformation(NamedTuple):
    """A functional optimizer (optax's ``GradientTransformation``)."""

    init: Callable
    update: Callable


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _scale(tree, s: float):
    return tree_map(lambda u: u * s, tree)


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> GradientTransformation:
    """optax ``sgd``: ``trace`` (t = g + momentum·t; Nesterov g + momentum·t
    on the new trace) then ``-lr``.  With momentum 0 the trace equals the
    gradient exactly, so no trace is kept."""

    def init(params):
        return {"trace": tree_map(torch.zeros_like, params)} if momentum else {}

    def update(grads, state, params=None):
        del params
        if not momentum:
            return _scale(grads, -lr), state
        trace = tree_map(lambda g, t: g + momentum * t, grads, state["trace"])
        updates = tree_map(lambda g, t: g + momentum * t, grads, trace) if nesterov else trace
        return _scale(updates, -lr), {"trace": trace}

    return GradientTransformation(init, update)


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    # a float32 base from a scalar, with no copy from the host: a captured
    # window may hold it
    base = torch.full((), decay, dtype=torch.float32, device=count.device)
    return 1 - base ** count.float()


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> GradientTransformation:
    """optax ``adam`` (``scale_by_adam``, eps outside the root, bias
    correction from the step count), and with ``weight_decay`` optax
    ``adamw`` (``add_decayed_weights`` after the Adam step); then ``-lr``."""

    def init(params):
        return {
            "count": torch.zeros((), dtype=torch.int32, device=_device(params)),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    def update(grads, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, n: (1 - b2) * (g * g) + b2 * n, grads, state["nu"])
        count = state["count"] + 1
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        updates = tree_map(lambda m, n: (m / bc1) / (torch.sqrt(n / bc2) + eps), mu, nu)
        if weight_decay:
            updates = tree_map(lambda u, p: u + weight_decay * p, updates, params)
        return _scale(updates, -lr), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def adagrad(lr: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
    """optax ``adagrad`` (``scale_by_rss``): s = g² + s from 0.1, update
    g·rsqrt(s + eps) where s > 0; then ``-lr``."""

    def init(params):
        return {"sum_of_squares": tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value), params)}

    def update(grads, state, params=None):
        del params
        sos = tree_map(lambda g, s: g * g + s, grads, state["sum_of_squares"])
        updates = tree_map(
            lambda g, s: torch.where(s > 0, torch.rsqrt(s + eps), 0.0) * g, grads, sos)
        return _scale(updates, -lr), {"sum_of_squares": sos}

    return GradientTransformation(init, update)


def rmsprop(lr: float, decay: float = 0.9, eps: float = 1e-8) -> GradientTransformation:
    """optax ``rmsprop`` (``scale_by_rms``, ``eps_in_sqrt=True``): ν = (1 −
    decay)·g² + decay·ν from 0, update g·rsqrt(ν + eps); then ``-lr``."""

    def init(params):
        return {"nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        del params
        nu = tree_map(lambda g, n: (1 - decay) * (g * g) + decay * n, grads, state["nu"])
        updates = tree_map(lambda g, n: g * torch.rsqrt(n + eps), grads, nu)
        return _scale(updates, -lr), {"nu": nu}

    return GradientTransformation(init, update)


def get_optimizer(spec, learning_rate: float | None = None, **kwargs) -> GradientTransformation:
    """Resolve an optimizer spec: GradientTransformation | name | (name, kwargs)."""
    if isinstance(spec, GradientTransformation):
        return spec
    if isinstance(spec, tuple):
        name, kw = spec
        return get_optimizer(name, **{**kw, **kwargs})
    name = str(spec).lower()
    lr = learning_rate if learning_rate is not None else kwargs.pop("lr", _DEFAULT_LR.get(name, 0.01))
    if name == "sgd":
        return sgd(lr, momentum=kwargs.get("momentum", 0.0), nesterov=kwargs.get("nesterov", False))
    if name == "momentum":
        return sgd(lr, momentum=kwargs.get("momentum", 0.9), nesterov=kwargs.get("nesterov", True))
    if name == "adam":
        return adam(lr)
    if name == "adamw":
        return adam(lr, weight_decay=kwargs.get("weight_decay", 1e-4))
    if name == "adagrad":
        return adagrad(lr)
    if name == "rmsprop":
        return rmsprop(lr)
    raise ValueError(f"unknown optimizer {spec!r}")
