"""Port parity: losses, metrics and optimizers of ``distkeras_tpu_torch.ops``
against the JAX package's (``distkeras_tpu.ops``, optax underneath) on the
same numpy inputs.

Tolerances: losses and metrics within 1e-6 relative (f32, the same formulas
in another summation order); optimizers within 1e-6 relative after five
updates (element-wise f32 arithmetic in the same order).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.ops import get_loss as jax_get_loss
from distkeras_tpu.ops import get_metric as jax_get_metric
from distkeras_tpu.ops import get_optimizer as jax_get_optimizer
from distkeras_tpu.ops.metrics import per_token_metric_names as jax_per_token_names
from distkeras_tpu_torch.ops import get_loss, get_metric, get_optimizer
from distkeras_tpu_torch.ops.metrics import per_token_metric_names
from distkeras_tpu_torch.ops.optimizers import apply_updates

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

RTOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _cases():
    """(loss name, preds, labels, from_logits) over every registered string."""
    r = _rng(1)
    logits = r.standard_normal((6, 5)).astype(np.float32)
    probs = _softmax(logits)
    onehot = np.eye(5, dtype=np.float32)[r.integers(0, 5, 6)]
    soft = _softmax(r.standard_normal((6, 5)).astype(np.float32))
    int_labels = r.integers(0, 5, 6).astype(np.int32)
    col_labels = r.integers(0, 5, (6, 1)).astype(np.int32)
    tok_logits = r.standard_normal((2, 7, 11)).astype(np.float32)
    tok_labels = r.integers(0, 11, (2, 7)).astype(np.int32)
    masked = tok_labels.copy()
    masked[:, 5:] = -1
    bin_logits = r.standard_normal((6, 1)).astype(np.float32)
    bin_labels = r.integers(0, 2, 6).astype(np.float32)
    reg = r.standard_normal((6, 3)).astype(np.float32)
    target = r.standard_normal((6, 3)).astype(np.float32)
    cases = []
    for name in ("categorical_crossentropy", "sparse_categorical_crossentropy", "crossentropy"):
        for labels in (onehot, soft, int_labels, col_labels):
            cases.append((name, logits, labels, True))
            cases.append((name, probs, labels, False))
    for name in ("token_crossentropy", "lm_crossentropy"):
        cases.append((name, tok_logits, tok_labels, True))
        cases.append((name, _softmax(tok_logits), tok_labels, False))
    for name in ("masked_token_crossentropy", "packed_crossentropy"):
        cases.append((name, tok_logits, masked, True))
        cases.append((name, _softmax(tok_logits), masked, False))
    cases.append(("binary_crossentropy", bin_logits, bin_labels, True))
    cases.append(("binary_crossentropy", 1 / (1 + np.exp(-bin_logits)), bin_labels, False))
    for name in ("mse", "mean_squared_error", "mae", "mean_absolute_error"):
        cases.append((name, reg, target, True))
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_loss_matches_jax(case):
    name, preds, labels, from_logits = CASES[case]
    got = get_loss(name, from_logits=from_logits)(torch.from_numpy(preds), labels)
    want = jax_get_loss(name, from_logits=from_logits)(jnp.asarray(preds), jnp.asarray(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=1e-7)


def test_loss_registry_errors_and_callables():
    fn = lambda p, y: p.sum()  # noqa: E731
    assert get_loss(fn) is fn
    with pytest.raises(ValueError, match="unknown loss"):
        get_loss("hinge")


def test_loss_gradient_flows_to_preds():
    preds = torch.from_numpy(_rng(2).standard_normal((2, 4, 6)).astype(np.float32))
    preds.requires_grad_(True)
    labels = _rng(3).integers(0, 6, (2, 4)).astype(np.int32)
    get_loss("token_crossentropy")(preds, labels).backward()
    # d/dlogits of the mean token NLL: (softmax - onehot) / tokens
    want = (torch.softmax(preds.detach(), -1)
            - torch.nn.functional.one_hot(torch.from_numpy(labels).long(), 6)) / 8
    torch.testing.assert_close(preds.grad, want.float(), atol=1e-7, rtol=1e-6)


def _metric_cases():
    r = _rng(4)
    logits = r.standard_normal((8, 4)).astype(np.float32)
    return [
        ("accuracy", logits, r.integers(0, 4, 8).astype(np.int32)),
        ("acc", logits, np.eye(4, dtype=np.float32)[r.integers(0, 4, 8)]),
        ("categorical_accuracy", r.random((8, 1)).astype(np.float32),
         r.integers(0, 2, 8).astype(np.int32)),
        ("token_accuracy", r.standard_normal((2, 5, 7)).astype(np.float32),
         r.integers(0, 7, (2, 5)).astype(np.int32)),
        ("lm_accuracy", r.standard_normal((2, 5, 7)).astype(np.float32),
         r.integers(0, 7, (2, 5)).astype(np.int32)),
    ]


@pytest.mark.parametrize("name,preds,labels", _metric_cases())
def test_metric_matches_jax(name, preds, labels):
    got = get_metric(name)(torch.from_numpy(preds), labels)
    want = jax_get_metric(name)(jnp.asarray(preds), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_per_token_metric_names_match_jax():
    spec = ("accuracy", "ACC", "categorical_accuracy", "token_accuracy", len)
    assert per_token_metric_names(spec) == jax_per_token_names(spec)
    with pytest.raises(ValueError, match="unknown metric"):
        get_metric("f1")


OPTIMIZERS = [
    "sgd",
    ("sgd", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "nesterov": True}),
    "momentum",
    "adam",
    ("adam", {"learning_rate": 3e-3}),
    ("adamw", {"learning_rate": 3e-3, "weight_decay": 0.1}),
    "adagrad",
    ("adagrad", {"lr": 0.1}),
    "rmsprop",
]


@pytest.mark.parametrize("spec", OPTIMIZERS, ids=str)
def test_optimizer_matches_optax(spec):
    r = _rng(5)
    shapes = {"w": (4, 3), "b": (3,)}
    params = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]

    opt = get_optimizer(spec)
    p_t = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(p_t)
    jopt = jax_get_optimizer(spec)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(p_j)
    for g in grads:
        updates, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, p_t)
        p_t = apply_updates(p_t, updates)
        jupdates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, p_j)
        p_j = optax.apply_updates(p_j, jupdates)
    for k in shapes:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=RTOL, atol=1e-7)


def test_adagrad_and_rmsprop_are_not_torch_optim():
    # optax starts adagrad's accumulator at 0.1 and keeps rmsprop's eps
    # inside the root with decay 0.9; torch.optim's defaults differ, so the
    # first steps must differ from torch.optim's
    g = torch.tensor([0.3, -2.0])
    for name, torch_opt in (("adagrad", torch.optim.Adagrad), ("rmsprop", torch.optim.RMSprop)):
        opt = get_optimizer(name)
        p = {"w": torch.zeros(2)}
        upd, _ = opt.update({"w": g}, opt.init(p), p)
        w = torch.zeros(2, requires_grad=True)
        ref = torch_opt([w], lr=0.01 if name == "adagrad" else 0.001)
        w.grad = g.clone()
        ref.step()
        assert not torch.allclose(upd["w"], w.detach(), rtol=1e-3)


def test_optimizer_registry_errors():
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("lamb")
    opt = get_optimizer("adam")
    assert get_optimizer(opt) is opt
