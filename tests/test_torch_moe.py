"""Mixture-of-experts in the port, case by case against
tests/test_moe_expert_parallel.py: each case runs its own check on the
port's modules and holds them to the JAX package's on the same numpy
inputs, the flax parameters carried over (``params_from_flax`` for the
classifier, the same arrays for a bare ``MoEFeedForward``).

Tolerances: the forward in f32 within 1e-5; the parameter gradients of
``sum(y * cotangent) + aux`` within 1e-5 (the router's with the
load-balance loss included); the aux value within 1e-6; the first epoch's
losses of a ``DOWNPOUR`` run within the engine tests' bounds (``rtol=2e-4,
atol=2e-5``).  Expert parallelism over ranks is
tests/test_torch_expert_parallel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import epoch_data, toy_text
from distkeras_tpu.algorithms import Downpour as JaxDownpour
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import MoEFeedForward as JaxFFN
from distkeras_tpu.models import MoETransformerClassifier as JaxMoE
from distkeras_tpu.models import expert_partition as jax_expert_partition
from distkeras_tpu.parallel import WindowedEngine as JaxEngine
from distkeras_tpu_torch.algorithms import Downpour
from distkeras_tpu_torch.models import (
    MoEFeedForward,
    MoETransformerClassifier,
    TorchModel,
    expert_partition,
    params_from_flax,
)
from distkeras_tpu_torch.parallel import WindowedEngine

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
CLS = dict(vocab_size=50, num_classes=2, dim=32, heads=2, num_layers=1, mlp_ratio=2,
           max_len=32)


def _moe_kwargs(num_experts=4, capacity_factor=2.0, top_k=1):
    return dict(CLS, num_experts=num_experts, capacity_factor=capacity_factor, top_k=top_k)


class FixedInit(TorchModel):
    """Test-side adapter whose ``init`` returns given parameters and the
    module's own (zero) buffers."""

    def __init__(self, module, params):
        super().__init__(module)
        self.params = params

    def init(self, generator, sample_input):
        return ({k: v.clone() for k, v in self.params.items()},
                {k: b.clone() for k, b in self.module.named_buffers()})


def _port_ffn(kwargs, flax_params):
    """A port ``MoEFeedForward`` holding the flax layer's parameters."""
    mod = MoEFeedForward(**kwargs)
    p = jax.tree_util.tree_map(np.asarray, flax_params)
    sd = {"router.weight": p["router"]["kernel"].T, "router.bias": p["router"]["bias"],
          **{k: p[k] for k in ("w1", "b1", "w2", "b2")},
          "losses.load_balance": np.zeros((), np.float32)}
    mod.load_state_dict({k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()})
    return mod


def _ffn_vs_jax(kwargs, x, variables, cot_seed=5):
    """The layer's output, aux and gradients of ``sum(y * cot) + aux`` in
    both packages: ``(port, jax)`` dicts of numpy arrays, the port's
    gradients under the port's names."""
    jmod = JaxFFN(**kwargs)
    cot = np.random.default_rng(cot_seed).normal(size=x.shape).astype(np.float32)

    def objective(params):
        y, state = jmod.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
        aux = state["losses"]["load_balance"]
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(objective, has_aux=True)(variables["params"])
    g = jax.tree_util.tree_map(np.asarray, grads)
    want = {"y": np.asarray(y), "aux": np.asarray(aux),
            "router.weight": g["router"]["kernel"].T, "router.bias": g["router"]["bias"],
            **{k: g[k] for k in ("w1", "b1", "w2", "b2")}}

    mod = _port_ffn(kwargs, variables["params"])
    adapter = TorchModel(mod)
    params = {k: p.detach().requires_grad_(True) for k, p in mod.named_parameters()}
    y, state = adapter.apply(params, dict(mod.named_buffers()), torch.from_numpy(x),
                             training=True)
    aux = adapter.aux_loss(state)
    objective = (y * torch.from_numpy(cot)).sum() + aux
    grads = torch.autograd.grad(objective, list(params.values()))
    got = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
           **{k: gr.numpy() for k, gr in zip(params, grads)}}
    return got, want


def _assert_held(got, want):
    np.testing.assert_allclose(got["y"], want["y"], **FWD_TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], **AUX_TOL)
    for name in ("router.weight", "router.bias", "w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **GRAD_TOL)


def _ffn_case(kwargs, x, seed=0):
    variables = JaxFFN(**kwargs).init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return variables, _port_ffn(kwargs, variables["params"])


# ---------------------------------------------------------------- the layer


def test_single_expert_moe_is_a_dense_ffn():
    """E=1, ample capacity: routing is the identity, so the layer equals
    the dense FFN of its expert-0 weights; and it is JAX's layer."""
    kwargs = dict(dim=8, num_experts=1, mlp_ratio=2, capacity_factor=1.0)
    x = np.random.default_rng(0).normal(size=(2, 4, 8)).astype(np.float32)
    variables, mod = _ffn_case(kwargs, x)
    with torch.no_grad():
        y = mod(torch.from_numpy(x)).numpy().reshape(8, 8)
        t = torch.from_numpy(x).reshape(8, 8)
        ref = torch.nn.functional.gelu(t @ mod.w1[0] + mod.b1[0], approximate="tanh") \
            @ mod.w2[0] + mod.b2[0]
    np.testing.assert_allclose(y, ref.numpy(), rtol=1e-5, atol=1e-6)
    _assert_held(*_ffn_vs_jax(kwargs, x, variables))


def test_capacity_drops_overflow_tokens():
    """E=1 with half the capacity: the first 4 tokens are the full layer's,
    the rest exactly zero (Switch drop semantics); both as in JAX."""
    full = dict(dim=8, num_experts=1, mlp_ratio=2, capacity_factor=1.0)
    half = dict(full, capacity_factor=0.5)
    x = np.random.default_rng(1).normal(size=(1, 8, 8)).astype(np.float32)
    variables, mod_full = _ffn_case(full, x)
    mod_half = _port_ffn(half, variables["params"])
    with torch.no_grad():
        y_full = mod_full(torch.from_numpy(x)).numpy()
        y_half = mod_half(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_half[0, :4], y_full[0, :4], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(y_half[0, 4:], np.zeros((4, 8), np.float32))
    _assert_held(*_ffn_vs_jax(half, x, variables))


def test_top2_equals_gate_weighted_dense_mixture():
    """E=2, top_k=2, ample capacity: every token visits both experts, so
    the layer is the gate-weighted sum of the two dense FFNs; and JAX's."""
    kwargs = dict(dim=8, num_experts=2, mlp_ratio=2, top_k=2, capacity_factor=1.0)
    x = np.random.default_rng(2).normal(size=(2, 4, 8)).astype(np.float32)
    variables, mod = _ffn_case(kwargs, x)
    with torch.no_grad():
        tokens = torch.from_numpy(x).reshape(8, 8)
        gates = torch.softmax(mod.router(tokens), dim=-1)
        expect = sum(gates[:, e:e + 1] * (torch.nn.functional.gelu(
            tokens @ mod.w1[e] + mod.b1[e], approximate="tanh") @ mod.w2[e] + mod.b2[e])
            for e in range(2))
        y = mod(torch.from_numpy(x)).reshape(8, 8)
    np.testing.assert_allclose(y.numpy(), expect.numpy(), rtol=2e-4, atol=2e-5)
    _assert_held(*_ffn_vs_jax(kwargs, x, variables))


def test_top2_rank0_outranks_rank1_for_capacity():
    """Rank-major queueing with scarce capacity (2 slots an expert): tokens
    0 and 1 take every slot with both their choices, tokens 2 and 3 are
    dropped; the router biased so that every token prefers expert 0."""
    kwargs = dict(dim=4, num_experts=2, mlp_ratio=1, top_k=2, capacity_factor=0.5)
    x = np.random.default_rng(3).normal(size=(1, 4, 4)).astype(np.float32)
    variables = JaxFFN(**kwargs).init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = jax.tree_util.tree_map(lambda a: np.array(a), variables["params"])
    p["router"]["kernel"][:] = 0.0
    p["router"]["bias"][:] = np.array([2.0, 0.0], np.float32)
    variables = {"params": p}
    mod = _port_ffn(kwargs, p)
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()[0]
    assert not np.allclose(out[0], 0) and not np.allclose(out[1], 0)
    np.testing.assert_allclose(out[2], np.zeros(4), atol=1e-7)
    np.testing.assert_allclose(out[3], np.zeros(4), atol=1e-7)
    _assert_held(*_ffn_vs_jax(kwargs, x, variables))


def test_ties_go_to_the_lower_expert_as_jax_top_k():
    """Equal gates (a zero router): every token's first choice is expert 0
    and its second expert 1, in both packages; with capacity for half the
    tokens the same tokens survive."""
    kwargs = dict(dim=4, num_experts=4, mlp_ratio=1, top_k=2, capacity_factor=0.5)
    x = np.random.default_rng(4).normal(size=(1, 8, 4)).astype(np.float32)
    variables = JaxFFN(**kwargs).init(jax.random.PRNGKey(2), jnp.asarray(x))
    p = jax.tree_util.tree_map(lambda a: np.array(a), variables["params"])
    p["router"]["kernel"][:] = 0.0
    p["router"]["bias"][:] = 0.0
    _assert_held(*_ffn_vs_jax(kwargs, x, {"params": p}))


# ------------------------------------------------------------ the classifier


def _cls_pair(**kwargs):
    """The JAX classifier, its parameters (perturbed off their initial
    values) and the port classifier holding them."""
    jmod = JaxMoE(**_moe_kwargs(**kwargs))
    x = toy_text(n=8)[0]
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])
    port = MoETransformerClassifier(**_moe_kwargs(**kwargs))
    return jmod, params, port, params_from_flax(port, params)


@pytest.mark.parametrize("top_k", [1, 2])
def test_classifier_forward_and_gradients_match_jax(top_k):
    """The whole classifier (attention, both LayerNorms with flax's eps,
    the MoE layer) in training: logits, the aux loss in the state, and
    every parameter's gradient of ``sum(logits * cot) + aux``."""
    jmod, params, port, pparams = _cls_pair(top_k=top_k)
    x = toy_text(n=8)[0]
    cot = np.random.default_rng(7).normal(size=(8, 2)).astype(np.float32)
    adapter = FlaxModel(jmod)
    state = {"losses": {"block_0": {"MoEFeedForward_0": {"load_balance": jnp.zeros(())}}}}

    def objective(p):
        out, new_state = adapter.apply(p, state, jnp.asarray(x), training=True)
        aux = adapter.aux_loss(new_state)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out, aux)), grads = jax.value_and_grad(objective, has_aux=True)(params)
    want = params_from_flax(MoETransformerClassifier(**_moe_kwargs(top_k=top_k)),
                            jax.tree_util.tree_map(np.asarray, grads))

    padapter = TorchModel(port)
    leaves = {k: v.detach().requires_grad_(True) for k, v in pparams.items()}
    pout, pstate = padapter.apply(leaves, dict(port.named_buffers()), torch.from_numpy(x),
                                  training=True)
    paux = padapter.aux_loss(pstate)
    pgrads = torch.autograd.grad((pout * torch.from_numpy(cot)).sum() + paux,
                                 list(leaves.values()))
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(out), **FWD_TOL)
    np.testing.assert_allclose(paux.detach().numpy(), np.asarray(aux), **AUX_TOL)
    for name, g in zip(leaves, pgrads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_router_gradient_carries_the_aux_loss():
    """The aux loss reaches the router: its gradient with the loss differs
    from its gradient without, and the difference is JAX's."""
    jmod, params, port, pparams = _cls_pair()
    x = toy_text(n=8)[0]
    adapter = FlaxModel(jmod)
    state = {"losses": {"block_0": {"MoEFeedForward_0": {"load_balance": jnp.zeros(())}}}}
    name = "blocks.0.moe.router.weight"

    def jax_aux_grad(p):
        return adapter.aux_loss(adapter.apply(p, state, jnp.asarray(x), training=True)[1])

    g = jax.grad(jax_aux_grad)(params)
    want = g["block_0"]["MoEFeedForward_0"]["router"]["kernel"].T
    padapter = TorchModel(port)
    leaves = {k: v.detach().requires_grad_(True) for k, v in pparams.items()}
    _, pstate = padapter.apply(leaves, dict(port.named_buffers()), torch.from_numpy(x),
                               training=True)
    (got,) = torch.autograd.grad(padapter.aux_loss(pstate), [leaves[name]])
    assert float(got.abs().max()) > 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_aux_loss_lives_in_state_and_engine_adds_it():
    """The training forward writes the load balance into the returned
    state (the caller's state untouched), ``aux_loss`` reads it, and the
    engine's step adds it to the objective."""
    _, _, port, pparams = _cls_pair()
    adapter = TorchModel(port)
    x = torch.from_numpy(toy_text(n=8)[0])
    _, state = adapter.init(None, None)
    assert list(state) == ["blocks.0.moe.losses.load_balance"]
    _, new_state = adapter.apply(pparams, state, x, training=True)
    aux = adapter.aux_loss(new_state)
    assert float(aux) >= 0.0 and np.isfinite(float(aux))
    assert float(aux) >= 1e-2 * 0.99  # E * sum f*P >= 1 by Cauchy-Schwarz
    assert float(state["blocks.0.moe.losses.load_balance"]) == 0.0
    _, eval_state = adapter.apply(pparams, state, x, training=False)
    assert adapter.aux_loss(eval_state) == 0.0  # the eval forward writes nothing

    engine = WindowedEngine(FixedInit(port, pparams), "categorical_crossentropy",
                            ("sgd", {"learning_rate": 0.0}), Downpour(2), num_workers=1,
                            metrics=(), device="cpu")
    y = torch.from_numpy(toy_text(n=8)[1]).long()
    _, _, _, loss, _, _ = engine._local_step(dict(pparams), engine.optimizer.init(pparams),
                                             state, None, x, y)
    out, _ = adapter.apply(pparams, state, x, training=True)
    ce = engine.loss_fn(out, y)
    np.testing.assert_allclose(float(loss), float(ce + aux), rtol=1e-6)
    assert float(loss) > float(ce)


def test_expert_partition_places_the_leaves_jax_places():
    """The spec_fn puts dim 0 of the four expert stacks on the axis, as
    JAX's does on the same leaves, and nothing else (not the attention,
    whose ``[heads, ...]`` dim equals the expert count here)."""
    jmod, params, port, _ = _cls_pair()
    jspec = jax_expert_partition(2 * 2)
    spec = expert_partition(4)
    marks = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(a.shape, float(jspec(a.shape, tuple(
            getattr(k, "key", k) for k in path)) is not None), np.float32), params)
    want = params_from_flax(MoETransformerClassifier(**_moe_kwargs()), marks)
    placed = set()
    for name, p in port.named_parameters():
        got = spec(tuple(p.shape), name)
        assert (got is not None) == bool(want[name].numpy().flat[0]), name
        if got is not None:
            assert got == ("model",)
            placed.add(name.split(".")[-1])
    assert placed == {"w1", "b1", "w2", "b2"}
    assert spec((4, 8), "blocks.0.attn.qkv.weight") is None
    assert spec((3, 8), "blocks.0.moe.w1") is None  # dim 0 is not the expert count


# ------------------------------------------------------------- training (DP)


def _dp_runs(top_k, epochs):
    """DOWNPOUR over 4 workers, Adam: the port's loss per epoch for
    ``epochs`` epochs and both packages' first epoch, from JAX's initial
    parameters."""
    x, _, onehot = toy_text(n=256)
    xs, ys = epoch_data(x, onehot, num_workers=4, n_windows=2, window=2, batch=8)
    jmod = JaxMoE(**_moe_kwargs(top_k=top_k))
    jeng = JaxEngine(FlaxModel(jmod), "categorical_crossentropy",
                     ("adam", {"learning_rate": 2e-3}), JaxDownpour(2), num_workers=4,
                     metrics=())
    state = jeng.init_state(jax.random.PRNGKey(0), xs[0, 0, 0])
    init = params_from_flax(MoETransformerClassifier(**_moe_kwargs(top_k=top_k)),
                            jax.tree_util.tree_map(np.asarray, state.center_params))
    sx, sy = jeng.shard_batches(xs, ys)
    state, stats = jeng.run_epoch(state, sx, sy)
    jax_first = np.asarray(stats["loss"])

    port = MoETransformerClassifier(**_moe_kwargs(top_k=top_k))
    eng = WindowedEngine(FixedInit(port, init), "categorical_crossentropy",
                         ("adam", {"learning_rate": 2e-3}), Downpour(2), num_workers=4,
                         metrics=(), device="cpu")
    pstate = eng.init_state(torch.Generator().manual_seed(0), None)
    pxs, pys = eng.shard_batches(xs, ys)
    losses, first = [], None
    for _ in range(epochs):
        pstate, pstats = eng.run_epoch(pstate, pxs, pys)
        first = np.asarray(pstats["loss"]) if first is None else first
        losses.append(float(np.asarray(pstats["loss"]).mean()))
    return losses, first, jax_first


@pytest.mark.parametrize("top_k", [1, 2], ids=["dp", "top2"])
def test_moe_downpour_converges(top_k):
    """DP converges in 10 epochs (JAX's test), and its first epoch is the
    JAX engine's from the same parameters."""
    losses, first, jax_first = _dp_runs(top_k, 10)
    assert losses[-1] < losses[0] * 0.8, losses
    np.testing.assert_allclose(first, jax_first, **LOSS_TOL)
