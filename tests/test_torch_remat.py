"""``remat=True``: the model's forward under ``torch.utils.checkpoint``.

* With dropout > 0, ``remat=True`` must give the gradients and trajectory of
  ``remat=False`` bit for bit on the CPU.  ``torch.utils.checkpoint``
  restores only the default generator, and the port draws dropout from
  each worker's own ``torch.Generator``: the engine recomputes from a copy
  of that generator taken before the forward, and without it the
  recomputed masks, hence the gradients, would differ (shown below).
* Against the JAX package's ``remat=True`` engine (``jax.checkpoint``)
  without dropout, from the same flax-initialised parameters on the same
  epoch arrays: losses and center parameters within 1e-5 (f32), on the
  tiny causal ``TransformerLM`` and on ``MNISTCNN``.
"""

import jax
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import distkeras_tpu_torch as tdk
from conftest import epoch_data
from distkeras_tpu.algorithms import Downpour as JaxDownpour
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.parallel import WindowedEngine as JaxEngine
from distkeras_tpu_torch.algorithms import Downpour
from distkeras_tpu_torch.models import (
    TorchModel,
    TransformerLM,
    params_from_flax,
    variables_from_flax,
    zoo,
)
from distkeras_tpu_torch.ops import get_loss
from distkeras_tpu_torch.parallel import WindowedEngine
from distkeras_tpu_torch.parallel import engine as engine_mod

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

LM = dict(vocab_size=23, dim=32, heads=2, num_layers=2, max_len=64)
TOL = dict(rtol=1e-5, atol=1e-5)


def lm_data(n=32, seq=16, vocab=23, seed=0):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n, 1))
    x = (start + np.arange(seq)) % vocab
    return x.astype(np.int32), ((x + 1) % vocab).astype(np.int32)


class FixedVariables(TorchModel):
    """Test-side adapter whose ``init`` returns given parameters and buffers."""

    def __init__(self, module, params, buffers=None):
        super().__init__(module)
        self.params, self.buffers = params, buffers or {}

    def init(self, generator, sample_input):
        return ({k: v.clone() for k, v in self.params.items()},
                {k: v.clone() for k, v in self.buffers.items()})


def _step_grads(remat_apply, dropout=0.25):
    """One training-mode forward and backward of a dropout LM from one
    generator state: (loss, gradients)."""
    model = TransformerLM(**LM, dropout=dropout, generator=torch.Generator().manual_seed(0))
    adapter = TorchModel(model)
    params = {k: p.detach().clone().requires_grad_(True) for k, p in model.named_parameters()}
    x, y = lm_data(n=4)
    gen = torch.Generator().manual_seed(123)
    if remat_apply is None:
        out, _ = adapter.apply(params, {}, torch.from_numpy(x), training=True, generator=gen)
    else:
        out, _ = remat_apply(adapter, params, {}, torch.from_numpy(x), gen)
    loss = get_loss("token_crossentropy")(out, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))


def test_remat_with_dropout_gives_the_same_gradients_bitwise():
    loss, grads = _step_grads(None)
    remat_loss, remat_grads = _step_grads(engine_mod._remat_apply)
    assert remat_loss == loss
    for name, g in grads.items():
        assert torch.equal(remat_grads[name], g), name


def test_recomputing_with_the_advanced_generator_would_differ():
    # the fault the generator copy guards against: a recomputation drawing
    # from the generator as the forward left it draws other masks
    def naive(adapter, params, state, x, generator):
        run = lambda x: adapter.apply(params, state, x, training=True, generator=generator)
        return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                                 preserve_rng_state=False)

    _, grads = _step_grads(None)
    _, naive_grads = _step_grads(naive)
    assert any(not torch.equal(naive_grads[k], g) for k, g in grads.items())


def test_remat_trainer_with_dropout_is_bitwise_the_plain_one():
    x, y = lm_data()

    def train(**kw):
        t = tdk.DOWNPOUR(TransformerLM(**LM, dropout=0.1), loss="token_crossentropy",
                         metrics=("token_accuracy",), worker_optimizer=("adam", {}),
                         num_workers=2, batch_size=4, communication_window=2, num_epoch=2,
                         seed=2, device="cpu", **kw)
        model = t.train(tdk.from_numpy(x, y), shuffle=True)
        return t.get_history(), model.params

    (h, params), (rh, rparams) = train(), train(remat=True)
    assert rh["loss"] == h["loss"] and rh["token_accuracy"] == h["token_accuracy"]
    for name, value in params.items():
        assert torch.equal(rparams[name], value), name


def _jax_and_port(jax_model, init_fn, x, y, loss, lr, **jax_kw):
    xs, ys = epoch_data(x, y, num_workers=2, n_windows=2, window=2, batch=4)
    jax_engine = JaxEngine(FlaxModel(jax_model), loss, ("sgd", {"learning_rate": lr}),
                           JaxDownpour(2), num_workers=2, metrics=(), remat=True, **jax_kw)
    jstate = jax_engine.init_state(jax.random.PRNGKey(0), xs[0, 0, 0])
    engine = WindowedEngine(init_fn(jstate), loss, ("sgd", {"learning_rate": lr}), Downpour(2),
                            num_workers=2, metrics=(), remat=True, device="cpu")
    pstate = engine.init_state(torch.Generator().manual_seed(0), None)
    jxs, jys = jax_engine.shard_batches(xs, ys)
    pxs, pys = engine.shard_batches(xs, ys)
    for _ in range(2):
        jstate, jstats = jax_engine.run_epoch(jstate, jxs, jys)
        pstate, stats = engine.run_epoch(pstate, pxs, pys)
        np.testing.assert_allclose(stats["loss"], np.asarray(jstats["loss"]), **TOL)
    return jax_engine.gather_center(jstate), pstate.center_params


def test_remat_lm_matches_jax_remat():
    x, y = lm_data()
    port = lambda s: FixedVariables(TransformerLM(**LM), params_from_flax(
        TransformerLM(**LM), jax.tree_util.tree_map(np.asarray, s.center_params)))
    want, got = _jax_and_port(JaxLM(**LM), port, x, y, "token_crossentropy", 0.05)
    want = params_from_flax(TransformerLM(**LM), jax.tree_util.tree_map(np.asarray, want))
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), **TOL, err_msg=name)


def test_remat_mnist_cnn_matches_jax_remat():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 784)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(x))]

    def port(s):
        params, buffers = variables_from_flax(zoo.MNISTCNN(num_classes=3), {
            "params": jax.tree_util.tree_map(np.asarray, s.center_params)})
        return FixedVariables(zoo.MNISTCNN(num_classes=3), params, buffers)

    want, got = _jax_and_port(jax_zoo.MNISTCNN(num_classes=3), port, x, y,
                              "categorical_crossentropy", 0.01, unroll=True)
    want, _ = variables_from_flax(zoo.MNISTCNN(num_classes=3), {
        "params": jax.tree_util.tree_map(np.asarray, want)})
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), **TOL, err_msg=name)


def test_remat_inside_a_captured_window_is_refused(monkeypatch):
    # remat composes with unroll: on the CPU unroll is a hint, and on a card
    # (the device faked here: the constructor touches none) each window is
    # captured with the recomputation inside the graph, which
    # tests/test_torch_graphs.py holds to eager on a card
    cpu = WindowedEngine(TorchModel(TransformerLM(**LM)), "mse", "sgd", Downpour(2),
                         num_workers=2, remat=True, unroll=True, device="cpu")
    assert cpu.remat and not cpu.use_graphs
    monkeypatch.setattr(engine_mod, "resolve_device", lambda device: torch.device("cuda", 0))
    card = WindowedEngine(TorchModel(TransformerLM(**LM)), "mse", "sgd", Downpour(2),
                          num_workers=2, remat=True, unroll=True, device="cuda")
    assert card.remat and card.use_graphs and card._twins is None
