"""Port parity: ``WindowedEngine.run_epochs`` (several epochs with one
read-back, and the on-device reshuffle) and the trainers'
``dispatch_epochs``.

* ``run_epochs`` with no seed equals ``num_epochs`` calls of ``run_epoch``
  bit for bit, as in the JAX package (tests/test_run_epochs.py).
* Against the JAX package's ``run_epochs`` on the tiny causal
  ``TransformerLM`` (``Downpour(2)``, 2 workers, SGD), from the same
  flax-initialised parameters on the same epoch arrays: losses and center
  parameters within 1e-5 (f32; the two differ only in summation order).
* torch cannot draw ``jax.random.permutation``: with
  :func:`~distkeras_tpu_torch.parallel.engine.epoch_permutation` patched to
  return the JAX package's permutation, the shuffled trajectory is held to
  JAX's shuffled ``run_epochs`` within the same 1e-5; the port's own
  permutation is held to its properties (a permutation, keyed by
  ``(seed, epoch)``, continued across a resume).
"""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu_torch as tdk
from conftest import epoch_data
from distkeras_tpu.algorithms import Downpour as JaxDownpour
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu.parallel import WindowedEngine as JaxEngine
from distkeras_tpu_torch.algorithms import Downpour
from distkeras_tpu_torch.models import TorchModel, TransformerLM, params_from_flax
from distkeras_tpu_torch.parallel import WindowedEngine
from distkeras_tpu_torch.parallel import engine as engine_mod

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

LM = dict(vocab_size=23, dim=32, heads=2, num_layers=1, max_len=64)
TOL = dict(rtol=1e-5, atol=1e-5)


def lm_data(n=64, seq=16, vocab=23, seed=0):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n, 1))
    x = (start + np.arange(seq)) % vocab
    return x.astype(np.int32), ((x + 1) % vocab).astype(np.int32)


class FixedInit(TorchModel):
    """Test-side adapter whose ``init`` returns given parameters."""

    def __init__(self, module, params):
        super().__init__(module)
        self.params = params

    def init(self, generator, sample_input):
        return {k: v.clone() for k, v in self.params.items()}, {}


def _setup(n_windows=2):
    x, y = lm_data()
    xs, ys = epoch_data(x, y, num_workers=2, n_windows=n_windows, window=2, batch=4)
    jax_engine = JaxEngine(FlaxModel(JaxLM(**LM)), "token_crossentropy",
                           ("sgd", {"learning_rate": 0.05}), JaxDownpour(2), num_workers=2,
                           metrics=("token_accuracy",))
    jstate = jax_engine.init_state(jax.random.PRNGKey(0), xs[0, 0, 0])
    init = params_from_flax(TransformerLM(**LM),
                            jax.tree_util.tree_map(np.asarray, jstate.center_params))
    return xs, ys, jax_engine, jstate, init


def _port_engine(init):
    return WindowedEngine(FixedInit(TransformerLM(**LM), init), "token_crossentropy",
                          ("sgd", {"learning_rate": 0.05}), Downpour(2), num_workers=2,
                          metrics=("token_accuracy",), device="cpu")


def _assert_center_close(jax_engine, jstate, pstate):
    want = params_from_flax(TransformerLM(**LM), jax.tree_util.tree_map(
        np.asarray, jax_engine.gather_center(jstate)))
    for name, value in want.items():
        np.testing.assert_allclose(pstate.center_params[name].numpy(), value.numpy(), **TOL,
                                   err_msg=name)


def test_run_epochs_is_run_epoch_repeated_bitwise():
    xs, ys, _, _, init = _setup()
    a, b = _port_engine(init), _port_engine(init)
    sa = a.init_state(torch.Generator().manual_seed(0), None)
    sb = b.init_state(torch.Generator().manual_seed(0), None)
    xa, ya = a.shard_batches(xs, ys)
    seq = []
    for _ in range(3):
        sa, stats = a.run_epoch(sa, xa, ya)
        seq.append(stats)
    sb, multi = b.run_epochs(sb, *b.shard_batches(xs, ys), 3)
    np.testing.assert_array_equal(multi["loss"], np.concatenate([s["loss"] for s in seq]))
    np.testing.assert_array_equal(multi["metrics"], np.concatenate([s["metrics"] for s in seq]))
    for name in sa.center_params:
        assert torch.equal(sa.center_params[name], sb.center_params[name]), name
        assert torch.equal(sa.local_params[name], sb.local_params[name]), name
    assert sa.epoch == sb.epoch == 3


def test_run_epochs_matches_jax():
    xs, ys, jax_engine, jstate, init = _setup()
    jstate, jstats = jax_engine.run_epochs(jstate, *jax_engine.shard_batches(xs, ys), 2)
    engine = _port_engine(init)
    pstate = engine.init_state(torch.Generator().manual_seed(0), None)
    pstate, stats = engine.run_epochs(pstate, *engine.shard_batches(xs, ys), 2)
    np.testing.assert_allclose(stats["loss"], np.asarray(jstats["loss"]), **TOL)
    np.testing.assert_allclose(stats["metrics"], np.asarray(jstats["metrics"]), atol=1e-6)
    _assert_center_close(jax_engine, jstate, pstate)
    assert pstate.epoch == int(jstate.epoch) == 2


def _jax_permutation(shuffle_seed, epoch, n, device):
    key = jax.random.fold_in(jax.random.PRNGKey(shuffle_seed), epoch)
    return torch.from_numpy(np.array(jax.random.permutation(key, n))).to(device)


def test_shuffled_run_epochs_matches_jax_given_its_permutation(monkeypatch):
    monkeypatch.setattr(engine_mod, "epoch_permutation", _jax_permutation)
    xs, ys, jax_engine, jstate, init = _setup()
    jstate, jstats = jax_engine.run_epochs(jstate, *jax_engine.shard_batches(xs, ys), 2,
                                           shuffle_seed=7)
    engine = _port_engine(init)
    pstate = engine.init_state(torch.Generator().manual_seed(0), None)
    pstate, stats = engine.run_epochs(pstate, *engine.shard_batches(xs, ys), 2, shuffle_seed=7)
    np.testing.assert_allclose(stats["loss"], np.asarray(jstats["loss"]), **TOL)
    _assert_center_close(jax_engine, jstate, pstate)


def test_epoch_permutation_properties():
    n = 257
    p = engine_mod.epoch_permutation(3, 0, n, "cpu")
    assert p.dtype == torch.int64
    assert torch.equal(torch.sort(p).values, torch.arange(n))
    # keyed by (seed, epoch): repeatable, and another epoch or seed differs
    assert torch.equal(p, engine_mod.epoch_permutation(3, 0, n, "cpu"))
    assert not torch.equal(p, engine_mod.epoch_permutation(3, 1, n, "cpu"))
    assert not torch.equal(p, engine_mod.epoch_permutation(4, 0, n, "cpu"))
    # the global generator is not drawn from
    before = torch.get_rng_state()
    engine_mod.epoch_permutation(3, 5, n, "cpu")
    assert torch.equal(before, torch.get_rng_state())
    # uniform enough: each position sees every value about equally often
    counts = np.zeros((8, 8))
    for e in range(2000):
        counts[np.arange(8), engine_mod.epoch_permutation(1, e, 8, "cpu").numpy()] += 1
    assert counts.min() > 2000 / 8 * 0.7 and counts.max() < 2000 / 8 * 1.3


def test_shuffled_run_epochs_continue_across_a_resume():
    # two epochs at once equal one epoch, then one more from epoch 1: the
    # permutation is keyed by the state's epoch counter
    xs, ys, _, _, init = _setup()
    a, b = _port_engine(init), _port_engine(init)
    sa = a.init_state(torch.Generator().manual_seed(0), None)
    sa, whole = a.run_epochs(sa, *a.shard_batches(xs, ys), 2, shuffle_seed=11)
    sb = b.init_state(torch.Generator().manual_seed(0), None)
    xb, yb = b.shard_batches(xs, ys)
    sb, first = b.run_epochs(sb, xb, yb, 1, shuffle_seed=11)
    sb, second = b.run_epochs(sb, xb, yb, 1, shuffle_seed=11)
    np.testing.assert_array_equal(whole["loss"], np.concatenate([first["loss"], second["loss"]]))
    for name in sa.center_params:
        assert torch.equal(sa.center_params[name], sb.center_params[name]), name
    # and the shuffle did something
    sc = _port_engine(init).init_state(torch.Generator().manual_seed(0), None)
    _, plain = a.run_epochs(sc, xb, yb, 2)
    assert not np.array_equal(plain["loss"], whole["loss"])


def test_run_epochs_refuses_the_staleness_simulation():
    _, _, _, _, init = _setup()
    engine = WindowedEngine(FixedInit(TransformerLM(**LM), init), "token_crossentropy", "sgd",
                            Downpour(2), num_workers=2, commit_schedule=[1, 2], device="cpu")
    with pytest.raises(ValueError, match="staleness simulation"):
        engine.run_epochs(None, np.zeros((2, 4, 1)), np.zeros((2, 4, 1)), 2)


@pytest.mark.parametrize("shuffle", [False, True])
def test_dispatch_epochs_history(shuffle):
    x, y = lm_data(n=32)

    def train(**kw):
        t = tdk.DOWNPOUR(TransformerLM(**LM), loss="token_crossentropy",
                         metrics=("token_accuracy",), num_workers=2, batch_size=4,
                         communication_window=2, num_epoch=3, seed=1, device="cpu", **kw)
        t.train(tdk.from_numpy(x, y), shuffle=shuffle)
        return t.get_history()

    chunked, per_epoch = train(dispatch_epochs=2), train()
    assert len(chunked["loss"]) == len(chunked["token_accuracy"]) == 3
    if shuffle:
        # the on-device reshuffle is not the host rng's: same data, other order
        assert chunked["loss"][0] != per_epoch["loss"][0]
    else:
        assert chunked["loss"] == per_epoch["loss"]
        assert chunked["token_accuracy"] == per_epoch["token_accuracy"]
