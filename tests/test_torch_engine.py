"""Port parity: ``distkeras_tpu_torch.parallel.engine.WindowedEngine``
against the JAX package's ``WindowedEngine`` on a tiny causal
``TransformerLM``: ``Downpour(2)``, 2 workers, SGD lr 0.05, 2 epochs, the
setting of tests/test_lm.py's trajectory tests.  Both start from the same
flax-initialised parameters (carried over by ``params_from_flax``) and see
the same epoch arrays.

Tolerances are the JAX package's own for equivalent trajectories: losses
within rtol 2e-4 / atol 2e-5, parameters within rtol 2e-3 / atol 2e-4.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import epoch_data
from distkeras_tpu.algorithms import Downpour as JaxDownpour
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu.parallel import WindowedEngine as JaxEngine
from distkeras_tpu_torch.algorithms import Downpour, Sequential
from distkeras_tpu_torch.models import TorchModel, TransformerLM, params_from_flax
from distkeras_tpu_torch.parallel import WindowedEngine, plan_workers

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

LM = dict(vocab_size=23, dim=32, heads=2, num_layers=1, max_len=64)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)


def lm_data(n=128, seq=16, vocab=23, seed=0):
    """tests/test_lm.py's task: next token = (token + 1) mod vocab."""
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
        return dict(self.params), {}


def port_params(flax_params):
    return params_from_flax(TransformerLM(**LM), flax_params)


def test_downpour_trajectory_matches_jax():
    x, y = lm_data()
    xs, ys = epoch_data(x, y, num_workers=2, n_windows=2, window=2, batch=8)

    jax_engine = JaxEngine(FlaxModel(JaxLM(**LM)), "token_crossentropy",
                           ("sgd", {"learning_rate": 0.05}), JaxDownpour(2),
                           num_workers=2, metrics=("token_accuracy",))
    state = jax_engine.init_state(jax.random.PRNGKey(0), xs[0, 0, 0])
    init = port_params(jax.tree_util.tree_map(np.asarray, state.center_params))
    xs_d, ys_d = jax_engine.shard_batches(xs, ys)
    jax_losses, jax_mets = [], []
    for _ in range(2):
        state, stats = jax_engine.run_epoch(state, xs_d, ys_d)
        jax_losses.append(np.asarray(stats["loss"]))
        jax_mets.append(np.asarray(stats["metrics"]))

    engine = WindowedEngine(FixedInit(TransformerLM(**LM), init), "token_crossentropy",
                            ("sgd", {"learning_rate": 0.05}), Downpour(2), num_workers=2,
                            metrics=("token_accuracy",), device="cpu")
    pstate = engine.init_state(torch.Generator().manual_seed(0), xs[0, 0, 0])
    pxs, pys = engine.shard_batches(xs, ys)
    losses, mets = [], []
    for _ in range(2):
        pstate, stats = engine.run_epoch(pstate, pxs, pys)
        losses.append(stats["loss"])
        mets.append(stats["metrics"])

    np.testing.assert_allclose(np.concatenate(losses), np.concatenate(jax_losses), **LOSS_TOL)
    np.testing.assert_allclose(np.concatenate(mets), np.concatenate(jax_mets), atol=1e-6)
    want = port_params(jax.tree_util.tree_map(np.asarray, jax_engine.gather_center(state)))
    got = engine.gather_center(pstate)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **PARAM_TOL,
                                   err_msg=name)
    assert pstate.epoch == int(state.epoch) == 2
    assert int(pstate.center_rule["num_updates"]) == int(state.center_rule["num_updates"])


def test_state_layout_follows_jax():
    init = {k: torch.ones(2, 3) * i for i, k in enumerate(("a", "b"))}
    engine = WindowedEngine(FixedInit(TransformerLM(**LM), init), "mse", "adam", Downpour(2),
                            num_workers=3, metrics=(), device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    assert state.center_params["a"].shape == (2, 3)
    assert state.local_params["b"].shape == (3, 2, 3)
    assert state.opt_state["count"].shape == (3,)
    assert state.rule_local["anchor"]["a"].shape == (3, 2, 3)
    assert len(state.rng) == 3 and state.epoch == 0
    # every worker holds its own copy of the center
    state.local_params["a"][0].add_(1.0)
    assert float(state.center_params["a"].sum()) == 0.0
    assert float(state.local_params["a"][1].sum()) == 0.0
    np.testing.assert_array_equal(engine.worker_slice(state.local_params, 2)["b"].numpy(),
                                  np.ones((2, 3)))


def test_no_commit_rule_keeps_workers_apart():
    # Sequential never commits: the center stays at its initial value
    x, y = lm_data(n=32)
    xs, ys = epoch_data(x, y, num_workers=2, n_windows=1, window=2, batch=8)
    init = port_params(FlaxModel(JaxLM(**LM)).init(jax.random.PRNGKey(1), x[:8])[0])
    engine = WindowedEngine(FixedInit(TransformerLM(**LM), init), "token_crossentropy",
                            ("sgd", {"learning_rate": 0.1}), Sequential(), num_workers=2,
                            metrics=(), device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    state, stats = engine.run_epoch(state, *engine.shard_batches(xs, ys))
    assert stats["loss"].shape == (1,) and stats["metrics"].shape == (1, 0)
    for name, value in init.items():
        torch.testing.assert_close(state.center_params[name], value, atol=0, rtol=0)
    w = "lm_head.weight"
    assert not torch.equal(state.local_params[w][0], state.local_params[w][1])
    averaged, _ = engine.average_workers(state)
    torch.testing.assert_close(averaged.center_params[w], state.local_params[w].mean(0))


@pytest.mark.parametrize("kwargs", [dict(remat=True), dict(unroll=2), dict(unroll=True)],
                         ids=lambda kw: f"{next(iter(kw))}={next(iter(kw.values()))}")
def test_ported_engine_options_keep_the_trajectory(kwargs):
    # accepted since remat and unroll are ported (these replace their cases
    # in test_unported_engine_options_raise): on the CPU, remat recomputes
    # the same forward and unroll is a hint, so an epoch is bitwise the
    # default one
    x, y = lm_data(n=32)
    xs, ys = epoch_data(x, y, num_workers=2, n_windows=2, window=2, batch=4)
    init = port_params(FlaxModel(JaxLM(**LM)).init(jax.random.PRNGKey(1), x[:4])[0])

    def run(**kw):
        engine = WindowedEngine(FixedInit(TransformerLM(**LM), init), "token_crossentropy",
                                ("sgd", {"learning_rate": 0.1}), Downpour(2), num_workers=2,
                                metrics=(), device="cpu", **kw)
        state = engine.init_state(torch.Generator().manual_seed(0), None)
        return engine.run_epoch(state, *engine.shard_batches(xs, ys))

    (state, stats), (want_state, want_stats) = run(**kwargs), run()
    np.testing.assert_array_equal(stats["loss"], want_stats["loss"])
    for name, value in want_state.center_params.items():
        assert torch.equal(state.center_params[name], value), name


@pytest.mark.parametrize("kwargs", [dict(mesh=object()), dict(seq_shards=2), dict(fsdp=True)])
def test_unported_engine_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        WindowedEngine(TorchModel(TransformerLM(**LM)), "mse", "sgd", Downpour(2),
                       num_workers=2, device="cpu", **kwargs)


def test_commit_schedule_is_accepted_and_runs_a_step():
    # the staleness simulation: epoch arrays [workers, steps, batch, ...]
    x, y = lm_data(n=32)
    engine = WindowedEngine(TorchModel(TransformerLM(**LM)), "token_crossentropy", "sgd",
                            Downpour(2), num_workers=2, metrics=(),
                            commit_schedule=np.array([1, 2]), device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    xs, ys = x[:16].reshape(2, 1, 8, -1), y[:16].reshape(2, 1, 8, -1)
    state, stats = engine.run_epoch(state, *engine.shard_batches(xs, ys))
    assert stats["loss"].shape == (1,) and np.isfinite(stats["loss"]).all()
    assert stats["metrics"].shape == (0,)
    assert int(state.center_rule["num_updates"]) == 1  # period 1 commits, period 2 waits
    with pytest.raises(ValueError, match="commit_schedule has 3 entries"):
        WindowedEngine(TorchModel(TransformerLM(**LM)), "mse", "sgd", Downpour(2),
                       num_workers=2, commit_schedule=[1, 2, 3], device="cpu")


def test_plan_workers_matches_jax():
    from distkeras_tpu.parallel.engine import plan_workers as jax_plan_workers

    for workers, devices in ((2, 1), (4, 8), (6, 4), (7, 2)):
        assert plan_workers(workers, devices) == jax_plan_workers(workers, devices)


def test_engine_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WindowedEngine(TorchModel(TransformerLM(**LM)), "mse", "sgd", Downpour(2))


def test_bfloat16_compute_keeps_f32_master_params_and_tracks_jax():
    # compute_dtype casts params and inputs inside the loss; the master
    # params and the optimizer stay f32.  bf16 rounds at other places in
    # the two frameworks, so the losses are held to 1e-2 relative only.
    import jax.numpy as jnp

    x, y = lm_data(n=64)
    xs, ys = epoch_data(x, y, num_workers=2, n_windows=2, window=2, batch=8)
    jax_engine = JaxEngine(FlaxModel(JaxLM(**LM)), "token_crossentropy",
                           ("sgd", {"learning_rate": 0.05}), JaxDownpour(2), num_workers=2,
                           metrics=(), compute_dtype=jnp.bfloat16)
    state = jax_engine.init_state(jax.random.PRNGKey(2), xs[0, 0, 0])
    init = port_params(jax.tree_util.tree_map(np.asarray, state.center_params))
    _, jax_stats = jax_engine.run_epoch(state, *jax_engine.shard_batches(xs, ys))

    engine = WindowedEngine(FixedInit(TransformerLM(**LM), init), "token_crossentropy",
                            ("sgd", {"learning_rate": 0.05}), Downpour(2), num_workers=2,
                            metrics=(), compute_dtype=torch.bfloat16, device="cpu")
    pstate = engine.init_state(torch.Generator().manual_seed(0), None)
    pstate, stats = engine.run_epoch(pstate, *engine.shard_batches(xs, ys))
    assert all(t.dtype == torch.float32 for t in pstate.center_params.values())
    assert all(t.dtype == torch.float32 for t in pstate.local_params.values())
    np.testing.assert_allclose(stats["loss"], np.asarray(jax_stats["loss"]), rtol=1e-2)
