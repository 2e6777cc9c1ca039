"""Port parity: the engine's stepwise staleness simulation
(``commit_schedule``) against the JAX package's, on a small ``MLP`` with
``commit_schedule=[1, 2, 3]``: three workers, each committing every
``period`` steps, all committers of a step racing the same center.

Both engines start from one flax initialisation (``variables_from_flax``)
and see the same stepwise epoch arrays ``[workers, steps, batch, ...]``.
Integers (``num_updates``, per-worker clocks) are held exactly; per-step
losses within 1e-5 relative, parameters within the JAX package's own
trajectory tolerance (rtol 2e-3 / atol 2e-4).
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import algorithms as jax_algorithms
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.parallel import WindowedEngine as JaxEngine
from distkeras_tpu_torch import algorithms
from distkeras_tpu_torch.data import epoch_arrays
from distkeras_tpu_torch.models import TorchModel, variables_from_flax, zoo
from distkeras_tpu_torch.parallel import WindowedEngine
from test_staleness import simulate_clocks  # the JAX package's host model of the race

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

SCHEDULE = [1, 2, 3]
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
MLP_KW = dict(features=(16, 8), num_classes=3)


class FixedInit(TorchModel):
    """Test-side adapter whose ``init`` returns given parameters and buffers."""

    def __init__(self, module, params, buffers=None):
        super().__init__(module)
        self.params, self.buffers = params, buffers or {}

    def init(self, generator, sample_input):
        return dict(self.params), {k: v.clone() for k, v in self.buffers.items()}


def _data(n=72, d=12, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


@pytest.mark.parametrize(
    "rule_name, kwargs",
    [("DynSGD", {}), ("Adag", {}), ("Downpour", {}), ("AdaptiveDynSGD", {"initial_bound": 1.0})],
    ids=["DynSGD", "Adag", "Downpour", "AdaptiveDynSGD-bound1"],
)
def test_stepwise_engine_matches_jax(rule_name, kwargs):
    x, y = _data()
    # 72 rows = 3 workers x 6 steps x batch 4: two windows of 3 a worker
    xs, ys = epoch_arrays(x, y, num_workers=3, batch_size=4, window=3, stepwise=True)
    assert xs.shape == (3, 6, 4, 12)
    opt = ("sgd", {"learning_rate": 0.1})

    jax_engine = JaxEngine(FlaxModel(jax_zoo.MLP(**MLP_KW)), "categorical_crossentropy", opt,
                           getattr(jax_algorithms, rule_name)(3, **kwargs), num_workers=3,
                           metrics=(), commit_schedule=np.array(SCHEDULE))
    jstate = jax_engine.init_state(jax.random.PRNGKey(0), xs[0, 0])
    params, buffers = variables_from_flax(
        zoo.MLP(**MLP_KW, in_features=12),
        {"params": jax.tree_util.tree_map(np.asarray, jstate.center_params)})
    jxs, jys = jax_engine.shard_batches(xs, ys)
    jax_losses = []
    for _ in range(2):
        jstate, stats = jax_engine.run_epoch(jstate, jxs, jys)
        jax_losses.append(np.asarray(stats["loss"]))

    engine = WindowedEngine(FixedInit(zoo.MLP(**MLP_KW, in_features=12), params, buffers),
                            "categorical_crossentropy", opt,
                            getattr(algorithms, rule_name)(3, **kwargs), num_workers=3,
                            metrics=(), commit_schedule=SCHEDULE, device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    pxs, pys = engine.shard_batches(xs, ys)
    losses = []
    for _ in range(2):
        state, stats = engine.run_epoch(state, pxs, pys)
        assert stats["metrics"].shape == (0,)
        losses.append(stats["loss"])

    np.testing.assert_allclose(np.concatenate(losses), np.concatenate(jax_losses), **LOSS_TOL)
    num_updates = int(state.center_rule["num_updates"])
    assert num_updates == int(jstate.center_rule["num_updates"])
    if "clock" in state.rule_local:
        np.testing.assert_array_equal(state.rule_local["clock"].numpy(),
                                      np.asarray(jstate.rule_local["clock"]).reshape(-1))
    if rule_name in ("DynSGD", "Adag", "Downpour"):
        # every scheduled commit lands: 6 + 3 + 2 a epoch
        clocks, want_updates, staleness = simulate_clocks(SCHEDULE, 6, n_epochs=2)
        assert num_updates == want_updates == 22 and max(staleness) > 0
        if rule_name == "DynSGD":
            assert state.rule_local["clock"].tolist() == clocks
    else:
        # the bound drops the stale commits: fewer updates than scheduled
        assert num_updates < 22
    want = jax.tree_util.tree_map(np.asarray, jstate.center_params)
    want, _ = variables_from_flax(zoo.MLP(**MLP_KW, in_features=12), {"params": want})
    for name, value in want.items():
        np.testing.assert_allclose(state.center_params[name].numpy(), value.numpy(),
                                   **PARAM_TOL, err_msg=name)


def test_stepwise_engine_syncs_model_state_under_the_mask():
    # ResNet20's running statistics: a worker's buffers become the mean over
    # all workers exactly at its own commit steps
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    engine = WindowedEngine(TorchModel(zoo.ResNet20()), "categorical_crossentropy", "sgd",
                            algorithms.Adag(2), num_workers=2, metrics=(),
                            commit_schedule=[1, 2], device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    xs, ys = epoch_arrays(x, y, num_workers=2, batch_size=4, window=1, stepwise=True)
    pxs, pys = engine.shard_batches(xs[:, :1], ys[:, :1])
    state, _ = engine.run_epoch(state, pxs, pys)  # one step: only worker 0 commits
    name = "stem_bn.running_mean"
    stats = state.model_state[name]
    assert not torch.equal(stats[0], stats[1])
    pxs, pys = engine.shard_batches(xs[:, 1:2], ys[:, 1:2])
    engine.commit_schedule = np.array([1, 1], np.int32)  # both commit on the next step
    state, _ = engine.run_epoch(state, pxs, pys)
    stats = state.model_state[name]
    torch.testing.assert_close(stats[0], stats[1], rtol=0, atol=0)
    assert float(stats.abs().max()) > 0.0
