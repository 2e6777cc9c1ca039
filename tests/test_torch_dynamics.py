"""Training dynamics in the port, against tests/test_dynamics.py: the
on-device health stats the engines compute under ``DISTKERAS_DYNAMICS``
(gradient and update norms, worker<->center divergence, non-finite counts,
effective staleness, the rules' own extras), the free disabled path, the
divergence watchdog's policies end to end through the trainers, and the
``AdaptiveBound`` staleness policy.

Both packages run the same toy run: one flax initialisation carried over
with ``variables_from_flax``, the same epoch arrays.  The per-epoch series
and their summary are held to JAX's within 1e-4 relative; integers and
the staleness clocks exactly; the watchdog's and ``AdaptiveBound``'s
decisions on the same summaries are the same.  JAX's "lowering is
byte-identical" pin becomes: with dynamics off the stats have no
``dynamics`` key and no tree helper runs; on or off, the trajectory is the
same bit for bit.  The captured-window case needs the card and runs from
tests/test_torch_graphs.py, which imports no JAX.
"""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu import algorithms as jax_algorithms
from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.parallel import WindowedEngine as JaxEngine
from distkeras_tpu.parallel.gspmd import GSPMDEngine as JaxGSPMD
from distkeras_tpu_torch import algorithms, telemetry
from distkeras_tpu_torch.data import epoch_arrays
from distkeras_tpu_torch.models import TorchModel, variables_from_flax, zoo
from distkeras_tpu_torch.parallel import GSPMDEngine, WindowedEngine
from distkeras_tpu_torch.telemetry.dynamics import (
    DivergenceWatchdog,
    DynamicsConfig,
    TrainingDiverged,
)

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

REL = 1e-4
MLP_KW = dict(features=(16,), num_classes=2)
SGD = ("sgd", {"learning_rate": 0.1})


@pytest.fixture(autouse=True)
def reset_dynamics():
    """Both packages' dynamics config is process-cached (engines read it at
    build); leave every test with the env-driven defaults restored."""
    yield
    for t in (telemetry, jax_telemetry):
        t.dynamics.configure()
        t.configure(None)
        t.trace.reset()
        t.metrics.reset()


def _both(**kw):
    for t in (telemetry, jax_telemetry):
        t.dynamics.configure(**kw)


def _toy(n=256, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,))
    y = (x @ w > 0).astype(np.int32)
    onehot = np.zeros((n, 2), np.float32)
    onehot[np.arange(n), y] = 1.0
    return x, onehot


class FixedInit(TorchModel):
    """Test-side adapter whose ``init`` returns given parameters."""

    def __init__(self, module, params):
        super().__init__(module)
        self.params = params

    def init(self, generator, sample_input):
        return {k: v.clone() for k, v in self.params.items()}, {}


def _flax_params(seed=0, d=8):
    variables = jax_zoo.MLP(**MLP_KW).init(jax.random.PRNGKey(seed), np.zeros((1, d), np.float32))
    params, _ = variables_from_flax(zoo.MLP(**MLP_KW, in_features=d),
                                    jax.tree_util.tree_map(np.asarray, variables))
    return params


def _port_mlp(params=None):
    module = zoo.MLP(**MLP_KW, in_features=8)
    return FixedInit(module, params if params is not None else _flax_params())


def _run_pair(rule_name="Downpour", workers=2, schedule=None, gspmd=False, batch=16, window=2):
    """One epoch of the same run in both packages: ``(jax stats, port
    stats)`` as numpy."""
    x, onehot = _toy()
    stepwise = schedule is not None
    xs, ys = epoch_arrays(x, onehot, workers, batch, window, stepwise=stepwise)
    kw = dict(num_workers=workers, metrics=(),
              commit_schedule=None if schedule is None else np.asarray(schedule))
    jax_cls = JaxGSPMD if gspmd else JaxEngine
    jeng = jax_cls(FlaxModel(jax_zoo.MLP(**MLP_KW)), "categorical_crossentropy", SGD,
                   getattr(jax_algorithms, rule_name)(window), **kw)
    jstate = jeng.init_state(jax.random.PRNGKey(0), x[:batch])
    _, jstats = jeng.run_epoch(jstate, *jeng.shard_batches(xs, ys))
    cls = GSPMDEngine if gspmd else WindowedEngine
    eng = cls(_port_mlp(), "categorical_crossentropy", SGD, getattr(algorithms, rule_name)(window),
              device="cpu", **kw)
    state = eng.init_state(torch.Generator().manual_seed(0), x[:batch])
    _, stats = eng.run_epoch(state, *eng.shard_batches(xs, ys))
    return jax.tree_util.tree_map(np.asarray, jstats), stats


def _assert_series_match(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=REL, atol=1e-6, err_msg=key)


# ------------------------------------------------------------------- config

def test_config_defaults_and_env(monkeypatch):
    assert DynamicsConfig().enabled is False  # off unless asked for
    monkeypatch.delenv("DISTKERAS_DYNAMICS", raising=False)
    assert DynamicsConfig.from_env().enabled is False
    monkeypatch.setenv("DISTKERAS_DYNAMICS", "1")
    monkeypatch.setenv("DISTKERAS_DYNAMICS_WATCHDOG", "halt")
    monkeypatch.setenv("DISTKERAS_DYNAMICS_FACTOR", "5.5")
    cfg = DynamicsConfig.from_env()
    assert (cfg.enabled, cfg.watchdog, cfg.divergence_factor) == (True, "halt", 5.5)
    with pytest.raises(ValueError):
        DynamicsConfig(watchdog="explode")
    with pytest.raises(ValueError):
        DynamicsConfig(divergence_factor=0.5)


def test_configure_overrides_and_enabled():
    telemetry.dynamics.configure(enabled=True, watchdog="off")
    assert telemetry.dynamics.enabled() is True
    assert DivergenceWatchdog.from_config() is None  # off policy: unarmed
    telemetry.dynamics.configure(enabled=False)
    assert telemetry.dynamics.enabled() is False


# ------------------------------------------------- disabled path stays free

def test_disabled_path_has_no_dynamics_key_and_calls_no_tree_helper(monkeypatch):
    def trap(*a, **k):
        raise AssertionError("a dynamics helper ran with dynamics off")

    for name in ("tree_sq_norm", "tree_sq_dist", "tree_nonfinite_count"):
        monkeypatch.setattr(telemetry.dynamics, name, trap)
    _both(enabled=False)
    _, stats = _run_pair()
    assert sorted(stats) == ["loss", "metrics"]
    _, stats = _run_pair("DynSGD", workers=4, schedule=[1, 2, 1, 4])
    assert sorted(stats) == ["loss", "metrics"]


@pytest.mark.parametrize("schedule", [None, [1, 2]], ids=["windows", "stepwise"])
def test_trajectory_unchanged_by_dynamics(schedule):
    x, onehot = _toy()
    xs, ys = epoch_arrays(x, onehot, 2, 16, 2, stepwise=schedule is not None)
    runs = []
    for on in (False, True):
        telemetry.dynamics.configure(enabled=on, watchdog="off")
        eng = WindowedEngine(_port_mlp(), "categorical_crossentropy", SGD,
                             algorithms.DynSGD(2), 2, metrics=(), device="cpu",
                             commit_schedule=None if schedule is None else np.asarray(schedule))
        state = eng.init_state(torch.Generator().manual_seed(0), x[:16])
        state, stats = eng.run_epoch(state, *eng.shard_batches(xs, ys))
        runs.append((stats["loss"], eng.gather_center(state)))
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    for name, value in runs[0][1].items():
        assert torch.equal(runs[1][1][name], value), name


# ------------------------------------------------------- the stats, vs JAX

def test_windowed_engine_dynamics_match_jax():
    _both(enabled=True, watchdog="off")
    jstats, stats = _run_pair(workers=2)
    dyn, n_windows = stats["dynamics"], len(stats["loss"])
    for k in ("grad_norm", "update_norm", "nonfinite_grads", "nonfinite_params"):
        assert dyn[k].shape == (n_windows,), k
    for k in ("divergence", "staleness"):
        assert dyn[k].shape == (n_windows, 2), k
    assert np.all(dyn["grad_norm"] > 0) and np.all(dyn["update_norm"] > 0)
    assert np.all(dyn["nonfinite_grads"] == 0) and np.all(dyn["nonfinite_params"] == 0)
    assert np.all(dyn["staleness"] == 2.0)  # uniform window of 2 steps
    _assert_series_match(dyn, jstats["dynamics"])
    summary = telemetry.dynamics.summarize(dyn, loss=stats["loss"])
    want = jax_telemetry.dynamics.summarize(jstats["dynamics"], loss=jstats["loss"])
    assert sorted(summary) == sorted(want)
    for key in want:
        np.testing.assert_allclose(summary[key], want[key], rtol=REL, atol=1e-6, err_msg=key)


def test_gspmd_engine_rule_extras_match_jax():
    _both(enabled=True, watchdog="off")
    jstats, stats = _run_pair("Adag", workers=4, gspmd=True)
    dyn = stats["dynamics"]
    assert dyn["divergence"].shape == (len(stats["loss"]), 4)
    # Adag's dynamics() hook exposes its accumulation state pre-commit
    assert np.all(dyn["rule_accum_norm"] > 0)
    assert np.all(dyn["rule_accum_steps"] == 2.0)
    _assert_series_match(dyn, jstats["dynamics"])


def _expected_dynsgd_staleness(schedule, n_steps):
    """Host model of the PS race (tests/test_dynamics.py's): each step every
    worker observes ``num_updates`` before the step's commits; committers
    then bump the counter and adopt it as their clock."""
    clocks = [0] * len(schedule)
    num_updates = 0
    rows = []
    for t in range(n_steps):
        rows.append([num_updates - c for c in clocks])
        committers = [i for i, p in enumerate(schedule) if (t + 1) % p == 0]
        num_updates += len(committers)
        for i in committers:
            clocks[i] = num_updates
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("rule_name", ["DynSGD", "AdaptiveDynSGD"])
def test_dynsgd_staleness_matches_jax_and_rule_bookkeeping(rule_name):
    schedule = [1, 2, 1, 4]
    _both(enabled=True, watchdog="off")
    jstats, stats = _run_pair(rule_name, workers=4, schedule=schedule)
    dyn = stats["dynamics"]
    expected = _expected_dynsgd_staleness(schedule, 256 // (4 * 16))
    np.testing.assert_array_equal(dyn["rule_staleness"], expected)
    np.testing.assert_allclose(dyn["rule_scale"], 1.0 / (expected + 1.0), rtol=1e-6)
    _assert_series_match(dyn, jstats["dynamics"])
    summary = telemetry.dynamics.summarize(dyn, loss=stats["loss"])
    assert summary["rule_staleness_max"] == expected.max()
    assert summary["loss_nonfinite"] == 0.0
    telemetry.configure(True)
    telemetry.metrics.reset()
    telemetry.dynamics.record_gauges(summary)
    snap = telemetry.metrics.snapshot()
    assert snap["dynamics_rule_staleness_max"]["value"] == expected.max()


def test_run_epochs_and_streaming_carry_the_same_series():
    """``run_epochs`` and the streamed epoch concatenate the windows' series
    as ``run_epoch`` does."""
    telemetry.dynamics.configure(enabled=True, watchdog="off")
    x, onehot = _toy()
    xs, ys = epoch_arrays(x, onehot, 2, 16, 2)

    def engine():
        eng = WindowedEngine(_port_mlp(), "categorical_crossentropy", SGD, algorithms.Downpour(2),
                             2, metrics=(), device="cpu")
        return eng, eng.init_state(torch.Generator().manual_seed(0), x[:16])

    eng, state = engine()
    sx, sy = eng.shard_batches(xs, ys)
    _, one = eng.run_epoch(state, sx, sy)
    eng, state = engine()
    _, multi = eng.run_epochs(state, sx, sy, 1)
    eng, state = engine()
    blocks = ((xs[:, i], ys[:, i]) for i in range(xs.shape[1]))
    _, streamed = eng.run_epoch_streaming(state, blocks)
    for other in (multi, streamed):
        for key, value in one["dynamics"].items():
            np.testing.assert_array_equal(other["dynamics"][key], value, err_msg=key)


# ------------------------------------------------------------ trainer smoke

def _downpour(lib, model, **kw):
    base = dict(loss="categorical_crossentropy", worker_optimizer=("sgd", {"learning_rate": 0.1}),
                num_workers=2, batch_size=16, num_epoch=2, communication_window=2, seed=7)
    base.update(kw)
    return lib.DOWNPOUR(model, **base) if lib is jdk else lib.DOWNPOUR(model, device="cpu",
                                                                        **base)


def test_smoke_train_emits_dynamics_series(tmp_path, monkeypatch):
    """A 2-worker run with the flag on writes the grad-norm, update-norm,
    divergence and staleness series into the metrics JSONL, one line an
    epoch, with no non-finite event."""
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path))
    telemetry.configure(True)
    telemetry.trace.reset()
    telemetry.metrics.reset()
    telemetry.dynamics.configure(enabled=True, watchdog="off")
    x, onehot = _toy()
    _downpour(tdk, _port_mlp()).train(tdk.from_numpy(x, onehot))
    files = [f for f in os.listdir(tmp_path) if f.startswith("metrics_")]
    assert len(files) == 1
    lines = [json.loads(line) for line in open(tmp_path / files[0]) if line.strip()]
    series_lines = [line for line in lines if line.get("type") == "dynamics"]
    assert [line["epoch"] for line in series_lines] == [0, 1]
    series = series_lines[-1]["series"]
    assert {"grad_norm", "update_norm", "divergence", "staleness", "nonfinite_grads",
            "nonfinite_params"} <= set(series)
    n_windows = series["grad_norm"]["shape"][0]
    assert series["divergence"]["shape"] == [n_windows, 2]
    assert all(v == 0 for v in series["nonfinite_grads"]["values"])
    assert series_lines[-1]["summary"]["grad_norm"] > 0
    snap = telemetry.metrics.snapshot()
    assert "dynamics_grad_norm" in snap and "dynamics_divergence_max" in snap


# ---------------------------------------------------------------- watchdog

def _summary(**kw):
    base = {"nonfinite_grads_max": 0.0, "nonfinite_params_max": 0.0,
            "loss_nonfinite": 0.0, "divergence_max": 1.0}
    base.update(kw)
    return base


def test_watchdog_healthy_epochs_build_history():
    wd = DivergenceWatchdog(policy="warn", min_history=3)
    for e in range(4):
        assert wd.observe(e, _summary(divergence_max=1.0 + 0.1 * e)) is None
    assert wd.trips == 0


def test_watchdog_warn_on_nonfinite_and_divergence():
    wd = DivergenceWatchdog(policy="warn", divergence_factor=10.0, min_history=3)
    with pytest.warns(RuntimeWarning, match="non-finite"):
        assert wd.observe(0, _summary(nonfinite_grads_max=3.0)) == "warn"
    for e in range(3):
        wd.observe(e, _summary(divergence_max=1.0))
    with pytest.warns(RuntimeWarning, match="running median"):
        assert wd.observe(3, _summary(divergence_max=100.0)) == "warn"
    assert wd.trips == 2


def test_watchdog_halt_raises():
    wd = DivergenceWatchdog(policy="halt")
    with pytest.raises(TrainingDiverged, match="non-finite"):
        wd.observe(5, _summary(loss_nonfinite=2.0))


def test_watchdog_rollback_budget_then_escalates():
    wd = DivergenceWatchdog(policy="rollback", max_rollbacks=1)
    assert wd.observe(0, _summary(nonfinite_grads_max=1.0)) == "rollback"
    assert wd.pending_rollback is not None
    wd.rolled_back()
    assert wd.pending_rollback is None and wd.rollbacks == 1
    with pytest.raises(TrainingDiverged, match="budget of 1 exhausted"):
        wd.observe(1, _summary(nonfinite_grads_max=1.0))


def test_watchdog_divergence_needs_positive_median():
    wd = DivergenceWatchdog(policy="halt", min_history=2)
    for e in range(3):
        assert wd.observe(e, _summary(divergence_max=0.0)) is None
    assert wd.observe(3, _summary(divergence_max=5.0)) is None


@pytest.mark.parametrize("policy", ["warn", "halt", "rollback"])
def test_watchdog_decisions_match_jax(policy):
    """Both packages' watchdogs take the same action on the same summaries,
    with the same message."""
    summaries = [_summary(divergence_max=v) for v in (1.0, 1.2, 0.9, 1.1, 30.0, 1.0)]
    summaries += [_summary(nonfinite_params_max=2.0), _summary(loss_nonfinite=1.0)]
    actions = []
    for wd in (DivergenceWatchdog(policy, divergence_factor=10.0, max_rollbacks=1),
               jax_telemetry.dynamics.DivergenceWatchdog(policy, divergence_factor=10.0,
                                                         max_rollbacks=1)):
        seen = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for e, s in enumerate(summaries):
                try:
                    seen.append(wd.observe(e, dict(s)))
                except Exception as err:  # noqa: BLE001 — the halt is the decision
                    seen.append(f"{type(err).__name__}: {err}")
                    break
                if wd.pending_rollback:
                    wd.rolled_back()
        actions.append((seen, wd.trips, wd.rollbacks))
    assert actions[0] == actions[1]
    assert actions[0][1] >= 1  # the spike tripped it (and halted, under "halt")


# ------------------------------------------- watchdog through the trainers

def test_watchdog_halt_stops_forced_nonfinite_run_within_one_epoch(monkeypatch):
    telemetry.configure(False)
    telemetry.dynamics.configure(enabled=True, watchdog="halt")
    x, onehot = _toy()
    epochs_seen = []
    real = telemetry.dynamics.summarize

    def spy(dyn, loss=None):
        epochs_seen.append(len(epochs_seen))
        return real(dyn, loss=loss)

    monkeypatch.setattr(telemetry.dynamics, "summarize", spy)
    with pytest.raises(TrainingDiverged, match="non-finite"):
        _downpour(tdk, _port_mlp(), worker_optimizer=("sgd", {"learning_rate": 1e38}),
                  num_epoch=4).train(tdk.from_numpy(x, onehot))
    assert len(epochs_seen) == 1


def test_watchdog_rollback_restores_checkpoint_and_continues(tmp_path, monkeypatch):
    """Policy 'rollback': one poisoned epoch triggers one restore from the
    last checkpoint, training then runs to completion, and the restore
    reads the pre-divergence step."""
    from distkeras_tpu_torch import checkpoint as ckpt_mod

    telemetry.configure(True)
    telemetry.metrics.reset()
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    telemetry.dynamics.configure(enabled=True, watchdog="rollback")
    real = telemetry.dynamics.summarize
    calls = []

    def poisoned(dyn, loss=None):
        s = real(dyn, loss=loss)
        calls.append(s)
        if len(calls) == 3:  # epoch index 2
            s["nonfinite_grads_max"] = 1.0
        return s

    monkeypatch.setattr(telemetry.dynamics, "summarize", poisoned)
    restore_steps = []
    orig_restore = ckpt_mod.CheckpointManager.restore

    def spy_restore(self, like=None, step=None):
        restore_steps.append(step)
        return orig_restore(self, like=like, step=step)

    monkeypatch.setattr(ckpt_mod.CheckpointManager, "restore", spy_restore)
    x, onehot = _toy()
    _downpour(tdk, _port_mlp(), num_epoch=5, checkpoint_dir=str(tmp_path / "ckpt"),
              checkpoint_every=1).train(tdk.from_numpy(x, onehot))
    assert restore_steps == [2]
    assert len(calls) == 5
    snap = telemetry.metrics.snapshot()
    assert snap["dynamics_watchdog_trips_total"]["value"] == 1.0
    assert snap["dynamics_rollbacks_total"]["value"] == 1.0


def test_watchdog_rollback_before_any_checkpoint_halts(tmp_path, monkeypatch):
    telemetry.configure(False)
    telemetry.dynamics.configure(enabled=True, watchdog="rollback")
    real = telemetry.dynamics.summarize

    def poisoned(dyn, loss=None):
        s = real(dyn, loss=loss)
        s["nonfinite_grads_max"] = 1.0
        return s

    monkeypatch.setattr(telemetry.dynamics, "summarize", poisoned)
    x, onehot = _toy()
    with pytest.raises(TrainingDiverged, match="no checkpoint has been saved"):
        _downpour(tdk, _port_mlp(), num_epoch=3, checkpoint_dir=str(tmp_path / "ckpt"),
                  checkpoint_every=1).train(tdk.from_numpy(x, onehot))


def test_rollback_policy_requires_checkpoint_dir():
    telemetry.configure(False)
    telemetry.dynamics.configure(enabled=True, watchdog="rollback")
    x, onehot = _toy()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _downpour(tdk, _port_mlp()).train(tdk.from_numpy(x, onehot))


# ------------------------------------------------------------ AdaptiveBound

def test_adaptive_bound_sequence_matches_jax():
    """The same summaries give the same bounds, tightening on a divergence
    spike and never below the observed staleness + 1."""
    summaries = [{"divergence_max": d, "rule_staleness_mean": s}
                 for d, s in ((1.0, 0.0), (1.1, 1.0), (0.9, 0.5), (5.0, 3.0), (1.0, 7.5),
                              (1.0, 0.0), (9.0, 0.0), (1.0, 0.0))]
    bounds = []
    for cls in (algorithms.AdaptiveBound, jax_algorithms.AdaptiveBound):
        policy = cls(initial=8.0, history=4)
        bounds.append(([policy.observe(s) for s in summaries], policy.tightened,
                       policy.loosened))
    assert bounds[0] == bounds[1]
    assert bounds[0][1] >= 1  # the spikes tightened it


def test_adaptive_bound_through_the_trainers_matches_jax():
    """``AdaptiveDynSGD(staleness_policy=AdaptiveBound())`` in both packages:
    the bounds the policy returns epoch by epoch, from each package's own
    summaries, are the same, and the rule's leaf carries the last one."""
    _both(enabled=True, watchdog="off")
    x, onehot = _toy()
    runs = []
    for lib in (jdk, tdk):
        policy = (jax_algorithms if lib is jdk else algorithms).AdaptiveBound(initial=4.0)
        seen = []
        real = policy.observe
        policy.observe = lambda s, real=real, seen=seen: seen.append(real(s)) or seen[-1]
        model = FlaxModel(jax_zoo.MLP(**MLP_KW)) if lib is jdk else _port_mlp()
        kw = dict(loss="categorical_crossentropy", worker_optimizer=SGD, num_workers=2,
                  batch_size=16, num_epoch=3, communication_window=2, seed=0,
                  staleness_policy=policy, initial_bound=4.0)
        t = (lib.AdaptiveDynSGD(model, **kw) if lib is jdk
             else lib.AdaptiveDynSGD(model, device="cpu", **kw))
        t.train(lib.from_numpy(x, onehot))
        runs.append(seen)
    assert runs[0] == runs[1] and len(runs[1]) == 3


def test_staleness_policy_without_dynamics_warns():
    telemetry.dynamics.configure(enabled=False)
    x, onehot = _toy()
    t = tdk.AdaptiveDynSGD(_port_mlp(), loss="categorical_crossentropy", worker_optimizer=SGD,
                           num_workers=2, batch_size=16, num_epoch=1, communication_window=2,
                           staleness_policy=algorithms.AdaptiveBound(), device="cpu")
    with pytest.warns(RuntimeWarning, match="the bound will not adapt"):
        t.train(tdk.from_numpy(x, onehot))
