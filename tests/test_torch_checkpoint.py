"""``distkeras_tpu_torch.checkpoint`` and recovery.

* A resume is bitwise the uninterrupted run: every ``TrainState`` leaf
  (Adam's step count included) and every worker's dropout generator state
  are saved.
* Publication is the JAX package's: the manifest the port writes for a
  step is byte for byte the one the JAX package's ``write_manifest`` writes
  for the same directory and run id, and the JAX package's
  ``verify_checkpoint`` accepts the step (``fast`` and ``full``).
* A damaged newest step is quarantined and the restore falls back one
  step; GC keeps the newest ``keep`` published steps; unverified
  directories are never restored or collected.
* Elastic resume at another worker count goes through
  ``state_from_center``: from one center, the port's 4-worker epoch is held
  to the JAX package's within 1e-5 (f32).
* ``train_with_recovery`` retries a transient failure from the checkpoint
  (bitwise), never the same failure twice without progress, nothing
  without a checkpoint, and never ``fleet.Preempted``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu_torch as tdk
from conftest import epoch_data
from distkeras_tpu import checkpoint as jax_ckpt
from distkeras_tpu.algorithms import Downpour as JaxDownpour
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu.parallel import WindowedEngine as JaxEngine
from distkeras_tpu.telemetry.flightdeck import correlate as jax_correlate
from distkeras_tpu_torch import checkpoint as ckpt
from distkeras_tpu_torch import fleet
from distkeras_tpu_torch.algorithms import Downpour
from distkeras_tpu_torch.models import TorchModel, TransformerLM, params_from_flax
from distkeras_tpu_torch.parallel import WindowedEngine
from distkeras_tpu_torch.parallel import engine as engine_mod
from distkeras_tpu_torch.telemetry import correlate

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

LM = dict(vocab_size=23, dim=32, heads=2, num_layers=1, max_len=64)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _sigterm_restored():
    """``train_with_recovery`` installs the SIGTERM-to-flag handler: put the
    process's own back after each test."""
    import signal

    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)
    fleet._HANDLER_INSTALLED = False
    fleet.reset_preemption()


def lm_data(n=32, seq=16, vocab=23, seed=0):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n, 1))
    x = (start + np.arange(seq)) % vocab
    return x.astype(np.int32), ((x + 1) % vocab).astype(np.int32)


def _trainer(cls=tdk.DOWNPOUR, **kw):
    kw.setdefault("num_epoch", 2)
    kw.setdefault("num_workers", 2)
    if cls is not tdk.AveragingTrainer:
        kw.setdefault("communication_window", 2)
    return cls(TransformerLM(**LM, dropout=0.1), loss="token_crossentropy",
               metrics=("token_accuracy",), worker_optimizer=("adam", {}), batch_size=4,
               seed=6, device="cpu", **kw)


def _train(trainer, x, y):
    model = trainer.train(tdk.from_numpy(x, y), shuffle=True)
    return trainer.get_history(), model.params


def _engine(num_workers=2, optimizer="adam"):
    return WindowedEngine(TorchModel(TransformerLM(**LM, dropout=0.1)), "token_crossentropy",
                          optimizer, Downpour(2), num_workers=num_workers,
                          metrics=("token_accuracy",), device="cpu")


def _trained_state(engine, epochs=1):
    x, y = lm_data()
    xs, ys = engine.shard_batches(*epoch_data(x, y, engine.num_workers, 2, 2, 4))
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    for _ in range(epochs):
        state, _ = engine.run_epoch(state, xs, ys)
    return state, xs, ys


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    x, y = lm_data()
    want = _train(_trainer(), x, y)
    _train(_trainer(checkpoint_dir=str(tmp_path), num_epoch=1), x, y)
    resumed = _trainer(checkpoint_dir=str(tmp_path), resume=True)
    history, params = _train(resumed, x, y)
    assert history["loss"] == want[0]["loss"][1:]
    for name, value in want[1].items():
        assert torch.equal(params[name], value), name


def test_restore_brings_back_every_leaf_and_generator(tmp_path):
    engine = _engine()
    state, xs, ys = _trained_state(engine)
    ckpt.save_checkpoint(str(tmp_path), state, 1)
    ckpt.wait_until_finished()
    fresh = engine.init_state(torch.Generator().manual_seed(99), None)
    restored = ckpt.restore_checkpoint(str(tmp_path), like=fresh)
    assert restored.epoch == state.epoch == 1
    # Adam's step count: 2 windows of 2 steps
    assert int(restored.opt_state["count"][0]) == int(state.opt_state["count"][0]) == 4
    pairs = []
    engine_mod.tree_map(lambda a, b: pairs.append((a, b)), engine_mod._state_trees(state),
                        engine_mod._state_trees(restored))
    assert len(pairs) > 10
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)
    for g, h in zip(state.rng, restored.rng):
        assert torch.equal(g.get_state(), h.get_state())
    # and the next epoch continues bitwise, dropout masks included
    a, _ = engine.run_epoch(state, xs, ys)
    b, _ = engine.run_epoch(restored, xs, ys)
    for name in a.center_params:
        assert torch.equal(a.center_params[name], b.center_params[name]), name


def test_snapshot_is_taken_before_save_returns(tmp_path):
    # the engine updates the state in place: what is saved is the state at
    # the call, whatever happens to the tensors afterwards
    engine = _engine()
    state, _, _ = _trained_state(engine)
    want = state.center_params["lm_head.weight"].clone()
    ckpt.save_checkpoint(str(tmp_path), state, 1)
    state.center_params["lm_head.weight"].add_(1.0)
    restored = ckpt.restore_checkpoint(str(tmp_path))
    assert torch.equal(restored["center_params"]["lm_head.weight"], want)
    assert ckpt.checkpoint_num_workers(str(tmp_path)) == 2


def test_bfloat16_leaves_round_trip(tmp_path):
    engine = _engine()
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    state = state.replace(center_params={k: v.to(torch.bfloat16)
                                         for k, v in state.center_params.items()})
    ckpt.save_checkpoint(str(tmp_path), state, 3)
    restored = ckpt.restore_checkpoint(str(tmp_path))["center_params"]
    for name, value in state.center_params.items():
        assert restored[name].dtype == torch.bfloat16 and torch.equal(restored[name], value)


def test_manifest_is_the_jax_packages_and_jax_verifies_the_step(tmp_path, monkeypatch):
    monkeypatch.setenv("DISTKERAS_RUN_ID", "run-under-test")
    correlate.set_run_id(None)
    jax_correlate.set_run_id(None)
    try:
        engine = _engine()
        state, _, _ = _trained_state(engine)
        ckpt.save_checkpoint(str(tmp_path), state, 1)
        ckpt.wait_until_finished()
        path = ckpt.manifest_path(str(tmp_path), 1)
        ours = open(path, "rb").read()
        manifest = json.loads(ours)
        assert set(manifest) == {"version", "step", "run_id", "files"}
        assert manifest["version"] == 1 and manifest["step"] == 1
        assert manifest["run_id"] == "run-under-test"
        assert all(set(f) == {"sha256", "bytes"} for f in manifest["files"].values())
        # the JAX package's commit record for the same directory, byte for byte
        os.remove(path)
        jax_ckpt.write_manifest(str(tmp_path), 1)
        assert open(path, "rb").read() == ours
        for mode in ("fast", "full"):
            assert jax_ckpt.verify_checkpoint(str(tmp_path), 1, mode)
            assert ckpt.verify_checkpoint(str(tmp_path), 1, mode)
        assert jax_ckpt.committed_steps(str(tmp_path)) == ckpt.committed_steps(str(tmp_path)) == [1]
    finally:
        correlate.set_run_id(None)
        jax_correlate.set_run_id(None)


def _flip_a_byte(path):
    """Damage ``path`` as bit rot would: one bit flipped, the size kept (the
    damaged copy is put in place whole)."""
    with open(path, "rb") as fh:
        raw = bytearray(fh.read())
    raw[len(raw) // 2] ^= 0x01
    with open(path + ".tmp", "wb") as fh:
        fh.write(bytes(raw))
    os.replace(path + ".tmp", path)


def test_flipped_byte_is_quarantined_and_restore_falls_back(tmp_path):
    engine = _engine()
    state, xs, ys = _trained_state(engine)
    manager = ckpt.CheckpointManager(str(tmp_path))
    manager.maybe_save(state, 0)
    state, _ = engine.run_epoch(state, xs, ys)
    manager.maybe_save(state, 1)
    manager.wait()
    victim = os.path.join(str(tmp_path), "step_2", "center_params.npz")
    _flip_a_byte(victim)
    assert ckpt.verify_checkpoint(str(tmp_path), 2, "fast")  # sizes intact
    assert not ckpt.verify_checkpoint(str(tmp_path), 2, "full")
    assert not jax_ckpt.verify_checkpoint(str(tmp_path), 2, "full")
    assert manager.latest_verified() == 1
    names = set(os.listdir(str(tmp_path)))
    assert {"step_2.corrupt", "step_2.corrupt.manifest.json"} <= names
    assert ckpt.committed_steps(str(tmp_path)) == [1]
    assert manager.restore(like=engine.init_state(torch.Generator(), None)).epoch == 1


def test_gc_keeps_the_newest_and_never_touches_unverified(tmp_path):
    engine = _engine()
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    orphan = tmp_path / "step_99"
    orphan.mkdir()
    manager = ckpt.CheckpointManager(str(tmp_path), keep=3)
    for epoch in range(5):
        manager.maybe_save(state.replace(epoch=epoch + 1), epoch)
    manager.wait()
    assert ckpt.committed_steps(str(tmp_path)) == [3, 4, 5]
    assert orphan.is_dir()  # unpublished: never collected
    assert manager.latest_verified() == 5  # and never restored
    with pytest.raises(FileNotFoundError, match="unverified"):
        ckpt.restore_checkpoint(str(tmp_path), step=99)
    watcher = ckpt.CheckpointWatcher(str(tmp_path), start_after=-1)
    assert watcher.poll() == 5 and watcher.poll() is None


def test_every_n_epochs_and_worker_mean(tmp_path):
    engine = _engine()
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    manager = ckpt.CheckpointManager(str(tmp_path), every=2)
    assert manager.maybe_save(state, 0) is None
    assert manager.maybe_save(state, 1) is not None
    manager.wait()
    assert ckpt.latest_step(str(tmp_path)) == 2
    ints = torch.tensor([[1, 2], [2, 2]], dtype=torch.int32)
    assert torch.equal(ckpt.worker_mean(ints), torch.tensor([2, 2], dtype=torch.int32))
    np.testing.assert_array_equal(ckpt.worker_mean(ints).numpy(),
                                  jax_ckpt.worker_mean(ints.numpy()))


def test_elastic_state_from_center_matches_jax():
    # one center (the JAX engine's after an epoch at 2 workers), rebuilt at
    # 4 workers by both packages and trained one more epoch
    x, y = lm_data(n=64)
    xs2, ys2 = epoch_data(x, y, num_workers=2, n_windows=2, window=2, batch=4)
    xs4, ys4 = epoch_data(x, y, num_workers=4, n_windows=1, window=2, batch=4)
    opt = ("sgd", {"learning_rate": 0.05})
    jax2 = JaxEngine(FlaxModel(JaxLM(**LM)), "token_crossentropy", opt, JaxDownpour(2),
                     num_workers=2, metrics=())
    jstate = jax2.init_state(jax.random.PRNGKey(0), xs2[0, 0, 0])
    jstate, _ = jax2.run_epoch(jstate, *jax2.shard_batches(xs2, ys2))
    center = jax.tree_util.tree_map(np.asarray, jstate.center_params)
    rule = jax.tree_util.tree_map(np.asarray, jstate.center_rule)

    jax4 = JaxEngine(FlaxModel(JaxLM(**LM)), "token_crossentropy", opt, JaxDownpour(2),
                     num_workers=4, metrics=())
    j4 = jax4.state_from_center(jax.random.PRNGKey(1), center, rule, {}, 1)
    j4, jstats = jax4.run_epoch(j4, *jax4.shard_batches(xs4, ys4))

    port4 = WindowedEngine(TorchModel(TransformerLM(**LM)), "token_crossentropy", opt,
                           Downpour(2), num_workers=4, metrics=(), device="cpu")
    p4 = port4.state_from_center(torch.Generator().manual_seed(1),
                                 params_from_flax(TransformerLM(**LM), center), rule, {}, 1)
    assert p4.epoch == 1 and int(p4.center_rule["num_updates"]) == int(rule["num_updates"])
    assert p4.local_params["lm_head.weight"].shape[0] == 4
    p4, stats = port4.run_epoch(p4, *port4.shard_batches(xs4, ys4))
    np.testing.assert_allclose(stats["loss"], np.asarray(jstats["loss"]), **TOL)
    want = params_from_flax(TransformerLM(**LM), jax.tree_util.tree_map(
        np.asarray, j4.center_params))
    for name, value in want.items():
        np.testing.assert_allclose(p4.center_params[name].numpy(), value.numpy(), **TOL,
                                   err_msg=name)
    assert int(p4.center_rule["num_updates"]) == int(j4.center_rule["num_updates"])


def test_trainer_elastic_resume_from_2_to_4_workers(tmp_path):
    x, y = lm_data(n=64)
    first = _trainer(checkpoint_dir=str(tmp_path), num_epoch=1)
    _train(first, x, y)
    updates = first.num_updates
    grown = _trainer(checkpoint_dir=str(tmp_path), resume=True, num_workers=4)
    history, _ = _train(grown, x, y)
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"]).all()
    # the center's commit counter carried over: 2 windows of 4 workers more
    assert grown.num_updates == updates + 4 * 2
    assert ckpt.checkpoint_num_workers(str(tmp_path)) == 4


def test_elastic_resume_refuses_non_committing_rules(tmp_path):
    x, y = lm_data()
    _train(_trainer(tdk.AveragingTrainer, checkpoint_dir=str(tmp_path), num_epoch=1), x, y)
    with pytest.raises(ValueError, match="requires a committing rule"):
        _train(_trainer(tdk.AveragingTrainer, checkpoint_dir=str(tmp_path), resume=True,
                        num_workers=4), x, y)


class _Failing:
    """Patch ``WindowedEngine.run_epoch`` to raise ``error`` on the calls in
    ``at`` (1-based, counted over the whole test)."""

    def __init__(self, monkeypatch, at, error=lambda: RuntimeError("lost a worker")):
        self.calls, self.at, self.error = 0, set(at), error
        real = WindowedEngine.run_epoch

        def run_epoch(engine, *args, **kwargs):
            self.calls += 1
            if self.calls in self.at:
                raise self.error()
            return real(engine, *args, **kwargs)

        monkeypatch.setattr(WindowedEngine, "run_epoch", run_epoch)


def test_train_with_recovery_retries_a_transient_failure(tmp_path, monkeypatch):
    x, y = lm_data()
    want = _train(_trainer(num_epoch=3), x, y)
    _Failing(monkeypatch, at={2})  # the second epoch fails once
    t = _trainer(checkpoint_dir=str(tmp_path), num_epoch=3)
    model = t.train_with_recovery(tdk.from_numpy(x, y), shuffle=True, backoff_base=0)
    for name, value in want[1].items():
        assert torch.equal(model.params[name], value), name


def test_train_with_recovery_never_repeats_a_failure_without_progress(tmp_path, monkeypatch):
    x, y = lm_data()
    failing = _Failing(monkeypatch, at=set(range(2, 100)))  # every epoch after the first
    t = _trainer(checkpoint_dir=str(tmp_path), num_epoch=3)
    with pytest.raises(RuntimeError, match="lost a worker"):
        t.train_with_recovery(tdk.from_numpy(x, y), backoff_base=0, max_retries=5)
    # attempt 1: epoch 1 saved, epoch 2 fails; attempt 2 resumes and fails the
    # same way with no new checkpoint: raised, not retried a third time
    assert failing.calls == 3


def test_train_with_recovery_needs_a_checkpoint_to_retry(tmp_path, monkeypatch):
    x, y = lm_data()
    failing = _Failing(monkeypatch, at={1})
    with pytest.raises(RuntimeError, match="lost a worker"):
        _trainer(checkpoint_dir=str(tmp_path)).train_with_recovery(
            tdk.from_numpy(x, y), backoff_base=0)
    assert failing.calls == 1
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        _trainer().train_with_recovery(tdk.from_numpy(x, y))


def test_preemption_leaves_a_boundary_checkpoint_and_is_never_retried(tmp_path):
    import signal

    x, y = lm_data()
    fleet.reset_preemption()
    assert fleet.install_preemption_handler()
    os.kill(os.getpid(), signal.SIGTERM)  # a real SIGTERM: the handler sets the flag
    assert fleet.preemption_requested()
    try:
        t = _trainer(checkpoint_dir=str(tmp_path), checkpoint_every=5, num_epoch=3)
        with pytest.raises(fleet.Preempted, match="epoch 1 boundary checkpoint"):
            t.train_with_recovery(tdk.from_numpy(x, y), backoff_base=0)
    finally:
        fleet.reset_preemption()
    assert ckpt.committed_steps(str(tmp_path)) == [1]
    data_state = ckpt.restore_data_state(str(tmp_path), 1)
    assert (data_state.epoch, data_state.block_cursor) == (1, 0)
