"""Streaming (``streaming=True``, ``prefetch``) and the mid-epoch checkpoint
(``checkpoint_blocks``).

* The streamed trajectory equals the in-memory one bit for bit, with no
  prefetch and through a ``PrefetchRing`` of depth 2, with f32 and with
  bfloat16 compute (the fused native gather), and for a trainer that never
  commits (ragged tail windows): tests/test_streaming.py's invariant.
* Against the JAX package's streaming ``DOWNPOUR`` on the tiny causal
  ``TransformerLM``, from the same flax-initialised parameters and the same
  shuffle: history and center parameters within 1e-5 (f32).
* A run killed mid-epoch resumes from its ``checkpoint_blocks`` save at the
  block it died on, and ends bitwise where the uninterrupted run ends.
"""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu_torch import trainers as trainers_mod
from distkeras_tpu_torch.models import TorchModel, TransformerLM, params_from_flax, zoo

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


def _lm_trainer(**kw):
    return tdk.DOWNPOUR(TransformerLM(**LM, dropout=0.1), loss="token_crossentropy",
                        metrics=("token_accuracy",), worker_optimizer=("adam", {}),
                        num_workers=2, batch_size=4, communication_window=2, num_epoch=2,
                        seed=3, device="cpu", **kw)


def _same(a, b):
    (ha, pa), (hb, pb) = a, b
    assert ha["loss"] == hb["loss"]
    for name, value in pa.items():
        assert torch.equal(pb[name], value), name


def _train(trainer, x, y):
    model = trainer.train(tdk.from_numpy(x, y), shuffle=True)
    return trainer.get_history(), model.params


@pytest.mark.parametrize("prefetch", [0, 2])
def test_streaming_equals_in_memory_lm(prefetch):
    x, y = lm_data(n=72)  # 72 rows: the last window wrap-pads
    _same(_train(_lm_trainer(), x, y), _train(_lm_trainer(streaming=True, prefetch=prefetch), x, y))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_streaming_equals_in_memory_bf16_cnn(prefetch):
    # bfloat16 compute: the streamed blocks come from the fused native gather
    rng = np.random.default_rng(1)
    x = rng.normal(size=(48, 784)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(x))]

    def trainer(**kw):
        model = zoo.MNISTCNN(num_classes=3, generator=torch.Generator().manual_seed(0))
        return tdk.DOWNPOUR(model, loss="categorical_crossentropy", metrics=(),
                            worker_optimizer=("sgd", {"learning_rate": 0.05}), num_workers=2,
                            batch_size=4, communication_window=2, num_epoch=1,
                            compute_dtype="bfloat16", device="cpu", **kw)

    _same(_train(trainer(), x, y), _train(trainer(streaming=True, prefetch=prefetch), x, y))


def test_streaming_single_trainer_ragged_tail_equals_in_memory():
    x, y = lm_data(n=36)  # 9 steps of batch 4: blocks of 9 steps, no padding

    def trainer(**kw):
        return tdk.SingleTrainer(TransformerLM(**LM), loss="token_crossentropy",
                                 metrics=("token_accuracy",), batch_size=4, num_epoch=2,
                                 seed=1, device="cpu", **kw)

    plain, streamed = trainer(), trainer(streaming=True, prefetch=2)
    _same(_train(plain, x, y), _train(streamed, x, y))
    assert streamed.get_history()["token_accuracy"] == plain.get_history()["token_accuracy"]


def test_streaming_matches_jax_streaming():
    x, y = lm_data(n=72)
    kwargs = dict(loss="token_crossentropy", metrics=("token_accuracy",),
                  worker_optimizer=("sgd", {"learning_rate": 0.05}), num_workers=2,
                  batch_size=4, communication_window=2, num_epoch=2, seed=4, streaming=True,
                  prefetch=2)
    jt = jdk.DOWNPOUR(FlaxModel(JaxLM(**LM)), **kwargs)
    jm = jt.train(jdk.from_numpy(x, y), shuffle=True)
    params, _ = FlaxModel(JaxLM(**LM)).init(jax.random.PRNGKey(4), x[:4])
    init = params_from_flax(TransformerLM(**LM), params)
    pt = tdk.DOWNPOUR(FixedInit(TransformerLM(**LM), init), device="cpu", **kwargs)
    pm = pt.train(tdk.from_numpy(x, y), shuffle=True)
    for key in ("loss", "token_accuracy"):
        np.testing.assert_allclose(pt.get_history()[key], jt.get_history()[key], **TOL)
    want = params_from_flax(TransformerLM(**LM), jax.tree_util.tree_map(np.asarray, jm.params))
    for name, value in want.items():
        np.testing.assert_allclose(pm.params[name].numpy(), value.numpy(), **TOL, err_msg=name)
    assert pt.num_updates == jt.num_updates


def test_stream_report_and_put_blocks():
    x, y = lm_data(n=64)
    from distkeras_tpu_torch.algorithms import Downpour
    from distkeras_tpu_torch.data import epoch_window_iter
    from distkeras_tpu_torch.parallel import WindowedEngine

    eng = WindowedEngine(TorchModel(TransformerLM(**LM)), "token_crossentropy", "sgd",
                         Downpour(2), num_workers=2, metrics=(), device="cpu")
    state = eng.init_state(torch.Generator().manual_seed(0), None)
    blocks = epoch_window_iter(x, y, 2, 4, 2)
    state, stats = eng.run_epoch_streaming(state, blocks)
    report = eng.last_stream_report
    assert report["windows"] == 4 == len(stats["loss"]) == len(stats["window_steps"])
    assert set(report) == {"windows", "source_seconds", "steady_wall_seconds",
                           "steady_source_seconds", "unhideable_fraction", "link_bound"}
    put = eng.stream_put((x[:8].reshape(2, 1, 4, 16), y[:8].reshape(2, 1, 4, 16)))
    assert put[0].shape == (2, 1, 1, 4, 16) and isinstance(put[0], torch.Tensor)
    with pytest.raises(ValueError, match="empty window iterator"):
        eng.run_epoch_streaming(state, iter(()))


def test_checkpoint_blocks_mid_epoch_resume_is_bitwise(tmp_path, monkeypatch):
    x, y = lm_data(n=64)  # 4 windows an epoch
    want = _train(_lm_trainer(streaming=True), x, y)

    real_iter = trainers_mod.epoch_window_iter
    calls = {"n": 0}

    def dying_iter(*args, **kwargs):
        # the second epoch's iterator dies pulling its fourth block; the
        # loop pulls two blocks ahead of the card, so two windows ran and
        # the cursor saved is 2
        calls["n"] += 1
        for i, block in enumerate(real_iter(*args, **kwargs)):
            if calls["n"] == 2 and i == 3:
                raise RuntimeError("worker lost")
            yield block

    monkeypatch.setattr(trainers_mod, "epoch_window_iter", dying_iter)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="worker lost"):
        _train(_lm_trainer(streaming=True, checkpoint_dir=ckpt, checkpoint_blocks=1), x, y)
    monkeypatch.setattr(trainers_mod, "epoch_window_iter", real_iter)
    from distkeras_tpu_torch.checkpoint import restore_data_state

    data_state = restore_data_state(ckpt)
    assert (data_state.epoch, data_state.block_cursor) == (1, 2)
    resumed = _lm_trainer(streaming=True, checkpoint_dir=ckpt, checkpoint_blocks=1, resume=True)
    got = _train(resumed, x, y)
    for name, value in want[1].items():
        assert torch.equal(got[1][name], value), name
    # the resumed epoch ran its last two blocks only
    assert resumed.get_history()["loss"] != want[0]["loss"][1:]


def test_checkpoint_blocks_requires_streaming():
    with pytest.raises(ValueError, match="streaming=True"):
        _lm_trainer(checkpoint_blocks=2)
