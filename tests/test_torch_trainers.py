"""Port parity: the trainers of ``distkeras_tpu_torch`` (``DOWNPOUR``,
``SingleTrainer``) against the JAX package's on the next-token task of
tests/test_lm.py, with ``shuffle=True``; and the trainers' behaviour.

Both packages start from the same parameters: the JAX trainer draws them
as ``FlaxModel(...).init(PRNGKey(seed), x[:batch_size])``, and the port
gets the same values, carried over by ``params_from_flax``, from a
test-side adapter whose ``init`` returns them.  Tolerances are the JAX
package's own for equivalent trajectories: losses within rtol 2e-4 /
atol 2e-5, parameters within rtol 2e-3 / atol 2e-4.
"""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu_torch import telemetry as port_telemetry
from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerLM, params_from_flax

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


def _jax_initial(x, batch_size, seed):
    params, _ = FlaxModel(JaxLM(**LM)).init(jax.random.PRNGKey(seed), x[:batch_size])
    return params_from_flax(TransformerLM(**LM), params)


def _compare(jax_trainer, jax_model, port_trainer, port_model, key_bias_atol=None):
    h, ph = jax_trainer.get_history(), port_trainer.get_history()
    assert ph.keys() == h.keys()
    for key in h:
        if key != "training_time":
            np.testing.assert_allclose(ph[key], h[key], **LOSS_TOL, err_msg=key)
    want = params_from_flax(TransformerLM(**LM), jax.tree_util.tree_map(np.asarray,
                                                                        jax_model.params))
    assert port_model.params.keys() == want.keys()
    got = {k: v.numpy() for k, v in port_model.params.items()}
    want = {k: v.numpy() for k, v in want.items()}
    if key_bias_atol is not None:
        # The key bias adds one constant to a query's every score, which the
        # softmax cancels: its gradient is 0 in exact arithmetic and f32
        # round-off in both packages, which Adam's g/sqrt(v) scales up to
        # steps of up to lr each.  Its third of qkv.bias is held to that
        # bound; the query and value thirds to the usual tolerance.
        name, third = "blocks.0.attn.qkv.bias", LM["dim"]
        np.testing.assert_allclose(got[name][third:2 * third], want[name][third:2 * third],
                                   rtol=0, atol=key_bias_atol)
        for d in (got, want):
            d[name] = np.delete(d[name], np.s_[third:2 * third])
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, **PARAM_TOL, err_msg=name)


def test_downpour_matches_jax():
    x, y = lm_data()
    kwargs = dict(loss="token_crossentropy", metrics=("accuracy",),
                  worker_optimizer=("adam", {"learning_rate": 3e-3}), num_workers=2,
                  batch_size=8, num_epoch=2, communication_window=2, seed=3)
    jt = jdk.DOWNPOUR(FlaxModel(JaxLM(**LM)), **kwargs)
    jm = jt.train(jdk.from_numpy(x, y), shuffle=True)
    pt = tdk.DOWNPOUR(FixedInit(TransformerLM(**LM), _jax_initial(x, 8, seed=3)),
                      device="cpu", **kwargs)
    pm = pt.train(tdk.from_numpy(x, y), shuffle=True)
    # per-token model: "accuracy" is reported as token_accuracy in both
    assert "token_accuracy" in pt.get_history() and pt.metrics == ("accuracy",)
    # 2 epochs x 8 local steps of Adam at lr 3e-3
    _compare(jt, jm, pt, pm, key_bias_atol=2 * 16 * 3e-3)
    assert pt.num_updates == jt.num_updates > 0
    assert pt.parameter_server.running is False and pt.parameter_server.model is pm
    assert isinstance(pm, TrainedModel) and pm.history is pt.get_history()


def test_single_trainer_matches_jax():
    x, y = lm_data(n=64)
    kwargs = dict(loss="token_crossentropy", metrics=("token_accuracy",),
                  worker_optimizer=("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
                  batch_size=16, num_epoch=2, seed=1)
    jt = jdk.SingleTrainer(FlaxModel(JaxLM(**LM)), **kwargs)
    jm = jt.train(jdk.from_numpy(x, y), shuffle=True)
    pt = tdk.SingleTrainer(FixedInit(TransformerLM(**LM), _jax_initial(x, 16, seed=1)),
                           device="cpu", **kwargs)
    pm = pt.train(tdk.from_numpy(x, y), shuffle=True)
    _compare(jt, jm, pt, pm)


def test_spans_match_jax():
    x, y = lm_data(n=32)
    kwargs = dict(loss="token_crossentropy", metrics=(), worker_optimizer="sgd",
                  batch_size=8, num_epoch=2)

    def names(events):
        return sorted((e["name"], e["args"].get("parent")) for e in events
                      if e["name"] in ("load_columns", "epoch", "epoch_arrays"))

    jax_telemetry.configure(True)
    port_telemetry.configure(True)
    try:
        jax_telemetry.trace.reset()
        jdk.SingleTrainer(FlaxModel(JaxLM(**LM)), **kwargs).train(jdk.from_numpy(x, y))
        jax_events = jax_telemetry.trace.events()
        port_telemetry.trace.reset()
        tdk.SingleTrainer(TransformerLM(**LM), device="cpu", **kwargs).train(
            tdk.from_numpy(x, y))
        port_events = port_telemetry.trace.events()
    finally:
        jax_telemetry.configure(None)
        port_telemetry.configure(None)
    assert names(port_events) == names(jax_events)
    assert len(names(port_events)) == 5  # load_columns, 2 x (epoch > epoch_arrays)


def test_trained_lm_learns_next_token():
    # tests/test_lm.py :: test_lm_learns_next_token_through_trainer, on the port
    x, y = lm_data(n=256)
    t = tdk.DOWNPOUR(TransformerLM(**LM, generator=torch.Generator().manual_seed(0)),
                     loss="token_crossentropy", metrics=("token_accuracy",),
                     worker_optimizer=("adam", {"learning_rate": 3e-3}), num_workers=4,
                     batch_size=16, num_epoch=10, communication_window=2, device="cpu")
    trained = t.train(tdk.from_numpy(x, y))
    h = t.get_history()
    assert h["loss"][-1] < h["loss"][0] * 0.3, h["loss"]
    assert h["token_accuracy"][-1] > 0.9, h["token_accuracy"]
    acc = np.mean(np.argmax(trained(x[:8]).numpy(), -1) == y[:8])
    assert acc > 0.9


def test_dropout_draws_from_the_given_generator():
    model = TransformerLM(**LM, dropout=0.25, generator=torch.Generator().manual_seed(0))
    adapter = TorchModel(model)
    params = {k: v.detach() for k, v in model.named_parameters()}
    tokens = torch.from_numpy(lm_data(n=4)[0])

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return adapter.apply(params, {}, tokens, training=True, generator=g)[0]

    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    # evaluation ignores dropout; training without a generator refuses
    evaluation = adapter.apply(params, {}, tokens)[0]
    assert torch.equal(evaluation, adapter.apply(params, {}, tokens)[0])
    with pytest.raises(ValueError, match="Generator"):
        adapter.apply(params, {}, tokens, training=True)
    # the mask keeps each element with probability 1 - p, scaled by 1/(1 - p)
    from distkeras_tpu_torch.models.transformer import _dropout

    ones = torch.ones(200_000)
    out = _dropout(ones, 0.25, True, torch.Generator().manual_seed(0))
    zero_share = float((out == 0).float().mean())
    assert abs(zero_share - 0.25) < 0.005, zero_share
    kept = out[out != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.75))


def test_training_with_dropout_is_reproducible():
    x, y = lm_data(n=32)

    def train():
        t = tdk.SingleTrainer(TransformerLM(**LM, dropout=0.1), loss="token_crossentropy",
                              metrics=(), batch_size=8, num_epoch=1, seed=4, device="cpu")
        return t.train(tdk.from_numpy(x, y)).params["lm_head.weight"]

    assert torch.equal(train(), train())


@pytest.mark.parametrize(
    "kwargs",
    [dict(checkpoint_dir="ckpt"), dict(resume=True), dict(profile_dir="prof"),
     dict(seq_shards=2), dict(tp_shards=2), dict(fsdp=True), dict(streaming=True),
     dict(remat=True), dict(dispatch_epochs=2), dict(pipeline_stages=2),
     dict(tensorboard_dir="tb"), dict(prefetch=2), dict(unroll=True),
     dict(commit_schedule=[1, 2]), dict(elastic=object()), dict(staleness_policy=object())],
    ids=lambda kw: next(iter(kw)),
)
def test_unported_kwargs_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        tdk.DOWNPOUR(TransformerLM(**LM), device="cpu", **kwargs)


def test_device_defaults_to_cuda_and_raises_without_a_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdk.DOWNPOUR(TransformerLM(**LM))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdk.SingleTrainer(TransformerLM(**LM))


def test_constructor_defaults_match_jax():
    import inspect

    for name in ("Trainer", "DistributedTrainer"):
        ours = inspect.signature(getattr(tdk, name).__init__).parameters
        theirs = inspect.signature(getattr(jdk, name).__init__).parameters
        assert [p for p in ours if p != "device"] == list(theirs)
        for p, param in theirs.items():
            assert ours[p].default == param.default, p
        assert ours["device"].default == "cuda"
    assert tdk.DOWNPOUR(TransformerLM(**LM), device="cpu").communication_window == 5
    assert tdk.DOWNPOUR(TransformerLM(**LM), device="cpu").num_workers == 1
