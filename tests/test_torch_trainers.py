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

import json

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
    [dict(checkpoint_dir=True), dict(resume=True), dict(streaming=True), dict(remat=True),
     dict(dispatch_epochs=2), dict(prefetch=2), dict(unroll=True),
     dict(streaming=True, checkpoint_blocks=1, checkpoint_dir=True)],
    ids=lambda kw: "+".join(kw),
)
def test_ported_kwargs_train(kwargs, tmp_path):
    # accepted since item 9 and item 11 (but packing) are ported; these
    # replace their cases in test_unported_kwargs_raise.  Each trains two
    # epochs to a finite loss; the ones that keep the math (all but the
    # on-device reshuffle) keep the default run's history bit for bit
    kwargs = {k: (str(tmp_path / "ckpt") if k == "checkpoint_dir" else v)
              for k, v in kwargs.items()}
    x, y = lm_data(n=32)

    def train(**kw):
        t = tdk.DOWNPOUR(TransformerLM(**LM), loss="token_crossentropy",
                         metrics=("token_accuracy",), num_workers=2, batch_size=4,
                         communication_window=2, num_epoch=2, seed=1, device="cpu", **kw)
        t.train(tdk.from_numpy(x, y), shuffle=True)
        return t.get_history()["loss"]

    got, want = train(**kwargs), train()
    assert len(got) == 2 and np.isfinite(got).all()
    if "dispatch_epochs" not in kwargs:
        assert got == want
    if "checkpoint_dir" in kwargs:
        from distkeras_tpu_torch.checkpoint import committed_steps

        assert committed_steps(kwargs["checkpoint_dir"]) == [1, 2]


def test_elastic_kwarg_is_accepted_and_polled():
    # accepted since item 18a is ported; replaces the last case of
    # test_unported_kwargs_raise.  A poller that reports no change is asked
    # at every epoch boundary but the last and changes no value
    # (tests/test_torch_fleet.py holds a resize to JAX's)
    class Unchanged:
        polls = 0

        def poll(self):
            self.polls += 1
            return None

    x, y = lm_data(n=32)

    def train(**kw):
        t = tdk.DOWNPOUR(TransformerLM(**LM), loss="token_crossentropy", num_workers=2,
                         batch_size=4, communication_window=2, num_epoch=3, seed=1,
                         device="cpu", **kw)
        t.train(tdk.from_numpy(x, y), shuffle=True)
        return t

    ctl = Unchanged()
    t = train(elastic=ctl)
    assert t.elastic is ctl and ctl.polls == 2
    assert t.get_history()["loss"] == train().get_history()["loss"]


@pytest.mark.parametrize("name", ["profile_dir", "staleness_policy"])
def test_telemetry_kwargs_are_accepted(name, tmp_path):
    # accepted since the training telemetry (item 19a) is ported; these
    # replace their cases in test_unported_kwargs_raise.  profile_dir
    # writes the second epoch's torch.profiler trace; staleness_policy
    # retunes AdaptiveDynSGD's bound from the dynamics summary between
    # epochs (tests/test_torch_dynamics.py holds it to JAX's)
    from distkeras_tpu_torch.algorithms import AdaptiveBound

    x, y = lm_data(n=32)
    kwargs = dict(loss="token_crossentropy", metrics=("token_accuracy",), num_workers=2,
                  batch_size=4, communication_window=2, num_epoch=2, seed=1, device="cpu")
    if name == "profile_dir":
        t = tdk.DOWNPOUR(TransformerLM(**LM), profile_dir=str(tmp_path), **kwargs)
        t.train(tdk.from_numpy(x, y))
        traces = [f for f in tmp_path.iterdir() if f.name.startswith("profile_")]
        assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
        return
    policy = AdaptiveBound(initial=4.0)
    port_telemetry.dynamics.configure(enabled=True, watchdog="off")
    try:
        t = tdk.AdaptiveDynSGD(TransformerLM(**LM), staleness_policy=policy,
                               initial_bound=4.0, **kwargs)
        t.train(tdk.from_numpy(x, y))
    finally:
        port_telemetry.dynamics.configure()
    assert t.staleness_policy is policy and policy.loosened == 2
    assert policy.bound == min(policy.max_bound, 4.0 * 1.25 ** 2)


@pytest.mark.parametrize("kwargs", [dict(pipeline_stages=2, pp_microbatches=2)],
                         ids=lambda kw: next(iter(kw)))
def test_pipeline_kwargs_build_the_pipeline_engine(kwargs):
    # accepted since item 15c (parallel/pipeline.py) is ported; this replaces
    # its case in test_unported_kwargs_raise.  The trainer keeps the kwargs
    # and routes a staged model to the pipeline engine, which in one process
    # (no group) asks for the stage ranks it needs in JAX's words; its
    # training runs in tests/test_torch_pipeline.py over two ranks
    from distkeras_tpu_torch.models import StagedLM

    x, y = lm_data(n=32)
    t = tdk.DOWNPOUR(StagedLM(vocab_size=LM["vocab_size"], dim=LM["dim"], heads=LM["heads"],
                              max_len=LM["max_len"]),
                     loss="token_crossentropy", num_workers=1, batch_size=4, device="cpu",
                     **kwargs)
    assert (t.pipeline_stages, t.pp_microbatches) == (2, 2)
    with pytest.raises(ValueError, match="num_stages=2 x tp_shards=1 x seq_shards=1 does not "
                                         "divide device count 1"):
        t.train(tdk.from_numpy(x, y))


@pytest.mark.parametrize("kwargs", [dict(tp_shards=2), dict(fsdp=True)],
                         ids=lambda kw: next(iter(kw)))
def test_gspmd_kwargs_build_the_gspmd_engine(kwargs):
    # accepted since item 15a (parallel/gspmd.py) is ported; these replace
    # their cases in test_unported_kwargs_raise.  In one process (no group)
    # the trainer routes both to the GSPMD engine: fsdp=True trains the
    # default run's history bit for bit (one workers rank: nothing to
    # split), and tp_shards=2 asks for the two model ranks it needs
    from distkeras_tpu_torch.parallel import GSPMDEngine
    from distkeras_tpu_torch.parallel.mesh import LocalMesh

    x, y = lm_data(n=32)

    def trainer(**kw):
        return tdk.DOWNPOUR(TransformerLM(**LM), loss="token_crossentropy",
                            metrics=("token_accuracy",), num_workers=2, batch_size=4,
                            communication_window=2, num_epoch=2, seed=1, device="cpu", **kw)

    t = trainer(**kwargs)
    rule = t.allocate_worker().rule
    if "tp_shards" in kwargs:
        with pytest.raises(ValueError, match="tp_shards=2 does not divide the rank count 1"):
            t._make_engine(TorchModel(TransformerLM(**LM)), rule, 2, ())
        return
    assert isinstance(t._make_engine(TorchModel(TransformerLM(**LM)), rule, 2, (),
                                     mesh=LocalMesh(("workers", "model"))), GSPMDEngine)
    want = trainer()
    t.train(tdk.from_numpy(x, y))
    want.train(tdk.from_numpy(x, y))
    assert t.get_history()["loss"] == want.get_history()["loss"]


def test_tp_shards_with_seq_shards_raises():
    # tests/test_fsdp_sp.py's refusal: ring attention needs the windowed
    # engine, tensor parallelism the GSPMD one
    with pytest.raises(ValueError, match="drop tp_shards"):
        tdk.DOWNPOUR(TransformerLM(**LM, seq_axis="seq"), seq_shards=2, tp_shards=2,
                     device="cpu")


def test_tensorboard_dir_kwarg_logs_each_epoch(tmp_path, monkeypatch):
    # accepted since utils/tb.py is ported (it replaces this kwarg's case in
    # test_unported_kwargs_raise): one line per epoch, the epoch means that
    # the history holds, in the JSONL sink
    from distkeras_tpu_torch.utils.tb import ScalarLogger

    monkeypatch.setattr(ScalarLogger, "_try_torch", lambda self: False)
    x, y = lm_data(n=32)
    t = tdk.SingleTrainer(TransformerLM(**LM), loss="token_crossentropy",
                          metrics=("token_accuracy",), batch_size=8, num_epoch=2,
                          tensorboard_dir=str(tmp_path / "tb"), device="cpu")
    t.train(tdk.from_numpy(x, y))
    lines = [json.loads(line) for line in (tmp_path / "tb" / "scalars.jsonl").read_text().splitlines()]
    h = t.get_history()
    assert lines == [{"step": e, "loss": h["loss"][e], "token_accuracy": h["token_accuracy"][e]}
                     for e in range(2)]


def test_commit_schedule_kwarg_trains():
    # accepted since the staleness simulation is ported; one epoch of one
    # step a worker, where only the period-1 worker commits
    x, y = lm_data(n=16)
    t = tdk.DOWNPOUR(TransformerLM(**LM), loss="token_crossentropy", metrics=(),
                     num_workers=2, batch_size=8, communication_window=1,
                     commit_schedule=[1, 2], device="cpu")
    t.train(tdk.from_numpy(x, y))
    assert t.num_updates == 1 and np.isfinite(t.get_history()["loss"]).all()


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


# --- the paper's training suite: the zoo models under the other trainers ---

ZOO_TRAINERS = ["AEASGD", "EAMSGD", "ADAG", "DynSGD", "AveragingTrainer", "EnsembleTrainer"]
MLP_KW = dict(features=(16, 8), num_classes=3)


def _zoo_case(model_name):
    """(JAX model, port model factory, x, one-hot y): 4 workers x batch 4 x
    2 windows of 2 steps a worker."""
    from distkeras_tpu.models import zoo as jax_zoo
    from distkeras_tpu_torch.models import zoo

    rng = np.random.default_rng(11)
    if model_name == "mlp":
        x = rng.normal(size=(64, 12)).astype(np.float32)
        jax_model, port = jax_zoo.MLP(**MLP_KW), lambda: zoo.MLP(**MLP_KW, in_features=12)
    else:
        x = rng.normal(size=(64, 784)).astype(np.float32)
        jax_model, port = jax_zoo.MNISTCNN(num_classes=3), lambda: zoo.MNISTCNN(num_classes=3)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(x))]
    return jax_model, port, x, y


class FixedVariables(TorchModel):
    """Test-side adapter whose ``init`` returns given parameters and buffers."""

    def __init__(self, module, params, buffers):
        super().__init__(module)
        self.params, self.buffers = params, buffers

    def init(self, generator, sample_input):
        return dict(self.params), dict(self.buffers)


def _zoo_kwargs(name, lr):
    """Each trainer's kwargs at learning rate ``lr``: small enough that
    training does not diverge, where round-off would grow without bound."""
    kwargs = dict(loss="categorical_crossentropy", metrics=("accuracy",), batch_size=4,
                  num_epoch=2, seed=5)
    if name == "EnsembleTrainer":
        return dict(kwargs, num_models=4, worker_optimizer=("sgd", {"learning_rate": lr}))
    kwargs["num_workers"] = 4
    if name == "AveragingTrainer":
        return dict(kwargs, worker_optimizer=("sgd", {"learning_rate": lr}))
    if name == "EAMSGD":  # its default worker optimizer: Nesterov SGD
        return dict(kwargs, communication_window=2, rho=2.0, learning_rate=lr / 2)
    if name == "AEASGD":
        return dict(kwargs, communication_window=2, rho=2.0, learning_rate=lr / 2,
                    worker_optimizer=("sgd", {"learning_rate": lr / 2}))
    return dict(kwargs, communication_window=2,
                worker_optimizer=("sgd", {"learning_rate": lr, "momentum": 0.9}))


@pytest.mark.parametrize("model_name", ["mlp", "mnist_cnn"])
@pytest.mark.parametrize("name", ZOO_TRAINERS)
def test_zoo_trainer_matches_jax(name, model_name):
    from distkeras_tpu_torch.models import variables_from_flax

    jax_model, port_model, x, y = _zoo_case(model_name)
    kwargs = _zoo_kwargs(name, 0.1 if model_name == "mlp" else 0.01)
    jt = getattr(jdk, name)(FlaxModel(jax_model), unroll=True, **kwargs)
    jm = jt.train(jdk.from_numpy(x, y), shuffle=True)
    variables = jax_model.init(jax.random.PRNGKey(kwargs["seed"]), x[:4], training=False)
    params, buffers = variables_from_flax(port_model(), variables)
    pt = getattr(tdk, name)(FixedVariables(port_model(), params, buffers), device="cpu",
                            **kwargs)
    pm = pt.train(tdk.from_numpy(x, y), shuffle=True)

    h, ph = jt.get_history(), pt.get_history()
    assert ph.keys() == h.keys()
    for key in h:
        if key != "training_time":
            np.testing.assert_allclose(ph[key], h[key], **LOSS_TOL, err_msg=key)
    jax_models, port_models = (jm, pm) if isinstance(jm, list) else ([jm], [pm])
    assert len(port_models) == len(jax_models)
    for want_model, got_model in zip(jax_models, port_models):
        assert isinstance(got_model, TrainedModel) and got_model.history is ph
        want, _ = variables_from_flax(port_model(), {"params": jax.tree_util.tree_map(
            np.asarray, want_model.params)})
        assert got_model.params.keys() == want.keys()
        for k, value in want.items():
            np.testing.assert_allclose(got_model.params[k].numpy(), value.numpy(),
                                       **PARAM_TOL, err_msg=k)
    if hasattr(jt, "num_updates"):
        assert pt.num_updates == jt.num_updates


def test_new_trainer_signatures_and_defaults_match_jax():
    import inspect

    for name in ("AveragingTrainer", "EnsembleTrainer", "AEASGD", "EAMSGD", "ADAG",
                 "DynSGD", "AdaptiveDynSGD"):
        ours = inspect.signature(getattr(tdk, name).__init__).parameters
        theirs = inspect.signature(getattr(jdk, name).__init__).parameters
        assert list(ours) == list(theirs), name
        for p, param in theirs.items():
            assert ours[p].default == param.default, (name, p)
    model = TransformerLM(**LM)
    for name in ("AEASGD", "EAMSGD", "ADAG", "DynSGD", "AdaptiveDynSGD"):
        ours, theirs = getattr(tdk, name)(model, device="cpu"), getattr(jdk, name)(model)
        for attr in ("communication_window", "rho", "learning_rate", "momentum",
                     "initial_bound", "parallelism_factor"):
            assert getattr(ours, attr, None) == getattr(theirs, attr, None), (name, attr)
        assert ours.num_workers == 1 and ours.commit_schedule is None
        assert (ours.parameter_server_class.__name__
                == theirs.parameter_server_class.__name__), name
        rule, jax_rule = ours.allocate_worker().rule, theirs.allocate_worker().rule
        assert type(rule).__name__ == type(jax_rule).__name__, name
    assert tdk.EnsembleTrainer(model, device="cpu").num_models == 2
    assert tdk.AveragingTrainer(model, device="cpu").num_workers == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdk.AEASGD(model)


@pytest.mark.parametrize(
    "args, kwargs, want",
    [((), {}, ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "nesterov": True})),
     (("categorical_crossentropy",), {"learning_rate": 0.2, "momentum": 0.5},
      ("sgd", {"learning_rate": 0.2, "momentum": 0.5, "nesterov": True})),
     (("categorical_crossentropy", "adam"), {}, "adam"),
     ((), {"worker_optimizer": "adagrad"}, "adagrad"),
     (("categorical_crossentropy", None), {}, ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                                        "nesterov": True}))],
    ids=["default", "default_tuned", "positional", "keyword", "positional_none"],
)
def test_eamsgd_optimizer_default_matches_jax(args, kwargs, want):
    model = TransformerLM(**LM)
    ours = tdk.EAMSGD(model, *args, device="cpu", **kwargs)
    theirs = jdk.EAMSGD(model, *args, **kwargs)
    assert ours._effective_worker_optimizer() == theirs._effective_worker_optimizer() == want
    assert ours.allocate_worker().optimizer == theirs.allocate_worker().optimizer == want
