"""Port parity: ``ModelPredictor`` / ``TrainedModel`` of ``distkeras_tpu_torch``
against the JAX package's, on one frame built with each package's
``from_numpy`` from the same numpy tokens.

37 rows in batches of 16 leave a padded tail batch of 5 rows.
"""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu.models.adapter import FlaxModel
from distkeras_tpu.models.adapter import TrainedModel as JaxTrainedModel
from distkeras_tpu.models.transformer import TransformerClassifier as JaxClassifier
from distkeras_tpu_torch import telemetry as port_telemetry
from distkeras_tpu_torch.models import (
    TorchModel,
    TrainedModel,
    TransformerClassifier,
    params_from_flax,
)

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

CFG = dict(vocab_size=64, num_classes=3, dim=32, heads=2, num_layers=2, max_len=32)
ROWS, SEQ, BATCH = 37, 24, 16


@pytest.fixture(scope="module")
def models():
    jax_model = JaxClassifier(**CFG)
    variables = jax_model.init(jax.random.key(0), np.zeros((1, SEQ), np.int32))
    params = variables["params"]
    port_model = TransformerClassifier(**CFG)
    port_params = params_from_flax(port_model, params)
    tokens = np.random.default_rng(0).integers(0, CFG["vocab_size"], (ROWS, SEQ), dtype=np.int32)
    return jax_model, params, port_model, port_params, tokens


def test_predictions_match_jax(models):
    jax_model, params, port_model, port_params, tokens = models
    ref = jdk.ModelPredictor(JaxTrainedModel(FlaxModel(jax_model), params, {}),
                             batch_size=BATCH, num_devices=1)
    out_ref = ref.predict(jdk.from_numpy(tokens))
    port = tdk.ModelPredictor(TrainedModel(TorchModel(port_model), port_params, device="cpu"),
                              batch_size=BATCH, device="cpu")
    out = port.predict(tdk.from_numpy(tokens))
    assert port.last_mode == ref.last_mode == "single"
    assert out.columns == out_ref.columns == ["features", "prediction"]
    pred, pred_ref = out["prediction"], out_ref["prediction"]
    assert pred.shape == pred_ref.shape == (ROWS, CFG["num_classes"])
    np.testing.assert_allclose(pred, pred_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out["features"], out_ref["features"])


def test_params_keyword_and_transform_alias_match_jax(models):
    jax_model, params, port_model, port_params, tokens = models
    ref = jdk.ModelPredictor(FlaxModel(jax_model), params=params, batch_size=BATCH,
                             num_devices=1, output_col="p")
    port = tdk.ModelPredictor(port_model, params=port_params, batch_size=BATCH,
                              output_col="p", device="cpu")
    np.testing.assert_allclose(port.transform(tdk.from_numpy(tokens[:20]))["p"],
                               ref.transform(jdk.from_numpy(tokens[:20]))["p"],
                               atol=1e-5, rtol=1e-5)


def test_trained_model_matches_jax(models):
    jax_model, params, port_model, port_params, tokens = models
    ref = JaxTrainedModel(FlaxModel(jax_model), params, {})
    port = TrainedModel(TorchModel(port_model), port_params, device="cpu")
    np.testing.assert_allclose(port.predict(tokens, batch_size=BATCH),
                               ref.predict(tokens, batch_size=BATCH), atol=1e-5, rtol=1e-5)
    logits = port(tokens[:4])
    assert isinstance(logits, torch.Tensor) and logits.device.type == "cpu"
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref(tokens[:4])), atol=1e-5, rtol=1e-5)


def test_lazy_init_draws_from_a_seeded_generator():
    frame = tdk.from_numpy(np.random.default_rng(1).integers(0, 64, (5, SEQ)).astype(np.int32))
    a = tdk.ModelPredictor(TransformerClassifier(**CFG), batch_size=4, device="cpu")
    b = tdk.ModelPredictor(TransformerClassifier(**CFG), batch_size=4, device="cpu")
    assert a.params is None
    pa, pb = a.predict(frame)["prediction"], b.predict(frame)["prediction"]
    assert pa.shape == (5, CFG["num_classes"]) and np.isfinite(pa).all()
    np.testing.assert_allclose(pa.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(pa, pb)


def test_default_device_raises_without_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device is usable")
    _, _, port_model, port_params, _ = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdk.ModelPredictor(port_model, params=port_params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainedModel(TorchModel(port_model), port_params)


def test_two_devices_match_jax_in_row_order(models):
    # num_devices=2 (ported with the meshes): from distribute_threshold rows
    # (default batch_size * 2) each batch of 32 rows splits over two
    # replicas, here two CPU devices; the JAX predictor on two of its CPU
    # devices does the same split
    jax_model, params, port_model, port_params, tokens = models
    ref = jdk.ModelPredictor(JaxTrainedModel(FlaxModel(jax_model), params, {}),
                             batch_size=BATCH, num_devices=2)
    port = tdk.ModelPredictor(TrainedModel(TorchModel(port_model), port_params, device="cpu"),
                              batch_size=BATCH, num_devices=2, device=["cpu", "cpu"])
    assert port.n_dev == ref.n_dev == 2
    assert port.distribute_threshold == ref.distribute_threshold == 2 * BATCH
    out, out_ref = port.predict(tdk.from_numpy(tokens)), ref.predict(jdk.from_numpy(tokens))
    assert port.last_mode == ref.last_mode == "distributed"
    np.testing.assert_allclose(out["prediction"], out_ref["prediction"], atol=1e-5, rtol=1e-5)
    # row order: the same as the single-device run's, bit for bit
    single = tdk.ModelPredictor(TrainedModel(TorchModel(port_model), port_params, device="cpu"),
                                batch_size=BATCH, device="cpu")
    np.testing.assert_array_equal(out["prediction"],
                                  single.predict(tdk.from_numpy(tokens))["prediction"])
    # below the threshold the first device predicts alone
    port.predict(tdk.from_numpy(tokens[:2 * BATCH - 1]))
    assert port.last_mode == "single"


def test_num_devices_refusals(models, monkeypatch):
    _, _, port_model, port_params, _ = models
    with pytest.raises(ValueError, match="exceeds the 1 device"):
        tdk.ModelPredictor(port_model, params=port_params, device="cpu", num_devices=2)
    with pytest.raises(ValueError, match="num_devices must be >= 1"):
        tdk.ModelPredictor(port_model, params=port_params, device="cpu", num_devices=0)
    # inside a process group of several ranks each rank predicts on its own
    # card (tests/test_torch_mesh.py checks it inside a real gloo group)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="each rank predicts on its own card"):
        tdk.ModelPredictor(port_model, params=port_params, device=["cpu", "cpu"],
                           num_devices=2)


def test_engine_predictions_match_jax():
    # ModelPredictor(engine=) (ported with the serving slice): each row is a
    # prompt, the column holds its greedy continuation, as the JAX
    # predictor's through the JAX engine on the same parameters
    from distkeras_tpu.models.transformer import TransformerLM as JaxLM
    from distkeras_tpu.serving import ServingEngine as JaxEngine
    from distkeras_tpu.telemetry.metrics import Registry as JaxRegistry
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.serving import ServingEngine
    from distkeras_tpu_torch.telemetry.metrics import Registry

    cfg = dict(vocab_size=23, dim=16, heads=2, num_layers=2, max_len=32)
    jax_model = JaxLM(**cfg)
    params = jax_model.init(jax.random.key(0), np.zeros((1, 4), np.int32))["params"]
    port_model = TransformerLM(**cfg)
    prompts = np.random.default_rng(6).integers(0, 23, (7, 4)).astype(np.int32)
    ref_engine = JaxEngine(jax_model, params, num_slots=3, page_size=8, registry=JaxRegistry())
    engine = ServingEngine(port_model, params_from_flax(port_model, params), num_slots=3,
                           page_size=8, queue_size=2, registry=Registry(), device="cpu")
    try:
        ref = jdk.ModelPredictor(engine=ref_engine, max_new_tokens=5).predict(
            jdk.from_numpy(prompts))
        predictor = tdk.ModelPredictor(engine=engine, max_new_tokens=5)
        out = predictor.predict(tdk.from_numpy(prompts))
    finally:
        ref_engine.stop()
        engine.stop()
    assert predictor.last_mode == "engine" and out.columns == ref.columns
    assert [list(v) for v in out["prediction"]] == [list(v) for v in ref["prediction"]]
    assert all(len(v) == 5 for v in out["prediction"])
    with pytest.raises(TypeError, match="engine"):
        tdk.ModelPredictor()  # neither a model nor an engine


def _span_shapes(events):
    return sorted((e["name"], e["args"].get("parent"), e["args"].get("rows"),
                   e["args"].get("mode"), e["args"].get("batch")) for e in events)


def test_spans_match_jax(models):
    jax_model, params, port_model, port_params, tokens = models
    jax_telemetry.configure(True)
    port_telemetry.configure(True)
    try:
        jax_telemetry.trace.reset()
        jdk.ModelPredictor(FlaxModel(jax_model), params=params, batch_size=BATCH,
                           num_devices=1).predict(jdk.from_numpy(tokens))
        jax_events = [e for e in jax_telemetry.trace.events()
                      if e["name"] in ("predict", "predict_batch")]
        port_telemetry.trace.reset()
        tdk.ModelPredictor(port_model, params=port_params, batch_size=BATCH,
                           device="cpu").predict(tdk.from_numpy(tokens))
        port_events = port_telemetry.trace.events()
    finally:
        jax_telemetry.configure(None)
        port_telemetry.configure(None)
    assert len(port_events) == 1 + -(-ROWS // BATCH)
    assert _span_shapes(port_events) == _span_shapes(jax_events)


def test_spans_are_noops_when_telemetry_is_off(models):
    _, _, port_model, port_params, tokens = models
    port_telemetry.configure(False)
    try:
        port_telemetry.trace.reset()
        tdk.ModelPredictor(port_model, params=port_params, batch_size=BATCH,
                           device="cpu").predict(tdk.from_numpy(tokens[:3]))
        assert port_telemetry.trace.events() == []
    finally:
        port_telemetry.configure(None)


def test_signature_matches_jax_in_order():
    # the JAX package's parameters, names, order and defaults, then the
    # port's trailing ``device``
    import inspect

    ours = list(inspect.signature(tdk.ModelPredictor.__init__).parameters.values())
    theirs = list(inspect.signature(jdk.ModelPredictor.__init__).parameters.values())
    assert [p.name for p in ours] == [p.name for p in theirs] + ["device"]
    for mine, ref in zip(ours, theirs):
        assert (mine.kind, mine.default) == (ref.kind, ref.default), ref.name
    assert ours[-1].default == "cuda"


def test_distribute_threshold_and_max_new_tokens_are_accepted(models):
    # distribute_threshold is inert on one card, as in the JAX package with
    # one device; a positional 8th argument is distribute_threshold, not engine
    _, _, port_model, port_params, tokens = models
    frame = tdk.from_numpy(tokens)
    base = tdk.ModelPredictor(port_model, params=port_params, batch_size=BATCH, device="cpu")
    p = tdk.ModelPredictor(port_model, "features", "prediction", BATCH, port_params, None, None,
                           4, max_new_tokens=8, device="cpu")
    assert (p.distribute_threshold, p.max_new_tokens) == (4, 8)
    np.testing.assert_array_equal(p.predict(frame)["prediction"],
                                  base.predict(frame)["prediction"])
    assert p.last_mode == "single"
