"""Port parity: the paper's DataFrame flow (``examples/mnist.py``) through
``distkeras_tpu_torch``'s public API against the same flow through the JAX
package, on the CPU.

The data is synthetic MNIST-like, 256 rows of 64 integer features in [0,
255], labelled by a fixed random linear map of the features (chip_smoke.py's
generator at another width), drawn from one numpy seed.  Both packages run
``from_numpy`` -> ``MinMaxTransformer(0, 1, 0, 255)`` ->
``OneHotTransformer(10)`` -> ``split(0.8)``, train ``MLP(32, 16)`` for 2
epochs with ``SingleTrainer`` and with ``DOWNPOUR`` over 2 workers (the
example's settings), then ``ModelPredictor`` -> ``LabelIndexTransformer``
-> ``AccuracyEvaluator`` on the held-out rows.  The port starts from the
JAX trainer's initial parameters, carried over with
``models.variables_from_flax``.

Tolerances: the frames bit for bit; the predictions within 1e-5 (f32, the
trainers' own agreement); the accuracies equal.
"""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu.models import MLP as JaxMLP
from distkeras_tpu.models import FlaxModel
from distkeras_tpu_torch.models import MLP, TorchModel, variables_from_flax

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROWS, FEATURES, CLASSES, HIDDEN, EPOCHS, BATCH, WORKERS = 256, 64, 10, (32, 16), 2, 32, 2


def synthetic_mnist(rows, features, seed=0):
    """chip_smoke.py's synthetic MNIST at another width: integer pixels in
    [0, 255], noisy copies of one prototype a class, labelled by a fixed
    random linear map of the pixels."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((features, CLASSES)).astype(np.float32)
    prototypes = np.where(w > 0, 200.0, 55.0).T
    noise = rng.normal(0.0, 100.0, (rows, features))
    x = np.clip(np.rint(prototypes[rng.integers(0, CLASSES, rows)] + noise), 0, 255)
    x = x.astype(np.float32)
    y = np.argmax((x / 255.0 - 0.5) @ w, axis=-1).astype(np.int64)
    return x, y


def prepare(dk, x, y):
    df = dk.from_numpy(x, y, features_col="features_raw", label_col="label")
    df = dk.MinMaxTransformer(0.0, 1.0, 0.0, 255.0, input_col="features_raw",
                              output_col="features").transform(df)
    df = dk.OneHotTransformer(CLASSES, input_col="label", output_col="label_encoded").transform(df)
    return df.split(0.8, seed=0)


def evaluate(dk, trained, test_df, **device):
    pred = dk.ModelPredictor(trained, features_col="features", **device).predict(test_df)
    pred = dk.LabelIndexTransformer(CLASSES, input_col="prediction",
                                    output_col="prediction_index").transform(pred)
    acc = dk.AccuracyEvaluator(prediction_col="prediction_index", label_col="label").evaluate(pred)
    return pred, acc


TRAINERS = {
    "SingleTrainer": {"worker_optimizer": ("sgd", {"learning_rate": 0.1})},
    "DOWNPOUR": {"worker_optimizer": ("adam", {"learning_rate": 1e-3 / WORKERS}),
                 "communication_window": 5, "num_workers": WORKERS},
}


@pytest.fixture(scope="module")
def frames():
    x, y = synthetic_mnist(ROWS, FEATURES)
    return prepare(jdk, x, y), prepare(tdk, x, y)


def test_prepared_frames_match_jax_bitwise(frames):
    for jdf, pdf in zip(*frames):
        assert jdf.columns == pdf.columns and len(jdf) == len(pdf)
        for name in jdf.columns:
            np.testing.assert_array_equal(pdf[name], jdf[name])
    assert len(frames[1][0]) + len(frames[1][1]) == ROWS


@pytest.mark.parametrize("name", list(TRAINERS))
def test_flow_matches_jax(frames, name):
    (jax_train, jax_test), (port_train, port_test) = frames
    jax_mlp = JaxMLP(features=HIDDEN, num_classes=CLASSES)
    port_mlp = MLP(features=HIDDEN, num_classes=CLASSES, in_features=FEATURES)
    # the JAX trainer draws its initial parameters with seed 0
    params, _ = variables_from_flax(
        port_mlp, jax_mlp.init(jax.random.PRNGKey(0), np.zeros((4, FEATURES), np.float32),
                               training=False))

    class JaxInitial(TorchModel):
        def init(self, generator, sample_input):
            return dict(params), {}

    common = dict(loss="categorical_crossentropy", features_col="features",
                  label_col="label_encoded", batch_size=BATCH, num_epoch=EPOCHS, **TRAINERS[name])
    jax_trainer = getattr(jdk, name)(FlaxModel(jax_mlp), **common)
    jax_pred, jax_acc = evaluate(jdk, jax_trainer.train(jax_train), jax_test)
    port_trainer = getattr(tdk, name)(JaxInitial(port_mlp), device="cpu", **common)
    port_pred, port_acc = evaluate(tdk, port_trainer.train(port_train), port_test, device="cpu")

    np.testing.assert_allclose(port_trainer.get_history()["loss"],
                               jax_trainer.get_history()["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port_pred["prediction"], jax_pred["prediction"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port_pred["prediction_index"], jax_pred["prediction_index"])
    assert port_acc == jax_acc
    if name == "DOWNPOUR":
        assert port_trainer.num_updates == jax_trainer.num_updates > 0
