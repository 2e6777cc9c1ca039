"""Port parity: the Keras adapter of ``distkeras_tpu_torch`` (Keras 3 on
the torch backend) against the JAX package's (Keras 3 on the JAX backend).

``tests/conftest.py`` sets ``KERAS_BACKEND=jax`` for the whole pytest
process, and Keras fixes its backend when it is first imported, so each
side runs in a subprocess of its own (two in all, side by side): the same
tiny Dense model, with the same weights drawn from numpy, runs its forward
through each package's ``KerasModel``, trains 2 epochs with
``SingleTrainer`` and 1 with ``EnsembleTrainer``, and writes what it got to
an ``.npz`` that this test compares.  The torch side also drives
``ModelPredictor`` on the returned Keras model and the Keras helpers of
``utils/serialization.py``.

Tolerances: the forward within 1e-5 (f32 products in two frameworks'
orders), the trained weights and losses within 1e-5.  The GPU runs
(``chip_smoke.py``) do not need ``keras``: the Keras path is tested on the
CPU only.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("keras")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)

_SIDE = textwrap.dedent('''
    import os, sys
    backend, out = sys.argv[1], sys.argv[2]
    os.environ["KERAS_BACKEND"] = backend
    import numpy as np
    import keras
    if backend == "jax":
        import distkeras_tpu as dk
        from distkeras_tpu.models.keras_adapter import KerasModel
        device = {}
    else:
        import torch
        torch.set_num_threads(1)
        import distkeras_tpu_torch as dk
        from distkeras_tpu_torch.models.keras_adapter import KerasModel
        device = {"device": "cpu"}

    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    weights = [rng.uniform(-0.5, 0.5, s).astype(np.float32)
               for s in ((6, 8), (8,), (8, 3), (3,))]

    def model():
        m = keras.Sequential([keras.Input((6,)), keras.layers.Dense(8, activation="relu"),
                              keras.layers.Dense(3, activation="softmax")])
        m.set_weights(weights)
        return m

    res = {}
    adapter = KerasModel(model())
    params, state = adapter.init(None, x[:4])
    res["forward"] = keras.ops.convert_to_numpy(adapter.apply(params, state, x[:16])[0])
    kw = dict(loss="categorical_crossentropy", worker_optimizer=("sgd", {"learning_rate": 0.1}),
              metrics=(), batch_size=16, **device)
    trainer = dk.SingleTrainer(model(), num_epoch=2, **kw)
    trained = trainer.train(dk.from_numpy(x, y))
    assert isinstance(trained, keras.Model), type(trained)
    res["loss"] = np.asarray(trainer.get_history()["loss"])
    for i, w in enumerate(trained.get_weights()):
        res[f"single_{i}"] = np.asarray(w)
    models = dk.EnsembleTrainer(model(), num_epoch=1, num_models=2, **kw).train(
        dk.from_numpy(x, y))
    assert len(models) == 2 and all(isinstance(m, keras.Model) for m in models)
    for j, m in enumerate(models):
        for i, w in enumerate(m.get_weights()):
            res[f"ensemble{j}_{i}"] = np.asarray(w)
    if backend == "torch":
        from distkeras_tpu_torch.utils import (deserialize_keras_model, serialize_keras_model,
                                               uniform_weights)
        pred = dk.ModelPredictor(trained, **device).predict(dk.from_numpy(x))
        res["predict"] = pred["prediction"]
        res["predict_ref"] = keras.ops.convert_to_numpy(trained(x))
        blob = serialize_keras_model(trained)
        again = deserialize_keras_model(blob)
        assert all(np.array_equal(a, b) for a, b in zip(again.get_weights(), blob["weights"]))
        assert np.array_equal(keras.ops.convert_to_numpy(again(x)), res["predict_ref"])
        m = uniform_weights(model(), (-0.1, 0.1), seed=3)
        flat = np.concatenate([w.ravel() for w in m.get_weights()])
        assert flat.min() >= -0.1 and flat.max() <= 0.1 and not np.allclose(flat, 0.0)
        assert all(np.array_equal(a, b) for a, b in zip(
            m.get_weights(), uniform_weights(model(), (-0.1, 0.1), seed=3).get_weights()))
    np.savez(out, **res)
    print("ok")
''')


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    out = tmp_path_factory.mktemp("keras")
    env = {k: v for k, v in os.environ.items() if k != "KERAS_BACKEND"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="3")
    procs = {backend: subprocess.Popen(
        [sys.executable, "-c", _SIDE, backend, str(out / f"{backend}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for backend in ("jax", "torch")}
    results = {}
    for backend, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{backend} side failed:\n{stderr[-4000:]}"
        results[backend] = dict(np.load(out / f"{backend}.npz"))
    return results


def test_forward_matches_the_jax_backend(sides):
    np.testing.assert_allclose(sides["torch"]["forward"], sides["jax"]["forward"], **TOL)
    assert sides["torch"]["forward"].shape == (16, 3)


def test_single_trainer_returns_the_keras_model_trained_as_jax(sides):
    ours, theirs = sides["torch"], sides["jax"]
    np.testing.assert_allclose(ours["loss"], theirs["loss"], **TOL)
    assert len(ours["loss"]) == 2
    for i in range(4):
        np.testing.assert_allclose(ours[f"single_{i}"], theirs[f"single_{i}"], **TOL)


def test_ensemble_trainer_returns_keras_clones_trained_as_jax(sides):
    ours, theirs = sides["torch"], sides["jax"]
    for j in range(2):
        for i in range(4):
            key = f"ensemble{j}_{i}"
            np.testing.assert_allclose(ours[key], theirs[key], **TOL)
    assert not np.array_equal(ours["ensemble0_0"], ours["ensemble1_0"])


def test_model_predictor_over_the_returned_keras_model(sides):
    # Keras models end in softmax: the predictor passes their outputs through
    np.testing.assert_allclose(sides["torch"]["predict"], sides["torch"]["predict_ref"],
                               rtol=1e-6, atol=1e-7)
