"""Port parity: ``distkeras_tpu_torch.utils.serialization`` and the scalar
logger of ``utils/tb.py`` against the JAX package's.

``params_to_bytes`` writes a tree's leaves in the order ``jax.tree.flatten``
gives them (a dict's keys sorted), so a blob that either package writes for
a flat dict of arrays loads leaf by leaf into the other, bit for bit.  The
Keras helpers (``serialize_keras_model``, ``uniform_weights``) are tested
with the Keras adapter, in tests/test_torch_keras.py's subprocess.

The scalar logger runs in its JSONL mode (TensorBoard's writer is switched
off on both sides): a trainer with ``tensorboard_dir`` writes one line per
epoch, and the port's lines equal the JAX trainer's for the same run on the
MLP (f32, the same initial parameters; within 1e-5 relative, the trainers'
own agreement on that run).
"""

import json

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu.models import MLP as JaxMLP
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.utils import serialization as jax_ser
from distkeras_tpu.utils.tb import ScalarLogger as JaxScalarLogger
from distkeras_tpu_torch.models import MLP, TorchModel, variables_from_flax
from distkeras_tpu_torch.utils import serialization as port_ser
from distkeras_tpu_torch.utils.tb import ScalarLogger

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


def _flat_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "a_step": np.array(7, np.int32),
            "emb": rng.standard_normal((5, 2)).astype(np.float64)}


def test_round_trip_of_a_tensor_tree():
    flat = _flat_arrays()
    tree = {"layer": {k: torch.from_numpy(v) for k, v in flat.items()},
            "extra": [torch.ones(2), (torch.zeros(3, dtype=torch.int64),)]}
    like = {"layer": {k: torch.empty_like(v) for k, v in tree["layer"].items()},
            "extra": [torch.empty(2), (torch.empty(3, dtype=torch.int64),)]}
    back = port_ser.params_from_bytes(port_ser.params_to_bytes(tree), like)
    assert back.keys() == tree.keys() and isinstance(back["extra"][1], tuple)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)


def test_leaves_follow_jax_tree_flatten_order():
    tree = {"b": {"y": 1.0, "x": 2.0}, "a": [3.0, 4.0], "c": (5.0,)}
    assert port_ser._flatten(tree)[0] == jax.tree.leaves(tree)


def test_jax_blob_loads_into_the_port_and_back():
    flat = _flat_arrays(1)
    jax_blob = jax_ser.params_to_bytes({k: jax.numpy.asarray(v) for k, v in flat.items()})
    like = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in flat.items()}
    ours = port_ser.params_from_bytes(jax_blob, like)
    for key, value in flat.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(jax.numpy.asarray(value)))
    port_blob = port_ser.params_to_bytes({k: torch.from_numpy(v) for k, v in flat.items()})
    theirs = jax_ser.params_from_bytes(port_blob, flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(np.asarray(theirs[key]), value)


def test_params_from_bytes_refuses_a_tree_of_another_size():
    blob = port_ser.params_to_bytes({"a": torch.ones(2)})
    with pytest.raises(ValueError, match="1 leaves"):
        port_ser.params_from_bytes(blob, {"a": torch.ones(2), "b": torch.ones(1)})


def test_history_to_json_matches_jax():
    history = {"loss": [np.float32(0.5), 0.25], "training_time": np.float64(1.5)}
    assert port_ser.history_to_json(history) == jax_ser.history_to_json(history)


def _jsonl_only(monkeypatch):
    for cls in (ScalarLogger, JaxScalarLogger):
        monkeypatch.setattr(cls, "_try_torch", lambda self: False)
    monkeypatch.delenv("DISTKERAS_TB_TF", raising=False)


def test_scalar_logger_jsonl_matches_jax(tmp_path, monkeypatch):
    _jsonl_only(monkeypatch)
    for cls, sub in ((ScalarLogger, "port"), (JaxScalarLogger, "jax")):
        with cls(str(tmp_path / sub)) as log:
            log.log(0, loss=np.float32(1.25), accuracy=0.5)
            log.log(np.int64(1), loss=1.0)
        log.close()  # idempotent
    assert ((tmp_path / "port" / "scalars.jsonl").read_text()
            == (tmp_path / "jax" / "scalars.jsonl").read_text())
    ScalarLogger(str(tmp_path / "unused")).close()  # nothing written, no file
    assert not (tmp_path / "unused" / "scalars.jsonl").exists()


def test_trainer_scalar_lines_match_the_jax_trainer(tmp_path, monkeypatch):
    _jsonl_only(monkeypatch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 128)]
    jax_mlp = JaxMLP(features=(16,), num_classes=3)
    port_mlp = MLP(in_features=8, features=(16,), num_classes=3)
    # the JAX trainer's initial parameters (its seed is 0), carried over
    params, _ = variables_from_flax(
        port_mlp, jax_mlp.init(jax.random.PRNGKey(0), x[:4], training=False))

    class Fixed(TorchModel):
        def init(self, generator, sample_input):
            return dict(params), {}

    kwargs = dict(loss="categorical_crossentropy", worker_optimizer=("sgd", {"learning_rate": 0.1}),
                  num_workers=2, batch_size=16, num_epoch=3, communication_window=2)
    jax_t = jdk.DOWNPOUR(FlaxModel(jax_mlp), tensorboard_dir=str(tmp_path / "jax"), **kwargs)
    jax_t.train(jdk.from_numpy(x, y))
    port_t = tdk.DOWNPOUR(Fixed(port_mlp),
                          tensorboard_dir=str(tmp_path / "port"), device="cpu", **kwargs)
    port_t.train(tdk.from_numpy(x, y))
    read = lambda sub: [json.loads(line) for line in
                        (tmp_path / sub / "scalars.jsonl").read_text().splitlines()]
    ours, theirs = read("port"), read("jax")
    assert len(ours) == len(theirs) == 3
    for mine, ref in zip(ours, theirs):
        assert mine.keys() == ref.keys() == {"step", "loss", "accuracy"}
        assert mine["step"] == ref["step"]
        np.testing.assert_allclose([mine["loss"], mine["accuracy"]],
                                   [ref["loss"], ref["accuracy"]], rtol=1e-5, atol=1e-6)
    assert [line["loss"] for line in ours] == port_t.get_history()["loss"]
