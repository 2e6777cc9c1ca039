"""Port parity: sequence packing (``distkeras_tpu_torch.datapipe.packing``,
``packed_positions`` and ``TransformerLM(packed=True)``) against the JAX
package's.

The packer is numpy in both packages and must agree bit for bit; so must
the positions.  The packed model's logits are held to the JAX packed
model's within 1e-5 (dim 32, 2 layers, the parameters carried over by
``params_from_flax``), and one ``DOWNPOUR`` step on packed rows with
``masked_token_crossentropy`` to the JAX trainer's step within 1e-5 (loss
and every parameter).
"""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu.datapipe import pack_sequences as jax_pack
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models.transformer import TransformerLM as JaxLM
from distkeras_tpu.models.transformer import packed_positions as jax_positions
from distkeras_tpu_torch.datapipe import PackedBatch, pack_sequences
from distkeras_tpu_torch.models import TorchModel, TransformerLM, packed_positions, params_from_flax

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

CFG = dict(vocab_size=23, dim=32, heads=2, num_layers=2, max_len=16)
TOL = dict(rtol=1e-5, atol=1e-5)


def ragged(seed: int, n: int = 24, longest: int = 16, vocab: int = 23):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=m) for m in rng.integers(1, longest + 1, size=n)]


# --------------------------------------------------------------- the packer

@pytest.mark.parametrize("seed,width", [(0, 16), (1, 16), (2, 24), (3, 40)])
def test_pack_sequences_bit_for_bit(seed, width):
    seqs = ragged(seed)
    got, want = pack_sequences(seqs, width), jax_pack(seqs, width)
    assert isinstance(got, PackedBatch)
    for field in ("tokens", "segment_ids", "positions", "labels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.int32, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.n_sequences, got.total_tokens) == (want.n_sequences, want.total_tokens)
    assert got.efficiency == want.efficiency
    np.testing.assert_array_equal(got.model_inputs(), want.model_inputs())


def test_pack_sequences_layout_and_labels():
    # tests/test_datapipe.py's layout check, on the port's packer
    seqs = [np.arange(1, n + 1) for n in (5, 3, 7, 2, 4)]
    pb = pack_sequences(seqs, 8)
    assert pb.n_sequences == 5 and pb.total_tokens == 21
    assert pb.efficiency == pytest.approx(21 / pb.tokens.size)
    assert pb.model_inputs().shape == pb.tokens.shape + (2,)
    found = 0
    for r in range(pb.tokens.shape[0]):
        segs = pb.segment_ids[r]
        for seg in range(1, segs.max() + 1):
            sel = segs == seg
            toks = pb.tokens[r][sel]
            assert any(len(s) == len(toks) and (s == toks).all() for s in seqs)
            np.testing.assert_array_equal(pb.positions[r][sel], np.arange(sel.sum()))
            labs = pb.labels[r][sel]
            np.testing.assert_array_equal(labs[:-1], toks[1:])
            assert labs[-1] == -1
            found += 1
    assert found == 5
    assert (pb.labels[pb.segment_ids == 0] == -1).all()
    # explicit labels go where their tokens go, as JAX puts them
    labels = [s * 10 for s in seqs]
    np.testing.assert_array_equal(pack_sequences(seqs, 8, labels=labels).labels,
                                  jax_pack(seqs, 8, labels=labels).labels)


def test_pack_sequences_deterministic():
    seqs = ragged(2, n=40)
    a = pack_sequences(seqs, 16)
    b = pack_sequences([s.copy() for s in seqs], 16)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.segment_ids, b.segment_ids)


@pytest.mark.parametrize("case", ["width", "none", "empty", "long", "label_count",
                                  "label_length"])
def test_pack_sequences_errors_match_jax(case):
    seqs = [np.array([1, 2, 3]), np.array([4, 5])]
    labels = [np.array([10, 20, 30]), np.array([40, 50])]
    args = {
        "width": ((seqs, 0), {}),
        "none": (([], 8), {}),
        "empty": (([np.array([1]), np.array([])], 8), {}),
        "long": (([np.arange(9)], 8), {}),
        "label_count": ((seqs, 8), {"labels": labels[:1]}),
        "label_length": ((seqs, 8), {"labels": [labels[0], labels[1][:1]]}),
    }[case]
    with pytest.raises(ValueError) as want:
        jax_pack(*args[0], **args[1])
    with pytest.raises(ValueError) as got:
        pack_sequences(*args[0], **args[1])
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the positions

@pytest.mark.parametrize("seed", [0, 1])
def test_packed_positions_bit_for_bit(seed):
    pb = pack_sequences(ragged(seed), 16)
    got = packed_positions(torch.from_numpy(pb.segment_ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_positions(pb.segment_ids)))
    # the packer's informational positions agree on real tokens (a pad run
    # counts on from its start in both packages' packed_positions)
    real = pb.segment_ids != 0
    np.testing.assert_array_equal(got.numpy()[real], pb.positions[real])


# ---------------------------------------------------------- the packed model

@pytest.fixture(scope="module")
def packed_models():
    pb = pack_sequences(ragged(0), CFG["max_len"])
    x = pb.model_inputs()
    jax_model = JaxLM(**CFG, packed=True)
    params = jax_model.init(jax.random.PRNGKey(0), x)["params"]
    port_model = TransformerLM(**CFG, packed=True)
    port_params = params_from_flax(port_model, jax.tree_util.tree_map(np.asarray, params))
    return pb, jax_model, params, port_model, port_params


def _logits(model, params, x):
    with torch.no_grad():
        return torch.func.functional_call(model, params, (torch.from_numpy(x),)).numpy()


def test_packed_logits_match_jax(packed_models):
    pb, jax_model, params, port_model, port_params = packed_models
    x = pb.model_inputs()
    want = np.asarray(jax_model.apply({"params": params}, x))
    got = _logits(port_model, port_params, x)
    assert got.shape == x.shape[:2] + (CFG["vocab_size"],)
    np.testing.assert_allclose(got, want, **TOL)


def test_packed_equals_unpacked_per_segment(packed_models):
    # the port alone: every segment's packed logits are its logits alone in a
    # row, through the packed=False twin on the same parameters
    pb, _, _, port_model, port_params = packed_models
    packed = _logits(port_model, port_params, pb.model_inputs())
    twin = TransformerLM(**CFG)
    checked = 0
    for r in range(pb.tokens.shape[0]):
        for seg in range(1, pb.segment_ids[r].max() + 1):
            sel = pb.segment_ids[r] == seg
            alone = _logits(twin, port_params, pb.tokens[r][sel][None])[0]
            np.testing.assert_allclose(packed[r][sel], alone, rtol=1e-5, atol=1e-5)
            checked += 1
    assert checked == pb.n_sequences


def test_packed_refusals_match_jax(packed_models):
    pb, jax_model, params, port_model, port_params = packed_models
    with pytest.raises(ValueError, match="decode with a packed=False twin"):
        port_model(torch.from_numpy(pb.model_inputs()), decode=True,
                   cache=port_model.init_cache(1))
    with pytest.raises(ValueError, match="incompatible with seq_axis"):
        TransformerLM(**CFG, packed=True, seq_axis="seq")


# ------------------------------------------------------ a packed training step

class FixedInit(TorchModel):
    """Test-side adapter whose ``init`` returns given parameters."""

    def __init__(self, module, params):
        super().__init__(module)
        self.params = params

    def init(self, generator, sample_input):
        return dict(self.params), {}


def test_downpour_step_on_packed_rows_matches_jax():
    # 2 workers x batch 4 = 8 packed rows: one window of one step, one commit
    pb = pack_sequences(ragged(5, n=30), CFG["max_len"])
    x, y = pb.model_inputs()[:8], pb.labels[:8]
    assert x.shape[0] == 8 and (y == -1).any()
    kwargs = dict(loss="masked_token_crossentropy",
                  worker_optimizer=("sgd", {"learning_rate": 0.05}), metrics=(),
                  num_workers=2, batch_size=4, num_epoch=1, communication_window=1)
    jax_trainer = jdk.DOWNPOUR(FlaxModel(JaxLM(**CFG, packed=True)), **kwargs)
    jax_model = jax_trainer.train(jdk.from_numpy(x, y))
    init, _ = FlaxModel(JaxLM(**CFG, packed=True)).init(jax.random.PRNGKey(0), x[:4])
    port_init = params_from_flax(TransformerLM(**CFG, packed=True), init)
    port_trainer = tdk.DOWNPOUR(FixedInit(TransformerLM(**CFG, packed=True), port_init),
                                device="cpu", **kwargs)
    port_model = port_trainer.train(tdk.from_numpy(x, y))
    loss, want_loss = port_trainer.get_history()["loss"], jax_trainer.get_history()["loss"]
    assert len(loss) == 1 and np.isfinite(loss).all()
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert port_trainer.num_updates == jax_trainer.num_updates == 2
    want = params_from_flax(TransformerLM(**CFG, packed=True),
                            jax.tree_util.tree_map(np.asarray, jax_model.params))
    for name, value in want.items():
        np.testing.assert_allclose(port_model.params[name].numpy(), value.numpy(), **TOL,
                                   err_msg=name)
