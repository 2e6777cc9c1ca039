"""Port parity: the paper's DataFrame surface of ``distkeras_tpu_torch``
(the transformers, the evaluators and the ``utils`` row helpers) against
the JAX package's on the same frames.

The transformers, ``AccuracyEvaluator``, ``PerplexityEvaluator`` and the
row helpers are numpy on both sides: they must agree bit for bit.
``LossEvaluator`` runs the port's loss registry on tensors (the JAX one
runs ``jnp``): within 1e-6 relative, for every loss string ``get_loss``
takes, as tests/test_torch_ops.py holds the registries themselves.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu import frame as jax_frame
from distkeras_tpu import utils as jax_utils
from distkeras_tpu_torch import frame as port_frame
from distkeras_tpu_torch import utils as port_utils

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

LOSS_RTOL = 1e-6


def _frames(columns):
    """The same columns as a JAX-package frame and a port frame."""
    return jax_frame.DataFrame(dict(columns)), port_frame.DataFrame(dict(columns))


def _assert_same(a, b):
    assert a.columns == b.columns and len(a) == len(b)
    for name in a.columns:
        x, y = a[name], b[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.dtype == object:
            for u, v in zip(x, y):
                u, v = (w.toarray() if hasattr(w, "toarray") else np.asarray(w) for w in (u, v))
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(x, y)


def _data():
    rng = np.random.default_rng(0)
    return {
        "features": rng.integers(0, 256, (20, 12)).astype(np.float32),
        "label": rng.integers(0, 10, 20).astype(np.int64),
        "prediction": rng.random((20, 10)).astype(np.float32),
    }


TRANSFORMS = {
    "minmax_default": lambda m: m.MinMaxTransformer(),
    "minmax_mnist": lambda m: m.MinMaxTransformer(0.0, 1.0, 0.0, 255.0, input_col="features",
                                                  output_col="features_normalized"),
    "minmax_signed": lambda m: m.MinMaxTransformer(-1.0, 1.0, 0.0, 255.0, output_col="x"),
    "onehot": lambda m: m.OneHotTransformer(10),
    "onehot_cols": lambda m: m.OneHotTransformer(10, input_col="label", output_col="y"),
    "label_index": lambda m: m.LabelIndexTransformer(10),
    "reshape": lambda m: m.ReshapeTransformer("features", "image", (3, 4, 1)),
    "dense": lambda m: m.DenseTransformer(),
    "standard_scale": lambda m: m.StandardScaleTransformer(),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transformer_matches_jax_bitwise(name):
    jdf, pdf = _frames(_data())
    jt, pt = TRANSFORMS[name](jdk.transformers), TRANSFORMS[name](tdk.transformers)
    assert vars(jt) == vars(pt)  # the same defaults and column names
    _assert_same(jt.transform(jdf), pt.transform(pdf))
    _assert_same(jt(jdf), pt(pdf))


def test_dense_transformer_densifies_object_columns_as_jax():
    rng = np.random.default_rng(1)
    rows = [scipy.sparse.csr_matrix(rng.random((1, 6)) * (rng.random((1, 6)) > 0.5))
            for _ in range(4)] + [list(rng.random(6)) for _ in range(3)]
    col = np.empty(len(rows), dtype=object)
    col[:] = rows
    jdf, pdf = _frames({"features": col})
    _assert_same(jdk.DenseTransformer().transform(jdf), tdk.DenseTransformer().transform(pdf))


def test_package_root_exports_match_jax():
    names = ("AccuracyEvaluator", "LossEvaluator", "PerplexityEvaluator", "LabelIndexTransformer",
             "OneHotTransformer", "MinMaxTransformer", "ReshapeTransformer", "DenseTransformer",
             "StandardScaleTransformer", "from_spark", "to_spark", "frame", "utils")
    for name in names:
        assert name in tdk.__all__ and hasattr(tdk, name), name
    assert set(jdk.__all__) - set(tdk.__all__) == set()


def test_utils_exports_match_jax():
    assert set(jax_utils.__all__) - set(port_utils.__all__) == set()
    # the JAX package's order, the port's two tree walkers after it
    assert port_utils.__all__[:len(jax_utils.__all__)] == jax_utils.__all__
    for name in jax_utils.__all__:
        assert hasattr(port_utils, name), name


def _tree(rng):
    # keys in sorted order: jax.tree flattens a dict by sorted key, the
    # port's walkers in insertion order
    return {"h": rng.normal(size=(2, 2)).astype(np.float16),
            "inner": {"b": rng.normal(size=(4,)).astype(np.float32),
                      "steps": np.arange(5, dtype=np.int32)},
            "w": rng.normal(size=(3, 4)).astype(np.float32)}


@pytest.mark.parametrize("helper", ["tree_scale", "tree_add_scaled", "tree_ones_like",
                                    "tree_global_norm", "tree_size", "tree_cast"])
def test_tree_helpers_match_jax(helper):
    """The six helpers the port lacked (C19) on one numpy tree, as name ->
    tensor dicts here and as a pytree of arrays in JAX."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(19)
    a, b = _tree(rng), _tree(rng)
    ta, tb = (port_utils.tree_map(torch.from_numpy, t) for t in (a, b))
    ja, jb = (jax.tree.map(jnp.asarray, t) for t in (a, b))
    calls = {
        "tree_scale": lambda m, x, y: m.tree_scale(x, 0.5),
        "tree_add_scaled": lambda m, x, y: m.tree_add_scaled(x, y, -0.25),
        "tree_ones_like": lambda m, x, y: m.tree_ones_like(x),
        "tree_global_norm": lambda m, x, y: m.tree_global_norm(
            {"w": x["w"], "b": x["inner"]["b"]}),
        "tree_size": lambda m, x, y: m.tree_size(x),
        "tree_cast": lambda m, x, y: m.tree_cast(x, torch.bfloat16 if m is port_utils
                                                 else jnp.bfloat16),
    }
    got = calls[helper](port_utils, ta, tb)
    want = calls[helper](jax_utils, ja, jb)
    if helper == "tree_size":
        assert got == want == 12 + 4 + 5 + 4 and type(got) is int
        return
    got_leaves = port_utils.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            g, w = g.float().numpy(), w.astype(np.float32)
        else:
            g = g.numpy()
            assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def test_tree_global_norm_of_an_empty_tree_is_a_zero_scalar():
    import jax.numpy as jnp

    got = port_utils.tree_global_norm({})
    assert got.shape == () and got.dtype == torch.float32 and float(got) == 0.0
    assert float(jax_utils.tree_global_norm({})) == 0.0
    assert jax_utils.tree_global_norm({}).dtype == jnp.float32


@pytest.mark.parametrize("pred_col,label_col", [
    ("prediction", "label"),          # vectors against indices
    ("prediction_index", "label"),    # indices against indices
    ("prediction", "label_encoded"),  # vectors against one-hot vectors
    ("label_column", "label"),        # [n, 1] indices
])
def test_accuracy_evaluator_matches_jax(pred_col, label_col):
    data = _data()
    data["prediction_index"] = np.argmax(data["prediction"], -1).astype(np.int32)
    data["label_encoded"] = np.eye(10, dtype=np.float32)[data["label"]]
    data["label_column"] = data["label"][:, None]
    jdf, pdf = _frames(data)
    want = jdk.AccuracyEvaluator(pred_col, label_col).evaluate(jdf)
    got = tdk.AccuracyEvaluator(pred_col, label_col).evaluate(pdf)
    assert got == want and type(got) is float
    recount = np.mean(jdk.AccuracyEvaluator._to_index(data[pred_col])
                      == jdk.AccuracyEvaluator._to_index(data[label_col]))
    assert got == float(recount)


def test_accuracy_evaluator_on_empty_frames_as_jax():
    # index columns give 0.0; vector columns raise in both packages (the
    # argmax's reshape comes before the empty check, in the reference too)
    jdf, pdf = _frames({"prediction": np.zeros(0, np.int32), "label": np.zeros(0, np.int64)})
    assert tdk.AccuracyEvaluator().evaluate(pdf) == jdk.AccuracyEvaluator().evaluate(jdf) == 0.0
    jdf, pdf = _frames({"prediction": np.zeros((0, 10), np.float32),
                        "label": np.zeros(0, np.int64)})
    for package, df in ((jdk, jdf), (tdk, pdf)):
        with pytest.raises(ValueError, match="reshape"):
            package.AccuracyEvaluator().evaluate(df)


@pytest.mark.parametrize("from_logits", [False, True])
def test_perplexity_evaluator_matches_jax(from_logits):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((5, 7, 11)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    preds = logits if from_logits else (e / e.sum(-1, keepdims=True)).astype(np.float32)
    jdf, pdf = _frames({"prediction": preds, "label": rng.integers(0, 11, (5, 7))})
    want = jdk.PerplexityEvaluator(from_logits=from_logits).evaluate(jdf)
    assert tdk.PerplexityEvaluator(from_logits=from_logits).evaluate(pdf) == want
    if not from_logits:
        bad = port_frame.DataFrame({"prediction": logits, "label": rng.integers(0, 11, (5, 7))})
        with pytest.raises(ValueError, match="from_logits"):
            tdk.PerplexityEvaluator().evaluate(bad)
        with pytest.raises(ValueError, match="per-token"):
            tdk.PerplexityEvaluator().evaluate(port_frame.DataFrame({"prediction": preds[:, 0],
                                                                     "label": preds[:, 0, 0]}))


def _loss_cases():
    """(loss string, preds, labels, from_logits) over every string ``get_loss``
    takes, in the frame's float32 columns."""
    r = np.random.default_rng(3)
    logits = r.standard_normal((6, 5)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[r.integers(0, 5, 6)]
    tok_logits = r.standard_normal((2, 7, 11)).astype(np.float32)
    et = np.exp(tok_logits - tok_logits.max(-1, keepdims=True))
    tok_probs = (et / et.sum(-1, keepdims=True)).astype(np.float32)
    tok_labels = r.integers(0, 11, (2, 7))
    masked = tok_labels.copy()
    masked[:, 5:] = -1
    bin_logits = r.standard_normal((6, 1)).astype(np.float32)
    bin_labels = r.integers(0, 2, 6).astype(np.float32)
    reg, target = (r.standard_normal((6, 3)).astype(np.float32) for _ in range(2))
    cases = []
    for name in ("categorical_crossentropy", "sparse_categorical_crossentropy", "crossentropy"):
        for labels in (onehot, r.integers(0, 5, 6)):
            cases += [(name, probs, labels, False), (name, logits, labels, True)]
    for name in ("token_crossentropy", "lm_crossentropy"):
        cases += [(name, tok_probs, tok_labels, False), (name, tok_logits, tok_labels, True)]
    for name in ("masked_token_crossentropy", "packed_crossentropy"):
        cases += [(name, tok_probs, masked, False), (name, tok_logits, masked, True)]
    cases += [("binary_crossentropy", 1 / (1 + np.exp(-bin_logits)), bin_labels, False),
              ("binary_crossentropy", bin_logits, bin_labels, True)]
    for name in ("mse", "mean_squared_error", "mae", "mean_absolute_error"):
        cases.append((name, reg, target, False))
    return cases


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("case", range(len(LOSS_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LOSS_CASES)])
def test_loss_evaluator_matches_jax(case):
    name, preds, labels, from_logits = LOSS_CASES[case]
    jdf, pdf = _frames({"prediction": preds, "label": labels})
    want = jdk.LossEvaluator(name, from_logits=from_logits).evaluate(jdf)
    got = tdk.LossEvaluator(name, from_logits=from_logits, device="cpu").evaluate(pdf)
    assert type(got) is float
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7)


def test_loss_evaluator_defaults_to_the_card():
    evaluator_args = ("categorical_crossentropy",)
    if torch.cuda.is_available():  # pragma: no cover - with a card
        assert tdk.LossEvaluator(*evaluator_args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdk.LossEvaluator(*evaluator_args)


def test_row_helpers_match_jax():
    data = _data()
    jdf, pdf = _frames(data)
    _assert_same(jax_utils.shuffle(jdf, seed=7), port_utils.shuffle(pdf, seed=7))
    jrow, prow = jdf.first(), pdf.first()
    jnew = jax_utils.new_dataframe_row(jrow, "extra", 3.5)
    pnew = port_utils.new_dataframe_row(prow, "extra", 3.5)
    assert type(pnew) is port_frame.Row and list(pnew) == list(jnew) and "extra" not in prow
    for key in jnew:
        np.testing.assert_array_equal(np.asarray(pnew[key]), np.asarray(jnew[key]))
    for value, size in ((3, 10), (np.int64(9), 10), (np.arange(4.0), 6), (np.arange(8.0), 5)):
        got, want = port_utils.to_dense_vector(value, size), jax_utils.to_dense_vector(value, size)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
