"""Evaluators — the port of :mod:`distkeras_tpu.evaluators`.

``AccuracyEvaluator.evaluate(df)`` compares a prediction column against a
label column and returns scalar accuracy; the reference does this as a Spark
row filter + count, here it is one vectorised numpy comparison.
``AccuracyEvaluator`` and ``PerplexityEvaluator`` are numpy, copied;
``LossEvaluator`` runs the port's loss registry on tensors, on the card
unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.frame import DataFrame
from distkeras_tpu_torch.parallel.mesh import resolve_device

__all__ = ["Evaluator", "AccuracyEvaluator", "LossEvaluator", "PerplexityEvaluator"]


class Evaluator:
    def evaluate(self, dataframe: DataFrame) -> float:
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows where prediction matches label (reference parity:
    ``AccuracyEvaluator(prediction_col, label_col)``).

    Either column may hold class indices or probability / one-hot vectors;
    vectors are argmaxed first (the reference requires a prior
    ``LabelIndexTransformer`` pass — we accept both forms).
    """

    def __init__(self, prediction_col: str = "prediction", label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    @staticmethod
    def _to_index(col: np.ndarray) -> np.ndarray:
        if col.dtype == object:
            col = np.stack([np.asarray(v) for v in col])
        col = np.asarray(col)
        if col.ndim > 1 and col.shape[-1] > 1:
            return np.argmax(col.reshape(len(col), -1), axis=-1)
        return col.reshape(-1).astype(np.int64)

    def evaluate(self, dataframe: DataFrame) -> float:
        preds = self._to_index(dataframe.column(self.prediction_col))
        labels = self._to_index(dataframe.column(self.label_col))
        if len(preds) == 0:
            return 0.0
        return float(np.mean(preds == labels))


class LossEvaluator(Evaluator):
    """Mean loss over a DataFrame (extension beyond the reference set).

    The loss runs on ``device``: ``"cuda"`` by default, which raises
    without a card; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, loss="categorical_crossentropy", prediction_col: str = "prediction",
                 label_col: str = "label", from_logits: bool = False, device="cuda"):
        from distkeras_tpu_torch.ops import get_loss

        self.loss_fn = get_loss(loss, from_logits=from_logits)
        self.prediction_col = prediction_col
        self.label_col = label_col
        self.device = resolve_device(device)

    def evaluate(self, dataframe: DataFrame) -> float:
        preds = torch.from_numpy(dataframe.matrix(self.prediction_col)).to(self.device)
        labels = torch.from_numpy(dataframe.matrix(self.label_col)).to(self.device)
        with torch.inference_mode():
            return float(self.loss_fn(preds, labels))


class PerplexityEvaluator(Evaluator):
    """Per-token perplexity for language models (extension beyond the
    reference set): ``exp(mean NLL of the true next tokens)``.

    Expects a prediction column of per-token distributions ``[seq, vocab]``
    (what ``ModelPredictor`` emits for a ``TransformerLM``/``StagedLM`` —
    softmax probabilities) and an integer label column ``[seq]``.
    """

    def __init__(self, prediction_col: str = "prediction",
                 label_col: str = "label", from_logits: bool = False,
                 eps: float = 1e-9):
        self.prediction_col = prediction_col
        self.label_col = label_col
        self.from_logits = from_logits
        self.eps = eps

    def evaluate(self, dataframe: DataFrame) -> float:
        preds = dataframe.matrix(self.prediction_col, dtype=np.float64)
        labels = dataframe.matrix(self.label_col, dtype=np.int64)
        if preds.ndim != 3:
            raise ValueError(
                f"perplexity needs per-token distributions [N, seq, vocab]; "
                f"got prediction shape {preds.shape}"
            )
        if self.from_logits:
            z = preds - preds.max(-1, keepdims=True)
            ez = np.exp(z)
            preds = ez / ez.sum(-1, keepdims=True)
        elif preds.min() < 0.0 or preds.max() > 1.0 + 1e-6:
            raise ValueError(
                "prediction column holds values outside [0, 1] — pass "
                "from_logits=True for raw logits (clipping them would report "
                "a deceptively low perplexity)"
            )
        picked = np.take_along_axis(preds, labels[..., None], axis=-1)[..., 0]
        nll = -np.log(np.clip(picked, self.eps, 1.0))
        return float(np.exp(nll.mean()))
