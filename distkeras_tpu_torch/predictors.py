"""Batch inference over a DataFrame — the port of :mod:`distkeras_tpu.predictors`.

``ModelPredictor.predict(df)`` appends a ``prediction`` column: the frame's
features run through the model in fixed-size batches on one device, under
``torch.inference_mode()``, and logits with more than one class become
softmax probabilities.  On a CUDA device the transformer models' attention
runs the hand-written flash-attention kernel.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.frame import DataFrame
from distkeras_tpu_torch.models.adapter import TrainedModel, as_adapter, to_device
from distkeras_tpu_torch.parallel.mesh import resolve_device

__all__ = ["Predictor", "ModelPredictor"]


class Predictor:
    def predict(self, dataframe: DataFrame) -> DataFrame:
        raise NotImplementedError


class ModelPredictor(Predictor):
    """Append model outputs as a ``prediction`` column.

    Accepts a :class:`TrainedModel`, a torch module or adapter with
    ``params`` (and ``state``), or a bare in-tree module, whose parameters
    are then drawn lazily, at the first ``predict``, from a
    ``torch.Generator`` seeded with 0.  ``device`` defaults to ``"cuda"``
    and raises without a card; pass ``device="cpu"`` to run on the CPU.
    Prediction over several cards (``num_devices > 1``) and through a
    serving engine (``engine=``) come with later slices.
    """

    def __init__(
        self,
        keras_model: Any = None,
        features_col: str = "features",
        output_col: str = "prediction",
        batch_size: int = 512,
        params: Any = None,
        state: Any = None,
        num_devices: Optional[int] = None,
        engine: Any = None,
        device="cuda",
    ):
        if engine is not None:
            raise NotImplementedError(
                "engine= (generation through the serving engine) comes with the "
                "serving slice (ROADMAP Queue A item 17)"
            )
        if num_devices is not None and int(num_devices) != 1:
            raise NotImplementedError(
                "prediction over several cards comes with the multi-GPU slice "
                "(ROADMAP Queue A item 13); pass num_devices=1 or None"
            )
        if keras_model is None:
            raise TypeError("ModelPredictor needs a model")
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        if isinstance(keras_model, TrainedModel):
            self.adapter = keras_model.adapter
            params, state = keras_model.params, keras_model.state
        else:
            self.adapter = as_adapter(keras_model)
        # None: lazy, drawn from the generator at the first predict
        self.params = None if params is None else to_device(params, self.device)
        self.state = to_device(state or {}, self.device)
        #: how the last ``predict`` ran: None | "single"
        self.last_mode = None

    def _ensure_params(self, sample: np.ndarray):
        if self.params is None:
            params, state = self.adapter.init(torch.Generator().manual_seed(0), sample)
            self.params = to_device(params, self.device)
            self.state = to_device(state, self.device)

    def predict(self, dataframe: DataFrame) -> DataFrame:
        col = dataframe.column(self.features_col)
        feats = dataframe.matrix(
            self.features_col,
            dtype=np.int32 if (col.dtype != object and np.issubdtype(col.dtype, np.integer)) else np.float32,
        )
        n = len(feats)
        self._ensure_params(feats[:1])
        self.last_mode = "single"
        # Every batch has batch_size rows: pad the tail, slice the output.
        bs = self.batch_size
        outs = []
        with telemetry.trace.span("predict", rows=int(n), mode=self.last_mode), \
                torch.inference_mode():
            for i in range(0, n, bs):
                chunk = feats[i : i + bs]
                pad = bs - len(chunk)
                if pad:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                # .cpu() waits for the device result, so the per-batch span
                # needs no extra sync
                with telemetry.trace.span("predict_batch", phase="infer",
                                          batch=len(chunk)):
                    x = torch.from_numpy(chunk).to(self.device)
                    out = self.adapter.apply(self.params, self.state, x, training=False)[0].cpu()
                outs.append(out[: bs - pad] if pad else out)
        preds = torch.cat(outs) if outs else torch.zeros((0,))
        if self.adapter.outputs_logits and preds.ndim > 1 and preds.shape[-1] > 1:
            preds = torch.softmax(preds, dim=-1)
        return dataframe.with_column(self.output_col, preds.numpy())

    # Spark-ML style alias used in the reference notebooks.
    transform = predict
