"""Batch inference over a DataFrame — the port of :mod:`distkeras_tpu.predictors`.

``ModelPredictor.predict(df)`` appends a ``prediction`` column: the frame's
features run through the model in fixed-size batches on one device, under
``torch.inference_mode()``, and logits with more than one class become
softmax probabilities.  On a CUDA device the transformer models' attention
runs the hand-written flash-attention kernel.  With ``engine=`` (a
:class:`~distkeras_tpu_torch.serving.ServingEngine`) each row is a token-id
prompt and the column holds its generated continuation.
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
    The parameters before ``device`` are the JAX package's, in its order.
    ``distribute_threshold`` (the row count from which the JAX package
    shards a batch over several devices) is accepted and has no effect on
    one card, as there.  With ``engine=`` the rows go through that serving
    engine, ``max_new_tokens`` each, on the engine's device, and no model is
    needed.  Prediction over several cards (``num_devices > 1``) comes with
    a later slice.
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
        distribute_threshold: Optional[int] = None,
        engine: Any = None,
        max_new_tokens: int = 16,
        device="cuda",
    ):
        if num_devices is not None and int(num_devices) != 1:
            raise NotImplementedError(
                "prediction over several cards comes with the multi-GPU slice "
                "(ROADMAP Queue A item 13); pass num_devices=1 or None"
            )
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.distribute_threshold = distribute_threshold
        # Route rows through a serving.ServingEngine instead of the batched
        # forward pass: the engine carries the model and its device.
        self.engine = engine
        self.max_new_tokens = int(max_new_tokens)
        #: how the last ``predict`` ran: None | "single" | "engine"
        self.last_mode = None
        if engine is not None:
            self.adapter = None
            self.params = self.state = None
            return
        if keras_model is None:
            raise TypeError("ModelPredictor needs a model (or an engine=)")
        self.device = resolve_device(device)
        if isinstance(keras_model, TrainedModel):
            self.adapter = keras_model.adapter
            params, state = keras_model.params, keras_model.state
        else:
            self.adapter = as_adapter(keras_model)
        # None: lazy, drawn from the generator at the first predict
        self.params = None if params is None else to_device(params, self.device)
        self.state = to_device(state or {}, self.device)

    def _ensure_params(self, sample: np.ndarray):
        if self.params is None:
            params, state = self.adapter.init(torch.Generator().manual_seed(0), sample)
            self.params = to_device(params, self.device)
            self.state = to_device(state, self.device)

    def _predict_via_engine(self, dataframe: DataFrame) -> DataFrame:
        """Generation-shaped prediction: every row's features are a token-id
        prompt submitted to the serving engine.  Submission is windowed —
        on backpressure (QueueFull) the oldest in-flight request is drained
        first, so the predictor never overruns the engine's queue and never
        deadlocks on its own submissions.  A request the engine aborted
        (stopped or crashed) raises instead of filling its row."""
        from collections import deque

        from distkeras_tpu_torch.serving.frontend import GenerateRequest, QueueFull

        col = dataframe.column(self.features_col)
        if col.dtype == object:
            prompts = [[int(t) for t in np.ravel(row)] for row in col]
        else:
            prompts = [[int(t) for t in row] for row in np.atleast_2d(
                dataframe.matrix(self.features_col, dtype=np.int32))]
        n = len(prompts)
        out = np.empty(n, dtype=object)
        in_flight: deque = deque()

        def drain_one():
            idx, pending = in_flight.popleft()
            result = pending.result(timeout=300.0)
            if result is None:
                raise TimeoutError(f"engine never finished row {idx}")
            if result.finish_reason == "aborted":
                raise RuntimeError(f"the serving engine aborted row {idx}")
            out[idx] = result.tokens

        with telemetry.trace.span("predict", rows=int(n), mode="engine"):
            for idx, prompt in enumerate(prompts):
                req = GenerateRequest(prompt=prompt,
                                      max_new_tokens=self.max_new_tokens)
                while True:
                    try:
                        in_flight.append((idx, self.engine.submit(req)))
                        break
                    except QueueFull:
                        drain_one()
            while in_flight:
                drain_one()
        self.last_mode = "engine"
        return dataframe.with_column(self.output_col, out)

    def predict(self, dataframe: DataFrame) -> DataFrame:
        if self.engine is not None:
            return self._predict_via_engine(dataframe)
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
