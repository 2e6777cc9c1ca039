"""Batch inference over a DataFrame — the port of :mod:`distkeras_tpu.predictors`.

``ModelPredictor.predict(df)`` appends a ``prediction`` column: the frame's
features run through the model in fixed-size batches on one device (or,
from ``distribute_threshold`` rows, split over several of this process's
cards, the model replicated on each), under ``torch.inference_mode()``, and
logits with more than one class become softmax probabilities.  On a CUDA device the transformer models' attention
runs the hand-written flash-attention kernel.  With ``engine=`` (a
:class:`~distkeras_tpu_torch.serving.ServingEngine`) each row is a token-id
prompt and the column holds its generated continuation.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

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

    ``num_devices=n`` predicts on the first ``n`` of this process's cards
    (every card by default; JAX's ``jax.local_devices()``), or on the first
    ``n`` entries of ``device`` when it is a list of devices (several
    entries may name the CPU).  From ``distribute_threshold`` rows (default
    ``batch_size * n``) each batch of ``batch_size * n`` rows is split into
    ``n`` slices of ``batch_size``, one per device, each device holding its
    own copy of the model; the outputs are gathered in row order.  Fewer
    rows run on the first device alone.  Inside a process group of several
    ranks each rank predicts on its own card: ``num_devices > 1`` raises
    ``ValueError`` there.  With ``engine=`` the rows go through that
    serving engine, ``max_new_tokens`` each, on the engine's device, and no
    model is needed.
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
        device: Union[str, torch.device, Sequence] = "cuda",
    ):
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.distribute_threshold = distribute_threshold
        # Route rows through a serving.ServingEngine instead of the batched
        # forward pass: the engine carries the model and its device.
        self.engine = engine
        self.max_new_tokens = int(max_new_tokens)
        #: how the last ``predict`` ran: None | "single" | "distributed" | "engine"
        self.last_mode = None
        if engine is not None:
            self.adapter = None
            self.params = self.state = None
            return
        if keras_model is None:
            raise TypeError("ModelPredictor needs a model (or an engine=)")
        self.devices = _local_devices(device, num_devices)
        self.device = self.devices[0]
        self.n_dev = len(self.devices)
        # below this many rows the split is not worth it: every device should
        # get a whole batch_size slice (as the JAX package scales it)
        self.distribute_threshold = (
            int(distribute_threshold) if distribute_threshold is not None
            else self.batch_size * self.n_dev
        )
        self._replicas = None
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

    def _replicated(self):
        """``(params, state)`` on each device, the first device's own."""
        if self._replicas is None:
            self._replicas = [(self.params, self.state)] + [
                (to_device(self.params, d), to_device(self.state, d)) for d in self.devices[1:]]
        return self._replicas

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
        distributed = self.n_dev > 1 and n >= self.distribute_threshold
        self.last_mode = "distributed" if distributed else "single"
        replicas = self._replicated() if distributed else [(self.params, self.state)]
        # Every batch has batch_size rows a device: pad the tail, slice the output.
        bs = self.batch_size
        wide = bs * len(replicas)
        outs = []
        with telemetry.trace.span("predict", rows=int(n), mode=self.last_mode), \
                torch.inference_mode():
            for i in range(0, n, wide):
                chunk = feats[i : i + wide]
                pad = wide - len(chunk)
                if pad:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                # every device's slice is launched before any is read back,
                # so the devices run side by side; .cpu() waits for each
                with telemetry.trace.span("predict_batch", phase="infer",
                                          batch=len(chunk)):
                    pending = []
                    for k, (device, (params, state)) in enumerate(zip(self.devices, replicas)):
                        x = torch.from_numpy(chunk[k * bs:(k + 1) * bs]).to(device)
                        pending.append(self.adapter.apply(params, state, x, training=False)[0])
                    out = torch.cat([o.cpu() for o in pending])
                outs.append(out[: wide - pad] if pad else out)
        preds = torch.cat(outs) if outs else torch.zeros((0,))
        if self.adapter.outputs_logits and preds.ndim > 1 and preds.shape[-1] > 1:
            preds = torch.softmax(preds, dim=-1)
        return dataframe.with_column(self.output_col, preds.numpy())

    # Spark-ML style alias used in the reference notebooks.
    transform = predict


def _local_devices(device, num_devices: Optional[int]) -> list:
    """The devices a predictor runs on: the first ``num_devices`` of
    ``device`` when it is a list (all of them by default); for ``"cuda"``
    this process's cards from the current one on (all of them by default,
    as JAX takes ``jax.local_devices()``, but one for a card named by its
    index or inside a process group of several ranks); else the one
    device."""
    n = None if num_devices is None else int(num_devices)
    if n is not None and n < 1:
        raise ValueError(f"num_devices must be >= 1, got {n}")
    in_group = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    if in_group and n is not None and n > 1:
        raise ValueError(
            f"num_devices={n} inside a process group of {dist.get_world_size()} ranks: "
            "each rank predicts on its own card (num_devices=1)"
        )
    if isinstance(device, (list, tuple)):
        candidates = [resolve_device(d) for d in device]
        default = len(candidates)
    else:
        first = resolve_device(device)
        candidates = [first]
        default = 1
        if first.type == "cuda":
            count = torch.cuda.device_count()
            candidates += [torch.device("cuda", (first.index + k) % count)
                           for k in range(1, count)]
            if torch.device(device).index is None and not in_group:
                default = count
    n = default if n is None else n
    if n > len(candidates):
        raise ValueError(f"num_devices={n} exceeds the {len(candidates)} device(s) "
                         f"this process can use")
    return candidates[:n]
