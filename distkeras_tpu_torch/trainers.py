"""Trainers — the user-facing API, signature-compatible with the reference.

The port of :mod:`distkeras_tpu.trainers` for this slice: ``Trainer``,
``SingleTrainer``, ``DistributedTrainer``, ``AsynchronousDistributedTrainer``
and ``DOWNPOUR``, on the in-memory per-epoch path.  Construct a trainer
around a model and call ``trainer.train(dataframe)`` to get a
:class:`~distkeras_tpu_torch.models.TrainedModel` back; the constructor
kwargs and their defaults are the JAX package's, plus ``device``
(``"cuda"`` by default; ``"cpu"`` must be asked for).  On a card the
transformer models' attention runs the flash-attention kernels, forward and
backward.

A kwarg of the JAX trainers whose feature is not ported yet raises
``NotImplementedError`` naming the ROADMAP item that brings it when it is
set to anything but its default; none is silently ignored.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch import workers as workers_mod
from distkeras_tpu_torch.data import epoch_arrays, plan_epoch
from distkeras_tpu_torch.frame import DataFrame
from distkeras_tpu_torch.models.adapter import ModelAdapter, TrainedModel, as_adapter
from distkeras_tpu_torch.ops.metrics import per_token_metric_names
from distkeras_tpu_torch.parallel.engine import WindowedEngine, device_count
from distkeras_tpu_torch.parallel.mesh import resolve_device
from distkeras_tpu_torch.parameter_servers import DeltaParameterServer, ParameterServer

__all__ = [
    "Trainer",
    "SingleTrainer",
    "DistributedTrainer",
    "AsynchronousDistributedTrainer",
    "DOWNPOUR",
]

# kwarg -> (its default, the ROADMAP Queue A item that ports its feature)
_UNPORTED = {
    "checkpoint_dir": (None, "item 11 (checkpointing)"),
    "checkpoint_every": (1, "item 11 (checkpointing)"),
    "resume": (False, "item 11 (checkpointing)"),
    "checkpoint_blocks": (0, "item 11 (checkpointing)"),
    "streaming": (False, "item 11 (streaming and the datapipe)"),
    "prefetch": (0, "item 11 (streaming and the datapipe)"),
    "dispatch_epochs": (1, "item 9 (run_epochs: several epochs a dispatch)"),
    "remat": (False, "item 9 (rematerialisation)"),
    "unroll": (1, "item 9 (a scan unroll of the jitted epoch)"),
    "commit_schedule": (None, "item 9 (the stepwise staleness simulation)"),
    "staleness_policy": (None, "item 9 (adaptive DynSGD)"),
    "tensorboard_dir": (None, "item 12 (utils/tb.py scalar logging)"),
    "seq_shards": (1, "item 14 (sequence parallelism)"),
    "tp_shards": (1, "item 15 (tensor parallelism)"),
    "fsdp": (False, "item 15 (FSDP)"),
    "pipeline_stages": (1, "item 15 (pipeline parallelism)"),
    "pp_microbatches": (None, "item 15 (pipeline parallelism)"),
    "tp_spec_fn": (None, "item 15 (tensor parallelism)"),
    "elastic": (None, "item 18 (fleet: elastic membership)"),
    "profile_dir": (None, "item 19 (telemetry: profiler)"),
}


def _refuse_unported(**kwargs) -> None:
    for name, value in kwargs.items():
        default, item = _UNPORTED[name]
        if not (value is default or (type(value) is type(default) and value == default)):
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: it comes with ROADMAP Queue A {item}"
            )


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    """``compute_dtype`` as a ``torch.dtype``: None, a torch dtype, or its
    name (``"bfloat16"``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype):
        raise TypeError(f"compute_dtype {dtype!r} is not a torch dtype or its name")
    return resolved


def _epoch_mean(stats, key):
    """Per-epoch mean of ``stats[key]`` over its window axis."""
    values = np.asarray(stats[key])
    return np.mean(values, axis=0) if values.ndim > 1 else np.mean(values)


class Trainer:
    """Base trainer: model + loss + worker optimizer + wall-clock bookkeeping
    (reference parity: ``trainers.py :: Trainer``)."""

    def __init__(
        self,
        keras_model: Any,
        loss: Any = "categorical_crossentropy",
        worker_optimizer: Any = "sgd",
        metrics: Sequence = ("accuracy",),
        features_col: str = "features",
        label_col: str = "label",
        batch_size: int = 32,
        num_epoch: int = 1,
        seed: int = 0,
        compute_dtype: Any = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        resume: bool = False,
        profile_dir: Optional[str] = None,
        seq_shards: int = 1,
        tp_shards: int = 1,
        fsdp: bool = False,
        tensorboard_dir: Optional[str] = None,
        streaming: bool = False,
        remat: bool = False,
        unroll=1,
        dispatch_epochs: int = 1,
        pipeline_stages: int = 1,
        pp_microbatches: Optional[int] = None,
        tp_spec_fn: Optional[Any] = None,
        prefetch: int = 0,
        checkpoint_blocks: int = 0,
        device="cuda",
    ):
        _refuse_unported(
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, resume=resume,
            profile_dir=profile_dir, seq_shards=seq_shards, tp_shards=tp_shards, fsdp=fsdp,
            tensorboard_dir=tensorboard_dir, streaming=streaming, remat=remat, unroll=unroll,
            dispatch_epochs=dispatch_epochs, pipeline_stages=pipeline_stages,
            pp_microbatches=pp_microbatches, tp_spec_fn=tp_spec_fn, prefetch=prefetch,
            checkpoint_blocks=checkpoint_blocks,
        )
        self.master_model = keras_model
        self.loss = loss
        self.worker_optimizer = worker_optimizer
        self.metrics = tuple(metrics)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.seed = seed
        self.compute_dtype = _torch_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.history: dict = {}
        self.training_time: float = 0.0
        self._t0: Optional[float] = None

    # -- wall-clock bookkeeping (reference parity) --------------------------
    def record_training_start(self) -> None:
        self._t0 = time.perf_counter()

    def record_training_stop(self) -> None:
        if self._t0 is None:  # stop without start: no interval to measure
            self.training_time = 0.0
        else:
            self.training_time = time.perf_counter() - self._t0

    def get_training_time(self) -> float:
        return self.training_time

    def get_history(self) -> dict:
        return self.history

    def _effective_worker_optimizer(self):
        """The optimizer spec handed to the engine."""
        return self.worker_optimizer

    # -- internals ----------------------------------------------------------
    def _load_columns(self, dataframe: DataFrame):
        # Integer token features must stay integral; every other feature
        # column materialises as one float32 matrix.
        f_raw = dataframe.column(self.features_col)
        if f_raw.dtype != object and np.issubdtype(f_raw.dtype, np.integer):
            feats = f_raw.astype(np.int32)
        else:
            feats = dataframe.matrix(self.features_col, dtype=np.float32)
        labels_raw = dataframe.column(self.label_col)
        if labels_raw.dtype == object:
            labels = dataframe.matrix(self.label_col, dtype=np.float32)
        elif np.issubdtype(labels_raw.dtype, np.integer):
            labels = labels_raw.astype(np.int32)
        else:
            labels = labels_raw.astype(np.float32)
        return feats, labels

    def _fit(self, dataframe: DataFrame, rule, num_workers: int, *, shuffle: bool = True,
             average_at_end: bool = False):
        """Train: build the engine, draw the initial parameters from
        ``seed``, and run ``num_epoch`` epochs over the whole frame, each
        shuffled (when ``shuffle``) by one ``np.random.default_rng(seed)``
        stream, as the JAX package's in-memory per-epoch path does."""
        adapter = as_adapter(self.master_model)
        # per-token models rename accuracy -> token_accuracy, without
        # mutating the user-visible self.metrics
        metrics = self.metrics
        if getattr(adapter, "per_token_labels", False):
            metrics = per_token_metric_names(metrics)
        with telemetry.trace.span("load_columns", phase="data"):
            feats, labels = self._load_columns(dataframe)
        engine = WindowedEngine(
            adapter, self.loss, self._effective_worker_optimizer(), rule, num_workers,
            metrics=metrics, compute_dtype=self.compute_dtype, device=self.device,
        )
        window = rule.communication_window if rule.communication_window > 0 else None
        rng = np.random.default_rng(self.seed)
        state = engine.init_state(torch.Generator().manual_seed(self.seed),
                                  feats[: self.batch_size])
        epoch_stats = []
        self.record_training_start()
        for epoch in range(self.num_epoch):
            with telemetry.trace.span("epoch", epoch=epoch):
                if window is None:
                    # one window spanning the whole epoch (no commits)
                    steps = plan_epoch(len(feats), num_workers, self.batch_size, 1)[0]
                    xs, ys = epoch_arrays(feats, labels, num_workers, self.batch_size, steps,
                                          rng=rng if shuffle else None)
                else:
                    xs, ys = epoch_arrays(feats, labels, num_workers, self.batch_size, window,
                                          rng=rng if shuffle else None)
                xs, ys = engine.shard_batches(xs, ys)
                state, stats = engine.run_epoch(state, xs, ys)
                ps = getattr(self, "parameter_server", None)
                if ps is not None:
                    ps.track(state.center_rule)
                epoch_stats.append(stats)
        if average_at_end:
            state, _ = engine.average_workers(state)
        self.record_training_stop()

        self.history = {
            "loss": [float(_epoch_mean(s, "loss")) for s in epoch_stats],
            "training_time": self.get_training_time(),
        }
        metrics_per_epoch = [_epoch_mean(s, "metrics") for s in epoch_stats
                             if np.asarray(s["metrics"]).size]
        for i, name in enumerate(metrics):
            if metrics_per_epoch:
                key = name if isinstance(name, str) else getattr(name, "__name__", f"metric_{i}")
                self.history[key] = [float(m[i]) for m in metrics_per_epoch]
        return engine, state, adapter

    def _finalize(self, engine: WindowedEngine, state, adapter: ModelAdapter,
                  use_center: bool = True) -> TrainedModel:
        """The trained model, on the engine's device, with the history."""
        if use_center:
            params = engine.gather_center(state)
        else:
            params = engine.worker_slice(state.local_params, 0)
        return TrainedModel(adapter, params, engine.final_model_state(state),
                            device=engine.device, history=self.history)

    def train(self, dataframe: DataFrame, shuffle: bool = False):
        raise NotImplementedError


class SingleTrainer(Trainer):
    """Single-worker baseline (reference parity: ``SingleTrainer`` — one
    partition, a SequentialWorker)."""

    def train(self, dataframe: DataFrame, shuffle: bool = False):
        worker = workers_mod.SequentialWorker(self.worker_optimizer, self.batch_size)
        engine, state, adapter = self._fit(dataframe, worker.rule, num_workers=1,
                                           shuffle=shuffle)
        return self._finalize(engine, state, adapter, use_center=False)


class DistributedTrainer(Trainer):
    """Parameter-server training base (reference parity: ``DistributedTrainer``).

    Owns the parameter-server facade's lifecycle and the worker allocation
    hook; subclasses pick the algorithm.  ``num_workers`` defaults to the
    number of cards; on one card every worker runs there in turn (the
    commit's sum across cards comes with ROADMAP Queue A item 13).
    """

    parameter_server_class = DeltaParameterServer

    def __init__(
        self,
        keras_model: Any,
        loss: Any = "categorical_crossentropy",
        worker_optimizer: Any = "sgd",
        metrics: Sequence = ("accuracy",),
        num_workers: Optional[int] = None,
        batch_size: int = 32,
        features_col: str = "features",
        label_col: str = "label",
        num_epoch: int = 1,
        master_port: int = 5000,
        seed: int = 0,
        compute_dtype: Any = None,
        commit_schedule: Optional[Sequence[int]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        resume: bool = False,
        profile_dir: Optional[str] = None,
        seq_shards: int = 1,
        tp_shards: int = 1,
        fsdp: bool = False,
        tensorboard_dir: Optional[str] = None,
        streaming: bool = False,
        remat: bool = False,
        unroll=1,
        dispatch_epochs: int = 1,
        pipeline_stages: int = 1,
        pp_microbatches: Optional[int] = None,
        tp_spec_fn: Optional[Any] = None,
        prefetch: int = 0,
        checkpoint_blocks: int = 0,
        elastic: Optional[Any] = None,
        staleness_policy: Optional[Any] = None,
        device="cuda",
    ):
        _refuse_unported(commit_schedule=commit_schedule, elastic=elastic,
                         staleness_policy=staleness_policy)
        super().__init__(
            keras_model, loss, worker_optimizer, metrics,
            features_col, label_col, batch_size, num_epoch, seed, compute_dtype,
            checkpoint_dir, checkpoint_every, resume, profile_dir, seq_shards,
            tp_shards, fsdp, tensorboard_dir, streaming, remat, unroll,
            dispatch_epochs, pipeline_stages, pp_microbatches, tp_spec_fn,
            prefetch, checkpoint_blocks, device,
        )
        self.num_workers = num_workers or device_count(self.device)
        self.master_port = master_port
        self.parameter_server: Optional[ParameterServer] = None

    def allocate_worker(self) -> workers_mod.Worker:
        raise NotImplementedError

    def allocate_parameter_server(self) -> ParameterServer:
        return self.parameter_server_class(self.master_model, self.master_port)

    def service(self) -> None:
        """Reference parity: started the PS thread.  Here the center variable
        is created on the card by the engine; this just builds the facade."""
        self.parameter_server = self.allocate_parameter_server()
        self.parameter_server.start()

    def stop_service(self) -> None:
        if self.parameter_server is not None:
            self.parameter_server.stop()

    @property
    def num_updates(self) -> int:
        return self.parameter_server.num_updates if self.parameter_server else 0

    @property
    def _logical_workers(self) -> int:
        """Logical worker count; AsynchronousDistributedTrainer multiplies by
        ``parallelism_factor`` (the reference's Spark over-partitioning),
        realised as more workers on the card."""
        return self.num_workers * getattr(self, "parallelism_factor", 1)

    def train(self, dataframe: DataFrame, shuffle: bool = False):
        worker = self.allocate_worker()
        self.service()
        engine, state, adapter = self._fit(dataframe, worker.rule, self._logical_workers,
                                           shuffle=shuffle)
        self.parameter_server.attach(engine.gather_center(state), state.center_rule)
        self.stop_service()
        model = self._finalize(engine, state, adapter, use_center=True)
        self.parameter_server.model = model
        return model


class AsynchronousDistributedTrainer(DistributedTrainer):
    """Reference parity: adds ``parallelism_factor`` (Spark over-partitioning
    so stragglers overlap), realised as more workers."""

    def __init__(self, *args, parallelism_factor: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.parallelism_factor = parallelism_factor


class DOWNPOUR(AsynchronousDistributedTrainer):
    """Downpour SGD (Dean et al. 2012) — windowed delta commits."""

    def __init__(self, *args, communication_window: int = 5, **kwargs):
        super().__init__(*args, **kwargs)
        self.communication_window = communication_window

    def allocate_worker(self):
        return workers_mod.DOWNPOURWorker(
            self.worker_optimizer, self.batch_size, self.features_col,
            self.label_col, self.communication_window,
        )
