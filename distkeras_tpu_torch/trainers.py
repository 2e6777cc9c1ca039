"""Trainers — the user-facing API, signature-compatible with the reference.

The port of :mod:`distkeras_tpu.trainers` on the in-memory per-epoch path:
``SingleTrainer``, ``AveragingTrainer``, ``EnsembleTrainer`` and the
parameter-server trainers ``DOWNPOUR``, ``AEASGD``, ``EAMSGD``, ``ADAG``,
``DynSGD`` and ``AdaptiveDynSGD``, with the staleness simulation
(``commit_schedule``).  Construct a trainer around a model and call
``trainer.train(dataframe)`` to get a
:class:`~distkeras_tpu_torch.models.TrainedModel` back (a Keras model, with
its trained weights written back, when one was passed in); the constructor
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
from typing import Any, List, Optional, Sequence

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
from distkeras_tpu_torch.parameter_servers import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    ParameterServer,
)

__all__ = [
    "Trainer",
    "SingleTrainer",
    "AveragingTrainer",
    "EnsembleTrainer",
    "DistributedTrainer",
    "AsynchronousDistributedTrainer",
    "DOWNPOUR",
    "AEASGD",
    "EAMSGD",
    "ADAG",
    "DynSGD",
    "AdaptiveDynSGD",
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
    "staleness_policy": (None, "item 19 (the dynamics telemetry AdaptiveBound reads)"),
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


def _metric_key(name, index: int) -> str:
    """The history and scalar-log key of metric ``name``."""
    return name if isinstance(name, str) else getattr(name, "__name__", f"metric_{index}")


def _epoch_scalars(stats, metrics) -> dict:
    """One epoch's scalars for the scalar log: the mean loss and the mean of
    each metric, as the JAX trainers log them."""
    scalars = {"loss": float(_epoch_mean(stats, "loss"))}
    if np.asarray(stats["metrics"]).size:
        per_metric = _epoch_mean(stats, "metrics")
        for i, name in enumerate(metrics):
            scalars[_metric_key(name, i)] = float(per_metric[i])
    return scalars


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
            streaming=streaming, remat=remat, unroll=unroll,
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
        self.tensorboard_dir = tensorboard_dir
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
             average_at_end: bool = False, commit_schedule=None):
        """Train: build the engine, draw the initial parameters from
        ``seed``, and run ``num_epoch`` epochs over the whole frame, each
        shuffled (when ``shuffle``) by one ``np.random.default_rng(seed)``
        stream, as the JAX package's in-memory per-epoch path does.  With
        ``commit_schedule`` the engine simulates staleness step by step."""
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
            metrics=metrics, compute_dtype=self.compute_dtype, commit_schedule=commit_schedule,
            device=self.device,
        )
        window = rule.communication_window if rule.communication_window > 0 else None
        rng = np.random.default_rng(self.seed)
        state = engine.init_state(torch.Generator().manual_seed(self.seed),
                                  feats[: self.batch_size])
        scalar_log = None
        if self.tensorboard_dir:
            from distkeras_tpu_torch.utils.tb import ScalarLogger

            scalar_log = ScalarLogger(self.tensorboard_dir)
        epoch_stats = []
        self.record_training_start()
        # try/finally so the scalar logger releases its writer even when an
        # epoch raises
        try:
            for epoch in range(self.num_epoch):
                with telemetry.trace.span("epoch", epoch=epoch):
                    if window is None:
                        # one window spanning the whole epoch (no commits)
                        steps = plan_epoch(len(feats), num_workers, self.batch_size, 1)[0]
                        xs, ys = epoch_arrays(feats, labels, num_workers, self.batch_size,
                                              steps, rng=rng if shuffle else None)
                    else:
                        xs, ys = epoch_arrays(feats, labels, num_workers, self.batch_size,
                                              window, stepwise=commit_schedule is not None,
                                              rng=rng if shuffle else None)
                    xs, ys = engine.shard_batches(xs, ys)
                    state, stats = engine.run_epoch(state, xs, ys)
                    ps = getattr(self, "parameter_server", None)
                    if ps is not None:
                        ps.track(state.center_rule)
                    epoch_stats.append(stats)
                    if scalar_log is not None:
                        scalar_log.log(epoch, **_epoch_scalars(stats, metrics))
        finally:
            if scalar_log is not None:
                scalar_log.close()
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
                self.history[_metric_key(name, i)] = [float(m[i]) for m in metrics_per_epoch]
        return engine, state, adapter

    def _finalize(self, engine: WindowedEngine, state, adapter: ModelAdapter,
                  use_center: bool = True):
        """The trained model in the type the user passed in: a Keras model
        with the trained values written back, else a :class:`TrainedModel`
        on the engine's device, with the history."""
        if use_center:
            params = engine.gather_center(state)
        else:
            params = engine.worker_slice(state.local_params, 0)
        model_state = engine.final_model_state(state)
        if hasattr(adapter, "assign"):  # Keras path: write back and return the Keras model
            return adapter.assign(params, model_state)
        return TrainedModel(adapter, params, model_state, device=engine.device,
                            history=self.history)

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


class AveragingTrainer(Trainer):
    """Synchronous one-shot weight averaging (reference parity:
    ``AveragingTrainer.average_models``): N independent replicas, averaged
    once at the end."""

    def __init__(self, *args, num_workers: int = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_workers = num_workers or device_count(self.device)

    def train(self, dataframe: DataFrame, shuffle: bool = False):
        worker = workers_mod.AveragingWorker(self.worker_optimizer, self.batch_size)
        engine, state, adapter = self._fit(dataframe, worker.rule, self.num_workers,
                                           shuffle=shuffle, average_at_end=True)
        return self._finalize(engine, state, adapter, use_center=True)


class EnsembleTrainer(Trainer):
    """Train N independent models and return all of them (reference parity:
    ``EnsembleTrainer``): for a Keras model, N independent clones, each
    carrying its own worker's weights and model state; otherwise N
    ``TrainedModel``s, each carrying the mean of the workers' model state,
    as in the JAX package."""

    def __init__(self, *args, num_models: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_models = num_models

    def train(self, dataframe: DataFrame, shuffle: bool = False) -> List:
        worker = workers_mod.SequentialWorker(self.worker_optimizer, self.batch_size)
        engine, state, adapter = self._fit(dataframe, worker.rule, self.num_models,
                                           shuffle=shuffle)
        if hasattr(adapter, "assign"):
            # Keras in -> Keras models out: one clone per member (assigning
            # into the one wrapped model N times would leave N handles to
            # the last worker's weights)
            import keras

            from distkeras_tpu_torch.models.keras_adapter import assign_keras_weights

            models = []
            for i in range(self.num_models):
                clone = keras.models.clone_model(adapter.model)
                if not clone.built:
                    clone.build(adapter.model.input_shape)
                assign_keras_weights(clone, engine.worker_slice(state.local_params, i),
                                     engine.worker_slice(state.model_state, i))
                models.append(clone)
            return models
        model_state = engine.final_model_state(state)
        return [TrainedModel(adapter, engine.worker_slice(state.local_params, i), model_state,
                             device=engine.device, history=self.history)
                for i in range(self.num_models)]


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
        _refuse_unported(elastic=elastic, staleness_policy=staleness_policy)
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
        # optional per-worker commit periods: the staleness simulation
        self.commit_schedule = (
            None if commit_schedule is None else np.asarray(commit_schedule, np.int32)
        )

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
                                           shuffle=shuffle, commit_schedule=self.commit_schedule)
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


class AEASGD(AsynchronousDistributedTrainer):
    """Asynchronous Elastic Averaging SGD (Zhang et al. 2015)."""

    def __init__(self, *args, communication_window: int = 32, rho: float = 5.0,
                 learning_rate: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self.communication_window = communication_window
        self.rho = rho
        self.learning_rate = learning_rate

    def allocate_worker(self):
        return workers_mod.AEASGDWorker(
            self.worker_optimizer, self.batch_size, self.features_col, self.label_col,
            self.communication_window, self.rho, self.learning_rate,
        )


class EAMSGD(AsynchronousDistributedTrainer):
    """Elastic averaging with Nesterov momentum (Zhang et al. 2015).

    The worker optimizer defaults to Nesterov-momentum SGD at
    ``learning_rate`` and ``momentum`` only when the caller passes none,
    positionally (``EAMSGD(model, loss, "sgd")``) or by keyword."""

    def __init__(self, *args, communication_window: int = 32, rho: float = 5.0,
                 learning_rate: float = 0.1, momentum: float = 0.9, **kwargs):
        # args[2] is worker_optimizer in the Trainer signature
        if len(args) < 3 and "worker_optimizer" not in kwargs:
            kwargs["worker_optimizer"] = None
        super().__init__(*args, **kwargs)
        self.communication_window = communication_window
        self.rho = rho
        self.learning_rate = learning_rate
        self.momentum = momentum

    def _effective_worker_optimizer(self):
        # resolved at each train() so a changed learning_rate/momentum counts
        if self.worker_optimizer is not None:
            return self.worker_optimizer
        return ("sgd", {"learning_rate": self.learning_rate, "momentum": self.momentum,
                        "nesterov": True})

    def allocate_worker(self):
        return workers_mod.EAMSGDWorker(
            self._effective_worker_optimizer(), self.batch_size, self.features_col,
            self.label_col, self.communication_window, self.rho, self.learning_rate,
            self.momentum,
        )


class ADAG(AsynchronousDistributedTrainer):
    """Accumulated-gradient normalisation (Hermans, arXiv:1710.02368)."""

    parameter_server_class = ADAGParameterServer

    def __init__(self, *args, communication_window: int = 12, **kwargs):
        super().__init__(*args, **kwargs)
        self.communication_window = communication_window

    def allocate_worker(self):
        return workers_mod.ADAGWorker(
            self.worker_optimizer, self.batch_size, self.features_col,
            self.label_col, self.communication_window,
        )


class DynSGD(AsynchronousDistributedTrainer):
    """Staleness-aware dynamic-learning-rate SGD (the SIGMOD'17 rule)."""

    parameter_server_class = DynSGDParameterServer

    def __init__(self, *args, communication_window: int = 5, **kwargs):
        super().__init__(*args, **kwargs)
        self.communication_window = communication_window

    def allocate_worker(self):
        return workers_mod.DynSGDWorker(
            self.worker_optimizer, self.batch_size, self.features_col,
            self.label_col, self.communication_window,
        )


class AdaptiveDynSGD(DynSGD):
    """DynSGD with an SSP-style staleness bound carried in the center state;
    with the default ``inf`` bound its trajectory is DynSGD's.  Retuning
    the bound online (``staleness_policy``) comes with the dynamics
    telemetry (ROADMAP Queue A item 19)."""

    def __init__(self, *args, communication_window: int = 5,
                 initial_bound: float = float("inf"), **kwargs):
        super().__init__(*args, communication_window=communication_window, **kwargs)
        self.initial_bound = initial_bound

    def allocate_worker(self):
        return workers_mod.AdaptiveDynSGDWorker(
            self.worker_optimizer, self.batch_size, self.features_col,
            self.label_col, self.communication_window, self.initial_bound,
        )
