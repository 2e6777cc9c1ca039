"""Trainers — the user-facing API, signature-compatible with the reference.

The port of :mod:`distkeras_tpu.trainers`: ``SingleTrainer``,
``AveragingTrainer``, ``EnsembleTrainer`` and the parameter-server trainers
``DOWNPOUR``, ``AEASGD``, ``EAMSGD``, ``ADAG``, ``DynSGD`` and
``AdaptiveDynSGD``, with the staleness simulation (``commit_schedule``);
several epochs a dispatch with the on-device reshuffle
(``dispatch_epochs``), captured windows (``unroll``), ``remat``, streaming
with the prefetch ring (``streaming``, ``prefetch``), checkpoints and
resume (``checkpoint_dir``, ``checkpoint_every``, ``resume``,
``checkpoint_blocks``, elastic resume at another worker count), the SIGTERM
boundary checkpoint and ``DistributedTrainer.train_with_recovery``.  Construct a trainer around a model and call
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

import random
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import fleet, telemetry
from distkeras_tpu_torch import workers as workers_mod
from distkeras_tpu_torch.data import epoch_arrays, epoch_window_iter, plan_epoch
from distkeras_tpu_torch.frame import DataFrame
from distkeras_tpu_torch.models.adapter import ModelAdapter, TrainedModel, as_adapter
from distkeras_tpu_torch.ops.metrics import per_token_metric_names
from distkeras_tpu_torch.parallel.engine import WindowedEngine, _mix64, device_count
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
    """Per-epoch mean of ``stats[key]`` over its window axis, weighted by
    the windows' step counts when a streamed epoch had a ragged tail
    (``window_steps``), so that the mean is over steps, as the in-memory
    path's; uniform windows take the plain mean."""
    values = np.asarray(stats[key])
    weights = stats.get("window_steps")
    if (weights is not None and values.ndim >= 1 and values.shape[0] == len(weights)
            and int(np.min(weights)) != int(np.max(weights))):
        return np.average(values, axis=0, weights=np.asarray(weights))
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
            profile_dir=profile_dir, seq_shards=seq_shards, tp_shards=tp_shards, fsdp=fsdp,
            pipeline_stages=pipeline_stages, pp_microbatches=pp_microbatches,
            tp_spec_fn=tp_spec_fn,
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
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.resume = resume
        self.tensorboard_dir = tensorboard_dir
        # feed the engine window blocks through epoch_window_iter instead of
        # whole epochs (the same trajectory; for datasets near device size)
        self.streaming = bool(streaming)
        # recompute the forward on the backward (torch.utils.checkpoint)
        self.remat = bool(remat)
        # other than 1 on a card: windows run as captured CUDA graphs; on the
        # CPU the JAX scan hint, inert
        self.unroll = unroll
        # >1: up to this many epochs per engine.run_epochs call, reshuffled
        # on the card between epochs (a uniform permutation drawn on the
        # device, not the host rng's, so the trajectory differs from
        # dispatch_epochs=1); chunks never straddle a checkpoint_every
        # boundary.  Incompatible with streaming and commit_schedule.
        self.dispatch_epochs = int(dispatch_epochs)
        if self.dispatch_epochs < 1:
            raise ValueError(f"dispatch_epochs must be >= 1, got {dispatch_epochs}")
        # >0 with streaming=True: a PrefetchRing of this depth gathers and
        # copies blocks to the card on a producer thread (same trajectory)
        self.prefetch = int(prefetch)
        if self.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        # >0 with streaming + checkpoint_dir: also checkpoint every N blocks
        # mid-epoch (state + DataState cursor)
        self.checkpoint_blocks = int(checkpoint_blocks)
        if self.checkpoint_blocks < 0:
            raise ValueError(f"checkpoint_blocks must be >= 0, got {checkpoint_blocks}")
        if self.checkpoint_blocks and not self.streaming:
            raise ValueError(
                "checkpoint_blocks>0 saves at streaming block boundaries; "
                "set streaming=True (the in-memory path dispatches whole "
                "epochs, so there is no mid-epoch point to save at)"
            )
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

    def _restore_state(self, ckpt, engine, state, elastic: bool, step=None):
        """Resume from ``checkpoint_dir``: bitwise when the checkpoint was
        written at this trainer's worker count; **elastic** otherwise — the
        restored center variable (and its commit counters and epoch) carry
        over, and the new workers pull it as fresh local replicas (the
        reference's retried worker reconnecting to the parameter server).
        Both reads pin ``step``."""
        if not elastic:
            return ckpt.restore(like=state, step=step)
        raw = ckpt.restore_center(step, include_model_state=False)
        epoch = int(raw["epoch"])
        model_state = ckpt.model_state_worker_mean(step)
        generator = torch.Generator().manual_seed(_mix64(self.seed, epoch))
        return engine.state_from_center(generator, raw["center_params"], raw["center_rule"],
                                        model_state, epoch)

    def _fit(self, dataframe: DataFrame, rule, num_workers: int, *, shuffle: bool = True,
             average_at_end: bool = False, commit_schedule=None):
        """Train, as the JAX package's ``_fit_inner``: build the engine, draw
        the initial parameters from ``seed`` (or resume from
        ``checkpoint_dir``), and run the epochs — in memory one epoch at a
        time, each shuffled (when ``shuffle``) by one
        ``np.random.default_rng(seed)`` stream; ``dispatch_epochs`` at a
        time with the on-device reshuffle; or streamed window by window.
        With ``commit_schedule`` the engine simulates staleness step by
        step.  Checkpoints land every ``checkpoint_every`` epochs (and every
        ``checkpoint_blocks`` streamed blocks) with their data-state
        sidecar; after a SIGTERM the epoch boundary is checkpointed and
        :class:`~distkeras_tpu_torch.fleet.Preempted` raised."""
        from distkeras_tpu_torch.datapipe import DataState

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
            remat=self.remat, unroll=self.unroll, device=self.device,
        )
        window = rule.communication_window if rule.communication_window > 0 else None
        rng = np.random.default_rng(self.seed)

        ckpt = None
        start_epoch = 0
        resuming = elastic = False
        if self.checkpoint_dir:
            from distkeras_tpu_torch.checkpoint import CheckpointManager

            ckpt = CheckpointManager(self.checkpoint_dir, every=self.checkpoint_every)
            # resolve the resume step once, verified (a corrupt newest step is
            # quarantined and the newest that verifies is taken); every read
            # below pins it
            resume_step = ckpt.latest_verified() if self.resume else None
            resuming = resume_step is not None
            elastic = resuming and ckpt.saved_worker_count(resume_step) != engine.num_workers
            if elastic and rule.communication_window <= 0:
                # no-commit rules never fold progress into the center, so an
                # elastic resume would silently restart from initialization
                raise ValueError(
                    f"elastic resume (checkpoint at "
                    f"{ckpt.saved_worker_count(resume_step)} workers, trainer at "
                    f"{engine.num_workers}) requires a committing rule; "
                    f"{type(rule).__name__} only produces its result at the "
                    "end of training, so the checkpointed center carries no "
                    "progress to adopt.  Resume with the original "
                    "num_workers instead."
                )
        # the elastic path builds its state from the partial restore; the
        # bitwise path restores into a fresh state
        state = None
        if not elastic:
            state = engine.init_state(torch.Generator().manual_seed(self.seed),
                                      feats[: self.batch_size])
        resume_data = None
        if resuming:
            state = self._restore_state(ckpt, engine, state, elastic, step=resume_step)
            start_epoch = int(state.epoch)
            # the data-state sidecar: exact RNG bits and the mid-epoch block
            # cursor; one whose epoch does not match the restored state's is
            # ignored
            resume_data = ckpt.restore_data_state(resume_step)
            if resume_data is not None and int(resume_data.epoch) != start_epoch:
                resume_data = None
            if resume_data is not None and resume_data.block_cursor and not self.streaming:
                raise ValueError(
                    f"checkpoint at step {resume_step} was saved mid-epoch "
                    f"(block cursor {resume_data.block_cursor}); resuming it "
                    "requires streaming=True — the in-memory path dispatches "
                    "whole epochs and cannot skip consumed blocks"
                )
        # keep the host RNG stream aligned with the epoch counter on resume:
        # the exact bit state when a DataState was saved, else one
        # permutation per epoch (dispatch_epochs>1 shuffles on the card,
        # keyed by the epoch, and never draws from the host stream)
        if self.dispatch_epochs == 1:
            if resume_data is not None and resume_data.rng_state is not None:
                resume_data.restore_rng(rng)
            else:
                for _ in range(start_epoch):
                    rng.permutation(len(feats))

        def data_state(epoch):
            """The epoch-boundary DataState: cursor 0 at the next epoch, the
            RNG bits as they stand (before the next epoch's shuffle)."""
            return DataState(epoch=epoch + 1, block_cursor=0,
                             rng_state=rng.bit_generator.state if shuffle else None)

        scalar_log = None
        if self.tensorboard_dir:
            from distkeras_tpu_torch.utils.tb import ScalarLogger

            scalar_log = ScalarLogger(self.tensorboard_dir)

        def log(stats, epoch):
            if scalar_log is not None:
                scalar_log.log(epoch, **_epoch_scalars(stats, metrics))

        epoch_stats: List[dict] = []
        self.record_training_start()
        # try/finally so the scalar logger releases its writer even when an
        # epoch raises
        try:
            if self.streaming and commit_schedule is not None:
                raise ValueError(
                    "streaming=True is incompatible with commit_schedule: the "
                    "staleness simulation scans the whole epoch in one program"
                )
            if self.dispatch_epochs > 1:
                if self.streaming:
                    raise ValueError(
                        "dispatch_epochs>1 needs the whole epoch on device; "
                        "streaming=True feeds it window by window"
                    )
                if commit_schedule is not None:
                    raise ValueError(
                        "dispatch_epochs>1 is incompatible with commit_schedule "
                        "(the staleness simulation dispatches per epoch)"
                    )
                state, epoch_stats = self._train_chunked(
                    engine, state, feats, labels, num_workers, window, shuffle, ckpt,
                    start_epoch, log)
                start_epoch = self.num_epoch  # the per-epoch loop below runs 0 times
            stream_window = window
            if self.streaming and window is None:
                # no-commit trainers have no natural window: stream fixed
                # blocks with a ragged tail, so the step count (and the
                # trajectory) is the in-memory path's
                steps = plan_epoch(len(feats), num_workers, self.batch_size, 1)[0]
                stream_window = min(steps, 32)
            for epoch in range(start_epoch, self.num_epoch):
                with telemetry.trace.span("epoch", epoch=epoch):
                    if self.streaming:
                        if window is not None:
                            total_windows = plan_epoch(len(feats), num_workers,
                                                       self.batch_size, window)[0]
                        else:
                            steps = plan_epoch(len(feats), num_workers, self.batch_size, 1)[0]
                            total_windows = -(-steps // stream_window)
                        start_block = 0
                        if resume_data is not None and epoch == start_epoch:
                            start_block = min(int(resume_data.block_cursor), total_windows)
                        # bit state BEFORE this epoch's shuffle, what a
                        # mid-epoch DataState carries (the iterator is lazy)
                        rng_bits = rng.bit_generator.state if shuffle else None
                        blocks = epoch_window_iter(
                            feats, labels, num_workers, self.batch_size, stream_window,
                            rng=rng if shuffle else None, pad_to_window=window is not None,
                            feature_dtype=self.compute_dtype, start_block=start_block,
                        )
                        if self.prefetch > 0:
                            from distkeras_tpu_torch.datapipe import PrefetchRing

                            blocks = PrefetchRing(blocks, depth=self.prefetch,
                                                  put_fn=engine.stream_put)
                        on_window = None
                        if ckpt is not None and self.checkpoint_blocks:
                            def on_window(live_state, done, _epoch=epoch, _base=start_block,
                                          _bits=rng_bits, _total=total_windows):
                                # skip the final block: the epoch-boundary
                                # save supersedes it
                                cursor = _base + done
                                if done % self.checkpoint_blocks or cursor >= _total:
                                    return
                                ckpt.save_partial(live_state, _epoch, DataState(
                                    epoch=_epoch, block_cursor=cursor, rng_state=_bits))

                        state, stats = engine.run_epoch_streaming(state, blocks,
                                                                  on_window=on_window)
                    else:
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
                    log(stats, epoch)
                    if ckpt is not None:
                        ckpt.maybe_save(state, epoch, data_state=data_state(epoch))
                    if fleet.preemption_requested():
                        # SIGTERM: leave a boundary checkpoint for whoever
                        # resumes, then exit loudly instead of dying mid-step
                        if ckpt is not None:
                            if (epoch + 1) % self.checkpoint_every:
                                ckpt.save_partial(state, epoch, data_state(epoch))
                            ckpt.wait()
                        raise fleet.Preempted(
                            f"preempted (SIGTERM); drained to the epoch {epoch + 1} boundary"
                            + (" checkpoint" if ckpt is not None else ""))
            if ckpt is not None:
                ckpt.wait()  # flush in-flight saves before declaring done
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

    def _train_chunked(self, engine, state, feats, labels, num_workers, window, shuffle, ckpt,
                       start_epoch, log):
        """The ``dispatch_epochs>1`` epoch loop: up to ``dispatch_epochs``
        epochs per :meth:`WindowedEngine.run_epochs` call, reshuffled on the
        card between epochs when ``shuffle`` is set.  Chunks never straddle
        a ``checkpoint_every`` boundary, so the checkpointed epochs are the
        per-epoch loop's.  Returns ``(state, per-epoch stats)``."""
        steps = window or plan_epoch(len(feats), num_workers, self.batch_size, 1)[0]
        xs, ys = engine.shard_batches(*epoch_arrays(feats, labels, num_workers,
                                                    self.batch_size, steps))
        shuffle_seed = self.seed if shuffle else None
        epoch_stats: List[dict] = []
        epoch = start_epoch
        while epoch < self.num_epoch:
            chunk = min(self.dispatch_epochs, self.num_epoch - epoch)
            if ckpt is not None:
                chunk = min(chunk, self.checkpoint_every - epoch % self.checkpoint_every)
            with telemetry.trace.span("epoch", epoch=epoch, epochs=chunk):
                state, stats = engine.run_epochs(state, xs, ys, chunk, shuffle_seed=shuffle_seed)
            # chunk stats -> per-epoch dicts (leaves keep [n_windows, ...])
            for e in range(chunk):
                one = {k: v.reshape((chunk, v.shape[0] // chunk) + v.shape[1:])[e]
                       for k, v in stats.items()}
                epoch_stats.append(one)
                log(one, epoch + e)
            epoch += chunk
            ps = getattr(self, "parameter_server", None)
            if ps is not None:
                ps.track(state.center_rule)
            if ckpt is not None:
                ckpt.maybe_save(state, epoch - 1)
        return state, epoch_stats

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

    def train_with_recovery(self, dataframe: DataFrame, shuffle: bool = False,
                            max_retries: int = 2, backoff_base: float = 0.5,
                            backoff_cap: float = 30.0):
        """Failure-tolerant training, as the JAX package's.

        The reference leaned on Spark task retries; here the recovery unit
        is the checkpoint: on an exception the trainer resumes from the
        latest verified checkpoint (bitwise).  Requires ``checkpoint_dir``.

        Retries are kept for transient failures: a retry happens only if a
        checkpoint exists, and never for the same failure (type and message)
        twice unless a checkpoint landed in between — a deterministic bug
        surfaces at once.  Retries back off exponentially
        (``backoff_base * 2^k`` capped at ``backoff_cap``, times 0.5-1.0
        jitter), and a SIGTERM preemption
        (:class:`~distkeras_tpu_torch.fleet.Preempted`) is never retried:
        its boundary checkpoint is on disk and the process is meant to exit.
        """
        if not self.checkpoint_dir:
            raise ValueError("train_with_recovery requires checkpoint_dir")
        from distkeras_tpu_torch.checkpoint import committed_steps, latest_step

        fleet.install_preemption_handler()
        attempts = 0
        last_failure = None
        last_step = None
        while True:
            try:
                return self.train(dataframe, shuffle)
            except fleet.Preempted:
                raise  # drained to a boundary checkpoint; exit, don't retry
            except Exception as e:  # noqa: BLE001 — re-raised unless retryable
                failure = (type(e), str(e))
                try:
                    step = latest_step(self.checkpoint_dir)
                except Exception:  # noqa: BLE001 — a failed save must not mask e
                    on_disk = committed_steps(self.checkpoint_dir)
                    step = on_disk[-1] if on_disk else None
                if step != last_step:
                    # progress checkpointed since the previous failure: a
                    # repeating failure is a recurring transient
                    last_failure = None
                attempts += 1
                if attempts > max_retries or failure == last_failure or step is None:
                    raise
                last_failure = failure
                last_step = step
                self.resume = True  # pick up from the latest checkpoint
                if backoff_base > 0:
                    delay = min(backoff_cap, backoff_base * (2 ** (attempts - 1)))
                    time.sleep(delay * (0.5 + 0.5 * random.random()))

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
