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
boundary checkpoint, ``DistributedTrainer.train_with_recovery`` and the
live elastic resize (``elastic=``, a
:class:`~distkeras_tpu_torch.fleet.ElasticMembership` polled at each epoch
boundary: a changed fleet rebuilds the engine at the new worker count
mid-run, around the center, as an elastic resume does).  Over several ranks
global rank 0 polls and broadcasts the answer, so every rank resizes at the
same boundary; a count that is not a multiple of the workers ranks is
rounded down to one (at least one worker a rank) with a ``RuntimeWarning``
(ROADMAP Queue C, C21).  With fault injection armed
(:mod:`~distkeras_tpu_torch.chaos`) the ``epoch`` site fires entering each
epoch, before any device work, and streamed blocks cross the ``block``
site.

Inside a ``torch.distributed`` process group (``torchrun --nproc-per-node
N``, or :func:`~distkeras_tpu_torch.networking.initialize` in each process)
every trainer runs over a mesh of the group's ranks, one process per card:
each process makes the same ``train`` call on the same frame, its engine
trains its block of the workers, and the commit sums over every rank
(:mod:`~distkeras_tpu_torch.parallel.engine`).  ``num_workers`` defaults
to the rank count; every process returns the same model and history.
``SingleTrainer``'s one worker trains whole on every rank.  With
``seq_shards > 1`` (a model built with ``seq_axis="seq"``) the ranks form a
``(workers, seq)`` grid of ``world / seq_shards`` workers ranks by
``seq_shards`` sequence blocks (ring attention), ``num_workers`` defaults to
``world / seq_shards``, and ``fsdp=True`` splits the center over the seq
ranks; every return path hands back the model's seq-free twin on the
trained parameters, which serves on one card.  With ``tp_shards > 1``, or
``fsdp=True`` without a seq axis, the ranks form the GSPMD engine's
``(workers, model)`` grid (:mod:`~distkeras_tpu_torch.parallel.gspmd`):
parameter leaves split over the ``tp_shards`` model ranks of a row
(``tp_spec_fn`` overrides the placement), the center also over the workers
ranks under ``fsdp``; ``num_workers`` defaults to the rank count, as JAX
defaults it to the device count, and the model comes back whole.  With
``pipeline_stages > 1`` (a staged model,
:class:`~distkeras_tpu_torch.models.StagedTransformer` or ``StagedLM``,
with as many stages) the ranks form the pipeline engine's ``(workers,
stages)`` grid (:mod:`~distkeras_tpu_torch.parallel.pipeline`), each step's
batch running as ``pp_microbatches`` microbatches (default: one a stage)
through the stages; with ``tp_shards > 1`` or ``seq_shards > 1`` (a staged
model built with ``seq_axis="seq"``) its ``(workers, stages, model)`` or
``(workers, stages, seq)`` grid; ``num_workers`` defaults to ``world /
(pipeline_stages x tp_shards x seq_shards)``, one worker a workers rank
(JAX's default, the device count, fails its own pipeline engine's check
whenever a row holds more than one device), and the model comes back
whole, a staged model's seq-free twin.  Construct a trainer around a model and call
``trainer.train(dataframe)`` to get a
:class:`~distkeras_tpu_torch.models.TrainedModel` back (a Keras model, with
its trained weights written back, when one was passed in); the constructor
kwargs and their defaults are the JAX package's, plus ``device``
(``"cuda"`` by default; ``"cpu"`` must be asked for).  On a card the
transformer models' attention runs the flash-attention kernels, forward and
backward.

The training telemetry is the JAX package's: with ``DISTKERAS_TELEMETRY``
on, a fit records spans, writes its trace and metrics files and starts the
flight deck; ``DISTKERAS_DYNAMICS`` adds the per-epoch training-dynamics
summary, the divergence watchdog and ``staleness_policy``; ``profile_dir``
and ``DISTKERAS_PROFILE`` capture ``torch.profiler`` traces.
``DISTKERAS_SANITIZE`` runs each epoch under the runtime sanitizer's
guards; in record mode a fit that recorded violations ends with one warning
that tallies them.
"""

from __future__ import annotations

import dataclasses
import random
import time
import warnings
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import chaos, fleet, sanitizer, telemetry
from distkeras_tpu_torch import workers as workers_mod
from distkeras_tpu_torch.data import epoch_arrays, epoch_window_iter, plan_epoch
from distkeras_tpu_torch.frame import DataFrame
from distkeras_tpu_torch.models.adapter import ModelAdapter, TrainedModel, as_adapter
from distkeras_tpu_torch.ops.metrics import per_token_metric_names
from distkeras_tpu_torch.parallel.engine import WindowedEngine, _mix64
from distkeras_tpu_torch.parallel.gspmd import GSPMDEngine
from distkeras_tpu_torch.parallel.pipeline import PipelineEngine
from distkeras_tpu_torch.parallel.mesh import (
    TP_AXIS,
    WORKER_AXIS,
    LocalMesh,
    all_reduce_sum,
    broadcast,
    local_device_count,
    resolve_device,
)
from distkeras_tpu_torch.parameter_servers import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    ParameterServer,
)
from distkeras_tpu_torch.utils.pytree import tree_leaves, tree_map

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

def _serving_twin(adapter: ModelAdapter) -> ModelAdapter:
    """The seq-free twin of a sequence-parallel adapter, on the same
    parameters: a ``seq_axis`` model runs the ring's collectives and needs
    its mesh, so every trainer return path hands back the ``seq_axis=None``
    twin, and ``train(df)`` returns a servable model (the JAX package's
    ``_serving_twin``).  Any other adapter as it is."""
    module = getattr(adapter, "module", None)
    if module is not None and getattr(module, "seq_axis", None) is not None:
        return dataclasses.replace(adapter, module=module.twin(None))
    if dataclasses.is_dataclass(adapter) and getattr(adapter, "seq_axis", None) is not None:
        # a staged adapter (pipeline x sequence parallelism) is the model
        # itself: its twin is a fresh instance with the seq axis off, which
        # carries over the non-field checkpoint a PretrainedStagedLM's init
        # adopts
        twin = dataclasses.replace(adapter, seq_axis=None)
        pretrained = getattr(adapter, "_pretrained", None)
        if pretrained is not None:
            twin._pretrained = pretrained
        return twin
    return adapter


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


def _tree_rows(stats, chunk: int, e: int):
    """Epoch ``e`` of a ``chunk``-epoch stats tree (nested dicts of arrays
    whose leading dim runs over the chunk's epochs)."""
    if isinstance(stats, dict):
        return {k: _tree_rows(v, chunk, e) for k, v in stats.items()}
    return stats.reshape((chunk, stats.shape[0] // chunk) + stats.shape[1:])[e]


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


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
        self.seq_shards = int(seq_shards)
        if self.seq_shards < 1:
            raise ValueError(f"seq_shards must be >= 1, got {seq_shards}")
        if tp_shards > 1 and self.seq_shards > 1:
            raise ValueError(
                "tp_shards>1 (GSPMD engine) is incompatible with "
                "seq_shards>1 (ring attention needs the shard_map "
                "engine); fsdp + seq_shards IS supported — drop tp_shards"
            )
        # tensor parallelism shards: >1 selects the GSPMD engine (parameter
        # leaves split over a 'model' axis of ranks; any model, unmodified)
        self.tp_shards = int(tp_shards)
        # fsdp with seq_shards>1 is the seq-axis ZeRO center of the windowed
        # engine; fsdp alone is the GSPMD engine's workers-axis one
        self.fsdp = bool(fsdp)
        # optional GSPMD leaf-placement override, (shape, name) -> spec|None
        self.tp_spec_fn = tp_spec_fn
        if tp_spec_fn is not None and self.tp_shards <= 1:
            raise ValueError(
                "tp_spec_fn places leaves on the model mesh axis, which only "
                "exists with tp_shards>1 (the GSPMD engine); without it the "
                "override would be silently ignored"
            )
        # profile the second epoch (or the only one) with torch.profiler, its
        # Chrome trace written here
        self.profile_dir = profile_dir
        # pipeline parallelism stages: >1 selects the pipeline engine (a
        # microbatch pipeline over the stages axis of a (workers, stages)
        # grid; needs a staged adapter with num_stages == pipeline_stages)
        self.pipeline_stages = int(pipeline_stages)
        self.pp_microbatches = pp_microbatches
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

    def _watchdog_rollback(self, engine, ckpt, state, watchdog):
        """Restore the last checkpoint after a watchdog trip (policy
        ``rollback``): the diverged state is discarded and training
        continues from the restored center and workers — the path a
        crash-resume takes, bitwise."""
        reason = watchdog.pending_rollback
        # verified: rolling back onto a corrupt checkpoint would trade a
        # diverged run for a crashed one
        step = ckpt.latest_verified() if ckpt is not None else None
        if step is None:
            raise telemetry.dynamics.TrainingDiverged(
                f"{reason} — rollback requested but no checkpoint has been "
                "saved yet"
            )
        state = self._restore_state(ckpt, engine, state, elastic=False, step=step)
        watchdog.rolled_back()
        if telemetry.enabled():
            telemetry.metrics.counter(
                "dynamics_rollbacks_total",
                help="watchdog-triggered checkpoint restores",
            ).inc()
        return state

    def _apply_staleness_bound(self, policy, summary, state):
        """Feed the finished epoch's dynamics summary to the staleness policy
        and write the bound it returns into the rule's ``staleness_bound``
        leaf, in place (a captured window reads the same tensor); rules
        without the leaf (plain DynSGD) pass through untouched."""
        from distkeras_tpu_torch.algorithms.adaptive import BOUND_KEY

        if BOUND_KEY not in state.center_rule:
            return state
        bound = float(policy.observe(summary))
        state.center_rule[BOUND_KEY].fill_(bound)
        if telemetry.enabled():
            telemetry.metrics.gauge(
                "dynamics_staleness_bound",
                help="adaptive DynSGD staleness bound in force",
            ).set(bound)
        return state

    def _elastic_resize(self, make_engine, engine, state, ckpt, epoch, rng, shuffle,
                        new_workers):
        """Mid-run worker-count change at an epoch boundary, as the JAX
        package's: drain to a boundary checkpoint, gather the center off the
        old engine, drop its captured windows, and rebuild the state at
        ``new_workers`` through ``state_from_center``, the path an elastic
        resume takes, with the same generator seed, so the run goes on bit
        for bit as a resume from that checkpoint at ``new_workers`` would.
        Progress (center, rule counters, epoch) carries over; the local
        replicas pull the center afresh."""
        from distkeras_tpu_torch.checkpoint import worker_mean
        from distkeras_tpu_torch.datapipe import DataState

        if ckpt is not None:
            # a boundary checkpoint first: if the rebuild dies,
            # train_with_recovery resumes from here
            ckpt.save_partial(state, epoch, DataState(
                epoch=epoch + 1, block_cursor=0,
                rng_state=rng.bit_generator.state if shuffle else None))
            ckpt.wait()
        center = engine.gather_center(state)
        # per-worker model state reduces to its worker mean on the host, as
        # an elastic resume reads it (checkpoint.worker_mean); over several
        # workers ranks the float64 sums meet in one all-reduce
        if engine.group is None:
            model_state = tree_map(lambda x: worker_mean(x.cpu()), state.model_state)
        else:
            sums = iter(all_reduce_sum([x.to(torch.float64).sum(dim=0)
                                        for x in tree_leaves(state.model_state)], engine.group))
            model_state = tree_map(lambda x: _rounded_mean(next(sums), engine.num_workers,
                                                           x.dtype), state.model_state)
        engine.clear_program_cache()
        new_engine = make_engine(new_workers)
        generator = torch.Generator().manual_seed(_mix64(self.seed, epoch + 1))
        new_state = new_engine.state_from_center(generator, center, state.center_rule,
                                                 model_state, epoch + 1)
        if telemetry.enabled():
            telemetry.metrics.counter(
                "elastic_resizes_total", help="mid-run worker-count rebuilds",
            ).inc()
            telemetry.metrics.gauge(
                "elastic_workers", help="current logical worker count"
            ).set(new_workers)
            telemetry.metrics.gauge(
                "elastic_devices", help="devices the worker axis occupies"
            ).set(new_engine.ranks)
        return new_engine, new_state

    def _elastic_poll(self, ctl, engine) -> Optional[int]:
        """The worker count ``ctl`` asks for at this boundary, or None.
        Global rank 0 polls and broadcasts the answer, so every rank
        resizes at the same boundary; a count that does not split evenly
        over the engine's workers ranks is rounded down to one that does,
        at least one worker a rank (ROADMAP Queue C, C21)."""
        import torch.distributed as dist

        grouped = dist.is_available() and dist.is_initialized()
        desired = ctl.poll() if not grouped or dist.get_rank() == 0 else None
        desired = _rank0_value(desired)
        if desired and desired % engine.ranks:
            fitted = max(engine.ranks, desired // engine.ranks * engine.ranks)
            warnings.warn(
                f"elastic membership asked for {desired} workers, which do not split "
                f"evenly over {engine.ranks} workers ranks; resizing to {fitted}",
                RuntimeWarning,
            )
            desired = fitted
        return desired

    def _fit(self, *args, **kwargs):
        """Crash-forensics boundary around :meth:`_fit_inner`, as in the JAX
        package: with telemetry on, mint or propagate the fleet ``run_id``
        and start the HTTP exporter when one is configured, and on any
        unhandled exception (a watchdog halt included) dump the flight
        recorder's blackbox into the telemetry directory before re-raising.
        With telemetry off this is one cached-bool check a fit."""
        if telemetry.enabled():
            telemetry.flightdeck.activate()
        try:
            return self._fit_inner(*args, **kwargs)
        except Exception as e:
            if telemetry.enabled():
                telemetry.flightdeck.on_crash(
                    f"{type(self).__name__}._fit: {type(e).__name__}: {e}")
            raise

    def _fit_inner(self, dataframe: DataFrame, rule, num_workers: int, *, shuffle: bool = True,
                   average_at_end: bool = False, commit_schedule=None, mesh=None):
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
        :class:`~distkeras_tpu_torch.fleet.Preempted` raised.  ``mesh``
        goes to the engine (None: every rank of the process group, if
        any).

        With dynamics on (``DISTKERAS_DYNAMICS``, an engine other than the
        pipeline's) each epoch's summary becomes gauges and a JSONL line
        (``telemetry.dynamics.record``) and feeds the divergence watchdog
        (``warn``, ``halt`` or ``rollback`` to the last checkpoint) and a
        ``staleness_policy``.  ``profile_dir`` profiles the second epoch
        (or the only one); ``DISTKERAS_PROFILE`` the epochs
        ``DISTKERAS_PROFILE_STEPS`` names."""
        from distkeras_tpu_torch.datapipe import DataState

        adapter = as_adapter(self.master_model)
        # per-token models rename accuracy -> token_accuracy, without
        # mutating the user-visible self.metrics
        metrics = self.metrics
        if getattr(adapter, "per_token_labels", False):
            metrics = per_token_metric_names(metrics)
        with telemetry.trace.span("load_columns", phase="data"):
            feats, labels = self._load_columns(dataframe)
        def make_engine(n_workers):
            return self._make_engine(adapter, rule, n_workers, metrics, commit_schedule, mesh)

        engine = make_engine(num_workers)
        window = rule.communication_window if rule.communication_window > 0 else None
        rng = np.random.default_rng(self.seed)

        ckpt = None
        start_epoch = 0
        resuming = elastic = False
        if self.checkpoint_dir:
            from distkeras_tpu_torch.checkpoint import CheckpointManager

            ckpt = CheckpointManager(self.checkpoint_dir, every=self.checkpoint_every,
                                     mesh=engine.mesh, center=engine)
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
        # divergence watchdog: armed only when the engine computes dynamics;
        # it reads each epoch's summary on the host, after the epoch's stats
        # were read back
        watchdog = None
        if engine._dynamics:
            watchdog = telemetry.dynamics.DivergenceWatchdog.from_config()
        if watchdog is not None and watchdog.policy == "rollback":
            if ckpt is None:
                raise ValueError(
                    "watchdog policy 'rollback' needs checkpoint_dir set so "
                    "there is a checkpoint to restore"
                )
            if self.dispatch_epochs > 1:
                raise ValueError(
                    "watchdog policy 'rollback' needs the per-epoch loop; "
                    "dispatch_epochs>1 runs whole chunks per dispatch with no "
                    "epoch boundary to restore at"
                )
        # elastic membership: poll the fleet at epoch boundaries and resize
        # the worker set mid-run; progress must live in the center to carry
        # over a rebuild, so only committing rules on the per-epoch loop
        elastic_ctl = getattr(self, "elastic", None)
        if elastic_ctl is not None and (
            rule.communication_window <= 0
            or commit_schedule is not None
            or self.pipeline_stages > 1
            or self.dispatch_epochs > 1
        ):
            warnings.warn(
                "elastic membership polling disabled: it requires a "
                "committing rule on the per-epoch loop (no commit_schedule, "
                "pipeline_stages=1, dispatch_epochs=1)",
                RuntimeWarning,
            )
            elastic_ctl = None
        # the staleness policy reads the dynamics summary
        staleness_policy = getattr(self, "staleness_policy", None)
        if staleness_policy is not None and not engine._dynamics:
            warnings.warn(
                "staleness_policy set but dynamics telemetry is off "
                "(DISTKERAS_DYNAMICS); the bound will not adapt",
                RuntimeWarning,
            )
            staleness_policy = None
        # the elastic path builds its state from the partial restore; the
        # bitwise path restores into a fresh state
        state = None
        if not elastic or self.pipeline_stages > 1:
            # the pipeline engine's init_state first, as in the JAX package
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

        # the env-driven step-windowed capture; profile_dir (the trainer's
        # knob) takes precedence, as both would drive the one profiler
        prof = None if self.profile_dir else telemetry.ProfilerHook.from_env()
        last_summary: dict = {}

        def observe(stats, epoch):
            """One epoch's read-back stats: the dynamics summary as gauges
            and a JSONL line, the scalar log, then the watchdog (after the
            logs, so that a halting epoch still reaches them)."""
            dyn = stats.get("dynamics")
            summary = None
            if dyn is not None:
                summary = telemetry.dynamics.summarize(dyn, loss=stats["loss"])
                telemetry.dynamics.record(epoch, dyn, summary)
                last_summary["value"] = summary
            if scalar_log is not None:
                scalar_log.log(epoch, **_epoch_scalars(stats, metrics))
                if telemetry.enabled():
                    telemetry.metrics.to_scalar_logger(scalar_log, epoch)
            if summary is not None and watchdog is not None:
                watchdog.observe(epoch, summary)  # raises under "halt"

        def profiled(run):
            """``run()`` under ``torch.profiler`` into ``profile_dir``."""
            with telemetry.profiler.profile(self.profile_dir):
                return run()

        epoch_stats: List[dict] = []
        self.record_training_start()
        # try/finally so the scalar logger and the profiler release their
        # writer and capture even when an epoch raises
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
                    start_epoch, observe, profiled)
                start_epoch = self.num_epoch  # the per-epoch loop below runs 0 times
            stream_window = window
            if self.streaming and window is None:
                # no-commit trainers have no natural window: stream fixed
                # blocks with a ragged tail, so the step count (and the
                # trajectory) is the in-memory path's
                steps = plan_epoch(len(feats), num_workers, self.batch_size, 1)[0]
                stream_window = min(steps, 32)
            for epoch in range(start_epoch, self.num_epoch):
                if chaos.enabled():
                    chaos.fault("epoch")  # seeded kill entering this epoch, before device work
                if prof is not None:
                    prof.on_step(epoch)
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
                            workers=engine.workers,
                        )
                        if self.prefetch > 0:
                            from distkeras_tpu_torch.datapipe import PrefetchRing

                            blocks = PrefetchRing(blocks, depth=self.prefetch,
                                                  put_fn=engine.stream_put)
                        if chaos.enabled():
                            # seeded kill or stall at a block index, downstream
                            # of the prefetch ring so it reaches the consumer
                            blocks = chaos.wrap_blocks(blocks)
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

                        run = (lambda blocks=blocks, on_window=on_window:
                               engine.run_epoch_streaming(state, blocks, on_window=on_window))
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
                        run = lambda xs=xs, ys=ys: engine.run_epoch(state, xs, ys)
                    # profile the second epoch (the first includes warm-up),
                    # or the only one
                    if self.profile_dir and epoch == min(start_epoch + 1, self.num_epoch - 1):
                        state, stats = profiled(run)
                    else:
                        state, stats = run()
                    ps = getattr(self, "parameter_server", None)
                    if ps is not None:
                        ps.track(state.center_rule)
                    epoch_stats.append(stats)
                    observe(stats, epoch)
                    if watchdog is not None and watchdog.pending_rollback:
                        state = self._watchdog_rollback(engine, ckpt, state, watchdog)
                        continue  # don't checkpoint the diverged state
                    if ckpt is not None:
                        ckpt.maybe_save(state, epoch, data_state=data_state(epoch))
                    if staleness_policy is not None and "value" in last_summary:
                        # the bound for the next epoch, from this one's summary
                        state = self._apply_staleness_bound(
                            staleness_policy, last_summary["value"], state)
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
                    if elastic_ctl is not None and epoch + 1 < self.num_epoch:
                        desired = self._elastic_poll(elastic_ctl, engine)
                        if desired and desired != num_workers:
                            engine, state = self._elastic_resize(
                                make_engine, engine, state, ckpt, epoch, rng, shuffle,
                                desired)
                            num_workers = desired
                            resume_data = None
            if ckpt is not None:
                ckpt.wait()  # flush in-flight saves before declaring done
        finally:
            if prof is not None:
                prof.close()
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
        if telemetry.enabled():
            tt = self.get_training_time()
            telemetry.metrics.gauge(
                "training_seconds", help="wall seconds of the last fit"
            ).set(tt)
            if tt > 0 and epoch_stats:
                telemetry.metrics.gauge(
                    "samples_per_sec_per_chip",
                    help="trained samples per second per card (last fit)",
                ).set(len(epoch_stats) * len(feats) / tt / _world_size())
            # one file pair per process under DISTKERAS_TELEMETRY[_DIR]: the
            # Chrome trace (open in Perfetto) and a metrics snapshot
            telemetry.flush()
        if sanitizer.enabled() and not sanitizer.strict():
            # record mode: per-violation warnings fire once per guard kind,
            # so close the fit with the full tally — the operator's cue to
            # re-run strict before this reaches a card
            recorded = sanitizer.violations()
            if recorded:
                kinds = sorted({k for k, _ in recorded})
                warnings.warn(
                    f"sanitizer recorded {len(recorded)} violation(s) during "
                    f"this fit ({', '.join(kinds)} guard"
                    f"{'s' if len(kinds) > 1 else ''}); see the sanitizer_* "
                    "counters, or run with DISTKERAS_SANITIZE=strict to fail "
                    "at the offending dispatch",
                    RuntimeWarning,
                )
        return engine, state, adapter

    def _worker_row(self) -> int:
        """The ranks of one worker, which the default worker count divides
        the group's ranks by: a pipeline maps workers one to one onto the
        rows of its grid, each ``pipeline_stages x tp_shards x seq_shards``
        ranks (JAX's ``PipelineEngine`` check); the windowed engine's row is
        its seq ranks; the GSPMD engine counts every rank, as JAX's counts
        every device, and its model ranks then share the workers."""
        if self.pipeline_stages > 1:
            return self.pipeline_stages * self.tp_shards * self.seq_shards
        return self.seq_shards

    def _make_engine(self, adapter, rule, num_workers, metrics, commit_schedule=None,
                     mesh=None):
        """The engine ``_fit`` trains with, routed as the JAX package routes
        it: ``pipeline_stages > 1`` builds the pipeline engine over the
        ``(workers, stages)`` grid; ``tp_shards > 1``, or ``fsdp`` without a
        seq axis, the GSPMD engine over the ``(workers, model)`` grid;
        everything else the windowed engine (the seq-axis ZeRO center with
        ``seq_shards > 1``)."""
        if self.pipeline_stages > 1:
            if self.tp_spec_fn is not None:
                raise ValueError(
                    "tp_spec_fn is a GSPMD-engine override; the pipeline "
                    "engine places the model axis by its staged-leaf shape "
                    "rule"
                )
            if commit_schedule is not None:
                raise ValueError(
                    "pipeline_stages>1 is incompatible with commit_schedule "
                    "(the staleness simulation dispatches per step)"
                )
            if getattr(adapter, "num_stages", None) != self.pipeline_stages:
                raise ValueError(
                    f"pipeline_stages={self.pipeline_stages} needs a staged "
                    f"adapter with num_stages={self.pipeline_stages} (e.g. "
                    "models.StagedTransformer); got "
                    f"{type(self.master_model).__name__}"
                )
            return PipelineEngine(
                adapter, self.loss, self._effective_worker_optimizer(), rule, num_workers,
                microbatches=self.pp_microbatches, tp_shards=self.tp_shards,
                seq_shards=self.seq_shards, fsdp=self.fsdp, metrics=metrics,
                compute_dtype=self.compute_dtype, remat=self.remat, unroll=self.unroll,
                mesh=mesh, device=self.device)
        kwargs = dict(metrics=metrics, compute_dtype=self.compute_dtype,
                      commit_schedule=commit_schedule, remat=self.remat, unroll=self.unroll,
                      device=self.device)
        if self.tp_shards > 1 or (self.fsdp and self.seq_shards == 1):
            return GSPMDEngine(adapter, self.loss, self._effective_worker_optimizer(), rule,
                               num_workers, tp_shards=self.tp_shards, fsdp=self.fsdp,
                               spec_fn=self.tp_spec_fn, mesh=mesh, **kwargs)
        return WindowedEngine(adapter, self.loss, self._effective_worker_optimizer(), rule,
                              num_workers, mesh=mesh, seq_shards=self.seq_shards,
                              fsdp=self.fsdp, **kwargs)

    def _train_chunked(self, engine, state, feats, labels, num_workers, window, shuffle, ckpt,
                       start_epoch, observe, profiled):
        """The ``dispatch_epochs>1`` epoch loop: up to ``dispatch_epochs``
        epochs per :meth:`WindowedEngine.run_epochs` call, reshuffled on the
        card between epochs when ``shuffle`` is set.  Chunks never straddle
        a ``checkpoint_every`` boundary, so the checkpointed epochs are the
        per-epoch loop's.  ``profile_dir`` profiles the second chunk when it
        is as long as the first, else a lone first chunk, as in JAX.
        Returns ``(state, per-epoch stats)``."""
        steps = window or plan_epoch(len(feats), num_workers, self.batch_size, 1)[0]
        shuffle_seed = self.seed if shuffle else None
        # over several ranks the reshuffle permutes every worker's rows
        xs, ys = engine.shard_batches(*epoch_arrays(feats, labels, num_workers,
                                                    self.batch_size, steps),
                                      whole=shuffle_seed is not None and engine.ranks > 1)
        epoch_stats: List[dict] = []
        epoch = start_epoch
        chunk_idx, first_chunk = 0, None
        while epoch < self.num_epoch:
            chunk = min(self.dispatch_epochs, self.num_epoch - epoch)
            if ckpt is not None:
                chunk = min(chunk, self.checkpoint_every - epoch % self.checkpoint_every)
            first_chunk = chunk if first_chunk is None else first_chunk
            run = lambda chunk=chunk: engine.run_epochs(state, xs, ys, chunk,
                                                        shuffle_seed=shuffle_seed)
            with telemetry.trace.span("epoch", epoch=epoch, epochs=chunk):
                if self.profile_dir and ((chunk_idx == 1 and chunk == first_chunk) or (
                        chunk_idx == 0 and epoch + chunk >= self.num_epoch)):
                    state, stats = profiled(run)
                else:
                    state, stats = run()
            # chunk stats -> per-epoch dicts (leaves keep [n_windows, ...])
            for e in range(chunk):
                one = _tree_rows(stats, chunk, e)
                epoch_stats.append(one)
                observe(one, epoch + e)
            epoch += chunk
            chunk_idx += 1
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
        adapter = _serving_twin(adapter)
        if hasattr(adapter, "assign"):  # Keras path: write back and return the Keras model
            return adapter.assign(params, model_state)
        return TrainedModel(adapter, params, model_state, device=engine.device,
                            history=self.history)

    def train(self, dataframe: DataFrame, shuffle: bool = False):
        raise NotImplementedError


class SingleTrainer(Trainer):
    """Single-worker baseline (reference parity: ``SingleTrainer`` — one
    partition, a SequentialWorker).  Inside a process group every rank
    trains the one worker whole (a one-rank mesh), so every rank returns
    the same model; global rank 0 alone writes checkpoints.  With
    ``tp_shards > 1`` the one worker trains over the model ranks of a
    one-row grid (every rank of the group)."""

    def train(self, dataframe: DataFrame, shuffle: bool = False):
        worker = workers_mod.SequentialWorker(self.worker_optimizer, self.batch_size)
        # sequence, tensor and pipeline parallelism need the grid of the
        # group's ranks; the GSPMD engine's fsdp alone trains on a one-rank grid
        if self.seq_shards > 1 or self.tp_shards > 1 or self.pipeline_stages > 1:
            mesh = None
        else:
            mesh = LocalMesh((WORKER_AXIS, TP_AXIS)) if self.fsdp else LocalMesh()
        engine, state, adapter = self._fit(dataframe, worker.rule, num_workers=1,
                                           shuffle=shuffle, mesh=mesh)
        return self._finalize(engine, state, adapter, use_center=False)


class AveragingTrainer(Trainer):
    """Synchronous one-shot weight averaging (reference parity:
    ``AveragingTrainer.average_models``): N independent replicas, averaged
    once at the end."""

    def __init__(self, *args, num_workers: int = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_workers = num_workers or _default_workers(self.device, self._worker_row())

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
        adapter = _serving_twin(adapter)
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
    ranks of the process group (one process per card), else to the number
    of cards; the workers of one rank run on its card in turn, and the
    commit sums over every rank.
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
        super().__init__(
            keras_model, loss, worker_optimizer, metrics,
            features_col, label_col, batch_size, num_epoch, seed, compute_dtype,
            checkpoint_dir, checkpoint_every, resume, profile_dir, seq_shards,
            tp_shards, fsdp, tensorboard_dir, streaming, remat, unroll,
            dispatch_epochs, pipeline_stages, pp_microbatches, tp_spec_fn,
            prefetch, checkpoint_blocks, device,
        )
        self.num_workers = num_workers or _default_workers(self.device, self._worker_row())
        # a fleet.ElasticMembership (anything with poll() -> Optional[int])
        # polled at epoch boundaries to resize the worker set mid-run
        self.elastic = elastic
        # AdaptiveBound-style policy retuning the rule's staleness bound
        # between epochs from the dynamics summary (DISTKERAS_DYNAMICS)
        self.staleness_policy = staleness_policy
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
        surfaces at once.  Inside a process group every rank runs this
        loop; the failure must reach every rank (a collective raises on all
        of them), and the newest step is global rank 0's, broadcast, so
        every rank takes the same decision.  Retries back off exponentially
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
                step = _rank0_value(step)
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


def _default_workers(device, row: int) -> int:
    """The default worker count: one per workers rank of the grid (the
    ranks over the ``row`` ranks of a worker, :meth:`Trainer._worker_row`),
    else one per card."""
    return max(1, local_device_count(device) // row)


def _rank0_value(value: Optional[int]) -> Optional[int]:
    """Global rank 0's ``value`` (None or an int >= 0: a checkpoint step, a
    worker count) on every rank of the process group (the value itself
    outside one)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return value
    got = broadcast([torch.tensor([-1 if value is None else int(value)])], 0, dist.group.WORLD)
    return None if int(got[0]) < 0 else int(got[0])


def _rounded_mean(total: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``checkpoint.worker_mean`` from a float64 sum over ``n`` workers,
    on the host."""
    m = total.cpu() / n
    return (m if dtype.is_floating_point else torch.round(m)).to(dtype)


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
    """DynSGD with an SSP-style staleness bound carried in the center state.

    Pass ``staleness_policy=AdaptiveBound(...)`` to retune the bound online
    between epochs from the dynamics telemetry (needs
    ``DISTKERAS_DYNAMICS=1``); with the default ``inf`` bound and no policy
    the trajectory is DynSGD's, bit for bit."""

    def __init__(self, *args, communication_window: int = 5,
                 initial_bound: float = float("inf"), **kwargs):
        super().__init__(*args, communication_window=communication_window, **kwargs)
        self.initial_bound = initial_bound

    def allocate_worker(self):
        return workers_mod.AdaptiveDynSGDWorker(
            self.worker_optimizer, self.batch_size, self.features_col,
            self.label_col, self.communication_window, self.initial_bound,
        )
