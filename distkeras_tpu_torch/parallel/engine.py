"""The training engine: windowed local SGD + commits, on one card or a mesh.

The port of :mod:`distkeras_tpu.parallel.engine` (``WindowedEngine``).  A
*worker* is a logical training replica.  Every per-worker tensor carries a
leading ``[num_workers]`` dim, the layout of the JAX engine's state; the
parameter-server center variable has none.  Two modes, as in JAX:

* **Uniform windows.**  One epoch is a loop over commit windows: in each
  window every worker takes ``window`` local optimizer steps, then the
  rule's ``commit`` runs once over all workers, its ``psum`` a sum over the
  worker dim.
* **Staleness simulation** (``commit_schedule``: one commit period per
  worker).  At each step every worker takes one local step, then **one**
  commit runs over all workers with the per-worker mask ``(t + 1) % period
  == 0`` and each worker's steps since its last commit.  All committers of
  a step race the same center, as under the JAX engine's ``vmap``: a rule
  that counts staleness (DynSGD) sees the update count from before the
  step's commits.

Epochs run from in-memory arrays (``run_epoch``; ``run_epochs`` for several
epochs with one read-back and an optional on-device reshuffle) or from a
stream of per-window blocks (``run_epoch_streaming``, fed by
``stream_put``).

**Over a mesh** (``mesh=``, or every rank of the process group when one
exists: :mod:`~distkeras_tpu_torch.parallel.mesh`) the engine runs SPMD,
one process per card: every rank makes the same calls, owns the contiguous
block ``[r*v, (r+1)*v)`` of the ``num_workers`` logical workers (its
per-worker tensors carry ``[v]``, not ``[num_workers]``) and holds a replica
of the center.  The commit's ``psum`` is the local sum followed by an
all-reduce over the mesh's group (:func:`~distkeras_tpu_torch.algorithms.
base.mesh_ctx`).  The trajectory does not depend on the world size: every
rank draws all ``num_workers`` dropout seeds and keeps its block, starts
from rank 0's parameters (a broadcast), draws the same reshuffle (rank 0's,
broadcast), and the stats are the mean over all workers (one all-reduce of
the sums an epoch).  Without a group the engine is the one-card engine,
bit for bit.

Deliberate differences from the JAX engine:

* Workers on one card run **one after another** inside a window.  JAX
  batches them with ``vmap``, a compile-time transform that
  ``torch.func.vmap`` cannot apply to a kernel launched through ``ctypes``.
  Workers are independent between commits, so the result is the same.
* Steps run eagerly, and ``run_epoch`` consumes its input state (its
  tensors are updated in place, the commit's too), as the JAX engine's
  donated dispatch does.  The counterpart of the jitted window is a
  **captured CUDA graph**: with ``unroll`` other than 1 (an int > 1, or
  ``True``) on a card, one uniform window (every worker's local steps and
  the commit) is captured once and replayed once a window, ``remat`` or
  not.  Over a mesh the window's collectives are inside the graph (the
  commit's all-reduce over workers; with sequence parallelism the ring's
  hops forward and backward, the gradients' pmean over seq and fsdp's
  gather of the center): every axis group must run NCCL, whose
  communicators are made before the capture, and every rank captures and
  replays the same windows in lockstep (:mod:`~distkeras_tpu_torch.utils.
  graphs`).  The staleness simulation's epoch is captured the same way, one
  step at a time: every worker's local step and the masked commit, with
  the step index and each worker's steps since its last commit held on
  the device, replayed once a step.  On the CPU, where there are no
  graphs, ``unroll`` stays the scan hint it is in JAX and changes nothing.
* Dropout randomness is one ``torch.Generator`` per worker on the card,
  seeded from the init generator (JAX splits a key per worker).
* The on-device reshuffle of ``run_epochs`` draws ``torch.randperm``, not
  ``jax.random.permutation`` (:func:`epoch_permutation`): both are uniform
  permutations keyed by ``(shuffle_seed, epoch)``, not the same ones.
* ``remat`` wraps the model's apply in ``torch.utils.checkpoint``, whose
  recomputation draws dropout from a copy of each worker's generator taken
  before the forward, so the recomputed masks are the forward's.  Inside a
  captured window the copy is a second generator registered with the
  graph and set to the worker's state before each replay
  (:func:`_remat_apply`).
* A mesh is one process per card (ROADMAP Queue C, C10), and every rank of
  it owns the same number of workers: ``num_workers`` must be a multiple of
  the rank count (JAX tiles fewer workers onto fewer of its devices).

**Sequence parallelism** (``seq_shards > 1``, a model built with
``seq_axis="seq"``): the ranks form the ``(workers, seq)`` grid of
:func:`~distkeras_tpu_torch.parallel.mesh.make_mesh_grid`, ``world /
seq_shards`` rows of workers ranks by ``seq_shards`` sequence blocks.  Each
rank takes its workers' rows and its block of the sequence (last) dim, of
the labels too when they are per-token; the model runs ring attention over
the ``seq`` axis inside :func:`~distkeras_tpu_torch.parallel.mesh.bind_mesh`;
each step's gradients are ``pmean``'d over ``seq`` (the exact total
gradient, as the JAX engine's ``_sync_grads`` argues); a per-token model's
stats are ``pmean``'d over ``seq``.  The commit's sum and the stats' mean
run over the **workers** axis only: the ranks of one seq row hold the same
workers' blocks.  Rank 0's parameters and the reshuffle reach the whole
grid (a broadcast over ``seq``, then one over ``workers``).  Every seq rank
of a worker draws dropout from that worker's generator (ROADMAP C11).
``fsdp=True`` (with ``seq_shards > 1`` only) stores 1/``seq_shards`` of
each evenly splitting center leaf on each seq rank
(:func:`zero_shard_dim`) and gathers it at use, around the commit and the
read-outs: the trajectory is the replicated center's, bit for bit.

**Training dynamics** (``DISTKERAS_DYNAMICS``, read once when the engine
is built, :mod:`~distkeras_tpu_torch.telemetry.dynamics`): each local step
also measures its gradients' squared norm and non-finite count, and each
window, before its commit, every worker's non-finite parameters, its
squared distance from the center and the rule's own diagnostics
(``UpdateRule.dynamics``), and across the commit the center's squared
update.  The values stay on the device (in a captured window, inside the
graph) and reach the host with the epoch's loss, at the epoch's one
read-back: ``stats["dynamics"]`` holds per-window globals (``grad_norm``,
``update_norm``, ``nonfinite_grads``, ``nonfinite_params``, ``[T]``) and
per-worker series (``divergence``, ``staleness``, the rule's ``rule_*``,
``[T, num_workers]``), as the JAX engine's.  Off, the engine does none of
this and the stats have no ``dynamics`` key; on or off, the trajectory is
the same bit for bit.

**The runtime sanitizer** (``DISTKERAS_SANITIZE``, read once when the engine
is built, :mod:`~distkeras_tpu_torch.sanitizer`): the device work of each
epoch (of ``run_epochs``' epochs together; of each streamed window) runs
under the transfer guard, labelled ``epoch_dispatch``, so a host read of a
tensor in the loop is reported, naming the innermost span; the stats'
read-back follows, outside it.  Then the consumed input state is poisoned:
a later read of its fields raises instead of silently seeing the updated
tensors.  Off, the engine does none of this; on or off, the trajectory is
the same bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from collections import deque
from typing import TYPE_CHECKING, Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from distkeras_tpu_torch import sanitizer as sanitizer_mod
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.telemetry import dynamics as dynamics_mod
from distkeras_tpu_torch.algorithms.base import CommitCtx, UpdateRule, mesh_ctx
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import get_metric, per_token_metric_names
from distkeras_tpu_torch.ops.optimizers import apply_updates, get_optimizer
from distkeras_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    TRANSPORTS,
    WORKER_AXIS,
    all_gather,
    all_reduce_sum,
    axis_group,
    bind_mesh,
    broadcast,
    local_device_count,
    make_mesh,
    make_mesh_grid,
    mesh_group,
    mesh_rank,
    mesh_size,
    resolve_axis,
    resolve_device,
    transport_stats,
    worker_sharding,
)
from distkeras_tpu_torch.utils import graphs
from distkeras_tpu_torch.utils.pytree import tree_leaves, tree_map, tree_where

if TYPE_CHECKING:  # models.adapter imports this package (resolve_device)
    from distkeras_tpu_torch.models.adapter import ModelAdapter

__all__ = ["TrainState", "WindowedEngine", "epoch_permutation", "plan_workers",
           "zero_shard_dim"]

#: pinned host buffers per block shape for ``stream_put``: a buffer is
#: written again only after its copy to the card has landed (its event)
_PINNED_SLOTS = 3


def plan_workers(num_workers: int, n_devices: int) -> tuple[int, int]:
    """Tile ``num_workers`` logical workers onto hardware: returns
    ``(devices_used, virtual_per_device)`` with ``d * v == num_workers``,
    maximising the device dimension."""
    d = min(num_workers, n_devices)
    while num_workers % d:
        d -= 1
    return d, num_workers // d


def zero_shard_dim(shape, shards: int) -> int:
    """The ZeRO shard placement: the largest dim of ``shape`` that splits
    evenly over ``shards`` with at least 2 rows a shard, or -1 to stay
    whole (the JAX package's policy, so that both place a leaf alike)."""
    free = [d for d, s in enumerate(shape) if s % shards == 0 and s >= 2 * shards]
    return max(free, key=lambda d: shape[d]) if free else -1


def _seq_grid(seq_shards: int):
    """The ``(workers, seq)`` grid over every rank of the process group."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world % seq_shards:
        raise ValueError(
            f"seq_shards={seq_shards} needs a multiple of {seq_shards} ranks, the process "
            f"group has {world}: launch one process per rank (torchrun --nproc-per-node N "
            "with N = workers ranks x seq_shards)"
        )
    return make_mesh_grid(world // seq_shards, seq_shards)


@dataclasses.dataclass
class TrainState:
    """Full training state.  ``center_*`` leaves have no worker dim; every
    other tensor leaf carries a leading worker dim, ``[num_workers]`` on one
    rank and the rank's block ``[v]`` on a mesh; ``rng`` holds one
    generator per worker of that dim."""

    center_params: Any
    center_rule: Any
    local_params: Any
    opt_state: Any
    model_state: Any
    rule_local: Any
    rng: List[torch.Generator]
    epoch: int

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with ROADMAP Queue A {item}")


def _mix64(seed: int, epoch: int) -> int:
    """A 63-bit generator seed for ``(seed, epoch)`` (SplitMix64's finaliser
    over both), so that neighbouring epochs get unrelated streams."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(epoch) + 0x632BE59BD9B4E019) % 2**64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
    return (z ^ (z >> 31)) >> 1


def epoch_permutation(shuffle_seed: int, epoch: int, n: int, device) -> torch.Tensor:
    """The on-device reshuffle of epoch ``epoch``: a uniform permutation of
    ``range(n)`` from ``torch.randperm`` on a generator on ``device`` seeded
    from ``(shuffle_seed, epoch)``.  Keyed by the epoch counter, so a
    resumed run continues the same stream.  The JAX engine draws
    ``jax.random.permutation(fold_in(PRNGKey(shuffle_seed), epoch), n)``,
    which torch cannot reproduce (ROADMAP Queue C, C6)."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix64(shuffle_seed, epoch))
    return torch.randperm(n, generator=g, device=device)


def _graphs_requested(unroll) -> bool:
    """``unroll`` other than 1: ``True``, or an int > 1 (``False`` is 1)."""
    if isinstance(unroll, bool):
        return unroll
    if not isinstance(unroll, (int, np.integer)) or unroll < 1:
        raise ValueError(f"unroll must be True, False or an int >= 1, got {unroll!r}")
    return unroll > 1


def _remat_apply(adapter, params, model_state, x, generator, twin=None):
    """``adapter.apply`` in training under ``torch.utils.checkpoint``: the
    forward keeps no activations and the backward recomputes them.
    ``torch.utils.checkpoint`` restores only the device's default
    generator, and the port's dropout draws from ``generator``, so the
    recomputation draws from a fresh generator set to ``generator``'s state
    from before the forward: the same masks, hence the same gradients.

    A captured window can read no generator state.  There the
    recomputation draws from ``twin``: a generator registered with the
    graph, which the engine sets to ``generator``'s state before each
    replay and which only the recomputations draw from.  The forwards and
    the recomputations of a window make the same draws in the same order,
    one from ``generator``, the other from ``twin``, so each replay's
    recomputation draws that replay's forward masks."""
    saved = None if generator is None or twin is not None else generator.get_state()
    calls = [0]

    def run(x):
        g = generator
        if calls[0] and generator is not None:
            if twin is not None:
                g = twin
            else:
                g = torch.Generator(device=generator.device)
                g.set_state(saved)
        calls[0] += 1
        return adapter.apply(params, model_state, x, training=True, generator=g)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                             preserve_rng_state=False)


def _copy_into(dst_trees, src_trees) -> None:
    """Copy each ``src`` leaf into its ``dst`` leaf, in place (in the
    destination's dtype).  A source that shares memory with some
    destination is cloned first, so no copy reads a leaf that an earlier
    copy already overwrote."""
    pairs = []
    for dt, st in zip(dst_trees, src_trees):  # paired by key, not by position
        tree_map(lambda d, s: pairs.append((d, s)) if d is not s else None, dt, st)
    dst_ptrs = {d.data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.data_ptr() in dst_ptrs else s) for d, s in pairs]
    for d, s in pairs:
        # an integer leaf averaged over workers rounds to the nearest integer
        d.copy_(s.round() if s.is_floating_point() and not d.is_floating_point() else s)


def _state_trees(state) -> tuple:
    return (state.center_params, state.center_rule, state.local_params, state.opt_state,
            state.model_state, state.rule_local)


def _state_key(state) -> tuple:
    """What a captured window reads: the addresses of the state's tensors and
    the identity of its generators."""
    return (tuple(t.data_ptr() for t in tree_leaves(_state_trees(state))),
            tuple(id(g) for g in state.rng))


class _PutBlock(tuple):
    """A block :meth:`WindowedEngine.stream_put` has put: ``(xs, ys)``
    tensors on the engine's device and the event (or None) the compute
    stream waits on before reading them."""

    def __new__(cls, tensors, ready):
        block = super().__new__(cls, tensors)
        block.ready = ready
        return block


class _Captured:
    """One captured window: the graph, its input buffers and its outputs
    (the dynamics values among them, with dynamics on)."""

    def __init__(self, graph, x, y, loss, mets, dyn, ticks):
        self.graph, self.x, self.y, self.loss, self.mets = graph, x, y, loss, mets
        self.dyn = dyn
        #: kernel launches recorded in the graph, by wrapper
        self.ticks = ticks
        self.replays = 0


class WindowedEngine:
    """Owns the training loop for one (model, rule) pair on one device, or
    on this rank's device of a mesh."""

    def __init__(
        self,
        adapter: ModelAdapter,
        loss,
        worker_optimizer,
        rule: UpdateRule,
        num_workers: Optional[int] = None,
        *,
        metrics: Sequence = ("accuracy",),
        compute_dtype: Optional[torch.dtype] = None,
        commit_schedule: Optional[np.ndarray] = None,
        sync_model_state: bool = True,
        mesh=None,
        seq_shards: int = 1,
        fsdp: bool = False,
        remat: bool = False,
        unroll=1,
        device="cuda",
    ):
        self.seq_shards = int(seq_shards)
        if self.seq_shards < 1:
            raise ValueError(f"seq_shards must be >= 1, got {seq_shards}")
        # the seq-axis ZeRO center: fsdp without sequence parallelism is
        # the GSPMD engine's (ROADMAP Queue A item 15)
        self.fsdp = bool(fsdp)
        if self.fsdp and self.seq_shards <= 1:
            raise ValueError(
                "fsdp=True on WindowedEngine shards the center over the seq "
                "axis and needs seq_shards>1; for fsdp without sequence "
                "parallelism use the GSPMD engine (trainers route it there)"
            )
        module_axis = getattr(getattr(adapter, "module", None), "seq_axis", None)
        if self.seq_shards > 1 and module_axis != SEQ_AXIS:
            raise ValueError(f"seq_shards={self.seq_shards} needs a model built with "
                             f"seq_axis={SEQ_AXIS!r}, got seq_axis={module_axis!r}")
        self.adapter = adapter
        self.rule = rule
        self.device = resolve_device(device)
        # rematerialise the model's forward on the backward
        # (torch.utils.checkpoint; jax.checkpoint in the JAX engine)
        self.remat = bool(remat)
        self.unroll = unroll
        # unroll other than 1 on a card: each uniform window is a captured
        # CUDA graph; on the CPU the option is the JAX scan hint and inert
        self.use_graphs = _graphs_requested(unroll) and self.device.type == "cuda"
        if self.seq_shards > 1:
            self.mesh = _seq_grid(self.seq_shards) if mesh is None else mesh
            names = tuple(self.mesh.mesh_dim_names or ())
            if names != (WORKER_AXIS, SEQ_AXIS) or resolve_axis(
                    SEQ_AXIS, self.mesh).size != self.seq_shards:
                raise ValueError(f"seq_shards={self.seq_shards} needs a ({WORKER_AXIS}, "
                                 f"{SEQ_AXIS}) grid with {self.seq_shards} seq ranks, got "
                                 f"{self.mesh}")
            default_workers = mesh_size(self.mesh)
        else:
            default_workers = local_device_count(self.device) if mesh is None else mesh_size(mesh)
            # every rank of the group, as JAX takes every device (one rank without)
            self.mesh = make_mesh() if mesh is None else mesh
        #: the seq axis's name, and its group (None without sequence parallelism)
        self.seq_axis = SEQ_AXIS if self.seq_shards > 1 else None
        self.seq_group = axis_group(self.mesh, SEQ_AXIS) if self.seq_axis else None
        #: the mesh's workers-axis process group; None runs no collective (one rank)
        self.group = mesh_group(self.mesh)
        if self.group is not None and self.mesh.get_coordinate() is None:
            raise ValueError(f"this process (rank {dist.get_rank()}) is not a rank of {mesh}")
        self.ranks, self.rank = mesh_size(self.mesh), mesh_rank(self.mesh)
        self.num_workers = int(num_workers or default_workers)
        self.n_dev, self.virtual = plan_workers(self.num_workers, self.ranks)
        if self.n_dev != self.ranks:
            raise ValueError(
                f"num_workers={self.num_workers} does not split evenly over the mesh's "
                f"{self.ranks} ranks: every rank owns the same number of workers"
            )
        #: this rank's block of the workers
        self.workers = worker_sharding(self.mesh).local_slice(self.num_workers)
        if self.use_graphs:
            graphs.require_nccl(
                [axis_group(self.mesh, n) for n in self.mesh.mesh_dim_names or ()],
                "captured windows (unroll other than 1 on a card)",
                "train with unroll=1, or over NCCL (one rank per card)")
        self.optimizer = get_optimizer(worker_optimizer)
        self.loss_fn = get_loss(loss, from_logits=self.adapter.outputs_logits)
        if getattr(self.adapter, "per_token_labels", False):
            metrics = per_token_metric_names(metrics)
        self.metric_fns = [get_metric(m) for m in metrics]
        self.compute_dtype = compute_dtype
        self.sync_model_state = sync_model_state
        # per-worker commit periods (staleness simulation); None => uniform
        # synchronous windows
        self.commit_schedule = (
            None if commit_schedule is None else np.asarray(commit_schedule, np.int32)
        )
        if self.commit_schedule is not None and len(self.commit_schedule) != self.num_workers:
            raise ValueError(
                f"commit_schedule has {len(self.commit_schedule)} entries for "
                f"{self.num_workers} workers"
            )
        # (schedule bytes, this rank's commit periods on the device): put
        # before the epoch's guarded device work, once per schedule
        self._periods = None
        # training-dynamics stats, read once: the engine's window and step
        # bodies branch on this bool for the engine's life
        self._dynamics = dynamics_mod.enabled()
        # the runtime sanitizer (distkeras_tpu_torch.sanitizer), same
        # convention: one cached bool read at build; off, no guard is
        # entered and no tensor method is patched
        self._sanitize = sanitizer_mod.enabled()
        # captured windows, keyed as the JAX engine keys its epoch programs;
        # every graph reads and writes the one state ``_static`` holds
        self._graphs: dict = {}
        self._static: Optional[TrainState] = None
        # with remat, one generator per worker of the captured state, registered
        # with every graph: the recomputations draw from it (_remat_apply);
        # ``_twin_of`` maps a worker's generator to it while a capture runs
        self._twins: Optional[list] = None
        self._twin_of: dict = {}
        # the staleness simulation's step index, each worker's steps since its
        # last commit and its commit periods, on the device (_stale_step)
        self._clock: Optional[dict] = None
        #: captures made and windows (or steps) replayed since the cache was
        #: last cleared
        self.graph_stats = {"captures": 0, "replays": 0}
        #: filled by :meth:`run_epoch_streaming`: source timing and the
        #: link-bound verdict of the last streamed epoch
        self.last_stream_report = None
        self._link_warned = False
        self._pinned: dict = {}
        self._copy_stream = None
        #: per center leaf, the dim fsdp splits over ``_fsdp_axis`` (-1:
        #: whole); set from the parameters when a state is built
        self._fsdp_dims = None
        #: the axis the fsdp center is split over (the GSPMD engine: workers)
        self._fsdp_axis = SEQ_AXIS
        #: the groups of the ranks that hold the same workers, one an axis
        #: after ``workers`` (the seq ranks of a row; the GSPMD engine's
        #: model ranks; the pipeline's stage ranks, then its model or seq
        #: ranks); None for an axis of one rank
        self._row_groups = (self.seq_group,)

    # ------------------------------------------------------------------ init
    def init_state(self, generator: torch.Generator, sample_input) -> TrainState:
        """Draw the initial parameters with ``adapter.init(generator,
        sample_input)``, give every worker a copy (and an optimizer and rule
        state), and seed one dropout generator per worker from
        ``generator``."""
        params, model_state = self.adapter.init(generator, sample_input)
        return self._assemble_state(generator, params, model_state)

    def _from_rank0(self, tree):
        """``tree`` as mesh rank 0 holds it, on every rank of the grid (one
        broadcast per dtype and axis: over each of the row's axes, seq,
        model or stages, then over workers); the tree itself without a
        group."""
        leaves = tree_leaves(tree)
        for group in (*self._row_groups, self.group):
            if group is not None:
                leaves = [t.clone() for t in broadcast(leaves, 0, group)]
        leaves = iter(leaves)
        return tree_map(lambda _: next(leaves), tree)

    # ------------------------------------------------- fsdp (ZeRO center)
    def _record_layout(self, params) -> None:
        """Choose, per center leaf, the dim fsdp splits over its axis
        (:func:`zero_shard_dim`), from the real parameter shapes; every
        later gather and slice reads this one table."""
        if not self.fsdp:
            return
        shards = resolve_axis(self._fsdp_axis, self.mesh).size
        self._fsdp_dims = tree_map(lambda x: zero_shard_dim(tuple(x.shape), shards), params)
        self._warn_if_whole(shards)

    def _warn_if_whole(self, shards: int) -> None:
        if all(d < 0 for d in tree_leaves(self._fsdp_dims)):
            warnings.warn(
                f"fsdp=True: no center leaf has a dim divisible by the {shards} "
                f"{self._fsdp_axis} shards (with >=2 rows per shard); the center "
                "stays whole on every rank", stacklevel=4)

    def _fsdp_gather(self, tree):
        """The center from its fsdp shards (gather at use); the tree itself
        without fsdp."""
        if not self.fsdp:
            return tree
        return tree_map(
            lambda d, x: x if d < 0 else all_gather(x, self._fsdp_axis, d, self.mesh),
            self._fsdp_dims, tree)

    def _fsdp_shard(self, tree):
        """This rank's fsdp block of each leaf of a gathered center (views);
        the tree itself without fsdp."""
        if not self.fsdp:
            return tree
        ax = resolve_axis(self._fsdp_axis, self.mesh)

        def one(d, x):
            if d < 0:
                return x
            block = x.shape[d] // ax.size
            return x.narrow(d, ax.index * block, block)

        return tree_map(one, self._fsdp_dims, tree)

    def shard_center(self, tree):
        """A whole center (a checkpoint's) as this rank stores it: its fsdp
        block of each leaf under fsdp, as new tensors; else the tree."""
        if not self.fsdp:
            return tree
        return tree_map(lambda x: x.clone(), self._fsdp_shard(tree))

    def _local_block(self, params):
        """The part of the whole parameters a worker on this rank holds:
        all of it here; the GSPMD engine's model rank holds its blocks."""
        return params

    @property
    def _forward(self):
        """What the local step (and remat's recompute) calls ``apply`` on:
        the adapter; the GSPMD engine's places the split parameters."""
        return self.adapter

    # ------------------------------------------------------- checkpoint views
    def checkpoint_state(self, state: TrainState) -> TrainState:
        """``state`` with whole leaves, what a checkpoint holds: the center
        gathered (a collective every rank of the grid takes part in)."""
        return state.replace(center_params=self.gather_center(state))

    def restore_field(self, field: str, tree):
        """A restored field, whole, as this rank stores it
        (:meth:`checkpoint_state`'s inverse)."""
        return self.shard_center(tree) if field == "center_params" else tree

    def _assemble_state(self, generator, params, model_state) -> TrainState:
        v, dev = self.virtual, self.device
        # a seq_axis model's parameters are the seq-free model's (JAX builds
        # them inside the ring, init_on_mesh): built outside any ring here,
        # and every rank of the grid takes rank 0's
        params = tree_map(lambda x: x.detach().to(dev, copy=True), params)
        params, model_state = self._from_rank0(
            (params, tree_map(lambda x: x.detach().to(dev), model_state)))
        self._record_layout(params)
        local = self._local_block(params)

        def tile(tree):
            # on the device: a rule's fresh counters (DynSGD's clock) start on the CPU
            return tree_map(lambda x: x.to(dev).expand(v, *x.shape).clone(), tree)

        # every rank draws all the workers' seeds and keeps its block, so a
        # worker's stream does not depend on where it runs
        seeds = torch.randint(0, 2**62, (self.num_workers,), generator=generator)[self.workers]
        return TrainState(
            center_params=self.shard_center(params),
            center_rule=tree_map(lambda x: x.to(dev), self.rule.init_center_state()),
            local_params=tile(local),
            opt_state=tile(self.optimizer.init(local)),
            model_state=tile(model_state),
            rule_local=tile(self.rule.init_local_state(local)),
            rng=[torch.Generator(device=dev).manual_seed(int(s)) for s in seeds],
            epoch=0,
        )

    def state_from_center(self, generator: torch.Generator, center_params, center_rule,
                          model_state, epoch: int) -> TrainState:
        """Elastic resume: rebuild the full training state around a restored
        center variable at this engine's worker count, which may differ
        from the count the checkpoint was written at.

        Local replicas adopt the center (the reference's retried worker
        reconnects to the parameter server and pulls), optimizer and rule
        local state start afresh, and the center's rule state (the commit
        counters) and the epoch carry over.  Leaves may be numpy arrays or
        tensors.  A resume at the same worker count restores bitwise
        instead (``CheckpointManager.restore(like=...)``)."""
        as_tensor = lambda x: x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        params = tree_map(as_tensor, center_params)
        state = self._assemble_state(generator, params, tree_map(as_tensor, model_state))
        rule = tree_map(lambda t: as_tensor(t).to(self.device, copy=True), center_rule)
        return state.replace(center_rule=rule, epoch=int(epoch))

    # ------------------------------------------------------------- local step
    def _local_step(self, params, opt_state, model_state, generator, x, y):
        """One optimizer step of one worker: forward, loss (plus the model's
        auxiliary loss), metrics, backward, optimizer update.  Returns the
        new ``(params, opt_state, model_state)``, this step's loss and
        metrics as device tensors, and with dynamics on its gradients'
        squared norm and non-finite count (else None)."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        # the ring's collectives resolve the seq axis against this mesh; the
        # binding spans the backward too (remat recomputes the forward there)
        with torch.enable_grad(), bind_mesh(self.mesh):
            p, x_c = leaves, x
            if self.compute_dtype is not None:
                # f32 master params, cast inside the loss (engine.py:456-462
                # of the JAX package); autocast would not cast the same ops
                cast = self.compute_dtype
                p = tree_map(lambda t: t.to(cast) if t.is_floating_point() else t, leaves)
                x_c = x.to(cast) if x.is_floating_point() else x
            if self.remat:
                out, model_state = _remat_apply(self._forward, p, model_state, x_c, generator,
                                                self._twin_of.get(id(generator)))
            else:
                out, model_state = self._forward.apply(p, model_state, x_c, training=True,
                                                       generator=generator)
            out = out.float()
            loss = self.loss_fn(out, y) + self.adapter.aux_loss(model_state)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)]
        if self.seq_axis is not None:
            # each seq rank holds its partial gradient (times seq_shards under
            # the classifier's psum): the pmean is the exact total gradient
            grads = [g / self.seq_shards for g in all_reduce_sum(grads, self.seq_group)]
        grads = iter(grads)
        grads = tree_map(lambda _: next(grads), leaves)
        with torch.no_grad():
            out = out.detach()
            mets = (torch.stack([m(out, y) for m in self.metric_fns]) if self.metric_fns
                    else torch.zeros((0,), device=out.device))
            dstep = self._grad_stats(grads)
            updates, opt_state = self.optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, model_state, loss.detach(), mets, dstep

    def _grad_stats(self, grads):
        """With dynamics on, a step's gradient health: ``(squared norm,
        non-finite count)`` as f32 device scalars; None when off."""
        if not self._dynamics:
            return None
        w = self._dyn_weights
        return (dynamics_mod.tree_sq_norm(grads, weights=w),
                dynamics_mod.tree_nonfinite_count(grads, weights=w))

    # ---------------------------------------------------------------- window
    def _ctx(self, steps_in_window, mask=None) -> CommitCtx:
        """The commit context of this rank's workers (``mask``: their
        block of the mask, every worker committing by default)."""
        if mask is None:
            mask = torch.ones(self.virtual, dtype=torch.bool, device=self.device)
        return mesh_ctx(self.num_workers, steps_in_window, self.device, self.group, mask)

    def _mean_over_workers(self, *sums):
        """Per-window (or per-step) sums over this rank's workers, as the
        mean over all workers: one all-reduce for all of them, over the
        workers axis.  A per-token model's stats are local to each rank's
        sequence block: they are then averaged over the seq axis (a
        classifier's psum-pooled logits are already the same on every seq
        rank)."""
        means = [s / self.num_workers for s in all_reduce_sum(sums, self.group)]
        if self.seq_axis is not None and self.adapter.per_token_labels:
            means = [m / self.seq_shards for m in all_reduce_sum(means, self.seq_group)]
        return means

    def _seq_block(self, xs, ys):
        """This rank's block of the sequence (last) dim of ``xs``, and of
        ``ys`` when the labels are per-token; both as given without
        sequence parallelism."""
        if self.seq_axis is None:
            return xs, ys
        n = xs.shape[-1]
        if n % self.seq_shards:
            raise ValueError(f"a sequence of {n} does not split over seq_shards={self.seq_shards}")
        block = n // self.seq_shards
        index = resolve_axis(SEQ_AXIS, self.mesh).index
        cut = slice(index * block, (index + 1) * block)
        return xs[..., cut], (ys[..., cut] if self.adapter.per_token_labels else ys)

    def _check_block(self, *tensors):
        """Over a mesh, data carry this rank's block of the workers
        (:meth:`shard_batches`), not every worker's rows."""
        for t in tensors:
            if t.shape[0] != self.virtual:
                raise ValueError(f"leading dim {t.shape[0]}: this rank holds {self.virtual} of "
                                 f"the {self.num_workers} workers (shard_batches)")

    def _sync_model_state(self, ctx: CommitCtx, model_state):
        if not self.sync_model_state or not tree_leaves(model_state):
            return model_state
        mean = tree_map(lambda x: ctx.psum(x) / self.num_workers, model_state)
        return tree_where(ctx.mask, mean, model_state)

    def _worker_steps(self, state: TrainState, w: int, xs, ys):
        """Worker ``w`` takes one local step per leading row of ``xs``/``ys``
        (``[steps, batch, ...]``), from and into its slice of ``state``.
        Returns its losses ``[steps]``, metrics ``[steps, n_metrics]`` and,
        with dynamics on, its gradients' squared norms and non-finite counts
        summed over the steps (else None)."""
        worker = lambda tree: tree_map(lambda x: x[w], tree)
        params, opt_state = worker(state.local_params), worker(state.opt_state)
        model_state = worker(state.model_state)
        losses, mets, grad_stats = [], [], None
        for t in range(xs.shape[0]):
            params, opt_state, model_state, loss, met, dstep = self._local_step(
                params, opt_state, model_state, state.rng[w], xs[t], ys[t])
            losses.append(loss)
            mets.append(met)
            if dstep is not None:
                grad_stats = dstep if grad_stats is None else tuple(
                    a + b for a, b in zip(grad_stats, dstep))
        with torch.no_grad():
            for dst, src in ((state.local_params, params), (state.opt_state, opt_state),
                             (state.model_state, model_state)):
                tree_map(lambda d, s: d[w].copy_(s), dst, src)
        return torch.stack(losses), torch.stack(mets), grad_stats

    def _commit(self, state: TrainState, ctx: CommitCtx, dyn=None, center=None) -> TrainState:
        """The rule's commit over all workers, and the model state synced
        under the same mask, written into the state's tensors in place (a
        captured window replays into the same memory).  ``center`` is the
        whole center when the caller has gathered it already; ``dyn`` (the
        window's dynamics) takes the center's squared update as
        ``update_sq``."""
        with torch.no_grad():
            # fsdp: the rule's math runs on the whole center (gathered at
            # use), and this rank keeps its block of the result
            if center is None:
                center = self._fsdp_gather(state.center_params)
            res = self.rule.commit(ctx, state.local_params, center,
                                   state.rule_local, state.center_rule)
            if dyn is not None:  # before the copy below overwrites the center
                dyn["update_sq"] = dynamics_mod.tree_sq_dist(res.center_params, center,
                                                             weights=self._dyn_weights)
            model_state = self._sync_model_state(ctx, state.model_state)
            _copy_into(
                (state.local_params, state.center_params, state.rule_local,
                 state.center_rule, state.model_state),
                (res.local_params, self._fsdp_shard(res.center_params), res.local_state,
                 res.center_state, model_state),
            )
        return state

    # --------------------------------------------------------------- dynamics
    @property
    def _dyn_weights(self):
        """Per parameter leaf, its share of a dynamics sum on this rank (None:
        every leaf whole); the GSPMD engine counts a leaf its model ranks
        all hold whole once across them."""
        return None

    def _model_total(self, *sums):
        """Per-rank dynamics sums as totals over the ranks that split the
        parameters (the GSPMD engine's model axis); as they are here."""
        return list(sums)

    def _rule_dynamics(self, ctx: CommitCtx, center, state: TrainState) -> dict:
        """The rule's pre-commit diagnostics (``UpdateRule.dynamics``)."""
        return self.rule.dynamics(ctx, state.local_params, center, state.rule_local,
                                  state.center_rule)

    def _pre_commit_dynamics(self, state: TrainState, ctx: CommitCtx, grad_stats, staleness):
        """The pre-commit snapshot of this rank's workers, each value ``[v]``:
        the summed gradient stats, non-finite parameters, drift from the
        center, ``staleness`` and the rule's extras (measured before the
        commit rewrites them); ``update_sq`` is set by the commit.  Returns
        the values and the whole center, which the commit reuses."""
        with torch.no_grad():
            w, v = self._dyn_weights, self.virtual
            center = self._fsdp_gather(state.center_params)
            local = state.local_params
            dyn = {
                "grad_sq": grad_stats[0],
                "nonfinite_grads": grad_stats[1],
                "nonfinite_params": dynamics_mod.tree_nonfinite_count(local, keep=1, weights=w),
                "divergence_sq": dynamics_mod.tree_sq_dist(local, center, keep=1, weights=w),
                "staleness": torch.broadcast_to(staleness.to(torch.float32), (v,)),
                "update_sq": torch.zeros((), dtype=torch.float32, device=self.device),
            }
            for key, value in self._rule_dynamics(ctx, center, state).items():
                # a value the rule holds on the host (ADAG's steps in the
                # window, fixed for the window's shape) is filled in on the
                # device: no copy to sync on, and none for a captured window
                # to record from host memory
                if isinstance(value, torch.Tensor):
                    value = value.to(self.device, torch.float32, non_blocking=True)
                else:
                    value = torch.full((), float(value), dtype=torch.float32, device=self.device)
                dyn[key] = torch.broadcast_to(value, (v,))
        return dyn, center

    def _dyn_reduce(self, wins: list) -> dict:
        """Stack the windows' (or steps') dynamics and reduce them to the
        epoch-stats layout, on the host: *global* series ``[T]`` (gradient
        norm and non-finite counts over every worker, the center's update
        norm) and *per-worker* series ``[T, num_workers]`` (divergence,
        staleness, the rule's extras).  One all-reduce for the sums over the
        ranks, one gather for the per-worker series."""
        dyn = {k: torch.stack([w[k] for w in wins]) for k in wins[0]}
        with torch.no_grad():
            sums = [dyn.pop(k).sum(dim=1) for k in ("grad_sq", "nonfinite_grads",
                                                    "nonfinite_params")]
            grad_sq, nf_grads, nf_params = all_reduce_sum(sums, self.group)
            grad_sq, nf_grads, nf_params, divergence_sq, update_sq = self._model_total(
                grad_sq, nf_grads, nf_params, dyn.pop("divergence_sq"), dyn.pop("update_sq"))
            out = {"grad_norm": grad_sq.sqrt(), "update_norm": update_sq.sqrt(),
                   "nonfinite_grads": nf_grads, "nonfinite_params": nf_params}
            worker = {"divergence": divergence_sq.sqrt(), **dyn}
            for key, value in worker.items():
                out[key] = all_gather(value, WORKER_AXIS, 1, self.mesh)
        return {k: v.cpu().numpy() for k, v in out.items()}

    # ---------------------------------------------------------------- window
    def _window_body(self, state: TrainState, xs, ys, do_commit: bool):
        """One window, in place: every worker of this rank takes
        ``xs.shape[1]`` local steps on its own rows of ``xs``/``ys`` (``[v,
        window, batch, ...]``), then (``do_commit``) the rule commits all
        workers.  Returns the window's loss and metrics, averaged over steps
        and summed over this rank's workers, as device tensors, and with
        dynamics on the window's values (:meth:`_pre_commit_dynamics`; else
        None)."""
        window = xs.shape[1]
        loss_sum, mets_sum, grad_stats = 0.0, 0.0, []
        for w in range(self.virtual):
            losses, mets, stats = self._worker_steps(state, w, xs[w], ys[w])
            loss_sum = loss_sum + losses.mean()
            mets_sum = mets_sum + mets.mean(dim=0)
            grad_stats.append(stats)
        dyn = center = None
        if self._dynamics:
            ctx = self._ctx(float(window),
                            torch.full((self.virtual,), do_commit, device=self.device))
            dyn, center = self._pre_commit_dynamics(
                state, ctx, [torch.stack(s) for s in zip(*grad_stats)],
                torch.full((), float(window), device=self.device))
        if do_commit:
            self._commit(state, self._ctx(float(window)), dyn, center)
        return loss_sum, mets_sum, dyn

    def _run_window(self, state: TrainState, xs, ys, do_commit: bool):
        """One window, eager or replayed from its captured graph.  Returns
        the state (the engine's captured state when graphs are on), the
        window's loss and metrics summed over this rank's workers and its
        dynamics values (None with dynamics off)."""
        if not self.use_graphs:
            return (state, *self._window_body(state, xs, ys, do_commit))
        key = ("win", do_commit, tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype)
        return self._replay(key, state, xs, ys,
                            lambda s, x, y: self._window_body(s, x, y, do_commit))

    def _replay(self, key, state: TrainState, xs, ys, body):
        """Replay the captured program ``key`` (capturing ``body(state, x,
        y)`` at its first use) over the engine's captured state, with
        ``xs``/``ys`` copied into its input buffers.  Returns that state and
        copies of the program's loss, metrics and dynamics values (each None
        where the body returns None)."""
        state = self._adopt(state)
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(state, xs, ys, body)
        captured.x.copy_(xs)
        captured.y.copy_(ys)
        for g, twin in zip(state.rng, self._twins or ()):
            # the recomputations draw what this replay's forwards draw
            twin.set_state(g.get_state())
        captured.graph.replay()
        captured.replays += 1
        self.graph_stats["replays"] += 1
        dyn = None if captured.dyn is None else {k: v.clone() for k, v in captured.dyn.items()}
        mets = None if captured.mets is None else captured.mets.clone()
        return state, captured.loss.clone(), mets, dyn

    def _adopt(self, state: TrainState) -> TrainState:
        """The state every captured window reads and writes: ``state`` itself
        the first time; later, when ``state`` holds other tensors (a
        restore, a fresh init), its values and generator states are copied
        into the captured ones."""
        static = self._static
        if static is None:
            # a state object of its own: the caller's is consumed (and, with
            # the sanitizer on, poisoned) when the epoch ends
            self._static = state.replace()
            return self._static
        if _state_key(state) != _state_key(static):
            with torch.no_grad():
                _copy_into(_state_trees(static), _state_trees(state))
            for mine, theirs in zip(static.rng, state.rng):
                mine.set_state(theirs.get_state())
        return static.replace(epoch=state.epoch)

    def _capture(self, state: TrainState, xs, ys, body) -> _Captured:
        """Capture ``body(state, x, y)``, one window or one step of the
        staleness simulation, as a CUDA graph over ``state``'s tensors (and
        the simulation's clock) and static input buffers ``x``/``y``.  A
        warm-up runs first on a side stream (lazy initialisation must not
        happen inside a capture) and is undone: the state's values, the
        clock and the generators are restored.  Each worker's dropout
        generator is registered with the graph, so every replay draws fresh
        masks; with ``remat``, so is its twin (:func:`_remat_apply`).  Over
        a mesh, the communicator of every axis group the window uses is
        made first (:func:`~distkeras_tpu_torch.utils.graphs.warm_up_groups`),
        and the collectives are recorded into the graph.  The process-wide
        capture lock is held throughout.  A failed capture raises: nothing
        falls back to eager."""
        from distkeras_tpu_torch.ops import (
            flash_attention,
            flash_attention_bwd_dkv,
            flash_attention_bwd_dq,
        )

        x, y = xs.clone(), ys.clone()
        leaves = tree_leaves(_state_trees(state)) + list((self._clock or {}).values())
        with graphs.CAPTURE_LOCK:
            # NCCL records a collective only over a communicator that exists
            graphs.warm_up_groups((self.group, *self._row_groups), self.device)
            saved = [t.clone() for t in leaves]
            saved_rng = [g.get_state() for g in state.rng]
            graphs.warm_up(lambda: body(state, x, y), self.device)
            with torch.no_grad():
                for t, v in zip(leaves, saved):
                    t.copy_(v)
            for g, v in zip(state.rng, saved_rng):
                g.set_state(v)
            del saved
            if self.remat and self._twins is None:
                self._twins = [g.clone_state() for g in state.rng]
            graph = torch.cuda.CUDAGraph()
            for g in (*state.rng, *(self._twins or ())):
                graph.register_generator_state(g)
            counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
            before = [c.launches for c in counters]
            sent = [transport_stats[n] for n in TRANSPORTS]
            self._twin_of = {id(g): t for g, t in zip(state.rng, self._twins or ())}
            try:
                with graphs.capturing(graph):
                    loss, mets, dyn = body(state, x, y)
            finally:
                self._twin_of = {}
        # kernels launched and collectives run inside the graph at each
        # replay, by wrapper and by transport
        ticks = {c.__name__: c.launches - b for c, b in zip(counters, before)}
        ticks.update((n, transport_stats[n] - b) for n, b in zip(TRANSPORTS, sent))
        self.graph_stats["captures"] += 1
        return _Captured(graph, x, y, loss, mets, dyn, ticks)

    def graph_launches(self) -> dict:
        """Kernel launches and collectives of the captured windows since the
        cache was last cleared, by wrapper (B1-B3) and by transport (the
        ``TRANSPORTS`` of :data:`~distkeras_tpu_torch.parallel.mesh.
        transport_stats`), as ``(capture ticks, runs)``: a counter ticks once
        per site at capture, which launches nothing, and each replay runs
        every recorded kernel and collective once, so the runs are the ticks
        times the replays."""
        out: dict = {}
        for captured in self._graphs.values():
            for name, ticks in captured.ticks.items():
                t, n = out.get(name, (0, 0))
                out[name] = (t + ticks, n + ticks * captured.replays)
        return out

    def _device_periods(self) -> torch.Tensor:
        """This rank's commit periods on the device, copied once per schedule
        (a caller may set ``commit_schedule`` between epochs): outside the
        epoch's device work, where a copy would be a blocking transfer."""
        schedule = np.asarray(self.commit_schedule, np.int32)
        key = schedule.tobytes()
        if self._periods is None or self._periods[0] != key:
            self._periods = (key, torch.as_tensor(schedule[self.workers], device=self.device))
        return self._periods[1]

    def _stale_clock(self, periods: torch.Tensor) -> dict:
        """The staleness simulation's clock at the start of an epoch: step
        0, no step since any worker's last commit, this rank's commit
        ``periods``.  Kept in the same device tensors from epoch to epoch,
        which a captured step reads and advances."""
        clock = self._clock
        if clock is None:
            clock = self._clock = {
                "t": torch.zeros((), dtype=torch.int64, device=self.device),
                "since": torch.zeros(self.virtual, dtype=torch.int32, device=self.device),
                "periods": torch.zeros_like(periods),
            }
        clock["t"].zero_()
        clock["since"].zero_()
        clock["periods"].copy_(periods)
        return clock

    def _stale_step(self, state: TrainState, xs, ys):
        """One step of the staleness simulation, in place: every worker of
        this rank takes one local step on its rows of ``xs``/``ys`` (``[v,
        1, batch, ...]``), then one commit runs over all of them (across
        the ranks too) with the mask ``(t + 1) % period == 0`` and each
        worker's steps since its last commit, read from the clock
        (:meth:`_stale_clock`), which then advances.  Returns the step's
        loss summed over this rank's workers, no metrics (None) and with
        dynamics on the step's values (the effective staleness is each
        worker's steps since its last commit; else None)."""
        clock = self._clock
        step = [self._worker_steps(state, w, xs[w], ys[w]) for w in range(self.virtual)]
        since = clock["since"] + 1
        mask = (clock["t"] + 1) % clock["periods"] == 0
        ctx = self._ctx(since, mask)
        dyn = center = None
        if self._dynamics:
            dyn, center = self._pre_commit_dynamics(
                state, ctx, [torch.stack(s) for s in zip(*(r[2] for r in step))], since)
        self._commit(state, ctx, dyn, center)
        with torch.no_grad():
            clock["since"].copy_(torch.where(mask, 0, since))
            clock["t"].add_(1)
        return torch.cat([r[0] for r in step]).sum(), None, dyn

    def _run_stepwise(self, state: TrainState, xs, ys, periods: torch.Tensor):
        """The staleness simulation over ``xs``/``ys`` shaped ``[v, n_steps,
        batch, ...]``, one step (:meth:`_stale_step`) after another, eager
        or, with graphs on, replayed from one captured step.  ``periods`` is
        :meth:`_device_periods`.  Returns the state (the engine's captured
        state when graphs are on), the per-step loss ``[n_steps]``, averaged
        over all workers, and with dynamics on each step's values."""
        self._stale_clock(periods)
        losses, steps_dyn = [], []
        for t in range(xs.shape[1]):
            x, y = xs[:, t:t + 1], ys[:, t:t + 1]
            if self.use_graphs:
                key = ("step", tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
                state, loss, _, dyn = self._replay(key, state, x, y, self._stale_step)
            else:
                loss, _, dyn = self._stale_step(state, x, y)
            losses.append(loss)
            if dyn is not None:
                steps_dyn.append(dyn)
        return state, self._mean_over_workers(torch.stack(losses))[0], steps_dyn

    # ----------------------------------------------------------------- epoch
    def shard_batches(self, xs: np.ndarray, ys: np.ndarray, whole: bool = False):
        """Epoch data onto the device, as tensors of the arrays' dtypes:
        this rank's block of the workers, or with ``whole=True`` every
        worker's rows (what ``run_epochs``' reshuffle permutes over a mesh
        of several ranks); under sequence parallelism, of those rows this
        rank's block of the sequence."""
        if not whole:
            xs, ys = xs[self.workers], ys[self.workers]
        xs, ys = self._seq_block(xs, ys)
        with telemetry.trace.span("h2d", phase="h2d", bytes=int(xs.nbytes + ys.nbytes)):
            return (torch.from_numpy(np.ascontiguousarray(xs)).to(self.device),
                    torch.from_numpy(np.ascontiguousarray(ys)).to(self.device))

    def _run_windows(self, state: TrainState, xs, ys):
        """Every window of ``xs``/``ys`` (``[v, n_windows, window, batch,
        ...]``) in turn.  Returns the state and the per-window loss
        ``[n_windows]`` and metrics ``[n_windows, n_metrics]``, averaged
        over all workers, on the device, and each window's dynamics values
        (None with dynamics off); nothing is read back."""
        do_commit = self.rule.communication_window > 0
        losses, mets, dyns = [], [], []
        for i in range(xs.shape[1]):
            state, loss, met, dyn = self._run_window(state, xs[:, i], ys[:, i], do_commit)
            losses.append(loss)
            mets.append(met)
            dyns.append(dyn)
        loss, mets = self._mean_over_workers(torch.stack(losses), torch.stack(mets))
        return state, loss, mets, dyns

    def run_epoch(self, state: TrainState, xs, ys, *, sync_telemetry: bool = True):
        """Run one epoch over ``xs``/``ys`` shaped ``[num_workers,
        n_windows, window, batch, ...]`` (uniform windows) or
        ``[num_workers, n_steps, batch, ...]`` (staleness simulation); over a
        mesh, this rank's block of that leading dim (:meth:`shard_batches`).
        Returns the new state and the epoch's stats as numpy: ``loss``
        ``[n_windows]`` and ``metrics`` ``[n_windows, n_metrics]``, each
        averaged over the window's steps and the workers; or, simulating
        staleness, ``loss`` ``[n_steps]`` averaged over the workers and no
        metrics (``[0]``), as the JAX engine's stepwise program returns;
        with dynamics on, also ``dynamics`` (see the module docstring).
        The stats are read back once, at the end.

        With telemetry on and ``sync_telemetry`` (the default), the epoch
        runs inside ``window``, ``step`` (through the stats' read-back) and
        ``commit`` (the residual wait for the center) spans, as the JAX
        engine's telemetry dispatch records them; ``sync_telemetry=False``
        records none."""
        self._check_block(xs, ys)
        if not (sync_telemetry and telemetry.enabled()):
            return self._epoch(state, xs, ys)
        with telemetry.trace.span("window", windows=int(xs.shape[1])):
            with telemetry.trace.span("step", phase="step"):
                state, stats = self._epoch(state, xs, ys)
            with telemetry.trace.span("commit", phase="commit"):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        return state, stats

    @contextlib.contextmanager
    def _dispatch(self, state: TrainState):
        """With the sanitizer on, the device work of one run (every launch of
        an epoch, or of ``run_epochs``' epochs) under the transfer guard, and
        then the consumed input ``state`` poisoned, as the JAX engine's
        ``_dispatch`` guards its jitted dispatch and poisons the donated
        state.  The caller builds the returned state inside the block (its
        fields are read there) and reads the stats back after it.  Off:
        nothing at all."""
        if not self._sanitize:
            yield
            return
        with sanitizer_mod.transfer.guard("epoch_dispatch"):
            yield
        sanitizer_mod.donation.poison(state, label="epoch state (consumed in place)")

    def _epoch(self, state: TrainState, xs, ys):
        mets = None
        periods = None if self.commit_schedule is None else self._device_periods()
        with self._dispatch(state):
            if periods is not None:
                new, losses, dyns = self._run_stepwise(state, xs, ys, periods)
            else:
                new, losses, mets, dyns = self._run_windows(state, xs, ys)
            new = new.replace(epoch=new.epoch + 1)
        # the read-back follows the dispatch, outside the guard
        stats = {"loss": losses.cpu().numpy(),
                 "metrics": np.zeros((0,), np.float32) if mets is None else mets.cpu().numpy()}
        if self._dynamics:
            stats["dynamics"] = self._dyn_reduce(dyns)
        return new, stats

    def run_epochs(self, state: TrainState, xs, ys, num_epochs: int, *,
                   shuffle_seed: Optional[int] = None):
        """Run ``num_epochs`` epochs over in-memory data with one read-back
        of the stats, at the end.

        With ``shuffle_seed=None`` this is ``num_epochs`` calls of
        :meth:`run_epoch`, bit for bit.  With a seed, each epoch first
        permutes the flattened step stream (workers x windows x window x
        batch) on the card by :func:`epoch_permutation`, keyed by
        ``(shuffle_seed, epoch)``, so a resumed run continues the same
        stream.  As in the JAX engine, the permutation acts on the padded
        stream: when the data do not divide evenly, the same wrap-pad
        duplicates recur every epoch.  Stats leaves concatenate over the
        epochs exactly like consecutive ``run_epoch`` results.  Uniform
        windows only: the staleness simulation runs per epoch.

        Over a mesh of several ranks the permutation mixes every worker's
        rows, so a reshuffle needs the whole epoch on every rank
        (``shard_batches(..., whole=True)``); every rank takes rank 0's
        permutation (a broadcast) and its own block of the result."""
        if self.commit_schedule is not None:
            raise ValueError(
                "run_epochs runs uniform windows; the staleness simulation "
                "dispatches per epoch (run_epoch)"
            )
        num_epochs = int(num_epochs)
        if num_epochs < 1:
            raise ValueError(f"num_epochs must be >= 1, got {num_epochs}")
        if shuffle_seed is None:
            self._check_block(xs, ys)
        elif xs.shape[0] != self.num_workers:
            raise ValueError(
                "the reshuffle permutes every worker's rows: pass the whole epoch "
                "(shard_batches(xs, ys, whole=True))"
            )
        n_total = int(np.prod(xs.shape[:4]))
        local_shape = (self.virtual,) + tuple(xs.shape[1:4])
        losses, mets, dyns = [], [], []
        with self._dispatch(state):  # the caller's state, poisoned at the end
            for _ in range(num_epochs):
                xs_e, ys_e = xs, ys
                if shuffle_seed is not None:
                    perm = epoch_permutation(shuffle_seed, state.epoch, n_total, xs.device)
                    perm = self._from_rank0(perm.to(xs.device))
                    # this rank's rows of the permuted stream
                    perm = perm.view(self.num_workers, -1)[self.workers].reshape(-1)
                    xs_e = xs.reshape((n_total,) + xs.shape[4:])[perm].reshape(
                        local_shape + xs.shape[4:])
                    ys_e = ys.reshape((n_total,) + ys.shape[4:])[perm].reshape(
                        local_shape + ys.shape[4:])
                state, loss, met, dyn = self._run_windows(state, xs_e, ys_e)
                state = state.replace(epoch=state.epoch + 1)
                losses.append(loss)
                mets.append(met)
                dyns += dyn
        stats = {"loss": torch.cat(losses).cpu().numpy(), "metrics": torch.cat(mets).cpu().numpy()}
        if self._dynamics:
            stats["dynamics"] = self._dyn_reduce(dyns)
        return state, stats

    def clear_program_cache(self, keep_multi: Optional[tuple] = None) -> None:
        """Drop the captured windows (the JAX engine's compiled epoch
        programs) and the state they were captured over; state and data
        tensors are unaffected, and the next window captures anew.

        ``keep_multi`` is accepted for the JAX engine's signature, where it
        names the ``(num_epochs, shuffle_seed)`` of a multi-epoch program
        to keep.  Here ``run_epochs`` has no program of its own: it replays
        the same window graphs as ``run_epoch``, so there is nothing to
        keep, and every graph is dropped whatever ``keep_multi`` says."""
        self._graphs.clear()
        self._static = None
        self._twins = None
        self.graph_stats = {"captures": 0, "replays": 0}

    # ------------------------------------------------------------- streaming
    def stream_put(self, block):
        """Copy one streamed window block ``(xs, ys)`` shaped ``[v, window,
        batch, ...]`` (this rank's workers, ``v = num_workers`` on one rank)
        to the card, as ``[v, 1, window, batch, ...]`` tensors: the copy
        half of the streaming path, which the
        :class:`~distkeras_tpu_torch.datapipe.PrefetchRing` runs on its
        producer thread.

        Float features go over in the compute dtype (the local step's first
        act is that cast, so it changes no value, and bf16 halves the
        bytes); blocks from the fused native bf16 gather arrive in it.  On
        a card each leaf goes through a pinned host buffer, copied with
        ``non_blocking=True`` on a copy stream; a pinned buffer is written
        again only once its previous copy has landed (its event), and the
        block carries the event the compute stream waits on before use."""
        xs, ys = self._seq_block(*block)  # this rank's sequence block alone crosses
        xs, ys = (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(t))
                  for t in (xs, ys))
        self._check_block(xs, ys)
        cast = self.compute_dtype
        if cast is not None and xs.is_floating_point():
            xs = xs.to(cast)
        if self.device.type != "cuda":
            return _PutBlock((xs[:, None], ys[:, None]), None)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        out = []
        with torch.cuda.stream(self._copy_stream):
            for t in (xs, ys):
                key = (tuple(t.shape), t.dtype)
                slots = self._pinned.setdefault(key, [])
                if len(slots) < _PINNED_SLOTS:
                    slot = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True), None]
                    slots.append(slot)
                else:
                    slot = slots.pop(0)
                    slots.append(slot)
                    slot[1].synchronize()  # its last copy has landed
                slot[0].copy_(t)
                dev = slot[0].to(self.device, non_blocking=True)
                slot[1] = torch.cuda.Event()
                slot[1].record(self._copy_stream)
                out.append(dev[:, None])
        return _PutBlock(out, slot[1])

    def run_epoch_streaming(self, state: TrainState, window_iter, prefetch: int = 2,
                            strict_link=None, on_window=None):
        """Run one epoch from an iterator of per-window blocks ``(xs, ys)``
        shaped ``[num_workers, window, batch, ...]``, over a mesh this
        rank's block of them (see
        :func:`distkeras_tpu_torch.data.epoch_window_iter` and its
        ``workers``).

        The whole-epoch array never exists on the card: each block is put
        as it is consumed, and as the card runs asynchronously, the next
        block's host gather and copy overlap the current window's compute.
        Blocks on the card are bounded at about ``2 x prefetch``: up to
        ``prefetch`` put blocks wait in the buffer while up to ``prefetch``
        windows are in flight (the loop waits on the window put
        ``prefetch`` windows ago).  Each window runs as :meth:`run_epoch`
        runs it, so the trajectory is the in-memory one bit for bit.

        **Link guardrail**: overlap only hides source latency while the
        source is faster than the card.  The loop times the pulls it makes
        (no added sync), and when the steady-state unhideable source share
        exceeds 25 % it warns once, or raises with ``strict_link=True``
        (default: ``DISTKERAS_STREAMING_STRICT``).  The report is kept on
        ``self.last_stream_report``.

        ``on_window(state, n)`` fires after window ``n`` (1-based) was
        launched, with the live state (its epoch counter still the epoch
        being trained): the trainers' mid-epoch checkpoint hook.
        ``window_iter.close()``, where it exists (generators, the
        prefetch ring), runs on every exit path."""
        if self.commit_schedule is not None:
            raise ValueError(
                "streaming runs uniform windows; the staleness simulation "
                "needs the whole epoch in one program (run_epoch)"
            )
        if strict_link is None:
            strict_link = os.environ.get(
                "DISTKERAS_STREAMING_STRICT", "").lower() not in ("", "0", "false")
        it = iter(window_iter)
        consumed = state
        buf = deque()
        losses, mets, dyns, done_events = [], [], [], []
        steps_list = []  # per-window step counts (ragged tail weighting)
        n_windows = 0
        depth = max(1, prefetch)
        do_commit = self.rule.communication_window > 0
        src_seconds = 0.0
        steady_src = 0.0
        steady_t0 = None

        def pull():
            nonlocal src_seconds, steady_src
            t0 = time.perf_counter()
            block = next(it, None)
            if block is not None:
                if not isinstance(block, _PutBlock):
                    block = self.stream_put(block)
                steps_list.append(int(block[0].shape[2]))
            dt = time.perf_counter() - t0
            src_seconds += dt
            if steady_t0 is not None:
                steady_src += dt
            return block

        try:
            while True:
                if not buf:
                    block = pull()
                    if block is None:
                        break
                    buf.append(block)
                block = buf.popleft()
                if block.ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(block.ready)
                xs, ys = block
                with telemetry.trace.span("window_dispatch", window=n_windows), \
                        self._guard_window():
                    state, loss, met, dyn = self._run_window(state, xs[:, 0], ys[:, 0],
                                                             do_commit)
                if self.device.type == "cuda":
                    for t in block:
                        t.record_stream(torch.cuda.current_stream(self.device))
                    done = torch.cuda.Event()
                    done.record()
                    done_events.append(done)
                n_windows += 1
                losses.append(loss)
                mets.append(met)
                dyns.append(dyn)
                if on_window is not None:
                    on_window(state, n_windows)
                # backpressure: wait on the window launched ``depth`` windows ago
                if n_windows > depth:
                    if done_events:
                        with telemetry.trace.span("window_wait", phase="step",
                                                  window=n_windows - 1 - depth):
                            done_events[n_windows - 1 - depth].synchronize()
                    if steady_t0 is None:
                        steady_t0 = time.perf_counter()
                while len(buf) < depth:
                    block = pull()
                    if block is None:
                        break
                    buf.append(block)
        finally:
            close = getattr(window_iter, "close", None)
            if close is not None:
                close()
        if not losses:
            raise ValueError("empty window iterator")
        self._report_stream_link(src_seconds, steady_src, steady_t0, n_windows, strict_link,
                                 time.perf_counter())
        with self._guard_window():
            loss, mets = self._mean_over_workers(torch.stack(losses), torch.stack(mets))
        out = state.replace(epoch=state.epoch + 1)
        if self._sanitize:
            sanitizer_mod.donation.poison(consumed, label="epoch state (consumed in place)")
        stats = {"loss": loss.cpu().numpy(),
                 "metrics": mets.cpu().numpy(),
                 # per-window step counts, so the history can weight a ragged
                 # tail window by its steps
                 "window_steps": np.asarray(steps_list, np.int64)}
        if self._dynamics:
            stats["dynamics"] = self._dyn_reduce(dyns)
        return out, stats

    def _guard_window(self):
        """The transfer guard around one streamed window's device work (the
        JAX engine guards each window's dispatch); a null context with the
        sanitizer off.  Pulls, the callback and the backpressure wait stay
        outside, as they are outside JAX's dispatch."""
        if not self._sanitize:
            return contextlib.nullcontext()
        return sanitizer_mod.transfer.guard("epoch_dispatch")

    def _report_stream_link(self, src_seconds, steady_src, steady_t0, n_windows, strict_link,
                            now):
        """Judge the last streamed epoch's source/compute balance.

        Over the steady state (first backpressure wait to the epoch's end)
        the loop alternates pulling blocks and waiting on the card; source
        time hidden behind compute shows up as wall time not spent in
        pulls, so ``unhideable = steady_src - (steady_wall - steady_src)``
        is the part of the source cost the card waited out.  A share above
        0.25 of the steady wall time means the source, not the model,
        bounds throughput: warn once per engine, or raise in strict mode.
        Epochs too short to reach backpressure measure nothing."""
        steady_wall = (now - steady_t0) if steady_t0 is not None else 0.0
        if steady_wall > 0:
            hidden = max(0.0, steady_wall - steady_src)
            unhideable = max(0.0, steady_src - hidden)
            fraction = unhideable / steady_wall
        else:
            fraction = 0.0
        link_bound = fraction > 0.25
        self.last_stream_report = {
            "windows": n_windows,
            "source_seconds": src_seconds,
            "steady_wall_seconds": steady_wall,
            "steady_source_seconds": steady_src,
            "unhideable_fraction": fraction,
            "link_bound": link_bound,
        }
        if not link_bound:
            return
        msg = (
            f"streaming source is the bottleneck: {fraction:.0%} of "
            f"steady-state wall time ({steady_src:.2f}s of "
            f"{steady_wall:.2f}s over {n_windows} windows) is source/"
            "transfer latency no prefetch depth can hide — the card is "
            "idling on the source.  Stage the dataset closer (local disk / "
            "in-memory), widen the link, or grow per-window compute "
            "(larger window/batch).  See engine.last_stream_report."
        )
        if strict_link:
            raise RuntimeError(msg)
        if not self._link_warned:
            self._link_warned = True
            warnings.warn(msg, RuntimeWarning, stacklevel=3)

    # ------------------------------------------------------------- read-outs
    def _worker_mean(self, tree):
        """The mean over all workers of each leaf of a per-worker tree: on
        one rank ``mean(dim=0)``; over a mesh the local sums, one
        all-reduce, divided by ``num_workers``."""
        if self.group is None:
            return tree_map(lambda x: x.mean(dim=0), tree)
        summed = iter(all_reduce_sum([x.sum(dim=0) for x in tree_leaves(tree)], self.group))
        return tree_map(lambda _: next(summed) / self.num_workers, tree)

    def average_workers(self, state: TrainState):
        """One-shot synchronous weight average (AveragingTrainer's final step)."""
        mean = self._worker_mean(state.local_params)
        mean_p = tree_map(lambda x: x.clone(), self._fsdp_shard(mean)) if self.fsdp else mean
        return state.replace(center_params=mean_p), self.final_model_state(state)

    def final_model_state(self, state: TrainState):
        """Model state for the returned model: the mean over workers (the
        first worker's for integer buffers, which mesh rank 0 holds)."""
        if self.group is None:
            return tree_map(lambda x: x.mean(dim=0) if x.is_floating_point() else x[0].clone(),
                            state.model_state)
        leaves = tree_leaves(state.model_state)
        sums = all_reduce_sum([x.sum(dim=0) for x in leaves if x.is_floating_point()],
                              self.group)
        means = iter(t / self.num_workers for t in sums)
        firsts = iter(broadcast([x[0] for x in leaves if not x.is_floating_point()], 0,
                                self.group))
        return tree_map(lambda x: next(means) if x.is_floating_point() else next(firsts).clone(),
                        state.model_state)

    def worker_slice(self, tree, index: int):
        """One worker's copy of per-worker state, on every rank: over a mesh
        the rank that owns worker ``index`` broadcasts it (every rank makes
        the call)."""
        if self.group is None:
            return tree_map(lambda x: x[index].clone(), tree)
        owner, local = divmod(int(index), self.virtual)
        leaves = [x[local].clone() for x in tree_leaves(tree)]
        got = iter(t.clone() for t in broadcast(leaves, owner, self.group))
        return tree_map(lambda _: next(got), tree)

    def gather_center(self, state: TrainState):
        """The center parameters (one copy on this engine's device, the same
        on every rank of a mesh); under fsdp gathered whole from the fsdp
        shards, a collective every rank of the grid takes part in."""
        with torch.no_grad():
            return self._fsdp_gather(state.center_params)

