"""Pipeline parallelism: a microbatch pipeline over the ``stages`` axis of a
``(workers, stages)`` grid.

The port of :mod:`distkeras_tpu.parallel.pipeline`.  The ranks form
:func:`~distkeras_tpu_torch.parallel.mesh.make_mesh_grid`'s ``(world / S,
S)`` grid (mesh rank ``(w, s)`` is global rank ``w * S + s``): data
parallelism with the windowed engine's commits across ``workers``, one
worker a workers rank, and the stages of a staged model
(:mod:`~distkeras_tpu_torch.models.staged`) down ``stages``:

* **Placement.**  Stage rank ``s`` holds block ``[s:s+1]`` of every staged
  ``blocks`` leaf (``[1, per_stage, ...]``): of the center, of its worker's
  parameters and of the optimizer and rule states built from them.  The
  embedding and the head are whole on every stage rank, or, with
  ``fsdp=True``, split ``1/S`` over the stages on
  :func:`~distkeras_tpu_torch.parallel.engine.zero_shard_dim`'s dim and
  gathered at use.
* **Schedule.**  A step's batch splits into ``M`` microbatches, which run
  through ``M + S - 1`` ticks: at tick ``t`` stage ``s`` runs microbatch
  ``t - s`` when there is one (stage 0 takes it from the embedding, the
  last stage puts its output through the head), and between ticks every
  stage hands its activation on with a ring shift over ``stages``
  (:func:`~distkeras_tpu_torch.parallel.mesh.ppermute`).  The JAX package
  runs every stage on every tick and masks the result; with one process a
  rank, a rank here skips its bubble ticks, which changes no value.  The
  last stage's outputs reach every stage by
  :func:`~distkeras_tpu_torch.parallel.mesh.broadcast_from_last`, a psum
  whose backward keeps the cotangent on the last stage: every rank computes
  the same loss, and exactly one copy of it drives the backward.
* **Backward.**  JAX differentiates its scheduled forward, and the
  ``ppermute`` transposes to the reverse shift.  Here each rank records its
  ticks' graphs and runs the reverse schedule itself: ``M + S - 1`` ticks
  from the last, each microbatch's cotangent handed back one stage by the
  reverse shift, so that every rank takes part in every collective in the
  same order and no collective over ``stages`` runs inside autograd.  The
  embedding's gradient lands on stage 0 and the head's on the last stage,
  and :meth:`PipelineEngine._sync_grads` sums them over ``stages``; under
  ``fsdp=True`` the sum is a reduce-scatter, each stage keeping its block.
  ``remat=True`` recomputes a tick's stage (and head) on the backward,
  which runs no collective over ``stages``.

* **Pipeline x tensor parallelism** (``tp_shards=k``): the grid is ``(world
  / (S k), S, k)``, ``(workers, stages, model)`` (mesh rank ``(w, s, m)`` is
  global rank ``(w S + s) k + m``).  Each ``blocks`` leaf is further split
  over ``model`` by JAX's ``_tp_tail``: the GSPMD engine's
  :func:`~distkeras_tpu_torch.parallel.gspmd.default_tp_dim` on the
  per-stage shape in flax's layout (:func:`~distkeras_tpu_torch.parallel.
  gspmd.leaf_views` of the staged model's block template), so that at
  widths that split every staged leaf splits, its 1-D ones too; the
  embedding and the head stay whole over ``model``.  Each tick's stage runs
  inside the GSPMD engine's :class:`~distkeras_tpu_torch.parallel.gspmd.
  _TensorParallel` mode: column-parallel products, a split leaf gathered
  whole at any other use.  The model ranks of a stage run the same ticks,
  so the mode's collectives, and those its backward runs inside the
  reverse schedule's ``torch.autograd.grad``, pair up; the head and the
  embedding run no collective.
* **Pipeline x sequence parallelism** (``seq_shards=k``, a staged model
  built with ``seq_axis="seq"``): the grid is ``(workers, stages, seq)``;
  each rank takes its block of the sequence (and of per-token labels,
  :meth:`shard_batches`), embeds it at its offset, and the blocks run ring
  attention over ``seq`` in every tick; a classifier's pooled outputs are
  ``pmean``'d over ``seq``, per-token outputs stay block-local, and every
  gradient is ``pmean``'d over ``seq`` after the stage sum (the windowed
  engine's rule).  ``tp_shards > 1`` with ``seq_shards > 1`` is refused, as
  in JAX.

* **Captured windows** (``unroll`` other than 1 on a card): each window is
  one CUDA graph, as the windowed engine captures it
  (:meth:`~distkeras_tpu_torch.parallel.engine.WindowedEngine._capture`),
  with every collective of the schedule inside: the fsdp gather of the
  embedding and the head, each tick's activation shift (zeros on a bubble
  tick) and each reverse tick's cotangent shift, ``broadcast_from_last``
  and a classifier's ``pmean`` over seq, the stage-axis sum (or fsdp's
  reduce-scatter) and the seq-axis mean of the gradients, the model axis's
  gathers and psums inside each tick and each ``torch.autograd.grad``, and
  the commit over ``workers``.  A rank's ticks are fixed on the host by its
  stage index, so the capture fixes them too.  Every axis group must run
  NCCL (the windowed engine refuses gloo by name); every rank warms each
  group, captures the same windows in the same order and replays them in
  lockstep.

Staged blocks carry no dropout, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from distkeras_tpu_torch.algorithms.base import UpdateRule
from distkeras_tpu_torch.models.adapter import ModelAdapter
from distkeras_tpu_torch.ops.optimizers import apply_updates
from distkeras_tpu_torch.parallel.engine import (
    TrainState,
    WindowedEngine,
    zero_shard_dim,
)
from distkeras_tpu_torch.parallel.gspmd import (
    _Placed,
    _TensorParallel,
    default_tp_dim,
    dims_like,
    leaf_views,
)
from distkeras_tpu_torch.parallel.mesh import (
    PP_AXIS,
    SEQ_AXIS,
    TP_AXIS,
    WORKER_AXIS,
    _reduce_scatter,
    all_gather,
    all_reduce_sum,
    axis_group,
    bind_mesh,
    broadcast_from_last,
    make_mesh_grid,
    pmean,
    ppermute,
    resolve_axis,
)
from distkeras_tpu_torch.utils.pytree import tree_leaves, tree_map

__all__ = ["PP_AXIS", "PipelineEngine"]


def _named_optimizer(opt) -> bool:
    return isinstance(opt, str) or (isinstance(opt, tuple) and len(opt) == 2
                                    and isinstance(opt[0], str))


@dataclasses.dataclass
class _Tape:
    """What a step's forward keeps for its backward on this rank: the
    embedding's output (stage 0), each microbatch's ``(input, output)`` in
    microbatch order, and the last stage's outputs before the broadcast."""

    h0: Optional[torch.Tensor] = None
    ticks: list = dataclasses.field(default_factory=list)
    outs: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _PipelinedView(ModelAdapter):
    """The *pipelined* executor of a staged model on this stage rank.

    ``apply`` runs inside :func:`~distkeras_tpu_torch.parallel.mesh.bind_mesh`
    over a mesh with the ``stages`` axis, on this rank's parameters: the
    ``blocks`` leaves its stage's ``[1, blocks_per_stage, ...]`` (with
    ``tp_dims``, its model block of them), the embedding and head whole or
    (``shard_dims``, set by the engine under ``fsdp=True``) split over the
    stages and gathered here.  Its outputs are the staged model's
    sequential ``apply``'s, on every stage rank; with a seq axis, of this
    rank's sequence block."""

    staged: Any
    microbatches: int
    outputs_logits: bool = True
    #: {"embed": name -> dim, "head": name -> dim}: the dim each non-staged
    #: leaf is split on over the stages (-1: whole), or None
    shard_dims: Any = None
    #: name -> dim: the dim each ``blocks`` leaf is split on over the model
    #: axis (-1: whole), or None without tensor parallelism
    tp_dims: Any = None

    @property
    def per_token_labels(self) -> bool:
        return bool(getattr(self.staged, "per_token_labels", False))

    def init(self, generator, sample_input):
        raise RuntimeError("init via the staged adapter, not the pipelined view")

    def gathered(self, params):
        """``params`` with the stage-split embed/head leaves gathered whole
        (no gradient: the engine reduces theirs itself)."""
        if not self.shard_dims:
            return params
        out = dict(params)
        with torch.no_grad():
            for key, dims in self.shard_dims.items():
                out[key] = {n: x if dims[n] < 0 else all_gather(x, PP_AXIS, dims[n])
                            for n, x in params[key].items()}
        return out

    def apply(self, params, state, inputs, training=False, generator=None):
        del training, generator  # the schedule is deterministic; no dropout
        with torch.no_grad():
            outs, _ = self.forward(self.gathered(params), inputs)
        return outs, state

    # ------------------------------------------------------------ schedule
    def _tick(self, blocks, head, x_in, last: bool):
        """One tick's stage (and the head on the last stage) on the stage
        leaves ``blocks`` (``[1, blocks_per_stage, ...]``); with a model
        axis inside :class:`_TensorParallel`, entered here so that remat's
        recomputation places the leaves again."""
        with self._tensor_parallel(blocks):
            y = self.staged.stage({k: v[0] for k, v in blocks.items()}, x_in)
        return self.staged.head(head, y) if last else y

    def _tensor_parallel(self, blocks):
        """The mode that runs a stage over the model axis, the split leaves
        keyed by the stage leaves themselves; a null context without one."""
        if not self.tp_dims:
            return contextlib.nullcontext()
        size = resolve_axis(TP_AXIS).size
        placed = {}
        for name, v in blocks.items():
            d = self.tp_dims[name]
            if d >= 0:
                whole = list(v.shape)
                whole[d] *= size
                placed[id(v)] = (v, _Placed(d, torch.Size(whole)))
        return _TensorParallel(placed, TP_AXIS, None)

    def forward(self, params, inputs, keep: bool = False, remat: bool = False):
        """The scheduled forward on this rank's (whole) ``params``: the
        outputs of all ``microbatches``, ``[batch, ...]``, on every stage
        rank, and the :class:`_Tape` of this rank's ticks (their graphs when
        ``keep``; with ``remat`` each tick is recomputed on the backward)."""
        ax = resolve_axis(PP_AXIS)
        S, s, M = ax.size, ax.index, self.microbatches
        B = inputs.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        mb, seq = B // M, inputs.shape[1]
        last = s == S - 1
        seq_axis = getattr(self.staged, "seq_axis", None)
        blocks, head = params["blocks"], params["head"]
        dtype = params["embed"]["tok_embed.weight"].dtype
        device = params["embed"]["tok_embed.weight"].device
        act = (mb, seq, self.staged.dim)
        tape = _Tape()
        micro = None
        if s == 0:
            # with a seq axis, this rank's block starts at its index times
            # the block's length
            offset = 0 if seq_axis is None else resolve_axis(seq_axis).index * seq
            tape.h0 = self.staged.embed(params["embed"], inputs, offset=offset)
            micro = [m.requires_grad_(keep) for m in tape.h0.detach().split(mb)]
        tick = functools.partial(self._tick, last=last)
        buf = None
        for t in range(M + S - 1):
            j, out = t - s, None
            if 0 <= j < M:
                x_in = micro[j] if s == 0 else buf.requires_grad_(keep)
                if keep and remat:
                    out = torch.utils.checkpoint.checkpoint(
                        tick, blocks, head, x_in, use_reentrant=False, preserve_rng_state=False)
                else:
                    out = tick(blocks, head, x_in)
                tape.ticks.append((x_in, out))
            if S > 1 and t < M + S - 2:
                send = (out.detach() if out is not None and not last
                        else torch.zeros(act, dtype=dtype, device=device))
                with torch.no_grad():
                    buf = ppermute(send, PP_AXIS, 1)
        if last:
            tape.outs = torch.cat([out for _, out in tape.ticks])
            local = tape.outs
        else:
            local = torch.zeros((B,) + self._head_shape(head, act, dtype)[1:], dtype=dtype,
                                device=device)
        outs = broadcast_from_last(local, PP_AXIS)
        if seq_axis is not None and not self.per_token_labels:
            # a classifier's head pooled this rank's block (its sum over the
            # block's length): the mean over seq is the whole sequence's
            # pool, the same on every seq rank; per-token outputs stay local
            outs = pmean(outs, seq_axis)
        return outs, tape

    def _head_shape(self, head, act, dtype) -> tuple:
        """The head's output shape for one microbatch, asked of the head on
        meta tensors (``[mb, classes]`` or ``[mb, seq, vocab]``)."""
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in head.items()}
        return tuple(self.staged.head(meta, torch.empty(act, dtype=dtype, device="meta")).shape)

    def backward(self, tape: _Tape, params, d_outs: Optional[torch.Tensor]):
        """The reverse schedule: gradients of this rank's leaves of
        ``params`` (whole embed/head, the stage's blocks), given the
        cotangent ``d_outs`` of the last stage's outputs (None elsewhere).
        The embedding's gradient is nonzero on stage 0 only, the head's on
        the last stage only."""
        ax = resolve_axis(PP_AXIS)
        S, s, M = ax.size, ax.index, self.microbatches
        last = s == S - 1
        blocks = list(params["blocks"].values())
        head = list(params["head"].values()) if last else []
        g_blocks = [torch.zeros_like(p) for p in blocks]
        g_head = [torch.zeros_like(p) for p in params["head"].values()]
        d_in = [None] * M
        mb = tape.ticks[0][0].shape[0]
        recv = None
        for t in reversed(range(M + S - 1)):
            j = t - s
            if 0 <= j < M:
                x_in, out = tape.ticks[j]
                g_out = d_outs[j * mb:(j + 1) * mb] if last else recv
                got = torch.autograd.grad(out, blocks + head + [x_in], g_out, allow_unused=True)
                for acc, g in zip(g_blocks + g_head, got[:-1]):
                    if g is not None:
                        acc += g
                d_in[j] = got[-1]
            if S > 1 and t > 0:
                send = (d_in[j] if 0 <= j < M and s > 0
                        else torch.zeros_like(tape.ticks[0][0]))
                with torch.no_grad():
                    recv = ppermute(send.detach(), PP_AXIS, -1)
        embed = list(params["embed"].values())
        g_embed = [torch.zeros_like(p) for p in embed]
        if s == 0:
            got = torch.autograd.grad(tape.h0, embed, torch.cat(d_in), allow_unused=True)
            g_embed = [z if g is None else g for z, g in zip(g_embed, got)]
        names = lambda key, gs: dict(zip(params[key], gs))
        return {"embed": names("embed", g_embed), "blocks": names("blocks", g_blocks),
                "head": names("head", g_head)}


class PipelineEngine(WindowedEngine):
    """Windowed async-SGD engine over a ``(workers, stages)`` grid of ranks,
    or a ``(workers, stages, model)`` or ``(workers, stages, seq)`` one.

    Same public surface and parameter-server semantics as
    :class:`~distkeras_tpu_torch.parallel.engine.WindowedEngine`; the model
    runs as a microbatch pipeline down the ``stages`` axis.  Needs a staged
    adapter (:class:`~distkeras_tpu_torch.models.staged.StagedTransformer`-like:
    an ``{"embed", "blocks", "head"}`` parameter tree and pure ``embed`` /
    ``stage`` / ``head`` functions).  ``mesh`` (the grid; by default one
    over every rank of the process group) replaces JAX's ``devices``, and
    ``device`` is the port's."""

    def __init__(
        self,
        staged_adapter,
        loss,
        worker_optimizer,
        rule: UpdateRule,
        num_workers: Optional[int] = None,
        *,
        microbatches: Optional[int] = None,
        tp_shards: int = 1,
        seq_shards: int = 1,
        fsdp: bool = False,
        metrics: Sequence = ("accuracy",),
        compute_dtype: Optional[Any] = None,
        sync_model_state: bool = True,
        mesh=None,
        remat: bool = False,
        unroll=1,
        device="cuda",
    ):
        for attr in ("embed", "stage", "head", "num_stages"):
            if not hasattr(staged_adapter, attr):
                raise TypeError(
                    f"PipelineEngine needs a staged adapter (missing {attr!r}); "
                    "see distkeras_tpu_torch.models.StagedTransformer"
                )
        S = int(staged_adapter.num_stages)
        self.tp_shards = tp = int(tp_shards)
        sp = int(seq_shards)
        # the JAX engine's checks, in its words and order
        if sp > 1 and tp > 1:
            raise ValueError(
                "seq_shards>1 with tp_shards>1 on the pipeline engine is "
                "not supported (ring attention is hand-placed; the model "
                "axis is partitioner-placed — pick one third axis)"
            )
        adapter_seq = getattr(staged_adapter, "seq_axis", None)
        if sp > 1 and adapter_seq != SEQ_AXIS:
            raise ValueError(
                f"seq_shards={sp} needs a staged adapter built with "
                f"seq_axis={SEQ_AXIS!r} (ring-attention blocks), got "
                f"seq_axis={adapter_seq!r}"
            )
        if sp == 1 and adapter_seq is not None:
            raise ValueError(
                f"staged adapter has seq_axis={adapter_seq!r} but "
                "seq_shards=1 — a ring-attention block needs its mesh axis"
            )
        self._pp_fsdp = bool(fsdp)
        if self._pp_fsdp and S <= 1:
            raise ValueError(
                "fsdp=True on PipelineEngine shards embed/head over the "
                "stage axis and needs num_stages>1"
            )
        if self._pp_fsdp and not _named_optimizer(worker_optimizer):
            # worker updates run on the 1/S shards: trajectory-identical only
            # for elementwise optimizers, which every named one is
            raise ValueError(
                "fsdp=True on PipelineEngine requires a named worker "
                "optimizer (elementwise update math); custom optax "
                "transforms may reduce across parameters (e.g. global-norm "
                "clipping), which is stage-inconsistent on sharded leaves — "
                "use the replicated layout (fsdp=False) or the GSPMD "
                "engine's fsdp for those"
            )
        ranks = _grid_ranks(mesh)
        if ranks % (S * tp * sp):
            raise ValueError(
                f"num_stages={S} x tp_shards={tp} x seq_shards={sp} does not divide "
                f"device count {ranks} (the ranks of the process group, one a card)"
            )
        worker_ranks = ranks // (S * tp * sp)
        num_workers = num_workers or worker_ranks
        if num_workers != worker_ranks:
            raise ValueError(
                f"pipeline engine maps workers 1:1 onto mesh rows: "
                f"num_workers={num_workers} != {worker_ranks} "
                f"(= {ranks} devices / {S} stages / {tp} tp shards / {sp} seq shards)"
            )
        self.pp_stages = S
        self.microbatches = S if microbatches is None else int(microbatches)
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got {self.microbatches}")
        # the third axis: the model axis (pipeline x tensor) or the seq axis
        # (pipeline x sequence), as in JAX's 3-D meshes
        third = TP_AXIS if tp > 1 else SEQ_AXIS if sp > 1 else None
        names = (WORKER_AXIS, PP_AXIS) + ((third,) if third else ())
        dims = (worker_ranks, S) + ((tp * sp,) if third else ())
        if mesh is None:
            mesh = make_mesh_grid(*dims, axis_names=names)
        if tuple(mesh.mesh_dim_names or ()) != names or any(
                resolve_axis(n, mesh).size != d for n, d in zip(names[1:], dims[1:])):
            raise ValueError(f"num_stages={S}, tp_shards={tp}, seq_shards={sp} need a "
                             f"{names} grid of {'x'.join(map(str, dims[1:]))} ranks a worker, "
                             f"got {mesh}")
        self.user_adapter = staged_adapter
        view = _PipelinedView(staged_adapter, self.microbatches,
                              # the staged model's own head form: a default would
                              # pair a softmax head with the from_logits loss
                              outputs_logits=staged_adapter.outputs_logits)
        super().__init__(
            view, loss, worker_optimizer, rule, num_workers, metrics=metrics,
            compute_dtype=compute_dtype, sync_model_state=sync_model_state, mesh=mesh,
            remat=remat, unroll=unroll, device=device,
        )
        self.fsdp = self._pp_fsdp
        self.axis = WORKER_AXIS
        # the training-dynamics stats stay off here whatever the switch says,
        # as in the JAX pipeline engine: a stage rank holds one stage's
        # gradients, so a norm would need a sum over the stages each step
        self._dynamics = False
        #: the stages axis's process group (None on one rank)
        self.stage_group = axis_group(self.mesh, PP_AXIS)
        self.stage_index = resolve_axis(PP_AXIS, self.mesh).index
        #: the model axis's process group (None without tensor parallelism)
        self.model_group = axis_group(self.mesh, TP_AXIS) if tp > 1 else None
        # the windowed engine's seq-axis rules (the sequence blocks of the
        # data, the per-token stats' mean over seq) read these
        self.seq_shards = sp
        self.seq_axis = SEQ_AXIS if sp > 1 else None
        self.seq_group = axis_group(self.mesh, SEQ_AXIS) if sp > 1 else None
        self._row_groups = (self.stage_group, self.model_group or self.seq_group)
        #: per parameter leaf, the dim split over the stages (-1: whole)
        self._pp_dims = None
        #: per parameter leaf, the dim split over the model axis (-1: whole)
        self._tp_dims = None

    # ------------------------------------------------------------ placement
    def _record_layout(self, params) -> None:
        """The placement tables from the whole parameters (at
        ``init_state`` and ``state_from_center`` alike): over the stages,
        every ``blocks`` leaf on its stage dim 0, and under ``fsdp=True``
        each embed/head leaf on :func:`zero_shard_dim`'s dim (-1: whole);
        over the model axis, each ``blocks`` leaf on :meth:`_tp_dim`'s dim,
        embed and head whole.  The JAX package's shape rule holds: no
        non-staged leaf may share a staged leaf's shape."""
        staged = {tuple(x.shape) for x in tree_leaves(params["blocks"])}
        for key, sub in params.items():
            if key == "blocks":
                continue
            clash = [x for x in tree_leaves(sub) if tuple(x.shape) in staged]
            if clash:
                raise ValueError(
                    f"non-staged param leaf in {key!r} has the same shape as a "
                    f"staged blocks leaf ({tuple(clash[0].shape)}); the stage-sharding "
                    "shape rule cannot disambiguate — change a dimension"
                )
        S = self.pp_stages
        split = lambda x: zero_shard_dim(tuple(x.shape), S) if self._pp_fsdp else -1
        self._pp_dims = {k: tree_map(lambda x: 0 if k == "blocks" else split(x), sub)
                         for k, sub in params.items()}
        shard_dims = {k: d for k, d in self._pp_dims.items() if k != "blocks"}
        if self._pp_fsdp and all(d < 0 for d in tree_leaves(shard_dims)):
            warnings.warn(
                f"fsdp=True: no embed/head leaf has a dim divisible by "
                f"num_stages={S} (with >=2 rows per shard); the non-staged "
                "params stay fully replicated", stacklevel=4,
            )
        self.adapter.shard_dims = shard_dims if self._pp_fsdp else None
        if self.tp_shards > 1:
            views = leaf_views(getattr(self.user_adapter, "_block", None))
            self._tp_dims = {k: tree_map(lambda x: -1, sub) for k, sub in params.items()}
            self._tp_dims["blocks"] = {n: self._tp_dim(views, n, x)
                                       for n, x in params["blocks"].items()}
            self.adapter.tp_dims = self._tp_dims["blocks"]

    def _tp_dim(self, views, name: str, leaf) -> int:
        """The dim of a whole ``blocks`` leaf (``[S, per_stage, *shape]``)
        split over the model axis, or -1: JAX's ``_tp_tail``, the GSPMD
        engine's :func:`default_tp_dim` applied to the per-stage shape in
        flax's layout (``[1, per_stage, *flax shape]``: a 1-D per-block leaf
        splits too), on the port's dim that holds flax's last dim."""
        shape = tuple(leaf.shape[2:])
        view, port_dim = views.get(name, (shape, len(shape) - 1))
        if default_tp_dim((1, leaf.shape[1]) + tuple(view), self.tp_shards) is None:
            return -1
        return 2 + port_dim

    def _placements(self):
        """``(axis, dims table)`` of each axis a leaf may be split over."""
        out = [(PP_AXIS, self._pp_dims)]
        if self._tp_dims is not None:
            out.append((TP_AXIS, self._tp_dims))
        return out

    def _block(self, tree, lead: int = 0):
        """This rank's block of each placed leaf of a whole tree (new
        tensors): its stage's, then its model rank's; dims taken after
        ``lead`` leading dims."""
        for axis, dims in self._placements():
            ax = resolve_axis(axis, self.mesh)

            def one(d, x):
                if d < 0:
                    return x
                size = x.shape[lead + d] // ax.size
                return x.narrow(lead + d, ax.index * size, size).clone()

            tree = tree_map(one, dims_like(tree, dims), tree)
        return tree

    def _whole(self, tree, lead: int = 0):
        """Each placed leaf of a tree of blocks gathered whole over the
        model axis and the stages (collectives every rank of the row takes
        part in)."""
        with torch.no_grad():
            for axis, dims in reversed(self._placements()):
                tree = tree_map(
                    lambda d, x: x if d < 0 else all_gather(x, axis, lead + d, self.mesh),
                    dims_like(tree, dims), tree)
        return tree

    def _local_block(self, params):
        return self._block(params)

    # the windowed engine's seq-axis center split does not apply: the stage
    # placement covers the center, and every per-worker tree, itself
    def _fsdp_gather(self, tree):
        return tree

    def _fsdp_shard(self, tree):
        return tree

    def shard_center(self, tree):
        """A whole center (a checkpoint's) as this stage rank stores it."""
        return self._block(tree)

    def gather_center(self, state: TrainState):
        """The whole center on every rank, gathered over the stages."""
        return self._whole(state.center_params)

    def worker_slice(self, tree, index: int):
        """One worker's copy of per-worker state, whole, on every rank."""
        return self._whole(super().worker_slice(tree, index))

    def checkpoint_state(self, state: TrainState) -> TrainState:
        """``state`` with whole leaves: the center, and every worker's
        parameters, optimizer and rule states gathered over the stages."""
        return state.replace(
            center_params=self.gather_center(state),
            local_params=self._whole(state.local_params, lead=1),
            opt_state=self._whole(state.opt_state, lead=1),
            rule_local=self._whole(state.rule_local, lead=1))

    def restore_field(self, field: str, tree):
        if field == "center_params":
            return self.shard_center(tree)
        if field in ("local_params", "opt_state", "rule_local"):
            return self._block(tree, lead=1)
        return tree

    # ------------------------------------------------------------------ init
    def init_state(self, generator: torch.Generator, sample_input) -> TrainState:
        params, model_state = self.user_adapter.init(generator, sample_input)
        if tree_leaves(model_state):
            raise ValueError(
                "pipeline engine supports stateless models (no BatchNorm-style "
                "mutable state across stages)"
            )
        return self._assemble_state(generator, params, model_state)

    # ------------------------------------------------------------ local step
    def _local_step(self, params, opt_state, model_state, generator, x, y):
        """One optimizer step of this rank's worker through the pipeline:
        the scheduled forward, the loss (the same on every stage rank), the
        reverse schedule, the gradients synced over the stages, the update
        of this rank's leaves."""
        del generator  # staged blocks carry no dropout
        view = self.adapter
        with bind_mesh(self.mesh):
            whole = view.gathered(params)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), whole)
        cast = self.compute_dtype
        with torch.enable_grad(), bind_mesh(self.mesh):
            p = leaves if cast is None else tree_map(
                lambda t: t.to(cast) if t.is_floating_point() else t, leaves)
            outs, tape = view.forward(p, x, keep=True, remat=self.remat)
            out = outs.float()
            loss = self.loss_fn(out, y)
            d_outs = None
            if tape.outs is not None:  # the last stage: the loss's one copy with a graph
                (d_outs,) = torch.autograd.grad(loss, tape.outs)
            grads = view.backward(tape, leaves, d_outs)
            del tape
        grads = self._sync_grads(grads)
        with torch.no_grad():
            out = out.detach()
            mets = (torch.stack([m(out, y) for m in self.metric_fns]) if self.metric_fns
                    else torch.zeros((0,), device=out.device))
            updates, opt_state = self.optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, model_state, loss.detach(), mets, None

    def _sync_grads(self, grads):
        """The embed and head gradients over the stages: the masked
        schedule lands the whole embed gradient on stage 0 and the whole
        head gradient on the last stage (zeros elsewhere), so their sum over
        ``stages`` is exact replication.  Under ``fsdp=True`` a split leaf
        takes its stage's block of that sum (a reduce-scatter, the transpose
        of the gather at use).  The ``blocks`` gradients stay per stage.
        With a seq axis every gradient is then ``pmean``'d over ``seq``:
        each seq rank holds its partial gradient (times ``seq_shards`` under
        a classifier's pmean), and the mean is the exact total."""
        ax = resolve_axis(PP_AXIS, self.mesh)
        out = grads
        if ax.size > 1:
            dims = self._pp_dims
            keys = [k for k in grads if k != "blocks"]
            whole = [(k, n) for k in keys for n in grads[k] if dims[k][n] < 0]
            summed = dict(zip(whole, all_reduce_sum([grads[k][n] for k, n in whole], ax.group)))
            out = {"blocks": grads["blocks"]}
            for k in keys:
                out[k] = {n: summed[k, n] if dims[k][n] < 0 else _reduce_scatter(g, ax, dims[k][n])
                          for n, g in grads[k].items()}
        if self.seq_axis is None:
            return out
        leaves = iter(g / self.seq_shards
                      for g in all_reduce_sum(tree_leaves(out), self.seq_group))
        return tree_map(lambda _: next(leaves), out)


def _grid_ranks(mesh) -> int:
    """The ranks a pipeline grid spans: the mesh's, or the process group's
    (one without a group)."""
    if mesh is not None:
        n = 1
        for d in mesh.shape:
            n *= int(d)
        return n
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
