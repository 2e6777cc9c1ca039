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
  same order and no collective runs inside autograd.  The embedding's
  gradient lands on stage 0 and the head's on the last stage, and
  :meth:`PipelineEngine._sync_grads` sums them over ``stages``; under
  ``fsdp=True`` the sum is a reduce-scatter, each stage keeping its block.
  ``remat=True`` recomputes a tick's stage (and head) on the backward,
  which runs no collective.

Staged blocks carry no dropout, as in JAX.  Not in this slice:
``tp_shards > 1`` and ``seq_shards > 1`` (pipeline x tensor and pipeline x
sequence parallelism, ROADMAP Queue A item 15c-ii), and captured CUDA-graph
windows (``unroll`` other than 1 on a card, item 20).
"""

from __future__ import annotations

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
    _graphs_requested,
    _not_ported,
    zero_shard_dim,
)
from distkeras_tpu_torch.parallel.gspmd import dims_like
from distkeras_tpu_torch.parallel.mesh import (
    PP_AXIS,
    SEQ_AXIS,
    WORKER_AXIS,
    _reduce_scatter,
    all_gather,
    all_reduce_sum,
    axis_group,
    bind_mesh,
    broadcast_from_last,
    make_mesh_grid,
    ppermute,
    resolve_axis,
    resolve_device,
)
from distkeras_tpu_torch.utils.pytree import tree_leaves, tree_map

__all__ = ["PP_AXIS", "PipelineEngine"]

_ITEM_15C_II = "item 15c-ii (pipeline x tensor and pipeline x sequence parallelism)"


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
    ``blocks`` leaves its stage's ``[1, blocks_per_stage, ...]``, the
    embedding and head whole or (``shard_dims``, set by the engine under
    ``fsdp=True``) split over the stages and gathered here.  Its outputs are
    the staged model's sequential ``apply``'s, on every stage rank."""

    staged: Any
    microbatches: int
    outputs_logits: bool = True
    #: {"embed": name -> dim, "head": name -> dim}: the dim each non-staged
    #: leaf is split on over the stages (-1: whole), or None
    shard_dims: Any = None

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
        y = self.staged.stage(blocks, x_in)
        return self.staged.head(head, y) if last else y

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
        blocks = {k: v[0] for k, v in params["blocks"].items()}
        head = params["head"]
        dtype = params["embed"]["tok_embed.weight"].dtype
        device = params["embed"]["tok_embed.weight"].device
        act = (mb, seq, self.staged.dim)
        tape = _Tape()
        micro = None
        if s == 0:
            tape.h0 = self.staged.embed(params["embed"], inputs)
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
        return broadcast_from_last(local, PP_AXIS), tape

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
    """Windowed async-SGD engine over a ``(workers, stages)`` grid of ranks.

    Same public surface and parameter-server semantics as
    :class:`~distkeras_tpu_torch.parallel.engine.WindowedEngine`; the model
    runs as a microbatch pipeline down the ``stages`` axis.  Needs a staged
    adapter (:class:`~distkeras_tpu_torch.models.staged.StagedTransformer`-like:
    an ``{"embed", "blocks", "head"}`` parameter tree and pure ``embed`` /
    ``stage`` / ``head`` functions).  ``mesh`` (a ``(workers, stages)``
    grid; by default one over every rank of the process group) replaces
    JAX's ``devices``, and ``device`` is the port's."""

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
        # the port's refusals, after JAX's checks
        if tp > 1 or sp > 1:
            raise _not_ported(f"tp_shards={tp}, seq_shards={sp} on the pipeline engine",
                              _ITEM_15C_II)
        if _graphs_requested(unroll) and resolve_device(device).type == "cuda":
            raise _not_ported("pipeline stages inside a captured window (unroll other than 1 "
                              "on a card)", "item 20 (CUDA-graph follow-ups)")
        if mesh is None:
            mesh = make_mesh_grid(worker_ranks, S, axis_names=(WORKER_AXIS, PP_AXIS))
        if tuple(mesh.mesh_dim_names or ()) != (WORKER_AXIS, PP_AXIS) or resolve_axis(
                PP_AXIS, mesh).size != S:
            raise ValueError(f"num_stages={S} needs a ({WORKER_AXIS}, {PP_AXIS}) grid with "
                             f"{S} stage ranks, got {mesh}")
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
        self.seq_shards = sp
        self.axis = WORKER_AXIS
        #: the stages axis's process group (None on one rank)
        self.stage_group = axis_group(self.mesh, PP_AXIS)
        self.stage_index = resolve_axis(PP_AXIS, self.mesh).index
        self._row_group = self.stage_group
        #: per parameter leaf, the dim split over the stages (-1: whole)
        self._pp_dims = None

    # ------------------------------------------------------------ placement
    def _record_layout(self, params) -> None:
        """The stage-placement table from the whole parameters (at
        ``init_state`` and ``state_from_center`` alike): every ``blocks``
        leaf on its stage dim 0; under ``fsdp=True`` each embed/head leaf on
        :func:`zero_shard_dim`'s dim (-1: whole).  The JAX package's shape
        rule holds: no non-staged leaf may share a staged leaf's shape."""
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

    def _block(self, tree, lead: int = 0):
        """This stage's block of each stage-placed leaf of a whole tree (new
        tensors), its dims taken after ``lead`` leading dims."""
        ax = resolve_axis(PP_AXIS, self.mesh)

        def one(d, x):
            if d < 0:
                return x
            size = x.shape[lead + d] // ax.size
            return x.narrow(lead + d, ax.index * size, size).clone()

        return tree_map(one, dims_like(tree, self._pp_dims), tree)

    def _whole(self, tree, lead: int = 0):
        """Each stage-placed leaf of a tree of stage blocks gathered whole
        over the stages (a collective every stage rank takes part in)."""
        with torch.no_grad():
            return tree_map(
                lambda d, x: x if d < 0 else all_gather(x, PP_AXIS, lead + d, self.mesh),
                dims_like(tree, self._pp_dims), tree)

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
        return params, opt_state, model_state, loss.detach(), mets

    def _sync_grads(self, grads):
        """The embed and head gradients over the stages: the masked
        schedule lands the whole embed gradient on stage 0 and the whole
        head gradient on the last stage (zeros elsewhere), so their sum over
        ``stages`` is exact replication.  Under ``fsdp=True`` a split leaf
        takes its stage's block of that sum (a reduce-scatter, the transpose
        of the gather at use).  The ``blocks`` gradients stay per stage."""
        ax = resolve_axis(PP_AXIS, self.mesh)
        if ax.size == 1:
            return grads
        dims = self._pp_dims
        keys = [k for k in grads if k != "blocks"]
        whole = [(k, n) for k in keys for n in grads[k] if dims[k][n] < 0]
        summed = dict(zip(whole, all_reduce_sum([grads[k][n] for k, n in whole], ax.group)))
        out = {"blocks": grads["blocks"]}
        for k in keys:
            out[k] = {n: summed[k, n] if dims[k][n] < 0 else _reduce_scatter(g, ax, dims[k][n])
                      for n, g in grads[k].items()}
        return out


def _grid_ranks(mesh) -> int:
    """The ranks a pipeline grid spans: the mesh's, or the process group's
    (one without a group)."""
    if mesh is not None:
        n = 1
        for d in mesh.shape:
            n *= int(d)
        return n
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
