"""The GSPMD engine: windowed async-SGD with tensor parallelism and the
workers-axis ZeRO center, over a ``(workers, model)`` grid.

The port of :mod:`distkeras_tpu.parallel.gspmd`.  JAX builds it the pjit
way: parameter leaves carry shardings over a 2-D ``(workers, model)`` mesh
and XLA's SPMD partitioner inserts the collectives they imply, so any model
runs unmodified.  The port runs one process per card (ROADMAP C10), so the
grid is :func:`~distkeras_tpu_torch.parallel.mesh.make_mesh_grid`'s
``(world / tp_shards, tp_shards)`` grid of ranks (mesh rank ``(w, m)`` is
global rank ``w * tp_shards + m``, JAX's row-major ``reshape``), and the
placement is carried out by the engine itself, without model surgery:

* **Placement** is the layout JAX chooses, read on the port's own leaves
  (:func:`default_tp_dim` on the leaf's flax layout, output channels last):
  each rank of a workers row stores its ``1/tp_shards`` block of the dim
  that holds a leaf's output channels (dim 0 of a ``Linear`` or conv
  weight, the last dim of an ``Embedding``, of a Keras kernel and of any
  other leaf), of the center, of every worker's parameters and of the
  optimizer and rule states built from them.  1-D leaves stay whole, as in
  JAX; the fused attention ``qkv`` bias, a ``[3, H, hd]`` leaf in JAX, is
  split with its weight.  ``spec_fn(shape, name)`` overrides the default
  per leaf, on the port's shape and parameter name.
* **Execution.**  Each forward runs inside a ``TorchFunctionMode`` that
  knows the split leaves by identity (after ``functional_call`` binds
  them).  ``F.linear``, the convolutions, ``F.embedding``, ``matmul`` and
  ``torch.addmm`` (HuggingFace's ``Conv1D``, its weight ``[in, out]``)
  over a leaf split on its output channels compute **column-parallel**:
  this rank's block of outputs from the replicated input
  (:func:`~distkeras_tpu_torch.parallel.mesh.copy_to_axis`: its gradient
  is psummed over ``model``), then the outputs gathered over ``model``
  (:func:`~distkeras_tpu_torch.parallel.mesh.gather_from_axis`: the
  gradient keeps this rank's block).  Any other use of a split leaf
  gathers it whole first.  An MoE layer's expert products
  (:func:`~distkeras_tpu_torch.models.moe.expert_ffn`) over expert stacks
  split on their expert dim (:func:`~distkeras_tpu_torch.models.moe.expert_partition`)
  run **expert-parallel**: each model rank computes its own experts on its
  block of the dispatched tokens, and the outputs are gathered over
  ``model`` once a layer.  Everything downstream of a gather is replicated
  over ``model``: the attention models run B1-B3 on all heads on every
  model rank, and every model rank of a row draws the same dropout masks
  from its worker's one generator (the ``tp_shards=1`` masks).
* **Commit.**  The rules' math is elementwise per leaf, so each model rank
  commits its own blocks: the sum over workers is the local sum plus an
  all-reduce over the workers axis of its model index.
* ``fsdp=True`` also splits each center leaf over the **workers** axis, on
  the largest still-free dim that splits over the worker ranks (JAX's
  ``_center_spec``): gathered at the window-boundary pull and sliced again
  after the commit (the windowed engine's ZeRO helpers over the workers
  axis).  Per-worker state keeps the workers axis on its leading dim.

``commit_schedule`` (the staleness simulation), ``remat`` and the training
dynamics run as in the windowed engine; the dynamics sums take each split
leaf's block on its model rank and a whole leaf once, over the model axis,
and the rule's diagnostics see whole trees.  ``unroll`` other than 1 on a
card captures each window as one CUDA graph, as the windowed engine does,
with its collectives inside: the column-parallel products' gathers and
input-gradient psums over ``model``, EP's input psum and output gather, with
dynamics on the rule's diagnostics' gathers over ``model``, the commit's
all-reduce over ``workers`` and, under fsdp, the center's gather at the
pull (its slice after the commit is a view).  Both axis groups must run
NCCL.  ``seq_shards`` is not taken here: ring attention needs the windowed
engine, as in JAX.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from distkeras_tpu_torch.algorithms.base import UpdateRule
from distkeras_tpu_torch.parallel.engine import TrainState, WindowedEngine
from distkeras_tpu_torch.parallel.mesh import (
    TP_AXIS,
    WORKER_AXIS,
    all_reduce_sum,
    axis_group,
    copy_to_axis,
    gather_from_axis,
    make_mesh_grid,
    resolve_axis,
)
from distkeras_tpu_torch.utils.pytree import tree_leaves, tree_map

__all__ = ["GSPMDEngine", "TP_AXIS", "default_tp_dim"]


def default_tp_dim(shape, tp_shards: int):
    """The ONE default tensor-parallel placement rule, shared by every
    engine that shards over a model axis (GSPMD default spec, pipeline
    staged-leaf tails): shard the LAST dim of any >=2-D leaf that splits
    evenly and is at least two lanes per shard; return its index or None.
    Any placement is *correct* under GSPMD — this default puts matmul
    output channels (Dense/Conv kernels, embeddings) on the model axis,
    Megatron column-parallel style."""
    if (
        tp_shards > 1
        and len(shape) >= 2
        and shape[-1] % tp_shards == 0
        and shape[-1] >= 2 * tp_shards
    ):
        return len(shape) - 1
    return None


def _tp_grid(tp_shards: int):
    """The ``(workers, model)`` grid over every rank of the process group."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world % tp_shards:
        raise ValueError(
            f"tp_shards={tp_shards} does not divide the rank count {world}: launch one "
            "process per rank (torchrun --nproc-per-node N with N = workers ranks x "
            "tp_shards)"
        )
    return make_mesh_grid(world // tp_shards, tp_shards, axis_names=(WORKER_AXIS, TP_AXIS))


def _on(entry, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def _named(tree, prefix: str = ""):
    """A tree of the leaves' names (dict keys and list indices joined by
    dots), in ``tree``'s structure: a flat name -> tensor dict's keys."""
    if isinstance(tree, dict):
        return {k: _named(v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_named(v, f"{prefix}{i}.") for i, v in enumerate(tree))
    return prefix[:-1]


def _same_structure(tree, ref) -> bool:
    """Does ``tree`` (of tensors) have the container structure of ``ref``
    (of dims)?  Only containers match: a parameter-shaped subtree of an
    optimizer or rule state."""
    if isinstance(ref, dict):
        return (isinstance(tree, dict) and tree.keys() == ref.keys()
                and all(_same_leaf(tree[k], ref[k]) for k in ref))
    if isinstance(ref, (list, tuple)):
        return (isinstance(tree, (list, tuple)) and len(tree) == len(ref)
                and all(_same_leaf(t, r) for t, r in zip(tree, ref)))
    return False


def _same_leaf(tree, ref) -> bool:
    if isinstance(ref, (dict, list, tuple)):
        return _same_structure(tree, ref)
    return isinstance(tree, torch.Tensor)


def dims_like(tree, dims):
    """Per-leaf split dims for any tree that holds parameter-shaped subtrees
    (parameters, optimizer and rule states), from the parameters' ``dims``:
    those subtrees take the parameters' dims, every other leaf -1."""
    if _same_structure(tree, dims):
        return dims
    if isinstance(tree, dict):
        return {k: dims_like(v, dims) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(dims_like(v, dims) for v in tree)
    return -1


def leaf_views(adapter) -> dict:
    """Per parameter name of an adapter's module (or of a module itself: the
    pipeline reads a staged model's block template), the leaf's shape in
    the JAX package's flax layout
    (output channels last) and the port's dim that holds that last dim:
    what :func:`default_tp_dim` is read on.  A ``Linear`` weight ``[out,
    in]`` is flax's ``[in, out]`` (dim 0); a conv weight ``[out, in, *k]``
    is ``[*k, in, out]`` (dim 0); the attention's fused ``qkv`` weight
    ``[3*H*hd, D]`` and bias ``[3*H*hd]`` are ``[D, 3, H, hd]`` and ``[3, H,
    hd]`` (dim 0), its ``proj`` weight ``[D, H*hd]`` is ``[H, hd, D]`` (dim
    0).  A leaf named nowhere here (an ``Embedding`` ``[V, D]``, a Keras
    kernel ``[in, out]``, any other leaf) is read as it is, last dim last."""
    from torch import nn

    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.models.transformer import _SelfAttention

    module = adapter if isinstance(adapter, nn.Module) else getattr(adapter, "module", None)
    views: dict = {}
    if not isinstance(module, nn.Module):
        return views
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, _SelfAttention):
            dim = m.qkv.in_features
            views[pre + "qkv.weight"] = ((dim, 3, m.heads, m.head_dim), 0)
            views[pre + "qkv.bias"] = ((3, m.heads, m.head_dim), 0)
            views[pre + "proj.weight"] = ((m.heads, m.head_dim, dim), 0)
        elif isinstance(m, nn.Linear) and pre + "weight" not in views:
            views[pre + "weight"] = ((m.in_features, m.out_features), 0)
        elif isinstance(m, (zoo.Conv, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            out, cin, *kernel = m.weight.shape
            views[pre + "weight"] = ((*kernel, cin, out), 0)
    return views


class _Placed(NamedTuple):
    """A split leaf in a forward: its dim on the model axis and the whole
    leaf's shape."""

    dim: int
    shape: torch.Size


_T = torch.Tensor
# the queries the models make of a leaf (the zoo's dtype promotion, Keras's
# variable reads), answered without a gather; the same for the whole leaf
_SAME_GETTERS = (_T.dtype, _T.device)
_CONVS = (F.conv1d, F.conv2d, F.conv3d)
_MATMULS = (torch.matmul, _T.matmul, _T.__matmul__)


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


class _TensorParallel(TorchFunctionMode):
    """The forward of one worker on one model rank: split leaves (by
    identity) run column-parallel where an op takes them on their output
    channels, and are gathered whole at any other use (once a forward).
    An integer index into the leading dim of a leaf split on a later dim is
    split as the leaf is (a staged model's stage and block of a stacked
    leaf, ``v[0]``, ``v[i]``)."""

    def __init__(self, placed: dict, axis: str, mesh):
        from distkeras_tpu_torch.models.moe import expert_ffn

        super().__init__()
        self._expert_ffn = expert_ffn  # an MoE layer's expert products, taken whole
        #: id -> (the tensor, kept alive so that its id stays its own; _Placed)
        self.placed = placed
        self.axis, self.mesh = axis, mesh
        self.whole: dict = {}

    # ---------------------------------------------------------------- lookups
    def _get(self, t) -> Optional[_Placed]:
        hit = self.placed.get(id(t)) if isinstance(t, torch.Tensor) else None
        return None if hit is None else hit[1]

    def _any(self, args, kwargs) -> bool:
        for a in (*args, *kwargs.values()):
            if isinstance(a, torch.Tensor):
                if id(a) in self.placed:
                    return True
            elif isinstance(a, (list, tuple)):
                if any(isinstance(b, torch.Tensor) and id(b) in self.placed for b in a):
                    return True
        return False

    def _use(self, t):
        """``t`` whole: a split leaf gathered over the model axis (once)."""
        p = self._get(t)
        if p is None:
            return t
        got = self.whole.get(id(t))
        if got is None:
            got = self.whole[id(t)] = gather_from_axis(t, self.axis, p.dim, self.mesh)
        return got

    def _uses(self, value):
        if isinstance(value, (list, tuple)):
            return type(value)(self._use(v) for v in value)
        return self._use(value)

    # ------------------------------------------------------------ the mode
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._any(args, kwargs):
            return func(*args, **kwargs)
        owner = getattr(func, "__self__", None)
        if owner is _T.shape:
            return self._get(args[0]).shape
        if any(owner is g for g in _SAME_GETTERS):
            return func(*args, **kwargs)
        if func is _T.to:  # a cast or a move is split as the leaf is
            p = self._get(args[0])
            out = func(*args, **kwargs)
            if p is not None and isinstance(out, torch.Tensor) and out.shape == args[0].shape:
                self.placed.setdefault(id(out), (out, p))
            return out
        if func is _T.__getitem__:
            p = self._get(args[0])
            if p is not None and p.dim > 0 and isinstance(args[1], int):
                out = func(*args, **kwargs)
                self.placed[id(out)] = (out, _Placed(p.dim - 1, p.shape[1:]))
                return out
        out = self._column_parallel(func, args, kwargs)
        if out is not None:
            return out
        return func(*self._uses(args), **{k: self._uses(v) for k, v in kwargs.items()})

    def _column_parallel(self, func, args, kwargs):
        """A product over a leaf split on its output channels, computed
        column-parallel, or an MoE layer's expert products over stacks
        split on their expert dim; None when ``func`` is no such product."""
        if func is self._expert_ffn:
            return self._experts(*args, **kwargs)
        if func is F.linear:
            x, w, b = args[0], _arg(args, kwargs, 1, "weight"), _arg(args, kwargs, 2, "bias")
            return self._columns(x, w, b, 0, -1, lambda x, w, b: F.linear(x, w, b))
        if func in _CONVS:
            x, w, b = args[0], _arg(args, kwargs, 1, "weight"), _arg(args, kwargs, 2, "bias")
            rest = [_arg(args, kwargs, i, n, d) for i, n, d in
                    ((3, "stride", 1), (4, "padding", 0), (5, "dilation", 1))]
            if _arg(args, kwargs, 6, "groups", 1) != 1:
                return None
            return self._columns(x, w, b, 0, 1, lambda x, w, b: func(x, w, b, *rest))
        if func is F.embedding:
            ids, w = args[0], _arg(args, kwargs, 1, "weight")
            p = self._get(w)
            if (p is None or self._get(ids) is not None or w.dim() != 2 or p.dim != 1
                    or _arg(args, kwargs, 3, "max_norm") is not None):
                return None
            return gather_from_axis(func(*args, **kwargs), self.axis, -1, self.mesh)
        if func is torch.addmm:
            # HF's Conv1D: bias + x @ w, w [in, out] split on its outputs
            b, x, w = (_arg(args, kwargs, i, n) for i, n in
                       ((0, "input"), (1, "mat1"), (2, "mat2")))
            if kwargs.get("beta", 1) != 1 or kwargs.get("alpha", 1) != 1:
                return None
            return self._columns(x, w, b, 1, -1, lambda x, w, b: torch.matmul(x, w)
                                 if b is None else torch.addmm(b, x, w))
        if func in _MATMULS:
            x, w = args[0], _arg(args, kwargs, 1, "other")
            if not isinstance(w, torch.Tensor) or w.dim() != 2:
                return None
            return self._columns(x, w, None, 1, -1, lambda x, w, b: torch.matmul(x, w))
        return None

    def _experts(self, xin, w1, b1, w2, b2):
        """Expert parallelism: with all four expert stacks split on dim 0,
        this rank runs the FFNs of its own experts on its block of the
        dispatched ``xin [E, C, d]`` (taken after :func:`copy_to_axis`, so
        that the input's gradient is summed over the ranks' experts) and
        the ``[E, C, d]`` outputs are gathered over the axis.  Any other
        placement: None (the leaves are then gathered whole)."""
        stacks = (w1, b1, w2, b2)
        if self._get(xin) is not None or any(
                p is None or p.dim != 0 for p in map(self._get, stacks)):
            return None
        per = w1.shape[0]  # this rank's experts (the mode is off in here)
        index = resolve_axis(self.axis, self.mesh).index
        block = copy_to_axis(xin, self.axis, self.mesh).narrow(0, index * per, per)
        return gather_from_axis(self._expert_ffn(block, *stacks), self.axis, 0, self.mesh)

    def _columns(self, x, w, b, w_dim: int, out_dim: int, product):
        """``product`` of the replicated ``x`` with this rank's block of
        ``w`` (split on ``w_dim``, its output channels), gathered on the
        output's ``out_dim``; a bias split as ``w`` rides in the product, a
        whole one is added after the gather."""
        p = self._get(w)
        if p is None or p.dim != w_dim or not isinstance(x, torch.Tensor) or self._get(x):
            return None
        pb = self._get(b)
        inner = b if pb is not None and pb.dim == 0 else None
        y = product(copy_to_axis(x, self.axis, self.mesh), w, inner)
        y = gather_from_axis(y, self.axis, out_dim, self.mesh)
        if b is not None and inner is None:
            b = self._use(b)
            y = y + (b if out_dim == -1 else b.view(-1, *([1] * (y.dim() - 2))))
        return y


class _PlacedForward:
    """What the engine's local step calls ``apply`` on: the adapter's
    forward inside :class:`_TensorParallel`, the split leaves found by
    their position in the parameter tree."""

    def __init__(self, engine: "GSPMDEngine"):
        self.engine = engine

    def apply(self, params, state, inputs, training=False, generator=None):
        eng = self.engine
        placed = {}
        for d, t in zip(tree_leaves(eng._tp_dims), tree_leaves(params)):
            if d >= 0:
                whole = list(t.shape)
                whole[d] *= eng.tp_shards
                placed[id(t)] = (t, _Placed(d, torch.Size(whole)))
        with _TensorParallel(placed, TP_AXIS, eng.mesh):
            return eng.adapter.apply(params, state, inputs, training=training,
                                     generator=generator)


class GSPMDEngine(WindowedEngine):
    """Drop-in engine with data x tensor parallelism over a ``(workers,
    model)`` grid.  Same public surface as :class:`WindowedEngine`
    (``init_state``, ``run_epoch``, ``run_epochs``, ``run_epoch_streaming``,
    ``shard_batches``, ``gather_center``, ``worker_slice``,
    ``average_workers``); ``mesh`` (a ``(workers, model)`` grid) replaces
    JAX's ``devices``, and ``device`` is the port's."""

    def __init__(
        self,
        adapter,
        loss,
        worker_optimizer,
        rule: UpdateRule,
        num_workers: Optional[int] = None,
        *,
        tp_shards: int = 1,
        fsdp: bool = False,
        spec_fn=None,
        metrics: Sequence = ("accuracy",),
        compute_dtype: Optional[Any] = None,
        sync_model_state: bool = True,
        commit_schedule: Optional[np.ndarray] = None,
        remat: bool = False,
        unroll=1,
        mesh=None,
        device="cuda",
    ):
        self.tp_shards = int(tp_shards)
        if self.tp_shards < 1:
            raise ValueError(f"tp_shards must be >= 1, got {tp_shards}")
        if mesh is None:
            mesh = _tp_grid(self.tp_shards)
        names = tuple(mesh.mesh_dim_names or ())
        if names != (WORKER_AXIS, TP_AXIS) or resolve_axis(TP_AXIS, mesh).size != self.tp_shards:
            raise ValueError(f"tp_shards={self.tp_shards} needs a ({WORKER_AXIS}, {TP_AXIS}) "
                             f"grid with {self.tp_shards} model ranks, got {mesh}")
        super().__init__(
            adapter, loss, worker_optimizer, rule, num_workers, metrics=metrics,
            compute_dtype=compute_dtype, commit_schedule=commit_schedule,
            sync_model_state=sync_model_state, mesh=mesh, remat=remat, unroll=unroll,
            device=device,
        )
        # ZeRO-3-style center over the workers axis (the windowed engine's
        # helpers, over another axis); per-worker state keeps its layout
        self.fsdp = bool(fsdp)
        self._fsdp_axis = WORKER_AXIS
        # placement override: (port shape, parameter name) -> spec or None
        self.spec_fn = spec_fn
        self.axis = WORKER_AXIS
        #: the model axis's process group (None on one rank)
        self.model_group = axis_group(self.mesh, TP_AXIS)
        self._row_groups = (self.model_group,)
        self._views = leaf_views(adapter)
        #: per parameter leaf, the dim split over the model axis (-1: whole)
        self._tp_dims = None

    # ------------------------------------------------------------- placement
    def _tp_spec(self, shape, name=None) -> tuple:
        """The model-axis placement of a leaf of the port's ``shape``: a
        tuple of axis names or None per dim (``()``: whole).  ``spec_fn``
        first; else JAX's default rule on the leaf's flax layout
        (:func:`leaf_views`), its last dim being the port's output-channel
        dim; a leaf with no view is read as it is."""
        shape = tuple(shape)
        if self.spec_fn is not None:
            spec = self.spec_fn(shape, name)
            if spec is not None:
                spec = tuple(spec)
                for dim, entry in zip(shape, spec):
                    if _on(entry, TP_AXIS) and dim % self.tp_shards:
                        raise ValueError(
                            f"spec_fn placed the model axis on a dim of size "
                            f"{dim}, not divisible by tp_shards={self.tp_shards} "
                            f"(leaf shape {shape}, name {name})"
                        )
                return spec
        view, port_dim = self._views.get(name, (shape, len(shape) - 1))
        # tp_shards == 1: no dim is named, so that _center_spec may give any
        # of them to the workers axis under fsdp
        if default_tp_dim(view, self.tp_shards) is not None:
            return (None,) * port_dim + (TP_AXIS,)
        return ()

    def _center_spec(self, shape, name=None) -> tuple:
        """TP placement plus, under ``fsdp=True``, the workers axis on the
        largest still-free evenly-splitting dim — each rank then stores
        ``1/n_dev`` of those leaves' model blocks.  Leaves with no such dim
        stay whole over the workers axis."""
        spec = list(self._tp_spec(shape, name))
        spec += [None] * (len(shape) - len(spec))
        taken = {n for entry in spec if entry is not None
                 for n in (entry if isinstance(entry, tuple) else (entry,))}
        if self.fsdp and self.n_dev > 1 and WORKER_AXIS not in taken:
            free = [d for d, entry in enumerate(spec)
                    if entry is None and shape[d] % self.n_dev == 0
                    and shape[d] >= 2 * self.n_dev]
            if free:
                spec[max(free, key=lambda d: shape[d])] = WORKER_AXIS
        return tuple(spec)

    def _dims(self, spec: tuple, shape, name) -> tuple:
        """``(model dim, workers dim)`` of a center spec, -1 for none.  The
        port splits one dim per axis."""
        model = [d for d, e in enumerate(spec) if _on(e, TP_AXIS)]
        workers = [d for d, e in enumerate(spec) if _on(e, WORKER_AXIS)]
        if len(model) > 1 or len(workers) > 1 or set(model) & set(workers):
            raise ValueError(f"placement {spec} of {name} {tuple(shape)}: the port splits "
                             "one dim over each axis, and no dim over both")
        return (model[0] if model else -1, workers[0] if workers and self.fsdp else -1)

    def _record_layout(self, params) -> None:
        """Per parameter leaf, from the whole parameters: the dim split over
        the model axis (``_tp_dims``) and, under fsdp, the center's dim
        split over the workers axis (``_fsdp_dims``); -1 for none."""
        names = _named(params)
        dims = lambda i: tree_map(
            lambda n, x: self._dims(self._center_spec(tuple(x.shape), n), x.shape, n)[i],
            names, params)
        self._tp_dims, self._fsdp_dims = dims(0), dims(1)
        if self.fsdp and self.n_dev > 1:
            self._warn_if_whole(self.n_dev)

    # --------------------------------------------------- blocks and wholes
    def _dims_like(self, tree):
        """The model-axis dims of any tree that holds parameter-shaped
        subtrees (:func:`dims_like`)."""
        return dims_like(tree, self._tp_dims)

    def _block(self, tree, lead: int = 0):
        """This model rank's block of each split leaf of a whole tree (new
        tensors), its dims taken after ``lead`` leading dims."""
        ax = resolve_axis(TP_AXIS, self.mesh)

        def one(d, x):
            if d < 0:
                return x
            size = x.shape[lead + d] // ax.size
            return x.narrow(lead + d, ax.index * size, size).clone()

        return tree_map(one, self._dims_like(tree), tree)

    def _whole(self, tree, lead: int = 0):
        """Each split leaf of a tree of model blocks gathered whole over the
        model axis (a collective every model rank takes part in)."""
        with torch.no_grad():
            return tree_map(
                lambda d, x: x if d < 0 else gather_from_axis(x, TP_AXIS, lead + d, self.mesh),
                self._dims_like(tree), tree)

    def _local_block(self, params):
        return self._block(params)

    # --------------------------------------------------------------- dynamics
    @property
    def _dyn_weights(self):
        """A split leaf's block counts whole on its model rank; a leaf every
        model rank holds whole counts ``1 / tp_shards`` on each, so that the
        sum over the model axis (:meth:`_model_total`) counts it once."""
        if self.model_group is None:
            return None
        return tree_map(lambda d: 1.0 if d >= 0 else 1.0 / self.tp_shards, self._tp_dims)

    def _model_total(self, *sums):
        return all_reduce_sum(sums, self.model_group)

    def _rule_dynamics(self, ctx, center, state):
        """The rule's diagnostics on whole trees: over several model ranks
        the workers' parameters and rule states, and the center, are
        gathered first (a norm of a model block is not the block's share of
        the whole norm)."""
        if self.model_group is None:
            return super()._rule_dynamics(ctx, center, state)
        return self.rule.dynamics(ctx, self._whole(state.local_params, lead=1),
                                  self._whole(center), self._whole(state.rule_local, lead=1),
                                  state.center_rule)

    @property
    def _forward(self):
        # made at each use, so that the engine is in no reference cycle: its
        # captured graphs go with it (NCCL keeps a communicator their
        # collectives recorded until they do)
        return _PlacedForward(self)

    def shard_center(self, tree):
        """A whole center (a checkpoint's) as this rank stores it: its model
        block of each split leaf, and under fsdp its workers block."""
        return tree_map(lambda x: x.clone(), self._fsdp_shard(self._block(tree)))

    def gather_center(self, state: TrainState):
        """The whole center on every rank: gathered over the workers axis
        (fsdp), then over the model axis."""
        with torch.no_grad():
            return self._whole(self._fsdp_gather(state.center_params))

    def worker_slice(self, tree, index: int):
        """One worker's copy of per-worker state, whole, on every rank."""
        return self._whole(super().worker_slice(tree, index))

    # ------------------------------------------------------- checkpoint views
    def checkpoint_state(self, state: TrainState) -> TrainState:
        """``state`` with whole leaves: the center, and every worker's
        parameters, optimizer and rule states gathered over the model axis."""
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
