"""The training engine: windowed local SGD + commits, on one card.

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
  the commit) is captured once and replayed once a window.  On the CPU,
  where there are no graphs, ``unroll`` stays the scan hint it is in JAX
  and changes nothing.  The staleness simulation stays eager under any
  ``unroll``.
* Dropout randomness is one ``torch.Generator`` per worker on the card,
  seeded from the init generator (JAX splits a key per worker).
* The on-device reshuffle of ``run_epochs`` draws ``torch.randperm``, not
  ``jax.random.permutation`` (:func:`epoch_permutation`): both are uniform
  permutations keyed by ``(shuffle_seed, epoch)``, not the same ones.
* ``remat`` wraps the model's apply in ``torch.utils.checkpoint``, whose
  recomputation draws dropout from a copy of each worker's generator taken
  before the forward, so the recomputed masks are the forward's.

Not in this slice: several cards (the cross-card sum of the commit),
sequence parallelism and FSDP, whose options the constructor refuses;
``remat`` inside a captured window; and the dynamics telemetry
(``DISTKERAS_DYNAMICS`` is not read).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from collections import deque
from typing import TYPE_CHECKING, Any, List, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.algorithms.base import CommitCtx, UpdateRule, stacked_ctx
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import get_metric, per_token_metric_names
from distkeras_tpu_torch.ops.optimizers import apply_updates, get_optimizer
from distkeras_tpu_torch.parallel.mesh import resolve_device
from distkeras_tpu_torch.utils.pytree import tree_leaves, tree_map, tree_where

if TYPE_CHECKING:  # models.adapter imports this package (resolve_device)
    from distkeras_tpu_torch.models.adapter import ModelAdapter

__all__ = ["TrainState", "WindowedEngine", "device_count", "epoch_permutation", "plan_workers"]

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


def device_count(device: torch.device) -> int:
    """Cards an entry point may count on: every CUDA card for a CUDA
    device, one for the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


@dataclasses.dataclass
class TrainState:
    """Full training state.  ``center_*`` leaves have no worker dim; every
    other tensor leaf carries a leading ``[num_workers]`` dim; ``rng`` holds
    one generator per worker."""

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


def _remat_apply(adapter, params, model_state, x, generator):
    """``adapter.apply`` in training under ``torch.utils.checkpoint``: the
    forward keeps no activations and the backward recomputes them.
    ``torch.utils.checkpoint`` restores only the device's default
    generator, and the port's dropout draws from ``generator``, so the
    recomputation draws from a fresh generator set to ``generator``'s state
    from before the forward: the same masks, hence the same gradients."""
    saved = None if generator is None else generator.get_state()
    calls = [0]

    def run(x):
        g = generator
        if calls[0] and generator is not None:
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
    """One captured window: the graph, its input buffers and its outputs."""

    def __init__(self, graph, x, y, loss, mets, ticks):
        self.graph, self.x, self.y, self.loss, self.mets = graph, x, y, loss, mets
        #: kernel launches recorded in the graph, by wrapper
        self.ticks = ticks
        self.replays = 0


class WindowedEngine:
    """Owns the training loop for one (model, rule) pair on one device."""

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
        if mesh is not None:
            raise _not_ported("mesh= (training over several cards)", "item 13")
        if int(seq_shards) != 1:
            raise _not_ported("seq_shards>1 (sequence parallelism)", "item 14")
        if fsdp:
            raise _not_ported("fsdp=True", "item 15")
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
        if self.use_graphs and self.remat:
            raise _not_ported("remat=True inside a captured window (unroll other than 1 on a "
                              "card)", "item 20 (CUDA-graph follow-ups)")
        self.num_workers = int(num_workers or device_count(self.device))
        # one card: every worker is a virtual worker on it (the cross-card
        # sum of the commit comes with ROADMAP Queue A item 13)
        self.n_dev, self.virtual = plan_workers(self.num_workers, 1)
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
        # captured windows, keyed as the JAX engine keys its epoch programs;
        # every graph reads and writes the one state ``_static`` holds
        self._graphs: dict = {}
        self._static: Optional[TrainState] = None
        #: captures made and windows replayed since the cache was last cleared
        self.graph_stats = {"captures": 0, "replays": 0}
        #: filled by :meth:`run_epoch_streaming`: source timing and the
        #: link-bound verdict of the last streamed epoch
        self.last_stream_report = None
        self._link_warned = False
        self._pinned: dict = {}
        self._copy_stream = None

    # ------------------------------------------------------------------ init
    def init_state(self, generator: torch.Generator, sample_input) -> TrainState:
        """Draw the initial parameters with ``adapter.init(generator,
        sample_input)``, give every worker a copy (and an optimizer and rule
        state), and seed one dropout generator per worker from
        ``generator``."""
        params, model_state = self.adapter.init(generator, sample_input)
        return self._assemble_state(generator, params, model_state)

    def _assemble_state(self, generator, params, model_state) -> TrainState:
        n, dev = self.num_workers, self.device
        params = tree_map(lambda x: x.detach().to(dev, copy=True), params)

        def tile(tree):
            # on the device: a rule's fresh counters (DynSGD's clock) start on the CPU
            return tree_map(lambda x: x.to(dev).expand(n, *x.shape).clone(), tree)

        seeds = torch.randint(0, 2**62, (n,), generator=generator)
        return TrainState(
            center_params=params,
            center_rule=tree_map(lambda x: x.to(dev), self.rule.init_center_state()),
            local_params=tile(params),
            opt_state=tile(self.optimizer.init(params)),
            model_state=tile(tree_map(torch.Tensor.detach, model_state)),
            rule_local=tile(self.rule.init_local_state(params)),
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
        new ``(params, opt_state, model_state)`` and this step's loss and
        metrics as device tensors."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            p, x_c = leaves, x
            if self.compute_dtype is not None:
                # f32 master params, cast inside the loss (engine.py:456-462
                # of the JAX package); autocast would not cast the same ops
                cast = self.compute_dtype
                p = tree_map(lambda t: t.to(cast) if t.is_floating_point() else t, leaves)
                x_c = x.to(cast) if x.is_floating_point() else x
            if self.remat:
                out, model_state = _remat_apply(self.adapter, p, model_state, x_c, generator)
            else:
                out, model_state = self.adapter.apply(p, model_state, x_c, training=True,
                                                      generator=generator)
            out = out.float()
            loss = self.loss_fn(out, y) + self.adapter.aux_loss(model_state)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = iter([torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)])
        grads = tree_map(lambda _: next(grads), leaves)
        with torch.no_grad():
            out = out.detach()
            mets = (torch.stack([m(out, y) for m in self.metric_fns]) if self.metric_fns
                    else torch.zeros((0,), device=out.device))
            updates, opt_state = self.optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, model_state, loss.detach(), mets

    # ---------------------------------------------------------------- window
    def _sync_model_state(self, ctx: CommitCtx, model_state):
        if not self.sync_model_state or not tree_leaves(model_state):
            return model_state
        mean = tree_map(lambda x: ctx.psum(x) / self.num_workers, model_state)
        return tree_where(ctx.mask, mean, model_state)

    def _worker_steps(self, state: TrainState, w: int, xs, ys):
        """Worker ``w`` takes one local step per leading row of ``xs``/``ys``
        (``[steps, batch, ...]``), from and into its slice of ``state``.
        Returns its losses ``[steps]`` and metrics ``[steps, n_metrics]``."""
        worker = lambda tree: tree_map(lambda x: x[w], tree)
        params, opt_state = worker(state.local_params), worker(state.opt_state)
        model_state = worker(state.model_state)
        losses, mets = [], []
        for t in range(xs.shape[0]):
            params, opt_state, model_state, loss, met = self._local_step(
                params, opt_state, model_state, state.rng[w], xs[t], ys[t])
            losses.append(loss)
            mets.append(met)
        with torch.no_grad():
            for dst, src in ((state.local_params, params), (state.opt_state, opt_state),
                             (state.model_state, model_state)):
                tree_map(lambda d, s: d[w].copy_(s), dst, src)
        return torch.stack(losses), torch.stack(mets)

    def _commit(self, state: TrainState, ctx: CommitCtx) -> TrainState:
        """The rule's commit over all workers, and the model state synced
        under the same mask, written into the state's tensors in place (a
        captured window replays into the same memory)."""
        with torch.no_grad():
            res = self.rule.commit(ctx, state.local_params, state.center_params,
                                   state.rule_local, state.center_rule)
            model_state = self._sync_model_state(ctx, state.model_state)
            _copy_into(
                (state.local_params, state.center_params, state.rule_local,
                 state.center_rule, state.model_state),
                (res.local_params, res.center_params, res.local_state, res.center_state,
                 model_state),
            )
        return state

    def _window_body(self, state: TrainState, xs, ys, do_commit: bool):
        """One window, in place: every worker takes ``xs.shape[1]`` local
        steps on its own rows of ``xs``/``ys`` (``[num_workers, window,
        batch, ...]``), then (``do_commit``) the rule commits all of them.
        Returns the window's loss and metrics, averaged over steps and
        workers, as device tensors."""
        n, window = self.num_workers, xs.shape[1]
        loss_sum, mets_sum = 0.0, 0.0
        for w in range(n):
            losses, mets = self._worker_steps(state, w, xs[w], ys[w])
            loss_sum = loss_sum + losses.mean()
            mets_sum = mets_sum + mets.mean(dim=0)
        if do_commit:
            self._commit(state, stacked_ctx(n, float(window), self.device))
        return loss_sum / n, mets_sum / n

    def _run_window(self, state: TrainState, xs, ys, do_commit: bool):
        """One window, eager or replayed from its captured graph.  Returns
        the state (the engine's captured state when graphs are on) and the
        window's loss and metrics."""
        if not self.use_graphs:
            loss, mets = self._window_body(state, xs, ys, do_commit)
            return state, loss, mets
        key = ("win", do_commit, tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype)
        state = self._adopt(state)
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(state, xs, ys, do_commit)
        captured.x.copy_(xs)
        captured.y.copy_(ys)
        captured.graph.replay()
        captured.replays += 1
        self.graph_stats["replays"] += 1
        return state, captured.loss.clone(), captured.mets.clone()

    def _adopt(self, state: TrainState) -> TrainState:
        """The state every captured window reads and writes: ``state`` itself
        the first time; later, when ``state`` holds other tensors (a
        restore, a fresh init), its values and generator states are copied
        into the captured ones."""
        static = self._static
        if static is None:
            self._static = state
            return state
        if _state_key(state) != _state_key(static):
            with torch.no_grad():
                _copy_into(_state_trees(static), _state_trees(state))
            for mine, theirs in zip(static.rng, state.rng):
                mine.set_state(theirs.get_state())
        return static.replace(epoch=state.epoch)

    def _capture(self, state: TrainState, xs, ys, do_commit: bool) -> _Captured:
        """Capture one window as a CUDA graph over ``state``'s tensors and
        static input buffers.  A warm-up window runs first on a side stream
        (lazy initialisation must not happen inside a capture) and is undone:
        the state's values and generators are restored.  Each worker's
        dropout generator is registered with the graph, so every replay
        draws fresh masks.  A failed capture raises: nothing falls back to
        eager."""
        from distkeras_tpu_torch.ops import (
            flash_attention,
            flash_attention_bwd_dkv,
            flash_attention_bwd_dq,
        )

        x, y = xs.clone(), ys.clone()
        leaves = tree_leaves(_state_trees(state))
        saved = [t.clone() for t in leaves]
        saved_rng = [g.get_state() for g in state.rng]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._window_body(state, x, y, do_commit)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, v in zip(leaves, saved):
                t.copy_(v)
        for g, v in zip(state.rng, saved_rng):
            g.set_state(v)
        del saved
        graph = torch.cuda.CUDAGraph()
        for g in state.rng:
            graph.register_generator_state(g)
        counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
        before = [c.launches for c in counters]
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            loss, mets = self._window_body(state, x, y, do_commit)
        # kernels launched inside the graph at each replay, by wrapper
        ticks = {c.__name__: c.launches - b for c, b in zip(counters, before)}
        self.graph_stats["captures"] += 1
        return _Captured(graph, x, y, loss, mets, ticks)

    def graph_launches(self) -> dict:
        """Kernel launches of the captured windows since the cache was last
        cleared, by wrapper, as ``(capture ticks, launches)``: a wrapper's
        counter ticks once per launch site at capture, which launches
        nothing, and each replay launches every recorded kernel once, so
        the launches are the ticks times the replays."""
        out: dict = {}
        for captured in self._graphs.values():
            for name, ticks in captured.ticks.items():
                t, n = out.get(name, (0, 0))
                out[name] = (t + ticks, n + ticks * captured.replays)
        return out

    def _run_stepwise(self, state: TrainState, xs, ys):
        """The staleness simulation over ``xs``/``ys`` shaped
        ``[num_workers, n_steps, batch, ...]``: each step, every worker takes
        one local step, then one masked commit runs over all of them.
        Returns the state and the per-step loss ``[n_steps]``, averaged over
        workers."""
        n = self.num_workers
        periods = torch.as_tensor(self.commit_schedule, device=self.device)
        since = torch.zeros(n, dtype=torch.int32, device=self.device)
        losses = []
        for t in range(xs.shape[1]):
            step = [self._worker_steps(state, w, xs[w, t:t + 1], ys[w, t:t + 1])[0]
                    for w in range(n)]
            since = since + 1
            mask = (t + 1) % periods == 0
            state = self._commit(state, stacked_ctx(n, since, self.device, mask))
            since = torch.where(mask, 0, since)
            losses.append(torch.cat(step).sum() / n)
        return state, torch.stack(losses)

    # ----------------------------------------------------------------- epoch
    def shard_batches(self, xs: np.ndarray, ys: np.ndarray):
        """Epoch data onto the device, as tensors of the arrays' dtypes."""
        return (torch.from_numpy(np.ascontiguousarray(xs)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(ys)).to(self.device))

    def _run_windows(self, state: TrainState, xs, ys):
        """Every window of ``xs``/``ys`` (``[num_workers, n_windows, window,
        batch, ...]``) in turn.  Returns the state and the per-window loss
        ``[n_windows]`` and metrics ``[n_windows, n_metrics]`` on the
        device; nothing is read back."""
        do_commit = self.rule.communication_window > 0
        losses, mets = [], []
        for i in range(xs.shape[1]):
            state, loss, met = self._run_window(state, xs[:, i], ys[:, i], do_commit)
            losses.append(loss)
            mets.append(met)
        return state, torch.stack(losses), torch.stack(mets)

    def run_epoch(self, state: TrainState, xs, ys):
        """Run one epoch over ``xs``/``ys`` shaped ``[num_workers,
        n_windows, window, batch, ...]`` (uniform windows) or
        ``[num_workers, n_steps, batch, ...]`` (staleness simulation).
        Returns the new state and the epoch's stats as numpy: ``loss``
        ``[n_windows]`` and ``metrics`` ``[n_windows, n_metrics]``, each
        averaged over the window's steps and the workers; or, simulating
        staleness, ``loss`` ``[n_steps]`` averaged over the workers and no
        metrics (``[0]``), as the JAX engine's stepwise program returns.
        The stats are read back once, at the end."""
        if self.commit_schedule is not None:
            state, losses = self._run_stepwise(state, xs, ys)
            stats = {"loss": losses.cpu().numpy(), "metrics": np.zeros((0,), np.float32)}
            return state.replace(epoch=state.epoch + 1), stats
        state, losses, mets = self._run_windows(state, xs, ys)
        stats = {"loss": losses.cpu().numpy(), "metrics": mets.cpu().numpy()}
        return state.replace(epoch=state.epoch + 1), stats

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
        windows only: the staleness simulation runs per epoch."""
        if self.commit_schedule is not None:
            raise ValueError(
                "run_epochs runs uniform windows; the staleness simulation "
                "dispatches per epoch (run_epoch)"
            )
        num_epochs = int(num_epochs)
        if num_epochs < 1:
            raise ValueError(f"num_epochs must be >= 1, got {num_epochs}")
        n_total = int(np.prod(xs.shape[:4]))
        losses, mets = [], []
        for _ in range(num_epochs):
            xs_e, ys_e = xs, ys
            if shuffle_seed is not None:
                perm = epoch_permutation(shuffle_seed, state.epoch, n_total, xs.device)
                perm = perm.to(xs.device)
                xs_e = xs.reshape((n_total,) + xs.shape[4:])[perm].reshape(xs.shape)
                ys_e = ys.reshape((n_total,) + ys.shape[4:])[perm].reshape(ys.shape)
            state, loss, met = self._run_windows(state, xs_e, ys_e)
            state = state.replace(epoch=state.epoch + 1)
            losses.append(loss)
            mets.append(met)
        return state, {"loss": torch.cat(losses).cpu().numpy(),
                       "metrics": torch.cat(mets).cpu().numpy()}

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
        self.graph_stats = {"captures": 0, "replays": 0}

    # ------------------------------------------------------------- streaming
    def stream_put(self, block):
        """Copy one streamed window block ``(xs, ys)`` shaped ``[num_workers,
        window, batch, ...]`` to the card, as ``[num_workers, 1, window,
        batch, ...]`` tensors: the copy half of the streaming path, which
        the :class:`~distkeras_tpu_torch.datapipe.PrefetchRing` runs on its
        producer thread.

        Float features go over in the compute dtype (the local step's first
        act is that cast, so it changes no value, and bf16 halves the
        bytes); blocks from the fused native bf16 gather arrive in it.  On
        a card each leaf goes through a pinned host buffer, copied with
        ``non_blocking=True`` on a copy stream; a pinned buffer is written
        again only once its previous copy has landed (its event), and the
        block carries the event the compute stream waits on before use."""
        xs, ys = (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(t))
                  for t in block)
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
        shaped ``[num_workers, window, batch, ...]`` (see
        :func:`distkeras_tpu_torch.data.epoch_window_iter`).

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
        buf = deque()
        losses, mets, done_events = [], [], []
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
                with telemetry.trace.span("window_dispatch", window=n_windows):
                    state, loss, met = self._run_window(state, xs[:, 0], ys[:, 0], do_commit)
                if self.device.type == "cuda":
                    for t in block:
                        t.record_stream(torch.cuda.current_stream(self.device))
                    done = torch.cuda.Event()
                    done.record()
                    done_events.append(done)
                n_windows += 1
                losses.append(loss)
                mets.append(met)
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
        stats = {"loss": torch.stack(losses).cpu().numpy(),
                 "metrics": torch.stack(mets).cpu().numpy(),
                 # per-window step counts, so the history can weight a ragged
                 # tail window by its steps
                 "window_steps": np.asarray(steps_list, np.int64)}
        return state.replace(epoch=state.epoch + 1), stats

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
    def average_workers(self, state: TrainState):
        """One-shot synchronous weight average (AveragingTrainer's final step)."""
        mean_p = tree_map(lambda x: x.mean(dim=0), state.local_params)
        return state.replace(center_params=mean_p), self.final_model_state(state)

    def final_model_state(self, state: TrainState):
        """Model state for the returned model: the mean over workers (the
        first worker's for integer buffers)."""
        return tree_map(lambda x: x.mean(dim=0) if x.is_floating_point() else x[0].clone(),
                        state.model_state)

    def worker_slice(self, tree, index: int):
        """One worker's copy of per-worker state."""
        return tree_map(lambda x: x[index].clone(), tree)

    def gather_center(self, state: TrainState):
        """The center parameters (one copy on this engine's device)."""
        return state.center_params
