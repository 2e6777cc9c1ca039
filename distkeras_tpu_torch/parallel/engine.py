"""The training engine: windowed local SGD + commits, on one card.

The port of :mod:`distkeras_tpu.parallel.engine` (``WindowedEngine`` in its
uniform-window mode).  A *worker* is a logical training replica.  Every
per-worker tensor carries a leading ``[num_workers]`` dim, the layout of
the JAX engine's state; the parameter-server center variable has none.
One epoch is a loop over commit windows: in each window every worker takes
``window`` local optimizer steps, then the rule's ``commit`` runs once over
all workers, its ``psum`` a sum over the worker dim.

Deliberate differences from the JAX engine:

* Workers on one card run **one after another** inside a window.  JAX
  batches them with ``vmap``, a compile-time transform that
  ``torch.func.vmap`` cannot apply to a kernel launched through ``ctypes``.
  Workers are independent between commits, so the result is the same.
* Steps run eagerly: there is no jitted epoch program, no donation and no
  scan unroll.  ``run_epoch`` consumes its input state (its tensors are
  updated in place), as the JAX engine's donated dispatch does.
* Dropout randomness is one ``torch.Generator`` per worker on the card,
  seeded from the init generator (JAX splits a key per worker).

Not in this slice: several cards (the cross-card sum of the commit),
sequence parallelism, FSDP, rematerialisation and the stepwise staleness
simulation (``commit_schedule``), whose options the constructor refuses;
and the dynamics telemetry (``DISTKERAS_DYNAMICS`` is not read).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, List, Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch.algorithms.base import CommitCtx, UpdateRule, stacked_ctx
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import get_metric, per_token_metric_names
from distkeras_tpu_torch.ops.optimizers import apply_updates, get_optimizer
from distkeras_tpu_torch.parallel.mesh import resolve_device
from distkeras_tpu_torch.utils.pytree import tree_leaves, tree_map, tree_where

if TYPE_CHECKING:  # models.adapter imports this package (resolve_device)
    from distkeras_tpu_torch.models.adapter import ModelAdapter

__all__ = ["TrainState", "WindowedEngine", "device_count", "plan_workers"]


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
        if commit_schedule is not None:
            raise _not_ported("commit_schedule (the stepwise staleness simulation)", "item 9")
        if remat:
            raise _not_ported("remat=True", "item 9")
        if unroll != 1:
            raise _not_ported("unroll (a scan unroll of the jitted epoch)", "item 9")
        if mesh is not None:
            raise _not_ported("mesh= (training over several cards)", "item 13")
        if int(seq_shards) != 1:
            raise _not_ported("seq_shards>1 (sequence parallelism)", "item 14")
        if fsdp:
            raise _not_ported("fsdp=True", "item 15")
        self.adapter = adapter
        self.rule = rule
        self.device = resolve_device(device)
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
            return tree_map(lambda x: x.expand(n, *x.shape).clone(), tree)

        seeds = torch.randint(0, 2**62, (n,), generator=generator)
        return TrainState(
            center_params=params,
            center_rule=tree_map(lambda x: x.to(dev), self.rule.init_center_state()),
            local_params=tile(params),
            opt_state=tile(self.optimizer.init(params)),
            model_state=tile(tree_map(lambda x: x.detach().to(dev), model_state)),
            rule_local=tile(self.rule.init_local_state(params)),
            rng=[torch.Generator(device=dev).manual_seed(int(s)) for s in seeds],
            epoch=0,
        )

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

    def _run_window(self, state: TrainState, xs, ys, do_commit: bool):
        """One window: every worker takes ``xs.shape[1]`` local steps on its
        own rows of ``xs``/``ys`` (``[num_workers, window, batch, ...]``),
        then (``do_commit``) the rule commits all of them.  Returns the
        window's loss and metrics, averaged over steps and workers."""
        n, window = self.num_workers, xs.shape[1]
        loss_sum, mets_sum = 0.0, 0.0
        for w in range(n):
            worker = lambda tree, w=w: tree_map(lambda x: x[w], tree)
            params, opt_state = worker(state.local_params), worker(state.opt_state)
            model_state = worker(state.model_state)
            losses, mets = [], []
            for t in range(window):
                params, opt_state, model_state, loss, met = self._local_step(
                    params, opt_state, model_state, state.rng[w], xs[w, t], ys[w, t])
                losses.append(loss)
                mets.append(met)
            with torch.no_grad():
                for dst, src in ((state.local_params, params), (state.opt_state, opt_state),
                                 (state.model_state, model_state)):
                    tree_map(lambda d, s, w=w: d[w].copy_(s), dst, src)
            loss_sum = loss_sum + torch.stack(losses).mean()
            mets_sum = mets_sum + torch.stack(mets).mean(dim=0)
        if do_commit:
            ctx = stacked_ctx(self.num_workers, float(window), self.device)
            with torch.no_grad():
                res = self.rule.commit(ctx, state.local_params, state.center_params,
                                       state.rule_local, state.center_rule)
                model_state = self._sync_model_state(ctx, state.model_state)
            state = state.replace(
                local_params=res.local_params, center_params=res.center_params,
                rule_local=res.local_state, center_rule=res.center_state,
                model_state=model_state,
            )
        return state, loss_sum / n, mets_sum / n

    # ----------------------------------------------------------------- epoch
    def shard_batches(self, xs: np.ndarray, ys: np.ndarray):
        """Epoch data onto the device, as tensors of the arrays' dtypes."""
        return (torch.from_numpy(np.ascontiguousarray(xs)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(ys)).to(self.device))

    def run_epoch(self, state: TrainState, xs, ys):
        """Run one epoch over ``xs``/``ys`` shaped ``[num_workers,
        n_windows, window, batch, ...]``.  Returns the new state and the
        epoch's stats as numpy: ``loss`` ``[n_windows]`` and ``metrics``
        ``[n_windows, n_metrics]``, each averaged over the window's steps
        and the workers.  The stats are read back once, at the end."""
        n_windows = xs.shape[1]
        do_commit = self.rule.communication_window > 0
        losses, mets = [], []
        for i in range(n_windows):
            state, loss, met = self._run_window(state, xs[:, i], ys[:, i], do_commit)
            losses.append(loss)
            mets.append(met)
        stats = {"loss": torch.stack(losses).cpu().numpy(),
                 "metrics": torch.stack(mets).cpu().numpy()}
        return state.replace(epoch=state.epoch + 1), stats

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
