"""Training cells: one trainer of the port, run once, spanning set-up and
the window.

The driver makes the weights and the rows from the seed, builds the
traffic's trainer (``DOWNPOUR``) over a ``from_numpy`` frame
of ``windows_per_epoch`` commit windows a worker, and calls its ``train``.
Each window is replayed from one captured CUDA graph; the driver sees every
window end through the engine the trainer built (its ``_run_window``,
wrapped) and keeps the host at most two windows ahead of the card, so the
host's clock at a window end is the card's to within a window.  Epochs end
inside the window as often as a user's epoch of that many windows ends.

* The first window is captured and run; right after it the driver reads,
  per leaf, the norm of Adam's first moment and the center's change, and
  the window's loss: what the reference follows.
* The window opens at the end of window ``warm_windows``, with the card
  synchronised, and closes, synchronised again, at the first window end
  ``--seconds`` later, when the driver stops the trainer.  Every local step
  completed in between counts, over all the time in between.  A ``--trace
  1`` run profiles the window from its start and closes it at the first
  window end ``profile_seconds`` later.

After the window the memory peak is read, the program's state freed, and
the reference (``portbench/reference``) runs the first window again in
float32 from the same weights and rows.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import checks, flops, harness, peaks, program, tracing
from portbench import traffic as gen
from portbench import weights as wmod
from portbench.reference import models as rmodels
from portbench.reference import train as rtrain
from portbench.reference.products import products

#: windows the host may run ahead of the card
AHEAD = 2


class WindowClosed(Exception):
    """Raised at a window end to stop the trainer: the window is over."""


class Probe:
    """Watches the engine's windows: the first window's readings, the end
    of set-up, the measured windows and the traced stretch."""

    def __init__(self, run: harness.Run, w0, warm_windows: int, profile_seconds: float):
        self.run = run
        self.w0 = w0
        self.warm_windows = warm_windows
        self.profile_seconds = profile_seconds
        self.windows = 0
        self.window_windows = 0
        self.first = None
        self.window_start = self.window_end = None
        self.stretch = tracing.Stretch()
        self.pending = []
        self.num_workers = run.cell.traffic["num_workers"]

    def attach(self, engine) -> None:
        run_window = engine._run_window

        def watched(state, xs, ys, do_commit):
            with tracing.span("engine.window"):
                out = run_window(state, xs, ys, do_commit)
            self.after_window(out)
            return out

        engine._run_window = watched

    def _sync(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        self.pending.clear()

    def _bound_ahead(self) -> None:
        """Wait until the window ``AHEAD`` back has run on the card."""
        if self.run.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record()
        self.pending.append(event)
        if len(self.pending) > AHEAD:
            self.pending.pop(0).synchronize()

    def after_window(self, out) -> None:
        self.windows += 1
        self._bound_ahead()
        if self.windows == 1:
            self.first = self._readings(out[0], out[1])
            self.w0 = None
        if self.windows < self.warm_windows:
            return
        if self.windows == self.warm_windows:
            self._sync()
            self.window_start = time.perf_counter()
            if self.run.traced:
                self.stretch.start()
            return
        self.window_windows += 1
        limit = self.profile_seconds if self.run.traced else self.run.seconds
        if time.perf_counter() - self.window_start >= limit:
            self._sync()
            self.window_end = time.perf_counter()
            if self.run.traced:
                self.stretch.stop()
            raise WindowClosed

    @torch.no_grad()
    def _readings(self, state, loss_sum) -> dict:
        """The first window's mean loss, per leaf the norm of Adam's first
        moment (worker 0), and the center's change (kept on the host until
        the reference has run)."""
        names = list(self.w0)
        mu = state.opt_state["mu"]
        moments = torch.stack([mu[k][0].double().norm() for k in names]).cpu().tolist()
        change = {k: (state.center_params[k] - self.w0[k]).cpu() for k in names}
        return {"loss": float(loss_sum) / self.num_workers, "mu": dict(zip(names, moments)),
                "change": change}


def first_batches(traffic: dict, x, y, device):
    """The first window's batches as the engine feeds worker 0: rows
    ``[t * batch, (t + 1) * batch)`` at step ``t`` (no shuffle)."""
    b, window = traffic["batch_size"], traffic["trainer_kwargs"]["communication_window"]
    as_t = lambda a: torch.as_tensor(a, device=device).long()
    return [(as_t(x[t * b:(t + 1) * b]), as_t(y[t * b:(t + 1) * b])) for t in range(window)]


def reference_window(config: dict, traffic: dict, seed: int, device, mode: str = "float32",
                     rows: slice = slice(None), lr: float = None) -> dict:
    """The first window worked out by the reference at precision ``mode``
    (:func:`portbench.reference.train.first_window`); ``rows`` takes part
    of each batch and ``lr`` replaces the learning rate (planted faults)."""
    x, y = gen.train_rows(seed, traffic, config["vocab_size"], rows_per_epoch(traffic))
    w0 = wmod.make(config, seed, device)
    batches = [(bx[rows], by[rows]) for bx, by in first_batches(traffic, x, y, device)]
    lr = traffic["optimizer"][1]["learning_rate"] if lr is None else lr
    with products(mode) as mm:
        return rtrain.first_window(w0, batches, rmodels.loss_fn(config), mm, traffic["trainer"],
                                   lr)


def rows_per_epoch(traffic: dict) -> int:
    """``windows_per_epoch`` commit windows of every worker."""
    return (traffic["num_workers"] * traffic["batch_size"]
            * traffic["trainer_kwargs"]["communication_window"] * traffic["windows_per_epoch"])


def run(run: harness.Run) -> None:
    config, traffic, device = run.cell.config, run.cell.traffic, run.device
    module = program.build(config)
    program.check_layout(module, wmod.table(config))
    w0 = wmod.make(config, run.seed, device)
    rows = rows_per_epoch(traffic)
    x, y = gen.train_rows(run.seed, traffic, config["vocab_size"], rows)
    probe = Probe(run, w0, traffic["warm_windows"], traffic["profile_seconds"])
    trainer = program.trainer(traffic, module, w0, run.seed, probe.attach, device)
    del w0
    try:
        with tracing.span("trainer.train"):
            trainer.train(program.frame(x, y))
        raise RuntimeError("the trainer ended before the window closed")
    except WindowClosed:
        pass
    run.memory_peak_bytes = harness.memory_peak(device)
    print(f"setup_s {probe.window_start - run.t0!r}", file=sys.stderr)
    del trainer
    harness.free_memory(device)

    window = traffic["trainer_kwargs"]["communication_window"]
    steps = probe.window_windows * window * traffic["num_workers"]
    samples = steps * traffic["batch_size"]
    seconds = probe.window_end - probe.window_start
    per_sample = flops.train_flops_per_sample(config, traffic["seq_len"])
    run.attempted, run.failed = steps, 0
    run.end_to_end["setup_s"] = probe.window_start - run.t0
    run.end_to_end["train_samples_per_s"] = samples / seconds
    run.end_to_end["train_mfu"] = 100.0 * samples * per_sample / seconds / peaks.PEAK_FLOPS[
        traffic["compute_dtype"]]
    run.facts.update(module=module, steps=steps, samples=samples, seconds=seconds,
                     flops_per_sample=per_sample, window=window)
    if run.traced:
        run.trace = tracing.summarize(probe.stretch.path)
        harness.measure_per_layer(run)

    ref = reference_window(config, traffic, run.seed, device)
    numbers = run.facts["numbers"] = checks.train_numbers(probe.first, ref)
    for name, limit in run.cell.limits["checks"].items():
        run.check(name, numbers[name], limit["limit"])
