"""Fixtures of the benchmark's own tests: cells of ``BENCHMARK.json``
shrunk to a size the CPU runs in seconds, and the card check.

Run with ``python -m pytest portbench/tests`` from the checkout's root (the
``cuda``-marked tests run only on a card: ``python -m pytest -m cuda
portbench/tests``).  No test here imports JAX or the JAX package.
"""

import time

import pytest
import torch

from portbench import harness

torch.set_num_threads(2)


def shrink(cell: harness.Cell) -> harness.Cell:
    """``cell`` at tiny widths (vocabularies of about 100, width 32, two
    blocks), small batches and a light serving mix."""
    cfg, tr = cell.config, cell.traffic
    positions = 64 if tr["driver"] == "serve" else 16
    cfg.update(vocab_size=101, n_embd=32, n_head=2, n_layer=2, n_inner=128, n_positions=positions)
    if tr["driver"] == "train":
        tr.update(batch_size=4, seq_len=16, profile_seconds=0.5, windows_per_epoch=3)
    else:
        tr["prompt"].update(min=4, max=40, median=12)
        tr["output"].update(min=2, max=16, median=6)
        tr["max_total"] = 56
        tr["engine"].update(num_slots=4, page_size=8)
        tr["check"].update(min_tokens=20, sample=6)
        tr["arrivals"]["rate"] = 4.0
        tr["trace"].update(at=0.2, seconds=0.5)
    return cell


@pytest.fixture
def tiny_run():
    """``make(cell, seed, seconds, traced=False)``: a :class:`harness.Run`
    of a shrunk cell on the CPU, with the cell's own limits."""
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")

    def make(name, seed=1, seconds=2.0, traced=False):
        run = harness.Run(cell=shrink(harness.resolve(manifest, name)), seed=seed, seconds=seconds, traced=traced,
                          t0=time.perf_counter())
        run.device = torch.device("cpu")
        return run

    return make


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
