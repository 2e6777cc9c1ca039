"""The captured windows' program cache: ``WindowedEngine.clear_program_cache``.

Every captured window reads and writes one state, held with the graphs;
``clear_program_cache`` drops both, with or without ``keep_multi`` (the
JAX engine's multi-epoch program to keep: ``run_epochs`` here replays the
window graphs ``run_epoch`` replays, so there is none of its own).  On the
CPU there is no graph, so the CPU case fills the cache by hand; the
``cuda``-marked case captures, clears and captures again on a card, with
dropout on, and holds both captures to eager within the chip smoke's
gates (loss 1e-6 relative, center parameters 1e-5).  No JAX here: the
``cuda`` case runs on the card's machine, which has none.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.algorithms import Downpour
from distkeras_tpu_torch.models import TorchModel, TransformerLM
from distkeras_tpu_torch.parallel import WindowedEngine

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

LM = dict(vocab_size=23, dim=32, heads=2, num_layers=1, max_len=16)
WORKERS, WINDOWS, WINDOW, BATCH = 2, 2, 2, 4


def lm_epoch(seed=0):
    """The next-token task ``(token + 1) mod vocab`` in the engine's epoch
    layout ``[workers, windows, window, batch, seq]``."""
    n = WORKERS * WINDOWS * WINDOW * BATCH
    start = np.random.default_rng(seed).integers(0, LM["vocab_size"], (n, 1))
    x = (start + np.arange(LM["max_len"])) % LM["vocab_size"]
    shape = (WORKERS, WINDOWS, WINDOW, BATCH, LM["max_len"])
    return (x.reshape(shape).astype(np.int64),
            ((x + 1) % LM["vocab_size"]).reshape(shape).astype(np.int64))


def engine_and_state(device, unroll, dropout=0.0):
    model = TransformerLM(**LM, dropout=dropout, generator=torch.Generator().manual_seed(1))
    engine = WindowedEngine(TorchModel(model), "token_crossentropy",
                            ("adam", {"learning_rate": 1e-3}), Downpour(WINDOW),
                            num_workers=WORKERS, metrics=(), unroll=unroll, device=device)
    xs, ys = lm_epoch()
    state = engine.init_state(torch.Generator().manual_seed(0), torch.from_numpy(xs[0, 0, 0]))
    return engine, state, engine.shard_batches(xs, ys)


@pytest.mark.parametrize("keep_multi", [None, (2, None)])
def test_clear_program_cache_drops_every_graph(keep_multi):
    engine, state, _ = engine_and_state("cpu", unroll=True)
    assert engine.use_graphs is False  # unroll is a hint on the CPU
    engine._graphs[("win", True)] = object()
    engine._static = state
    engine.graph_stats = {"captures": 1, "replays": 3}
    engine.clear_program_cache(keep_multi=keep_multi)
    assert engine._graphs == {} and engine._static is None
    assert engine.graph_stats == {"captures": 0, "replays": 0}


@pytest.mark.cuda
def test_capture_clear_and_capture_again_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    eager, e_state, (xs, ys) = engine_and_state("cuda", unroll=1, dropout=0.1)
    graph, g_state, _ = engine_and_state("cuda", unroll=True, dropout=0.1)
    e_losses, g_losses = [], []
    for epoch in range(2):
        e_state, stats = eager.run_epoch(e_state, xs, ys)
        e_losses.append(stats["loss"])
        g_state, stats = graph.run_epoch(g_state, xs, ys)
        g_losses.append(stats["loss"])
        assert graph.graph_stats == {"captures": 1, "replays": WINDOWS}
        assert len(graph._graphs) == 1 and graph._static is not None
        if epoch == 0:
            graph.clear_program_cache()
            assert graph._graphs == {} and graph._static is None
            assert graph.graph_stats == {"captures": 0, "replays": 0}
    np.testing.assert_allclose(np.concatenate(g_losses), np.concatenate(e_losses), rtol=1e-6)
    for name, want in eager.gather_center(e_state).items():
        got = graph.gather_center(g_state)[name]
        assert float((got - want).abs().max()) <= 1e-5, name
