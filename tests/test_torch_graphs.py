"""The captured windows' program cache: ``WindowedEngine.clear_program_cache``.

Every captured window reads and writes one state, held with the graphs;
``clear_program_cache`` drops both, with or without ``keep_multi`` (the
JAX engine's multi-epoch program to keep: ``run_epochs`` here replays the
window graphs ``run_epoch`` replays, so there is none of its own).  On the
CPU there is no graph, so the CPU case fills the cache by hand; the
``cuda``-marked case captures, clears and captures again on a card, with
dropout on, and holds both captures to eager within the chip smoke's
gates (loss 1e-6 relative, center parameters 1e-5).  A second ``cuda``
case captures windows with the training dynamics on (``DISTKERAS_DYNAMICS``:
the stats computed inside the graph): the trajectory equals dynamics off
bit for bit, and the stats equal the eager engine's.  Two more ``cuda``
cases hold captures to eager within the same gates: ``remat=True`` inside
captured windows (the recomputation in the graph, the forward kernel
launched twice a forward), and the staleness simulation's epoch
(``commit_schedule``), one captured step replayed once a step.  A ``cuda``
case captures ADAG's windows with the dynamics on: the rule's steps in the
window, a host value, is filled in on the card and equals eager's.  The
pipeline engine, whose windows a card does not capture yet (ROADMAP Queue A
item 20's last part), refuses ``unroll`` on a (faked) card by name.  No JAX
here: the ``cuda`` cases run on the card's machine, which has none.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.algorithms import Adag, Downpour, DynSGD
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


def engine_and_state(device, unroll, dropout=0.0, rule=None, **kwargs):
    model = TransformerLM(**LM, dropout=dropout, generator=torch.Generator().manual_seed(1))
    if rule is None:
        rule = DynSGD(WINDOW) if "commit_schedule" in kwargs else Downpour(WINDOW)
    engine = WindowedEngine(TorchModel(model), "token_crossentropy",
                            ("adam", {"learning_rate": 1e-3}), rule,
                            num_workers=WORKERS, metrics=(), unroll=unroll, device=device,
                            **kwargs)
    xs, ys = lm_epoch()
    state = engine.init_state(torch.Generator().manual_seed(0), torch.from_numpy(xs[0, 0, 0]))
    if "commit_schedule" in kwargs:  # the stepwise layout [workers, steps, batch, seq]
        xs, ys = (a.reshape(WORKERS, WINDOWS * WINDOW, BATCH, -1) for a in (xs, ys))
    return engine, state, engine.shard_batches(xs, ys)


def held_to_eager(runs, eager, graph, e_state, g_state):
    """The captured run's losses within 1e-6 relative of the eager run's,
    its center parameters within 1e-5."""
    np.testing.assert_allclose(np.concatenate(runs["graph"]), np.concatenate(runs["eager"]),
                               rtol=1e-6)
    for name, want in eager.gather_center(e_state).items():
        got = graph.gather_center(g_state)[name]
        assert float((got - want).abs().max()) <= 1e-5, name


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


def test_pipeline_inside_a_captured_window_names_item_20():
    # the pipeline's ticks are fixed at capture: its windows are ROADMAP
    # Queue A item 20's last part, refused on a card (faked here: the
    # constructor touches none) by name
    from distkeras_tpu_torch.models import StagedLM
    from distkeras_tpu_torch.parallel import PipelineEngine
    from test_torch_ring import faked_card

    model = StagedLM(vocab_size=23, dim=32, heads=2, num_stages=1, blocks_per_stage=1,
                     max_len=16)
    with faked_card(), pytest.raises(NotImplementedError, match="item 20"):
        PipelineEngine(model, "token_crossentropy", "sgd", Downpour(WINDOW), unroll=True,
                       device="cuda")


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


@pytest.mark.cuda
def test_captured_window_dynamics_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distkeras_tpu_torch.telemetry import dynamics

    runs = {}
    try:
        for name, on, unroll in (("off", False, True), ("on", True, True), ("eager", True, 1)):
            dynamics.configure(enabled=on, watchdog="off")
            engine, state, (xs, ys) = engine_and_state("cuda", unroll)
            for _ in range(2):
                state, stats = engine.run_epoch(state, xs, ys)
            assert engine.use_graphs == (unroll is True)
            runs[name] = (stats, {k: v.cpu() for k, v in engine.gather_center(state).items()})
    finally:
        dynamics.configure()
    np.testing.assert_array_equal(runs["on"][0]["loss"], runs["off"][0]["loss"])
    for key, value in runs["off"][1].items():
        assert torch.equal(runs["on"][1][key], value), key
    assert "dynamics" not in runs["off"][0]
    assert sorted(runs["on"][0]["dynamics"]) == sorted(runs["eager"][0]["dynamics"])
    for key, value in runs["eager"][0]["dynamics"].items():
        np.testing.assert_allclose(runs["on"][0]["dynamics"][key], value, rtol=1e-5, atol=1e-7,
                                   err_msg=key)


@pytest.mark.cuda
def test_remat_inside_captured_windows_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distkeras_tpu_torch.ops import flash_attention

    eager, e_state, (xs, ys) = engine_and_state("cuda", unroll=1, dropout=0.1)
    graph, g_state, _ = engine_and_state("cuda", unroll=True, dropout=0.1, remat=True)
    runs = {"eager": [], "graph": []}
    for _ in range(2):
        e_state, stats = eager.run_epoch(e_state, xs, ys)
        runs["eager"].append(stats["loss"])
        g_state, stats = graph.run_epoch(g_state, xs, ys)
        runs["graph"].append(stats["loss"])
    held_to_eager(runs, eager, graph, e_state, g_state)
    assert graph.graph_stats == {"captures": 1, "replays": 2 * WINDOWS}
    # the forward kernel twice a forward (the recomputation), in the graph
    forwards = LM["num_layers"] * WORKERS * WINDOW
    assert graph.graph_launches()[flash_attention.__name__] == (2 * forwards,
                                                                4 * WINDOWS * forwards)


@pytest.mark.cuda
def test_staleness_epoch_captured_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    schedule = dict(commit_schedule=[1, 2])
    eager, e_state, (xs, ys) = engine_and_state("cuda", unroll=1, dropout=0.1, **schedule)
    graph, g_state, _ = engine_and_state("cuda", unroll=True, dropout=0.1, **schedule)
    runs = {"eager": [], "graph": []}
    for _ in range(2):
        e_state, stats = eager.run_epoch(e_state, xs, ys)
        runs["eager"].append(stats["loss"])
        g_state, stats = graph.run_epoch(g_state, xs, ys)
        runs["graph"].append(stats["loss"])
    held_to_eager(runs, eager, graph, e_state, g_state)
    steps = xs.shape[1]
    assert graph.graph_stats == {"captures": 1, "replays": 2 * steps}
    assert torch.equal(g_state.rule_local["clock"], e_state.rule_local["clock"])
    assert int(g_state.center_rule["num_updates"]) == int(e_state.center_rule["num_updates"]) \
        == 2 * (steps + steps // 2)


@pytest.mark.cuda
def test_adag_dynamics_in_captured_windows_on_the_card():
    # ADAG's ``rule_accum_steps`` is a host number (the window's steps): the
    # engine fills it in on the card, so the captured window records no
    # copy from host memory, and it reads as eager's
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distkeras_tpu_torch.telemetry import dynamics

    runs = {}
    try:
        dynamics.configure(enabled=True, watchdog="off")
        for name, unroll in (("eager", 1), ("graph", True)):
            engine, state, (xs, ys) = engine_and_state("cuda", unroll, rule=Adag(WINDOW))
            for _ in range(2):
                state, stats = engine.run_epoch(state, xs, ys)
            runs[name] = stats["dynamics"]
    finally:
        dynamics.configure()
    np.testing.assert_array_equal(runs["graph"]["rule_accum_steps"],
                                  np.full((WINDOWS, WORKERS), float(WINDOW), np.float32))
    for key, value in runs["eager"].items():
        np.testing.assert_allclose(runs["graph"][key], value, rtol=1e-5, atol=1e-7,
                                   err_msg=key)
