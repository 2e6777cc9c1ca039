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
pipeline engine captures its windows too: on a (faked) card over one rank
it takes NCCL and refuses gloo by name, and a ``cuda`` case holds a
one-stage pipeline's captured windows to its eager ones bit for bit.  The
deadline-bounded wait a serving mesh puts after its replays
(``utils.graphs.wait_bounded``) is driven with a stub event and a stub
clock.  No JAX here: the ``cuda`` cases run on the card's machine, which
has none.
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


def test_pipeline_inside_a_captured_window_names_item_20(tmp_path):
    # Named for the refusal it replaced (ROADMAP Queue A item 20's last
    # part): the pipeline's ticks are fixed on the host, so a capture fixes
    # them too, and its windows are captured on a card (faked here: the
    # constructor touches none) over a one-rank group whose axis groups run
    # NCCL; a gloo group is refused by name
    import torch.distributed as dist

    from distkeras_tpu_torch.models import StagedLM
    from distkeras_tpu_torch.parallel import PipelineEngine
    from distkeras_tpu_torch.parallel.mesh import PP_AXIS, WORKER_AXIS, make_mesh_grid
    from test_torch_ring import capture_refusals

    model = StagedLM(vocab_size=23, dim=32, heads=2, num_stages=1, blocks_per_stage=1,
                     max_len=16)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        grid = make_mesh_grid(1, 1, axis_names=(WORKER_AXIS, PP_AXIS))
        got = capture_refusals(lambda: PipelineEngine(
            model, "token_crossentropy", "sgd", Downpour(WINDOW), mesh=grid, unroll=True,
            device="cuda"))
    finally:
        dist.destroy_process_group()
    assert got["nccl"] == "captures", got
    assert got["gloo"].startswith("ValueError") and "only NCCL collectives" in got["gloo"], got


class _Never:
    """A recorded event whose work never completes (a replay waiting on a
    dead peer)."""

    def __init__(self, done_after=None):
        self.polls, self.done_after = 0, done_after

    def query(self):
        self.polls += 1
        return self.done_after is not None and self.polls > self.done_after


def _stub_clock(monkeypatch):
    """``utils.graphs``'s clock, stubbed: a sleep advances it, and is kept."""
    import types

    from distkeras_tpu_torch.utils import graphs

    now, pauses = [0.0], []

    def sleep(s):
        pauses.append(s)
        now[0] += s

    monkeypatch.setattr(graphs, "time", types.SimpleNamespace(monotonic=lambda: now[0],
                                                              sleep=sleep))
    return (lambda: now[0]), pauses


def test_wait_bounded_aborts_and_raises_past_its_deadline(monkeypatch):
    from distkeras_tpu_torch.utils import graphs

    clock, pauses = _stub_clock(monkeypatch)
    aborted = []

    def abort():
        aborted.append(clock())
        return "its group was aborted in 0.001 s"

    with pytest.raises(TimeoutError, match="a replayed step did not complete within 0.5 s.*"
                                           "its group was aborted in 0.001 s"):
        graphs.wait_bounded(_Never(), 0.5, abort, "a replayed step")
    # the abort once, at the deadline and not before; the pauses doubling
    # from 10 us to their cap
    assert len(aborted) == 1 and 0.5 <= aborted[0] < 0.5 + graphs.POLL_MAX_S
    assert pauses[:3] == [1e-5, 2e-5, 4e-5] and max(pauses) == graphs.POLL_MAX_S


def test_wait_bounded_returns_when_the_event_completes(monkeypatch):
    from distkeras_tpu_torch.utils import graphs

    _, pauses = _stub_clock(monkeypatch)
    event, aborted = _Never(done_after=3), []
    graphs.wait_bounded(event, 0.5, lambda: aborted.append(True), "a replayed step")
    assert aborted == [] and event.polls == 4 and len(pauses) == 3


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


@pytest.mark.cuda
def test_pipeline_window_captured_on_the_card_is_eager_bitwise():
    # a one-stage pipeline (no group: no collective) in captured windows,
    # bit for bit its eager run; B1-B3 ticks x replays equal to the eager
    # launches (blocks x microbatches x local steps)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distkeras_tpu_torch.models import StagedLM
    from distkeras_tpu_torch.ops import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from distkeras_tpu_torch.parallel import PipelineEngine

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    model = StagedLM(vocab_size=23, dim=32, heads=2, num_stages=1, blocks_per_stage=2,
                     max_len=16)
    xs, ys = (a[:1] for a in lm_epoch())
    runs, launches = {}, {}
    for name, unroll in (("eager", 1), ("graph", True)):
        engine = PipelineEngine(model, "token_crossentropy", ("adam", {"learning_rate": 1e-3}),
                                Downpour(WINDOW), microbatches=2, metrics=(), unroll=unroll)
        state = engine.init_state(torch.Generator().manual_seed(0), None)
        sx, sy = engine.shard_batches(xs, ys)
        for c in counters:
            c.launches = 0
        losses = []
        for _ in range(2):
            state, stats = engine.run_epoch(state, sx, sy)
            losses.append(stats["loss"])
        launches[name] = [c.launches for c in counters]
        runs[name] = (np.concatenate(losses), engine.gather_center(state), engine)
    graph = runs["graph"][2]
    assert graph.use_graphs and graph.graph_stats == {"captures": 1, "replays": 2 * WINDOWS}
    np.testing.assert_array_equal(runs["graph"][0], runs["eager"][0])
    for key, sub in runs["eager"][1].items():
        for name, want in sub.items():
            assert torch.equal(runs["graph"][1][key][name], want), (key, name)
    ticks = graph.graph_launches()
    # 2 blocks x 2 microbatches x 2 epochs of WINDOWS x WINDOW steps
    want = [2 * 2 * 2 * WINDOWS * WINDOW] * 3
    assert [ticks[c.__name__][1] for c in counters] == launches["eager"] == want


@pytest.mark.parametrize("outcome", ["returns", "raises", "hangs"])
def test_abort_group_reports_how_the_abort_went_and_never_blocks(monkeypatch, outcome):
    # the abort runs on a daemon thread, waited for a bounded time: a caller
    # past its deadline fails whether the abort returns, raises or hangs
    import threading

    import torch.distributed as dist

    from distkeras_tpu_torch.utils import graphs

    release, seen = threading.Event(), []

    def abort(group):
        seen.append(group)
        if outcome == "raises":
            raise RuntimeError("communicator gone")
        if outcome == "hangs":
            release.wait(5.0)

    monkeypatch.setattr(dist.distributed_c10d, "_abort_process_group", abort)
    monkeypatch.setattr(graphs, "ABORT_WAIT_S", 0.2)
    try:
        note = graphs.abort_group("step group")
    finally:
        release.set()
    assert seen == ["step group"]
    want = {"returns": "its group was aborted in", "raises": "RuntimeError('communicator gone')",
            "hangs": "had not returned after 0.2 s"}[outcome]
    assert want in note, note
    assert graphs.abort_group(None) == "no group to abort"
