"""Pipeline x tensor parallelism in the port: the pipeline engine over the
``(workers, stages, model)`` grid of four gloo ranks on the CPU (1 workers
rank x 2 stages x 2 model ranks), case by case against tests/test_pp_tp.py
and tests/test_pp_fsdp.py :: test_pp_tp_fsdp_trajectory_matches_pp_fsdp: the
JAX package's ``PipelineEngine(tp_shards=2)`` on four of its CPU devices,
and the port's own sequential executor and one-rank trainer.  The 3-D grid's
axis groups and collectives are checked first, on three grids.  What a
card captures is shown on the CPU as in ``test_torch_pipeline.py``
(``capture_case``): pp x tp, with and without fsdp.

Four ranks are spawned **once** for the module (``ranks`` fixture, the
pattern of ``test_torch_pipeline.py``): each runs this file as a script,
joins the gloo group through a file store, runs every case and writes its
results.  Both packages start from the same parameters (the JAX staged
model's initial parameters, carried over with ``params_from_flax``; the JAX
engines' states are built around them with ``state_from_center``), and the
data come from one numpy seed.  The JAX engines run in the pytest process
while the ranks run.

Tolerances: JAX's own (tests/test_pp_tp.py): losses ``rtol=2e-4,
atol=2e-5``, the center ``rtol=2e-3, atol=2e-4``; the pipelined forward
against the sequential one within 1e-5; fsdp against the port's replicated
run bit for bit; the elements a rank stores equal to JAX's shard sizes; the
collectives, which move and add small integers, exactly.  Under Adam the key
third of the fused ``qkv`` bias is held to its round-off bound
(``test_torch_pipeline.hold_key_third``).

:func:`spawn_grid_ranks`, :func:`jax_run` and :func:`capture_cases` are
shared with ``test_torch_pp_sp.py``.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

from test_torch_pipeline import (  # noqa: E402
    ADAM,
    LM,
    SGD,
    _data,
    _load,
    assert_run,
    classifier,
    flat,
    hold_key_third,
    lm_text,
    staged,
)

ROOT = Path(__file__).resolve().parent.parent
WORLD, STAGES, SHARDS = 4, 2, 2
TOL = dict(rtol=2e-4, atol=2e-5)
CENTER_TOL = dict(rtol=2e-3, atol=2e-4)
FWD_TOL = 1e-5
# the grids the axis check runs on: every axis of size 2 in one of them
GRIDS = ((1, 2, 2), (2, 1, 2), (2, 2, 1))


# ------------------------------------------------------- shared with the ranks

def engine(workdir, kind="cls", opt=SGD, seq=False, num_workers=1, device="cpu", **kwargs):
    """The port's pipeline engine on the JAX initial parameters: 1 worker,
    2 microbatches, Downpour(2)."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.parallel import PipelineEngine

    loss = "token_crossentropy" if kind == "lm" else "categorical_crossentropy"
    model = staged(kind, _load(workdir, kind), **({"seq_axis": "seq"} if seq else {}))
    return PipelineEngine(model, loss, opt, algorithms.Downpour(2), num_workers,
                          microbatches=2, metrics=(), device=device, **kwargs)


def capture_cases(workdir, third: str, cases) -> dict:
    """``test_torch_pipeline.capture_case`` for the staged LM on the 1 x 2 x
    2 grid whose third axis is ``third``, each of ``cases`` (name, the
    engine's keyword arguments)."""
    from distkeras_tpu_torch.parallel.mesh import PP_AXIS, WORKER_AXIS, make_mesh_grid
    from test_torch_pipeline import capture_case

    grid = make_mesh_grid(1, STAGES, SHARDS, axis_names=(WORKER_AXIS, PP_AXIS, third))
    return {name: capture_case(lambda device: engine(workdir, "lm", ADAM, mesh=grid,
                                                     unroll=True, device=device, **kwargs),
                               "lm")
            for name, kwargs in cases}


def save_captures(workdir, rank, capture) -> None:
    import json

    with open(os.path.join(workdir, f"capture_{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(capture, fh)


def run(eng, kind, epochs=2):
    """Two epochs: ``(losses and center under flat names, final state)``."""
    xs, ys = _data(kind)
    state = eng.init_state(torch.Generator().manual_seed(0), None)
    sx, sy = eng.shard_batches(xs, ys)
    losses = []
    for _ in range(epochs):
        state, stats = eng.run_epoch(state, sx, sy)
        losses.append(stats["loss"])
    return {**flat(eng.gather_center(state), "center/"), "loss": np.concatenate(losses)}, state


def numel(tree) -> dict:
    """Elements a rank stores, per top-level key of a staged tree."""
    return {k: np.asarray(sum(x.numel() for x in sub.values())) for k, sub in tree.items()}


def forward_case(workdir, kind, seq=False, **kwargs):
    """The pipelined view on this rank's leaves against the sequential
    executor on the whole parameters (with a seq axis, this rank's block of
    a per-token model's outputs)."""
    from distkeras_tpu_torch.parallel.mesh import SEQ_AXIS, bind_mesh, resolve_axis
    from distkeras_tpu_torch.utils.pytree import tree_map

    xs, _ = _data(kind)
    eng = engine(workdir, kind, seq=seq, **kwargs)
    state = eng.init_state(torch.Generator().manual_seed(0), None)
    local = tree_map(lambda t: t[0], state.local_params)
    x = torch.from_numpy(xs[0, 0, 0])
    want = staged(kind).apply(_load(workdir, kind), {}, x)[0]
    if seq:
        ax = resolve_axis(SEQ_AXIS, eng.mesh)
        block = x.shape[1] // ax.size
        x = x[:, ax.index * block:(ax.index + 1) * block]
        if kind == "lm":
            want = want[:, ax.index * block:(ax.index + 1) * block]
    with torch.no_grad(), bind_mesh(eng.mesh):
        got = eng.adapter.apply(local, {}, x)[0]
    return {"err": np.asarray(float((got - want).abs().max())),
            "shape": np.asarray(got.shape)}


def trainer_case(**kwargs):
    """``DOWNPOUR(..., pipeline_stages=2, **kwargs)`` on the staged LM
    through ``train(frame)``, ``num_workers`` left to its default."""
    import distkeras_tpu_torch as tdk

    x, y = lm_text(n=64)
    model = staged("lm", **({"seq_axis": "seq"} if kwargs.get("seq_shards", 1) > 1 else {}))
    t = tdk.DOWNPOUR(model, loss="token_crossentropy", metrics=("token_accuracy",),
                     worker_optimizer=ADAM, batch_size=8, num_epoch=2, communication_window=2,
                     pipeline_stages=STAGES, pp_microbatches=2, seed=3, device="cpu", **kwargs)
    trained = t.train(tdk.from_numpy(x, y))
    return {"loss": np.asarray(t.get_history()["loss"]), **flat(trained.params, "params/"),
            "predict": trained.predict(x[:4]), "num_workers": np.asarray(t.num_workers),
            "twin_seq_axis": np.asarray(str(trained.adapter.seq_axis))}


def one_rank_trainer():
    """The trainer case's run on one rank (``pipeline_stages=1``), and the
    initial parameters its seed draws."""
    import distkeras_tpu_torch as tdk

    x, y = lm_text(n=64)
    t = tdk.DOWNPOUR(staged("lm"), loss="token_crossentropy", metrics=("token_accuracy",),
                     worker_optimizer=ADAM, num_workers=1, batch_size=8, num_epoch=2,
                     communication_window=2, seed=3, device="cpu")
    trained = t.train(tdk.from_numpy(x, y))
    init = staged("lm").init(torch.Generator().manual_seed(3), None)[0]
    return ({"loss": np.asarray(t.get_history()["loss"]), **flat(trained.params, "params/")},
            init["blocks"]["attn.qkv.bias"].numpy())


def assert_trainer(got, want, init):
    """The trainer's run against the one-rank run (2 epochs of 8 steps), and
    a whole model that predicts on one rank."""
    got, want = hold_key_third(got, want, init, 16, "params/")
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    for name in (k for k in want if k.startswith("params/")):
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **CENTER_TOL)
    assert got["predict"].shape == (4, 16, 50)
    np.testing.assert_allclose(got["predict"].sum(-1), 1.0, rtol=1e-5)
    assert int(got["num_workers"]) == 1


def _grid_case(rank):
    """Each axis of each of :data:`GRIDS`: its group's ranks, and a ring
    shift (and its backward), a sum, ``broadcast_from_last`` and a
    reduce-scatter over it, on inputs that name their rank."""
    import torch.distributed as dist

    from distkeras_tpu_torch.parallel.mesh import (
        PP_AXIS,
        TP_AXIS,
        WORKER_AXIS,
        _reduce_scatter,
        all_reduce_sum,
        axis_group,
        broadcast_from_last,
        make_mesh_grid,
        ppermute,
        resolve_axis,
    )

    names = (WORKER_AXIS, PP_AXIS, TP_AXIS)
    out = {}
    for dims in GRIDS:
        grid = make_mesh_grid(*dims, axis_names=names)
        for axis in names:
            ax = resolve_axis(axis, grid)
            key = f"{'x'.join(map(str, dims))}_{axis}"
            x = torch.arange(4.0) + 10.0 * rank
            x.requires_grad_(True)
            shifted = ppermute(x, axis, 1, grid)
            (back,) = torch.autograd.grad((shifted * (1.0 + rank)).sum(), x)
            last = x.detach() if ax.index == ax.size - 1 else torch.zeros(4)
            out[key] = {
                "group": np.asarray(dist.get_process_group_ranks(axis_group(grid, axis))),
                "index": np.asarray(ax.index), "size": np.asarray(ax.size),
                "shift": shifted.detach().numpy(), "back": back.numpy(),
                "sum": all_reduce_sum([x.detach()], ax.group)[0].numpy(),
                "bfl": broadcast_from_last(last, axis, grid).numpy(),
                "scatter": _reduce_scatter(x.detach(), ax, 0).numpy(),
            }
    return out


def spawn_grid_ranks(script, workdir):
    """Start the four ranks of ``script`` (``test_torch_ring.start_ranks``)."""
    from test_torch_ring import start_ranks

    return start_ranks(script, WORLD, workdir)


def read_ranks(workdir):
    out = []
    for r in range(WORLD):
        results = {}
        with np.load(os.path.join(workdir, f"rank_{r}.npz")) as got:
            for key in got.files:
                case, _, name = key.partition("|")
                results.setdefault(case, {})[name] = got[key]
        out.append(results)
    return out


def save_rank(workdir, rank, results):
    np.savez(os.path.join(workdir, f"rank_{rank}.npz"),
             **{f"{c}|{k}": v for c, r in results.items() for k, v in r.items()})


# ------------------------------------------------------------------ the ranks

def _layout(state):
    """This rank's stored shapes and elements."""
    return {"center_block": np.asarray(state.center_params["blocks"]["fc1.weight"].shape),
            "local_block": np.asarray(state.local_params["blocks"]["fc1.weight"].shape),
            "center_qkv_bias": np.asarray(state.center_params["blocks"]["attn.qkv.bias"].shape),
            "center_ln": np.asarray(state.center_params["blocks"]["ln1.weight"].shape),
            "center_tok": np.asarray(state.center_params["embed"]["tok_embed.weight"].shape),
            **{f"center_{k}": v for k, v in numel(state.center_params).items()},
            **{f"local_{k}": v for k, v in numel(state.local_params).items()}}


def _cases(workdir):
    out = {}
    out["cls"], state = run(engine(workdir, tp_shards=SHARDS), "cls")
    out["layout"] = _layout(state)
    out["cls_fsdp"], state = run(engine(workdir, tp_shards=SHARDS, fsdp=True), "cls")
    out["layout_fsdp"] = _layout(state)
    out["lm"], state = run(engine(workdir, "lm", ADAM, tp_shards=SHARDS), "lm")
    out["layout_lm"] = {
        **_layout(state),
        "moments": np.asarray([tuple(m["blocks"]["fc1.weight"].shape)
                               for m in state.opt_state.values()
                               if isinstance(m, dict) and "blocks" in m])}
    out["forward"] = forward_case(workdir, "cls", tp_shards=SHARDS)
    out["trainer"] = trainer_case(tp_shards=SHARDS)
    try:
        engine(workdir, num_workers=4, tp_shards=SHARDS)
        out["refused"] = {"rows": np.asarray("")}
    except ValueError as e:
        out["refused"] = {"rows": np.asarray(str(e))}
    return out


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    from distkeras_tpu_torch.parallel.mesh import TP_AXIS

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        results = {**{f"grid_{k}": v for k, v in _grid_case(rank).items()}, **_cases(workdir)}
        capture = capture_cases(workdir, TP_AXIS, (("tp", dict(tp_shards=SHARDS)),
                                                   ("tp_fsdp", dict(tp_shards=SHARDS,
                                                                    fsdp=True))))
    finally:
        dist.destroy_process_group()
    save_rank(workdir, rank, results)
    save_captures(workdir, rank, capture)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------------- test process

def jax_model(kind, seq=None):
    from distkeras_tpu.models import StagedLM, StagedTransformer
    from test_torch_pipeline import CLS

    return StagedLM(**LM, seq_axis=seq) if kind == "lm" else StagedTransformer(**CLS, seq_axis=seq)


def jax_init(kind):
    """The JAX staged model's initial parameters (flax), and under the
    port's names."""
    import jax

    from test_torch_pipeline import to_port

    xs, _ = _data(kind)
    params, _ = jax_model(kind).init(jax.random.PRNGKey(0), xs[0, 0, 0])
    return params, to_port(kind, jax.tree.map(np.asarray, params))


def jax_run(kind, params, fsdp=False, epochs=2, **kwargs):
    """JAX's ``PipelineEngine`` on four CPU devices (1 worker, 2
    microbatches, Downpour(2)) from ``params``: ``(losses and center under
    the port's flat names, the elements of each top-level key's first shard,
    center and per-worker, as the engine places the state and after the
    epochs)``.  The state is built with ``state_from_center``
    (a seq-axis engine's ``init_state`` inits op by op inside ``shard_map``,
    many seconds on the CPU; the states agree, the rule's fresh)."""
    import jax

    from distkeras_tpu.algorithms import Downpour
    from distkeras_tpu.parallel import PipelineEngine
    from distkeras_tpu.parallel.mesh import SEQ_AXIS
    from test_torch_pipeline import to_port

    seq = SEQ_AXIS if kwargs.get("seq_shards", 1) > 1 else None
    loss, opt = (("token_crossentropy", ADAM) if kind == "lm"
                 else ("categorical_crossentropy", SGD))
    eng = PipelineEngine(jax_model(kind, seq), loss, opt, Downpour(2), num_workers=1,
                         microbatches=2, metrics=(), fsdp=fsdp, devices=jax.devices()[:WORLD],
                         **kwargs)
    state = eng.state_from_center(jax.random.PRNGKey(0), params,
                                  Downpour(2).init_center_state(), {}, 0)

    def shards(state):
        return {f"{where}_{k}": sum(leaf.addressable_shards[0].data.size
                                    for leaf in jax.tree.leaves(tree[k]))
                for where, tree in (("center", state.center_params),
                                    ("local", state.local_params))
                for k in tree}

    placed = shards(state)
    xs, ys = _data(kind)
    sx, sy = eng.shard_batches(xs, ys)
    losses = []
    for _ in range(epochs):
        state, stats = eng.run_epoch(state, sx, sy)
        losses.append(np.asarray(stats["loss"]))
    center = to_port(kind, jax.tree.map(np.asarray, eng.gather_center(state)))
    trained = shards(state)
    return ({**flat(center, "center/"), "loss": np.concatenate(losses)},
            {"placed": placed, "trained": trained})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(results of every rank, JAX's runs, the one-rank trainer's run,
    every rank's capture cases)``: the JAX initial parameters are written
    for the ranks, which start; the JAX engines and the one-rank trainer
    run meanwhile."""
    from test_torch_pipeline import read_captures
    from test_torch_ring import wait_ranks

    workdir = str(tmp_path_factory.mktemp("pp_tp"))
    params, ports = {}, {}
    for kind in ("cls", "lm"):
        params[kind], ports[kind] = jax_init(kind)
        np.savez(os.path.join(workdir, f"init_{kind}.npz"), **flat(ports[kind]))
    procs = spawn_grid_ranks(__file__, workdir)
    try:
        jax_runs = {"cls": jax_run("cls", params["cls"], tp_shards=SHARDS),
                    "cls_fsdp": jax_run("cls", params["cls"], fsdp=True, tp_shards=SHARDS),
                    "lm": jax_run("lm", params["lm"], tp_shards=SHARDS),
                    "lm_init": ports["lm"]}
        trainer = one_rank_trainer()
    finally:
        wait_ranks(procs, workdir)
    return read_ranks(workdir), jax_runs, trainer, read_captures(workdir, WORLD)


def _coords(rank, dims):
    return np.unravel_index(rank, dims)


def test_grid_axis_groups_hold_the_ranks_that_share_the_other_coordinates(ranks):
    """On every grid and axis: the group is the ranks that differ only along
    the axis, in axis order; the ring shift, its backward, the sum,
    ``broadcast_from_last`` and the reduce-scatter move what they must."""
    got = ranks[0]
    for dims in GRIDS:
        for a, axis in enumerate(("workers", "stages", "model")):
            for rank in range(WORLD):
                c = _coords(rank, dims)
                peers = []
                for i in range(dims[a]):
                    p = list(c)
                    p[a] = i
                    peers.append(int(np.ravel_multi_index(p, dims)))
                row = got[rank][f"grid_{'x'.join(map(str, dims))}_{axis}"]
                n, me = dims[a], int(c[a])
                assert list(row["group"]) == peers and int(row["index"]) == me
                assert int(row["size"]) == n
                x = lambda r: np.arange(4.0) + 10.0 * r
                np.testing.assert_array_equal(row["shift"], x(peers[(me - 1) % n]))
                np.testing.assert_array_equal(row["back"], np.full(4, 1.0 + peers[(me + 1) % n]))
                total = sum(x(p) for p in peers)
                np.testing.assert_array_equal(row["sum"], total)
                np.testing.assert_array_equal(row["bfl"], x(peers[-1]))
                block = 4 // n
                np.testing.assert_array_equal(row["scatter"], total[me * block:(me + 1) * block])


def test_pp_tp_pipelined_forward_matches_sequential(ranks):
    for got in ranks[0]:
        assert float(got["forward"]["err"]) <= FWD_TOL
        assert tuple(got["forward"]["shape"]) == (8, 2)


def test_pp_tp_trajectory_matches_jax(ranks):
    """1 worker x 2 stages x 2 model ranks, the classifier, two epochs of
    Downpour(2) with SGD: JAX's 3-D pipeline's losses and center, on every
    rank (each gathers the whole center)."""
    want, _ = ranks[1]["cls"]
    for got in ranks[0]:
        np.testing.assert_allclose(got["cls"]["loss"], want["loss"], **TOL)
        assert_run(got["cls"], want, **CENTER_TOL)


def assert_placed(layout, shards):
    """A rank's stored elements: JAX's placement's shard sizes, of the
    center and of the worker's parameters, and the staged blocks' after the
    epochs too.  (After an epoch JAX's partitioner, free over the auto model
    axis, also splits the embedding and the head on their last dim; its
    engine places them whole, and the port keeps them so.)"""
    for where in ("center", "local"):
        for k in ("embed", "blocks", "head"):
            assert int(layout[f"{where}_{k}"]) == shards["placed"][f"{where}_{k}"], (where, k)
        assert int(layout[f"{where}_blocks"]) == shards["trained"][f"{where}_blocks"], where


def test_pp_tp_state_sharded_over_three_axes(ranks):
    """Each rank stores its stage's blocks split over the model axis, a
    quarter of the whole, every staged leaf split (the 1-D ones too); embed
    and head whole; the elements a rank stores are JAX's shard sizes; the
    Adam moments ride the same layout."""
    _, shards = ranks[1]["cls"]
    whole = {k: sum(v.size for n, v in ranks[1]["cls"][0].items()
                    if n.startswith(f"center/{k}/")) for k in ("embed", "blocks", "head")}
    for got in ranks[0]:
        lay = got["layout"]
        assert tuple(lay["center_block"]) == (1, 1, 64, 32)  # fc1 [1, 1, 128, 32] split
        assert tuple(lay["local_block"]) == (1, 1, 1, 64, 32)
        assert tuple(lay["center_qkv_bias"]) == (1, 1, 48)
        assert tuple(lay["center_ln"]) == (1, 1, 16)
        assert tuple(lay["center_tok"]) == (50, 32)
        assert_placed(lay, shards)
        assert 4 * int(lay["center_blocks"]) == whole["blocks"]
        assert int(lay["center_embed"]) == whole["embed"]
        lm = got["layout_lm"]
        assert [tuple(m) for m in lm["moments"]] == [(1, 1, 2, 64, 32)] * 2


def test_pp_tp_staged_lm_matches_jax(ranks):
    """The staged causal LM, Adam, over the 3-D grid: JAX's run."""
    want, shards = ranks[1]["lm"]
    init = ranks[1]["lm_init"]["blocks"]["attn.qkv.bias"]
    for got in ranks[0]:
        g, w = hold_key_third(got["lm"], want, init, 8)
        np.testing.assert_allclose(g["loss"], w["loss"], **TOL)
        assert_run(g, w, **CENTER_TOL)
        assert_placed(got["layout_lm"], shards)


def test_pp_tp_fsdp_trajectory_matches_pp_fsdp(ranks):
    """Three axes and the stage-split embed/head: the replicated 3-D run bit
    for bit, JAX's fsdp run within its bounds, and the embedding half a
    stage (the model axis leaves it whole)."""
    want, shards = ranks[1]["cls_fsdp"]
    for got in ranks[0]:
        assert_run(got["cls_fsdp"], got["cls"], exact=True)
        np.testing.assert_allclose(got["cls_fsdp"]["loss"], want["loss"], **TOL)
        assert_run(got["cls_fsdp"], want, **CENTER_TOL)
        lay = got["layout_fsdp"]
        assert tuple(lay["center_tok"]) == (25, 32)
        assert_placed(lay, shards)


def test_pp_tp_through_trainer_api(ranks):
    """``DOWNPOUR(..., pipeline_stages=2, tp_shards=2)`` with the default
    worker count (one a row of 4 ranks) trains the one-rank trainer's run
    and returns a whole model that predicts on one rank."""
    want, init = ranks[2]
    for got in ranks[0]:
        assert_trainer(got["trainer"], want, init)


def test_pp_tp_device_count_validation(ranks):
    """JAX's errors: 3 stages x 2 model ranks do not divide the ranks; 4
    workers on a grid with one workers row."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.parallel import PipelineEngine

    with pytest.raises(ValueError, match="does not divide"):
        PipelineEngine(classifier(num_stages=3), "categorical_crossentropy", "sgd",
                       algorithms.Downpour(2), tp_shards=2, device="cpu")
    for got in ranks[0]:
        assert "1:1" in str(got["refused"]["rows"])


def test_default_worker_count_divides_by_the_pipeline_row():
    """A pipeline's default worker count is the ranks over its row's
    (stages x model or seq ranks); the GSPMD engine's counts every rank."""
    import distkeras_tpu_torch as tdk

    kw = dict(batch_size=8, device="cpu")
    row = lambda **k: tdk.DOWNPOUR(staged("cls"), **kw, **k)._worker_row()
    assert row(pipeline_stages=2, tp_shards=2) == 4
    assert row(pipeline_stages=2, seq_shards=2) == 4
    assert row(pipeline_stages=2) == 2
    assert row(tp_shards=2) == 1
    assert row(seq_shards=2) == 2


@pytest.mark.parametrize("layout", ["tp", "tp_fsdp"])
def test_a_pp_tp_window_captures_over_nccl_and_reads_nothing_on_the_host(ranks, layout):
    """``unroll=True`` on a card, grid 1 x 2 x 2: the window (the stage
    shifts, the model axis's gathers and psums inside each tick and each
    ``autograd.grad``, the stage sums, under fsdp the embed/head gather
    and reduce-scatter) is captured over NCCL, gloo refused by name; one
    window on each of the four ranks reads nothing on the host, and all
    four issue the same collectives in the same order."""
    from test_torch_pipeline import assert_captured

    assert_captured(ranks[3], layout)
