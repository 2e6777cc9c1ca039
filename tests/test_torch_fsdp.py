"""The GSPMD engine's ZeRO center in the port (``fsdp=True`` without a seq
axis): the center split over the **workers** axis of the ``(workers,
model)`` grid of four gloo ranks on the CPU, case by case against
tests/test_fsdp.py: the JAX package's ``GSPMDEngine(fsdp=True)`` on four of
its CPU devices, and the port's replicated-center run.

Four ranks are spawned **once** for the module (``ranks`` fixture, the
pattern of ``test_torch_ring.py``; the helpers are
``test_torch_tensor_parallel.py``'s): each runs this file as a script and
every case; rank 0 writes the results, every rank its own layout.  Both
packages start from the JAX engine's initial center, carried over.

Tolerances: JAX's own for fsdp against DP (tests/test_fsdp.py),
``rtol=2e-5, atol=2e-6``, against JAX's GSPMD engine; the port's fsdp run
against its own replicated run bit for bit (the gather is a concatenation
and the commit's math runs on the gathered center), streaming bit for bit
the in-memory run, a checkpoint resume within ``rtol=1e-5, atol=1e-6``;
the per-rank element counts exactly.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
# (JAX MLP features, workers, tp_shards, windows, epochs) of the trajectory cases
CASES = {"fsdp": ((32, 16), 4, 1, 2, 2), "fsdp_tp": ((32, 16), 2, 2, 2, 2),
         "virtual": ((32,), 8, 1, 1, 1)}


# ------------------------------------------------------- shared with the ranks

def _trajectory_cases(workdir):
    """Each case under fsdp, and the same engine with the center
    replicated (fsdp off), from the JAX initial parameters."""
    from distkeras_tpu_torch import algorithms
    from test_torch_tensor_parallel import _gspmd, data, epoch_arrays, fixed, load, port_mlp, run

    x, _, onehot = data(n=512)
    out = {}
    for name, (features, workers, tp, windows, epochs) in CASES.items():
        xs, ys = epoch_arrays(x, onehot, workers, windows, 4, 8)
        for fsdp in (True, False):
            engine = _gspmd(fixed(port_mlp(features), load(workdir, name)),
                            algorithms.Downpour(4), workers, tp_shards=tp, fsdp=fsdp)
            got = run(engine, xs, ys, epochs)
            if fsdp:
                got["virtual"] = np.asarray(engine.virtual)
            out[name if fsdp else f"{name}_replicated"] = got
    return out


def _layout_case(workdir):
    """Each center leaf's shape on this rank and its model and workers
    dims, under fsdp alone and fsdp with ``tp_shards=2``."""
    from distkeras_tpu_torch import algorithms
    from test_torch_tensor_parallel import _gspmd, fixed, load, port_mlp

    out = {}
    for name in ("fsdp", "fsdp_tp"):
        features, workers, tp, _, _ = CASES[name]
        engine = _gspmd(fixed(port_mlp(features), load(workdir, name)), algorithms.Downpour(4),
                        workers, tp_shards=tp, fsdp=True)
        state = engine.init_state(torch.Generator().manual_seed(0), None)
        for leaf, value in state.center_params.items():
            out[f"{name}/center/{leaf}"] = np.asarray(value.shape)
            out[f"{name}/model/{leaf}"] = np.asarray(engine._tp_dims[leaf])
            out[f"{name}/workers/{leaf}"] = np.asarray(engine._fsdp_dims[leaf])
            out[f"{name}/local/{leaf}"] = np.asarray(state.local_params[leaf].shape)
    return out


def _staleness_case():
    from distkeras_tpu_torch import algorithms
    from test_torch_tensor_parallel import _gspmd, _one_rank, data, fixed, port_mlp, run

    x, _, onehot = data()
    xs = x[:256].reshape(4, 16, 4, -1)  # [workers, steps, batch, d]
    ys = np.argmax(onehot[:256], -1).reshape(4, 16, 4).astype(np.int32)
    init = {k: v.detach() for k, v in port_mlp((32,)).named_parameters()}
    schedule = np.array([2, 4, 8, 16])
    fs = _gspmd(fixed(port_mlp((32,)), init), algorithms.DynSGD(communication_window=4), 4,
                fsdp=True, commit_schedule=schedule)
    ref = _one_rank(fixed(port_mlp((32,)), init), algorithms.DynSGD(communication_window=4), 4,
                    commit_schedule=schedule)
    return {**{f"fsdp/{k}": v for k, v in run(fs, xs, ys, 1).items()},
            **{f"ref/{k}": v for k, v in run(ref, xs, ys, 1).items()}}


def _trainer(num_epoch, **kwargs):
    import distkeras_tpu_torch as tdk
    from test_torch_tensor_parallel import port_mlp

    return tdk.DOWNPOUR(port_mlp(kwargs.pop("features", (32,)), 2, 8),
                        loss="categorical_crossentropy",
                        worker_optimizer=("sgd", {"learning_rate": 0.1}), num_workers=4,
                        batch_size=16, num_epoch=num_epoch, communication_window=4, fsdp=True,
                        device="cpu", **kwargs)


def _trainer_cases(workdir):
    """The trainer with ``fsdp=True``: convergence over 8 epochs; two
    epochs in memory and streamed; with ``tp_shards=2``, 4 epochs straight
    and 2 + a resume of 2."""
    import torch.distributed as dist

    import distkeras_tpu_torch as tdk
    from test_torch_tensor_parallel import toy_classification

    x, _, onehot = toy_classification()
    frame = tdk.from_numpy(x, onehot)
    out = {}
    t = _trainer(8)
    trained = t.train(frame)
    out["converge"] = {"loss": np.asarray(t.get_history()["loss"]),
                       "predict": trained.predict(x)}
    for streaming in (False, True):
        trained = _trainer(2, seed=5, streaming=streaming).train(frame)
        out[f"streaming_{streaming}"] = {k: v.numpy() for k, v in trained.params.items()}
    directory = os.path.join(workdir, "ckpt")
    for name, kw in (("straight", dict(num_epoch=4)),
                     ("first", dict(num_epoch=2, checkpoint_dir=directory)),
                     ("resumed", dict(num_epoch=4, checkpoint_dir=directory, resume=True))):
        trained = _trainer(kw.pop("num_epoch"), features=(16,), seed=11, tp_shards=2,
                           **kw).train(frame)
        out[f"ckpt_{name}"] = {k: v.numpy() for k, v in trained.params.items()}
        dist.barrier()
    return out


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init,
                            world_size=world, rank=rank)
    try:
        results = {**_trajectory_cases(workdir), "layout": _layout_case(workdir),
                   "stale": _staleness_case(), **_trainer_cases(workdir)}
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank_{rank}.npz"),
             **{f"{c}|{k}": v for c, r in results.items() for k, v in r.items()})


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------------- test process

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(results of every rank, workdir)``: the JAX initial parameters are
    written for the ranks, then the four ranks run every case."""
    from test_torch_ring import spawn_ranks
    from test_torch_tensor_parallel import data, jax_init, jax_mlp_engine, read_ranks

    workdir = str(tmp_path_factory.mktemp("fsdp"))
    x = data(n=512)[0]
    for name, (features, workers, tp, _, _) in CASES.items():
        _, init = jax_init(jax_mlp_engine(features, workers, tp_shards=tp, fsdp=True), x[:8],
                           features)
        np.savez(os.path.join(workdir, f"init_{name}.npz"), **init)
    spawn_ranks(__file__, WORLD, workdir)
    return read_ranks(workdir), workdir


def _assert_bitwise(got, want):
    names = [k for k in want if k.startswith("center/")]
    assert names and sorted(names) == sorted(k for k in got if k.startswith("center/"))
    np.testing.assert_array_equal(got["loss"], want["loss"])
    for name in names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("case", list(CASES), ids=["fsdp", "composes_with_tp", "virtual_workers"])
def test_fsdp_matches_jax_and_the_replicated_run(ranks, case):
    """4 workers with a workers-axis-split center (also with 2 model ranks,
    and 8 workers, 2 a rank) compute the JAX fsdp run, and the port's
    replicated-center run bit for bit."""
    from test_torch_tensor_parallel import TOL, assert_center, data, epoch_arrays, jax_mlp_engine
    from test_torch_tensor_parallel import jax_run

    features, workers, tp, windows, epochs = CASES[case]
    x, _, onehot = data(n=512)
    xs, ys = epoch_arrays(x, onehot, workers, windows, 4, 8)
    center, loss = jax_run(jax_mlp_engine(features, workers, tp_shards=tp, fsdp=True), xs, ys,
                           epochs, features)
    results, _ = ranks
    got = results[0][case]
    assert int(got["virtual"]) == workers * tp // WORLD
    np.testing.assert_allclose(got["loss"], loss, **TOL)
    assert_center(got, center, **TOL)
    _assert_bitwise(got, results[0][f"{case}_replicated"])


@pytest.mark.parametrize("case", ["fsdp", "fsdp_tp"], ids=["fsdp", "composes_with_tp"])
def test_center_is_stored_as_jax_shards_it(ranks, case):
    """Every center leaf with a dim that splits over the worker ranks is
    stored split, and each rank holds as many elements of each leaf as a
    JAX device's shard; with ``tp_shards=2`` a leaf carries both axes.
    Per-worker state keeps its layout (whole over the workers axis)."""
    import jax

    from distkeras_tpu.parallel import TP_AXIS
    from distkeras_tpu.parallel.mesh import WORKER_AXIS
    from test_torch_tensor_parallel import data, jax_init, jax_mlp_engine, to_port

    features, workers, tp, _, _ = CASES[case]
    state, _ = jax_init(jax_mlp_engine(features, workers, tp_shards=tp, fsdp=True),
                        data()[0][:8], features)
    leaves, treedef = jax.tree_util.tree_flatten(state.center_params)
    marks = to_port(features, jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)]))
    results, _ = ranks
    both = 0
    for name, mark in marks.items():
        leaf = leaves[int(mark.flat[0])]
        spec = jax.tree.leaves(tuple(leaf.sharding.spec))
        for rank, got in enumerate(results):
            layout = got["layout"]
            assert (int(layout[f"{case}/workers/{name}"]) >= 0) == (WORKER_AXIS in spec), name
            assert (int(layout[f"{case}/model/{name}"]) >= 0) == (TP_AXIS in spec), name
            shape = layout[f"{case}/center/{name}"]
            assert int(np.prod(shape)) == leaf.addressable_shards[0].data.size, (rank, name)
            local = layout[f"{case}/local/{name}"][1:]
            split = tp if TP_AXIS in spec else 1
            assert int(np.prod(local)) == int(np.prod(leaf.shape)) // split, (rank, name)
        both += WORKER_AXIS in spec and TP_AXIS in spec
    assert (both > 0) == (tp > 1)
    assert any(int(v) >= 0 for k, v in results[0]["layout"].items()
               if k.startswith(f"{case}/workers/"))


def test_fsdp_staleness_schedule_matches_the_replicated_run(ranks):
    """The per-step masked-commit body (staleness simulation) with a split
    center: DynSGD under a skewed schedule, finite, and the port's one-rank
    stepwise run within JAX's bound (the commit's sum runs over ranks)."""
    got = ranks[0][0]["stale"]
    assert np.isfinite(got["fsdp/loss"]).all()
    np.testing.assert_allclose(got["fsdp/loss"], got["ref/loss"], rtol=2e-5, atol=2e-6)
    for name in [k for k in got if k.startswith("ref/center/")]:
        np.testing.assert_allclose(got["fsdp/" + name[4:]], got[name], rtol=2e-5, atol=2e-6,
                                   err_msg=name)


def test_trainer_fsdp_kwarg_converges(ranks):
    """``fsdp=True`` alone routes to the GSPMD engine and trains to the same
    quality as the default path."""
    from test_torch_tensor_parallel import toy_classification

    got = ranks[0][0]["converge"]
    h = got["loss"]
    assert h[-1] < h[0] * 0.6
    _, y, _ = toy_classification()
    assert np.mean(np.argmax(got["predict"], -1) == y) > 0.8


def test_fsdp_composes_with_streaming(ranks):
    a, b = ranks[0][0]["streaming_False"], ranks[0][0]["streaming_True"]
    assert sorted(a) == sorted(b) and a
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_checkpoint_resume_under_fsdp_and_tp(ranks):
    """4 epochs straight == 2 + resume 2 with the center split over both
    axes, on every rank (the payload holds whole leaves)."""
    from test_torch_tensor_parallel import CKPT_TOL

    for got in ranks[0]:
        straight, resumed = got["ckpt_straight"], got["ckpt_resumed"]
        assert sorted(straight) == sorted(resumed) and straight
        for name in straight:
            np.testing.assert_allclose(resumed[name], straight[name], err_msg=name, **CKPT_TOL)


def test_fsdp_rejects_bad_combos():
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.parallel import WindowedEngine
    from test_torch_tensor_parallel import LM, port_mlp

    # the windowed engine's fsdp is the seq-axis one; fsdp alone is GSPMD's
    with pytest.raises(ValueError, match="GSPMD engine"):
        WindowedEngine(port_mlp((32,)), "categorical_crossentropy", "sgd",
                       algorithms.Downpour(4), fsdp=True, device="cpu")
    # pipeline x seq (item 15c-ii, ported) takes fsdp: the staged model
    # builds its blocks on the seq axis, and the trainer's row is a worker's
    # 2 stages x 2 seq ranks (tests/test_torch_pp_sp.py trains it)
    from distkeras_tpu_torch.models import StagedLM

    t = tdk.DOWNPOUR(StagedLM(vocab_size=LM["vocab_size"], dim=LM["dim"], heads=LM["heads"],
                              max_len=LM["max_len"], seq_axis="seq"),
                     num_workers=4, seq_shards=2, pipeline_stages=2, fsdp=True, device="cpu")
    assert t.fsdp and t._worker_row() == 4
    assert t.master_model._block.attn.seq_axis == "seq"
