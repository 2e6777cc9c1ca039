"""Expert parallelism in the port: ``GSPMDEngine(tp_shards=2,
spec_fn=expert_partition(4))`` over two gloo ranks on the CPU (grid 1 x 2,
2 workers) trains the MoE classifier, against tests/test_moe_expert_parallel.py's
case: the JAX package's ``GSPMDEngine`` with its own ``expert_partition``
on two of its CPU devices, and the port's data-parallel engine on one rank.

The two ranks are spawned **once** for the module (``ranks`` fixture, the
pattern of ``test_torch_ring.py``): each runs this file as a script, joins
the gloo group and runs the expert-parallel training; each writes its
results.  Both packages start from the same parameters (the JAX engine's
initial center, carried over with ``params_from_flax``), and the data come
from one numpy seed.

Tolerances: JAX's test's own for EP against DP, the losses within ``rtol=2e-4,
atol=2e-5`` and the center within ``rtol=2e-3, atol=2e-4``, for the
port's EP run against JAX's EP run and against the port's one-rank DP run;
layouts and expert counts exactly.

The ranks also make the checks of a window a card captures (``unroll``
other than 1): the EP engine built on a faked card captures over NCCL and
refuses gloo, and one EP window reads nothing on the host while both ranks
issue the same collectives in the same order (``capture_<rank>.json``).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD, TP, E = 2, 2, 4
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
SGD = ("sgd", {"learning_rate": 0.05})
MOE = dict(vocab_size=50, num_classes=2, dim=32, heads=2, num_layers=1, num_experts=E,
           mlp_ratio=2, capacity_factor=2.0, max_len=32)
EPOCHS = 2
STACKS = ("w1", "b1", "w2", "b2")


# ------------------------------------------------------- shared with the ranks

def fixed(module, params):
    """A test-side adapter over ``module`` whose ``init`` returns the given
    parameters (the JAX engine's, carried over) and the module's buffers."""
    from distkeras_tpu_torch.models import TorchModel

    class FixedInit(TorchModel):
        def init(self, generator, sample_input):
            return ({k: v.clone() for k, v in params.items()},
                    {k: b.clone() for k, b in module.named_buffers()})

    return FixedInit(module)


def load(workdir, name):
    with np.load(os.path.join(workdir, f"{name}.npz")) as got:
        return {k: torch.from_numpy(got[k]) for k in got.files}


def run(engine, xs, ys):
    """The whole center and the last epoch's losses after ``EPOCHS``
    epochs, and the state."""
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    sx, sy = engine.shard_batches(xs, ys)
    for _ in range(EPOCHS):
        state, stats = engine.run_epoch(state, sx, sy)
    center = engine.gather_center(state)
    out = {f"center/{k}": v.numpy() for k, v in center.items()}
    out["loss"] = np.asarray(stats["loss"])
    return out, state


def _ep_case(workdir):
    """The expert-parallel run on this rank: its results, the shapes of
    its resident expert stacks, and the expert count each expert product
    on this rank saw."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import MoETransformerClassifier, expert_partition, moe
    from distkeras_tpu_torch.parallel import GSPMDEngine

    seen = []
    plain = moe._expert_ffn

    def recording(xin, *stacks):
        seen.append((xin.shape[0], *(w.shape[0] for w in stacks)))
        return plain(xin, *stacks)

    moe._expert_ffn = recording
    try:
        data = load(workdir, "data")
        engine = GSPMDEngine(fixed(MoETransformerClassifier(**MOE), load(workdir, "init")),
                             "categorical_crossentropy", SGD, algorithms.Downpour(2),
                             num_workers=2, tp_shards=TP, spec_fn=expert_partition(E),
                             metrics=(), device="cpu")
        out, state = run(engine, data["xs"].numpy(), data["ys"].numpy())
    finally:
        moe._expert_ffn = plain
    for name in engine.gather_center(state):
        leaf = name.split(".")[-1]
        if ".moe." in name and leaf in STACKS:
            out[f"block/{name}"] = state.center_params[name].numpy()
            out[f"local_shape/{name}"] = np.asarray(state.local_params[name].shape)
            out[f"dim/{name}"] = np.asarray(engine._tp_dims[name])
    out["seen"] = np.asarray(seen)
    out["grid"] = np.asarray(engine.mesh.shape)
    return out


def _capture_case(workdir):
    """An EP window as a card captures it: the engine built on a faked card
    over NCCL and over gloo, and one window on this rank's CPU block under
    the transfer guard, its collectives recorded (EP's input psum and
    output gather, the attention's column-parallel products, the commit)."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import MoETransformerClassifier, expert_partition
    from distkeras_tpu_torch.parallel import GSPMDEngine
    from distkeras_tpu_torch.parallel.mesh import TP_AXIS, WORKER_AXIS, make_mesh_grid
    from test_torch_ring import capture_refusals, host_reads, recording_collectives

    grid = make_mesh_grid(1, TP, axis_names=(WORKER_AXIS, TP_AXIS))

    def build(device):
        return GSPMDEngine(fixed(MoETransformerClassifier(**MOE), load(workdir, "init")),
                           "categorical_crossentropy", SGD, algorithms.Downpour(2),
                           num_workers=2, tp_shards=TP, spec_fn=expert_partition(E),
                           metrics=(), mesh=grid, unroll=True, device=device)

    out = {"card": capture_refusals(lambda: build("cuda"))}
    engine = build("cpu")
    data = load(workdir, "data")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    sx, sy = engine.shard_batches(data["xs"].numpy(), data["ys"].numpy())
    with recording_collectives() as log, host_reads() as reads:
        engine._window_body(state, sx[:, 0], sy[:, 0], True)
    out["collectives"], out["host_reads"] = log, reads
    return out


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init,
                            world_size=world, rank=rank)
    try:
        results = _ep_case(workdir)
        capture = _capture_case(workdir)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank_{rank}.npz"), **results)
    with open(os.path.join(workdir, f"capture_{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(capture, fh)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------------- test process

def _data():
    from conftest import epoch_data, toy_text

    x, _, onehot = toy_text(n=128)
    return epoch_data(x, onehot, num_workers=2, n_windows=2, window=2, batch=8)


def _to_port(tree):
    import jax

    from distkeras_tpu_torch.models import MoETransformerClassifier, params_from_flax

    got = params_from_flax(MoETransformerClassifier(**MOE),
                           jax.tree_util.tree_map(np.asarray, tree))
    return {k: v.numpy() for k, v in got.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(every rank's results, JAX's EP run, the port's one-rank DP run)``."""
    import jax

    from distkeras_tpu.algorithms import Downpour as JaxDownpour
    from distkeras_tpu.models import FlaxModel
    from distkeras_tpu.models import MoETransformerClassifier as JaxMoE
    from distkeras_tpu.models import expert_partition as jax_expert_partition
    from distkeras_tpu.parallel import GSPMDEngine as JaxGSPMD
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import MoETransformerClassifier
    from distkeras_tpu_torch.parallel import WindowedEngine
    from distkeras_tpu_torch.parallel.mesh import LocalMesh
    from test_torch_ring import spawn_ranks

    workdir = str(tmp_path_factory.mktemp("ep"))
    xs, ys = _data()
    np.savez(os.path.join(workdir, "data.npz"), xs=xs, ys=ys)

    jeng = JaxGSPMD(FlaxModel(JaxMoE(**MOE)), "categorical_crossentropy", SGD,
                    JaxDownpour(2), num_workers=2, tp_shards=TP,
                    spec_fn=jax_expert_partition(E), metrics=(),
                    devices=jax.devices()[:WORLD])
    state = jeng.init_state(jax.random.PRNGKey(0), xs[0, 0, 0])
    init = _to_port(jeng.gather_center(state))
    np.savez(os.path.join(workdir, "init.npz"), **init)
    w1 = state.center_params["block_0"]["MoEFeedForward_0"]["w1"]
    jax_shard_rows = {s.data.shape[0] for s in w1.addressable_shards}
    sx, sy = jeng.shard_batches(xs, ys)
    for _ in range(EPOCHS):
        state, stats = jeng.run_epoch(state, sx, sy)
    jax_run = {"loss": np.asarray(stats["loss"]), "center": _to_port(jeng.gather_center(state)),
               "shard_rows": jax_shard_rows}

    spawn_ranks(__file__, WORLD, workdir)

    dp = WindowedEngine(fixed(MoETransformerClassifier(**MOE),
                              {k: torch.from_numpy(v) for k, v in init.items()}),
                        "categorical_crossentropy", SGD, algorithms.Downpour(2), num_workers=2,
                        metrics=(), device="cpu", mesh=LocalMesh())
    dp_run, _ = run(dp, xs, ys)
    results = []
    for r in range(WORLD):
        with np.load(os.path.join(workdir, f"rank_{r}.npz")) as got:
            results.append({k: got[k] for k in got.files})
        with open(os.path.join(workdir, f"capture_{r}.json"), encoding="utf-8") as fh:
            results[-1]["capture"] = json.load(fh)
    return results, jax_run, dp_run


def _assert_center(got, want, **tol):
    names = sorted(k[len("center/"):] for k in got if k.startswith("center/"))
    assert names == sorted(want)
    for name in names:
        np.testing.assert_allclose(got[f"center/{name}"], want[name], err_msg=name, **tol)


def test_ep_matches_jax_expert_parallel_run(ranks):
    """2 workers x 2 expert shards computes the JAX GSPMD engine's run under
    its own ``expert_partition``: EP is a layout, not an algorithm."""
    results, jax_run, _ = ranks
    np.testing.assert_allclose(results[0]["loss"], jax_run["loss"], **LOSS_TOL)
    _assert_center(results[0], jax_run["center"], **PARAM_TOL)


def test_ep_matches_the_one_rank_dp_run(ranks):
    results, _, dp_run = ranks
    np.testing.assert_allclose(results[0]["loss"], dp_run["loss"], **LOSS_TOL)
    _assert_center(results[0], {k[len("center/"):]: v for k, v in dp_run.items()
                                if k.startswith("center/")}, **PARAM_TOL)


def test_expert_stacks_are_resident_in_halves(ranks):
    """Each rank stores its ``E/2`` experts of every stack (center and
    every worker's copy), as a JAX device's shard of the same leaf holds."""
    results, jax_run, _ = ranks
    assert jax_run["shard_rows"] == {E // TP}
    for rank, got in enumerate(results):
        assert list(got["grid"]) == [1, TP]
        stacks = [k[len("block/"):] for k in got if k.startswith("block/")]
        assert sorted(n.split(".")[-1] for n in stacks) == sorted(STACKS)
        for name in stacks:
            assert got[f"block/{name}"].shape[0] == E // TP, (rank, name)
            assert got[f"local_shape/{name}"][1] == E // TP, (rank, name)
            assert int(got[f"dim/{name}"]) == 0


def test_expert_products_see_their_rank_experts(ranks):
    """Every expert product on a rank ran its ``E/2`` experts (input block
    and the four stacks alike), never all ``E``."""
    results, _, _ = ranks
    steps = EPOCHS * 2 * 2 * 2  # epochs x windows x window x workers
    for got in results:
        seen = got["seen"]
        assert len(seen) == steps
        assert (seen == E // TP).all(), seen


def test_gathered_center_is_the_ranks_blocks_whole(ranks):
    """Both ranks gather the same center, and each expert stack of it is
    the two ranks' blocks in axis order."""
    results, _, _ = ranks
    for key in results[0]:
        if key.startswith("center/"):
            np.testing.assert_array_equal(results[0][key], results[1][key])
    for key in results[0]:
        if key.startswith("block/"):
            whole = np.concatenate([r[key] for r in results], axis=0)
            np.testing.assert_array_equal(results[0][f"center/{key[len('block/'):]}"], whole)


def test_ep_in_a_captured_window_takes_nccl_and_refuses_gloo(ranks):
    """``tp_shards=2`` with ``expert_partition`` and ``unroll=True`` on a
    card: the window is captured over NCCL; gloo is refused by name."""
    for got in ranks[0]:
        card = got["capture"]["card"]
        assert card["nccl"] == "captures", card
        assert card["gloo"].startswith("ValueError") and "NCCL" in card["gloo"], card


def test_an_ep_window_reads_nothing_on_the_host_and_both_ranks_pair(ranks):
    """The EP window a card captures: no host read on either rank, and the
    same collectives in the same order on both."""
    logs = [got["capture"]["collectives"] for got in ranks[0]]
    assert logs[0] and logs[0] == logs[1]
    assert {"all_gather", "all_reduce"} <= {c[0] for c in logs[0]}
    assert all(got["capture"]["host_reads"] == [] for got in ranks[0])
