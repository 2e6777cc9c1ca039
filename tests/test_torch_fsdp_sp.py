"""fsdp x sp in the port: the seq-axis ZeRO center (``fsdp=True`` with
``seq_shards > 1``) over the ``(workers, seq)`` grid of four gloo ranks on
the CPU, against the replicated-center sequence-parallel run, and the
checkpoints of a seq-sharded run, and the live elastic resize over the
grid (ROADMAP Queue C, C21): global rank 0 alone polls and broadcasts, a
count that does not split over the workers ranks is rounded down with a
warning, and the resized run is the elastic-resume path's bit for bit.

Four ranks are spawned **once** for the module (``ranks`` fixture, the
pattern of ``test_torch_ring.py``); rank 0 writes the results.  The
classifier is tests/test_fsdp_sp.py's (dim 32, one layer, 32 tokens).

Tolerances: fsdp is a layout change, so its trajectory is the replicated
run's bit for bit (the gather is a concatenation and the commit's math
runs on the whole center); a checkpoint written at ``seq_shards=2``
restores bit for bit, at two seq ranks and at one rank.
"""

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD, SEQ_SHARDS = 4, 2
CLS = dict(vocab_size=50, num_classes=2, dim=32, heads=2, num_layers=1, max_len=64)
ROWS, SEQ = 64, 32


# ------------------------------------------------------- shared with the ranks

def _data():
    rng = np.random.default_rng(0)
    x = rng.integers(0, CLS["vocab_size"], size=(ROWS, SEQ)).astype(np.int32)
    label = ((x == 7).sum(1) > (x == 3).sum(1)).astype(np.int32)
    return x, np.eye(2, dtype=np.float32)[label]


def _module(seq_axis="seq"):
    from distkeras_tpu_torch.models import TransformerClassifier

    return TransformerClassifier(**CLS, seq_axis=seq_axis,
                                 generator=torch.Generator().manual_seed(5))


def _train(rule="DOWNPOUR", seq_shards=SEQ_SHARDS, fsdp=False, num_epoch=2, num_workers=2,
           **kwargs):
    import distkeras_tpu_torch as tdk

    x, y = _data()
    extra = dict(rho=1.0, learning_rate=0.05) if rule == "AEASGD" else {}
    t = getattr(tdk, rule)(_module("seq" if seq_shards > 1 else None),
                           loss="categorical_crossentropy",
                           worker_optimizer=("sgd", {"learning_rate": 0.05}),
                           num_workers=num_workers,
                           batch_size=8, num_epoch=num_epoch, communication_window=2,
                           seq_shards=seq_shards, fsdp=fsdp, seed=5, device="cpu",
                           **extra, **kwargs)
    trained = t.train(tdk.from_numpy(x, y))
    out = {f"center/{k}": v.numpy() for k, v in trained.params.items()}
    out["loss"] = np.asarray(t.get_history()["loss"])
    return out


def _layout_case():
    """The center's storage under fsdp: each leaf's shape on this rank, its
    recorded dim, and the gathered center against the initial one."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import TorchModel
    from distkeras_tpu_torch.parallel import WindowedEngine

    engine = WindowedEngine(TorchModel(_module()), "categorical_crossentropy", "sgd",
                            algorithms.Downpour(2), num_workers=2, seq_shards=SEQ_SHARDS,
                            fsdp=True, device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    whole = engine.gather_center(state)
    out = {}
    for name, leaf in state.center_params.items():
        out[f"shape/{name}"] = np.asarray(leaf.shape)
        out[f"dim/{name}"] = np.asarray(engine._fsdp_dims[name])
        out[f"whole/{name}"] = whole[name].numpy()
        out[f"local0/{name}"] = state.local_params[name][0].numpy()
    return out


def _elastic_case():
    """``state_from_center`` at 4 workers (2 a workers rank) around a
    gathered center, then one epoch."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.data import epoch_arrays
    from distkeras_tpu_torch.models import TorchModel
    from distkeras_tpu_torch.parallel import WindowedEngine

    make = lambda n: WindowedEngine(TorchModel(_module()), "categorical_crossentropy", "sgd",
                                    algorithms.Downpour(2), num_workers=n,
                                    seq_shards=SEQ_SHARDS, fsdp=True, device="cpu")
    first = make(2)
    center = first.gather_center(first.init_state(torch.Generator().manual_seed(0), None))
    engine = make(4)
    state = engine.state_from_center(torch.Generator().manual_seed(1),
                                     {k: v.numpy() for k, v in center.items()},
                                     engine.rule.init_center_state(), {}, epoch=3)
    x, y = _data()
    state, stats = engine.run_epoch(state, *engine.shard_batches(
        *epoch_arrays(x, y, 4, 4, 2)))
    return {"loss": stats["loss"], "epoch": np.asarray(state.epoch),
            "rows": np.asarray(next(iter(state.local_params.values())).shape[0])}


def _checkpoint_cases(workdir, rank):
    import torch.distributed as dist

    first = os.path.join(workdir, "ckpt_1")
    resumed = os.path.join(workdir, "ckpt_2")
    out = {"first": _train(fsdp=True, num_epoch=1, checkpoint_dir=first)}
    if rank == 0:  # a copy to resume in, so ckpt_1 keeps only its step 1
        shutil.copytree(first, resumed)
    dist.barrier()
    out["resumed"] = _train(fsdp=True, checkpoint_dir=resumed, resume=True)
    return out


class _Scripted:
    """Stands in for ElasticMembership: poll() pops a scripted answer."""

    def __init__(self, answers):
        self.answers, self.polls = list(answers), 0

    def poll(self):
        self.polls += 1
        return self.answers.pop(0) if self.answers else None


def _live_elastic_case(workdir, rank):
    """The live resize after epoch 0: rank 0's poller asks for 5 workers
    (the others' would ask for none, and are never asked), rounded down to
    4 over the 2 workers ranks; then the elastic-resume path from ckpt_1
    (epoch 0 at 2 workers) at 4 workers."""
    import warnings

    import torch.distributed as dist

    ctl = _Scripted([5] if rank == 0 else [3])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = {"live": _train(fsdp=True, elastic=ctl)}
    resized = [str(w.message) for w in caught if "resizing to 4" in str(w.message)]
    out["live"].update(polls=np.asarray(ctl.polls), warned=np.asarray(len(resized)))
    resume = os.path.join(workdir, "ckpt_3")
    if rank == 0:
        shutil.copytree(os.path.join(workdir, "ckpt_1"), resume)
    dist.barrier()
    out["elastic_resumed"] = _train(fsdp=True, num_workers=4, checkpoint_dir=resume,
                                    resume=True)
    return out


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init,
                            world_size=world, rank=rank)
    try:
        results = {
            "sp": _train(), "fsdp": _train(fsdp=True),
            "sp_aeasgd": _train("AEASGD"), "fsdp_aeasgd": _train("AEASGD", fsdp=True),
            "layout": _layout_case(), "elastic": _elastic_case(),
            **_checkpoint_cases(workdir, rank),
        }
        results.update(_live_elastic_case(workdir, rank))
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
    """``(results of every rank, workdir)``."""
    from test_torch_ring import spawn_ranks

    workdir = str(tmp_path_factory.mktemp("fsdp_sp"))
    spawn_ranks(__file__, WORLD, workdir)
    out = []
    for r in range(WORLD):
        results = {}
        with np.load(os.path.join(workdir, f"rank_{r}.npz")) as data:
            for key in data.files:
                case, _, name = key.partition("|")
                results.setdefault(case, {})[name] = data[key]
        out.append(results)
    return out, workdir


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("rule", ["", "_aeasgd"], ids=["downpour", "aeasgd"])
def test_fsdp_trajectory_equals_replicated_sp(ranks, rule):
    for results in ranks[0]:  # on every rank of the grid
        _assert_equal(results[f"fsdp{rule}"], results[f"sp{rule}"])


def test_center_is_stored_in_seq_shards(ranks):
    from distkeras_tpu_torch.parallel.engine import zero_shard_dim

    results, _ = ranks
    sharded = 0
    for rank, got in enumerate(results):
        layout, seq_index = got["layout"], rank % SEQ_SHARDS
        for key in [k for k in layout if k.startswith("whole/")]:
            name = key[len("whole/"):]
            whole, local = layout[key], layout[f"local0/{name}"]
            d = int(layout[f"dim/{name}"])
            assert d == zero_shard_dim(whole.shape, SEQ_SHARDS)
            # the gathered center is the whole initial one, which every worker copied
            np.testing.assert_array_equal(whole, local)
            shape = list(whole.shape)
            if d >= 0:
                sharded += 1
                shape[d] //= SEQ_SHARDS
                block = np.split(whole, SEQ_SHARDS, axis=d)[seq_index]
                assert block.shape == tuple(shape)
            assert list(layout[f"shape/{name}"]) == shape, name
    assert sharded  # the layout split something


def test_state_from_center_resumes_under_fsdp(ranks):
    elastic = ranks[0][0]["elastic"]
    assert np.isfinite(elastic["loss"]).all()
    assert int(elastic["epoch"]) == 4 and int(elastic["rows"]) == 2  # 2 of 4 workers a rank


def test_checkpoint_resume_at_two_seq_ranks_is_bitwise(ranks):
    results, _ = ranks
    for got in results:
        resumed, straight = got["resumed"], got["fsdp"]
        # the resumed run's history holds the epoch it ran
        np.testing.assert_array_equal(resumed.pop("loss"), straight["loss"][1:])
        _assert_equal(resumed, {k: v for k, v in straight.items() if k != "loss"})


def test_checkpoint_written_at_two_seq_ranks_restores_at_one_rank(ranks):
    """The files are the one-rank engine's: the seq-sharded center was
    gathered before the save, and a one-rank engine restores it whole."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.checkpoint import CheckpointManager, checkpoint_num_workers
    from distkeras_tpu_torch.models import TorchModel
    from distkeras_tpu_torch.parallel import WindowedEngine

    results, workdir = ranks
    directory = os.path.join(workdir, "ckpt_1")
    assert checkpoint_num_workers(directory, 1) == 2
    engine = WindowedEngine(TorchModel(_module(None)), "categorical_crossentropy", "sgd",
                            algorithms.Downpour(2), num_workers=2, device="cpu")
    like = engine.init_state(torch.Generator().manual_seed(0), None)
    state = CheckpointManager(directory).restore(like=like, step=1)
    assert state.epoch == 1
    for name, value in state.center_params.items():
        np.testing.assert_array_equal(value.numpy(), results[0]["first"][f"center/{name}"],
                                      err_msg=name)


def test_live_elastic_resize_over_the_grid_is_the_resume_path(ranks):
    results, _ = ranks
    for rank, got in enumerate(results):
        live, resumed = dict(got["live"]), dict(got["elastic_resumed"])
        assert int(live.pop("polls")) == (1 if rank == 0 else 0)  # rank 0 alone polls
        assert int(live.pop("warned")) == 1  # 5 workers over 2 ranks: rounded to 4
        np.testing.assert_array_equal(live.pop("loss")[1:], resumed.pop("loss"))
        _assert_equal(live, resumed)
