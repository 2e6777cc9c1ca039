"""Pipeline x sequence parallelism in the port: the pipeline engine over the
``(workers, stages, seq)`` grid of four gloo ranks on the CPU (1 workers
rank x 2 stages x 2 seq ranks), a staged model built with
``seq_axis="seq"``, case by case against tests/test_pp_sp.py: the JAX
package's ``PipelineEngine(seq_shards=2)`` on four of its CPU devices, and
the port's own sequential executor and one-rank trainer.

Four ranks are spawned **once** for the module (``ranks`` fixture, as in
``test_torch_pp_tp.py``, whose helpers this file shares): each runs this
file as a script, joins the gloo group through a file store, runs every case
and writes its results.  Both packages start from the same parameters (the
JAX staged model's initial parameters, carried over with
``params_from_flax``), and the data come from one numpy seed.

Tolerances: JAX's own (tests/test_pp_sp.py, tests/test_pp_tp.py): losses
``rtol=2e-4, atol=2e-5``, the center ``rtol=2e-3, atol=2e-4``; the pipelined
forward against the sequential one within 1e-5; fsdp against the port's
replicated run bit for bit; the elements a rank stores equal to JAX's shard
sizes.  Under Adam the key third of the fused ``qkv`` bias is held to its
round-off bound (``test_torch_pipeline.hold_key_third``).  What a card
captures is shown on the CPU as in ``test_torch_pipeline.py``
(``capture_case``): pp x sp, with and without fsdp.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

from test_torch_pipeline import ADAM, assert_run, classifier, flat, hold_key_third  # noqa: E402
from test_torch_pp_tp import (  # noqa: E402
    CENTER_TOL,
    FWD_TOL,
    TOL,
    assert_trainer,
    capture_cases,
    engine,
    forward_case,
    jax_init,
    jax_run,
    numel,
    one_rank_trainer,
    read_ranks,
    run,
    save_captures,
    save_rank,
    spawn_grid_ranks,
    trainer_case,
)

ROOT = Path(__file__).resolve().parent.parent
SHARDS = 2


# ------------------------------------------------------------------ the ranks

def _layout(state):
    return {"center_block": np.asarray(state.center_params["blocks"]["fc1.weight"].shape),
            "center_tok": np.asarray(state.center_params["embed"]["tok_embed.weight"].shape),
            **{f"center_{k}": v for k, v in numel(state.center_params).items()},
            **{f"local_{k}": v for k, v in numel(state.local_params).items()}}


def _cases(workdir):
    out = {}
    out["cls"], state = run(engine(workdir, seq=True, seq_shards=SHARDS), "cls")
    out["layout"] = _layout(state)
    out["cls_fsdp"], state = run(engine(workdir, seq=True, seq_shards=SHARDS, fsdp=True), "cls")
    out["layout_fsdp"] = _layout(state)
    out["lm"], state = run(engine(workdir, "lm", ADAM, seq=True, seq_shards=SHARDS), "lm")
    out["forward"] = forward_case(workdir, "cls", seq=True, seq_shards=SHARDS)
    out["forward_lm"] = forward_case(workdir, "lm", seq=True, seq_shards=SHARDS)
    out["trainer"] = trainer_case(seq_shards=SHARDS)
    return out


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    from distkeras_tpu_torch.parallel.mesh import SEQ_AXIS

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        results = _cases(workdir)
        capture = capture_cases(workdir, SEQ_AXIS, (
            ("sp", dict(seq=True, seq_shards=SHARDS)),
            ("sp_fsdp", dict(seq=True, seq_shards=SHARDS, fsdp=True))))
    finally:
        dist.destroy_process_group()
    save_rank(workdir, rank, results)
    save_captures(workdir, rank, capture)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------------- test process

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(results of every rank, JAX's runs, the one-rank trainer's run,
    every rank's capture cases)``."""
    from test_torch_pipeline import read_captures
    from test_torch_ring import wait_ranks

    workdir = str(tmp_path_factory.mktemp("pp_sp"))
    params, ports = {}, {}
    for kind in ("cls", "lm"):
        params[kind], ports[kind] = jax_init(kind)
        np.savez(os.path.join(workdir, f"init_{kind}.npz"), **flat(ports[kind]))
    procs = spawn_grid_ranks(__file__, workdir)
    try:
        jax_runs = {"cls": jax_run("cls", params["cls"], seq_shards=SHARDS),
                    "lm": jax_run("lm", params["lm"], seq_shards=SHARDS),
                    "lm_init": ports["lm"]}
        trainer = one_rank_trainer()
    finally:
        wait_ranks(procs, workdir)
    return read_ranks(workdir), jax_runs, trainer, read_captures(workdir, 4)


def test_pp_sp_pipelined_forward_matches_sequential(ranks):
    """On each rank's sequence block: the classifier's pooled outputs are
    the whole sequence's (the mean over seq), the LM's per-token outputs
    its block's, both the sequential executor's."""
    for got in ranks[0]:
        assert float(got["forward"]["err"]) <= FWD_TOL
        assert tuple(got["forward"]["shape"]) == (8, 2)
        assert float(got["forward_lm"]["err"]) <= FWD_TOL
        assert tuple(got["forward_lm"]["shape"]) == (8, 8, 50)


def test_pp_sp_trajectory_matches_jax(ranks):
    """1 worker x 2 stages x 2 seq ranks, the classifier, two epochs of
    Downpour(2) with SGD: JAX's 3-D pipeline's losses and center on every
    rank; each rank stores its stage's blocks whole over seq (half the
    blocks), as JAX places them."""
    want, shards = ranks[1]["cls"]
    whole = sum(v.size for n, v in want.items() if n.startswith("center/blocks/"))
    for got in ranks[0]:
        np.testing.assert_allclose(got["cls"]["loss"], want["loss"], **TOL)
        assert_run(got["cls"], want, **CENTER_TOL)
        lay = got["layout"]
        assert tuple(lay["center_block"]) == (1, 1, 128, 32)
        assert 2 * int(lay["center_blocks"]) == whole
        for key in ("center_embed", "center_blocks", "center_head", "local_blocks"):
            assert int(lay[key]) == shards["placed"][key] == shards["trained"][key], key


def test_pp_sp_fsdp_trajectory_matches_pp_sp(ranks):
    """All three: stage-split embed/head on the (workers, stages, seq) grid,
    the replicated run bit for bit, the embedding 25 rows a stage."""
    for got in ranks[0]:
        assert_run(got["cls_fsdp"], got["cls"], exact=True)
        assert tuple(got["layout_fsdp"]["center_tok"]) == (25, 32)


def test_pp_sp_causal_lm_matches_jax(ranks):
    """The staged causal LM with causal ring attention through the
    pipeline, per-token labels split over seq with the tokens, Adam: JAX's
    run."""
    want, _ = ranks[1]["lm"]
    init = ranks[1]["lm_init"]["blocks"]["attn.qkv.bias"]
    for got in ranks[0]:
        g, w = hold_key_third(got["lm"], want, init, 8)
        np.testing.assert_allclose(g["loss"], w["loss"], **TOL)
        assert_run(g, w, **CENTER_TOL)


def test_pp_sp_through_trainer_api(ranks):
    """``DOWNPOUR(..., pipeline_stages=2, seq_shards=2)``: the one-rank
    trainer's run, and the model handed back is the seq-free twin, which
    predicts on one rank."""
    want, init = ranks[2]
    for got in ranks[0]:
        assert str(got["trainer"]["twin_seq_axis"]) == "None"
        assert_trainer(got["trainer"], want, init)


def test_pp_sp_rejections():
    """JAX's errors in its words: a seq axis the staged model lacks, a
    ring-attention model without its axis, and a model axis with a seq
    axis."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.parallel import PipelineEngine

    make = lambda model, **kw: PipelineEngine(model, "categorical_crossentropy", "sgd",
                                              algorithms.Downpour(2), device="cpu", **kw)
    with pytest.raises(ValueError, match="seq_axis"):
        make(classifier(), seq_shards=2)
    with pytest.raises(ValueError, match="seq_axis"):
        make(classifier(seq_axis="seq"))
    with pytest.raises(ValueError, match="not supported"):
        make(classifier(seq_axis="seq"), tp_shards=2, seq_shards=2)


@pytest.mark.parametrize("layout", ["sp", "sp_fsdp"])
def test_a_pp_sp_window_captures_over_nccl_and_reads_nothing_on_the_host(ranks, layout):
    """``unroll=True`` on a card, grid 1 x 2 x 2 with the seq axis: the
    window (the stage shifts, the ring's hops in every tick forward and
    backward, a classifier's pmean, the stage sums and the seq-axis mean of
    the gradients; under fsdp the embed/head gather and reduce-scatter) is
    captured over NCCL, gloo refused by name; one window on each of the
    four ranks reads nothing on the host, and all four issue the same
    collectives in the same order."""
    from test_torch_pipeline import assert_captured

    assert_captured(ranks[3], layout)
