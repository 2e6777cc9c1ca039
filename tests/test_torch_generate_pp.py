"""Pipelined ``StagedLM`` decode in the port over two gloo ranks on the CPU
(one stage of blocks and one stage's KV cache a rank) against the
sequential executor and against the JAX package's decode
(tests/test_generate_pp.py): the tokens are the same, token for token.

Two ranks are spawned **once** for the module (``ranks`` fixture, the
pattern of ``test_torch_tensor_parallel.py``): each runs this file as a
script, joins the gloo group, decodes every case and writes its tokens.
The flax parameters of JAX's ``StagedLM`` are carried over with
``params_from_flax``; the prompts come from numpy seeds.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
VOCAB = 23
LAYOUTS = {"2x2": (2, 2), "2x1": (2, 1)}
STEPS = 6


def config(num_stages, per_stage):
    return dict(vocab_size=VOCAB, dim=32, heads=2, num_stages=num_stages,
                blocks_per_stage=per_stage, max_len=64)


def prompts():
    rng = np.random.default_rng(3)
    return (rng.integers(0, VOCAB, size=(4, 8)).astype(np.int32),
            np.arange(3 * 5, dtype=np.int32).reshape(3, 5) % VOCAB)


# ------------------------------------------------------- shared with the ranks

def _params(workdir, name):
    with np.load(os.path.join(workdir, f"init_{name}.npz")) as got:
        out = {}
        for key in got.files:
            k, n = key.split("/", 1)
            out.setdefault(k, {})[n] = torch.from_numpy(got[key])
    return out


def _decode_cases(workdir):
    from distkeras_tpu_torch.models import StagedLM
    from distkeras_tpu_torch.models.generate import (
        greedy_generate_staged,
        greedy_generate_staged_pipelined,
    )

    long, short = prompts()
    out = {}
    for name, layout in LAYOUTS.items():
        staged, params = StagedLM(**config(*layout)), _params(workdir, name)
        out[f"{name}/pp"] = greedy_generate_staged_pipelined(staged, params, long, STEPS,
                                                             device="cpu")
        out[f"{name}/seq"] = greedy_generate_staged(staged, params, long, STEPS, device="cpu")
    staged, params = StagedLM(**config(*LAYOUTS["2x2"])), _params(workdir, "2x2")
    for steps in (0, 1):
        out[f"short/pp{steps}"] = greedy_generate_staged_pipelined(staged, params, short, steps,
                                                                   device="cpu")
        out[f"short/seq{steps}"] = greedy_generate_staged(staged, params, short, steps,
                                                          device="cpu")
    return out


def _entry_point_case():
    """A ``StagedLM`` from ``SingleTrainer`` (every rank trains the one
    worker whole) through ``greedy_generate``, sequential and pipelined."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import StagedLM, greedy_generate

    x = (np.arange(64 * 16).reshape(64, 16) % VOCAB).astype(np.int32)
    y = ((x + 1) % VOCAB).astype(np.int32)
    t = tdk.SingleTrainer(StagedLM(**config(2, 2)), loss="token_crossentropy",
                          metrics=("token_accuracy",), worker_optimizer=("adam", {"learning_rate": 2e-3}),
                          batch_size=16, num_epoch=1, device="cpu")
    trained = t.train(tdk.from_numpy(x, y))
    prompt = x[:2, :6]
    return {"seq": greedy_generate(trained, prompt, 4),
            "pp": greedy_generate(trained, prompt, 4, pipelined=True)}


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        results = {**_decode_cases(workdir),
                   **{f"entry/{k}": v for k, v in _entry_point_case().items()}}
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank_{rank}.npz"), **results)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------------- test process

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(tokens of every rank, JAX's tokens)``: JAX's parameters are
    written for the ranks; JAX decodes while they run."""
    import jax

    from distkeras_tpu.models import StagedLM as JaxStagedLM
    from distkeras_tpu.models.generate import greedy_generate_staged
    from distkeras_tpu_torch.models import StagedLM, params_from_flax
    from test_torch_ring import start_ranks, wait_ranks

    workdir = str(tmp_path_factory.mktemp("generate_pp"))
    models = {}
    for name, layout in LAYOUTS.items():
        model = JaxStagedLM(**config(*layout))
        params, _ = model.init(jax.random.PRNGKey(0), np.zeros((2, 8), np.int32))
        port = params_from_flax(StagedLM(**config(*layout)), params)
        np.savez(os.path.join(workdir, f"init_{name}.npz"),
                 **{f"{k}/{n}": v.numpy() for k, sub in port.items() for n, v in sub.items()})
        models[name] = (model, params)
    procs = start_ranks(__file__, WORLD, workdir)
    try:
        long, short = prompts()
        want = {name: np.asarray(greedy_generate_staged(m, p, long, STEPS))
                for name, (m, p) in models.items()}
        want.update({f"short{s}": np.asarray(greedy_generate_staged(*models["2x2"], short, s))
                     for s in (0, 1)})
    finally:
        wait_ranks(procs, workdir)
    got = []
    for r in range(WORLD):
        with np.load(os.path.join(workdir, f"rank_{r}.npz")) as data:
            got.append({k: data[k] for k in data.files})
    return got, want


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipelined_decode_matches_sequential(ranks, layout):
    """Each rank holds one stage's blocks and KV cache; the tokens are the
    sequential executor's and JAX's, on both ranks."""
    got, want = ranks
    long, _ = prompts()
    for tokens in got:
        pp = tokens[f"{layout}/pp"]
        assert pp.shape == (4, 8 + STEPS) and pp.dtype == np.int32
        np.testing.assert_array_equal(pp, tokens[f"{layout}/seq"])
        np.testing.assert_array_equal(pp, want[layout])
        np.testing.assert_array_equal(pp[:, :8], long)


def test_pipelined_decode_single_step_and_zero(ranks):
    got, want = ranks
    _, short = prompts()
    for tokens in got:
        np.testing.assert_array_equal(tokens["short/pp0"], short)
        for steps in (0, 1):
            np.testing.assert_array_equal(tokens[f"short/pp{steps}"],
                                          tokens[f"short/seq{steps}"])
            np.testing.assert_array_equal(tokens[f"short/pp{steps}"], want[f"short{steps}"])


def test_pipelined_decode_rejects_too_few_devices():
    """One process, no group: one rank for two stages."""
    from distkeras_tpu_torch.models import StagedLM
    from distkeras_tpu_torch.models.generate import greedy_generate_staged_pipelined

    staged = StagedLM(**config(2, 2))
    params, _ = staged.init(torch.Generator().manual_seed(0), None)
    with pytest.raises(ValueError, match="devices"):
        greedy_generate_staged_pipelined(staged, params, np.zeros((1, 4), np.int32), 2,
                                         device="cpu")


def test_pipelined_entry_point_kwarg(ranks):
    """``greedy_generate(pipelined=True)`` routes a trainer's ``StagedLM``
    through the stage ranks, to the sequential tokens; a model that is not
    staged refuses the keyword."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TransformerLM, greedy_generate

    for tokens in ranks[0]:
        np.testing.assert_array_equal(tokens["entry/pp"], tokens["entry/seq"])
        assert tokens["entry/pp"].shape == (2, 10)
    x = (np.arange(64 * 16).reshape(64, 16) % VOCAB).astype(np.int32)
    t = tdk.SingleTrainer(TransformerLM(vocab_size=VOCAB, dim=16, heads=2, num_layers=1,
                                        max_len=32),
                          loss="token_crossentropy", metrics=("token_accuracy",),
                          batch_size=16, num_epoch=1, device="cpu")
    trained = t.train(tdk.from_numpy(x, ((x + 1) % VOCAB).astype(np.int32)))
    with pytest.raises(TypeError, match="pipelined"):
        greedy_generate(trained, x[:2, :6], 2, pipelined=True)
