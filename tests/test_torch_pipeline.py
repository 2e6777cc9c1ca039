"""Pipeline parallelism in the port: the pipeline engine over the ``(workers,
stages)`` grid of two gloo ranks on the CPU (1 workers rank x 2 stages),
case by case against tests/test_pipeline_parallel.py and tests/test_pp_fsdp.py:
the JAX package's ``PipelineEngine`` on two of its CPU devices, and the
port's own sequential executor and one-rank trainer.

Two ranks are spawned **once** for the module (``ranks`` fixture, the
pattern of ``test_torch_tensor_parallel.py``): each runs this file as a
script, joins the gloo group and runs every case, and writes its results.
What a card captures (``unroll=True``: each window one CUDA graph, the
schedule's collectives inside) is shown here on the CPU: the constructor
on a faked card takes NCCL and refuses gloo by name, and one window reads
nothing on the host and issues the same collectives on both ranks
(``capture_<rank>.json``).
Both packages start from the same parameters (the JAX engine's initial
center, carried over with ``params_from_flax``), and the data come from one
numpy seed.  The JAX engines run in the pytest process while the ranks run.

Tolerances: the pipelined forward against the sequential one within 1e-5;
the trajectories against JAX's ``PipelineEngine`` ``rtol=2e-4, atol=2e-5``
(the engine tests' bound), the center too; remat, fsdp and ``run_epochs``
against the port's own run bit for bit (each is a layout or a schedule of
the same math); the pipeline trainer against the one-rank trainer within
the trajectories' bound.  Under Adam the key third of the fused ``qkv``
bias is held to its round-off bound instead (:func:`hold_key_third`, as in
tests/test_torch_tensor_parallel.py).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD, STAGES = 2, 2
TOL = dict(rtol=2e-4, atol=2e-5)
FWD_TOL = 1e-5
MICROBATCHES = (1, 2, 4)
SGD = ("sgd", {"learning_rate": 0.05})
ADAM = ("adam", {"learning_rate": 2e-3})
CLS = dict(vocab_size=50, num_classes=2, dim=32, heads=2, num_stages=2, blocks_per_stage=1,
           max_len=64)
LM = dict(vocab_size=50, dim=32, heads=2, num_stages=2, blocks_per_stage=2, max_len=64)


# ------------------------------------------------------- shared with the ranks

def toy_text(n=32, seq=16, vocab=50, seed=0):
    """tests/conftest.py's toy task: tokens and one-hot labels."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, size=(n, seq)).astype(np.int32)
    y = ((x == 7).sum(1) > (x == 3).sum(1)).astype(np.int32)
    return x, np.eye(2, dtype=np.float32)[y]


def lm_text(n=32, seq=16, vocab=50, seed=1):
    rng = np.random.default_rng(seed)
    x = ((rng.integers(0, vocab, size=(n, 1)) + np.arange(seq)) % vocab).astype(np.int32)
    return x, ((x + 1) % vocab).astype(np.int32)


def epoch_data(x, y, n_windows=2, window=2, batch=8):
    """One worker's epoch ``[1, n_windows, window, batch, ...]``."""
    n = n_windows * window * batch
    return (x[:n].reshape(1, n_windows, window, batch, *x.shape[1:]),
            y[:n].reshape(1, n_windows, window, batch, *y.shape[1:]))


def flat(tree, prefix=""):
    """A staged parameter tree as ``{"embed/tok_embed.weight": array}``."""
    return {f"{prefix}{k}/{n}": np.asarray(v) for k, sub in tree.items()
            for n, v in sub.items()}


def unflat(arrays, prefix=""):
    out = {}
    for key, value in arrays.items():
        if key.startswith(prefix):
            k, n = key[len(prefix):].split("/", 1)
            out.setdefault(k, {})[n] = torch.from_numpy(np.array(value))
    return out


def staged(kind, init=None, **kwargs):
    """The port's staged model; with ``init``, its ``init`` returns those
    parameters (the JAX engine's, carried over)."""
    from distkeras_tpu_torch.models import StagedLM, StagedTransformer

    model = (StagedLM(**LM, **kwargs) if kind == "lm"
             else StagedTransformer(**CLS, **kwargs))
    if init is not None:
        model.init = lambda generator, sample: (
            {k: {n: v.clone() for n, v in sub.items()} for k, sub in init.items()}, {})
    return model


def _load(workdir, kind):
    with np.load(os.path.join(workdir, f"init_{kind}.npz")) as got:
        return unflat({k: got[k] for k in got.files})


def _engine(workdir, kind="cls", microbatches=2, opt=SGD, device="cpu", **kwargs):
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.parallel import PipelineEngine

    loss = "token_crossentropy" if kind == "lm" else "categorical_crossentropy"
    return PipelineEngine(staged(kind, _load(workdir, kind)), loss, opt, algorithms.Downpour(2),
                          1, microbatches=microbatches, metrics=(), device=device, **kwargs)


def _data(kind):
    return epoch_data(*(lm_text() if kind == "lm" else toy_text()))


def _run(engine, xs, ys, epochs=2):
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    sx, sy = engine.shard_batches(xs, ys)
    losses = []
    for _ in range(epochs):
        state, stats = engine.run_epoch(state, sx, sy)
        losses.append(stats["loss"])
    return {**flat(engine.gather_center(state), "center/"), "loss": np.concatenate(losses)}, state


def _trajectory_cases(workdir):
    """The classifier at each microbatch count; remat; ``run_epochs``; the
    staged LM replicated and under fsdp."""
    out = {}
    xs, ys = _data("cls")
    for m in MICROBATCHES:
        out[f"M{m}"], _ = _run(_engine(workdir, microbatches=m), xs, ys)
    out["remat"], _ = _run(_engine(workdir, remat=True), xs, ys)
    engine = _engine(workdir)
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    state, stats = engine.run_epochs(state, *engine.shard_batches(xs, ys), 2)
    out["multi"] = {**flat(engine.gather_center(state), "center/"), "loss": stats["loss"]}
    xs, ys = _data("lm")
    for name, fsdp in (("lm_rep", False), ("lm_fsdp", True)):
        engine = _engine(workdir, "lm", opt=ADAM, fsdp=fsdp)
        out[name], state = _run(engine, xs, ys)
        if fsdp:  # this rank's stored blocks: the layout survives the epochs
            out[name].update({
                "center_tok": np.asarray(state.center_params["embed"]["tok_embed.weight"].shape),
                "local_tok": np.asarray(state.local_params["embed"]["tok_embed.weight"].shape),
                "moments": np.asarray([tuple(m["embed"]["tok_embed.weight"].shape)
                                       for m in state.opt_state.values()
                                       if isinstance(m, dict) and "embed" in m]),
                "head_bias": np.asarray(state.center_params["head"]["out.bias"].shape)})
    return out


def _forward_case(workdir):
    """The pipelined view's forward (2 microbatches) on this rank's blocks
    against the sequential executor on the whole parameters; and an lr=0
    epoch's reported loss against the sequential loss of the same batches."""
    from distkeras_tpu_torch.ops import get_loss
    from distkeras_tpu_torch.parallel.mesh import bind_mesh
    from distkeras_tpu_torch.utils.pytree import tree_map

    xs, ys = _data("cls")
    engine = _engine(workdir, opt=("sgd", {"learning_rate": 0.0}))
    center = _load(workdir, "cls")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    local = tree_map(lambda t: t[0], state.local_params)
    x = torch.from_numpy(xs[0, 0, 0])
    with torch.no_grad(), bind_mesh(engine.mesh):
        got = engine.adapter.apply(local, {}, x)[0]
    want = engine.user_adapter.apply(center, {}, x)[0]
    _, stats = engine.run_epoch(state, *engine.shard_batches(xs, ys))
    loss = get_loss("categorical_crossentropy")
    seq = np.mean([float(loss(engine.user_adapter.apply(center, {}, torch.from_numpy(xs[0, w, t]))[0],
                              torch.from_numpy(ys[0, w, t])))
                   for w in range(xs.shape[1]) for t in range(xs.shape[2])])
    return {"err": np.asarray(float((got - want).abs().max())),
            "loss": np.asarray(float(np.mean(stats["loss"]))), "seq_loss": np.asarray(seq)}


def _layout_case(workdir):
    """This rank's stored shapes: a blocks leaf of the center and of the
    worker's parameters, and the embedding."""
    engine = _engine(workdir)
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    return {"center_block": np.asarray(state.center_params["blocks"]["fc1.weight"].shape),
            "local_block": np.asarray(state.local_params["blocks"]["fc1.weight"].shape),
            "center_tok": np.asarray(state.center_params["embed"]["tok_embed.weight"].shape),
            "stage": np.asarray(engine.stage_index),
            "block": state.center_params["blocks"]["fc1.weight"].numpy()}


def _resume_case(workdir):
    """fsdp: an epoch, the whole center, a fresh engine's
    ``state_from_center`` (sharded again), an epoch more."""
    xs, ys = _data("cls")
    engine = _engine(workdir, fsdp=True)
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    sx, sy = engine.shard_batches(xs, ys)
    state, _ = engine.run_epoch(state, sx, sy)
    center = engine.gather_center(state)
    fresh = _engine(workdir, fsdp=True)
    resumed = fresh.state_from_center(torch.Generator().manual_seed(1), center,
                                      state.center_rule, {}, 1)
    tok = resumed.center_params["embed"]["tok_embed.weight"]
    whole = fresh.gather_center(resumed)["embed"]["tok_embed.weight"]
    resumed, stats = fresh.run_epoch(resumed, sx, sy)
    return {"tok_shape": np.asarray(tok.shape),
            "whole_err": np.asarray(float((whole - center["embed"]["tok_embed.weight"]).abs().max())),
            "loss": stats["loss"], "epoch": np.asarray(resumed.epoch)}


def _head_form_case(workdir):
    """lr=0 epochs of the classifier declaring logits and probabilities, and
    each declaration's closed form on the sequential outputs of the rows."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.parallel import PipelineEngine

    xs, ys = _data("cls")
    out = {}
    for name, logits in (("logits", True), ("probs", False)):
        model = staged("cls", _load(workdir, "cls"), outputs_logits=logits)
        engine = PipelineEngine(model, "categorical_crossentropy",
                                ("sgd", {"learning_rate": 0.0}), algorithms.Downpour(2), 1,
                                microbatches=2, metrics=(), device="cpu")
        out[f"{name}_declared"] = np.asarray(engine.adapter.outputs_logits)
        run, _ = _run(engine, xs, ys, epochs=1)
        out[name] = np.asarray(float(np.mean(run["loss"])))
    x = torch.from_numpy(xs.reshape(-1, xs.shape[-1]))
    y = torch.from_numpy(ys.reshape(-1, ys.shape[-1]))
    outs = staged("cls").apply(_load(workdir, "cls"), {}, x)[0]
    out["want_logits"] = np.asarray(float(-(y * torch.log_softmax(outs, -1)).sum(-1).mean()))
    p = outs.clamp(1e-7, 1 - 1e-7)
    out["want_probs"] = np.asarray(float(-(y * torch.log(p)).sum(-1).mean()))
    return out


def _trainer_case():
    """``DOWNPOUR(..., pipeline_stages=2, pp_microbatches=2)`` on the
    staged LM through ``train(frame)``."""
    import distkeras_tpu_torch as tdk

    x, y = lm_text(n=64)
    t = tdk.DOWNPOUR(staged("lm"), loss="token_crossentropy", metrics=("token_accuracy",),
                     worker_optimizer=ADAM, num_workers=1, batch_size=8, num_epoch=2,
                     communication_window=2, pipeline_stages=STAGES, pp_microbatches=2,
                     seed=3, device="cpu")
    trained = t.train(tdk.from_numpy(x, y))
    return {"loss": np.asarray(t.get_history()["loss"]), **flat(trained.params, "params/"),
            "predict": trained.predict(x[:4])}


def _checkpoint_case(workdir):
    """fsdp through the trainer: one epoch checkpointed, a resume for one
    more, against two epochs straight (each rank's stage blocks and
    embed/head halves gathered whole into the files, split again on
    restore)."""
    import torch.distributed as dist

    import distkeras_tpu_torch as tdk

    x, y = lm_text(n=32)
    directory = os.path.join(workdir, "ckpt")
    out = {}
    for name, kw in (("straight", dict(num_epoch=2)),
                     ("first", dict(num_epoch=1, checkpoint_dir=directory)),
                     ("resumed", dict(num_epoch=2, checkpoint_dir=directory, resume=True))):
        t = tdk.DOWNPOUR(staged("lm"), loss="token_crossentropy", metrics=(),
                         worker_optimizer=ADAM, num_workers=1, batch_size=8,
                         communication_window=2, pipeline_stages=STAGES, fsdp=True, seed=5,
                         device="cpu", **kw)
        out.update(flat(t.train(tdk.from_numpy(x, y)).params, f"{name}/"))
        dist.barrier()
    return out


def _refusal_case():
    """The pipeline with a model axis, and with a seq axis (one stage here,
    so that the grid's checks pass on two ranks): each builds its 3-D grid;
    both at once is refused, in JAX's words."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import StagedLM
    from distkeras_tpu_torch.parallel import PipelineEngine

    out = {}
    one = dict(LM, num_stages=1)
    for name, kwargs in (("tp", dict(tp_shards=2)), ("seq", dict(seq_shards=2)),
                         ("both", dict(tp_shards=2, seq_shards=2))):
        model = StagedLM(**one, seq_axis="seq" if "seq_shards" in kwargs else None)
        try:
            engine = PipelineEngine(model, "token_crossentropy", "sgd", algorithms.Downpour(2),
                                    device="cpu", **kwargs)
            out[name] = np.asarray([*engine.mesh.mesh_dim_names,
                                    *map(str, engine.mesh.shape)])
        except (NotImplementedError, ValueError) as e:
            out[name] = np.asarray([str(e)])
    return out


def _broadcast_case(rank):
    """``broadcast_from_last``: the last stage's value on both, and its
    backward keeping the cotangent on the last stage."""
    from distkeras_tpu_torch.parallel.mesh import (
        PP_AXIS,
        WORKER_AXIS,
        bind_mesh,
        broadcast_from_last,
        make_mesh_grid,
    )

    grid = make_mesh_grid(1, WORLD, axis_names=(WORKER_AXIS, PP_AXIS))
    x = torch.full((3,), float(rank + 1) if rank == WORLD - 1 else 0.0, requires_grad=True)
    with bind_mesh(grid):
        y = broadcast_from_last(x, PP_AXIS)
        (g,) = torch.autograd.grad((y * torch.arange(3.0)).sum(), x)
    return {"y": y.detach().numpy(), "g": g.numpy()}


def capture_case(build, kind) -> dict:
    """A pipeline window as a card captures it: ``build(device)`` (the
    engine, ``unroll=True``) on a faked card whose groups run NCCL, then
    gloo; then one ``_window_body`` of the engine built on the CPU, on this
    rank's block of the first window, under the transfer guard with every
    collective recorded.  Shared with ``test_torch_pp_tp.py`` and
    ``test_torch_pp_sp.py``."""
    from test_torch_ring import capture_refusals, host_reads, recording_collectives

    out = {"card": capture_refusals(lambda: build("cuda"))}
    engine = build("cpu")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    sx, sy = engine.shard_batches(*_data(kind))
    with recording_collectives(ranks=True) as log, host_reads() as reads:
        engine._window_body(state, sx[:, 0], sy[:, 0], True)
    out["collectives"], out["host_reads"] = log, reads
    out["stage"] = engine.stage_index
    return out


def _capture_cases(workdir) -> dict:
    """:func:`capture_case` for the staged LM on the 1 x 2 grid, replicated
    and under fsdp."""
    from distkeras_tpu_torch.parallel.mesh import PP_AXIS, WORKER_AXIS, make_mesh_grid

    grid = make_mesh_grid(1, WORLD, axis_names=(WORKER_AXIS, PP_AXIS))
    return {name: capture_case(lambda device: _engine(workdir, "lm", opt=ADAM, mesh=grid,
                                                      unroll=True, device=device, **kwargs),
                               "lm")
            for name, kwargs in (("replicated", {}), ("fsdp", dict(fsdp=True)))}


def read_captures(workdir, world) -> list:
    """Every rank's ``capture_<rank>.json``, in rank order."""
    import json

    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"capture_{rank}.json"), encoding="utf-8") as fh:
            out.append(json.load(fh))
    return out


def assert_captured(got: list, layout: str) -> None:
    """The window of ``layout`` as a card captures it, on every rank (``got``
    in rank order): the constructor on a faked card captures over NCCL and
    refuses gloo by name; no host read; every rank of each group issues the
    group's collectives in the same order as the group's other ranks (the
    stage axis's shifts, broadcast from the last stage and gradient sums;
    the third axis's gathers, psums or ring hops; the commit), so that the
    captured windows pair at every replay.  The ranks of one stage run the
    same ticks: their whole logs agree, so that the collectives of
    different groups are ordered alike on every rank of a third-axis group."""
    groups, stage_of, logs = [], [], []
    for rank, g in enumerate(got):
        card = g[layout]["card"]
        assert card["nccl"] == "captures", card
        assert card["gloo"].startswith("ValueError") and "NCCL" in card["gloo"], card
        assert g[layout]["host_reads"] == []
        mine = {}
        for *entry, members in g[layout]["collectives"]:
            mine.setdefault(tuple(members), []).append(entry)
        groups.append(mine)
        logs.append([entry for *entry, _ in g[layout]["collectives"]])
        stage_of.append(g[layout]["stage"])
        # a shift is one batch_isend_irecv over NCCL, a send and a receive here
        calls = {c[0] for c in logs[-1]}
        assert "all_reduce" in calls and calls & {"isend", "batch_isend_irecv"}, calls
    for rank, mine in enumerate(groups):
        for members, entries in mine.items():
            for other in members:
                assert groups[other][members] == entries, (rank, other, members)
        for other, stage in enumerate(stage_of):
            if stage == stage_of[rank]:
                assert logs[other] == logs[rank], (rank, other)


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import json

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        results = {**_trajectory_cases(workdir), "forward": _forward_case(workdir),
                   "layout": _layout_case(workdir), "resume": _resume_case(workdir),
                   "head_form": _head_form_case(workdir), "trainer": _trainer_case(),
                   "refused": _refusal_case(), "bfl": _broadcast_case(rank),
                   "ckpt": _checkpoint_case(workdir)}
        capture = _capture_cases(workdir)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank_{rank}.npz"),
             **{f"{c}|{k}": v for c, r in results.items() for k, v in r.items()})
    with open(os.path.join(workdir, f"capture_{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(capture, fh)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------------- test process

def jax_engine(kind, microbatches=2, fsdp=False):
    import jax

    from distkeras_tpu.algorithms import Downpour
    from distkeras_tpu.models import StagedLM, StagedTransformer
    from distkeras_tpu.parallel import PipelineEngine

    if kind == "lm":
        model, loss, opt = StagedLM(**LM), "token_crossentropy", ADAM
    else:
        model, loss, opt = StagedTransformer(**CLS), "categorical_crossentropy", SGD
    return PipelineEngine(model, loss, opt, Downpour(2), num_workers=1,
                          microbatches=microbatches, metrics=(), fsdp=fsdp,
                          devices=jax.devices()[:STAGES])


def to_port(kind, tree):
    from distkeras_tpu_torch.models import params_from_flax

    return {k: {n: v.numpy() for n, v in sub.items()}
            for k, sub in params_from_flax(staged(kind), tree).items()}


def jax_run(kind, microbatches=2, fsdp=False, epochs=2):
    import jax

    engine = jax_engine(kind, microbatches, fsdp)
    xs, ys = _data(kind)
    state = engine.init_state(jax.random.PRNGKey(0), xs[0, 0, 0])
    init = to_port(kind, jax.tree.map(np.asarray, engine.gather_center(state)))
    sx, sy = engine.shard_batches(xs, ys)
    losses = []
    for _ in range(epochs):
        state, stats = engine.run_epoch(state, sx, sy)
        losses.append(np.asarray(stats["loss"]))
    center = to_port(kind, jax.tree.map(np.asarray, engine.gather_center(state)))
    return init, {**flat(center, "center/"), "loss": np.concatenate(losses)}


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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(results of every rank, JAX's runs, every rank's capture cases)``:
    the JAX initial parameters are written for the ranks, which start; the
    JAX engines run meanwhile."""
    from test_torch_ring import start_ranks, wait_ranks

    workdir = str(tmp_path_factory.mktemp("pp"))
    jax_runs = {}
    init, jax_runs["M1"] = jax_run("cls", microbatches=1)
    np.savez(os.path.join(workdir, "init_cls.npz"), **flat(init))
    init, jax_runs["lm_fsdp"] = jax_run("lm", fsdp=True)
    np.savez(os.path.join(workdir, "init_lm.npz"), **flat(init))
    jax_runs["lm_init"] = unflat(flat(init))
    procs = start_ranks(__file__, WORLD, workdir)
    try:
        for m in MICROBATCHES[1:]:
            jax_runs[f"M{m}"] = jax_run("cls", microbatches=m)[1]
    finally:
        wait_ranks(procs, workdir)
    return read_ranks(workdir), jax_runs, read_captures(workdir, WORLD)


def classifier(**changes):
    from distkeras_tpu_torch.models import StagedTransformer

    return StagedTransformer(**{**CLS, **changes})


def hold_key_third(got, want, init, steps, prefix="center/"):
    """``got`` and ``want`` without the key third of the fused ``qkv``
    bias, which is held to its bound instead: its gradient is zero in exact
    arithmetic (a softmax over keys does not see a shift that is the same
    for every key), so Adam, which divides a gradient by the root of its own
    second moment, steps it by up to its learning rate a step on round-off
    alone, in either package (tests/test_torch_tensor_parallel.py)."""
    name = f"{prefix}blocks/attn.qkv.bias"
    keys = np.s_[..., LM["dim"]:2 * LM["dim"]]
    lr = ADAM[1]["learning_rate"]
    for bias in (got[name], want[name]):
        assert np.abs(bias[keys] - init[keys]).max() <= lr * steps
    rest = lambda b: np.delete(b, np.r_[LM["dim"]:2 * LM["dim"]], axis=-1)
    return {**got, name: rest(got[name])}, {**want, name: rest(want[name])}


def assert_run(got, want, exact=False, **tol):
    names = sorted(k for k in want if k.startswith("center/"))
    assert names == sorted(k for k in got if k.startswith("center/"))
    for name in names + ["loss"]:
        if exact:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


def test_pipelined_forward_matches_sequential(ranks):
    """The pipelined view on each rank's stage gives the sequential
    model's outputs, and an lr=0 epoch reports the sequential loss."""
    for got in ranks[0]:
        f = got["forward"]
        assert float(f["err"]) <= FWD_TOL
        np.testing.assert_allclose(f["loss"], f["seq_loss"], rtol=FWD_TOL)


@pytest.mark.parametrize("microbatches", MICROBATCHES)
def test_pipeline_trajectory_matches_jax(ranks, microbatches):
    """1 worker x 2 stages, the classifier, two epochs of Downpour(2) with
    SGD: JAX's PipelineEngine's losses and center, at every microbatch
    count, on both stage ranks (each gathers the whole center)."""
    for got in ranks[0]:
        assert_run(got[f"M{microbatches}"], ranks[1][f"M{microbatches}"], **TOL)


def test_pipeline_stage_params_are_stage_sharded(ranks):
    """Each stage rank stores only its stage's block leaves; the embedding
    stays whole; the two blocks are the whole leaf's halves."""
    layouts = [got["layout"] for got in ranks[0]]
    for s, lay in enumerate(layouts):
        assert int(lay["stage"]) == s
        assert tuple(lay["center_block"]) == (1, 1, 128, 32)  # [1 stage, per_stage, ...]
        assert tuple(lay["local_block"]) == (1, 1, 1, 128, 32)  # [worker, ...]
        assert tuple(lay["center_tok"]) == (50, 32)
    whole = ranks[0][0]["M1"]  # any gathered center: its block leaf is [2, 1, ...]
    assert whole["center/blocks/fc1.weight"].shape == (2, 1, 128, 32)
    assert not np.array_equal(layouts[0]["block"], layouts[1]["block"])


def test_pipeline_multi_epoch_dispatch_matches_loop(ranks):
    """``run_epochs`` (one call) equals ``run_epoch`` called twice."""
    got = ranks[0][0]
    assert_run(got["multi"], got["M2"], exact=True)


def test_pipeline_remat_trajectory_identical(ranks):
    """Recomputing each tick's stage on the backward changes no bit."""
    got = ranks[0][0]
    assert_run(got["remat"], got["M2"], exact=True)


def test_pipeline_respects_declared_head_form(ranks):
    """The pipelined view forwards the staged model's ``outputs_logits``:
    the two declarations train two objectives, each its closed form on the
    sequential outputs of the epoch's rows (the mean over steps of a mean
    over rows is the mean over rows: every step has 8)."""
    got = ranks[0][0]["head_form"]
    assert bool(got["logits_declared"]) and not bool(got["probs_declared"])
    assert abs(float(got["logits"]) - float(got["probs"])) > 1e-3
    np.testing.assert_allclose(got["logits"], got["want_logits"], rtol=FWD_TOL)
    np.testing.assert_allclose(got["probs"], got["want_probs"], rtol=FWD_TOL)


def test_pipeline_through_trainer_api(ranks):
    """``DOWNPOUR(..., pipeline_stages=2, pp_microbatches=2)`` on the staged
    LM trains the one-rank trainer's run (``pipeline_stages=1``, the same
    seed and data: 2 epochs of 8 steps), and returns a whole model that
    predicts anywhere."""
    import distkeras_tpu_torch as tdk

    x, y = lm_text(n=64)
    t = tdk.DOWNPOUR(staged("lm"), loss="token_crossentropy", metrics=("token_accuracy",),
                     worker_optimizer=ADAM, num_workers=1, batch_size=8, num_epoch=2,
                     communication_window=2, seed=3, device="cpu")
    trained = t.train(tdk.from_numpy(x, y))
    want = {"loss": np.asarray(t.get_history()["loss"]), **flat(trained.params, "params/")}
    init = staged("lm").init(torch.Generator().manual_seed(3), None)[0]
    for got in ranks[0]:
        got, want_ = hold_key_third(got["trainer"], want,
                                    init["blocks"]["attn.qkv.bias"].numpy(), 16, "params/")
        np.testing.assert_allclose(got["loss"], want_["loss"], **TOL)
        for name in (k for k in want_ if k.startswith("params/")):
            np.testing.assert_allclose(got[name], want_[name], err_msg=name, **TOL)
        assert got["predict"].shape == (4, 16, 50)
        np.testing.assert_allclose(got["predict"].sum(-1), 1.0, rtol=1e-5)


def test_trainer_pipeline_kwarg_validation():
    """JAX's trainer errors, in its words: a seq axis the staged model
    lacks, and a model that is not staged."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TextCNN

    x, onehot = toy_text()
    frame = tdk.from_numpy(x, onehot)
    t = tdk.DOWNPOUR(staged("cls"), pipeline_stages=2, seq_shards=2, num_workers=1,
                     batch_size=8, num_epoch=1, device="cpu")
    with pytest.raises(ValueError, match="seq_axis"):
        t.train(frame)
    t2 = tdk.DOWNPOUR(TextCNN(vocab_size=50, num_classes=2), pipeline_stages=2, num_workers=1,
                      batch_size=8, num_epoch=1, device="cpu")
    with pytest.raises(ValueError, match="staged adapter"):
        t2.train(frame)
    t3 = tdk.DOWNPOUR(staged("cls"), pipeline_stages=2, num_workers=1, batch_size=8,
                      num_epoch=1, device="cpu", commit_schedule=[1])
    with pytest.raises(ValueError, match="commit_schedule"):
        t3.train(frame)


def test_pipeline_rejects_bad_configs():
    """Three stages do not divide one rank; a model that is not staged."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import TextCNN
    from distkeras_tpu_torch.parallel import PipelineEngine

    with pytest.raises(ValueError, match="divide"):
        PipelineEngine(classifier(num_stages=3), "categorical_crossentropy", "sgd",
                       algorithms.Downpour(2), device="cpu")
    with pytest.raises(TypeError, match="staged adapter"):
        PipelineEngine(TextCNN(vocab_size=10, num_classes=2), "categorical_crossentropy",
                       "sgd", algorithms.Downpour(2), device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        PipelineEngine(classifier(num_stages=1), "categorical_crossentropy", "sgd",
                       algorithms.Downpour(2), microbatches=0, device="cpu")


def test_pipeline_layouts_to_come_are_refused_by_name(ranks):
    """A model axis or a seq axis on the pipeline (item 15c-ii, ported)
    builds the 3-D grid, 1 x 1 x 2 on two ranks; both at once stays refused
    in JAX's words."""
    for got in ranks[0]:
        refused = got["refused"]
        assert list(refused["tp"]) == ["workers", "stages", "model", "1", "1", "2"]
        assert list(refused["seq"]) == ["workers", "stages", "seq", "1", "1", "2"]
        assert "not supported" in str(refused["both"][0])


def test_broadcast_from_last_keeps_the_cotangent_on_the_last_stage(ranks):
    for r, got in enumerate(ranks[0]):
        np.testing.assert_array_equal(got["bfl"]["y"], np.full(3, float(WORLD)))
        want = np.arange(3.0) if r == WORLD - 1 else np.zeros(3)
        np.testing.assert_array_equal(got["bfl"]["g"], want)


@pytest.mark.parametrize("layout", ["replicated", "fsdp"])
def test_a_pipeline_window_captures_over_nccl_and_reads_nothing_on_the_host(ranks, layout):
    """``unroll=True`` on a card: the 1 x 2 pipeline's window (and under
    fsdp, with the embed/head gather and reduce-scatter) is captured over
    NCCL, gloo refused by name; one window on each stage rank reads
    nothing on the host, and both ranks issue the same collectives in the
    same order, the bubble ticks' zero shifts included."""
    assert_captured(ranks[2], layout)


# ---------------------------------------------------------------- fsdp

def test_pp_fsdp_trajectory_equals_replicated(ranks):
    """Stage-split embed/head against the replicated layout: the same run
    bit for bit (the gather and reduce-scatter add no math)."""
    got = ranks[0][0]
    assert_run(got["lm_fsdp"], got["lm_rep"], exact=True)


def test_pp_fsdp_staged_lm_matches_jax(ranks):
    """The staged LM with its vocab embedding and head split over the
    stages, Adam: JAX's fsdp pipeline run."""
    init = ranks[1]["lm_init"]["blocks"]["attn.qkv.bias"].numpy()
    for got in ranks[0]:
        # 2 epochs of 2 windows of 2 steps
        assert_run(*hold_key_third(got["lm_fsdp"], ranks[1]["lm_fsdp"], init, 8), **TOL)


def test_pp_fsdp_state_is_stage_sharded(ranks):
    """The vocab embedding stores half a stage in the center, the worker's
    parameters and both Adam moments; the 50-wide head bias splits too
    (``zero_shard_dim``: 25 rows a stage)."""
    for got in ranks[0]:
        lm = got["lm_fsdp"]
        assert tuple(lm["center_tok"]) == (25, 32)
        assert tuple(lm["local_tok"]) == (1, 25, 32)
        assert [tuple(m) for m in lm["moments"]] == [(1, 25, 32), (1, 25, 32)]
        assert tuple(lm["head_bias"]) == (25,)


def test_pp_fsdp_state_from_center_resumes(ranks):
    for got in ranks[0]:
        r = got["resume"]
        assert tuple(r["tok_shape"]) == (25, 32)
        assert float(r["whole_err"]) == 0.0
        assert np.isfinite(r["loss"]).all() and int(r["epoch"]) == 2


def test_pp_fsdp_checkpoint_resume_is_bitwise(ranks):
    """A checkpointed fsdp pipeline resumed for its second epoch ends where
    two straight epochs end, bit for bit, on both stage ranks."""
    for got in ranks[0]:
        ckpt = got["ckpt"]
        names = [k[len("straight/"):] for k in ckpt if k.startswith("straight/")]
        assert names
        for name in names:
            np.testing.assert_array_equal(ckpt[f"resumed/{name}"], ckpt[f"straight/{name}"],
                                          err_msg=name)


def test_pp_fsdp_rejects_unauditable_optimizers():
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.parallel import PipelineEngine

    with pytest.raises(ValueError, match="named worker"):
        PipelineEngine(staged("cls"), "categorical_crossentropy", get_optimizer(SGD),
                       algorithms.Downpour(2), fsdp=True, device="cpu")


def test_pp_fsdp_single_stage_rejected():
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.parallel import PipelineEngine

    with pytest.raises(ValueError, match="num_stages"):
        PipelineEngine(classifier(num_stages=1), "categorical_crossentropy", "sgd",
                       algorithms.Downpour(2), fsdp=True, device="cpu")
