"""Meshes: the port's engine and trainers over two ranks of a gloo process
group on the CPU, against the JAX engine's 4 workers on its 4-device CPU
mesh and against the port's own 1 rank x 4 workers.

Two ranks are spawned **once** for the module (``ranks`` fixture): each
runs this file as a script (``python tests/test_torch_mesh.py RANK WORLD
INIT DIR``; only torch and the port are imported there), joins the gloo
group through the file store ``INIT`` in the module's directory, runs every
case and leaves; rank 0 writes
the results, which the parametrised tests read.  Each rank owns 2 of the 4
workers.  The cases start from the JAX engine's initial parameters
(``params_from_flax``), written by the fixture before the spawn.

Tolerances: the JAX tiling invariance bound (tests/test_virtual_workers.py),
``rtol=1e-5, atol=1e-6`` at f32, for 2 ranks against JAX and against 1
rank (a 2-rank commit sums ``(w0 + w1) + (w2 + w3)``); commit counts and
DynSGD's clocks exact; a world of one rank bitwise the engine without a
group.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORKERS, WORLD = 4, 2
LM = dict(vocab_size=23, dim=32, heads=2, num_layers=1, max_len=16)
MLP_CFG = dict(features=(16,), num_classes=3)
MODELS = ("mlp", "lm")
RULES = ("downpour", "aeasgd", "eamsgd", "adag", "dynsgd", "dynsgd_schedule")
SCHEDULE = [1, 2, 3, 4]
TOL = dict(rtol=1e-5, atol=1e-6)
BATCH, WINDOW, WINDOWS, STEPS = 8, 2, 2, 4
SPAWN_TIMEOUT_S = 300


# ------------------------------------------------------- shared with the ranks

def _rule(name, lib):
    """The rule ``name`` from ``lib`` (either package's ``algorithms``)."""
    return {
        "downpour": lambda: lib.Downpour(WINDOW),
        "aeasgd": lambda: lib.Aeasgd(WINDOW, rho=5.0, learning_rate=0.05),
        "eamsgd": lambda: lib.Eamsgd(WINDOW, rho=5.0, learning_rate=0.05, momentum=0.9),
        "adag": lambda: lib.Adag(WINDOW),
        "dynsgd": lambda: lib.DynSGD(WINDOW),
        "dynsgd_schedule": lambda: lib.DynSGD(1),
    }[name]()


def _optimizer(rule):
    if rule == "eamsgd":
        return ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "nesterov": True})
    return ("sgd", {"learning_rate": 0.05})


def _task(model):
    """``(loss, metrics, features, labels)`` of the model's task."""
    rng = np.random.default_rng(7)
    n = WORKERS * WINDOWS * WINDOW * BATCH
    if model == "mlp":
        x = rng.normal(size=(n, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int) + (x[:, 1] > 0.5)]
        return "categorical_crossentropy", ("accuracy",), x, y
    start = rng.integers(0, LM["vocab_size"], size=(n, 1))
    x = ((start + np.arange(LM["max_len"])) % LM["vocab_size"]).astype(np.int32)
    return "token_crossentropy", ("token_accuracy",), x, (x + 1) % LM["vocab_size"]


def _epoch(model, rule):
    """The epoch arrays: ``[workers, windows, window, batch, ...]``, or
    ``[workers, steps, batch, ...]`` for the staleness simulation."""
    _, _, x, y = _task(model)
    lead = (WORKERS, STEPS) if rule == "dynsgd_schedule" else (WORKERS, WINDOWS, WINDOW)
    return x.reshape(lead + (BATCH,) + x.shape[1:]), y.reshape(lead + (BATCH,) + y.shape[1:])


def _module(model):
    from distkeras_tpu_torch.models import MLP, TransformerLM

    return MLP(**MLP_CFG, in_features=8) if model == "mlp" else TransformerLM(**LM)


def _adapter(model, init):
    from distkeras_tpu_torch.models import TorchModel

    class FixedInit(TorchModel):
        """Test-side adapter whose ``init`` returns the given parameters."""

        def init(self, generator, sample_input):
            return {k: v.clone() for k, v in init.items()}, {}

    return FixedInit(_module(model))


def _load_init(workdir, model):
    with np.load(os.path.join(workdir, f"init_{model}.npz")) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}


def _engine_case(workdir, model, rule, mesh=None, device="cpu", unroll=1, engine_box=None):
    """One epoch of the port's engine; the whole result on mesh rank 0 (or
    without a group), None elsewhere."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.checkpoint import gather_workers
    from distkeras_tpu_torch.parallel import WindowedEngine

    loss, metrics, _, _ = _task(model)
    xs, ys = _epoch(model, rule)
    engine = WindowedEngine(
        _adapter(model, _load_init(workdir, model)), loss, _optimizer(rule),
        _rule(rule, algorithms), WORKERS, metrics=metrics, mesh=mesh, device=device,
        unroll=unroll, commit_schedule=SCHEDULE if rule == "dynsgd_schedule" else None)
    if engine_box is not None:
        engine_box.append(engine)
    state = engine.init_state(torch.Generator().manual_seed(0), xs[0, 0, 0])
    state, stats = engine.run_epoch(state, *engine.shard_batches(xs, ys))
    full = gather_workers(state, engine.mesh)
    if full is None:
        return None
    out = {"loss": stats["loss"], "metrics": stats["metrics"],
           "num_updates": np.asarray(int(state.center_rule["num_updates"]))}
    out.update({f"center/{k}": v.cpu().numpy() for k, v in state.center_params.items()})
    out.update({f"local/{k}": v.cpu().numpy() for k, v in full.local_params.items()})
    if rule.startswith("dynsgd"):
        out["clock"] = full.rule_local["clock"].cpu().numpy()
    return out


def _frame(model="mlp"):
    import distkeras_tpu_torch as tdk

    _, _, x, y = _task(model)
    return tdk.from_numpy(x, y)


def _downpour(workdir, **kwargs):
    import distkeras_tpu_torch as tdk

    return tdk.DOWNPOUR(_adapter("mlp", _load_init(workdir, "mlp")),
                        loss="categorical_crossentropy", worker_optimizer=_optimizer("downpour"),
                        num_workers=WORKERS, batch_size=BATCH, communication_window=WINDOW,
                        device="cpu", **kwargs)


def _trained(trainer, frame, shuffle=True, **out):
    model = trainer.train(frame, shuffle=shuffle)
    out.update({f"center/{k}": v.numpy() for k, v in model.params.items()})
    out["loss"] = np.asarray(trainer.get_history()["loss"])
    out["num_updates"] = np.asarray(getattr(trainer, "num_updates", -1))
    return out


def _trainer_cases(workdir, rank):
    """dispatch_epochs=2, streaming, checkpoints (2 ranks and resumed at 2),
    train_with_recovery, Ensemble and Averaging over the mesh."""
    import torch.distributed as dist

    import distkeras_tpu_torch as tdk

    frame = _frame()
    out = {"dispatch": _trained(_downpour(workdir, num_epoch=2, dispatch_epochs=2), frame),
           "streaming": _trained(_downpour(workdir, num_epoch=1, streaming=True, prefetch=2),
                                 frame)}
    first, resumed = os.path.join(workdir, "ckpt_1"), os.path.join(workdir, "ckpt_2")
    out["ckpt_first"] = _trained(_downpour(workdir, num_epoch=1, checkpoint_dir=first), frame)
    if rank == 0:  # a copy to resume in, so ckpt_1 keeps only its step 1
        shutil.copytree(first, resumed)
    dist.barrier()
    out["ckpt_resumed"] = _trained(_downpour(workdir, num_epoch=2, checkpoint_dir=resumed,
                                             resume=True), frame)
    out["ckpt_straight"] = _trained(_downpour(workdir, num_epoch=2), frame)
    out["recovery"] = _recovery_case(workdir, frame)
    members = tdk.EnsembleTrainer(_adapter("mlp", _load_init(workdir, "mlp")),
                                  loss="categorical_crossentropy",
                                  worker_optimizer=_optimizer("downpour"), num_models=WORKERS,
                                  batch_size=BATCH, device="cpu").train(frame)
    out["ensemble"] = {f"{i}/{k}": v.numpy() for i, m in enumerate(members)
                       for k, v in m.params.items()}
    averaging = tdk.AveragingTrainer(_adapter("mlp", _load_init(workdir, "mlp")),
                                     loss="categorical_crossentropy",
                                     worker_optimizer=_optimizer("downpour"),
                                     num_workers=WORKERS, batch_size=BATCH, device="cpu")
    out["averaging"] = _trained(averaging, frame)
    return out


def _recovery_case(workdir, frame):
    """``train_with_recovery`` over the ranks: every rank's second epoch
    raises once (before any collective); every rank retries from rank 0's
    checkpoint of epoch 1."""
    from distkeras_tpu_torch.parallel import WindowedEngine

    real, calls = WindowedEngine.run_epoch, [0]

    def failing(engine, *args, **kwargs):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("lost a worker")
        return real(engine, *args, **kwargs)

    WindowedEngine.run_epoch = failing
    try:
        trainer = _downpour(workdir, num_epoch=2,
                            checkpoint_dir=os.path.join(workdir, "ckpt_recovery"))
        model = trainer.train_with_recovery(frame, shuffle=True, backoff_base=0)
    finally:
        WindowedEngine.run_epoch = real
    out = {f"center/{k}": v.numpy() for k, v in model.params.items()}
    out["run_epoch_calls"] = np.asarray(calls[0])
    return out


def _readout_case(workdir, rank):
    """``final_model_state`` (float mean, first worker's ints) and
    ``worker_slice`` of a worker that lives on the other rank."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.parallel import WindowedEngine

    engine = WindowedEngine(_adapter("mlp", _load_init(workdir, "mlp")), "mse", "sgd",
                            algorithms.Downpour(WINDOW), WORKERS, device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    workers = torch.arange(WORKERS)[engine.workers]
    state.model_state = {"mean": workers[:, None].float() * torch.ones(1, 3) + 0.5,
                         "count": workers * 10 + 1}
    final = engine.final_model_state(state)
    far = engine.worker_slice(state.model_state, WORKERS - 1)
    return {"mean": final["mean"].numpy(), "count": final["count"].numpy(),
            "far_mean": far["mean"].numpy(), "far_count": far["count"].numpy()}


def _error_cases():
    """The messages of what a 2-rank group refuses."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.parallel import WindowedEngine, make_mesh, make_mesh_grid

    errors = {}

    def caught(name, fn):
        try:
            fn()
        except ValueError as e:
            errors[name] = str(e)
        else:
            errors[name] = None

    caught("make_mesh_3", lambda: make_mesh(3))
    caught("make_mesh_0", lambda: make_mesh(0))
    caught("grid_2x2", lambda: make_mesh_grid(2, 2))
    caught("uneven_workers", lambda: WindowedEngine(
        _adapter("mlp", {}), "mse", "sgd", algorithms.Downpour(WINDOW), 3, device="cpu"))
    caught("predictor", lambda: tdk.ModelPredictor(_module("mlp"), device=["cpu", "cpu"],
                                                   num_devices=2))
    mesh, grid = make_mesh(), make_mesh_grid(2, 1)
    errors["mesh"] = [mesh.mesh_dim_names, list(mesh.shape), grid.mesh_dim_names,
                      list(grid.shape)]
    return errors


def _world_one_case(workdir, init):
    """A world of one gloo rank against no group, bit for bit: the commit's
    all-reduce and the stats' run over one rank."""
    import torch.distributed as dist

    alone = _engine_case(workdir, "mlp", "downpour")
    dist.init_process_group("gloo", init_method=init, world_size=1, rank=0)
    try:
        grouped = _engine_case(workdir, "mlp", "downpour")
    finally:
        dist.destroy_process_group()
    return {"alone": alone, "grouped": grouped}


def _flat(results, prefix=""):
    out = {}
    for k, v in results.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}|"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rank_main(rank: int, world: int, init: str, workdir: str, device: str) -> None:
    """One rank of the gloo group: every case on the CPU; on a card (both
    ranks sharing ``cuda:0``) the MLP's engine cases alone."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init,
                            world_size=world, rank=rank)
    errors = {}
    try:
        models = MODELS if device == "cpu" else ("mlp",)
        results = {f"{m}/{r}": _engine_case(workdir, m, r, device=device)
                   for m in models for r in RULES}
        if device == "cpu":
            results.update(_trainer_cases(workdir, rank))
            results["readout"] = _readout_case(workdir, rank)
            errors = _error_cases()
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return
    if device == "cpu":
        results["world_one"] = _world_one_case(workdir, init + "_world_one")
    np.savez(os.path.join(workdir, "results.npz"), **_flat(results))
    with open(os.path.join(workdir, "errors.json"), "w", encoding="utf-8") as fh:
        json.dump(errors, fh)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    sys.exit(0)


# ------------------------------------------------------------- test process

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_port(model, flax_params):
    """Flax parameters under the port module's names."""
    import jax

    from distkeras_tpu_torch.models import params_from_flax, variables_from_flax

    flax_params = jax.tree_util.tree_map(np.asarray, flax_params)
    if model == "mlp":
        return variables_from_flax(_module(model), {"params": flax_params})[0]
    return params_from_flax(_module(model), flax_params)


def _jax_init(model):
    import jax

    from distkeras_tpu.models import MLP as JaxMLP
    from distkeras_tpu.models import FlaxModel
    from distkeras_tpu.models import TransformerLM as JaxLM

    _, _, x, _ = _task(model)
    module = JaxMLP(**MLP_CFG) if model == "mlp" else JaxLM(**LM)
    params, _ = FlaxModel(module).init(jax.random.PRNGKey(0), x[:BATCH])
    return module, {k: v.numpy() for k, v in _to_port(model, params).items()}


def _jax_case(model, rule, module, init_np):
    """The JAX engine's 4 workers on 4 of its CPU devices, from the same
    parameters."""
    import jax

    import distkeras_tpu.algorithms as jax_algorithms
    from distkeras_tpu.models import FlaxModel
    from distkeras_tpu.parallel import WindowedEngine as JaxEngine

    loss, metrics, _, _ = _task(model)
    xs, ys = _epoch(model, rule)
    engine = JaxEngine(FlaxModel(module), loss, _optimizer(rule), _rule(rule, jax_algorithms),
                       num_workers=WORKERS, metrics=metrics,
                       commit_schedule=(np.asarray(SCHEDULE) if rule == "dynsgd_schedule"
                                        else None))
    assert engine.n_dev == WORKERS
    state = engine.init_state(jax.random.PRNGKey(0), _task(model)[2][:BATCH])
    start = _to_port(model, state.center_params)
    for k, v in start.items():  # the port starts from these
        np.testing.assert_array_equal(v.numpy(), init_np[k])
    state, stats = engine.run_epoch(state, *engine.shard_batches(xs, ys))
    port = lambda tree: _to_port(model, tree)
    out = {"loss": np.asarray(stats["loss"]), "metrics": np.asarray(stats["metrics"]),
           "num_updates": np.asarray(int(state.center_rule["num_updates"]))}
    out.update({f"center/{k}": v.numpy() for k, v in port(state.center_params).items()})
    local = jax.tree_util.tree_map(np.asarray, state.local_params)
    for w in range(WORKERS):
        one = port(jax.tree_util.tree_map(lambda a: a[w], local))
        for k, v in one.items():
            out.setdefault(f"local/{k}", []).append(v.numpy())
    out.update({k: np.stack(v) for k, v in out.items() if k.startswith("local/")})
    if rule.startswith("dynsgd"):
        out["clock"] = np.asarray(state.rule_local["clock"])
    return out


def _spawn(workdir: str, device: str = "cpu"):
    """Run the two ranks to their end; returns ``(results, errors)``."""
    from test_torch_ring import rendezvous

    init = rendezvous(workdir)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    env.pop("PYTHONSTARTUP", None)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), init, workdir,
                               device], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for proc in procs:  # a rank left waiting on a dead peer must not outlive the test
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-4000:]
    with np.load(os.path.join(workdir, "results.npz")) as data:
        flat = {k: data[k] for k in data.files}
    results = {}
    for key, value in flat.items():
        case, _, name = key.rpartition("|")
        results.setdefault(case, {})[name] = value
    with open(os.path.join(workdir, "errors.json"), encoding="utf-8") as fh:
        errors = json.load(fh)
    return results, errors


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two gloo ranks once; returns ``(results, errors, workdir,
    jax_inits)``."""
    workdir = str(tmp_path_factory.mktemp("mesh"))
    inits = {}
    for model in MODELS:
        module, init_np = _jax_init(model)
        inits[model] = (module, init_np)
        np.savez(os.path.join(workdir, f"init_{model}.npz"), **init_np)
    return (*_spawn(workdir), workdir, inits)


@pytest.fixture(scope="module")
def one_rank(ranks):
    """The port's 1 rank x 4 workers, every engine case, in this process."""
    workdir = ranks[2]
    return {f"{m}/{r}": _engine_case(workdir, m, r) for m in MODELS for r in RULES}


def _assert_close(got, want, keys, **tol):
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


def _compared_keys(result):
    return [k for k in result if k in ("loss", "metrics") or k.startswith(("center/", "local/"))]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("rule", RULES)
def test_two_ranks_match_jax_four_devices(ranks, model, rule):
    results, _, _, inits = ranks
    got = results[f"{model}/{rule}"]
    want = _jax_case(model, rule, *inits[model])
    _assert_close(got, want, _compared_keys(want), **TOL)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("rule", RULES)
def test_two_ranks_match_one_rank(ranks, one_rank, model, rule):
    got, want = ranks[0][f"{model}/{rule}"], one_rank[f"{model}/{rule}"]
    assert sorted(got) == sorted(want)
    _assert_close(got, want, _compared_keys(want), **TOL)


@pytest.mark.parametrize("rule", RULES)
def test_commit_counts_and_clocks_exact(ranks, one_rank, rule):
    results, _, _, inits = ranks
    for model in MODELS:
        got, want = results[f"{model}/{rule}"], one_rank[f"{model}/{rule}"]
        jax = _jax_case(model, rule, *inits[model]) if model == "mlp" else want
        for ref in (want, jax):
            assert int(got["num_updates"]) == int(ref["num_updates"])
            if rule.startswith("dynsgd"):
                np.testing.assert_array_equal(got["clock"], ref["clock"])
    if rule == "dynsgd_schedule":
        # periods 1, 2, 3, 4 over 4 steps: 4 + 2 + 1 + 1 commits
        assert int(got["num_updates"]) == 8
    else:
        assert int(got["num_updates"]) == WORKERS * WINDOWS


def _one_rank_trainer(workdir, **kwargs):
    return _trained(_downpour(workdir, **kwargs), _frame())


def test_run_epochs_dispatch_two_over_two_ranks(ranks):
    results, _, workdir, _ = ranks
    want = _one_rank_trainer(workdir, num_epoch=2, dispatch_epochs=2)
    got = results["dispatch"]
    assert got["loss"].shape == (2,)
    _assert_close(got, want, [k for k in want if k != "num_updates"], **TOL)
    assert int(got["num_updates"]) == int(want["num_updates"])


def test_streaming_over_two_ranks(ranks):
    results, _, workdir, _ = ranks
    want = _one_rank_trainer(workdir, num_epoch=1, streaming=True, prefetch=2)
    # the streamed trajectory is the in-memory one
    in_memory = _one_rank_trainer(workdir, num_epoch=1)
    for ref in (want, in_memory):
        _assert_close(results["streaming"], ref, [k for k in ref if k != "num_updates"], **TOL)


def test_checkpoint_written_at_two_ranks_resumes_at_two(ranks):
    results, _, workdir, _ = ranks
    from distkeras_tpu_torch.checkpoint import checkpoint_num_workers, verify_checkpoint

    first = os.path.join(workdir, "ckpt_1")
    assert checkpoint_num_workers(first, 1) == WORKERS
    assert verify_checkpoint(first, 1, mode="full")
    got, want = results["ckpt_resumed"], results["ckpt_straight"]
    for key in want:
        if key != "loss":  # the resumed run's history holds its own epoch only
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got["loss"], want["loss"][1:])


def test_checkpoint_written_at_two_ranks_resumes_at_one(ranks, tmp_path):
    results, _, workdir, _ = ranks
    from distkeras_tpu_torch.checkpoint import restore_checkpoint

    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(workdir, "ckpt_1"), ckpt)
    got = _one_rank_trainer(workdir, num_epoch=2, checkpoint_dir=ckpt, resume=True)
    want = results["ckpt_resumed"]
    _assert_close(got, want, [k for k in want if k != "num_updates"], **TOL)
    assert int(got["num_updates"]) == int(want["num_updates"])
    # the files hold every worker: a 1-rank restore takes all four
    state = restore_checkpoint(os.path.join(workdir, "ckpt_1"), 1)
    assert len(state["rng"]) == WORKERS
    assert all(v.shape[0] == WORKERS for v in state["local_params"].values())


def test_train_with_recovery_over_two_ranks(ranks):
    results = ranks[0]
    got, want = results["recovery"], results["ckpt_straight"]
    # epoch 1, the failed epoch 2, then epoch 2 again from the checkpoint
    assert int(got["run_epoch_calls"]) == 3
    for key in want:
        if key.startswith("center/"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_ensemble_and_averaging_over_two_ranks(ranks, tmp_path):
    results, _, workdir, _ = ranks
    import distkeras_tpu_torch as tdk

    members = tdk.EnsembleTrainer(_adapter("mlp", _load_init(workdir, "mlp")),
                                  loss="categorical_crossentropy",
                                  worker_optimizer=_optimizer("downpour"), num_models=WORKERS,
                                  batch_size=BATCH, device="cpu").train(_frame())
    for i, member in enumerate(members):  # independent workers: bit for bit
        for k, v in member.params.items():
            np.testing.assert_array_equal(results["ensemble"][f"{i}/{k}"], v.numpy())
    averaging = tdk.AveragingTrainer(_adapter("mlp", _load_init(workdir, "mlp")),
                                     loss="categorical_crossentropy",
                                     worker_optimizer=_optimizer("downpour"),
                                     num_workers=WORKERS, batch_size=BATCH, device="cpu")
    want = _trained(averaging, _frame())
    _assert_close(results["averaging"], want, [k for k in want if k != "num_updates"], **TOL)


def test_final_model_state_and_worker_slice_across_ranks(ranks):
    got = ranks[0]["readout"]
    np.testing.assert_allclose(got["mean"], np.full(3, 2.0), **TOL)  # mean of 0.5..3.5
    np.testing.assert_array_equal(got["count"], 1)  # worker 0's, on rank 0
    # worker 3 lives on rank 1: rank 0 receives it
    np.testing.assert_array_equal(got["far_mean"], np.full(3, 3.5))
    np.testing.assert_array_equal(got["far_count"], 31)


def test_world_of_one_rank_is_bitwise_no_group(ranks):
    got = ranks[0]
    alone, grouped = got["world_one|alone"], got["world_one|grouped"]
    assert sorted(alone) == sorted(grouped)
    for key in alone:
        np.testing.assert_array_equal(grouped[key], alone[key], err_msg=key)


def test_refusals_inside_a_group(ranks):
    errors = ranks[1]
    assert "num_workers=3 exceeds the ranks of the process group (2)" in errors["make_mesh_3"]
    assert "torchrun --nproc-per-node" in errors["make_mesh_3"]
    assert "at least one rank" in errors["make_mesh_0"]
    assert "needs 4 ranks, have 2" in errors["grid_2x2"]
    assert "does not split evenly over the mesh's 2 ranks" in errors["uneven_workers"]
    assert "each rank predicts on its own card" in errors["predictor"]
    assert errors["mesh"] == [["workers"], [2], ["workers", "seq"], [2, 1]]


def test_make_mesh_outside_a_group():
    from distkeras_tpu_torch.parallel import (
        LocalMesh,
        make_mesh,
        make_mesh_grid,
        replicated_sharding,
        worker_sharding,
    )

    mesh = make_mesh()
    assert isinstance(mesh, LocalMesh) and mesh.size() == 1 and mesh.get_group() is None
    assert make_mesh(1).mesh_dim_names == ("workers",)
    assert make_mesh_grid(1, 1).mesh_dim_names == ("workers", "seq")
    with pytest.raises(ValueError, match="exceeds the ranks of the process group"):
        make_mesh(2)
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh_grid(2, 1)
    assert worker_sharding(mesh).local_slice(4) == slice(0, 4)
    assert replicated_sharding(mesh).local_slice(4) == slice(0, 4)


def test_engine_takes_a_local_mesh_as_no_mesh(ranks):
    # mesh=LocalMesh() outside a group is the one-rank engine, bit for bit
    from distkeras_tpu_torch.parallel import make_mesh

    workdir = ranks[2]
    alone = _engine_case(workdir, "mlp", "dynsgd_schedule")
    local = _engine_case(workdir, "mlp", "dynsgd_schedule", mesh=make_mesh())
    for key in alone:
        np.testing.assert_array_equal(local[key], alone[key], err_msg=key)


def test_epoch_permutation_is_a_function_of_seed_and_epoch():
    # run_epochs broadcasts rank 0's permutation; the draw itself is pinned too
    from distkeras_tpu_torch.parallel.engine import epoch_permutation

    a, b = epoch_permutation(3, 1, 64, "cpu"), epoch_permutation(3, 1, 64, "cpu")
    assert torch.equal(a, b) and sorted(a.tolist()) == list(range(64))
    assert not torch.equal(a, epoch_permutation(3, 2, 64, "cpu"))


def _port_init(workdir):
    """The MLP's parameters drawn by the port itself (the card's machine has
    no JAX), written where the ranks read them."""
    module = _module("mlp")
    np.savez(os.path.join(workdir, "init_mlp.npz"),
             **{k: v.detach().numpy() for k, v in module.named_parameters()})


def _one_rank_group(backend: str):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)


@pytest.mark.cuda
def test_two_ranks_share_one_card_over_gloo(tmp_path):
    # NCCL refuses two ranks on one card; gloo all-reduces and broadcasts
    # the CUDA tensors through the host
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    workdir = str(tmp_path)
    _port_init(workdir)
    results, _ = _spawn(workdir, device="cuda")
    for rule in RULES:
        got, want = results[f"mlp/{rule}"], _engine_case(workdir, "mlp", rule, device="cuda")
        assert int(got["num_updates"]) == int(want["num_updates"]), rule
        _assert_close(got, want, _compared_keys(want), **TOL)
        if rule.startswith("dynsgd"):
            np.testing.assert_array_equal(got["clock"], want["clock"])


@pytest.mark.cuda
def test_captured_window_holds_the_nccl_all_reduce(tmp_path):
    # unroll=True on a card captures each window, the commit's all-reduce
    # inside the graph (after one warm-up collective made the communicator)
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    workdir = str(tmp_path)
    _port_init(workdir)
    eager = _engine_case(workdir, "mlp", "downpour", device="cuda")
    engines = []
    _one_rank_group("nccl")
    try:
        graph = _engine_case(workdir, "mlp", "downpour", device="cuda", unroll=True,
                             engine_box=engines)
    finally:
        dist.destroy_process_group()
    assert engines[0].use_graphs and engines[0].group is not None
    assert engines[0].graph_stats["captures"] >= 1
    assert engines[0].graph_stats["replays"] == WINDOWS
    _assert_close(graph, eager, _compared_keys(eager), **TOL)


@pytest.mark.cuda
def test_gloo_group_on_the_card_refuses_a_captured_window(tmp_path):
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    workdir = str(tmp_path)
    _port_init(workdir)
    _one_rank_group("gloo")
    try:
        with pytest.raises(ValueError, match="only NCCL collectives can be captured"):
            _engine_case(workdir, "mlp", "downpour", device="cuda", unroll=True)
    finally:
        dist.destroy_process_group()
