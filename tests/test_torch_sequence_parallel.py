"""Sequence parallelism in the port: the paper's trainers over the
``(workers, seq)`` grid of four gloo ranks on the CPU (2 workers x 2 seq
shards), against the JAX package's sequence-parallel engine on its CPU
devices and against the port's own data-parallel run.

Four ranks are spawned **once** for the module (``ranks`` fixture, the
pattern of ``test_torch_ring.py``): each runs this file as a script, joins
the gloo group and trains every case; rank 0 writes the results.  Both
packages start from the same parameters (the JAX init, carried over by
``params_from_flax`` and handed to the port by a test-side adapter), and
the data come from one numpy seed (tests/conftest.py's ``toy_text`` task
at 32 tokens, and the next-token task).

Tolerances:
* the port's SP against JAX's SP, loss history and center: ``rtol=1e-5,
  atol=1e-6`` (f32, SGD; both sum the same blocks in the same ring order);
* the port's SP against the port's DP: JAX's own bounds for SP against DP
  (tests/test_sequence_parallel.py, tests/test_lm.py): losses ``rtol=2e-4,
  atol=2e-5``, parameters ``rtol=5e-3, atol=5e-4``;
* streaming and ``remat`` against the in-memory SP run: bit for bit (the
  same windows, the same products);
* the returned twin's predictions against a seq-free model on the same
  parameters: bit for bit.
Dropout is 0 throughout (ROADMAP C6 and C11: the port's draws are its own).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD, SEQ_SHARDS, WORKERS = 4, 2, 2
CLS = dict(vocab_size=50, num_classes=2, dim=32, heads=2, num_layers=1, max_len=64)
LM = dict(vocab_size=23, dim=32, heads=2, num_layers=1, max_len=64)
SEQ, ROWS, SEED = 32, 64, 5
TRAIN = dict(worker_optimizer=("sgd", {"learning_rate": 0.05}), num_workers=WORKERS,
             batch_size=8, num_epoch=2, seed=SEED)
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
DP_LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
DP_PARAM_TOL = dict(rtol=5e-3, atol=5e-4)
SCHEDULE = [1, 2]


# ------------------------------------------------------- shared with the ranks

def _data(model):
    """``(x, y, loss)`` of the model's task: tests/conftest.py's toy_text
    (one-hot labels) for the classifier, the next-token task for the LM."""
    rng = np.random.default_rng(0)
    if model == "cls":
        x = rng.integers(0, CLS["vocab_size"], size=(ROWS, SEQ)).astype(np.int32)
        label = ((x == 7).sum(1) > (x == 3).sum(1)).astype(np.int32)
        return x, np.eye(2, dtype=np.float32)[label], "categorical_crossentropy"
    start = rng.integers(0, LM["vocab_size"], size=(ROWS, 1))
    x = ((start + np.arange(SEQ)) % LM["vocab_size"]).astype(np.int32)
    return x, ((x + 1) % LM["vocab_size"]).astype(np.int32), "token_crossentropy"


def _port_module(model, seq_axis):
    from distkeras_tpu_torch.models import TransformerClassifier, TransformerLM

    if model == "cls":
        return TransformerClassifier(**CLS, seq_axis=seq_axis)
    return TransformerLM(**LM, seq_axis=seq_axis)


def _adapter(model, seq_axis, init):
    from distkeras_tpu_torch.models import TorchModel

    class FixedInit(TorchModel):
        """Test-side adapter whose ``init`` returns the given parameters."""

        def init(self, generator, sample_input):
            return {k: v.clone() for k, v in init.items()}, {}

    return FixedInit(_port_module(model, seq_axis))


def _load_init(workdir, model):
    with np.load(os.path.join(workdir, f"init_{model}.npz")) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}


def port_run(workdir, model, seq_shards=SEQ_SHARDS, trainer="DOWNPOUR", shuffle=False,
             **kwargs):
    """One port training run: the returned model's parameters, the loss
    history, its predictions on 16 rows and whether the returned module is
    seq-free."""
    import distkeras_tpu_torch as tdk

    x, y, loss = _data(model)
    seq_axis = "seq" if seq_shards > 1 else None
    args = dict(TRAIN, loss=loss, metrics=(), seq_shards=seq_shards, device="cpu", **kwargs)
    if trainer == "EnsembleTrainer":
        args.pop("num_workers")
        t = tdk.EnsembleTrainer(_adapter(model, seq_axis, _load_init(workdir, model)),
                                num_models=WORKERS, **args)
    else:
        args.setdefault("communication_window", 2)
        t = getattr(tdk, trainer)(_adapter(model, seq_axis, _load_init(workdir, model)), **args)
    trained = t.train(tdk.from_numpy(x, y), shuffle=shuffle)
    out = {"loss": np.asarray(t.get_history()["loss"])}
    for i, m in enumerate(trained if isinstance(trained, list) else [trained]):
        out.update({f"{i}/{k}": v.numpy() for k, v in m.params.items()})
        out[f"{i}/predict"] = m.predict(x[:16])
        out[f"{i}/seq_free"] = np.asarray(all(getattr(mod, "seq_axis", None) is None
                                              for mod in m.adapter.module.modules()))
    return out


CASES = {
    "cls": ("cls", {}),
    "lm": ("lm", {}),
    "lm_streaming": ("lm", dict(streaming=True, prefetch=2)),
    "lm_remat": ("lm", dict(remat=True)),
    "lm_dispatch": ("lm", dict(dispatch_epochs=2, shuffle=True)),
    "lm_dynsgd": ("lm", dict(trainer="DynSGD", commit_schedule=SCHEDULE)),
    "cls_ensemble": ("cls", dict(trainer="EnsembleTrainer")),
}


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init,
                            world_size=world, rank=rank)
    try:
        results = {name: port_run(workdir, model, **kw) for name, (model, kw) in CASES.items()}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(workdir, "results.npz"),
                 **{f"{c}|{k}": v for c, r in results.items() for k, v in r.items()})


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------------- test process

def _jax_module(model, seq_axis):
    from distkeras_tpu.models import TransformerClassifier, TransformerLM

    if model == "cls":
        return TransformerClassifier(**CLS, seq_axis=seq_axis)
    return TransformerLM(**LM, seq_axis=seq_axis)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(results by case, workdir)``: the JAX initial parameters are
    written for the ranks, then the four ranks train every case."""
    import jax

    from distkeras_tpu.models import FlaxModel
    from distkeras_tpu_torch.models import params_from_flax
    from test_torch_ring import spawn_ranks

    workdir = str(tmp_path_factory.mktemp("sp"))
    for model in ("cls", "lm"):
        x = _data(model)[0]
        params, _ = FlaxModel(_jax_module(model, None)).init(jax.random.PRNGKey(SEED), x[:8])
        init = params_from_flax(_port_module(model, None), params)
        np.savez(os.path.join(workdir, f"init_{model}.npz"),
                 **{k: v.numpy() for k, v in init.items()})
    spawn_ranks(__file__, WORLD, workdir)
    results = {}
    with np.load(os.path.join(workdir, "results.npz")) as data:
        for key in data.files:
            case, _, name = key.partition("|")
            results.setdefault(case, {})[name] = data[key]
    return results, workdir


def _jax_sp(model, rule="downpour", commit_schedule=None):
    """The JAX engine at seq_shards=2 on its CPU devices, as its trainer
    drives it without shuffling: ``(loss history, center under the port's
    names)``.  The state is built with ``state_from_center`` around the
    initial parameters (the trainer's ``init_state`` inits the flax module
    op by op inside ``shard_map``, some 25 s on the CPU; the states agree
    but for the dropout keys, and dropout is 0)."""
    import jax

    import distkeras_tpu.algorithms as jax_algorithms
    from distkeras_tpu.data import epoch_arrays
    from distkeras_tpu.models import FlaxModel
    from distkeras_tpu.parallel import WindowedEngine
    from distkeras_tpu_torch.models import params_from_flax

    x, y, loss = _data(model)
    module = _jax_module(model, "seq")
    params, _ = FlaxModel(_jax_module(model, None)).init(jax.random.PRNGKey(SEED), x[:8])
    rule = (jax_algorithms.DynSGD(2) if rule == "dynsgd" else jax_algorithms.Downpour(2))
    engine = WindowedEngine(FlaxModel(module), loss, TRAIN["worker_optimizer"], rule,
                            num_workers=WORKERS, metrics=(), seq_shards=SEQ_SHARDS,
                            commit_schedule=commit_schedule)
    state = engine.state_from_center(jax.random.PRNGKey(SEED), params,
                                     rule.init_center_state(), {}, 0)
    history = []
    for _ in range(TRAIN["num_epoch"]):
        xs, ys = epoch_arrays(x, y, WORKERS, TRAIN["batch_size"], 2,
                              stepwise=commit_schedule is not None)
        state, stats = engine.run_epoch(state, *engine.shard_batches(xs, ys))
        history.append(float(np.mean(np.asarray(stats["loss"]))))
    center = jax.tree_util.tree_map(np.asarray, engine.gather_center(state))
    center = params_from_flax(_port_module(model, None), center)
    return np.asarray(history), {k: v.numpy() for k, v in center.items()}


def _assert_params(got, want, **tol):
    names = [k for k in want if k.startswith("0/") and k not in ("0/predict", "0/seq_free")]
    assert names
    for name in names:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


@pytest.mark.parametrize("case,rule,kwargs", [
    ("cls", "downpour", {}),
    ("lm", "downpour", {}),
    ("lm_dynsgd", "dynsgd", dict(commit_schedule=np.asarray(SCHEDULE))),
], ids=["classifier", "lm", "lm_dynsgd_schedule"])
def test_sp_matches_jax_sp(ranks, case, rule, kwargs):
    got = ranks[0][case]
    loss, center = _jax_sp(CASES[case][0], rule, **kwargs)
    np.testing.assert_allclose(got["loss"], loss, **JAX_TOL)
    _assert_params(got, {f"0/{k}": v for k, v in center.items()}, **JAX_TOL)


@pytest.mark.parametrize("case", ["cls", "lm", "lm_dispatch", "lm_dynsgd"])
def test_sp_matches_the_ports_dp(ranks, case):
    results, workdir = ranks
    model, kwargs = CASES[case]
    want = port_run(workdir, model, seq_shards=1, **kwargs)
    got = results[case]
    np.testing.assert_allclose(got["loss"], want["loss"], **DP_LOSS_TOL)
    _assert_params(got, want, **DP_PARAM_TOL)


@pytest.mark.parametrize("case", ["lm_streaming", "lm_remat"])
def test_streaming_and_remat_equal_the_in_memory_sp_run(ranks, case):
    results, _ = ranks
    got, want = results[case], results["lm"]
    np.testing.assert_array_equal(got["loss"], want["loss"])
    _assert_params(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["cls", "cls_ensemble"])
def test_returned_twin_predicts_without_a_mesh(ranks, case):
    from distkeras_tpu_torch.models import TorchModel, TrainedModel

    results, _ = ranks
    got = results[case]
    members = 2 if case == "cls_ensemble" else 1
    x = _data("cls")[0][:16]
    for i in range(members):
        assert bool(got[f"{i}/seq_free"])
        params = {k[len(f"{i}/"):]: torch.from_numpy(v) for k, v in got.items()
                  if k.startswith(f"{i}/") and k not in (f"{i}/predict", f"{i}/seq_free")}
        plain = TrainedModel(TorchModel(_port_module("cls", None)), params, device="cpu")
        assert got[f"{i}/predict"].shape == (16, 2)
        np.testing.assert_array_equal(got[f"{i}/predict"], plain.predict(x))
    if members == 2:  # two workers trained apart: two models
        assert not np.array_equal(got["0/predict"], got["1/predict"])
