"""Tensor parallelism in the port: the GSPMD engine over the ``(workers,
model)`` grid of four gloo ranks on the CPU (2 workers ranks x 2 model
ranks), case by case against tests/test_tensor_parallel.py: the JAX
package's ``GSPMDEngine`` on four of its CPU devices, and the port's own
data-parallel engine.

Four ranks are spawned **once** for the module (``ranks`` fixture, the
pattern of ``test_torch_ring.py``): each runs this file as a script, joins
the gloo group and runs every case; rank 0 writes the results, and every
rank its own layout.  Both packages start from the same parameters (the JAX
engine's initial center, carried over with ``variables_from_flax`` /
``params_from_flax`` and handed to the port by a test-side adapter), and
the data come from one numpy seed.

Tolerances: JAX's own for TP against DP (tests/test_tensor_parallel.py),
``rtol=2e-5, atol=2e-6``, for the MLP trajectories against JAX's GSPMD
engine and against the port's data-parallel engine (the staleness
simulation, the dropout LM at one rank); the classifier under ADAG with Adam
within 1e-4, but for the key third of the fused ``qkv`` bias: its gradient
is zero in exact arithmetic (a softmax over keys does not see a shift that
is the same for every key), so Adam, which divides a gradient by the root
of its own second moment, steps it by up to its learning rate on round-off
alone, in either package; it is held to that bound (``lr`` a step from its
initial value) instead; a checkpointed run against the straight one within
``rtol=1e-5, atol=1e-6`` (JAX's bound); the placement functions and the
per-rank element counts exactly.  The two autograd Functions of
``parallel/mesh.py`` against the unsharded product within 1e-6.

The ranks also make the checks of a window a card captures (``unroll``
other than 1): the engine's constructor on a faked card captures over NCCL
and refuses gloo (``tp_shards=2``; fsdp alone), and one window of the TP
engine (a ``TransformerLM``, grid 2 x 2) and of the fsdp engine (the MLP,
grid 4 x 1) reads nothing on the host while every rank issues the same
collectives in the same order (each rank's ``capture_<rank>.json``).
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD, TP = 4, 2
TOL = dict(rtol=2e-5, atol=2e-6)
CLS_TOL = dict(rtol=1e-4, atol=1e-4)
CKPT_TOL = dict(rtol=1e-5, atol=1e-6)
FN_TOL = dict(rtol=1e-6, atol=1e-6)
SGD = ("sgd", {"learning_rate": 0.05})
CLS = dict(vocab_size=50, num_classes=2, dim=16, heads=2, num_layers=1, max_len=16)
LM = dict(vocab_size=23, dim=32, heads=2, num_layers=1, max_len=16)
SCHEDULE = [2, 3, 4, 5]
# (JAX MLP features, workers, windows, epochs) of the MLP trajectory cases
MLP_CASES = {"mlp_tp": ((32, 16), 4, 2, 2), "virtual": ((32,), 8, 1, 1)}


# ------------------------------------------------------- shared with the ranks

def data(n=256, d=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(x @ rng.normal(size=(d, classes)), axis=1).astype(np.int32)
    return x, y, np.eye(classes, dtype=np.float32)[y]


def epoch_arrays(x, onehot, num_workers, n_windows, window, batch):
    n = num_workers * n_windows * window * batch
    xs = x[:n].reshape(num_workers, n_windows, window, batch, -1)
    ys = np.argmax(onehot[:n], -1).reshape(num_workers, n_windows, window, batch)
    return xs, ys.astype(np.int32)


def toy_classification():
    """tests/conftest.py's toy task (the ranks do not load the conftest)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 8)).astype(np.float32)
    y = (x @ rng.normal(size=(8,)) > 0).astype(np.int32)
    return x, y, np.eye(2, dtype=np.float32)[y]


def toy_text(n=128, seq=16, vocab=50, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, size=(n, seq)).astype(np.int32)
    y = ((x == 7).sum(1) > (x == 3).sum(1)).astype(np.int32)
    return x, y


def fixed(module, params, buffers=None):
    """A test-side adapter over ``module`` whose ``init`` returns the given
    parameters (the JAX engine's, carried over)."""
    from distkeras_tpu_torch.models import TorchModel

    class FixedInit(TorchModel):
        def init(self, generator, sample_input):
            return ({k: v.clone() for k, v in params.items()},
                    {k: v.clone() for k, v in (buffers or {}).items()})

    return FixedInit(module)


def load(workdir, name):
    with np.load(os.path.join(workdir, f"init_{name}.npz")) as got:
        return {k: torch.from_numpy(got[k]) for k in got.files}


def port_mlp(features, classes=4, in_features=16, seed=7):
    from distkeras_tpu_torch.models import MLP

    return MLP(features=features, num_classes=classes, in_features=in_features,
               generator=torch.Generator().manual_seed(seed))


def run(engine, xs, ys, epochs):
    """tests/test_tensor_parallel.py's ``_run``: the center (whole) and
    the last epoch's losses."""
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    sx, sy = engine.shard_batches(xs, ys)
    for _ in range(epochs):
        state, stats = engine.run_epoch(state, sx, sy)
    center = engine.gather_center(state)
    out = {f"center/{k}": v.numpy() for k, v in center.items()}
    out["loss"] = np.asarray(stats["loss"])
    return out


def _gspmd(adapter, rule, workers, opt=SGD, **kwargs):
    from distkeras_tpu_torch.parallel import GSPMDEngine

    return GSPMDEngine(adapter, "categorical_crossentropy", opt, rule, num_workers=workers,
                       metrics=(), device="cpu", **kwargs)


def _one_rank(adapter, rule, workers, opt=SGD, **kwargs):
    """The port's data-parallel engine on one rank (no collective)."""
    from distkeras_tpu_torch.parallel import WindowedEngine
    from distkeras_tpu_torch.parallel.mesh import LocalMesh

    return WindowedEngine(adapter, "categorical_crossentropy", opt, rule, num_workers=workers,
                          metrics=(), device="cpu", mesh=LocalMesh(), **kwargs)


def _mlp_cases(workdir):
    from distkeras_tpu_torch import algorithms

    x, _, onehot = data(n=512)
    out = {}
    for name, (features, workers, windows, epochs) in MLP_CASES.items():
        xs, ys = epoch_arrays(x, onehot, workers, windows, 4, 8)
        engine = _gspmd(fixed(port_mlp(features), load(workdir, name)), algorithms.Downpour(4),
                        workers, tp_shards=TP)
        out[name] = {**run(engine, xs, ys, epochs), "virtual": np.asarray(engine.virtual)}
    return out


def _classifier_case(workdir):
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import TransformerClassifier

    x, y = toy_text()
    xs, ys = x.reshape(2, 2, 4, 8, 16), y.reshape(2, 2, 4, 8)
    engine = _gspmd(fixed(TransformerClassifier(**CLS), load(workdir, "cls")),
                    algorithms.Adag(4), 2, opt=("adam", {"learning_rate": 1e-3}), tp_shards=TP)
    return run(engine, xs, ys, 1)


def _layout_case(workdir):
    """Each center and local leaf's shape on this rank, and its model dim,
    for the MLP and the classifier at ``tp_shards=2``."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import TransformerClassifier

    out = {}
    for model, adapter in (("mlp", fixed(port_mlp((32, 16)), load(workdir, "mlp_tp"))),
                           ("cls", fixed(TransformerClassifier(**CLS), load(workdir, "cls")))):
        engine = _gspmd(adapter, algorithms.Downpour(4), 2, tp_shards=TP)
        state = engine.init_state(torch.Generator().manual_seed(0), None)
        for name, leaf in state.center_params.items():
            out[f"{model}/center/{name}"] = np.asarray(leaf.shape)
            out[f"{model}/local/{name}"] = np.asarray(state.local_params[name].shape)
            out[f"{model}/dim/{name}"] = np.asarray(engine._tp_dims[name])
    return out


def _dropout_lm_case():
    """``TransformerLM`` with dropout 0.1 through ``DOWNPOUR``: ``tp_shards=2``
    on the grid against the port's one rank (``tp_shards=1``), from the
    same seeds, and the workers' generator states after training."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.parallel.mesh import LocalMesh

    rng = np.random.default_rng(0)
    x = ((rng.integers(0, 23, size=(32, 1)) + np.arange(16)) % 23).astype(np.int32)
    y = ((x + 1) % 23).astype(np.int32)
    out = {}
    for name, tp, remat in (("tp2", TP, False), ("tp2_remat", TP, True), ("tp1", 1, False)):
        t = tdk.DOWNPOUR(TransformerLM(**LM, dropout=0.1, generator=torch.Generator().manual_seed(1)),
                         loss="token_crossentropy", metrics=("token_accuracy",),
                         worker_optimizer=("sgd", {"learning_rate": 0.1}), num_workers=2,
                         batch_size=4, communication_window=2, num_epoch=2, seed=3,
                         tp_shards=tp, remat=remat, device="cpu")
        mesh = None if tp > 1 else LocalMesh()
        rule = t.allocate_worker().rule
        t.service()
        engine, state, adapter = t._fit(tdk.from_numpy(x, y), rule, 2, mesh=mesh)
        model = t._finalize(engine, state, adapter)
        out[f"{name}/loss"] = np.asarray(t.get_history()["loss"])
        out.update({f"{name}/center/{k}": v.numpy() for k, v in model.params.items()})
        out[f"{name}/rng"] = torch.stack([g.get_state() for g in state.rng]).numpy()
    return out


def _staleness_case():
    from distkeras_tpu_torch import algorithms

    x, _, onehot = data(n=512)
    workers, n_steps, batch = 4, 8, 8
    n = workers * n_steps * batch
    xs = x[:n].reshape(workers, n_steps, batch, -1)
    ys = np.argmax(onehot[:n], -1).reshape(workers, n_steps, batch).astype(np.int32)
    init = dict(port_mlp((32,)).named_parameters())
    mlp = lambda: fixed(port_mlp((32,)), {k: v.detach() for k, v in init.items()})
    ref = _one_rank(mlp(), algorithms.DynSGD(4), workers, commit_schedule=SCHEDULE)
    tp = _gspmd(mlp(), algorithms.DynSGD(4), workers, tp_shards=TP, commit_schedule=SCHEDULE)
    return {**{f"ref/{k}": v for k, v in run(ref, xs, ys, 1).items()},
            **{f"tp/{k}": v for k, v in run(tp, xs, ys, 1).items()}}


def _trainer(num_epoch, **kwargs):
    import distkeras_tpu_torch as tdk

    return tdk.DOWNPOUR(port_mlp(kwargs.pop("features", (32,)), 2, 8),
                        loss="categorical_crossentropy", num_workers=4, batch_size=16,
                        num_epoch=num_epoch, communication_window=4, tp_shards=TP, device="cpu",
                        **kwargs)


def _trainer_case():
    import distkeras_tpu_torch as tdk

    x, _, onehot = toy_classification()
    t = _trainer(8, worker_optimizer=("sgd", {"learning_rate": 0.1}))
    trained = t.train(tdk.from_numpy(x, onehot))
    return {"loss": np.asarray(t.get_history()["loss"]), "predict": trained.predict(x)}


def _trainer_variants_case():
    """``dispatch_epochs=2`` with the on-device reshuffle, ``AveragingTrainer``
    and ``EnsembleTrainer`` at ``tp_shards=2`` (2 x 2 grid) and at
    ``tp_shards=1`` (the windowed engine over the 4 ranks, one worker each)."""
    import distkeras_tpu_torch as tdk

    x, _, onehot = toy_classification()
    frame = tdk.from_numpy(x, onehot)
    out = {}
    for tp in (TP, 1):
        kw = dict(loss="categorical_crossentropy", worker_optimizer=("sgd", {"learning_rate": 0.1}),
                  batch_size=16, num_epoch=2, seed=2, tp_shards=tp, device="cpu")
        model = lambda: port_mlp((16,), 2, 8)
        runs = {"dispatch": [tdk.DOWNPOUR(model(), num_workers=4, communication_window=4,
                                          dispatch_epochs=2, **kw).train(frame, shuffle=True)],
                "averaging": [tdk.AveragingTrainer(model(), num_workers=4, **kw).train(frame)],
                "ensemble": tdk.EnsembleTrainer(model(), num_models=4, **kw).train(frame)}
        for name, models in runs.items():
            for i, m in enumerate(models):
                out.update({f"tp{tp}/{name}/{i}/{k}": v.numpy() for k, v in m.params.items()})
    return out


def _checkpoint_case(workdir, rank):
    import torch.distributed as dist

    import distkeras_tpu_torch as tdk

    x, _, onehot = toy_classification()
    directory = os.path.join(workdir, "ckpt")
    out = {}

    def make(num_epoch, **kw):
        return _trainer(num_epoch, features=(16,), seed=11,
                        worker_optimizer=("sgd", {"learning_rate": 0.05}), **kw)

    for name, t in (("straight", make(4)), ("first", make(2, checkpoint_dir=directory)),
                    ("resumed", make(4, checkpoint_dir=directory, resume=True))):
        trained = t.train(tdk.from_numpy(x, onehot))
        out.update({f"{name}/{k}": v.numpy() for k, v in trained.params.items()})
        dist.barrier()
    return out


def _bad_case():
    from distkeras_tpu_torch import algorithms

    try:
        _gspmd(fixed(port_mlp((32,)), {}), algorithms.Downpour(4), 4, tp_shards=3)
    except ValueError as e:
        return {"tp3": np.asarray(str(e))}
    return {"tp3": np.asarray("")}


def _function_cases(rank):
    """:func:`gather_from_axis` and :func:`copy_to_axis` on the 2 x 2 grid:
    a product split over ``model`` on its output rows, each rank's
    gradients for its block."""
    from distkeras_tpu_torch.parallel.mesh import (
        TP_AXIS,
        WORKER_AXIS,
        bind_mesh,
        copy_to_axis,
        gather_from_axis,
        make_mesh_grid,
    )

    grid = make_mesh_grid(WORLD // TP, TP, axis_names=(WORKER_AXIS, TP_AXIS))
    x, w, cot = function_inputs()
    m = rank % TP
    rows = slice(m * w.shape[0] // TP, (m + 1) * w.shape[0] // TP)
    out = {}
    with bind_mesh(grid):
        # the gather: its backward keeps this rank's block of the cotangent
        wb = w[rows].clone().requires_grad_(True)
        y = gather_from_axis(torch.nn.functional.linear(x, wb), TP_AXIS, -1)
        (g,) = torch.autograd.grad((y * cot).sum(), wb)
        out["gather/y"], out["gather/dw"] = y.detach().numpy(), g.numpy()
        # the copy: the identity forward, the psum of the partial dx backward
        xr = x.clone().requires_grad_(True)
        yb = torch.nn.functional.linear(copy_to_axis(xr, TP_AXIS), w[rows])
        (g,) = torch.autograd.grad((yb * cot[:, rows]).sum(), xr)
        out["copy/dx"] = g.numpy()
    return out


def function_inputs():
    rng = np.random.default_rng(4)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((3, 5), (6, 5), (3, 6)))


def _capture_cases():
    """Windows of the GSPMD engine as a card captures them: the engine built
    on a faked card over NCCL and over gloo, and one window on this rank's
    CPU block under the transfer guard, its collectives recorded; for
    ``tp_shards=2`` (a ``TransformerLM``, grid 2 x 2, 2 workers) and for
    ``fsdp=True`` alone (the MLP, grid 4 x 1, 4 workers)."""
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.parallel.mesh import TP_AXIS, WORKER_AXIS, make_mesh_grid
    from test_torch_ring import capture_refusals, host_reads, recording_collectives

    rng = np.random.default_rng(5)
    x = ((rng.integers(0, 23, size=(32, 1)) + np.arange(16)) % 23).astype(np.int32)
    lm = TransformerLM(**LM, generator=torch.Generator().manual_seed(1))
    mlp = port_mlp((32,))
    runs = {
        "tp": (TP, dict(tp_shards=TP), "token_crossentropy", 2,
               fixed(lm, {k: v.detach() for k, v in lm.named_parameters()}),
               x.reshape(2, 1, 2, 8, 16), ((x + 1) % 23).reshape(2, 1, 2, 8, 16)),
        "fsdp": (1, dict(fsdp=True), "categorical_crossentropy", 4,
                 fixed(mlp, {k: v.detach() for k, v in mlp.named_parameters()}),
                 *epoch_arrays(*data()[::2], 4, 1, 2, 8)),
    }
    out = {}
    for name, (tp, kwargs, loss, workers, adapter, xs, ys) in runs.items():
        grid = make_mesh_grid(WORLD // tp, tp, axis_names=(WORKER_AXIS, TP_AXIS))

        def build(device):
            from distkeras_tpu_torch.parallel import GSPMDEngine

            return GSPMDEngine(adapter, loss, SGD, algorithms.Downpour(2), num_workers=workers,
                               metrics=(), mesh=grid, unroll=True, device=device, **kwargs)

        out[f"{name}/card"] = capture_refusals(lambda: build("cuda"))
        engine = build("cpu")
        state = engine.init_state(torch.Generator().manual_seed(0), None)
        sx, sy = engine.shard_batches(xs, ys)
        with recording_collectives() as log, host_reads() as reads:
            engine._window_body(state, sx[:, 0], sy[:, 0], True)
        out[f"{name}/collectives"], out[f"{name}/host_reads"] = log, reads
    return out


def _rank_main(rank: int, world: int, init: str, workdir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init,
                            world_size=world, rank=rank)
    try:
        results = {**_mlp_cases(workdir), "cls": _classifier_case(workdir),
                   "layout": _layout_case(workdir), "lm": _dropout_lm_case(),
                   "stale": _staleness_case(), "trainer": _trainer_case(),
                   "variants": _trainer_variants_case(),
                   "ckpt": _checkpoint_case(workdir, rank), "bad": _bad_case(),
                   "fn": _function_cases(rank)}
        capture = _capture_cases()
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

def jax_mlp_engine(features, workers, **kwargs):
    import jax

    from distkeras_tpu.algorithms import Downpour
    from distkeras_tpu.models import MLP, FlaxModel
    from distkeras_tpu.parallel import GSPMDEngine

    return GSPMDEngine(FlaxModel(MLP(features=features, num_classes=4)),
                       "categorical_crossentropy", SGD, Downpour(4), num_workers=workers,
                       metrics=(), devices=jax.devices()[:WORLD], **kwargs)


def jax_cls_engine(**kwargs):
    import jax

    from distkeras_tpu.algorithms import Adag
    from distkeras_tpu.models import FlaxModel, TransformerClassifier
    from distkeras_tpu.parallel import GSPMDEngine

    return GSPMDEngine(FlaxModel(TransformerClassifier(**CLS)), "categorical_crossentropy",
                       ("adam", {"learning_rate": 1e-3}), Adag(4), num_workers=2, metrics=(),
                       devices=jax.devices()[:WORLD], **kwargs)


def to_port(model, tree):
    """A JAX parameter tree under the port's names (numpy)."""
    from distkeras_tpu_torch.models import TransformerClassifier, params_from_flax
    from distkeras_tpu_torch.models.convert import variables_from_flax

    tree = {k: v for k, v in tree.items()}
    if model == "cls":
        got = params_from_flax(TransformerClassifier(**CLS), tree)
    else:
        got = variables_from_flax(port_mlp(model), {"params": tree})[0]
    return {k: v.numpy() for k, v in got.items()}


def jax_run(engine, xs, ys, epochs, model):
    import jax

    state = engine.init_state(jax.random.PRNGKey(0), xs.reshape(-1, *xs.shape[4:])[:8])
    sx, sy = engine.shard_batches(xs, ys)
    for _ in range(epochs):
        state, stats = engine.run_epoch(state, sx, sy)
    center = jax.tree.map(np.asarray, engine.gather_center(state))
    return to_port(model, center), np.asarray(stats["loss"])


def jax_init(engine, x0, model):
    import jax

    state = engine.init_state(jax.random.PRNGKey(0), x0)
    return state, to_port(model, jax.tree.map(np.asarray, engine.gather_center(state)))


def read_ranks(workdir):
    out = []
    for r in range(WORLD):
        results = {}
        with np.load(os.path.join(workdir, f"rank_{r}.npz")) as data_:
            for key in data_.files:
                case, _, name = key.partition("|")
                results.setdefault(case, {})[name] = data_[key]
        out.append(results)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(results of every rank, workdir)``: the JAX initial parameters are
    written for the ranks, then the four ranks run every case."""
    from test_torch_ring import spawn_ranks

    workdir = str(tmp_path_factory.mktemp("tp"))
    x, _, _ = data(n=512)
    for name, (features, workers, _, _) in MLP_CASES.items():
        _, init = jax_init(jax_mlp_engine(features, workers, tp_shards=TP), x[:8], features)
        np.savez(os.path.join(workdir, f"init_{name}.npz"), **init)
    _, init = jax_init(jax_cls_engine(tp_shards=TP), toy_text()[0][:8], "cls")
    np.savez(os.path.join(workdir, "init_cls.npz"), **init)
    spawn_ranks(__file__, WORLD, workdir)
    return read_ranks(workdir), workdir


def assert_center(got, want, **tol):
    names = [k for k in got if k.startswith("center/")]
    assert sorted(n[len("center/"):] for n in names) == sorted(want)
    for name in names:
        np.testing.assert_allclose(got[name], want[name[len("center/"):]], err_msg=name, **tol)


@pytest.mark.parametrize("case", list(MLP_CASES), ids=["tp_matches_jax", "virtual_workers"])
def test_mlp_trajectory_matches_jax_gspmd(ranks, case):
    """4 workers x 2 model shards (and 8 workers, 4 a workers rank) computes
    the JAX GSPMD engine's run: TP is a layout, not an algorithm."""
    features, workers, windows, epochs = MLP_CASES[case]
    x, _, onehot = data(n=512)
    xs, ys = epoch_arrays(x, onehot, workers, windows, 4, 8)
    center, loss = jax_run(jax_mlp_engine(features, workers, tp_shards=TP), xs, ys, epochs,
                           features)
    got = ranks[0][0][case]
    assert int(got["virtual"]) == workers // (WORLD // TP)
    np.testing.assert_allclose(got["loss"], loss, **TOL)
    assert_center(got, center, **TOL)


def test_transformer_classifier_under_adag_matches_jax(ranks):
    """The unmodified classifier trains under ADAG with Adam on the 2 x 2
    grid as on JAX's: its attention runs whole heads on every model rank."""
    x, y = toy_text()
    center, loss = jax_run(jax_cls_engine(tp_shards=TP), x.reshape(2, 2, 4, 8, 16),
                           y.reshape(2, 2, 4, 8), 1, "cls")
    got = dict(ranks[0][0]["cls"])
    assert np.isfinite(got["loss"]).all()
    np.testing.assert_allclose(got["loss"], loss, **CLS_TOL)
    # the key bias moves on round-off alone (module docstring): within Adam's
    # bound of its initial value, in both packages; every other element 1e-4
    name, keys = "blocks.0.attn.qkv.bias", slice(CLS["dim"], 2 * CLS["dim"])
    init = np.load(os.path.join(ranks[1], "init_cls.npz"))[name][keys]
    steps = 2 * 4  # windows x window: each worker's local steps
    for bias in (got[f"center/{name}"][keys], center[name][keys]):
        assert np.abs(bias - init).max() <= 1e-3 * steps
    got[f"center/{name}"] = np.delete(got[f"center/{name}"], np.r_[keys])
    center = {**center, name: np.delete(center[name], np.r_[keys])}
    assert_center(got, center, **CLS_TOL)


def _jax_leaf_shards(state, model):
    """Per port name: ``(is the center leaf on the model axis, elements of
    one device's shard)`` of a JAX engine's state."""
    import jax

    from distkeras_tpu.parallel import TP_AXIS

    leaves, treedef = jax.tree_util.tree_flatten(state.center_params)
    # each leaf filled with its own index, through the port's layout
    marks = to_port(model, jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)]))
    out = {}
    for name, mark in marks.items():
        leaf = leaves[int(mark.flat[0])]
        out[name] = (TP_AXIS in jax.tree.leaves(tuple(leaf.sharding.spec)),
                     int(leaf.addressable_shards[0].data.size))
    return out


@pytest.mark.parametrize("model", ["mlp", "cls"])
def test_sharded_leaves_and_their_sizes_are_jax(ranks, model):
    """The same leaves sit on the model axis as in JAX, and each rank
    stores as many elements of each as a JAX device's shard holds; the
    workers' parameters carry the same blocks."""
    results, _ = ranks
    if model == "mlp":
        state, _ = jax_init(jax_mlp_engine((32, 16), 2, tp_shards=TP), data()[0][:8], (32, 16))
    else:
        state, _ = jax_init(jax_cls_engine(tp_shards=TP), toy_text()[0][:8], "cls")
    want = _jax_leaf_shards(state, model if model == "cls" else (32, 16))
    assert any(on for on, _ in want.values())
    for rank, got in enumerate(results):
        layout = got["layout"]
        for name, (on_model, size) in want.items():
            shape = layout[f"{model}/center/{name}"]
            assert (int(layout[f"{model}/dim/{name}"]) >= 0) == on_model, (rank, name)
            assert int(np.prod(shape)) == size, (rank, name, shape)
            np.testing.assert_array_equal(layout[f"{model}/local/{name}"][1:], shape)


def test_placement_functions_match_jax_bitwise():
    """``default_tp_dim``, the TP spec (with and without ``spec_fn``) and
    the fsdp center spec on a table of shapes, against the JAX engine's own
    functions called on the same engine settings."""
    from distkeras_tpu.parallel import gspmd as jax_gspmd
    from distkeras_tpu_torch.parallel import gspmd

    shapes = [(), (7,), (8,), (4, 4), (4, 2), (3, 8), (8, 3), (16, 32), (2, 3, 4),
              (3, 3, 16, 32), (5, 6, 7), (1024, 768), (50257, 768), (768, 50257), (12, 64)]
    spec_fn = lambda shape, name: ("model",) + (None,) * (len(shape) - 1) if (
        len(shape) == 2 and shape[0] % 4 == 0) else None
    for tp in (1, 2, 3, 4):
        for shape in shapes:
            assert gspmd.default_tp_dim(shape, tp) == jax_gspmd.default_tp_dim(shape, tp)
    for tp, n_dev, fsdp, fn in [(2, 2, False, None), (2, 2, True, None), (1, 4, True, None),
                                (4, 2, True, None), (2, 4, True, spec_fn), (4, 1, True, spec_fn)]:
        mine = gspmd.GSPMDEngine.__new__(gspmd.GSPMDEngine)
        theirs = jax_gspmd.GSPMDEngine.__new__(jax_gspmd.GSPMDEngine)
        for eng in (mine, theirs):
            eng.tp_shards, eng.n_dev, eng.fsdp, eng.spec_fn = tp, n_dev, fsdp, fn
        mine._views = {}
        for shape in shapes:
            assert mine._tp_spec(shape) == tuple(theirs._tp_spec(shape)), (tp, shape)
            want = tuple(theirs._center_spec(shape))
            got = mine._center_spec(shape)
            assert got == want + (None,) * (len(got) - len(want)), (tp, n_dev, fsdp, shape)


def test_dropout_lm_at_two_model_ranks_is_the_one_rank_run(ranks):
    """``TransformerLM`` with dropout 0.1: every model rank of a worker
    draws that worker's masks from its one generator, so ``tp_shards=2``
    is the one-rank run within round-off (other masks would move the loss
    by far more), with the generators left in the same states."""
    got = ranks[0][0]["lm"]
    # rank 0 is the first workers row: worker 0 of the two
    np.testing.assert_array_equal(got["tp2/rng"], got["tp1/rng"][:1])
    np.testing.assert_allclose(got["tp2/loss"], got["tp1/loss"], **TOL)
    names = [k[len("tp1/"):] for k in got if k.startswith("tp1/center/")]
    assert names
    for name in names:
        np.testing.assert_allclose(got[f"tp2/{name}"], got[f"tp1/{name}"], err_msg=name, **TOL)


def test_remat_under_tp_is_bitwise_the_plain_run(ranks):
    """``remat=True`` at 2 model ranks: the recomputed forward runs
    column-parallel again, with the forward's dropout masks, so the run is
    the plain TP run bit for bit."""
    got = ranks[0][0]["lm"]
    names = [k[len("tp2/"):] for k in got if k.startswith("tp2/")]
    assert len(names) > 2
    for name in names:
        np.testing.assert_array_equal(got[f"tp2_remat/{name}"], got[f"tp2/{name}"], err_msg=name)


def test_staleness_schedule_matches_the_ports_windowed_engine(ranks):
    """``commit_schedule`` under TP reproduces the port's stepwise
    data-parallel run (DynSGD, periods 2-5)."""
    got = ranks[0][0]["stale"]
    np.testing.assert_allclose(got["tp/loss"], got["ref/loss"], **TOL)
    for name in [k for k in got if k.startswith("ref/center/")]:
        np.testing.assert_allclose(got["tp/" + name[4:]], got[name], err_msg=name, **TOL)


def test_trainer_level_tp_converges(ranks):
    got = ranks[0][0]["trainer"]
    _, y, onehot = toy_classification()
    h = got["loss"]
    assert h[-1] < h[0] * 0.6
    assert np.mean(np.argmax(got["predict"], -1) == y) > 0.8


def test_reshuffle_averaging_and_ensemble_under_tp(ranks):
    """The other trainer paths at 2 model ranks hold the data-parallel run
    over the same ranks: ``dispatch_epochs=2`` (the reshuffle broadcast over
    both axes), the final weight average, and every ensemble member made
    whole from its worker's blocks."""
    got = ranks[0][0]["variants"]
    names = [k[len("tp1/"):] for k in got if k.startswith("tp1/")]
    assert {n.split("/")[0] for n in names} == {"dispatch", "averaging", "ensemble"}
    assert sum(n.startswith("ensemble/3/") for n in names) == 4
    for name in names:
        np.testing.assert_allclose(got[f"tp{TP}/{name}"], got[f"tp1/{name}"], err_msg=name, **TOL)


def test_checkpoint_resume_under_tp(ranks):
    """4 epochs straight == 2 epochs + resume 2, on every rank: the
    payload holds whole leaves, and the resume restores them into blocks."""
    for got in ranks[0]:
        ckpt = got["ckpt"]
        names = [k[len("straight/"):] for k in ckpt if k.startswith("straight/")]
        assert names
        for name in names:
            np.testing.assert_allclose(ckpt[f"resumed/{name}"], ckpt[f"straight/{name}"],
                                       err_msg=name, **CKPT_TOL)


def test_checkpoint_written_under_tp_restores_at_one_rank(ranks):
    """The files are the one-rank engine's: whole leaves."""
    from distkeras_tpu_torch.checkpoint import restore_checkpoint

    results, workdir = ranks
    state = restore_checkpoint(os.path.join(workdir, "ckpt"), 4)
    for name, value in state["center_params"].items():
        np.testing.assert_array_equal(value.numpy(), results[0]["ckpt"][f"resumed/{name}"])
        assert state["local_params"][name].shape[1:] == value.shape


def test_tp_rejects_bad_combos(ranks):
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TransformerLM

    # tp_shards must divide the rank count (4 gloo ranks here)
    msg = str(ranks[0][0]["bad"]["tp3"])
    assert "tp_shards=3" in msg and "torchrun" in msg
    with pytest.raises(ValueError, match="drop tp_shards"):
        tdk.DOWNPOUR(port_mlp((32,)), num_workers=4, tp_shards=2, seq_shards=2, device="cpu")
    with pytest.raises(ValueError, match="tp_spec_fn"):
        tdk.DOWNPOUR(TransformerLM(**LM), tp_spec_fn=lambda shape, name: None, device="cpu")


def test_gather_from_axis_keeps_its_block_of_the_gradient(ranks):
    """The gather of a column-parallel product's outputs: forward the whole
    product, backward this rank's block of the whole (replicated)
    cotangent, so each rank's weight block gets the unsharded gradient's
    rows (a reduce-scatter would give ``tp_shards`` times them)."""
    x, w, cot = function_inputs()
    w = w.clone().requires_grad_(True)
    y = torch.nn.functional.linear(x, w)
    (dw,) = torch.autograd.grad((y * cot).sum(), w)
    for rank, got in enumerate(ranks[0]):
        m = rank % TP
        rows = slice(m * w.shape[0] // TP, (m + 1) * w.shape[0] // TP)
        np.testing.assert_allclose(got["fn"]["gather/y"], y.detach().numpy(), **FN_TOL)
        np.testing.assert_allclose(got["fn"]["gather/dw"], dw[rows].numpy(), **FN_TOL)


def test_copy_to_axis_psums_the_partial_input_gradient(ranks):
    """The replicated input of a column-parallel product: each rank's
    ``dx`` is a partial sum over its output channels, the psum makes it
    the unsharded product's."""
    x, w, cot = function_inputs()
    x = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad((torch.nn.functional.linear(x, w) * cot).sum(), x)
    for got in ranks[0]:
        np.testing.assert_allclose(got["fn"]["copy/dx"], dx.numpy(), **FN_TOL)


def _capture_ranks(workdir):
    out = []
    for rank in range(WORLD):
        with open(os.path.join(workdir, f"capture_{rank}.json"), encoding="utf-8") as fh:
            out.append(json.load(fh))
    return out


@pytest.mark.parametrize("run", ["tp", "fsdp"])
def test_gspmd_in_a_captured_window_takes_nccl_and_refuses_gloo(ranks, run):
    """``tp_shards=2``, and ``fsdp=True`` alone, with ``unroll=True`` on a
    card: the window is captured over NCCL; gloo is refused by name."""
    for got in _capture_ranks(ranks[1]):
        card = got[f"{run}/card"]
        assert card["nccl"] == "captures", card
        assert card["gloo"].startswith("ValueError") and "NCCL" in card["gloo"], card


@pytest.mark.parametrize("run", ["tp", "fsdp"])
def test_a_gspmd_window_reads_nothing_on_the_host_and_every_rank_pairs(ranks, run):
    """The window a card captures: no host read on any rank, and the same
    collectives in the same order on all four (TP: the column-parallel
    gathers and input-gradient psums over ``model`` and the commit over
    ``workers``; fsdp: the center's gathers and the commit)."""
    got = _capture_ranks(ranks[1])
    logs = [g[f"{run}/collectives"] for g in got]
    assert logs[0] and all(log == logs[0] for log in logs)
    calls = {c[0] for c in logs[0]}
    assert {"all_gather", "all_reduce"} <= calls, calls
    assert all(g[f"{run}/host_reads"] == [] for g in got)


@pytest.mark.cuda
def test_tp_or_fsdp_inside_a_captured_window_names_item_20():
    # Named for the refusal it replaced (ROADMAP Queue A item 20): the GSPMD
    # engine's fsdp center now takes unroll=True on a card.  Over a one-rank
    # NCCL group each window is captured, the commit's all-reduce inside
    # the graph, bit for bit the eager windows on the same group.
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU unroll is the inert scan hint")
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.parallel import GSPMDEngine
    from test_torch_mesh import _one_rank_group

    x, _, onehot = data(n=512)
    xs, ys = epoch_arrays(x, onehot, 2, 2, 4, 8)
    mlp = port_mlp((32,))
    init = {k: v.detach() for k, v in mlp.named_parameters()}
    out, engines = {}, {}
    _one_rank_group("nccl")
    try:
        for name, unroll in (("eager", 1), ("graph", True)):
            engine = GSPMDEngine(fixed(mlp, init), "categorical_crossentropy", SGD,
                                 algorithms.Downpour(4), num_workers=2, fsdp=True, metrics=(),
                                 unroll=unroll, device="cuda")
            state = engine.init_state(torch.Generator().manual_seed(0), None)
            sx, sy = engine.shard_batches(xs, ys)
            for _ in range(2):
                state, stats = engine.run_epoch(state, sx, sy)
            out[name] = {k: v.cpu() for k, v in engine.gather_center(state).items()}
            out[name]["loss"] = torch.from_numpy(np.asarray(stats["loss"]))
            engines[name] = engine
    finally:
        dist.destroy_process_group()
    graph = engines["graph"]
    assert graph.use_graphs and not engines["eager"].use_graphs
    assert graph.graph_stats == {"captures": 1, "replays": 4}
    ticks, runs = graph.graph_launches()["all_reduce"]
    assert ticks >= 1 and runs == 4 * ticks
    for key, want in out["eager"].items():
        assert torch.equal(out["graph"][key], want), key


# ------------------------------------------------------------------- Keras

_KERAS_SIDE = textwrap.dedent('''
    import os, sys
    backend = sys.argv[1]
    os.environ["KERAS_BACKEND"] = backend
    import numpy as np
    if backend == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 2)
        import distkeras_tpu as dk
        out, device, rank = sys.argv[2], {}, 0
    else:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        import distkeras_tpu_torch as dk
        rank, world, init, workdir = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
        dist.init_process_group("gloo", init_method=init,
                                world_size=world, rank=rank)
        out, device = os.path.join(workdir, "torch.npz"), {"device": "cpu"}
    import keras
    from keras import layers

    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 8)).astype(np.float32)
    y = (x @ rng.normal(size=(8,)) > 0).astype(np.int32)
    weights = [rng.uniform(-0.5, 0.5, s).astype(np.float32)
               for s in ((8, 16), (16,), (16, 2), (2,))]
    model = keras.Sequential([keras.Input((8,)), layers.Dense(16, activation="relu"),
                              layers.Dense(2, activation="softmax")])
    model.set_weights(weights)
    t = dk.DOWNPOUR(model, loss="categorical_crossentropy",
                    worker_optimizer=("sgd", {"learning_rate": 0.1}), num_workers=4,
                    batch_size=16, num_epoch=4, communication_window=4, tp_shards=2, **device)
    trained = t.train(dk.from_numpy(x, np.eye(2, dtype=np.float32)[y]))
    assert isinstance(trained, keras.Model), type(trained)
    preds = np.argmax(trained.predict(x, verbose=0), -1)
    res = {"accuracy": np.mean(preds == y), "loss": np.asarray(t.get_history()["loss"])}
    for i, w in enumerate(trained.get_weights()):
        res[f"w{i}"] = np.asarray(w)
    if backend == "torch":
        dist.destroy_process_group()
    if rank == 0:
        np.savez(out, **res)
''')


@pytest.fixture(scope="module")
def keras_sides(tmp_path_factory):
    """The JAX side (Keras on JAX, two CPU devices) in a subprocess, and
    the port's (Keras on torch, two gloo ranks) beside it."""
    pytest.importorskip("keras")
    from test_torch_ring import spawn_ranks

    workdir = str(tmp_path_factory.mktemp("tp_keras"))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    jax_side = subprocess.Popen([sys.executable, "-c", _KERAS_SIDE, "jax",
                                 os.path.join(workdir, "jax.npz")], cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        spawn_ranks(["-c", _KERAS_SIDE, "torch"], 2, workdir)
        log = jax_side.communicate(timeout=300)[0]
    finally:
        if jax_side.poll() is None:
            jax_side.kill()
            jax_side.wait()
    assert jax_side.returncode == 0, log[-4000:]
    sides = {}
    for backend in ("jax", "torch"):
        with np.load(os.path.join(workdir, f"{backend}.npz")) as got:
            sides[backend] = {k: got[k] for k in got.files}
    return sides


def test_keras_model_at_two_model_ranks_trains_as_jax(keras_sides):
    """A Keras 3 model (torch backend) trains with ``tp_shards=2`` on two
    gloo ranks, returns a Keras model, and holds JAX's run (Keras on JAX,
    ``tp_shards=2`` on two devices)."""
    mine, theirs = keras_sides["torch"], keras_sides["jax"]
    assert float(mine["accuracy"]) > 0.75
    np.testing.assert_allclose(mine["loss"], theirs["loss"], rtol=1e-5, atol=1e-5)
    for i in range(4):
        np.testing.assert_allclose(mine[f"w{i}"], theirs[f"w{i}"], rtol=1e-5, atol=1e-5)
