"""The port's runtime sanitizer (DISTKERAS_SANITIZE), against
tests/test_sanitizer.py: mode resolution and the cached-bool convention
(the same answers as the JAX package's on every spelling), one seeded
violation per guard — a host read of a tensor inside the guard trips the
transfer guard's interposition layer, a read of a consumed ``TrainState``
trips the donation poison, off-lock mutation and inversion trip the lock
watchdog, the Punchcard daemon's job table included — and the engine and
trainer integration: a clean epoch passes
strict with the trajectory bit for bit the sanitizer-off one, a planted
``.item()`` in the model's apply raises naming the span, record mode counts
and warns, and off means untouched (a subprocess: no ``torch.Tensor``
method patched, no ledger, the same trajectory and kernel launches).  The
CPU layer of the transfer guard is per thread; the gloo pair runs strict
with its collectives, whose host staging on a card is a declared transfer.
The card layer (torch's sync debug mode) is ``tests/test_torch_sanitizer_cuda.py``.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as tdk
from distkeras_tpu_torch import sanitizer, telemetry
from distkeras_tpu_torch.algorithms import Downpour
from distkeras_tpu_torch.data import epoch_arrays
from distkeras_tpu_torch.models import MLP, TorchModel
from distkeras_tpu_torch.parallel import WindowedEngine
from distkeras_tpu_torch.sanitizer import donation, lockwatch, runtime, transfer
from distkeras_tpu_torch.sanitizer.lockwatch import LockOrderViolation
from distkeras_tpu_torch.sanitizer.runtime import SanitizerViolation
from distkeras_tpu_torch.sanitizer.transfer import TransferViolation

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def reset_sanitizer(tmp_path, monkeypatch):
    """Sanitizer mode is process-cached (engines read it at build); leave
    every test with env-driven defaults and empty watchdog state."""
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path))
    yield
    sanitizer.configure(None)
    lockwatch.reset()
    donation.reset_stats()
    transfer.reset_stats()
    telemetry.configure(None)
    telemetry.trace.reset()
    telemetry.metrics.reset()


def _toy(n=128, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,))
    y = (x @ w > 0).astype(np.int32)
    onehot = np.zeros((n, 2), np.float32)
    onehot[np.arange(n), y] = 1.0
    return x, onehot


def _mlp():
    return MLP(features=(16,), num_classes=2, in_features=8)


#: a module-level constant the leaky model reads on the host every step
SCALE = torch.tensor(1.0)


class _LeakyModel(TorchModel):
    """The MLP with a deliberate host read in its apply — the seeded
    violation DK101 flags statically and the transfer guard must catch."""

    def apply(self, params, state, inputs, training=False, generator=None):
        out, state = super().apply(params, state, inputs, training, generator)
        return out * SCALE.item(), state


def _engine(adapter=None):
    return WindowedEngine(adapter or TorchModel(_mlp()), "categorical_crossentropy",
                          ("sgd", {"learning_rate": 0.1}), Downpour(2), 2, device="cpu")


def _epoch_data(eng, x, onehot, batch=16, window=2):
    state = eng.init_state(torch.Generator().manual_seed(0), x[:batch])
    xs, ys = eng.shard_batches(*epoch_arrays(x, onehot, eng.num_workers, batch, window))
    return state, xs, ys


def _trainer(model, **kw):
    return tdk.DOWNPOUR(model, loss="categorical_crossentropy",
                        worker_optimizer=("sgd", {"learning_rate": 0.1}), num_workers=2,
                        batch_size=16, num_epoch=kw.pop("num_epoch", 1),
                        communication_window=2, seed=7, device="cpu", **kw)


# ------------------------------------------------------------ mode switch

ENV_MODES = [("", "off"), ("0", "off"), ("false", "off"), ("no", "off"), ("1", "record"),
             ("true", "record"), ("record", "record"), ("strict", "strict")]


def test_mode_resolution_from_env(monkeypatch):
    from distkeras_tpu import sanitizer as jax_sanitizer

    try:
        for raw, expect in ENV_MODES:
            sanitizer.configure(None)
            jax_sanitizer.configure(None)
            monkeypatch.setenv("DISTKERAS_SANITIZE", raw)
            assert sanitizer.mode() == jax_sanitizer.mode() == expect, raw
    finally:
        jax_sanitizer.configure(None)
    sanitizer.configure(None)
    monkeypatch.delenv("DISTKERAS_SANITIZE", raising=False)
    assert (sanitizer.mode(), sanitizer.enabled(), sanitizer.strict()) == (
        "off", False, False)


def test_mode_is_cached_until_reconfigured(monkeypatch):
    sanitizer.configure(None)
    monkeypatch.delenv("DISTKERAS_SANITIZE", raising=False)
    assert sanitizer.mode() == "off"
    monkeypatch.setenv("DISTKERAS_SANITIZE", "strict")
    assert sanitizer.mode() == "off"  # cached
    sanitizer.configure(None)  # explicit reset re-reads
    assert sanitizer.mode() == "strict"


def test_configure_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode must be one of"):
        sanitizer.configure("paranoid")


def test_record_log_is_capped_as_jax():
    from distkeras_tpu.sanitizer import runtime as jax_runtime

    assert runtime._VIOLATIONS_CAP == jax_runtime._VIOLATIONS_CAP == 200
    sanitizer.configure("record")
    with pytest.warns(RuntimeWarning, match="sanitizer \\[unit\\]"):
        for i in range(250):
            runtime.report("unit", f"violation {i}")
    assert len(runtime.violations("unit")) == 200
    assert telemetry.metrics.snapshot()["sanitizer_unit_violations"]["value"] == 250


# ----------------------------------------------------- transfer guard unit

def test_transfer_guard_strict_raises_and_names_label():
    sanitizer.configure("strict")
    const = torch.tensor(2.0)
    x = torch.ones(3)  # created outside the guard, like shard_batches' output
    with pytest.raises(TransferViolation, match="guard 'unit_label'"):
        with transfer.guard("unit_label"):
            x * const.item()


@pytest.mark.parametrize("read", ["item", "tolist", "numpy", "float", "int", "index",
                                  "asarray"])
def test_every_host_read_is_interposed(read):
    sanitizer.configure("strict")
    t = torch.tensor(3)
    calls = {"item": lambda: t.item(), "tolist": lambda: t.tolist(),
             "numpy": lambda: t.numpy(), "float": lambda: float(t), "int": lambda: int(t),
             "index": lambda: [0, 1, 2, 3][t], "asarray": lambda: np.asarray(t)}
    with pytest.raises(TransferViolation, match="reads the tensor on the host"):
        with transfer.guard("reads"):
            calls[read]()
    assert int(np.asarray(calls[read]())) == 3  # outside the guard: legal


def test_transfer_guard_clean_program_passes_strict():
    sanitizer.configure("strict")
    x = torch.ones(8)
    with transfer.guard("clean"):
        out = torch.sum(x * 3.0) + torch.arange(x.shape[0]).sum()
    assert float(out) == pytest.approx(52.0)
    assert runtime.violations() == []


def test_transfer_guard_record_counts_and_continues():
    sanitizer.configure("record")
    telemetry.metrics.reset()
    const = torch.tensor(2.0)
    x = torch.ones(3)
    with pytest.warns(RuntimeWarning, match="sanitizer \\[transfer\\]"):
        with transfer.guard("rec"):
            out = x * const.item()
    np.testing.assert_allclose(out.numpy(), 2.0 * np.ones(3))
    snap = telemetry.metrics.snapshot()
    assert snap["sanitizer_transfer_violations"]["value"] >= 1
    kinds_msgs = runtime.violations("transfer")
    assert kinds_msgs and "Tensor.item() reads the tensor on the host" in kinds_msgs[0][1]


def test_transfers_free_outside_guard_and_when_off():
    sanitizer.configure("record")
    assert torch.tensor(2.0).item() == 2.0  # outside any guard: legal
    sanitizer.configure("off")
    with transfer.guard("noop"):
        assert torch.tensor(3.0).item() == 3.0  # guard is a no-op when off
    assert runtime.violations() == []


def test_guard_names_the_innermost_span():
    telemetry.configure(True)
    sanitizer.configure("strict")
    with pytest.raises(TransferViolation, match="span 'inner'"):
        with transfer.guard("outer_label"), telemetry.trace.span("outer"):
            with telemetry.trace.span("inner"):
                torch.tensor(1.0).item()


def test_guard_on_one_thread_does_not_report_another_threads_reads():
    """The interposition layer is per thread: a guard open on the training
    thread must not report a read the serving loop (or a prefetch
    producer) makes on its own thread at the same time."""
    sanitizer.configure("strict")
    opened, read = threading.Event(), threading.Event()
    seen = []

    def other():
        opened.wait(timeout=10)
        seen.append(torch.tensor(5.0).item())  # another thread, no guard of its own
        read.set()

    th = threading.Thread(target=other)
    th.start()
    with transfer.guard("main"):
        opened.set()
        assert read.wait(timeout=10)
    th.join(timeout=10)
    assert seen == [5.0] and runtime.violations() == []


def test_declared_transfers_pass_and_are_counted():
    sanitizer.configure("strict")
    with transfer.guard("g"):
        with transfer.allow("unit staging"):
            assert torch.tensor(1.0).item() == 1.0
        with pytest.raises(TransferViolation):
            torch.tensor(1.0).item()  # the declaration ended with its block
    assert transfer.stats()["declared"] == {"unit staging": 1}


def test_gloo_staging_is_the_only_declared_route():
    """The gloo collectives' host staging (a CUDA tensor over gloo) runs as
    a declared transfer; the direct and NCCL routes declare nothing."""
    from distkeras_tpu_torch.parallel import mesh

    sanitizer.configure("strict")
    with transfer.guard("collective"):
        with mesh._staging("host"):
            torch.tensor(1.0).item()
        for route in ("direct", "nccl"):
            with pytest.raises(TransferViolation):
                with mesh._staging(route):
                    torch.tensor(1.0).item()
    assert transfer.stats()["declared"] == {"gloo host staging": 1}


# ----------------------------------------------------- donation guard unit

def test_donation_poison_marks_the_consumed_state():
    sanitizer.configure("record")
    telemetry.metrics.reset()
    x, onehot = _toy()
    eng = _engine()
    state, _, _ = _epoch_data(eng, x, onehot)
    live = state.replace(epoch=1)  # what run_epoch returns: the same tensors
    n = len(donation._tensor_leaves(donation._fields_of(state)))
    before = [t.clone() for t in donation._tensor_leaves(donation._fields_of(live))]
    assert donation.poison(state, label="unit state") == n > 0
    assert donation.poisoned(state) and not donation.poisoned(live)
    with pytest.raises(SanitizerViolation, match="read of 'local_params' on a consumed"):
        state.local_params  # noqa: B018 — the read itself is the violation
    with pytest.raises(SanitizerViolation, match="unit state"):
        state.replace(epoch=2)
    # the tensors the live state shares are untouched
    after = donation._tensor_leaves(donation._fields_of(live))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert donation.poison(state) == 0  # poisoned before: already_deleted
    st = donation.stats()
    assert (st["poisoned"], st["already_deleted"], st["boundaries"]) == (n, n, 2)
    assert telemetry.metrics.snapshot()["sanitizer_donation_poisoned"]["value"] == n


def test_donation_poison_is_noop_when_off():
    sanitizer.configure("off")
    x, onehot = _toy()
    state, _, _ = _epoch_data(_engine(), x, onehot)
    assert donation.poison(state) == 0
    assert not donation.poisoned(state) and state.epoch == 0


def test_donation_poison_takes_a_dataclass_instance():
    sanitizer.configure("record")
    with pytest.raises(TypeError, match="dataclass instance"):
        donation.poison({"w": torch.ones(2)})


# --------------------------------------------------------- lockwatch unit

def test_lock_order_inversion_detected():
    sanitizer.configure("record")
    a = lockwatch.maybe_wrap(threading.Lock(), "A")
    b = lockwatch.maybe_wrap(threading.Lock(), "B")
    with a:
        with b:
            pass
    with pytest.warns(RuntimeWarning, match="inversion"):
        with b:
            with a:
                pass
    assert any("inversion" in m for _, m in runtime.violations("lock"))


def test_off_lock_notify_and_guarded_map():
    sanitizer.configure("record")
    cv = lockwatch.maybe_wrap(threading.Condition(), "cv")
    jobs = lockwatch.guard_map({}, cv, "jobs")
    with pytest.warns(RuntimeWarning, match="without holding"):
        with pytest.raises(RuntimeError):  # stock Condition still errors too
            cv.notify_all()
    jobs_before = len(runtime.violations("lock"))
    jobs["k"] = 1  # off-lock write: recorded, mutation still applied
    assert len(runtime.violations("lock")) == jobs_before + 1
    with cv:
        jobs["k2"] = 2  # under the lock: silent
    assert len(runtime.violations("lock")) == jobs_before + 1
    assert jobs == {"k": 1, "k2": 2}


def test_lockwatch_strict_raises():
    sanitizer.configure("strict")
    cv = lockwatch.maybe_wrap(threading.Condition(), "cv2")
    with pytest.raises(LockOrderViolation, match="without holding"):
        cv.notify_all()


def test_exclusive_flags_same_direction_concurrency():
    sanitizer.configure("record")
    sock = object()
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with lockwatch.exclusive(sock, "send"):
            entered.set()
            release.wait(timeout=5)

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert entered.wait(timeout=5)
        with pytest.warns(RuntimeWarning, match="concurrent send"):
            with lockwatch.exclusive(sock, "send"):
                pass
        # full duplex is legal: recv while the other thread sends
        before = len(runtime.violations("lock"))
        with lockwatch.exclusive(sock, "recv"):
            pass
        assert len(runtime.violations("lock")) == before
    finally:
        release.set()
        t.join(timeout=5)


def test_networking_frames_are_exclusive_per_socket():
    """``send_data``/``recv_data`` hold ``lockwatch.exclusive`` for one
    frame: a second sender on the same socket is reported."""
    import socket

    from distkeras_tpu_torch import networking

    sanitizer.configure("record")
    a, b = socket.socketpair()
    try:
        with lockwatch.exclusive(a, "send_data on one socket"):
            done = threading.Event()

            def send():
                networking.send_data(a, {"x": np.arange(3)})
                done.set()

            with pytest.warns(RuntimeWarning, match="concurrent send_data"):
                th = threading.Thread(target=send)
                th.start()
                th.join(timeout=10)
        assert done.is_set()
        got = networking.recv_data(b)
        np.testing.assert_array_equal(got["x"], np.arange(3))
        assert len(runtime.violations("lock")) == 1
    finally:
        a.close()
        b.close()


def test_disabled_path_returns_stock_objects():
    from distkeras_tpu_torch.job_deployment import PunchcardServer

    sanitizer.configure("off")
    cv = threading.Condition()
    assert lockwatch.maybe_wrap(cv, "x") is cv
    m = lockwatch.guard_map({"a": 1}, cv, "x")
    assert type(m) is dict and m == {"a": 1}
    srv = PunchcardServer(port=0)
    assert isinstance(srv._cv, threading.Condition)
    assert type(srv.jobs) is dict


def test_punchcard_jobs_mutation_off_lock_is_flagged():
    from distkeras_tpu_torch.job_deployment import PunchcardServer

    sanitizer.configure("record")
    srv = PunchcardServer(port=0)
    assert isinstance(srv._cv, lockwatch.GuardedLock)
    with pytest.warns(RuntimeWarning, match="off-lock write"):
        srv.jobs["job-1"] = {"status": "QUEUED"}
    with srv._cv:
        srv.jobs["job-2"] = {"status": "QUEUED"}  # the blessed path
    assert len(runtime.violations("lock")) == 1


@pytest.mark.parametrize("mode", ["off", "record"])
def test_serving_engine_condition_under_lockwatch(mode):
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.serving import ServingEngine
    from distkeras_tpu_torch.telemetry.metrics import Registry

    sanitizer.configure(mode)
    model = TransformerLM(vocab_size=23, dim=16, heads=2, num_layers=1, max_len=32)
    params = {k: v.detach() for k, v in model.named_parameters()}
    engine = ServingEngine(model, params, num_slots=2, page_size=8, registry=Registry(),
                           device="cpu")
    try:
        if mode == "off":
            assert isinstance(engine._cv, type(threading.Condition()))
        else:
            assert isinstance(engine._cv, lockwatch.GuardedLock)
        assert len(engine.generate([1, 2, 3], 4, timeout=60).tokens) == 4
    finally:
        engine.stop()
    assert runtime.violations() == []


# ------------------------------------------- engine integration + the pins

def test_engine_caches_flag_at_build():
    sanitizer.configure("off")
    eng = _engine()
    assert eng._sanitize is False
    sanitizer.configure("record")
    assert eng._sanitize is False  # snapshot taken at build, like _dynamics
    assert _engine()._sanitize is True


def _center(eng, state):
    return {k: v.clone() for k, v in eng.gather_center(state).items()}


def test_clean_epoch_passes_strict_and_poisons_the_consumed_state():
    x, onehot = _toy()
    sanitizer.configure("off")
    eng = _engine()
    state0, xs, ys = _epoch_data(eng, x, onehot)
    ref_state, ref = eng.run_epoch(state0, xs, ys)
    ref_center = _center(eng, ref_state)

    sanitizer.configure("strict")
    eng = _engine()
    state0, xs, ys = _epoch_data(eng, x, onehot)
    state1, stats = eng.run_epoch(state0, xs, ys)
    assert np.array_equal(stats["loss"], ref["loss"])  # bit for bit
    assert np.array_equal(stats["metrics"], ref["metrics"])
    assert all(torch.equal(a, b) for a, b in zip(_center(eng, state1).values(),
                                                  ref_center.values()))
    # the consumed input state is poisoned at the epoch boundary: a stale
    # read raises instead of silently seeing the updated tensors
    with pytest.raises(SanitizerViolation, match="consumed TrainState"):
        state0.center_params  # noqa: B018
    assert donation.stats()["boundaries"] == 1
    assert runtime.violations() == []
    # run_epochs and the streamed epoch poison their input state too
    state2, _ = eng.run_epochs(state1, xs, ys, 2)
    assert donation.poisoned(state1) and not donation.poisoned(state2)
    blocks = [(xs[:, w, :].numpy(), ys[:, w, :].numpy()) for w in range(xs.shape[1])]
    state3, _ = eng.run_epoch_streaming(state2, iter(blocks))
    assert donation.poisoned(state2) and not donation.poisoned(state3)
    assert donation.stats()["boundaries"] == 3
    assert runtime.violations() == []


def test_strict_staleness_epoch_is_clean():
    sanitizer.configure("strict")
    x, onehot = _toy()
    eng = WindowedEngine(TorchModel(_mlp()), "categorical_crossentropy",
                         ("sgd", {"learning_rate": 0.1}), Downpour(2), 2,
                         commit_schedule=np.array([1, 2]), device="cpu")
    state = eng.init_state(torch.Generator().manual_seed(0), x[:16])
    xs, ys = eng.shard_batches(*epoch_arrays(x, onehot, 2, 16, 2, stepwise=True))
    _, stats = eng.run_epoch(state, xs, ys)
    assert np.all(np.isfinite(stats["loss"])) and runtime.violations() == []


# ------------------------------------------------------- trainer seeded runs

def test_strict_trainer_raises_on_seeded_item_and_names_span():
    """The acceptance smoke: DISTKERAS_SANITIZE=strict turns a planted
    in-loop ``.item()`` in the model's apply into a raise that names the
    enclosing telemetry span."""
    telemetry.configure(True)  # spans on, so the violation is attributed
    sanitizer.configure("strict")
    x, onehot = _toy()
    with pytest.raises(TransferViolation, match="span 'step'") as exc:
        _trainer(_LeakyModel(_mlp())).train(tdk.from_numpy(x, onehot))
    assert "hot loop" in str(exc.value) and "Tensor.item()" in str(exc.value)


def test_record_trainer_counts_seeded_item_and_warns():
    sanitizer.configure("record")
    telemetry.metrics.reset()
    x, onehot = _toy()
    with pytest.warns(RuntimeWarning) as caught:
        _trainer(_LeakyModel(_mlp())).train(tdk.from_numpy(x, onehot))  # completes
    messages = [str(w.message) for w in caught]
    assert any(m.startswith("sanitizer [transfer]") for m in messages)
    # the fit closes with the tally
    assert any("sanitizer recorded" in m and "(transfer guard)" in m for m in messages)
    snap = telemetry.metrics.snapshot()
    assert snap["sanitizer_transfer_violations"]["value"] >= 1
    assert runtime.violations("transfer")


def test_clean_trainer_strict_is_bitwise_the_plain_one():
    x, onehot = _toy()
    sanitizer.configure("off")
    plain = _trainer(_mlp(), num_epoch=2)
    plain_model = plain.train(tdk.from_numpy(x, onehot))
    telemetry.configure(True)
    sanitizer.configure("strict")
    strict = _trainer(_mlp(), num_epoch=2)
    strict_model = strict.train(tdk.from_numpy(x, onehot))
    assert strict.get_history()["loss"] == plain.get_history()["loss"]
    for k, v in plain_model.params.items():
        assert torch.equal(strict_model.params[k], v), k
    assert runtime.violations() == [] and donation.stats()["boundaries"] == 2


# ----------------------------------------------- off means untouched (fresh)

OFF_ON = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
import distkeras_tpu_torch as tdk
from distkeras_tpu_torch import sanitizer, telemetry
from distkeras_tpu_torch.models import TransformerLM
from distkeras_tpu_torch.ops import flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv
from distkeras_tpu_torch.sanitizer import transfer
from distkeras_tpu_torch.serving import ServingEngine
from distkeras_tpu_torch.telemetry.metrics import Registry

ORIG = {n: getattr(torch.Tensor, n) for n in transfer._SYNC_METHODS}
CFG = dict(vocab_size=23, dim=16, heads=2, num_layers=2, max_len=16)
rng = np.random.default_rng(3)
start = rng.integers(0, 23, (32, 1))
x = (start + np.arange(16)) % 23
y = (x + 1) % 23

def fit():
    model = TransformerLM(**CFG)
    t = tdk.DOWNPOUR(model, loss="token_crossentropy", metrics=("token_accuracy",),
                     worker_optimizer=("adam", {"learning_rate": 1e-3}), num_workers=2,
                     batch_size=4, communication_window=2, num_epoch=1, seed=5, device="cpu")
    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    for c in counters:
        c.launches = 0
    trained = t.train(tdk.from_numpy(x, y))
    engine = ServingEngine(trained, num_slots=2, page_size=8, registry=Registry(), device="cpu")
    try:
        ledger = engine._ledger is not None
        tokens = engine.generate([1, 2, 3], 4, timeout=60).tokens
    finally:
        engine.stop()
    return {"loss": t.get_history()["loss"], "launches": [c.launches for c in counters],
            "params": {k: v.double().sum().item() for k, v in trained.params.items()},
            "ledger": ledger, "tokens": tokens}

telemetry.configure(True)
off = fit()
off["patched"] = transfer.installed() or any(
    getattr(torch.Tensor, n) is not f for n, f in ORIG.items())
sanitizer.configure("strict")
tdk.telemetry.accounting.configure(True)
on = fit()
on["patched"] = transfer.installed()
on["violations"] = sanitizer.violations()
print(json.dumps({"off": off, "on": on}))
"""


def test_off_means_untouched_and_the_same_trajectory_as_strict(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT),
           "DISTKERAS_ACCOUNTING": "0", "DISTKERAS_TELEMETRY_DIR": str(tmp_path)}
    env.pop("DISTKERAS_SANITIZE", None)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", OFF_ON], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    off, on = out["off"], out["on"]
    # off: nothing patched, no ledger
    assert off["patched"] is False and off["ledger"] is False
    # on: patched, billed, clean — and the same run bit for bit
    assert on["patched"] is True and on["ledger"] is True and on["violations"] == []
    assert on["loss"] == off["loss"] and on["params"] == off["params"]
    assert on["launches"] == off["launches"] and on["tokens"] == off["tokens"]


# ------------------------------------------------------------ the gloo pair

def _gloo_rank(rank: int, world: int, init: str, workdir: str) -> None:
    """One rank of the gloo pair: a strict DOWNPOUR over the group, its
    collectives inside the guard, then the result for rank 0's check."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    sanitizer.configure("strict")
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        x, onehot = _toy()
        t = _trainer(_mlp(), num_epoch=2)
        t.train(tdk.from_numpy(x, onehot))
        out = {"loss": t.get_history()["loss"], "violations": sanitizer.violations(),
               "declared": transfer.stats()["declared"],
               "boundaries": donation.stats()["boundaries"]}
        if rank == 0:
            with open(os.path.join(workdir, "gloo.json"), "w") as fh:
                json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def test_gloo_pair_runs_strict_with_its_collectives(tmp_path):
    """Two gloo ranks train under strict: the commit's all-reduce and the
    stats' run inside the guard, and CPU tensors take gloo's direct route,
    so nothing is staged or declared; the trajectory is one rank's."""
    from test_torch_ring import spawn_ranks

    spawn_ranks(__file__, 2, str(tmp_path), timeout=240)
    got = json.load(open(tmp_path / "gloo.json"))
    assert got["violations"] == [] and got["declared"] == {}
    assert got["boundaries"] == 2
    x, onehot = _toy()
    sanitizer.configure("off")
    one = _trainer(_mlp(), num_epoch=2)
    one.train(tdk.from_numpy(x, onehot))
    np.testing.assert_allclose(got["loss"], one.get_history()["loss"], rtol=1e-6)


if __name__ == "__main__":
    _gloo_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
