"""Elastic fleet membership in the port, against tests/test_fleet.py:
the lease table, the daemon's membership verbs, the worker's heartbeat
thread and rejoin, the trainer-side poller, the handler deadline, and the
live elastic resize.

Where the JAX tests sleep out a lease, these drive the membership table's
injectable clock.  The daemon-thread tests keep their leases generous.
The live resize (a scripted poller shrinking 4 -> 2 workers after the
second epoch, and growing 4 -> 8 after the first) is held to the JAX
package's on the same MLP, data and initial parameters (losses within the
trainer tolerance of tests/test_torch_trainers.py, parameters within its
parameter tolerance), and bit for bit to the port's own elastic-resume
path: a checkpoint at the boundary, resumed by a new trainer at the new
worker count.  tests/test_fleet.py's preemption, recovery and adaptive
staleness cases are mirrored in tests/test_torch_checkpoint.py and
tests/test_torch_dynamics.py.
"""

import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as tdk
from distkeras_tpu import fleet as jax_fleet
from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu.models import FlaxModel
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu_torch import fleet, telemetry
from distkeras_tpu_torch.job_deployment import Job, PunchcardServer
from distkeras_tpu_torch.models import TorchModel, variables_from_flax, zoo

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

LOSS_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_trainers.py's
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
MLP_KW = dict(features=(16,), num_classes=2)


@pytest.fixture(autouse=True)
def fresh_telemetry(tmp_path, monkeypatch):
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path))
    for t in (telemetry, jax_telemetry):
        t.configure(True)
        t.metrics.reset()
    yield
    for t in (telemetry, jax_telemetry):
        t.metrics.reset()
        t.trace.reset()
        t.configure(None)


# ------------------------------------------------------- membership table

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


BOTH = pytest.mark.parametrize("lib", [fleet, jax_fleet], ids=["port", "jax"])


@BOTH
def test_membership_register_heartbeat_deregister(lib):
    fm = lib.FleetMembership(lease=1.0, miss_tolerance=2, clock=_Clock())
    wid = fm.register(workers=4, host="10.0.0.1")
    assert fm.epoch == 1 and fm.workers_total() == 4
    # re-register only refreshes the lease; the epoch tracks set changes
    fm.register(worker_id=wid, workers=4)
    assert fm.epoch == 1
    assert fm.heartbeat(wid) is True and fm.heartbeat("ghost") is False
    assert fm.deregister(wid) is True
    assert fm.epoch == 2 and fm.workers_total() == 0
    assert fm.deregister(wid) is False and fm.epoch == 2


@BOTH
def test_membership_lease_eviction_bumps_epoch_once(lib):
    clk = _Clock()
    fm = lib.FleetMembership(lease=1.0, miss_tolerance=2, clock=clk)
    a, b = fm.register(workers=1), fm.register(workers=2)
    assert fm.epoch == 2
    clk.t = 1.9  # inside lease x tolerance
    assert fm.sweep() == []
    clk.t = 2.1
    assert sorted(fm.sweep()) == sorted([a, b])
    assert fm.epoch == 3  # one bump for the whole sweep
    assert fm.evictions == 2 and fm.workers_total() == 0


@BOTH
def test_membership_heartbeat_extends_lease(lib):
    clk = _Clock()
    fm = lib.FleetMembership(lease=1.0, miss_tolerance=1, clock=clk)
    wid = fm.register()
    clk.t = 0.9
    assert fm.heartbeat(wid)
    clk.t = 1.5  # past the original deadline, inside the refreshed one
    assert fm.sweep() == []
    clk.t = 2.0
    assert fm.sweep() == [wid]


@BOTH
def test_membership_snapshot_and_validation(lib):
    fm = lib.FleetMembership(lease=1.0)
    fm.register(worker_id="w1", workers=2, host="h1")
    fm.register(worker_id="w2", workers=1, meta={"role": "replica"})
    snap = fm.snapshot()
    assert snap["epoch"] == 2 and snap["workers_total"] == 3
    assert snap["members"]["w1"] == {"workers": 2, "host": "h1"}
    assert snap["members"]["w2"]["meta"] == {"role": "replica"}
    with pytest.raises(ValueError):
        lib.FleetMembership(lease=0)
    with pytest.raises(ValueError):
        lib.FleetMembership(miss_tolerance=0)


# ------------------------------------------------------- daemon verbs (live)

@pytest.fixture()
def daemon():
    server = PunchcardServer(port=0, secret="s3cret", lease=5.0, lease_misses=1)
    server.start()
    yield server
    server.stop()


def _worker(daemon, **kw):
    return fleet.FleetWorker("127.0.0.1", daemon.port, secret="s3cret", **kw)


def _poller(daemon, **kw):
    return fleet.ElasticMembership("127.0.0.1", daemon.port, secret="s3cret", **kw)


def test_daemon_register_and_membership_poll(daemon):
    w1 = _worker(daemon, workers=2)
    assert w1.register() == 1
    assert w1.lease == pytest.approx(5.0)
    assert w1.heartbeat() == 1  # no set change, the epoch holds
    poller = _poller(daemon, max_workers=4)
    assert poller.poll() is None  # baseline read, not a change
    w2 = _worker(daemon, workers=3)
    w2.register()
    assert poller.poll() == 4  # the join moved the epoch: 5, clamped to max_workers
    assert poller.poll() is None  # unchanged fleet
    w1.deregister()
    assert poller.poll() == 3


def test_daemon_lease_eviction_and_metrics(daemon):
    clk = _Clock()
    with daemon._cv:  # the daemon's table on an injected clock
        daemon.fleet._clock = clk
    w = _worker(daemon)
    w.register()
    poller = _poller(daemon)
    assert poller.poll() is None  # baseline at epoch 1
    clk.t = 4.9
    assert poller.poll() is None  # inside the lease
    clk.t = 5.1  # no heartbeat: the membership verb's sweep evicts
    assert poller.poll() == 1  # workers_total 0, clamped to min_workers
    with daemon._cv:
        assert daemon.fleet.evictions == 1 and w.worker_id not in daemon.fleet.members
    assert telemetry.metrics.counter("fleet_evictions_total").value == 1
    assert telemetry.metrics.gauge("fleet_membership_epoch").value == 2


def test_fleet_worker_heartbeat_thread_keeps_lease(daemon):
    clk = _Clock()
    with daemon._cv:
        daemon.fleet._clock = clk
        span = daemon.fleet.lease * daemon.fleet.miss_tolerance
    w = _worker(daemon, heartbeat_interval=0.02)
    w.start()
    try:
        for _ in range(4):  # two and a half leases of the daemon's clock
            with daemon._cv:
                clk.t += 0.6 * span
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:  # the thread's next beat lands
                with daemon._cv:
                    if daemon.fleet.members[w.worker_id]["deadline"] == clk.t + span:
                        break
                time.sleep(0.01)
            with daemon._cv:
                assert daemon.fleet.sweep() == []
                assert daemon.fleet.members[w.worker_id]["deadline"] == clk.t + span
        assert w.rejoins == 0
    finally:
        w.stop()
    with daemon._cv:
        assert w.worker_id not in daemon.fleet.members  # deregistered


def test_fleet_worker_rejoins_after_eviction(daemon):
    w = _worker(daemon)
    w.register()
    with daemon._cv:  # force-evict as the sweeper would
        del daemon.fleet.members[w.worker_id]
        daemon.fleet.epoch += 1
    epoch = w.heartbeat()  # sees "unknown", transparently re-registers
    assert w.rejoins == 1 and epoch == 3
    with daemon._cv:
        assert w.worker_id in daemon.fleet.members


def test_fleet_worker_membership_state_coherent_under_concurrency(daemon):
    """lease / membership_epoch / rejoins are written on the caller's thread
    (register) and the heartbeat threads (re-register after eviction) under
    one lock: a burst of heartbeats racing evictions never loses a rejoin
    or tears the triple."""
    w = _worker(daemon)
    w.register()
    stop = threading.Event()
    errs = []

    def hammer():
        while not stop.is_set():
            try:
                w.heartbeat()
            except Exception as e:  # noqa: BLE001 — any error fails the test
                errs.append(e)
                return

    threads = [threading.Thread(target=hammer, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(10):  # force evictions racing the heartbeats
            with daemon._cv:
                daemon.fleet.members.pop(w.worker_id, None)
                daemon.fleet.epoch += 1
            time.sleep(0.005)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert not errs, errs
    assert not any(t.is_alive() for t in threads)
    with w._state_lock:  # the triple is always observed whole
        assert isinstance(w.lease, float) and isinstance(w.membership_epoch, int)
        assert w.rejoins >= 1
    with daemon._cv:
        assert w.membership_epoch <= daemon.fleet.epoch


def test_elastic_membership_survives_daemon_outage():
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    poller = fleet.ElasticMembership("127.0.0.1", port, secret="")
    poller._job.rpc_retries = 0
    assert poller.poll() is None  # an unreachable daemon is not a resize


def test_wait_timeout_zero_reports_poll_count(daemon):
    job = Job("127.0.0.1", daemon.port, secret="s3cret", script="print('x')")
    job.submit()
    with pytest.raises(TimeoutError, match=r"unpolled"):
        job.wait(timeout=0)
    assert job.wait(timeout=30)["status"] == "finished"


def test_handler_timeout_frees_the_daemon_thread():
    server = PunchcardServer(port=0, secret="", handler_timeout=0.2)
    server.start()
    try:
        # a half-open client connects and sends nothing: the handler
        # deadline fires instead of wedging the thread forever
        sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
        counter = telemetry.metrics.counter("punchcard_handler_timeouts_total")
        deadline = time.monotonic() + 10
        while counter.value < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert counter.value >= 1
        sock.close()
        # the daemon still answers
        assert Job("127.0.0.1", server.port)._rpc({"action": "list"})["status"] == "ok"
    finally:
        server.stop()


# ------------------------------------------------------- live elastic resize

def _toy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 8)).astype(np.float32)
    y = (x @ rng.normal(size=(8,)) > 0).astype(np.int32)
    return x, np.eye(2, dtype=np.float32)[y]


class FixedInit(TorchModel):
    """Test-side adapter whose ``init`` returns given parameters."""

    def __init__(self, module, params):
        super().__init__(module)
        self.params = params

    def init(self, generator, sample_input):
        return {k: v.clone() for k, v in self.params.items()}, {}


class _ScriptedElastic:
    """Stands in for ElasticMembership: poll() pops a scripted answer."""

    def __init__(self, answers):
        self.answers = list(answers)
        self.polls = 0

    def poll(self):
        self.polls += 1
        return self.answers.pop(0) if self.answers else None


def _kwargs(**kw):
    return dict(loss="categorical_crossentropy",
                worker_optimizer=("sgd", {"learning_rate": 0.05}), batch_size=16,
                communication_window=4, seed=11, **kw)


def _port_params(x):
    variables = jax_zoo.MLP(**MLP_KW).init(jax.random.PRNGKey(11), x[:16])
    params, _ = variables_from_flax(zoo.MLP(**MLP_KW, in_features=8),
                                    jax.tree_util.tree_map(np.asarray, variables))
    return params


def _port_train(params, df, **kw):
    t = tdk.DOWNPOUR(FixedInit(zoo.MLP(**MLP_KW, in_features=8), params), device="cpu",
                     **_kwargs(**kw))
    return t, t.train(df)


@pytest.mark.parametrize("answers, epochs, boundary, after", [([None, 2], 4, 2, 2), ([8], 3, 1, 8)],
                         ids=["shrink_to_2", "grow_to_8"])
def test_elastic_resize_mid_run(answers, epochs, boundary, after, tmp_path):
    x, onehot = _toy()
    jt = jdk.DOWNPOUR(FlaxModel(jax_zoo.MLP(**MLP_KW)), **_kwargs(
        num_workers=4, num_epoch=epochs, elastic=_ScriptedElastic(answers)))
    jm = jt.train(jdk.from_numpy(x, onehot))
    params, df = _port_params(x), tdk.from_numpy(x, onehot)

    ctl = _ScriptedElastic(answers)
    pt, pm = _port_train(params, df, num_workers=4, num_epoch=epochs, elastic=ctl,
                         checkpoint_dir=str(tmp_path / "live"))
    assert ctl.polls == epochs - 1  # every boundary but the last
    assert telemetry.metrics.counter("elastic_resizes_total").value == 1
    assert telemetry.metrics.gauge("elastic_workers").value == after
    assert pt.num_updates == jt.num_updates
    np.testing.assert_allclose(pt.get_history()["loss"], jt.get_history()["loss"], **LOSS_TOL)
    want, _ = variables_from_flax(zoo.MLP(**MLP_KW, in_features=8), {
        "params": jax.tree_util.tree_map(np.asarray, jm.params)})
    for name, value in want.items():
        np.testing.assert_allclose(pm.params[name].numpy(), value.numpy(), **PARAM_TOL,
                                   err_msg=name)

    # the port's elastic-resume path: a checkpoint at the boundary, resumed
    # by a new trainer at the new worker count
    ckpt = str(tmp_path / "resume")
    _port_train(params, df, num_workers=4, num_epoch=boundary, checkpoint_dir=ckpt)
    rt, rm = _port_train(params, df, num_workers=after, num_epoch=epochs,
                         checkpoint_dir=ckpt, resume=True)
    assert rt.get_history()["loss"] == pt.get_history()["loss"][boundary:]
    for name, value in rm.params.items():
        assert torch.equal(pm.params[name], value), name


def test_elastic_disabled_off_the_per_epoch_loop():
    x, onehot = _toy()
    ctl = _ScriptedElastic([2])
    with pytest.warns(RuntimeWarning, match="elastic membership polling"):
        _port_train(_port_params(x), tdk.from_numpy(x, onehot), num_workers=4, num_epoch=3,
                    elastic=ctl, dispatch_epochs=3)
    assert ctl.polls == 0
