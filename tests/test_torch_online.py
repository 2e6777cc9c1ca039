"""The port's online loop (``online/``) against tests/test_online.py:
capture admission (deterministic sampling, content filter, per-tenant
window quotas and rates), atomic window publication readable back through
``MemmapSource``, the journal/sidecar crash resume (a capture killed
between shard rotation and manifest publish resumes bitwise), the
``WindowScheduler``'s window -> verified checkpoint pipeline with chaos
retries, capacity-aware placement, the daemon's ``online_loop`` /
``online_status`` / ``stop_online`` verbs with stub scripts (and C3 for
``online_loop``: a retry mid-request spawns once), the frontend capture
hook, and the ``online_*`` schema against the JAX package's golden text.

Across the two packages: the same (request, result) records through JAX's
``TrafficLog`` and the port's give byte-identical shards and equal
manifests, each package's ``verify_window`` accepts the other's directory,
``SamplingPolicy`` admits the same sequence numbers, and ``plan_placement``
places alike.  The port's checkpoints hold a ``TrainState``, so the
scheduler's stub ``train_fn`` returns one.  No device, no spawned ranks."""

import hashlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu import online as jax_online
from distkeras_tpu.serving import GenerateRequest as JaxRequest
from distkeras_tpu.serving import GenerateResult as JaxResult
from distkeras_tpu_torch import chaos, job_deployment, telemetry
from distkeras_tpu_torch.datapipe.source import atomic_write_npy
from distkeras_tpu_torch.datapipe.state import DataState
from distkeras_tpu_torch.job_deployment import Job, PunchcardServer
from distkeras_tpu_torch.online import (
    SamplingPolicy,
    TrafficLog,
    WindowScheduler,
    load_window_manifest,
    online_metrics,
    plan_placement,
    published_windows,
    verify_window,
    window_source,
)
from distkeras_tpu_torch.parallel.engine import TrainState
from distkeras_tpu_torch.serving import GenerateRequest, GenerateResult
from distkeras_tpu_torch.telemetry.metrics import Registry

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True)
def clean_online():
    chaos.configure("")  # chaos off, counters clear, for every test
    yield
    chaos.configure(None)
    telemetry.configure(None)


def _gen(i, tenant="", cls=(GenerateRequest, GenerateResult)):
    """One deterministic served generation (request, result) pair."""
    req_cls, res_cls = cls
    req = req_cls(prompt=[1 + i, 2, 3 + (i % 4)], tenant=tenant)
    res = res_cls(request_id=f"r{i}", prompt=req.prompt, tokens=[5, 6 + (i % 3)],
                  finish_reason="length")
    return req, res


def _capture_digest(directory):
    """sha256 of every published artifact (shards, manifests, sidecar) —
    journals excluded: they are working state, not publication."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.startswith("journal_"):
            continue
        with open(os.path.join(directory, name), "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


# ------------------------------------------------------------ metric schema


def test_online_metrics_schema_golden():
    registry = Registry()
    m = online_metrics(registry)
    m["ingested"].inc(5)
    m["dropped"].inc(3)
    m["quota_drops"].inc(2)
    m["rate_drops"].inc(4)
    m["capture_errors"].inc(1)
    m["windows_published"].inc(2)
    m["windows_trained"].inc(2)
    m["retrain_failures"].inc(1)
    m["window_lag_seconds"].set(1.5)
    m["swap_age_seconds"].set(2.5)
    m["retrain_seconds"].observe(0.5)
    golden = open(os.path.join(GOLDEN, "online_metrics.txt")).read()
    assert registry.to_prometheus(labels={"run_id": "fleet1234"}) == golden
    assert online_metrics(registry)["ingested"] is m["ingested"]


# -------------------------------------------------------- sampling policy


def test_sampling_policy_deterministic_and_equal_to_jax():
    a = SamplingPolicy(rate=0.5, seed=11)
    decisions = [a._keep(seq) for seq in range(200)]
    assert decisions == [SamplingPolicy(rate=0.5, seed=11)._keep(s) for s in range(200)]
    assert 0 < sum(decisions) < 200
    assert decisions != [SamplingPolicy(rate=0.5, seed=12)._keep(s) for s in range(200)]
    # the same draw as the JAX package's for every (seed, seq)
    for seed in (0, 11, 2 ** 31 + 5):
        ours, theirs = SamplingPolicy(seed=seed), jax_online.SamplingPolicy(seed=seed)
        assert [ours._uniform(s) for s in range(300)] == [theirs._uniform(s) for s in range(300)]


def test_sampling_policy_admission_reasons():
    policy = SamplingPolicy(tenant_quota=2, filter=lambda prompt, tokens: len(tokens) > 1)
    assert policy.admit(0, "t", 0, [1], [2, 3]) is None
    assert policy.admit(1, "t", 2, [1], [2, 3]) == "quota"
    assert policy.admit(2, "t", 0, [1], [2]) == "filtered"
    assert SamplingPolicy(rate=0.0).admit(3, "t", 0, [1], [2]) == "sampled"


def test_sampling_policy_validation():
    for bad in (dict(rate=1.5), dict(tenant_quota=0), dict(tenant_rate=0.0),
                dict(rate_unit="bogus")):
        with pytest.raises(ValueError):
            SamplingPolicy(**bad)


class _FixedRateLedger:
    """Stand-in for the accounting ledger: fixed rolling rates by tenant."""

    def __init__(self, rates, unit="tokens"):
        self.rates, self.unit = rates, unit

    def rolling_rate(self, tenant, unit="tokens"):
        assert unit == self.unit
        return self.rates.get(tenant, 0.0)


def test_sampling_policy_tenant_rate_thins_hot_tenant():
    ledger = _FixedRateLedger({"hot": 40.0, "warm": 10.0}, unit="tokens")
    policy = SamplingPolicy(tenant_rate=10.0, rate_unit="tokens", ledger=ledger, seed=7)
    assert all(policy.admit(s, "warm", 0, [1], [2]) is None for s in range(200))
    assert all(policy.admit(s, "cold", 0, [1], [2]) is None for s in range(50))
    decisions = [policy.admit(s, "hot", 0, [1], [2]) for s in range(400)]
    drops = decisions.count("rate")
    assert abs((400 - drops) / 400 - 0.25) < 0.1
    jax_policy = jax_online.SamplingPolicy(tenant_rate=10.0, rate_unit="tokens",
                                           ledger=ledger, seed=7)
    assert decisions == [jax_policy.admit(s, "hot", 0, [1], [2]) for s in range(400)]
    mixed = SamplingPolicy(rate=0.5, tenant_rate=10.0, rate_unit="tokens", ledger=ledger,
                           seed=7)
    assert {mixed.admit(s, "hot", 0, [1], [2]) for s in range(200)} == {None, "sampled", "rate"}
    assert SamplingPolicy(tenant_rate=10.0).admit(0, "hot", 0, [1], [2]) is None


def test_sampling_policy_rate_unit_requests():
    ledger = _FixedRateLedger({"hot": 8.0}, unit="requests")
    policy = SamplingPolicy(tenant_rate=2.0, rate_unit="samples", ledger=ledger, seed=3)
    admitted = [policy.admit(s, "hot", 0, [1], [2]) for s in range(400)].count(None)
    assert abs(admitted / 400 - 0.25) < 0.1


# -------------------------------------------------- capture + publication


def test_capture_rotates_into_memmap_windows(tmp_path):
    d = str(tmp_path / "cap")
    registry = Registry()
    log = TrafficLog(d, window_samples=4, max_len=8, registry=registry)
    for i in range(9):
        assert log.record(*_gen(i, tenant="t")) is True
    assert published_windows(d) == [0, 1]
    assert log.pending == 1
    manifest = load_window_manifest(d, 1)
    assert manifest["samples"] == 4
    assert manifest["first_seq"] == 4 and manifest["last_seq"] == 7
    assert manifest["tenants"] == {"t": 4}
    assert verify_window(d, 0) is None and verify_window(d, 1) is None
    feats, lens = window_source(d, 0).local_arrays()
    assert feats.shape == (4, 8) and feats.dtype == np.int32
    req0, res0 = _gen(0, tenant="t")
    merged = req0.prompt + res0.tokens
    assert feats[0, :len(merged)].tolist() == merged and int(lens[0]) == len(merged)
    snap = registry.snapshot()
    assert snap["online_samples_ingested_total"]["value"] == 9
    assert snap["online_windows_published_total"]["value"] == 2
    log.close()


@pytest.mark.parametrize("policy", ["plain", "quota_sampled"])
def test_capture_bytes_equal_jax_and_verify_across(tmp_path, policy):
    """The same records through JAX's TrafficLog and the port's: the
    shards byte for byte, the manifests (and so their digests) equal; each
    package's ``verify_window`` accepts the other's directory."""
    kw = {} if policy == "plain" else dict(tenant_quota=2, rate=0.7, seed=5)
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    logs = {"jax": jax_online.TrafficLog(dirs["jax"], window_samples=3, max_len=8,
                                         policy=jax_online.SamplingPolicy(**kw)),
            "port": TrafficLog(dirs["port"], window_samples=3, max_len=8,
                               policy=SamplingPolicy(**kw))}
    cls = {"jax": (JaxRequest, JaxResult), "port": (GenerateRequest, GenerateResult)}
    admitted = {k: [log.record(*_gen(i, tenant=f"t{i % 3}", cls=cls[k])) for i in range(14)]
                for k, log in logs.items()}
    for log in logs.values():
        log.flush()
        log.close()
    assert admitted["jax"] == admitted["port"]
    assert _capture_digest(dirs["jax"]) == _capture_digest(dirs["port"])
    windows = published_windows(dirs["port"])
    assert windows == jax_online.published_windows(dirs["jax"]) and len(windows) >= 2
    for w in windows:
        assert load_window_manifest(dirs["port"], w) == \
            jax_online.load_window_manifest(dirs["jax"], w)
        assert verify_window(dirs["jax"], w) is None
        assert jax_online.verify_window(dirs["port"], w) is None


def test_capture_tenant_quota_caps_hot_tenant(tmp_path):
    d = str(tmp_path / "cap")
    registry = Registry()
    log = TrafficLog(d, window_samples=4, max_len=8, policy=SamplingPolicy(tenant_quota=2),
                     registry=registry)
    admitted = [log.record(*_gen(i, tenant="hot" if i % 4 < 3 else "cold")) for i in range(16)]
    assert published_windows(d) == [0, 1]
    for w in published_windows(d):
        tenants = load_window_manifest(d, w)["tenants"]
        assert tenants["hot"] <= 2 and tenants["cold"] >= 1
    drops = admitted.count(False)
    snap = registry.snapshot()
    assert drops > 0
    assert snap["online_quota_drops_total"]["value"] == drops
    assert snap["online_samples_dropped_total"]["value"] == drops
    assert log.dropped()["quota"] == drops
    log.close()


def test_capture_tenant_rate_policy_counts_rate_drops(tmp_path):
    d = str(tmp_path / "cap")
    registry = Registry()
    ledger = _FixedRateLedger({"hot": 100.0}, unit="tokens")
    log = TrafficLog(d, window_samples=4, max_len=8, registry=registry,
                     policy=SamplingPolicy(tenant_rate=25.0, rate_unit="tokens", ledger=ledger,
                                           seed=9))
    drops = [log.record(*_gen(i, tenant="hot")) for i in range(40)].count(False)
    assert 0 < drops < 40
    snap = registry.snapshot()
    assert snap["online_rate_drops_total"]["value"] == drops
    assert snap["online_samples_dropped_total"]["value"] == drops
    assert log.dropped()["rate"] == drops
    log.close()


def test_capture_flush_publishes_partial_window(tmp_path):
    d = str(tmp_path / "cap")
    log = TrafficLog(d, window_samples=64, max_len=8)
    for i in range(3):
        log.record(*_gen(i))
    assert log.flush() == 0
    assert load_window_manifest(d, 0)["samples"] == 3
    assert log.flush() is None
    log.close()


def test_verify_window_catches_torn_shard(tmp_path):
    d = str(tmp_path / "cap")
    log = TrafficLog(d, window_samples=2, max_len=8)
    for i in range(2):
        log.record(*_gen(i))
    log.close()
    shard = os.path.join(d, "window_000000.features.npy")
    with open(shard, "r+b") as fh:
        fh.truncate(os.path.getsize(shard) - 8)
    assert "bytes" in verify_window(d, 0)


def test_atomic_write_npy_roundtrip_and_no_tmp_left(tmp_path):
    path = str(tmp_path / "a.npy")
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)
    atomic_write_npy(path, arr)
    assert (np.load(path) == arr).all()
    assert not os.path.exists(path + ".tmp")


# ------------------------------------------------------------ crash resume


def test_capture_plain_restart_resumes_cursor(tmp_path):
    d = str(tmp_path / "cap")
    log = TrafficLog(d, window_samples=4, max_len=8)
    for i in range(6):
        log.record(*_gen(i, tenant="t"))
    log.close()
    resumed = TrafficLog(d, window_samples=4, max_len=8)
    assert (resumed.next_seq, resumed.window, resumed.pending) == (6, 1, 2)
    for i in range(6, 8):
        resumed.record(*_gen(i, tenant="t"))
    assert published_windows(d) == [0, 1]
    resumed.close()


def test_capture_resume_after_kill_between_rotate_and_manifest(tmp_path):
    """A seeded kill BETWEEN shard rotation and manifest publish (chaos
    ``window_rotate`` site), then resume: every published byte matches an
    uninterrupted reference capture — no sample lost, none duplicated."""
    kwargs = dict(window_samples=4, max_len=8)

    def policy():
        return SamplingPolicy(tenant_quota=3, seed=5)

    ref_dir = str(tmp_path / "ref")
    ref = TrafficLog(ref_dir, policy=policy(), **kwargs)
    for i in range(14):
        ref.record(*_gen(i, tenant=f"t{i % 2}"))
    ref.close()

    kill_dir = str(tmp_path / "kill")
    chaos.configure("23:kill_rotate=2")
    log = TrafficLog(kill_dir, policy=policy(), **kwargs)
    killed = 0
    for i in range(14):
        try:
            log.record(*_gen(i, tenant=f"t{i % 2}"))
        except chaos.ChaosKilled:
            # the offered sample was journaled before the kill: the resumed
            # log owns it — re-offering here would duplicate it
            killed += 1
            chaos.configure("")
            log = TrafficLog(kill_dir, policy=policy(), **kwargs)
    log.close()
    assert killed == 1
    assert _capture_digest(kill_dir) == _capture_digest(ref_dir)
    windows = published_windows(kill_dir)
    assert windows == published_windows(ref_dir) == [0, 1, 2]
    next_seq = 0
    for w in windows:
        m = load_window_manifest(kill_dir, w)
        assert m["first_seq"] == next_seq
        assert m["samples"] == m["last_seq"] - m["first_seq"] + 1 == 4
        assert len(window_source(kill_dir, w).local_arrays()[0]) == 4
        next_seq = m["last_seq"] + 1
    with open(os.path.join(kill_dir, "capture_state.json")) as fh:
        state = json.load(fh)
    assert DataState.from_json(state["data_state"]).block_cursor == 14


def test_capture_resume_completes_interrupted_rotation_only_once(tmp_path):
    d = str(tmp_path / "cap")
    chaos.configure("7:kill_rotate=0")
    log = TrafficLog(d, window_samples=3, max_len=8)
    with pytest.raises(chaos.ChaosKilled):
        for i in range(3):
            log.record(*_gen(i))
    chaos.configure("")
    assert published_windows(d) == []  # shards landed, manifest did not
    resumed = TrafficLog(d, window_samples=3, max_len=8)
    assert published_windows(d) == [0]
    assert resumed.pending == 0 and resumed.window == 1
    assert verify_window(d, 0) is None
    resumed.close()
    again = TrafficLog(d, window_samples=3, max_len=8)
    assert published_windows(d) == [0] and again.next_seq == 3
    again.close()


# -------------------------------------------------------- window scheduler


def _np_train_fn(calls):
    """A stub retrain: the window's rows counted, a ``TrainState`` whose
    center carries the window (the port's checkpoints hold one)."""
    def train_fn(window, source):
        feats, _ = source.local_arrays()
        calls.append((window, len(feats)))
        return TrainState(center_params={"w": torch.full((2, 2), float(window + 1))},
                          center_rule={}, local_params={"rows": torch.tensor([[len(feats)]])},
                          opt_state={}, model_state={}, rule_local={},
                          rng=[torch.Generator()], epoch=window)
    return train_fn


def _log_windows(cap, n, window_samples):
    log = TrafficLog(cap, window_samples=window_samples, max_len=8)
    for i in range(n):
        log.record(*_gen(i))
    log.close()


def test_window_scheduler_trains_published_windows(tmp_path):
    from distkeras_tpu_torch.checkpoint import (
        committed_steps,
        restore_checkpoint,
        restore_data_state,
    )

    cap, ckpt = str(tmp_path / "cap"), str(tmp_path / "ckpt")
    _log_windows(cap, 6, 3)
    calls = []
    registry = Registry()
    sched = WindowScheduler(cap, _np_train_fn(calls), ckpt, registry=registry)
    assert sched.pending_windows() == [0, 1]
    assert sched.step_once() == 0
    assert sched.step_once() == 1
    assert sched.step_once() is None
    assert calls == [(0, 3), (1, 3)]
    assert committed_steps(ckpt) == [1, 2]
    state = restore_checkpoint(ckpt, step=2, verify="full")
    assert float(state["center_params"]["w"][0, 0]) == 2.0
    ds = restore_data_state(ckpt, step=2)
    assert ds.epoch == 1
    assert ds.block_cursor == load_window_manifest(cap, 1)["last_seq"] + 1
    snap = registry.snapshot()
    assert snap["online_windows_trained_total"]["value"] == 2
    assert snap["online_retrain_seconds"]["count"] == 2
    # restart safety: a new scheduler baselines on committed steps
    calls2 = []
    sched2 = WindowScheduler(cap, _np_train_fn(calls2), ckpt)
    assert sched2.trained == 1
    assert sched2.step_once() is None and calls2 == []


def test_window_scheduler_retries_chaos_killed_epoch(tmp_path):
    cap = str(tmp_path / "cap")
    _log_windows(cap, 2, 2)
    calls = []
    registry = Registry()
    chaos.configure("3:kill_epoch=0")
    sched = WindowScheduler(cap, _np_train_fn(calls), str(tmp_path / "ckpt"),
                            registry=registry)
    assert sched.step_once() == 0  # first attempt killed before train_fn, retry trains
    assert calls == [(0, 2)]
    assert registry.snapshot()["online_retrain_failures_total"]["value"] == 1


def test_window_scheduler_refuses_torn_window(tmp_path):
    cap = str(tmp_path / "cap")
    _log_windows(cap, 2, 2)
    shard = os.path.join(cap, "window_000000.labels.npy")
    with open(shard, "r+b") as fh:
        fh.truncate(os.path.getsize(shard) - 4)
    sched = WindowScheduler(cap, _np_train_fn([]), str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="shard verification"):
        sched.step_once()


def test_window_scheduler_background_loop(tmp_path):
    cap = str(tmp_path / "cap")
    log = TrafficLog(cap, window_samples=2, max_len=8)
    calls = []
    sched = WindowScheduler(cap, _np_train_fn(calls), str(tmp_path / "ckpt"),
                            poll_interval=0.02)
    sched.start()
    try:
        for i in range(4):
            log.record(*_gen(i))
        deadline = time.monotonic() + 10
        while len(calls) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        sched.stop()
        log.close()
    assert [w for w, _ in calls] == [0, 1]
    assert sched.status()["windows_trained"] == 2
    assert sched.status()["pending"] == []


# --------------------------------------------------------------- placement


@pytest.mark.parametrize("members,replicas", [
    ({"a": {"workers": 2}, "b": {"workers": 8}, "c": {"workers": 4}}, 3),
    ({"only": {"workers": 2}}, 2),
    ({"big": {"workers": 4}, "tiny": {"workers": 1}}, 3),
    ({}, 2),
    ({"x": {"workers": 1}, "y": {"workers": 1}, "z": {}}, 5),
])
def test_plan_placement_equals_jax(members, replicas):
    assert plan_placement(members, replicas) == jax_online.plan_placement(members, replicas)


def test_plan_placement_cases():
    plan = plan_placement({"a": {"workers": 2}, "b": {"workers": 8}, "c": {"workers": 4}}, 3)
    assert plan["trainer"] == "b" and sum(plan["replicas"].values()) == 3
    assert "b" not in plan["replicas"] and plan["capacity"] == 14
    plan = plan_placement({"only": {"workers": 2}}, replicas=2)
    assert plan["trainer"] == "only" and plan["replicas"] == {"only": 2}
    overflow = plan_placement({"big": {"workers": 4}, "tiny": {"workers": 1}}, replicas=3)
    assert overflow["trainer"] == "big" and overflow["replicas"]["tiny"] >= 1
    assert sum(overflow["replicas"].values()) == 3
    assert plan_placement({}, replicas=2) == {"trainer": None, "replicas": {}, "capacity": 0}


# ------------------------------------------------------------ daemon verbs


@pytest.fixture
def punchcard(tmp_path):
    workdir = tmp_path / "punchcard"
    workdir.mkdir()
    server = PunchcardServer(port=0, secret="s3cret", workdir=str(workdir))
    server.start()
    yield server
    server.stop()


SLEEPER = "import time\ntime.sleep(60)\n"


def test_daemon_online_loop_status_stop(punchcard):
    job = Job("127.0.0.1", punchcard.port, secret="s3cret", script=SLEEPER)
    job._rpc({"action": "register", "worker_id": "w-big", "workers": 4})
    job._rpc({"action": "register", "worker_id": "w-small", "workers": 1})
    online_id = job.online_loop(replicas=2, trainer_script=SLEEPER)
    assert job.online_id == online_id and job.tier_id
    st = job.online_status()
    assert st["status"] == "ok"
    assert len(st["replicas"]) == 2 and st["serving"] == 2
    assert st["trainer"]["status"] == "serving"
    assert st["windows_published"] == 0 and st["steps_published"] == 0
    assert st["placement"]["trainer"] == "w-big"
    assert os.path.isdir(st["capture_dir"]) and os.path.isdir(st["checkpoint_dir"])
    stopped = job.stop_online()
    assert stopped["status"] == "stopped" and stopped["stopped"] == 3
    assert job.online_status(online_id)["status"] == "unknown"
    assert job.tier_status()["status"] == "unknown"  # the tier went with it


def test_daemon_online_status_counts_windows_and_steps(punchcard, tmp_path):
    cap, ckpt = str(tmp_path / "cap"), str(tmp_path / "ckpt")
    job = Job("127.0.0.1", punchcard.port, secret="s3cret", script=SLEEPER)
    job.online_loop(replicas=1, trainer_script=SLEEPER, capture_dir=cap, checkpoint_dir=ckpt)
    _log_windows(cap, 4, 2)
    WindowScheduler(cap, _np_train_fn([]), ckpt).step_once()
    st = job.online_status()
    assert st["windows_published"] == 2 and st["steps_published"] == 1
    job.stop_online()


def test_daemon_online_unknown_ids(punchcard):
    job = Job("127.0.0.1", punchcard.port, secret="s3cret", script=SLEEPER)
    assert job.online_status("nope")["status"] == "unknown"
    assert job.stop_online("nope")["status"] == "unknown"
    with pytest.raises(RuntimeError):
        job.online_status()


def test_online_loop_retry_mid_request_spawns_once(punchcard, monkeypatch):
    """C3 for ``online_loop``: the key is reserved before any spawn, so a
    retry that arrives while the first request is still spawning waits for
    its reply and replays it — one tier, one trainer."""
    spawns = []
    real = PunchcardServer._spawn_serve_job

    def slow(self, *args, **kwargs):
        spawns.append(kwargs.get("extra_env", {}).get("DISTKERAS_ONLINE_ROLE", "replica"))
        time.sleep(0.3)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(PunchcardServer, "_spawn_serve_job", slow)
    msg = {"action": "online_loop", "script": SLEEPER, "replicas": 2,
           "trainer_script": SLEEPER, "idempotency": "one-key"}
    replies = [None, None]

    def call(i):
        replies[i] = Job("127.0.0.1", punchcard.port, secret="s3cret")._rpc(dict(msg))

    first = threading.Thread(target=call, args=(0,))
    first.start()
    time.sleep(0.1)  # the retry lands while the first request is spawning
    call(1)
    first.join(timeout=30)
    assert replies[0] == replies[1] and replies[0]["status"] == "online"
    assert spawns == ["replica", "replica", "trainer"]
    assert len(punchcard._online) == 1 and len(punchcard._tiers) == 1
    assert not any(v is job_deployment._PENDING for v in punchcard._idempotent.values())
    Job("127.0.0.1", punchcard.port, secret="s3cret").stop_online(replies[0]["online_id"])


# ---------------------------------------------------- frontend capture hook


class _FakePending:
    def __init__(self, result):
        self._result = result

    def result(self, timeout=None):
        return self._result


class _FakeEngine:
    def __init__(self, result):
        self._result = result
        self.submitted = []

    def submit(self, req):
        self.submitted.append(req)
        return _FakePending(self._result)


def _install(engine, traffic_log, monkeypatch):
    from distkeras_tpu_torch.serving import frontend
    from distkeras_tpu_torch.telemetry.flightdeck import server as server_mod

    handlers = {}
    monkeypatch.setattr(server_mod, "add_endpoint",
                        lambda path, fn: handlers.update({path: fn}))
    frontend.install_http_endpoint(engine, traffic_log=traffic_log)
    return handlers["/generate"]


class _Log:
    def __init__(self):
        self.recorded = []

    def record(self, req, res):
        self.recorded.append((req, res))
        return True


def test_frontend_records_successful_generation(monkeypatch):
    result = GenerateResult(request_id="r", prompt=[1, 2], tokens=[3], finish_reason="length")
    log = _Log()
    handle = _install(_FakeEngine(result), log, monkeypatch)
    _, _, status = handle({"method": "POST",
                           "body": json.dumps({"prompt": [1, 2], "tenant": "acme"})})[:3]
    assert status == 200
    assert len(log.recorded) == 1
    assert log.recorded[0][0].tenant == "acme" and log.recorded[0][1] is result


def test_frontend_tenant_header_fallback(monkeypatch):
    log = _Log()
    handle = _install(_FakeEngine(GenerateResult(request_id="r", prompt=[1], tokens=[2],
                                                 finish_reason="length")), log, monkeypatch)
    handle({"method": "POST", "body": json.dumps({"prompt": [1]}),
            "headers": {"x-dk-tenant": "hdr-tenant"}})
    assert log.recorded[0][0].tenant == "hdr-tenant"


def test_frontend_capture_failure_never_breaks_serving(monkeypatch):
    class _ExplodingLog:
        def record(self, req, res):
            raise RuntimeError("capture disk full")

    telemetry.configure(True)
    telemetry.metrics.reset()
    handle = _install(_FakeEngine(GenerateResult(request_id="r", prompt=[1], tokens=[2],
                                                 finish_reason="length")),
                      _ExplodingLog(), monkeypatch)
    _, body, status = handle({"method": "POST", "body": json.dumps({"prompt": [1]})})[:3]
    assert status == 200  # the client never sees the capture fault
    assert json.loads(body)["tokens"] == [2]
    # counted, not silent
    assert telemetry.metrics.snapshot()["online_capture_errors_total"]["value"] == 1
    telemetry.metrics.reset()


def test_frontend_no_capture_on_aborted(monkeypatch):
    log = _Log()
    handle = _install(_FakeEngine(GenerateResult(request_id="r", prompt=[1], tokens=[],
                                                 finish_reason="aborted")), log, monkeypatch)
    out = handle({"method": "POST", "body": json.dumps({"prompt": [1]})})
    assert out[2] == 503
    assert log.recorded == []  # failed generations are not training data
