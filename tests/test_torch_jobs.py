"""The Punchcard control plane in the port (``job_deployment``), against
tests/test_networking_jobs.py's job cases and tests/test_serving_tier.py's
daemon tier verbs, with the port's fix of ROADMAP Queue C's C3.

* Jobs run to completion, report failures, and the status verb carries the
  job's telemetry surface.  Job scripts are plain Python (no torch), so
  each costs a bare interpreter start.
* The tier verbs spawn, supervise (respawn up to the cap) and stop serving
  replicas; the serve script is a stub that sleeps.
* C3: ``serve`` and ``serve_tier`` reserve the client's idempotency key
  before they spawn, so a retry that arrives while the first request is
  still spawning (the spawn is slowed here) waits for its reply and
  replays it: exactly one spawn.
* The online verbs refuse by name until ROADMAP Queue A item 18c.
* The wire is the JAX package's byte for byte: a JAX ``Job`` submits to
  the port's daemon, and the port's ``FleetWorker`` registers with a JAX
  daemon.
"""

import os
import time

import pytest
import torch

from distkeras_tpu import chaos as jax_chaos
from distkeras_tpu import job_deployment as jax_jobs
from distkeras_tpu_torch import chaos, fleet, job_deployment, telemetry
from distkeras_tpu_torch.job_deployment import Job, PunchcardServer

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

SLEEPER = "import time\ntime.sleep(60)\n"


@pytest.fixture(autouse=True)
def chaos_off():
    for c in (chaos, jax_chaos):
        c.configure("")
    yield
    for c in (chaos, jax_chaos):
        c.configure(None)


@pytest.fixture()
def punchcard():
    server = PunchcardServer(port=0, secret="s3cret")
    server.start()
    yield server
    server.stop()


def _job(server, script="", **kw):
    return Job("127.0.0.1", server.port, secret="s3cret", script=script, **kw)


# ----------------------------------------------------------------- jobs

def test_job_submit_run_finish(punchcard):
    job = _job(punchcard, "print('result:', 6 * 7)")
    job.submit()
    st = job.wait(timeout=30)
    assert st["status"] == "finished" and "result: 42" in st["output"]


def test_job_failure_reported(punchcard):
    job = _job(punchcard, "raise SystemExit(3)")
    job.submit()
    st = job.wait(timeout=30)
    assert st["status"] == "failed" and st["returncode"] == 3


#: a job that writes one metrics snapshot where the daemon points it
METRICS_JOB = """import json, os
path = os.path.join(os.environ["DISTKERAS_TELEMETRY_DIR"], f"metrics_{os.getpid()}.jsonl")
with open(path, "w") as fh:
    fh.write(json.dumps({"metrics": {"c": {"type": "counter", "value": 1.0}}}) + "\\n")
"""


def test_status_verb_reports_telemetry_surface(punchcard, tmp_path, monkeypatch):
    """The status verb carries each job's telemetry dir, live HTTP address
    (None while the flight deck is off) and a last-heartbeat timestamp
    from the job's telemetry files; the job's snapshot reaches the fleet
    merge."""
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path))
    telemetry.configure(True)
    try:
        job = _job(punchcard, METRICS_JOB)
        job.submit()
        st = job.wait(timeout=60)
        assert st["status"] == "finished", st.get("output")
        assert st["telemetry_dir"] == os.path.join(punchcard.workdir, "telemetry", job.job_id)
        assert st["http"] is None  # no DISTKERAS_TELEMETRY_HTTP: no exporter
        assert isinstance(st["last_heartbeat"], float)
        agg = job.aggregate()
        assert agg["jobs"] == 1 and agg["snapshot"]["c"]["value"] == 1.0
    finally:
        telemetry.trace.reset()
        telemetry.metrics.reset()
        telemetry.configure(None)


def test_status_verb_without_telemetry_has_null_surface(punchcard):
    job = _job(punchcard, "print('ok')")
    job.submit()
    st = job.wait(timeout=30)
    assert st["status"] == "finished"
    assert st["telemetry_dir"] is None and st["http"] is None and st["last_heartbeat"] is None


def test_job_bad_secret_denied(punchcard):
    job = Job("127.0.0.1", punchcard.port, secret="wrong", script="print(1)")
    with pytest.raises(RuntimeError):
        job.submit()


# ------------------------------------------------------------ tier verbs

def test_serve_tier_verb_and_status(punchcard):
    job = _job(punchcard, SLEEPER)
    tier_id = job.serve_tier(replicas=2)
    st = job.tier_status()
    assert st["status"] == "ok" and st["tier_id"] == tier_id
    assert len(st["replicas"]) == 2 and st["serving"] == 2 and st["respawns"] == 0
    assert job.stop_tier() == {"status": "stopped", "tier_id": tier_id, "stopped": 2}
    assert job.tier_status(tier_id)["status"] == "unknown"
    # the replicas' job records survive as stopped serve jobs
    assert [punchcard.jobs[r["job_id"]]["status"] for r in st["replicas"]] == ["stopped"] * 2


def test_serve_tier_respawns_crashed_replicas_up_to_cap(punchcard):
    """The runner loop finds a dead replica within its idle wakeup, respawns
    it into the same slot, and stops at the cap (the corpse then stays
    visible as failed)."""
    job = _job(punchcard, "raise SystemExit(1)\n")
    job.serve_tier(replicas=1, max_respawns=2)
    deadline = time.monotonic() + 30
    st = job.tier_status()
    while time.monotonic() < deadline:
        st = job.tier_status()
        if st["respawns"] == 2 and st["replicas"][0]["status"] == "failed":
            break
        time.sleep(0.2)
    assert st["respawns"] == 2 and st["max_respawns"] == 2
    assert st["replicas"][0]["status"] == "failed" and st["serving"] == 0


def test_serve_tier_idempotent_retry(punchcard):
    """A lost serve_tier reply does not double-spawn the fleet: the retry
    replays the original tier (same id, same job_ids)."""
    job = _job(punchcard, SLEEPER, rpc_backoff=0.01)
    chaos.configure("5:drop_reply=1")
    tier_id = job.serve_tier(replicas=2)
    chaos.configure("")
    st = job.tier_status()
    assert st["serving"] == 2 and set(punchcard._tiers) == {tier_id}
    job.stop_tier()


@pytest.mark.parametrize("verb", ["serve", "serve_tier"])
def test_retry_mid_request_spawns_once(punchcard, monkeypatch, verb):
    """C3: the client's reply is dropped right after its send, so its retry
    reaches the daemon while the first request is still spawning (each
    spawn is held 0.3 s here).  The key was reserved first: the retry waits
    for the stored reply and replays it."""
    spawns = []
    spawn = PunchcardServer._spawn_serve_job

    def slow_spawn(self, *args, **kwargs):
        spawns.append(time.monotonic())
        time.sleep(0.3)
        return spawn(self, *args, **kwargs)

    monkeypatch.setattr(PunchcardServer, "_spawn_serve_job", slow_spawn)
    job = _job(punchcard, SLEEPER, rpc_backoff=0.0)
    chaos.configure("5:drop_reply=1")
    first = job.serve_tier(replicas=2) if verb == "serve_tier" else job.serve()
    chaos.configure("")
    assert len(spawns) == (2 if verb == "serve_tier" else 1)
    with punchcard._cv:
        serving = dict(punchcard._serving)
        tiers = dict(punchcard._tiers)
    assert len(serving) == len(spawns) and len(punchcard.jobs) == len(spawns)
    if verb == "serve_tier":
        assert set(tiers) == {first} and job.tier_status()["serving"] == 2
        job.stop_tier()
    else:
        assert list(serving) == [first] and not tiers
        job.stop_serving()


def test_retry_after_a_failed_spawn_spawns_again(punchcard, monkeypatch):
    """A request that fails before storing its reply releases its key: the
    retry does the work (once)."""
    calls = []
    spawn = PunchcardServer._spawn_serve_job

    def flaky(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("disk full")
        return spawn(self, *args, **kwargs)

    monkeypatch.setattr(PunchcardServer, "_spawn_serve_job", flaky)
    job = _job(punchcard, SLEEPER, rpc_backoff=0.0)
    job_id = job.serve()
    assert len(calls) == 2 and list(punchcard._serving) == [job_id]
    assert not any(v is job_deployment._PENDING for v in punchcard._idempotent.values())
    job.stop_serving()


def test_online_verbs_refuse_naming_item_18c(punchcard):
    job = _job(punchcard, SLEEPER)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 18c"):
        job.online_loop(replicas=1, trainer_script="print(1)")
    for reply in (job.online_status("x"), job.stop_online("x"),
                  job._rpc({"action": "online_loop", "script": SLEEPER})):
        assert reply["status"] == "unported" and "ROADMAP Queue A item 18c" in reply["error"]
    assert not punchcard.jobs  # nothing spawned


# ------------------------------------------------- across the two packages

def test_jax_client_and_port_daemon_and_back():
    """The wire codec is the JAX package's byte for byte: a JAX Job submits
    to the port's daemon, and the port's FleetWorker registers with a JAX
    daemon."""
    port_daemon = PunchcardServer(port=0, secret="s3cret")
    jax_daemon = jax_jobs.PunchcardServer(port=0, secret="s3cret", lease=5.0)
    port_daemon.start()
    jax_daemon.start()
    try:
        job = jax_jobs.Job("127.0.0.1", port_daemon.port, secret="s3cret",
                           script="print('across')")
        job.submit()
        st = job.wait(timeout=30)
        assert st["status"] == "finished" and "across" in st["output"]
        w = fleet.FleetWorker("127.0.0.1", jax_daemon.port, secret="s3cret", workers=3)
        assert w.register() == 1 and w.lease == 5.0
        poller = fleet.ElasticMembership("127.0.0.1", jax_daemon.port, secret="s3cret")
        assert poller.poll() is None
        w.deregister()
        assert poller.poll() == 1
        with jax_daemon._cv:
            assert not jax_daemon.fleet.members
    finally:
        port_daemon.stop()
        jax_daemon.stop()
