"""Job deployment — the reference's experimental "Punchcard" subsystem.

The port of :mod:`distkeras_tpu.job_deployment` (host code, copied; its
wire format is the JAX package's byte for byte, so a client of either
package talks to a daemon of either).  One point differs:
**idempotency keys are reserved before any work** (ROADMAP Queue C, C3):
``serve``, ``serve_tier`` and ``online_loop`` claim the client's key under
the daemon's condition variable before they spawn, so a retry that arrives
while the first request is still spawning waits (bounded by
``handler_timeout``) for the stored reply and replays it, and never spawns
a second tier or trainer; a spawn that fails releases the key.

The ``online_loop``, ``online_status`` and ``stop_online`` verbs deploy,
report on and tear down the online serve-to-train loop
(:mod:`distkeras_tpu_torch.online`): a supervised serving tier plus one
co-scheduled trainer job over a shared capture directory and checkpoint
directory, placed by :func:`~distkeras_tpu_torch.online.scheduler.
plan_placement` over the fleet's live leases.

Reference parity: ``distkeras/job_deployment.py :: Job`` packages a training
script plus data pointer plus a shared secret and ships it to a remote
Punchcard daemon that runs queued jobs (SURVEY.md L7; explicitly experimental
and off the main path — same status here).

This implementation: :class:`PunchcardServer` is a small TCP daemon with a
FIFO queue and one runner thread; :class:`Job` is the client.  Transport uses
:mod:`distkeras_tpu_torch.networking`'s restricted codec (no pickle).  Submitted
code executes with the daemon's privileges — the shared secret gates access,
so deploy only inside a trusted cluster, exactly like the reference.
"""

from __future__ import annotations

import glob
import hmac
import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from distkeras_tpu_torch import chaos as _chaos
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.fleet import FleetMembership
from distkeras_tpu_torch.networking import connect, recv_data, send_data
from distkeras_tpu_torch.sanitizer import lockwatch

__all__ = ["Job", "PunchcardServer"]

DEFAULT_PORT = 8000
# retained replies for retried submit/serve, keyed by client idempotency key
# (bounded FIFO — a retry storm must not grow daemon memory unboundedly)
_IDEMPOTENCY_CACHE = 256
# the reply slot of an idempotency key whose first request is still working
_PENDING = object()


def _collect_job_snapshot(tel_dir: str) -> Optional[dict]:
    """The last metrics snapshot from each ``metrics_*.jsonl`` a job wrote
    (one file per process), merged across its processes.  Returns ``None``
    when the job emitted no telemetry.  Dynamics-series lines (which carry
    no ``metrics`` key) are skipped — the snapshot line is the scrape
    surface; the series stay in the job's JSONL for offline analysis."""
    snaps = []
    for path in sorted(glob.glob(os.path.join(tel_dir, "metrics_*.jsonl"))):
        last = None
        try:
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "metrics" in rec:
                        last = rec["metrics"]
        except OSError:
            continue
        if last:
            snaps.append(last)
    if not snaps:
        return None
    from distkeras_tpu_torch.telemetry.metrics import merge_snapshots

    return merge_snapshots(snaps) if len(snaps) > 1 else snaps[0]


class PunchcardServer:
    """Queue-and-run daemon for packaged training jobs."""

    def __init__(self, port: int = DEFAULT_PORT, secret: str = "",
                 workdir: Optional[str] = None, handler_timeout: float = 30.0,
                 lease: float = 10.0, lease_misses: int = 2):
        self.port = port
        self.secret = secret
        self.workdir = workdir or tempfile.mkdtemp(prefix="punchcard_")
        #: per-connection deadline on handler sockets: a half-open client
        #: must time out instead of pinning a handler thread forever
        self.handler_timeout = handler_timeout
        # Under DISTKERAS_SANITIZE the cv is wrapped by the lock-order
        # watchdog (acquisition-order graph, off-lock wait/notify checks)
        # and the jobs dict rejects mutation off the cv — DK105's runtime
        # twin.  With the flag off both are the stock objects.
        self._cv = lockwatch.maybe_wrap(threading.Condition(), "punchcard.cv")
        self.jobs: Dict[str, dict] = lockwatch.guard_map({}, self._cv,
                                                         "punchcard.jobs")
        self._queue: list[str] = []
        self._running = False
        self._sock: Optional[socket.socket] = None
        self._threads: list[threading.Thread] = []
        # long-running `serve` jobs: job_id -> Popen (the FIFO runner only
        # handles run-to-completion scripts; a serving engine never exits)
        self._serving: Dict[str, subprocess.Popen] = {}
        # elastic-fleet membership (register/heartbeat/deregister/membership
        # verbs).  Same lock domain as queue + jobs: every access goes
        # through self._cv, so the lock-order graph stays a single node.
        self.fleet = FleetMembership(lease=lease, miss_tolerance=lease_misses)
        # idempotency-key -> reply replay cache for retried submit/serve
        self._idempotent: Dict[str, dict] = {}
        self._idempotent_order: list[str] = []
        self._evictions_exported = 0
        # serve_tier replica groups: tier_id -> {script, args, flags,
        # job_ids, respawns, max_respawns}.  Mutated under the cv; the
        # runner loop's idle wakeups double as the respawn supervisor.
        self._tiers: Dict[str, dict] = {}
        # online serve->train deployments: online_id -> {tier_id,
        # trainer_job_id, capture_dir, checkpoint_dir, placement}.  The
        # serving replicas live in self._tiers (so the respawn supervisor
        # covers them); this record ties them to their trainer job and the
        # capture/checkpoint directories the loop pivots on.
        self._online: Dict[str, dict] = {}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(16)
        with self._cv:
            self._running = True
        if telemetry.enabled():
            # Fleet correlation + live scrape: mint the daemon's run_id now
            # (spawned jobs inherit it through their env) and start the HTTP
            # exporter when one is configured, with the fleet-merged
            # /aggregate view mounted next to the per-process endpoints.
            telemetry.flightdeck.activate()
            telemetry.flightdeck.add_endpoint(
                "/aggregate",
                lambda: ("application/json", json.dumps(self._fleet_snapshot())),
            )
        for target in (self._accept_loop, self._runner_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        for job_id in list(self._serving):
            self._stop_serving_job(job_id)
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._sock is not None:
            try:  # self-connect to unblock accept() — the reference's cancel_accept trick
                socket.create_connection(("127.0.0.1", self.port), timeout=1).close()
            except OSError:
                pass
            self._sock.close()
        # the daemon often outlives any single fit and may be killed rather
        # than exit cleanly — write its trace/metrics now, not at interpreter
        # exit (no-op when telemetry is disabled)
        telemetry.flush()

    # -- server internals ---------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if not self._running:
                conn.close()
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _authorized(self, msg: dict) -> bool:
        return hmac.compare_digest(str(msg.get("secret", "")), self.secret)

    def _remember(self, idem: Optional[str], reply) -> None:
        """Retain ``reply`` under the client's idempotency key (caller holds
        the cv) so a retried submit/serve replays the original outcome
        instead of double-enqueuing, and wake the retries waiting on it."""
        if not idem:
            return
        if idem not in self._idempotent:
            self._idempotent_order.append(idem)
            while len(self._idempotent_order) > _IDEMPOTENCY_CACHE:
                self._idempotent.pop(self._idempotent_order.pop(0), None)
        self._idempotent[idem] = reply
        self._cv.notify_all()

    def _reserve(self, idem: Optional[str]) -> Optional[dict]:
        """Claim ``idem`` before any work (caller holds the cv): ``None``
        when this request is the first with its key (the key is now
        reserved, or the request has none), else the first request's
        stored reply.  A retry that arrives while the first request is
        still working waits here for its reply, at most
        ``handler_timeout`` seconds (then ``TimeoutError``, and the
        connection is dropped unanswered); it never does the work twice."""
        if not idem:
            return None
        deadline = time.monotonic() + self.handler_timeout
        while self._idempotent.get(idem) is _PENDING:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"request {idem} is still in progress")
            self._cv.wait(timeout=left)
        reply = self._idempotent.get(idem)
        if reply is None:
            self._remember(idem, _PENDING)
        return reply

    def _release(self, idem: Optional[str]) -> None:
        """Drop the reservation of a request that failed before it stored
        a reply (caller holds the cv): a retry may then do the work."""
        if idem and self._idempotent.get(idem) is _PENDING:
            del self._idempotent[idem]
            self._idempotent_order.remove(idem)
            self._cv.notify_all()

    def _once(self, idem: Optional[str], work) -> dict:
        """``work()``'s reply, done once per idempotency key: reserved
        before, stored after (a retry replays it), released if ``work``
        raised."""
        with self._cv:
            reply = self._reserve(idem)
        if reply is not None:
            return reply
        try:
            reply = work()
        except BaseException:
            with self._cv:
                self._release(idem)
            raise
        with self._cv:
            self._remember(idem, reply)
        return reply

    def _handle(self, conn: socket.socket) -> None:
        try:
            # per-connection deadline: recv_data on a half-open client must
            # raise instead of pinning this handler thread forever
            conn.settimeout(self.handler_timeout)
            msg = recv_data(conn)
            if not self._authorized(msg):
                send_data(conn, {"status": "denied"})
                return
            action = msg.get("action")
            idem = msg.get("idempotency")
            if action == "submit":
                with self._cv:
                    reply = self._idempotent.get(idem) if idem else None
                    if reply is None:
                        job_id = uuid.uuid4().hex
                        self.jobs[job_id] = {"status": "queued", "output": "",
                                             "returncode": None, "metrics": None,
                                             "script": msg["script"],
                                             "args": msg.get("args", [])}
                        self._queue.append(job_id)
                        self._cv.notify()
                        reply = {"status": "queued", "job_id": job_id}
                        self._remember(idem, reply)
                send_data(conn, reply)
            elif action == "serve":
                # Host a long-running serving engine as a job: launched
                # detached (Popen) because the FIFO runner blocks until a
                # script exits and a serving loop never does.  The script is
                # expected to build a ServingEngine, install the /generate
                # endpoint, and block; its flightdeck exporter port is
                # forced on so the engine is reachable, and discoverable
                # through the usual discovery-file -> status-verb path.
                # The key is reserved before the spawn: a retry whose first
                # request is still spawning waits for its reply (C3).
                def serve():
                    flags = msg.get("flags")
                    job_id = self._spawn_serve_job(
                        msg["script"], list(msg.get("args", [])),
                        flags if isinstance(flags, dict) else {})
                    return {"status": "serving", "job_id": job_id}

                send_data(conn, self._once(idem, serve))
            elif action == "serve_tier":
                # N identical serving replicas as one supervised group —
                # the unit the ServingTier router fronts.  Each replica is
                # an ordinary serve job (own exporter, own log, own
                # job_id); the daemon tracks the group so tier_status
                # answers in one round trip and the runner loop's idle
                # wakeups respawn crashed replicas (capped per tier).  The
                # key is reserved before the first spawn (C3), and the
                # spawns run off the lock.
                def serve_tier():
                    replicas = max(1, int(msg.get("replicas") or 1))
                    flags = msg.get("flags")
                    flags = dict(flags) if isinstance(flags, dict) else {}
                    tier_id = uuid.uuid4().hex
                    job_ids = [
                        self._spawn_serve_job(
                            msg["script"], list(msg.get("args", [])), flags,
                            extra_env={"DISTKERAS_TIER_ID": tier_id,
                                       "DISTKERAS_REPLICA_INDEX": str(i)})
                        for i in range(replicas)
                    ]
                    with self._cv:
                        self._tiers[tier_id] = {
                            "script": msg["script"],
                            "args": list(msg.get("args", [])),
                            "flags": flags,
                            "job_ids": job_ids,
                            "respawns": 0,
                            "max_respawns": int(msg.get("max_respawns", 3)),
                        }
                    return {"status": "serving", "tier_id": tier_id,
                            "job_ids": list(job_ids)}

                send_data(conn, self._once(idem, serve_tier))
            elif action == "tier_status":
                with self._cv:
                    tier = self._tiers.get(msg.get("tier_id", ""))
                    job_ids = list(tier["job_ids"]) if tier else []
                if tier is None:
                    send_data(conn, {"status": "unknown"})
                else:
                    reps = []
                    for jid in job_ids:
                        job = self.jobs.get(jid)
                        if job is None:
                            continue
                        self._refresh_serving(jid, job)
                        reps.append({"job_id": jid,
                                     "status": job["status"],
                                     "http": self._job_http_address(job)})
                    with self._cv:
                        respawns = tier["respawns"]
                        cap = tier["max_respawns"]
                    send_data(conn, {
                        "status": "ok", "tier_id": msg.get("tier_id"),
                        "replicas": reps,
                        "serving": sum(1 for r in reps
                                       if r["status"] == "serving"),
                        "respawns": respawns, "max_respawns": cap})
            elif action == "stop_tier":
                with self._cv:
                    tier = self._tiers.pop(msg.get("tier_id", ""), None)
                    job_ids = list(tier["job_ids"]) if tier else []
                if tier is None:
                    send_data(conn, {"status": "unknown"})
                else:
                    stopped = sum(1 for jid in job_ids
                                  if self._stop_serving_job(jid))
                    send_data(conn, {"status": "stopped",
                                     "tier_id": msg.get("tier_id"),
                                     "stopped": stopped})
            elif action == "online_loop":
                # Co-schedule the whole serve->train loop on this fleet:
                # ``replicas`` serving jobs as one supervised tier (their
                # script installs a TrafficLog-backed /generate) plus one
                # detached trainer job (its script runs a WindowScheduler
                # over the shared capture directory and publishes verified
                # checkpoint steps the replicas' watcher hot-swaps in).
                # Placement is decided from the live leases up front and
                # recorded on the deployment so online_status can show
                # where the work was put.  The key is reserved before the
                # first spawn (C3), and the spawns run off the lock.
                send_data(conn, self._once(idem, lambda: self._online_loop(msg)))
            elif action == "online_status":
                with self._cv:
                    ent = self._online.get(msg.get("online_id", ""))
                    ent = dict(ent) if ent else None
                    tier = self._tiers.get(ent["tier_id"]) if ent else None
                    job_ids = list(tier["job_ids"]) if tier else []
                if ent is None:
                    send_data(conn, {"status": "unknown"})
                else:
                    reps = []
                    for jid in job_ids:
                        job = self.jobs.get(jid)
                        if job is None:
                            continue
                        self._refresh_serving(jid, job)
                        reps.append({"job_id": jid,
                                     "status": job["status"],
                                     "http": self._job_http_address(job)})
                    tjid = ent["trainer_job_id"]
                    tjob = self.jobs.get(tjid)
                    if tjob is not None:
                        self._refresh_serving(tjid, tjob)
                    # window/step progress straight off the filesystem —
                    # counting manifests keeps the daemon free of the
                    # device-heavy checkpoint module
                    from distkeras_tpu_torch.online.capture import published_windows
                    windows = len(published_windows(ent["capture_dir"]))
                    steps = 0
                    if os.path.isdir(ent["checkpoint_dir"]):
                        names = set(os.listdir(ent["checkpoint_dir"]))
                        steps = sum(
                            1 for d in names
                            if d.startswith("step_")
                            and d.endswith(".manifest.json")
                            and d[len("step_"):-len(".manifest.json")].isdigit()
                            and d[:-len(".manifest.json")] in names)
                    send_data(conn, {
                        "status": "ok",
                        "online_id": msg.get("online_id"),
                        "tier_id": ent["tier_id"],
                        "replicas": reps,
                        "serving": sum(1 for r in reps
                                       if r["status"] == "serving"),
                        "trainer": {"job_id": tjid,
                                    "status": (tjob["status"]
                                               if tjob else "unknown")},
                        "windows_published": windows,
                        "steps_published": steps,
                        "capture_dir": ent["capture_dir"],
                        "checkpoint_dir": ent["checkpoint_dir"],
                        "placement": ent["placement"]})
            elif action == "stop_online":
                with self._cv:
                    ent = self._online.pop(msg.get("online_id", ""), None)
                    tier = (self._tiers.pop(ent["tier_id"], None)
                            if ent else None)
                    job_ids = list(tier["job_ids"]) if tier else []
                if ent is None:
                    send_data(conn, {"status": "unknown"})
                else:
                    stopped = sum(1 for jid in job_ids
                                  if self._stop_serving_job(jid))
                    if self._stop_serving_job(ent["trainer_job_id"]):
                        stopped += 1
                    send_data(conn, {"status": "stopped",
                                     "online_id": msg.get("online_id"),
                                     "stopped": stopped})
            elif action == "stop_serving":
                job_id = msg.get("job_id", "")
                if self._stop_serving_job(job_id):
                    send_data(conn, {"status": "stopped", "job_id": job_id})
                else:
                    send_data(conn, {"status": "unknown"})
            elif action == "register":
                with self._cv:
                    self.fleet.sweep()
                    wid = self.fleet.register(
                        msg.get("worker_id") or None,
                        int(msg.get("workers") or 1), msg.get("host"))
                    reply = {"status": "ok", "worker_id": wid,
                             "lease": self.fleet.lease,
                             "epoch": self.fleet.epoch}
                    self._export_fleet_metrics()
                send_data(conn, reply)
            elif action == "heartbeat":
                with self._cv:
                    self.fleet.sweep()
                    alive = self.fleet.heartbeat(str(msg.get("worker_id") or ""))
                    reply = ({"status": "ok", "epoch": self.fleet.epoch}
                             if alive else {"status": "unknown"})
                    self._export_fleet_metrics()
                send_data(conn, reply)
            elif action == "deregister":
                with self._cv:
                    known = self.fleet.deregister(str(msg.get("worker_id") or ""))
                    reply = {"status": "ok" if known else "unknown",
                             "epoch": self.fleet.epoch}
                    self._export_fleet_metrics()
                send_data(conn, reply)
            elif action == "membership":
                with self._cv:
                    self.fleet.sweep()
                    reply = {"status": "ok", **self.fleet.snapshot()}
                    self._export_fleet_metrics()
                send_data(conn, reply)
            elif action == "status":
                job = self.jobs.get(msg.get("job_id", ""))
                if job is None:
                    send_data(conn, {"status": "unknown"})
                else:
                    self._refresh_serving(msg.get("job_id", ""), job)
                    # telemetry_dir / http / last_heartbeat let an operator
                    # find (and scrape) a wedged job without grepping the
                    # daemon log; all None while telemetry is off.
                    send_data(conn, {"status": job["status"], "output": job["output"],
                                     "returncode": job["returncode"],
                                     "telemetry_dir": job.get("telemetry_dir"),
                                     "http": self._job_http_address(job),
                                     "last_heartbeat": self._job_heartbeat(job),
                                     "serve_flags": job.get("serve_flags")})
            elif action == "list":
                with self._cv:
                    serving_ids = set(self._serving)
                for jid, j in list(self.jobs.items()):
                    if jid in serving_ids:
                        self._refresh_serving(jid, j)
                send_data(conn, {"status": "ok",
                                 "jobs": {k: v["status"] for k, v in self.jobs.items()}})
            elif action == "metrics":
                # Control-plane scrape of this process's telemetry registry:
                # Prometheus text (for scrapers / humans) plus the structured
                # snapshot, both JSON-safe for the restricted codec — and the
                # merged whole-fleet view of every job that reported metrics.
                reply = {"status": "ok",
                         "enabled": telemetry.enabled(),
                         "prometheus": telemetry.metrics.to_prometheus(),
                         "snapshot": telemetry.metrics.snapshot(),
                         "fleet": self._fleet_snapshot()}
                job = self.jobs.get(msg.get("job_id") or "")
                if job is not None:
                    # live scrape of a still-running job's /vars through its
                    # flightdeck exporter, instead of waiting for job exit
                    reply["live"] = self._job_live_vars(job)
                send_data(conn, reply)
            elif action == "aggregate":
                send_data(conn, {"status": "ok", **self._fleet_snapshot()})
            elif action == "slo_status":
                send_data(conn, {"status": "ok", **self._fleet_slo()})
            elif action == "ledger_status":
                send_data(conn, {"status": "ok", **self._fleet_ledger()})
            else:
                send_data(conn, {"status": "bad_request"})
        except TimeoutError:
            # handler deadline hit (half-open or glacial client) — drop the
            # connection, count it, keep the thread pool healthy
            if telemetry.enabled():
                telemetry.metrics.counter(
                    "punchcard_handler_timeouts_total",
                    help="handler sockets dropped at the connection deadline",
                ).inc()
        except (ConnectionError, ValueError, OSError):
            pass
        except Exception:
            # a handler crash on a daemon thread would otherwise vanish with
            # the connection — leave the blackbox behind, then let it surface
            telemetry.flightdeck.on_crash("punchcard._handle crashed")
            raise
        finally:
            conn.close()

    def _export_fleet_metrics(self) -> None:
        """Fleet gauges into the telemetry registry (caller holds the cv —
        registry updates are cheap and never block).  They ride the same
        flightdeck ``/vars`` + ``aggregate``-verb path as every other
        daemon metric."""
        if not telemetry.enabled():
            return
        telemetry.metrics.gauge(
            "fleet_members", help="workers holding a live lease"
        ).set(len(self.fleet.members))
        telemetry.metrics.gauge(
            "fleet_workers", help="summed logical workers across members"
        ).set(self.fleet.workers_total())
        telemetry.metrics.gauge(
            "fleet_membership_epoch",
            help="monotonic membership epoch (bumps on join/leave/evict)",
        ).set(self.fleet.epoch)
        delta = self.fleet.evictions - self._evictions_exported
        if delta:
            telemetry.metrics.counter(
                "fleet_evictions_total",
                help="workers evicted on a missed lease",
            ).inc(delta)
            self._evictions_exported = self.fleet.evictions

    def _job_env(self, job_id: str, ensure_http: bool = False) -> tuple:
        """Telemetry environment for a spawned job: its own telemetry
        subdirectory (so the ``aggregate`` verb can collect snapshots
        without jobs clobbering each other), the fleet run_id (dktrace
        merge joins on it), and an ephemeral flightdeck exporter when the
        daemon itself is scrape-able — or unconditionally for ``serve``
        jobs (``ensure_http``), whose /generate endpoint lives on it.
        Returns ``(env, tel_dir)``, both ``None`` when telemetry is off;
        the caller records ``tel_dir`` on the job dict under the cv."""
        if not telemetry.enabled():
            return None, None
        tel_dir = os.path.join(self.workdir, "telemetry", job_id)
        os.makedirs(tel_dir, exist_ok=True)
        env = dict(os.environ, DISTKERAS_TELEMETRY="1",
                   DISTKERAS_TELEMETRY_DIR=tel_dir,
                   DISTKERAS_RUN_ID=telemetry.flightdeck.run_id())
        if ensure_http or telemetry.flightdeck.http_port() is not None:
            env["DISTKERAS_TELEMETRY_HTTP"] = "0"
        return env, tel_dir

    def _spawn_serve_job(self, script: str, args: list, flags: dict,
                         extra_env: Optional[Dict[str, str]] = None) -> str:
        """Spawn one detached serving process (shared by the ``serve`` and
        ``serve_tier`` verbs and the tier respawn supervisor): write the
        script, build the job env with the exporter forced on (the
        ``/generate`` endpoint lives on it), Popen with a log file, record
        the job and its process under the cv.  Returns the new job_id."""
        job_id = uuid.uuid4().hex
        script_path = os.path.join(self.workdir, f"{job_id}.py")
        with open(script_path, "w") as f:
            f.write(script)
        job = {"status": "serving", "output": "", "returncode": None,
               "metrics": None, "script": script, "args": list(args),
               "log_path": None, "serve_flags": dict(flags)}
        env, tel_dir = self._job_env(job_id, ensure_http=True)
        if tel_dir is not None:
            job["telemetry_dir"] = tel_dir
        if job["serve_flags"] or extra_env:
            if env is None:  # telemetry off: _job_env built no env
                env = dict(os.environ)
            if job["serve_flags"]:
                # engine knobs (prefill_buckets, spec_tokens, ...) ride to
                # the child as JSON; the script reads them back via
                # serving.serve_flags() so one script serves many configs
                env["DISTKERAS_SERVE_FLAGS"] = json.dumps(job["serve_flags"])
            if extra_env:
                env.update(extra_env)
        log_path = os.path.join(self.workdir, f"{job_id}.log")
        job["log_path"] = log_path
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, script_path, *map(str, args)],
                stdout=log, stderr=subprocess.STDOUT,
                cwd=self.workdir, env=env,
            )
        with self._cv:
            self.jobs[job_id] = job
            self._serving[job_id] = proc
            n_serving = len(self._serving)
        if telemetry.enabled():
            telemetry.metrics.gauge(
                "punchcard_serving_jobs",
                help="serve-verb engines currently hosted",
            ).set(n_serving)
        return job_id

    def _online_loop(self, msg: dict) -> dict:
        """The ``online_loop`` verb's work, run once per idempotency key:
        the directories, the placement, the replicas and the trainer spawned
        (off the lock), then the deployment recorded under the cv."""
        from distkeras_tpu_torch.online.scheduler import plan_placement

        replicas = max(1, int(msg.get("replicas") or 1))
        flags = msg.get("flags")
        flags = dict(flags) if isinstance(flags, dict) else {}
        online_id = uuid.uuid4().hex
        capture_dir = (msg.get("capture_dir")
                       or os.path.join(self.workdir, "online", online_id, "capture"))
        ckpt_dir = (msg.get("checkpoint_dir")
                    or os.path.join(self.workdir, "online", online_id, "ckpt"))
        os.makedirs(capture_dir, exist_ok=True)
        os.makedirs(ckpt_dir, exist_ok=True)
        with self._cv:
            self.fleet.sweep()
            members = self.fleet.snapshot()["members"]
        placement = plan_placement(members, replicas)
        loop_env = {"DISTKERAS_ONLINE_ID": online_id,
                    "DISTKERAS_CAPTURE_DIR": capture_dir,
                    "DISTKERAS_CKPT_DIR": ckpt_dir}
        tier_id = uuid.uuid4().hex
        job_ids = [
            self._spawn_serve_job(
                msg["script"], list(msg.get("args", [])), flags,
                extra_env={**loop_env,
                           "DISTKERAS_TIER_ID": tier_id,
                           "DISTKERAS_REPLICA_INDEX": str(i)})
            for i in range(replicas)
        ]
        trainer_job = self._spawn_serve_job(
            msg["trainer_script"], list(msg.get("trainer_args", [])), flags,
            extra_env={**loop_env, "DISTKERAS_ONLINE_ROLE": "trainer"})
        with self._cv:
            self._tiers[tier_id] = {
                "script": msg["script"],
                "args": list(msg.get("args", [])),
                "flags": flags,
                "job_ids": job_ids,
                "respawns": 0,
                "max_respawns": int(msg.get("max_respawns", 3)),
            }
            self._online[online_id] = {
                "tier_id": tier_id,
                "trainer_job_id": trainer_job,
                "capture_dir": capture_dir,
                "checkpoint_dir": ckpt_dir,
                "placement": placement,
            }
        return {"status": "online", "online_id": online_id,
                "tier_id": tier_id, "job_ids": list(job_ids),
                "trainer_job_id": trainer_job,
                "capture_dir": capture_dir,
                "checkpoint_dir": ckpt_dir,
                "placement": placement}

    def _find_dead_replica(self) -> Optional[tuple]:
        """One crashed tier replica due a respawn, as ``(tier_id, job_id)``
        — or ``None``.  Caller holds the cv; ``poll()`` is a non-blocking
        reap.  Tiers out of respawn credits are skipped: their dead
        replicas stay visible through ``tier_status`` as failed instead of
        flapping forever."""
        for tier_id, tier in self._tiers.items():
            if tier["respawns"] >= tier["max_respawns"]:
                continue
            for jid in tier["job_ids"]:
                proc = self._serving.get(jid)
                if proc is not None and proc.poll() is not None:
                    return tier_id, jid
                if proc is None:
                    # a tier_status poll's _refresh_serving may reap the
                    # corpse first — the folded status is still a death
                    # ("stopped" is an explicit stop, never respawned)
                    job = self.jobs.get(jid) or {}
                    if job.get("status") in ("failed", "finished"):
                        return tier_id, jid
        return None

    def _respawn_replica(self, tier_id: str, dead_id: str) -> None:
        """Replace one crashed tier replica: fold the dead process into its
        job record (off-lock log read), burn one respawn credit, spawn the
        replacement into the same slot.  Runs on the runner thread."""
        job = self.jobs.get(dead_id)
        if job is not None:
            self._refresh_serving(dead_id, job)
        with self._cv:
            tier = self._tiers.get(tier_id)
            if (tier is None or dead_id not in tier["job_ids"]
                    or tier["respawns"] >= tier["max_respawns"]):
                return  # tier stopped / already handled / out of credits
            tier["respawns"] += 1
            index = tier["job_ids"].index(dead_id)
            script = tier["script"]
            args = list(tier["args"])
            flags = dict(tier["flags"])
        new_id = self._spawn_serve_job(
            script, args, flags,
            extra_env={"DISTKERAS_TIER_ID": tier_id,
                       "DISTKERAS_REPLICA_INDEX": str(index)})
        with self._cv:
            tier = self._tiers.get(tier_id)
            live = (tier is not None and index < len(tier["job_ids"])
                    and tier["job_ids"][index] == dead_id)
            if live:
                tier["job_ids"][index] = new_id
        if not live:
            # the tier was stopped while the replacement was starting —
            # reap the orphan instead of leaking a headless engine
            self._stop_serving_job(new_id)
            return
        if telemetry.enabled():
            telemetry.metrics.counter(
                "punchcard_tier_respawns_total",
                help="tier serve replicas respawned after a crash",
            ).inc()

    def _refresh_serving(self, job_id: str, job: dict) -> None:
        """Fold a serve job's process state into its status: a serving
        engine that exited did not finish — it died (or was stopped).
        The log read happens off-lock; the job/ _serving mutations go under
        the cv (GuardedMap only polices the map itself — mutations of the
        inner job dicts are invisible to it, so the discipline must hold by
        construction here)."""
        with self._cv:
            proc = self._serving.get(job_id)
        if proc is None or proc.poll() is None:
            return
        output = self._read_log(job)
        with self._cv:
            job["returncode"] = proc.returncode
            job["status"] = "failed" if proc.returncode else "finished"
            job["output"] = output
            self._serving.pop(job_id, None)

    def _stop_serving_job(self, job_id: str) -> bool:
        """Terminate a serving job; ``False`` when no such job is live.
        The pop is atomic under the cv, the terminate/wait runs off-lock."""
        with self._cv:
            proc = self._serving.pop(job_id, None)
            n_serving = len(self._serving)
        if proc is None:
            return False
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        job = self.jobs.get(job_id)
        output = self._read_log(job) if job is not None else ""
        if job is not None:
            with self._cv:
                job["status"] = "stopped"
                job["returncode"] = proc.returncode
                job["output"] = output
        if telemetry.enabled():
            telemetry.metrics.gauge(
                "punchcard_serving_jobs",
                help="serve-verb engines currently hosted",
            ).set(n_serving)
        return True

    @staticmethod
    def _read_log(job: dict) -> str:
        path = job.get("log_path")
        if not path:
            return job.get("output", "")
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                return fh.read()
        except OSError:
            return job.get("output", "")

    def _runner_loop(self) -> None:
        while True:
            respawn = None
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait(timeout=0.5)
                    # the runner's idle wakeups double as the lease sweeper:
                    # an expired worker is evicted (and the membership epoch
                    # bumped) within ~0.5 s even with no verb traffic ...
                    if self.fleet.sweep():
                        self._export_fleet_metrics()
                    # ... and as the tier supervisor: a crashed serve_tier
                    # replica is detected here and respawned off-lock below
                    respawn = self._find_dead_replica()
                    if respawn is not None:
                        break
                if not self._running:
                    return
                if respawn is None:
                    job_id = self._queue.pop(0)
                    # job lookup + status flip under the cv (previously both
                    # raced the handler threads from outside the lock)
                    job = self.jobs[job_id]
                    job["status"] = "running"
                    script = job["script"]
                    args = list(job["args"])
            if respawn is not None:
                # the spawn itself (log open + Popen) must not hold the cv
                self._respawn_replica(*respawn)
                continue
            script_path = os.path.join(self.workdir, f"{job_id}.py")
            with open(script_path, "w") as f:
                f.write(script)
            env, tel_dir = self._job_env(job_id)
            if tel_dir is not None:
                with self._cv:
                    job["telemetry_dir"] = tel_dir
            try:
                # the job_run span is dktrace merge's clock-skew anchor: a
                # job's own trace starts at its process-local perf origin,
                # and realigning it into the fleet timeline needs the
                # daemon-side dispatch window
                with telemetry.trace.span("job_run", job_id=job_id):
                    proc = subprocess.run(
                        [sys.executable, script_path, *map(str, args)],
                        capture_output=True, text=True, timeout=3600, cwd=self.workdir,
                        env=env,
                    )
                with self._cv:
                    job["output"] = proc.stdout + proc.stderr
                    job["returncode"] = proc.returncode
                outcome = "finished" if proc.returncode == 0 else "failed"
            except subprocess.TimeoutExpired:
                outcome = "timeout"
            if tel_dir is not None:
                with telemetry.trace.span("job_collect", job_id=job_id):
                    snapshot = _collect_job_snapshot(tel_dir)
                with self._cv:
                    job["metrics"] = snapshot
            if telemetry.enabled():
                telemetry.metrics.counter(
                    "punchcard_jobs_finished_total" if outcome == "finished"
                    else "punchcard_jobs_failed_total",
                    help="jobs the runner completed, by outcome",
                ).inc()
                if outcome != "finished":
                    # daemon-side blackbox for the crashed/wedged job: the
                    # ring holds its dispatch/collect spans and the fleet
                    # counters at failure time
                    telemetry.flightdeck.on_crash(
                        f"punchcard job {job_id} {outcome}",
                        extra={"job_id": job_id,
                               "returncode": job["returncode"],
                               "telemetry_dir": tel_dir})
                # flush per job: fleet runs must not lose telemetry that
                # would otherwise only be written at interpreter exit
                telemetry.flush()
            # status last: clients poll it as the completion signal, so the
            # job's fleet snapshot must already be in place when it flips
            with self._cv:
                job["status"] = outcome

    def _job_http_address(self, job: dict) -> Optional[str]:
        """The job's live flightdeck address, from the discovery file its
        exporter drops into the job telemetry dir.  Cached into the job map
        once resolved; ``None`` while flightdeck is off or the job has not
        come up yet."""
        addr = job.get("http")
        if addr:
            return addr
        tel_dir = job.get("telemetry_dir")
        if not tel_dir:
            return None
        for path in sorted(glob.glob(os.path.join(tel_dir, "flightdeck_*.json"))):
            try:
                with open(path, encoding="utf-8") as fh:
                    addr = json.load(fh).get("address")
            except (OSError, ValueError):
                continue
            if addr:
                job["http"] = addr
                return addr
        return None

    def _job_heartbeat(self, job: dict) -> Optional[float]:
        """Unix timestamp of the job's last observable activity: the live
        ``/healthz`` answer when its exporter is up, else the newest mtime
        in its telemetry dir, else ``None`` — how an operator spots a wedged
        job from the ``status`` verb alone."""
        addr = self._job_http_address(job)
        if addr:
            try:
                import urllib.request

                with urllib.request.urlopen(f"http://{addr}/healthz",
                                            timeout=1.0) as resp:
                    body = json.loads(resp.read().decode("utf-8"))
                hb = body.get("last_event_unix") or body.get("unix")
                if hb is not None:
                    return float(hb)
            except (OSError, ValueError):
                pass
        tel_dir = job.get("telemetry_dir")
        if tel_dir and os.path.isdir(tel_dir):
            try:
                mtimes = [os.path.getmtime(os.path.join(tel_dir, name))
                          for name in os.listdir(tel_dir)]
            except OSError:
                mtimes = []
            if mtimes:
                return max(mtimes)
        return None

    def _job_live_json(self, job: dict, path: str) -> Optional[dict]:
        """GET one JSON endpoint off a still-running job's flightdeck
        exporter; ``None`` when the job has no live exporter (or the scrape
        fails — a dead job must not fail the fleet view)."""
        addr = self._job_http_address(job)
        if not addr:
            return None
        try:
            import urllib.request

            with urllib.request.urlopen(f"http://{addr}/{path}",
                                        timeout=1.0) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except (OSError, ValueError):
            return None

    def _job_live_vars(self, job: dict) -> Optional[dict]:
        """Scrape a still-running job's ``/vars`` (live metrics snapshot +
        dynamics summary); ``None`` when the job has no live exporter."""
        return self._job_live_json(job, "vars")

    def _fleet_snapshot(self) -> dict:
        """Merged metric snapshot across every job that reported metrics —
        whole-fleet health in one scrape (``aggregate`` verb)."""
        from distkeras_tpu_torch.telemetry.metrics import (
            merge_snapshots,
            prometheus_from_snapshot,
        )

        with self._cv:
            snaps = [j["metrics"] for j in self.jobs.values() if j.get("metrics")]
        merged = merge_snapshots(snaps)
        return {"jobs": len(snaps), "snapshot": merged,
                "prometheus": prometheus_from_snapshot(merged)}

    def _fleet_slo(self) -> dict:
        """Fleet SLO + rollup view (``slo_status`` verb): every live job's
        ``/slo`` engines plus the daemon's own, and the jobs' rollup rings
        merged onto one time axis — what ``dkmon status/watch/check`` and
        the future autoscaler verb consume."""
        from distkeras_tpu_torch.telemetry import slo as _slo
        from distkeras_tpu_torch.telemetry.flightdeck.rollup import merge_series

        engines: Dict[str, dict] = {}
        firing: List[dict] = []
        series: List[dict] = []

        def _collect(owner: str, status_by_source: Dict[str, dict]) -> None:
            for src, st in (status_by_source or {}).items():
                engines[f"{owner}:{src}"] = st
                for row in st.get("objectives", ()):
                    if row.get("firing"):
                        firing.append({"owner": owner, "source": src, **row})

        with self._cv:
            jobs = list(self.jobs.items())
        for jid, job in jobs:
            body = self._job_live_json(job, "slo")
            if body:
                _collect(jid, body.get("engines"))
            ts = self._job_live_json(job, "timeseries")
            if ts and ts.get("samples"):
                series.append(ts)
        _collect("daemon",
                 {src: e.status() for src, e in _slo.engines().items()})
        align = max((float(p.get("interval") or 1.0) for p in series),
                    default=1.0)
        merged = (merge_series(series, align_s=align) if series
                  else {"interval": align, "capacity": 0, "samples": []})
        return {"engines": engines, "firing": firing,
                "firing_count": len(firing), "timeseries": merged}

    def _fleet_ledger(self) -> dict:
        """Fleet accounting view (``ledger_status`` verb): every live job's
        ``/ledger`` table plus the daemon's own process, merged tenant-wise
        (bucket-exact, see :func:`accounting.merge_ledgers`) — what
        ``dkmon top --daemon host:port`` renders."""
        from distkeras_tpu_torch.telemetry import accounting

        with self._cv:
            jobs = list(self.jobs.items())
        tables = []
        scraped = 0
        for jid, job in jobs:
            body = self._job_live_json(job, "ledger")
            if body and body.get("enabled"):
                tables.append(body)
                scraped += 1
        own = accounting.ledger_payload()
        if own.get("enabled"):
            tables.append(own)
        merged = accounting.merge_ledgers(tables)
        merged["enabled"] = bool(tables)
        merged["jobs"] = scraped
        return merged


class Job:
    """Client: package a training script, submit it, poll for the result
    (reference parity: ``job_deployment.py :: Job``)."""

    def __init__(self, host: str, port: int = DEFAULT_PORT, secret: str = "",
                 script: str = "", args: Optional[list] = None,
                 rpc_timeout: float = 30.0, rpc_retries: int = 3,
                 rpc_backoff: float = 0.1):
        self.host = host
        self.port = port
        self.secret = secret
        self.script = script
        self.args = args or []
        self.job_id: Optional[str] = None
        self.tier_id: Optional[str] = None
        self.online_id: Optional[str] = None
        #: socket deadline per RPC attempt (connect + send + recv)
        self.rpc_timeout = rpc_timeout
        #: transport-failure retries per RPC (0 = single attempt)
        self.rpc_retries = rpc_retries
        #: base of the capped exponential retry backoff (x0.5–1.0 jitter)
        self.rpc_backoff = rpc_backoff

    def _rpc(self, message: dict) -> Any:
        """One control-plane round trip, retried on transport faults.

        Retries are safe for every verb: reads are idempotent by nature and
        the mutating verbs (``submit``/``serve``) carry an idempotency key
        the daemon replays, so a retry after a lost *reply* cannot
        double-enqueue.  Backoff is capped exponential with jitter so a
        fleet of recovering clients doesn't stampede the daemon."""
        last_exc: Optional[Exception] = None
        for attempt in range(self.rpc_retries + 1):
            if attempt and self.rpc_backoff > 0:
                delay = min(2.0, self.rpc_backoff * (2 ** (attempt - 1)))
                time.sleep(delay * (0.5 + 0.5 * random.random()))
            try:
                sock = connect(self.host, self.port, timeout=self.rpc_timeout)
                try:
                    sock.settimeout(self.rpc_timeout)
                    send_data(sock, {**message, "secret": self.secret})
                    if _chaos.enabled():
                        # lost-reply injection: the request reached the
                        # daemon, the reply never reaches us — the exact
                        # scenario idempotency keys exist for
                        _chaos.fault("rpc_reply")
                    return recv_data(sock)
                finally:
                    sock.close()
            except (ConnectionError, TimeoutError, ValueError, OSError) as e:
                last_exc = e
        assert last_exc is not None
        raise last_exc

    def submit(self) -> str:
        # one idempotency key per logical submit, constant across _rpc's
        # transport retries: the daemon replays the original reply instead
        # of enqueuing a second job
        reply = self._rpc({"action": "submit", "script": self.script,
                           "args": self.args,
                           "idempotency": uuid.uuid4().hex})
        if reply.get("status") != "queued":
            raise RuntimeError(f"submission rejected: {reply}")
        self.job_id = reply["job_id"]
        return self.job_id

    def status(self) -> dict:
        if self.job_id is None:
            raise RuntimeError("job not submitted")
        return self._rpc({"action": "status", "job_id": self.job_id})

    def serve(self, flags: Optional[dict] = None) -> str:
        """Host this client's script as a long-running serving job
        (``serve`` verb).  The script should build a
        :class:`distkeras_tpu_torch.serving.ServingEngine`, install the
        ``/generate`` endpoint, and block; once up, ``status()['http']``
        is its flightdeck address (serve jobs always get an exporter).

        ``flags`` (a JSON-safe dict of engine knobs — ``prefill_buckets``,
        ``spec_tokens``, ``num_slots``, ...) is delivered to the job as the
        ``DISTKERAS_SERVE_FLAGS`` env var; the script reads it back with
        :func:`distkeras_tpu_torch.serving.serve_flags`, so one serving script
        can be deployed under many engine configurations."""
        msg = {"action": "serve", "script": self.script, "args": self.args,
               "idempotency": uuid.uuid4().hex}
        if flags is not None:
            msg["flags"] = dict(flags)
        reply = self._rpc(msg)
        if reply.get("status") != "serving":
            raise RuntimeError(f"serve rejected: {reply}")
        self.job_id = reply["job_id"]
        return self.job_id

    def stop_serving(self, job_id: Optional[str] = None) -> dict:
        """Terminate a serving job (``stop_serving`` verb); defaults to
        this client's job."""
        jid = job_id or self.job_id
        if jid is None:
            raise RuntimeError("no serving job to stop")
        return self._rpc({"action": "stop_serving", "job_id": jid})

    def serving_address(self, timeout: float = 30.0,
                        poll: float = 0.2) -> str:
        """Block until the serving job's flightdeck exporter is
        discoverable and return its ``host:port``."""
        deadline = time.monotonic() + timeout
        polls = 0
        while time.monotonic() < deadline:
            st = self.status()
            polls += 1
            if st.get("status") not in ("serving",):
                raise RuntimeError(f"serving job is {st.get('status')}: "
                                   f"{st.get('output', '')[-2000:]}")
            addr = st.get("http")
            if addr:
                return addr
            time.sleep(poll)
        # polls may be 0 (timeout <= 0): the message must not read from the
        # loop-local status — previously an UnboundLocalError
        raise TimeoutError(
            f"serving job {self.job_id} published no address after {polls} "
            f"poll(s) in {timeout}s")

    def serve_tier(self, replicas: int, flags: Optional[dict] = None,
                   max_respawns: int = 3) -> str:
        """Host ``replicas`` copies of this client's script as one
        supervised serving tier (``serve_tier`` verb).  Each replica is an
        ordinary serve job; the daemon respawns crashed replicas (up to
        ``max_respawns`` across the tier) from its runner loop's idle
        wakeups.  Returns the tier id (also stored on ``self.tier_id``);
        front the replicas with
        :class:`~distkeras_tpu_torch.serving.ServingTier` over
        :class:`~distkeras_tpu_torch.serving.HttpReplica` handles built from
        :meth:`tier_addresses`."""
        msg = {"action": "serve_tier", "script": self.script,
               "args": self.args, "replicas": int(replicas),
               "max_respawns": int(max_respawns),
               "idempotency": uuid.uuid4().hex}
        if flags is not None:
            msg["flags"] = dict(flags)
        reply = self._rpc(msg)
        if reply.get("status") != "serving":
            raise RuntimeError(f"serve_tier rejected: {reply}")
        self.tier_id = reply["tier_id"]
        return self.tier_id

    def tier_status(self, tier_id: Optional[str] = None) -> dict:
        """Per-replica status of a serving tier (``tier_status`` verb):
        ``{"status": "ok", "replicas": [{"job_id", "status", "http"}, ...],
        "serving": N, "respawns": n, "max_respawns": cap}``."""
        tid = tier_id or self.tier_id
        if tid is None:
            raise RuntimeError("no tier to query")
        return self._rpc({"action": "tier_status", "tier_id": tid})

    def stop_tier(self, tier_id: Optional[str] = None) -> dict:
        """Terminate every replica of a serving tier (``stop_tier`` verb);
        defaults to this client's tier."""
        tid = tier_id or self.tier_id
        if tid is None:
            raise RuntimeError("no tier to stop")
        return self._rpc({"action": "stop_tier", "tier_id": tid})

    def online_loop(self, replicas: int, trainer_script: str,
                    trainer_args: Optional[list] = None,
                    flags: Optional[dict] = None,
                    capture_dir: Optional[str] = None,
                    checkpoint_dir: Optional[str] = None,
                    max_respawns: int = 3) -> str:
        """Deploy the whole serve->train loop on the daemon's fleet
        (``online_loop`` verb): this client's script as ``replicas``
        supervised serving jobs plus ``trainer_script`` as the co-scheduled
        retraining job, wired together through a shared capture directory
        and checkpoint directory (daemon-chosen under its workdir unless
        given).  Every spawned process sees ``DISTKERAS_ONLINE_ID`` /
        ``DISTKERAS_CAPTURE_DIR`` / ``DISTKERAS_CKPT_DIR`` in its
        environment; the serve script should install its ``/generate``
        endpoint with a :class:`~distkeras_tpu_torch.online.TrafficLog` on
        the capture dir and watch the checkpoint dir for hot-swaps, the
        trainer script should run a
        :class:`~distkeras_tpu_torch.online.WindowScheduler` over the same
        pair.  One idempotency key rides every retry of the call, so a lost
        reply never deploys twice.  Returns the online id (also stored on
        ``self.online_id``; the tier id lands on ``self.tier_id``)."""
        msg: dict = {"action": "online_loop", "script": self.script,
                     "args": self.args, "replicas": int(replicas),
                     "trainer_script": trainer_script,
                     "trainer_args": list(trainer_args or []),
                     "max_respawns": int(max_respawns),
                     "idempotency": uuid.uuid4().hex}
        if flags is not None:
            msg["flags"] = dict(flags)
        if capture_dir is not None:
            msg["capture_dir"] = capture_dir
        if checkpoint_dir is not None:
            msg["checkpoint_dir"] = checkpoint_dir
        reply = self._rpc(msg)
        if reply.get("status") != "online":
            raise RuntimeError(f"online_loop rejected: {reply}")
        self.online_id = reply["online_id"]
        self.tier_id = reply["tier_id"]
        return self.online_id

    def online_status(self, online_id: Optional[str] = None) -> dict:
        """Progress view of an online deployment (``online_status`` verb):
        serving replica statuses, trainer job status, and the loop's window
        and checkpoint-step counts read straight off the shared
        directories — ``{"status": "ok", "replicas": [...], "serving": N,
        "trainer": {"job_id", "status"}, "windows_published": n,
        "steps_published": m, "placement": {...}, ...}``."""
        oid = online_id or self.online_id
        if oid is None:
            raise RuntimeError("no online deployment to query")
        return self._rpc({"action": "online_status", "online_id": oid})

    def stop_online(self, online_id: Optional[str] = None) -> dict:
        """Tear down an online deployment — every serving replica plus the
        trainer job (``stop_online`` verb); defaults to this client's."""
        oid = online_id or self.online_id
        if oid is None:
            raise RuntimeError("no online deployment to stop")
        return self._rpc({"action": "stop_online", "online_id": oid})

    def tier_addresses(self, timeout: float = 30.0,
                       poll: float = 0.2) -> list:
        """Block until every tier replica has published its flightdeck
        address; returns ``["host:port", ...]`` ordered by replica slot."""
        deadline = time.monotonic() + timeout
        st: dict = {}
        while time.monotonic() < deadline:
            st = self.tier_status()
            reps = st.get("replicas", [])
            if reps and all(r.get("status") == "serving" and r.get("http")
                            for r in reps):
                return [r["http"] for r in reps]
            time.sleep(poll)
        raise TimeoutError(
            f"tier {self.tier_id} not fully addressable after {timeout}s: "
            f"{st}")

    def metrics(self, job_id: Optional[str] = None) -> dict:
        """Scrape the daemon's telemetry registry (``metrics`` verb):
        ``{"status": "ok", "enabled": ..., "prometheus": <text>,
        "snapshot": {...}, "fleet": {"jobs": N, "snapshot": <merged>,
        "prometheus": <text>}}`` — ``fleet`` is the whole-fleet merge of
        every finished job's metric snapshot.  With a ``job_id`` (defaults
        to this client's submitted job) the reply also carries ``live``:
        that job's ``/vars`` scraped through its flightdeck exporter while
        it is still running (``None`` when flightdeck is off)."""
        msg: dict = {"action": "metrics"}
        jid = job_id or self.job_id
        if jid:
            msg["job_id"] = jid
        return self._rpc(msg)

    def aggregate(self) -> dict:
        """Fleet-wide metric merge only (``aggregate`` verb): counters
        summed, gauges max'd (mean alongside), histograms merged on their
        bounded-bucket representation."""
        return self._rpc({"action": "aggregate"})

    def slo_status(self) -> dict:
        """Fleet SLO view (``slo_status`` verb): ``{"engines": {"<owner>:
        <source>": <status>}, "firing": [...], "firing_count": N,
        "timeseries": <merged rollup>}`` — every live job's ``/slo``
        engines plus the daemon's own, and the jobs' rollup rings merged
        onto one time axis.  ``dkmon status --daemon host:port`` renders
        this; ``dkmon check`` gates on ``firing_count``."""
        return self._rpc({"action": "slo_status"})

    def ledger_status(self) -> dict:
        """Fleet per-tenant accounting view (``ledger_status`` verb): every
        live job's ``/ledger`` table plus the daemon's own, merged
        tenant-wise with shares recomputed over the merged totals.  ``dkmon
        top --daemon host:port`` renders this."""
        return self._rpc({"action": "ledger_status"})

    def wait(self, timeout: float = 300.0, poll: float = 0.2) -> dict:
        # monotonic, not wall-clock: an NTP step mid-poll must not shrink or
        # stretch the deadline (dklint DK106)
        deadline = time.monotonic() + timeout
        st: Optional[dict] = None
        polls = 0
        while time.monotonic() < deadline:
            st = self.status()
            polls += 1
            if st["status"] in ("finished", "failed", "timeout"):
                return st
            time.sleep(poll)
        # with timeout <= 0 the loop never runs; st stays None (previously
        # this raise hit an UnboundLocalError)
        last = st["status"] if st is not None else "unpolled"
        raise TimeoutError(
            f"job {self.job_id} still {last} after {polls} poll(s) in "
            f"{timeout}s")
