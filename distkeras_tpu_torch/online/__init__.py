"""Online learning loop — close the serve→train circle on one fleet.

The port of :mod:`distkeras_tpu.online`.  The train→serve half is verified
checkpoint publication plus the serving tier's rolling hot-swap
(:mod:`distkeras_tpu_torch.serving.tier`); this package adds the
serve→train half, so one fleet serves, captures what it served, retrains
on it, and hot-swaps to the result — continuously, and under fault
injection:

* :class:`~distkeras_tpu_torch.online.capture.TrafficLog` — bounded
  in-memory ring over served generations, journal-backed for bitwise crash
  resume, rotated into :class:`~distkeras_tpu_torch.datapipe.MemmapSource`-
  compatible ``.npy`` replay shards published atomically with per-window
  manifests (tmp + fsync + ``os.replace``, per-file sha256 — the checkpoint
  discipline applied to data);
* :class:`~distkeras_tpu_torch.online.capture.SamplingPolicy` — deterministic
  sampling rate, content filter, and per-tenant window quotas so one hot
  client cannot dominate a retrain window;
* :class:`~distkeras_tpu_torch.online.scheduler.WindowScheduler` — polls for
  published windows and closes each into retrain → verified checkpoint
  publish (+ :class:`~distkeras_tpu_torch.datapipe.DataState` sidecar) → the
  serving tier's watcher rolls the fleet, zero dropped requests;
* :func:`~distkeras_tpu_torch.online.scheduler.plan_placement` —
  capacity-aware trainer/replica placement over live fleet leases, recorded
  by the daemon's ``online_loop`` / ``online_status`` / ``stop_online``
  verbs (:mod:`distkeras_tpu_torch.job_deployment`);
* :func:`~distkeras_tpu_torch.online.capture.online_metrics` — the
  ``online_*`` flightdeck schema (window lag, samples ingested /
  dropped-by-quota, swap age), the JAX package's names.

Wire it up in-process::

    from distkeras_tpu_torch import online, serving
    log = online.TrafficLog(capture_dir, window_samples=256,
                            policy=online.SamplingPolicy(tenant_quota=64))
    serving.install_tier_endpoint(tier, traffic_log=log)     # capture
    sched = online.WindowScheduler(capture_dir, train_fn, ckpt_dir)
    tier.watch_checkpoints(ckpt_dir, loader)                 # hot-swap
    sched.start()                                            # retrain

or as a daemon deployment: ``Job.online_loop(replicas=3, ...)`` spawns the
serving tier and the scheduler loop as co-scheduled jobs on one fleet.
"""

from distkeras_tpu_torch.online.capture import (
    SamplingPolicy,
    TrafficLog,
    load_window_manifest,
    online_metrics,
    published_windows,
    verify_window,
    window_manifest_path,
    window_source,
)
from distkeras_tpu_torch.online.scheduler import WindowScheduler, plan_placement

__all__ = [
    "SamplingPolicy",
    "TrafficLog",
    "WindowScheduler",
    "load_window_manifest",
    "online_metrics",
    "plan_placement",
    "published_windows",
    "verify_window",
    "window_manifest_path",
    "window_source",
]
