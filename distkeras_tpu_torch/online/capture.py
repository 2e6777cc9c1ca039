"""Traffic capture — the serve→train half of the online loop.

The port of :mod:`distkeras_tpu.online.capture`, host code copied: the
same admission draws, journal, sidecar, shard bytes and manifests, so the
same (request, result) records give byte-identical window shards and
equal manifests in both packages, and each package's
:func:`verify_window` accepts the other's directory.

:class:`TrafficLog` hangs off the serving frontend's ``/generate`` path, or
the serving tier's router, and turns completed generations back into
training data: each admitted prompt+response becomes one fixed-width int32
token row in a bounded in-memory ring, and every ``window_samples``
admitted rows the ring rotates into a pair of
:class:`~distkeras_tpu_torch.datapipe.MemmapSource`-compatible ``.npy``
shards published with a per-window manifest — the same tmp + fsync +
``os.replace`` verified-publication discipline as checkpoint manifests, so
a cross-process :class:`WindowScheduler` polling the directory can never
see a torn shard.

Admission is governed by a :class:`SamplingPolicy`: a deterministic sampling
rate (seeded per-sequence-number, no RNG state to checkpoint), an optional
content filter, a per-tenant window quota so one hot client cannot dominate
a retrain window, and an optional per-tenant *rate* policy keyed off the
accounting ledger's rolling usage
(:mod:`distkeras_tpu_torch.telemetry.accounting`) — tenants above the target
tokens-or-samples/sec are deterministically thinned back to it through the
same splitmix admit path.

Crash safety is journal-based: every *offered* sample — admitted or dropped,
with its decision — appends one line to the current window's journal before
the ring mutates, and a :class:`~distkeras_tpu_torch.datapipe.DataState`
sidecar (``capture_state.json``) is republished atomically at every
rotation.  A killed capture therefore resumes **bitwise**: replaying the
journal restores the exact pending rows, per-tenant counts, drop tallies,
and sequence cursor, and an interrupted rotation (shards landed, manifest
missing — the chaos ``kill_rotate`` window) is completed idempotently on
resume, so no sample is ever lost or duplicated.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from distkeras_tpu_torch import chaos as _chaos
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.datapipe.source import MemmapSource, atomic_write_npy
from distkeras_tpu_torch.datapipe.state import DataState

__all__ = [
    "SamplingPolicy",
    "TrafficLog",
    "load_window_manifest",
    "online_metrics",
    "published_windows",
    "verify_window",
    "window_manifest_path",
    "window_source",
]

_STATE_FILE = "capture_state.json"


def online_metrics(registry=None) -> dict:
    """Get-or-create the online loop's instruments (default: process-global
    registry).  One canonical home for names/help so capture, scheduler,
    the golden test, and the CI loop smoke assert the same schema."""
    if registry is None:
        from distkeras_tpu_torch.telemetry.metrics import metrics as registry
    return {
        "ingested": registry.counter(
            "online_samples_ingested_total",
            help="served samples admitted into the capture window ring",
        ),
        "dropped": registry.counter(
            "online_samples_dropped_total",
            help="served samples dropped at capture admission "
                 "(sampling rate, content filter, or tenant quota)",
        ),
        "quota_drops": registry.counter(
            "online_quota_drops_total",
            help="served samples dropped by the per-tenant window quota",
        ),
        "rate_drops": registry.counter(
            "online_rate_drops_total",
            help="served samples dropped by the per-tenant rate policy "
                 "(rolling ledger rate above the configured tenant_rate)",
        ),
        "capture_errors": registry.counter(
            "online_capture_errors_total",
            help="capture hook failures swallowed at the serving path "
                 "(the response still left)",
        ),
        "windows_published": registry.counter(
            "online_windows_published_total",
            help="capture windows rotated into published replay shards",
        ),
        "windows_trained": registry.counter(
            "online_windows_trained_total",
            help="published windows retrained into a verified checkpoint",
        ),
        "retrain_failures": registry.counter(
            "online_retrain_failures_total",
            help="window retrains that raised and were retried",
        ),
        "window_lag_seconds": registry.gauge(
            "online_window_lag_seconds",
            help="age of the oldest published-but-untrained window",
        ),
        "swap_age_seconds": registry.gauge(
            "online_swap_age_seconds",
            help="seconds since the last retrained checkpoint published "
                 "(freshness of what the serving fleet hot-swaps to)",
        ),
        "retrain_seconds": registry.histogram(
            "online_retrain_seconds",
            help="wall seconds per window retrain (train step + verified "
                 "checkpoint publish)",
        ),
    }


class SamplingPolicy:
    """Admission policy for captured traffic.

    ``rate``: fraction of offered samples kept, decided by a *deterministic*
    per-sequence-number draw (seeded splitmix-style hash, no RNG object) —
    the decision for sample ``seq`` is a pure function of ``(seed, seq)``,
    so a resumed capture re-derives identical decisions without
    checkpointing generator state.  ``filter``: optional
    ``f(prompt, tokens) -> bool`` content gate (False drops).
    ``tenant_quota``: max admitted samples any one tenant gets per window —
    the fairness backstop that keeps a hot client from flooding a retrain
    window (dropped-by-quota is separately counted and surfaced).
    ``tenant_rate``: a per-tenant *rate* target in ``rate_unit``/sec
    (``"samples"`` or ``"tokens"``), judged against the accounting
    ``ledger``'s rolling usage
    (:meth:`~distkeras_tpu_torch.telemetry.accounting.TenantLedger.rolling_rate`):
    a tenant running above the target is thinned with admission probability
    ``target / observed`` through a decorrelated splitmix draw — the same
    stateless (seed, seq) determinism as ``rate``, so resume re-derives the
    decisions given the same observed rates.  Without a ``ledger`` (or for
    a tenant it has never seen) the rate policy admits — no usage signal,
    no throttle.
    """

    def __init__(self, rate: float = 1.0,
                 tenant_quota: Optional[int] = None,
                 filter: Optional[Callable] = None,  # noqa: A002 — API word
                 seed: int = 0,
                 tenant_rate: Optional[float] = None,
                 rate_unit: str = "samples",
                 ledger=None):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        if tenant_quota is not None and tenant_quota < 1:
            raise ValueError(f"tenant_quota must be >= 1, got {tenant_quota}")
        if tenant_rate is not None and tenant_rate <= 0:
            raise ValueError(f"tenant_rate must be > 0, got {tenant_rate}")
        if rate_unit not in ("samples", "tokens"):
            raise ValueError(
                f"rate_unit must be 'samples' or 'tokens', got {rate_unit!r}")
        self.rate = float(rate)
        self.tenant_quota = None if tenant_quota is None else int(tenant_quota)
        self.filter = filter
        self.seed = int(seed)
        self.tenant_rate = None if tenant_rate is None else float(tenant_rate)
        self.rate_unit = rate_unit
        self.ledger = ledger

    def _uniform(self, seq: int) -> float:
        # splitmix64 finalizer over (seed, seq): uniform enough for a
        # sampling gate, stateless, and bit-stable across platforms
        x = ((self.seed << 32) ^ seq) & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
        return (x >> 11) / float(1 << 53)

    def _keep(self, seq: int) -> bool:
        return self._uniform(seq) < self.rate

    def admit(self, seq: int, tenant: str, tenant_count: int,
              prompt, tokens) -> Optional[str]:
        """``None`` to admit, else the drop reason (``"sampled"``,
        ``"filtered"``, ``"rate"``, ``"quota"``).  ``tenant_count`` is the
        tenant's admitted-sample count in the current window."""
        if self.rate < 1.0 and not self._keep(seq):
            return "sampled"
        if self.filter is not None and not self.filter(prompt, tokens):
            return "filtered"
        if self.tenant_rate is not None and self.ledger is not None:
            unit = "tokens" if self.rate_unit == "tokens" else "requests"
            observed = self.ledger.rolling_rate(tenant, unit=unit)
            if observed > self.tenant_rate:
                # thin to the target: admit with p = target/observed; the
                # xor decorrelates this draw from the sampling-rate draw so
                # the two gates stay independent per sequence number
                draw = self._uniform(seq ^ 0x9E3779B97F4A7C15)
                if draw >= self.tenant_rate / observed:
                    return "rate"
        if self.tenant_quota is not None and tenant_count >= self.tenant_quota:
            return "quota"
        return None


def window_manifest_path(directory: str, window: int) -> str:
    """The ``window_<n>.manifest.json`` publication record — present iff
    the window's shards are complete and durable."""
    return os.path.join(os.path.abspath(directory),
                        f"window_{int(window):06d}.manifest.json")


def _shard_paths(directory: str, window: int) -> tuple:
    directory = os.path.abspath(directory)
    return (os.path.join(directory, f"window_{int(window):06d}.features.npy"),
            os.path.join(directory, f"window_{int(window):06d}.labels.npy"))


def published_windows(directory: str) -> List[int]:
    """Sorted indices of fully published windows (manifest present)."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return out
    for name in names:
        if name.startswith("window_") and name.endswith(".manifest.json"):
            digits = name[len("window_"):-len(".manifest.json")]
            if digits.isdigit():
                out.append(int(digits))
    return sorted(out)


def load_window_manifest(directory: str, window: int) -> dict:
    with open(window_manifest_path(directory, window), encoding="utf-8") as fh:
        return json.load(fh)


def verify_window(directory: str, window: int) -> Optional[str]:
    """Re-verify a published window's shard bytes against the manifest
    digests (the same full-hash gate the checkpoint watcher applies at swap
    time).  Returns a human-readable failure, or ``None`` when clean."""
    import hashlib

    try:
        manifest = load_window_manifest(directory, window)
    except (OSError, ValueError) as e:
        return f"manifest unreadable: {e}"
    for rel, meta in manifest.get("files", {}).items():
        path = os.path.join(os.path.abspath(directory), rel)
        try:
            size = os.path.getsize(path)
        except OSError:
            return f"{rel}: missing"
        if size != meta["bytes"]:
            return f"{rel}: {size} bytes, manifest says {meta['bytes']}"
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != meta["sha256"]:
            return f"{rel}: sha256 mismatch"
    return None


def window_source(directory: str, window: int, **kwargs) -> MemmapSource:
    """A :class:`MemmapSource` over one published window's shards.
    Capture shards are already per-host, so sharding defaults off."""
    feats, labels = _shard_paths(directory, window)
    kwargs.setdefault("shard", False)
    return MemmapSource(feats, labels, **kwargs)


class TrafficLog:
    """Bounded capture ring over served generations, rotated into published
    replay windows.

    ``record(request, result)`` offers one completed generation; admitted
    samples become ``prompt + tokens`` rows padded/truncated to ``max_len``
    (features: ``[n, max_len]`` int32; labels: ``[n]`` int32 true lengths,
    the loss mask for next-token retraining).  Constructing a TrafficLog on
    a directory with prior capture state **resumes** it — see the module
    docstring for the journal/sidecar protocol.

    Thread-safe: the serving frontend calls ``record`` from per-request
    handler threads.
    """

    def __init__(self, directory: str, *, window_samples: int = 64,
                 max_len: int = 64, pad_id: int = 0,
                 policy: Optional[SamplingPolicy] = None,
                 registry=None):
        if window_samples < 1:
            raise ValueError(f"window_samples must be >= 1, got {window_samples}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.directory = os.path.abspath(directory)
        self.window_samples = int(window_samples)
        self.max_len = int(max_len)
        self.pad_id = int(pad_id)
        self.policy = policy or SamplingPolicy()
        self._metrics = (online_metrics(registry)
                         if registry is not None or telemetry.enabled()
                         else None)
        # reentrant: record/flush/_resume hold it across _rotate, which
        # re-acquires (keeping every mutation lexically under the lock)
        self._lock = threading.RLock()
        self._pending: List[tuple] = []  # (seq, tenant, row, length)
        self._tenant_counts: Dict[str, int] = {}
        self._dropped: Dict[str, int] = {}
        self._window = 0
        self._seq = 0
        self._journal = None
        os.makedirs(self.directory, exist_ok=True)
        self._resume()

    # ------------------------------------------------------------- resume

    def _journal_path(self, window: int) -> str:
        return os.path.join(self.directory, f"journal_{int(window):06d}.jsonl")

    def _resume(self) -> None:
        """Roll state forward from disk: published manifests are ground
        truth for completed windows, the sidecar for cumulative counters,
        and the newest journal for pending rows and unaccounted drops.
        Every crash window of the rotation sequence (shards → manifest →
        sidecar → journal rollover) resumes to the same state the
        uninterrupted capture would have reached — no sample lost, none
        duplicated."""
        with self._lock:
            state_path = os.path.join(self.directory, _STATE_FILE)
            state_window = 0
            if os.path.exists(state_path):
                with open(state_path, encoding="utf-8") as fh:
                    state = json.load(fh)
                state_window = int(state.get("window", 0))
                self._seq = int(state.get("next_seq", 0))
                self._dropped = {k: int(v)
                                 for k, v in (state.get("dropped") or {}).items()}
            self._window = state_window
            published = published_windows(self.directory)
            covered = -1  # newest seq owned by a published window
            if published and published[-1] >= state_window:
                # crashed after manifest publish but before the sidecar update:
                # the manifest wins — its rows are done, but the journal still
                # holds that window's drop decisions (not yet folded into the
                # sidecar) and any carry-over rows past the manifest boundary
                manifest = load_window_manifest(self.directory, published[-1])
                covered = int(manifest["last_seq"])
                self._window = published[-1] + 1
                self._seq = max(self._seq, covered + 1)
            # journals strictly older than the sidecar's window are fully
            # accounted (rows published, drops folded in): replaying them
            # would double-count
            for window in range(state_window):
                try:
                    os.remove(self._journal_path(window))
                except FileNotFoundError:
                    pass
            # replay the newest journal: pending rows (skipping any a published
            # manifest already owns), tenant counts, drop tallies, seq cursor
            replay = self._journal_path(state_window)
            if os.path.exists(replay):
                with open(replay, encoding="utf-8") as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            break  # torn tail line from a mid-write kill
                        seq = int(rec["seq"])
                        self._seq = max(self._seq, seq + 1)
                        reason = rec.get("drop")
                        if reason is not None:
                            self._dropped[reason] = self._dropped.get(reason, 0) + 1
                            continue
                        if seq <= covered:
                            continue  # already in a published shard
                        tenant = str(rec.get("tenant", ""))
                        row = np.asarray(rec["row"], dtype=np.int32)
                        self._pending.append((seq, tenant, row, int(rec["len"])))
                        self._tenant_counts[tenant] = \
                            self._tenant_counts.get(tenant, 0) + 1
            current = self._journal_path(self._window)
            if self._window != state_window:
                # the replayed remainder belongs to the advanced window's
                # journal; rewrite it there, then retire the stale journal
                self._journal = open(current, "w", encoding="utf-8")
                for seq, tenant, row, length in self._pending:
                    self._journal_write({"seq": seq, "tenant": tenant,
                                         "row": [int(t) for t in row],
                                         "len": length})
                self._write_state()
                if replay != current:
                    try:
                        os.remove(replay)
                    except FileNotFoundError:
                        pass
            else:
                self._journal = open(current, "a", encoding="utf-8")
            # an interrupted rotation (full pending ring, shards maybe on disk,
            # manifest missing) completes now — idempotently, same bytes
            while len(self._pending) >= self.window_samples:
                self._rotate()

    # ------------------------------------------------------------- capture

    def record(self, request, result) -> bool:
        """Offer one completed generation (a
        :class:`~distkeras_tpu_torch.serving.GenerateRequest` and its
        :class:`~distkeras_tpu_torch.serving.GenerateResult`); returns whether it
        was admitted into the current window."""
        prompt = [int(t) for t in request.prompt]
        tokens = [int(t) for t in result.tokens]
        tenant = str(getattr(request, "tenant", "") or "")
        with self._lock:
            seq = self._seq
            self._seq += 1
            reason = self.policy.admit(
                seq, tenant, self._tenant_counts.get(tenant, 0),
                prompt, tokens)
            if reason is not None:
                self._dropped[reason] = self._dropped.get(reason, 0) + 1
                self._journal_write({"seq": seq, "tenant": tenant,
                                     "drop": reason})
                if self._metrics is not None:
                    self._metrics["dropped"].inc()
                    if reason == "quota":
                        self._metrics["quota_drops"].inc()
                    elif reason == "rate":
                        self._metrics["rate_drops"].inc()
                return False
            row = np.full(self.max_len, self.pad_id, dtype=np.int32)
            merged = (prompt + tokens)[:self.max_len]
            row[:len(merged)] = merged
            self._journal_write({"seq": seq, "tenant": tenant,
                                 "row": [int(t) for t in row],
                                 "len": len(merged)})
            self._pending.append((seq, tenant, row, len(merged)))
            self._tenant_counts[tenant] = self._tenant_counts.get(tenant, 0) + 1
            if self._metrics is not None:
                self._metrics["ingested"].inc()
            if len(self._pending) >= self.window_samples:
                self._rotate()
            return True

    def _journal_write(self, rec: dict) -> None:
        self._journal.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._journal.flush()

    # ------------------------------------------------------------ rotation

    def _rotate(self) -> int:
        """Publish the pending ring head as window ``self._window``
        (re-acquires the reentrant lock, so callers may already hold it).
        Order: shards (atomic each) → chaos ``window_rotate`` site →
        manifest (atomic) → sidecar (atomic) → journal rollover.  A kill
        at the chaos site leaves shards without a manifest; resume replays
        the journal and re-runs this function, producing byte-identical
        shards — publication is idempotent."""
        import hashlib

        with self._lock:
            batch = self._pending[:self.window_samples]
            window = self._window
            features = np.stack([row for _, _, row, _ in batch])
            labels = np.asarray([length for _, _, _, length in batch],
                                dtype=np.int32)
            f_path, l_path = _shard_paths(self.directory, window)
            atomic_write_npy(f_path, features)
            atomic_write_npy(l_path, labels)
            # the journal must be durable before the manifest claims the window:
            # a resume after the chaos site below replays it to re-publish
            os.fsync(self._journal.fileno())
            if _chaos.enabled():
                _chaos.fault("window_rotate")
            files = {}
            for path in (f_path, l_path):
                h = hashlib.sha256()
                with open(path, "rb") as fh:
                    for chunk in iter(lambda: fh.read(1 << 20), b""):
                        h.update(chunk)
                files[os.path.basename(path)] = {
                    "sha256": h.hexdigest(), "bytes": os.path.getsize(path)}
            tenants: Dict[str, int] = {}
            for _, tenant, _, _ in batch:
                tenants[tenant] = tenants.get(tenant, 0) + 1
            _atomic_write_json(window_manifest_path(self.directory, window), {
                "version": 1,
                "window": window,
                "samples": len(batch),
                "first_seq": batch[0][0],
                "last_seq": batch[-1][0],
                "max_len": self.max_len,
                "tenants": tenants,
                "files": files,
            })
            # window closed: advance the cursor, then make the new position
            # durable before fresh samples can land in the next journal
            self._pending = self._pending[self.window_samples:]
            self._tenant_counts = {}
            for _, tenant, _, _ in self._pending:
                self._tenant_counts[tenant] = self._tenant_counts.get(tenant, 0) + 1
            self._window = window + 1
            self._write_state()
            old = self._journal
            self._journal = open(self._journal_path(self._window), "a",
                                 encoding="utf-8")
            # carry-over samples (admitted past the window boundary) belong to
            # the new journal so resume finds them there
            for seq, tenant, row, length in self._pending:
                self._journal_write({"seq": seq, "tenant": tenant,
                                     "row": [int(t) for t in row],
                                     "len": length})
            old.close()
            try:
                os.remove(self._journal_path(window))
            except FileNotFoundError:
                pass
            if self._metrics is not None:
                self._metrics["windows_published"].inc()
            return window

    def _write_state(self) -> None:
        _atomic_write_json(os.path.join(self.directory, _STATE_FILE), {
            "version": 1,
            "window": self._window,
            "next_seq": self._seq,
            "dropped": dict(self._dropped),
            "data_state": DataState(epoch=self._window,
                                    block_cursor=self._seq).to_json(),
        })

    # ------------------------------------------------------------- control

    def flush(self) -> Optional[int]:
        """Force-rotate a partial window (shutdown path: trailing samples
        still become a training window).  Returns the published window
        index, or ``None`` when nothing was pending."""
        with self._lock:
            if not self._pending:
                return None
            saved = self.window_samples
            self.window_samples = len(self._pending)
            try:
                return self._rotate()
            finally:
                self.window_samples = saved

    def close(self) -> None:
        with self._lock:
            self._write_state()
            if self._journal is not None:
                self._journal.close()
                self._journal = None

    # ---------------------------------------------------------- inspection

    @property
    def window(self) -> int:
        """Index the *next* rotation will publish."""
        with self._lock:
            return self._window

    @property
    def next_seq(self) -> int:
        with self._lock:
            return self._seq

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def dropped(self) -> Dict[str, int]:
        """Cumulative drop counts by reason."""
        with self._lock:
            return dict(self._dropped)


def _atomic_write_json(path: str, obj) -> None:
    # same tmp+fsync+replace+dir-fsync discipline as checkpoint manifests;
    # duplicated locally so the capture path never imports the (torch-
    # heavy) checkpoint module
    from distkeras_tpu_torch.datapipe.source import _fsync_dir

    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
