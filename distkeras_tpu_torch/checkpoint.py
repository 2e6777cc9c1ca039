"""Checkpoint / resume — mid-training persistence of the training state.

The port of :mod:`distkeras_tpu.checkpoint`.  The full training state —
center params, per-worker local replicas, optimizer state, rule state
(clocks, anchors), model state, every worker's dropout generator state and
the epoch counter — is written, so an interrupted run resumes bitwise
(given the same data order seed).

**Payload.**  Orbax is JAX's, so the payload format is the port's own: a
``step_<n>`` directory holding one ``<field>.npz`` per ``TrainState`` field
(leaves ``leaf_0, leaf_1, ...`` in ``jax.tree.flatten``'s order, as
:mod:`distkeras_tpu_torch.utils.serialization` writes them, bfloat16 as its
``uint16`` bits; a generator's state is its ``get_state()`` bytes) and a
``tree.json`` describing the trees, dtypes and worker count.  No pickle.

**Saves are asynchronous**, as in the JAX package, but the engine updates
its state in place, so :func:`save_checkpoint` takes its host snapshot (a
finished copy off the card) before it returns; only the file writes, the
hashing and the publication run on a writer thread.
:func:`wait_until_finished` (called by the trainers at the end of the epoch
loop, and before any restore) waits for them and re-raises a failed save.

**Verified publication**, the JAX package's protocol and JSON: a step is
*published* — visible to restores, watchers and GC — only once a
``step_<n>.manifest.json`` commit record (``version``, ``step``, ``run_id``
and per-file ``sha256`` and ``bytes``) sits next to its directory, written
tmp + fsync + ``os.replace`` (+ parent-dir fsync) after the directory was
renamed into place.  :func:`verify_checkpoint` checks a published step
against its manifest (``fast`` = existence + sizes, ``full`` = digests);
every restore verifies first, renames a failing step aside
(``step_<n>.corrupt``), and falls back to the newest step that verifies.
Directories without a manifest are *unverified*: never restored, never
GC'd, never quarantined.  The JAX package's ``verify_checkpoint`` accepts a
step this module published.  The JAX package's fault-injection hooks
(``chaos``) come with ROADMAP Queue A item 18.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.utils.pytree import tree_map
from distkeras_tpu_torch.utils.serialization import _flatten, _unflatten

__all__ = [
    "save_checkpoint", "restore_checkpoint", "restore_center",
    "model_state_worker_mean", "latest_step", "worker_mean",
    "checkpoint_num_workers", "CheckpointManager", "CheckpointWatcher",
    "save_data_state", "restore_data_state", "wait_until_finished",
    "manifest_path", "write_manifest", "verify_checkpoint", "verify_failure",
    "quarantine_step", "committed_steps",
]

#: the ``TrainState`` fields in the JAX dataclass's (= ``tree.flatten``'s) order
FIELDS = ("center_params", "center_rule", "local_params", "opt_state", "model_state",
          "rule_local", "rng", "epoch")
_TREE_FILE = "tree.json"

# ------------------------------------------------------ verified publication

#: (manifest path) -> (manifest stat, per-file stats) recorded when a step
#: passed a FULL digest verify, so one resume sequence re-resolving the same
#: step does not re-hash it; any size/mtime change drops the memo.
_VERIFIED: dict = {}

# one writer thread: saves land in the order they were made
_WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint-writer")
_INFLIGHT: list = []
_INFLIGHT_LOCK = threading.Lock()


def manifest_path(directory: str, step: int) -> str:
    """The ``step_<n>.manifest.json`` commit record published after the
    step's directory lands.  A plain file, so :func:`committed_steps`'s
    digit parse never mistakes it for a step directory."""
    return os.path.join(os.path.abspath(directory), f"step_{step}.manifest.json")


def _fsync_dir(path: str) -> None:
    """Make a directory entry durable (the rename itself, not just the
    renamed bytes).  Best-effort: not every filesystem lets you open or
    fsync a directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_json(path: str, obj) -> None:
    """tmp + fsync + ``os.replace`` + parent-dir fsync: a reader sees the
    old file or the new file, never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _step_files(step_dir: str) -> list:
    """Every regular file under a step directory, as sorted relative paths
    — the manifest's (and verify's) stable enumeration order."""
    out = []
    for root, dirs, files in os.walk(step_dir):
        dirs.sort()
        for name in sorted(files):
            out.append(os.path.relpath(os.path.join(root, name), step_dir))
    return out


def _sha256_file(path: str):
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
            size += len(chunk)
    return h.hexdigest(), size


def write_manifest(directory: str, step: int) -> str:
    """Hash a committed ``step_<n>`` directory and publish its commit
    record.  Called as each save lands; call it directly only to *adopt* a
    checkpoint written without one into the verified set."""
    directory = os.path.abspath(directory)
    step_dir = os.path.join(directory, f"step_{step}")
    files = {}
    with telemetry.trace.span("checkpoint_publish", phase="ckpt", step=int(step)):
        for rel in _step_files(step_dir):
            digest, size = _sha256_file(os.path.join(step_dir, rel))
            files[rel] = {"sha256": digest, "bytes": size}
        from distkeras_tpu_torch.telemetry import correlate

        path = manifest_path(directory, step)
        _atomic_write_json(path, {
            "version": 1,
            "step": int(step),
            "run_id": correlate.run_id(),
            "files": files,
        })
    return path


def wait_until_finished() -> None:
    """Block until every in-flight save has landed and published its
    manifest; re-raise the first save that failed."""
    with _INFLIGHT_LOCK:
        pending = list(_INFLIGHT)
        _INFLIGHT.clear()
    with telemetry.trace.span("checkpoint_flush", phase="ckpt"):
        errors = []
        for future in pending:
            try:
                future.result()
            except Exception as e:  # noqa: BLE001 — re-raised below, after every save ended
                errors.append(e)
    if errors:
        raise errors[0]


# ----------------------------------------------------------------- payload

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a finished copy off the card), bfloat16 as its
    ``uint16`` bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _snapshot(state) -> dict:
    """The host snapshot of a ``TrainState``: per field, its treedef, its
    leaves' dtypes and its leaves as numpy arrays."""
    out = {}
    for field in FIELDS:
        value = getattr(state, field)
        if field == "rng":
            value = [g.get_state() for g in value]
        elif field == "epoch":
            value = torch.tensor(int(value), dtype=torch.int32)
        leaves, treedef = _flatten(value)
        out[field] = (treedef, [_dtype_name(t) for t in leaves], [_to_numpy(t) for t in leaves])
    return out


def _write_payload(step_dir: str, snapshot: dict) -> None:
    """Write a snapshot's files into ``step_dir``, each fsync'd."""
    tree = {"version": 1, "num_workers": len(snapshot["rng"][2]), "fields": {}}
    for field, (treedef, dtypes, arrays) in snapshot.items():
        tree["fields"][field] = {"treedef": treedef, "dtypes": dtypes,
                                 "shapes": [list(a.shape) for a in arrays]}
        with open(os.path.join(step_dir, f"{field}.npz"), "wb") as fh:
            np.savez(fh, **{f"leaf_{i}": a for i, a in enumerate(arrays)})
            fh.flush()
            os.fsync(fh.fileno())
    with open(os.path.join(step_dir, _TREE_FILE), "w", encoding="utf-8") as fh:
        json.dump(tree, fh, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())


def _save_job(directory: str, step: int, snapshot: dict) -> None:
    """The writer thread's half of a save: the files into a temporary
    directory, renamed into place as ``step_<n>`` (the commit), then the
    manifest (the publication)."""
    final = os.path.join(directory, f"step_{step}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step}.", suffix=".tmp", dir=directory)
    try:
        _write_payload(tmp, snapshot)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(directory)
    write_manifest(directory, step)


def save_checkpoint(directory: str, state: Any, step: int, force: bool = False) -> str:
    """Write training state under ``directory/step_<n>`` (asynchronously);
    returns the path.  The host snapshot is taken before this returns, so
    the caller may go on updating ``state`` in place.  Call
    :func:`wait_until_finished` before reading the step back.

    ``force=True`` overwrites an existing ``step_<n>`` — the mid-epoch save
    path, where the same step is saved again as the block cursor advances
    and finally superseded by the epoch-boundary save.  A directory with
    no manifest (an orphan of a crash between the write and the
    publication) is overwritten as if forced."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}")
    if not force and os.path.isdir(path) and not os.path.exists(manifest_path(directory, step)):
        force = True
    if not force and os.path.isdir(path):
        raise FileExistsError(f"checkpoint {path} exists (pass force=True to overwrite it)")
    with telemetry.trace.span("checkpoint_enqueue", phase="ckpt", step=int(step)):
        snapshot = _snapshot(state)
        if force:
            # the step is being superseded: retract its manifest FIRST, so it
            # can never describe (and a reader never verify against) the
            # replacement bytes, and let an earlier save of it land
            wait_until_finished()
            try:
                os.remove(manifest_path(directory, step))
            except FileNotFoundError:
                pass
        future = _WRITER.submit(_save_job, directory, int(step), snapshot)
    with _INFLIGHT_LOCK:
        _INFLIGHT.append(future)
    return path


def data_state_path(directory: str, step: int) -> str:
    """The ``step_<n>_data.json`` sidecar carrying a step's
    :class:`~distkeras_tpu_torch.datapipe.DataState`.  A plain file, so
    :func:`committed_steps`'s digit parse never mistakes it for a step."""
    return os.path.join(os.path.abspath(directory), f"step_{step}_data.json")


def save_data_state(directory: str, data_state, step: int) -> str:
    """Write the data checkpoint sidecar for ``step`` — synchronous (a few
    hundred bytes), atomic and durable."""
    path = data_state_path(directory, step)
    _atomic_write_json(path, data_state.to_json())
    return path


def restore_data_state(directory: str, step: Optional[int] = None):
    """The :class:`~distkeras_tpu_torch.datapipe.DataState` saved with
    ``step`` (default: latest), or None — model-only checkpoints resume with
    the epoch-boundary RNG fast-forward instead."""
    from distkeras_tpu_torch.datapipe.state import DataState

    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = data_state_path(directory, step)
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return DataState.from_json(json.load(fh))


def committed_steps(directory: str) -> list:
    """*Published* steps: a ``step_<n>.manifest.json`` commit record next to
    a final ``step_<n>`` directory — readable cross-process with no flush.
    Directories without a manifest and quarantined ``step_<n>.corrupt``
    renames do not count."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    names = set(os.listdir(directory))
    suffix = ".manifest.json"
    out = []
    for d in names:
        if d.startswith("step_") and d.endswith(suffix):
            num = d[len("step_"):-len(suffix)]
            if num.isdigit() and f"step_{num}" in names:
                out.append(int(num))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    wait_until_finished()  # a step only counts once its save committed
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def verify_failure(directory: str, step: int, mode: str = "fast") -> Optional[str]:
    """Why ``step`` fails verification against its manifest, or ``None``
    when it passes.  ``fast`` checks every manifested file exists at its
    recorded size (catches torn writes); ``full`` additionally re-hashes
    every file (catches bit flips).  ``off`` always passes."""
    if mode not in ("off", "fast", "full"):
        raise ValueError(f"verify mode must be off|fast|full, got {mode!r}")
    if mode == "off":
        return None
    directory = os.path.abspath(directory)
    mpath = manifest_path(directory, step)
    try:
        with open(mpath, "r", encoding="utf-8") as fh:
            manifest = json.load(fh)
        files = manifest["files"]
    except FileNotFoundError:
        return (f"step {step} has no manifest (in-flight save, crashed "
                "publish, or pre-manifest checkpoint)")
    except (ValueError, KeyError, OSError) as e:
        return f"step {step} manifest unreadable: {e}"
    step_dir = os.path.join(directory, f"step_{step}")
    hash_files = mode == "full"
    memo = None
    if hash_files:
        memo = _VERIFIED.get(mpath)
        if memo is not None:
            try:
                st = os.stat(mpath)
                if memo[0] == (st.st_mtime_ns, st.st_size):
                    hash_files = False  # digests proven; stats re-checked below
                else:
                    _VERIFIED.pop(mpath, None)
                    memo = None
            except OSError:
                memo = None
    file_stats = []
    for rel in sorted(files):
        full = os.path.join(step_dir, rel)
        want = files[rel]
        try:
            st = os.stat(full)
        except OSError:
            return f"step {step}: {rel} missing"
        if st.st_size != int(want["bytes"]):
            return f"step {step}: {rel} is {st.st_size} bytes, manifest says {want['bytes']}"
        if mode == "full" and not hash_files:
            # memo hit: the digests were proven for the bytes as they were
            # then; any stat drift since re-hashes
            if (rel, st.st_size, st.st_mtime_ns) not in memo[1]:
                _VERIFIED.pop(mpath, None)
                return verify_failure(directory, step, mode)
        if hash_files:
            digest, _size = _sha256_file(full)
            if digest != want["sha256"]:
                return f"step {step}: {rel} sha256 mismatch"
            file_stats.append((rel, st.st_size, st.st_mtime_ns))
    if hash_files:
        try:
            st = os.stat(mpath)
            _VERIFIED[mpath] = ((st.st_mtime_ns, st.st_size), frozenset(file_stats))
        except OSError:
            pass
    return None


def verify_checkpoint(directory: str, step: int, mode: str = "fast") -> bool:
    """Whether ``step`` passes manifest verification (see
    :func:`verify_failure` for the modes)."""
    return verify_failure(directory, step, mode) is None


def quarantine_step(directory: str, step: int, reason: str = "") -> str:
    """Move a corrupt step out of the restorable set: ``step_<n>`` →
    ``step_<n>.corrupt`` (suffix-numbered if that name is taken), with its
    manifest and data sidecar renamed alongside for forensics; the digit
    parse of :func:`committed_steps` never matches the renamed files."""
    directory = os.path.abspath(directory)
    src = os.path.join(directory, f"step_{step}")
    dst = src + ".corrupt"
    n = 0
    while os.path.exists(dst) or os.path.exists(dst + ".manifest.json"):
        n += 1
        dst = f"{src}.corrupt.{n}"
    if os.path.isdir(src):
        os.replace(src, dst)
    mpath = manifest_path(directory, step)
    _VERIFIED.pop(mpath, None)
    try:
        os.replace(mpath, dst + ".manifest.json")
    except FileNotFoundError:
        pass
    try:
        os.replace(data_state_path(directory, step), dst + "_data.json")
    except FileNotFoundError:
        pass
    _fsync_dir(directory)
    with telemetry.trace.span("checkpoint_quarantine", phase="ckpt", step=int(step),
                              reason=reason[:200]):
        pass
    return dst


def _resolve_verified(directory: str, step: Optional[int], mode: str = "full") -> int:
    """The step a restore may load: verify first; quarantine a corrupt step
    and fall back to the newest one that verifies.  An explicitly requested
    step without a manifest raises instead (it may be another process's
    in-flight save)."""
    wait_until_finished()
    directory = os.path.abspath(directory)
    if step is not None:
        reason = verify_failure(directory, step, mode)
        if reason is None:
            return int(step)
        if not os.path.exists(manifest_path(directory, step)):
            raise FileNotFoundError(f"cannot restore unverified step under {directory}: {reason}")
        quarantine_step(directory, step, reason)
    while True:
        steps = committed_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no verified checkpoints under {directory}")
        newest = steps[-1]
        reason = verify_failure(directory, newest, mode)
        if reason is None:
            return newest
        quarantine_step(directory, newest, reason)


class CheckpointWatcher:
    """Newest-step watcher over a checkpoint directory (the train→serve
    bridge): ``poll()`` returns the newest *verified* step the first time
    it is seen, ``None`` otherwise.  Built on :func:`committed_steps`, so
    it never waits on this process's saves; a published step must also
    pass a ``fast`` verify.  With ``start_after`` omitted it baselines at
    the newest step on disk at construction; ``start_after=-1`` sees every
    step."""

    def __init__(self, directory: str, start_after: Optional[int] = None):
        self.directory = directory
        if start_after is None:
            steps = committed_steps(directory)
            start_after = steps[-1] if steps else -1
        self.last_step = int(start_after)

    def poll(self) -> Optional[int]:
        """The newest verified step if newer than anything reported before,
        else ``None``; intermediate steps are skipped on purpose."""
        for step in reversed(committed_steps(self.directory)):
            if step <= self.last_step:
                return None
            if verify_failure(self.directory, step, "fast") is None:
                self.last_step = step
                return step
        return None


def _step_path(directory: str, step: Optional[int], verify: str = "full") -> str:
    """The directory a restore reads — verified (quarantine + newest
    verified fallback) unless the caller opted out with ``verify="off"``."""
    if verify == "off":
        wait_until_finished()
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {directory}")
    else:
        step = _resolve_verified(directory, step, verify)
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def _read_tree(path: str) -> dict:
    with open(os.path.join(path, _TREE_FILE), "r", encoding="utf-8") as fh:
        return json.load(fh)


def _read_field(path: str, tree: dict, field: str, leaf_ids=None) -> list:
    """The leaves of one field as CPU tensors (those in ``leaf_ids`` only,
    when given: the others are never read off disk)."""
    meta = tree["fields"][field]
    with np.load(os.path.join(path, f"{field}.npz"), allow_pickle=False) as data:
        ids = range(len(meta["dtypes"])) if leaf_ids is None else leaf_ids
        return [_from_numpy(data[f"leaf_{i}"], meta["dtypes"][i]) for i in ids]


def _field_tree(path: str, tree: dict, field: str):
    return _unflatten(tree["fields"][field]["treedef"], iter(_read_field(path, tree, field)))


def restore_checkpoint(directory: str, step: Optional[int] = None, like: Any = None,
                       verify: str = "full") -> Any:
    """Load training state.  With ``like`` (a ``TrainState``, e.g. a freshly
    built one) the result is a ``TrainState`` with ``like``'s structure,
    dtypes and devices, and ``like``'s generators set to the saved states;
    without it, a dict of the fields as CPU tensor trees.

    Verifies before load (default ``full``: a bit flip keeps sizes, so only
    digests prove the bytes): a corrupt step is quarantined and the newest
    verified one loads instead; ``verify="off"`` restores blind."""
    path = _step_path(directory, step, verify)
    tree = _read_tree(path)
    if like is None:
        return {field: _field_tree(path, tree, field) for field in FIELDS}
    changes = {}
    for field in FIELDS:
        saved = _read_field(path, tree, field)
        if field == "rng":
            if len(saved) != len(like.rng):
                raise ValueError(f"checkpoint has {len(saved)} workers, the state {len(like.rng)}")
            for g, s in zip(like.rng, saved):
                g.set_state(s)
            continue
        if field == "epoch":
            changes["epoch"] = int(saved[0])
            continue
        ref = getattr(like, field)
        ref_leaves, treedef = _flatten(ref)
        if len(ref_leaves) != len(saved):
            raise ValueError(f"checkpoint field {field} has {len(saved)} leaves, "
                             f"the state {len(ref_leaves)}")
        # rebuilt in the template's own key order, on its devices and dtypes
        changes[field] = tree_map(lambda r, s: s.to(device=r.device, dtype=r.dtype), ref,
                                  _unflatten(treedef, iter(saved)))
    return like.replace(**changes)


def restore_center(directory: str, step: Optional[int] = None,
                   include_model_state: bool = True) -> dict:
    """Partial restore for elastic resume: only the center variable, its
    rule state, the epoch counter and (``include_model_state``) the model
    state leave disk; the per-worker fields (local replicas, optimizer
    state, rule locals, generators) are never read."""
    path = _step_path(directory, step)
    tree = _read_tree(path)
    keep = ("center_params", "center_rule", "epoch")
    if include_model_state:
        keep = keep + ("model_state",)
    return {field: _field_tree(path, tree, field) for field in keep}


def worker_mean(x) -> torch.Tensor:
    """Mean over the leading (workers) dim with resume-grade dtype care:
    accumulated in float64 (bf16 leaves do not round twice), integer leaves
    rounded to nearest instead of truncated."""
    x = torch.as_tensor(x)
    m = x.to(torch.float64).mean(dim=0)
    if not x.is_floating_point():
        m = torch.round(m)
    return m.to(x.dtype)


def model_state_worker_mean(directory: str, step: Optional[int] = None,
                            host_bytes_budget: int = 256 * 1024**2):
    """Collapse the checkpointed per-worker ``[N_old, ...]`` model-state
    stack to its worker mean without holding the whole stack on the host:
    leaves are read in groups whose combined size stays under
    ``host_bytes_budget`` and reduced at once (a single leaf over the
    budget is read alone)."""
    path = _step_path(directory, step)
    tree = _read_tree(path)
    meta = tree["fields"]["model_state"]
    sizes = [int(np.prod(shape, dtype=np.int64))
             * torch.empty((), dtype=getattr(torch, dt)).element_size()
             for shape, dt in zip(meta["shapes"], meta["dtypes"])]
    groups, cur, cur_bytes = [], [], 0
    for i, nbytes in enumerate(sizes):
        if cur and cur_bytes + nbytes > host_bytes_budget:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        groups.append(cur)
    out = [None] * len(sizes)
    for group in groups:
        for i, leaf in zip(group, _read_field(path, tree, "model_state", group)):
            out[i] = worker_mean(leaf)
    return _unflatten(meta["treedef"], iter(out))


def checkpoint_num_workers(directory: str, step: Optional[int] = None) -> int:
    """Worker count a checkpoint was written at, read from its
    ``tree.json`` alone — the cheap probe behind elastic resume."""
    return int(_read_tree(_step_path(directory, step))["num_workers"])


class CheckpointManager:
    """Every-N-epochs checkpointing hook used by trainers (``checkpoint_dir``
    + ``checkpoint_every`` kwargs)."""

    def __init__(self, directory: str, every: int = 1, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.every = max(1, int(every))
        self.keep = keep
        self._saved: set = set()
        # steps whose latest save is a mid-epoch (partial) one: their
        # epoch-boundary save must overwrite (force=True), and their stale
        # cursor sidecar must go when the boundary save supersedes it
        self._partial: set = set()
        os.makedirs(self.directory, exist_ok=True)

    def _is_partial(self, step: int) -> bool:
        """Whether ``step``'s latest save is a mid-epoch one — from this
        manager's memory, or from the on-disk cursor sidecar (written
        synchronously, so a resumed process sees a killed run's partial
        step)."""
        if step in self._partial:
            return True
        ds = restore_data_state(self.directory, step)
        return ds is not None and int(ds.block_cursor) > 0

    def maybe_save(self, state: Any, epoch: int, data_state=None) -> Optional[str]:
        if (epoch + 1) % self.every:
            return None
        step = epoch + 1
        path = save_checkpoint(self.directory, state, step, force=self._is_partial(step))
        if data_state is not None:
            save_data_state(self.directory, data_state, step)
        else:
            # a boundary save without a DataState supersedes a mid-epoch one:
            # drop any stale cursor so resume doesn't skip blocks
            try:
                os.remove(data_state_path(self.directory, step))
            except FileNotFoundError:
                pass
        self._partial.discard(step)
        self._saved.add(step)
        self._gc()
        return path

    def save_partial(self, state: Any, epoch: int, data_state) -> str:
        """Mid-epoch save: model state plus the :class:`DataState` cursor
        marking how far into ``epoch``'s blocks the run got, under the step
        the epoch-boundary save will later claim (``epoch + 1``), saved
        again in place as the cursor advances."""
        step = epoch + 1
        path = save_checkpoint(self.directory, state, step, force=True)
        save_data_state(self.directory, data_state, step)
        self._partial.add(step)
        self._saved.add(step)
        self._gc()
        return path

    def restore_data_state(self, step: Optional[int] = None):
        return restore_data_state(self.directory, step)

    def wait(self) -> None:
        """Flush in-flight saves (end of the trainer epoch loop), then apply
        the keep policy exactly."""
        wait_until_finished()
        self._gc()

    def _gc(self) -> None:
        # Only PUBLISHED steps are GC candidates: counting an in-flight save
        # toward ``keep`` could, at keep=1, delete the only restorable
        # checkpoint while the new one is still writing.  Quarantined
        # ``step_<n>.corrupt`` renames fail the digit parse and stay for
        # forensics.  The manifest goes first (un-publication), so no reader
        # resolves a step whose bytes are mid-deletion.
        committed = committed_steps(self.directory)
        for s in committed[: -self.keep] if self.keep else []:
            self._saved.discard(s)
            self._partial.discard(s)
            try:
                os.remove(manifest_path(self.directory, s))
            except FileNotFoundError:
                pass
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
            try:
                os.remove(data_state_path(self.directory, s))
            except FileNotFoundError:
                pass

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def latest_verified(self, mode: str = "full") -> Optional[int]:
        """The newest step whose bytes provably match their manifest — what
        resume pins; corrupt steps found on the way are quarantined.
        ``None`` when nothing verifiable exists."""
        self.wait()
        try:
            return _resolve_verified(self.directory, None, mode)
        except FileNotFoundError:
            return None

    def saved_worker_count(self, step: Optional[int] = None) -> int:
        return checkpoint_num_workers(self.directory, step)

    def restore_center(self, step: Optional[int] = None,
                       include_model_state: bool = True) -> dict:
        return restore_center(self.directory, step, include_model_state)

    def model_state_worker_mean(self, step: Optional[int] = None,
                                host_bytes_budget: int = 256 * 1024**2):
        return model_state_worker_mean(self.directory, step, host_bytes_budget)

    def restore(self, like: Any = None, step: Optional[int] = None,
                verify: str = "full") -> Any:
        return restore_checkpoint(self.directory, step, like, verify)
