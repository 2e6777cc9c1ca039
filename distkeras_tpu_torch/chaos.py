"""Deterministic chaos harness — fault injection for the fleet layer.

The port of :mod:`distkeras_tpu.chaos`, copied: the same spec keys, sites
and seeded draws, so a spec fires the same faults at the same counts, and
tears and corrupts at the same offsets, in both packages.

Opt-in through ``DISTKERAS_CHAOS=<seed>:<spec>`` (same discipline as
``DISTKERAS_SANITIZE``): unset/falsey ⇒ **off** — every hook is one cached
bool check, the control-plane objects are stock, and an epoch's trajectory
and kernel launches are bit for bit those of an armed spec that never
fires (pinned by test).  The harness never touches device code or a
captured CUDA graph: every fault fires on the host, at a named *site*,
from seeded per-site counters — so a chaos run is exactly reproducible, which is what
makes recovery paths provable in CI rather than asserted.

``<spec>`` is a comma-separated ``key=value`` list:

======================  =====================================================
``kill_epoch=N``        raise :class:`ChaosKilled` entering epoch number N
                        (0-based count of ``epoch`` faults; fires once)
``kill_block=N``        raise :class:`ChaosKilled` at the Nth streaming block
                        (global across epochs; fires once)
``stall_block=N``       sleep ``stall_secs`` at the Nth block (fires once)
``stall_secs=S``        stall duration for ``stall_block`` (default 0.05)
``refuse_connect=K``    first K ``connect`` sites raise ConnectionRefusedError
``drop_reply=K``        first K ``rpc_reply`` sites raise ConnectionError —
                        the request reached the daemon, the reply was lost
``drop_recv=K``         first K ``recv`` sites raise ConnectionError
``tear_send=K``         first K ``send`` sites put a truncated frame on the
                        wire (seeded split point) then raise ConnectionError
``delay_send_ms=M``     every ``send`` site sleeps M milliseconds first
``kill_replica=N``      raise :class:`ChaosKilled` at the Nth ``replica``
                        site (a serving replica's decode loop, hit only
                        while requests are in flight; fires once)
``stall_http=K``        first K ``http`` sites (health probes) sleep
                        ``stall_secs`` — a wedged ``/healthz``
``kill_commit=N``       raise :class:`ChaosKilled` at the Nth ``ckpt_commit``
                        site — after the step directory landed but *before* the
                        manifest commit record was published (fires once)
``delay_commit_ms=M``   every ``ckpt_commit`` site sleeps M milliseconds
                        first — widens the committed-but-unpublished window
                        a cross-process watcher must never surface
``kill_rotate=N``       raise :class:`ChaosKilled` at the Nth ``window_rotate``
                        site — after a capture window's shard files landed
                        but *before* its manifest published (fires once)
``torn_ckpt=N``         truncate one seeded leaf file of the Nth *published*
                        checkpoint (post-commit torn write / lost page
                        cache; fires once)
``flip_ckpt=N``         flip one seeded bit in one seeded leaf file of the
                        Nth published checkpoint (bit rot — sizes intact,
                        only a full digest verify can catch it; fires once)
======================  =====================================================

Example: ``DISTKERAS_CHAOS=7:kill_block=5,refuse_connect=2``.

Tests flip the switch with :func:`configure` instead of mutating
``os.environ``, exactly like ``sanitizer.configure``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Iterable, Iterator, Optional

__all__ = [
    "ChaosConfig",
    "ChaosKilled",
    "configure",
    "counts",
    "enabled",
    "fault",
    "corrupt_ckpt",
    "spec",
    "tear_bytes",
    "wrap_blocks",
]

_FALSEY = ("", "0", "false", "no")

# integer-valued spec keys and their meaning; anything else is rejected so a
# typo'd fault name fails loudly instead of silently injecting nothing
_INT_KEYS = frozenset({
    "kill_epoch", "kill_block", "stall_block", "refuse_connect",
    "drop_reply", "drop_recv", "tear_send", "delay_send_ms",
    "kill_replica", "stall_http",
    "kill_commit", "delay_commit_ms", "torn_ckpt", "flip_ckpt",
    "kill_rotate",
})
_FLOAT_KEYS = frozenset({"stall_secs"})


class ChaosKilled(RuntimeError):
    """A seeded worker-kill fault fired (the injected analogue of a
    preempted/crashed worker mid-run)."""


class ChaosConfig:
    """Parsed ``<seed>:<spec>``; ``None`` spec values mean 'not armed'."""

    def __init__(self, seed: int, params: Dict[str, float]):
        self.seed = int(seed)
        self.params = dict(params)

    def get(self, key: str) -> Optional[float]:
        return self.params.get(key)

    @classmethod
    def parse(cls, raw: str) -> "ChaosConfig":
        head, _, rest = raw.partition(":")
        try:
            seed = int(head)
        except ValueError as e:
            raise ValueError(
                f"DISTKERAS_CHAOS must start with '<seed>:', got {raw!r}"
            ) from e
        params: Dict[str, float] = {}
        for item in filter(None, (p.strip() for p in rest.split(","))):
            key, sep, value = item.partition("=")
            if not sep:
                raise ValueError(f"chaos spec item {item!r} is not key=value")
            if key in _INT_KEYS:
                params[key] = int(value)
            elif key in _FLOAT_KEYS:
                params[key] = float(value)
            else:
                raise ValueError(
                    f"unknown chaos spec key {key!r} (known: "
                    f"{sorted(_INT_KEYS | _FLOAT_KEYS)})"
                )
        return cls(seed, params)


# None = not yet resolved from the environment; False = resolved off;
# a ChaosConfig once resolved on (or forced via configure()).
_CONFIG = None
_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {}
_FIRED: set = set()


def _resolve():
    global _CONFIG
    if _CONFIG is None:
        raw = os.environ.get("DISTKERAS_CHAOS", "")
        _CONFIG = ChaosConfig.parse(raw) if raw.lower() not in _FALSEY else False
    return _CONFIG


def enabled() -> bool:
    """Whether chaos injection is armed; cached after the first read."""
    return _resolve() is not False


def spec() -> Optional[ChaosConfig]:
    cfg = _resolve()
    return cfg if cfg is not False else None


def configure(raw: Optional[str] = None) -> None:
    """Force the spec (``"<seed>:<spec>"``), disable (``""``), or reset to
    env-driven (``None``).  Clears every site counter and fired-fault
    record, so each test starts from a clean chaos timeline."""
    global _CONFIG
    with _LOCK:
        if raw is None:
            _CONFIG = None
        elif raw.lower() in _FALSEY:
            _CONFIG = False
        else:
            _CONFIG = ChaosConfig.parse(raw)
        _COUNTS.clear()
        _FIRED.clear()


def counts() -> Dict[str, int]:
    """Per-site fault-hook hit counts (introspection for tests)."""
    with _LOCK:
        return dict(_COUNTS)


def _next_count(site: str) -> int:
    """Increment and return the 0-based hit index for ``site``."""
    with _LOCK:
        n = _COUNTS.get(site, 0)
        _COUNTS[site] = n + 1
        return n


def _fire_once(key: str) -> bool:
    with _LOCK:
        if key in _FIRED:
            return False
        _FIRED.add(key)
        return True


def _note(kind: str) -> None:
    # chaos decisions are visible in the telemetry registry so a CI chaos
    # leg can assert faults actually fired; one cached-bool check when off
    from distkeras_tpu_torch import telemetry

    if telemetry.enabled():
        telemetry.metrics.counter(
            f"chaos_{kind}_total", help=f"chaos faults injected ({kind})"
        ).inc()


def fault(site: str) -> None:
    """Fire any armed fault for ``site``; no-op (beyond one counter bump)
    otherwise.  Sites: ``connect``, ``send``, ``recv``, ``rpc_reply``,
    ``epoch``, ``block``, ``replica``, ``http``, ``ckpt_commit``,
    ``window_rotate``."""
    cfg = spec()
    if cfg is None:
        return
    n = _next_count(site)
    if site == "connect":
        k = cfg.get("refuse_connect")
        if k is not None and n < k:
            _note("refuse_connect")
            raise ConnectionRefusedError(
                f"chaos: connect refused ({n + 1}/{int(k)})")
    elif site == "rpc_reply":
        k = cfg.get("drop_reply")
        if k is not None and n < k:
            _note("drop_reply")
            raise ConnectionError(f"chaos: reply dropped ({n + 1}/{int(k)})")
    elif site == "recv":
        k = cfg.get("drop_recv")
        if k is not None and n < k:
            _note("drop_recv")
            raise ConnectionError(f"chaos: recv dropped ({n + 1}/{int(k)})")
    elif site == "send":
        delay = cfg.get("delay_send_ms")
        if delay:
            _note("delay_send")
            time.sleep(delay / 1000.0)  # injected stall
    elif site == "epoch":
        k = cfg.get("kill_epoch")
        if k is not None and n == k and _fire_once("kill_epoch"):
            _note("kill_epoch")
            raise ChaosKilled(f"chaos: worker killed entering epoch {n}")
    elif site == "block":
        k = cfg.get("kill_block")
        if k is not None and n == k and _fire_once("kill_block"):
            _note("kill_block")
            raise ChaosKilled(f"chaos: worker killed at block {n}")
        k = cfg.get("stall_block")
        if k is not None and n == k and _fire_once("stall_block"):
            _note("stall_block")
            time.sleep(cfg.get("stall_secs") or 0.05)  # injected stall
    elif site == "replica":
        k = cfg.get("kill_replica")
        if k is not None and n == k and _fire_once("kill_replica"):
            _note("kill_replica")
            raise ChaosKilled(
                f"chaos: serving replica killed at busy iteration {n}")
    elif site == "http":
        k = cfg.get("stall_http")
        if k is not None and n < k:
            _note("stall_http")
            time.sleep(cfg.get("stall_secs") or 0.05)  # injected stall
    elif site == "window_rotate":
        k = cfg.get("kill_rotate")
        if k is not None and n == k and _fire_once("kill_rotate"):
            _note("kill_rotate")
            raise ChaosKilled(
                f"chaos: capture killed between shard rotation and manifest "
                f"publish (window rotation {n})")
    elif site == "ckpt_commit":
        delay = cfg.get("delay_commit_ms")
        if delay:
            _note("delay_commit")
            time.sleep(delay / 1000.0)  # injected stall
        k = cfg.get("kill_commit")
        if k is not None and n == k and _fire_once("kill_commit"):
            _note("kill_commit")
            raise ChaosKilled(
                f"chaos: killed between the step commit and manifest publish "
                f"(publish {n})")


def tear_bytes(site: str, frame_len: int) -> Optional[int]:
    """When a ``tear_send`` fault is armed for this hit of ``site``, the
    number of leading frame bytes to put on the wire before dropping the
    connection (seeded split point, always a proper prefix); ``None``
    otherwise.  Does NOT consume the site counter — call before
    :func:`fault` for the same frame."""
    cfg = spec()
    if cfg is None:
        return None
    k = cfg.get("tear_send")
    if k is None:
        return None
    with _LOCK:
        n = _COUNTS.get(site, 0)
    if n >= k:
        return None
    _next_count(site)
    _note("tear_send")
    rng = random.Random((cfg.seed << 16) ^ n)
    return rng.randrange(1, max(2, frame_len))


def corrupt_ckpt(paths: Iterable[str]) -> Optional[str]:
    """Fire any armed post-publish checkpoint corruption (``torn_ckpt`` /
    ``flip_ckpt``) against one seeded file from ``paths``; consumes one hit
    of the ``ckpt_publish`` site per call.  Models damage that lands *after*
    the manifest committed (torn page-cache writeback, bit rot) — which is
    exactly what digest verification exists to catch — so the caller must
    invoke it after its commit record is durable.  Returns a description of
    the injected damage, ``None`` when nothing fired."""
    cfg = spec()
    if cfg is None:
        return None
    n = _next_count("ckpt_publish")
    # only non-empty regular files can be meaningfully damaged
    candidates = sorted(p for p in paths
                        if os.path.isfile(p) and os.path.getsize(p) > 0)
    if not candidates:
        return None
    k = cfg.get("torn_ckpt")
    if k is not None and n == k and _fire_once("torn_ckpt"):
        _note("torn_ckpt")
        rng = random.Random((cfg.seed << 16) ^ (0x70 + n))
        target = candidates[rng.randrange(len(candidates))]
        size = os.path.getsize(target)
        keep = rng.randrange(size)  # always a proper prefix
        with open(target, "rb+") as fh:
            fh.truncate(keep)
        return f"torn {target} at {keep}/{size} bytes"
    k = cfg.get("flip_ckpt")
    if k is not None and n == k and _fire_once("flip_ckpt"):
        _note("flip_ckpt")
        rng = random.Random((cfg.seed << 16) ^ (0xF0 + n))
        target = candidates[rng.randrange(len(candidates))]
        size = os.path.getsize(target)
        offset = rng.randrange(size)
        bit = 1 << rng.randrange(8)
        with open(target, "rb+") as fh:
            fh.seek(offset)
            byte = fh.read(1)[0]
            fh.seek(offset)
            fh.write(bytes([byte ^ bit]))
        return f"flipped bit {bit:#04x} at {target}:{offset}"
    return None


def wrap_blocks(blocks: Iterable) -> Iterator:
    """Wrap a streaming block iterator so each block crosses the ``block``
    fault site (kill/stall at a seeded block index) before it reaches the
    engine."""
    for item in blocks:
        fault("block")
        yield item
