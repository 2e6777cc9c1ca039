"""Networking — host discovery, multi-process initialisation, wire helpers.

The port of :mod:`distkeras_tpu.networking`.  Reference parity:
``distkeras/networking.py`` provided ``determine_host_address`` plus
length-prefixed pickled-TCP ``send_data`` / ``recv_data`` — the transport
of the star-topology parameter server.  In the port the training-path
transport is ``torch.distributed``: NCCL between cards, gloo on the CPU.
What lives here:

* :func:`determine_host_address` — unchanged role;
* :func:`initialize` / :func:`shutdown` — multi-process bootstrap over
  ``torch.distributed`` (the JAX package's ``jax.distributed``), the
  reference's ``master_host``/``master_port`` analogue; with no arguments
  it reads torchrun's environment (``env://``);
* ``send_data`` / ``recv_data`` — the control-plane wire helpers.  Payloads
  are length-prefixed; the codec is a restricted numpy/JSON container
  format, NOT pickle.  It is the JAX package's byte for byte (magic
  ``DKT1``, a ``!Q`` length, a ``!II`` header, JSON, an ``.npz`` blob), so a
  frame written by either package decodes in the other.

With the runtime sanitizer on, one frame's send and one frame's receive
each run under ``lockwatch.exclusive`` on their socket: two threads sending
(or receiving) on one socket at once interleave length-prefixed frames and
tear the stream, which the guard reports.  With fault injection armed
(``DISTKERAS_CHAOS``, :mod:`~distkeras_tpu_torch.chaos`) the ``connect``,
``send`` and ``recv`` sites fire where the JAX package's do: before the
dial, before a frame goes out (a torn frame puts a seeded prefix on the
wire and raises ``ConnectionError``) and before a frame is read.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
from typing import Any, Optional

import numpy as np

from distkeras_tpu_torch import chaos
from distkeras_tpu_torch.parallel.mesh import resolve_device
from distkeras_tpu_torch.sanitizer import lockwatch

__all__ = [
    "determine_host_address",
    "initialize",
    "shutdown",
    "connect",
    "send_data",
    "recv_data",
]

_MAGIC = b"DKT1"
_MAX_MESSAGE = 1 << 31


def determine_host_address() -> str:
    """Best-effort routable address of this host (reference parity:
    ``networking.py :: determine_host_address``)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        # UDP connect sends no packet and cannot block on a peer
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        s.close()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join the multi-process job (the reference's master handshake) as one
    process of a ``torch.distributed`` process group.

    ``coordinator_address='host:port'`` with ``num_processes`` and
    ``process_id`` names the group's rendezvous; with no arguments the
    group is read from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``device`` picks the
    backend: NCCL on the card (``"cuda"``, the default, which raises
    without one; the process takes card ``LOCAL_RANK`` where torchrun sets
    it), gloo for ``device="cpu"``.
    """
    import torch
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index)))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


def shutdown() -> None:
    """Leave the process group :func:`initialize` joined (a no-op if none).

    NCCL does not destroy a communicator while a CUDA graph that recorded
    its collectives lives (a captured window's, a serving mesh's program):
    the card is synchronised and the unreachable objects collected first,
    since engines hold their graphs and often sit in reference cycles.  An
    engine still referenced keeps its graphs: drop it, or clear its
    captured programs (``clear_program_cache``), before the call."""
    import gc

    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        gc.collect()
        dist.destroy_process_group()


# -- control-plane wire helpers (job deployment) ---------------------------

def connect(host: str, port: int, timeout: float = 30.0) -> socket.socket:
    """TCP connect with NODELAY (reference parity: ``networking.py :: connect``).
    The timeout stays applied on the returned socket — callers inherit a
    deadline on every subsequent send/recv unless they override it."""
    if chaos.enabled():
        chaos.fault("connect")  # seeded ConnectionRefusedError injection
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def _encode(obj: Any) -> bytes:
    """Restricted container codec: JSON tree with out-of-band numpy arrays."""
    arrays: list[np.ndarray] = []

    def visit(x):
        if isinstance(x, np.ndarray):
            arrays.append(x)
            return {"__nd__": len(arrays) - 1}
        if isinstance(x, (np.integer, np.floating)):
            return x.item()
        if isinstance(x, dict):
            return {k: visit(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [visit(v) for v in x]
        if isinstance(x, bytes):
            arrays.append(np.frombuffer(x, dtype=np.uint8))
            return {"__bytes__": len(arrays) - 1}
        return x

    tree = json.dumps(visit(obj)).encode()
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": a for i, a in enumerate(arrays)})
    blob = buf.getvalue()
    return struct.pack("!II", len(tree), len(blob)) + tree + blob


def _decode(payload: bytes) -> Any:
    tree_len, blob_len = struct.unpack("!II", payload[:8])
    tree = json.loads(payload[8 : 8 + tree_len].decode())
    blob = payload[8 + tree_len : 8 + tree_len + blob_len]
    arrays = np.load(io.BytesIO(blob), allow_pickle=False) if blob_len else {}

    def visit(x):
        if isinstance(x, dict):
            if "__nd__" in x and len(x) == 1:
                return arrays[f"a{x['__nd__']}"]
            if "__bytes__" in x and len(x) == 1:
                return arrays[f"a{x['__bytes__']}"].tobytes()
            return {k: visit(v) for k, v in x.items()}
        if isinstance(x, list):
            return [visit(v) for v in x]
        return x

    return visit(tree)


def send_data(sock: socket.socket, obj: Any) -> None:
    """Length-prefixed message send (reference parity: ``send_data``).  One
    frame per call; callers keep sends on one socket to one thread at a
    time, or frames interleave."""
    payload = _encode(obj)
    frame = _MAGIC + struct.pack("!Q", len(payload)) + payload
    # one frame must hit the wire atomically per socket: the sanitizer's
    # exclusivity guard flags concurrent sends from two threads
    with lockwatch.exclusive(sock, "send_data on one socket"):
        if chaos.enabled():
            # tear check first (it consumes the site counter only when it
            # fires); the delay fault below is skipped for a torn frame
            torn = chaos.tear_bytes("send", len(frame))
            if torn is not None:
                sock.sendall(frame[:torn])
                raise ConnectionError(f"chaos: frame torn after {torn}/{len(frame)} bytes")
            chaos.fault("send")
        sock.sendall(frame)


def _recvall(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        # timeout is the caller's contract: connect() applies one
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_data(sock: socket.socket) -> Any:
    """Length-prefixed message receive (reference parity: ``recv_data``)."""
    if chaos.enabled():
        chaos.fault("recv")  # seeded ConnectionError before the read
    with lockwatch.exclusive(sock, "recv_data on one socket"):
        header = _recvall(sock, 12)
        if header[:4] != _MAGIC:
            raise ValueError("bad message magic")
        (length,) = struct.unpack("!Q", header[4:])
        if length > _MAX_MESSAGE:
            raise ValueError(f"message too large: {length}")
        payload = _recvall(sock, length)
    return _decode(payload)
