"""Port parity: ``distkeras_tpu_torch.networking`` against the JAX
package's ``distkeras_tpu.networking``.

The wire codec is the JAX package's byte for byte: ``_encode`` gives the
same bytes for the same nested object (``np.savez`` stamps the zip entries
with the clock, so the test pins it), and frames cross between the two
packages over a ``socket.socketpair()`` in both directions.
``initialize`` / ``shutdown`` join and leave a ``torch.distributed``
process group of one gloo process (in a subprocess, so the test process
keeps no group), through a ``tcp://`` rendezvous on localhost and through
torchrun's ``env://`` variables.
"""

import os
import socket
import subprocess
import sys
import textwrap
import types
import zipfile

import numpy as np
import pytest
import torch

from distkeras_tpu import networking as jax_net
from distkeras_tpu_torch import networking as port_net

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _message():
    rng = np.random.default_rng(0)
    return {
        "verb": "commit",
        "step": np.int64(12),
        "lr": np.float32(0.125),
        "delta": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": rng.integers(0, 9, 5).astype(np.int32)},
        "blob": b"\x00\x01raw bytes\xff",
        "shape": (2, 3),
        "tags": ["a", None, True, 1.5, [np.arange(3, dtype=np.int16)]],
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for key in want:
            _assert_same(got[key], want[key])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


def test_encode_is_byte_identical_to_jax(monkeypatch):
    # np.savez stamps each zip entry with the local time: pin the clock
    clock = types.SimpleNamespace(time=lambda: 1.7e9, localtime=zipfile.time.localtime)
    monkeypatch.setattr(zipfile, "time", clock)
    msg = _message()
    assert port_net._encode(msg) == jax_net._encode(msg)
    assert port_net._encode({}) == jax_net._encode({})
    _assert_same(port_net._decode(jax_net._encode(msg)), jax_net._decode(jax_net._encode(msg)))


@pytest.mark.parametrize("sender,receiver", [(port_net, jax_net), (jax_net, port_net),
                                             (port_net, port_net)],
                         ids=["port_to_jax", "jax_to_port", "port_to_port"])
def test_frames_cross_between_the_packages(sender, receiver):
    a, b = socket.socketpair()
    try:
        msg = _message()
        sender.send_data(a, msg)
        sender.send_data(a, [1, 2])
        want = receiver._decode(receiver._encode(msg))
        _assert_same(receiver.recv_data(b), want)
        assert receiver.recv_data(b) == [1, 2]
    finally:
        a.close()
        b.close()


def test_recv_rejects_bad_magic_oversize_and_a_closed_peer():
    a, b = socket.socketpair()
    try:
        a.sendall(b"XXXX" + b"\x00" * 8)
        with pytest.raises(ValueError, match="magic"):
            port_net.recv_data(b)
        a.sendall(port_net._MAGIC + (port_net._MAX_MESSAGE + 1).to_bytes(8, "big"))
        with pytest.raises(ValueError, match="too large"):
            port_net.recv_data(b)
        a.sendall(port_net._MAGIC + (100).to_bytes(8, "big") + b"short")
        a.close()
        with pytest.raises(ConnectionError, match="mid-message"):
            port_net.recv_data(b)
    finally:
        b.close()


def test_connect_sets_nodelay_and_keeps_the_timeout():
    server = socket.create_server(("127.0.0.1", 0))
    try:
        sock = port_net.connect("127.0.0.1", server.getsockname()[1], timeout=5.0)
        peer, _ = server.accept()
        try:
            assert sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
            assert sock.gettimeout() == 5.0
            port_net.send_data(sock, {"x": np.ones(2)})
            np.testing.assert_array_equal(port_net.recv_data(peer)["x"], np.ones(2))
        finally:
            peer.close()
            sock.close()
    finally:
        server.close()


def test_determine_host_address_reads_the_routed_interface(monkeypatch):
    # a fake socket: the UDP connect picks a route and sends nothing
    class FakeSocket:
        def __init__(self, *args):
            self.target = None

        def connect(self, target):
            self.target = target

        def getsockname(self):
            assert self.target is not None
            return ("10.1.2.3", 40000)

        def close(self):
            pass

    monkeypatch.setattr(port_net.socket, "socket", FakeSocket)
    assert port_net.determine_host_address() == "10.1.2.3"

    class NoRoute(FakeSocket):
        def connect(self, target):
            raise OSError("network unreachable")

    monkeypatch.setattr(port_net.socket, "socket", NoRoute)
    monkeypatch.setattr(port_net.socket, "gethostname", lambda: "localhost")
    assert port_net.determine_host_address() == socket.gethostbyname("localhost")


def test_initialize_needs_the_group_size_and_rank_with_an_address():
    with pytest.raises(ValueError, match="num_processes"):
        port_net.initialize("127.0.0.1:1", device="cpu")
    if not torch.cuda.is_available():  # NCCL on the card by default: raises here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_net.initialize("127.0.0.1:1", 1, 0)
    port_net.shutdown()  # no group: a no-op


def test_initialize_and_shutdown_over_gloo_in_a_subprocess():
    script = textwrap.dedent("""
        import os, socket
        import torch, torch.distributed as dist
        from distkeras_tpu_torch import networking

        def free_port():
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                return s.getsockname()[1]

        networking.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
        t = torch.arange(4.0)
        dist.all_reduce(t)
        assert t.tolist() == [0.0, 1.0, 2.0, 3.0]
        networking.shutdown()
        assert not dist.is_initialized()

        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                          WORLD_SIZE="1", RANK="0")
        networking.initialize(device="cpu")  # torchrun's env://
        assert dist.get_world_size() == 1
        networking.shutdown()
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
