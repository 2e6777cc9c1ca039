"""Ring attention and the named-axis collectives of the port, over four
gloo ranks on the CPU, against the JAX package's ``ring_attention_sharded``
on four of its CPU devices.

Four ranks are spawned **once** for the module (``ranks`` fixture): each
runs this file as a script (``python tests/test_torch_ring.py RANK WORLD
INIT DIR``; only torch and the port are imported there), joins the gloo
group through the file store ``INIT`` in the module's directory, runs every case and writes its own
``rank_<r>.npz``.  The same inputs come from one numpy seed on both sides.

Tolerances: the JAX test's ring bound (tests/test_ring_attention.py),
values ``rtol=2e-4, atol=2e-5`` and gradients ``rtol=5e-4, atol=5e-5``;
the port's ring against the port's own unsharded attention within the same;
the collectives, which move and add a few small integers, exactly.

:func:`spawn_ranks` is shared with ``test_torch_sequence_parallel.py`` and
``test_torch_fsdp_sp.py``, and the capture helpers (:func:`recording_collectives`,
:func:`host_reads`, :func:`faked_card`, :func:`capture_refusals`) with the
several-rank files whose paths a card captures (ROADMAP Queue A item 20).
"""

import contextlib
import os
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
SPAWN_TIMEOUT_S = 300
VALUE_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
VALUE_SHAPE = dict(batch=2, seq=64, heads=4, dim=16, seed=0)
GRAD_SHAPE = dict(batch=1, seq=32, heads=2, dim=8, seed=1)


def qkv(batch, seq, heads, dim, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(batch, seq, heads, dim)).astype(np.float32)
                 for _ in range(3))


def rendezvous(workdir: str) -> str:
    """A fresh ``init_method`` for one group of spawned ranks: a file store in
    the test's own directory.  A TCP port picked free here and bound by rank
    0 only once it has imported torch could be taken by another process of
    the suite in between; a new path cannot."""
    return "file://" + os.path.join(workdir, f"rendezvous_{uuid.uuid4().hex}")


def start_ranks(script, world: int, workdir: str, extra=()):
    """Start ``python script RANK WORLD INIT WORKDIR *extra`` for every rank
    and return the processes; each writes its output to
    ``WORKDIR/log_<rank>.txt``.  ``script`` is a path, or a list of the
    interpreter's arguments (``["-c", code]``)."""
    script = [script] if isinstance(script, (str, Path)) else list(script)
    init = rendezvous(workdir)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    env.pop("PYTHONSTARTUP", None)
    procs = []
    for r in range(world):
        with open(os.path.join(workdir, f"log_{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, *script, str(r), str(world), init, workdir, *extra],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def wait_ranks(procs, workdir: str, timeout: int = SPAWN_TIMEOUT_S):
    """Wait for every rank of :func:`start_ranks` to its end (a rank left
    waiting on a dead peer is killed); each rank must exit 0."""
    try:
        for proc in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(workdir, f"log_{rank}.txt")) as log:
                raise AssertionError(f"rank {rank} exited {proc.returncode}:\n"
                                     f"{log.read()[-4000:]}")


def spawn_ranks(script, world: int, workdir: str, extra=(), timeout: int = SPAWN_TIMEOUT_S):
    """Run ``python script RANK WORLD INIT WORKDIR *extra`` for every rank to
    its end (:func:`start_ranks`, :func:`wait_ranks`)."""
    wait_ranks(start_ranks(script, world, workdir, extra), workdir, timeout)


# ------------------------------------------- capture on a card, shown on the CPU

#: the ``torch.distributed`` calls of ``parallel/mesh.py``'s transports and
#: of the serving engine's plans
_DIST_CALLS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "batch_isend_irecv", "isend", "irecv")


@contextlib.contextmanager
def recording_collectives():
    """Record every collective this process issues in the block, on any
    thread, in issue order, as ``[call, group size, shapes, dtype]``: a
    program captured on a card replays its collectives, so every rank of a
    group must issue the same ones in the same order."""
    import torch.distributed as dist

    log, saved = [], {name: getattr(dist, name) for name in _DIST_CALLS}

    def recorded(name, call):
        def wrapper(*args, **kwargs):
            tensors = []
            for a in (*args, *kwargs.values()):
                for t in (a if isinstance(a, (list, tuple)) else (a,)):
                    if isinstance(t, torch.Tensor):
                        tensors.append(t)
                    elif isinstance(t, dist.P2POp):
                        tensors.append(t.tensor)
            group = kwargs.get("group")
            log.append([name, dist.get_world_size(group) if group is not None else 0,
                        [list(t.shape) for t in tensors],
                        str(tensors[0].dtype) if tensors else ""])
            return call(*args, **kwargs)

        return wrapper

    for name, call in saved.items():
        setattr(dist, name, recorded(name, call))
    try:
        yield log
    finally:
        for name, call in saved.items():
            setattr(dist, name, call)


@contextlib.contextmanager
def host_reads():
    """The runtime sanitizer's transfer guard in record mode around the
    block on this thread: the block's host reads of a tensor (``item``,
    ``tolist``, ``numpy``, ...) land in the returned list, which holds
    their messages once the block ends.  On the CPU this is the proxy for
    "capturable": a captured program reads nothing on the host.  (Strict
    mode would raise on the first read, on one rank, and leave the other
    ranks waiting in a collective.)"""
    from distkeras_tpu_torch import sanitizer
    from distkeras_tpu_torch.sanitizer import runtime, transfer

    found = []
    sanitizer.configure("record")
    try:
        with transfer.guard("captured program"):
            yield found
        found.extend(message for _, message in runtime.violations("transfer"))
    finally:
        sanitizer.configure(None)


@contextlib.contextmanager
def faked_card(backend=None):
    """The engines' constructors told the device is a card (they allocate
    nothing on it), and with ``backend`` every process group said to run
    it: the constructors' checks alone, on the CPU."""
    import torch.distributed as dist

    from distkeras_tpu_torch.parallel import engine, pipeline
    from distkeras_tpu_torch.serving import engine as serving

    card = lambda device="cuda": torch.device("cuda", 0)
    saved = [(m, "resolve_device", m.resolve_device) for m in (engine, pipeline, serving)]
    if backend is not None:
        saved.append((dist, "get_backend", dist.get_backend))
    try:
        for m, name, _ in saved[:3]:
            setattr(m, name, card)
        if backend is not None:
            dist.get_backend = lambda group=None: backend
        yield
    finally:
        for m, name, value in saved:
            setattr(m, name, value)


def capture_refusals(build) -> dict:
    """``build()`` (an engine's constructor call) on a faked card whose
    groups run NCCL, then gloo: ``{backend: "captures" or the error}``."""
    out = {}
    for backend in ("nccl", "gloo"):
        try:
            with faked_card(backend):
                engine = build()
            out[backend] = "captures" if engine.use_graphs else "eager"
        except (ValueError, NotImplementedError) as e:
            out[backend] = f"{type(e).__name__}: {e}"
    return out


# ------------------------------------------------------------------ the ranks

def _collective_cases(rank, device):
    """Each collective over one axis of the 2 x 2 grid, forward and
    backward, on inputs and cotangents that name their rank."""
    from distkeras_tpu_torch.parallel.mesh import (
        all_gather,
        bind_mesh,
        make_mesh_grid,
        pmean,
        ppermute,
        psum,
    )

    grid = make_mesh_grid(2, 2)
    base = torch.arange(6.0, device=device).reshape(2, 3)
    out = {}
    with bind_mesh(grid):
        for name, fn in (
            ("gather_seq_0", lambda x: all_gather(x, "seq", 0)),
            ("gather_seq_1", lambda x: all_gather(x, "seq", 1)),
            ("psum_workers", lambda x: psum(x, "workers")),
            ("pmean_seq", lambda x: pmean(x, "seq")),
            ("ppermute_seq", lambda x: ppermute(x, "seq", 1)),
            ("ppermute_workers", lambda x: ppermute(x, "workers", -1)),
        ):
            x = (base + 100 * rank).requires_grad_(True)
            y = fn(x)
            cot = torch.arange(float(y.numel()), device=device).reshape(y.shape) + 1000 * rank
            (g,) = torch.autograd.grad((y * cot).sum(), x)
            out[f"{name}/y"], out[f"{name}/grad"] = y.detach().cpu().numpy(), g.cpu().numpy()
    return out


def _ring_cases(device):
    from distkeras_tpu_torch.parallel.mesh import make_mesh
    from distkeras_tpu_torch.parallel.ring import ring_attention_sharded

    mesh = make_mesh(WORLD, axis_name="seq")
    out = {}
    for causal in (False, True):
        q, k, v = (torch.from_numpy(a).to(device) for a in qkv(**VALUE_SHAPE))
        out[f"values/{causal}"] = ring_attention_sharded(q, k, v, mesh, "seq",
                                                         causal).cpu().numpy()
        q, k, v = (torch.from_numpy(a).to(device).requires_grad_(True)
                   for a in qkv(**GRAD_SHAPE))
        loss = (ring_attention_sharded(q, k, v, mesh, causal=causal) ** 2).sum()
        for name, g in zip("qkv", torch.autograd.grad(loss, (q, k, v))):
            out[f"grad_{name}/{causal}"] = g.cpu().numpy()
    return out


def _rank_main(rank: int, world: int, init: str, workdir: str, device: str = "cpu",
               backend: str = "gloo") -> None:
    """Every case on ``device``: over gloo on a card the four ranks share
    ``cuda:0`` and the seq collectives are staged through the host; over
    NCCL each rank has a card of its own."""
    import torch.distributed as dist

    from distkeras_tpu_torch.parallel.mesh import transport_stats

    if device == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=init,
                            world_size=world, rank=rank)
    try:
        out = {**_ring_cases(device), **_collective_cases(rank, device)}
    finally:
        dist.destroy_process_group()
    out["host_staged_bytes"] = np.asarray(transport_stats["host_staged_bytes"])
    np.savez(os.path.join(workdir, f"rank_{rank}.npz"), **out)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], *sys.argv[5:])
    sys.exit(0)


# ------------------------------------------------------------- test process

def _spawned(workdir, device="cpu", backend="gloo"):
    """Every rank's results: a list, rank by rank."""
    spawn_ranks(__file__, WORLD, workdir, extra=(device, backend))
    out = []
    for r in range(WORLD):
        with np.load(os.path.join(workdir, f"rank_{r}.npz")) as data:
            out.append({k: data[k] for k in data.files})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _spawned(str(tmp_path_factory.mktemp("ring")))


def _jax_ring(q, k, v, causal):
    from distkeras_tpu.parallel.mesh import make_mesh
    from distkeras_tpu.parallel.ring import ring_attention_sharded

    return ring_attention_sharded(q, k, v, make_mesh(WORLD), causal=causal)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_values_match_jax_at_four_shards(ranks, causal):
    import jax.numpy as jnp

    want = np.asarray(_jax_ring(*(jnp.asarray(a) for a in qkv(**VALUE_SHAPE)), causal))
    for r, got in enumerate(ranks):  # every rank returns the global output
        np.testing.assert_allclose(got[f"values/{causal}"], want, **VALUE_TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_jax_at_four_shards(ranks, causal):
    import jax
    import jax.numpy as jnp

    # jitted: op by op, the shard_map's grad takes ~8 s on the CPU
    grad_fn = jax.jit(jax.grad(lambda q, k, v: jnp.sum(_jax_ring(q, k, v, causal) ** 2),
                               argnums=(0, 1, 2)))
    grads = grad_fn(*(jnp.asarray(a) for a in qkv(**GRAD_SHAPE)))
    for r, got in enumerate(ranks):
        for name, want in zip("qkv", grads):
            np.testing.assert_allclose(got[f"grad_{name}/{causal}"], np.asarray(want),
                                       **GRAD_TOL, err_msg=f"rank {r} d{name}")


def _assert_ring_matches_unsharded(got, causal):
    from distkeras_tpu_torch.parallel.ring import local_attention

    q, k, v = (torch.from_numpy(a) for a in qkv(**VALUE_SHAPE))
    want = local_attention(q, k, v, causal=causal).numpy()
    np.testing.assert_allclose(got[f"values/{causal}"], want, **VALUE_TOL)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in qkv(**GRAD_SHAPE))
    grads = torch.autograd.grad((local_attention(q, k, v, causal=causal) ** 2).sum(), (q, k, v))
    for name, want in zip("qkv", grads):
        np.testing.assert_allclose(got[f"grad_{name}/{causal}"], want.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_the_ports_unsharded_attention(ranks, causal):
    _assert_ring_matches_unsharded(ranks[0], causal)


def _expected(name, rank):
    """A collective's output and input gradient at ``rank`` of the 2 x 2
    (workers, seq) grid: rank ``(w, s)`` is ``2 w + s``."""
    w, s = divmod(rank, 2)
    x = lambda r: np.arange(6.0).reshape(2, 3) + 100 * r
    cot = lambda r, shape: np.arange(float(np.prod(shape))).reshape(shape) + 1000 * r
    seq_peers, worker_peers = [2 * w, 2 * w + 1], [s, 2 + s]
    if name.startswith("gather_seq"):
        dim = int(name[-1])
        y = np.concatenate([x(r) for r in seq_peers], axis=dim)
        # the backward is a reduce-scatter: this rank's block, summed over seq
        total = sum(cot(r, y.shape) for r in seq_peers)
        return y, np.split(total, 2, axis=dim)[s]
    if name == "psum_workers":
        return sum(x(r) for r in worker_peers), sum(cot(r, (2, 3)) for r in worker_peers)
    if name == "pmean_seq":
        return (sum(x(r) for r in seq_peers) / 2, sum(cot(r, (2, 3)) for r in seq_peers) / 2)
    if name == "ppermute_seq":  # a ring of two: the other seq rank, both ways
        other = seq_peers[1 - s]
        return x(other), cot(other, (2, 3))
    # ppermute over workers by -1: from the next workers rank, cotangent back to it
    other = worker_peers[1 - w]
    return x(other), cot(other, (2, 3))


@pytest.mark.parametrize("name", ["gather_seq_0", "gather_seq_1", "psum_workers", "pmean_seq",
                                  "ppermute_seq", "ppermute_workers"])
def test_collective_forward_and_backward_stay_on_their_axis(ranks, name):
    _assert_collective(ranks, name)


def _assert_collective(ranks, name):
    for rank, got in enumerate(ranks):
        y, grad = _expected(name, rank)
        np.testing.assert_array_equal(got[f"{name}/y"], y, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got[f"{name}/grad"], grad, err_msg=f"rank {rank}")


def test_gloo_moves_cpu_tensors_directly(ranks):
    assert all(int(got["host_staged_bytes"]) == 0 for got in ranks)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_cuda_tensors_on_gloo_and_nccl(tmp_path, backend):
    # gloo: four ranks sharing cuda:0, the ring and every collective on CUDA
    # tensors staged through pinned host memory (ROADMAP C11); NCCL: one
    # rank a card, NCCL's own collectives, nothing staged
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these routes move CUDA tensors")
    if backend == "nccl" and torch.cuda.device_count() < WORLD:
        pytest.skip(f"NCCL needs one card a rank: {WORLD} cards")
    ranks = _spawned(str(tmp_path), "cuda", backend)
    staged = [int(got["host_staged_bytes"]) for got in ranks]
    assert all(b > 0 for b in staged) if backend == "gloo" else not any(staged)
    for causal in (False, True):
        _assert_ring_matches_unsharded(ranks[0], causal)
    for name in ("gather_seq_0", "gather_seq_1", "psum_workers", "pmean_seq", "ppermute_seq",
                 "ppermute_workers"):
        _assert_collective(ranks, name)


def test_unbound_axis_raises():
    from distkeras_tpu_torch.parallel.ring import ring_attention

    q = torch.zeros(1, 4, 1, 2)
    with pytest.raises(ValueError, match="not bound"):
        ring_attention(q, q, q, "seq")
