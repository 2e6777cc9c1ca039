"""The runtime sanitizer on a card: the transfer guard's card layer (torch's
sync debug mode, armed in strict mode) and what runs under it.  A planted
sync the interposition does not see (``torch.nonzero`` of a CUDA tensor)
raises naming the guard, the previous mode comes back when the last guard
closes, and nested guards work; an eager and a captured (``unroll``) epoch
run strict with no violation, bit for bit the sanitizer-off runs; the
serving engine's read-backs, declared, do not trip another thread's strict
guard; two gloo ranks sharing the card train strict, their collectives'
host staging declared.  Every case is ``cuda``-marked and skips without a
card; no JAX here (the card's machine has none)."""

import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import sanitizer
from distkeras_tpu_torch.algorithms import Downpour
from distkeras_tpu_torch.models import TorchModel, TransformerLM
from distkeras_tpu_torch.parallel import WindowedEngine
from distkeras_tpu_torch.sanitizer import donation, transfer
from distkeras_tpu_torch.sanitizer.transfer import TransferViolation

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

LM = dict(vocab_size=23, dim=32, heads=2, num_layers=1, max_len=16)
WORKERS, WINDOWS, WINDOW, BATCH = 2, 2, 2, 4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card layer is torch's CUDA sync debug mode")


@pytest.fixture(autouse=True)
def reset_sanitizer():
    yield
    sanitizer.configure(None)
    donation.reset_stats()
    transfer.reset_stats()


def lm_epoch(seed=0):
    n = WORKERS * WINDOWS * WINDOW * BATCH
    start = np.random.default_rng(seed).integers(0, LM["vocab_size"], (n, 1))
    x = (start + np.arange(LM["max_len"])) % LM["vocab_size"]
    shape = (WORKERS, WINDOWS, WINDOW, BATCH, LM["max_len"])
    return (x.reshape(shape).astype(np.int64),
            ((x + 1) % LM["vocab_size"]).reshape(shape).astype(np.int64))


def _run(mode, unroll, epochs=2):
    sanitizer.configure(mode)
    model = TransformerLM(**LM, dropout=0.1, generator=torch.Generator().manual_seed(1))
    engine = WindowedEngine(TorchModel(model), "token_crossentropy",
                            ("adam", {"learning_rate": 1e-3}), Downpour(WINDOW),
                            num_workers=WORKERS, metrics=(), unroll=unroll, device="cuda")
    xs, ys = lm_epoch()
    state = engine.init_state(torch.Generator().manual_seed(0), torch.from_numpy(xs[0, 0, 0]))
    xs, ys = engine.shard_batches(xs, ys)
    losses = []
    for _ in range(epochs):
        state, stats = engine.run_epoch(state, xs, ys)
        losses.append(stats["loss"])
    center = {k: v.cpu() for k, v in engine.gather_center(state).items()}
    return np.concatenate(losses), center, engine


@pytest.mark.cuda
def test_card_layer_catches_a_sync_the_interposition_does_not_see():
    _card()
    sanitizer.configure("strict")
    x = torch.arange(8, device="cuda")
    before = torch.cuda.get_sync_debug_mode()
    with pytest.raises(TransferViolation, match="guard 'planted'"):
        with transfer.guard("planted"):
            torch.nonzero(x)
    assert torch.cuda.get_sync_debug_mode() == before
    assert torch.nonzero(x).shape == (7, 1)  # outside the guard: legal
    with transfer.guard("outer"):
        with transfer.guard("inner"):
            assert torch.cuda.get_sync_debug_mode() == 2  # "error"
        assert torch.cuda.get_sync_debug_mode() == 2  # the outer guard's
        with transfer.allow("declared"):
            assert torch.nonzero(x).shape == (7, 1)
    assert torch.cuda.get_sync_debug_mode() == before
    sanitizer.configure("record")  # record mode arms the interposition only
    with transfer.guard("record"):
        torch.nonzero(x)
    assert sanitizer.violations() == []


@pytest.mark.cuda
def test_interposition_reports_a_cuda_item():
    _card()
    sanitizer.configure("strict")
    x = torch.ones(2, device="cuda")
    with pytest.raises(TransferViolation, match=r"Tensor.item\(\) reads the tensor"):
        with transfer.guard("item"):
            x.sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, True])
def test_strict_epochs_are_clean_and_bitwise_off(unroll):
    _card()
    off_loss, off_center, _ = _run("off", unroll)
    on_loss, on_center, engine = _run("strict", unroll)
    assert sanitizer.violations() == []
    assert np.array_equal(on_loss, off_loss)
    assert all(torch.equal(on_center[k], v) for k, v in off_center.items())
    assert donation.stats()["boundaries"] == 2
    if unroll is True:
        assert engine.graph_stats["captures"] >= 1
        assert transfer.stats()["declared"].get("graph capture set-up", 0) >= 1


@pytest.mark.cuda
def test_serving_read_backs_do_not_trip_another_threads_guard():
    _card()
    from distkeras_tpu_torch.serving import ServingEngine
    from distkeras_tpu_torch.telemetry.metrics import Registry

    sanitizer.configure("strict")
    model = TransformerLM(vocab_size=23, dim=32, heads=2, num_layers=1, max_len=32)
    params = {k: v.detach().cuda() for k, v in model.named_parameters()}
    engine = ServingEngine(model, params, num_slots=2, page_size=8, registry=Registry())
    try:
        alone = engine.generate([1, 2, 3], 6, timeout=120).tokens
        opened, done = threading.Event(), threading.Event()

        def hold():
            with transfer.guard("training thread"):
                opened.set()
                done.wait(timeout=120)

        th = threading.Thread(target=hold)
        th.start()
        assert opened.wait(timeout=30)
        try:
            under = engine.generate([1, 2, 3], 6, timeout=120).tokens
        finally:
            done.set()
            th.join(timeout=30)
        assert under == alone and engine.alive
    finally:
        engine.stop()
    assert sanitizer.violations() == []
    assert transfer.stats()["declared"]["serving read-back"] >= 12


def _gloo_rank(rank: int, world: int, init: str, workdir: str) -> None:
    """One of two gloo ranks sharing the card: a strict two-epoch run."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        loss, _, _ = _run("strict", 1)
        out = {"loss": loss.tolist(), "violations": sanitizer.violations(),
               "declared": transfer.stats()["declared"]}
        if rank == 0:
            with open(os.path.join(workdir, "gloo.json"), "w") as fh:
                json.dump(out, fh)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_gloo_pair_on_one_card_stages_as_a_declared_transfer(tmp_path):
    _card()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_ring import spawn_ranks

    spawn_ranks(__file__, 2, str(tmp_path), timeout=600)
    got = json.load(open(tmp_path / "gloo.json"))
    assert got["violations"] == []
    assert got["declared"].get("gloo host staging", 0) >= 1
    one, _, _ = _run("off", 1)
    np.testing.assert_allclose(got["loss"], one, rtol=1e-5)


if __name__ == "__main__":
    _gloo_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
