"""``chip_smoke.py``'s training-suite, flow, head-dim, networking, epochs,
streaming, checkpoint and remat/graph phases rehearsed on the CPU.

The script runs on an H100; here those phases run on the CPU
(``ZOO_DEVICE = "cpu"``) at small batches, windows, row counts and model
sizes, with the CUDA timers replaced by the host clock, so a fault in their
control flow, their checks or their JSON shows before a card is asked for.
The numbers they print here are the CPU's and mean nothing for the card;
the flow phase's accuracy gate is set for the card's 48,000 training rows
and is not held on the rehearsal's 480.  On the CPU ``unroll`` is a hint,
so the graph phases' capture runs only in the ``cuda``-marked test, which
skips here.  Without a card the script itself must exit non-zero and print
no result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


def _host_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "ZOO_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "cuda_ms", _host_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    # batch 4, window 2: the configurations' widths, far fewer rows
    monkeypatch.setattr(chip_smoke, "ZOO_CONFIGS",
                        [c[:4] + (4,) + c[5:] for c in chip_smoke.ZOO_CONFIGS])
    monkeypatch.setattr(chip_smoke, "ZOO_WINDOW", 2)
    monkeypatch.setattr(chip_smoke, "ZOO_STEP_ROWS", 4)
    monkeypatch.setattr(chip_smoke, "ZOO_PREDICT_ROWS", 8)
    monkeypatch.setattr(chip_smoke, "STALENESS_SCHEDULE", (2, 4))
    monkeypatch.setattr(chip_smoke, "STALENESS_STEPS", 8)
    monkeypatch.setattr(chip_smoke, "STALENESS_BATCH", 4)


def _emitted(capsys, phase):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{") and json.loads(line).get("phase") == phase]


def test_zoo_phase_rehearsal(on_cpu, capsys):
    rows = chip_smoke.zoo_phase(0)
    printed = _emitted(capsys, "zoo")
    assert [(r["config"], r["trainer"]) for r in printed] == [
        (c[0], c[1]) for c in chip_smoke.ZOO_CONFIGS]
    assert len(rows) == 7 and all(not r["failures"] for r in rows)
    for row in rows:
        assert row["num_updates"] == row["expected_num_updates"]
        assert row["step_f64_max_grad_rel_norm_err"] < 1e-9  # one device: the same step
        assert all(v > 0 for v in (row["seconds_per_step"], row["samples_per_s"]))
    by_name = {r["config"]: r for r in rows}
    assert by_name["cifar_cnn_downpour"]["bitwise_repeatable"] is True
    assert by_name["cifar_resnet20_adag"]["running_stats_equal_across_workers"] is True
    # no device time on the CPU: the profiler split reports none
    assert by_name["cifar_resnet20_adag"]["model_profile"]["device_ms_per_call"] is None


def test_staleness_phase_rehearsal(on_cpu, capsys):
    row = chip_smoke.staleness_phase(0)
    assert _emitted(capsys, "staleness") == [{"phase": "staleness", **row}]
    # periods 2 and 4 over 8 steps, 2 epochs: 4 + 2 commits an epoch
    assert row["num_updates"] == row["expected_num_updates"] == 12
    assert row["clocks"] == row["expected_clocks"] and row["stale_commits"] > 0


def test_without_a_card_the_script_fails_with_no_result(tmp_path):
    # alone in a directory, as it must also fail there
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    for cwd, path in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, script)):
        proc = subprocess.run([sys.executable, str(path)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_flow_phase_rehearsal(on_cpu, capsys, monkeypatch):
    from distkeras_tpu_torch.utils.tb import ScalarLogger

    monkeypatch.setattr(ScalarLogger, "_try_torch", lambda self: False)  # the JSONL sink
    monkeypatch.setattr(chip_smoke, "FLOW_ROWS", 600)
    monkeypatch.setattr(chip_smoke, "FLOW_CNN_BATCH", 64)
    monkeypatch.setattr(chip_smoke, "FLOW_CPU_ROWS", 64)
    monkeypatch.setattr(chip_smoke, "FLOW_MIN_ACCURACY", {"MLP": 0.0, "MNISTCNN": 0.0})
    rows = chip_smoke.flow_phase(0)
    printed = _emitted(capsys, "flow")
    assert [r["trainer"] for r in printed] == [t[0] for t in chip_smoke.FLOW_TRAINERS]
    for row in rows:
        assert not row["failures"] and row["scalar_sink"] == "jsonl"
        assert row["accuracy"] == row["accuracy_recount"]
        assert row["scalar_lines"] == chip_smoke.FLOW_EPOCHS
        assert row["scalar_loss"] == row["loss"]
        assert row["num_updates"] == row["expected_num_updates"]
        assert row["predict_max_abs_err_vs_cpu"] == 0.0  # one device: the same numbers
    by_name = {r["trainer"]: r for r in rows}
    # 480 training rows, 2 workers of batch 32, window 5: 8 steps, 2 windows
    assert by_name["DOWNPOUR"]["expected_num_updates"] == 2 * 2 * 2


def test_head_dim_phase_rehearsal(on_cpu, capsys, monkeypatch):
    # the models' widths cut to a CPU's size, their head dims kept (96 and 8)
    monkeypatch.setattr(chip_smoke, "LM_D96", dict(vocab_size=64, dim=192, heads=2,
                                                   num_layers=2, max_len=16))
    out = chip_smoke.head_dim_phase(0)
    assert [r["case"] for r in _emitted(capsys, "head_dim_models")] == ["lm_d96", "classifier_d8"]
    assert out["lm_d96"]["expected_launches"] == 2
    assert out["classifier_d8"]["expected_launches"] == 2 * 64 // 16
    assert 1.0 < out["lm_d96"]["perplexity"] < 1e3


def test_networking_phase_rehearsal(on_cpu, capsys):
    row = chip_smoke.networking_phase(0)
    assert _emitted(capsys, "networking") == [{"phase": "networking", **row}]
    assert row["backend"] == "gloo" and row["wire_round_trip"] and row["group_left"]


def test_epochs_streaming_checkpoint_phases_rehearsal(on_cpu, capsys, monkeypatch):
    import signal

    sigterm = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(chip_smoke, "EPOCHS_WINDOWS", 1)
    eager, frame, x, _ = chip_smoke.epochs_phase(0)
    rows = _emitted(capsys, "epochs")
    assert [r["mode"] for r in rows] == ["eager", "dispatch_epochs", "graph"]
    # 2 workers x 1 window x 2 steps x batch 4, 2 epochs
    assert len(x) == len(frame) == 16 and rows[0]["local_steps"] == 8
    for row in rows[1:]:
        assert row["vs_eager"]["bitwise"]  # unroll is a hint on the CPU
    assert rows[2]["graphs"] is False and rows[2]["graph_stats"]["captures"] == 0
    assert all(r["steady_seconds_per_step"] > 0 and r["device_busy_share"] is None for r in rows)

    streamed = chip_smoke.streaming_phase(0, eager, frame)
    assert [r["prefetch"] for r in streamed] == [0, 2]
    for row in streamed:
        assert row["native_available"] and row["vs_in_memory"]["bitwise"]
        assert row["last_stream_report"]["windows"] == 1

    row = chip_smoke.checkpoint_phase(0, eager, frame)
    assert _emitted(capsys, "checkpoint") == [{"phase": "checkpoint", **row}]
    assert row["with_checkpoints_vs_eager"]["bitwise"] and row["quarantined"]
    assert row["recovery_calls"] == 3 and len(row["resumed_loss"]) == 1
    assert row["checkpoint_bytes"] > 0 and "tree.json" in row["checkpoint_files"]
    # train_with_recovery's SIGTERM handler is taken down after the phase
    assert signal.getsignal(signal.SIGTERM) is sigterm


TINY_LM = dict(vocab_size=64, dim=32, heads=2, num_layers=2, max_len=16)


def _eager_lm_run(device):
    """The train phase's DOWNPOUR over ``TINY_LM`` (eager), as the remat/graph
    phase's reference."""
    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.models import TransformerLM

    model = TransformerLM(**TINY_LM, generator=torch.Generator().manual_seed(2))
    x, y = chip_smoke.lm_task(chip_smoke.TRAIN_ROWS, TINY_LM["max_len"],
                              TINY_LM["vocab_size"], 2)
    trainer = tdk.DOWNPOUR(model, loss="token_crossentropy", metrics=("token_accuracy",),
                           worker_optimizer=("adam", {"learning_rate": 2e-4}),
                           num_workers=chip_smoke.TRAIN_WORKERS,
                           batch_size=chip_smoke.TRAIN_BATCH,
                           communication_window=chip_smoke.TRAIN_WINDOW,
                           num_epoch=chip_smoke.TRAIN_EPOCHS, seed=0, device=device)
    trained = trainer.train(tdk.from_numpy(x, y))
    return dict(loss=trainer.get_history()["loss"],
                params={k: v.detach().float().cpu().clone() for k, v in trained.params.items()})


def test_remat_graph_phase_rehearsal(on_cpu, capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke, "REMAT_MODEL", TINY_LM)
    row = chip_smoke.remat_graph_phase(0, _eager_lm_run("cpu"))
    assert _emitted(capsys, "remat_graph") == [{"phase": "remat_graph", **row}]
    assert not row["failures"] and row["dropout"] > 0 and row["dropout_changed_loss"]
    # remat's recomputation draws the forward's masks: bitwise on the CPU
    assert row["remat_vs_eager"]["bitwise"] and row["graph_vs_eager"]["bitwise"]
    # the CPU runs the plain attention: no kernel launch to count
    assert row["launches_eager"] == row["launches_remat"] == [0, 0, 0]
    assert row["graphs"] is False and row["expected_launches_graph"] == 2 * 16 + 2 * 2 * 2
    assert "fresh_masks_each_replay" not in row  # no graph to replay on the CPU


@pytest.mark.cuda
def test_remat_graph_phase_on_the_card(monkeypatch, capsys):
    # the phase at the tiny widths: remat and the captured windows through
    # DOWNPOUR with dropout, B1-B3 inside the graph, fresh masks each replay
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    monkeypatch.setattr(chip_smoke, "REMAT_MODEL", TINY_LM)
    row = chip_smoke.remat_graph_phase(0, _eager_lm_run("cuda"))
    assert not row["failures"] and row["graphs"] is True
    assert row["graph_stats"]["captures"] == 1 and row["graph_stats"]["replays"] == 4
    expected = row["expected_launches_eager"]
    assert row["launches_eager"] == [expected] * 3 == [2 * 16] * 3
    assert row["launches_remat"] == [2 * expected, expected, expected]
    assert row["fresh_masks_each_replay"] and row["replay_repeatable"]


@pytest.fixture
def tiny_serving(monkeypatch):
    # the phase's widths cut to a CPU's size, its head dims (64) kept
    monkeypatch.setattr(chip_smoke, "SERVE_MODEL", dict(vocab_size=64, dim=128, heads=2,
                                                        num_layers=2, max_len=64))
    monkeypatch.setattr(chip_smoke, "SERVE_DRAFT", dict(vocab_size=64, dim=64, heads=1,
                                                        num_layers=2, max_len=64))
    monkeypatch.setattr(chip_smoke, "SERVE_GREEDY", (2, 8, 6))
    monkeypatch.setattr(chip_smoke, "SERVE_SLOTS", 3)
    monkeypatch.setattr(chip_smoke, "SERVE_PAGE", 8)
    monkeypatch.setattr(chip_smoke, "SERVE_REQUESTS", 6)
    monkeypatch.setattr(chip_smoke, "SERVE_PROMPT_LEN", (4, 20))
    monkeypatch.setattr(chip_smoke, "SERVE_NEW_TOKENS", (4, 10))
    monkeypatch.setattr(chip_smoke, "SERVE_STAGGER_S", 0.005)
    monkeypatch.setattr(chip_smoke, "SERVE_SPEC_PROMPTS", 2)
    monkeypatch.setattr(chip_smoke, "SERVE_PREDICT", (4, 6, 4))
    monkeypatch.setattr(chip_smoke, "SERVE_PROFILE", (8, 4))


def test_serving_phase_rehearsal(on_cpu, tiny_serving, capsys):
    out = chip_smoke.serving_phase(0)
    printed = _emitted(capsys, "serving")
    assert [r["case"] for r in printed] == ["greedy", "engine", "speculative"]
    greedy, engine, spec = out["greedy"], out["engine"], out["speculative"]
    # the CPU runs the plain attention: no kernel launch to count
    assert greedy["launches_b1"] == greedy["launches_b1_check"] == engine["launches_b1"] == 0
    assert engine["launches_b2_b3"] == [0, 0]
    assert greedy["departures"] == [] and engine["greedy_departures"] == []
    assert engine["eos_finish"] == "eos" and engine["queue_full_rejected"] == 1
    assert engine["pages_after"] == 0 and 0 < engine["peak_pages"] <= engine["pages_total"]
    assert engine["buckets"] == [8, 16, 32, 64]
    assert set(engine["prefill_ms"]) <= {8, 16, 32, 64} and engine["decode_steps"] > 0
    assert engine["ttft_ms_p50"] <= engine["ttft_ms_p99"]
    # no profiler on the CPU
    assert engine["profiled_decode"]["device_busy_share"] is None
    assert engine["profiled_decode"]["device_ops_per_step"] is None
    assert 0 < engine["decode_tokens_per_s"] and 0 < engine["generated_tokens_per_s"]
    faithful = spec["faithful"]
    assert faithful["accept_rate"] == 1.0 and faithful["steps_per_decode_token"] < 1
    # one request at a time: a step emits at least one token, so never more
    # steps than decode tokens
    assert spec["draft"]["steps_per_decode_token"] <= 1
    assert spec["draft"]["departures"] == [] and spec["draft"]["proposed"] > 0


@pytest.mark.cuda
def test_serving_phase_on_the_card(tiny_serving, capsys):
    # the phase at the tiny widths on the card: its checks, B1 in the check
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = chip_smoke.serving_phase(0)
    assert out["greedy"]["launches_b1"] == out["engine"]["launches_b1"] == 0
    assert out["engine"]["launches_b2_b3"] == [0, 0]
    assert out["greedy"]["launches_b1_check"] == 2
    assert out["engine"]["profiled_decode"]["steps"] > 0
    assert out["engine"]["profiled_decode"]["device_ops_per_step"] > 0
