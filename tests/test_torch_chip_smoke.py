"""``chip_smoke.py``'s training-suite, flow, head-dim, networking, epochs,
streaming, checkpoint, remat/graph, serving, packing, mesh, seq, tp,
serving_tp, moe and pipeline phases rehearsed on the CPU.

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

import numpy as np
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
    # unroll is a hint on the CPU: the same eager steps, bit for bit
    unroll = row["unroll"]
    assert unroll["graphs"] is False and unroll["versus_eager"]["bitwise"]
    assert unroll["clocks"] == row["clocks"] and unroll["num_updates"] == 12


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
    assert row["remat_graph_vs_eager"]["bitwise"]
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
    # remat inside the captured windows: B1 twice a forward, in the graph
    assert row["remat_graph_stats"] == {"captures": 1, "replays": 4}
    graphed = row["expected_launches_graph"]
    assert row["launches_remat_graph"] == [2 * graphed, graphed, graphed]
    assert row["remat_graph_replays"] == {"fresh_masks_each_replay": True,
                                          "replay_repeatable": True}


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
    assert [r["case"] for r in printed] == ["greedy", "engine", "speculative", "bf16_pools"]
    greedy, engine, spec = out["greedy"], out["engine"], out["speculative"]
    # bf16 page pools under f32 parameters: half the bytes, greedy's tokens
    bf16 = out["bf16_pools"]
    assert bf16["pool_dtypes"] == ["torch.bfloat16"]
    assert 2 * bf16["pool_bytes"] == bf16["pool_bytes_f32"] == engine["pool_bytes"]
    assert bf16["requests"] == 2 and bf16["gap_limit"] >= chip_smoke.GREEDY_GAP
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
    # captured against eager: the CPU runs both eagerly, and nothing captures
    assert engine["eager_equal"] and engine["swap_eager_equal"]
    assert spec["graphs"]["eager_equal"] and engine["swap_requests"] == 4
    for graphs in (engine["graphs"], spec["graphs"]):
        assert graphs["after_swap"]["graph_stats"] == {"captures": 0, "replays": 0}
    assert engine["profiled_decode_eager"]["captured"] is False


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


TINY_PACK = dict(vocab_size=64, dim=32, heads=2, num_layers=2, max_len=64)


def test_packing_phase_rehearsal(on_cpu, capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke, "PACK_MODEL", TINY_PACK)
    monkeypatch.setattr(chip_smoke, "PACK_WIDTH", 64)
    monkeypatch.setattr(chip_smoke, "PACK_MIN_LEN", 4)
    monkeypatch.setattr(chip_smoke, "PACK_SEQUENCES", 80)
    row = chip_smoke.packing_phase(0)
    assert _emitted(capsys, "packing") == [{"phase": "packing", **row}]
    assert row["sequences"] == 80 and row["rows"] >= 16 and 0.5 < row["efficiency"] <= 1.0
    assert 4 <= row["lengths"][0] <= row["lengths"][1] <= 64
    assert row["max_abs_err_packed_vs_alone"] <= chip_smoke.PACK_LOGITS_ATOL
    # the CPU takes the reference path: no launch anywhere
    assert row["launches_packed_forward"] == row["launches_alone"] == 0
    train = row["train"]
    assert train["launches_b1_b2_b3"] == [0, 0, 0] and train["num_updates"] > 0
    assert len(train["loss"]) == chip_smoke.PACK_EPOCHS and train["real_tokens_per_s"] > 0


def test_mesh_phase_rehearsal(on_cpu, capsys, monkeypatch):
    # batch 16 (batch 4 diverges at the configuration's learning rate), 1
    # window of 2 steps an epoch at 4 workers; the spawned gloo ranks take
    # these settings from their spec
    monkeypatch.setattr(chip_smoke, "ZOO_CONFIGS",
                        [c[:4] + (16,) + c[5:] for c in chip_smoke.ZOO_CONFIGS])
    monkeypatch.setattr(chip_smoke, "EPOCHS_WINDOWS", 2)
    monkeypatch.setattr(chip_smoke, "MESH_PREDICT_ROWS", 64)
    import distkeras_tpu_torch as tdk

    x, y = chip_smoke._mesh_frame(0)
    frame = tdk.from_numpy(x, y)
    eager = chip_smoke._trained(chip_smoke._cifar_trainer(0), frame)
    out = chip_smoke.mesh_phase(0, eager, frame, None, None)
    rows = _emitted(capsys, "mesh")
    assert [r["case"] for r in rows] == ["one_rank", "two_ranks_one_card", "cards", "predictor"]
    one = out["one_rank"]
    assert one["backend"] == "gloo" and one["ranks"] == 1 and one["engine_group"]
    assert one["mesh"] == "DeviceMesh" and one["mesh_dim_names"] == ["workers"]
    assert one["vs_no_mesh"]["bitwise"] and "lm" not in one
    two = out["two_ranks"]
    assert two["ranks"] == 2 and two["num_updates"] == two["num_updates_one_rank"] == [4, 8]
    # the workers' own steps are the same sums at one and two ranks
    assert two["f32_vs_one_rank"]["loss_rel_err"] == 0.0
    assert rows[2]["mesh_cards_run"] == 1
    pred = out["predictor"]
    assert pred["two_replicas_one_card"]["mode"] == "distributed"
    assert pred["two_replicas_one_card"]["max_abs_err"] <= chip_smoke.MESH_PREDICT_ATOL


def test_seq_phase_rehearsal(on_cpu, capsys, monkeypatch):
    # phase 19 at TINY_LM's widths: two gloo ranks spawned on the CPU (the
    # (workers, seq) grid 1 x 2), held to the one-rank run made here
    monkeypatch.setattr(chip_smoke, "SEQ_MODEL", TINY_LM)
    monkeypatch.setattr(chip_smoke, "SEQ_PREDICT_ROWS", 2)
    _, reference = chip_smoke.seq_train(0, 1)
    out = chip_smoke.seq_phase(0, reference)
    rows = _emitted(capsys, "seq")
    assert [r["case"] for r in rows] == ["two_ranks_one_card", "cards"]
    assert rows[1]["seq_cards_run"] == 1
    row = out["two_ranks_one_card"]
    assert rows[0] == {"phase": "seq", **row}
    assert not row["failures"] and row["backend"] == "gloo" and row["grid"] == [1, 2]
    assert row["tokens_per_rank"] == TINY_LM["max_len"] // 2
    assert row["fsdp_vs_sp"]["bitwise"] and row["center_bytes_rank0_fsdp"] < row[
        "center_bytes_rank0"]
    assert row["first_window_loss_rel_err"] <= chip_smoke.SEQ_FIRST_LOSS_RTOL
    # the CPU ranks run gloo on CPU tensors: nothing is staged, nothing launched
    assert row["host_staged_bytes_rank0"] == 0
    assert row["launches_b1_b2_b3"] == row["launches_b1_b2_b3_fsdp"] == [0, 0, 0]
    assert row["classifier"]["max_abs_err_vs_one_rank"] <= chip_smoke.SEQ_CLS_ATOL
    twin = row["twin_predictor"]
    assert twin["seq_free"] and twin["finite"] and twin["shape"] == [2, 16, 64]
    for key in ("tokens_per_s", "ring_fwd_ms_per_layer", "num_updates", "card"):
        assert key in row


def test_tp_phase_rehearsal(on_cpu, capsys, monkeypatch):
    # phase 20 at TINY_LM's widths: two gloo ranks spawned on the CPU, the
    # (workers, model) grid 1 x 2 with tp_shards=2 held to the one-rank run
    # made in the phase, then fsdp=True alone (grid 2 x 1) against the
    # replicated two-rank run
    monkeypatch.setattr(chip_smoke, "TP_MODEL", TINY_LM)
    monkeypatch.setattr(chip_smoke, "SEQ_PREDICT_ROWS", 2)
    _, reference = chip_smoke.tp_train(0, chip_smoke.TP_EPOCHS)
    out = chip_smoke.tp_phase(0, reference)
    rows = _emitted(capsys, "tp")
    assert [r["case"] for r in rows] == ["two_ranks_one_card", "cards"]
    assert rows[1]["tp_cards_run"] == 1
    row = out["two_ranks_one_card"]
    assert rows[0] == {"phase": "tp", **row}
    assert not row["failures"] and row["backend"] == "gloo" and row["grid"] == [1, 2]
    assert row["first_window_loss_rel_err"] <= chip_smoke.TP_FIRST_LOSS_RTOL
    # sharded leaves halve: every resident tree a rank is the layout's, less
    # than the one rank's
    for mine, layout, one in row["resident_rank0_layout_one_rank"].values():
        assert mine == layout < one
    fsdp = row["fsdp_alone"]
    assert fsdp["vs_replicated"]["bitwise"] and fsdp["grid"] == [2, 1]
    assert fsdp["center_bytes_rank0"] < fsdp["center_bytes_replicated"]
    # the CPU ranks run gloo on CPU tensors: nothing is staged, nothing launched
    assert row["host_staged_bytes_rank0"] == 0
    assert row["launches_b1_b2_b3"] == row["launches_b1_b2_b3_one_rank"] == [0, 0, 0]
    pred = row["predictor"]
    assert pred["finite"] and pred["shape"] == [2, 16, 64]
    for key in ("tokens_per_s", "tokens_per_s_one_rank", "num_updates", "card"):
        assert key in row


def test_serving_tp_phase_rehearsal(on_cpu, tiny_serving, capsys, monkeypatch):
    # phase 21 at the tiny serving widths: the one-rank engine here, two
    # gloo ranks spawned on the CPU serving with mesh= (1 head a rank)
    monkeypatch.setattr(chip_smoke, "SERVE_TP_REQUESTS", 4)
    monkeypatch.setattr(chip_smoke, "SERVE_TP_SPEC_PROMPTS", 1)
    spawned = []
    spawn = chip_smoke._spawn_serving_tp

    def keep(*args):
        spawned.append(spawn(*args))
        return spawned[-1]

    monkeypatch.setattr(chip_smoke, "_spawn_serving_tp", keep)
    out = chip_smoke.serving_tp_phase(0)
    rows = _emitted(capsys, "serving_tp")
    assert [r["case"] for r in rows] == ["two_ranks_one_card", "cards"]
    assert rows[1]["serving_tp_cards_run"] == 1
    row = out["two_ranks_one_card"]
    assert rows[0] == {"phase": "serving_tp", **row}
    assert not row["failures"] and row["backend"] == "gloo" and row["heads_a_rank"] == 1
    assert row["requests"] == 4 and row["sampled"] == 2 and row["sampled_rerun_equal"]
    assert row["greedy_departures"] == []
    assert row["speculative"]["requests"] == 1
    assert row["speculative"]["departures_from_mesh_plain"] == []
    assert 2 * row["pool_bytes_rank"] == row["pool_bytes_one_rank"]
    decode = row["profiled_decode"]
    assert decode["all_reduces_per_decode_step"] == chip_smoke.SERVE_MODEL["num_layers"]
    assert decode["steps"] > 0 and decode["device_busy_share"] is None  # no profiler here
    # CPU ranks: gloo on CPU tensors stages nothing; nothing is launched
    assert row["host_staged_bytes_rank0"] == 0 and row["launches_b1_b2_b3"] == [0, 0, 0]
    for key in ("generated_tokens_per_s", "ttft_ms_p50", "step_ms_p50", "step_ms_p99",
                "one_rank", "card"):
        assert key in row
    # a failed gate raises: the same ranks' run with a sampled request off
    # and with pools that did not split
    broken = dict(spawned[0], sampled_mismatched=[1])
    monkeypatch.setattr(chip_smoke, "_spawn_serving_tp", lambda *args: broken)
    with pytest.raises(AssertionError, match="sampled requests"):
        chip_smoke.serving_tp_phase(0)
    _, failures = chip_smoke._serving_tp_versus(
        dict(spawned[0], pool_bytes=2 * spawned[0]["pool_bytes"]), row["one_rank"] | {
            "tokens": spawned[0]["traffic"]["tokens"]}, chip_smoke._serve_tp_requests(0),
        chip_smoke._serve_model(0)[1], 2)
    assert any("pools" in f for f in failures)


TINY_MOE = dict(vocab_size=64, num_classes=2, dim=32, heads=2, num_layers=2, num_experts=4,
                mlp_ratio=2, top_k=1, capacity_factor=1.25, max_len=16)


def test_moe_phase_rehearsal(on_cpu, capsys, monkeypatch):
    # phase 22 at TINY_MOE's widths: one rank here, then two gloo ranks
    # spawned on the CPU, tp_shards=2 with expert_partition(4) (grid 1 x 2)
    monkeypatch.setattr(chip_smoke, "MOE_MODEL", TINY_MOE)
    monkeypatch.setattr(chip_smoke, "MOE_PREDICT_ROWS", 2)
    spawned = []
    spawn = chip_smoke._spawn_moe

    def keep(*args):
        spawned.append(spawn(*args))
        return spawned[-1]

    monkeypatch.setattr(chip_smoke, "_spawn_moe", keep)
    out = chip_smoke.moe_phase(0)
    rows = _emitted(capsys, "moe")
    assert [r["case"] for r in rows] == ["one_rank", "two_ranks_one_card", "cards"]
    assert rows[2]["moe_cards_run"] == 1
    one = out["one_rank"]
    assert not rows[0]["failures"] and np.isfinite(one["loss"]).all()
    assert one["aux_loss"] > 0 and one["objective_rel_err"] < 1e-6
    assert one["step_vs_cpu"]["loss_rel_err"] == 0.0  # the CPU against itself
    assert one["predictor"]["max_abs_err"] == 0.0 and one["experts_seen"] == [4]
    # the CPU runs the plain attention: no kernel launch to count
    assert one["launches_b1_b2_b3"] == one["expected_launches"] == [0, 0, 0]
    row = out["two_ranks_one_card"]
    assert rows[1] == {"phase": "moe", **row}
    assert not row["failures"] and row["grid"] == [1, 2] and row["experts_seen_rank0"] == [2]
    assert 2 * row["expert_bytes_rank0"] == row["expert_bytes_one_rank"]
    assert row["first_window_loss_rel_err"] <= chip_smoke.MOE_FIRST_LOSS_RTOL
    assert row["vs_one_rank"]["param_rel_norm_err"] <= chip_smoke.MOE_PARAM_REL_NORM
    assert row["host_staged_bytes_rank0"] == 0
    for key in ("tokens_per_s", "tokens_per_s_one_rank", "peak_memory_gb_rank0", "card"):
        assert key in row
    # a failed gate raises: the same ranks' run with whole expert stacks
    broken = dict(spawned[0], expert_bytes=2 * spawned[0]["expert_bytes"])
    monkeypatch.setattr(chip_smoke, "_spawn_moe", lambda *args: broken)
    with pytest.raises(AssertionError, match="expert bytes"):
        chip_smoke.moe_phase(0)


TINY_STAGED = dict(vocab_size=64, dim=32, heads=2, num_stages=2, blocks_per_stage=1,
                   max_len=16)


def test_pipeline_phase_rehearsal(on_cpu, capsys, monkeypatch):
    # phase 23 at TINY_STAGED's widths: one rank here, then two gloo ranks
    # spawned on the CPU, pipeline_stages=2 (grid 1 x 2), replicated and fsdp
    monkeypatch.setattr(chip_smoke, "PP_MODEL", TINY_STAGED)
    monkeypatch.setattr(chip_smoke, "PP_DECODE", (2, 4, 4))
    spawned = []
    spawn = chip_smoke._spawn_pp

    def keep(*args):
        spawned.append(spawn(*args))
        return spawned[-1]

    monkeypatch.setattr(chip_smoke, "_spawn_pp", keep)
    out = chip_smoke.pipeline_phase(0)
    rows = _emitted(capsys, "pipeline")
    assert [r["case"] for r in rows] == ["one_rank", "two_ranks_one_card", "cards"]
    assert rows[2]["pp_cards_run"] == 1
    one = out["one_rank"]
    assert one["engine"] == "WindowedEngine" and np.isfinite(one["loss"]).all()
    row = out["two_ranks_one_card"]
    assert rows[1] == {"phase": "pipeline", **json.loads(json.dumps(row))}
    # PP_ROWS (16) of batch 4 on one worker
    assert not row["failures"] and row["grid"] == [1, 2] and row["local_steps"] == 4
    assert row["first_window_loss_rel_err"] <= chip_smoke.PP_FIRST_LOSS_RTOL
    assert row["vs_one_rank"]["param_rel_norm_err"] <= chip_smoke.PP_PARAM_REL_NORM
    # each stage rank holds half the blocks; fsdp halves the embed and head
    assert [2 * b for b in row["block_bytes_per_rank"]] == [row["block_bytes_one_rank"]] * 2
    fsdp = row["fsdp"]
    assert fsdp["vs_pipeline"]["bitwise"]
    assert [2 * b for b in fsdp["embed_head_bytes_per_rank"]] == [
        fsdp["embed_head_bytes_replicated"]] * 2
    assert row["decode"]["pipelined_equals_sequential"] == [True, True]
    assert row["serving"]["requests"] == 3 and len(row["serving"]["tokens"]) == 3
    # the CPU runs the plain attention over gloo on CPU tensors: no kernel
    # launch to count, nothing staged
    assert row["launches_b1_b2_b3_per_rank"] == [[0, 0, 0]] * 2
    assert row["host_staged_bytes_per_rank"] == [0, 0]
    for key in ("tokens_per_s", "tokens_per_s_one_rank", "peak_memory_gb_per_rank", "card"):
        assert key in row
    # a failed gate raises: the same ranks' run with rank 1 holding every block
    ranks = spawned[0]
    broken = [ranks[0], dict(ranks[1], pipeline=dict(
        ranks[1]["pipeline"], block_bytes=2 * ranks[1]["pipeline"]["block_bytes"]))]
    monkeypatch.setattr(chip_smoke, "_spawn_pp", lambda *args: broken)
    with pytest.raises(AssertionError, match="block bytes"):
        chip_smoke.pipeline_phase(0)


def test_pipeline_3d_phase_rehearsal(on_cpu, capsys, monkeypatch):
    # phase 24 at TINY_STAGED's widths against phase 23's one-rank run made
    # here: four gloo ranks spawned on the CPU (grid 1 x 2 x 2), pp x tp,
    # with fsdp, and pp x sp
    monkeypatch.setattr(chip_smoke, "PP_MODEL", TINY_STAGED)
    ref = chip_smoke._pp_one_rank(0, 1, chip_smoke._pp3d_model())
    spawned = []
    spawn = chip_smoke._spawn_pp3d

    def keep(*args):
        spawned.append(spawn(*args))
        return spawned[-1]

    monkeypatch.setattr(chip_smoke, "_spawn_pp3d", keep)
    out = chip_smoke.pipeline_3d_phase(0, ref)
    rows = _emitted(capsys, "pipeline_3d")
    assert [r["case"] for r in rows] == ["four_ranks_one_card", "cards"]
    assert rows[1]["pp3d_cards_run"] == 1
    row = out["four_ranks_one_card"]
    assert rows[0] == {"phase": "pipeline_3d", **json.loads(json.dumps(row))}
    assert not row["failures"] and row["grid"] == [1, 2, 2] and row["local_steps"] == 4
    assert "not supported" in row["both_axes_refused"]
    for name, axis, share in (("tp", "model", 4), ("tp_fsdp", "model", 4), ("sp", "seq", 2)):
        case = row[name]
        assert case["axes"] == ["workers", "stages", axis]
        assert case["first_window_loss_rel_err"] <= chip_smoke.PP_FIRST_LOSS_RTOL
        assert case["vs_one_rank"]["loss_rel_err"] <= chip_smoke.PP_LOSS_RTOL
        assert case["vs_one_rank"]["param_rel_norm_err"] <= chip_smoke.PP_PARAM_REL_NORM
        # a rank's blocks: a quarter of one rank's over (stages, model), half over stages
        assert [share * b for b in case["block_bytes_per_rank"]] == [row["block_bytes_one_rank"]] * 4
        # the CPU runs the plain attention over gloo on CPU tensors: no kernel
        # launch to count, nothing staged
        assert case["launches_b1_b2_b3_per_rank"] == [[0, 0, 0]] * 4
        assert case["host_staged_bytes_per_rank"] == [0] * 4
        assert case["predict"]["finite"] and case["predict"]["seq_axis"] == "None"
        for key in ("tokens_per_s", "peak_memory_gb_per_rank", "seconds"):
            assert key in case
    assert row["tp_fsdp"]["vs_tp"]["bitwise"]
    assert [2 * b for b in row["tp_fsdp"]["embed_head_bytes_per_rank"]] == \
        row["tp"]["embed_head_bytes_per_rank"]
    for key in ("tokens_per_s_one_rank", "card", "seconds"):
        assert key in row
    # a failed gate raises: the same ranks' run with rank 1 holding its
    # stage's blocks whole over the model axis
    ranks = spawned[0]
    broken = [ranks[0], dict(ranks[1], tp=dict(ranks[1]["tp"],
                                               block_bytes=2 * ranks[1]["tp"]["block_bytes"]))]
    broken += ranks[2:]
    monkeypatch.setattr(chip_smoke, "_spawn_pp3d", lambda *args: broken)
    with pytest.raises(AssertionError, match="block bytes"):
        chip_smoke.pipeline_3d_phase(0, ref)


TINY_GPT2 = dict(vocab_size=64, n_positions=16, n_embd=32, n_head=2, n_layer=2, n_inner=None,
                 activation_function="gelu_new", layer_norm_epsilon=1e-5,
                 tie_word_embeddings=True)


def test_hf_telemetry_phase_rehearsal(on_cpu, capsys, monkeypatch):
    # phase 25 at TINY_GPT2's widths: the state-dict conversion, the forward
    # against the CPU, the three one-rank trainings (telemetry off, then on
    # with dynamics, the warn watchdog and profile_dir, then the sanitizer
    # strict) and three greedy requests of two tenants over HTTP on
    # 127.0.0.1, strict and billed, every gate checked
    monkeypatch.setattr(chip_smoke, "HF_CONFIG", TINY_GPT2)
    monkeypatch.setattr(chip_smoke, "HF_SERVE", (3, 4, 4))
    row = chip_smoke.hf_telemetry_phase(0)
    assert _emitted(capsys, "hf_telemetry") == [
        {"phase": "hf_telemetry", **json.loads(json.dumps(row))}]
    assert not row["failures"] and row["local_steps"] == 8
    assert row["histories_bitwise"] and row["vs_plain"]["bitwise"]
    assert row["forward_max_abs_err"] <= chip_smoke.PREDICT_ATOL
    # the CPU runs the plain attention: no kernel launch to count
    assert row["launches_b1_b2_b3_plain"] == row["launches_b1_b2_b3_observed"] == [0, 0, 0]
    assert row["forward_launches_b1"] == 0
    summary = row["dynamics_summary"]
    assert summary["nonfinite_grads_max"] == 0.0 and summary["update_norm"] > 0.0
    assert row["dynamics_lines"] == 1 and row["profile_traces"] == 1
    http = row["http"]
    assert http["requests"] == 3 and [len(t) for t in http["tokens"]] == [4, 4, 4]
    assert http["address"].startswith("127.0.0.1:") and http["scrape_has_ttft"]
    assert http["scrape_tokens_line"].startswith(f'serving_tokens_total{{run_id="{http["run_id"]}"}}')
    assert len(http["latency_s"]) == 3 and "card" in row
    # (d) the strict third run: clean, bitwise, one donation boundary, the
    # consumed state poisoned; no card here, so the planted sync passes
    assert row["sanitized_error"] is None and row["sanitizer_violations"] == []
    assert row["sanitized_bitwise"] and row["launches_b1_b2_b3_sanitized"] == [0, 0, 0]
    assert row["sanitizer_donation"]["boundaries"] == 1
    assert row["sanitizer_stale_read"].startswith("read of 'center_params' on a consumed")
    assert row["planted_sync"] == {"caught": None, "outside_rows": 7}
    assert row["tokens_per_s_sanitized"] > 0
    assert len(row["tokens_per_s_unsanitized_before_after"]) == 2
    # the strict HTTP serving, billed: a a b, conserved exactly
    assert http["tenants"] == ["a", "a", "b"] and http["ledger_tenants"] == ["a", "b"]
    assert http["ledger_decode_tokens"] == 12 == float(http["scrape_tokens_line"].split()[-1])
    assert http["ledger_prefill_tokens"] == http["prompt_tokens"] == 12
    assert http["ledger_by_tenant"]["a"]["decode_tokens"] == 8
    assert http["healthz_sanitizer"] == {"mode": "strict", "violations": {}}
    assert http["engine_cv"] == "GuardedLock"
    assert http["slo_engines"] == ["serving"] and http["slo_evaluated"] == [True]
    assert len(http["slo_objectives"]) == 4
    # a failed gate raises: the same phase with a forward tolerance it misses
    monkeypatch.setattr(chip_smoke, "PREDICT_ATOL", -1.0)
    with pytest.raises(AssertionError, match="converted forward"):
        chip_smoke.hf_telemetry_phase(0)
