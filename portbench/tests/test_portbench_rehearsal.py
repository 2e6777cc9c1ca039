"""Each driver rehearsed on the CPU at tiny widths: the control flow, the
result line's parts and the reference comparison, with the cell's own
limits; and with the timed path broken underneath, ``correct`` comes out
false.  No number here is a device number."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness

#: the training cells of BENCHMARK.json, whose limits a broken step must fail
TRAIN_CELLS = ["gpt2s-train-downpour"]


def _run(run):
    harness.driver_module(run.cell.traffic["driver"]).run(run)
    return run


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_driver(tiny_run, cell):
    run = _run(tiny_run(cell, seed=2**31 + 3, seconds=1.0))
    assert set(run.end_to_end) == {"setup_s", "train_samples_per_s", "train_mfu"}
    assert run.attempted > 0 and run.failed == 0
    assert set(run.facts["numbers"]) == {"loss_gap", "grad_gap", "change_gap",
                                         "grad_gap_median", "change_gap_median"}
    assert set(run.checks) == set(run.cell.limits["checks"])
    assert all(v < 0.1 for v in run.facts["numbers"].values()), run.facts["numbers"]


def test_traced_training_run_reads_its_stretch(tiny_run):
    run = _run(tiny_run("gpt2s-train-downpour", seconds=1.0, traced=True))
    assert run.trace.window_s > 0 and run.facts["steps"] > 0
    for entry in run.cell.per_layer:
        value = harness.per_layer_module(run, entry["name"]).read(run)
        if entry["name"].endswith("_roofline"):
            assert value is None  # no kernel ran: nothing to read, never 0
    breakdown = run.trace.breakdown()
    assert set(breakdown) == {"device_ops", "idle_gaps"} and breakdown["idle_gaps"]


def test_serving_driver(tiny_run):
    run = _run(tiny_run("gpt2s-serve-open", seed=11, seconds=4.0))
    assert set(run.end_to_end) == {"setup_s", "serve_tokens_per_s", "serve_ttft_p95_ms"}
    assert run.attempted == 16 and run.failed == 0
    assert run.checks["tokens_short"]["value"] == 0
    assert run.checks["logit_gap"]["value"] < 1e-4
    assert run.correct


def test_traced_serving_run(tiny_run):
    run = _run(tiny_run("gpt2s-serve-open", seed=12, seconds=2.0, traced=True))
    assert run.trace.window_s > 0
    readers = {e["name"]: harness.per_layer_module(run, e["name"]) for e in run.cell.per_layer}
    assert readers["serve.decode_step_ms"].read(run) > 0
    assert 0 <= readers["serve.prefill_pad_share"].read(run) < 100


def _unchanged(original):
    def step(self, params, opt_state, model_state, generator, x, y):
        out = original(self, params, opt_state, model_state, generator, x, y)
        return (params, opt_state, model_state) + out[3:]
    return step


def _half_batch(original):
    def step(self, params, opt_state, model_state, generator, x, y):
        half = x.shape[0] // 2
        return original(self, params, opt_state, model_state, generator, x[:half], y[:half])
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_broken_step_is_not_correct(tiny_run, monkeypatch, cell, fault):
    from distkeras_tpu_torch.parallel.engine import WindowedEngine

    monkeypatch.setattr(WindowedEngine, "_local_step", fault(WindowedEngine._local_step))
    run = _run(tiny_run(cell, seed=5, seconds=0.5))
    assert not run.correct, run.checks


def test_an_altered_token_is_not_correct(tiny_run, monkeypatch):
    from distkeras_tpu_torch.serving import engine as serving_engine

    original = serving_engine.sample_tokens
    monkeypatch.setattr(serving_engine, "sample_tokens",
                        lambda logits, *a: (original(logits, *a) + 1) % logits.shape[-1])
    run = _run(tiny_run("gpt2s-serve-open", seed=13, seconds=2.0))
    assert not run.correct, run.checks


def _bench(args, cwd):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _bench(["--workload", "gpt2s-train-downpour", "--seed", "1", "--seconds", "1"],
                 harness.ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench(["--workload", "gpt2s-serve-open", "--seed", "1", "--seconds", "1"], tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
