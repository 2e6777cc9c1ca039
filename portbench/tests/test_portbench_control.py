"""The control, the reference put in the program's place one precision
lower, fails one of its cell's numbers; and the rate sweep runs.  On the CPU
at tiny widths for training (float8 products); on the card at the cell's own
size for both cells (``cuda``: TF32 exists only there)."""

import json
import subprocess
import sys

import pytest

from portbench import control, harness


def _fails_a_limit(numbers, limits):
    return any(numbers[name] > limit["limit"] for name, limit in limits["checks"].items()
               if name in numbers)


def test_float8_control_fails_the_training_cell(tiny_run):
    run = tiny_run("gpt2s-train-downpour", seed=21, seconds=0.5)
    out = control._train(run)
    assert not _fails_a_limit(out["program"], run.cell.limits), out["program"]
    assert _fails_a_limit(out["control"], run.cell.limits), out["control"]
    assert _fails_a_limit(out["half_batch"], run.cell.limits)
    assert out["unchanged"]["change_gap"] == pytest.approx(1.0)


def test_sweep_rehearses(tiny_run, monkeypatch, capsys):
    from portbench import sweep

    cell = tiny_run("gpt2s-serve-open").cell
    monkeypatch.setattr(harness, "resolve", lambda manifest, name: cell)
    monkeypatch.setattr(harness, "require_cards", lambda chips: __import__("torch").device("cpu"))
    monkeypatch.setattr(harness, "card_line", lambda: "cpu")
    assert sweep.main(["--workload", cell.name, "--seed", "3", "--seconds", "2",
                       "--rates", "2", "6"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["rate"] for x in lines] == [2.0, 6.0] and all(x["failed"] == 0 for x in lines)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gpt2s-train-downpour", "gpt2s-serve-open"])
def test_control_fails_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.control", "--workload", cell,
                          "--seeds", "909", "--seconds", "10"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    reading = json.loads(out.stdout.splitlines()[-1])
    limits = harness.load_json(harness.BENCH_DIR / "workloads" / f"{cell}.json")
    assert not _fails_a_limit(reading["program"], limits), reading["program"]
    assert _fails_a_limit(reading["control"], limits), reading["control"]
