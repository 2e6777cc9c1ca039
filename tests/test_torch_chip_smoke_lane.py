"""``chip_smoke.py``'s gloo lane on the CPU: phases 19 to 24 run in a process
of the script's own beside the others. The lane's rows are chosen as the
kernels line reads them, its process (and whatever it spawned) is ended by
``stop`` and by its parent's end, a failed lane fails the run, and each
phase's seconds reach standard error as they end. The lane's process is a
stub script here; the phases themselves are rehearsed in
``test_torch_chip_smoke.py``. ``scripts/chip_smoke_profile.py``, which
says where the script's seconds go, is run on a small command.
"""

import json
import os
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


def test_gloo_lane_runs_each_phase_in_turn_and_keeps_the_rows_the_kernels_line_reads(
        monkeypatch):
    calls = []

    def phase(name, key):
        def run(seed, *args):
            calls.append((name, seed, args))
            return {key: {"of": name}, "one_rank": {"ref": name}} if key else {"of": name}
        return run

    monkeypatch.setattr(chip_smoke, "seq_train", lambda seed, epochs: (None, f"seq ref {epochs}"))
    monkeypatch.setattr(chip_smoke, "tp_train", lambda seed, epochs: (None, f"tp ref {epochs}"))
    monkeypatch.setattr(chip_smoke, "seq_phase", phase("seq", "two_ranks_one_card"))
    monkeypatch.setattr(chip_smoke, "tp_phase", phase("tp", "two_ranks_one_card"))
    monkeypatch.setattr(chip_smoke, "serving_tp_phase", phase("serving_tp", "two_ranks_one_card"))
    monkeypatch.setattr(chip_smoke, "moe_phase", phase("moe", None))
    monkeypatch.setattr(chip_smoke, "pipeline_phase", phase("pipeline", "two_ranks_one_card"))
    monkeypatch.setattr(chip_smoke, "pipeline_3d_phase",
                        phase("pipeline_3d", "four_ranks_one_card"))
    timed_names = []

    def timed(name, fn, *args):
        timed_names.append(name)
        return fn(*args)

    rows = chip_smoke.gloo_lane(5, timed)
    assert timed_names == list(chip_smoke.LANE_PHASES)
    assert rows == {name: {"of": name} for name in chip_smoke.LANE_PHASES}
    by_name = {name: args for name, _, args in calls}
    assert by_name["seq"] == ("seq ref 1",)
    assert by_name["tp"] == (f"tp ref {chip_smoke.TRAIN_EPOCHS}",)
    # phase 24 is held to phase 23's one-rank run while their models agree
    if chip_smoke._pp3d_model() == chip_smoke.PP_MODEL:
        assert by_name["pipeline_3d"] == ({"ref": "pipeline"},)
    assert all(seed == 5 for _, seed, _ in calls)


def test_timer_prints_each_phase_and_empties_nothing_without_a_card(capsys):
    seconds = {}
    timed = chip_smoke._timer(seconds, time.perf_counter(), "lane")
    assert timed("one", lambda a, b: a + b, 2, 3) == 5
    with pytest.raises(ValueError):
        timed("two", lambda: (_ for _ in ()).throw(ValueError("x")))
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.splitlines()]
    assert [r["of"] for r in rows] == ["one", "two"]
    assert set(seconds) == {"one", "two"}
    assert "lane: one " in err and "lane: two " in err and "since the build began" in err


def _gone(pid: int) -> bool:
    """The process has ended: no such pid, or a zombie its dead parent
    never reaped."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    with open(f"/proc/{pid}/stat", encoding="utf-8") as fh:
        return fh.read().split()[2] == "Z"


def _stub(tmp_path, body: str) -> Path:
    """A script standing in for chip_smoke.py in the lane's process."""
    path = tmp_path / "lane_stub.py"
    path.write_text(textwrap.dedent("""\
        import json, os, subprocess, sys, time
        spec = json.load(open(sys.argv[2]))
        assert sys.argv[1] == "--gloo-lane"
        """) + textwrap.dedent(body))
    return path


def test_lane_result_copies_its_rows_and_returns_them(tmp_path, monkeypatch, capsys):
    stub = _stub(tmp_path, """\
        print(json.dumps({"phase": "seq", "threads": spec["threads"]}), flush=True)
        print("lane err", file=sys.stderr, flush=True)
        json.dump({"rows": {"seq": {"launches_b1_b2_b3": [0, 0, 0]}},
                   "seconds": {"seq": 1.5}, "seed": spec["seed"]}, open(spec["out"], "w"))
        """)
    monkeypatch.setattr(chip_smoke, "__file__", str(stub))
    lane = chip_smoke.GlooLane(3, time.perf_counter())
    try:
        rows, seconds = lane.result(60)
    finally:
        lane.stop()
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[0])["phase"] == "seq"
    assert rows == {"seq": {"launches_b1_b2_b3": [0, 0, 0]}}
    assert seconds == {"seq": 1.5}


def test_a_failed_lane_fails_the_run(tmp_path, monkeypatch, capsys):
    stub = _stub(tmp_path, """\
        print(json.dumps({"phase": "seq", "failures": ["x"]}), flush=True)
        sys.exit(3)
        """)
    monkeypatch.setattr(chip_smoke, "__file__", str(stub))
    lane = chip_smoke.GlooLane(0, time.perf_counter())
    try:
        with pytest.raises(AssertionError, match="exited 3"):
            lane.result(60)
    finally:
        lane.stop()
    assert '"failures"' in capsys.readouterr().out


def test_stop_ends_the_lane_and_what_it_spawned(tmp_path, monkeypatch):
    pid_file = tmp_path / "child.pid"
    stub = _stub(tmp_path, f"""\
        child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        open({str(pid_file)!r}, "w").write(str(child.pid))
        time.sleep(600)
        """)
    monkeypatch.setattr(chip_smoke, "__file__", str(stub))
    lane = chip_smoke.GlooLane(0, time.perf_counter())
    try:
        with pytest.raises(AssertionError, match="ran past"):
            deadline = time.monotonic() + 30
            while not pid_file.exists() or not pid_file.read_text():
                assert time.monotonic() < deadline
                time.sleep(0.05)
            lane.result(0.2)
    finally:
        lane.stop()
    child = int(pid_file.read_text())
    deadline = time.monotonic() + 10
    while not _gone(child):
        assert time.monotonic() < deadline, "the lane's child outlived stop()"
        time.sleep(0.05)


def test_the_lane_and_its_ranks_end_with_the_parent(tmp_path):
    """A parent killed outright (as a time limit kills it) takes the lane's
    session with it: the lane watches its parent."""
    import subprocess

    pids = tmp_path / "pids"
    lane = textwrap.dedent(f"""\
        import os, subprocess, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        import chip_smoke
        chip_smoke._die_with(os.getppid())
        rank = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        open({str(pids)!r}, "w").write(f"{{os.getpid()}} {{rank.pid}}")
        time.sleep(600)
        """)
    parent = subprocess.Popen([sys.executable, "-c", textwrap.dedent(f"""\
        import subprocess, sys, time
        subprocess.Popen([sys.executable, "-c", {lane!r}], start_new_session=True)
        time.sleep(600)
        """)])
    try:
        deadline = time.monotonic() + 60
        while not pids.exists() or len(pids.read_text().split()) != 2:
            assert time.monotonic() < deadline, "the lane never started its rank"
            time.sleep(0.05)
        lane_pid, rank_pid = map(int, pids.read_text().split())
        assert not _gone(lane_pid) and not _gone(rank_pid)
    finally:
        parent.kill()
        parent.wait()
    deadline = time.monotonic() + 15
    while not (_gone(lane_pid) and _gone(rank_pid)):
        assert time.monotonic() < deadline, "the lane or its rank outlived the parent"
        time.sleep(0.1)


def test_the_profile_script_charges_a_command_s_seconds_to_its_functions(tmp_path):
    import subprocess

    busy = tmp_path / "busy.py"
    busy.write_text(textwrap.dedent("""\
        import time

        def spin(seconds):
            t = time.perf_counter()
            while time.perf_counter() - t < seconds:
                pass

        spin(0.6)
        """))
    out = tmp_path / "profile"
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "chip_smoke_profile.py"),
                           "--out", str(out), "--", sys.executable, str(busy)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = (out / "report.txt").read_text()
    assert "exit 0" in report and "== main process: 1 process(es)" in report
    spin = [line for line in report.splitlines() if "innermost busy.py:spin" in line]
    assert spin and float(spin[0].rsplit(":", 1)[1].split()[0]) >= 0.4
