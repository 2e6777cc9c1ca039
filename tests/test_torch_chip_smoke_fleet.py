"""``chip_smoke.py``'s phase 26 (chaos, fleet membership with the live
elastic resize, and the Punchcard control plane) rehearsed on the CPU at a
tiny ``TransformerLM``, every gate held, the job's subprocess included.

A file of its own, so that under ``--dist loadfile`` it does not ride on
tests/test_torch_chip_smoke.py's worker.  On the CPU the attention runs
its plain version, so every launch count is 0; the card's counts are
checked by the phase itself on the H100.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

TINY_LM = dict(vocab_size=23, dim=16, heads=2, num_layers=2, max_len=16)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "ZOO_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "FLEET_MODEL", TINY_LM)
    monkeypatch.setattr(chip_smoke, "FLEET_JOB_TIMEOUT_S", 60)


def test_fleet_phase_rehearsal(tiny, capsys, monkeypatch):
    row = chip_smoke.fleet_phase(0)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"phase": "fleet"')]
    assert printed == [{"phase": "fleet", **json.loads(json.dumps(row))}]
    assert not row["failures"]
    # (a) the kill and the torn checkpoint, recovered bit for bit
    assert row["killed_bitwise"] and row["torn_bitwise"]
    assert row["epoch_sites"] == [4, 5] and row["torn_quarantined"] == ["step_2.corrupt"]
    assert row["launches_b1_b2_b3_killed"] == row["launches_b1_b2_b3_torn"] == [0, 0, 0]
    assert row["local_steps_per_epoch"] == 4
    assert row["save_bytes_on_disk"] > row["save_bytes_reckoned"] > 0
    # (b) one live grow to 4 workers, the resume path's bit for bit
    elastic = row["elastic"]
    assert (elastic["resizes"], elastic["workers_after"], elastic["polls"]) == (1, 4, 2)
    assert elastic["workers_per_epoch"] == [2, 2, 4] and elastic["bitwise_resume_path"]
    assert len(elastic["tokens_per_s_per_epoch"]) == 3
    # (c) one job through the faulted control plane, the parent's predictions
    job = row["job"]
    assert (job["jobs"], job["status"], job["returncode"]) == (1, "finished", 0)
    assert job["child"] == job["parent"] and job["child"]["kind"] == "cpu"
    assert job["child"]["shape"] == [4, 16, 23]
    assert job["chaos_sites"]["connect"] >= 2 and job["chaos_sites"]["rpc_reply"] >= 1
    # a failed gate raises: the same phase with a job that predicts nothing
    monkeypatch.setattr(chip_smoke, "FLEET_JOB_SCRIPT", "print('no prediction')\n")
    with pytest.raises(AssertionError, match="are not the parent's"):
        chip_smoke.fleet_phase(0)
