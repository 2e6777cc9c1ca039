"""``chip_smoke.py``'s phase 27 (the serving tier and the online
serve-to-train loop) rehearsed on the CPU at a tiny ``TransformerLM``,
every gate held: (a) the failover under a seeded ``kill_replica``, billed
once, held to each request served alone; (b) served traffic captured over
HTTP into two windows, a killed first retrain retried, a rotted step
rejected at swap time and the next rolled into both replicas bit for bit
with requests in flight.

A file of its own, so that under ``--dist loadfile`` it does not ride on
tests/test_torch_chip_smoke.py's worker.  On the CPU the attention runs its
plain version, so every launch count is 0; the card's counts are checked
by the phase itself on the H100.
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

TINY_LM = dict(vocab_size=23, dim=16, heads=2, num_layers=2, max_len=32)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "ZOO_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ONLINE_MODEL", TINY_LM)
    monkeypatch.setattr(chip_smoke, "ONLINE_PROMPT_LEN", (3, 8))
    monkeypatch.setattr(chip_smoke, "ONLINE_NEW_TOKENS", 4)
    monkeypatch.setattr(chip_smoke, "ONLINE_ROW", 16)
    monkeypatch.setattr(chip_smoke, "ONLINE_ROLL_NEW_TOKENS", 12)


def test_online_phase_rehearsal(tiny, capsys):
    row = chip_smoke.online_phase(0)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"phase": "online"')]
    assert printed == [{"phase": "online", **json.loads(json.dumps(row))}]
    assert not row["failures"]
    fo = row["failover"]
    assert fo["dead"] == 1 and fo["failovers"] >= 1 and fo["sampled"] == 8
    assert fo["routed"] == fo["billed_requests"] == 16 and fo["billed_tenants"] == ["a", "b"]
    assert fo["billed_failover_attempts"] >= 1 and fo["launches_b1"] == 0
    assert fo["sampled_mismatched"] == [] and fo["tokens_per_s"] > 0
    loop = row["loop"]
    assert loop["windows_published"] == [0, 1] and loop["windows_trained"] == 2
    assert (loop["retrain_failures"], loop["ckpt_rejected"], loop["hot_swaps"]) == (1, 1, 2)
    assert loop["loaded_steps"] == [2] and loop["replicas_bitwise_the_step"] == [True, True]
    assert loop["roll_statuses"] == [200] * 4 and "aborted" not in loop["roll_finish_reasons"]
    assert loop["data_state"] == {"epoch": 1, "block_cursor": loop["window1_last_seq"] + 1}
    assert loop["launches_b1_b2_b3"] == [0, 0, 0] and loop["local_steps_per_window"] == 4
    assert [v["ok"] for v in loop["verifies"]] == [False, True]
    assert all(s["save_bytes"] > 0 for s in loop["saves"])
    assert (loop["capture_errors"], loop["roll_failures"]) == (0, 0)
