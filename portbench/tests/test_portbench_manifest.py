"""``BENCHMARK.json`` keeps to the rules for a manifest, and every part of
every cell is found by name."""

import json
import math
import re

import pytest

from portbench import harness

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "d_model", "d_ff",
               "n_embd", "n_inner", "head", "expansion", "experts_per_tok", "top_k")


def test_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"] and len(MANIFEST["command"]) <= 32
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_one_line_texts():
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS + [
        m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [w["why"] for w in MANIFEST["workloads"]] + [c["why"] for c in MANIFEST["configs"]]
    texts += [c["source"] for c in MANIFEST["configs"]] + [m["layer"] for m in MANIFEST["per_layer"]]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [m for m in e2e.values() if "workloads" not in m or cell in m["workloads"]]
        assert len(reported) >= 2, cell


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS and ("workloads" not in moved or cell in moved["workloads"])
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"]), cell


def test_every_kernel_roofline_has_a_step_mfu_beside_it():
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(o["workloads"])
                       for o in MANIFEST["per_layer"]), m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_part_of_a_cell_is_found_by_name(cell):
    resolved = harness.resolve(MANIFEST, cell)
    assert resolved.chips in (1, 4)
    driver = harness.driver_module(resolved.traffic["driver"])
    assert callable(driver.run)
    for m in resolved.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
    for name, check in resolved.limits["checks"].items():
        assert math.isfinite(check["limit"]), name


def test_configurations():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        body = harness.load_json(harness.ROOT / c["file"])
        assert c["file"].startswith("portbench/") and body["name"] == c["name"]
        assert c["reduced"] == body["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in body, key
            assert not key.endswith(("_dim", "_rank")), key
            assert not any(w in key for w in WIDTH_WORDS), key
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    four = sum(1 for w in MANIFEST["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(pairs) // 4)
