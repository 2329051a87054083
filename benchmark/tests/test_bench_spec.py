"""BENCHMARK.json against the contract: every cell resolves its files, every
name and unit keeps to the allowed characters, every per-layer metric has a
reader and reports with the end-to-end metric it moves."""

import json
import re

import pytest

import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert (harness.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    names += CELLS
    assert all(NAME.match(n) for n in names)
    assert len(set(SPEC["end_to_end"][i]["name"] for i in range(len(SPEC["end_to_end"])))) == len(SPEC["end_to_end"])
    assert len(set(CELLS)) == len(CELLS)


def test_end_to_end_bounds():
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.find_cell(cell)
    assert (harness.BENCH / "drivers" / f"{c.mix['entry']}.py").is_file()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"} and len(c.end_to_end) >= 3
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.limits and all(v > 0 for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} reports in {cell} without {m['moves']}"
        assert callable(harness.load_module(harness.reader_path(m['name'])).read)


def test_per_layer_entries():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    perf = (harness.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, f"layer {layer!r} is not in PERF.md's list of layers"


def test_configs_list_every_change():
    for c in SPEC["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
