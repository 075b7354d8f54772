"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every cell, configuration, traffic mix, model, reference, metric and
roofline count by its name."""

import json
import re

import pytest
from conftest import BENCH, CELLS, REPO

from portbench import harness, roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ROOT = REPO / "portbench"


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_workloads_keep_the_contract():
    """Every cell, whichever PR added it: the rules of ``workloads`` and the
    files a cell and its configuration are found by."""
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs, w["name"]
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        limits = ROOT / "workloads" / f"{w['name']}.json"
        assert limits.is_file(), f"{limits} is missing"
        sizes = ROOT / "tests" / "sizes" / f"{w['config']}.json"
        assert sizes.is_file(), f"{sizes} is missing"
        assert {"tiny", "small"} <= set(json.loads(sizes.read_text())), sizes


def test_names_units_and_keys():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"host path", "device", "kernels"}
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%" and m["layer"] == "kernels"
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS)), m["name"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("portbench/") and 1 <= len(conf["source"]) <= 200
    data = json.loads((REPO / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"] and data["reduced"] == conf["reduced"]
    assert (ROOT / "models" / f"{data['model']}.py").is_file()
    assert (ROOT / "reference" / f"{data['model']}.py").is_file()
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert (ROOT / "traffic" / f"{entry['traffic']}.json").is_file()
    assert cell.traffic["mode"] in ("batch", "stream") and cell.traffic["loop"] == "closed"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer, "setup_s, another end-to-end and a per-layer metric"
    assert {m["moves"] for m in cell.per_layer} <= e2e
    assert set(cell.limits) >= ({"pred_err", "sigma_err"} if cell.traffic["nrep"] else {"pred_err"})
    for m in cell.end_to_end:
        assert callable(harness.reader("end_to_end", m["name"]).read)
    for m in cell.per_layer:
        assert callable(harness.reader("metrics", m["name"]).read)


@pytest.mark.parametrize("op", sorted(p.stem for p in (ROOT / "roofline_ops").glob("*.py")))
def test_roofline_ops_found_by_name(op):
    assert callable(roofline.op(op).work)
