"""Each cell runs end to end at a tiny size on the CPU through the port's
plain routes (the look for a card skipped) and prints a result line of the
contract's shape with ``correct`` true."""

import json
import math

import pytest
from conftest import CELLS, run_tiny, tiny_cell


@pytest.mark.parametrize("trace", [0, 1], ids=["timed", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_cpu(name, trace):
    out, line = run_tiny(name, trace=bool(trace))
    assert line["correct"] is True, line["checks"]
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) >= {"pred_err"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and 0 <= c["value"] <= c["limit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        # no device on the CPU: the per-layer readers find nothing to read
        assert line["metrics"] == {} and line["device"]["busy_s"] == 0.0
    else:
        assert set(line["metrics"]) == {m["name"] for m in tiny_cell(name).end_to_end}
        assert {"peak_mem_gib", "setup_s"} < set(line["metrics"])
        assert all(math.isfinite(m["value"]) for m in line["metrics"].values())
    json.dumps(line)
    assert out["foreign"] == []


@pytest.mark.parametrize("name", ["ig_beta6.boot256", "ig_beta6.stream"])
def test_same_seed_same_answers(name):
    a, _ = run_tiny(name, seconds=0.05)
    b, _ = run_tiny(name, seconds=0.05)
    first = a["window"].answers[0], b["window"].answers[0]
    assert first[0]["seed"] == first[1]["seed"]
    assert (first[0]["pred"] == first[1]["pred"]).all() and (first[0]["std"] == first[1]["std"]).all()
