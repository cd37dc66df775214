"""BENCHMARK.json against the contract, and the harness finding every
part of a cell by name."""
import json
import re

import pytest

from perfbench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][1] == "perfbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in BENCH[k]]
        assert len(ns) == len(set(ns))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(cell):
    c = spec.cell(cell)
    assert c.workload["name"] == cell and c.workload["config"] == c.config["name"]
    loop = spec.loop(c.workload["loop"])
    assert set(c.workload["limits"]) == set(loop.CHECKS)
    # the loop says whether it trains, and every metric the cell lists is
    # of that kind: a traced run asks only those (`cell.per_layer`)
    assert isinstance(loop.TRAINING, bool)
    assert all(spec.trains(m["name"]) == loop.TRAINING for m in c.per_layer)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        reader = spec.metric_reader(m["name"])
        assert reader.UNIT == m["unit"] and reader.MOVES == m["moves"]
        assert m["moves"] in e2e  # the cell reports what the metric moves


def test_per_layer_layers_named_alike():
    """Every metric names its layer from the one list, which has room for
    the solver's."""
    assert {m["layer"] for m in BENCH["per_layer"]} <= set(spec.LAYERS)
    assert "solver" in spec.LAYERS and len(set(spec.LAYERS)) == len(spec.LAYERS)


def test_a_workload_file_not_yet_named_is_a_cell():
    c = spec.cell("coord-validate-f32-b64")
    assert c.chips == 1 and c.config["name"] == c.workload["config"]
    assert {m["name"] for m in c.end_to_end} == {"peak_mem_gib", "setup_s"}
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
