"""The cells, configurations, traffic mixes, limits and per-layer metrics of
BENCHMARK.json are found by name, and the file keeps to the benchmark's
contract of names, units and keys."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    parts = spec.cell(name, BENCH)
    cfg, t = parts["config"], parts["traffic"]
    assert cfg["name"] == parts["cell"]["config"]
    assert cfg["precision"] in ("bfloat16", "int8", "float32")
    assert set(t) >= {"loop", "height", "width", "exp", "mode", "batch", "in_flight", "pool",
                      "warm_steps", "check_answers", "trace_seconds"}
    assert t["pool"] % t["batch"] == 0
    assert set(parts["limits"]) == {"off2_ratio"} and parts["limits"]["off2_ratio"] > 0
    # every cell reports set-up, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in spec.metrics(BENCH, "end_to_end", name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics(BENCH, "per_layer", name)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_found_by_name(metric):
    assert callable(spec.reader(metric))


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
