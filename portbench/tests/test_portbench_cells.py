"""Every cell, configuration, traffic mix and metric that BENCHMARK.json
names is found by name, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from harness import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_found_by_name(w):
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert len(w["why"]) <= 200
    config = cells.config(w["config"])
    mix = cells.traffic(w["traffic"])
    assert config["name"] == w["config"]
    assert [q for q, _ in cells.queries(mix)] == mix["queries"]
    for kind, name in (("generators", config["generator"]),
                       ("reference", config["reference"]),
                       ("entries", mix["entry"])):
        cells.module(kind, name)
    ref = cells.module("reference", config["reference"])
    assert set(mix["queries"]) <= set(ref.QUERIES)
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m["name"] for m in cells.end_to_end(w["name"], BENCH)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cells.per_layer(w["name"], BENCH)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    data = json.loads((cells.ROOT / c["file"]).read_text())
    assert data["source"] == c["source"]
    assert data["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert data["control"]["kind"] in ("program", "reference")


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert callable(cells.reader(m["name"]).read)
        for w in m.get("workloads", []):
            cells.workload(w, BENCH)


def test_one_layer_name_per_layer():
    by_prefix = {}
    for m in BENCH["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        cells.workload("no-such-cell", BENCH)
    with pytest.raises(FileNotFoundError):
        cells.module("metrics", "no.such.metric")
    with pytest.raises(FileNotFoundError):
        cells.reader("no.such.metric")
    with pytest.raises(KeyError):
        cells.prepared("no-such-config.power")
