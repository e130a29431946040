"""Rehearsals on the CPU at a small size, through the same harness as
`run.py`, of the ClickBench cell and of the TPC-H cell that the files make
ready (`cells.prepared`; BENCHMARK.json does not list it): the reference
agrees with the port, the frozen TPC-H generator with the port's, nothing
forbidden is loaded, and a broken timed path or a control in a narrower
precision comes out not correct."""

import shutil

import numpy as np
import pytest
import torch

from _run import HERE, rehearse, script
from harness import cells

SMALL = {"tpch-sf1.power": 0.01, "clickbench-hits.dashboard": 20000}
SEEDS = [3, 2**31 + 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_reference_agrees_with_the_port(cell, seed):
    rc, result, out, err = rehearse("--workload", cell, "--seed", seed,
                                    "--size", SMALL[cell])
    assert rc == 0, err[-3000:]
    assert result["correct"], err[-3000:]
    assert result["checks"]["wrong_results"]["value"] == 0
    assert result["attempted"] >= 22 and result["failed"] == 0
    # no top-level jax, jaxlib, flax or the JAX package in the process
    assert out.strip().splitlines()[-2] == "[]"


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_rehearsal_reports_per_layer_metrics(cell):
    rc, result, _out, err = rehearse("--workload", cell, "--seed", 11,
                                     "--size", SMALL[cell], "--trace", 1)
    assert rc == 0 and result["correct"], err[-3000:]
    # the CPU has no device activity: only the host's metrics are read,
    # those that BENCHMARK.json lists for the cell
    listed = {m["name"] for m in cells.per_layer(cell)}
    assert set(result["metrics"]) == listed & {"session.plan_ms",
                                               "executor.syncs_per_query"}
    assert result["device"]["busy_s"] == 0.0
    assert len(result["breakdown"]["idle_gaps"]) <= 10
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", ["alter", "half"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    rc, result, _out, err = rehearse("--workload", cell, "--seed", 7,
                                     "--size", SMALL[cell], "--fault", fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
    assert result["checks"]["wrong_results"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    rc, result, _out, err = script(
        HERE / "control.py", "--workload", cell, "--seed", 5, "--device",
        "cpu", "--size", SMALL[cell])
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
    checks = result["checks"]
    assert (checks["float_rel_err"]["value"]
            > checks["float_rel_err"]["limit"]
            or checks["wrong_results"]["value"] > 0)


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_frozen_tpch_generator_equals_the_ports(seed):
    from datafusion_distributed_tpu_torch.data import tpchgen
    from generators import tpch

    ours, theirs = tpch.generate(0.01, seed), tpchgen.gen_tpch(0.01, seed)
    assert list(ours) == list(theirs)
    for name, host in theirs.items():
        t = ours[name]
        assert list(t["columns"]) == [f.name for f in host.schema.fields]
        for col, values in t["columns"].items():
            assert np.array_equal(values, host.data[col]), (name, col)
            if t["types"][col] == "string":
                assert np.array_equal(
                    t["dicts"][col],
                    host.dictionaries[col].values.astype(str)), (name, col)


def test_clickbench_generator_is_seeded():
    from generators import clickbench_hits as gen

    a = gen.generate(5000, 2**33 + 9, "cpu", capacity=8192)["hits"]
    b = gen.generate(5000, 2**33 + 9, "cpu", capacity=8192)["hits"]
    c = gen.generate(5000, 2**33 + 10, "cpu", capacity=8192)["hits"]
    assert list(a["columns"]) == [n for n, _ in gen.SCHEMA]
    assert len(a["columns"]) == 105
    for name, col in a["columns"].items():
        assert col.shape == (8192,) and not col[5000:].any()
        assert torch.equal(col, b["columns"][name])
    # another seed orders the same rows (the values come from data_seed)
    assert not torch.equal(a["columns"]["UserID"], c["columns"]["UserID"])
    for name, col in a["columns"].items():
        assert torch.equal(col.sort().values,
                           c["columns"][name].sort().values), name
    d = gen.generate(5000, 2**33 + 9, "cpu", capacity=8192, data_seed=1)
    assert not torch.equal(a["columns"]["UserID"].sort().values,
                           d["hits"]["columns"]["UserID"].sort().values)
    assert list(a["dicts"]["URL"]) == sorted(a["dicts"]["URL"])
    assert gen.stable_hash("http://example.com/1") == \
        gen.stable_hash("http://example.com/1")


def test_run_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, result, out, _err = script(HERE / "run.py", "--workload",
                                   "clickbench-hits.dashboard", "--seed", 1,
                                   "--seconds", 1)
    assert rc != 0 and result is None and out == ""


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ lacks the
    port: a run exits non-zero and prints no result."""
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, result, out, _err = script(
        tmp_path / "portbench" / "tests" / "rehearse.py", "--workload",
        "tpch-sf1.power", "--seed", 1, "--size", 0.01, cwd=tmp_path,
        env={"PYTHONPATH": ""})
    assert rc != 0 and result is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, result, _out, err = script(
        HERE / "control.py", "--workload", cell, "--seed", 5, "--size",
        SMALL[cell])
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
