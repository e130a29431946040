"""`ctx.last_trace()`, `ctx.last_trace_profile()`, `trace_coverage` and
`render_profile` of the port against the reference's, on coordinated TPC-H
q3 (SF 0.002, seed 7, `bytes_per_task = 1`, 4 tasks over an
InMemoryCluster of 4 workers, `SET distributed.tracing = 'on'`), on the CPU.

Times differ between the packages, so the comparisons are of structure:
the Chrome trace's events by phase, category and name; the spans by kind,
name and attribute keys (the reference's worker spans also carry
`new_traces`, its XLA trace count, which an eager port has no counterpart
of); the bytes each stage's data plane moved; the fault and membership
events; and the profile report with its times masked."""

import collections
import json
import os
import re

import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import tracing as jtr
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import tracing as ttr
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q3 = open(os.path.join(REPO, "benchmarks", "queries", "tpch", "q3.sql")).read()
JAX_ONLY_ATTRS = {"new_traces"}


@pytest.fixture(scope="module")
def traced():
    arrow = gen_tpch(sf=0.002, seed=7)
    out = {}
    for name, ctx, mod, tr in (("reference", JContext(), jcoord, jtr),
                               ("port", TContext(device="cpu"), tcoord, ttr)):
        ctx.config.distributed_options["bytes_per_task"] = 1
        for tname, tbl in arrow.items():
            ctx.register_arrow(tname, tbl)
        ctx.sql("SET distributed.tracing = 'on'")
        cluster = mod.InMemoryCluster(4)
        coord = mod.Coordinator(resolver=cluster, channels=cluster,
                                config_options=ctx.config.distributed_snapshot())
        result = ctx.sql(Q3).collect_coordinated_table(coordinator=coord,
                                                       num_tasks=4)
        out[name] = {
            "ctx": ctx,
            "module": tr,
            "result": result.to_numpy(),
            "chrome": ctx.last_trace(),
            "profile": ctx.last_trace_profile(),
            "trace": tr.DEFAULT_TRACE_STORE.last(),
        }
    return out


def _events(chrome: dict) -> collections.Counter:
    return collections.Counter(
        (e.get("ph"), e.get("cat"), e.get("name"))
        for e in chrome["traceEvents"])


def test_last_trace_is_the_references_chrome_trace(traced):
    ref, port = traced["reference"]["chrome"], traced["port"]["chrome"]
    assert sorted(port) == sorted(ref)
    assert _events(port) == _events(ref)
    assert len(port["traceEvents"]) == len(ref["traceEvents"]) > 0
    # the export is plain JSON (Perfetto loads it as written)
    assert json.loads(json.dumps(port)) == port
    lanes = {e["args"]["name"] for e in port["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "coordinator" in lanes


def test_spans_and_events_equal_the_references(traced):
    def spans(trace):
        return collections.Counter(
            (s.kind, s.name,
             tuple(sorted(set(s.attrs) - JAX_ONLY_ATTRS)))
            for s in trace.span_list())

    def events(trace):
        return [n for _, n, _, _ in trace.event_list()]

    ref, port = traced["reference"]["trace"], traced["port"]["trace"]
    assert spans(port) == spans(ref)
    assert events(port) == events(ref)
    assert port.dropped == ref.dropped == 0


def test_stage_data_rates_move_the_references_bytes(traced):
    def bytes_by_stage(side):
        rates = side["module"].stage_data_rates(side["trace"])
        return {sid: slot["bytes"] for sid, slot in rates.items()}

    assert bytes_by_stage(traced["port"]) == bytes_by_stage(
        traced["reference"])


def test_trace_coverage(traced):
    for side in ("reference", "port"):
        tr, trace = traced[side]["module"], traced[side]["trace"]
        cov, max_gap = tr.trace_coverage(trace)
        assert 0.95 <= cov <= 1.0 and 0.0 <= max_gap <= 0.05, (side, cov)


def _masked(profile: str) -> list:
    """The profile with times, rates, shares and the query id masked, the
    top-span rows reduced to a count (which spans lead depends on time)."""
    out, top = [], 0
    for line in profile.splitlines():
        if re.match(r"^\s+\d+\.\d+s\s", line):
            top += 1
            continue
        line = re.sub(r"\(query [0-9a-f]+\)", "(query Q)", line)
        line = re.sub(r"\d+\.\d+(s|%| GB/s)", r"T\1", line)
        out.append(line)
    return out + [f"top rows: {top}"]


def test_last_trace_profile_and_render_profile(traced):
    ref, port = traced["reference"], traced["port"]
    assert port["profile"] == ttr.render_profile(port["trace"])
    assert port["profile"].startswith("-- trace profile (query ")
    assert _masked(port["profile"]) == _masked(ref["profile"])
    assert ttr.render_profile(port["trace"], top_n=3).count("\n") < \
        port["profile"].count("\n")


def test_nothing_traced_gives_none_and_empty(traced, monkeypatch):
    for side in ("reference", "port"):
        tr, ctx = traced[side]["module"], traced[side]["ctx"]
        monkeypatch.setattr(tr, "DEFAULT_TRACE_STORE", tr.TraceStore())
        assert ctx.last_trace() is None
        assert ctx.last_trace_profile() == ""


def test_traced_result_equals_the_references(traced):
    ref, port = traced["reference"]["result"], traced["port"]["result"]
    assert list(port) == list(ref)
    assert all(len(port[k]) == len(ref[k]) for k in ref)
    assert port["l_orderkey"].tolist() == ref["l_orderkey"].tolist()
