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

import numpy as np
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


# ---------------------------------------------------------------------------
# The single-node path's spans (runtime/tracing.py `span`, `local_query`):
# the port's own, with no counterpart in the reference
# ---------------------------------------------------------------------------

SINGLE = "select k, sum(f) from t where s like 's1%' group by k"


@pytest.fixture()
def single(monkeypatch):
    """A session over a small table, with a trace store of its own (the
    process-wide one feeds other tests' consoles)."""
    import pyarrow as pa

    monkeypatch.setattr(ttr, "DEFAULT_TRACE_STORE", ttr.TraceStore())
    rng = np.random.default_rng(3)
    n = 4000
    ctx = TContext(device="cpu")
    ctx.register_arrow("t", pa.table({
        "k": rng.integers(0, 3000, n), "f": rng.random(n),
        "s": pa.array([f"s{i % 37}" for i in range(n)])}))
    ttr.reset_span_totals()
    yield ctx
    ttr.reset_span_totals()


def _run_as_the_benchmark(ctx, sql):
    """One query as portbench's session entry runs it, each step inside
    its `portbench:<step>:<query>` range."""
    from torch.profiler import record_function

    with record_function("portbench:plan:q"):
        df = ctx.sql(sql)
        df.physical_plan()
    with record_function("portbench:execute:q"):
        table = df.collect_table()
    with record_function("portbench:to_host:q"):
        return table.to_numpy()


def _ranges(prof) -> list:
    """(name, thread, start_ns, end_ns) of the benchmark's and the
    program's ranges, on the profiler's one clock."""
    return sorted(
        (e.name(), e.start_thread_id(), e.start_ns(),
         e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(("dftpu:", "portbench:")))


def _parent(ranges, r):
    """The innermost range that holds ``r`` on its thread."""
    holders = [p for p in ranges if p is not r and p[1] == r[1]
               and p[2] <= r[2] and r[3] <= p[3]]
    return min(holders, key=lambda p: p[3] - p[2]) if holders else None


def test_single_node_spans_nest_inside_the_benchmarks_ranges(single):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run_as_the_benchmark(single, SINGLE)
    assert len(out["k"]) > 0
    ranges = _ranges(prof)
    parent = {r: _parent(ranges, r) for r in ranges}

    def chain(name):
        r = next(x for x in ranges if x[0] == name)
        names = []
        while r is not None:
            names.append(r[0])
            r = parent[r]
        return names

    assert chain("dftpu:session:sql") == ["dftpu:session:sql",
                                          "portbench:plan:q"]
    assert chain("dftpu:expr:like")[-4:] == [
        "dftpu:op:HashAggregate", "dftpu:op:Projection",
        "dftpu:executor:attempt", "portbench:execute:q"]
    assert chain("dftpu:expr:like")[:2] == ["dftpu:expr:like",
                                            "dftpu:op:Filter"]
    assert chain("dftpu:kernel:build_group_ids")[:2] == [
        "dftpu:kernel:build_group_ids", "dftpu:op:HashAggregate"]
    assert chain("dftpu:table:to_host") == ["dftpu:table:to_host",
                                            "portbench:to_host:q"]
    plans = [r for r in ranges if r[0] == "dftpu:planner:physical_plan"]
    assert [parent[r][0] for r in plans] == ["portbench:plan:q",
                                             "dftpu:executor:attempt"]
    for name in ("dftpu:executor:load", "dftpu:executor:flags"):
        assert parent[next(r for r in ranges if r[0] == name)][0] == \
            "dftpu:executor:attempt"
    totals = ttr.span_totals()
    assert totals["executor:attempt:ok"][0] == 1
    assert totals["planner:physical_plan"][0] == 2
    assert all(seconds >= 0.0 for _n, seconds in totals.values())


def test_span_sites_make_nothing_when_off(single, monkeypatch):
    """With the profiler not recording and `distributed.tracing` off, a
    span site builds no span, reads no clock and records nothing."""

    class Boom:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read with spans off")

    def boom(*a, **kw):
        raise AssertionError("a span was made with spans off")

    assert not ttr.spans_on()
    monkeypatch.setattr(ttr, "time", Boom())
    monkeypatch.setattr(ttr, "Span", boom)
    monkeypatch.setattr(ttr, "_LocalSpan", boom)
    out = _run_as_the_benchmark(single, SINGLE)
    assert len(out["k"]) > 0
    assert ttr.span_totals() == {}
    with ttr.span("op", "X", "node_id", 1) as sp:
        assert sp.note("outcome", "ok") is sp


def test_last_trace_covers_a_single_node_query(single):
    single.sql("SET distributed.tracing = 'on'")
    df = single.sql(SINGLE)
    df.collect_table()
    trace = ttr.DEFAULT_TRACE_STORE.last()
    root = trace.root_span()
    assert root.kind == "query" and root.attrs["path"] == "single-node"
    spans = trace.span_list()
    kinds = collections.Counter(s.kind for s in spans)
    assert {"executor", "op", "expr", "kernel", "planner"} <= set(kinds)
    by_id = {s.span_id: s for s in spans}
    agg = next(s for s in spans if s.name == "HashAggregate")
    attempt = by_id[by_id[agg.parent_id].parent_id]
    assert (attempt.kind, attempt.name) == ("executor", "attempt")
    assert attempt.attrs == {"attempt": 0, "outcome": "ok"}
    assert attempt.parent_id == root.span_id
    build = next(s for s in spans if s.name == "build_group_ids")
    assert by_id[build.parent_id] is agg
    assert agg.attrs["node_id"] is not None
    events = {e["name"] for e in single.last_trace()["traceEvents"]}
    assert {"query", "attempt", "HashAggregate", "like"} <= events
    single.sql("SET distributed.tracing = 'off'")
    assert not ttr.spans_on()


def test_a_forced_overflow_is_an_attempt_with_outcome_overflow(single):
    single.sql("SET distributed.tracing = 'on'")
    single.sql("SET planner.agg_slot_factor = 0.1")
    df = single.sql(SINGLE)
    df.collect_table()
    assert df.last_retry_count == 1
    spans = ttr.DEFAULT_TRACE_STORE.last().span_list()
    attempts = sorted((s.t0, s.attrs["attempt"], s.attrs["outcome"])
                      for s in spans if s.name == "attempt")
    assert [a[1:] for a in attempts] == [(0, "overflow"), (1, "ok")]
    widen = next(s for s in spans if s.name == "overflow")
    first = next(s for s in spans if s.name == "attempt"
                 and s.attrs["attempt"] == 0)
    assert widen.parent_id == first.span_id
    totals = ttr.span_totals()
    assert totals["executor:attempt:overflow"][0] == 1
    assert totals["executor:attempt:ok"][0] == 1


def test_live_build_rows_count_only_while_spans_are_on(single):
    from torch.profiler import ProfilerActivity, profile

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    hk.reset_launch_counts()
    single.sql(SINGLE).collect_table()
    assert hk.live_build_rows() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        out = single.sql(SINGLE).collect_table().to_numpy()
    live = hk.live_build_rows()
    # one build over the filter's surviving rows, padded to its capacity
    assert len(live) == 1 and list(live.values()) == [
        sum(1 for i in range(4000) if f"s{i % 37}".startswith("s1"))]
    assert len(out["k"]) > 0
    hk.reset_launch_counts()
    assert hk.live_build_rows() == {}


def test_span_totals_lose_no_update_across_threads(single):
    """Spans closed on many threads at once, with a short switch interval:
    every one lands in the totals (they are updated under a lock)."""
    import sys
    import threading

    per_thread, threads = 300, 8
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ttr.local_query("on", store=ttr.TraceStore()):
            def work():
                for _ in range(per_thread):
                    with ttr.span("op", "Stress"):
                        pass
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert ttr.span_totals()["op:Stress"][0] == per_thread * threads
    assert not ttr.spans_on()


def test_string_length_and_concat_are_expr_spans(single):
    single.sql("SET distributed.tracing = 'on'")
    single.sql("select concat(s, s) as c, length(s) as l, count(*) from t "
               "group by 1, 2").collect_table()
    totals = ttr.span_totals()
    assert totals["expr:concat"][0] == 1 and totals["expr:length"][0] == 1
    spans = ttr.DEFAULT_TRACE_STORE.last().span_list()
    assert {s.attrs["entries"] for s in spans if s.name == "length"} == {37}
