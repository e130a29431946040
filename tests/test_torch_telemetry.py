"""The port's telemetry (runtime/telemetry.py) and event log
(runtime/eventlog.py) against the reference's, on the CPU: the counterpart
of tests/test_telemetry.py less its console cases (those are in
tests/test_torch_console.py, apart from the sparkline row, which is here).

Every case runs both packages on the same input and compares what each
observes:

- the typed registry (counter, gauge, histogram, the callback gauge and a
  collector), with the same errors for the same misuse; the store adapters
  (HedgeBudget, LatencySketch);
- the OpenMetrics exposition of the same registry, byte for byte against
  the reference's render and its golden text; ``merge_snapshots`` worker
  labels and ``scalar_series``;
- ``get_metrics`` over an InMemoryCluster after a coordinated query, with
  per-worker degradation, and over two localhost gRPC workers (the port's
  ``start_localhost_cluster(2, device="cpu")`` against the reference's)
  with a server stopped;
- the history ring and sparklines; SloTracker's attainment and burn math
  and the SLO knobs' validation;
- the event-log ring, its sink and dump; fault events correlated with the
  trace ids, and logged with tracing off;
- the serving SLO and registry surface, and telemetry sampling that leaves
  the results and the shipped plans unchanged (the port's counterpart of
  the reference's "zero new traces").
"""

import json
import math
import os
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_results_equal,
    identical,
    record_shipped_plans,
    sum_by_key_plan,
)

torch.set_num_threads(1)

CHAOS_SEED = int(os.environ.get("DFTPU_CHAOS_SEED", "20260803"))
SQL = "select k, sum(v) as s from t group by k order by k"


def _tel(P):
    return P("runtime.telemetry")


def _raises(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the observation
        return type(e).__name__
    return "no error"


# ---------------------------------------------------------------------------
# registry units
# ---------------------------------------------------------------------------


def _typed_metrics(P):
    r = _tel(P).MetricRegistry()
    c = r.counter("dftpu_t_faults", "h", labels=("kind",))
    c.inc(kind="retry")
    c.inc(2, kind="retry")
    g = r.gauge("dftpu_t_depth", "h")
    g.set(5)
    g.dec(2)
    h = r.histogram("dftpu_t_wall", "h", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 50):
        h.observe(v)
    return {
        "counter": c.value(kind="retry"),
        "gauge": g.value(),
        "histogram": h.samples(),
        "errors": [
            _raises(lambda: c.inc(-1, kind="retry")),
            _raises(lambda: c.inc(kind="retry", extra="x")),
            _raises(lambda: c.inc()),
            _raises(lambda: r.gauge("dftpu_t_faults", "h",
                                    labels=("kind",))),
            _raises(lambda: r.counter("dftpu_t_faults", "h",
                                      labels=("other",))),
            _raises(lambda: r.counter("Bad-Name", "h")),
            _raises(lambda: r.histogram("dftpu_t_wall", "h",
                                        buckets=(0.5,))),
        ],
        "same_counter": r.counter("dftpu_t_faults", "h",
                                  labels=("kind",)) is c,
        "same_histogram": r.histogram("dftpu_t_wall", "h",
                                      buckets=(1.0, 0.1)) is h,
        "snapshot": r.snapshot(),
    }


def _callback_and_collector(P):
    r = _tel(P).MetricRegistry()
    box = {"v": 7}
    r.gauge("dftpu_t_cb", "h").set_function(lambda: box["v"])
    fc = P("runtime.metrics").FaultCounters()
    fc.bump("task_retries", 3)
    r.register_collector(fc.telemetry_families)
    first = r.snapshot()
    box["v"] = 9  # callbacks sample at snapshot time
    second = r.snapshot()
    r.register_collector(lambda: (_ for _ in ()).throw(RuntimeError()))
    return {"first": first, "second": second,
            "broken_collector": sorted(r.snapshot())}


def _store_adapters(P):
    metrics = P("runtime.metrics")
    hb = metrics.HedgeBudget()
    hb.try_acquire(1)
    hb.try_acquire(1)  # denied
    sk = metrics.LatencySketch()
    for v in (0.01, 0.02, 0.5):
        sk.record(v)
    return {"hedges": dict(hb.telemetry_families()),
            "sketch": dict(sk.telemetry_families("dftpu_t_lat"))}


GOLDEN = (
    '# HELP dftpu_g_bytes Staged bytes.\n'
    '# TYPE dftpu_g_bytes gauge\n'
    'dftpu_g_bytes 1024\n'
    '# HELP dftpu_g_faults Faults by kind.\n'
    '# TYPE dftpu_g_faults counter\n'
    'dftpu_g_faults_total{kind="retry"} 2\n'
    'dftpu_g_faults_total{kind="we\\"ird\\nkind"} 1\n'
    '# HELP dftpu_g_wall Wall seconds.\n'
    '# TYPE dftpu_g_wall histogram\n'
    'dftpu_g_wall_bucket{le="0.5"} 1\n'
    'dftpu_g_wall_bucket{le="2.0"} 2\n'
    'dftpu_g_wall_bucket{le="+Inf"} 2\n'
    'dftpu_g_wall_sum 1.1\n'
    'dftpu_g_wall_count 2\n'
    '# EOF\n'
)


def _exposition(P):
    tel = _tel(P)
    r = tel.MetricRegistry()
    c = r.counter("dftpu_g_faults", "Faults by kind.", labels=("kind",))
    c.inc(2, kind="retry")
    c.inc(1, kind='we"ird\nkind')  # label escaping
    r.gauge("dftpu_g_bytes", "Staged bytes.").set(1024)
    h = r.histogram("dftpu_g_wall", "Wall seconds.", buckets=(0.5, 2.0))
    h.observe(0.1)
    h.observe(1.0)
    # values the golden text leaves out: fractions, big and odd floats
    r2 = tel.MetricRegistry()
    g = r2.gauge("dftpu_g_odd", "Odd values.", labels=("case",))
    for case, v in (("third", 1 / 3), ("big", 2.0 ** 53 + 2),
                    ("tiny", 1e-9), ("neg", -4.5), ("inf", math.inf)):
        g.set(v, case=case)
    return {"golden": r.render_openmetrics(),
            "module": tel.render_openmetrics(r.snapshot()),
            "odd": r2.render_openmetrics()}


def _merge(P):
    tel = _tel(P)
    r = tel.MetricRegistry()
    r.gauge("dftpu_m_bytes", "h").set(10)
    base = tel.MetricRegistry()
    base.counter("dftpu_m_queries", "h").inc(4)
    merged = tel.merge_snapshots(
        base.snapshot(), {"grpc://a": r.snapshot(), "grpc://b": r.snapshot()})
    return {"merged": merged, "flat": tel.scalar_series(merged)}


REGISTRY_CASES = {
    "typed_metrics": _typed_metrics,
    "callback_and_collector": _callback_and_collector,
    "store_adapters": _store_adapters,
    "exposition": _exposition,
    "merge_snapshots": _merge,
}


@pytest.mark.parametrize("case", list(REGISTRY_CASES))
def test_registry_matches_reference(case):
    ref, got = REGISTRY_CASES[case](REF), REGISTRY_CASES[case](PORT)
    assert got == ref, case
    if case == "typed_metrics":
        assert got["counter"] == 3 and got["gauge"] == 3
        assert got["histogram"][0][1]["buckets"] == [
            [0.1, 1], [1.0, 2], ["+Inf", 3]]
        assert got["errors"] == ["ValueError"] * 7
        assert got["same_counter"] and got["same_histogram"]
    elif case == "callback_and_collector":
        assert got["first"]["dftpu_t_cb"]["samples"] == [[{}, 7.0]]
        assert got["first"]["dftpu_faults"]["samples"] == [
            [{"kind": "task_retries"}, 3]]
        assert got["second"]["dftpu_t_cb"]["samples"] == [[{}, 9.0]]
        assert "dftpu_t_cb" in got["broken_collector"]
    elif case == "store_adapters":
        assert got["hedges"]["dftpu_hedges_in_flight"]["samples"] == [
            [{}, 1]]
        assert got["hedges"]["dftpu_hedges_denied"]["samples"] == [[{}, 1]]
        assert {s[0]["quantile"] for s in
                got["sketch"]["dftpu_t_lat"]["samples"]} == {
            "p50", "p95", "p99"}
    elif case == "exposition":
        assert got["golden"] == got["module"] == GOLDEN
    else:
        assert [s[0] for s in got["merged"]["dftpu_m_bytes"]["samples"]] == [
            {"worker": "grpc://a"}, {"worker": "grpc://b"}]
        assert got["flat"]['dftpu_m_bytes{worker="grpc://a"}'] == 10.0
        assert got["flat"]["dftpu_m_queries"] == 4.0


# ---------------------------------------------------------------------------
# get_metrics over a cluster
# ---------------------------------------------------------------------------


def _families(out) -> dict:
    """{family: (type, sorted label keys of its samples)} of a merged
    snapshot."""
    return {name: (fam["type"], sorted({tuple(sorted(s[0]))
                                        for s in fam["samples"]}))
            for name, fam in out["metrics"].items()}


def _in_process(P):
    co = P("runtime.coordinator")
    cluster = co.InMemoryCluster(2)
    coord = co.Coordinator(resolver=cluster, channels=cluster)
    coord.execute(sum_by_key_plan(P))
    obs = P("runtime.observability").ObservabilityService(
        cluster, cluster, fault_counters=coord.faults)
    out = obs.get_metrics()
    executed = out["metrics"]["dftpu_worker_tasks_executed"]["samples"]
    text = obs.render_openmetrics()
    return {
        "workers": sorted(out["workers"]),
        "executed_by": sorted({s[0]["worker"] for s in executed}),
        "executed": sum(v for _l, v in executed),
        "families": _families(out),
        "text_end": text.endswith("# EOF\n"),
        "text_has": ["dftpu_worker_tasks_executed_total{" in text,
                     "dftpu_store_spilled_bytes{" in text],
    }


def _degraded(P):
    cluster = P("runtime.coordinator").InMemoryCluster(2)
    url = cluster.get_urls()[0]

    class Flaky:
        def get_urls(self):
            return cluster.get_urls()

        def get_worker(self, u):
            if u == url:
                raise RuntimeError("down")
            return cluster.get_worker(u)

    out = P("runtime.observability").ObservabilityService(
        Flaky(), Flaky()).get_metrics()
    other = [u for u in cluster.get_urls() if u != url][0]
    return {"down": out["workers"][url],
            "other": sorted(out["workers"][other]),
            "staged_by": sorted(
                s[0].get("worker") for s in
                out["metrics"]["dftpu_store_staged_bytes"]["samples"])}


@pytest.mark.parametrize("case", ["in_process", "degraded"])
def test_get_metrics_matches_reference(case):
    fn = {"in_process": _in_process, "degraded": _degraded}[case]
    ref, got = fn(REF), fn(PORT)
    assert got == ref
    if case == "in_process":
        assert got["executed_by"] == got["workers"] and got["executed"] >= 2
        assert "dftpu_store_spilled_bytes" in got["families"]
        assert got["text_end"] and all(got["text_has"])
    else:
        assert got["down"] == {"error": "down"} and "families" in got["other"]
        assert got["staged_by"] == ["mem://worker-1"]


def _reference_grpc_cluster():
    from datafusion_distributed_tpu.runtime import grpc_worker as jgrpc

    with pytest.MonkeyPatch.context() as mp:
        serve = jgrpc.serve_worker
        mp.setattr(jgrpc, "serve_worker",
                   lambda w, port=0, host=None: serve(w, port, "127.0.0.1"))
        return jgrpc.start_localhost_cluster(2)


def test_get_metrics_over_grpc_matches_reference():
    pytest.importorskip("grpc", reason="grpc not installed")
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )

    seen = {}
    for P, start in ((REF, _reference_grpc_cluster),
                     (PORT, lambda: start_localhost_cluster(
                         2, device="cpu", rpc_timeout_s=60))):
        cluster = start()
        try:
            co = P("runtime.coordinator")
            coord = co.Coordinator(resolver=cluster, channels=cluster)
            coord.execute(sum_by_key_plan(P))
            obs = P("runtime.observability").ObservabilityService(
                cluster, cluster)
            out = obs.get_metrics()
            executed = out["metrics"]["dftpu_worker_tasks_executed"][
                "samples"]
            urls = cluster.get_urls()
            assert {s[0]["worker"] for s in executed} <= set(urls)
            victim, survivor = urls
            cluster._by_url[victim][0].stop(grace=None)
            out2 = obs.get_metrics()
            seen[P] = {
                "executed": sum(v for _l, v in executed),
                "families": sorted(out["metrics"]),
                "victim": sorted(out2["workers"][victim]),
                "survivor": sorted(out2["workers"][survivor]),
            }
        finally:
            cluster.shutdown()
    assert seen[PORT] == seen[REF]
    assert seen[PORT]["executed"] >= 2
    assert seen[PORT]["victim"] == ["error"]
    assert "families" in seen[PORT]["survivor"]


# ---------------------------------------------------------------------------
# history ring, sparklines, SLO math
# ---------------------------------------------------------------------------


def _history(P):
    tel = _tel(P)
    clock = {"t": 0.0}
    h = tel.TelemetryHistory(capacity=4, resolution_s=1.0,
                             clock=lambda: clock["t"])
    r = tel.MetricRegistry()
    c = r.counter("dftpu_h_done", "h")
    sampled = []
    for i in range(10):
        c.inc(2)
        sampled.append(h.sample(r, extra={"p99_ms": 100.0 + i}))
        sampled.append(h.sample(r))  # inside the resolution window
        clock["t"] += 1.0
    return {"sampled": sampled, "len": len(h),
            "series": h.series("dftpu_h_done"),
            "rate": h.rate("dftpu_h_done"), "latest": h.latest("p99_ms"),
            "spark": h.sparkline("p99_ms"), "missing": h.rate("missing"),
            "capacity_1": _raises(lambda: tel.TelemetryHistory(capacity=1))}


def _sparklines(P):
    spark = _tel(P).sparkline
    rng = np.random.default_rng(5)
    cases = [[], [5, 5, 5], [0, 1, 2, 3], [0, 7], [-3, 0, 3, 9, 1],
             list(rng.normal(size=40))]
    return [spark(v) for v in cases] + [spark([0, 1, 2, 3], width=2),
                                        spark(cases[-1], width=16)]


def _slo(P):
    tel = _tel(P)
    t = tel.SloTracker(window=100)
    for _ in range(8):
        t.record(0.050, ok=True)
    t.record(0.500, ok=True)
    t.record(None, ok=False)
    t2 = tel.SloTracker(window=2)
    for v in (1.0, 0.01, 0.01):
        t2.record(v)
    return {"snap": t.snapshot(p99_target_ms=100, error_rate_target=0.2),
            "zero_target": t.snapshot(error_rate_target=0.0),
            "slid": t2.snapshot(p99_target_ms=100),
            "families": dict(t.telemetry_families(p99_target_ms=100))}


def _slo_knobs(P):
    ctx = P.ctx()
    ctx.sql("set distributed.slo_p99_ms = 250")
    ctx.sql("set distributed.slo_error_rate = 0.01")
    return {"options": {k: ctx.config.distributed_options[k]
                        for k in ("slo_p99_ms", "slo_error_rate")},
            "errors": [_raises(lambda: ctx.sql(
                "set distributed.slo_p99_ms = 0")),
                _raises(lambda: ctx.sql(
                    "set distributed.slo_error_rate = 1.5"))]}


HISTORY_CASES = {"history": _history, "sparklines": _sparklines,
                 "slo": _slo, "slo_knobs": _slo_knobs}


@pytest.mark.parametrize("case", list(HISTORY_CASES))
def test_history_and_slo_match_reference(case):
    ref, got = HISTORY_CASES[case](REF), HISTORY_CASES[case](PORT)
    assert got == ref, case
    if case == "history":
        assert got["sampled"] == [True, False] * 10 and got["len"] == 4
        assert got["series"][-1][1] == 20.0
        assert got["rate"] == pytest.approx(2.0)
        assert got["latest"] == pytest.approx(109.0)
        assert len(got["spark"]) == 4 and got["missing"] is None
        assert got["capacity_1"] == "ValueError"
    elif case == "sparklines":
        assert got[:4] == ["", "▁▁▁", "▁▃▆█", "▁█"] and len(got[6]) == 2
    elif case == "slo":
        s = got["snap"]
        assert s["window_n"] == 10 and s["p99_ok"] is False
        assert s["error_rate"] == pytest.approx(0.1)
        assert s["p99_ms"] == pytest.approx(500.0)
        assert s["latency_attainment"] == pytest.approx(8 / 9)
        assert s["error_budget_burn"] == pytest.approx(0.5)
        assert got["zero_target"]["error_budget_burn"] == math.inf
        assert got["slid"]["latency_attainment"] == 1.0
    else:
        assert got["options"]["slo_p99_ms"] == 250.0
        assert got["errors"] == ["ValueError", "ValueError"]


# ---------------------------------------------------------------------------
# event log, and its correlation with traces and fault counters
# ---------------------------------------------------------------------------


def _event_log(P, tmp_path):
    EventLog = P("runtime.eventlog").EventLog
    sink = tmp_path / f"{P}-events.jsonl"
    log = EventLog(capacity=3, path=str(sink))
    for i in range(5):
        log.log("task_retry", query_id="q1", stage=i, task=0)
    stats = log.stats()
    ring = [e["stage"] for e in log.events()]
    lines = [json.loads(x) for x in sink.read_text().strip().splitlines()]
    dumped = log.dump(str(tmp_path / f"{P}-dump.jsonl"))
    weird = log.log("weird", query_id="q2", obj=object())
    fams = dict(log.telemetry_families())
    log.close()
    return {
        "stats": {k: stats[k] for k in ("events", "total", "dropped")},
        "ring": ring,
        "sink": [(e["kind"], e["stage"], e["seq"]) for e in lines],
        "sink_keys": sorted({k for e in lines for k in e}),
        "filtered": log.events(query_id="nope"),
        "dumped": dumped,
        "weird_is_str": isinstance(weird["obj"], str),
        "families": fams,
    }


def test_event_log_matches_reference(tmp_path):
    ref, got = _event_log(REF, tmp_path), _event_log(PORT, tmp_path)
    assert got == ref
    assert got["stats"] == {"events": 3, "total": 5, "dropped": 2}
    assert got["ring"] == [2, 3, 4]
    assert [s for _k, s, _q in got["sink"]] == [0, 1, 2, 3, 4]
    assert "ts" in got["sink_keys"] and got["dumped"] == 3
    assert got["weird_is_str"]
    fams = got["families"]
    assert fams["dftpu_events_dropped"]["samples"] == [[{}, 3]]
    assert fams["dftpu_events_logged"]["samples"] == [[{}, 6]]
    assert {s[0]["kind"]: s[1] for s in fams["dftpu_events"]["samples"]} \
        == {"task_retry": 5, "weird": 1}


def _fault_events(P, tracing):
    co = P("runtime.coordinator")
    chaos = P("runtime.chaos")
    cluster = co.InMemoryCluster(3)
    wrapped = chaos.wrap_cluster(cluster,
                                 chaos.one_crash_per_stage(CHAOS_SEED))
    opts = {"task_retry_backoff_s": 0.001}
    if tracing:
        opts["tracing"] = "on"
    coord = co.Coordinator(resolver=wrapped, channels=wrapped,
                           config_options=opts)
    log = P("runtime.eventlog").default_event_log()
    before = {e["seq"] for e in log.events()}
    out = coord.execute(sum_by_key_plan(P))
    qid = coord.last_query_id
    retries = [e for e in log.events() if e["seq"] not in before
               and e["kind"] == "task_retry"]
    trace = coord.last_query_trace()
    seen = {
        "retries": len(retries),
        "same_query": all(e["query_id"] == qid for e in retries),
        "counted": coord.faults.get("task_retries") == len(retries),
        "traced": trace is not None,
    }
    if trace is not None:
        traced = [a for _t, name, a, _p in trace.event_list()
                  if name == "task_retry"]
        seen["trace_matches"] = (
            len(traced) == len(retries)
            and {(e.get("stage"), e.get("task")) for e in retries}
            == {(a.get("stage"), a.get("task")) for a in traced})
    return seen, out.to_numpy()


@pytest.mark.parametrize("tracing", [True, False], ids=["traced",
                                                        "tracing_off"])
def test_fault_events_match_reference(tracing):
    (ref, ref_out), (got, out) = (_fault_events(REF, tracing),
                                  _fault_events(PORT, tracing))
    assert got["retries"] >= 1 and got["same_query"] and got["counted"]
    assert got["traced"] is tracing
    assert got.get("trace_matches", True)
    assert {k: v for k, v in got.items() if k != "retries"} == {
        k: v for k, v in ref.items() if k != "retries"}
    assert_results_equal(ref_out, out, "the plan under chaos")


# ---------------------------------------------------------------------------
# the serving SLO surface; sampling changes no plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving_ctxs():
    rng = np.random.default_rng(0)
    data = pa.table({"k": rng.integers(0, 8, 4096),
                     "v": rng.normal(size=4096)})
    out = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.register_arrow("t", data)
        out[P] = ctx
    return out


def _serving(P, ctx):
    ctx.config.distributed_options["slo_p99_ms"] = 60000.0
    ctx.config.distributed_options["slo_error_rate"] = 0.5
    try:
        srv = P("runtime.serving").ServingSession(ctx, num_workers=2)
        try:
            results = [h.result() for h in
                       [srv.submit(SQL) for _ in range(3)]]
            slo = srv.stats()["slo"]
            snap = srv.telemetry.snapshot()
            con = P("console").Console(srv.cluster, srv.cluster, serving=srv)
            obs = P("runtime.observability").ObservabilityService(
                srv.cluster, srv.cluster, serving=srv)
            merged = obs.get_metrics()["metrics"]
            P("runtime.adaptivity")  # registers its counters at import
            tel = _tel(P)
            default = tel.DEFAULT_REGISTRY.snapshot()
            exposed = tel.render_openmetrics(default)
            return {
                "slo": {k: slo[k] for k in (
                    "window_n", "latency_attainment", "p99_ok",
                    "error_budget_burn")},
                "done": [v for labels, v in
                         snap["dftpu_serving_queries"]["samples"]
                         if labels == {"state": "done"}],
                "families": sorted(snap),
                "history": len(srv.history) >= 1,
                "shared_history": con.history is srv.history,
                "merged_has": [f in merged for f in (
                    "dftpu_serving_admitted", "dftpu_worker_tasks_executed",
                    "dftpu_queries_preempted")],
                "preempted_0": "dftpu_queries_preempted_total 0"
                in obs.render_openmetrics(),
                "adaptivity": [(f in default, f"{f}_total" in exposed)
                               for f in ("dftpu_skew_splits",
                                         "dftpu_partial_agg_bailouts",
                                         "dftpu_replans")],
            }, results[-1]
        finally:
            srv.close()
    finally:
        ctx.config.distributed_options.pop("slo_p99_ms", None)
        ctx.config.distributed_options.pop("slo_error_rate", None)


def test_serving_slo_and_registry_match_reference(serving_ctxs):
    ref, ref_out = _serving(REF, serving_ctxs[REF])
    got, out = _serving(PORT, serving_ctxs[PORT])
    assert got == ref
    assert got["slo"] == {"window_n": 3, "latency_attainment": 1.0,
                          "p99_ok": True, "error_budget_burn": 0.0}
    assert got["done"] == [3] and got["history"] and got["shared_history"]
    assert all(got["merged_has"]) and got["preempted_0"]
    assert got["adaptivity"] == [(True, True)] * 3
    assert_results_equal(
        {c: ref_out.column(c).to_numpy() for c in ref_out.column_names},
        {c: out.column(c).to_numpy() for c in out.column_names}, "served")


def test_telemetry_sampling_changes_no_plan(serving_ctxs):
    """The port's counterpart of the reference's "telemetry and event log
    add zero new traces": with metrics merged, exposed, sampled into a
    history and events logged between queries, each run returns the same
    bytes and ships the same task plans (by fingerprint), and no kernel is
    built; the reference's trace count does not move."""
    from datafusion_distributed_tpu.plan import physical as jphys
    from datafusion_distributed_tpu_torch.ops import _build

    seen = {}
    for P in BOTH:
        ctx = serving_ctxs[P]
        co = P("runtime.coordinator")
        tel = _tel(P)
        cluster = co.InMemoryCluster(2)
        coord = co.Coordinator(resolver=cluster, channels=cluster)
        df = ctx.sql(SQL)
        base = df.collect_coordinated_table(coordinator=coord, num_tasks=2)
        obs = P("runtime.observability").ObservabilityService(
            cluster, cluster, fault_counters=coord.faults)
        shipped = record_shipped_plans(cluster)
        traces0 = jphys.trace_count()
        libs0 = dict(_build._LIBS)
        hist = tel.TelemetryHistory(capacity=8, resolution_s=0.0)
        runs = []
        for _ in range(2):
            got = ctx.sql(SQL).collect_coordinated_table(
                coordinator=co.Coordinator(resolver=cluster,
                                           channels=cluster,
                                           faults=coord.faults),
                num_tasks=2)
            assert identical(base.to_numpy(), got.to_numpy()), P
            out = obs.get_metrics()
            assert out["metrics"]
            obs.render_openmetrics()
            hist.sample(None, extra=tel.scalar_series(out["metrics"]))
            P("runtime.eventlog").default_event_log().log(
                "bench_tick", query_id="telemetry-test")
            runs.append(sorted(shipped))
            shipped.clear()
        if P is REF:
            assert jphys.trace_count() == traces0
        else:
            assert dict(_build._LIBS) == libs0
            assert runs[0] and all(fp for *_k, fp in runs[0])
            assert runs[0] == runs[1]
        seen[P] = base.to_numpy()
    assert_results_equal(seen[REF], seen[PORT], "sampled runs")


def _console_sparkline(P):
    cluster = P("runtime.coordinator").InMemoryCluster(1)
    con = P("console").Console(cluster, cluster, poll_s=0.01)
    con.history = _tel(P).TelemetryHistory(capacity=16, resolution_s=0.0)

    class FakeServing:
        telemetry = None
        history = None
        _n = 0

        def stats(self):
            FakeServing._n += 2
            return {"active": 0, "queued": 0,
                    "admitted_total": FakeServing._n,
                    "completed": {"done": FakeServing._n},
                    "latency": {"p99": 0.120}, "budget_bytes": 0, "slo": {}}

    con.obs.serving = FakeServing()
    con.render_frame()
    frame = con.render_frame()  # second frame: two points give trends
    plain = re.sub(r"\x1b\[[0-9;]*m", "", frame)
    line = [ln for ln in plain.splitlines() if ln.startswith("telemetry")]
    return [("qps" in ln, "p99" in ln) for ln in line]


def test_console_sparkline_row_matches_reference():
    """The reference suite's console sparkline case (its other console
    cases are in tests/test_torch_console.py)."""
    assert _console_sparkline(PORT) == _console_sparkline(REF) == [
        (True, True)]
