"""The port's config and observability plumbing (config and passthrough
headers as they reach the workers, version skew, the latency sketch, the
fault-tolerance knobs set with SET, the graphviz text) against the
reference's, on the CPU: the counterpart of tests/test_config_plumbing.py.

Every case runs both packages on the same input and compares what each
observes: the config and headers a worker's registry holds after
``set_plan`` and after a coordinated run (captured as they arrive), which
headers are refused, the version-skew error, the sketch's count,
percentiles, merge and wire dict on the same lognormal samples (exactly),
the coordinator's recorded latencies, the knobs' parsed values, and the
graphviz text of the same staged plan.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_port_helpers import BOTH, PORT, REF

torch.set_num_threads(1)


def _plan(P, n=512):
    rng = np.random.default_rng(0)
    t = P.table(pa.table({"k": rng.integers(0, 8, n),
                          "v": rng.normal(size=n)}))
    phys = P("plan.physical")
    scan = phys.MemoryScanExec([t], t.schema())
    agg = phys.HashAggregateExec(
        "single", ["k"], [P("ops.aggregate").AggSpec("sum", "v", "sv")],
        scan, 16)
    dist = P("planner.distributed")
    return dist.distribute_plan(agg, dist.DistributedConfig(num_tasks=4))


def _seen_by_workers(P) -> list:
    """(stage, task, config knob, header) of every plan a coordinated run
    ships, then the same of a direct set_plan."""
    rt = P("runtime.coordinator")
    cluster = rt.InMemoryCluster(2)
    seen = []
    for w in cluster.workers.values():
        real = w.set_plan

        def set_plan(key, plan_obj, *a, _real=real, **kw):
            seen.append((key.stage_id, key.task_number,
                         (kw.get("config") or {}).get("custom_knob"),
                         (kw.get("headers") or {}).get("authorization")))
            return _real(key, plan_obj, *a, **kw)

        w.set_plan = set_plan
    coord = rt.Coordinator(
        resolver=cluster, channels=cluster,
        config_options={"collect_metrics": True, "custom_knob": 7},
        passthrough_headers={"authorization": "Bearer xyz"})
    out = coord.execute(_plan(P))
    w = next(iter(cluster.workers.values()))
    t = P.table(pa.table({"x": np.arange(8)}))
    obj = P("runtime.codec").encode_plan(
        P("plan.physical").MemoryScanExec([t], t.schema()), w.table_store)
    key = P("runtime.worker").TaskKey("q", 0, 0)
    w.set_plan(key, obj, 1, config={"custom_knob": 7},
               headers={"authorization": "Bearer xyz"})
    data = w.registry.get(key)
    return (sorted(seen), data.config.get("custom_knob"),
            data.headers.get("authorization"), out.to_numpy())


def test_config_and_headers_reach_workers():
    got = {P: _seen_by_workers(P) for P in BOTH}
    assert got[PORT][:3] == got[REF][:3]
    assert got[PORT][1:3] == (7, "Bearer xyz")
    assert got[PORT][0] and all(s[2:] == (7, "Bearer xyz")
                                for s in got[PORT][0])


@pytest.mark.parametrize("headers", [
    {"x-dftpu-internal": "1"}, {"authorization": "ok"},
    {"X-DFTPU-trace": "a"}, {"x-request-id": "r1", "x-dftpu-": ""},
])
def test_reserved_passthrough_headers(headers):
    got = {}
    for P in BOTH:
        try:
            P("runtime.worker").validate_passthrough_headers(headers)
            got[P] = "ok"
        except ValueError as e:
            got[P] = str(e)
    assert got[PORT] == got[REF]


def test_version_skew_detected():
    got = {}
    for P in BOTH:
        rt = P("runtime.coordinator")
        cluster = rt.InMemoryCluster(2)
        list(cluster.workers.values())[1].version = "9.9.9"
        coord = rt.Coordinator(resolver=cluster, channels=cluster,
                               expected_version="0.1.0")
        try:
            coord.execute(_plan(P))
            got[P] = None
        except Exception as e:  # noqa: BLE001 - the observed refusal
            got[P] = (type(e).__name__, str(e))
    assert got[PORT] == got[REF]
    assert got[PORT][0] == "WorkerError" and "version skew" in got[PORT][1]


def _sketch(P, values):
    m = P("runtime.metrics")
    a, b = m.LatencySketch(), m.LatencySketch()
    for v in values[:2000]:
        a.record(v)
    for v in values[2000:]:
        b.record(v)
    half = a.percentile(0.5)
    a.merge(b)
    back = m.LatencySketch.from_dict(a.to_dict())
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)
    return (half, a.count, [a.percentile(q) for q in qs], a.to_dict(),
            [back.percentile(q) for q in qs], a.summary())


def test_latency_sketch_percentiles_and_merge():
    rng = np.random.default_rng(1)
    values = rng.lognormal(mean=-3.0, sigma=1.0, size=4000)
    got = {P: _sketch(P, values) for P in BOTH}
    assert got[PORT] == got[REF]
    assert got[PORT][1] == 4000
    for q, est in zip((0.5, 0.95, 0.99), (got[PORT][2][3], got[PORT][2][5],
                                          got[PORT][2][6])):
        exact = float(np.quantile(values, q))
        assert abs(est - exact) / exact < 0.05, (q, est, exact)
    assert got[PORT][4] == got[PORT][2]


def test_coordinator_records_latency():
    got = {}
    for P in BOTH:
        rt = P("runtime.coordinator")
        cluster = rt.InMemoryCluster(2)
        coord = rt.Coordinator(resolver=cluster, channels=cluster)
        coord.execute(_plan(P))
        s = coord.latency.summary()
        got[P] = (sorted(s), s["count"])
        assert s["p50"] is not None and s["p50"] > 0, P
    assert got[PORT] == got[REF]


SET_SQL = ("set distributed.max_task_retries = 5;"
           "set distributed.task_timeout_s = 1.5;"
           "set distributed.dispatch_timeout_s = 2.5;"
           "set distributed.quarantine_threshold = 1;"
           "set distributed.quarantine_seconds = 0.25;"
           "set distributed.task_retry_backoff_s = 0.01")


def _knobs(P, options):
    kw = {} if options is None else {"config_options": options}
    c = P("runtime.coordinator").Coordinator(resolver=None, channels=None,
                                             **kw)
    policy = c._health_tracker().policy
    return (c._opt_int("max_task_retries"), c._opt_float("task_timeout_s"),
            c._opt_float("dispatch_timeout_s"),
            c._opt_int("quarantine_threshold"),
            c._opt_float("quarantine_seconds"),
            c._opt_float("task_retry_backoff_s"),
            policy.failure_threshold, policy.quarantine_seconds)


@pytest.mark.parametrize("how", ["set", "defaults", "malformed"])
def test_fault_tolerance_knobs(how):
    got = {}
    for P in BOTH:
        if how == "set":
            ctx = P("sql.context").SessionContext(
                **({"device": "cpu"} if P is PORT else {}))
            ctx.sql(SET_SQL)
            opts = dict(ctx.config.distributed_options)
            knobs = P("runtime.coordinator").FAULT_TOLERANCE_DEFAULTS
            assert all(k in opts for k in knobs), P
            opts = {k: opts[k] for k in knobs}
        elif how == "defaults":
            opts = None
        else:
            opts = {"max_task_retries": "many", "task_timeout_s": "soon",
                    "quarantine_threshold": None}
        got[P] = (opts, _knobs(P, opts))
    assert got[PORT] == got[REF]
    if how == "set":
        assert got[PORT][1] == (5, 1.5, 2.5, 1, 0.25, 0.01, 1, 0.25)


def _numbered(dot: str) -> str:
    """The graphviz text with each node id (a process-wide counter, which
    the two packages advance differently) renamed by first appearance."""
    import re

    ids: dict = {}
    return re.sub(r"\bn\d+\b",
                  lambda m: ids.setdefault(m.group(0), f"n{len(ids)}"), dot)


def test_graphviz_display():
    got = {P: _numbered(P("planner.distributed")
                        .display_staged_plan_graphviz(_plan(P)))
           for P in BOTH}
    assert got[PORT] == got[REF]
    dot = got[PORT]
    assert dot.startswith("digraph") and "subgraph cluster_" in dot
    assert "->" in dot
