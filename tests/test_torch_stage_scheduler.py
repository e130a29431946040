"""The port's stage-DAG scheduler (planner/distributed.py build_stage_dag,
the coordinator's concurrent stage materialization, runtime/metrics.py's
stage spans) against the reference's, on the CPU: the counterpart of
tests/test_stage_scheduler.py.

Every case runs both packages on the same input (TPC-H SF 0.002, seed 7,
``bytes_per_task = 1``, no broadcast joins, as the reference suite's
``tpch_ctx``; or seeded numpy tables) and compares what each observes:

- ``build_stage_dag`` of a join plan: the same stages, dependencies and
  topological order as the reference's DAG, with independent sibling
  stages; the refusal of a plan with an unstamped exchange;
- an instrumented cluster: the join's feed stages overlap in both;
  ``stage_parallelism = 1`` reproduces the sequential order, the same order
  of first execution as the reference's; the in-flight budget bounds the
  recorded spans;
- byte identity, sequential against the DAG scheduler (q3, q5 on both
  planes), under the seeded chaos schedule and for q21 (with chaos), each
  held against the reference's coordinated result;
- ``overlap_factor() > 1`` for q5 in both packages; the EXPLAIN ANALYZE
  stage-schedule render against the reference's text (times masked);
- a fatal error cancelling siblings and releasing slices, the cancel check
  before dispatch, and TaskCancelledError not being a WorkerError;
- the counterpart of the reference's two trace-relevance cases and its
  "stage_parallelism flip causes zero new traces": the scheduler and fault
  knobs are the reference's, and flipping them leaves the fingerprints of
  the staged plan and of every shipped task plan unchanged.
"""

import os
import re
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.test_stage_scheduler import TPCH_Q3, TPCH_Q5, TPCH_Q21
from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_matches_reference,
    assert_no_leaks,
    coordinated,
    identical,
    record_shipped_plans,
    tpch_contexts,
)

torch.set_num_threads(1)

CHAOS_SEED = int(os.environ.get("DFTPU_CHAOS_SEED", "20260803"))
FAST = {"task_retry_backoff_s": 0.001}
QUERIES = {"q3": TPCH_Q3, "q5": TPCH_Q5, "q21": TPCH_Q21}
JOIN_SQL = ("select o_orderkey, sum(l_extendedprice) s from orders, lineitem "
            "where o_orderkey = l_orderkey group by o_orderkey")


@pytest.fixture(scope="module")
def tpch():
    """Both packages' sessions over the same tables; ``ref(q)`` is the
    reference's coordinated result of ``q`` under ``stage_parallelism =
    1`` (run once)."""
    ctxs = tpch_contexts(bytes_per_task=1, broadcast_joins=False)
    memo = {}

    def ref(q):
        if q not in memo:
            memo[q] = coordinated(REF, ctxs[REF], QUERIES[q], _cluster(REF),
                           stage_parallelism=1)[0]
        return memo[q]

    return ctxs, ref


def _coord(P, cluster, **opts):
    return P("runtime.coordinator").Coordinator(
        resolver=cluster, channels=cluster,
        config_options={**FAST, **opts})


def _cluster(P, n=4):
    return P("runtime.coordinator").InMemoryCluster(n)


# ---------------------------------------------------------------------------
# DAG extraction
# ---------------------------------------------------------------------------


def _dag_facts(P, ctx):
    dist = P("planner.distributed")
    df = ctx.sql(JOIN_SQL)
    plan = df.distributed_plan(4, config=df._seeded_host_config(4))
    dag = dist.build_stage_dag(plan)
    assert dag is not None
    nodes = {}
    for sid, node in dag.nodes.items():
        assert node.stage_id == sid
        frontier = sorted(f.stage_id for f in dist.exchange_frontier(
            node.exchange.children()[0]))
        assert sorted(node.deps) == frontier
        assert all(d < sid for d in node.deps)
        nodes[sid] = (type(node.exchange).__name__, sorted(node.deps))
    return nodes, dag.schedulable_order()


def test_build_stage_dag_matches_reference(tpch):
    ctxs, _ref = tpch
    ref, got = _dag_facts(REF, ctxs[REF]), _dag_facts(PORT, ctxs[PORT])
    assert got == ref
    nodes, order = got
    sids = sorted(nodes)
    assert len(sids) >= 2 and order == sids
    deps = {sid: set(nodes[sid][1]) for sid in sids}

    def ancestors(s, acc):
        for d in deps[s]:
            if d not in acc:
                acc.add(d)
                ancestors(d, acc)
        return acc

    assert any(a not in ancestors(b, set()) and b not in ancestors(a, set())
               for a in sids for b in sids if a < b), \
        "join plan has no independent sibling stages"


def _unstamped(P):
    phys = P("plan.physical")
    dist = P("planner.distributed")
    rng = np.random.default_rng(0)
    t = P.table(pa.table({
        "k": rng.integers(0, 8, 256), "v": rng.normal(size=256),
    }))
    scan = phys.MemoryScanExec([t], t.schema())
    agg = phys.HashAggregateExec(
        "single", ["k"], [P("ops.aggregate").AggSpec("sum", "v", "sv")],
        scan, 16)
    staged = dist.distribute_plan(agg, dist.DistributedConfig(num_tasks=4))
    stamped = dist.build_stage_dag(staged) is not None
    staged.collect(lambda n: getattr(n, "is_exchange", False))[0] \
        .stage_id = None
    return stamped, dist.build_stage_dag(staged)


def test_build_stage_dag_rejects_unstamped_plans():
    assert _unstamped(PORT) == _unstamped(REF) == (True, None)


# ---------------------------------------------------------------------------
# instrumented overlap, sequential order, in-flight budget
# ---------------------------------------------------------------------------


class _StageRecorder:
    """Thread-safe record of which stages were executing when."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active: dict = {}
        self.peak_stages = 0
        self.first_seen: list = []
        self.intervals: dict = {}

    def enter(self, sid):
        now = time.monotonic()
        with self.lock:
            if not self.active.get(sid) and sid not in self.intervals:
                self.first_seen.append(sid)
                self.intervals[sid] = [now, now]
            self.active[sid] = self.active.get(sid, 0) + 1
            live = sum(1 for v in self.active.values() if v > 0)
            self.peak_stages = max(self.peak_stages, live)

    def exit(self, sid):
        now = time.monotonic()
        with self.lock:
            self.active[sid] -= 1
            self.intervals[sid][1] = max(self.intervals[sid][1], now)

    def overlapping_pairs(self):
        iv = self.intervals
        return {(a, b) for a in iv for b in iv
                if a < b and iv[a][0] < iv[b][1] and iv[b][0] < iv[a][1]}


def _instrumented_cluster(P, n, recorder, sleep_s=0.05):
    """``P``'s in-memory cluster whose workers record per-stage execution
    intervals; a small sleep per task makes sibling overlap deterministic
    on a loaded CPU."""
    cluster = _cluster(P, n)
    for w in cluster.workers.values():
        real = w._execute_task_body

        def body(key, _real=real):
            recorder.enter(key.stage_id)
            try:
                time.sleep(sleep_s)
                return _real(key)
            finally:
                recorder.exit(key.stage_id)

        w._execute_task_body = body
    return cluster


def _instrumented_run(P, ctx, sql, sleep_s, **opts):
    rec = _StageRecorder()
    cluster = _instrumented_cluster(P, 4, rec, sleep_s)
    out, coord = coordinated(P, ctx, sql, cluster, peer_shuffle=False, **opts)
    return out, coord, rec


def test_join_feeds_overlap_under_dag_scheduler(tpch):
    ctxs, _ref = tpch
    outs = {}
    for P in BOTH:
        out, _co, rec = _instrumented_run(
            P, ctxs[P], JOIN_SQL + " order by s desc", 0.05,
            stage_parallelism=4)
        assert rec.peak_stages >= 2, (P, rec.peak_stages)
        assert rec.overlapping_pairs(), (P, rec.intervals)
        outs[P] = out
    assert_matches_reference(outs[REF], outs[PORT], "join, DAG scheduler")


def test_stage_parallelism_one_reproduces_sequential_order(tpch):
    ctxs, _ref = tpch
    orders = {}
    for P in BOTH:
        _out, _co, rec = _instrumented_run(
            P, ctxs[P], JOIN_SQL + " order by s desc", 0.0,
            stage_parallelism=1)
        assert rec.peak_stages == 1, (P, "sequential mode overlapped")
        orders[P] = rec.first_seen
    order = orders[PORT]
    assert order == orders[REF]
    assert order[-1] == -1
    stages = [s for s in order if s != -1]
    assert stages == sorted(stages), order


def test_stage_parallelism_budget_bounds_inflight(tpch):
    ctxs, ref = tpch
    for P in BOTH:
        out, coord, _rec = _instrumented_run(
            P, ctxs[P], TPCH_Q5, 0.05, stage_parallelism=2,
            pipelined_shuffle=False)
        summary = coord.stage_metrics.stage_schedule_summary()
        assert 1 <= summary["max_concurrent"] <= 2, (P, summary)
    assert_matches_reference(ref("q5"), out, "q5 at a budget of 2")


# ---------------------------------------------------------------------------
# byte identity: sequential against the DAG scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,variants", [
    ("q3", ({"stage_parallelism": 4},)),
    ("q5", ({"stage_parallelism": 4},
            {"stage_parallelism": 4, "peer_shuffle": False})),
])
def test_byte_identical_sequential_vs_dag(tpch, q, variants):
    ctxs, ref = tpch
    base, _ = coordinated(PORT, ctxs[PORT], QUERIES[q], _cluster(PORT),
                   stage_parallelism=1)
    for opts in variants:
        got, _ = coordinated(PORT, ctxs[PORT], QUERIES[q], _cluster(PORT), **opts)
        assert identical(base.to_numpy(), got.to_numpy()), (q, opts)
    assert_matches_reference(ref(q), base, q)


@pytest.mark.parametrize("q", ["q5", "q21"])
def test_byte_identical_under_chaos_schedule(tpch, q):
    """One injected crash per stage under the concurrent scheduler: the
    result equals the fault-free sequential run, in both packages, and
    nothing leaks; q21 also without chaos."""
    ctxs, ref = tpch
    base, _ = coordinated(PORT, ctxs[PORT], QUERIES[q], _cluster(PORT),
                   stage_parallelism=1)
    if q == "q21":
        got, _ = coordinated(PORT, ctxs[PORT], QUERIES[q], _cluster(PORT),
                      stage_parallelism=4)
        assert identical(base.to_numpy(), got.to_numpy()), q
    fired = {}
    for P in BOTH:
        chaos = P("runtime.chaos")
        cluster = _cluster(P)
        wrapped = chaos.wrap_cluster(cluster,
                                     chaos.one_crash_per_stage(CHAOS_SEED))
        got, coord = coordinated(P, ctxs[P], QUERIES[q], wrapped,
                          stage_parallelism=4)
        assert_no_leaks(cluster)
        fired[P] = (bool(wrapped.plan.fired),
                    coord.faults.get("task_retries") >= 1)
        if P is PORT:
            assert identical(base.to_numpy(), got.to_numpy()), q
    assert fired[PORT] == fired[REF] == (True, True)
    assert_matches_reference(ref(q), base, q)


# ---------------------------------------------------------------------------
# stage spans, the overlap factor and the EXPLAIN ANALYZE render
# ---------------------------------------------------------------------------


def test_overlap_factor_exceeds_one_for_q5(tpch):
    ctxs, ref = tpch
    for P in BOTH:
        chaos = P("runtime.chaos")
        cluster = chaos.wrap_cluster(_cluster(P), chaos.FaultPlan(
            CHAOS_SEED, [chaos.FaultSpec(site="execute", kind="delay",
                                         delay_s=0.05, rate=1.0)]))
        out, coord = coordinated(P, ctxs[P], TPCH_Q5, cluster, peer_shuffle=False,
                          stage_parallelism=4)
        factor = coord.overlap_factor()
        assert factor is not None and factor > 1.0, (P, factor)
        summary = coord.stage_metrics.stage_schedule_summary()
        assert summary["max_concurrent"] >= 2, (P, summary)
        rendered = coord.stage_metrics.render_stage_schedule()
        assert "overlap factor" in rendered and "stage schedule" in rendered
    assert_matches_reference(ref("q5"), out, "q5 with a uniform delay")


_TIMES = re.compile(r"\d+\.\d+")


def _schedule_shape(text: str) -> list:
    """The stage-schedule block of an EXPLAIN ANALYZE text with its times
    and peak masked (they are this run's): which stages it lists, on which
    plane, and its line shapes."""
    block = text[text.index("-- stage schedule"):].splitlines()
    return [re.sub(r"peak \d+", "peak N", _TIMES.sub("#", ln))
            for ln in block]


def _explain_analyze(P, ctx):
    explain = P("runtime.metrics").explain_analyze
    coord = _coord(P, _cluster(P), stage_parallelism=4)
    df = ctx.sql(TPCH_Q5)
    plan = df.distributed_plan(4, coordinator=coord,
                               config=df._seeded_host_config(4))
    coord.execute(plan)
    text = explain(plan, coord.stage_metrics)
    spans = next(iter(coord.stage_metrics.stage_spans.values()))
    n_exchanges = len(plan.collect(lambda n: getattr(n, "is_exchange",
                                                     False)))
    qid = plan._last_query_id
    df2 = ctx.sql(TPCH_Q3)
    plan2 = df2.distributed_plan(4, coordinator=coord,
                                 config=df2._seeded_host_config(4))
    coord.execute(plan2)
    again = explain(plan, coord.stage_metrics)
    unexecuted = df2.distributed_plan(4, config=df2._seeded_host_config(4))
    return {
        "shape": [re.sub(r"query [0-9a-f]{8}", "query Q", ln)
                  for ln in _schedule_shape(text)],
        "root_span": -1 in spans,
        "spans": len(spans) == n_exchanges + 1,
        "binds_to_first": f"query {qid[:8]}" in again
        and plan2._last_query_id != qid,
        "unexecuted": "-- stage schedule" in explain(unexecuted,
                                                    coord.stage_metrics),
    }


def test_explain_analyze_renders_stage_schedule(tpch):
    ctxs, _ref = tpch
    ref, got = _explain_analyze(REF, ctxs[REF]), _explain_analyze(
        PORT, ctxs[PORT])
    assert got == ref
    assert got["root_span"] and got["spans"] and got["binds_to_first"]
    assert not got["unexecuted"]
    assert any("overlap factor" in ln for ln in got["shape"])


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------


def test_fatal_error_cancels_siblings_and_releases_slices(tpch):
    ctxs, _ref = tpch
    seen = {}
    for P in BOTH:
        chaos = P("runtime.chaos")
        errors = P("runtime.errors")
        cluster = _cluster(P, 3)
        wrapped = chaos.wrap_cluster(cluster, chaos.FaultPlan(CHAOS_SEED, [
            # an unknown kind is a plain WorkerError: non-retryable, fatal
            chaos.FaultSpec(site="execute", kind="fatal_poison", rate=1.0,
                            max_total=1),
            chaos.FaultSpec(site="execute", kind="delay", delay_s=0.2,
                            rate=1.0),
        ]))
        t0 = time.monotonic()
        with pytest.raises(errors.WorkerError) as ei:
            coordinated(P, ctxs[P], TPCH_Q3, wrapped, stage_parallelism=4,
                 max_task_retries=4)
        assert time.monotonic() - t0 < 60.0, P
        assert_no_leaks(cluster)
        seen[P] = (type(ei.value).__name__, errors.is_retryable(ei.value),
                   ei.value.original_type)
    assert seen[PORT] == seen[REF]
    assert seen[PORT][1] is False


def _cancel_before_dispatch(P):
    errors = P("runtime.errors")
    cluster = _cluster(P, 1)
    coord = _coord(P, cluster)
    coord._cancel_event = threading.Event()
    coord._cancel_event.set()
    rng = np.random.default_rng(0)
    t = P.table(pa.table({"x": rng.integers(0, 9, 64)}))
    stage_plan = P("plan.physical").MemoryScanExec([t], t.schema())
    with pytest.raises(errors.TaskCancelledError):
        coord._run_stage_task(stage_plan, "q", 0, 0, 1)
    assert_no_leaks(cluster)
    e = errors.TaskCancelledError("x")
    return (errors.is_retryable(e), isinstance(e, errors.WorkerError),
            [c.__name__ for c in type(e).__mro__])


@pytest.mark.parametrize("case", ["before_dispatch", "not_a_worker_error"])
def test_cancellation_matches_reference(case):
    ref, got = _cancel_before_dispatch(REF), _cancel_before_dispatch(PORT)
    assert got == ref
    if case == "not_a_worker_error":
        # cancellation must not count against worker health
        assert got[:2] == (False, False)


# ---------------------------------------------------------------------------
# scheduling knobs change no plan
# ---------------------------------------------------------------------------


def _executed_config_keys(P) -> set:
    """The keys ``P``'s executed code (plan/, ops/) reads from a task's
    shipped config (``<...>.config.get("key")``), by an AST scan: the
    reference's inventory of its compile key."""
    import ast
    import pathlib

    root = pathlib.Path(P("plan").__file__).parent.parent
    keys = set()
    for sub in ("plan", "ops"):
        for path in (root / sub).rglob("*.py"):
            for node in ast.walk(ast.parse(path.read_text())):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "get"
                        and isinstance(node.func.value, ast.Attribute)
                        and node.func.value.attr == "config"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    keys.add(node.args[0].value)
    return keys


def test_scheduler_knobs_are_the_references():
    """The scheduler and fault knobs are the reference's; none of them is
    in the reference's trace-relevant keys (its compile key), and neither
    package's executed code reads one from a task's config. The port reads
    what the reference reads, but the SPMD group (``mesh``) where the
    reference reads its mesh axis name."""
    from datafusion_distributed_tpu.runtime.worker import (
        TRACE_RELEVANT_CONFIG_KEYS,
    )

    jco, tco = REF("runtime.coordinator"), PORT("runtime.coordinator")
    assert tco.SCHEDULER_DEFAULTS == jco.SCHEDULER_DEFAULTS
    assert tco.FAULT_TOLERANCE_DEFAULTS == jco.FAULT_TOLERANCE_DEFAULTS
    ref_keys, port_keys = _executed_config_keys(REF), _executed_config_keys(
        PORT)
    assert ref_keys <= TRACE_RELEVANT_CONFIG_KEYS
    assert port_keys - {"mesh"} == ref_keys - {"mesh_axis"}
    for knobs in (tco.SCHEDULER_DEFAULTS, tco.FAULT_TOLERANCE_DEFAULTS):
        assert not set(knobs) & TRACE_RELEVANT_CONFIG_KEYS
        assert not set(knobs) & (ref_keys | port_keys)


#: every scheduling and fault knob flipped away from its default
FLIPPED = {"stage_parallelism": 1, "max_task_retries": 7,
           "task_retry_backoff_s": 0.002, "pipelined_shuffle": False}


def test_scheduler_knobs_leave_plans_unchanged(tpch):
    """The counterpart of the reference's "stage_parallelism flip causes
    zero new traces" and of its trace-relevant key inventory: flipping the
    scheduler knobs leaves the staged plan's fingerprint and the
    fingerprint of every task plan shipped unchanged, and builds no
    kernel; the reference's trace count does not move."""
    from datafusion_distributed_tpu.plan import physical as jphys
    from datafusion_distributed_tpu_torch.ops import _build
    from datafusion_distributed_tpu_torch.plan import fingerprint as tfp

    ctxs, _ref = tpch
    ctx = ctxs[PORT]
    df = ctx.sql(TPCH_Q3)
    fps, shipped = [], []
    libs0 = dict(_build._LIBS)
    for opts in ({"stage_parallelism": 4, "peer_shuffle": False},
                 {**FLIPPED, "peer_shuffle": False}):
        coord = _coord(PORT, _cluster(PORT), **opts)
        plan = df.distributed_plan(4, coordinator=coord,
                                   config=df._seeded_host_config(4))
        fps.append(tfp.prepare_plan(plan).fingerprint)
        cl = _cluster(PORT)
        rec = record_shipped_plans(cl)
        coordinated(PORT, ctx, TPCH_Q3, cl, **opts)
        shipped.append(sorted(rec))
    assert fps[0] is not None and fps[0] == fps[1]
    assert shipped[0] and shipped[0] == shipped[1]
    assert dict(_build._LIBS) == libs0
    coordinated(REF, ctxs[REF], TPCH_Q3, _cluster(REF), stage_parallelism=1)
    before = jphys.trace_count()
    coordinated(REF, ctxs[REF], TPCH_Q3, _cluster(REF), stage_parallelism=4)
    assert jphys.trace_count() == before
