"""The port's pipelined shuffle (runtime/streams.py: PartitionFeed,
StreamBudget, StreamScanExec) and partial-aggregate push-down
(planner/distributed.py, planner/statistics.py) against the reference's, on
the CPU: the counterpart of tests/test_pipelined_shuffle.py.

Every case runs both packages on the same input (numpy or arrow, from a
seed) and compares what each observes:

- the feed units: the (producer, seq) merge order, per-partition completion,
  the error and cancel wake, ``on_complete`` firing once, StreamBudget's
  wake on cancel, abandoned pullers counted (stats, telemetry, the event),
  and the exactly-once slice build under concurrent StreamScanExec readers;
- coordinated TPC-H (SF 0.002, seed 7, ``bytes_per_task = 1``, no broadcast
  joins, 4 workers, 4 tasks): pipelined against materialized on the peer
  and peerless planes (q1, q3, q5, q21), under the seeded chaos schedule,
  under membership churn and with hedging, each run byte-identical within
  the port and held against the reference's coordinated result (ints,
  strings and row order exact, floats at test_rtol(), capacities equal),
  with no TableStore slice left; checkpointing coordinators and
  ``stage_parallelism = 1`` never pipeline; pipelined stage spans cover
  production, with the same stages and exchange bytes as the reference;
- the reference's "plane toggle causes zero new traces": the consumer stage
  plans the two planes ship fingerprint alike, and no kernel is built;
- the push-down: ``expected_distinct`` and ``predict_partial_agg_reduction``
  over a grid of (rows, NDV); the rewrite, its eligibility guards and no
  partial-over-partial held plan for plan (modes, predicted-bytes stamps,
  capacities, every planner annotation); measured exchange bytes that fall
  and a predicted stamp within 2x of them, equal to the reference's; the
  telemetry counters; TPC-H q1 with push-down on and off.
"""

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_matches_reference,
    assert_no_leaks,
    assert_results_equal,
    coordinated,
    identical,
    planner_annotations,
    record_shipped_plans,
    tpch_contexts,
)

torch.set_num_threads(1)

CHAOS_SEED = int(os.environ.get("DFTPU_CHAOS_SEED", "20260803"))
FAST = {"task_retry_backoff_s": 0.001}
#: the reference suite's pipelined run (its compiled programs are shared)
PIPED = {"peer_shuffle": False, "stage_parallelism": 4}

from tests.test_pipelined_shuffle import (  # noqa: E402
    TPCH_Q1,
    TPCH_Q3,
    TPCH_Q5,
    TPCH_Q21,
)

QUERIES = {"q1": TPCH_Q1, "q3": TPCH_Q3, "q5": TPCH_Q5, "q21": TPCH_Q21}


@pytest.fixture(scope="module")
def tpch():
    """Both packages' sessions over the same tables, configured as the
    reference suite's ``tpch_ctx``; ``ref(q)`` is the reference's
    coordinated result of ``q`` on the pipelined plane (run once)."""
    ctxs = tpch_contexts(bytes_per_task=1, broadcast_joins=False)
    memo = {}

    def ref(q):
        if q not in memo:
            memo[q] = coordinated(REF, ctxs[REF], QUERIES[q],
                           REF("runtime.coordinator").InMemoryCluster(4),
                           **PIPED)[0]
        return memo[q]

    return ctxs, ref


def _coord(P, cluster, **opts):
    return P("runtime.coordinator").Coordinator(
        resolver=cluster, channels=cluster,
        config_options={**FAST, **opts})


def _cluster(P, n=4, cls="InMemoryCluster"):
    return getattr(P("runtime.coordinator"), cls)(n)


def _planes(coord) -> set:
    return {v.get("plane") for v in coord.stream_metrics.values()}


# ---------------------------------------------------------------------------
# PartitionFeed / StreamBudget / leak accounting, both packages
# ---------------------------------------------------------------------------


class _Chunk:
    """Table stand-in: the feed only forwards references."""

    def __init__(self, tag):
        self.tag = tag
        self.num_rows = 1


def _merge_order(P):
    streams = P("runtime.streams")
    feed = streams.PartitionFeed(num_partitions=2, num_producers=2)
    feed.add(1, 0, _Chunk("b0"))  # producer 1 lands its p0 chunk first
    feed.add(0, 0, _Chunk("a0"))
    feed.add(0, 0, _Chunk("a1"))
    ready = []
    t = threading.Thread(target=lambda: ready.append(feed.wait_partition(0)),
                         daemon=True)
    t.start()
    time.sleep(0.05)
    early = bool(ready)  # neither producer has moved past p0 yet
    feed.add(0, 1, _Chunk("a-p1"))  # producer 0 moves past p0
    feed.producer_done(1)
    t.join(2.0)
    p0 = [c.tag for c in ready[0]] if ready else None
    feed.producer_done(0)
    p1 = [c.tag for c in feed.wait_partition(1)]
    return {"closed_early": early, "p0": p0, "p1": p1,
            "p1_again": feed.wait_partition(1)}


def _error_and_cancel(P):
    streams = P("runtime.streams")
    errors = P("runtime.errors")
    feed = streams.PartitionFeed(1, 1)
    woke = []

    def wait():
        try:
            feed.wait_partition(0)
        except Exception as e:  # noqa: BLE001 - the observation
            woke.append((type(e).__name__, str(e)))

    t = threading.Thread(target=wait, daemon=True)
    t.start()
    feed.fail(RuntimeError("producer exploded"))
    t.join(2.0)
    feed2 = streams.PartitionFeed(1, 1)
    try:
        feed2.wait_partition(0, cancelled=lambda: True)
        cancel = None
    except errors.TaskCancelledError as e:
        cancel = type(e).__name__
    return {"woke": woke, "cancel": cancel}


def _producer_error(P):
    streams = P("runtime.streams")
    errors = P("runtime.errors")
    rng = np.random.default_rng(2)
    chunk = P.table(pa.table({"k": rng.integers(0, 4, 8)}))
    boom = RuntimeError("producer died mid-stream")

    def good(cancel):
        for p in range(2):
            yield (p, chunk), 64

    def bad(cancel):
        yield (0, chunk), 64
        raise boom

    feed = streams.PartitionFeed(num_partitions=2, num_producers=2)
    out = {}
    try:
        streams.stream_partition_chunks([good, bad], 1 << 20, feed)
    except RuntimeError as e:
        out["raised"] = str(e)
    out["stored_is_boom"] = feed.error is boom
    try:
        feed.wait_partition(1)
    except RuntimeError as e:
        out["waiter"] = str(e)
    feed2 = streams.PartitionFeed(1, 1)
    feed2.fail(errors.TransportError("flaky wire"))
    fatal = errors.WorkerError("semantic failure")
    feed2.fail(fatal)
    out["fatal_displaces"] = feed2.error is fatal
    return out


def _on_complete(P):
    streams = P("runtime.streams")
    feed = streams.PartitionFeed(1, 1)
    fired = []
    feed.on_complete(lambda end: fired.append(end))
    before = len(fired)
    feed.producer_done(0)
    feed.finish(streams.StreamStats())
    after = len(fired)
    feed.on_complete(lambda end: fired.append(end))  # late: fires at once
    return {"before": before, "after": after, "late": len(fired),
            "same": fired[0] == fired[-1]}


def _budget_cancel(P):
    streams = P("runtime.streams")
    budget = streams.StreamBudget(10)
    cancel = streams.CancelSignal()
    budget.bind_cancel(cancel)
    res = {"bound": cancel in budget._bound,
           "first": budget.acquire(8, cancel)}

    def blocked():
        res["second"] = budget.acquire(8, cancel)

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    cancel.set()
    t.join(2.0)
    res["woke_fast"] = time.perf_counter() - t0 < 1.0
    fired = []
    cancel.add_hook(lambda: fired.append(1))  # registered after set()
    res["late_hook"] = fired
    return res


def _abandoned_pullers(P):
    streams = P("runtime.streams")
    ctr = P("runtime.telemetry").DEFAULT_REGISTRY.counter(
        "dftpu_stream_pullers_leaked",
        "Stream puller threads abandoned after the join timeout "
        "(a hung producer task the stream stopped waiting for).",
    )
    before = ctr.value()
    log = P("runtime.eventlog").default_event_log()
    seq0 = max((e["seq"] for e in log.events()), default=-1)
    hang = threading.Event()
    threads = [threading.Thread(target=hang.wait, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    stats = streams.StreamStats()
    streams._join_pullers(threads, stats, timeout_s=0.05)
    hang.set()
    events = [e for e in log.events(kind="stream_pullers_leaked")
              if e["seq"] > seq0]
    return {"stats": stats.extra.get("pullers_leaked"),
            "telemetry": ctr.value() - before,
            "events": [e["count"] for e in events]}


def _exactly_once(P):
    streams = P("runtime.streams")
    rng = np.random.default_rng(11)
    t = P.table(pa.table({"k": rng.integers(0, 4, 64)}))
    feed = streams.PartitionFeed(num_partitions=1, num_producers=1)
    feed.add(0, 0, t)
    feed.producer_done(0)
    feed.finish(streams.StreamStats())
    scan = streams.StreamScanExec(feed, t.schema())
    got = []
    threads = [threading.Thread(target=lambda: got.append(scan.task_slice(0)))
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(5.0)
    return {"n": len(got), "unique": all(g is got[0] for g in got),
            "rows": int(got[0].num_rows), "capacity": got[0].capacity,
            "k": got[0].to_numpy()["k"].tolist()}


#: each feed case with what the reference suite asserts of it
FEED_CASES = {
    "merge_order": (_merge_order, {
        "closed_early": False, "p0": ["a0", "a1", "b0"], "p1": ["a-p1"],
        "p1_again": []}),
    "error_and_cancel": (_error_and_cancel, {
        "woke": [("RuntimeError", "producer exploded")],
        "cancel": "TaskCancelledError"}),
    "producer_error": (_producer_error, {
        "raised": "producer died mid-stream", "stored_is_boom": True,
        "waiter": "producer died mid-stream", "fatal_displaces": True}),
    "on_complete_once": (_on_complete, {
        "before": 0, "after": 1, "late": 2, "same": True}),
    "budget_cancel_wake": (_budget_cancel, {
        "bound": True, "first": True, "second": False, "woke_fast": True,
        "late_hook": [1]}),
    "abandoned_pullers": (_abandoned_pullers, {
        "stats": 2, "telemetry": 2, "events": [2]}),
    "exactly_once_slice": (_exactly_once, None),
}


@pytest.mark.parametrize("case", list(FEED_CASES))
def test_feed_units_match_reference(case):
    fn, expected = FEED_CASES[case]
    ref, got = fn(REF), fn(PORT)
    assert got == ref, case
    if expected is not None:
        assert got == expected, case
    else:
        assert got["n"] == 4 and got["unique"] and got["rows"] == 64


# ---------------------------------------------------------------------------
# byte identity across planes and faults, held against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q21"])
def test_pipelined_matches_materialized_and_reference(tpch, q):
    ctxs, ref = tpch
    ctx = ctxs[PORT]
    runs = {}
    for label, opts in (("materialized", {**PIPED,
                                          "pipelined_shuffle": False}),
                        ("pipelined", PIPED),
                        ("peer", {"stage_parallelism": 4})):
        cl = _cluster(PORT)
        runs[label] = coordinated(PORT, ctx, QUERIES[q], cl, **opts)
        assert_no_leaks(cl)
    base = runs["materialized"][0].to_numpy()
    for label in ("pipelined", "peer"):
        assert identical(base, runs[label][0].to_numpy()), (q, label)
    assert_matches_reference(ref(q), runs["pipelined"][0], q)
    if q == "q5":  # the bushy shape engages the pipelined plane
        assert "pipelined" in _planes(runs["pipelined"][1])


def _chaos_crash(P, cluster):
    chaos = P("runtime.chaos")
    return chaos.wrap_cluster(cluster, chaos.one_crash_per_stage(CHAOS_SEED))


def _churn(P, cluster):
    chaos = P("runtime.chaos")
    victim = cluster.get_urls()[-1]
    return chaos.wrap_cluster(cluster, chaos.FaultPlan(CHAOS_SEED, [], membership=[
        chaos.MembershipEvent("leave", victim, site="execute", nth_call=1),
    ]))


def _straggler(P, cluster):
    chaos = P("runtime.chaos")
    return chaos.wrap_cluster(cluster, chaos.FaultPlan(CHAOS_SEED, [
        chaos.FaultSpec(site="execute", kind="straggler", delay_s=0.4,
                        workers=["worker-1"], rate=1.0),
    ], query_scoped=True))


#: the reference suite's fault schedules: (query, cluster, wrap, knobs)
FAULTS = {
    "chaos": ("q5", "InMemoryCluster", _chaos_crash, {}),
    "churn": ("q3", "DynamicCluster", _churn, {}),
    "hedging": ("q3", "InMemoryCluster", _straggler,
                {"hedging": True, "hedge_floor_s": 0.05, "hedge_budget": 4}),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_pipelined_under_faults_matches_reference(tpch, fault):
    ctxs, ref = tpch
    q, cls, wrap, knobs = FAULTS[fault]
    seen = {}
    for P in BOTH:
        cluster = _cluster(P, cls=cls)
        victim = cluster.get_urls()[-1]
        wrapped = wrap(P, cluster)
        out, coord = coordinated(P, ctxs[P], QUERIES[q], wrapped, **PIPED, **knobs)
        assert_no_leaks(cluster)
        faults = coord.faults.as_dict()
        seen[P] = {
            "chaos": lambda: bool(wrapped.plan.fired)
            and faults.get("task_retries", 0) >= 1,
            "churn": lambda: victim not in cluster.get_urls(),
            "hedging": lambda: faults.get("hedges_issued", 0) >= 1,
        }[fault]()
        if P is PORT:
            port_out = out
    assert seen == {REF: True, PORT: True}, (fault, seen)
    materialized = coordinated(PORT, ctxs[PORT], QUERIES[q], _cluster(PORT),
                        **PIPED, pipelined_shuffle=False)[0]
    assert identical(materialized.to_numpy(), port_out.to_numpy()), fault
    assert_matches_reference(ref(q), port_out, f"{q} under {fault}")


def _pipelining_decisions(P):
    coord = _coord(P, _cluster(P), stage_parallelism=4)
    out = [coord._pipelined_shuffle_enabled(None)]
    coord.checkpoints = object()
    out.append(coord._pipelined_shuffle_enabled(None))
    coord.checkpoints = None
    coord.config_options["stage_parallelism"] = 1
    out.append(coord._pipelined_shuffle_enabled(None))
    coord.config_options["stage_parallelism"] = 4
    coord.config_options["pipelined_shuffle"] = "off"
    out.append(coord._pipelined_shuffle_enabled(None))
    return out


def test_checkpointing_coordinator_stays_materialized():
    ref, got = _pipelining_decisions(REF), _pipelining_decisions(PORT)
    assert got == ref == [True, False, False, False]


def test_sequential_parallelism_never_pipelines(tpch):
    ctxs, ref = tpch
    planes = {}
    for P in BOTH:
        out, coord = coordinated(P, ctxs[P], TPCH_Q5, _cluster(P),
                          peer_shuffle=False, stage_parallelism=1)
        planes[P] = _planes(coord)
    assert "pipelined" not in planes[PORT]
    assert planes[PORT] == planes[REF]
    assert_matches_reference(ref("q5"), out, "q5 sequential")


def _pipelined_stages(coord):
    """{stage: (bytes streamed, chunks)} of the pipelined stages, and the
    pipelined stage spans the scheduler recorded."""
    piped = {}
    for (_query, stage), v in coord.stream_metrics.items():
        if v.get("plane") != "pipelined":
            continue
        assert v.get("bytes_streamed", 0) > 0, v
        assert v.get("exchange_bytes", 0) == v.get("bytes_streamed"), v
        assert v.get("chunks", 0) >= 1, v
        assert v.get("pullers_leaked", 0) == 0, v
        piped[stage] = v["exchange_bytes"]
    spans = coord.stage_metrics.stage_spans[coord.last_query_id]
    span_ids = sorted(s for s, sp in spans.items()
                      if sp.get("plane") == "pipelined")
    return piped, span_ids


def test_pipelined_stage_spans_cover_production(tpch):
    ctxs, _ref = tpch
    seen = {}
    for P in BOTH:
        _out, coord = coordinated(P, ctxs[P], TPCH_Q5, _cluster(P), **PIPED)
        seen[P] = _pipelined_stages(coord)
    assert seen[PORT][0] and seen[PORT][1], seen[PORT]
    assert seen[PORT] == seen[REF]


def test_plane_toggle_ships_identical_stage_plans(tpch):
    """The port's counterpart of the reference's "plane toggle causes zero
    new traces": the two planes ship consumer stage plans that fingerprint
    alike (so a compiled-program cache keyed by them would hit), and
    toggling builds no kernel; the reference's trace count does not move."""
    from datafusion_distributed_tpu.plan import physical as jphys
    from datafusion_distributed_tpu_torch.ops import _build

    ctxs, _ref = tpch
    shipped = {}
    libs0 = dict(_build._LIBS)
    for plane, opts in (("pipelined", PIPED),
                        ("materialized", {**PIPED,
                                          "pipelined_shuffle": False})):
        cl = _cluster(PORT)
        rec = record_shipped_plans(cl)
        coordinated(PORT, ctxs[PORT], TPCH_Q3, cl, **opts)
        shipped[plane] = sorted(rec)
    assert shipped["pipelined"] and all(fp for *_k, fp in
                                        shipped["pipelined"])
    assert shipped["pipelined"] == shipped["materialized"]
    assert dict(_build._LIBS) == libs0
    coordinated(REF, ctxs[REF], TPCH_Q3, _cluster(REF), **PIPED)
    before = jphys.trace_count()
    coordinated(REF, ctxs[REF], TPCH_Q3, _cluster(REF), **PIPED,
         pipelined_shuffle=False)
    assert jphys.trace_count() == before


# ---------------------------------------------------------------------------
# partial-aggregate push-down
# ---------------------------------------------------------------------------


def _agg_over_shuffle_plan(P, n=1 << 13, ndv=8, aggs=None, keys=None,
                           est_rows=None, pushdown=True, threshold=0.2):
    """The reference suite's hand-placed boundary: scan -> shuffle(k) ->
    single aggregate, in package ``P``."""
    agg_mod = P("ops.aggregate")
    phys = P("plan.physical")
    dist = P("planner.distributed")
    rng = np.random.default_rng(3)
    t = P.table(pa.table({
        "k": rng.integers(0, ndv, n),
        "v": rng.normal(size=n),
        "w": rng.normal(size=n),
    }))
    scan = phys.MemoryScanExec(P("parallel.exchange").partition_table(t, 4),
                               t.schema())
    ex = P("plan.exchanges").ShuffleExchangeExec(
        scan, keys or ["k"], 4,
        P("ops.table").round_up_pow2(max(4 * n // 4, 8)))
    Agg = agg_mod.AggSpec
    agg = phys.HashAggregateExec(
        "single", ["k"],
        [Agg(*a) for a in aggs] if aggs else
        [Agg("sum", "v", "sv"), Agg("avg", "w", "aw"),
         Agg("count_star", None, "c")],
        ex,
    )
    agg.est_rows = est_rows if est_rows is not None else ndv
    return dist.distribute_plan(agg, dist.DistributedConfig(
        num_tasks=4, partial_agg_pushdown=pushdown,
        partial_agg_pushdown_min_reduction=threshold,
    ))


def _plan_facts(P, plan):
    """Modes of the aggregates, then each node's class, capacity and
    planner annotations (predicted-bytes stamps among them)."""
    phys = P("plan.physical")
    modes = [n.mode for n in plan.collect(
        lambda n: isinstance(n, phys.HashAggregateExec))]
    caps = [(type(n).__name__, int(n.output_capacity()))
            for n in plan.collect(lambda n: True)]
    return modes, caps, planner_annotations(plan)


def test_expected_distinct_and_reduction_match_reference():
    jst = REF("planner.statistics")
    tst = PORT("planner.statistics")
    rows = (0, 1, 10, 1000, 10_000, 80_000, 1 << 20)
    ndvs = (1, 8, 100, 1000, 1 << 13, 1_000_000)
    for n in rows:
        for ndv in ndvs:
            assert tst.expected_distinct(n, ndv) == jst.expected_distinct(
                n, ndv), (n, ndv)
            for tasks in (1, 4, 8):
                a = jst.predict_partial_agg_reduction(n, ndv, tasks)
                b = tst.predict_partial_agg_reduction(n, ndv, tasks)
                assert vars(b) == vars(a), (n, ndv, tasks)
    # the reference suite's values
    assert tst.expected_distinct(0, 100) == 0.0
    assert tst.expected_distinct(1000, 1) == pytest.approx(1.0)
    assert tst.expected_distinct(10_000, 8) == pytest.approx(8.0, rel=1e-6)
    assert tst.expected_distinct(10, 1_000_000) == pytest.approx(10.0,
                                                                 rel=1e-2)
    assert tst.predict_partial_agg_reduction(80_000, 8, 4).reduction > 0.99
    assert tst.predict_partial_agg_reduction(1000, 1000, 4).reduction < 0.3


#: the rewrite and its guards: plan arguments, and the aggregate modes
PUSHDOWN_PLANS = {
    "rewrite": ({}, ["final", "partial"]),
    "off": ({"pushdown": False}, ["single"]),
    "non_decomposable": ({"aggs": [("stddev", "v", "sd")]}, ["single"]),
    "keys_not_group_keys": ({"keys": ["v"]}, ["single"]),
    "high_ndv": ({"ndv": 1 << 13, "est_rows": 1 << 13}, ["single"]),
}


@pytest.mark.parametrize("case", list(PUSHDOWN_PLANS))
def test_pushdown_plans_match_reference(case):
    kw, modes = PUSHDOWN_PLANS[case]
    ref = _plan_facts(REF, _agg_over_shuffle_plan(REF, **kw))
    got = _plan_facts(PORT, _agg_over_shuffle_plan(PORT, **kw))
    assert got == ref, case
    assert got[0] == modes, got[0]
    stamped = [a for a in got[2] if a[0] == "ShuffleExchangeExec"
               and a[-1] is not None]
    assert bool(stamped) == (case == "rewrite"), stamped
    assert (sorted(PORT("ops.aggregate").PUSHDOWN_DECOMPOSABLE_FUNCS)
            == sorted(REF("ops.aggregate").PUSHDOWN_DECOMPOSABLE_FUNCS))
    assert "stddev" not in PORT("ops.aggregate").PUSHDOWN_DECOMPOSABLE_FUNCS


def _eager_split_plan(P):
    phys = P("plan.physical")
    dist = P("planner.distributed")
    rng = np.random.default_rng(5)
    t = P.table(pa.table({
        "k": rng.integers(0, 8, 4096), "v": rng.normal(size=4096),
    }))
    scan = phys.MemoryScanExec([t], t.schema())
    agg = phys.HashAggregateExec(
        "single", ["k"], [P("ops.aggregate").AggSpec("sum", "v", "sv")],
        scan, 64)
    agg.est_rows = 8
    return dist.distribute_plan(agg, dist.DistributedConfig(
        num_tasks=4, partial_agg_pushdown=True))


def test_pushdown_no_double_push_on_eager_split():
    ref = _plan_facts(REF, _eager_split_plan(REF))
    got = _plan_facts(PORT, _eager_split_plan(PORT))
    assert got == ref
    assert got[0].count("partial") == 1, got[0]
    assert any(a[0] == "ShuffleExchangeExec" and a[-1] is not None
               for a in got[2]), "eager-split shuffle missed the stamp"


def _pushdown_run(P, pushdown):
    cl = _cluster(P)
    coord = _coord(P, cl, **PIPED)
    out = coord.execute(_agg_over_shuffle_plan(P, pushdown=pushdown))
    assert_no_leaks(cl)
    stats = sorted(
        (v["exchange_bytes"], v.get("predicted_exchange_bytes"))
        for v in coord.stream_metrics.values() if "exchange_bytes" in v)
    res = out.to_numpy()
    order = np.argsort(res["k"], kind="stable")
    return {k: v[order] for k, v in res.items()}, stats


def test_pushdown_reduces_measured_exchange_bytes():
    runs = {(P, on): _pushdown_run(P, on) for P in BOTH for on in (False,
                                                                   True)}
    for on in (False, True):
        assert runs[(PORT, on)][1] == runs[(REF, on)][1], on
        assert_results_equal(runs[(REF, on)][0], runs[(PORT, on)][0],
                             f"push-down {on}")
    off, s_off = runs[(PORT, False)]
    on, s_on = runs[(PORT, True)]
    np.testing.assert_array_equal(off["k"], on["k"])
    np.testing.assert_array_equal(off["c"], on["c"])
    assert np.allclose(off["sv"], on["sv"], rtol=1e-4, atol=1e-6)
    assert np.allclose(off["aw"], on["aw"], rtol=1e-4, atol=1e-6)
    bytes_off = sum(m for m, _p in s_off)
    bytes_on = sum(m for m, _p in s_on)
    assert bytes_on * 5 < bytes_off, (bytes_on, bytes_off)
    pred = [(m, p) for m, p in s_on if p is not None]
    assert pred, "predicted bytes never recorded"
    for m, p in pred:
        assert m / 2 <= p <= m * 2, (p, m)


def test_pushdown_telemetry_counters():
    deltas = {}
    for P in BOTH:
        reg = P("runtime.telemetry").DEFAULT_REGISTRY
        meas = reg.counter(
            "dftpu_exchange_bytes",
            "Measured bytes crossing shuffle exchange boundaries.",
            labels=("plane",))
        pred = reg.counter(
            "dftpu_exchange_predicted_bytes",
            "Planner-predicted exchange bytes for shuffles "
            "rewritten by the partial-aggregate push-down.",
            labels=("plane",))
        m0, p0 = meas.value(plane="pipelined"), pred.value(plane="pipelined")
        cl = _cluster(P)
        _coord(P, cl, **PIPED).execute(_agg_over_shuffle_plan(P))
        deltas[P] = (meas.value(plane="pipelined") - m0,
                     pred.value(plane="pipelined") - p0)
    assert deltas[PORT] == deltas[REF]
    assert deltas[PORT][0] > 0 and deltas[PORT][1] > 0


def test_pushdown_sql_tpch_results_hold(tpch):
    """q1 (an aggregate over the lineitem scan) with the push-down off and
    on: equal at the float-merge tolerance, integer outputs exactly; the
    run with it on (the default) held against the reference's."""
    ctxs, ref = tpch
    ctx = ctxs[PORT]
    got = {}
    for on in ("off", "on"):
        ctx.config.set_option("distributed.partial_agg_pushdown", on)
        try:
            got[on] = coordinated(PORT, ctx, TPCH_Q1, _cluster(PORT), **PIPED)[0]
        finally:
            ctx.config.distributed_options.pop("partial_agg_pushdown", None)
    b, g = got["off"].to_numpy(), got["on"].to_numpy()
    assert list(g) == list(b)
    for col in b:
        if g[col].dtype.kind in "fc":
            assert np.allclose(g[col], b[col], rtol=1e-4, atol=1e-6), col
        else:
            np.testing.assert_array_equal(g[col], b[col], err_msg=col)
    assert_matches_reference(ref("q1"), got["on"], "q1 with push-down on")
