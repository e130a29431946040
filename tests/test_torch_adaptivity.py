"""The port's runtime adaptivity (runtime/adaptivity.py and its three
decision points in runtime/coordinator.py: the skew split, the
partial-aggregate bail-out and the mid-query replan) against the
reference's, on the CPU: the counterpart of tests/test_adaptivity.py.

Every case runs both packages on the same seeded input and compares what
each observes:

- ``AdaptivitySettings.from_options`` on the same options, and the SET-time
  validation of the four knobs; ``detect_skew`` and ``split_ranges`` on the
  same histograms;
- the forced skew split of the reference suite's hand-built plan and of
  TPC-H lineitem (SF 0.002) partitioned by its status columns
  (``l_returnflag``, ``l_linestatus``: the 'NO' partition holds about half
  the rows): ``skew_splits``, ``skew_partition_rows``, the
  ``dftpu_skew_splits`` delta, the result with its capacity, equal to the
  run with the adaptations off; the chaos ``kind="skew"`` schedule;
- the bail-out on all-distinct keys: ``partial_agg_ratio``, which tasks
  ran the passthrough, the ``dftpu_partial_agg_bailouts`` delta; on the
  shape-1 plan the widened capacities; none on low NDV;
- the replan: ``replanned_stages`` of each stage, the rescaled ``est_rows``
  of each downstream stage, the ``dftpu_replans`` delta;
- TPC-H (SF 0.002, seed 7, ``bytes_per_task = 1``, no broadcast joins,
  4 stages at once; a replan needs downstream stages not yet submitted, so
  none fires with one stage at a time, and with four the replans come in
  the order their stages finish, in both packages alike: the stages that
  replanned and each downstream stage's final estimate are compared):
  q18 on the bulk plane with ``partial_agg_bailout_ratio = 0.2`` bails out
  on its ``group by l_orderkey`` and replans, and q9 on the default plane
  replans, in both packages alike; q3 under membership churn, and q3, q5
  and q18 under one crash a stage, with every adaptation armed.
"""

import os
import threading

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
    coordinated,
    identical,
    record_shipped_plans,
    tpch_contexts,
)

torch.set_num_threads(1)

CHAOS_SEED = int(os.environ.get("DFTPU_CHAOS_SEED", "20260803"))
FAST = {"task_retry_backoff_s": 0.001}
BULK = {"pipelined_shuffle": False, "data_plane": "unary"}

from tests.test_adaptivity import ADAPT_OFF, ADAPT_ON, TPCH  # noqa: E402

COUNTERS = ("dftpu_skew_splits", "dftpu_partial_agg_bailouts",
            "dftpu_replans")


def _counters(P) -> dict:
    snap = P("runtime.telemetry").DEFAULT_REGISTRY.snapshot()
    return {n: sum(v for _, v in snap.get(n, {}).get("samples", []))
            for n in COUNTERS}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


_COUNTER_LOCK = threading.Lock()


def _observed(P, fn):
    """fn() with the adaptivity counters' deltas around it. The registry is
    process-wide, so the runs that read it take one lock."""
    with _COUNTER_LOCK:
        before = _counters(P)
        out = fn()
        return out, _delta(before, _counters(P))


def _adaptations(coord) -> dict:
    """Each stage's adaptation record from ``stream_metrics``."""
    keys = ("skew_splits", "skew_partition_rows", "partial_agg_bailout",
            "partial_agg_ratio", "bailout_capacity_widened",
            "replanned_stages")
    out = {}
    for (_q, sid), sm in coord.stream_metrics.items():
        got = {k: sm[k] for k in keys if k in sm}
        if got:
            out[sid] = got
    return out


def _record_replans(coord) -> list:
    """A list that gathers (stage, {downstream stage: (est_rows before,
    after)}) of every replan that ``coord`` makes, in the order made."""
    seen = []
    real = coord._maybe_replan

    def judged(query_id, stage_id, nodes, scan, submitted):
        aff = coord._downstream_unsubmitted(stage_id, nodes, set(submitted))
        before = {s: int(nodes[s].est_rows or 0) for s in aff}
        fired = real(query_id, stage_id, nodes, scan, submitted)
        if fired:
            seen.append((stage_id, {s: (before[s], int(nodes[s].est_rows))
                                    for s in aff}))
        return fired

    coord._maybe_replan = judged
    return seen


def _replan_summary(seen) -> tuple:
    """(the stages that replanned, {downstream stage: its est_rows after
    the last replan}). With stages run at once the replans come in the
    order their stages finish, and each truncates its rescaled estimate to
    an int, so a final estimate may differ by a row with the order."""
    final = {}
    for _s, rescaled in seen:
        for d, (_before, after) in rescaled.items():
            final[d] = after
    return sorted(s for s, _r in seen), final


def _assert_estimates_close(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b), (a, b)
    for d in a:
        assert abs(a[d] - b[d]) <= max(1, 1e-3 * b[d]), (d, a, b)


def _record_passthrough(cluster) -> list:
    """A list that gathers (stage, task, ran the passthrough) of every task
    plan shipped to ``cluster``'s workers."""
    return record_shipped_plans(
        cluster, lambda plan_obj: "partial_passthrough" in repr(plan_obj))


def _coord(P, cluster, **opts):
    return P("runtime.coordinator").Coordinator(
        resolver=cluster, channels=cluster, config_options={**FAST, **opts})


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

SETTINGS_OPTIONS = [
    {},
    {"skew_split_factor": "0", "partial_agg_bailout_ratio": 0,
     "replan_cardinality_factor": 0.0},
    {"skew_split_factor": "wat", "skew_split_min_rows": -4},
    ADAPT_ON,
    {"skew_split_factor": 2.5, "skew_split_min_rows": "64",
     "partial_agg_bailout_ratio": "0.5", "replan_cardinality_factor": None},
]


@pytest.mark.parametrize("i", range(len(SETTINGS_OPTIONS)))
def test_settings_from_options(i):
    import dataclasses

    got = {}
    for P in BOTH:
        s = P("runtime.adaptivity").AdaptivitySettings.from_options(
            SETTINGS_OPTIONS[i])
        got[P] = (dataclasses.asdict(s), s.skew_enabled, s.bailout_enabled,
                  s.replan_enabled)
    assert got[PORT] == got[REF]


SET_VALUES = [
    ("skew_split_factor", "2.5"), ("skew_split_factor", "0"),
    ("skew_split_min_rows", "64"), ("partial_agg_bailout_ratio", "0.9"),
    ("replan_cardinality_factor", "8"), ("skew_split_factor", "0.5"),
    ("skew_split_factor", "-1"), ("skew_split_min_rows", "-8"),
    ("skew_split_min_rows", "x"), ("partial_agg_bailout_ratio", "1.5"),
    ("partial_agg_bailout_ratio", "-0.1"),
    ("replan_cardinality_factor", "0.2"),
    ("replan_cardinality_factor", "nope"),
]


@pytest.mark.parametrize("key,value", SET_VALUES)
def test_set_time_validation(key, value):
    got = {}
    for P in BOTH:
        cfg = P("sql.context").SessionConfig()
        try:
            cfg.set_option(f"distributed.{key}", value)
            got[P] = ("ok", cfg.distributed_options[key])
        except ValueError:
            got[P] = ("ValueError", None)
    assert got[PORT] == got[REF]


def _histograms():
    rng = np.random.default_rng(5)
    fixed = [[100, 100, 1000, 90], [100, 100, 150], [4, 4, 64], [], [500],
             [100, 900], [0, 0, 0, 5000], [7, 7, 7, 4], [2983] * 3 + [2980]]
    rand = [list(rng.integers(0, int(rng.choice([10, 1000, 100_000])),
                              int(rng.integers(2, 9))))
            for _ in range(60)]
    return fixed + rand


def test_detect_skew_and_split_ranges():
    import dataclasses

    params = [(f, m) for f in (0.0, 1.5, 4.0) for m in (1, 50, 1024)]
    for counts in _histograms():
        for factor, min_rows in params:
            got = []
            for P in BOTH:
                r = P("runtime.adaptivity").detect_skew(counts, factor,
                                                        min_rows)
                got.append(None if r is None else dataclasses.asdict(r))
            assert got[0] == got[1], (counts, factor, min_rows)
    for rows in (1, 3, 7, 8, 9, 10, 1000, 4000, 12345):
        for parts in (1, 2, 3, 7, 8, 16):
            got = [P("runtime.adaptivity").split_ranges(rows, parts)
                   for P in BOTH]
            assert got[0] == got[1], (rows, parts)


# ---------------------------------------------------------------------------
# skew split
# ---------------------------------------------------------------------------


def _skewed_plan(P, slices):
    """A hash shuffle on ``k`` over a scan of ``slices`` (arrow tables, one a
    task) into a coalesce, stage ids as prepare assigns them."""
    ex_mod = P("plan.exchanges")
    tasks = [P.table(s) for s in slices]
    scan = P("plan.physical").MemoryScanExec(tasks, tasks[0].schema())
    cap = 1 << int(np.ceil(np.log2(max(s.num_rows for s in slices) * 2)))
    ex = ex_mod.ShuffleExchangeExec(scan, ["k"], len(slices),
                                    per_dest_capacity=cap)
    ex.producer_tasks = len(slices)
    ex.stage_id = 1
    root = ex_mod.CoalesceExchangeExec(ex, len(slices))
    root.stage_id = 2
    return root


def _suite_slices():
    """tests/test_adaptivity.py's hot-slice input."""
    def mk(n, seed):
        rng = np.random.default_rng(seed)
        return pa.table({
            "k": pa.array(rng.integers(0, 64, n).astype(np.int64)),
            "v": pa.array(rng.random(n)),
        })

    return [mk(4000, 0), mk(250, 1), mk(250, 2), mk(250, 3)]


def _lineitem_by_status():
    """TPC-H lineitem (SF 0.002, seed 7) partitioned by (l_returnflag,
    l_linestatus), as a table partitioned on disk by its status columns:
    the 'NO' partition holds about half the rows."""
    from datafusion_distributed_tpu.data.tpchgen import gen_tpch

    li = gen_tpch(sf=0.002, seed=7)["lineitem"]
    flag = np.asarray(li.column("l_returnflag").to_pylist(), dtype=object)
    status = np.asarray(li.column("l_linestatus").to_pylist(), dtype=object)
    cols = {"k": li.column("l_orderkey"),
            "v": li.column("l_extendedprice"),
            "q": li.column("l_quantity")}
    t = pa.table(cols)
    out = []
    for f, s in (("A", "F"), ("N", "F"), ("N", "O"), ("R", "F")):
        idx = np.nonzero((flag == f) & (status == s))[0]
        out.append(t.take(pa.array(idx)))
    return out


SKEW_INPUTS = {"suite": (_suite_slices, 4000),
               "lineitem_by_status": (_lineitem_by_status, None)}


def _skew_run(P, slices, **opts):
    cluster = P("runtime.coordinator").InMemoryCluster(2)
    coord = _coord(P, cluster, stage_parallelism=1, **BULK, **opts)
    out, delta = _observed(P, lambda: coord.execute(_skewed_plan(P, slices)))
    assert_no_leaks(cluster)
    return out, coord, delta


@pytest.mark.parametrize("name", sorted(SKEW_INPUTS))
def test_forced_skew_split(name):
    make, hot_rows = SKEW_INPUTS[name]
    slices = make()
    if hot_rows is None:
        hot_rows = max(s.num_rows for s in slices)
    got = {}
    for P in BOTH:
        base, c0, d0 = _skew_run(P, slices, **ADAPT_OFF)
        out, c1, d1 = _skew_run(P, slices, skew_split_factor=1.5,
                                skew_split_min_rows=64)
        assert identical(base.to_numpy(), out.to_numpy()), P
        assert base.capacity == out.capacity, P
        assert not _adaptations(c0) and d0["dftpu_skew_splits"] == 0, P
        got[P] = (out, _adaptations(c1), d1)
    assert got[PORT][1] == got[REF][1]
    assert got[PORT][2] == got[REF][2]
    assert_matches_reference(got[REF][0], got[PORT][0], name)
    splits = [a for a in got[PORT][1].values() if a.get("skew_splits")]
    assert splits and splits[0]["skew_partition_rows"] == hot_rows, got
    assert got[PORT][2]["dftpu_skew_splits"] >= 1


def test_skew_split_default_inert_on_small_data():
    def mk(n, seed):
        rng = np.random.default_rng(seed)
        return pa.table({"k": pa.array(rng.integers(0, 8, n)
                                       .astype(np.int64))})

    slices = [mk(800, 0), mk(20, 1), mk(20, 2), mk(20, 3)]
    got = {}
    for P in BOTH:
        out, coord, delta = _skew_run(P, slices)
        got[P] = (out, _adaptations(coord), delta)
        assert not got[P][1] and delta["dftpu_skew_splits"] == 0, P
    assert_matches_reference(got[REF][0], got[PORT][0], "inert")


def test_chaos_skew_kind_replays_alike():
    n = 2000
    rng = np.random.default_rng(0)
    arrow = pa.table({"k": pa.array(rng.integers(0, 64, n).astype(np.int64)),
                      "v": pa.array(rng.random(n))})
    sql = ("SELECT k, COUNT(*) AS c FROM t GROUP BY k ORDER BY c DESC, k "
           "LIMIT 3")
    got = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.config.distributed_options["bytes_per_task"] = 1
        ctx.register_arrow("t", arrow)
        chaos = P("runtime.chaos")
        arms = []
        for opts in (ADAPT_OFF, {"skew_split_factor": 1.5,
                                 "skew_split_min_rows": 64}):
            plan = chaos.FaultPlan(CHAOS_SEED, [chaos.FaultSpec(
                site="execute", kind="skew", skew_fraction=0.8,
                stages=[0])], query_scoped=True)
            inner = P("runtime.coordinator").InMemoryCluster(2)
            out, coord = coordinated(
                P, ctx, sql, chaos.wrap_cluster(inner, plan), **BULK,
                partial_agg_pushdown=False, **opts)
            assert_no_leaks(inner)
            arms.append((out, sorted(
                (f["site"], f["stage_id"], f["task_number"], f["kind"])
                for f in plan.fired), _adaptations(coord)))
        assert identical(arms[0][0].to_numpy(), arms[1][0].to_numpy()), P
        assert arms[0][1] == arms[1][1] and arms[0][1], P
        assert int(arms[0][0].to_numpy()["c"][0]) > n // 2, P
        got[P] = arms
    for i in range(2):
        assert_matches_reference(got[REF][i][0], got[PORT][i][0], f"arm {i}")
        assert got[PORT][i][1:] == got[REF][i][1:]


# ---------------------------------------------------------------------------
# partial-aggregate bail-out
# ---------------------------------------------------------------------------


def _ndv_ctx(P, n, ndv=None):
    ctx = P.ctx()
    ctx.config.distributed_options["bytes_per_task"] = 1
    rng = np.random.default_rng(1)
    keys = (np.arange(n) if ndv is None
            else rng.integers(0, ndv, n)).astype(np.int64)
    ctx.register_arrow("u", pa.table({"k": pa.array(keys),
                                      "v": pa.array(rng.random(n))}))
    return ctx


def _bail_run(P, ctx, sql, **opts):
    cluster = P("runtime.coordinator").InMemoryCluster(2)
    shipped = _record_passthrough(cluster)
    (out, coord), delta = _observed(
        P, lambda: coordinated(P, ctx, sql, cluster, **BULK, **opts))
    assert_no_leaks(cluster)
    passthrough = sorted((s, t) for s, t, p in shipped if p)
    return out, _adaptations(coord), delta, passthrough


def test_bailout_on_high_ndv():
    sql = "SELECT k, SUM(v) AS s FROM u GROUP BY k ORDER BY k"
    got = {}
    for P in BOTH:
        ctx = _ndv_ctx(P, 8192)
        off = _bail_run(P, ctx, sql, partial_agg_pushdown=False,
                        partial_agg_bailout_ratio=0.0)
        on = _bail_run(P, ctx, sql, partial_agg_pushdown=True,
                       partial_agg_bailout_ratio=0.5)
        assert not off[1] and not off[3], P
        np.testing.assert_array_equal(on[0].to_numpy()["k"],
                                      off[0].to_numpy()["k"])
        got[P] = on
    out, adapt, delta, passthrough = got[PORT]
    assert_matches_reference(got[REF][0], out, "bail-out")
    assert (adapt, delta, passthrough) == got[REF][1:]
    bail = [a for a in adapt.values() if a.get("partial_agg_bailout")]
    assert bail and bail[0]["partial_agg_ratio"] >= 0.5, adapt
    assert delta["dftpu_partial_agg_bailouts"] >= 1
    # task 0 is the probe; the stage's other tasks ran the passthrough
    assert passthrough and all(t > 0 for _s, t in passthrough), passthrough


def _shape1_plan(P, n):
    phys = P("plan.physical")
    dist = P("planner.distributed")
    rng = np.random.default_rng(3)
    t = P.table(pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                          "v": pa.array(rng.random(n))}))
    pow2 = P("ops.table").round_up_pow2

    def mk(pushdown):
        scan = phys.MemoryScanExec(
            P("parallel.exchange").partition_table(t, 4), t.schema())
        ex = P("plan.exchanges").ShuffleExchangeExec(scan, ["k"], 4, pow2(n))
        agg = phys.HashAggregateExec(
            "single", ["k"], [P("ops.aggregate").AggSpec("sum", "v", "s")],
            ex, num_slots=pow2(4 * n))
        return dist.distribute_plan(agg, dist.DistributedConfig(
            num_tasks=4, partial_agg_pushdown=pushdown))

    return mk


def _capacities(plan) -> list:
    return [(type(n).__name__, getattr(n, "num_slots", None),
             getattr(n, "per_dest_capacity", None))
            for n in plan.collect(lambda _n: True)]


def test_bailout_widens_stale_planner_capacities():
    n = 1 << 14
    got = {}
    for P in BOTH:
        mk = _shape1_plan(P, n)
        arms = []
        for pushdown, ratio in ((False, 0.0), (True, 0.5)):
            cluster = P("runtime.coordinator").InMemoryCluster(2)
            coord = _coord(P, cluster, stage_parallelism=1, **BULK,
                           partial_agg_bailout_ratio=ratio)
            plan = mk(pushdown)
            out = coord.execute(plan)
            assert_no_leaks(cluster)
            arms.append((out, _adaptations(coord), _capacities(plan)))
        got[P] = arms
        assert int(arms[0][0].num_rows) == int(arms[1][0].num_rows) == n, P
    for i in range(2):
        assert_matches_reference(got[REF][i][0], got[PORT][i][0], f"arm {i}")
        assert got[PORT][i][1:] == got[REF][i][1:], i
    bail = [a for a in got[PORT][1][1].values()
            if a.get("partial_agg_bailout")]
    assert bail and bail[0]["bailout_capacity_widened"] >= n // 4, bail


def test_no_bailout_on_low_ndv():
    sql = "SELECT k, SUM(v) AS s FROM u GROUP BY k ORDER BY k"
    got = {P: _bail_run(P, _ndv_ctx(P, 2000, ndv=8), sql,
                        partial_agg_bailout_ratio=0.8) for P in BOTH}
    assert_matches_reference(got[REF][0], got[PORT][0], "low NDV")
    for P in BOTH:
        assert not got[P][1] and not got[P][3], P
        assert got[P][2]["dftpu_partial_agg_bailouts"] == 0, P
    assert int(got[PORT][0].num_rows) == 8


# ---------------------------------------------------------------------------
# mid-query replan
# ---------------------------------------------------------------------------


def _replan_run(P, ctx, sql, cluster_size=2, wrap=None, **opts):
    rt = P("runtime.coordinator")
    cluster = rt.InMemoryCluster(cluster_size)
    coord = _coord(P, wrap(cluster) if wrap else cluster, **opts)
    judged = _record_replans(coord)
    df = ctx.sql(sql)
    out, delta = _observed(P, lambda: df._strip_quals(
        df.collect_coordinated_table(coordinator=coord, num_tasks=4)))
    assert_no_leaks(cluster)
    return out, _adaptations(coord), delta, judged


def test_replan_fires_and_stays_byte_identical():
    n = 4000
    rng = np.random.default_rng(0)
    a = pa.table({"k": pa.array((np.arange(n) % 37).astype(np.int64)),
                  "v": pa.array(rng.random(n))})
    b = pa.table({"k": pa.array(np.arange(37).astype(np.int64)),
                  "w": pa.array(rng.random(37))})
    sql = ("SELECT a.k, SUM(a.v * b.w) AS s FROM a JOIN b ON a.k = b.k "
           "WHERE a.v < 0.01 GROUP BY a.k ORDER BY a.k")
    got = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.config.distributed_options.update(bytes_per_task=1,
                                              broadcast_joins=False)
        ctx.register_arrow("a", a)
        ctx.register_arrow("b", b)
        base = _replan_run(P, ctx, sql, **BULK, **ADAPT_OFF)
        on = _replan_run(P, ctx, sql, **BULK, replan_cardinality_factor=1.5)
        assert identical(base[0].to_numpy(), on[0].to_numpy()), P
        assert not base[3] and base[2]["dftpu_replans"] == 0, P
        got[P] = on
    assert_matches_reference(got[REF][0], got[PORT][0], "replan")
    assert got[PORT][1:3] == got[REF][1:3]
    fired, final = (_replan_summary(got[P][3]) for P in (PORT, REF))
    assert fired[0] == final[0] and fired[0], (fired, final)
    _assert_estimates_close(fired[1], final[1])
    assert got[PORT][2]["dftpu_replans"] >= 1
    # every replan rescaled its downstream stages' estimates
    for _s, rescaled in got[PORT][3]:
        assert rescaled and any(b != a for b, a in rescaled.values())


# ---------------------------------------------------------------------------
# TPC-H: the inputs at which each adaptation fires
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    return tpch_contexts(bytes_per_task=1, broadcast_joins=False)


#: name -> (query, coordinator options, the adaptation records it must show)
TPCH_FIRING = {
    "q18_bulk": ("q18", {**BULK, **ADAPT_ON, "stage_parallelism": 4,
                         "partial_agg_bailout_ratio": 0.2},
                 ("partial_agg_bailout", "replanned_stages")),
    "q9_default": ("q9", {**ADAPT_ON, "stage_parallelism": 4,
                          "pipelined_shuffle": False},
                   ("replanned_stages",)),
}


def _tpch_sql(q):
    from tests.test_torch_coordinator import _sql

    return _sql(q)


@pytest.mark.parametrize("name", sorted(TPCH_FIRING))
def test_tpch_adaptations_fire_alike(tpch, name):
    q, opts, kinds = TPCH_FIRING[name]
    sql = _tpch_sql(q)
    got = {}
    for P in BOTH:
        cluster = P("runtime.coordinator").InMemoryCluster(4)
        shipped = _record_passthrough(cluster)
        coord = _coord(P, cluster, **opts)
        judged = _record_replans(coord)
        df = tpch[P].sql(sql)
        out, delta = _observed(P, lambda: df._strip_quals(
            df.collect_coordinated_table(coordinator=coord, num_tasks=4)))
        assert_no_leaks(cluster)
        got[P] = (out, _adaptations(coord), delta,
                  sorted((s, t) for s, t, p in shipped if p),
                  _replan_summary(judged))
    assert_matches_reference(got[REF][0], got[PORT][0], name)
    assert got[PORT][1:4] == got[REF][1:4]
    assert got[PORT][4][0] == got[REF][4][0]
    _assert_estimates_close(got[PORT][4][1], got[REF][4][1])
    fired = {k for a in got[PORT][1].values() for k in a}
    assert set(kinds) <= fired, (name, got[PORT][1])
    if "partial_agg_bailout" in kinds:
        assert got[PORT][2]["dftpu_partial_agg_bailouts"] >= 1
        assert got[PORT][3]
    assert got[PORT][2]["dftpu_replans"] >= 1 and got[PORT][4][0]
    # the adaptations change no byte of the port's result
    off = coordinated(PORT, tpch[PORT], sql,
                      PORT("runtime.coordinator").InMemoryCluster(4),
                      **{**opts, **ADAPT_OFF})[0]
    assert identical(off.to_numpy(), got[PORT][0].to_numpy()), name


def test_tpch_q3_churn_with_every_adaptation(tpch):
    got = {}
    for P in BOTH:
        rt, chaos = P("runtime.coordinator"), P("runtime.chaos")
        cluster = rt.DynamicCluster(4)
        victim = cluster.get_urls()[-1]
        plan = chaos.FaultPlan(CHAOS_SEED, [], membership=[
            chaos.MembershipEvent("leave", victim, site="execute",
                                  nth_call=1)])
        out, _coord_ = coordinated(
            P, tpch[P], TPCH["q3"], chaos.wrap_cluster(cluster, plan),
            stage_parallelism=4, pipelined_shuffle=False, **ADAPT_ON)
        assert victim not in cluster.get_urls(), P
        assert_no_leaks(cluster)
        got[P] = (out, sorted(f["kind"] for f in plan.fired))
    assert_matches_reference(got[REF][0], got[PORT][0], "q3 churn")
    assert got[PORT][1] == got[REF][1]


@pytest.mark.parametrize("qname", sorted(TPCH))
def test_tpch_all_paths_under_chaos(tpch, qname):
    """Every adaptation armed under one crash a stage: the port's result
    equal byte for byte to its run with the adaptations off and no fault,
    and to the reference's; the crashes fired in the same stages."""
    got = {}
    for P in BOTH:
        rt, chaos = P("runtime.coordinator"), P("runtime.chaos")
        cluster = rt.InMemoryCluster(4)
        wrapped = chaos.wrap_cluster(cluster,
                                     chaos.one_crash_per_stage(CHAOS_SEED))
        out, _c = coordinated(P, tpch[P], TPCH[qname], wrapped,
                              stage_parallelism=4, pipelined_shuffle=False,
                              **ADAPT_ON)
        assert_no_leaks(cluster)
        got[P] = (out, sorted((f["stage_id"], f["kind"])
                              for f in wrapped.plan.fired))
    assert_matches_reference(got[REF][0], got[PORT][0], qname)
    assert got[PORT][1] == got[REF][1] and got[PORT][1]
    base = coordinated(PORT, tpch[PORT], TPCH[qname],
                       PORT("runtime.coordinator").InMemoryCluster(4),
                       stage_parallelism=4, pipelined_shuffle=False,
                       **ADAPT_OFF)[0]
    assert identical(base.to_numpy(), got[PORT][0].to_numpy()), qname
