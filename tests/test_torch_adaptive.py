"""The port's adaptive planning (planner/adaptive.py: LoadInfo, SamplerExec,
insert_samplers, resize_for_inputs; planner/statistics.py's cost model;
the AdaptiveCoordinator's task counts, partial-sample freezes and overflow
headroom; the session's targeted overflow widening) against the
reference's, on the CPU: the counterpart of tests/test_adaptive.py.

Every case runs both packages on the same seeded arrow input and compares
what each observes: the row estimate and the three costs of a plan and of
its staged form, ``Complexity`` and ``compute_based_task_count``;
``collect_load_info``'s LoadInfo (but its wall-clock rates); the
SamplerExec's recorded metrics; the plan after ``insert_samplers``;
``resize_for_inputs``' slots; the adaptive
coordinator's results, its ``task_count_decisions`` (sized from every
producer's output, ``sample_fraction = 1.0``: at a partial fraction the
freeze follows which producers finish first, in both packages alike) and
the co-shuffled join's shared count; at the default fraction, that each
package decides from a partial sample with per-column statistics; the
widened planner and distributed configs for each overflow message; and the
resize headroom through a pin, a successful run and a release.
"""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_matches_reference,
)

torch.set_num_threads(1)


def _plan(P, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    arrow = pa.table({"k": rng.integers(0, 12, n), "v": rng.normal(size=n)})
    t = P.table(arrow)
    phys = P("plan.physical")
    ex = P("plan.expressions")
    float64 = P("schema").DataType.FLOAT64
    scan = phys.MemoryScanExec([t], t.schema())
    filt = phys.FilterExec(
        ex.BinaryOp(">", ex.Col("v"), ex.Literal(0.0, float64)), scan)
    agg = P("ops.aggregate").AggSpec
    return phys.HashAggregateExec(
        "single", ["k"], [agg("sum", "v", "sv"), agg("count_star", None, "n")],
        filt)


def _staged(P, plan, tasks=4):
    dist = P("planner.distributed")
    return dist.distribute_plan(plan, dist.DistributedConfig(num_tasks=tasks))


def test_cost_model():
    got = {}
    for P in BOTH:
        st = P("planner.statistics")
        plan = _plan(P)
        cost = dataclasses.asdict(st.calculate_cost(plan))
        dcost = dataclasses.asdict(st.calculate_cost(_staged(P, plan)))
        got[P] = (st.estimate_rows(plan), cost, dcost,
                  [st.Complexity(nlogn=1.0).evaluate(n)
                   for n in (1, 1024, 10 ** 6)],
                  [st.compute_based_task_count(st.Cost(compute=c), 1e8, 8)
                   for c in (1e5, 1e8, 3e8, 1e9, 1e12)],
                  st.row_width(plan.schema()))
    assert got[PORT] == got[REF]
    assert 1 <= got[PORT][0] <= 3000 and got[PORT][2]["network"] > 0


def test_collect_load_info():
    arrow = pa.table({"k": pa.array([1, 1, 2, None], type=pa.int64()),
                      "s": ["a", "b", "a", "c"],
                      "f": pa.array([0.5, None, None, 1.5])})
    got = {}
    for P in BOTH:
        info = P("planner.adaptive").collect_load_info([P.table(arrow)] * 2)
        # rows_per_s and bytes_per_s are rates over this call's wall time
        got[P] = {k: v for k, v in dataclasses.asdict(info).items()
                  if not k.endswith("_per_s")}
    assert got[PORT] == got[REF]
    assert got[PORT]["ndv"]["k"] == 2 and got[PORT]["rows"] == 8


def test_sampler_exec_records_metrics():
    got = {}
    for P in BOTH:
        plan = _plan(P, 500)
        wrapped = P("planner.adaptive").SamplerExec(plan)
        store = P("runtime.metrics").MetricsStore()
        P("plan.physical").execute_plan(wrapped, metrics_store=store,
                                        task_label="task0")
        m = store.aggregated()[wrapped.node_id]
        got[P] = (m["sampled_rows"], m["sampled_bytes"])
    assert got[PORT] == got[REF]
    assert got[PORT][0] == 12 and got[PORT][1] > 0


def test_insert_samplers_under_exchanges():
    got = {P: P("planner.adaptive").insert_samplers(
        _staged(P, _plan(P))).display_tree() for P in BOTH}
    assert got[PORT] == got[REF]
    assert "Sampler" in got[PORT]


@pytest.mark.parametrize("rows,ndv", [(100, 12), (100, None), (5000, 3000),
                                      (10, 1)])
def test_resize_for_inputs(rows, ndv):
    got = {}
    for P in BOTH:
        ad = P("planner.adaptive")
        plan = _plan(P)
        info = ad.LoadInfo(rows=rows, bytes=rows * 16,
                           ndv={} if ndv is None else {"k": ndv})
        resized = ad.resize_for_inputs(plan, info)
        got[P] = (plan.num_slots, resized.num_slots)
    assert got[PORT] == got[REF]
    if (rows, ndv) == (100, 12):
        assert got[PORT][1] <= 64 and got[PORT][1] < got[PORT][0]


def _adaptive(P, cluster, **kw):
    return P("runtime.coordinator").AdaptiveCoordinator(
        resolver=cluster, channels=cluster, **kw)


def test_adaptive_coordinator_matches_single():
    got = {}
    for P in BOTH:
        plan = _plan(P, 4000, seed=3)
        cluster = P("runtime.coordinator").InMemoryCluster(2)
        coord = _adaptive(P, cluster, sample_fraction=1.0)
        out = coord.execute(_staged(P, plan))
        single = P("plan.physical").execute_plan(plan)
        got[P] = (out, single, sorted(coord.task_count_decisions))
    assert_matches_reference(got[REF][0], got[PORT][0], "adaptive")
    assert got[PORT][2] == got[REF][2]
    a = got[PORT][0].to_pandas().sort_values("k").reset_index(drop=True)
    b = got[PORT][1].to_pandas().sort_values("k").reset_index(drop=True)
    np.testing.assert_array_equal(a["k"], b["k"])
    np.testing.assert_array_equal(a["n"], b["n"])


def _grouped(P, n, seed, sql, tasks, **kw):
    rng = np.random.default_rng(seed)
    arrow = pa.table({"k": rng.integers(0, 50, n).astype("int64"),
                      "v": rng.normal(size=n)})
    ctx = P.ctx()
    ctx.register_arrow("t", arrow)
    ctx.config.distributed_options["bytes_per_task"] = 1
    df = ctx.sql(sql)
    cluster = P("runtime.coordinator").InMemoryCluster(4)
    coord = _adaptive(P, cluster, **kw)
    out = df._strip_quals(df.collect_coordinated_table(coordinator=coord,
                                                       num_tasks=tasks))
    return out, coord


def test_adaptive_overlap_partial_decision():
    sql = "select k, sum(v) sv, count(*) c from t group by k order by k"
    got = {}
    for P in BOTH:
        out, coord = _grouped(P, 20000, 7, sql, 4)
        assert coord.partial_decisions, P
        for done, total in coord.partial_decisions.values():
            assert 0 < done < total, P
        full, fcoord = _grouped(P, 20000, 7, sql, 4, sample_fraction=1.0)
        got[P] = (out, full, sorted(fcoord.task_count_decisions))
    # the partial freeze's sizing follows the finishing order: rows equal
    for i in (0, 1):
        a, b = got[PORT][i].to_numpy(), got[REF][i].to_numpy()
        np.testing.assert_array_equal(a["k"], b["k"])
        np.testing.assert_array_equal(a["c"], b["c"])
        np.testing.assert_allclose(a["sv"], b["sv"], rtol=2e-5, atol=1e-3)
    assert_matches_reference(got[REF][1], got[PORT][1], "full sample")
    assert got[PORT][2] == got[REF][2]


def _join_decisions(P, n_rows, sample_fraction):
    rng = np.random.default_rng(7)
    ctx = P.ctx()
    ctx.register_arrow("a", pa.table({"k": rng.integers(0, 40, n_rows),
                                      "v": rng.normal(size=n_rows)}))
    ctx.register_arrow("b", pa.table({"k": np.arange(40),
                                      "w": rng.normal(size=40)}))
    ctx.config.distributed_options["broadcast_joins"] = False
    ctx.config.distributed_options["bytes_per_task"] = 1
    df = ctx.sql("select a.k, sum(a.v) sv, sum(b.w) sw from a join b "
                 "on a.k = b.k group by a.k order by a.k")
    cluster = P("runtime.coordinator").InMemoryCluster(2)
    coord = _adaptive(P, cluster, bytes_per_task=1 << 16,
                      sample_fraction=sample_fraction)
    out = df._strip_quals(df.collect_coordinated_table(coordinator=coord,
                                                       num_tasks=4))
    d = {sid: t for sid, _planned, t in coord.task_count_decisions}
    lo = sorted(d)[:2]
    return out, (d[lo[0]], d[lo[1]]), sorted(coord.task_count_decisions)


@pytest.mark.parametrize("n_rows,expect", [(200, 1), (60_000, 4)])
def test_coshuffled_join_stage_adapts_shared_count(n_rows, expect):
    got = {P: _join_decisions(P, n_rows, 1.0) for P in BOTH}
    assert_matches_reference(got[REF][0], got[PORT][0], "co-shuffled")
    assert got[PORT][1:] == got[REF][1:]
    assert got[PORT][1] == (expect, expect)
    # at the default fraction too, both feeds agree on one count
    for P in BOTH:
        _out, pair, _d = _join_decisions(P, n_rows, 0.25)
        assert pair == (expect, expect), (P, pair)


def test_midstream_column_loadinfo():
    rng = np.random.default_rng(11)
    n = 40_000
    vals = rng.normal(size=n)
    vals[rng.random(n) < 0.1] = np.nan
    arrow = pa.table({"k": rng.integers(0, 64, n),
                      "v": pa.array(vals, from_pandas=True)})
    sql = "select k, sum(v) s, count(*) c from t group by k order by k"
    got = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.register_arrow("t", arrow)
        ctx.config.distributed_options["bytes_per_task"] = 1
        df = ctx.sql(sql)
        cluster = P("runtime.coordinator").InMemoryCluster(2)
        coord = _adaptive(P, cluster, sample_fraction=0.25)
        out = df._strip_quals(df.collect_coordinated_table(
            coordinator=coord, num_tasks=8))
        assert coord.partial_decisions, P
        with_ndv = [(sid, i) for sid, i in coord._predicted.items() if i.ndv]
        assert with_ndv, P
        sid, info = with_ndv[0]
        done, total = coord.partial_decisions[sid]
        assert done < total and info.ndv_scale == pytest.approx(
            total / done), P
        assert any(1 <= v <= 64 for v in info.ndv.values()), P
        assert info.null_frac and info.rows_per_s > 0, P
        got[P] = (out, sorted(info.ndv), sorted(info.null_frac))
    a, b = got[PORT][0].to_numpy(), got[REF][0].to_numpy()
    np.testing.assert_array_equal(a["k"], b["k"])
    np.testing.assert_array_equal(a["c"], b["c"])
    np.testing.assert_allclose(a["s"], b["s"], rtol=2e-5, equal_nan=True)
    assert got[PORT][1:] == got[REF][1:]


OVERFLOWS = [
    ("agg", "hash table overflow in plan (nodes: ['HashAggregate']); "
            "re-plan with more slots", True, False),
    ("join_shuffle", "exchange/hash capacity overflow on mesh (nodes: "
                     "['HashJoin', 'ShuffleExchange']); re-plan with more "
                     "slots", True, False),
    ("bare", "hash table overflow somewhere", True, False),
    ("unknown_label", "hash table overflow in plan (nodes: ['TopK']); "
                      "re-plan", True, False),
    ("shuffle_single_process", "hash table overflow in plan (nodes: "
                               "['ShuffleExchange']); re-plan", False, False),
    ("force_all", "hash table overflow in plan (nodes: ['HashAggregate']); "
                  "re-plan with more slots", True, True),
]


@pytest.mark.parametrize("case", OVERFLOWS, ids=[o[0] for o in OVERFLOWS])
def test_targeted_overflow_widening(case):
    _name, msg, distributed, force_all = case
    got = {}
    for P in BOTH:
        p = P("sql.planner").PlannerConfig()
        d = (P("planner.distributed").DistributedConfig(num_tasks=4)
             if distributed else None)
        p2, d2 = P("sql.context")._widen_for_overflow(
            p, d, RuntimeError(msg), force_all=force_all)
        got[P] = ({k: v for k, v in dataclasses.asdict(p2).items()
                   if v != getattr(p, k)},
                  None if d2 is None else {
                      f.name: getattr(d2, f.name)
                      for f in dataclasses.fields(d2)
                      if getattr(d2, f.name) != getattr(d, f.name)})
    assert got[PORT] == got[REF]
    assert got[PORT][0] or got[PORT][1]


def test_pinned_headroom_survives_inner_success():
    rng = np.random.default_rng(3)
    arrow = pa.table({"k": rng.integers(0, 8, 2000),
                      "v": rng.normal(size=2000)})
    got = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.register_arrow("t", arrow)
        ctx.config.distributed_options["bytes_per_task"] = 1
        df = ctx.sql("select k, sum(v) s from t group by k")
        cluster = P("runtime.coordinator").InMemoryCluster(2)
        coord = _adaptive(P, cluster)
        plan = df.distributed_plan(4, coordinator=coord)
        seq = [coord._base_resize_headroom, coord.OVERFLOW_WIDEN_FACTOR]
        coord.pin_overflow_headroom(attempt=2)
        seq.append(coord.resize_headroom)
        out = coord.execute(plan)
        seq += [int(out.num_rows), coord.resize_headroom]
        coord.release_overflow_headroom()
        coord.execute(plan)
        seq.append(coord.resize_headroom)
        got[P] = seq
    assert got[PORT] == got[REF]
    base, factor, pinned, rows, after, released = got[PORT]
    assert pinned == base * factor ** 2 == after and rows == 8
    assert released == base
