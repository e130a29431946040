"""The port's task-count sizing (planner/distributed.py's task-count
lattice, bytes-based and cardinality-based sizing, planner/statistics.py's
``estimate_rows``, the AdaptiveCoordinator's runtime counts) against the
reference's, on the CPU: the counterpart of tests/test_task_counts.py.

Every case runs both packages on the same seeded arrow tables and compares
what each observes: ``effective_num_tasks``, the staged plan's display
text and each exchange's producer and consumer task counts under
``size_tasks_to_data``, ``bytes_per_task``, ``max_tasks_per_stage``, a user
TaskEstimator (with the calls it saw) and ``cardinality_task_count_factor``;
per-stage byte sizing; ``estimate_rows`` with catalog NDV; the adaptive
coordinator's ``task_count_decisions``; and the coordinated results with
their capacities. The partial-reduce pass on the q1 shape is compared
through the staged plan (every planner annotation) and its result: the
reference runs it as its suite does, on its 8-device mesh, the port on its
in-process task executor (``runtime/mesh_executor.execute_tasks``).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_matches_reference,
    assert_staged_plans_equal,
    planner_annotations,
)

torch.set_num_threads(1)


def _ctx(P, rows: int):
    rng = np.random.default_rng(0)
    ctx = P.ctx()
    ctx.register_arrow("t", pa.table({"k": rng.integers(0, 50, rows),
                                      "v": rng.normal(size=rows)}))
    return ctx


def _exchange_counts(P, staged) -> list:
    ex = P("plan.exchanges")
    return [(type(n).__name__, n.producer_tasks, n.num_tasks)
            for n in staged.collect(lambda n: isinstance(
                n, (ex.ShuffleExchangeExec, ex.CoalesceExchangeExec,
                    ex.BroadcastExchangeExec)))]


def _staged(P, plan, **cfg):
    dist = P("planner.distributed")
    c = dist.DistributedConfig(**cfg)
    staged = dist.distribute_plan(plan, c)
    return (dist.effective_num_tasks(plan, c),
            dist.display_staged_plan(staged), _exchange_counts(P, staged),
            planner_annotations(staged))


CONFIGS = {
    "small_table": (1000, {"num_tasks": 8, "size_tasks_to_data": True}),
    "bytes_per_task_1": (1000, {"num_tasks": 8, "size_tasks_to_data": True,
                                "bytes_per_task": 1}),
    "max_tasks_per_stage": (4000, {"num_tasks": 8,
                                   "max_tasks_per_stage": 2}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_static_task_counts(name):
    rows, cfg = CONFIGS[name]
    got = {}
    for P in BOTH:
        plan = _ctx(P, rows).sql("select k, sum(v) from t group by k") \
            .physical_plan()
        got[P] = _staged(P, plan, **cfg)
    assert got[PORT] == got[REF]
    eff, disp = got[PORT][:2]
    if name == "small_table":
        assert eff == 1 and "tasks=8" not in disp
    elif name == "bytes_per_task_1":
        assert eff == 8 and "tasks=8" in disp
    else:
        assert "tasks=2" in disp and "tasks=8" not in disp


def test_user_task_estimator_hook():
    got = {}
    for P in BOTH:
        dist = P("planner.distributed")
        seen = []

        class CapAtThree(dist.TaskEstimator):
            def task_estimation(self, leaf, cfg):
                seen.append(("estimate", type(leaf).__name__))
                return dist.TaskCountAnnotation(3, maximum=True)

            def scale_up_leaf_node(self, leaf, task_count, cfg):
                seen.append(("scale_up", type(leaf).__name__, task_count))
                return None

        plan = _ctx(P, 4000).sql("select k, sum(v) from t group by k") \
            .physical_plan()
        got[P] = (_staged(P, plan, num_tasks=8, task_estimator=CapAtThree()),
                  sorted(seen))
    assert got[PORT] == got[REF]
    disp = got[PORT][0][1]
    assert "tasks=3" in disp and "tasks=8" not in disp
    assert {s[0] for s in got[PORT][1]} == {"estimate", "scale_up"}


def test_cardinality_factor_shrinks_consumer_stages():
    got = {}
    for P in BOTH:
        plan = _ctx(P, 4000).sql(
            "select k, sum(v) from t where v > 0 group by k").physical_plan()
        got[P] = _staged(P, plan, num_tasks=8,
                         cardinality_task_count_factor=2.0)
    assert got[PORT] == got[REF]
    shuffles = [c for c in got[PORT][2] if c[0] == "ShuffleExchangeExec"]
    assert shuffles and shuffles[0][1:] == (8, 2), got[PORT][2]


def _coordinated(P, df, num_tasks=8, workers=2, coord=None):
    kw = ({"coordinator": coord} if coord is not None
          else {"num_workers": workers})
    return df._strip_quals(df.collect_coordinated_table(num_tasks=num_tasks,
                                                        **kw))


def test_max_tasks_per_stage_end_to_end():
    got = {}
    for P in BOTH:
        ctx = _ctx(P, 4000)
        ctx.config.distributed_options["max_tasks_per_stage"] = 2
        got[P] = _coordinated(
            P, ctx.sql("select k, sum(v) as sv from t group by k"))
    assert_matches_reference(got[REF], got[PORT], "max_tasks_per_stage")


def test_per_stage_byte_sizing_differs_between_stages():
    rng = np.random.default_rng(1)
    n = 60_000
    fact = pa.table({"k": rng.integers(0, 40, n), "v": rng.normal(size=n),
                     "pad1": rng.normal(size=n), "pad2": rng.normal(size=n)})
    dim = pa.table({"k": np.arange(40), "name": rng.integers(0, 5, 40)})
    sql = ("select d.name, sum(f.v) from fact f join dim d on f.k = d.k "
           "group by d.name order by d.name")
    got = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.register_arrow("fact", fact)
        ctx.register_arrow("dim", dim)
        df = ctx.sql(sql)
        staged = _staged(P, df.physical_plan(), num_tasks=8,
                         size_tasks_to_data=True, bytes_per_task=400_000,
                         broadcast_joins=True)
        ctx.config.distributed_options["bytes_per_task"] = 400_000
        got[P] = (staged, _coordinated(P, df))
    assert got[PORT][0] == got[REF][0]
    assert_matches_reference(got[REF][1], got[PORT][1], "per-stage")
    counts = sorted((c[1] or c[2]) for c in got[PORT][0][2]
                    if c[0] == "ShuffleExchangeExec")
    assert counts and counts[-1] > 1, got[PORT][0][1]


def test_adaptive_coordinator_shrinks_task_counts():
    got = {}
    for P in BOTH:
        ctx = _ctx(P, 4000)
        ctx.config.distributed_options["bytes_per_task"] = 1
        df = ctx.sql("select k, sum(v) as sv from t group by k order by k")
        rt = P("runtime.coordinator")
        cluster = rt.InMemoryCluster(2)
        # sized from every producer's output: at the default fraction the
        # statistics freeze when the first producers finish, which is a
        # race in both packages (tests/test_torch_coordinator.py)
        coord = rt.AdaptiveCoordinator(resolver=cluster, channels=cluster,
                                       sample_fraction=1.0)
        got[P] = (_coordinated(P, df, 4, coord=coord),
                  sorted(coord.task_count_decisions))
    assert_matches_reference(got[REF][0], got[PORT][0], "adaptive")
    assert got[PORT][1] == got[REF][1]
    assert any(chosen < planned for _s, planned, chosen in got[PORT][1])


def test_isolated_arms_survive_task_count_shrink():
    rng = np.random.default_rng(7)
    arrow = pa.table({"a": rng.integers(0, 100, 256)})
    got = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.register_arrow("t", arrow)
        ctx.config.distributed_options["size_tasks_to_data"] = False
        df = ctx.sql("select sum(a) v from t union all select max(a) v "
                     "from t")
        rt = P("runtime.coordinator")
        cluster = rt.InMemoryCluster(2)
        coord = rt.Coordinator(resolver=cluster, channels=cluster)
        got[P] = _coordinated(P, df, 4, coord=coord)
    assert_matches_reference(got[REF], got[PORT], "isolated arms")
    assert int(got[PORT].num_rows) == 2


def test_partial_reduce_pass_fires_on_q1_shape():
    sql = ("select k, sum(v) as sv, count(*) as c, avg(v) as av from t "
           "group by k order by k")
    got = {}
    for P in BOTH:
        df = _ctx(P, 4000).sql(sql)
        plan = df.physical_plan()
        dist = P("planner.distributed")
        agg = P("plan.physical").HashAggregateExec
        off = dist.distribute_plan(plan, dist.DistributedConfig(num_tasks=8))
        assert not off.collect(lambda n: isinstance(n, agg)
                               and n.mode == "partial_reduce"), P
        staged = dist.distribute_plan(plan, dist.DistributedConfig(
            num_tasks=8, partial_reduce=True))
        shuffles = staged.collect(lambda n: isinstance(
            n, P("plan.exchanges").ShuffleExchangeExec))
        assert any(isinstance(s.child, agg)
                   and s.child.mode == "partial_reduce"
                   and s.child.child.mode == "partial"
                   for s in shuffles), P
        if P is REF:
            import jax

            ex = P("runtime.mesh_executor")
            out = ex.execute_on_mesh(staged,
                                     ex.make_mesh(min(8, len(jax.devices()))))
        else:
            out = P("runtime.mesh_executor").execute_tasks(staged, 8)
        got[P] = (staged, df._strip_quals(out), df._strip_quals(
            df.collect_table()))
    assert_staged_plans_equal(got[REF][0], got[PORT][0], 8, "partial_reduce")
    assert_matches_reference(got[REF][1], got[PORT][1], "partial_reduce")
    single = got[PORT][2].to_numpy()
    res = got[PORT][1].to_numpy()
    np.testing.assert_array_equal(res["k"], single["k"])
    for col in ("sv", "c", "av"):
        np.testing.assert_allclose(res[col], single[col], rtol=2e-5)


def test_estimate_rows_consumes_catalog_ndv():
    rng = np.random.default_rng(3)
    n = 20_000
    arrow = pa.table({"k": rng.integers(0, 7, n),
                      "cat": rng.integers(0, 20, n),
                      "v": rng.normal(size=n)})
    got = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.register_arrow("t", arrow)
        est = P("planner.statistics").estimate_rows
        agg = ctx.sql("select k, sum(v) from t group by k").physical_plan()
        filt = ctx.sql("select v from t where cat = 3").physical_plan()
        dist = P("planner.distributed")
        staged = dist.distribute_plan(agg, dist.DistributedConfig(
            num_tasks=8))
        got[P] = (est(agg), est(filt), est(staged))
    assert got[PORT] == got[REF]
    assert got[PORT][0] <= 16 and got[PORT][1] < n / 6
    assert got[PORT][2] <= 16 * 8
