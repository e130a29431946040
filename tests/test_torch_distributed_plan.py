"""The port's staged planner against the reference package's on the CPU:
for T in {1, 2, 4, 8}, `explain_distributed(T)`, the verifier's findings
(mesh width given and not given) and the staged plan's structural
fingerprint are equal for all 22 TPC-H queries (SF 0.002, seed 7) and all
43 ClickBench queries (20,000 rows, seed 3); TPC-H at T = 4 under the
planner's knob variants and at T = 8 in x64 mode; the inline cases of
tests/test_plan_snapshots.py; and the planning-only cases of
tests/test_distributed.py (partition_table, the task-count lattice, the
arm assignment). A one-task staged plan has no exchange; plans over more
tasks run in tests/test_torch_tasks.py."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.data.clickbenchgen import (
    gen_clickbench as j_gen_clickbench,
)
from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.planner import distributed as jdist
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.data import clickbenchgen as tcb
from datafusion_distributed_tpu_torch.data import tpchgen as ttpch
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
from datafusion_distributed_tpu_torch.parallel.exchange import partition_table
from datafusion_distributed_tpu_torch.plan.exchanges import (
    assign_arms_to_tasks,
)
from datafusion_distributed_tpu_torch.planner import distributed as tdist
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_staged_plans_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCH_DIR = os.path.join(REPO, "benchmarks", "queries", "tpch")
CLICKBENCH_DIR = os.path.join(REPO, "benchmarks", "queries", "clickbench")
TPCH = [f"q{i}" for i in range(1, 23)]
CLICKBENCH = [f"q{i}" for i in range(43)]
TASKS = (1, 2, 4, 8)


def _sql(qdir: str, q: str) -> str:
    with open(os.path.join(qdir, f"{q}.sql")) as f:
        return f.read()


def _assert_staged_equal(jctx, tctx, sql: str, num_tasks: int, what: str,
                         config=None) -> None:
    jdf, tdf = jctx.sql(sql), tctx.sql(sql)
    if config is None:
        assert tdf.explain_distributed(num_tasks) == \
            jdf.explain_distributed(num_tasks), what
        jp, tp = (jdf.distributed_plan(num_tasks),
                  tdf.distributed_plan(num_tasks))
    else:
        jp = jdf.distributed_plan(num_tasks, jdist.DistributedConfig(**config))
        tp = tdf.distributed_plan(num_tasks, tdist.DistributedConfig(**config))
    assert_staged_plans_equal(jp, tp, num_tasks, what)


@pytest.fixture(scope="module")
def tpch():
    jctx = JContext()
    for name, tbl in gen_tpch(0.002, 7).items():
        jctx.register_arrow(name, tbl)
    tctx = TContext(device="cpu")
    ttpch.register_tpch(tctx, 0.002, 7)
    return jctx, tctx


@pytest.fixture(scope="module")
def clickbench():
    jctx = JContext()
    jctx.register_arrow("hits", j_gen_clickbench(rows=20_000, seed=3))
    tctx = TContext(device="cpu")
    tcb.register_clickbench(tctx, 20_000, 3)
    return jctx, tctx


@pytest.mark.parametrize("q", TPCH)
def test_tpch_staged_plans_match_reference(tpch, q):
    for t in TASKS:
        _assert_staged_equal(*tpch, _sql(TPCH_DIR, q), t, f"{q} T={t}")


@pytest.mark.parametrize("q", CLICKBENCH)
def test_clickbench_staged_plans_match_reference(clickbench, q):
    for t in TASKS:
        _assert_staged_equal(*clickbench, _sql(CLICKBENCH_DIR, q), t,
                             f"{q} T={t}")


def test_tpch_logical_display_matches_reference(tpch):
    jctx, tctx = tpch
    for q in TPCH:
        sql = _sql(TPCH_DIR, q)
        assert tctx.sql(sql).logical_display() == \
            jctx.sql(sql).logical_display(), q


#: the planner's knobs, each at a value that reshapes plans
KNOB_VARIANTS = {
    "multiway_join": {"multiway_join": True},
    "global_hash_agg": {"global_hash_agg": True},
    "no_broadcast": {"broadcast_joins": False, "broadcast_threshold_rows": 0},
    "partial_reduce": {"partial_reduce": True},
    "max_tasks_per_stage": {"max_tasks_per_stage": 3},
}


@pytest.mark.parametrize("variant", sorted(KNOB_VARIANTS))
def test_tpch_knob_variants_match_reference(tpch, variant):
    jctx, tctx = tpch
    for q in TPCH:
        _assert_staged_equal(jctx, tctx, _sql(TPCH_DIR, q), 4,
                             f"{q} {variant}",
                             dict(KNOB_VARIANTS[variant], num_tasks=4))


_X64_SCRIPT = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(1)
    from datafusion_distributed_tpu.data.tpchgen import gen_tpch
    from datafusion_distributed_tpu.sql.context import SessionContext as J
    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.sql.context import SessionContext as T
    from tests.torch_port_helpers import assert_staged_plans_equal
    assert precision.MODE == "x64"
    j = J()
    for name, t in gen_tpch(0.002, 7).items():
        j.register_arrow(name, t)
    t = T(device="cpu")
    tpchgen.register_tpch(t, 0.002, 7)
    for mw in (False, True):
        for ctx in (j, t):
            ctx.config.distributed_options["multiway_join"] = mw
        for i in range(1, 23):
            sql = open(f"{qdir}/q{{i}}.sql").read()
            jdf, tdf = j.sql(sql), t.sql(sql)
            assert tdf.explain_distributed(8) == jdf.explain_distributed(8)
            assert_staged_plans_equal(jdf.distributed_plan(8),
                                      tdf.distributed_plan(8), 8, f"q{{i}}")
    print("X64-STAGED-OK")
""")


def test_tpch_staged_plans_match_reference_in_x64_mode():
    env = dict(os.environ, DFTPU_PRECISION="x64", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _X64_SCRIPT.format(qdir=TPCH_DIR)],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "X64-STAGED-OK" in proc.stdout


# ---------------------------------------------------------------------------
# the inline cases of tests/test_plan_snapshots.py, in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def snapshot_ctx():
    from datafusion_distributed_tpu.data.tpchgen import register_tpch

    jctx = JContext()
    register_tpch(jctx, sf=0.001, seed=0)
    tctx = TContext(device="cpu")
    ttpch.register_tpch(tctx, 0.001, 0)
    return jctx, tctx


#: name -> (sql, tasks, session options)
SNAPSHOT_CASES = {
    "aggregate": ("select l_returnflag, sum(l_quantity) q from lineitem "
                  "group by l_returnflag order by l_returnflag", 4, {}),
    "range_sort": ("select l_orderkey, l_extendedprice from lineitem "
                   "order by l_extendedprice desc", 4,
                   {"range_sort_threshold_rows": 64}),
    "broadcast_join": ("select n_name, count(*) c from supplier, nation "
                       "where s_nationkey = n_nationkey group by n_name", 4,
                       {}),
    "global_aggregate": ("select sum(l_extendedprice * l_discount) as revenue"
                         " from lineitem where l_quantity < 24", 8, {}),
    "topk": ("select o_orderkey from orders order by o_totalprice desc "
             "limit 5", 4, {}),
    "semi_join": ("select o_orderpriority, count(*) c from orders where "
                  "exists (select 1 from lineitem where l_orderkey = "
                  "o_orderkey) group by o_orderpriority", 4, {}),
    "semi_join_coshuffled": (
        "select o_orderpriority, count(*) c from orders where exists ("
        "select 1 from lineitem where l_orderkey = o_orderkey) "
        "group by o_orderpriority", 4, {"broadcast_joins": False}),
    "stage_ids": ("select l_returnflag, count(*) from lineitem group by 1",
                  4, {}),
}


@pytest.mark.parametrize("case", sorted(SNAPSHOT_CASES))
def test_snapshot_cases_match_reference(snapshot_ctx, case):
    sql, t, opts = SNAPSHOT_CASES[case]
    for ctx in snapshot_ctx:
        ctx.config.distributed_options.update(opts)
    try:
        _assert_staged_equal(*snapshot_ctx, sql, t, case)
    finally:
        for ctx in snapshot_ctx:
            for k in opts:
                del ctx.config.distributed_options[k]


def test_snapshot_aggregate_shape(snapshot_ctx):
    """The full stage tree of tests/test_plan_snapshots.py's aggregate case,
    capacities included, from the port."""
    tree = snapshot_ctx[1].sql(SNAPSHOT_CASES["aggregate"][0]) \
        .explain_distributed(4)
    lines = tree.splitlines()
    assert lines[0] == "Sort: [l_returnflag ASC]"
    assert lines[1] == "  CoalesceExchange tasks=4 ── stage 1 boundary"
    assert lines[4].startswith("        ShuffleExchange keys=[__g0] tasks=4 ")
    assert lines[4].endswith(" ── stage 0 boundary")
    assert lines[-1].startswith("                MemoryScan tasks=4 cap=")


# ---------------------------------------------------------------------------
# the planning-only cases of tests/test_distributed.py
# ---------------------------------------------------------------------------


def test_partition_table_roundtrip():
    t = arrow_to_table(pa.table({"x": np.arange(100), "s": ["v"] * 100}),
                       device="cpu")
    parts = partition_table(t, 8)
    assert len(parts) == 8
    assert sum(int(p.num_rows) for p in parts) == 100
    got = np.concatenate([p.to_numpy()["x"] for p in parts])
    np.testing.assert_array_equal(got, np.arange(100))
    assert {p.capacity for p in parts} == {16}
    assert all(p.to_numpy()["s"].tolist() == ["v"] * int(p.num_rows)
               for p in parts)


@pytest.mark.parametrize("rows,parts", [(100, 8), (3, 8), (0, 4), (64, 1),
                                        (17, 5)])
def test_partition_table_matches_reference(rows, parts):
    from datafusion_distributed_tpu.io.parquet import (
        arrow_to_table as j_arrow,
    )
    from datafusion_distributed_tpu.parallel.exchange import (
        partition_table as j_partition,
    )

    rng = np.random.default_rng(rows)
    arrow = pa.table({
        "x": rng.integers(0, 1000, rows),
        "y": pa.array([None if v % 3 == 0 else float(v)
                       for v in range(rows)], type=pa.float64()),
    })
    jparts = j_partition(j_arrow(arrow), parts)
    tparts = partition_table(arrow_to_table(arrow, device="cpu"), parts)
    for j, t in zip(jparts, tparts):
        assert t.capacity == j.capacity
        assert int(t.num_rows) == int(j.num_rows)
        for jc, tc in zip(j.columns, t.columns):
            np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
            np.testing.assert_array_equal(tc.validity.numpy(),
                                          np.asarray(jc.validity))


def test_task_count_lattice():
    d = tdist.TaskCountAnnotation
    assert d(4).merge(d(8)) == d(8)  # desired: max
    assert d(4, True).merge(d(8)) == d(4, True)  # maximum caps desired
    assert d(8).merge(d(4, True)) == d(4, True)
    assert d(8, True).merge(d(4, True)) == d(4, True)  # max+max: min
    assert d(8, True).merge(d(2)) == d(8, True)  # Maximum dominates desired


def test_assign_arms_weighted():
    # more tasks than arms: distinct tasks
    assert len(set(assign_arms_to_tasks([10.0, 5.0], 4))) == 2
    # more arms than tasks: balanced loads
    weights = [4.0, 3.0, 3.0, 2.0, 2.0]
    loads = [0.0, 0.0]
    for w, t in zip(weights, assign_arms_to_tasks(weights, 2)):
        loads[t] += w
    assert abs(loads[0] - loads[1]) <= 2.0
    # equal tasks and arms: a bijection
    assert sorted(assign_arms_to_tasks([1.0, 1.0, 1.0], 3)) == [0, 1, 2]


# ---------------------------------------------------------------------------
# the one-task staged plan
# ---------------------------------------------------------------------------


def test_one_task_staged_plans_have_no_exchange(tpch):
    _jctx, tctx = tpch
    tctx.config.distributed_options["multiway_join"] = True
    try:
        for q in TPCH:
            plan = tctx.sql(_sql(TPCH_DIR, q)).distributed_plan(1)
            assert not plan.collect(lambda n: n.is_exchange), q
    finally:
        del tctx.config.distributed_options["multiway_join"]
