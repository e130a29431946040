"""Staged plans over T > 1 tasks on one device (`runtime/mesh_executor.py`,
the exchanges' `_execute`, `collect_distributed_table(T)`) against the
reference package's 8-device CPU mesh (tests/conftest.py).

- TPC-H, all 22 queries at SF 0.002, seed 7, `bytes_per_task = 1`, through
  `collect_distributed_table(8)` in both packages: ints, strings and row
  order exact, floats at test_rtol(), result capacities and overflow-retry
  counts equal. q22 and q13 again over `orders` without the customers whose
  key is divisible by 3 (SF 0.01: 7 and 22 rows); S1 and S2 with
  `multiway_join` on; q3, q9 and q13 at T = 2 and 4; q1, q3, q9, q13, q16
  and q18 in x64 mode in a subprocess.
- ClickBench, all 43 queries at 20,000 rows, seed 3, at T = 8.
- The mesh cases of tests/test_distributed.py, through both packages.
- An overflow retry at T = 8: a skewed key overflows a shuffle's
  per-destination capacity; the retried plans and counts are equal.
- `IsolatedArmExec`: the arm computed once at T = 8, and the other tasks'
  empty arm equal to the reference's; the split of a scan column shared by
  two plans."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from datafusion_distributed_tpu.data.clickbenchgen import (
    gen_clickbench as j_gen_clickbench,
)
from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.io.parquet import arrow_to_table as j_arrow
from datafusion_distributed_tpu.ops.aggregate import AggSpec as JAggSpec
from datafusion_distributed_tpu.ops.sort import SortKey as JSortKey
from datafusion_distributed_tpu.parallel.exchange import (
    partition_table as j_partition,
)
from datafusion_distributed_tpu.plan import exchanges as jex
from datafusion_distributed_tpu.plan import physical as jphys
from datafusion_distributed_tpu.planner import distributed as jdist
from datafusion_distributed_tpu.runtime import mesh_executor as jmesh
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.data import clickbenchgen as tcb
from datafusion_distributed_tpu_torch.data import tpchgen as ttpch
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table as t_arrow
from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec as TAggSpec
from datafusion_distributed_tpu_torch.ops.sort import SortKey as TSortKey
from datafusion_distributed_tpu_torch.parallel.exchange import (
    partition_table as t_partition,
)
from datafusion_distributed_tpu_torch.plan import exchanges as tex
from datafusion_distributed_tpu_torch.plan import physical as tphys
from datafusion_distributed_tpu_torch.planner import distributed as tdist
from datafusion_distributed_tpu_torch.runtime import mesh_executor as tmesh
from datafusion_distributed_tpu_torch.sql import context as tcontext
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import (
    assert_results_equal,
    assert_staged_plans_equal,
    np_of,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCH_DIR = os.path.join(REPO, "benchmarks", "queries", "tpch")
CLICKBENCH_DIR = os.path.join(REPO, "benchmarks", "queries", "clickbench")
TPCH = [f"q{i}" for i in range(1, 23)]
CLICKBENCH = [f"q{i}" for i in range(43)]
NT = 8

#: the star query: lineitem probes orders, part and supplier on its own keys
S1 = """select s_nationkey, p_brand, o_orderpriority, count(*) as n,
       sum(l_quantity) as q
from lineitem join orders on l_orderkey = o_orderkey
join part on l_partkey = p_partkey join supplier on l_suppkey = s_suppkey
group by s_nationkey, p_brand, o_orderpriority
order by s_nationkey, p_brand, o_orderpriority"""
#: S1's star with a selective first step: the suppliers of one nation
S2 = """select p_brand, o_orderpriority, count(*) as n, sum(l_quantity) as q
from lineitem join orders on l_orderkey = o_orderkey
join part on l_partkey = p_partkey join supplier on l_suppkey = s_suppkey
where s_nationkey = 3
group by p_brand, o_orderpriority order by p_brand, o_orderpriority"""
STARS = {"S1": S1, "S2": S2}


def _sql(qdir: str, q: str) -> str:
    if q in STARS:
        return STARS[q]
    with open(os.path.join(qdir, f"{q}.sql")) as f:
        return f.read()


def _assert_same_run(jdf, tdf, num_tasks: int, what: str):
    """Both packages' collect_distributed_table(num_tasks): equal results,
    capacities, names and overflow-retry counts."""
    a = jdf.collect_distributed_table(num_tasks)
    b = tdf.collect_distributed_table(num_tasks)
    assert b.names == a.names, what
    assert b.capacity == a.capacity, what
    assert tdf.last_retry_count == jdf.last_retry_count, what
    assert_results_equal(a.to_numpy(), b.to_numpy(), what)
    return a, b


def _tpch_contexts(arrow: dict, **opts):
    jctx, tctx = JContext(), TContext(device="cpu")
    for name, tbl in arrow.items():
        jctx.register_arrow(name, tbl)
        tctx.register_arrow(name, tbl)
    for ctx in (jctx, tctx):
        ctx.config.distributed_options["bytes_per_task"] = 1
        ctx.config.distributed_options.update(opts)
    return jctx, tctx


@pytest.fixture(scope="module")
def tpch_arrow():
    return gen_tpch(0.002, 7)


@pytest.fixture(scope="module")
def tpch(tpch_arrow):
    return _tpch_contexts(tpch_arrow)


# ---------------------------------------------------------------------------
# TPC-H
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", TPCH)
def test_tpch_eight_tasks_match_reference(tpch, q):
    jctx, tctx = tpch
    sql = _sql(TPCH_DIR, q)
    _assert_same_run(jctx.sql(sql), tctx.sql(sql), NT, q)


@pytest.mark.parametrize("num_tasks", [2, 4])
@pytest.mark.parametrize("q", ["q3", "q9", "q13"])
def test_tpch_two_and_four_tasks_match_reference(tpch, q, num_tasks):
    jctx, tctx = tpch
    sql = _sql(TPCH_DIR, q)
    _assert_same_run(jctx.sql(sql), tctx.sql(sql), num_tasks,
                     f"{q} T={num_tasks}")


@pytest.mark.parametrize("q", ["q3", "q13", "q21"])
def test_producers_cut_to_live_rows_match_reference(tpch, q, monkeypatch):
    """Every exchange's producers cut to their live rows before routing
    (as large ones are on the card): the same results as the reference."""
    monkeypatch.setattr(tex, "PREFIX_MIN_ROWS", 0)
    cuts = []
    real = tex.live_prefix
    monkeypatch.setattr(tex, "live_prefix",
                        lambda t: cuts.append(t.capacity) or real(t))
    jctx, tctx = tpch
    sql = _sql(TPCH_DIR, q)
    _assert_same_run(jctx.sql(sql), tctx.sql(sql), NT, q)
    assert cuts


@pytest.mark.parametrize("q", ["S1", "S2"])
def test_star_queries_fused_at_eight_tasks_match_reference(tpch_arrow, q):
    jctx, tctx = _tpch_contexts(tpch_arrow, multiway_join=True)
    tdf = tctx.sql(_sql(TPCH_DIR, q))
    plan = tdf.distributed_plan(
        NT, tdf._seeded_distributed_config(NT), executing=False)
    assert plan.collect(lambda n: type(n).__name__ == "MultiwayHashJoinExec")
    _a, b = _assert_same_run(jctx.sql(_sql(TPCH_DIR, q)), tdf, NT, q)
    assert int(b.num_rows) > 0


def test_q22_and_q13_with_customers_without_orders_at_eight_tasks():
    """q22 and q13 over customers of whom a third have no order (SF 0.01:
    7 and 22 rows), so that q22 returns rows at T = 8."""
    arrow = gen_tpch(0.01, 7)
    orders = arrow["orders"]
    keep = np.asarray(orders.column("o_custkey")) % 3 != 0
    jctx, tctx = _tpch_contexts(dict(arrow,
                                     orders=orders.filter(pa.array(keep))))
    for q, rows in (("q22", 7), ("q13", 22)):
        sql = _sql(TPCH_DIR, q)
        _a, b = _assert_same_run(jctx.sql(sql), tctx.sql(sql), NT, q)
        assert int(b.num_rows) == rows, q


_X64_SCRIPT = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(1)
    from datafusion_distributed_tpu.data.tpchgen import gen_tpch
    from datafusion_distributed_tpu_torch import precision
    from tests.test_torch_tasks import _assert_same_run, _tpch_contexts
    assert precision.MODE == "x64"
    j, t = _tpch_contexts(gen_tpch(0.002, 7))
    for q in {queries!r}:
        sql = open(f"{qdir}/{{q}}.sql").read()
        _assert_same_run(j.sql(sql), t.sql(sql), 8, q)
    print("X64-TASKS-OK")
""")


def test_tpch_eight_tasks_match_reference_in_x64_mode():
    script = _X64_SCRIPT.format(
        qdir=TPCH_DIR, queries=("q1", "q3", "q9", "q13", "q16", "q18"))
    env = dict(os.environ, DFTPU_PRECISION="x64", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "X64-TASKS-OK" in proc.stdout


# ---------------------------------------------------------------------------
# ClickBench
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clickbench():
    jctx = JContext()
    jctx.register_arrow("hits", j_gen_clickbench(rows=20_000, seed=3))
    tctx = TContext(device="cpu")
    tcb.register_clickbench(tctx, 20_000, 3)
    return jctx, tctx


@pytest.mark.parametrize("q", CLICKBENCH)
def test_clickbench_eight_tasks_match_reference(clickbench, q):
    jctx, tctx = clickbench
    sql = _sql(CLICKBENCH_DIR, q)
    _assert_same_run(jctx.sql(sql), tctx.sql(sql), NT, q)


# ---------------------------------------------------------------------------
# the mesh cases of tests/test_distributed.py, in both packages
# ---------------------------------------------------------------------------


def _both(**tables):
    jctx, tctx = JContext(), TContext(device="cpu")
    for name, tbl in tables.items():
        jctx.register_arrow(name, tbl)
        tctx.register_arrow(name, tbl)
    return jctx, tctx


def test_union_arm_isolation_on_mesh():
    rng = np.random.default_rng(5)
    jctx, tctx = _both(t=pa.table({
        "k": rng.integers(0, 10, 512).astype(np.int32),
        "v": rng.normal(size=512)}))
    sql = ("select k, sum(v) as sv from t group by k "
           "union all select -1 as k, sum(v) as sv from t")
    tdf = tctx.sql(sql)
    assert tdf.distributed_plan(NT).collect(
        lambda n: isinstance(n, tex.IsolatedArmExec))
    _assert_same_run(jctx.sql(sql), tdf, NT, "union arm")


def test_union_replicated_arm_no_duplication():
    jctx, tctx = _both(b=pa.table({"x": np.arange(64, dtype=np.int64)}))
    sql = "select x from b union all select max(x) from b"
    _a, b = _assert_same_run(jctx.sql(sql), tctx.sql(sql), NT, "union")
    assert int(b.num_rows) == 65


def test_distributed_sql_join_matches_single():
    rng = np.random.default_rng(2)
    jctx, tctx = _both(
        f=pa.table({"k": rng.integers(0, 20, 3000),
                    "v": rng.normal(size=3000)}),
        d=pa.table({"k": np.arange(20), "w": rng.normal(size=20)}))
    sql = ("select f.k, sum(f.v * d.w) s, count(*) n from f, d "
           "where f.k = d.k group by f.k order by f.k")
    _assert_same_run(jctx.sql(sql), tctx.sql(sql), NT, "join")


def test_distributed_anti_join_replicated_probe():
    rng = np.random.default_rng(3)
    jctx, tctx = _both(t=pa.table({"k": rng.integers(0, 50, 500)}),
                       u=pa.table({"k": rng.integers(0, 50, 400)}))
    sql = ("select k from (select distinct k from t order by k) s "
           "where k not in (select k from u)")
    _assert_same_run(jctx.sql(sql), tctx.sql(sql), NT, "anti join")


def test_range_sort_exact_order_on_mesh():
    rng = np.random.default_rng(5)
    n = 12000
    arrow = pa.table({
        "k": rng.integers(-500, 500, n).astype("int64"),
        "s": rng.choice(["ant", "bee", "cat", "dog", "elk"], n),
        "v": rng.normal(size=n),
    })
    jctx, tctx = _both(t=arrow)
    for ctx in (jctx, tctx):
        ctx.config.distributed_options["bytes_per_task"] = 1
        ctx.config.distributed_options["range_sort_threshold_rows"] = 64
    sql = "select k, s from t where v > 0 order by s desc, k"
    tdf = tctx.sql(sql)
    assert "RangeShuffleExchange" in tdf.explain_distributed(NT)
    _a, b = _assert_same_run(jctx.sql(sql), tdf, NT, "range sort")
    single = tctx.sql(sql).collect_table()
    assert_results_equal(single.to_numpy(), b.to_numpy(), "range sort")


def _hand_built(pkg: str, arrow, build):
    """``build(mods, table)`` in package ``pkg`` -> the staged plan."""
    if pkg == "j":
        mods = dict(phys=jphys, ex=jex, dist=jdist, agg=JAggSpec,
                    sort=JSortKey, split=j_partition)
        table = j_arrow(arrow)
    else:
        mods = dict(phys=tphys, ex=tex, dist=tdist, agg=TAggSpec,
                    sort=TSortKey, split=t_partition)
        table = t_arrow(arrow, device="cpu")
    return build(mods, table)


def _run_hand_built(arrow, build, what: str):
    jplan = _hand_built("j", arrow, build)
    tplan = _hand_built("t", arrow, build)
    assert tdist.display_staged_plan(tplan) == jdist.display_staged_plan(jplan)
    a = jmesh.execute_on_mesh(jplan, jmesh.make_mesh(NT))
    b = tmesh.execute_tasks(tplan, NT)
    assert b.capacity == a.capacity, what
    assert_results_equal(a.to_numpy(), b.to_numpy(), what)
    return tplan


def test_distributed_aggregate_matches_single():
    rng = np.random.default_rng(1)
    arrow = pa.table({"k": rng.integers(0, 30, 2000),
                      "v": rng.normal(size=2000)})

    def build(m, t):
        scan = m["phys"].MemoryScanExec([t], t.schema())
        agg = m["phys"].HashAggregateExec(
            "single", ["k"],
            [m["agg"]("sum", "v", "sv"), m["agg"]("count_star", None, "n"),
             m["agg"]("min", "v", "mn")], scan)
        plan = m["phys"].SortExec([m["sort"]("k")], agg)
        return m["dist"].distribute_plan(plan,
                                         m["dist"].DistributedConfig(NT))

    plan = _run_hand_built(arrow, build, "aggregate")
    s = tdist.display_staged_plan(plan)
    assert "ShuffleExchange" in s and "CoalesceExchange" in s


def test_preinjected_reduction_tree_on_mesh():
    """partial -> N:M coalesce (2 consumers) -> partial_reduce -> coalesce
    -> final, hand-placed: the planner only finalizes it."""
    rng = np.random.default_rng(13)
    arrow = pa.table({"k": rng.integers(0, 9, 6000),
                      "v": rng.normal(size=6000)})

    def build(m, t):
        ph, ex = m["phys"], m["ex"]
        aggs = [m["agg"]("avg", "v", "av"), m["agg"]("count_star", None, "c")]
        scan = ph.MemoryScanExec(m["split"](t, NT), t.schema())
        partial = ph.HashAggregateExec("partial", ["k"], aggs, scan,
                                       num_slots=64)
        narrow = ex.CoalesceExchangeExec(partial, NT, num_consumers=2)
        reduce_ = ph.HashAggregateExec("partial_reduce", ["k"], aggs, narrow,
                                       num_slots=64)
        gather = ex.CoalesceExchangeExec(reduce_, NT)
        final = ph.HashAggregateExec("final", ["k"], aggs, gather,
                                     num_slots=64)
        plan = ph.SortExec([m["sort"]("k")], final)
        return m["dist"].distribute_plan(plan,
                                         m["dist"].DistributedConfig(NT))

    plan = _run_hand_built(arrow, build, "reduction tree")
    assert sorted(e.stage_id for e in plan.collect(
        lambda n: n.is_exchange)) == [0, 1]


def test_preinjected_partitioned_root_gets_coalesced():
    """A tree ending at a shuffle comes back coalesced, so the root stage
    reads a one-consumer coalesce and task 0 alone runs it."""
    rng = np.random.default_rng(21)
    arrow = pa.table({"k": rng.integers(0, 7, 3000),
                      "v": rng.normal(size=3000)})

    def build(m, t):
        ph = m["phys"]
        scan = ph.MemoryScanExec(m["split"](t, NT), t.schema())
        partial = ph.HashAggregateExec(
            "partial", ["k"], [m["agg"]("sum", "v", "s")], scan, num_slots=64)
        shuffled = m["ex"].ShuffleExchangeExec(partial, ["k"], NT, 512)
        final = ph.HashAggregateExec(
            "final", ["k"], [m["agg"]("sum", "v", "s")], shuffled,
            num_slots=64)
        return m["dist"].distribute_plan(final,
                                         m["dist"].DistributedConfig(NT))

    plan = _run_hand_built(arrow, build, "partitioned root")
    assert isinstance(plan, tex.CoalesceExchangeExec)
    assert tmesh.root_stage_is_replicated(plan)


# ---------------------------------------------------------------------------
# overflow retry, task count, what runs where
# ---------------------------------------------------------------------------


def test_shuffle_overflow_retry_matches_reference(monkeypatch):
    """90% of the probe rows on one key overflow the co-shuffled join's
    per-destination capacity at T = 8: both packages retry once, with the
    same widened plan, and return the same rows."""
    rng = np.random.default_rng(4)
    n = 4000
    jctx, tctx = _both(
        f=pa.table({"k": np.where(rng.random(n) < 0.9, 7,
                                  rng.integers(0, 500, n)),
                    "v": rng.normal(size=n)}),
        g=pa.table({"k": np.arange(500), "w": rng.normal(size=500)}))
    for ctx in (jctx, tctx):
        ctx.config.distributed_options.update(
            broadcast_joins=False, broadcast_threshold_rows=0)
    ran = {"j": [], "t": []}
    j_real, t_real = jmesh.execute_on_mesh, tcontext.execute_tasks
    monkeypatch.setattr(jmesh, "execute_on_mesh", lambda p, m, **kw: (
        ran["j"].append(jdist.display_staged_plan(p)) or j_real(p, m, **kw)))
    monkeypatch.setattr(tcontext, "execute_tasks", lambda p, t, **kw: (
        ran["t"].append(tdist.display_staged_plan(p)) or t_real(p, t, **kw)))
    sql = ("select f.k, sum(v * w) s from f join g on f.k = g.k "
           "group by f.k order by f.k")
    jdf, tdf = jctx.sql(sql), tctx.sql(sql)
    _assert_same_run(jdf, tdf, NT, "skewed join")
    assert tdf.last_retry_count == 1
    assert ran["t"] == ran["j"] and len(ran["t"]) == 2
    assert ran["t"][0] != ran["t"][1]


def test_every_task_runs(tpch, monkeypatch):
    """collect_distributed_table(8) loads every leaf for tasks 0..7 of 8,
    and an exchange outside a multi-task run raises."""
    loads = set()
    real = tphys.MemoryScanExec.load

    def load(self, task):
        loads.add((task.task_index, task.task_count))
        return real(self, task)

    monkeypatch.setattr(tphys.MemoryScanExec, "load", load)
    df = tpch[1].sql(_sql(TPCH_DIR, "q3"))
    df.collect_distributed_table(NT)
    assert loads == {(i, NT) for i in range(NT)}
    plan = df.distributed_plan(4)
    ex = plan.collect(lambda n: n.is_exchange)[0]
    ctx = tphys.ExecContext(task=tphys.DistributedTaskContext(0, 4),
                            inputs={})
    with pytest.raises(RuntimeError, match="outside a multi-task run"):
        ex.execute(ctx)


def test_isolated_arm_runs_once_at_eight_tasks(monkeypatch):
    from datafusion_distributed_tpu_torch.plan.fingerprint import prepare_plan

    rng = np.random.default_rng(5)
    _j, tctx = _both(t=pa.table({
        "k": rng.integers(0, 10, 512).astype(np.int32),
        "v": rng.normal(size=512)}))
    tdf = tctx.sql("select k, sum(v) as sv from t group by k "
                   "union all select -1 as k, sum(v) as sv from t")
    # the plan collect_distributed_table(8) runs: every stage at 8 tasks
    plan = tdf.distributed_plan(NT, dataclasses.replace(
        tdf._seeded_distributed_config(NT), uniform_stage_tasks=True),
        executing=True)
    (arm,) = prepare_plan(plan).plan.collect(
        lambda n: isinstance(n, tex.IsolatedArmExec))
    runs = []
    real = arm.child._execute

    def counting(ctx):
        runs.append(ctx.task.task_index)
        return real(ctx)

    monkeypatch.setattr(arm.child, "_execute", counting)
    tdf.collect_distributed_table(NT)
    assert runs == [arm.assigned_task]


def test_empty_arm_matches_reference():
    """An arm assigned to task 2 of 4 over a replicated scan: every task's
    table and recorded flags equal the reference's on a 4-device mesh (the
    assigned task's arm, the others' empty arms)."""
    rng = np.random.default_rng(8)
    arrow = pa.table({"k": rng.integers(0, 6, 200).astype(np.int32),
                      "s": rng.choice(["x", "y", "z"], 200),
                      "v": rng.normal(size=200)})
    nt = 4

    def build(m, t):
        scan = m["phys"].MemoryScanExec([t], t.schema(), replicated=True)
        agg = m["phys"].HashAggregateExec(
            "single", ["s"], [m["agg"]("sum", "v", "sv")], scan)
        return m["ex"].IsolatedArmExec(agg, 2), scan

    jarm, jscan = _hand_built("j", arrow, build)
    tarm, tscan = _hand_built("t", arrow, build)
    jt = jscan.load(jphys.DistributedTaskContext(0, nt))
    stacked = jax.tree.map(lambda x: jnp.stack([x] * nt), jt)
    names = []

    def step(s):
        ctx = jphys.ExecContext(
            task=jphys.DistributedTaskContext(0, nt),
            inputs={jscan.node_id: jax.tree.map(lambda x: x[0], s)},
            config={"mesh_axis": jmesh.AXIS, "num_tasks": nt})
        out = jarm.execute(ctx)
        names[:] = [n for n, _ in ctx.overflow_flags]
        flags = jnp.stack([f for _, f in ctx.overflow_flags])
        return jax.tree.map(lambda x: x[None], (out, flags))

    jout, jflags = jax.jit(shard_map(
        step, mesh=jmesh.make_mesh(nt), in_specs=(P(jmesh.AXIS),),
        out_specs=P(jmesh.AXIS), check_rep=False))(stacked)
    peers: list = []
    for i in range(nt):
        task = tphys.DistributedTaskContext(i, nt)
        peers.append(tphys.ExecContext(
            task=task, inputs={tscan.node_id: tscan.load(task)},
            exchange_cache={} if not peers else peers[0].exchange_cache,
            peers=peers))
    for i, ctx in enumerate(peers):
        out = tarm.execute(ctx)
        assert [n for n, _ in ctx.overflow_flags] == names, i
        assert [bool(f) for _, f in ctx.overflow_flags] == \
            list(np.asarray(jflags)[i]), i
        assert int(out.num_rows) == int(np.asarray(jout.num_rows)[i]), i
        assert out.capacity == jout.columns[0].data.shape[1], i
        for a, b in zip(jout.columns, out.columns):
            if a.dictionary is not None:
                assert list(b.dictionary.values) == list(a.dictionary.values)
            if i == 2:  # the arm: its float sums at test_rtol
                continue
            assert np.asarray(a.data)[i].tobytes() == np_of(b.data).tobytes()
            assert np.array_equal(np.asarray(a.validity)[i],
                                  np_of(b.validity))
        if i == 2:
            ref = jax.tree.map(lambda x: np.asarray(x)[i], jout)
            assert_results_equal(ref.to_numpy(), out.to_numpy(), "arm")
    assert int(peers[0].exchange_cache[("arm", tarm.node_id)][0]
               .num_rows) == 3


def test_plans_share_the_split_of_a_scan_column(tpch):
    """q1 and q6 planned for 8 tasks read the same slices of lineitem's
    l_discount: one split, shared."""
    tctx = tpch[1]
    storages = []
    for q in ("q1", "q6"):
        plan = tctx.sql(_sql(TPCH_DIR, q)).distributed_plan(NT)
        (scan,) = [n for n in plan.collect(
            lambda n: isinstance(n, tphys.MemoryScanExec))
            if "l_discount" in n.tasks[0].names]
        assert len(scan.tasks) == NT
        storages.append({
            i: t.column("l_discount").data.untyped_storage().data_ptr()
            for i, t in enumerate(scan.tasks)})
    assert storages[0] == storages[1]


@pytest.mark.parametrize("q", ["q11", "q15", "q22"])
def test_executing_plans_fingerprint_as_the_reference(tpch, q):
    """The plans collect_distributed_table(8) runs, whose scalar subqueries
    ran over 8 tasks at plan time, equal the reference's mesh plans:
    display, annotations, findings and fingerprint (a subquery's float
    value at test_rtol)."""
    jctx, tctx = tpch
    jdf, tdf = jctx.sql(_sql(TPCH_DIR, q)), tctx.sql(_sql(TPCH_DIR, q))
    jplan = jdf.distributed_plan(NT, dataclasses.replace(
        jdf._seeded_distributed_config(NT), uniform_stage_tasks=True),
        mesh=jmesh.make_mesh(NT))
    tplan = tdf.distributed_plan(NT, dataclasses.replace(
        tdf._seeded_distributed_config(NT), uniform_stage_tasks=True),
        executing=True)
    assert_staged_plans_equal(jplan, tplan, NT, q)
