"""The port's result and sub-plan cache (runtime/result_cache.py,
plan/fingerprint.py `result_cache_key`, `SET distributed.result_cache`)
against the reference's, on the CPU.

- `DataFrame._result_cache_key(4)` equal to the reference's for all 22
  TPC-H queries at SF 0.002, seed 7, with literal hoisting on and off
  (the staged plan's fingerprint, its hoisted literals, the PlannerConfig
  snapshot, the catalog generation and the task count);
- the cache alone: hit, miss, fill, a failed owner releasing its flight,
  a single-flight stampede (one fill; every waiter gets the filled table
  itself), generation invalidation, and a budget that spills the coldest
  entry instead of evicting it and refaults it byte for byte;
- through the session: a hit returns the cold run's table (the same
  tensors); literal variants of q6 each get their own entry and are never
  served another's rows; a PlannerConfig change misses; `register_table`
  drops every entry; a second query sharing an exchange prefix restores
  it from the sub-plan tier;
- TPC-H q1, q3, q5 with the cache on byte-identical to the cache off, and
  equal to the reference's coordinated result;
- through the serving tier: a stampede of identical submissions executes
  once, and a cache hit reserves no admission budget.
"""

import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.plan import fingerprint as jfp
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
from datafusion_distributed_tpu_torch.plan import fingerprint as tfp
from datafusion_distributed_tpu_torch.runtime.coordinator import (
    Coordinator,
    InMemoryCluster,
)
from datafusion_distributed_tpu_torch.runtime.result_cache import ResultCache
from datafusion_distributed_tpu_torch.runtime.serving import ServingSession
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from datafusion_distributed_tpu_torch import precision as tprec
from tests.torch_port_helpers import (
    assert_results_equal,
    identical,
    mask_subquery_floats,
)

torch.set_num_threads(1)

import os  # noqa: E402

TPCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "queries", "tpch")
TPCH = [f"q{i}" for i in range(1, 23)]
Q6_TPL = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1995-01-01'
  and l_discount between {lo} and {hi}
  and l_quantity < 24
"""


def _sql(q: str) -> str:
    with open(os.path.join(TPCH_DIR, f"{q}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def arrow():
    return gen_tpch(sf=0.002, seed=7)


def _ctx(arrow, cache: bool, module=None, **opts):
    ctx = JContext() if module == "ref" else TContext(device="cpu")
    ctx.config.distributed_options.update(
        bytes_per_task=1, task_retry_backoff_s=0.001, **opts)
    if cache:
        ctx.config.distributed_options["result_cache"] = True
    for name, tbl in arrow.items():
        ctx.register_arrow(name, tbl)
    return ctx


@pytest.fixture(scope="module")
def pair(arrow):
    return _ctx(arrow, False, "ref"), _ctx(arrow, False)


@pytest.fixture(scope="module")
def cached(arrow):
    return _ctx(arrow, True)


def _run(ctx, sql, cluster, **opts):
    coord = Coordinator(resolver=cluster, channels=cluster,
                        config_options={**ctx.config.distributed_snapshot(),
                                        **opts})
    return ctx.sql(sql).collect_coordinated_table(coordinator=coord,
                                                  num_tasks=4)


def _table(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return arrow_to_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.random(n)),
    }), device="cpu")


def _same_bytes(a, b) -> bool:
    return (a.names == b.names and int(a.num_rows) == int(b.num_rows)
            and all(ca.data.numpy().tobytes() == cb.data.numpy().tobytes()
                    for ca, cb in zip(a.columns, b.columns)))


# ---------------------------------------------------------------------------
# result_cache_key against the reference
# ---------------------------------------------------------------------------


def _keyed_plan(ctx, q):
    """The staged plan `_result_cache_key(4)` fingerprints, prepared."""
    df = ctx.sql(_sql(q))
    return df.distributed_plan(4, df._seeded_host_config(4),
                               ctx.config.planner)


@pytest.mark.parametrize("q", TPCH)
def test_result_cache_key_equals_reference(pair, q):
    """Equal keys; where a plan embeds a resolved float scalar subquery
    (q22's average balance) the two packages sum it in other orders, so
    that value agrees at test_rtol() and the fingerprints are compared
    with it masked, as the staged-plan tests compare them."""
    jctx, tctx = pair
    try:
        for hoist in (True, False):
            jfp.set_literal_hoisting(hoist)
            tfp.set_literal_hoisting(hoist)
            jkey = jctx.sql(_sql(q))._result_cache_key(4)
            tkey = tctx.sql(_sql(q))._result_cache_key(4)
            assert jkey is not None and tkey is not None, q
            assert tkey[0] == jkey[0] and tkey[2:] == jkey[2:], (q, hoist)
            if tkey[1] != jkey[1]:
                jf, tf = [], []
                jcanon = jfp._canon_plan(
                    jfp.prepare_plan(_keyed_plan(jctx, q)).plan)
                tcanon = tfp._canon_plan(
                    tfp.prepare_plan(_keyed_plan(tctx, q)).plan)
                assert (mask_subquery_floats(tcanon, tf)
                        == mask_subquery_floats(jcanon, jf)), (q, hoist)
                assert tf and np.allclose(tf, jf, rtol=tprec.test_rtol()), q
            if hoist and q in ("q1", "q6"):
                assert jkey[2] or jkey[3], "q1 and q6 hoist literals"
    finally:
        jfp.set_literal_hoisting(True)
        tfp.set_literal_hoisting(True)


# ---------------------------------------------------------------------------
# the cache alone
# ---------------------------------------------------------------------------


def test_unit_hit_miss_fill():
    rc = ResultCache()
    t = _table(256, 0)
    state, got = rc.begin(("k1",))
    assert state == "miss" and got is None
    rc.fill(("k1",), t)
    state, got = rc.begin(("k1",))
    assert state == "hit" and got is t  # by reference: the same buffers
    assert rc.lookup(("k2",)) is None
    st = rc.stats()
    assert (st["hits"], st["misses"], st["fills"]) == (1, 1, 1)
    assert st["hit_rate"] == 0.5
    names = {name for name, _fam in rc.telemetry_families()}
    assert "dftpu_result_cache_hits" in names
    assert rc.clear() == 1 and rc.stats()["entries"] == 0


def test_unit_fail_releases_flight():
    rc = ResultCache()
    assert rc.begin(("k",))[0] == "miss"
    rc.fail(("k",))  # the owner failed: the key can be claimed again
    assert rc.begin(("k",))[0] == "miss"
    rc.fill(("k",), _table(16, 1))
    assert rc.lookup(("k",)) is not None
    rc.clear()


def test_unit_budget_spills_coldest_and_refaults_byte_exact():
    from datafusion_distributed_tpu_torch.runtime.tracing import table_nbytes

    t1, t2, t3 = _table(4096, 1), _table(4096, 2), _table(4096, 3)
    per = table_nbytes(t1)
    rc = ResultCache()
    rc.sync(generation=0, budget_bytes=int(per * 2.5))
    for key, t in ((("k1",), t1), (("k2",), t2)):
        assert rc.begin(key)[0] == "miss"
        rc.fill(key, t)
    assert rc.lookup(("k1",)) is t1  # touch: k2 becomes the coldest
    assert rc.begin(("k3",))[0] == "miss"
    rc.fill(("k3",), t3)
    st = rc.stats()
    assert st["spills"] == 1 and st["spilled_nbytes"] == per, st
    assert st["spill_files"] == 1 and st["entries"] == 3
    r0 = st["refaults"]
    assert rc.lookup(("k1",)) is t1 and rc.stats()["refaults"] == r0
    back = rc.lookup(("k2",))  # the spilled victim refaults
    assert back is not t2 and _same_bytes(back, t2)
    assert back.capacity == t2.capacity and back.device == t2.device
    assert rc.stats()["refaults"] == r0 + 1
    rc.clear()
    st = rc.stats()
    assert st["entries"] == 0 and st["spill_files"] == 0, st


def test_unit_single_flight_stampede():
    rc = ResultCache()
    t = _table(64, 4)
    ready = threading.Barrier(9)
    results: list = []

    def owner():
        assert rc.begin(("k",))[0] == "miss"
        ready.wait()
        rc.fill(("k",), t)

    def waiter():
        ready.wait()
        results.append(rc.begin(("k",)))

    threads = [threading.Thread(target=owner)] + [
        threading.Thread(target=waiter) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(results) == 8
    assert all(s == "hit" and g is t for s, g in results)
    assert rc.stats()["fills"] == 1 and rc.stats()["misses"] == 1
    rc.clear()


def test_unit_generation_invalidation():
    rc = ResultCache()
    rc.sync(generation=1)
    rc.begin(("k",))
    rc.fill(("k",), _table(32, 5))
    assert rc.invalidate_generation(2) == 1
    assert rc.lookup(("k",)) is None
    st = rc.stats()
    assert st["invalidations"] == 1 and st["entries"] == 0
    assert rc.invalidate_generation(2) == 0  # same generation: no-op


# ---------------------------------------------------------------------------
# through the session
# ---------------------------------------------------------------------------


def test_hit_returns_the_cold_runs_tensors(cached):
    sql = Q6_TPL.format(lo=0.05, hi=0.07)
    cold = _run(cached, sql, InMemoryCluster(2))
    st0 = cached.result_cache().stats()
    warm = _run(cached, sql, InMemoryCluster(2))
    assert warm is cold
    assert all(a.data is b.data for a, b in zip(warm.columns, cold.columns))
    st1 = cached.result_cache().stats()
    assert st1["hits"] == st0["hits"] + 1 and st1["fills"] == st0["fills"]


def test_literal_variants_get_their_own_entries(cached, pair):
    jctx = pair[0]
    results = {}
    for lo, hi in ((0.02, 0.04), (0.05, 0.07), (0.06, 0.08)):
        results[(lo, hi)] = _run(cached, Q6_TPL.format(lo=lo, hi=hi),
                                 InMemoryCluster(2)).to_numpy()
    for (lo, hi), first in results.items():
        again = _run(cached, Q6_TPL.format(lo=lo, hi=hi),
                     InMemoryCluster(2)).to_numpy()
        assert identical(again, first), (lo, hi)
        ref = jctx.sql(Q6_TPL.format(lo=lo, hi=hi)).collect_table()
        assert_results_equal(ref.to_numpy(), first, f"variant {lo}")
    revenues = [v["revenue"][0] for v in results.values()]
    assert len(set(revenues)) == 3, revenues


def test_planner_config_snapshot_keys_the_cache(cached):
    sql = Q6_TPL.format(lo=0.03, hi=0.05)
    base = _run(cached, sql, InMemoryCluster(2)).to_numpy()
    fills0 = cached.result_cache().stats()["fills"]
    prev = cached.config.planner.agg_slot_factor
    cached.config.planner.agg_slot_factor = prev * 2
    try:
        got = _run(cached, sql, InMemoryCluster(2)).to_numpy()
    finally:
        cached.config.planner.agg_slot_factor = prev
    assert cached.result_cache().stats()["fills"] == fills0 + 1
    assert identical(got, base)
    h0 = cached.result_cache().stats()["hits"]
    _run(cached, sql, InMemoryCluster(2))
    assert cached.result_cache().stats()["hits"] == h0 + 1


def test_register_table_invalidates_no_stale_reads():
    ctx = TContext(device="cpu")
    ctx.config.distributed_options.update(bytes_per_task=1,
                                          result_cache=True)
    n = 512
    keys = pa.array((np.arange(n) % 7).astype(np.int64))
    ctx.register_arrow("t", pa.table({"k": keys, "v": pa.array(np.ones(n))}))
    sql = "select k, sum(v) as s from t group by k order by k"
    first = _run(ctx, sql, InMemoryCluster(2)).to_numpy()
    assert float(first["s"].sum()) == float(n)
    _run(ctx, sql, InMemoryCluster(2))  # a hit
    inv0 = ctx.result_cache().stats()["invalidations"]
    ctx.register_arrow("t", pa.table({"k": keys,
                                      "v": pa.array(np.full(n, 2.0))}))
    st = ctx.result_cache().stats()
    assert st["invalidations"] > inv0
    assert st["entries"] == 0 and st["subplan_entries"] == 0
    second = _run(ctx, sql, InMemoryCluster(2)).to_numpy()
    assert float(second["s"].sum()) == float(2 * n)


def test_subplan_prefix_reuse_across_distinct_queries():
    ctx = TContext(device="cpu")
    ctx.config.distributed_options.update(
        bytes_per_task=1, result_cache=True, size_tasks_to_data=False,
        pipelined_shuffle=False)
    n = 50_000
    rng = np.random.default_rng(3)
    ctx.register_arrow("t", pa.table({
        "k": pa.array((np.arange(n) % 97).astype(np.int64)),
        "v": pa.array(rng.random(n)),
    }))
    asc = _run(ctx, "select k, sum(v) as s from t group by k order by k",
               InMemoryCluster(2)).to_numpy()
    st = ctx.result_cache().stats()
    assert st["subplan_fills"] >= 1, st
    desc = _run(ctx, "select k, sum(v) as s from t group by k "
                     "order by k desc", InMemoryCluster(2)).to_numpy()
    st = ctx.result_cache().stats()
    assert st["subplan_hits"] >= 1, st
    for col in ("k", "s"):
        assert asc[col].tobytes() == desc[col][::-1].tobytes()


@pytest.mark.parametrize("q", ["q1", "q3", "q5"])
def test_tpch_cache_on_equals_off(arrow, pair, q):
    jctx = pair[0]
    off = _ctx(arrow, False)
    base = _run(off, _sql(q), InMemoryCluster(4),
                stage_parallelism=4).to_numpy()
    on = _ctx(arrow, True)
    cold = _run(on, _sql(q), InMemoryCluster(4), stage_parallelism=4)
    warm = _run(on, _sql(q), InMemoryCluster(4), stage_parallelism=4)
    assert identical(cold.to_numpy(), base), q
    assert warm is cold, q
    assert on.result_cache().stats()["hits"] >= 1
    jcl = jcoord.InMemoryCluster(4)
    ref = jctx.sql(_sql(q)).collect_coordinated_table(
        coordinator=jcoord.Coordinator(
            resolver=jcl, channels=jcl,
            config_options=jctx.config.distributed_snapshot()),
        num_tasks=4)
    assert_results_equal(ref.to_numpy(), base, q)


# ---------------------------------------------------------------------------
# through the serving tier
# ---------------------------------------------------------------------------


def test_serving_stampede_executes_once(arrow):
    ctx = _ctx(arrow, True)
    sql = Q6_TPL.format(lo=0.05, hi=0.07)
    results: list = []
    errors: list = []
    with ServingSession(ctx, num_workers=4, num_tasks=4,
                        max_concurrent_queries=8) as srv:
        start = threading.Barrier(8)

        def client():
            try:
                start.wait()
                results.append(srv.submit(sql).result_table(timeout=120))
            except BaseException as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors, errors
        st = srv.stats()["result_cache"]
    assert st["fills"] == 1, st
    assert len(results) == 8 and all(r is results[0] for r in results)


def test_serving_fast_path_skips_admission_charge(arrow):
    ctx = _ctx(arrow, True)
    sql = Q6_TPL.format(lo=0.05, hi=0.07)
    with ServingSession(ctx, num_workers=2, num_tasks=4) as srv:
        cold = srv.submit(sql).result_table(timeout=120)
        h = srv.submit(sql)
        assert h.done() and h._cache_hit and h.est_bytes == 0
        assert h.result_table(timeout=1) is cold
        st = srv.stats()
        assert st["in_use_bytes"] == 0 and st["queued_bytes"] == 0
        assert st["result_cache"]["hits"] >= 1
        assert "dftpu_result_cache_hits" in srv.telemetry.snapshot()
