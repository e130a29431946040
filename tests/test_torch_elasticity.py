"""The port's elastic membership (runtime/coordinator.py `DynamicCluster`,
the departed-peer healing, runtime/chaos.py `MembershipEvent`) against the
reference's, on the CPU.

The counterparts of tests/test_elasticity.py (its console case is left to
the console's port; its observability half is in
tests/test_torch_observability.py). Every case runs the same steps in both
packages and compares what they observe:

- `membership_snapshot()`, epochs, roles, drain accounting and the stale
  cache and health pruning equal the reference's after the same mutations;
- a small distributed aggregate (2,048 seeded rows over 4 tasks) under a
  leave, a join, a drain, and a shrink to one worker then a join: the
  result byte-identical to the same package's static run and equal to the
  reference's (floats at test_rtol()), the same fired membership kinds;
- TPC-H q3 at SF 0.002 under the reference's churn schedule (a leave at
  the first execute, a join at the fifth set_plan, a drain at the fourth
  execute): byte-identical to each package's no-churn run, the sorted
  fired kinds equal, the drained worker removed only once empty;
- quarantine and half-open recovery under the concurrent stage scheduler;
- the same seed fires the same membership events on two runs;
- after every query no surviving worker keeps a staged slice or a task.
"""

import os
import time
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.io import parquet as jparquet
from datafusion_distributed_tpu.ops import aggregate as jagg
from datafusion_distributed_tpu.plan import physical as jphys
from datafusion_distributed_tpu.planner import distributed as jdist
from datafusion_distributed_tpu.runtime import chaos as jchaos
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import errors as jerrors
from datafusion_distributed_tpu.runtime import health as jhealth
from datafusion_distributed_tpu.runtime import worker as jworker
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.io import parquet as tparquet
from datafusion_distributed_tpu_torch.ops import aggregate as tagg
from datafusion_distributed_tpu_torch.plan import physical as tphys
from datafusion_distributed_tpu_torch.planner import distributed as tdist
from datafusion_distributed_tpu_torch.runtime import chaos as tchaos
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import errors as terrors
from datafusion_distributed_tpu_torch.runtime import health as thealth
from datafusion_distributed_tpu_torch.runtime import worker as tworker
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_results_equal, identical

torch.set_num_threads(1)

REF = SimpleNamespace(
    name="reference", coordinator=jcoord, chaos=jchaos, errors=jerrors,
    health=jhealth, worker=jworker, parquet=jparquet, agg=jagg,
    physical=jphys, dist=jdist, device={},
)
PORT = SimpleNamespace(
    name="port", coordinator=tcoord, chaos=tchaos, errors=terrors,
    health=thealth, worker=tworker, parquet=tparquet, agg=tagg,
    physical=tphys, dist=tdist, device={"device": "cpu"},
)
PKGS = (REF, PORT)

SEED = 20260803
FAST = {"task_retry_backoff_s": 0.001, "quarantine_seconds": 0.05}
TPCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "queries", "tpch")


def _sql(q: str) -> str:
    with open(os.path.join(TPCH_DIR, f"{q}.sql")) as f:
        return f.read()


def _table(p, arrow):
    return p.parquet.arrow_to_table(arrow, **p.device)


def _plan(p, n=2048, num_tasks=4):
    """tests/test_elasticity.py's plan: a GROUP BY over 2,048 seeded rows,
    distributed over ``num_tasks``."""
    rng = np.random.default_rng(3)
    t = _table(p, pa.table({"k": rng.integers(0, 16, n),
                            "v": rng.normal(size=n)}))
    scan = p.physical.MemoryScanExec([t], t.schema())
    agg = p.physical.HashAggregateExec(
        "single", ["k"], [p.agg.AggSpec("sum", "v", "sv")], scan, 32)
    return p.dist.distribute_plan(agg,
                                  p.dist.DistributedConfig(num_tasks=num_tasks))


def _coord(p, cluster, **opts):
    return p.coordinator.Coordinator(resolver=cluster, channels=cluster,
                                     config_options={**FAST, **opts})


def _assert_no_leaks(cluster):
    for url, w in cluster.workers.items():
        assert not w.table_store.tables, f"{url} leaked staged tables"
        assert len(w.registry) == 0, f"{url} leaked task entries"


def _run(p, cluster, **opts):
    return _coord(p, cluster, **opts).execute(_plan(p)).to_numpy()


def _both_equal(outs, what):
    """Each package's churned result byte-identical to its static run, and
    the two packages' results equal."""
    for (base, got), p in zip(outs, PKGS):
        assert identical(base, got), f"{what}: {p.name} diverged"
    assert_results_equal(outs[0][1], outs[1][1], what)


# ---------------------------------------------------------------------------
# DynamicCluster unit semantics
# ---------------------------------------------------------------------------


def test_membership_epoch_and_roles():
    seen = []
    for p in PKGS:
        cluster = p.coordinator.DynamicCluster(2)
        e0 = cluster.membership_epoch
        obs = [e0, sorted(cluster.get_urls())]
        w = cluster.add_worker("mem://w-new")
        assert w.peer_channels is cluster
        obs += [cluster.membership_epoch, w.url in cluster.get_urls()]
        cluster.drain_worker("mem://worker-0")
        obs += [cluster.membership_epoch, cluster.get_urls(),
                cluster.get_worker("mem://worker-0").url]
        cluster.remove_worker("mem://worker-1")
        with pytest.raises(p.errors.WorkerUnavailableError) as ei:
            cluster.get_worker("mem://worker-1")
        assert p.errors.is_retryable(ei.value)
        obs += [cluster.membership_epoch, str(ei.value),
                cluster.membership_snapshot()]
        seen.append(obs)
    assert seen[1] == seen[0]
    assert seen[0][-1] == {"epoch": 5, "active": ["mem://w-new"],
                           "draining": ["mem://worker-0"],
                           "departed": ["mem://worker-1"]}


def _stage_one_task(p, cluster):
    rng = np.random.default_rng(0)
    t = _table(p, pa.table({"x": rng.integers(0, 9, 64)}))
    c = p.coordinator.Coordinator(resolver=cluster, channels=cluster)
    c._dispatch_task(p.physical.MemoryScanExec([t], t.schema()), "q", 0, 0, 1)


def test_drained_worker_removed_only_when_empty():
    seen = []
    for p in PKGS:
        cluster = p.coordinator.DynamicCluster(2)
        url = "mem://worker-0"
        w = cluster.get_worker(url)
        _stage_one_task(p, cluster)
        cluster.drain_worker(url)
        obs = [cluster.is_drained(url), cluster.finish_drains(),
               cluster.in_flight(url)]
        w.registry.invalidate(p.worker.TaskKey("q", 0, 0))
        obs += [cluster.in_flight(url), cluster.is_drained(url),
                cluster.finish_drains()]
        with pytest.raises(p.errors.WorkerUnavailableError):
            cluster.get_worker(url)
        obs.append(cluster.membership_snapshot())
        seen.append(obs)
    assert seen[1] == seen[0]
    assert seen[0][:6] == [False, [], 1, 0, True, ["mem://worker-0"]]


def test_registry_clear_releases_shipped_slices():
    """An abrupt leave releases the departing worker's registry and staged
    tables through the store's release path (budget counters fall)."""
    seen = []
    for p in PKGS:
        cluster = p.coordinator.DynamicCluster(1)
        url = cluster.get_urls()[0]
        w = cluster.get_worker(url)
        _stage_one_task(p, cluster)
        obs = [len(w.table_store.tables), len(w.registry)]
        cluster.remove_worker(url)
        obs += [len(w.table_store.tables), len(w.registry),
                w.table_store.nbytes()]
        seen.append(obs)
    assert seen[1] == seen[0]
    assert seen[0][0] >= 1 and seen[0][1] == 1 and seen[0][2:] == [0, 0, 0]


class _PlainWorker:
    """Duck-typed worker WITHOUT the partition-stream surface."""

    def __init__(self, url):
        self.url = url


def test_peer_capable_cache_keyed_on_membership_mutation():
    seen = []
    for p in PKGS:
        cluster = p.coordinator.InMemoryCluster(2)
        coord = _coord(p, cluster)
        obs = [coord._workers_peer_capable()]
        cluster.workers["mem://plain"] = _PlainWorker("mem://plain")
        obs.append(coord._workers_peer_capable())
        del cluster.workers["mem://plain"]
        obs.append(coord._workers_peer_capable())
        seen.append(obs)
    assert seen[0] == seen[1] == [True, False, True]


def test_peer_capable_cache_keyed_on_epoch():
    seen = []
    for p in PKGS:
        cluster = p.coordinator.DynamicCluster(2)
        coord = _coord(p, cluster)
        obs = [coord._workers_peer_capable()]
        late = p.worker.Worker("mem://w-late")
        cluster.add_worker(late)
        late.peer_channels = None  # joined un-wired: pulls would fail
        obs.append(coord._workers_peer_capable())
        cluster.remove_worker("mem://w-late")
        obs.append(coord._workers_peer_capable())
        seen.append(obs)
    assert seen[0] == seen[1] == [True, False, True]


def test_excluded_set_pruned_of_departed_urls():
    seen = []
    for p in PKGS:
        cluster = p.coordinator.DynamicCluster(3)
        urls = cluster.get_urls()
        coord = _coord(p, cluster)
        excluded = {urls[0], urls[1]}
        cluster.remove_worker(urls[0])
        obs = [coord._routable_urls(excluded), sorted(excluded)]
        excluded = {urls[1], urls[2]}
        obs.append(sorted(coord._routable_urls(excluded)))
        seen.append(obs)
    assert seen[1] == seen[0]
    assert seen[0] == [["mem://worker-2"], ["mem://worker-1"],
                       ["mem://worker-1", "mem://worker-2"]]


def test_health_state_pruned_on_departure():
    seen = []
    for p in PKGS:
        cluster = p.coordinator.DynamicCluster(3)
        urls = cluster.get_urls()
        coord = _coord(p, cluster, quarantine_threshold=1)
        coord._health_tracker()
        for _ in range(3):
            coord._record_worker_failure(urls[0])
        obs = [coord.health.state_of(urls[0])]
        cluster.remove_worker(urls[0])
        coord._routable_urls()  # membership observed -> prune
        obs += [urls[0] in coord.health.snapshot(),
                coord.faults.get("health_entries_pruned")]
        t = p.health.HealthTracker(p.health.HealthPolicy(failure_threshold=1))
        t.record_failure("a")
        t.record_failure("b")
        obs += [t.prune(["b"]), t.forget("b"), t.forget("b"), t.snapshot()]
        seen.append(obs)
    assert seen[1] == seen[0]
    assert seen[0][0] == jhealth.OPEN and seen[0][1] is False
    assert seen[0][2] >= 1


# ---------------------------------------------------------------------------
# mid-query churn: leave / join / drain
# ---------------------------------------------------------------------------


def _churned(p, events, **opts):
    """(static result, churned result, fired kinds, coordinator, cluster)."""
    base = _run(p, p.coordinator.InMemoryCluster(3))
    cluster = p.coordinator.DynamicCluster(3)
    chaos = p.chaos.wrap_cluster(cluster, p.chaos.FaultPlan(
        SEED, [], membership=events(p, cluster.get_urls())))
    coord = _coord(p, chaos, **opts)
    got = coord.execute(_plan(p)).to_numpy()
    kinds = [f["kind"] for f in chaos.plan.fired]
    return base, got, kinds, coord, cluster


def test_leave_mid_query_reroutes_and_heals_peer_producers():
    """A worker holding staged slices and shipped peer producers leaves at
    the first execute: its producers are re-shipped onto survivors, the
    consumers' pull specs rewritten, the result byte-identical."""
    outs = []
    for p in PKGS:
        base, got, kinds, coord, cluster = _churned(p, lambda p, urls: [
            p.chaos.MembershipEvent("leave", urls[0], site="execute",
                                    nth_call=0)])
        assert kinds == ["membership_leave"]
        assert coord.faults.get("peer_producers_reshipped") >= 1, (
            p.name, coord.faults.as_dict())
        assert "mem://worker-0" not in cluster.get_urls()
        _assert_no_leaks(cluster)
        outs.append((base, got))
    _both_equal(outs, "leave")


def _counting(p):
    class CountingWorker(p.worker.Worker):
        """Worker recording every task key it is given."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seen_keys: list = []

        def set_plan(self, key, plan_obj, task_count, **kw):
            self.seen_keys.append(key)
            return super().set_plan(key, plan_obj, task_count, **kw)

    return CountingWorker


def test_join_mid_query_receives_later_stage_tasks():
    outs = []
    for p in PKGS:
        base = _run(p, p.coordinator.InMemoryCluster(3))
        cls = _counting(p)
        cluster = p.coordinator.DynamicCluster(
            3, worker_factory=lambda url, cls=cls: cls(url))
        chaos = p.chaos.wrap_cluster(cluster, p.chaos.FaultPlan(
            SEED, [], membership=[p.chaos.MembershipEvent(
                "join", "mem://joiner", site="set_plan", nth_call=0)]))
        dplan = _plan(p)
        got = _coord(p, chaos).execute(dplan).to_numpy()
        joiner = cluster.get_worker("mem://joiner")
        qid = dplan._last_query_id
        assert [k for k in joiner.seen_keys
                if k.query_id == qid and k.stage_id >= 1], (
            p.name, joiner.seen_keys)
        _assert_no_leaks(cluster)
        outs.append((base, got))
    _both_equal(outs, "join")


def test_drain_mid_query_finishes_inflight_then_removes():
    outs = []
    for p in PKGS:
        base, got, kinds, _coord_, cluster = _churned(p, lambda p, urls: [
            p.chaos.MembershipEvent("drain", urls[2], site="execute",
                                    nth_call=0)])
        victim = "mem://worker-2"
        assert kinds == ["membership_drain"]
        assert victim not in cluster.get_urls()
        assert victim in cluster.membership_snapshot()["draining"]
        assert cluster.wait_drained(victim, timeout_s=10.0), (
            p.name, cluster.in_flight(victim))
        assert victim in cluster.membership_snapshot()["departed"]
        _assert_no_leaks(cluster)
        outs.append((base, got))
    _both_equal(outs, "drain")


def test_shrink_below_excluded_then_rejoin():
    outs = []
    for p in PKGS:
        base, got, kinds, _coord_, cluster = _churned(p, lambda p, urls: [
            p.chaos.MembershipEvent("leave", urls[1], site="execute",
                                    nth_call=0),
            p.chaos.MembershipEvent("leave", urls[2], site="execute",
                                    nth_call=1),
            p.chaos.MembershipEvent("join", "mem://fresh", site="execute",
                                    nth_call=2),
        ], max_task_retries=6)
        assert sorted(cluster.get_urls()) == ["mem://fresh",
                                              "mem://worker-0"]
        _assert_no_leaks(cluster)
        outs.append((base, got))
    _both_equal(outs, "shrink")


def test_membership_schedule_deterministic_seed():
    """The same seed fires the same membership event set on independent
    runs, in both packages, with byte-identical results."""
    outs = []
    for p in PKGS:
        runs = []
        for _ in range(2):
            cluster = p.coordinator.DynamicCluster(3)
            chaos = p.chaos.wrap_cluster(cluster, p.chaos.FaultPlan(
                SEED, [], membership=_churn_schedule(p, cluster.get_urls())))
            out = _coord(p, chaos, max_task_retries=6).execute(_plan(p))
            runs.append((out.to_numpy(),
                         sorted(f["kind"] for f in chaos.plan.fired)))
        assert identical(runs[0][0], runs[1][0]), p.name
        assert runs[0][1] == runs[1][1] == [
            "membership_drain", "membership_join", "membership_leave"]
        outs.append(runs[0][0])
    assert_results_equal(outs[0], outs[1], "deterministic seed")


# ---------------------------------------------------------------------------
# TPC-H under seeded membership churn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_ctxs():
    arrow = gen_tpch(sf=0.002, seed=7)
    out = {}
    for p, ctx in ((REF, JContext()), (PORT, TContext(device="cpu"))):
        ctx.config.distributed_options["bytes_per_task"] = 1
        ctx.config.distributed_options["broadcast_joins"] = False
        for name, tbl in arrow.items():
            ctx.register_arrow(name, tbl)
        out[p.name] = ctx
    return out


def _run_tpch(p, ctx, sql, cluster, coord=None, **opts):
    coord = coord or _coord(p, cluster, **opts)
    df = ctx.sql(sql)
    out = df._strip_quals(df.collect_coordinated_table(
        coordinator=coord, num_tasks=4)).to_numpy()
    return out, coord


def _churn_schedule(p, urls):
    """The reference's leave + join + drain schedule."""
    return [
        p.chaos.MembershipEvent("leave", urls[1], site="execute",
                                nth_call=0),
        p.chaos.MembershipEvent("join", "mem://joiner-0", site="set_plan",
                                nth_call=4),
        p.chaos.MembershipEvent("drain", urls[2], site="execute",
                                nth_call=3),
    ]


def test_tpch_membership_churn_parity(tpch_ctxs):
    sql = _sql("q3")
    outs = []
    for p in PKGS:
        ctx = tpch_ctxs[p.name]
        base, _ = _run_tpch(p, ctx, sql, p.coordinator.InMemoryCluster(3))
        cluster = p.coordinator.DynamicCluster(3)
        urls = cluster.get_urls()
        chaos = p.chaos.wrap_cluster(cluster, p.chaos.FaultPlan(
            SEED, [], membership=_churn_schedule(p, urls)))
        got, _c = _run_tpch(p, ctx, sql, chaos, max_task_retries=6)
        kinds = sorted(f["kind"] for f in chaos.plan.fired)
        assert kinds == ["membership_drain", "membership_join",
                         "membership_leave"], (p.name, kinds)
        assert cluster.wait_drained(urls[2], timeout_s=10.0)
        assert urls[1] not in cluster.get_urls()
        assert "mem://joiner-0" in cluster.get_urls()
        _assert_no_leaks(cluster)
        outs.append((base, got))
    _both_equal(outs, "q3 churn")


def test_quarantine_half_open_recovery_concurrent_scheduler(tpch_ctxs):
    """A crash quarantines a worker under the concurrent stage scheduler;
    once the quarantine elapses a successful probe closes its circuit;
    results equal throughout, in both packages."""
    sql = _sql("q3")
    outs = []
    for p in PKGS:
        ctx = tpch_ctxs[p.name]
        base, _ = _run_tpch(p, ctx, sql, p.coordinator.InMemoryCluster(3),
                            stage_parallelism=4)
        cluster = p.coordinator.InMemoryCluster(3)
        bad = cluster.get_urls()[0]
        fault = p.chaos.FaultPlan(SEED, [p.chaos.FaultSpec(
            site="execute", kind="crash", rate=1.0, workers=[bad],
            max_total=1)])
        got, coord = _run_tpch(p, ctx, sql,
                               p.chaos.wrap_cluster(cluster, fault),
                               stage_parallelism=4, quarantine_threshold=1,
                               quarantine_seconds=0.05, max_task_retries=4)
        assert identical(base, got), p.name
        assert coord.faults.get("workers_quarantined") == 1
        time.sleep(0.1)  # quarantine elapses -> next dispatch is the probe
        got2, _c = _run_tpch(p, ctx, sql, None, coord=coord)
        assert identical(base, got2), p.name
        assert coord.health.state_of(bad) == p.health.CLOSED, p.name
        _assert_no_leaks(cluster)
        outs.append(base)
    assert_results_equal(outs[0], outs[1], "q3 quarantine")
