"""The port's serving tier (runtime/serving.py: ServingSession, QueryHandle,
GlobalStageScheduler) against the reference's, on the CPU.

TPC-H at SF 0.002, seed 7, over in-memory workers (`bytes_per_task = 1`
and no broadcast joins, as tests/test_serving.py sets them):

- handle lifecycle, cancel (queued and running), admission by footprint
  budget and by count, priority classes, `close` with a backlog (graceful
  and cancelling), the per-query stage budget under the global pool;
- the scheduler's pick order equal to the reference GlobalStageScheduler's
  on the same synthetic jobs, state and seed (fair share and FIFO), and
  the stride rule live (a cheap query overtakes a heavy one);
- concurrent mixed queries from client threads byte-identical to the
  port's sequential coordinated runs and equal to the reference's
  sequential coordinated results (ints, strings, order exact; floats at
  test_rtol());
- `PreparedStatement.submit` equal to the binding's `execute()` in both
  packages;
- every serving knob validated at SET time as the reference validates it
  (the same error message);
- chaos (runtime/chaos.py): a query-scoped crash schedule under
  concurrent queries, and the transport, straggler, corrupt_plan and skew
  kinds firing at the same calls as the reference's with the same result
  (or, for a corrupted plan, the same fatal error);
- after every test no worker keeps a staged slice or a task entry.
"""

import threading
import time

import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.runtime import chaos as jchaos
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import serving as jserving
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.runtime import chaos as tchaos
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import serving as tserving
from datafusion_distributed_tpu_torch.runtime.coordinator import (
    Coordinator,
    InMemoryCluster,
)
from datafusion_distributed_tpu_torch.runtime.errors import (
    TaskCancelledError,
)
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_results_equal, identical

torch.set_num_threads(1)

import os  # noqa: E402

TPCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "queries", "tpch")


def _sql(q: str) -> str:
    with open(os.path.join(TPCH_DIR, f"{q}.sql")) as f:
        return f.read()


MIX = ("q1", "q3", "q6")
OPTS = {"bytes_per_task": 1, "broadcast_joins": False,
        "task_retry_backoff_s": 0.001}
Q6_TEMPLATE = (_sql("q6").replace("< 24", "< $qty")
               .replace("between 0.05 and 0.07",
                        "between $lo and $hi"))


@pytest.fixture(scope="module")
def env():
    arrow = gen_tpch(sf=0.002, seed=7)
    jctx, tctx = JContext(), TContext(device="cpu")
    for ctx in (jctx, tctx):
        ctx.config.distributed_options.update(OPTS)
        for name, tbl in arrow.items():
            ctx.register_arrow(name, tbl)
    return jctx, tctx


@pytest.fixture(scope="module")
def sequential(env):
    """The port's sequential coordinated result of each MIX query."""
    tctx = env[1]
    return {q: _coordinated(tctx, InMemoryCluster(4), q) for q in MIX}


def _coordinated(ctx, cluster, q, module=None, num_tasks=4):
    """``q`` through a fresh coordinator (the port's, or ``module``'s) over
    ``cluster`` -> numpy result."""
    cls = module.Coordinator if module is not None else Coordinator
    coord = cls(resolver=cluster, channels=cluster,
                config_options=ctx.config.distributed_snapshot())
    return ctx.sql(_sql(q)).collect_coordinated_table(
        coordinator=coord, num_tasks=num_tasks).to_numpy()


def _assert_no_leaks(cluster):
    for w in cluster.workers.values():
        assert not w.table_store.tables, f"{w.url} leaked staged tables"
        assert len(w.registry) == 0, f"{w.url} leaked task entries"
        assert w.table_store.stats()["spill_files"] == 0, w.url


def _delay_cluster(workers=4, delay_s=0.05):
    """In-memory workers behind a uniform injected execute delay, so
    admission and scheduling effects show on a small input."""
    return tchaos.wrap_cluster(InMemoryCluster(workers), tchaos.FaultPlan(
        11, [tchaos.FaultSpec(site="execute", kind="delay", delay_s=delay_s,
                              rate=1.0)], query_scoped=True))


# ---------------------------------------------------------------------------
# the async frontend
# ---------------------------------------------------------------------------


def test_handle_lifecycle(env, sequential):
    tctx = env[1]
    with tserving.ServingSession(tctx, num_workers=4, num_tasks=4) as srv:
        h = srv.submit(_sql("q6"))
        out = h.result_table(timeout=120)
        assert h.status() == tserving.DONE and h.done()
        assert h.wall_s() is not None and h.queue_wait_s() is not None
        detail = h.status(detail=True)
        assert detail["state"] == "done" and detail["est_bytes"] > 0
        assert detail["peak_staged_bytes"] > 0
        assert identical(out.to_numpy(), sequential["q6"])
        assert h.result(timeout=1).num_rows == 1  # pyarrow, names stripped
        h2 = srv.submit(_sql("q6"))
        h2.result_table(timeout=120)
        assert h.query_id != h2.query_id
        stats = srv.stats()
        assert stats["completed"]["done"] == 2 and stats["active"] == 0
    _assert_no_leaks(srv.cluster)


def test_submit_rejects_non_query(env):
    with tserving.ServingSession(env[1], num_workers=2) as srv:
        with pytest.raises(ValueError, match="SELECT"):
            srv.submit("set distributed.stage_parallelism = 2")


def test_cancel_queued_and_running(env):
    cluster = _delay_cluster(workers=2, delay_s=0.2)
    with tserving.ServingSession(env[1], cluster=cluster, num_tasks=2,
                                 max_concurrent_queries=1) as srv:
        h1 = srv.submit(_sql("q6"))
        h2 = srv.submit(_sql("q6"))  # queued behind h1
        assert h2.status() == tserving.QUEUED
        assert h2.cancel()
        assert h2.status() == tserving.CANCELLED
        with pytest.raises(TaskCancelledError):
            h2.result_table(timeout=5)
        assert h1.cancel()  # mid-execution (the injected delay)
        with pytest.raises(TaskCancelledError):
            h1.result_table(timeout=60)
        assert h1.status() == tserving.CANCELLED
        assert not h1.cancel()  # resolved: the request lands nowhere
        srv.drain(timeout=60)
    _assert_no_leaks(cluster.inner)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_admission_budget_queues_behind_footprint(env):
    from datafusion_distributed_tpu_torch.planner.statistics import (
        plan_device_bytes,
    )

    tctx = env[1]
    est = plan_device_bytes(tctx.sql(_sql("q3")).physical_plan())
    assert est > 0
    cluster = _delay_cluster(workers=4, delay_s=0.15)
    with tserving.ServingSession(tctx, cluster=cluster, num_tasks=4,
                                 admission_budget_bytes=est * 1.5,
                                 max_concurrent_queries=8) as srv:
        h1 = srv.submit(_sql("q3"))
        h2 = srv.submit(_sql("q3"))  # would pass the byte budget: queues
        assert h1.status() == tserving.RUNNING
        assert h2.status() == tserving.QUEUED
        st = srv.stats()
        assert st["active"] == 1 and st["queued"] == 1
        assert st["in_use_bytes"] == h1.est_bytes == est
        a = h1.result_table(timeout=120).to_numpy()
        b = h2.result_table(timeout=120).to_numpy()
        assert h2.status() == tserving.DONE and identical(a, b)
        assert h2.admitted_s >= h1.finished_s
    _assert_no_leaks(cluster.inner)


def test_admission_oversized_query_runs_alone(env):
    """A query whose estimate exceeds the WHOLE budget still runs when
    nothing else does (no starvation)."""
    with tserving.ServingSession(env[1], num_workers=2, num_tasks=2,
                                 admission_budget_bytes=1.0) as srv:
        h = srv.submit(_sql("q6"))
        h.result_table(timeout=120)
        assert h.status() == tserving.DONE


def test_max_concurrent_queries_bound(env, sequential):
    cluster = _delay_cluster(workers=4, delay_s=0.05)
    peak = [0]
    with tserving.ServingSession(env[1], cluster=cluster, num_tasks=4,
                                 max_concurrent_queries=2) as srv:
        handles = [srv.submit(_sql("q6")) for _ in range(5)]

        def watch():
            while any(not h.done() for h in handles):
                peak[0] = max(peak[0], srv.stats()["active"])
                time.sleep(0.005)

        w = threading.Thread(target=watch, daemon=True)
        w.start()
        for h in handles:
            assert identical(h.result_table(timeout=120).to_numpy(),
                             sequential["q6"])
        w.join(timeout=10)
    assert 1 <= peak[0] <= 2, peak
    _assert_no_leaks(cluster.inner)


def test_priority_class_admission_order(env):
    cluster = _delay_cluster(workers=2, delay_s=0.1)
    with tserving.ServingSession(env[1], cluster=cluster, num_tasks=2,
                                 max_concurrent_queries=1) as srv:
        h1 = srv.submit(_sql("q6"))
        h_lo = srv.submit(_sql("q6"), priority=0)
        h_hi = srv.submit(_sql("q6"), priority=5)
        for h in (h1, h_lo, h_hi):
            h.result_table(timeout=120)
        # the higher class leaves the queue first though it came later
        assert h_hi.admitted_s < h_lo.admitted_s


@pytest.mark.parametrize("cancel_pending", [False, True],
                         ids=["graceful", "cancel_pending"])
def test_close_with_a_backlog(env, cancel_pending):
    """close() stops accepting queries; the backlog either still runs
    (default) or is cancelled — either way every handle resolves."""
    cluster = _delay_cluster(workers=2, delay_s=0.05)
    srv = tserving.ServingSession(env[1], cluster=cluster, num_tasks=2,
                                  max_concurrent_queries=1)
    handles = [srv.submit(_sql("q6")) for _ in range(3)]
    srv.close(cancel_pending=cancel_pending)
    states = [h.status() for h in handles]
    assert all(h.done() for h in handles)
    if cancel_pending:
        assert states[0] == tserving.DONE
        assert states[1:] == [tserving.CANCELLED] * 2
    else:
        assert states == [tserving.DONE] * 3
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(_sql("q6"))
    _assert_no_leaks(cluster.inner)


def test_stage_parallelism_bounds_query_under_global_pool(env):
    """`stage_parallelism` keeps its memory-control meaning under the
    serving tier: one query's in-flight stages on the global pool never
    exceed the per-query budget."""

    class CountingScheduler:
        def __init__(self):
            self.in_flight = self.peak = self.jobs = 0
            self._lock = threading.Lock()

        def submit(self, qid, fn, cost_hint=0):
            import concurrent.futures as cf

            fut = cf.Future()

            def run():
                with self._lock:
                    self.in_flight += 1
                    self.jobs += 1
                    self.peak = max(self.peak, self.in_flight)
                try:
                    fut.set_result(fn())
                except BaseException as e:
                    fut.set_exception(e)
                finally:
                    with self._lock:
                        self.in_flight -= 1

            threading.Thread(target=run, daemon=True).start()
            return fut

    tctx = env[1]
    sched = CountingScheduler()
    cluster = InMemoryCluster(4)
    coord = Coordinator(resolver=cluster, channels=cluster,
                        config_options={**tctx.config.distributed_snapshot(),
                                        "stage_parallelism": 1})
    coord.stage_pool = tserving._QueryPool(sched, "q-bounded")
    df = tctx.sql(_sql("q3"))
    out = coord.execute(df.distributed_plan(
        4, config=df._seeded_host_config(4), coordinator=coord))
    assert sched.peak == 1 and sched.jobs > 1, (sched.peak, sched.jobs)
    assert int(out.num_rows) > 0
    _assert_no_leaks(cluster)


# ---------------------------------------------------------------------------
# the global stage scheduler
# ---------------------------------------------------------------------------


def _pick_order(module, fair_share: bool, seed: int) -> list:
    """Drain one synthetic backlog through ``module``'s scheduler pick
    function by hand: four queries at given pass values and priorities,
    jobs with cost hints, in arrival order."""
    sched = module.GlobalStageScheduler(slots=1, fair_share=fair_share,
                                        seed=seed)
    sched.close()  # no worker threads: pick by hand
    state = {"qa": (0.30, 0), "qb": (0.05, 0), "qc": (0.05, 0),
             "qd": (0.0, 0), "qe": (0.7, 2)}
    for i, (q, (p, prio)) in enumerate(state.items()):
        sched._pass[q] = p
        sched._prio[q] = prio
        sched._weight[q] = 1.0
        sched._qseq[q] = i
    sched._running_stages["qb"] = 1
    sched._mean_wall["qb"] = 0.02
    for seq, (q, hint) in enumerate([
        ("qa", 10), ("qb", 20), ("qc", 20), ("qd", 5), ("qb", 5),
        ("qc", 5), ("qa", 1), ("qe", 3), ("qd", 50), ("qc", 5),
    ]):
        sched._pending.append(module._StageJob(q, None, seq, hint))
    order = []
    while sched._pending:
        job = sched._pick_locked()
        order.append((job.qid, job.seq))
    return order


@pytest.mark.parametrize("fair_share", [True, False],
                         ids=["fair_share", "fifo"])
@pytest.mark.parametrize("seed", [0, 7])
def test_scheduler_pick_order_equals_reference(fair_share, seed):
    got = _pick_order(tserving, fair_share, seed)
    assert got == _pick_order(jserving, fair_share, seed)
    assert got[0][0] == "qe"  # the higher priority class first


@pytest.mark.parametrize("fair_share", [True, False],
                         ids=["fair_share", "fifo"])
def test_stride_overtakes_heavy_live(fair_share):
    """After a heavy query held the only slot, a cheap query's stage wins
    the next slot under fair share although the heavy query's arrived
    first; FIFO keeps arrival order."""
    sched = tserving.GlobalStageScheduler(slots=1, fair_share=fair_share,
                                          seed=1)
    try:
        sched.register_query("heavy")
        sched.register_query("cheap")
        started = threading.Event()

        def blocker():
            started.set()
            time.sleep(0.08)

        b = sched.submit("heavy", blocker)
        assert started.wait(5)
        f_heavy = sched.submit("heavy", lambda: "h")
        f_cheap = sched.submit("cheap", lambda: "c")
        for f in (b, f_heavy, f_cheap):
            f.result(timeout=30)
        order = [qid for qid, _ in sched.schedule_log]
        want = (["heavy", "cheap", "heavy"] if fair_share
                else ["heavy", "heavy", "cheap"])
        assert order == want, order
        st = sched.stats()
        assert st["policy"] == ("fair_share" if fair_share else "fifo")
        assert sched.peak_in_flight == 1 and st["pending_stages"] == 0
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# concurrent queries against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fair_share", [True, False],
                         ids=["fair_share", "fifo"])
def test_concurrent_mixed_equal_reference(env, sequential, fair_share):
    """Six clients on threads submit q1, q3 and q6 twice each at once:
    every result is byte-identical to the port's sequential coordinated
    run and equal to the reference's sequential coordinated result."""
    jctx, tctx = env
    cluster = InMemoryCluster(4)
    results: dict = {}
    errors: list = []
    with tserving.ServingSession(tctx, cluster=cluster, num_tasks=4,
                                 fair_share=fair_share, seed=3) as srv:
        def client(i):
            try:
                for _ in range(2):
                    q = MIX[i % len(MIX)]
                    h = srv.submit(_sql(q))
                    results.setdefault(q, []).append(
                        h.result_table(timeout=120).to_numpy())
            except BaseException as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        st = srv.stats()
        assert st["completed"]["done"] == 12, st["completed"]
        assert st["scheduler"]["peak_in_flight"] >= 2
    jcl = jcoord.InMemoryCluster(4)
    for q in MIX:
        ref = _coordinated(jctx, jcl, q, module=jcoord)
        assert len(results[q]) == 4
        for got in results[q]:
            assert identical(got, sequential[q]), q
            assert_results_equal(ref, got, f"{q}: served vs the reference")
    _assert_no_leaks(cluster)


def test_concurrent_under_chaos_and_churn(env, sequential):
    """tests/test_serving.py's case in both packages: six queries served
    at once over a DynamicCluster under seeded transport faults, a leave
    and a join. Each package's results are byte-identical to its
    sequential runs, the packages' results equal, the membership events
    fired, the per-query chaos state swept, no staged slice left."""
    jctx, tctx = env
    served = []
    names = ("q1", "q6", "q3", "q6", "q1", "q3")
    for ctx, chaos, module, serving in (
            (jctx, jchaos, jcoord, jserving),
            (tctx, tchaos, tcoord, tserving)):
        cluster = module.DynamicCluster(4)
        urls = cluster.get_urls()
        plan = chaos.FaultPlan(20260803, [
            chaos.FaultSpec(site="execute", kind="transport", rate=0.1),
            chaos.FaultSpec(site="set_plan", kind="transport", rate=0.05),
        ], membership=[
            chaos.MembershipEvent("leave", urls[3], site="execute",
                                  nth_call=5),
            chaos.MembershipEvent("join", "mem://joiner-srv",
                                  site="set_plan", nth_call=12),
        ], query_scoped=True)
        ctx.config.distributed_options["max_task_retries"] = 8
        try:
            with serving.ServingSession(
                    ctx, cluster=chaos.wrap_cluster(cluster, plan),
                    num_tasks=4, max_concurrent_queries=6) as srv:
                handles = [srv.submit(_sql(q)) for q in names]
                served.append({q: h.result_table(timeout=600).to_numpy()
                               for q, h in zip(names, handles)})
                assert set(srv.stats()["hedging"]) == {
                    "in_flight", "peak_in_flight", "denied"}
        finally:
            ctx.config.distributed_options.pop("max_task_retries", None)
        kinds = {f["kind"] for f in plan.fired}
        assert {"membership_leave", "membership_join"} <= kinds, kinds
        assert urls[3] not in cluster.get_urls()
        assert "mem://joiner-srv" in cluster.get_urls()
        assert not plan._calls, list(plan._calls)[:4]
        _assert_no_leaks(cluster)
    for q in MIX:
        assert identical(served[1][q], sequential[q]), q
        assert_results_equal(served[0][q], served[1][q], q)


def test_prepared_statement_submit(env):
    """Three bindings of a q6 template through `submit` equal the same
    bindings' `execute()` (and the reference's) — the serving hot path."""
    jctx, tctx = env
    bindings = [{"qty": 24, "lo": 0.05, "hi": 0.07},
                {"qty": 30, "lo": 0.02, "hi": 0.09},
                {"qty": 10, "lo": 0.04, "hi": 0.06}]
    tstmt = tctx.prepare(Q6_TEMPLATE)
    jstmt = jctx.prepare(Q6_TEMPLATE)
    cluster = InMemoryCluster(4)
    with tserving.ServingSession(tctx, cluster=cluster, num_tasks=4) as srv:
        handles = [tstmt.submit(srv, b) for b in bindings]
        for b, h in zip(bindings, handles):
            got = h.result_table(timeout=120).to_numpy()
            assert_results_equal(tstmt.to_df(b).collect_table().to_numpy(),
                                 got, f"submit {b}")
            assert_results_equal(jstmt.to_df(b).collect_table().to_numpy(),
                                 got, f"reference {b}")
    _assert_no_leaks(cluster)


#: bad values of every serving knob the SET parser validates
BAD_KNOBS = {
    "max_concurrent_queries": 0,
    "admission_budget_bytes": -1,
    "worker_memory_budget_bytes": -5,
    "worker_memory_redline": 0.5,
    "checkpoint_budget_bytes": -1,
    "result_cache_budget_bytes": -2,
    "serving_stage_slots": -1,
    "slo_p99_ms": 0,
    "slo_error_rate": 1.5,
}


@pytest.mark.parametrize("knob", list(BAD_KNOBS))
def test_bad_serving_knob_raises_the_reference_message(knob):
    msgs = []
    for ctx in (JContext(), TContext(device="cpu")):
        with pytest.raises(ValueError) as ei:
            ctx.config.set_option(f"distributed.{knob}", BAD_KNOBS[knob])
        assert knob not in ctx.config.distributed_options
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0] and knob in msgs[0]


def test_serving_knobs_reach_admission_live(env):
    tctx = env[1]
    opts = tctx.config.distributed_options
    tctx.sql("set distributed.max_concurrent_queries = 3")
    tctx.sql("set distributed.admission_budget_bytes = 123456789")
    try:
        srv = tserving.ServingSession(tctx, num_workers=2)
        try:
            assert srv._max_concurrent() == 3
            assert srv._budget_bytes() == 123456789.0
            tctx.sql("set distributed.max_concurrent_queries = 5")
            assert srv._max_concurrent() == 5
        finally:
            srv.close()
        assert opts["max_concurrent_queries"] == 5
        with pytest.raises(ValueError, match="max_concurrent_queries"):
            tctx.sql("set distributed.max_concurrent_queries = 0")
        tctx.sql("set distributed.fair_share = false")
        assert opts["fair_share"] is False
    finally:
        for k in ("max_concurrent_queries", "admission_budget_bytes",
                  "fair_share"):
            opts.pop(k, None)


def test_chaos_query_scoped_schedule_replays_per_query(env, sequential):
    """A query-scoped crash schedule: every concurrent query sees the same
    seeded faults, retries onto another worker and matches the sequential
    run; the plan's per-query call counters are swept when they resolve."""
    plan = tchaos.FaultPlan(5, [tchaos.FaultSpec(
        site="execute", kind="crash", rate=0.3)], query_scoped=True)
    cluster = tchaos.wrap_cluster(InMemoryCluster(4), plan)
    with tserving.ServingSession(env[1], cluster=cluster,
                                 num_tasks=4) as srv:
        handles = [srv.submit(_sql("q3")) for _ in range(3)]
        for h in handles:
            assert identical(h.result_table(timeout=120).to_numpy(),
                             sequential["q3"])
        assert srv.faults.get("task_retries") > 0
    assert plan.fired and not plan._calls
    _assert_no_leaks(cluster.inner)


#: a seeded schedule per ported fault kind (crash, delay and oom are run by
#: the tests above and in tests/test_torch_memory.py)
FAULT_KINDS = {
    "transport": dict(site="execute", kind="transport", rate=0.5),
    "straggler": dict(site="execute", kind="straggler", rate=0.5,
                      delay_s=0.01),
    "corrupt_plan": dict(site="set_plan", kind="corrupt_plan", rate=1.0,
                         max_total=1),
    "skew": dict(site="execute", kind="skew", rate=1.0, stages=[0],
                 skew_fraction=0.8),
}


@pytest.mark.parametrize("kind", list(FAULT_KINDS))
def test_chaos_fault_kind_equals_reference(env, kind):
    """The same seeded schedule in both packages (q6, 4 tasks, the bulk
    plane): the same faults fire at the same calls, and the query gives
    the same result — or, for a corrupted plan, the same fatal error."""
    jctx, tctx = env
    outs = []
    for ctx, chaos, module in ((jctx, jchaos, jcoord),
                               (tctx, tchaos, tcoord)):
        plan = chaos.FaultPlan(20260803, [chaos.FaultSpec(
            **FAULT_KINDS[kind])])
        inner = module.InMemoryCluster(4)
        cluster = chaos.wrap_cluster(inner, plan)
        coord = module.Coordinator(resolver=cluster, channels=cluster,
                                   config_options={
                                       **ctx.config.distributed_snapshot(),
                                       "data_plane": "unary",
                                       "stage_parallelism": 1})
        try:
            res = ctx.sql(_sql("q6")).collect_coordinated_table(
                coordinator=coord, num_tasks=4).to_numpy()
        except Exception as e:  # compared across the packages below
            res = (type(e).__name__, "DFTPU043" in str(e))
        fired = sorted((f["site"], f["stage_id"], f["task_number"],
                        f["kind"]) for f in plan.fired)
        outs.append((res, fired))
        for w in inner.workers.values():
            assert not w.table_store.tables and len(w.registry) == 0
    (jres, jfired), (tres, tfired) = outs
    if "max_total" in FAULT_KINDS[kind]:
        # a capped slot goes to whichever sibling task arrives first
        # (runtime/chaos.py): the count and the stage are deterministic
        tfired = [f[:2] + f[3:] for f in tfired]
        jfired = [f[:2] + f[3:] for f in jfired]
    assert tfired == jfired and tfired, (tfired, jfired)
    if kind == "corrupt_plan":
        assert tres == jres == ("PlanIntegrityError", True)
    else:
        assert_results_equal(jres, tres, kind)
