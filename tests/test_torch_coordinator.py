"""The port's coordinated tier (`collect_coordinated_table`,
runtime/coordinator.py over an InMemoryCluster of 4 in-process workers)
against the reference's, on the CPU.

TPC-H at SF 0.002, seed 7, `bytes_per_task = 1` (as
tests/test_tpch_distributed.py sets it), queries from benchmarks/queries/tpch,
`num_tasks=4`:

- all 22 queries with Coordinator, each equal to the reference's
  coordinator (ints, strings and row order exact, floats at test_rtol(),
  result capacity and overflow-retry count equal); with
  AdaptiveCoordinator, all 22 equal to the port's single-node result, and
  q3, q6, q9, q13, q18 and q21 to the reference's coordinator (together
  every exchange kind TPC-H plans at 4 tasks: hash and range shuffles,
  co-shuffled join sides, broadcasts, the N:1 coalesce; the reference's
  side of all 22 would add minutes of XLA compiles to the suite). The
  reference's coordinated tier fails q11, q15 and q22 with DFTPU043: its
  codec ships a resolved scalar subquery as a plain literal, so a worker's
  decoded plan no longer fingerprints as the coordinator's. The port ships
  it as a subquery constant; those three are held against the reference's
  single-node result, and the reference's failure is asserted as it stands;
- the adaptive coordinator's decisions per stage (consumer task counts and
  the resized capacities of every shipped stage plan) equal to the
  reference's. Those are compared with `sample_fraction = 1.0`, i.e. sized
  from every producer's output: at the default the statistics freeze when
  the first quarter of a stage's producers completes, so they depend on
  which task finished first, and the reference's own decisions differ run
  to run (q3: 32 or 128 slots for its final aggregate). The default is run
  too, held against the port's single-node result;
- after each query every worker's TableStore and task registry are empty;
- the data-plane knobs byte-identical to the default run on q3, q18, q21;
- a worker that fails once with WorkerUnavailableError: retried onto
  another worker, the same result and FaultCounters in both packages; a
  non-retryable worker error surfaces with the reference's type and
  message;
- the features once left out (`last_trace`, `last_trace_profile`) answer
  as the reference's; the shm data plane and chaos `segment_lost` (refused until the
  wire tier was ported) run over localhost gRPC workers; the serving
  tier's hooks (checkpoints, the result cache, the
  stage pool, worker memory budgets, `PreparedStatement.submit`) and the
  resilience tier (hedging, `DynamicCluster`, chaos membership events) run.
"""

import re

import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import errors as jerrors
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.runtime import chaos as tchaos
from datafusion_distributed_tpu_torch.runtime import codec as tcodec
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import errors as terrors
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_results_equal, identical

torch.set_num_threads(1)

import os  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCH_DIR = os.path.join(REPO, "benchmarks", "queries", "tpch")
TPCH = [f"q{i}" for i in range(1, 23)]
#: queries the reference's coordinated tier fails with DFTPU043
REF_FAILS = ("q11", "q15", "q22")
#: the adaptive queries held against the reference's coordinator
ADAPTIVE_REF = ("q3", "q6", "q9", "q13", "q18", "q21")
NT = 4
WORKERS = 4


def _sql(q: str) -> str:
    with open(os.path.join(TPCH_DIR, f"{q}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def env():
    arrow = gen_tpch(sf=0.002, seed=7)
    jctx, tctx = JContext(), TContext(device="cpu")
    for ctx in (jctx, tctx):
        ctx.config.distributed_options["bytes_per_task"] = 1
        for name, tbl in arrow.items():
            ctx.register_arrow(name, tbl)
    return (jctx, jcoord.InMemoryCluster(WORKERS),
            tctx, tcoord.InMemoryCluster(WORKERS))


def _recording(cls):
    """``cls`` noting the capacities of every stage plan it ships (the
    adaptive coordinator resizes them from runtime statistics)."""

    class Recording(cls):
        def _prepare_stage_plan(self, stage_plan):
            out = super()._prepare_stage_plan(stage_plan)
            caps = tuple(
                (type(n).__name__, int(n.output_capacity()),
                 getattr(n, "num_slots", None))
                for n in out.collect(lambda n: True))
            self.__dict__.setdefault("prepared", []).append(caps)
            return out

    return Recording


def _coordinated(ctx, cluster, module, q, adaptive, opts=None,
                 exact_stats=False):
    cls = _recording(module.AdaptiveCoordinator if adaptive
                     else module.Coordinator)
    kw = {"sample_fraction": 1.0} if exact_stats else {}
    coord = cls(resolver=cluster, channels=cluster,
                config_options={**ctx.config.distributed_snapshot(),
                                **(opts or {})}, **kw)
    df = ctx.sql(_sql(q))
    out = df.collect_coordinated_table(coordinator=coord, num_tasks=NT)
    for w in cluster.workers.values():
        assert not w.table_store.tables, (w.url, "staged tables leaked")
        assert len(w.registry) == 0, (w.url, "task entries leaked")
    return out, coord, df


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["static", "adaptive"])
@pytest.mark.parametrize("q", TPCH)
def test_tpch_coordinated_equals_reference(env, q, adaptive):
    jctx, jcl, tctx, tcl = env
    single = tctx.sql(_sql(q)).collect_table()
    if adaptive:
        default, _co, _df = _coordinated(tctx, tcl, tcoord, q, True)
        assert_results_equal(single.to_numpy(), default.to_numpy(),
                             f"{q}: default adaptive vs single-node")
        if q not in ADAPTIVE_REF:
            return
    got, tco, tdf = _coordinated(tctx, tcl, tcoord, q, adaptive,
                                 exact_stats=adaptive)
    assert_results_equal(single.to_numpy(), got.to_numpy(),
                         f"{q}: coordinated vs the port's single-node")
    if q in REF_FAILS:
        with pytest.raises(jerrors.PlanIntegrityError, match="DFTPU043"):
            _coordinated(jctx, jcl, jcoord, q, adaptive,
                         exact_stats=adaptive)
        ref = jctx.sql(_sql(q)).collect_table()
        assert_results_equal(ref.to_numpy(), got.to_numpy(),
                             f"{q}: against the reference's single-node")
        return
    ref, jco, jdf = _coordinated(jctx, jcl, jcoord, q, adaptive,
                                 exact_stats=adaptive)
    assert got.names == ref.names, q
    assert got.capacity == ref.capacity, q
    assert tdf.last_retry_count == jdf.last_retry_count, q
    assert_results_equal(ref.to_numpy(), got.to_numpy(), q)
    if adaptive:
        assert tco.task_count_decisions == jco.task_count_decisions, q
        assert sorted(tco.prepared) == sorted(jco.prepared), q


#: the knob variants, byte-identical to the default run
KNOBS = {
    "data_plane=unary": {"data_plane": "unary"},
    "data_plane=stream": {"data_plane": "stream"},
    "peer_shuffle=false": {"peer_shuffle": False},
    "pipelined_shuffle=false": {"pipelined_shuffle": False},
    "stage_parallelism=1": {"stage_parallelism": 1},
}


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("q", ["q3", "q18", "q21"])
def test_knob_variants_byte_identical(env, q, knob):
    _jctx, _jcl, tctx, tcl = env
    default, dco, _ = _coordinated(tctx, tcl, tcoord, q, False)
    got, co, _ = _coordinated(tctx, tcl, tcoord, q, False, KNOBS[knob])
    assert identical(default.to_numpy(), got.to_numpy()), (q, knob)
    planes = {sm.get("plane", "stream") for sm in co.stream_metrics.values()}
    if knob.startswith("data_plane") or knob == "peer_shuffle=false":
        assert "peer" not in planes, (knob, planes)
    if knob == "data_plane=unary":
        assert planes <= {"unary", "stream"}, planes


def _unary(ctx):
    return {**ctx.config.distributed_snapshot(), "data_plane": "unary",
            "task_retry_backoff_s": 0.0}


def _fail_once(cluster, exc):
    """The second worker raises ``exc`` from its first execute_task."""
    w = cluster.workers[sorted(cluster.workers)[1]]
    real = w.execute_task
    state = {"left": 1}

    def execute_task(key, *a, **kw):
        if state["left"]:
            state["left"] -= 1
            raise exc(f"injected: {w.url} is gone", worker_url=w.url,
                      task=key)
        return real(key, *a, **kw)

    w.execute_task = execute_task
    return w, real


def test_retry_onto_another_worker(env):
    jctx, _jcl, tctx, _tcl = env
    out = []
    for ctx, module, errors in ((jctx, jcoord, jerrors),
                                (tctx, tcoord, terrors)):
        cluster = module.InMemoryCluster(WORKERS)
        w, real = _fail_once(cluster, errors.WorkerUnavailableError)
        coord = module.Coordinator(resolver=cluster, channels=cluster,
                                   config_options=_unary(ctx))
        res = ctx.sql(_sql("q3")).collect_coordinated_table(
            coordinator=coord, num_tasks=NT)
        w.execute_task = real
        for wk in cluster.workers.values():
            assert not wk.table_store.tables and len(wk.registry) == 0
        out.append((res.to_numpy(), coord.faults.as_dict()))
    assert_results_equal(out[0][0], out[1][0], "q3 with one retry")
    assert out[1][1] == out[0][1]
    assert out[1][1].get("task_retries") == 1, out[1][1]


def _norm(msg: str) -> str:
    """The message without the query id, and without which worker and
    task failed first (the stage's tasks run on threads)."""
    msg = re.sub(r"query_id='[0-9a-f]+'", "query_id=...", msg)
    msg = re.sub(r"worker-\d+", "worker-N", msg)
    return re.sub(r"task_number=\d+", "task_number=N", msg)


def test_non_retryable_error_surfaces_as_the_reference(env):
    jctx, _jcl, tctx, _tcl = env
    out = []
    for ctx, module, errors in ((jctx, jcoord, jerrors),
                                (tctx, tcoord, terrors)):
        cluster = module.InMemoryCluster(WORKERS)

        def refuse(plan, key):
            raise ValueError("injected: refused by the on_plan hook")

        for w in cluster.workers.values():
            w.on_plan = refuse
        coord = module.Coordinator(resolver=cluster, channels=cluster,
                                   config_options=_unary(ctx))
        with pytest.raises(errors.WorkerError) as ei:
            ctx.sql(_sql("q6")).collect_coordinated_table(
                coordinator=coord, num_tasks=NT)
        e = ei.value
        out.append((type(e).__name__, e.retryable, e.original_type,
                    _norm(str(e)), coord.faults.as_dict()))
    assert out[1] == out[0]
    assert "injected: refused" in out[0][3]


def _left_out_cases():
    """The features this port refused until the tools were ported (ROADMAP
    A.5.4): each now answers, after a traced coordinated q6, with what the
    reference's answers (tests/test_torch_tracing.py holds them in
    detail)."""
    return {
        "last_trace": lambda ctx: sorted(
            (e.get("ph"), e.get("name"))
            for e in ctx.last_trace()["traceEvents"]),
        "last_trace_profile": lambda ctx: [
            ln for ln in ctx.last_trace_profile().splitlines()
            if ln.startswith(("per-stage", "events", "top spans"))],
    }


@pytest.mark.parametrize("case", list(_left_out_cases()))
def test_left_out_features_refuse(env, case):
    jctx, _jcl, tctx, _tcl = env
    out = []
    for ctx, module in ((jctx, jcoord), (tctx, tcoord)):
        cluster = module.InMemoryCluster(WORKERS)
        coord = module.Coordinator(
            resolver=cluster, channels=cluster,
            config_options={**ctx.config.distributed_snapshot(),
                            "tracing": "on"})
        ctx.sql(_sql("q6")).collect_coordinated_table(coordinator=coord,
                                                      num_tasks=NT)
        out.append(_left_out_cases()[case](ctx))
    assert out[1] == out[0] and out[1]


def _wire_tier_cases():
    """The tiers this port refused before the wire tier was ported: each
    now runs q6 (4 tasks over two localhost gRPC workers on the CPU) to
    the default coordinated result, with no staged slice, task or shm
    segment left on either worker."""
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )

    def run(ctx, wrap=None, **opts):
        cluster = start_localhost_cluster(2, device="cpu", rpc_timeout_s=60)
        try:
            c = cluster if wrap is None else wrap(cluster)
            coord = tcoord.Coordinator(
                resolver=c, channels=c,
                config_options={**ctx.config.distributed_snapshot(), **opts})
            out = ctx.sql(_sql("q6")).collect_coordinated_table(
                coordinator=coord, num_tasks=NT)
            for w in cluster.local_workers:
                assert not w.table_store.tables and len(w.registry) == 0
                assert w.segment_pool.live_segments() == 0
            return out
        finally:
            cluster.shutdown()

    def torn(cluster):
        return tchaos.wrap_cluster(cluster, tchaos.one_crash_per_stage(
            7, kind="segment_lost"))

    return {
        "data_plane=shm": lambda ctx: run(ctx, data_plane="shm"),
        "chaos segment_lost": lambda ctx: run(ctx, wrap=torn,
                                              data_plane="shm"),
    }


@pytest.mark.parametrize("case", list(_wire_tier_cases()))
def test_wire_tier_runs(env, case):
    tctx = env[2]
    base = tctx.sql(_sql("q6")).collect_coordinated_table(
        num_workers=WORKERS, num_tasks=NT).to_numpy()
    got = _wire_tier_cases()[case](tctx).to_numpy()
    assert identical(base, got), case


def _serving_hook_cases():
    """The tiers this port refused before the serving tier was ported:
    each now runs q6 (4 tasks over in-memory workers) to the default
    coordinated result."""
    from datafusion_distributed_tpu_torch.runtime import (
        checkpoint as tckpt,
        result_cache as trc,
        serving as tserving,
    )

    def coord_with(make):
        def run(ctx):
            cluster = tcoord.InMemoryCluster(2)
            coord = tcoord.Coordinator(
                resolver=cluster, channels=cluster,
                config_options=ctx.config.distributed_snapshot(),
                **make(cluster))
            try:
                return ctx.sql(_sql("q6")).collect_coordinated_table(
                    coordinator=coord, num_tasks=NT)
            finally:
                pool = getattr(coord.stage_pool, "_sched", None)
                if pool is not None:
                    pool.close()
        return run

    def checkpointer(cluster):
        store = tckpt.CheckpointStore()
        return {"checkpoints": tckpt.QueryCheckpointer(
            store, store.admit("q6"), cluster, cluster)}

    def budget(ctx):
        cluster = tcoord.InMemoryCluster(2)
        coord = tcoord.Coordinator(
            resolver=cluster, channels=cluster,
            config_options={**ctx.config.distributed_snapshot(),
                            "worker_memory_budget_bytes": 1 << 12})
        out = ctx.sql(_sql("q6")).collect_coordinated_table(
            coordinator=coord, num_tasks=NT)
        assert all(w.table_store.budget_bytes == 1 << 12
                   for w in cluster.workers.values())
        return out

    def session_set(ctx):
        ctx.sql("SET distributed.result_cache = true")
        try:
            first = ctx.sql(_sql("q6")).collect_coordinated_table(
                num_tasks=NT)
            again = ctx.sql(_sql("q6")).collect_coordinated_table(
                num_tasks=NT)
            assert again is first
            return again
        finally:
            ctx.config.distributed_options.pop("result_cache", None)

    def store_budget(ctx):
        store = tcodec.TableStore(budget_bytes=1)
        table = ctx.sql(_sql("q6")).collect_table()
        tid = store.put(table)
        assert store.stats()["spills"] == 1
        out = store.get(tid)
        store.remove([tid])
        assert store.stats()["spill_files"] == 0
        return out

    def submit(ctx):
        with tserving.ServingSession(ctx, num_workers=2,
                                     num_tasks=NT) as srv:
            return ctx.prepare(_sql("q6").replace("< 24", "< $1")).submit(
                srv, [24]).result_table(timeout=120)

    return {
        "checkpoints": coord_with(checkpointer),
        "result_cache field": coord_with(
            lambda cluster: {"result_cache": trc.ResultCache()}),
        "SET distributed.result_cache": session_set,
        "stage_pool": coord_with(lambda cluster: {
            "stage_pool": tserving._QueryPool(
                tserving.GlobalStageScheduler(2), "q6")}),
        "worker_memory_budget_bytes": budget,
        "TableStore budget": store_budget,
        "PreparedStatement.submit": submit,
    }


@pytest.mark.parametrize("case", list(_serving_hook_cases()))
def test_serving_tier_hooks_run(env, case):
    tctx = env[2]
    base = tctx.sql(_sql("q6")).collect_coordinated_table(
        num_workers=WORKERS, num_tasks=NT).to_numpy()
    got = _serving_hook_cases()[case](tctx).to_numpy()
    assert_results_equal(base, got, case)


def _resilience_cases():
    """The tiers this port refused before elastic membership and hedging
    were ported: each now runs q6 (4 tasks over in-memory workers) to the
    default coordinated result."""

    def run(ctx, cluster, **opts):
        coord = tcoord.Coordinator(
            resolver=cluster, channels=cluster,
            config_options={**ctx.config.distributed_snapshot(), **opts})
        out = ctx.sql(_sql("q6")).collect_coordinated_table(
            coordinator=coord, num_tasks=NT)
        for w in cluster.workers.values():
            assert not w.table_store.tables and len(w.registry) == 0
        return out

    def membership_event(ctx):
        cluster = tcoord.DynamicCluster(3)
        chaos = tchaos.wrap_cluster(cluster, tchaos.FaultPlan(
            7, [], membership=[tchaos.MembershipEvent(
                "leave", "mem://worker-0", site="execute")]))
        out = run(ctx, chaos)
        assert cluster.is_departed("mem://worker-0")
        return out

    return {
        "hedging": lambda ctx: run(ctx, tcoord.InMemoryCluster(2),
                                   hedging=True),
        "DynamicCluster": lambda ctx: run(ctx, tcoord.DynamicCluster(2)),
        "chaos MembershipEvent": membership_event,
    }


@pytest.mark.parametrize("case", list(_resilience_cases()))
def test_resilience_tier_runs(env, case):
    tctx = env[2]
    base = tctx.sql(_sql("q6")).collect_coordinated_table(
        num_workers=WORKERS, num_tasks=NT).to_numpy()
    got = _resilience_cases()[case](tctx).to_numpy()
    assert identical(base, got), case


def test_prepared_statement_execute_coordinated(env):
    tctx = env[2]
    stmt = tctx.prepare(_sql("q6").replace("< 24", "< $1"))
    a = stmt.execute_coordinated([24], num_workers=WORKERS, num_tasks=NT)
    b = tctx.sql(_sql("q6")).collect_coordinated(num_workers=WORKERS,
                                                 num_tasks=NT)
    assert a.equals(b)
    assert a.num_rows == 1
