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
- every left-out feature raises NotImplementedError naming ROADMAP A.5.
"""

import re

import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import errors as jerrors
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
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
    def coord_with(**fields):
        def run(ctx):
            cluster = tcoord.InMemoryCluster(2)
            coord = tcoord.Coordinator(resolver=cluster, channels=cluster,
                                       **fields)
            ctx.sql(_sql("q6")).collect_coordinated_table(
                coordinator=coord, num_tasks=NT)
        return run

    def coord_opts(**opts):
        def run(ctx):
            cluster = tcoord.InMemoryCluster(2)
            coord = tcoord.Coordinator(
                resolver=cluster, channels=cluster,
                config_options={**ctx.config.distributed_snapshot(), **opts})
            ctx.sql(_sql("q6")).collect_coordinated_table(
                coordinator=coord, num_tasks=NT)
        return run

    def session_set(stmt):
        def run(ctx):
            ctx.sql(stmt)
            try:
                ctx.sql(_sql("q6")).collect_coordinated_table(num_tasks=NT)
            finally:
                ctx.config.distributed_options.pop("result_cache", None)
        return run

    return {
        "hedging": coord_opts(hedging=True),
        "checkpoints": coord_with(checkpoints=object()),
        "result_cache field": coord_with(result_cache=object()),
        "SET distributed.result_cache": session_set(
            "SET distributed.result_cache = true"),
        "stage_pool": coord_with(stage_pool=object()),
        "worker_memory_budget_bytes": coord_opts(
            worker_memory_budget_bytes=1 << 20),
        "data_plane=shm": coord_opts(data_plane="shm"),
        "DynamicCluster": lambda ctx: tcoord.DynamicCluster(2),
        "TableStore budget": lambda ctx: tcodec.TableStore(budget_bytes=1),
        "PreparedStatement.submit": lambda ctx: ctx.prepare(
            _sql("q6").replace("< 24", "< $1")).submit(None, [24]),
        "last_trace": lambda ctx: ctx.last_trace(),
        "last_trace_profile": lambda ctx: ctx.last_trace_profile(),
    }


@pytest.mark.parametrize("case", list(_left_out_cases()))
def test_left_out_features_refuse(env, case):
    tctx = env[2]
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        _left_out_cases()[case](tctx)


def test_prepared_statement_execute_coordinated(env):
    tctx = env[2]
    stmt = tctx.prepare(_sql("q6").replace("< 24", "< $1"))
    a = stmt.execute_coordinated([24], num_workers=WORKERS, num_tasks=NT)
    b = tctx.sql(_sql("q6")).collect_coordinated(num_workers=WORKERS,
                                                 num_tasks=NT)
    assert a.equals(b)
    assert a.num_rows == 1
