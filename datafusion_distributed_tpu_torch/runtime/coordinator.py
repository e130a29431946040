"""Coordinator: stage-wise distributed execution across workers.

The reference's `DistributedExec`/`QueryCoordinator` assign worker URLs per
task, ship task-specialized plans over a coordinator channel, then stream
results through the exchange network (`src/coordinator/`,
SURVEY.md §3.2). This is the host-runtime tier of the TPU design:

  in-mesh   -> runtime/mesh_executor.py (one SPMD program, collectives)
  cross-mesh/host -> THIS: each stage's tasks run on workers; the coordinator
  materializes stage outputs and performs the exchange semantics between
  stages (the DCN hop).

Stages execute bottom-up: every exchange boundary's producer subtree is
shipped to workers task-by-task (round-robin routing, the reference's
routed_urls default), executed, and the exchange (shuffle regroup /
broadcast / coalesce) is applied to the collected outputs; the boundary then
becomes an in-memory scan for the consumer stage — the Pending->Ready flip
of `Stage::Local -> Stage::Remote`.

Port of the reference `runtime/coordinator.py`, in-process tier. Stage
outputs stay on the device they were made on: the regroups, range slices,
modulo slices and chunk views below run there (the reference moves every
producer's rows through numpy), and each table's live-row count is read to
the host once (ops/table.py `host_rows`, `read_rows`). The serving tier's
hooks are ported: the global stage pool (`stage_pool`), query checkpoints
(`checkpoints`), the sub-plan cache (`result_cache`) and the enforced
worker memory budget; elastic membership (`DynamicCluster`), the
departed-peer healing and straggler hedging. Every attempt of a task
(a hedge included) runs on the device's one current stream. The same
coordinator drives gRPC workers (runtime/grpc_worker.py), whose planes
carry Arrow IPC bytes through the host, the co-located shm plane among
them (`data_plane = shm`). Over mesh workers (runtime/mesh_worker.py)
a stage's tasks ship as spans, one plan a worker's span of tasks
(`_try_dispatch_span`).
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import torch

from datafusion_distributed_tpu_torch.ops.hash import hash_columns
from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Table,
    concat_tables,
    host_rows,
    is_host_backed,
    read_rows,
    rows_tensor,
    slice_view,
)
from datafusion_distributed_tpu_torch.plan.exchanges import (
    BroadcastExchangeExec,
    CoalesceExchangeExec,
    IsolatedArmExec,
    PartitionReplicatedExec,
    RangeShuffleExchangeExec,
    ShuffleExchangeExec,
)
from datafusion_distributed_tpu_torch.plan.physical import (
    DistributedTaskContext,
    ExecutionPlan,
    MemoryScanExec,
)
from datafusion_distributed_tpu_torch.ops.table import parse_bool_knob
from datafusion_distributed_tpu_torch.runtime.codec import TableStore, encode_plan
from datafusion_distributed_tpu_torch.runtime.errors import (
    TaskCancelledError,
    TaskTimeoutError,
    WorkerError,
    WorkerUnavailableError,
    is_retryable,
)
from datafusion_distributed_tpu_torch.runtime.metrics import (
    FaultCounters,
    MetricsStore,
)
from datafusion_distributed_tpu_torch.runtime.streams import StreamScanExec
from datafusion_distributed_tpu_torch.runtime.tracing import (
    DEFAULT_TRACE_STORE,
    NULL_TRACER,
    TRACE_CTX_KEY,
    resolve_tracing_mode,
    table_nbytes,
)
from datafusion_distributed_tpu_torch.runtime.worker import (
    TaskKey,
    Worker,
    call_with_deadline,
)


#: fault-tolerance knobs and their defaults, settable per session via
#: `SET distributed.<knob> = <value>` (sql/context.py plumbs
#: distributed_options into Coordinator.config_options). Timeouts of 0
#: mean "no deadline". task_timeout_s bounds one ATTEMPT: on the bulk
#: plane that is execution + result transfer (gRPC wire deadlines span
#: the whole call), on the streaming planes it is the wait for the FIRST
#: chunk (which contains the execution; later chunks slice an already-
#: materialized output) — size it for the slowest legitimate task
#: including its result, not just its compute.
FAULT_TOLERANCE_DEFAULTS = {
    "max_task_retries": 2,
    "task_retry_backoff_s": 0.05,
    "task_timeout_s": 0.0,
    "dispatch_timeout_s": 0.0,
    "quarantine_threshold": 3,
    "quarantine_seconds": 30.0,
}

#: stage-DAG scheduler knobs (`SET distributed.stage_parallelism`):
#: bounded in-flight budget for CONCURRENT STAGES — how many independent
#: exchange subtrees may materialize at once. 0 = auto (the worker
#: count); 1 = the sequential depth-first order (pre-scheduler
#: behavior, byte-identical results by design at any setting).
SCHEDULER_DEFAULTS = {
    "stage_parallelism": 0,
}

#: pipelined-shuffle knob (`SET distributed.pipelined_shuffle`, default
#: on): shuffle boundaries on the coordinator-mediated partition-stream
#: plane stream producer slices into a live PartitionFeed and the
#: consumer stage releases on FIRST SLICE instead of stage-complete —
#: each consumer task then blocks only for ITS partition
#: (runtime/streams.py StreamScanExec). Results are byte-identical to
#: the materialized plane by construction (same chunk order, same
#: capacity arithmetic). Engages only under the stage-DAG scheduler
#: (stage_parallelism > 1 — `= 1` keeps the documented pre-scheduler
#: materialized behavior) and only without a checkpointer (checkpoints
#: snapshot materialized frontiers).
PIPELINE_DEFAULTS = {
    "pipelined_shuffle": True,
}

#: straggler-hedging knobs (`SET distributed.hedging` etc.): when a
#: task's attempt outlives max(sketch-p<hedge_quantile>, hedge_floor_s)
#: the coordinator speculatively re-dispatches it to a different healthy
#: worker; first completed attempt wins, the loser is cancelled and its
#: staged slices released. hedge_budget bounds IN-FLIGHT speculative
#: attempts cluster-wide (runtime/metrics.py HedgeBudget) so a cold
#: sketch or a uniformly slow stage cannot stampede the cluster with
#: doubled load. Off by default: hedging burns spare capacity for tail
#: latency — a serving-tier tradeoff the operator opts into.
HEDGING_DEFAULTS = {
    "hedging": False,
    "hedge_quantile": 0.99,
    "hedge_floor_s": 0.05,
    "hedge_budget": 2,
}

#: single lookup for every `SET distributed.*` knob default the
#: coordinator reads through _opt_int/_opt_float
_OPTION_DEFAULTS = {
    **FAULT_TOLERANCE_DEFAULTS, **SCHEDULER_DEFAULTS, **HEDGING_DEFAULTS,
}


def _terminal(exc: WorkerError) -> WorkerError:
    """Mark an instance of a retryable class as NOT retryable (cluster-wide
    conditions like 'no healthy workers' that no re-dispatch can fix)."""
    exc.retryable = False
    return exc


#: serializes lazy HealthTracker creation: stage fan-out threads may record
#: their first failures concurrently, and a lost race would drop a failure
#: on an orphan tracker (threshold-1 quarantines silently missed)
_HEALTH_INIT_LOCK = threading.Lock()

#: same role for the lazily-created HedgeBudget: two concurrent tasks
#: each minting a budget would double the in-flight bound
_HEDGE_INIT_LOCK = threading.Lock()


class _EitherSet:
    """Duck-typed cancel handle merging two events: ``is_set()`` when
    EITHER is. Lets a hedge attempt hand workers/chaos ONE pollable
    object combining the per-query cancel (a sibling failed / the caller
    cancelled) with the attempt's private loser-cancel (it lost the
    hedge race). Members may be None or nested _EitherSets."""

    __slots__ = ("_a", "_b")

    def __init__(self, a, b):
        self._a = a
        self._b = b

    def is_set(self) -> bool:
        return (self._a is not None and self._a.is_set()) or (
            self._b is not None and self._b.is_set()
        )


class _RetryState:
    """Per-task retry bookkeeping: attempt count + the urls of workers
    whose attempts already failed (the re-dispatch routes around them)."""

    __slots__ = ("attempt", "excluded")

    def __init__(self) -> None:
        self.attempt = 0
        self.excluded: set[str] = set()


class WorkerResolver:
    """Cluster membership (the reference's WorkerResolver: get_urls)."""

    def get_urls(self) -> list[str]:
        raise NotImplementedError


class ChannelResolver:
    """URL -> worker channel (the reference's ChannelResolver)."""

    def get_worker(self, url: str) -> Worker:
        raise NotImplementedError


class InMemoryCluster(WorkerResolver, ChannelResolver):
    """N in-process workers (the InMemoryChannelResolver fake cluster used by
    the reference's whole TPC suite, `src/test_utils/`)."""

    def __init__(self, num_workers: int, ttl_seconds: float = 600.0):
        self.workers = {
            f"mem://worker-{i}": Worker(f"mem://worker-{i}", ttl_seconds)
            for i in range(num_workers)
        }
        for w in self.workers.values():
            # peers resolve each other through the cluster itself (the
            # in-memory duplex-pipe analogue, `in_memory_channel_resolver.rs`)
            w.peer_channels = self

    def get_urls(self) -> list[str]:
        return list(self.workers.keys())

    def get_worker(self, url: str) -> Worker:
        return self.workers[url]


class DynamicCluster(WorkerResolver, ChannelResolver):
    """Epoch-versioned MUTABLE cluster membership (the reference's
    WorkerResolver as a dynamic layer, SURVEY §1): workers `add_worker`/
    `remove_worker`/`drain_worker` at any time — including mid-query — and
    every mutation bumps the monotonically increasing `membership_epoch`
    the coordinator keys its per-membership caches on.

    Three membership roles:

      active    listed by `get_urls()` — eligible for new task dispatch
      draining  NOT listed by `get_urls()` (no new tasks) but still
                resolvable via `get_worker` so in-flight tasks finish and
                staged peer-producer plans keep serving pulls; removed by
                `finish_drains()` only once EMPTY (zero registry entries,
                zero staged TableStore slices)
      departed  `get_worker` raises the retryable WorkerUnavailableError —
                the coordinator's retry machinery re-routes/re-stages the
                affected work onto survivors

    `remove_worker` models an abrupt leave (process death): the worker's
    registry and shipment store are released, as the dying process would
    release them — so leak accounting stays exact across churn."""

    def __init__(self, num_workers: int = 0, ttl_seconds: float = 600.0,
                 worker_factory: Optional[Callable[[str], Worker]] = None):
        self._lock = threading.RLock()
        self._epoch = 0  # guarded-by: _lock
        self._active: dict[str, Worker] = {}  # guarded-by: _lock
        self._draining: dict[str, Worker] = {}  # guarded-by: _lock
        self._departed: set[str] = set()  # guarded-by: _lock
        self._ttl = ttl_seconds
        self._factory = worker_factory or (
            lambda url: Worker(url, ttl_seconds)
        )
        for i in range(num_workers):
            self.add_worker(f"mem://worker-{i}")

    # -- resolver surface ---------------------------------------------------
    @property
    def membership_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def get_urls(self) -> list[str]:
        with self._lock:
            return list(self._active.keys())

    def get_worker(self, url: str) -> Worker:
        with self._lock:
            w = self._active.get(url) or self._draining.get(url)
            if w is not None:
                return w
        raise WorkerUnavailableError(
            f"worker {url} is not in the cluster membership"
            + (" (departed)" if url in self._departed else ""),
            worker_url=url,
        )

    # -- membership mutation -------------------------------------------------
    def add_worker(self, worker) -> Worker:
        """Add ``worker`` (a Worker instance or a url for the factory).
        A joining worker is immediately eligible for new dispatches —
        including later stages of an already-running query."""
        w = worker if isinstance(worker, Worker) else self._factory(worker)
        with self._lock:
            if w.url in self._active or w.url in self._draining:
                raise ValueError(f"worker {w.url} already in the cluster")
            # peers resolve each other through the cluster itself, so a
            # joiner can serve AND issue peer pulls right away
            w.peer_channels = self
            self._active[w.url] = w
            self._departed.discard(w.url)
            self._epoch += 1
        return w

    def remove_worker(self, url: str, release: bool = True) -> None:
        """Abrupt leave: the url stops resolving NOW. ``release`` frees the
        worker's registry + shipment store the way its dying process would
        (in-flight coordinator attempts against it fail retryably)."""
        with self._lock:
            w = self._active.pop(url, None) or self._draining.pop(url, None)
            if w is None:
                raise KeyError(f"worker {url} not in the cluster")
            self._departed.add(url)
            self._epoch += 1
        if release:
            w.registry.clear()
            w.table_store.tables.clear()

    def drain_worker(self, url: str) -> None:
        """Graceful half of leave: accept no NEW tasks (the url drops out
        of `get_urls()`), keep serving in-flight work and staged peer
        producers, and become removable only once empty."""
        with self._lock:
            w = self._active.pop(url, None)
            if w is None:
                if url in self._draining:
                    return  # already draining
                raise KeyError(f"worker {url} not in the active membership")
            self._draining[url] = w
            self._epoch += 1

    # -- drain accounting ----------------------------------------------------
    def in_flight(self, url: str) -> int:
        """Tasks the worker still holds: registry entries (staged or
        executing) — zero plus an empty shipment store means drained."""
        with self._lock:
            w = self._active.get(url) or self._draining.get(url)
        return 0 if w is None else len(w.registry)

    def is_drained(self, url: str) -> bool:
        with self._lock:
            w = self._draining.get(url)
        return (
            w is not None
            and len(w.registry) == 0
            and not w.table_store.tables
        )

    def finish_drains(self) -> list[str]:
        """Remove every draining worker that reached empty; -> the removed
        urls. A draining worker still holding tasks/slices stays — the
        'removed only when empty' contract."""
        removed = []
        with self._lock:
            for url, w in list(self._draining.items()):
                if len(w.registry) == 0 and not w.table_store.tables:
                    del self._draining[url]
                    self._departed.add(url)
                    self._epoch += 1
                    removed.append(url)
        return removed

    def wait_drained(self, url: str, timeout_s: float = 10.0,
                     poll_s: float = 0.01) -> bool:
        """Block until ``url`` is drained (then remove it) or the timeout
        elapses; -> whether it drained."""
        import time as _time

        deadline = _time.monotonic() + timeout_s
        while _time.monotonic() < deadline:
            if self.is_drained(url):
                self.finish_drains()
                return True
            _time.sleep(poll_s)
        return False

    # -- introspection -------------------------------------------------------
    @property
    def workers(self) -> dict:
        """url -> Worker for every member still owning resources (active +
        draining) — the InMemoryCluster-compatible leak-check surface."""
        with self._lock:
            return {**self._active, **self._draining}

    def is_departed(self, url: str) -> bool:
        with self._lock:
            return url in self._departed

    def membership_snapshot(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "active": list(self._active.keys()),
                "draining": list(self._draining.keys()),
                "departed": sorted(self._departed),
            }


def _plan_device(plan: ExecutionPlan):
    """The device of a plan's leaf tables (where every stage runs)."""
    from datafusion_distributed_tpu_torch.plan.physical import (
        ParquetScanExec,
    )

    for leaf in plan.collect(lambda n: not n.children()):
        if isinstance(leaf, MemoryScanExec) and leaf.tasks:
            return leaf.tasks[0].device
        if isinstance(leaf, ParquetScanExec) and leaf.device is not None:
            return torch.device(leaf.device)
    return None


@dataclass
class Coordinator:
    resolver: WorkerResolver
    channels: ChannelResolver
    route_tasks: Optional[Callable] = None  # custom routing hook
    collect_metrics: bool = True
    metrics: dict = field(default_factory=dict)  # TaskKey -> worker metrics
    # (query_id, stage_id) -> streaming-plane stats (bytes/chunks/early_exit)
    stream_metrics: dict = field(default_factory=dict)  # per-query: swept-by sweep_query
    # `SET distributed.*` options propagated to every worker with the plan
    # (the config-over-headers flow, `config_extension_ext.rs:1-82`)
    config_options: dict = field(default_factory=dict)
    # user headers forwarded verbatim (`passthrough_headers.rs`)
    passthrough_headers: dict = field(default_factory=dict)
    # reject workers whose version differs (rolling-upgrade safety — the
    # reference's GetWorkerInfo + with_version, `worker_service.rs:175-179`)
    expected_version: Optional[str] = None
    # per-task execute-latency sketch, mergeable across queries
    latency: "object" = None
    # worker circuit breakers (runtime/health.py), created on first failure
    # and persistent across queries on this coordinator — a worker
    # quarantined by one query stays routed-around for the next
    health: "object" = None
    # retry/quarantine/timeout counters (runtime/metrics.py FaultCounters)
    faults: FaultCounters = field(default_factory=FaultCounters)
    # per-stage scheduler spans + query walls (runtime/metrics.py), the
    # observability surface of the stage-DAG scheduler: explain_analyze
    # renders them as a critical-path summary whose overlap factor
    # (sum stage wall / query wall) proves inter-stage overlap
    stage_metrics: MetricsStore = field(default_factory=MetricsStore)
    # -- multi-query serving hooks (runtime/serving.py) ---------------------
    # external stage scheduler: an object with submit(fn, cost_hint=0) ->
    # concurrent.futures.Future. When set, stage jobs (and the root stage)
    # run on the GLOBAL cross-query pool under its fair-share policy
    # instead of a per-query ThreadPoolExecutor — the generalization of
    # the per-query stage-DAG scheduler to the whole serving tier
    stage_pool: "object" = None
    # pre-installed per-query cancel event: lets an async QueryHandle
    # cancel a query BEFORE and DURING execute() without racing the
    # event's creation (execute reuses this one when present)
    cancel_event: "object" = None
    # called with the query_id after every execute() completes (success,
    # failure, or cancellation): the serving tier sweeps per-query chaos/
    # metrics state here so a long-lived process sheds resolved queries
    on_query_end: Optional[Callable[[str], None]] = None
    # distributed-tracing store (runtime/tracing.py). The process-wide
    # default backs `ctx.last_trace()` / `QueryHandle.trace()` /
    # explain_analyze's profile fold; per-query Tracers hang on
    # `self._tracer` for the execute's duration (NULL_TRACER when
    # `SET distributed.tracing` is off — the always-cheap-when-off path)
    trace_store: "object" = None
    # in-flight speculative-attempt budget (runtime/metrics.py
    # HedgeBudget), shared across every per-query coordinator under the
    # serving tier so the hedge stampede bound is cluster-wide; created
    # lazily on the first hedge decision otherwise
    hedges: "object" = None
    # per-query checkpoint facade (runtime/checkpoint.py
    # QueryCheckpointer): when set, every materialized (MemoryScan)
    # exchange boundary snapshots its consumer slices on completion and
    # restores them — fingerprint-validated — on a resumed execute
    checkpoints: "object" = None
    # cross-query result/sub-plan cache (runtime/result_cache.py
    # ResultCache): when set, materialized exchange boundaries save
    # their frontier under the subtree's pre-hoist fingerprint and a
    # LATER query sharing that prefix restores it instead of
    # re-executing the producer stage (checkpoint restore, which is
    # intra-query and validates against worker slices, wins first)
    result_cache: "object" = None
    # measured peak staged bytes attributed to this coordinator's
    # executes across the workers' TableStores (harvested by
    # sweep_query): the MEASURED side of the serving tier's
    # estimate-vs-reality admission loop
    staged_peak_bytes: int = 0
    # the device of the executing plan's leaf tables (set per execute)
    _device = None

    #: declarative concurrency model (tools/check_concurrency.py): the
    #: span caches are shared by sibling-stage fan-out threads, and every
    #: write outside execute's fresh reset must hold the named lock
    _GUARDED_BY = {
        "_span_shipped": "_span_lock",
        "_span_ok_cache": "_span_lock",
    }


    def _tr(self):
        """The current query's tracer (NULL_TRACER outside execute or with
        tracing off): one unconditional accessor so every instrumentation
        site stays a plain call, never a branch tree."""
        return getattr(self, "_tracer", NULL_TRACER)

    def _event(self, name: str, **attrs) -> None:
        """One fault-path transition, fanned to BOTH sinks: the query's
        trace-event stream (visible when `SET distributed.tracing` is
        on) and the always-on structured event log
        (runtime/eventlog.py), stamped with this query's id — so logs,
        traces, and the `dftpu_faults` counters correlate on the same
        query/stage/task ids instead of the old trace-only asymmetry."""
        self._tr().event(name, **attrs)
        from datafusion_distributed_tpu_torch.runtime.eventlog import log_event

        log_event(name, query_id=getattr(self, "last_query_id", None),
                  **attrs)

    def last_query_trace(self):
        """The most recent query's QueryTrace on this coordinator (None
        without tracing). Naming convention across surfaces:
        ``*query_trace()`` returns the QueryTrace object,
        ``trace()``/``last_trace()`` (QueryHandle / SessionContext)
        return the exported Chrome trace-event dict."""
        qid = getattr(self, "last_query_id", None)
        store = self.trace_store or DEFAULT_TRACE_STORE
        return store.get(qid) if qid else None

    def overlap_factor(self, query_id: Optional[str] = None):
        """sum(stage wall) / query wall for ``query_id`` (default: most
        recent). >1.0 means independent stages genuinely overlapped."""
        return self.stage_metrics.stage_schedule_summary(query_id).get(
            "overlap_factor"
        )

    def execute(self, plan: ExecutionPlan) -> Table:
        """Run a distributed plan (exchange-staged) across the workers and
        return the (replicated) root result."""
        from datafusion_distributed_tpu_torch.plan.verify import (
            enforce_verification,
        )
        from datafusion_distributed_tpu_torch.runtime.metrics import LatencySketch

        # static verification BEFORE any dispatch (plan/verify.py): a
        # malformed staged plan is rejected here — the cheapest point — so
        # no worker compiles/executes against it. Memoized on the plan
        # object, so the retry loops' re-submissions verify once.
        enforce_verification(plan, options=self.config_options,
                             context="coordinator pre-dispatch")
        # every stage runs on the device of the plan's leaf tables; an
        # empty slice made here takes that device too
        self._device = _plan_device(plan)
        # push the enforced worker memory budget (when configured) to the
        # in-process workers BEFORE the first dispatch: dispatch encodes
        # stage slices into the destination store ahead of set_plan, so
        # the budget must be live by then
        self._apply_worker_budgets()
        if self.latency is None:
            self.latency = LatencySketch()
        if self.expected_version is not None:
            self._check_worker_versions()
        query_id = uuid.uuid4().hex
        # stamp the submitted plan object with its query id so
        # explain_analyze can bind the stage-schedule block to THIS
        # query's spans (a long-lived coordinator holds spans for many)
        plan._last_query_id = query_id
        self.last_query_id = query_id
        # distributed tracing (runtime/tracing.py): NULL_TRACER when off
        trace_store = self.trace_store or DEFAULT_TRACE_STORE
        try:
            sample_rate = float(
                self.config_options.get("tracing_sample_rate", 0.125)
            )
        except (TypeError, ValueError):
            sample_rate = 0.125
        self._tracer = trace_store.begin(
            query_id, resolve_tracing_mode(self.config_options),
            sample_rate=sample_rate,
        )
        # fresh per execute: stage ids repeat across queries, and a stale
        # hint map would stamp the PREVIOUS query's planner estimates
        # onto this query's stage spans
        self._stage_span_hints = {}
        # producer tasks shipped but never coordinator-executed (peer data
        # plane): released at query end — the reference's query-end EOS
        # notifier role (`query_coordinator.rs:188-192`)
        self._peer_shipped: list = []
        # (query_id, stage_id) -> (prepared producer plan, t_prod, ttl):
        # the re-ship source when a worker holding a shipped peer-producer
        # plan departs the membership mid-query (_heal_departed_peers)
        self._peer_plan_registry: dict = {}  # per-query: swept-by sweep_query
        # accumulated ACROSS heal passes (healing is incremental — each
        # failing consumer heals when IT retries, possibly long after the
        # pass that moved a producer): producer key tuple -> the url now
        # serving it, and the set of shipped copies whose on-worker plan
        # pre-dates a spec rewrite and must be refreshed before trusted
        self._peer_url_map: dict = {}  # per-query: swept-by sweep_query
        self._peer_stale: set = set()  # per-query: swept-by sweep_query
        # per-query caches (span plans are keyed by query_id; the plan-walk
        # verdicts key by (query, stage)). The lock serializes span
        # check-and-ship: concurrent stage tasks of one span must not
        # double-ship (the span would run twice and the first shipment
        # would leak).
        self._span_shipped: dict = {}
        self._span_ok_cache: dict = {}
        import time as _time
        import threading as _threading

        self._span_lock = _threading.Lock()
        self._peer_heal_lock = _threading.Lock()

        # per-query cancel event: the FIRST fatal error sets it, and every
        # dispatch/execute path checks it before doing work — a failed
        # sibling stage/task cancels in-flight and not-yet-submitted work
        # instead of leaving orphaned tasks running (and their staged
        # TableStore slices leaking until TTL). FRESH per execute: the
        # overflow-retry loops re-enter execute() on this same object, and
        # a stale set event would abort every retry as cancelled. The
        # separate `cancel_event` field (the serving tier's
        # QueryHandle.cancel surface) is a read-only cancel REQUEST this
        # coordinator never sets — _check_cancelled honors both, so an
        # external cancel reaches any execute attempt without being
        # conflated with one attempt's internal teardown.
        self._cancel_event = _threading.Event()
        # hedge-attempt threads spawned this execute (appends are
        # GIL-atomic single-op list mutations like _peer_shipped, so no
        # lock is declared): joined in the finally below so every
        # loser's cleanup lands before the query resolves — the leak
        # gates observe a quiesced store, never a racing release
        self._hedge_threads: list = []
        # pipelined-shuffle feeder threads (one per pipelined boundary;
        # GIL-atomic appends like _hedge_threads): joined in the finally
        # so producer-side cleanup (task invalidation, staged-slice
        # release inside the pull retry loops) lands before the query
        # resolves and the leak gates observe a quiesced store
        self._stream_feeds: list = []
        # one `query_resumed` event per execute, on the first restore
        self._resume_traced = False
        if self.checkpoints is not None:
            # stamp this execute in the checkpoint session and
            # fingerprint the pristine exchange subtrees (restore keys)
            try:
                self.checkpoints.begin_execute(plan)
            except Exception:
                self.checkpoints = None  # never fail the query for it
        if self.result_cache is not None:
            # stamp this execute's pre-hoist exchange fingerprints so
            # boundaries can restore frontiers a PRIOR query produced
            # (cross-query sub-plan sharing, runtime/result_cache.py)
            try:
                self.result_cache.begin_query(query_id, plan)
            except Exception:
                self.result_cache = None  # never fail the query for it
        # pin this query's spans against the shared store's LRU for as
        # long as it runs (runtime/metrics.py begin/finish_query)
        self.stage_metrics.begin_query(query_id)
        q_t0 = _time.monotonic()
        tracer = self._tracer
        qspan = tracer.start_span("query", "query", query_id=query_id)
        if tracer.active:
            tracer.trace.root_id = qspan.span_id
        try:
            resolved = self._materialize_exchanges(plan, query_id)
            # the root stage: a single consumer task — routed through the
            # global serving pool when one is installed, so even a
            # single-stage query's heavy consumer competes under the
            # fair-share policy instead of bypassing it on this thread
            r_sub = _time.monotonic()
            if self.stage_pool is not None:
                fut = self.stage_pool.submit(
                    lambda: (_time.monotonic(), self._run_stage_task(
                        resolved, query_id, -1, 0, 1
                    ))
                )
                r_t0, out = fut.result()
            else:
                r_t0 = r_sub
                out = self._run_stage_task(
                    resolved, query_id, stage_id=-1, task_number=0,
                    task_count=1,
                )
            r_t1 = _time.monotonic()
            self.stage_metrics.record_stage_span(
                query_id, -1, r_sub, r_t0, r_t1, plane="root"
            )
            self._trace_stage_span(-1, r_sub, r_t0, r_t1, "root")
            self.stage_metrics.record_query_wall(
                query_id, r_t1 - q_t0
            )
            return out
        except BaseException:
            self._signal_cancel()
            raise
        finally:
            # drain hedge attempts FIRST: a loser's thread owns releasing
            # its staged slices, and the cancel plumbing (interruptible
            # chaos delays, per-attempt events) makes these joins short on
            # cancellable surfaces. A loser mid-compute on a surface with
            # NO cancel parameter (plain in-process Worker) cannot be
            # interrupted from Python — a final-stage straggler can then
            # hold query COMPLETION (not the result) until it finishes or
            # the join budget expires; `task_timeout_s` bounds that wall
            # when set
            for t in self._hedge_threads:
                t.join(timeout=30.0)
            # drain pipelined feeders: on success they already finished
            # (the root stage consumed every partition); on failure the
            # cancel event stops their pullers at the next checkpoint —
            # either way their per-task cleanup runs before the query
            # resolves
            for t in self._stream_feeds:
                t.join(timeout=30.0)
            # release THIS query's shipped peer producers promptly (their
            # per-entry TTL is only the crash backstop, not the release
            # path — DFTPU301/307); sweep_query re-runs the same helper
            # idempotently for direct _peer_boundary users
            self._release_peer_tasks(query_id)
            self._drop_heal_state(query_id)
            # close the trace AFTER the peer sweep so last-drop worker
            # spans (peer producers report at query end) still splice
            tracer.end_span(qspan)
            trace_store.finish(query_id)
            self._tracer = NULL_TRACER
            self.stage_metrics.finish_query(query_id)
            if self.on_query_end is not None:
                try:
                    self.on_query_end(query_id)
                except Exception:
                    pass  # sweep hook must not mask the query's error

    def _apply_worker_budgets(self) -> None:
        """Apply `distributed.worker_memory_budget_bytes` (when present
        in the session config) to every reachable in-process worker
        store. Best-effort and idempotent; absent knob leaves env-set
        budgets untouched."""
        budget = self.config_options.get("worker_memory_budget_bytes")
        if budget is None:
            return
        try:
            urls = self.resolver.get_urls()
        except Exception:
            return
        for url in urls:
            try:
                store = getattr(self.channels.get_worker(url),
                                "table_store", None)
                if store is not None and hasattr(store, "set_budget"):
                    store.set_budget(budget)
            except Exception:
                pass  # a departed worker

    def _store_pressure_probe(self):
        """Producer-backpressure probe over the live workers' stores
        (None when no store exposes one — wire transports): True while
        ANY destination store is over its enforced budget, which the
        stream planes' StreamBudget turns into trickle-paced producers
        instead of a budget overrun."""
        try:
            urls = list(self.resolver.get_urls())
        except Exception:
            return None
        stores = []
        for url in urls:
            try:
                store = getattr(self.channels.get_worker(url),
                                "table_store", None)
            except Exception:
                continue
            if store is not None and hasattr(store, "under_pressure"):
                stores.append(store)
        if not stores:
            return None

        def probe() -> bool:
            return any(s.under_pressure() for s in stores)

        return probe

    def _release_peer_tasks(self, query_id: str) -> None:
        """Release every shipped peer-producer task belonging to
        ``query_id`` and forget it. Idempotent — released entries are
        removed from ``_peer_shipped``, so execute's finally and
        ``sweep_query`` can both call this (the latter covers direct
        ``_peer_boundary`` users that never enter execute)."""
        shipped = getattr(self, "_peer_shipped", None)
        if not shipped:
            return  # coordinator never executed (or nothing shipped)
        remaining = []
        for worker, key in list(shipped):
            if key.query_id != query_id:
                remaining.append((worker, key))
                continue
            try:
                # peer producers report metrics at query end (the
                # last-drop metrics flush rides no coordinator stream
                # to observe earlier)
                self._record_task_progress(worker, key)
            except Exception:
                pass
            try:
                if hasattr(worker, "release_task"):
                    worker.release_task(key)
                else:
                    worker.registry.invalidate(key)
            except Exception:
                pass  # cleanup must not mask the query's own error
        shipped[:] = remaining

    def sweep_query(self, query_id: str) -> None:
        """Drop THIS query's accumulated per-task/stream metrics — the
        unbounded per-query dicts a long-lived serving coordinator would
        otherwise grow forever (stage spans are separately LRU-bounded in
        MetricsStore and stay for explain_analyze). Callers that want the
        data harvest it before sweeping; the serving tier calls this from
        `on_query_end` once the QueryHandle captured its summary.
        Also harvests the query's per-store staging attribution into
        `staged_peak_bytes` (summed across workers, maxed across this
        coordinator's executes) — the measured peak the serving tier
        re-costs admission with."""
        peak = 0
        try:
            urls = list(self.resolver.get_urls())
        except Exception:
            urls = []
        for url in urls:
            try:
                store = getattr(self.channels.get_worker(url),
                                "table_store", None)
                if store is not None and hasattr(
                    store, "sweep_query_attribution"
                ):
                    peak += store.sweep_query_attribution(query_id)
            except Exception:
                pass  # departed worker: its attribution died with it
        if peak > self.staged_peak_bytes:
            self.staged_peak_bytes = peak
        if self.result_cache is not None:
            # shed this execute's sub-plan fingerprint map (the cached
            # frontiers themselves stay — they are the cross-query point)
            try:
                self.result_cache.end_query(query_id)
            except Exception:
                pass
        # list() snapshots are taken in C (no GIL release) so sweeping one
        # query never races another in-flight query's inserts
        for key in [k for k in list(self.metrics) if k.query_id == query_id]:
            self.metrics.pop(key, None)
        for key in [
            k for k in list(self.stream_metrics) if k[0] == query_id
        ]:
            self.stream_metrics.pop(key, None)
        # peer-plane state: release any still-shipped producer tasks and
        # drop the query's re-ship plans and heal bookkeeping (both
        # re-entrant no-ops after execute's finally)
        self._release_peer_tasks(query_id)
        self._drop_heal_state(query_id)
        spans = getattr(self, "_span_shipped", None)
        ok = getattr(self, "_span_ok_cache", None)
        if spans or ok:
            with self._span_lock:
                for k in [k for k in (spans or ()) if k[0] == query_id]:
                    spans.pop(k, None)
                # the ok-cache shares the span lock with the shipment map:
                # _try_dispatch_span checks and inserts under it
                for k in [k for k in (ok or ()) if k[0] == query_id]:
                    ok.pop(k, None)
        # query end is the leak-harness checkpoint: any tracked resource
        # still attributed to this query is a leak
        from datafusion_distributed_tpu_torch.runtime import leakcheck

        leakcheck.sweep_query(query_id)

    def _drop_heal_state(self, query_id: str) -> None:
        """Drop ``query_id``'s re-ship plans and heal bookkeeping. The
        retained producer plans pin the device tables their scans hold,
        so execute's finally drops them as soon as the query's peer
        producers are released (a reused coordinator would otherwise
        hold the last query's tables until its next execute)."""
        plans = getattr(self, "_peer_plan_registry", None)
        if plans:
            for k in [k for k in list(plans) if k[0] == query_id]:
                plans.pop(k, None)
        heal_lock = getattr(self, "_peer_heal_lock", None)
        if heal_lock is not None:
            with self._peer_heal_lock:
                url_map = getattr(self, "_peer_url_map", None) or {}
                for k in [k for k in list(url_map) if k[0] == query_id]:
                    url_map.pop(k, None)
                stale = getattr(self, "_peer_stale", None) or set()
                for k in [k for k in list(stale) if k[0] == query_id]:
                    stale.discard(k)

    def _check_worker_versions(self) -> None:
        from datafusion_distributed_tpu_torch.runtime.errors import WorkerError

        for url in self.resolver.get_urls():
            info = self.channels.get_worker(url).get_info()
            v = info.get("version")
            if v != self.expected_version:
                raise WorkerError(
                    f"version skew: worker {url} runs {v!r}, coordinator "
                    f"expects {self.expected_version!r}",
                    worker_url=url,
                )

    # -- stage materialization ----------------------------------------------
    def _materialize_exchanges(
        self, plan: ExecutionPlan, query_id: str
    ) -> ExecutionPlan:
        """Materialize every exchange boundary, bottom-up.

        Two schedulers produce byte-identical results:

        - `stage_parallelism > 1` (default: the worker count): the stage-
          DAG scheduler — one pass builds the dependency graph of
          exchange subtrees (planner/distributed.py build_stage_dag),
          then every dependency-free stage is submitted to a bounded pool
          concurrently and consumers release as their feeds materialize.
          Sibling subtrees — a hash join's build and probe sides, the
          producer stages of every co-shuffled group, union branches —
          overlap across the cluster instead of idling the worker pool
          between them (the reference's concurrent async fan-out,
          `query_coordinator.rs:140-222`).
        - `stage_parallelism = 1`, or a plan build_stage_dag cannot
          schedule: the sequential depth-first recursion (pre-scheduler
          behavior).
        """
        par = self._stage_parallelism()
        dag = None
        if par > 1 or self.stage_pool is not None:
            from datafusion_distributed_tpu_torch.planner.distributed import (
                build_stage_dag,
            )

            dag = build_stage_dag(plan)
        tr = self._tr()
        if tr.active and dag is not None:
            # planner stage cost hints become span attributes: the stage
            # spans recorded later pick these up by stage id
            self._stage_span_hints = {
                sid: n.span_attrs() for sid, n in dag.nodes.items()
            }
        if dag is None or (
            len(dag.nodes) <= 1 and self.stage_pool is None
        ):
            # a global serving pool routes even single-stage plans through
            # the DAG path so every stage competes under the fair-share
            # policy; without one a single stage gains nothing from it
            with tr.span("schedule", "schedule", mode="sequential"):
                return self._materialize_exchanges_sequential(
                    plan, query_id
                )
        with tr.span("schedule", "schedule", mode="dag",
                     stages=len(dag.nodes), parallelism=par):
            return self._materialize_exchanges_dag(plan, query_id, dag, par)

    def _stage_parallelism(self) -> int:
        """`SET distributed.stage_parallelism`: the in-flight stage budget
        (memory control — every in-flight stage holds its producer outputs).
        0/unset = auto: the LIVE worker count at query start (task routing
        inside each stage re-resolves membership per dispatch, so joiners
        still receive tasks even though the stage budget is fixed)."""
        n = self._opt_int("stage_parallelism")
        if n <= 0:
            n = self._live_worker_count()
        return n

    # -- membership awareness -------------------------------------------------
    def _membership_token(self, urls=None):
        """Cache key for everything derived from cluster membership. An
        epoch-versioned resolver (DynamicCluster) keys by its monotonic
        `membership_epoch`; static resolvers key by the url tuple itself,
        so even a user mutating `InMemoryCluster.workers` between
        dispatches invalidates the derived caches."""
        ep = getattr(self.resolver, "membership_epoch", None)
        if isinstance(ep, int):
            return ("epoch", ep)
        if urls is None:
            try:
                urls = self.resolver.get_urls()
            except Exception:
                urls = []
        return ("urls", tuple(urls))

    def _note_membership(self, urls=None):
        """Observe the current membership; on a CHANGE, prune
        health/quarantine state for workers that departed — a shrunk or
        grown cluster must not carry breaker state for endpoints that no
        longer exist. Per-membership caches (peer capability, mesh span
        width) are not cleared here — each stores the token it was
        computed under and is ignored on mismatch, so a slow probe racing
        a membership change can only install a verdict stamped with its
        own stale token, never poison the new epoch."""
        tok = self._membership_token(urls)
        if tok == getattr(self, "_membership_seen", None):
            return tok
        self._membership_seen = tok
        self._event(
            "membership_change",
            epoch=tok[1] if tok[0] == "epoch" else None,
        )
        if self.health is not None:
            for _u in self.health.prune(self._full_membership_urls()):
                self.faults.bump("health_entries_pruned")
        return tok

    def _full_membership_urls(self) -> list[str]:
        """Active + draining urls — the set that still owns resources.
        Draining workers keep their health state (they are finishing
        work); only truly departed workers are pruned."""
        snap = getattr(self.resolver, "membership_snapshot", None)
        if callable(snap):
            try:
                s = snap()
                return list(s.get("active", ())) + list(
                    s.get("draining", ())
                )
            except Exception:
                pass
        try:
            return self.resolver.get_urls()
        except Exception:
            return []

    def _live_worker_count(self) -> int:
        try:
            urls = self.resolver.get_urls()
        except Exception:
            return 1
        self._note_membership(urls)
        return max(len(urls), 1)

    def _zero_copy(self) -> bool:
        """`SET distributed.zero_copy` (default on): the view-based data
        plane — host-view regroup/chunking and buffer-sharing staging."""
        from datafusion_distributed_tpu_torch.ops.table import zero_copy_enabled

        return zero_copy_enabled(self.config_options)

    def _materialize_exchanges_sequential(
        self, plan: ExecutionPlan, query_id: str
    ) -> ExecutionPlan:
        children = [
            self._materialize_exchanges_sequential(c, query_id)
            for c in plan.children()
        ]
        if children:
            plan = self._bailout_multiway(
                self._widen_bailed_out_merge(
                    plan.with_new_children(children)
                ),
                query_id,
            )
        if not getattr(plan, "is_exchange", False):
            return plan
        import time as _time

        t0 = _time.monotonic()
        scan = self._materialize_exchange_node(
            plan, plan.children()[0], query_id
        )
        sid = plan.stage_id if plan.stage_id is not None else 0
        if isinstance(scan, StreamScanExec):
            # pipelined boundary reached through the sequential fallback
            # (e.g. an unschedulable hand-built plan at parallelism > 1):
            # the span records at feed completion like the DAG path
            scan.feed.on_complete(
                lambda end_s, s=sid, t=t0:
                self._record_stage_span(query_id, s, t, t, end_s)
            )
        else:
            self._record_stage_span(query_id, sid, t0, t0,
                                    _time.monotonic())
        return scan

    def _materialize_exchanges_dag(
        self, plan: ExecutionPlan, query_id: str, dag, parallelism: int
    ) -> ExecutionPlan:
        """Event-driven stage scheduler: submit every dependency-free stage
        to a bounded pool, release consumers as their feeds materialize.
        All DAG bookkeeping runs on THIS thread (no lock needed); stage
        jobs only materialize their own exchange. The first fatal error
        sets the per-query cancel event — in-flight stages abort at their
        next dispatch/execute checkpoint and release their staged slices,
        not-yet-ready stages never submit — and the error re-raises after
        the in-flight jobs drained (deterministic teardown)."""
        import concurrent.futures as cf
        import time as _time

        nodes = dag.nodes
        resolved: dict = {}  # stage_id -> consumer-side scan

        def resolve(node: ExecutionPlan) -> ExecutionPlan:
            # rebuild `node`'s subtree with every frontier exchange
            # replaced by its materialized scan (never descends past an
            # exchange boundary — nested exchanges live inside their
            # consumer's already-resolved subtree)
            if getattr(node, "is_exchange", False):
                return resolved[node.stage_id]
            children = [resolve(c) for c in node.children()]
            if not children:
                return node
            return self._bailout_multiway(
                self._widen_bailed_out_merge(
                    node.with_new_children(children)
                ),
                query_id,
            )

        try:
            waiting = {sid: set(n.deps) for sid, n in nodes.items()}
            consumers = dag.consumers_map()
            first_error: Optional[BaseException] = None
            first_cancel: Optional[BaseException] = None

            def job(exchange, submit_s):
                self._check_cancelled()
                t0 = _time.monotonic()
                producer = resolve(exchange.children()[0])
                scan = self._materialize_exchange_node(
                    exchange, producer, query_id
                )
                if isinstance(scan, StreamScanExec):
                    # pipelined boundary: the job resolved at FIRST SLICE —
                    # consumers release now while producers keep streaming.
                    # The stage span is recorded by the feed at COMPLETION
                    # (same submit/start as the materialized plane would
                    # use), so overlap-factor/explain_analyze keep covering
                    # the stage's true production window.
                    sid = (exchange.stage_id
                           if exchange.stage_id is not None else 0)
                    scan.feed.on_complete(
                        lambda end_s, s=sid, sub=submit_s, t=t0:
                        self._record_stage_span(query_id, s, sub, t, end_s)
                    )
                    return scan, submit_s, t0, None
                return scan, submit_s, t0, _time.monotonic()

            # the stage jobs' executor: a per-query bounded pool, or — under
            # the serving tier — the GLOBAL cross-query scheduler installed
            # as `stage_pool`, whose fair-share policy decides which
            # query's ready stage gets the next slot (runtime/serving.py).
            # Either way this thread keeps all DAG bookkeeping; only the
            # job placement policy changes.
            ext = self.stage_pool
            pool = None
            if ext is None:
                pool = cf.ThreadPoolExecutor(
                    max_workers=parallelism, thread_name_prefix="dftpu-stage"
                )
            try:
                futs: dict = {}
                # ready-but-unsubmitted stage ids: with the EXTERNAL pool
                # the per-query `stage_parallelism` budget still bounds
                # THIS query's in-flight stages (every in-flight stage
                # holds its producer outputs); the global pool's slots
                # bound the tier, not the query. The internal pool needs
                # no backlog: max_workers IS the bound.
                backlog: list = []

                def submit(sid: int) -> None:
                    node = nodes[sid]
                    sub_t = _time.monotonic()
                    if ext is not None:
                        fut = ext.submit(
                            lambda e=node.exchange, t=sub_t: job(e, t),
                            cost_hint=node.est_bytes,
                        )
                    else:
                        fut = pool.submit(job, node.exchange, sub_t)
                    futs[fut] = sid

                def enqueue(sid: int) -> None:
                    if ext is not None and len(futs) >= parallelism:
                        backlog.append(sid)
                    else:
                        submit(sid)

                for sid in sorted(
                    s for s, deps in waiting.items() if not deps
                ):
                    enqueue(sid)
                replan_active = False
                while futs:
                    done, _ = cf.wait(
                        list(futs), return_when=cf.FIRST_COMPLETED
                    )
                    for f in sorted(done, key=lambda f: futs[f]):
                        sid = futs.pop(f)
                        try:
                            scan, sub_s, t0, t1 = f.result()
                        except TaskCancelledError as e:
                            if first_cancel is None:
                                first_cancel = e
                            continue
                        except BaseException as e:
                            if first_error is None:
                                first_error = e
                            self._signal_cancel()
                            continue
                        resolved[sid] = scan
                        if t1 is not None:  # pipelined spans record at feed
                            self._record_stage_span(query_id, sid, sub_s, t0,
                                                    t1)
                        # closed-loop re-cost: a stage whose measured output
                        # cardinality diverged far from its estimate rescales
                        # the not-yet-submitted downstream frontier, so the
                        # backlog promotion below dispatches cheapest-first
                        # on CORRECTED bytes (scheduling only — plan
                        # structure and results are untouched)
                        if self._maybe_replan(
                            query_id, sid, nodes, scan,
                            set(futs.values()) | set(resolved),
                        ):
                            replan_active = True
                        for c in sorted(consumers.get(sid, ())):
                            waiting[c].discard(sid)
                            if not waiting[c] and first_error is None and (
                                not self._cancelled()
                            ):
                                enqueue(c)
                    # freed budget: promote backlogged ready stages (in
                    # deterministic stage-id order; after a replan, in
                    # deterministic corrected-cost order)
                    if backlog and first_error is None and (
                        not self._cancelled()
                    ):
                        if replan_active:
                            backlog.sort(key=lambda s: (
                                int(nodes[s].est_bytes or 0), s))
                        else:
                            backlog.sort()
                        while backlog and len(futs) < parallelism:
                            submit(backlog.pop(0))
            finally:
                if pool is not None:
                    pool.shutdown(wait=True)
            if first_error is not None:
                # raised from a local that the traceback's frame holds:
                # drop the local, or exception, traceback and frame form a
                # cycle that keeps the failed stages' device tables alive
                # until the next full garbage collection
                err, first_error = first_error, None
                try:
                    raise err
                finally:
                    del err
            if first_cancel is not None:
                # only cancellations surfaced: something upstream (another
                # thread sharing this coordinator) set the event — propagate
                raise first_cancel
            # a cancel can land in the window where every in-flight job
            # completes cleanly: downstream stages are then silently skipped
            # (the enqueue gate), futs drains, and neither error slot is set —
            # resolving the partial frontier would KeyError on a stage that
            # never ran. Surface the cancel like a job would have.
            self._check_cancelled()
            return resolve(plan)
        finally:
            # `resolve` calls itself (a recursive closure, so a reference
            # cycle): drop the scans it captured, or the cycle keeps their
            # device tables alive until the next full garbage collection
            resolved.clear()

    def _record_stage_span(self, query_id: str, stage_id: int,
                           submit_s: float, start_s: float,
                           end_s: float) -> None:
        sm = self.stream_metrics.get((query_id, stage_id))
        plane = (sm.get("plane", "stream") if sm else "bulk")
        self.stage_metrics.record_stage_span(
            query_id, stage_id, submit_s, start_s, end_s, plane=plane
        )
        self._trace_stage_span(stage_id, submit_s, start_s, end_s, plane)

    def _trace_stage_span(self, stage_id: int, submit_s: float,
                          start_s: float, end_s: float,
                          plane: str) -> None:
        """Record a stage's trace span under the pre-reserved stage span
        id (task spans created while the stage ran already parent to it);
        planner cost hints (StageDagNode.span_attrs) ride as attributes."""
        tr = self._tr()
        if not tr.active:
            return
        attrs = dict(getattr(self, "_stage_span_hints", {}).get(
            stage_id, ()
        ))
        attrs.update(
            stage=stage_id, plane=plane,
            queue_s=round(max(start_s - submit_s, 0.0), 6),
        )
        tr.finish_reserved(
            ("stage", stage_id),
            "root" if stage_id == -1 else f"stage {stage_id}",
            "stage", submit_s, end_s, **attrs,
        )

    # -- per-query cancellation ---------------------------------------------
    def _cancelled(self) -> bool:
        """Whether this query should stop: the per-execute internal event
        (a sibling stage/task failed fatally) OR the externally-owned
        cancel request (serving-tier QueryHandle.cancel)."""
        ev = getattr(self, "_cancel_event", None)
        if ev is not None and ev.is_set():
            return True
        ext = self.cancel_event
        return ext is not None and ext.is_set()

    def _check_cancelled(self) -> None:
        """Raise if this query's cancel event is set (a sibling stage or
        task already failed fatally, or an external cancel request).
        Checked at every dispatch/execute boundary so orphaned work stops
        instead of running to completion against a query that can no
        longer succeed."""
        if self._cancelled():
            self._event("task_cancelled")
            raise TaskCancelledError(
                "query cancelled: a sibling stage/task failed or the "
                "caller cancelled"
            )

    def _signal_cancel(self) -> None:
        ev = getattr(self, "_cancel_event", None)
        if ev is not None:
            if not ev.is_set():
                self._event("query_cancel")
            ev.set()

    def _materialize_exchange_node(
        self, plan: ExecutionPlan, producer: ExecutionPlan, query_id: str
    ) -> ExecutionPlan:
        """Materialize ONE exchange whose producer subtree is fully
        resolved (every nested boundary already a scan): run the producer
        stage through the appropriate data plane and return the
        consumer-side scan."""
        stage_id = plan.stage_id if plan.stage_id is not None else 0
        t_prod = self._producer_task_count(plan, producer)
        tr = self._tr()
        with tr.span("exchange", "exchange",
                     parent=tr.reserved_id(("stage", stage_id)),
                     stage=stage_id, exchange=type(plan).__name__,
                     producer_tasks=t_prod):
            restored = self._restore_stage_checkpoint(
                plan, producer, query_id, stage_id
            )
            if restored is not None:
                return restored
            restored = self._restore_subplan_cache(
                plan, producer, query_id, stage_id
            )
            if restored is not None:
                return restored
            scan = self._materialize_exchange_body(
                plan, producer, query_id, stage_id, t_prod
            )
            self._save_stage_checkpoint(query_id, stage_id, t_prod, scan)
            self._save_subplan_cache(query_id, stage_id, t_prod, scan)
            return scan

    # -- query checkpoint/resume (runtime/checkpoint.py) ---------------------
    def _checkpoint_eligible(self) -> bool:
        """Whether this coordinator's stage lattices are deterministic
        enough to snapshot/restore (the AdaptiveCoordinator re-derives
        consumer counts from runtime LoadInfo and opts out)."""
        return True

    def _restore_stage_checkpoint(self, plan, producer, query_id: str,
                                  stage_id: int):
        """Consumer-side scan rebuilt from a valid stage checkpoint, or
        None (no checkpointer / miss / fingerprint mismatch / staged-
        slice loss — the latter two re-execute the stage, whose own
        producers still restore from THEIR checkpoints: the partially-
        lost-frontier heal)."""
        ck = self.checkpoints
        if ck is None or not self._checkpoint_eligible():
            return None
        hit, reason = ck.restore(stage_id)
        if hit is None:
            if reason == "fp_mismatch":
                self.faults.bump("checkpoint_fp_mismatch")
                self._event("checkpoint_fp_mismatch", stage=stage_id)
            elif reason == "slice_lost":
                self.faults.bump("checkpoint_slices_lost")
                self._event("checkpoint_slices_lost", stage=stage_id)
            return None
        slices, replicated, pinned, _t_prod = hit
        scan = MemoryScanExec(slices, producer.schema(), pinned=pinned,
                              replicated=replicated)
        self.faults.bump("checkpoint_stages_restored")
        if not self._resume_traced:
            # first restored stage of this execute: the query is resuming
            self._resume_traced = True
            self.faults.bump("queries_resumed")
            self._event("query_resumed", stage=stage_id)
        self.stream_metrics[(query_id, stage_id)] = {
            "plane": "checkpoint",
            "coordinator_bytes": 0,
            "partitions": len(slices),
        }
        self._seed_consumer_scan(plan, scan)
        return scan

    def _save_stage_checkpoint(self, query_id: str, stage_id: int,
                               t_prod: int, scan) -> None:
        """Snapshot a just-materialized boundary. Only MemoryScan results
        checkpoint — a peer-plane boundary's data never materialized on
        the coordinator (its producers re-ship through the peer-heal
        path instead)."""
        ck = self.checkpoints
        if ck is None or not self._checkpoint_eligible():
            return
        if type(scan) is not MemoryScanExec:
            return
        if getattr(scan, "bailout_raw_rows", False):
            # a bailed-out boundary carries raw rows at a widened
            # capacity; a restore could not re-derive the consumer-side
            # merge widening (the annotation dies with the scan), so
            # this stage re-executes instead of restoring
            return
        staged = ck.save(stage_id, list(scan.tasks), scan.replicated,
                         scan.pinned, t_prod)
        if staged is not None:
            self.faults.bump("checkpoint_stages_saved")
            self._event(
                "checkpoint_saved", stage=stage_id,
                slices=len(scan.tasks), bytes=staged,
            )

    # -- cross-query sub-plan cache (runtime/result_cache.py) -----------------
    def _restore_subplan_cache(self, plan, producer, query_id: str,
                               stage_id: int):
        """Consumer-side scan rebuilt from a frontier a PRIOR query
        cached under this exchange subtree's pre-hoist fingerprint, or
        None. Slices come from the cache's own store (never a worker),
        so a restore is correct under any membership churn. Shares the
        checkpoint tier's eligibility gate: an adaptive coordinator's
        runtime-derived lattices opt out of both."""
        rc = self.result_cache
        if rc is None or not self._checkpoint_eligible():
            return None
        try:
            hit = rc.restore_subplan(query_id, stage_id)
        except Exception:
            return None  # cache trouble must never fail the query
        if hit is None:
            return None
        slices, replicated, pinned, _t_prod = hit
        scan = MemoryScanExec(slices, producer.schema(), pinned=pinned,
                              replicated=replicated)
        self.faults.bump("subplan_cache_stages_restored")
        self._event("subplan_cache_restored", stage=stage_id,
                    slices=len(slices))
        self.stream_metrics[(query_id, stage_id)] = {
            "plane": "result-cache",
            "coordinator_bytes": 0,
            "partitions": len(slices),
        }
        self._seed_consumer_scan(plan, scan)
        return scan

    def _save_subplan_cache(self, query_id: str, stage_id: int,
                            t_prod: int, scan) -> None:
        """Offer a just-materialized boundary to the cross-query cache.
        Same guards as `_save_stage_checkpoint`: only MemoryScan
        results (a peer-plane boundary never materialized here) and
        never a bailed-out boundary (its widened-capacity annotation
        dies with the scan)."""
        rc = self.result_cache
        if rc is None or not self._checkpoint_eligible():
            return
        if type(scan) is not MemoryScanExec:
            return
        if getattr(scan, "bailout_raw_rows", False):
            return
        try:
            staged = rc.save_subplan(
                query_id, stage_id, list(scan.tasks), scan.replicated,
                scan.pinned, t_prod,
            )
        except Exception:
            return
        if staged is not None:
            self._event("subplan_cache_saved", stage=stage_id,
                        slices=len(scan.tasks), bytes=staged)


    def _materialize_exchange_body(
        self, plan: ExecutionPlan, producer: ExecutionPlan, query_id: str,
        stage_id: int, t_prod: int,
    ) -> ExecutionPlan:
        if self._peer_plane_enabled(plan):
            scan = self._peer_boundary(plan, producer, query_id, stage_id,
                                       t_prod)
            if scan is not None:
                self._seed_consumer_scan(plan, scan)
                return scan
        if isinstance(plan, PartitionReplicatedExec):
            # producer is replicated: one task's output carries everything
            outputs = [
                self._run_stage_task(producer, query_id, stage_id, 0, t_prod)
            ]
        elif isinstance(
            plan, (CoalesceExchangeExec, BroadcastExchangeExec)
        ) and not (
            isinstance(plan, CoalesceExchangeExec) and plan.num_consumers > 1
        ):
            # N:1 coalesce / broadcast: the STREAMING data plane — chunked,
            # budget-bounded, LIMIT-aware (see _stream_stage_coalesced)
            merged = self._stream_stage_coalesced(
                plan, producer, query_id, stage_id, t_prod
            )
            scan = MemoryScanExec([merged], producer.schema(),
                                  replicated=True)
            self._seed_consumer_scan(plan, scan)
            return scan
        elif (
            isinstance(plan, ShuffleExchangeExec)
            and self._partition_streams_enabled(plan)
        ):
            if self._pipelined_shuffle_enabled(plan):
                # PIPELINED shuffle: producers stream partition slices
                # into a live feed and this boundary resolves at FIRST
                # SLICE — the consumer stage's tasks block only for
                # their own partition (runtime/streams.py StreamScanExec)
                scan = self._shuffle_stage_pipelined(
                    plan, producer, query_id, stage_id, t_prod
                )
                self._seed_consumer_scan(plan, scan)
                return scan
            # partition-range data plane: each producer serves its hash-
            # partitioned output over ONE multiplexed stream; the hashing
            # runs on the workers and the coordinator only demuxes
            slices = self._shuffle_stage_partition_streams(
                plan, producer, query_id, stage_id, t_prod
            )
            scan = MemoryScanExec(slices, producer.schema())
            self._seed_consumer_scan(plan, scan)
            return scan
        else:
            if isinstance(plan, ShuffleExchangeExec) and not isinstance(
                plan, RangeShuffleExchangeExec
            ):
                # skew-aware split (runtime/adaptivity.py): a hot
                # producer slice — typically a hot hash partition left
                # by the upstream shuffle — fans out over contiguous
                # row-range views before the tasks dispatch. Plain hash
                # shuffles only: their regroup is producer-major with
                # stable within-producer order, so contiguous sub-views
                # reproduce the exact row order of the unsplit task.
                producer, t_prod = self._adapt_split_skew(
                    producer, query_id, stage_id, t_prod
                )
            outputs = self._run_stage_tasks(
                producer, query_id, stage_id, t_prod
            )
        if isinstance(plan, ShuffleExchangeExec) and not isinstance(
            plan, RangeShuffleExchangeExec
        ):
            from datafusion_distributed_tpu_torch.ops.table import round_up_pow2
            from datafusion_distributed_tpu_torch.planner.statistics import (
                row_width,
            )

            sm = self.stream_metrics.get((query_id, stage_id)) or {}
            if sm.get("partial_agg_bailout"):
                # a bail-out invalidates the planner's capacity
                # arithmetic too: the push-down pass sized this
                # exchange's padded per-destination capacity from the
                # partial's slot count, but after the swap RAW rows
                # cross the boundary. Padded capacities are shapes, not
                # hints — regrouping at the stale capacity is a hard
                # concat overflow — so widen to the worst-case
                # per-destination share (every row on one destination)
                # before the regroup.
                total = sum(read_rows(outputs))
                need = round_up_pow2(
                    -(-total // max(len(outputs), 1))
                )
                if need > int(plan.per_dest_capacity):
                    plan.per_dest_capacity = need
                    sm["bailout_capacity_widened"] = need
            # bulk plane: the exchange moved the producers' LIVE rows
            # through the coordinator (padded capacities are device
            # buffers, not wire bytes here)
            self._record_exchange_bytes(
                plan, query_id, stage_id,
                sum(read_rows(outputs))
                * row_width(producer.schema()),
                "unary" if self._data_plane() == "unary" else "bulk",
                rows=sum(read_rows(outputs)),
            )
            # consumer-count decision + regroup are overridable together:
            # the adaptive coordinator defers co-shuffled siblings so a
            # join stage's feeds agree on ONE adapted count
            scan = self._finish_shuffle(plan, outputs, producer)
            if sm.get("partial_agg_bailout"):
                # flag the consumer-side scan: RAW rows live in these
                # slices, so the merge aggregate above must re-derive
                # its table size from the slice capacity instead of the
                # stale partial-rows prediction (_widen_bailed_out_merge
                # picks this up when the consumer tree resolves)
                scan.bailout_raw_rows = True
            self._seed_consumer_scan(plan, scan)
            return scan
        t = self._consumer_task_count(plan, outputs)
        if isinstance(plan, RangeShuffleExchangeExec):
            # host tier can range-partition EXACTLY: sort the concatenated
            # producer output once and hand out contiguous slices (the
            # mesh tier's sample-splitter approximation is only needed
            # where no task sees the whole dataset)
            slices = _range_regroup(outputs, plan.sort_keys, t)
        elif isinstance(plan, CoalesceExchangeExec) and (
            plan.num_consumers > 1
        ):
            # true N:M coalesce: consumer j gets the contiguous producer
            # group [j*g, (j+1)*g) (network_coalesce.rs div_ceil arithmetic)
            m = plan.num_consumers
            g = -(-len(outputs) // m)
            slices = []
            for j in range(t):
                group = outputs[j * g: (j + 1) * g] if j < m else []
                if group:
                    slices.append(
                        concat_tables(
                            group, capacity=sum(o.capacity for o in group)
                        )
                    )
                else:  # short/absent group: empty stream
                    ref = outputs[0]
                    slices.append(Table(ref.names, ref.columns,
                                        rows_tensor(0, ref.device)))
        elif isinstance(plan, PartitionReplicatedExec):
            # producer is replicated: each consumer keeps its modulo slice of
            # task 0's output
            slices = _mod_slices(outputs[0], t)
        else:
            raise NotImplementedError(type(plan).__name__)
        scan = MemoryScanExec(slices, producer.schema())
        self._seed_consumer_scan(plan, scan)
        return scan

    def _seed_consumer_scan(self, exchange, scan) -> None:
        """Hook: the consumer-side scan for `exchange` was just built (the
        AdaptiveCoordinator seeds it with mid-execution LoadInfo)."""

    def _producer_progress(self, stage_id: int, done: int, total: int,
                           rows: int, width: int) -> None:
        """Hook: `done`/`total` producer tasks of stage `stage_id` have
        completed with `rows` total output rows so far (the reference's
        LoadInfo stream, `sampler.rs:30-42`). Called while the remaining
        producers are still executing."""

    def _chunk_observer(self, stage_id: int):
        """Hook: per-chunk observer for stage output in flight (the
        per-column half of the LoadInfo stream). None = no sampling; the
        AdaptiveCoordinator returns a ColumnStreamSampler.observe."""
        return None

    # -- data-plane selection ------------------------------------------------
    def _data_plane(self) -> str:
        """`SET distributed.data_plane` (default ``auto``): which
        cross-process plane serves exchange boundaries. ``auto`` keeps
        the existing ladder (peer pulls -> partition streams -> bulk);
        ``stream``/``shm`` force every shuffle through the streaming
        TransferPartitions RPC (shm additionally offering the co-located
        segment plane); ``unary`` forces the bulk whole-table plane.
        Plane choice is EXECUTION routing only — never traced, never
        part of the plan fingerprint — so toggling it recompiles
        nothing and must not change a single result byte."""
        return str(self.config_options.get("data_plane", "auto")).lower()

    def _forced_plane_label(self, default: str) -> str:
        """Telemetry label for an exchange: the forced plane name when
        `data_plane` is pinned to stream/shm, else the ladder's own
        label — so `dftpu_exchange_bytes{plane=...}` separates forced
        planes from auto routing."""
        plane = self._data_plane()
        return plane if plane in ("stream", "shm") else default

    # -- peer-to-peer data plane ---------------------------------------------
    def _peer_plane_enabled(self, exchange) -> bool:
        """Default plane for shuffle/broadcast/N:M-coalesce boundaries when
        every worker offers the partition-stream surface: consumer tasks
        pull straight from producer workers and the coordinator only ships
        plans (`prepare_static_plan.rs:10-56` + `worker_connection_pool.rs`).
        N:1 coalesce keeps the coordinator-streamed plane — there the
        coordinator itself is the consumer (the reference's head stage runs
        on the coordinator). RangeShuffle keeps the host plane for its exact
        global sort. `SET distributed.peer_shuffle = false` restores the
        coordinator-mediated plane everywhere."""
        if self._data_plane() != "auto":
            # a forced plane (unary/stream/shm) routes every boundary
            # through the coordinator-mediated paths the toggle names;
            # peer pulls would bypass the selection
            return False
        if not bool(self.config_options.get("peer_shuffle", True)):
            return False
        if isinstance(exchange, RangeShuffleExchangeExec):
            return False
        eligible = isinstance(
            exchange, (ShuffleExchangeExec, BroadcastExchangeExec)
        ) or (
            isinstance(exchange, CoalesceExchangeExec)
            and exchange.num_consumers > 1
        )
        if not eligible:
            return False
        return self._workers_peer_capable()

    def _workers_peer_capable(self) -> bool:
        """Capability probe cached PER MEMBERSHIP TOKEN — the verdict is
        stored WITH the token it was computed under and ignored on
        mismatch, so a worker added after the first dispatch is probed,
        not assumed, and a slow probe racing a membership change cannot
        install a stale verdict for the new epoch. Probing every worker
        per boundary would put O(stages x workers) resolver calls on the
        dispatch path, but a stale verdict on a mutated cluster either
        fails at consumer load time or silently degrades the plane.

        Checks the data-plane surface AND actual peer WIRING
        (`Worker.peer_capable` / the gRPC GetInfo flag): a user-built
        cluster of plain Worker(url) objects without peer_channels must
        keep the coordinator-mediated plane, not fail at consumer load
        time. A single-worker cluster is always capable (every pull
        short-circuits to the local bypass)."""
        urls = self.resolver.get_urls()
        tok = self._note_membership(urls)
        cached = getattr(self, "_peer_capable", None)
        if cached is not None and cached[0] == tok:
            return cached[1]
        workers = []
        for u in urls:
            try:
                workers.append(self.channels.get_worker(u))
            except WorkerUnavailableError:
                # departed between listing and probe (this runs at
                # boundary materialization, OUTSIDE the dispatch retry
                # loops — an escape here would fail the query, not
                # reroute it): judge the survivors; the token is already
                # stale, so the next boundary re-probes the new epoch
                continue
        verdict = all(
            hasattr(w, "execute_task_partitions") for w in workers
        ) and (
            len(urls) <= 1
            or all(getattr(w, "peer_capable", False) for w in workers)
        )
        self._peer_capable = (tok, verdict)
        return verdict

    def _peer_boundary(
        self, exchange, producer: ExecutionPlan, query_id: str,
        stage_id: int, t_prod: int,
    ):
        """Ship the producer stage's task plans to their workers WITHOUT
        executing them, and return the consumer-side peer scan. Row bytes
        for this boundary never touch the coordinator; producers execute
        lazily on the first consumer pull (pending->ready without a
        coordinator materialization step)."""
        from datafusion_distributed_tpu_torch.runtime.peer import (
            PeerShuffleScanExec,
            group_pulls,
            shuffle_pulls,
        )

        prepared = self._prepare_stage_plan(producer)
        # peer producers are first PULLED when their consumer stage runs;
        # on a deep plan that can be far beyond the worker registry's
        # idle-TTL default, so ship them with a query-lifetime TTL (the
        # query-end sweep, not the TTI cache, owns their cleanup)
        peer_ttl = float(self.config_options.get("peer_task_ttl", 3600.0))
        # retained for the membership-churn path: a producer shipped here
        # whose worker later LEAVES is re-shipped from this prepared plan
        # onto a survivor (_heal_departed_peers)
        self._peer_plan_registry[(query_id, stage_id)] = (
            prepared, t_prod, peer_ttl
        )
        producers = []  # (key_obj, url)
        for i in range(t_prod):
            worker, key, plan_obj, _store = self._dispatch_task_with_retry(
                prepared, query_id, stage_id, i, t_prod, ttl=peer_ttl
            )
            self._peer_shipped.append((worker, key))
            producers.append(
                ((key.query_id, key.stage_id, key.task_number), worker.url)
            )
        budget = int(self.config_options.get(
            "worker_connection_buffer_budget_bytes", 64 << 20
        ))
        chunk_rows = int(self.config_options.get("stream_chunk_rows", 65536))
        schema = producer.schema()
        dicts = _leaf_dictionaries(producer, schema)
        if isinstance(exchange, ShuffleExchangeExec):
            t_cons = exchange.num_tasks
            scan = PeerShuffleScanExec(
                shuffle_pulls(producers, t_cons), exchange.key_names,
                t_cons, exchange.per_dest_capacity, schema, dicts,
                budget_bytes=budget, chunk_rows=chunk_rows,
                capacity_hint=t_prod * exchange.per_dest_capacity,
                device=self._device,
            )
        elif isinstance(exchange, BroadcastExchangeExec):
            t_cons = max(exchange.num_tasks, 1)
            scan = PeerShuffleScanExec(
                shuffle_pulls(producers, t_cons), [], t_cons, 0, schema,
                dicts, replicated=True, budget_bytes=budget,
                chunk_rows=chunk_rows,
                capacity_hint=producer.output_capacity() * max(t_prod, 1),
                device=self._device,
            )
        else:  # N:M coalesce
            t_cons = exchange.num_consumers
            scan = PeerShuffleScanExec(
                group_pulls(producers, t_cons), [], 1, 0, schema, dicts,
                budget_bytes=budget, chunk_rows=chunk_rows,
                capacity_hint=exchange.output_capacity(),
                device=self._device,
            )
        self.stream_metrics[(query_id, stage_id)] = {
            "plane": "peer",
            "coordinator_bytes": 0,
            "producers": t_prod,
            "partitions": t_cons,
        }
        return scan

    def _heal_departed_peers(self, stage_plan, query_id) -> int:
        """Membership-churn recovery for the peer data plane: producer
        tasks whose worker LEFT the membership (neither active nor
        draining) are re-shipped onto survivors from the prepared plans
        retained at boundary time, and every pull spec naming them is
        rewritten to the survivor — so the failing consumer's next attempt
        pulls from live endpoints.

        The heal is TRANSITIVE: registered peer stages are processed
        bottom-up (ascending stage id — `_prepare` stamps producers before
        consumers), so when a re-shipped producer's own plan pulls from an
        earlier departed producer, it ships with already-healed specs; and
        a producer still sitting on a LIVE worker whose shipped copy names
        a departed upstream is REFRESHED in place (same key, same worker —
        its consumers' specs keep pointing at it). Original scan nodes are
        mutated (task specialization copies pull lists per dispatch), so
        every retrying sibling task sees the healed specs; the heal lock
        serializes concurrent retries, and a second pass finds everything
        reachable and no-ops. -> producer tasks re-shipped."""
        from datafusion_distributed_tpu_torch.runtime.codec import (
            collect_table_ids,
        )
        from datafusion_distributed_tpu_torch.runtime.peer import (
            PeerShuffleScanExec,
            reroute_pulls,
        )

        plans = getattr(self, "_peer_plan_registry", None)
        if not plans:
            return 0

        def peer_scans(plan):
            return plan.collect(
                lambda n: isinstance(n, PeerShuffleScanExec)
            )

        if getattr(self, "_peer_heal_lock", None) is None:
            # direct-call safety (tests invoke the heal without execute)
            self._peer_heal_lock = threading.Lock()
        healed = 0
        # the lock guards _peer_url_map and _peer_stale
        with self._peer_heal_lock:
            # url_map/stale accumulate ACROSS heal passes for the query
            # (direct-call safety: tests invoke the heal without execute)
            url_map = getattr(self, "_peer_url_map", None)
            if url_map is None:
                url_map = self._peer_url_map = {}
            stale = getattr(self, "_peer_stale", None)
            if stale is None:
                stale = self._peer_stale = set()
            reachable = set(self._full_membership_urls())
            if not url_map and not stale and all(
                w.url in reachable for w, _ in self._peer_shipped
            ):
                # nothing ever moved and every shipped worker is still a
                # member: the heal is a no-op. This runs on EVERY
                # retryable failure (plain fault chaos included), so skip
                # the per-stage plan walks before sibling retries convoy
                # behind the lock
                return 0
            # latest shipped location of every peer producer task
            loc: dict = {}
            for w, k in self._peer_shipped:
                loc[(k.query_id, k.stage_id, k.task_number)] = (w, k)
            for qid, sid in sorted(plans, key=lambda e: e[1]):
                prepared, t_prod, ttl = plans[(qid, sid)]
                if sum(
                    reroute_pulls(s, url_map) for s in peer_scans(prepared)
                ):
                    # this pass changed the stage's specs: every shipped
                    # copy now pre-dates them and must be refreshed (or
                    # re-shipped) before its consumers can trust it — the
                    # mark persists across passes so copies whose workers
                    # are busy THIS pass still refresh on a later one
                    stale.update((qid, sid, i) for i in range(t_prod))
                for i in range(t_prod):
                    ko = (qid, sid, i)
                    held = loc.get(ko)
                    if held is None:
                        continue
                    worker, key = held
                    if worker.url not in reachable:
                        # departed: re-ship onto a survivor (the prepared
                        # plan's own specs were healed just above)
                        worker, key, _po, _st = (
                            self._dispatch_task_with_retry(
                                prepared, qid, sid, i, t_prod, ttl=ttl
                            )
                        )
                        self._peer_shipped.append((worker, key))
                        loc[ko] = (worker, key)
                        url_map[ko] = worker.url
                        stale.discard(ko)
                        self.faults.bump("peer_producers_reshipped")
                        healed += 1
                    elif ko in stale:
                        # live worker, stale shipped copy (its pulls named
                        # a departed upstream): refresh in place so the
                        # worker-held plan pulls from the survivors —
                        # consumers keep addressing this same (key, url).
                        # No pre-invalidate: registry.put evicts the
                        # displaced entry atomically, so a concurrent
                        # consumer pull never sees a "no plan" gap, and a
                        # failed refresh leaves the old copy registered
                        plan_obj = encode_plan(
                            _task_specialized(prepared, i),
                            worker.table_store,
                        )
                        try:
                            worker.set_plan(
                                key, plan_obj, t_prod,
                                config=self.config_options,
                                headers=self.passthrough_headers,
                                ttl=ttl,
                            )
                        except BaseException as e:
                            worker.table_store.remove(
                                collect_table_ids(plan_obj)
                            )
                            if not getattr(e, "retryable", False):
                                raise
                            # transient refresh failure (the heal runs
                            # inside the callers' failure-handling branch,
                            # OUTSIDE their retry loops — an escape here
                            # would fail the query): fall back to a full
                            # re-ship, which retries/reroutes internally.
                            # The old copy stays registered but unreferenced
                            # once url_map points its consumers at the
                            # re-shipped location; the query-end sweep
                            # releases it.
                            worker, key, _po, _st = (
                                self._dispatch_task_with_retry(
                                    prepared, qid, sid, i, t_prod, ttl=ttl
                                )
                            )
                            self._peer_shipped.append((worker, key))
                            loc[ko] = (worker, key)
                            url_map[ko] = worker.url
                            stale.discard(ko)
                            self.faults.bump("peer_producers_reshipped")
                            healed += 1
                            continue
                        stale.discard(ko)
                        self.faults.bump("peer_producers_refreshed")
            if url_map:
                # the ACCUMULATED map, not just this pass's additions: a
                # consumer whose specs were pinned before an earlier pass
                # moved a producer heals here on its own retry
                for s in peer_scans(stage_plan):
                    reroute_pulls(s, url_map)
        if healed:
            self._event("peer_heal", reshipped=healed)
        return healed

    # -- partition-range data plane ------------------------------------------
    def _partition_streams_enabled(self, exchange) -> bool:
        """Shuffle via worker-side partitioning + multiplexed partition
        streams when every worker offers the surface. The adaptive
        coordinator overrides to False: it resizes consumer task counts
        from exact materialized outputs, while a partition stream fixes
        the partition count in the request."""
        if self._data_plane() == "unary":
            # forced unary: the bulk whole-table plane, the byte-identity
            # baseline every streaming plane is gated against
            return False
        try:
            return all(
                hasattr(self.channels.get_worker(u),
                        "execute_task_partitions")
                for u in self.resolver.get_urls()
            )
        except Exception:
            return False

    def _partition_stream_pullers(self, exchange, prepared, query_id,
                                  stage_id, t_prod, chunk_rows,
                                  trace_parent):
        """One multiplexed partition-range puller per producer task —
        SHARED by the materialized and pipelined shuffle planes: the
        pull protocol (partition-range request shape, retry/reroute
        wrapping, trace parenting) must stay identical across
        planes or their byte-identity contract drifts. Each puller
        yields ((partition, chunk), est_bytes)."""
        t_cons = exchange.num_tasks
        plane = self._data_plane()
        wire_mode = str(
            self.config_options.get("wire_compression", "auto")
        ).lower()
        use_transfer = plane in ("stream", "shm")

        def make_puller(task_number: int):
            def body(worker, key, cancel):
                if use_transfer and hasattr(worker, "transfer_partitions"):
                    # forced stream/shm plane: the streaming
                    # TransferPartitions RPC — same request shape and
                    # yield contract (the server delegates to
                    # execute_task_partitions), so retries reroute
                    # through _pull_task_with_retry unchanged. After a
                    # SegmentError the client marks shm broken and the
                    # re-pull lands here again, wire-only.
                    it = worker.transfer_partitions(
                        key, exchange.key_names, t_cons, 0, t_cons,
                        per_dest_capacity=exchange.per_dest_capacity,
                        chunk_rows=chunk_rows, cancel=cancel,
                        wire_compression=wire_mode,
                        shm=(plane == "shm"),
                    )
                else:
                    it = worker.execute_task_partitions(
                        key, exchange.key_names, t_cons, 0, t_cons,
                        per_dest_capacity=exchange.per_dest_capacity,
                        chunk_rows=chunk_rows, cancel=cancel,
                    )
                for p, piece, est in it:
                    yield (p, piece), est

            def pull(cancel):
                yield from self._pull_task_with_retry(
                    prepared, query_id, stage_id, task_number, t_prod,
                    body, cancel, trace_parent=trace_parent,
                )

            return pull

        return [make_puller(i) for i in range(t_prod)]

    def _shuffle_stage_partition_streams(
        self, exchange, producer: ExecutionPlan, query_id: str,
        stage_id: int, t_prod: int,
    ) -> list[Table]:
        """One multiplexed stream per producer task carrying the FULL
        partition range [0, t_consumer); chunks arrive tagged with their
        partition id and are demuxed into consumer slices under the shared
        byte budget (the reference's WorkerConnectionPool demux +
        64 MiB budget, `worker_connection_pool.rs:243-308`). The hash/
        bucket work runs on the producers, not the coordinator."""
        from datafusion_distributed_tpu_torch.runtime.streams import (
            stream_stage_chunks,
        )

        t_cons = exchange.num_tasks
        budget = int(self.config_options.get(
            "worker_connection_buffer_budget_bytes", 64 << 20
        ))
        chunk_rows = int(self.config_options.get("stream_chunk_rows", 65536))
        prepared = self._prepare_stage_plan(producer)
        obs = self._chunk_observer(stage_id)
        plane_label = self._forced_plane_label("partition-stream")
        tr = self._tr()
        with tr.span("transfer", "transfer", stage=stage_id,
                     plane=plane_label) as xfer:
            chunks, stats = stream_stage_chunks(
                self._partition_stream_pullers(
                    exchange, prepared, query_id, stage_id, t_prod,
                    chunk_rows, xfer.span_id,
                ),
                budget,
                max_concurrent=max(len(self.resolver.get_urls()), 1),
                payload_rows=lambda pr: host_rows(pr[1]),
                on_chunk=(lambda pr: obs(pr[1])) if obs is not None
                else None,
                pressure=self._store_pressure_probe(),
            )
            xfer.set(bytes=stats.bytes_streamed, rows=stats.rows,
                     chunks=stats.chunks)
        self.stream_metrics[(query_id, stage_id)] = {
            "bytes_streamed": stats.bytes_streamed,
            "chunks": stats.chunks,
            "peak_in_flight": stats.peak_in_flight,
            "early_exit": stats.early_exit,
            "rows": stats.rows,
            "partitions": t_cons,
            "rows_per_s": round(stats.rows_per_s, 1),
            "bytes_per_s": round(stats.bytes_per_s, 1),
        }
        self._record_exchange_bytes(
            exchange, query_id, stage_id, stats.bytes_streamed,
            plane_label,
        )
        parts: list[list[Table]] = [[] for _ in range(t_cons)]
        for per in chunks:
            for p, tbl in per:
                parts[p].append(tbl)
        schema = producer.schema()
        slices = []
        for plist in parts:
            if plist:
                rows = sum(read_rows(plist))
                cap = max(-(-rows // 8) * 8, 8)
                slices.append(concat_tables(plist, capacity=cap))
            else:
                slices.append(Table.empty(
                    schema, 8, _leaf_dictionaries(producer, schema),
                    device=self._device,
                ))
        return slices

    # -- pipelined shuffle plane ---------------------------------------------
    def _pipelined_shuffle_enabled(self, exchange) -> bool:
        """`SET distributed.pipelined_shuffle` (default on): stream the
        shuffle's partition slices into a live PartitionFeed and release
        the consumer stage at first slice. Requires the stage-DAG
        scheduler (`stage_parallelism > 1` — `= 1` is the documented
        materialized pre-scheduler behavior, the byte-identity baseline)
        and no checkpointer (checkpoints snapshot MATERIALIZED
        MemoryScan frontiers; a live feed has nothing restorable)."""
        import os as _os

        from datafusion_distributed_tpu_torch.ops.table import parse_bool_knob

        # env override wins over session config (the whole-suite A/B
        # escape hatch, mirroring DFTPU_ZERO_COPY)
        v = _os.environ.get("DFTPU_PIPELINED_SHUFFLE")
        if v is None:
            v = self.config_options.get(
                "pipelined_shuffle",
                PIPELINE_DEFAULTS["pipelined_shuffle"],
            )
        try:
            enabled = parse_bool_knob(v)
        except Exception:
            enabled = bool(v)
        if not enabled:
            return False
        if self.checkpoints is not None:
            return False
        return self._stage_parallelism() > 1

    def _shuffle_stage_pipelined(
        self, exchange, producer: ExecutionPlan, query_id: str,
        stage_id: int, t_prod: int,
    ) -> "StreamScanExec":
        """Pipelined variant of `_shuffle_stage_partition_streams`: the
        same per-producer multiplexed partition streams (same pullers,
        same retry machinery, same shared byte budget), but demuxed
        INCREMENTALLY into a `PartitionFeed` by a background feeder
        thread. This method returns a `StreamScanExec` as soon as the
        first slice lands — the boundary flips pending->ready while
        producers are still emitting, and each consumer task's dispatch
        blocks only until ITS partition closes. Byte identity with the
        materialized plane holds because the feed preserves the exact
        (producer, seq) merge order and capacity arithmetic."""
        import threading as _threading

        from datafusion_distributed_tpu_torch.runtime.streams import (
            PartitionFeed,
            stream_partition_chunks,
        )

        t_cons = exchange.num_tasks
        budget = int(self.config_options.get(
            "worker_connection_buffer_budget_bytes", 64 << 20
        ))
        chunk_rows = int(self.config_options.get("stream_chunk_rows", 65536))
        prepared = self._prepare_stage_plan(producer)
        schema = producer.schema()
        dicts = _leaf_dictionaries(producer, schema)
        feed = PartitionFeed(t_cons, t_prod)
        obs = self._chunk_observer(stage_id)
        tr = self._tr()
        # explicit start/end (no context manager): the transfer span
        # covers the stream's full production window and is closed by the
        # feeder thread at completion
        plane_label = self._forced_plane_label("pipelined")
        xfer = tr.start_span(
            "transfer", "transfer",
            parent=tr.reserved_id(("stage", stage_id)),
            stage=stage_id, plane=plane_label,
        )
        pullers = self._partition_stream_pullers(
            exchange, prepared, query_id, stage_id, t_prod, chunk_rows,
            xfer.span_id,
        )
        # visible immediately (plane attribution for stage spans recorded
        # at first slice); the feeder overwrites with the full stats at
        # completion
        self.stream_metrics[(query_id, stage_id)] = {
            "plane": plane_label,
            "partitions": t_cons,
            "producers": t_prod,
        }
        max_conc = max(len(self.resolver.get_urls()), 1)
        pressure_probe = self._store_pressure_probe()

        def run_feed() -> None:
            try:
                stats = stream_partition_chunks(
                    pullers, budget, feed,
                    max_concurrent=max_conc,
                    on_chunk=obs,
                    should_cancel=self._cancelled,
                    pressure=pressure_probe,
                )
            except BaseException as e:
                # idempotent hardening: stream_partition_chunks fails
                # the feed on its own error paths, but an exception from
                # OUTSIDE them (a demux bug, a bad partition id) must
                # also reach blocked consumers or an un-cancelled query
                # would hang in wait_partition forever
                feed.fail(e)
                tr.end_span(xfer.set(error=type(e).__name__))
                return
            tr.end_span(xfer.set(
                bytes=stats.bytes_streamed, rows=stats.rows,
                chunks=stats.chunks,
            ))
            self.stream_metrics[(query_id, stage_id)] = {
                "plane": plane_label,
                "bytes_streamed": stats.bytes_streamed,
                "chunks": stats.chunks,
                "peak_in_flight": stats.peak_in_flight,
                "early_exit": stats.early_exit,
                "rows": stats.rows,
                "partitions": t_cons,
                "producers": t_prod,
                "rows_per_s": round(stats.rows_per_s, 1),
                "bytes_per_s": round(stats.bytes_per_s, 1),
                "pullers_leaked": stats.extra.get("pullers_leaked", 0),
            }
            self._record_exchange_bytes(
                exchange, query_id, stage_id, stats.bytes_streamed,
                plane_label,
            )

        t = _threading.Thread(target=run_feed, daemon=True,
                              name="dftpu-pipelined-feed")
        if not hasattr(self, "_stream_feeds"):
            # direct-call safety (tests materialize without execute)
            self._stream_feeds = []
        self._stream_feeds.append(t)
        t.start()
        # consumer release point: the first slice proves data is flowing
        # (and surfaces an immediate producer failure HERE, on the stage
        # job, exactly where the materialized plane would raise it)
        feed.wait_first_chunk(self._cancelled)
        return StreamScanExec(
            feed, schema, dicts,
            capacity_hint=t_prod * exchange.per_dest_capacity,
            cancelled=self._cancelled,
            device=self._device,
        )

    def _record_exchange_bytes(self, exchange, query_id: str,
                               stage_id: int, measured: int,
                               plane: str, rows: Optional[int] = None) -> None:
        """Predicted-vs-measured exchange accounting (the partial-agg
        push-down feedback loop): the planner pass stamps
        `predicted_exchange_bytes` on shuffles it rewrote from sampled
        key-distribution statistics; the coordinator records both sides
        into the process telemetry registry and the per-stage stream
        metrics, so `dftpu_exchange_bytes` / `dftpu_exchange_predicted_
        bytes` expose how good the prediction was. Host-side only, after
        the stream resolved — never in traced code (DFTPU110)."""
        predicted = getattr(exchange, "predicted_exchange_bytes", None)
        sm = self.stream_metrics.setdefault(
            (query_id, stage_id), {"plane": plane}
        )
        sm["exchange_bytes"] = int(measured)
        if rows is not None:
            # bulk-plane measured output rows (the streaming planes
            # record theirs from StreamStats) — what the mid-query
            # replan compares against StageDagNode.est_rows
            sm["rows"] = int(rows)
        if predicted is not None:
            sm["predicted_exchange_bytes"] = int(predicted)
        try:
            from datafusion_distributed_tpu_torch.runtime.telemetry import (
                DEFAULT_REGISTRY,
            )

            DEFAULT_REGISTRY.counter(
                "dftpu_exchange_bytes",
                "Measured bytes crossing shuffle exchange boundaries.",
                labels=("plane",),
            ).inc(int(measured), plane=plane)
            if predicted is not None:
                DEFAULT_REGISTRY.counter(
                    "dftpu_exchange_predicted_bytes",
                    "Planner-predicted exchange bytes for shuffles "
                    "rewritten by the partial-aggregate push-down.",
                    labels=("plane",),
                ).inc(int(predicted), plane=plane)
        except Exception:
            pass  # telemetry must never fail the exchange

    # -- task-count policy ---------------------------------------------------
    def _producer_task_count(self, exchange, producer) -> int:
        """How many tasks to run for the producer stage: the lattice-stamped
        count when present, else the exchange's planned count — never more
        than the data slices available in its scans (an earlier exchange may
        have produced fewer consumer slices than the planned task count),
        never fewer than an isolated arm's pinned index needs."""
        from datafusion_distributed_tpu_torch.runtime.peer import (
            PeerShuffleScanExec,
        )

        planned = getattr(exchange, "producer_tasks", None)
        if planned is None:
            planned = exchange.num_tasks
        scans = [
            n for n in producer.collect(lambda n: not n.children())
            if isinstance(n, MemoryScanExec) and not n.pinned
        ]
        # isolated union arms pin work to specific task indices; running
        # fewer tasks than the highest assignment would silently drop arms
        # (task specialization ships them as empty scans)
        arms = producer.collect(lambda n: isinstance(n, IsolatedArmExec))
        # a peer scan INSIDE an arm is wholly pulled by the arm's one task
        # (pull_all) — it must not constrain the stage width
        in_arm_peer = {
            id(n)
            for a in arms
            for n in a.collect(lambda n: isinstance(n, PeerShuffleScanExec))
        }
        peer_scans = [
            n for n in producer.collect(
                lambda n: isinstance(n, PeerShuffleScanExec)
            )
            if n.pinned_task is None and id(n) not in in_arm_peer
        ]
        # pipelined-shuffle feeds (StreamScanExec): one partition per
        # consumer task, and — like peer pull specs — every partition is
        # a CONSUMPTION OBLIGATION: running fewer tasks than partitions
        # would silently drop the untaken ones' rows
        in_arm_stream = {
            id(n)
            for a in arms
            for n in a.collect(lambda n: isinstance(n, StreamScanExec))
        }
        stream_scans = [
            n for n in producer.collect(
                lambda n: isinstance(n, StreamScanExec)
            )
            if id(n) not in in_arm_stream
        ]
        need = 1 + max((a.assigned_task for a in arms), default=-1)
        partitioned = [s for s in scans if not s.replicated]
        partitioned_peer = [s for s in peer_scans if not s.replicated]
        # a partitioned peer scan's partitions are pull obligations, not
        # just available slices: running fewer tasks than pull-spec lists
        # would leave partitions unpulled (silent row loss)
        need = max(
            need,
            max((len(s.pulls_per_task) for s in partitioned_peer), default=0),
            max((s.num_partitions for s in stream_scans), default=0),
        )
        slice_counts = [len(s.tasks) for s in partitioned] + [
            len(s.pulls_per_task) for s in partitioned_peer
        ] + [s.num_partitions for s in stream_scans]
        if slice_counts:
            t = min(planned, max(slice_counts))
        elif scans or peer_scans:
            # all inputs replicated: every task would compute the identical
            # result — run the stage ONCE (the reference co-locates
            # single-task stages the same way, prepare_dynamic_plan.rs:86-96)
            t = 1
        else:
            t = planned
        return min(max(planned, need), max(t, need))

    def _consumer_task_count(self, exchange, outputs) -> int:
        """Static mode: the planned count (AdaptiveCoordinator recomputes
        from exact materialized bytes)."""
        return exchange.num_tasks

    def _finish_shuffle(self, exchange, outputs, producer) -> MemoryScanExec:
        """Decide the consumer task count and regroup a hash shuffle's
        producer outputs into consumer slices."""
        t = self._consumer_task_count(exchange, outputs)
        slices = _shuffle_regroup(
            outputs, exchange.key_names, t, exchange.per_dest_capacity,
            zero_copy=self._zero_copy(),
        )
        return MemoryScanExec(slices, producer.schema())

    # -- closed-loop runtime adaptivity --------------------------------------
    def _adaptivity(self):
        """Runtime-adaptivity knobs (runtime/adaptivity.py), re-parsed
        per decision so `SET skew_split_factor` etc. between queries
        take effect without rebuilding the coordinator. None of them is
        trace-relevant: toggling recompiles nothing."""
        from datafusion_distributed_tpu_torch.runtime.adaptivity import (
            AdaptivitySettings,
        )

        return AdaptivitySettings.from_options(self.config_options)

    def _adapt_split_skew(self, producer, query_id: str, stage_id: int,
                          task_count: int):
        """Skew-aware repartitioning on the bulk shuffle plane: when one
        producer task's input slice carries `skew_split_factor` x the
        median rows (the signature of a hot hash partition produced by
        the upstream exchange — the same histogram PartitionFeed records
        on the streaming plane), split that task into contiguous
        row-range views (`ops.table.slice_view`, on the slice's device)
        so idle workers share the hot rows. Returns the (possibly rewritten) producer and task
        count.

        Byte-identity argument: `_shuffle_regroup` walks producers in
        list order with a STABLE within-producer order, so replacing
        task j by sub-views whose concatenation is exactly task j's row
        order reproduces identical per-destination rows in identical
        order — only task boundaries (and padding capacities) change.
        Eligibility is conservative: exactly one un-pinned partitioned
        MemoryScan (every other leaf replicated), reached from the stage
        root through row-order-preserving nodes only (filter/projection/
        coalesce/sampler, or a hash join via its PROBE child — emission
        is probe-major)."""
        settings = self._adaptivity()
        if not settings.skew_enabled or task_count < 2:
            return producer, task_count
        from datafusion_distributed_tpu_torch.runtime.adaptivity import (
            detect_skew,
            note_skew_split,
            split_ranges,
        )

        leaves = producer.collect(lambda n: not n.children())
        scans = [n for n in leaves if isinstance(n, MemoryScanExec)]
        if len(scans) != len(leaves):
            return producer, task_count  # stream/peer/parquet leaves
        candidates = [
            s for s in scans if not s.pinned and not s.replicated
        ]
        if len(candidates) != 1:
            return producer, task_count
        scan = candidates[0]
        if len(scan.tasks) != task_count:
            return producer, task_count
        if producer.collect(lambda n: isinstance(n, IsolatedArmExec)):
            return producer, task_count
        if not self._skew_splittable(producer, scan):
            return producer, task_count
        counts = read_rows(scan.tasks)
        rep = detect_skew(counts, settings.skew_split_factor,
                          settings.skew_split_min_rows)
        if rep is None:
            return producer, task_count
        k = min(
            -(-rep.rows // max(int(rep.median), 1)),
            max(self._live_worker_count(), 2),
            8,  # fan-out ceiling: dispatch overhead grows per sub-task
            rep.rows,
        )
        if k < 2:
            return producer, task_count
        hot = scan.tasks[rep.partition]
        subs = [
            slice_view(hot, lo, cnt)
            for lo, cnt in split_ranges(rep.rows, k)
        ]
        new_tasks = (
            list(scan.tasks[:rep.partition]) + subs
            + list(scan.tasks[rep.partition + 1:])
        )
        new_scan = MemoryScanExec(new_tasks, scan._schema)

        def swap(node):
            if node is scan:
                return new_scan
            children = [swap(c) for c in node.children()]
            return node.with_new_children(children) if children else node

        note_skew_split(query_id, stage_id, rep.partition, rep.rows, k,
                        rep.median)
        sm = self.stream_metrics.setdefault(
            (query_id, stage_id), {"plane": "bulk"}
        )
        sm["skew_splits"] = sm.get("skew_splits", 0) + 1
        sm["skew_partition_rows"] = rep.rows
        return swap(producer), task_count + k - 1

    def _skew_splittable(self, producer, scan) -> bool:
        """Whether the path from the stage root to `scan` preserves
        per-row order under a contiguous split of the scan's task axis:
        only row-wise nodes, and hash joins entered via the probe child
        (their emission is probe-major; the build side must then hang
        off replicated scans, which the candidate filter guarantees)."""
        from datafusion_distributed_tpu_torch.plan.joins import HashJoinExec
        from datafusion_distributed_tpu_torch.plan.physical import (
            CoalescePartitionsExec,
            FilterExec,
            ProjectionExec,
        )
        from datafusion_distributed_tpu_torch.planner.adaptive import SamplerExec

        def path_ok(node) -> bool:
            if node is scan:
                return True
            if isinstance(node, (FilterExec, ProjectionExec,
                                 CoalescePartitionsExec, SamplerExec)):
                return path_ok(node.children()[0])
            if isinstance(node, HashJoinExec):
                return path_ok(node.probe)
            return False

        return path_ok(producer)

    def _bailout_probe(self, producer, query_id: str, stage_id: int,
                       task_count: int):
        """When the stage carries a pushed-down partial aggregate the
        planner stamped as a bail-out candidate
        (planner/distributed.py `_partial_agg_pushdown_pass`), return a
        closure that judges task 0's measured reduction ratio and — when
        it exceeds `partial_agg_bailout_ratio`, i.e. the sampled-NDV
        prediction was wrong and the partial barely reduced — returns a
        producer with the partial swapped for `PartialPassthroughExec`
        for the remaining tasks (grounding: *Partial Partial
        Aggregates*). None when the stage has no candidate or its input
        rows are not measurable host-side.

        Input rows come from the partitioned scans' task-0 slices, so
        the probe only engages when every node under the partial is
        row-wise (a filter UNDERCOUNTS the true ratio — conservative:
        it can only make the bail-out rarer, never spurious)."""
        settings = self._adaptivity()
        if not settings.bailout_enabled or task_count < 2:
            return None
        from datafusion_distributed_tpu_torch.plan.physical import (
            CoalescePartitionsExec,
            FilterExec,
            HashAggregateExec,
            PartialPassthroughExec,
            ProjectionExec,
        )
        from datafusion_distributed_tpu_torch.planner.adaptive import SamplerExec
        from datafusion_distributed_tpu_torch.runtime.adaptivity import (
            note_partial_agg_bailout,
        )

        partials = producer.collect(
            lambda n: isinstance(n, HashAggregateExec)
            and n.mode == "partial"
            and getattr(n, "bailout_candidate", False)
        )
        if len(partials) != 1:
            return None
        partial = partials[0]
        allowed = (FilterExec, ProjectionExec, CoalescePartitionsExec,
                   SamplerExec, MemoryScanExec)
        subtree = partial.child.collect(lambda n: True)
        if any(not isinstance(n, allowed) for n in subtree):
            return None  # joins/unions below: scan rows ≠ agg input rows
        scans = [
            n for n in subtree
            if isinstance(n, MemoryScanExec)
            and not n.pinned and not n.replicated and n.tasks
        ]
        rows_in = sum(host_rows(s.tasks[0]) for s in scans)
        if rows_in <= 0:
            return None

        def judge(out0: Table):
            rows_out = host_rows(out0)
            ratio = rows_out / rows_in
            if ratio < settings.partial_agg_bailout_ratio:
                return None
            passthrough = PartialPassthroughExec(
                partial.group_names, partial.aggs, partial.child
            )

            def swap(node):
                if node is partial:
                    return passthrough
                children = [swap(c) for c in node.children()]
                return (node.with_new_children(children)
                        if children else node)

            note_partial_agg_bailout(
                query_id, stage_id, rows_in, rows_out, ratio,
                getattr(partial, "predicted_partial_rows", 0),
            )
            sm = self.stream_metrics.setdefault(
                (query_id, stage_id), {"plane": "bulk"}
            )
            sm["partial_agg_bailout"] = True
            sm["partial_agg_ratio"] = round(ratio, 4)
            return swap(producer)

        return judge

    @staticmethod
    def _widen_bailed_out_merge(node):
        """Consumer-side half of the bail-out: after the swap, RAW rows
        crossed the exchange, so the planner's consumer merge table —
        sized from the same predicted partial rows that the probe just
        disproved — is stale exactly like the exchange capacity was.
        When an aggregate sits directly on a bailed-out boundary's scan
        (the push-down pass builds `final(shuffle(partial))`, so the
        scan IS its direct child once the exchange resolves), rebuild
        it with the constructor's input-bound default (2x the slice
        capacity: load factor <= 0.5 even with every row distinct),
        never below the planner's own sizing. Deterministic — the same
        bail-out decision always yields the same widened shape."""
        from datafusion_distributed_tpu_torch.plan.physical import (
            HashAggregateExec,
        )

        if not isinstance(node, HashAggregateExec):
            return node
        if not any(getattr(c, "bailout_raw_rows", False)
                   for c in node.children()):
            return node
        rebuilt = HashAggregateExec(node.mode, node.group_names,
                                    node.aggs, node.children()[0])
        if rebuilt.num_slots <= int(node.num_slots):
            return node
        for attr in node._PRESERVED_ANNOTATIONS:
            setattr(rebuilt, attr, getattr(node, attr, None))
        return rebuilt

    def _bailout_multiway(self, node, query_id: str):
        """Multiway half of the bail-out: once a fused stage's build
        boundaries resolve to materialized MemoryScans, their row counts
        are MEASURED, not estimated. If any measured build outgrew the
        hash table the planner captured for its step (per-task load
        factor would exceed 0.5 — the bound the binary constructor sizes
        to), the fused stage is swapped back to its binary chain with
        ``rederive=True`` so every join re-sizes from the resolved
        children. Output bytes are unchanged either way — the chain is
        the fused stage's reference semantics — only the sizing and
        kernel choice differ. Capacity paddings never trigger this:
        only actual materialized rows count, so the peer/stream planes
        (whose rows never cross the coordinator) simply never bail —
        the same measurability rule _maybe_replan follows.
        Deterministic: the same measured rows always bail the same
        stages."""
        from datafusion_distributed_tpu_torch.plan.joins import (
            MultiwayHashJoinExec,
        )

        if not isinstance(node, MultiwayHashJoinExec):
            return node
        if not getattr(node, "multiway_bailout_candidate", False):
            return node

        def measured_rows(build):
            # the per-task build table: replicated scans load the full
            # table on every task, partitioned scans one shard each
            if not isinstance(build, MemoryScanExec) or not build.tasks:
                return None
            if getattr(build, "replicated", False):
                return host_rows(build.tasks[0])
            return max(read_rows(build.tasks))

        worst = 0
        slots = 0
        for build, step in zip(node.builds, node.steps):
            rows = measured_rows(build)
            if rows is not None and 2 * rows > int(step.num_slots):
                worst = max(worst, rows)
                slots = int(step.num_slots)
        if not worst:
            return node
        from datafusion_distributed_tpu_torch.runtime.adaptivity import (
            note_multiway_bailout,
        )

        note_multiway_bailout(query_id, len(node.steps), worst, slots)
        return node.to_binary_chain(rederive=True)

    def _maybe_replan(self, query_id: str, stage_id: int, nodes, scan,
                      submitted) -> bool:
        """Mid-query re-cost: when stage `stage_id`'s measured output
        cardinality diverges from its `StageDagNode.est_rows` by
        `replan_cardinality_factor`, scale the estimates of every
        transitively-dependent NOT-YET-SUBMITTED stage by the measured
        ratio — the backlog promotion then dispatches the unstarted
        frontier cheapest-first on corrected bytes, and the serving
        tier's fair-share pool sees corrected cost hints (submit reads
        `node.est_bytes` at submit time). Scheduling only: stage plans
        are byte-for-byte untouched, and every affected exchange is
        re-run through the static verifier (memoized, so structure
        unchanged == known clean) before it can dispatch."""
        settings = self._adaptivity()
        if not settings.replan_enabled:
            return False
        node = nodes.get(stage_id)
        if node is None:
            return False
        est = int(getattr(node, "est_rows", 0) or 0)
        if est <= 0:
            return False
        # measured output rows: every plane that moves rows through the
        # coordinator records them in stream_metrics (bulk:
        # _record_exchange_bytes; streaming coalesce + pipelined drain:
        # stats.rows). A materialized MemoryScan is the fallback. The
        # peer plane is unmeasurable by design — its rows never cross
        # the coordinator — so those stages simply never trigger.
        sm0 = self.stream_metrics.get((query_id, stage_id), {})
        measured = sm0.get("rows")
        if measured is None and isinstance(scan, MemoryScanExec):
            if getattr(scan, "replicated", False):
                measured = host_rows(scan.tasks[0]) if scan.tasks else 0
            else:
                measured = sum(read_rows(scan.tasks))
        if not measured or int(measured) <= 0:
            return False
        measured = int(measured)
        if max(measured / est, est / measured) < (
            settings.replan_cardinality_factor
        ):
            return False
        affected = self._downstream_unsubmitted(stage_id, nodes,
                                                submitted)
        if not affected:
            return False
        from datafusion_distributed_tpu_torch.plan.verify import (
            enforce_verification,
        )
        from datafusion_distributed_tpu_torch.runtime.adaptivity import (
            note_replan,
        )

        try:
            for sid2 in affected:
                enforce_verification(
                    nodes[sid2].exchange, options=self.config_options,
                    context=f"replan stage {sid2}",
                )
        except Exception:
            return False  # never fail or degrade a query over re-costing
        ratio = measured / est
        for sid2 in affected:
            n2 = nodes[sid2]
            n2.est_rows = max(int(n2.est_rows * ratio), 1)
            n2.est_bytes = max(int(n2.est_bytes * ratio), 1)
        note_replan(query_id, stage_id, measured, est, len(affected))
        sm = self.stream_metrics.setdefault(
            (query_id, stage_id), {"plane": "bulk"}
        )
        sm["replanned_stages"] = len(affected)
        return True

    @staticmethod
    def _downstream_unsubmitted(stage_id: int, nodes, submitted) -> list:
        """Transitive consumers of `stage_id` that have not been
        submitted (not resolved, not in flight — i.e. still waiting on
        deps or parked in the ready backlog), in stage-id order."""
        rev: dict = {}
        for sid, n in nodes.items():
            for d in n.deps:
                rev.setdefault(d, []).append(sid)
        seen: set = set()
        stack = [stage_id]
        while stack:
            for c in rev.get(stack.pop(), ()):
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return sorted(s for s in seen if s not in submitted)

    # -- streaming data plane -----------------------------------------------
    def _stream_stage_coalesced(
        self, exchange, producer: ExecutionPlan, query_id: str,
        stage_id: int, t_prod: int,
    ) -> Table:
        """Materialize an N:1 coalesce/broadcast boundary through the
        chunked streaming plane (runtime/streams.py): one puller per
        producer task, in-flight bytes bounded by
        `worker_connection_buffer_budget_bytes`, and production cancelled
        early once a downstream LIMIT's rows have arrived
        (`exchange.consumer_fetch`, stamped by the planner)."""
        from datafusion_distributed_tpu_torch.runtime.streams import (
            stream_stage_chunks,
        )

        budget = int(self.config_options.get(
            "worker_connection_buffer_budget_bytes", 64 << 20
        ))
        chunk_rows = int(self.config_options.get("stream_chunk_rows", 65536))
        fetch = getattr(exchange, "consumer_fetch", None)

        prepared = self._prepare_stage_plan(producer)

        def make_puller(task_number: int):
            def body(worker, key, cancel):
                if hasattr(worker, "execute_task_stream"):
                    yield from worker.execute_task_stream(
                        key, chunk_rows=chunk_rows, cancel=cancel
                    )
                else:  # transport without a streaming surface
                    from datafusion_distributed_tpu_torch.planner.statistics import (  # noqa: E501
                        row_width,
                    )

                    out = worker.execute_task(key)
                    # zero-copy: chunks are views of the output
                    zc = self._zero_copy()
                    width = row_width(out.schema())
                    n = host_rows(out)
                    for lo in range(0, max(n, 1), chunk_rows):
                        if cancel.is_set():
                            return
                        c = min(chunk_rows, n - lo)
                        yield (
                            slice_view(out, lo, c) if zc
                            else out.slice_rows(lo, c)
                        ), c * width

            def pull(cancel):
                # `xfer` binds when the transfer span opens below, before
                # any puller runs — pull spans nest under the transfer
                yield from self._pull_task_with_retry(
                    prepared, query_id, stage_id, task_number, t_prod,
                    body, cancel, trace_parent=xfer.span_id,
                )

            return pull

        from datafusion_distributed_tpu_torch.planner.statistics import row_width

        width = row_width(producer.schema())

        def progress(done, total, rows, _bytes):
            self._producer_progress(stage_id, done, total, rows, width)

        tr = self._tr()
        with tr.span("transfer", "transfer", stage=stage_id,
                     plane="stream") as xfer:
            chunks, stats = stream_stage_chunks(
                [make_puller(i) for i in range(t_prod)], budget,
                row_target=fetch,
                max_concurrent=max(len(self.resolver.get_urls()), 1),
                on_progress=progress,
                on_chunk=self._chunk_observer(stage_id),
                pressure=self._store_pressure_probe(),
            )
            xfer.set(bytes=stats.bytes_streamed, rows=stats.rows,
                     chunks=stats.chunks, early_exit=stats.early_exit)
        self.stream_metrics[(query_id, stage_id)] = {
            "bytes_streamed": stats.bytes_streamed,
            "chunks": stats.chunks,
            "peak_in_flight": stats.peak_in_flight,
            "early_exit": stats.early_exit,
            "rows": stats.rows,
            "rows_per_s": round(stats.rows_per_s, 1),
            "bytes_per_s": round(stats.bytes_per_s, 1),
        }
        flat = [c for per in chunks for c in per]
        if not flat:
            schema = producer.schema()
            return Table.empty(schema, 8,
                               _leaf_dictionaries(producer, schema),
                               device=self._device)
        # capacity: exactly the streamed rows, 8-row aligned (chunk padding
        # and a pow2 round here would transiently double big gathers)
        cap = max(-(-stats.rows // 8) * 8, 8)
        return concat_tables(flat, capacity=cap)

    # -- task execution ------------------------------------------------------
    def _run_stage_tasks(
        self, producer: ExecutionPlan, query_id: str, stage_id: int,
        task_count: int,
    ) -> list[Table]:
        """Fan ALL tasks of a stage out concurrently — one thread per worker
        (the reference fans tasks out as concurrent async sends,
        `query_coordinator.rs:140-222`; round 1 ran them in a sequential
        Python loop, serializing the whole cluster). A failed task cancels
        the remaining ones (cancellation propagation)."""
        import concurrent.futures as cf

        from datafusion_distributed_tpu_torch.planner.statistics import row_width

        width = row_width(producer.schema())
        obs = self._chunk_observer(stage_id)
        outs: dict[int, Table] = {}
        rows = 0
        done = 0

        def account(i: int, out: Table) -> None:
            nonlocal rows, done
            outs[i] = out
            rows += host_rows(out)
            done += 1
            if obs is not None:
                obs(out)
            self._producer_progress(stage_id, done, task_count, rows, width)

        # worker count is LIVE, re-checked per task in the sequential path:
        # a cluster of 1 that grows mid-stage (elastic join) promotes the
        # REMAINING tasks to the concurrent fan-out instead of serializing
        # the whole stage on the stale snapshot taken at stage start
        pending = list(range(task_count))
        probe = self._bailout_probe(producer, query_id, stage_id,
                                    task_count)
        if probe is not None:
            # self-correcting partial aggregation: run task 0 FIRST (one
            # task of lookahead), measure the partial's actual reduction,
            # and swap the remaining tasks to the per-row passthrough
            # when the sampled-NDV prediction was wrong. Deterministic by
            # construction — the decision depends only on task 0's
            # measured rows, and exactly tasks 1..n-1 swap — so repeated
            # runs stay byte-identical.
            i = pending.pop(0)
            account(i, self._run_stage_task(producer, query_id, stage_id,
                                            i, task_count))
            swapped = probe(outs[i])
            if swapped is not None:
                producer = swapped
        while pending and (
            task_count == 1 or self._live_worker_count() == 1
        ):
            i = pending.pop(0)
            account(i, self._run_stage_task(producer, query_id, stage_id, i,
                                            task_count))
        if pending:
            workers = self._live_worker_count()
            with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                futs = {
                    pool.submit(self._run_stage_task, producer, query_id,
                                stage_id, i, task_count): i
                    for i in pending
                }
                try:
                    # drain in completion order so mid-execution LoadInfo
                    # flows while the slower producers are still running
                    # (bulk-plane "chunks" are whole task outputs)
                    for f in cf.as_completed(futs):
                        account(futs[f], f.result())
                except BaseException:
                    # `f.cancel()` only stops futures that never STARTED;
                    # the per-query cancel event reaches the in-flight ones
                    # — they abort at their next dispatch/execute checkpoint
                    # and release any already-staged slices (no orphaned
                    # tasks, no TTL-leaked TableStore entries)
                    self._signal_cancel()
                    for f in futs:
                        f.cancel()
                    raise
        return [outs[i] for i in range(task_count)]

    def _run_stage_task(
        self,
        stage_plan: ExecutionPlan,
        query_id: str,
        stage_id: int,
        task_number: int,
        task_count: int,
    ) -> Table:
        stage_plan = self._prepare_stage_plan(stage_plan)
        state = _RetryState()
        kt = (query_id, stage_id, task_number)
        tr = self._tr()
        with tr.span("task", "task",
                     parent=tr.reserved_id(("stage", stage_id)),
                     stage=stage_id, task=task_number) as tsp:
            while True:
                self._check_cancelled()
                with tr.span("attempt", "attempt",
                             attempt=state.attempt) as asp:
                    worker, key, plan_obj, store = (
                        self._dispatch_task_with_retry(
                            stage_plan, query_id, stage_id, task_number,
                            task_count, state=state,
                        )
                    )
                    try:
                        self._check_cancelled()
                    except TaskCancelledError:
                        # a sibling failed while this task was shipping:
                        # release the just-staged slices NOW instead of
                        # leaking them until the registry's TTL sweep
                        try:
                            self._cleanup_task(worker, key, plan_obj, store)
                        except Exception:
                            pass
                        raise
                    asp.set(worker=worker.url)
                    hedge_after = self._hedge_threshold()
                    try:
                        if hedge_after is not None and (
                            not self._stage_span_shipped(query_id,
                                                         stage_id)
                        ):
                            # hedge arm: race the primary against a
                            # speculative re-dispatch once its wall
                            # passes the sketch-derived threshold
                            worker, out = self._hedged_execute(
                                stage_plan, query_id, stage_id,
                                task_number, task_count,
                                (worker, key, plan_obj, store),
                                hedge_after, state, asp,
                            )
                        else:
                            try:
                                with tr.span("execute_rpc", "execute",
                                             worker=worker.url):
                                    out = self._execute_attempt(
                                        worker, key,
                                        cancel=self._cancel_event,
                                    )
                                # metrics are best-effort: a flaky
                                # progress RPC after a SUCCESSFUL execute
                                # must not discard the result, re-run the
                                # task, or count against the worker
                                try:
                                    self._record_task_progress(worker,
                                                               key)
                                except Exception:
                                    pass
                            finally:
                                # best-effort: with the result in hand a
                                # cleanup hiccup must not discard it (or
                                # re-execute the task), and on the
                                # failure path it must not MASK the
                                # execute error; cleanup is local-only
                                try:
                                    self._cleanup_task(worker, key,
                                                       plan_obj, store)
                                except Exception:
                                    pass
                    except BaseException as e:
                        # attribute the failure to the worker the ERROR
                        # names when it names one (a dead peer PRODUCER
                        # failing a consumer's pull must not quarantine
                        # the healthy consumer)
                        asp.set(error=type(e).__name__)
                        if self._handle_task_failure(
                            e, getattr(e, "worker_url", "") or worker.url,
                            kt, state,
                        ):
                            # a departed worker may have taken shipped
                            # peer-producer plans with it: re-ship them
                            # onto survivors and rewrite this stage plan's
                            # pull specs BEFORE the re-dispatch
                            self._heal_departed_peers(stage_plan, query_id)
                            continue
                        raise
                self._record_worker_success(worker.url)
                if tr.active:
                    tsp.set(bytes=table_nbytes(out),
                            rows=host_rows(out))
                return out

    # -- fault tolerance -----------------------------------------------------
    def _execute_attempt(self, worker, key, cancel=None) -> Table:
        """ONE bulk-plane execute attempt under the per-task deadline
        (`SET distributed.task_timeout_s`). Workers whose execute_task
        accepts a ``timeout`` get NATIVE enforcement — the gRPC client
        turns it into a wire deadline that cancels the stream server-side
        instead of leaking an open RPC per abandoned attempt. Workers
        without the parameter (MeshWorker, user duck-types) fall back to
        the coordinator-side thread deadline, which works against any
        transport but can only abandon, not cancel.

        ``cancel``: a pollable cancel handle (the per-query event, or a
        hedge attempt's combined loser-cancel) forwarded to workers whose
        surface declares it — chaos proxies poll it inside injected
        delays, so a cancelled attempt releases its slot at cancellation
        latency rather than the full injected delay."""
        timeout = self._opt_float("task_timeout_s")
        kw = {}
        if cancel is not None and self._worker_accepts_param(
            worker, "execute_task", "cancel"
        ):
            kw["cancel"] = cancel
        if not timeout:
            return worker.execute_task(key, **kw)
        if self._worker_accepts_timeout(worker):
            return worker.execute_task(key, timeout=timeout, **kw)
        return call_with_deadline(
            lambda: worker.execute_task(key, **kw), timeout, worker.url,
            key,
        )

    def _worker_accepts_timeout(self, worker,
                                method: str = "execute_task") -> bool:
        """Whether this worker type's ``method`` takes an EXPLICIT
        ``timeout=`` (see `_worker_accepts_param`)."""
        return self._worker_accepts_param(worker, method, "timeout")

    def _worker_accepts_param(self, worker, method: str,
                              param: str) -> bool:
        """Whether this worker type's ``method`` declares an EXPLICIT
        ``param`` (cached per (type, method, param) — signature
        inspection is not free per task). A bare ``**kwargs``
        deliberately does NOT count: a forwarding wrapper could swallow
        the kwarg without honoring it, silently disabling the deadline or
        the cancel plumbing — such workers get the coordinator-side
        fallback instead of a TypeError."""
        cache = getattr(self, "_timeout_sig_cache", None)
        if cache is None:
            cache = self._timeout_sig_cache = {}
        ck = (type(worker), method, param)
        hit = cache.get(ck)
        if hit is None:
            import inspect

            try:
                params = inspect.signature(
                    getattr(worker, method)
                ).parameters
                hit = param in params
            except (TypeError, ValueError, AttributeError):
                hit = False
            cache[ck] = hit
        return hit

    def _opt_float(self, name: str) -> float:
        default = _OPTION_DEFAULTS.get(name, 0.0)
        try:
            return float(self.config_options.get(name, default) or 0.0)
        except (TypeError, ValueError):
            return float(default)

    def _opt_int(self, name: str) -> int:
        default = _OPTION_DEFAULTS.get(name, 0)
        try:
            return int(self.config_options.get(name, default))
        except (TypeError, ValueError):
            return int(default)

    def _health_tracker(self):
        if self.health is None:
            from datafusion_distributed_tpu_torch.runtime.health import (
                HealthPolicy,
                HealthTracker,
            )

            with _HEALTH_INIT_LOCK:
                if self.health is None:  # double-checked: fan-out threads
                    self.health = HealthTracker(HealthPolicy(
                        failure_threshold=self._opt_int(
                            "quarantine_threshold"
                        ),
                        quarantine_seconds=self._opt_float(
                            "quarantine_seconds"
                        ),
                    ))
        return self.health

    def _record_worker_failure(self, url: str) -> None:
        if url and self._health_tracker().record_failure(url):
            self.faults.bump("workers_quarantined")
            self._event("worker_quarantined", worker=url)

    def _record_worker_success(self, url: str) -> None:
        if self.health is not None and url:
            self.health.record_success(url)

    # -- straggler hedging ---------------------------------------------------
    def _hedge_budget(self):
        if self.hedges is None:
            from datafusion_distributed_tpu_torch.runtime.metrics import (
                HedgeBudget,
            )

            with _HEDGE_INIT_LOCK:
                if self.hedges is None:  # double-checked: fan-out threads
                    self.hedges = HedgeBudget()
        return self.hedges

    def _hedge_threshold(self) -> Optional[float]:
        """Seconds an attempt may run before a speculative re-dispatch,
        or None with hedging off. max(sketch-p<hedge_quantile>,
        hedge_floor_s): the floor keeps a COLD sketch from hedging
        everything instantly (and the in-flight budget bounds whatever
        the floor still admits)."""
        from datafusion_distributed_tpu_torch.ops.table import parse_bool_knob

        v = self.config_options.get("hedging", False)
        try:
            enabled = parse_bool_knob(v)
        except Exception:
            enabled = bool(v)
        if not enabled:
            return None
        q = min(max(self._opt_float("hedge_quantile"), 0.0), 1.0)
        floor = max(self._opt_float("hedge_floor_s"), 0.0)
        p = None
        if self.latency is not None and getattr(self.latency, "count", 0):
            try:
                p = self.latency.percentile(q)
            except Exception:
                p = None
        threshold = max(p or 0.0, floor)
        return threshold if threshold > 0 else None

    def _stage_span_shipped(self, query_id: str, stage_id: int) -> bool:
        """Whether this (query, stage) shipped as mesh SPANS: a span plan
        is shared across sibling tasks, so neither a lone-task
        re-dispatch nor a lone-task hedge is defined for it."""
        spans = getattr(self, "_span_shipped", None)
        if not spans:
            return False
        with self._span_lock:  # vs concurrent sibling-stage shipment
            return any(
                k[0] == query_id and k[1] == stage_id for k in spans
            )

    def _record_hedge_loss(self, url: str) -> None:
        """Hedge-loss mark, DISTINCT from a failure: never advances the
        circuit breaker (runtime/health.py record_hedge_loss)."""
        if not url:
            return
        tracker = self._health_tracker()
        mark = getattr(tracker, "record_hedge_loss", None)
        if callable(mark):
            mark(url)

    def _dispatch_hedge(self, stage_plan, query_id, stage_id, task_number,
                        task_count, primary_url, state):
        """Speculatively dispatch the SAME task to a different healthy
        worker; -> (worker, key, plan_obj, store) or None (no budget, no
        alternative candidate, or the dispatch itself failed — a hedge
        that cannot launch must never fail the primary attempt)."""
        try:
            urls = self.resolver.get_urls()
        except Exception:
            return None
        if not any(u != primary_url for u in urls):
            return None  # single-worker cluster: nowhere to hedge to
        budget = self._hedge_budget()
        if not budget.try_acquire(self._opt_int("hedge_budget")):
            self.faults.bump("hedge_budget_denied")
            return None
        ok = False
        try:
            disp = self._dispatch_task(
                stage_plan, query_id, stage_id, task_number, task_count,
                exclude=set(state.excluded) | {primary_url},
            )
            if disp[0].url == primary_url:
                # exclusion fell back to the primary (every alternative
                # quarantined): hedging the same worker is pure waste
                try:
                    self._cleanup_task(*disp)
                except Exception:
                    pass
                self.faults.bump("hedges_abandoned")
                return None
            ok = True
            return disp
        except Exception:
            self.faults.bump("hedges_abandoned")
            return None
        finally:
            if not ok:
                budget.release()

    def _hedged_execute(self, stage_plan, query_id, stage_id, task_number,
                        task_count, primary, threshold, state, asp):
        """Bulk-plane hedge race: run the already-dispatched ``primary``
        attempt in a thread; if it outlives ``threshold``, speculatively
        re-dispatch to a different worker and let the FIRST completed
        attempt win. The loser is cancelled through its per-attempt
        cancel handle and its thread releases its staged slices when the
        in-flight call resolves (execute's finally joins these threads,
        so the query never resolves with a release still pending).
        -> (winner worker, result Table). Raises the primary's error when
        every attempt fails (the normal retry loop takes over)."""
        import queue as _queue
        import threading as _threading

        tr = self._tr()
        results: "_queue.Queue" = _queue.Queue()
        race_lock = _threading.Lock()
        attempts: list = []

        def start(disp, speculative: bool) -> dict:
            ev = _threading.Event()
            att = {
                "worker": disp[0], "key": disp[1], "plan_obj": disp[2],
                "store": disp[3], "ev": ev, "spec": speculative,
                "lost": False,
            }
            cancel = _EitherSet(self._cancel_event, ev)

            def run() -> None:
                sp = tr.start_span(
                    "execute_rpc", "execute", parent=asp.span_id,
                    worker=att["worker"].url, hedge=speculative,
                )
                payload = None
                try:
                    out = self._execute_attempt(
                        att["worker"], att["key"], cancel=cancel
                    )
                except BaseException as e:
                    sp.set(error=type(e).__name__)
                    payload = (att, None, e)
                else:
                    payload = (att, out, None)
                finally:
                    tr.end_span(sp)
                    if speculative:
                        self._hedge_budget().release()
                # deliver-or-discard under the race lock: after the main
                # thread marks an attempt lost, nothing more enqueues
                with race_lock:
                    if not att["lost"]:
                        results.put(payload)
                if payload[2] is None and not att["lost"]:
                    # winner-side metrics (losers are being discarded: a
                    # cancelled attempt's wall must not feed the sketch)
                    try:
                        self._record_task_progress(att["worker"],
                                                   att["key"])
                    except Exception:
                        pass
                try:
                    self._cleanup_task(att["worker"], att["key"],
                                       att["plan_obj"], att["store"])
                except Exception:
                    pass

            t = _threading.Thread(target=run, daemon=True,
                                  name="dftpu-hedge")
            attempts.append(att)
            self._hedge_threads.append(t)
            t.start()
            return att

        start(primary, speculative=False)
        started = 1
        hedged = False
        first = None
        try:
            first = results.get(timeout=threshold)
        except _queue.Empty:
            disp = self._dispatch_hedge(
                stage_plan, query_id, stage_id, task_number, task_count,
                primary[0].url, state,
            )
            if disp is not None:
                hedged = True
                self.faults.bump("hedges_issued")
                self._event(
                    "hedge_issued", stage=stage_id, task=task_number,
                    primary=primary[0].url, hedge=disp[0].url,
                    threshold_ms=round(threshold * 1e3, 1),
                )
                start(disp, speculative=True)
                started = 2
        errors: list = []
        winner = None
        while winner is None:
            while first is None:
                try:
                    first = results.get(timeout=0.05)
                except _queue.Empty:
                    if self._cancelled():
                        self._abandon_attempts(attempts, race_lock)
                        self._check_cancelled()
            att, out, err = first
            first = None
            if err is None:
                winner = (att, out)
                break
            errors.append((att, err))
            if len(errors) >= started:
                # every attempt failed: surface the PRIMARY's error (the
                # retry loop's health/reroute attribution expects it) and
                # count the non-surfaced failures against their workers
                surfaced = next(
                    (e for a, e in errors if not a["spec"]),
                    errors[0][1],
                )
                self._note_failed_attempts(
                    [(a, e) for a, e in errors if e is not surfaced]
                )
                raise surfaced
        att, out = winner
        # the race resolved with a success: attempts that FAILED before
        # the win were genuine failures (breaker-visible); attempts still
        # running merely LOST (cancelled, breaker-neutral)
        self._note_failed_attempts(errors)
        failed = {id(a) for a, _e in errors}
        self._abandon_attempts(
            [a for a in attempts if a is not att], race_lock,
        )
        for a in attempts:
            if a is not att and id(a) not in failed:
                self._record_hedge_loss(a["worker"].url)
        if hedged:
            name = "hedge_won" if att["spec"] else "hedge_lost"
            self.faults.bump("hedges_won" if att["spec"] else
                             "hedges_lost")
            self._event(name, stage=stage_id, task=task_number,
                     worker=att["worker"].url)
        return att["worker"], out

    def _abandon_attempts(self, atts, race_lock) -> None:
        """Mark ``atts`` lost (their threads stop delivering and discard
        their own results/slices) and set their cancel handles."""
        for a in atts:
            with race_lock:
                a["lost"] = True
            a["ev"].set()

    def _note_failed_attempts(self, errors) -> None:
        """Health accounting for hedge-race attempts that FAILED with a
        genuine error (collected before any winner, so never
        cancellation-induced): a retryable infrastructure failure counts
        against its worker's breaker exactly as the unhedged path would
        count it — a worker that keeps crashing hedge attempts must not
        stay quarantine-proof just because a sibling attempt won."""
        member = set(self._full_membership_urls())
        for a, e in errors:
            if not is_retryable(e):
                continue  # query-semantic: no breaker input (as unhedged)
            url = getattr(e, "worker_url", "") or a["worker"].url
            if url in member:
                self._record_worker_failure(url)

    def _discard_attempt(self, att, it) -> None:
        """Release a losing (or abandoned) streaming attempt: close its
        chunk iterator (the worker-side stream's own cleanup runs in its
        finalizers) and drop its staged slices. Best-effort and silent —
        teardown of discarded work must never mask or fail anything."""
        try:
            if it is not None:
                it.close()
        except Exception:
            pass
        try:
            self._cleanup_task(att["worker"], att["key"],
                               att["plan_obj"], att["store"])
        except Exception:
            pass

    def _hedged_first_chunk(self, stage_plan, query_id, stage_id,
                            task_number, task_count, primary, body,
                            cancel, threshold, state, done, pull_span):
        """Streaming-plane hedge race over the FIRST chunk (which
        contains the task's execution — later chunks slice an already-
        materialized output). Returns the winning attempt's
        (worker, key, plan_obj, store, iterator, first_item); the caller
        adopts the iterator and streams it exactly like an unhedged pull,
        so the retry-while-nothing-yielded contract is preserved. Losers
        are cancelled per-attempt and release their own staged state.
        Raises the primary's error when every attempt fails."""
        import queue as _queue
        import threading as _threading

        tr = self._tr()
        timeout = self._opt_float("task_timeout_s")
        results: "_queue.Queue" = _queue.Queue()
        race_lock = _threading.Lock()
        attempts: list = []

        def start(disp, speculative: bool) -> dict:
            ev = _threading.Event()
            att = {
                "worker": disp[0], "key": disp[1], "plan_obj": disp[2],
                "store": disp[3], "ev": ev, "spec": speculative,
                "lost": False,
            }
            # the attempt's pollable cancel merges the CALLER's stream
            # cancel (LIMIT satisfied / sibling failure) with this
            # attempt's private loser-cancel and the per-query event
            combined = _EitherSet(
                cancel, _EitherSet(ev, self._cancel_event)
            )

            def run() -> None:
                sp = tr.start_span(
                    "pull_attempt", "execute", parent=pull_span.span_id,
                    worker=att["worker"].url, hedge=speculative,
                )
                it = None
                payload = None
                try:
                    it = iter(body(att["worker"], att["key"], combined))
                    if timeout:
                        first = call_with_deadline(
                            lambda: next(it, done), timeout,
                            att["worker"].url, att["key"],
                        )
                    else:
                        first = next(it, done)
                except BaseException as e:
                    sp.set(error=type(e).__name__)
                    payload = (att, None, None, e)
                else:
                    payload = (att, it, first, None)
                finally:
                    tr.end_span(sp)
                    if speculative:
                        self._hedge_budget().release()
                # deliver-or-discard under the race lock: once the main
                # thread marks this attempt lost, nothing more enqueues —
                # so a post-race drain of the queue sees every delivered
                # loser, and an undelivered loser discards itself here
                with race_lock:
                    lost = att["lost"]
                    if not lost:
                        results.put(payload)
                if payload[3] is not None:
                    # a FAILED attempt's staged state is dead no matter
                    # how the race resolves (the main thread never adopts
                    # an error): release it here — idempotent with the
                    # caller's primary-cleanup on the all-failed path
                    self._discard_attempt(att, it)
                elif lost:
                    self._discard_attempt(att, it)

            t = _threading.Thread(target=run, daemon=True,
                                  name="dftpu-hedge-pull")
            attempts.append(att)
            self._hedge_threads.append(t)
            t.start()
            return att

        start(primary, speculative=False)
        started = 1
        hedged = False
        first_res = None
        try:
            first_res = results.get(timeout=threshold)
        except _queue.Empty:
            disp = self._dispatch_hedge(
                stage_plan, query_id, stage_id, task_number, task_count,
                primary[0].url, state,
            )
            if disp is not None:
                hedged = True
                self.faults.bump("hedges_issued")
                self._event(
                    "hedge_issued", stage=stage_id, task=task_number,
                    primary=primary[0].url, hedge=disp[0].url,
                    threshold_ms=round(threshold * 1e3, 1),
                    plane="stream",
                )
                start(disp, speculative=True)
                started = 2
        errors: list = []
        winner = None
        while winner is None:
            while first_res is None:
                try:
                    first_res = results.get(timeout=0.05)
                except _queue.Empty:
                    if self._cancelled():
                        self._abandon_attempts(attempts, race_lock)
                        self._drain_discard(results)
                        self._check_cancelled()
            att, it, first, err = first_res
            first_res = None
            if err is None:
                winner = (att, it, first)
                break
            errors.append((att, err))
            if len(errors) >= started:
                # surface the PRIMARY's error for the retry loop's
                # attribution; count the non-surfaced failures here
                surfaced = next(
                    (e for a, e in errors if not a["spec"]),
                    errors[0][1],
                )
                self._note_failed_attempts(
                    [(a, e) for a, e in errors if e is not surfaced]
                )
                raise surfaced
        att, it, first = winner
        # failed-before-the-win attempts are breaker-visible failures;
        # still-running attempts merely lost the race (breaker-neutral)
        self._note_failed_attempts(errors)
        failed = {id(a) for a, _e in errors}
        self._abandon_attempts(
            [a for a in attempts if a is not att], race_lock,
        )
        # a loser that DELIVERED before being marked lost sits in the
        # queue: its iterator/slices are discarded here (its thread
        # already exited and will not)
        self._drain_discard(results)
        for a in attempts:
            if a is not att and id(a) not in failed:
                self._record_hedge_loss(a["worker"].url)
        if hedged:
            name = "hedge_won" if att["spec"] else "hedge_lost"
            self.faults.bump("hedges_won" if att["spec"] else
                             "hedges_lost")
            self._event(name, stage=stage_id, task=task_number,
                     worker=att["worker"].url, plane="stream")
        return (att["worker"], att["key"], att["plan_obj"],
                att["store"], it, first)

    def _drain_discard(self, results) -> None:
        """Discard every already-delivered losing attempt in ``results``
        (close iterators, release slices)."""
        import queue as _queue

        while True:
            try:
                late = results.get_nowait()
            except _queue.Empty:
                return
            att, it, _first, err = late
            if err is None:
                self._discard_attempt(att, it)

    def _handle_task_failure(self, exc, url, key_tuple, state) -> bool:
        """Record + classify a failed task attempt; True -> caller retries.

        Retry only the retryable taxonomy (TransportError /
        WorkerUnavailableError / TaskTimeoutError — runtime/errors.py):
        query-semantic failures are deterministic and re-executing them
        N more times would just burn the cluster before surfacing the
        SAME error. Each retried attempt excludes the workers that
        already failed this task, so the re-dispatch reroutes (the
        excluded-runner idea); exclusion falls away when it would leave
        no candidate (single-worker clusters retry in place).

        Only RETRYABLE (infrastructure) errors count toward quarantine:
        a query-semantic failure would raise identically on any worker,
        and tripping breakers on it would punish healthy endpoints."""
        member = set(self._full_membership_urls())
        if not is_retryable(exc):
            if url and member and url not in member and isinstance(
                exc, WorkerError
            ):
                # the failure is attributed to a worker that LEFT the
                # membership: whatever the attempt relied on — staged
                # slices, cached partitions, an in-flight execution —
                # died with it, so the "fatal" classification is an
                # artifact of the departure. Reclassify as retryable
                # infrastructure so the task re-stages onto survivors.
                self.faults.bump("departed_worker_faults")
            else:
                if isinstance(exc, WorkerError):
                    self.faults.bump("fatal_failures")
                return False
        if url and url in member:
            # departed workers get no breaker state: quarantining an
            # endpoint that no longer exists would only re-grow the
            # health map the membership prune just cleaned
            self._record_worker_failure(url)
        if self._stage_span_shipped(key_tuple[0], key_tuple[1]):
            # this (query, stage) shipped as mesh SPANS: a span plan is
            # shared across sibling tasks, so re-dispatching a lone task
            # elsewhere is undefined. Keyed on what shipped, not on the
            # width cache: a membership change resetting the cache
            # mid-stage must not lift this guard
            return False
        if state.attempt >= self._opt_int("max_task_retries"):
            self.faults.bump("retries_exhausted")
            self._event(
                "retries_exhausted", stage=key_tuple[1],
                task=key_tuple[2], error=type(exc).__name__,
            )
            return False
        if isinstance(exc, TaskTimeoutError):
            self.faults.bump("task_timeouts")
        self.faults.bump("task_retries")
        self._event(
            "task_retry", stage=key_tuple[1], task=key_tuple[2],
            attempt=state.attempt, worker=url,
            error=type(exc).__name__,
        )
        if url:
            state.excluded.add(url)
        self._retry_backoff(key_tuple, state.attempt)
        state.attempt += 1
        return True

    def _retry_backoff(self, key_tuple, attempt: int) -> None:
        """Exponential backoff with DETERMINISTIC jitter: the jitter is a
        hash of (task identity, attempt), so a replayed failure schedule
        sleeps identically — fault-injection runs stay reproducible while
        concurrent retries still de-synchronize."""
        base = self._opt_float("task_retry_backoff_s")
        if base <= 0:
            return
        import time as _time
        import zlib as _zlib

        jitter = _zlib.crc32(
            repr((key_tuple, attempt)).encode()
        ) / 0xFFFFFFFF
        _time.sleep(base * (2.0 ** attempt) + base * jitter)

    def _dispatch_task_with_retry(self, stage_plan, query_id, stage_id,
                                  task_number, task_count, ttl=None,
                                  state=None, trace_parent=None):
        """Dispatch with retry + reroute. Standalone (peer-plane producers:
        ship now, execute at first pull) or as the shared dispatch phase of
        the execute/pull retry loops — ``state`` threads ONE attempt budget
        across both phases of a task. ``trace_parent``: explicit trace-span
        parent for callers whose thread has no span stack (streaming
        pullers)."""
        state = state if state is not None else _RetryState()
        kt = (query_id, stage_id, task_number)
        while True:
            self._check_cancelled()
            try:
                disp = self._dispatch_task(
                    stage_plan, query_id, stage_id, task_number, task_count,
                    ttl=ttl, exclude=state.excluded,
                    trace_parent=trace_parent,
                )
            except BaseException as e:
                if self._handle_task_failure(
                    e, getattr(e, "worker_url", "") or "", kt, state
                ):
                    continue
                raise
            if state.attempt and disp[0].url not in state.excluded:
                self.faults.bump("tasks_rerouted")
                self._event(
                    "task_rerouted", stage=stage_id, task=task_number,
                    worker=disp[0].url,
                )
            return disp

    def _pull_task_with_retry(self, stage_plan, query_id, stage_id,
                              task_number, task_count, body, cancel,
                              ttl=None, trace_parent=None):
        """Streaming-plane analogue of `_run_stage_task`'s retry loop:
        dispatch + run ``body(worker, key, cancel)`` (a chunk iterator),
        re-dispatching on retryable failures for as long as NOTHING has
        been yielded yet. Once a chunk is out, a replayed stream could
        double rows downstream, so mid-stream failures stay fatal.

        The execution deadline (`task_timeout_s`) covers the wait for the
        FIRST chunk — that wait contains the task's actual execution (the
        output materializes before any chunk can stream), so a hung worker
        converts into the retryable TaskTimeoutError here too; later
        chunks slice an already-materialized output and stream without
        per-chunk deadline overhead."""
        timeout = self._opt_float("task_timeout_s")
        state = _RetryState()
        kt = (query_id, stage_id, task_number)
        done = object()  # first-chunk sentinel: body produced nothing
        tr = self._tr()
        pull_parent = trace_parent
        if pull_parent is None and tr.active:
            pull_parent = tr.reserved_id(("stage", stage_id))
        while True:
            self._check_cancelled()
            # explicit start/end (no context manager): the span covers
            # the pull's full streaming lifetime across generator
            # suspensions, ending when the attempt resolves or the
            # consumer closes the stream
            pull_span = tr.start_span(
                "pull", "execute", parent=pull_parent,
                stage=stage_id, task=task_number, attempt=state.attempt,
            )
            try:
                worker, key, plan_obj, store = (
                    self._dispatch_task_with_retry(
                        stage_plan, query_id, stage_id, task_number,
                        task_count, ttl=ttl, state=state,
                        trace_parent=pull_span.span_id,
                    )
                )
            except BaseException as e:
                tr.end_span(pull_span.set(error=type(e).__name__))
                raise
            pull_span.set(worker=worker.url)
            yielded = False
            hedge_after = self._hedge_threshold()
            try:
                try:
                    if hedge_after is not None and (
                        not self._stage_span_shipped(query_id, stage_id)
                    ):
                        # hedge arm (streaming plane): race the FIRST
                        # chunk — the wait that contains the execution —
                        # against a speculative re-dispatch; the winner's
                        # iterator is adopted below, so nothing has been
                        # yielded before the race resolves and replay
                        # safety is untouched
                        worker, key, plan_obj, store, it, first = (
                            self._hedged_first_chunk(
                                stage_plan, query_id, stage_id,
                                task_number, task_count,
                                (worker, key, plan_obj, store),
                                body, cancel, hedge_after, state, done,
                                pull_span,
                            )
                        )
                        pull_span.set(worker=worker.url)
                    else:
                        it = iter(body(worker, key, cancel))
                        if timeout:
                            first = call_with_deadline(
                                lambda: next(it, done), timeout,
                                worker.url, key,
                            )
                        else:
                            first = next(it, done)
                    if first is not done:
                        yielded = True
                        yield first
                        for item in it:
                            yield item
                    # best-effort, as in _run_stage_task: a flaky metrics
                    # read must not fail a fully-streamed task
                    try:
                        self._record_task_progress(worker, key)
                    except Exception:
                        pass
                finally:
                    # best-effort for the same reason as _run_stage_task:
                    # never discard streamed chunks or mask the real error
                    try:
                        self._cleanup_task(worker, key, plan_obj, store)
                    except Exception:
                        pass
            except GeneratorExit:
                # the consumer abandoned the stream (satisfied LIMIT /
                # sibling failure cancellation) — not a worker fault:
                # cleanup already ran in the finally; just unwind
                tr.end_span(pull_span.set(abandoned=True))
                raise
            except BaseException as e:
                tr.end_span(pull_span.set(error=type(e).__name__))
                if cancel is not None and cancel.is_set():
                    # the stream was cancelled (satisfied LIMIT or a
                    # sibling's fatal error): teardown-induced failures
                    # are not worker faults and the output is already
                    # being discarded — no backoff, no health record,
                    # no re-dispatch
                    return
                if not yielded and self._handle_task_failure(
                    e, getattr(e, "worker_url", "") or worker.url, kt, state
                ):
                    # the failure may be a departed PEER PRODUCER feeding
                    # this streamed stage: re-ship it onto a survivor and
                    # rewrite the pull specs before the re-dispatch
                    self._heal_departed_peers(stage_plan, query_id)
                    continue
                raise
            tr.end_span(pull_span)
            self._record_worker_success(worker.url)
            return

    # -- shared task dispatch (bulk + streaming planes) ----------------------
    def _prepare_stage_plan(self, stage_plan: ExecutionPlan) -> ExecutionPlan:
        """Hook: last-moment stage-plan rewrite before shipping (the
        AdaptiveCoordinator resizes capacities from exact input stats)."""
        return stage_plan

    def _routable_urls(self, exclude=None) -> list[str]:
        """Candidate worker urls for a dispatch: quarantined workers (open
        circuit, runtime/health.py) are routed around, and a retry's
        ``exclude`` set steers the re-dispatch away from workers that
        already failed this task. Exclusion is best-effort — when it would
        leave no candidate (single-worker cluster), the excluded workers
        come back; quarantine is not — with every circuit open the query
        fails rather than hammer known-bad endpoints.

        Candidates come from LIVE membership on every call: a retry's
        ``exclude`` set is first PRUNED of urls that departed the cluster,
        so the no-candidate fallback keys on the membership of THIS
        attempt, not attempt 0's — a cluster that shrank mid-retry cannot
        exclude itself into a dead end, and a joiner is immediately
        eligible."""
        urls = self.resolver.get_urls()
        self._note_membership(urls)
        if not urls:
            raise _terminal(WorkerUnavailableError("cluster has no workers"))
        if exclude:
            # in-place: the caller's _RetryState.excluded forgets departed
            # workers for its NEXT attempts too
            exclude.intersection_update(urls)
        if self.health is not None:
            healthy = self.health.route_filter(urls)
            if not healthy:
                # RETRYABLE under elastic membership: time CAN conjure a
                # healthy worker — a quarantine expires into a half-open
                # probe, an outstanding probe resolves, a joiner arrives.
                # The retry backoff rides out the window without hammering
                # anything (this raise happens before any RPC), and the
                # retry budget still bounds a truly dead cluster
                raise WorkerUnavailableError(
                    f"no healthy workers remain ({len(urls)} quarantined)"
                )
            urls = healthy
        if exclude:
            candidates = [u for u in urls if u not in exclude]
            if candidates:
                urls = candidates
        return urls

    def _dispatch_task(self, stage_plan, query_id, stage_id, task_number,
                       task_count, ttl=None, exclude=None,
                       trace_parent=None):
        """Route, task-specialize, ship: -> (worker, key, plan_obj, store).
        ``ttl`` overrides the worker registry's idle-TTL for this entry
        (peer producers live until pulled or swept). ``exclude``: urls a
        retry must route around (the failed attempts' workers)."""
        disp = self._try_dispatch_span(stage_plan, query_id, stage_id,
                                       task_number, task_count, ttl=ttl)
        if disp is not None:
            return disp
        urls = self._routable_urls(exclude)
        if self.route_tasks is not None:
            url = self.route_tasks(query_id, stage_id, task_number, urls)
        else:
            url = urls[(stage_id + task_number) % len(urls)]  # round-robin
        worker = self.channels.get_worker(url)
        key = TaskKey(query_id, stage_id, task_number)
        store = worker.table_store
        tr = self._tr()
        with tr.span("dispatch", "dispatch", parent=trace_parent,
                     stage=stage_id, task=task_number, worker=url) as dsp:
            with tr.span("encode", "codec", stage=stage_id) as esp:
                from datafusion_distributed_tpu_torch.runtime.codec import (
                    staging_attribution,
                )

                # per-query staged-byte attribution (estimate-vs-measured
                # loop): owned bytes this encode stages into the worker
                # store are charged to this query id
                with staging_attribution(query_id):
                    plan_obj = encode_plan(
                        _task_specialized(stage_plan, task_number,
                                          self._device),
                        store,
                    )
                if tr.active:
                    from datafusion_distributed_tpu_torch.runtime.codec import (
                        collect_table_ids as _ctids,
                    )

                    # staged bytes: the slices this ship moves into the
                    # worker's TableStore (in-process: by reference; wire:
                    # serialized) — the store's RECORDED entry sizes, so
                    # encode spans and store accounting can never disagree
                    # (entry_nbytes is table_nbytes captured at put time)
                    esp.set(bytes=sum(
                        store.entry_nbytes(tid)
                        for tid in _ctids(plan_obj)
                    ))
            config = self.config_options
            if tr.active:
                # cross-wire trace context: rides the task envelope's
                # config dict. NEVER a compile-cache input — the worker
                # strips it before execute_plan, physical.py filters it
                # from cfg_items (span ids differ per task; keying on
                # them would force one XLA trace per task). The parent is
                # the span ABOVE the dispatch (the task attempt / pull),
                # so worker-side spans slot in as siblings of dispatch
                # and execute, where they belong on the timeline.
                ctx = tr.wire_ctx()
                ctx["parent"] = dsp.parent_id
                config = {**config, TRACE_CTX_KEY: ctx}
            ship_kw = {}
            ship_cancel = getattr(self, "_cancel_event", None)
            if ship_cancel is not None and self._worker_accepts_param(
                worker, "set_plan", "cancel"
            ):
                # surfaces that declare a dispatch cancel (chaos proxies)
                # get the per-query event so injected ship delays abort
                # at cancellation latency
                ship_kw["cancel"] = ship_cancel
            dispatch_timeout = self._opt_float("dispatch_timeout_s")
            if dispatch_timeout and self._worker_accepts_timeout(
                worker, "set_plan"
            ):
                # pass only when configured AND the surface declares it:
                # custom duck-typed workers predating the deadline
                # parameter keep working (no deadline) instead of dying
                # on a TypeError
                ship_kw["timeout"] = dispatch_timeout
            try:
                with tr.span("ship", "rpc", worker=url):
                    # a wire transport returns the framed bytes it put on
                    # the wire (GrpcWorkerClient.set_plan); in-process
                    # workers return None — no wire hop to attribute
                    shipped = worker.set_plan(
                        key, plan_obj, task_count, config=config,
                        headers=self.passthrough_headers, ttl=ttl,
                        **ship_kw,
                    )
            except BaseException:
                # a failed ship leaves no registry entry to own the staged
                # slices — release them here or they leak until process
                # exit
                from datafusion_distributed_tpu_torch.runtime.codec import (
                    collect_table_ids,
                )

                store.remove(collect_table_ids(plan_obj))
                raise
            if tr.active and isinstance(shipped, int):
                dsp.set(wire_bytes=shipped)
        return worker, key, plan_obj, store

    def _try_dispatch_span(self, stage_plan, query_id, stage_id,
                           task_number, task_count, ttl=None):
        """Meshes-as-workers dispatch: when every worker owns several
        devices (`MeshWorker.mesh_width`), a stage's tasks ship as
        contiguous SPANS — worker k gets tasks [kW, (k+1)W) as ONE span
        plan, decoded and checked once for its W tasks. Per-task keys stay
        the data-plane address, so peer pulls and streams work unchanged
        between workers. Returns None when span dispatch does not apply
        (mixed cluster, custom routing, span-inexpressible plans)."""
        if self.route_tasks is not None:
            return None
        tok = self._note_membership()
        cached_w = getattr(self, "_mesh_span_width", None)
        if cached_w is not None and cached_w[0] == tok:
            span_w = cached_w[1]
        else:
            # cached per membership token (stored WITH the token and
            # ignored on mismatch, as _workers_peer_capable's verdict)
            urls0 = self.resolver.get_urls()
            widths = [
                getattr(self.channels.get_worker(u), "mesh_width", 0)
                for u in urls0
            ]
            span_w = min(widths) if widths and all(
                w > 0 for w in widths
            ) else 0
            self._mesh_span_width = (tok, span_w)
        if span_w <= 0:
            return None
        from datafusion_distributed_tpu_torch.runtime.mesh_worker import (
            span_specializable,
            span_specialized,
        )

        if not hasattr(self, "_span_lock"):
            # a direct call without execute: these bare writes come before
            # any sibling-stage thread shares this coordinator (as
            # execute's per-query resets do)
            self._span_lock = threading.Lock()
            self._span_shipped = {}
            self._span_ok_cache = {}
        # keyed by (query, stage): per-task prepared plans are transient
        # objects (id() recycles within a query) but share one structure
        ok_key = (query_id, stage_id)
        with self._span_lock:
            ok = self._span_ok_cache.get(ok_key)
            if ok is None:
                ok = self._span_ok_cache[ok_key] = span_specializable(
                    stage_plan
                )
        if not ok:
            return None
        span = task_number // span_w
        key = TaskKey(query_id, stage_id, task_number)
        lo, hi = span * span_w, min((span + 1) * span_w, task_count)
        ship_key = (query_id, stage_id, lo)
        with self._span_lock:
            hit = self._span_shipped.get(ship_key)
            if hit is None:
                # route from live membership only when SHIPPING the span;
                # sibling tasks reuse the shipped worker below, so a
                # membership change between siblings cannot split one
                # span's tasks across two workers
                urls = self.resolver.get_urls()
                url = urls[(stage_id + span) % len(urls)]
                worker = self.channels.get_worker(url)
                from datafusion_distributed_tpu_torch.runtime.codec import (
                    collect_table_ids,
                    staging_attribution,
                )

                with staging_attribution(query_id):
                    plan_obj = encode_plan(
                        span_specialized(stage_plan, lo, hi),
                        worker.table_store,
                    )
                try:
                    worker.set_stage_plan(
                        query_id, stage_id, lo, hi, task_count, plan_obj,
                        config=self.config_options,
                        headers=self.passthrough_headers,
                        ttl=ttl,
                    )
                except BaseException:
                    # a failed ship leaves no registry entry to own the
                    # staged slices
                    worker.table_store.remove(collect_table_ids(plan_obj))
                    raise
                hit = self._span_shipped[ship_key] = (plan_obj, worker)
        plan_obj, worker = hit
        return worker, key, plan_obj, worker.table_store

    def _record_task_progress(self, worker, key) -> None:
        tr = self._tr()
        # tracing reads the progress payload even with metrics collection
        # off: the worker-side spans ride it, and `collect_metrics=False`
        # must not silently amputate the cross-wire half of a trace the
        # user explicitly turned on
        if not self.collect_metrics and not tr.active:
            return
        progress = worker.task_progress(key) or {}
        # worker-side spans (decode/execute, runtime/worker.py) ride the
        # progress payload over BOTH transports; splice them into the
        # query trace under their propagated wire parent — this is the
        # cross-wire join making worker time attributable per task
        spans = progress.pop("spans", None)
        if spans and tr.active:
            tr.splice(spans)
        if not self.collect_metrics:
            return
        self.metrics[key] = progress
        elapsed = progress.get("elapsed_s")
        if elapsed is not None and self.latency is not None:
            self.latency.record(float(elapsed))

    def _cleanup_task(self, worker, key, plan_obj, store) -> None:
        # drop-driven cleanup: the task's cache entry AND its shipped
        # table slices are released as soon as its single partition is
        # consumed (reference: on_drop_stream + invalidate,
        # `impl_execute_task.rs:97-112`)
        worker.registry.invalidate(key)
        from datafusion_distributed_tpu_torch.runtime.codec import (
            collect_table_ids,
        )

        store.remove(collect_table_ids(plan_obj))


@dataclass
class AdaptiveCoordinator(Coordinator):
    """Dynamic-planning coordinator (the reference's `dynamic_task_count`
    mode): consumer stages are re-sized from runtime LoadInfo — planning
    and execution interleave (`prepare_dynamic_plan.rs`). Both CAPACITIES
    (resize_for_inputs) and TASK COUNTS (compute_based_task_count analogue:
    ceil(bytes / bytes_per_task)) adapt.

    Mid-execution sampling: every dispatch path streams per-completion
    LoadInfo (`_producer_progress` — the reference's SamplerExec stream,
    `sampler.rs:30-42`); once `sample_fraction` of a stage's producer
    tasks have completed, the consumer's statistics are EXTRAPOLATED from
    that partial per-task sample and frozen — the sizing decision is taken
    while the remaining producers are still running, exactly the
    reference's 20%%-sample short-circuit (`prepare_dynamic_plan.rs:
    111-141,206-331`). In this bulk-synchronous host tier the consumer
    still launches only after its inputs materialize, so what the early
    freeze buys is the reference's decision protocol (sample-extrapolated
    sizing, available to e.g. pre-compile or pre-provision the consumer)
    rather than wall-clock overlap; stages whose producers finish before
    the threshold fall back to exact statistics."""

    #: declarative concurrency model: the co-shuffled-group barrier state
    #: mutates from sibling stage-DAG threads (see _finish_shuffle); the
    #: read-only group topology maps (_group_of/_group_members/
    #: _group_heads) are written once in execute before any fan-out
    _GUARDED_BY = {"_group_pending": "_group_lock"}

    #: compute_based_task_count divisor (prepare_dynamic_plan.rs:60-69 uses
    #: cpu_cost / bytes_per_partition_per_second; here exact bytes / this)
    bytes_per_task: int = 16 << 20
    #: fraction of producer tasks whose completion triggers the partial-
    #: sample decision (the reference short-circuits at 20% sampling)
    sample_fraction: float = 0.25
    #: safety margin applied to extrapolated rows (underestimating a
    #: capacity costs an overflow-retry; overestimating only pads)
    extrapolation_headroom: float = 1.25
    #: resize_for_inputs headroom; quadruples after an overflow so the
    #: session's overflow-retry CONVERGES — otherwise each retry replans
    #: wider and the adaptive resize shrinks straight back to the same
    #: overflowing capacity
    resize_headroom: float = 2.0

    #: multiplier applied to resize_headroom per overflow (and per pinned
    #: retry attempt — both schedules MUST share this constant)
    OVERFLOW_WIDEN_FACTOR = 4.0

    def __post_init__(self):
        # remember the CONSTRUCTED value: the post-query reset must restore
        # a caller-configured headroom, not clobber it with the class default
        self._base_resize_headroom = self.resize_headroom
        self._headroom_pinned = False

    def _checkpoint_eligible(self) -> bool:
        """Adaptive lattices derive from runtime LoadInfo (consumer task
        counts and capacities re-sized mid-query from sampled outputs):
        a restored checkpoint lattice could disagree with the one a
        resume would re-derive, so the adaptive coordinator opts out of
        checkpoint save/restore entirely — resumes under it degrade to
        full re-execution, never to a mismatched lattice."""
        return False

    def pin_overflow_headroom(self, attempt: int) -> None:
        """Widen the resize headroom for retry ``attempt`` of one query and
        PIN it: scalar subqueries execute through this same coordinator and
        their success must not reset the outer query's widened headroom to
        base mid-attempt (q11's HAVING subquery did exactly that, so the
        overflowing group-by re-ran at base headroom on every retry).
        Callers release with release_overflow_headroom() when the query's
        retry loop ends."""
        self.resize_headroom = (
            self._base_resize_headroom
            * (self.OVERFLOW_WIDEN_FACTOR ** attempt)
        )
        self._headroom_pinned = True

    def release_overflow_headroom(self) -> None:
        self._headroom_pinned = False
        self.resize_headroom = self._base_resize_headroom

    def execute(self, plan: ExecutionPlan) -> Table:
        self._load_info: dict[int, object] = {}
        self.task_count_decisions: list[tuple[int, int, int]] = []
        #: stage_id -> LoadInfo predicted from a partial producer sample
        self._predicted: dict[int, object] = {}
        #: stage_id -> mid-stream per-column sampler (fresh per query:
        #: stage ids repeat across queries)
        self._col_samplers: dict = {}
        #: stage_id -> (done, total) at decision time — test/introspection
        #: surface proving the decision predates producer completion
        self.partial_decisions: dict[int, tuple[int, int]] = {}
        self._solo_shuffles = _find_solo_shuffles(plan)
        # co-shuffled groups (join stages fed by >= 2 shuffles) adapt
        # TOGETHER: the shared consumer count is decided once, from the
        # combined runtime statistics of every feeding shuffle, before any
        # side's slices ship (prepare_dynamic_plan.rs re-injection analogue)
        self._group_of: dict = {}
        self._group_members: dict = {}
        self._group_heads: dict = {}
        self._group_pending: dict = {}
        # serializes group registration under the concurrent stage-DAG
        # scheduler (members of one co-shuffled group materialize in
        # sibling threads; the last-one-in decide must fire exactly once)
        self._group_lock = threading.Lock()
        #: stage_id -> (consumer head node, original exchange node_id) for
        #: the stage-cost model (compute_based_task_count analogue)
        self._stage_heads: dict = {}
        for head, shuffles in _shuffle_consumer_groups(plan):
            for s in shuffles:
                self._stage_heads[s.stage_id] = (head, s.node_id)
            if len(shuffles) >= 2:
                gid = tuple(sorted(s.stage_id for s in shuffles))
                self._group_members[gid] = [s.stage_id for s in shuffles]
                self._group_heads[gid] = head
                for s in shuffles:
                    self._group_of[s.stage_id] = gid
        try:
            out = super().execute(plan)
        except RuntimeError as e:
            if "overflow" in str(e):
                self.resize_headroom *= self.OVERFLOW_WIDEN_FACTOR
            raise
        # success: back to the constructed value so one query's widening does
        # not permanently inflate every later query on this coordinator —
        # UNLESS a retry loop pinned the headroom (pin_overflow_headroom)
        if not self._headroom_pinned:
            self.resize_headroom = self._base_resize_headroom
        return out

    def _partition_streams_enabled(self, exchange) -> bool:
        # adaptive mode recomputes consumer task counts from exact
        # materialized outputs; a partition stream would fix the count
        # in the producer request before those statistics exist
        return False

    def _peer_plane_enabled(self, exchange) -> bool:
        # same rationale: the peer plane fixes partition counts and pull
        # specs at plan-ship time, before runtime statistics exist
        return False

    # -- mid-execution sampling ------------------------------------------
    def _chunk_observer(self, stage_id):
        """Per-stage ColumnStreamSampler fed by in-flight chunks/outputs:
        per-column NDV + null fractions + velocity exist BEFORE the stage
        finishes (the reference SamplerExec's LoadInfo stream,
        `sampler.rs:30-42`)."""
        from datafusion_distributed_tpu_torch.planner.adaptive import (
            ColumnStreamSampler,
        )

        samplers = getattr(self, "_col_samplers", None)
        if samplers is None:
            samplers = self._col_samplers = {}
        if stage_id not in samplers:
            samplers[stage_id] = ColumnStreamSampler()
        return samplers[stage_id].observe

    def _producer_progress(self, stage_id, done, total, rows, width):
        if stage_id in self._predicted or done >= total or done <= 0:
            return
        import math

        if done < max(1, math.ceil(total * self.sample_fraction)):
            return
        from datafusion_distributed_tpu_torch.planner.adaptive import LoadInfo

        pred_rows = int(rows * total / done * self.extrapolation_headroom)
        sampler = getattr(self, "_col_samplers", {}).get(stage_id)
        if sampler is not None and sampler.sampled > 0:
            # freeze WITH the mid-stream column statistics; NDV is
            # extrapolated by producer coverage (hash-partitioned outputs
            # carry disjoint key values, so done/total of the producers
            # have seen ~done/total of the distinct values), null
            # fractions and velocity ride along
            info = sampler.load_info(pred_rows, width,
                                     ndv_scale=total / done)
        else:
            info = LoadInfo(rows=pred_rows, bytes=pred_rows * width)
        self._predicted[stage_id] = info
        self.partial_decisions[stage_id] = (done, total)

    def _seed_consumer_scan(self, exchange, scan) -> None:
        """Freeze the mid-execution prediction as the consumer's LoadInfo:
        `_stage_input_info` will size the consumer stage from the partial
        sample instead of re-measuring the final tables."""
        pred = self._predicted.get(exchange.stage_id)
        if pred is not None:
            self._load_info[scan.node_id] = pred

    def _consumer_task_count(self, exchange, outputs) -> int:
        """Recompute the consumer task count from producer-output bytes
        (dynamic_task_count semantics); the planned count is only an upper
        bound. Uses the mid-execution prediction when one was frozen,
        exact bytes otherwise.

        This method handles SOLO shuffles (consumer stage fed by exactly
        one shuffle). Co-shuffled siblings — a hash-join's sides must agree
        on `hash % t` — adapt together through the deferred group decision
        in `_finish_shuffle`/`_decide_group` (the reference re-plans whole
        stages for the same reason, `prepare_dynamic_plan.rs`).
        Coalesce/broadcast outputs are replicated single tables — task
        counts do not apply to them."""
        from datafusion_distributed_tpu_torch.planner.statistics import row_width

        if not isinstance(exchange, ShuffleExchangeExec):
            return exchange.num_tasks
        if exchange.stage_id not in getattr(self, "_solo_shuffles", set()):
            return exchange.num_tasks
        if not outputs or self.bytes_per_task <= 0:
            return exchange.num_tasks
        pred = self._predicted.get(exchange.stage_id)
        if pred is not None:
            nbytes = pred.bytes
        else:
            width = row_width(outputs[0].schema())
            nbytes = sum(read_rows(outputs)) * width
        want = max(1, -(-nbytes // self.bytes_per_task))
        t = min(exchange.num_tasks, int(want))
        # cost-informed floor: size by the consumer STAGE's modeled device
        # work, not bytes alone (the compute_based_task_count of
        # `prepare_dynamic_plan.rs:60-69`) — a compute-heavy consumer
        # (join probe, multi-round aggregate) keeps more tasks than its
        # input bytes would suggest
        head_info = self._stage_heads.get(exchange.stage_id)
        if head_info is not None:
            from datafusion_distributed_tpu_torch.planner.statistics import (
                PlanStatistics,
                compute_based_task_count,
                stage_cost,
            )

            head, orig_nid = head_info
            rows = (pred.rows if pred is not None
                    else sum(read_rows(outputs)))
            cost = stage_cost(
                head, PlanStatistics(rows={orig_nid: float(rows)})
            )
            t_cost = compute_based_task_count(
                cost, float(max(self.bytes_per_task, 1)), exchange.num_tasks
            )
            t = min(exchange.num_tasks, max(t, t_cost))
        self.task_count_decisions.append(
            (exchange.stage_id if exchange.stage_id is not None else -1,
             exchange.num_tasks, t)
        )
        return t

    def _finish_shuffle(self, exchange, outputs, producer):
        """Co-shuffled siblings defer their regroup until EVERY member of
        the group has materialized its producers; the shared consumer count
        is then decided once from the combined statistics. Solo shuffles
        keep the immediate path (base + adaptive `_consumer_task_count`).

        Under the stage-DAG scheduler the group members materialize
        CONCURRENTLY, so the group decision is a real barrier now, not a
        recursion-order artifact: registration is serialized by
        `_group_lock` and exactly the member that completes the group runs
        `_decide_group` (before its own stage job returns — the DAG edges
        guarantee the consumer stage is only released after every feed's
        job finished, i.e. after the decision filled the placeholders)."""
        gid = self._group_of.get(exchange.stage_id)
        if gid is None:
            return super()._finish_shuffle(exchange, outputs, producer)
        # placeholder scan, filled in-place when the group decides: the
        # consumer stage only reads it after all its feeds materialized
        # (sequential: recursion order; DAG: dependency edges + the
        # synchronous decide below)
        scan = MemoryScanExec([], producer.schema())
        complete = None
        with self._group_lock:
            pend = self._group_pending.setdefault(gid, {})
            pend[exchange.stage_id] = (exchange, outputs, scan)
            if len(pend) == len(self._group_members[gid]):
                complete = self._group_pending.pop(gid)
        if complete is not None:
            # heavy work (hash regroup) deliberately OUTSIDE the lock
            self._decide_group(gid, complete)
        return scan

    def _decide_group(self, gid, pend) -> None:
        from datafusion_distributed_tpu_torch.planner.statistics import (
            PlanStatistics,
            compute_based_task_count,
            row_width,
            stage_cost,
        )

        head = self._group_heads[gid]
        planned = min(ex.num_tasks for ex, _, _ in pend.values())
        total_bytes = 0
        rows_stats: dict = {}
        # deterministic iteration: under the DAG scheduler dict insertion
        # order is COMPLETION order, which varies run to run — the
        # decision's inputs are order-independent sums/mins, but the
        # regroup + decision log below must not be
        for sid in sorted(pend):
            (ex, outputs, _scan) = pend[sid]
            pred = self._predicted.get(sid)
            if pred is not None:
                rows, nbytes = pred.rows, pred.bytes
            else:
                width = row_width(outputs[0].schema()) if outputs else 8
                rows = sum(read_rows(outputs))
                nbytes = rows * width
            total_bytes += nbytes
            head_info = self._stage_heads.get(sid)
            if head_info is not None:
                rows_stats[head_info[1]] = float(rows)
        if self.bytes_per_task > 0:
            t_bytes = max(1, -(-int(total_bytes) // self.bytes_per_task))
        else:
            t_bytes = planned
        cost = stage_cost(head, PlanStatistics(rows=rows_stats))
        t_cost = compute_based_task_count(
            cost, float(max(self.bytes_per_task, 1)), planned
        )
        t = min(planned, max(t_bytes, t_cost))
        for sid in sorted(pend):
            (ex, outputs, scan) = pend[sid]
            scan.tasks[:] = _shuffle_regroup(
                outputs, ex.key_names, t, ex.per_dest_capacity,
                zero_copy=self._zero_copy(),
            )
            self.task_count_decisions.append((sid, ex.num_tasks, t))

    def _prepare_stage_plan(self, stage_plan):
        """Resize stage capacities from runtime LoadInfo (exact or
        partial-sample-predicted) — applied by BOTH the bulk and streaming
        dispatch paths."""
        info = self._stage_input_info(stage_plan)
        if info is None:
            return stage_plan
        from datafusion_distributed_tpu_torch.planner.adaptive import (
            resize_for_inputs,
        )

        return resize_for_inputs(stage_plan, info,
                                 skew_headroom=self.resize_headroom)

    def _stage_input_info(self, stage_plan):
        from datafusion_distributed_tpu_torch.planner.adaptive import (
            LoadInfo,
            collect_load_info,
        )

        scans = [
            n for n in stage_plan.collect(lambda n: not n.children())
            if isinstance(n, MemoryScanExec)
        ]
        if not scans:
            return None
        merged: Optional[LoadInfo] = None
        for s in scans:
            info = self._load_info.get(s.node_id)
            if info is None:
                info = collect_load_info(s.tasks)
                self._load_info[s.node_id] = info
            if merged is None or info.rows > merged.rows:
                merged = info
        return merged


def _shuffle_consumer_groups(plan: ExecutionPlan) -> list:
    """-> [(consumer head node, [feeding ShuffleExchangeExec nodes])] for
    every stage of the ORIGINAL plan tree. A head fed by ONE shuffle can
    re-size that shuffle independently; a head fed by several (a co-shuffled
    join) must re-size them TOGETHER or `hash % t` co-partitioning breaks —
    the situation the reference solves by re-running boundary injection per
    stage at runtime (`prepare_dynamic_plan.rs:26-141`)."""

    def frontier(node) -> list:
        out = []
        for c in node.children():
            if getattr(c, "is_exchange", False):
                out.append(c)
            else:
                out.extend(frontier(c))
        return out

    groups = []
    heads = [plan] + [
        e.children()[0]
        for e in plan.collect(lambda n: getattr(n, "is_exchange", False))
    ]
    for head in heads:
        shuffles = [
            f for f in frontier(head)
            if isinstance(f, ShuffleExchangeExec)
            and not isinstance(f, RangeShuffleExchangeExec)
            and f.stage_id is not None
        ]
        if shuffles:
            groups.append((head, shuffles))
    return groups


def _find_solo_shuffles(plan: ExecutionPlan) -> set:
    """ids of ShuffleExchangeExec nodes whose consumer stage is fed by no
    OTHER shuffle (safe to re-size independently; keyed by stage_id —
    materialization rebuilds nodes, object identity does not survive
    with_new_children)."""
    return {
        s[0].stage_id
        for _, s in _shuffle_consumer_groups(plan)
        if len(s) == 1
    }


def _task_specialized(plan: ExecutionPlan, task_number: int,
                      device=None) -> ExecutionPlan:
    """Ship only this task's leaf slice (the reference strips other tasks'
    DistributedLeaf variants before sending, `query_coordinator.rs:346-382`).

    Inside an IsolatedArmExec that IS assigned to this task, partitioned
    scans contribute ALL their slices, concatenated: the arm executes on
    exactly one task, so it is the sole consumer of any exchange output or
    base-table slice in its subtree — indexing those by the OUTER task
    number would silently drop every slice but this task's (observed as
    q5's catalog channel vanishing when its arm landed on task 1 and the
    arm's scans held a single slice 0). This is the reference's inner
    `DistributedTaskContext` remap for union children
    (`children_isolator_union.rs:84-100`). ``device``: where an empty slice
    made here lives (the stage's device)."""

    from datafusion_distributed_tpu_torch.runtime.peer import PeerShuffleScanExec

    def walk(node: ExecutionPlan, in_arm: bool) -> ExecutionPlan:
        if isinstance(node, StreamScanExec):
            # pipelined-shuffle feed: resolve to THIS task's partition by
            # blocking until it closes (the pipelined wait point — the
            # feed keeps streaming the remaining partitions meanwhile).
            # Inside an arm the sole consumer takes every partition,
            # concatenated, mirroring the MemoryScan in-arm concat.
            if in_arm:
                slices = node.all_slices()
                chosen = (slices[0] if len(slices) == 1 else concat_tables(
                    slices, capacity=sum(s.capacity for s in slices)
                ))
            elif task_number < node.num_partitions:
                chosen = node.task_slice(task_number)
            else:
                chosen = Table.empty(node.schema(), 8, node.dictionaries,
                                     device=node.device)
            return MemoryScanExec([chosen], node.schema(), pinned=True)
        if isinstance(node, PeerShuffleScanExec):
            if node.pinned_task is not None or node.pull_all:
                return node  # already specialized
            if node.replicated:
                # broadcast: EVERY virtual partition is the producer's full
                # output — pull exactly ONE, in or out of an arm (pull_all
                # here would duplicate the build side num_partitions x);
                # modulo guards a consumer stage forced wider than the
                # broadcast's planned fan-out by a sibling feed
                return node.pinned_copy(
                    task_number % max(node.num_partitions, 1)
                )
            # in an arm: the sole consumer pulls EVERY partition (same
            # argument as the MemoryScan concat below)
            return node.pinned_copy(task_number, pull_all=in_arm)
        if isinstance(node, IsolatedArmExec):
            if node.assigned_task != task_number:
                # ChildrenIsolatorUnion semantics: this arm belongs to
                # another task; ship an empty scan instead of the subtree
                schema = node.schema()
                empty = Table.empty(schema, 8, None, device=device)
                return MemoryScanExec([empty], schema, pinned=True)
            return walk(node.child, True)
        if in_arm:
            from datafusion_distributed_tpu_torch.plan.physical import (
                ParquetScanExec,
            )

            if isinstance(node, ParquetScanExec):
                # the arm's task reads EVERY file group (same sole-consumer
                # argument as the MemoryScan case below)
                flat = [f for g in node.file_groups for f in g]
                groups = [[] for _ in range(task_number)] + [flat]
                return ParquetScanExec(
                    groups, node.schema(),
                    node.capacity * max(len(node.file_groups), 1),
                    projection=node.projection,
                    dictionaries=node.dictionaries,
                    device=node.device,
                )
        if isinstance(node, MemoryScanExec) and node.replicated:
            # every task reads the same merged table
            return MemoryScanExec([node.tasks[0]], node.schema(),
                                  pinned=True)
        if isinstance(node, MemoryScanExec) and not node.pinned:
            if in_arm:
                if len(node.tasks) == 1:
                    chosen = node.tasks[0]
                else:
                    chosen = concat_tables(
                        node.tasks,
                        capacity=sum(t.capacity for t in node.tasks),
                    )
            elif task_number < len(node.tasks):
                chosen = node.tasks[task_number]
            else:
                from datafusion_distributed_tpu_torch.plan.physical import _dicts_of

                ref = node.tasks[0]
                chosen = Table.empty(
                    node.schema(), ref.capacity, _dicts_of(ref),
                    device=ref.device,
                )
            return MemoryScanExec([chosen], node.schema(), pinned=True)
        children = [walk(c, in_arm) for c in node.children()]
        return node.with_new_children(children) if children else node

    return walk(plan, False)


def _shuffle_regroup(
    outputs: Sequence[Table], key_names, num_tasks: int,
    per_dest_capacity: int, zero_copy: bool = True, exact: bool = False,
) -> list[Table]:
    """Hash regroup between stages, where the producers live. Uses the SAME
    hash as the task executor's shuffle (ops/hash.py, bit-identical to the
    reference's device hash and to the native host hash), so keys co-locate
    across tiers.

    Producer tables on the card are bucketed there; producer tables in host
    memory by the native host data plane (native/: its hash and CSR
    buckets, `_shuffle_regroup_host`), as the reference's regroup does.
    The tables' device decides, never whether the library built: a failed
    build raises.

    ``zero_copy`` (the view-based data plane, default on): each producer
    output is bucketed with ONE stable destination-major gather per column,
    and every per-destination slice is a zero-copy view of it
    (`_shuffle_regroup_views`). ``exact`` skips the per-destination
    capacity padding (the peer partition plane, where slices only feed
    chunk streams); without it the returned slices keep the
    ``len(outputs) * per_dest_capacity`` padded shape that consumer stage
    plans key on.

    The copying path (``zero_copy`` off) compacts each destination's rows
    out of each producer and concatenates them: the same rows in the same
    order, so both paths give the same bytes."""
    if outputs and all(is_host_backed(o) for o in outputs):
        return _shuffle_regroup_host(
            outputs, key_names, num_tasks, per_dest_capacity, zero_copy,
            exact,
        )
    if zero_copy:
        return _shuffle_regroup_views(
            outputs, key_names, num_tasks, per_dest_capacity, exact
        )
    buckets: list[list[Table]] = [[] for _ in range(num_tasks)]
    for out in outputs:
        dest = hash_columns([out.column(k).data for k in key_names],
                            [out.column(k).validity for k in key_names]
                            ) % num_tasks
        live = out.row_mask()
        for j in range(num_tasks):
            buckets[j].append(out.compact(live & (dest == j)))
    slices = []
    # each of the len(outputs) producers contributes <= per_dest_capacity
    # rows to a destination (task counts may differ per stage)
    cap = max(len(outputs), 1) * per_dest_capacity
    for j in range(num_tasks):
        slices.append(concat_tables(buckets[j], capacity=cap))
    return slices


def _shuffle_regroup_host(
    outputs: Sequence[Table], key_names, num_tasks: int,
    per_dest_capacity: int, zero_copy: bool, exact: bool,
) -> list[Table]:
    """The regroup of producer tables in host memory (port of the
    reference's `_shuffle_regroup_host` and its native copying path): the
    native library hashes each output's live key rows and builds the CSR of
    row indices per destination, each destination's rows in their original
    order. On the view plane one gather per column by that CSR makes a
    destination-major buffer whose per-destination row ranges are the
    slices; the copying plane gathers each destination's rows out of each
    producer at the producer's capacity (the padding is row 0, as
    `Table.compact` pads). Both give the rows and order of the device
    paths, so every plane stays byte-identical."""
    from datafusion_distributed_tpu_torch import native

    ns = read_rows(outputs)
    buckets: list[list[Table]] = [[] for _ in range(num_tasks)]
    for out, n in zip(outputs, ns):
        keys = [_narrowed(out.column(k), n) for k in key_names]
        h = native.hash_rows(
            [c.data.numpy() for c in keys],
            [c.validity.numpy() if c.validity is not None else None
             for c in keys],
            [c.dtype for c in keys],
        )
        offsets, indices, counts = native.shuffle_buckets(h, None, num_tasks)
        order = torch.from_numpy(indices)
        if zero_copy:
            gathered = Table(
                out.names,
                tuple(_narrowed(c, n).gather(order) for c in out.columns),
                out.num_rows,
            )
            gathered._host_rows = n
            for j in range(num_tasks):
                buckets[j].append(slice_view(
                    gathered, int(offsets[j]), int(counts[j])))
            continue
        for j in range(num_tasks):
            idx = torch.zeros(out.capacity, dtype=torch.int64)
            idx[: int(counts[j])] = order[int(offsets[j]):int(offsets[j + 1])]
            piece = out.gather(idx, int(counts[j]))
            piece._host_rows = int(counts[j])
            buckets[j].append(piece)
    cap = max(len(outputs), 1) * per_dest_capacity
    slices = []
    for j in range(num_tasks):
        if not zero_copy:
            slices.append(concat_tables(buckets[j], capacity=cap))
            continue
        if exact and len(buckets[j]) == 1:
            slices.append(buckets[j][0])
            continue
        rows = sum(host_rows(b) for b in buckets[j])
        slices.append(concat_tables(
            buckets[j],
            capacity=(max(rows, 1) if exact else cap),
        ))
    return slices


def _shuffle_regroup_views(
    outputs: Sequence[Table], key_names, num_tasks: int,
    per_dest_capacity: int, exact: bool,
) -> list[Table]:
    """View-based regroup on the device: per producer output, hash the keys
    of its live rows, stable-sort the row indices by destination, gather
    ONCE per column into a destination-major buffer, and hand out
    per-destination row-range views of it. Row order within each
    destination matches the copying path exactly (a stable sort keeps the
    original order within a bucket), so results stay byte-identical. The
    host reads each output's row count (one transfer for all of them) and
    the per-destination counts (one more)."""
    ns = read_rows(outputs)
    gathered, counts = [], []
    for out, n in zip(outputs, ns):
        keys = [_narrowed(out.column(k), n) for k in key_names]
        dest = hash_columns([c.data for c in keys],
                            [c.validity for c in keys]) % num_tasks
        order = torch.sort(dest, stable=True).indices
        counts.append(torch.bincount(dest, minlength=num_tasks))
        gathered.append(Table(
            out.names,
            tuple(_narrowed(c, n).gather(order) for c in out.columns),
            out.num_rows,
        ))
    # the per-destination counts of every producer in one transfer
    host_counts = (torch.stack(counts).cpu().tolist() if counts else [])
    buckets: list[list[Table]] = [[] for _ in range(num_tasks)]
    for g, n, cnt in zip(gathered, ns, host_counts):
        g._host_rows = n
        lo = 0
        for j in range(num_tasks):
            buckets[j].append(slice_view(g, lo, cnt[j]))
            lo += cnt[j]
    cap = max(len(outputs), 1) * per_dest_capacity
    slices = []
    for j in range(num_tasks):
        if exact and len(buckets[j]) == 1:
            slices.append(buckets[j][0])
            continue
        rows = sum(host_rows(b) for b in buckets[j])
        slices.append(concat_tables(
            buckets[j],
            capacity=(max(rows, 1) if exact else cap),
        ))
    return slices


def _narrowed(c: Column, n: int) -> Column:
    """A column's first ``n`` rows as a view."""
    return Column(
        c.data.narrow(0, 0, n),
        c.validity.narrow(0, 0, n) if c.validity is not None else None,
        c.dtype, c.dictionary,
    )


def _range_regroup(outputs: Sequence[Table], sort_keys,
                   num_tasks: int) -> list[Table]:
    """Exact host-side range partition: concat, sort once, contiguous
    slices. Slice i's rows all order before slice i+1's, so consumers'
    local sorts + an order-preserving coalesce reproduce the global
    order (mesh-tier contract of RangeShuffleExchangeExec)."""
    from datafusion_distributed_tpu_torch.ops.sort import sort_table

    read_rows(outputs)  # one transfer; the concat then copies by offsets
    total = concat_tables(
        outputs, capacity=sum(o.capacity for o in outputs)
    )
    s = sort_table(total, sort_keys)
    n = host_rows(s)
    per = -(-max(n, 1) // num_tasks)
    slices = []
    for i in range(num_tasks):
        count = max(min(per, n - i * per), 0)
        if count > 0:
            slices.append(s.slice_rows(i * per, count))
        else:
            from datafusion_distributed_tpu_torch.plan.physical import _dicts_of

            slices.append(Table.empty(s.schema(), 8, _dicts_of(s),
                                      device=s.device))
    return slices


def _leaf_dictionaries(plan: ExecutionPlan, schema) -> Optional[dict]:
    """Best-effort dictionaries for an empty result table: string columns in
    `schema` keep the codes minted at the leaves, so a zero-row fallback must
    carry the same dictionaries a real (bulk) result would — dictionary-
    dependent consumers (literal code lookups) break on a bare None."""
    from datafusion_distributed_tpu_torch.plan.physical import ParquetScanExec

    from datafusion_distributed_tpu_torch.runtime.peer import PeerShuffleScanExec

    out: dict = {}
    names = {f.name for f in schema.fields}
    for leaf in plan.collect(lambda n: not n.children()):
        dicts: dict = {}
        if isinstance(leaf, ParquetScanExec) and leaf.dictionaries:
            dicts = leaf.dictionaries
        elif isinstance(leaf, PeerShuffleScanExec) and leaf.dictionaries:
            dicts = leaf.dictionaries
        elif isinstance(leaf, StreamScanExec) and leaf.dictionaries:
            dicts = leaf.dictionaries
        elif isinstance(leaf, MemoryScanExec) and leaf.tasks:
            ref = leaf.tasks[0]
            dicts = {
                n: c.dictionary
                for n, c in zip(ref.names, ref.columns)
                if c.dictionary is not None
            }
        for name, d in dicts.items():
            if name in names and d is not None:
                out.setdefault(name, d)
    return out or None


def _mod_slices(table: Table, num_tasks: int) -> list[Table]:
    idx = torch.arange(table.capacity, dtype=torch.int32,
                       device=table.device)
    live = table.row_mask()
    return [
        table.compact(live & ((idx % num_tasks) == i)) for i in range(num_tasks)
    ]
