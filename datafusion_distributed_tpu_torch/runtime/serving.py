"""Multi-query serving tier: async frontend, global cross-query stage
scheduler, admission control.

Port of the reference `runtime/serving.py`. Every admitted query runs
through its own coordinator on the shared in-process workers, all on the
session's device (one card, one CUDA stream: device work of concurrent
queries interleaves in launch order). One straggler-hedge budget is
shared by every query's coordinator, so the in-flight hedge bound holds
for the whole tier.

The coordinator executes ONE query at a time: its stage-DAG scheduler
overlaps stages *within* a query, but nothing arbitrates *between*
queries sharing the worker pool and TableStore. This is the concurrency tier the reference
repo's `cli/` + `console/` serving layers sit on (SURVEY §5), shaped by
the fair-share scheduling argument of *Chasing Similarity* (PAPERS.md):
one heavy analytical query must not starve a stream of cheap ones.

Three cooperating pieces:

`ServingSession`
    The async frontend. ``submit(sql, priority=0) -> QueryHandle`` lets N
    clients run concurrently against one shared cluster + TableStore;
    each admitted query gets its OWN per-query `Coordinator` (isolating
    the cancel-event, retry state, and peer bookkeeping that live on the
    coordinator object) wired to SHARED health/fault/metrics/latency
    stores — a worker quarantined by one query stays routed-around for
    the next, and one MetricsStore holds every query's stage spans under
    its LRU + running-query pin.

`GlobalStageScheduler`
    The per-query stage-DAG scheduler generalized to the whole tier: ONE
    bounded slot pool executes ready stages from ALL admitted queries.
    Each per-query coordinator keeps its own DAG bookkeeping (dependency
    release order is a per-query concern) and submits ready stages here
    through its ``stage_pool`` hook; the policy decides which query's
    stage gets the next free slot. Fair share is STRIDE scheduling keyed
    on per-query accumulated stage wall-clock: every finished stage
    charges its measured wall to its query's pass value, and the pending
    stage belonging to the query with the LOWEST pass runs next — so a
    heavy q21 accumulates pass and cheap q1/q6 stages overtake it at
    every slot boundary. Selection is a pure function of (priority, pass
    values, seeded tie-break, arrival order): given a seed and identical
    completion timings the interleaving replays, and results are
    byte-identical under ANY interleaving by the stage-DAG scheduler's
    own contract. ``fair_share=False`` degrades to FIFO (arrival order),
    the comparison arm of the serving bench.

Admission control
    Keyed on the existing `plan_device_bytes` footprint estimate
    (planner/statistics.py — the same arithmetic the overflow-retry
    budget guard uses): a query whose estimate would push the sum of
    running-query footprints past ``admission_budget_bytes``, or that
    would exceed ``max_concurrent_queries``, QUEUES (FIFO within its
    priority class, higher class first) instead of OOMing the pool.
    Both knobs are live `SET distributed.*` options.

Prepared statements (`SessionContext.prepare`, sql/context.py) ride this
tier: `PreparedStatement.submit(session, params)` binds parameter values
into the template; the literal hoisting gives every binding one
structural fingerprint, and the result cache keys each binding's
parameters beside it.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
import uuid
import zlib
from typing import Optional

from datafusion_distributed_tpu_torch.runtime.errors import TaskCancelledError
from datafusion_distributed_tpu_torch.runtime.metrics import (
    FaultCounters,
    LatencySketch,
    MetricsStore,
)

# -- handle states -----------------------------------------------------------
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"
#: shed under memory pressure (red-line load shedding): resolved with a
#: typed QueryPreemptedError, checkpoint frontier RETAINED so recover()
#: resumes the query when pressure clears
PREEMPTED = "preempted"

#: serving knob defaults, settable per session via `SET distributed.<knob>`
#: (validated at SET time, sql/context.py). The ADMISSION knobs
#: (max_concurrent_queries, admission_budget_bytes) are read LIVE at each
#: admission decision, so a SET mid-serving applies to the next
#: submit/admit; the SCHEDULER knobs (fair_share, serving_stage_slots)
#: bind when the ServingSession is constructed — the slot pool and its
#: policy are fixed for the session's lifetime.
#: admission_budget_bytes 0 = unlimited.
SERVING_DEFAULTS = {
    "max_concurrent_queries": 8,
    "admission_budget_bytes": 16e9,
    "fair_share": True,
    "serving_stage_slots": 0,  # 0 = auto: the live worker count
    #: query checkpoint/resume (runtime/checkpoint.py): admitted queries
    #: snapshot completed-stage outputs onto the workers so a fresh
    #: session's `recover()` resumes them from the staged frontier
    "checkpointing": False,
    #: SLO targets (runtime/telemetry.py SloTracker), read LIVE per
    #: stats()/snapshot: rolling p99 latency target in milliseconds and
    #: error-rate budget over the SLO window. None = no target declared
    #: (the tracker still reports the rolling p99/error rate).
    "slo_p99_ms": None,
    "slo_error_rate": None,
    #: red-line load shedding (with the enforced worker memory budget,
    #: `SET distributed.worker_memory_budget_bytes`): a worker whose
    #: RESIDENT staged bytes stay over budget x this factor — i.e. spill
    #: already failed to relieve it — triggers preemption of the
    #: lowest-priority running query (typed QueryPreemptedError, its
    #: checkpoint frontier retained for recover()). 0 disables shedding.
    "worker_memory_redline": 1.25,
}


class QueryHandle:
    """One submitted query's async surface: ``result()`` blocks for the
    pyarrow table (re-raising the query's error), ``cancel()`` stops a
    queued or running query, ``status()`` reports the lifecycle state.
    Timing fields (`submitted_s`, `admitted_s`, `finished_s`, monotonic)
    expose queue wait and run wall for the serving bench."""

    def __init__(self, session: "ServingSession", sql: str, df,
                 priority: int, est_bytes: int):
        self.query_id = uuid.uuid4().hex  # collision-free under any
        # concurrency: uuid4 per handle, never a shared counter
        self.sql = sql
        self.priority = int(priority)
        self.est_bytes = int(est_bytes)
        self.submitted_s = time.monotonic()
        self.admitted_s: Optional[float] = None
        self.finished_s: Optional[float] = None
        self._session = session
        self._df = df
        self._state = QUEUED
        self._result = None  # raw ops Table
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        # pre-installed into the per-query coordinator (its execute()
        # reuses it), so cancel() reaches in-flight dispatches directly
        self._cancel_event = threading.Event()
        self._coordinator = None
        # checkpoint-store record id (runtime/checkpoint.py) when the
        # session checkpoints; pre-set by recover() for resumed queries
        self._ckpt_record: Optional[str] = None
        # red-line load shedding (the session's memory monitor): set
        # BEFORE the cancel event fires so _drive classifies the
        # resulting TaskCancelledError as preemption, not a user cancel
        self._preempted = False
        # served from the result cache (runtime/result_cache.py): such
        # a query reserved NO admission budget and its ~0-byte "peak"
        # must never pollute the measured-bytes re-cost history
        self._cache_hit = False
        # measured peak staged bytes (TableStore attribution summed
        # across workers), harvested when the query resolves — the
        # measured side of the est_bytes admission loop
        self.peak_staged_bytes = 0
        # the coordinator-internal query id of the MAIN execute (stamped
        # by _drive) — the key into the distributed-tracing store,
        # isolating this handle's trace from every concurrent query's
        self.trace_query_id: Optional[str] = None

    # -- inspection ---------------------------------------------------------
    def status(self, detail: bool = False):
        """Lifecycle state string; ``detail=True`` returns a dict adding
        the admission estimate, the MEASURED per-query peak staged bytes
        (populated once the query resolves; the serving tier re-costs
        later admissions of the same SQL from it), and the preemption
        flag."""
        if not detail:
            return self._state
        return {
            "state": self._state,
            "priority": self.priority,
            "est_bytes": self.est_bytes,
            "peak_staged_bytes": self.peak_staged_bytes,
            "preempted": self._preempted,
            "queue_wait_s": self.queue_wait_s(),
            "wall_s": self.wall_s(),
        }

    def done(self) -> bool:
        return self._done.is_set()

    def queue_wait_s(self) -> Optional[float]:
        if self.admitted_s is None:
            return None
        return self.admitted_s - self.submitted_s

    def wall_s(self) -> Optional[float]:
        """Admission -> completion wall (the latency the serving bench
        reports); None while unresolved or never admitted."""
        if self.finished_s is None or self.admitted_s is None:
            return None
        return self.finished_s - self.admitted_s

    # -- results ------------------------------------------------------------
    def result_table(self, timeout: Optional[float] = None):
        """Raw device Table (qualified column names preserved)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.query_id[:8]} unresolved after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    def result(self, timeout: Optional[float] = None):
        """-> pyarrow Table with user-facing column names (the DataFrame
        .collect() convention)."""
        from datafusion_distributed_tpu_torch.io.parquet import table_to_arrow
        from datafusion_distributed_tpu_torch.sql.context import DataFrame

        return table_to_arrow(
            DataFrame._strip_quals(self.result_table(timeout))
        )

    def cancel(self) -> bool:
        """Request cancellation; -> whether the request landed on an
        unresolved query. A QUEUED query is removed from the admission
        queue immediately; a RUNNING one aborts at its coordinator's next
        dispatch/execute checkpoint (the per-query cancel event)."""
        return self._session._cancel(self)

    # -- distributed tracing -------------------------------------------------
    def query_trace(self):
        """This query's QueryTrace (None unless it ran with
        `SET distributed.tracing` on/sampled)."""
        from datafusion_distributed_tpu_torch.runtime.tracing import (
            DEFAULT_TRACE_STORE,
        )

        if self.trace_query_id is None:
            return None
        return DEFAULT_TRACE_STORE.get(self.trace_query_id)

    def trace(self):
        """Chrome trace-event JSON dict of this query's distributed trace
        (load in Perfetto / chrome://tracing), or None if untraced."""
        from datafusion_distributed_tpu_torch.runtime.tracing import (
            to_chrome_trace,
        )

        t = self.query_trace()
        return to_chrome_trace(t) if t is not None else None

    def trace_profile(self) -> str:
        """Text profile report of this query's trace ('' if untraced)."""
        from datafusion_distributed_tpu_torch.runtime.tracing import (
            render_profile,
        )

        t = self.query_trace()
        return render_profile(t) if t is not None else ""

    # -- session-internal transitions ---------------------------------------
    def _finish(self, state: str, result=None,
                error: Optional[BaseException] = None) -> None:
        self._state = state
        self._result = result
        self._error = error
        self.finished_s = time.monotonic()
        self._coordinator = None  # shed per-query coordinator state
        self._df = None
        self._done.set()


class _StageJob:
    """One pending stage awaiting a global slot."""

    __slots__ = ("qid", "fn", "future", "seq", "cost_hint")

    def __init__(self, qid: str, fn, seq: int, cost_hint: int):
        self.qid = qid
        self.fn = fn
        self.future: cf.Future = cf.Future()
        self.seq = seq
        self.cost_hint = int(cost_hint)


class _QueryPool:
    """Per-query facade installed as `Coordinator.stage_pool`: tags every
    submitted stage with its query id so the global scheduler can apply
    the cross-query policy."""

    __slots__ = ("_sched", "_qid")

    def __init__(self, scheduler: "GlobalStageScheduler", qid: str):
        self._sched = scheduler
        self._qid = qid

    def submit(self, fn, cost_hint: int = 0) -> cf.Future:
        return self._sched.submit(self._qid, fn, cost_hint=cost_hint)


class GlobalStageScheduler:
    """Bounded slot pool executing ready stages from every admitted query
    under a fair-share (stride) or FIFO policy. See the module docstring
    for the policy; mechanically:

    - `submit(qid, fn)` enqueues a job and returns a standard
      `concurrent.futures.Future` (the coordinator's DAG loop `cf.wait`s
      on it unchanged).
    - N worker threads each loop: pick the best pending job, run it,
      charge its measured wall to its query's pass value.
    - pick order: highest priority class first; within a class the lowest
      EFFECTIVE pass — the accumulated pass plus a provisional charge of
      (in-flight stages x the query's mean stage wall). Charging only on
      completion would let a many-stage query flood every slot at pass 0
      before its first charge lands; the provisional term makes holding
      slots itself costly, so a cheap query's stage overtakes at the next
      slot boundary even while the heavy query's stages are still
      running. Ties break on (seeded registration-order hash, smaller
      stage cost hint, arrival seq) — total and deterministic given the
      seed (registration order, not uuids, feeds the hash, so a replayed
      workload replays its schedule).
    - a newly registered query starts at the MINIMUM pass of the live
      queries (the standard stride-scheduling join rule: a newcomer
      neither monopolizes the pool nor inherits an unpayable debt).
    """

    def __init__(self, slots: int, fair_share: bool = True, seed: int = 0):
        self.slots = max(int(slots), 1)
        self.fair_share = bool(fair_share)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list[_StageJob] = []  # guarded-by: _lock
        self._pass: dict[str, float] = {}  # guarded-by: _lock; per-query: swept-by unregister_query
        self._prio: dict[str, int] = {}  # guarded-by: _lock; per-query: swept-by unregister_query
        self._weight: dict[str, float] = {}  # guarded-by: _lock; per-query: swept-by unregister_query
        self._qseq: dict[str, int] = {}  # guarded-by: _lock; per-query: swept-by unregister_query
        self._qseq_next = 0  # guarded-by: _lock
        #: per-query in-flight stage count + mean stage wall (EMA): the
        #: provisional-charge inputs
        self._running_stages: dict[str, int] = {}  # guarded-by: _lock; per-query: swept-by unregister_query
        self._mean_wall: dict[str, float] = {}  # guarded-by: _lock; per-query: swept-by unregister_query
        #: qids registered implicitly by submit() (direct coordinator
        #: use, no ServingSession driving unregister): reaped when their
        #: last job drains, so a long-lived scheduler does not grow
        #: per-query state for every ad-hoc query it ever served
        self._adhoc: set = set()  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        #: pick order, for tests/introspection: (qid, job seq) per slot
        #: grant, appended under the lock
        self.schedule_log: list[tuple] = []  # guarded-by: _lock
        self._in_flight = 0  # guarded-by: _lock
        self.peak_in_flight = 0  # guarded-by: _lock
        self._threads = [
            threading.Thread(target=self._loop, daemon=True,
                             name=f"dftpu-serve-{i}")
            for i in range(self.slots)
        ]
        for t in self._threads:
            t.start()

    # -- query registration -------------------------------------------------
    def register_query(self, qid: str, priority: int = 0,
                       weight: float = 1.0) -> None:
        with self._lock:
            live = [
                self._pass[q] for q in self._pass
                if self._prio.get(q) == priority
            ]
            self._pass.setdefault(qid, min(live) if live else 0.0)
            self._prio[qid] = int(priority)
            self._weight[qid] = max(float(weight), 1e-9)
            if qid not in self._qseq:
                self._qseq[qid] = self._qseq_next
                self._qseq_next += 1

    def unregister_query(self, qid: str) -> None:
        with self._lock:
            self._unregister_locked(qid)

    def _unregister_locked(self, qid: str) -> None:
        self._pass.pop(qid, None)
        self._prio.pop(qid, None)
        self._weight.pop(qid, None)
        self._qseq.pop(qid, None)
        self._running_stages.pop(qid, None)
        self._mean_wall.pop(qid, None)
        self._adhoc.discard(qid)

    # -- job surface --------------------------------------------------------
    def submit(self, qid: str, fn, cost_hint: int = 0) -> cf.Future:
        with self._cv:
            if self._closed:
                raise RuntimeError("serving scheduler is closed")
            if qid not in self._pass:
                # unregistered submitter (direct coordinator use): admit
                # ad hoc at the current minimum pass
                live = list(self._pass.values())
                self._pass[qid] = min(live) if live else 0.0
                self._prio.setdefault(qid, 0)
                self._weight.setdefault(qid, 1.0)
                self._adhoc.add(qid)
                if qid not in self._qseq:
                    self._qseq[qid] = self._qseq_next
                    self._qseq_next += 1
            job = _StageJob(qid, fn, self._seq, cost_hint)
            self._seq += 1
            self._pending.append(job)
            self._cv.notify()
            return job.future

    def _tie(self, qid: str) -> int:
        # seeded deterministic tie-break between equal-pass queries:
        # hashes the REGISTRATION order, not the uuid, so a replayed
        # workload (same arrival order, same seed) replays its schedule
        return zlib.crc32(
            f"{self.seed}:{self._qseq.get(qid, -1)}".encode()
        )

    def _effective_pass(self, qid: str) -> float:
        """Accumulated pass plus the provisional charge for stages this
        query is running RIGHT NOW (in-flight count x its mean stage
        wall): holding slots costs pass immediately, not at completion."""
        base = self._pass.get(qid, 0.0)
        running = self._running_stages.get(qid, 0)
        if not running:
            return base
        est = self._mean_wall.get(qid, 0.0) or 1e-3
        return base + running * est / self._weight.get(qid, 1.0)

    def _pick_locked(self) -> Optional[_StageJob]:
        if not self._pending:
            return None
        if self.fair_share:
            best = min(
                self._pending,
                key=lambda j: (
                    -self._prio.get(j.qid, 0),
                    self._effective_pass(j.qid),
                    self._tie(j.qid),
                    j.cost_hint,
                    j.seq,
                ),
            )
        else:  # FIFO: priority classes still order, arrival decides
            best = min(
                self._pending,
                key=lambda j: (-self._prio.get(j.qid, 0), j.seq),
            )
        self._pending.remove(best)
        return best

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                job = self._pick_locked()
                if job is None:
                    continue
                if not job.future.set_running_or_notify_cancel():
                    continue  # cancelled while pending
                self.schedule_log.append((job.qid, job.seq))
                self._in_flight += 1
                self.peak_in_flight = max(
                    self.peak_in_flight, self._in_flight
                )
                self._running_stages[job.qid] = (
                    self._running_stages.get(job.qid, 0) + 1
                )
            t0 = time.monotonic()
            try:
                out = job.fn()
            except BaseException as e:
                job.future.set_exception(e)
            else:
                job.future.set_result(out)
            wall = time.monotonic() - t0
            with self._lock:
                self._in_flight -= 1
                left = self._running_stages.get(job.qid, 1) - 1
                if left > 0:
                    self._running_stages[job.qid] = left
                else:
                    self._running_stages.pop(job.qid, None)
                if job.qid in self._pass:
                    self._pass[job.qid] += wall / self._weight.get(
                        job.qid, 1.0
                    )
                    prev = self._mean_wall.get(job.qid)
                    self._mean_wall[job.qid] = (
                        wall if prev is None else 0.5 * prev + 0.5 * wall
                    )
                if (
                    job.qid in self._adhoc
                    and job.qid not in self._running_stages
                    and not any(j.qid == job.qid for j in self._pending)
                ):
                    # last job of an implicitly-registered query drained:
                    # reap its state (explicit registrations are owned by
                    # their ServingSession's unregister)
                    self._unregister_locked(job.qid)

    # -- lifecycle / introspection ------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "slots": self.slots,
                "policy": "fair_share" if self.fair_share else "fifo",
                "pending_stages": len(self._pending),
                "in_flight_stages": self._in_flight,
                "peak_in_flight": self.peak_in_flight,
                "query_pass": dict(self._pass),
            }

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)


def run_closed_loop(session: "ServingSession", client_workloads,
                    classify=None, timeout: float = 600.0) -> dict:
    """Drive N closed-loop clients against ``session``: client ``i``
    submits each SQL in ``client_workloads[i]`` in order, waiting for
    each result before the next (the serving bench harness, shared by
    `bench.py --serving` and `benchmarks/micro_bench.py`).

    ``classify(client_index) -> label`` buckets the per-query walls
    (submit -> resolve, queue wait included — the client-visible
    latency); default: one "all" bucket. A failing client records its
    error and stops; partial walls stay reportable.

    -> {"wall_s", "queries", "walls": {label: [seconds...]},
        "errors": [str...]}
    """
    classify = classify or (lambda ci: "all")
    walls: dict = {}
    errors: list = []
    lock = threading.Lock()
    t0 = time.monotonic()

    def client(ci: int) -> None:
        label = classify(ci)
        try:
            for sql in client_workloads[ci]:
                h = session.submit(sql)
                h.result(timeout=timeout)
                with lock:
                    walls.setdefault(label, []).append(
                        h.finished_s - h.submitted_s
                    )
        except BaseException as e:  # keep partial results reportable
            with lock:
                errors.append(f"client{ci}: {type(e).__name__}: {e}")

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True)
        for i in range(len(client_workloads))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {
        "wall_s": time.monotonic() - t0,
        "queries": sum(len(v) for v in walls.values()),
        "walls": walls,
        "errors": errors,
    }


def percentile_ms(walls, q: float):
    """q-th percentile of a wall-seconds list, in ms (None if empty)."""
    if not walls:
        return None
    v = sorted(walls)
    return round(v[min(int(q * len(v)), len(v) - 1)] * 1e3, 1)


class ServingSession:
    """N concurrent clients over one SessionContext + one worker cluster.

    ::

        ctx = SessionContext(); register tables...
        with ServingSession(ctx, num_workers=4) as srv:
            h1 = srv.submit("select ...")
            h2 = srv.submit("select ...", priority=1)
            t1, t2 = h1.result(), h2.result()

    ``cluster`` may be any resolver+channels pair (InMemoryCluster,
    DynamicCluster, a chaos-wrapped cluster); by default an
    InMemoryCluster of ``num_workers`` spins up. Admission / policy knobs
    come from `SET distributed.*` (SERVING_DEFAULTS) with constructor
    overrides; ``seed`` makes scheduler tie-breaks reproducible.
    """

    def __init__(self, ctx, cluster=None, num_workers: int = 4,
                 num_tasks: int = 4,
                 max_concurrent_queries: Optional[int] = None,
                 admission_budget_bytes: Optional[float] = None,
                 fair_share: Optional[bool] = None,
                 stage_slots: Optional[int] = None,
                 checkpoints=None,
                 checkpointing: Optional[bool] = None,
                 seed: int = 0):
        from datafusion_distributed_tpu_torch.runtime.coordinator import (
            InMemoryCluster,
        )
        from datafusion_distributed_tpu_torch.runtime.health import (
            HealthPolicy,
            HealthTracker,
        )
        from datafusion_distributed_tpu_torch.runtime.metrics import (
            HedgeBudget,
        )

        self.ctx = ctx
        self.cluster = cluster if cluster is not None else InMemoryCluster(
            num_workers
        )
        self.num_tasks = int(num_tasks)
        self._overrides = {
            "max_concurrent_queries": max_concurrent_queries,
            "admission_budget_bytes": admission_budget_bytes,
            "fair_share": fair_share,
            "serving_stage_slots": stage_slots,
            "checkpointing": checkpointing,
        }
        # query checkpoint/resume (runtime/checkpoint.py): a passed
        # ``checkpoints`` store enables it implicitly — pass the SAME
        # store to a fresh session and `recover()` resumes whatever this
        # one leaves unresolved (the store outlives the session on
        # purpose: that IS the coordinator-loss recovery path)
        if checkpoints is None and bool(self._opt_over("checkpointing")):
            from datafusion_distributed_tpu_torch.runtime.checkpoint import (
                CheckpointStore,
            )

            try:
                ckpt_cap = int(float(
                    self._opt("checkpoint_budget_bytes", 0) or 0
                ))
            except (TypeError, ValueError):
                ckpt_cap = 0
            checkpoints = CheckpointStore(budget_bytes=ckpt_cap)
        self.checkpoints = checkpoints
        # one cluster-wide speculative-attempt budget shared by every
        # per-query coordinator (the hedge stampede bound)
        self.hedge_budget = HedgeBudget()
        # shared across every per-query coordinator: quarantine/fault/
        # latency/span state outlives any single query
        self.health = HealthTracker(HealthPolicy(
            failure_threshold=int(self._opt("quarantine_threshold", 3)),
            quarantine_seconds=float(self._opt("quarantine_seconds", 30.0)),
        ))
        self.faults = FaultCounters()
        self.stage_metrics = MetricsStore()
        self.task_latency = LatencySketch()
        #: per-QUERY wall latency (admission -> completion): the p50/p99
        #: surface of the serving bench
        self.query_latency = LatencySketch()
        slots = int(self._opt_over("serving_stage_slots"))
        if slots <= 0:
            try:
                slots = max(len(self.cluster.get_urls()), 1)
            except Exception:
                slots = 4
        self.scheduler = GlobalStageScheduler(
            slots,
            fair_share=bool(self._opt_over("fair_share")),
            seed=seed,
        )
        self._lock = threading.Lock()
        # arrival order preserved
        self._queued: list[QueryHandle] = []  # guarded-by: _lock
        self._running: dict[str, QueryHandle] = {}  # guarded-by: _lock; per-query: swept-by _drive
        self._query_threads: dict[str, threading.Thread] = {}  # guarded-by: _lock; per-query: swept-by _drive
        self._admitted_total = 0  # guarded-by: _lock
        self._completed = {DONE: 0, FAILED: 0, CANCELLED: 0,
                           PREEMPTED: 0}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # estimate-vs-reality admission loop: SQL text -> last MEASURED
        # peak staged bytes (TableStore attribution); queued admission
        # decisions re-cost from it, replacing the static
        # plan_device_bytes estimate once a real run measured the query
        self._measured_bytes: dict = {}  # guarded-by: _lock
        # cluster-wide telemetry (runtime/telemetry.py): ONE typed
        # registry is the exposition sink for every counter this tier
        # already keeps — faults, hedge budget, breaker state, latency
        # sketches, admission/queue state, SLO attainment, event-log
        # tallies — sampled via collector adapters at snapshot time.
        # `ObservabilityService(serving=...).get_metrics()` merges it
        # with the per-worker `get_metrics` snapshots.
        from datafusion_distributed_tpu_torch.runtime.eventlog import (
            default_event_log,
        )
        from datafusion_distributed_tpu_torch.runtime.telemetry import (
            MetricRegistry,
            SloTracker,
            TelemetryHistory,
        )

        self.slo = SloTracker()
        self.telemetry = MetricRegistry()
        for collector in (
            self.faults.telemetry_families,
            self.hedge_budget.telemetry_families,
            self.health.telemetry_families,
            self._serving_families,
            self._slo_families,
            self._result_cache_families,
            default_event_log().telemetry_families,
            lambda: self.query_latency.telemetry_families(
                "dftpu_query_latency_seconds",
                "Per-query admission->completion wall (seconds).",
            ),
            lambda: self.task_latency.telemetry_families(
                "dftpu_task_latency_seconds",
                "Per-task execute wall (seconds).",
            ),
        ):
            self.telemetry.register_collector(collector)
        # bounded time-series ring over the registry: `_drive` samples
        # it as queries resolve (the resolution gate inside the history
        # keeps the grid uniform)
        self.history = TelemetryHistory(
            capacity=int(self._opt("telemetry_history_points", 240)),
            resolution_s=float(self._opt("telemetry_resolution_s", 1.0)),
        )
        # red-line memory monitor (load shedding): a daemon sampler over
        # the in-process workers' TableStores. Cheap when no store has a
        # budget set (a handful of int reads per tick); preempts the
        # lowest-priority running query when residency stays over
        # budget x `worker_memory_redline` AFTER spilling already ran.
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._memory_monitor, daemon=True,
            name="dftpu-mem-monitor",
        )
        self._monitor.start()

    # -- telemetry adapters (runtime/telemetry.py) --------------------------
    def _serving_families(self) -> list:
        """Admission/queue/completion state as typed families."""
        from datafusion_distributed_tpu_torch.runtime.telemetry import family

        with self._lock:
            active = len(self._running)
            queued = len(self._queued)
            admitted = self._admitted_total
            completed = dict(self._completed)
            in_use = sum(r.est_bytes for r in self._running.values())
            queued_bytes = sum(q.est_bytes for q in self._queued)
        return [
            family("dftpu_serving_active_queries", "gauge",
                   "Admitted queries currently executing.",
                   [({}, active)]),
            family("dftpu_serving_queued_queries", "gauge",
                   "Queries waiting for admission.", [({}, queued)]),
            family("dftpu_serving_admitted", "counter",
                   "Queries ever admitted.", [({}, admitted)]),
            family("dftpu_serving_queries", "counter",
                   "Resolved queries by terminal state.",
                   [({"state": k}, v)
                    for k, v in sorted(completed.items())]),
            family("dftpu_serving_in_use_bytes", "gauge",
                   "Admission-estimate bytes of running queries.",
                   [({}, in_use)]),
            family("dftpu_serving_queued_bytes", "gauge",
                   "Admission-estimate bytes of queued queries.",
                   [({}, queued_bytes)]),
            family("dftpu_queries_preempted", "counter",
                   "Queries preempted by red-line load shedding "
                   "(checkpoint frontier retained for recover()).",
                   [({}, completed.get(PREEMPTED, 0))]),
        ]

    def _result_cache_families(self) -> list:
        """`dftpu_result_cache_*` families when the session context has
        ever created a cache (knob-on), eagerly zero-valued from its
        first snapshot; empty while the tier is off."""
        rc = getattr(self.ctx, "_result_cache", None)
        if rc is None:
            return []
        try:
            return rc.telemetry_families()
        except Exception:
            return []

    def _slo_families(self) -> list:
        return self.slo.telemetry_families(
            p99_target_ms=self._opt("slo_p99_ms", None),
            error_rate_target=self._opt("slo_error_rate", None),
        )

    def slo_snapshot(self) -> dict:
        """Rolling SLO attainment against the live `SET distributed.
        slo_p99_ms` / `slo_error_rate` targets (runtime/telemetry.py
        SloTracker) — also folded into `stats()["slo"]`."""
        return self.slo.snapshot(
            p99_target_ms=self._opt("slo_p99_ms", None),
            error_rate_target=self._opt("slo_error_rate", None),
        )

    # -- option plumbing ----------------------------------------------------
    def _opt(self, name: str, default):
        try:
            return self.ctx.config.distributed_options.get(name, default)
        except Exception:
            return default

    def _opt_over(self, name: str):
        """Constructor override > live `SET distributed.*` > default."""
        v = self._overrides.get(name)
        if v is not None:
            return v
        return self._opt(name, SERVING_DEFAULTS[name])

    def _max_concurrent(self) -> int:
        try:
            return max(int(self._opt_over("max_concurrent_queries")), 1)
        except (TypeError, ValueError):
            return int(SERVING_DEFAULTS["max_concurrent_queries"])

    def _budget_bytes(self) -> float:
        try:
            return float(self._opt_over("admission_budget_bytes"))
        except (TypeError, ValueError):
            return float(SERVING_DEFAULTS["admission_budget_bytes"])

    # -- submission ---------------------------------------------------------
    def submit(self, sql: str, priority: int = 0,
               _resume: Optional[str] = None) -> QueryHandle:
        """Parse, plan, and estimate the query NOW (client thread; the
        session plan cache makes repeats cheap), then admit or queue it.
        ``priority``: higher class admits and schedules first; FIFO
        within a class. ``_resume``: internal (recover()) — an existing
        checkpoint-store record id this submission resumes instead of
        registering a fresh one."""
        from datafusion_distributed_tpu_torch.planner.statistics import (
            plan_device_bytes,
        )

        if self._closed:
            raise RuntimeError("serving session is closed")
        df = self.ctx.sql(sql)
        if df is None or not hasattr(df, "collect_coordinated_table"):
            raise ValueError(
                "serving submit requires a SELECT statement "
                "(DDL/SET-only scripts have no result to serve)"
            )
        # result-cache fast path (runtime/result_cache.py): consult the
        # whole-result cache BEFORE costing — a hit resolves on the
        # client thread with est_bytes=0, reserving NO admission budget
        # and no queue slot for execution it will skip (the bursty-
        # serving fast path; resumed queries always re-execute)
        if _resume is None:
            hit = self._cache_fast_path(sql, df, priority)
            if hit is not None:
                return hit
        # the admission footprint: the single-node physical plan's
        # device-buffer bound — the same plan_device_bytes estimate the
        # overflow-retry budget guard keys on (sql/context.py). Planning
        # here is cached by the session plan cache, so a repeated
        # template estimates for free.
        try:
            est = int(plan_device_bytes(df.physical_plan()))
        except Exception:
            est = 0  # unplannable estimate -> admit on count alone
        handle = QueryHandle(self, sql, df, priority, est)
        handle._ckpt_record = _resume
        with self._lock:
            if self._closed:
                # re-checked under the lock: a close() racing the
                # planning above must not strand a handle on a queue
                # nobody will ever admit from
                raise RuntimeError("serving session is closed")
            self._queued.append(handle)
            self._admit_locked()
        return handle

    def _result_cache(self):
        """The session context's ResultCache (None when the knob is
        off, or when the context predates the surface)."""
        try:
            return self.ctx.result_cache()
        except AttributeError:
            return None

    def _cache_fast_path(self, sql: str, df, priority: int):
        """A resolved QueryHandle served by reference from the
        whole-result cache, or None (cache off / miss / unkeyable).
        The handle never touches admission: it is admitted+done in one
        step, charged zero budget, and excluded from re-cost history."""
        rc = self._result_cache()
        if rc is None:
            return None
        try:
            key = df._result_cache_key(self.num_tasks)
        except Exception:
            key = None
        if key is None:
            return None
        cached = rc.lookup(key)
        if cached is None:
            return None
        h = QueryHandle(self, sql, df, priority, 0)
        h._cache_hit = True
        h.admitted_s = time.monotonic()
        with self._lock:
            if self._closed:
                raise RuntimeError("serving session is closed")
            self._admitted_total += 1
            self._completed[DONE] = self._completed.get(DONE, 0) + 1
        h._finish(DONE, result=cached)
        wall = h.wall_s()
        if wall is not None:
            self.query_latency.record(wall)
            self.slo.record(wall, ok=True)
        from datafusion_distributed_tpu_torch.runtime.eventlog import log_event

        log_event("query_admitted", serving_query_id=h.query_id,
                  priority=h.priority, est_bytes=0, cache_hit=True,
                  queue_wait_s=0.0)
        log_event("query_done", serving_query_id=h.query_id,
                  cache_hit=True, priority=h.priority,
                  wall_s=round(wall, 6) if wall is not None else None)
        self.history.sample(self.telemetry)
        return h

    # -- admission control --------------------------------------------------
    def _recost_locked(self, h: QueryHandle) -> int:
        """Re-cost a queued admission decision from MEASURED reality:
        once a prior run of the same SQL measured its peak staged bytes
        (TableStore attribution), that replaces the static
        plan_device_bytes estimate — mis-estimated queries stop
        over/under-admitting on their second appearance."""
        measured = self._measured_bytes.get(h.sql)
        if measured is not None and measured > 0 and (
            measured != h.est_bytes
        ):
            h.est_bytes = int(measured)
        return h.est_bytes

    def _admissible_locked(self, h: QueryHandle) -> bool:
        if len(self._running) >= self._max_concurrent():
            return False
        if self._running and self._redline_hot():
            # a worker is over the hard red-line with queries running:
            # queue instead of piling more demand onto a pressured pool
            # (the monitor sheds if pressure persists)
            return False
        budget = self._budget_bytes()
        if budget and budget > 0:
            est = self._recost_locked(h)
            in_use = sum(r.est_bytes for r in self._running.values())
            if in_use + est > budget and self._running:
                # over budget with peers running -> wait; an EMPTY pool
                # always admits the head (a query bigger than the whole
                # budget must not starve forever)
                return False
        return True

    def _admit_locked(self) -> None:
        """Admit queued queries while capacity allows: highest priority
        class first, FIFO within the class, and STRICT head-of-class
        order — a large query at the head blocks its class until it fits
        (documented admission semantics: no small-query bypass, so
        arrival order within a class is also completion-start order).
        Runs even after close(): a closed session stops ACCEPTING
        queries, but what was already queued still admits and resolves
        (close(cancel_pending=True) cancels the backlog instead)."""
        while self._queued:
            # max() returns the FIRST maximal element, so this is exactly
            # head-of-highest-class with FIFO preserved within the class
            head = max(self._queued, key=lambda h: h.priority)
            if not self._admissible_locked(head):
                return
            self._queued.remove(head)
            self._start_locked(head)

    def _start_locked(self, h: QueryHandle) -> None:
        h._state = RUNNING
        h.admitted_s = time.monotonic()
        if self.checkpoints is not None and h._ckpt_record is None:
            # register the admitted query in the checkpoint store NOW:
            # from this point a coordinator/session loss leaves a
            # recoverable record behind
            h._ckpt_record = self.checkpoints.admit(h.sql, h.priority)
        self._admitted_total += 1
        self._running[h.query_id] = h
        self.scheduler.register_query(h.query_id, priority=h.priority)
        t = threading.Thread(
            target=self._drive, args=(h,), daemon=True,
            name=f"dftpu-query-{h.query_id[:8]}",
        )
        self._query_threads[h.query_id] = t
        t.start()

    # -- per-query thread ---------------------------------------------------
    def _make_coordinator(self, h: QueryHandle):
        """Fresh per-query coordinator over the SHARED cluster: isolates
        every per-query attribute Coordinator.execute hangs on `self`
        (cancel event, peer-ship registry, span caches, retry state)
        while sharing the cross-query stores."""
        from datafusion_distributed_tpu_torch.runtime.coordinator import (
            Coordinator,
        )

        sweeps = getattr(getattr(self.cluster, "plan", None),
                         "sweep_query", None)

        def on_query_end(query_id: str) -> None:
            # per-execute sweep (subquery executes included): chaos call
            # counters and the per-task/stream metric dicts for this
            # internal query id are shed the moment it resolves
            if callable(sweeps):
                sweeps(query_id)
            coord.sweep_query(query_id)

        checkpointer = None
        if self.checkpoints is not None and h._ckpt_record is not None:
            from datafusion_distributed_tpu_torch.runtime.checkpoint import (
                QueryCheckpointer,
            )

            checkpointer = QueryCheckpointer(
                self.checkpoints, h._ckpt_record,
                resolver=self.cluster, channels=self.cluster,
            )
        coord = Coordinator(
            resolver=self.cluster, channels=self.cluster,
            # GIL-atomic snapshot: a live `SET distributed.*` from a
            # client thread must not explode this copy mid-iteration
            config_options=self.ctx.config.distributed_snapshot(),
            passthrough_headers=dict(self.ctx.config.passthrough_headers),
            health=self.health,
            faults=self.faults,
            stage_metrics=self.stage_metrics,
            latency=self.task_latency,
            stage_pool=_QueryPool(self.scheduler, h.query_id),
            cancel_event=h._cancel_event,
            on_query_end=on_query_end,
            hedges=self.hedge_budget,
            checkpoints=checkpointer,
            result_cache=self._result_cache(),
        )
        return coord

    def _drive(self, h: QueryHandle) -> None:
        from datafusion_distributed_tpu_torch.runtime.eventlog import log_event

        wait = h.queue_wait_s()
        log_event("query_admitted", serving_query_id=h.query_id,
                  priority=h.priority, est_bytes=h.est_bytes,
                  queue_wait_s=round(wait, 6) if wait is not None
                  else None)
        coord = None
        try:
            if h._cancel_event.is_set():
                raise TaskCancelledError("cancelled before execution")
            coord = h._coordinator = self._make_coordinator(h)
            out = h._df.collect_coordinated_table(
                coordinator=coord, num_tasks=self.num_tasks
            )
            if getattr(coord, "last_query_id", None) is None:
                # the coordinator never executed: the result cache
                # served this query while it sat in the queue (or a
                # concurrent identical submission's single-flight fill)
                h._cache_hit = True
            h._finish(DONE, result=out)
        except TaskCancelledError as e:
            if h._preempted:
                # red-line load shedding rode the cancel path: surface
                # the TYPED error and keep the checkpoint frontier —
                # recover() resumes this query when pressure clears
                from datafusion_distributed_tpu_torch.runtime.errors import (
                    QueryPreemptedError,
                )

                h._finish(PREEMPTED, error=QueryPreemptedError(
                    f"query {h.query_id[:8]} preempted by memory "
                    "red-line load shedding; its checkpoint frontier "
                    "is retained — ServingSession.recover() resumes it"
                ))
            else:
                h._finish(CANCELLED, error=e)
        except BaseException as e:
            h._finish(FAILED, error=e)
        finally:
            # measured side of the admission loop: the coordinator's
            # sweep harvested per-store staging attribution into
            # staged_peak_bytes; bind it to the handle and (for resolved
            # runs) re-cost future admissions of this SQL from it
            peak = int(getattr(coord, "staged_peak_bytes", 0) or 0)
            h.peak_staged_bytes = peak
            # cache-served completions never update the measured-bytes
            # history: their ~0-byte "peak" would poison the re-cost
            # loop into under-admitting the next COLD run of this SQL
            if h._state == DONE and peak > 0 and not h._cache_hit:
                with self._lock:
                    self._measured_bytes[h.sql] = peak
                    while len(self._measured_bytes) > 256:
                        self._measured_bytes.pop(
                            next(iter(self._measured_bytes))
                        )
            if self.checkpoints is not None and h._ckpt_record is not None:
                if h._state in (DONE, CANCELLED):
                    # resolved: the record and its staged slices are
                    # dead weight (and would leak) — release them.
                    # FAILED stays recoverable — and PREEMPTED stays
                    # recoverable ON PURPOSE: the retained completed-
                    # stage frontier is what recover() resumes from
                    # after load shedding.
                    self.checkpoints.release(h._ckpt_record, self.cluster)
            self._stamp_trace(h, coord)
            self.scheduler.unregister_query(h.query_id)
            wall = h.wall_s()
            if wall is not None and h._state == DONE:
                self.query_latency.record(wall)
            # SLO window (runtime/telemetry.py): DONE counts against the
            # latency target, FAILED burns error budget; CANCELLED is
            # operator-initiated and charges neither
            if h._state == DONE:
                self.slo.record(wall, ok=True)
            elif h._state == FAILED:
                self.slo.record(wall, ok=False)
            log_event(
                f"query_{h._state}", serving_query_id=h.query_id,
                query_id=getattr(coord, "last_query_id", None),
                wall_s=round(wall, 6) if wall is not None else None,
                priority=h.priority, cache_hit=h._cache_hit,
            )
            with self._lock:
                self._running.pop(h.query_id, None)
                self._query_threads.pop(h.query_id, None)
                self._completed[h._state] = (
                    self._completed.get(h._state, 0) + 1
                )
                self._admit_locked()
            # time-series point per resolved query (the history's own
            # resolution gate bounds the grid; a quiet tier simply has
            # no new points, matching a scrape-on-change model)
            lat = self.query_latency.summary()
            self.history.sample(self.telemetry, extra={
                "p99_ms": (lat["p99"] * 1e3
                           if lat.get("p99") is not None else None),
            })

    def _stamp_trace(self, h: QueryHandle, coord) -> None:
        """Bind the handle to its MAIN execute's trace (the last query id
        the coordinator ran — subquery executes resolved earlier) and
        annotate the trace root with the serving tier's admission
        queue-wait, so the profile shows the full submit->result story."""
        qid = getattr(coord, "last_query_id", None)
        if qid is None:
            return
        h.trace_query_id = qid
        wait = h.queue_wait_s()
        if wait is not None:
            from datafusion_distributed_tpu_torch.runtime.tracing import (
                DEFAULT_TRACE_STORE,
            )

            DEFAULT_TRACE_STORE.annotate(
                qid, admission_wait_s=round(wait, 6),
                serving_query_id=h.query_id, priority=h.priority,
            )

    # -- query recovery (runtime/checkpoint.py) ------------------------------
    def recover(self, store=None, cluster=None) -> list:
        """Resume every admitted-but-unresolved query recorded in
        ``store`` (default: this session's checkpoint store) — the
        fresh-coordinator half of checkpoint/resume. Each record's SQL
        resubmits through normal admission at its original priority; the
        new query's coordinator restores completed stages from the
        checkpointed frontier (fingerprint-validated against the
        re-planned query) and re-executes only what is missing or
        invalid, falling back to full re-execution when nothing
        restores. ``cluster`` is accepted for call-site symmetry with
        the docs but must be the session's own cluster (the staged
        slices live on its workers). -> the new QueryHandles, in record
        order."""
        if store is not None and store is not self.checkpoints:
            own = self.checkpoints
            if own is not None and own.stats()["queries"]:
                # the session's own store already tracks queries: silently
                # switching would orphan their records
                raise ValueError(
                    "recover(store=...) on a session whose own checkpoint "
                    "store already tracks queries"
                )
            # adopt (an auto-created empty store — e.g. from
            # `SET distributed.checkpointing` — is simply replaced):
            # resumed queries re-save into the recovered store
            self.checkpoints = store
        store = self.checkpoints
        if store is None:
            return []
        if cluster is not None and cluster is not self.cluster:
            raise ValueError(
                "recover() must run against the cluster holding the "
                "checkpointed slices (the session's own cluster)"
            )
        handles = []
        for rec in store.incomplete():
            store.mark_resumed(rec.record_id)
            self.faults.bump("queries_recovered")
            handles.append(
                self.submit(rec.sql, priority=rec.priority,
                            _resume=rec.record_id)
            )
        return handles

    # -- memory red-line monitor / load shedding -----------------------------
    def _redline_factor(self) -> float:
        try:
            return float(self._opt_over("worker_memory_redline"))
        except (TypeError, ValueError):
            return float(SERVING_DEFAULTS["worker_memory_redline"])

    def _worker_stores(self) -> list:
        """The in-process workers' TableStores (wire workers report via
        their own budget enforcement; the monitor cannot see them)."""
        stores = []
        try:
            urls = self.cluster.get_urls()
        except Exception:
            return stores
        for url in urls:
            try:
                s = getattr(self.cluster.get_worker(url), "table_store",
                            None)
            except Exception:
                continue
            if s is not None and hasattr(s, "under_pressure"):
                stores.append((url, s))
        return stores

    def _redline_hot(self) -> bool:
        """Any worker's RESIDENT staged bytes over budget x red-line
        (spill already failed to relieve it)? Plain int reads only —
        this runs on the 50 ms monitor tick and under the admission
        lock, so it must never walk a store's full stats()."""
        factor = self._redline_factor()
        if factor <= 0:
            return False
        for _url, s in self._worker_stores():
            b = getattr(s, "budget_bytes", 0)
            if b and s.nbytes() > b * factor:
                return True
        return False

    def _memory_monitor(self) -> None:
        """Daemon sampler: while any worker store sits over the hard
        red-line, shed load — preempt the LOWEST-PRIORITY running query
        (largest measured staged bytes within the class) through the
        existing cancel path, typed as QueryPreemptedError with its
        checkpoint frontier retained. One preemption in flight at a
        time: the next only fires if pressure persists after the victim
        resolved (natural hysteresis)."""
        while not self._monitor_stop.wait(0.05):
            try:
                self._check_redline()
            except Exception:
                pass  # the monitor must never die mid-session

    @staticmethod
    def _current_staged(h: QueryHandle, stores) -> int:
        """Bytes currently attributed to ``h``'s main execute across the
        worker stores (the over-budget tie-break among equal-priority
        shed candidates)."""
        qid = getattr(h._coordinator, "last_query_id", None)
        if not qid:
            return 0
        total = 0
        for _url, s in stores:
            try:
                total += s.query_current_nbytes(qid)
            except Exception:
                pass
        return total

    def _check_redline(self) -> None:
        factor = self._redline_factor()
        if factor <= 0:
            return
        hot = []
        stores = self._worker_stores()
        for url, s in stores:
            # budget_bytes is a plain attribute and nbytes() a two-line
            # locked int read: the 20 Hz tick must not contend the
            # store lock with a stats() walk over every staged entry
            b = getattr(s, "budget_bytes", 0)
            if b:
                n = s.nbytes()
                if n > b * factor:
                    hot.append((url, n, b))
        if not hot:
            return
        with self._lock:
            running = list(self._running.values())
            if any(h._preempted for h in running):
                return  # a shed is already unwinding: wait for it
            candidates = [h for h in running if not h.done()]
            if not candidates:
                return
            victim = min(candidates, key=lambda h: (
                h.priority,
                -self._current_staged(h, stores),
                -(h.admitted_s or 0.0),
            ))
            victim._preempted = True
        self.faults.bump("queries_preempted")
        from datafusion_distributed_tpu_torch.runtime.eventlog import log_event

        log_event(
            "query_preempt_requested",
            serving_query_id=victim.query_id, priority=victim.priority,
            hot_workers=[u for u, _n, _b in hot],
            resident_bytes=max(n for _u, n, _b in hot),
            budget_bytes=max(b for _u, _n, b in hot),
        )
        # the existing cancel path does the unwinding (slice release,
        # coordinator teardown); _drive types the result as PREEMPTED
        victim._cancel_event.set()

    # -- cancellation -------------------------------------------------------
    def _cancel(self, h: QueryHandle) -> bool:
        with self._lock:
            if h in self._queued:
                self._queued.remove(h)
                h._finish(CANCELLED, error=TaskCancelledError(
                    "cancelled while queued"
                ))
                self._completed[CANCELLED] += 1
                self._admit_locked()
                queued_cancel = True
            else:
                queued_cancel = False
        if queued_cancel:
            if self.checkpoints is not None and h._ckpt_record is not None:
                # a RESUMED query cancelled while still queued: its
                # record (and staged frontier) is explicitly abandoned
                self.checkpoints.release(h._ckpt_record, self.cluster)
            return True
        if h.done():
            return False
        # running (or racing admission): the pre-installed cancel event
        # reaches the coordinator's dispatch/execute checkpoints
        h._cancel_event.set()
        return True

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        """The observability surface: active/queued/admitted
        counts, footprint accounting, scheduler state, latency summary."""
        with self._lock:
            running = list(self._running.values())
            queued = list(self._queued)
            out = {
                "active": len(running),
                "queued": len(queued),
                "admitted_total": self._admitted_total,
                "completed": dict(self._completed),
                "in_use_bytes": sum(r.est_bytes for r in running),
                "queued_bytes": sum(q.est_bytes for q in queued),
                "budget_bytes": self._budget_bytes(),
                "max_concurrent_queries": self._max_concurrent(),
            }
        out["scheduler"] = self.scheduler.stats()
        out["latency"] = self.query_latency.summary()
        out["hedging"] = self.hedge_budget.stats()
        # enforced-memory surface: per-worker residency vs budget plus
        # spill counters (in-process stores only) and the red-line factor
        out["memory"] = {
            "redline_factor": self._redline_factor(),
            "measured_queries": len(self._measured_bytes),
            "workers": {
                url: {
                    k: v for k, v in s.stats().items()
                    if k in ("nbytes", "peak_nbytes", "budget_bytes",
                             "spilled_nbytes", "spills", "refaults",
                             "spill_files")
                }
                for url, s in self._worker_stores()
            },
        }
        # rolling SLO attainment vs the live targets (empty targets
        # still report the window's p99/error rate)
        out["slo"] = self.slo_snapshot()
        if self.checkpoints is not None:
            out["checkpoints"] = self.checkpoints.stats()
        rc = getattr(self.ctx, "_result_cache", None)
        if rc is not None:
            out["result_cache"] = rc.stats()
        return out

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted query resolved; -> drained."""
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        while True:
            with self._lock:
                busy = bool(self._running) or bool(self._queued)
            if not busy:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)

    def close(self, cancel_pending: bool = False,
              timeout: float = 30.0) -> None:
        """Stop ACCEPTING queries and shut down. By default the backlog
        still resolves — already-queued queries admit and run during the
        drain (graceful); ``cancel_pending=True`` cancels them instead.
        Either way every handle resolves — no stranded result() waiters."""
        with self._lock:
            self._closed = True
            queued = list(self._queued) if cancel_pending else []
        for h in queued:
            self._cancel(h)
        if not self.drain(timeout=timeout):
            # the graceful window expired with queries still in flight:
            # cancel them so their handles resolve CANCELLED — closing
            # the scheduler under them would fail their next stage
            # submission with a scheduler-internal error instead
            with self._lock:
                stuck = list(self._running.values()) + list(self._queued)
            for h in stuck:
                self._cancel(h)
            self.drain(timeout=10.0)
        self._monitor_stop.set()
        self.scheduler.close()

    def __enter__(self) -> "ServingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close(cancel_pending=True)
