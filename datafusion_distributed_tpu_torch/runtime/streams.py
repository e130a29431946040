"""Streaming data plane: budgeted, cancellable chunk streams between
workers and the coordinator.

The reference's WorkerConnectionPool multiplexes a partition range per
stream, demuxes into per-partition channels, and backpressures on a 64 MiB
byte budget (`src/worker/worker_connection_pool.rs:243-308`);
tasks execute their partitions concurrently
(`src/worker/impl_execute_task.rs:80-114`). The TPU host
tier's analogue: a task's (device-resident) output is sliced into row
chunks; one puller thread per task feeds a shared bounded buffer whose
in-flight bytes never exceed the budget; the consumer drains chunks and can
cancel the remaining production early (a satisfied LIMIT stops the wire).

Two consumer shapes share the machinery:

- `stream_stage_chunks`: collect-then-return — every puller's chunks are
  gathered and handed back at once (the materialized planes).
- `stream_partition_chunks` + `PartitionFeed`: incremental demux — chunks
  arrive tagged (partition, producer, seq) and become visible to waiting
  consumers the moment they land, with per-partition completion tracking.
  This is the PIPELINED shuffle plane's transport: consumer tasks start on
  their partition as soon as it closes instead of waiting for the whole
  boundary (`StreamScanExec` is the consumer-side leaf).

In-mesh exchanges never touch this: they are single-program collectives.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from datafusion_distributed_tpu_torch.runtime import leakcheck as _leakcheck
from datafusion_distributed_tpu_torch.ops.table import (
    Table,
    concat_tables,
    host_rows,
)
from datafusion_distributed_tpu_torch.plan.physical import (
    DistributedTaskContext,
    ExecContext,
    ExecutionPlan,
)


class CancelSignal(threading.Event):
    """threading.Event whose ``set()`` also fires registered wake hooks.

    The stream machinery blocks producers inside `StreamBudget.acquire`
    (a Condition wait); a plain Event's ``set()`` cannot wake them, which
    is why acquire historically polled with a 50 ms timeout. Binding the
    cancel to the budget (`StreamBudget.bind_cancel`) registers the
    budget's notify as a hook, so cancellation wakes blocked producers
    IMMEDIATELY and the poll timeout goes away."""

    def __init__(self):
        super().__init__()
        self._hook_lock = threading.Lock()
        self._hooks: list = []  # guarded-by: _hook_lock

    def add_hook(self, fn) -> None:
        with self._hook_lock:
            self._hooks.append(fn)
            already = self.is_set()
        if already:  # set() may have raced the registration: fire now
            fn()

    def set(self) -> None:
        super().set()
        with self._hook_lock:
            hooks = list(self._hooks)
        for fn in hooks:
            fn()


class StreamBudget:
    """Bounds the BYTES of chunks produced but not yet consumed (the
    connection-buffer budget role). Producers block in acquire() until the
    consumer releases; a chunk larger than the whole budget is admitted
    alone (large-but-valid rows must stream through, never deadlock).

    ``pressure``: optional callable — the destination worker stores'
    memory-pressure probe (TableStore.under_pressure). While it reads
    True, producers with chunks still in flight BLOCK even when the
    stream's own budget has room: the stream degrades to trickle pace
    (one chunk at a time) so a pipelined shuffle slows down instead of
    overrunning an enforced worker memory budget. Like the byte budget,
    pressure never blocks a producer with ZERO bytes in flight —
    guaranteed progress, so a store pinned over budget by live
    consumers can still drain. A bound CancelSignal wakes blocked
    producers immediately either way (cancel-notify); pressure-clear is
    observed at the 50 ms poll."""

    def __init__(self, budget_bytes: int, pressure=None):
        self.budget = max(int(budget_bytes), 1)
        self.pressure = pressure
        self._cv = threading.Condition()
        self._in_flight = 0  # guarded-by: _cv
        self.peak_in_flight = 0  # guarded-by: _cv
        self.pressure_waits = 0  # guarded-by: _cv
        # cancel events whose set() notifies _cv (bind_cancel): acquire
        # may then wait WITHOUT a poll timeout — a blocked producer wakes
        # at cancellation latency instead of the next 50 ms tick
        self._bound = weakref.WeakSet()  # guarded-by: _cv

    def bind_cancel(self, cancel: "CancelSignal") -> None:
        """Register ``cancel`` to notify blocked acquirers on set()."""
        with self._cv:
            self._bound.add(cancel)
        cancel.add_hook(self._wake_all)

    def _wake_all(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def _under_pressure(self) -> bool:
        if self.pressure is None:
            return False
        try:
            return bool(self.pressure())
        except Exception:
            return False  # a broken probe must never wedge the stream

    def acquire(self, nbytes: int, cancel: threading.Event) -> bool:
        with self._cv:
            # a bound CancelSignal notifies this condition on set(), so
            # the wait needs no poll timeout; an unbound plain Event —
            # or an installed pressure probe, which nothing notifies —
            # keeps the 50 ms poll as the progress check
            timeout = (
                None if cancel in self._bound and self.pressure is None
                else 0.05
            )
            noted_pressure = False
            while self._in_flight > 0 and (
                self._in_flight + nbytes > self.budget
                or self._under_pressure()
            ):
                if not noted_pressure and (
                    self._in_flight + nbytes <= self.budget
                ):
                    # blocked by store pressure alone: count it once per
                    # acquire (the backpressure-engaged signal)
                    self.pressure_waits += 1
                    noted_pressure = True
                if cancel.is_set():
                    return False
                self._cv.wait(timeout=timeout)
            if cancel.is_set():
                return False
            self._in_flight += nbytes
            self.peak_in_flight = max(self.peak_in_flight, self._in_flight)
            return True

    def release(self, nbytes: int) -> None:
        with self._cv:
            self._in_flight -= nbytes
            self._cv.notify_all()


@dataclass
class StreamStats:
    """Per-stage streaming telemetry (surfaced via Coordinator.metrics).
    ``rows_per_s``/``bytes_per_s`` are the reference LoadInfo's velocity
    fields (`worker.proto` LoadInfo, `sampler.rs:30-42`)."""

    bytes_streamed: int = 0
    chunks: int = 0
    peak_in_flight: int = 0
    early_exit: bool = False
    rows: int = 0
    elapsed_s: float = 0.0
    rows_per_s: float = 0.0
    bytes_per_s: float = 0.0
    extra: dict = field(default_factory=dict)


def _note_leaked_pullers(count: int) -> None:
    """A puller thread outlived its join window: count it into the
    process telemetry registry (`dftpu_stream_pullers_leaked_total`) and
    the always-on structured event log, so a hung producer shows up as a
    visible signal instead of a slow thread leak. Best-effort — leak
    OBSERVABILITY must never fail the stream that already completed."""
    try:
        from datafusion_distributed_tpu_torch.runtime.telemetry import (
            DEFAULT_REGISTRY,
        )

        DEFAULT_REGISTRY.counter(
            "dftpu_stream_pullers_leaked",
            "Stream puller threads abandoned after the join timeout "
            "(a hung producer task the stream stopped waiting for).",
        ).inc(count)
    except Exception:
        pass
    try:
        from datafusion_distributed_tpu_torch.runtime.eventlog import log_event

        log_event("stream_pullers_leaked", count=count)
    except Exception:
        pass


def _join_pullers(threads, stats: StreamStats,
                  timeout_s: float = 5.0) -> None:
    """Join puller threads with a bounded per-stream budget; stragglers
    are ABANDONED (daemon threads — a hung worker execute cannot be
    interrupted from Python) but now counted instead of silently leaked:
    `stats.extra["pullers_leaked"]` + telemetry + a structured event."""
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    leaked = sum(1 for t in threads if t.is_alive())
    if leaked:
        stats.extra["pullers_leaked"] = leaked
        _note_leaked_pullers(leaked)


def stream_stage_chunks(
    pullers: list[Callable[[threading.Event], Iterator[tuple[Table, int]]]],
    budget_bytes: int,
    row_target: Optional[int] = None,
    max_concurrent: Optional[int] = None,
    on_progress: Optional[Callable[[int, int, int, int], None]] = None,
    payload_rows: Optional[Callable] = None,
    on_chunk: Optional[Callable] = None,
    pressure: Optional[Callable[[], bool]] = None,
) -> tuple[list[list], StreamStats]:
    """Run one chunk stream per producer task concurrently under a shared
    byte budget; -> (per-task chunk lists, stats).

    ``row_target``: stop pulling once this many TOTAL rows arrived (the
    downstream LIMIT's fetch+skip) — remaining production is cancelled and
    its bytes never cross the wire.

    ``max_concurrent``: at most this many pullers EXECUTE at once (the
    cluster's worker count — a single in-process worker must not run every
    producer task simultaneously; matches `_run_stage_tasks`' thread-pool
    policy). Each puller materializes its task's output on dispatch, so
    this bounds peak device-side concurrency, not just host chunks.

    ``on_progress(done_pullers, total_pullers, rows, bytes)``: called in
    the consumer thread after every puller COMPLETION with the rows/bytes
    contributed by the completed pullers only — the reference's
    mid-execution LoadInfo stream (`sampler.rs:30-42`); an adaptive
    coordinator extrapolates the NEXT stage's sizing from these partial
    per-task samples (rows from still-running pullers are excluded so
    `rows * total/done` is an unbiased estimate).

    ``on_chunk(payload)``: called in the consumer thread for EVERY chunk
    as it arrives — the per-column half of the reference's LoadInfo
    (NDV %% / null %% sampled from in-flight batches, `sampler.rs:30-42`);
    the adaptive coordinator feeds a mid-stream column sampler from it.

    ``pressure``: destination-store memory-pressure probe
    (StreamBudget's producer backpressure — see its docstring).
    """
    import queue as _q

    if payload_rows is None:
        payload_rows = lambda p: host_rows(p)  # noqa: E731
    t_start = time.perf_counter()
    budget = StreamBudget(budget_bytes, pressure=pressure)
    cancel = CancelSignal()
    budget.bind_cancel(cancel)
    out_q: _q.Queue = _q.Queue()
    chunks: list[list[Table]] = [[] for _ in pullers]
    stats = StreamStats()
    gate = (
        threading.Semaphore(max_concurrent)
        if max_concurrent is not None and max_concurrent < len(pullers)
        else None
    )

    def run(i: int, pull) -> None:
        held = False
        if _leakcheck.enabled():
            _leakcheck.note_acquire("stream-puller", (id(out_q), i),
                                    tag="stream_stage_chunks")
        try:
            if gate is not None:
                gate.acquire()
                held = True
            if cancel.is_set():  # satisfied LIMIT: never dispatch the task
                return
            for chunk, nbytes in pull(cancel):
                if not budget.acquire(nbytes, cancel):
                    break
                out_q.put(("chunk", i, chunk, nbytes))
        except BaseException as e:  # propagate to the consumer
            out_q.put(("error", i, e, 0))
        finally:
            if held:
                gate.release()
            # an abandoned puller (join timeout) stays live in the leak
            # harness until its thread actually exits — leaked-while-hung,
            # self-releasing, matching the telemetry counter's intent
            if _leakcheck.enabled():
                _leakcheck.note_release("stream-puller", (id(out_q), i))
            out_q.put(("done", i, None, 0))

    threads = [
        threading.Thread(target=run, args=(i, p), daemon=True)
        for i, p in enumerate(pullers)
    ]
    for t in threads:
        t.start()
    live = len(pullers)
    error: Optional[BaseException] = None
    rows_per = [0] * len(pullers)
    bytes_per = [0] * len(pullers)
    done_rows = 0
    done_bytes = 0
    while live:
        kind, i, payload, nbytes = out_q.get()
        if kind == "done":
            live -= 1
            done_rows += rows_per[i]
            done_bytes += bytes_per[i]
            if on_progress is not None:
                on_progress(len(pullers) - live, len(pullers),
                            done_rows, done_bytes)
            continue
        if kind == "error":
            # first error wins, EXCEPT that a fatal (non-retryable) error
            # displaces a retryable one: once the fault-tolerant pullers
            # exhausted their retries, the query-semantic failure is the
            # actionable diagnosis — a sibling's transport hiccup that
            # happened to arrive first must not mask it
            from datafusion_distributed_tpu_torch.runtime.errors import (
                is_retryable,
            )

            if error is None or (
                is_retryable(error) and not is_retryable(payload)
            ):
                error = payload
            cancel.set()
            continue
        budget.release(nbytes)
        if cancel.is_set():
            continue  # late chunk after cancellation: drop
        chunks[i].append(payload)
        if on_chunk is not None:
            try:
                on_chunk(payload)
            except Exception:
                pass  # sampling must never fail the stream
        stats.chunks += 1
        stats.bytes_streamed += nbytes
        pr = payload_rows(payload)
        stats.rows += pr
        rows_per[i] += pr
        bytes_per[i] += nbytes
        if row_target is not None and stats.rows >= row_target:
            stats.early_exit = True
            cancel.set()
    _join_pullers(threads, stats)
    if error is not None:
        raise error
    stats.peak_in_flight = budget.peak_in_flight
    if budget.pressure_waits:
        stats.extra["pressure_waits"] = budget.pressure_waits
    stats.elapsed_s = max(time.perf_counter() - t_start, 1e-9)
    stats.rows_per_s = stats.rows / stats.elapsed_s
    stats.bytes_per_s = stats.bytes_streamed / stats.elapsed_s
    return chunks, stats


# ---------------------------------------------------------------------------
# pipelined shuffle plane: incremental per-(task, partition) demux
# ---------------------------------------------------------------------------


def _feed_cancel_error():
    from datafusion_distributed_tpu_torch.runtime.errors import TaskCancelledError

    return TaskCancelledError(
        "pipelined partition feed cancelled: the query was cancelled "
        "while waiting for producer slices"
    )


class PartitionFeed:
    """Consumer-side incremental buffer of a pipelined shuffle boundary.

    Producer task i's multiplexed stream yields (partition, chunk) pairs
    in ASCENDING partition order (`Worker.execute_task_partitions` walks
    [part_lo, part_hi)); the feed demuxes arrivals into per-partition
    chunk lists tagged (producer, seq). Partition p is COMPLETE once
    every producer has either finished or moved past p — at which point
    `wait_partition(p)` returns p's chunks in deterministic
    (producer, seq) order, which is EXACTLY the order the materialized
    plane's collect-then-concat produces (producer-major, yield order
    within a producer), so the pipelined and materialized planes build
    byte-identical consumer slices.

    Waits honor an optional ``cancelled`` callable (the coordinator's
    per-query cancel predicate) so a consumer blocked on a partition of a
    cancelled query unwinds instead of waiting for producers that will
    never finish."""

    def __init__(self, num_partitions: int, num_producers: int):
        self.num_partitions = int(num_partitions)
        self.num_producers = int(num_producers)
        self._cv = threading.Condition()
        #: per partition: list of (producer_index, seq, Table)
        self._chunks: list[list] = [
            [] for _ in range(self.num_partitions)
        ]  # guarded-by: _cv
        #: per producer: highest partition id it has emitted so far
        self._frontier = [-1] * self.num_producers  # guarded-by: _cv
        self._seq = [0] * self.num_producers  # guarded-by: _cv
        self._done = [False] * self.num_producers  # guarded-by: _cv
        self._first = False  # guarded-by: _cv
        self._complete = False  # guarded-by: _cv
        self._error: Optional[BaseException] = None  # guarded-by: _cv
        self._end_s: Optional[float] = None  # guarded-by: _cv
        self._on_complete: list = []  # guarded-by: _cv
        self.stats: Optional[StreamStats] = None  # guarded-by: _cv
        #: per-partition rows/bytes landed so far — the live skew
        #: histogram the runtime-adaptivity layer reads to spot a hot
        #: destination while (and after) the shuffle streams
        #: (runtime/adaptivity.py detect_skew)
        self.partition_rows = [0] * self.num_partitions  # guarded-by: _cv
        self.partition_bytes = [0] * self.num_partitions  # guarded-by: _cv

    # -- producer side (driven by stream_partition_chunks) -------------------
    def add(self, producer: int, partition: int, chunk: Table,
            nbytes: int = 0) -> None:
        with self._cv:
            self._chunks[partition].append(
                (producer, self._seq[producer], chunk)
            )
            self._seq[producer] += 1
            self._frontier[producer] = max(
                self._frontier[producer], partition
            )
            self.partition_rows[partition] += host_rows(chunk)
            self.partition_bytes[partition] += int(nbytes)
            self._first = True
            self._cv.notify_all()

    def producer_done(self, producer: int) -> None:
        with self._cv:
            self._done[producer] = True
            self._cv.notify_all()

    def fail(self, error: BaseException) -> None:
        """Record a failure (idempotent). Mirrors the stream loops'
        first-error-wins-except-fatal-displaces-retryable rule: once the
        pullers exhausted their retries, the query-semantic failure is
        the actionable diagnosis and must not be masked by a sibling's
        transport hiccup that landed first."""
        from datafusion_distributed_tpu_torch.runtime.errors import is_retryable

        with self._cv:
            if self._error is None or (
                is_retryable(self._error) and not is_retryable(error)
            ):
                self._error = error
            self._end_s = self._end_s or time.monotonic()
            self._cv.notify_all()

    def finish(self, stats: StreamStats) -> None:
        with self._cv:
            self.stats = stats
            self._complete = True
            self._end_s = time.monotonic()
            callbacks = list(self._on_complete)
            self._on_complete.clear()
            end = self._end_s
            self._cv.notify_all()
        for cb in callbacks:  # outside the lock: callbacks may take locks
            cb(end)

    def on_complete(self, cb: Callable[[float], None]) -> None:
        """Register ``cb(end_monotonic_s)`` to fire when the feed
        completes successfully (immediately if it already has). A failed
        feed never fires — matching the materialized plane, which records
        no stage span for a failed materialization."""
        with self._cv:
            if not self._complete:
                self._on_complete.append(cb)
                return
            end = self._end_s
        cb(end)

    # -- consumer side -------------------------------------------------------
    def _partition_ready_locked(self, p: int) -> bool:
        if self._complete:
            return True
        return all(
            self._done[i] or self._frontier[i] > p
            for i in range(self.num_producers)
        )

    def _wait_locked(self, pred, cancelled: Optional[Callable[[], bool]]):
        """Block until ``pred()`` or the feed errors; the caller holds
        `_cv`. ``cancelled`` is polled at a coarse interval as the
        backstop for cancellations that never reach the feed itself."""
        while True:
            if self._error is not None:
                raise self._error
            if pred():
                return
            if cancelled is not None and cancelled():
                raise _feed_cancel_error()
            self._cv.wait(timeout=0.25 if cancelled is not None
                          else None)

    def wait_first_chunk(
        self, cancelled: Optional[Callable[[], bool]] = None
    ) -> None:
        """Block until the first slice landed (the stage-DAG scheduler's
        consumer-release point) — or the feed completed empty/errored."""
        with self._cv:
            self._wait_locked(
                lambda: self._first or self._complete, cancelled
            )

    def wait_partition(
        self, p: int, cancelled: Optional[Callable[[], bool]] = None
    ) -> list[Table]:
        """Chunks of partition ``p`` in deterministic (producer, seq)
        order, blocking until the partition is complete."""
        with self._cv:
            self._wait_locked(
                lambda: self._partition_ready_locked(p), cancelled
            )
            parts = sorted(self._chunks[p], key=lambda e: (e[0], e[1]))
            # consumed exactly once per partition; drop the raw refs so
            # the feed does not pin chunk views past their concat
            self._chunks[p] = []
        return [c for _i, _s, c in parts]

    def wait_complete(
        self, cancelled: Optional[Callable[[], bool]] = None
    ) -> StreamStats:
        with self._cv:
            self._wait_locked(lambda: self._complete, cancelled)
            return self.stats

    def partition_histogram(self) -> tuple[list, list]:
        """Point-in-time copy of the per-partition (rows, bytes) landed
        so far — complete once the feed finished."""
        with self._cv:
            return list(self.partition_rows), list(self.partition_bytes)

    @property
    def error(self) -> Optional[BaseException]:
        with self._cv:
            return self._error


def stream_partition_chunks(
    pullers: list,
    budget_bytes: int,
    feed: PartitionFeed,
    max_concurrent: Optional[int] = None,
    on_chunk: Optional[Callable] = None,
    should_cancel: Optional[Callable[[], bool]] = None,
    pressure: Optional[Callable[[], bool]] = None,
) -> StreamStats:
    """Incremental variant of `stream_stage_chunks` for per-(task,
    partition) streams: each puller yields ((partition, chunk), est_bytes)
    and every arrival is demuxed into ``feed`` IMMEDIATELY (budget bytes
    released on demux — the feed's accumulation is the same memory the
    materialized plane would hold). On success the feed is finished with
    the stream stats; on failure it is failed with the first error (fatal
    displaces retryable, as in stream_stage_chunks) and the error
    re-raises. ``should_cancel``: external cancel predicate (the
    per-query cancel) polled in the consumer loop. ``pressure``:
    destination-store memory-pressure probe — producers slow to trickle
    pace while the worker stores are over their enforced budget."""
    import queue as _q

    t_start = time.perf_counter()
    budget = StreamBudget(budget_bytes, pressure=pressure)
    cancel = CancelSignal()
    budget.bind_cancel(cancel)
    out_q: _q.Queue = _q.Queue()
    stats = StreamStats()
    gate = (
        threading.Semaphore(max_concurrent)
        if max_concurrent is not None and max_concurrent < len(pullers)
        else None
    )

    def run(i: int, pull) -> None:
        held = False
        if _leakcheck.enabled():
            _leakcheck.note_acquire("stream-puller", (id(out_q), i),
                                    tag="stream_partition_chunks")
        try:
            if gate is not None:
                gate.acquire()
                held = True
            if cancel.is_set():
                return
            for payload, nbytes in pull(cancel):
                if not budget.acquire(nbytes, cancel):
                    break
                out_q.put(("chunk", i, payload, nbytes))
        except BaseException as e:
            out_q.put(("error", i, e, 0))
        finally:
            if held:
                gate.release()
            if _leakcheck.enabled():
                _leakcheck.note_release("stream-puller", (id(out_q), i))
            out_q.put(("done", i, None, 0))

    threads = [
        threading.Thread(target=run, args=(i, p), daemon=True,
                         name="dftpu-pipelined-pull")
        for i, p in enumerate(pullers)
    ]
    for t in threads:
        t.start()
    live = len(pullers)
    error: Optional[BaseException] = None
    while live:
        try:
            kind, i, payload, nbytes = out_q.get(timeout=0.25)
        except _q.Empty:
            if should_cancel is not None and should_cancel():
                cancel.set()
            continue
        if kind == "done":
            live -= 1
            feed.producer_done(i)
            continue
        if kind == "error":
            from datafusion_distributed_tpu_torch.runtime.errors import (
                is_retryable,
            )

            if error is None or (
                is_retryable(error) and not is_retryable(payload)
            ):
                error = payload
            # fail the feed NOW, not at loop end: the failed producer's
            # trailing "done" would otherwise mark its unfinished
            # partitions complete and a consumer mid-wait could build a
            # silently truncated slice in the drain window (the error
            # message precedes the done message in the queue, so waiters
            # observe the failure first)
            feed.fail(payload)
            cancel.set()
            continue
        budget.release(nbytes)
        if cancel.is_set():
            continue  # late chunk after cancellation: drop
        p, chunk = payload
        feed.add(i, p, chunk, nbytes=nbytes)
        if on_chunk is not None:
            try:
                on_chunk(chunk)
            except Exception:
                pass  # sampling must never fail the stream
        stats.chunks += 1
        stats.bytes_streamed += nbytes
        stats.rows += host_rows(chunk)
        if should_cancel is not None and should_cancel():
            cancel.set()
    _join_pullers(threads, stats)
    stats.peak_in_flight = budget.peak_in_flight
    if budget.pressure_waits:
        stats.extra["pressure_waits"] = budget.pressure_waits
    stats.elapsed_s = max(time.perf_counter() - t_start, 1e-9)
    stats.rows_per_s = stats.rows / stats.elapsed_s
    stats.bytes_per_s = stats.bytes_streamed / stats.elapsed_s
    if error is not None:
        feed.fail(error)
        raise error
    if cancel.is_set():
        # cancelled WITHOUT a puller error (external should_cancel):
        # in-flight chunks were dropped above, so the feed must FAIL —
        # finishing it would let a consumer that already passed its
        # cancel checkpoint build a silently TRUNCATED partition and
        # record the stream as complete
        cancelled = _feed_cancel_error()
        feed.fail(cancelled)
        raise cancelled
    feed.finish(stats)
    return stats


class StreamScanExec(ExecutionPlan):
    """Consumer-side leaf of a PIPELINED shuffle boundary.

    Holds a live `PartitionFeed` instead of materialized tables: the
    stage-DAG scheduler releases the consumer stage on FIRST SLICE, and
    each consumer task's dispatch (`_task_specialized`) resolves this
    node into a pinned MemoryScan by waiting for ITS partition only — so
    consumer task j starts executing the moment partition j closes, while
    partitions j+1.. are still streaming. Never crosses the wire (task
    specialization replaces it before encode; the codec has no entry for
    it by design, so an accidental ship fails loudly).

    Byte identity with the materialized plane: `task_slice` builds each
    partition's table with the SAME chunk order ((producer, seq) — the
    materialized collect's producer-major order) and the SAME capacity
    arithmetic (live rows rounded up to 8), so the consumer stage's
    compiled programs and results are identical across planes."""

    def __init__(self, feed: PartitionFeed, schema,
                 dictionaries: Optional[dict] = None,
                 capacity_hint: int = 0,
                 cancelled: Optional[Callable[[], bool]] = None,
                 device=None):
        super().__init__()
        self.feed = feed
        # the device of an empty partition's table (the chunks' own
        # device otherwise)
        self.device = device
        self._schema = schema
        self.dictionaries = dictionaries
        self.capacity_hint = int(capacity_hint)
        self._cancelled = cancelled
        self._cv = threading.Condition()
        self._slices: dict = {}  # partition -> Table; guarded-by: _cv
        #: partitions a thread is currently building (claim protocol:
        #: feed chunks drain exactly once, so a concurrent second
        #: build — a re-dispatch of the same consumer task — must
        #: WAIT for the first one, never build from the drained
        #: feed and install an empty slice)
        self._building: set = set()  # guarded-by: _cv

    @property
    def num_partitions(self) -> int:
        return self.feed.num_partitions

    # -- tree ---------------------------------------------------------------
    def children(self):
        return []

    def with_new_children(self, children):
        assert not children
        return self

    def schema(self):
        return self._schema

    def output_capacity(self):
        return max(self.capacity_hint, 8)

    # -- data plane ---------------------------------------------------------
    def task_slice(self, partition: int) -> Table:
        """The consumer slice for ``partition``, built exactly like the
        materialized plane's (concat in (producer, seq) order, capacity =
        live rows rounded to 8, schema-typed empty fallback). Built
        EXACTLY ONCE (the feed's chunks drain on first take); concurrent
        callers — task retries, a hedged re-dispatch of the same
        consumer task — wait for the first build and observe the same
        table object."""
        with self._cv:
            while True:
                hit = self._slices.get(partition)
                if hit is not None:
                    return hit
                if partition not in self._building:
                    self._building.add(partition)
                    break
                # another thread is building this slice: wait for its
                # install (timeout so an external cancel still unwinds)
                if self._cancelled is not None and self._cancelled():
                    raise _feed_cancel_error()
                self._cv.wait(
                    timeout=0.25 if self._cancelled is not None else None
                )
        try:
            chunks = self.feed.wait_partition(partition, self._cancelled)
            if chunks:
                rows = sum(host_rows(t) for t in chunks)
                cap = max(-(-rows // 8) * 8, 8)
                built = concat_tables(chunks, capacity=cap)
            else:
                built = Table.empty(self._schema, 8, self.dictionaries,
                               device=self.device)
        except BaseException:
            with self._cv:
                # release the claim so a retry (or the hedge sibling)
                # can surface the feed's error instead of hanging
                self._building.discard(partition)
                self._cv.notify_all()
            raise
        with self._cv:
            self._building.discard(partition)
            self._slices[partition] = built
            self._cv.notify_all()
        return built

    def all_slices(self) -> list[Table]:
        """Every partition's slice in partition order (the IsolatedArm
        sole-consumer pull and the direct-execution fallback)."""
        return [self.task_slice(p) for p in range(self.num_partitions)]

    def load(self, task: DistributedTaskContext) -> Table:
        """In-process fallback (a stage executed without task
        specialization): mirror MemoryScanExec.load semantics."""
        if task.task_index >= self.num_partitions:
            return Table.empty(self._schema, 8, self.dictionaries,
                               device=self.device)
        return self.task_slice(task.task_index)

    def _execute(self, ctx: ExecContext) -> Table:
        return ctx.inputs[self.node_id]

    def display(self):
        return (
            f"StreamScan partitions={self.num_partitions} "
            f"producers={self.feed.num_producers}"
        )
