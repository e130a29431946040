"""Worker runtime: plan hosting, task registry, execution service.

The reference's worker (`src/worker/worker_service.rs`) is a
gRPC service holding a TTL cache of `TaskKey -> TaskData`, a per-query
session factory, plan hooks, and the ExecuteTask data plane. This is the
TPU-native equivalent for the host runtime tier: inside a mesh no worker
objects exist at all (the SPMD program IS the stage execution); workers come
into play across meshes/hosts, where each worker owns a device (or mesh) and
the coordinator moves stage outputs between them.

Transport-agnostic by design: `Worker` is plain Python called in-process
(the InMemoryChannelResolver analogue); `runtime/grpc_worker.py` wraps the
same object behind gRPC for multi-host deployments.

Port of the reference `runtime/worker.py`. A task runs `execute_plan` on the
device its tables live on, eagerly; the reference's stage-shared compile
cache has no counterpart here (nothing is compiled). Outputs, partition
slices and chunks stay on that device: slices and chunks are row-range
views (ops/table.py `slice_view`). The gRPC wrapper, the shm plane and the
wire codecs are ROADMAP A.5.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from datafusion_distributed_tpu_torch.ops.table import Table, host_rows
from datafusion_distributed_tpu_torch.plan.physical import (
    DistributedTaskContext,
    ExecutionPlan,
)
from datafusion_distributed_tpu_torch.runtime.codec import TableStore, decode_plan
from datafusion_distributed_tpu_torch.runtime.errors import (
    TaskTimeoutError,
    WorkerError,
    wrap_worker_exception,
)


def call_with_deadline(fn, timeout: Optional[float], worker_url: str, task):
    """Run ``fn()`` under a wall-clock deadline: on expiry raise the
    retryable `TaskTimeoutError` and ABANDON the still-running call (a hung
    execution cannot be interrupted from Python; the coordinator's retry
    machinery reroutes the task meanwhile). A bare DAEMON thread, not a
    ThreadPoolExecutor: pool workers are non-daemon and joined at
    interpreter exit, so one truly hung task would wedge process shutdown —
    the exact failure mode deadlines exist to convert. ``timeout``
    None/<=0 calls inline."""
    if not timeout or timeout <= 0:
        return fn()
    import threading

    box: dict = {}
    done = threading.Event()

    def run() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised in the caller below
            box["error"] = e
        finally:
            done.set()

    threading.Thread(target=run, daemon=True,
                     name="dftpu-deadline").start()
    if not done.wait(timeout):
        raise TaskTimeoutError(
            f"deadline of {timeout}s elapsed",
            worker_url=worker_url,
            task=task,
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


@dataclass(frozen=True)
class TaskKey:
    """(query, stage, task) addressing — the reference's `TaskKey`
    (`worker.proto`)."""

    query_id: str
    stage_id: int
    task_number: int


def _check_decoded_plan(plan: ExecutionPlan, plan_obj: dict,
                        worker_url: str, key, config=None) -> None:
    """Post-decode verification (plan/verify.py wiring, worker side).

    1. Integrity: the decoded plan's structural fingerprint must match the
       fingerprint stamped at encode time (``plan_obj["_fp"]``,
       runtime/codec.py). The compiled-program caches key on this
       fingerprint — stage-shared programs especially — so a silently
       miscoded plan would bind another stage's compiled program to this
       task's inputs (the physical.py wrong-binding hazard). A mismatch is
       the classified fatal `PlanIntegrityError` (DFTPU043), never wrong
       results. Runs before any `on_plan` hook (hooks legitimately rewrite
       plans per task).
    2. Static verification: under ``verify_plans=strict`` (propagated via
       the coordinator's config options) the decoded stage plan re-runs the
       schema/capacity passes — a defense against version-skewed decoders
       reconstructing a structurally broken tree.
    """
    from datafusion_distributed_tpu_torch.plan.verify import (
        PlanVerificationError,
        resolve_verify_mode,
        verify_physical_plan,
    )

    mode = resolve_verify_mode(config)
    if mode == "off":
        return
    wire_fp = plan_obj.get("_fp")
    if wire_fp is not None:
        from datafusion_distributed_tpu_torch.plan.fingerprint import prepare_plan
        from datafusion_distributed_tpu_torch.runtime.errors import (
            PlanIntegrityError,
        )

        got = prepare_plan(plan).fingerprint
        if got is not None and got != wire_fp:
            raise PlanIntegrityError(
                f"DFTPU043: decoded plan fingerprint {got} does not match "
                f"the wire fingerprint {wire_fp} — the plan was corrupted "
                "in transit or mis-decoded; executing it could bind a "
                "fingerprint-keyed compiled program to wrong inputs",
                worker_url=worker_url, task=key,
            )
    if mode == "strict":
        result = verify_physical_plan(plan, include_cache_audit=False)
        if not result.ok:
            raise PlanVerificationError(result, context=f"worker {worker_url} post-decode")


@dataclass
class TaskData:
    """Per-task state (the reference's `task_data.rs`): the decoded plan plus
    temporal metrics for observability."""

    key: TaskKey
    plan: ExecutionPlan
    task_count: int
    plan_added_at: float = field(default_factory=time.time)
    executed_at: Optional[float] = None
    finished_at: Optional[float] = None
    metrics: dict = field(default_factory=dict)
    # coordinator-propagated session config (config-over-headers analogue,
    # `config_extension_ext.rs:1-82`) and verbatim user headers
    # (`passthrough_headers.rs`)
    config: dict = field(default_factory=dict)
    headers: dict = field(default_factory=dict)
    # partition-range data plane state (the reference's per-task partition
    # accounting, `impl_execute_task.rs:97-112` / `task_data.rs`): the
    # task's output partitioned once per (keys, P) spec, a served set (a
    # retried range must not double-decrement), and a remaining count —
    # the entry self-invalidates when every partition was served. `lock`
    # serializes build/accounting across concurrent range streams.
    partition_spec: Optional[tuple] = None
    partition_slices: Optional[list] = None
    partitions_remaining: Optional[int] = None
    partitions_served: set = field(default_factory=set)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # shipment-store ids this task's plan references: released whenever the
    # registry entry dies (drop-driven cleanup OR TTL eviction), so a
    # cancelled/errored partition stream cannot leak TableStore entries on
    # a long-lived worker (ADVICE r4)
    shipped_table_ids: list = field(default_factory=list)
    # store ids of the STAGED partition slices (zero-copy accounting of
    # the peer partition plane): released with the entry like shipped ids,
    # and replaced wholesale when the partition spec changes (a re-spec
    # must not pin the previous regrouped buffer)
    staged_partition_ids: list = field(default_factory=list)
    # per-entry idle TTL override (None = the registry default). Peer-plane
    # producers ship at plan time but are first PULLED when their consumer
    # stage finally runs — on a deep plan under load that gap exceeded the
    # 600 s default and the entry evicted mid-query ("no plan for task").
    ttl: Optional[float] = None


RESERVED_HEADER_PREFIX = "x-dftpu-"


def validate_passthrough_headers(headers: dict) -> None:
    """User headers must not collide with the engine's reserved prefix
    (the reference rejects `x-datafusion-distributed-*` the same way)."""
    for k in headers:
        if k.lower().startswith(RESERVED_HEADER_PREFIX):
            raise ValueError(
                f"passthrough header {k!r} uses the reserved prefix "
                f"{RESERVED_HEADER_PREFIX!r}"
            )


class TaskRegistry:
    """TTL cache of TaskData (the moka TTI cache, `worker_service.rs:26,39`:
    entries idle longer than `ttl_seconds` are evicted so abandoned queries
    cannot leak plans/buffers)."""

    def __init__(self, ttl_seconds: float = 600.0,
                 on_evict: Optional[Callable[[TaskData], None]] = None):
        self.ttl = ttl_seconds
        self._entries: dict[TaskKey, tuple[float, TaskData]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # fired (outside hot paths, under the registry lock) for EVERY entry
        # leaving the registry — invalidate, TTL expiry, or sweep — so owners
        # can release per-task resources (the worker's shipped table slices)
        self.on_evict = on_evict

    def put(self, data: TaskData) -> None:
        with self._lock:
            self._evict_locked()
            # replacement evicts the displaced entry (releases its shipped
            # slices — table ids are unique per encode, so the new entry's
            # slices are untouched): a re-ship of the same key (retry to
            # the same worker, peer-producer refresh after membership
            # churn) must not strand the old attempt's slices, and callers
            # must NOT pre-invalidate — that would open a window where a
            # concurrent pull sees "no plan" for a key that is merely
            # being replaced
            old = self._entries.get(data.key)
            self._entries[data.key] = (time.time(), data)
            if old is not None:
                self._fire_evict(old[1])

    def get(self, key: TaskKey) -> Optional[TaskData]:
        with self._lock:
            self._evict_locked()
            hit = self._entries.get(key)
            if hit is None:
                return None
            ts, data = hit
            if time.time() - ts > (
                data.ttl if data.ttl is not None else self.ttl
            ):
                del self._entries[key]
                self._fire_evict(data)
                return None
            self._entries[key] = (time.time(), data)  # touch (TTI semantics)
            return data

    def invalidate(self, key: TaskKey) -> None:
        with self._lock:
            hit = self._entries.pop(key, None)
            if hit is not None:
                self._fire_evict(hit[1])

    def clear(self) -> None:
        """Evict EVERY entry (firing on_evict for each — shipped slices
        are released), as a dying worker process would: DynamicCluster's
        abrupt-leave path uses this so leak accounting across membership
        churn stays exact."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
            for _, data in entries:
                self._fire_evict(data)

    def _evict_locked(self) -> None:
        # DFTPU201/203 fix: caller holds `_lock` (the *_locked-suffix
        # convention the concurrency lint enforces; the old name implied
        # a self-locking method)
        now = time.time()
        dead = [
            k for k, (ts, d) in self._entries.items()
            if now - ts > (d.ttl if d.ttl is not None else self.ttl)
        ]
        for k in dead:
            _, data = self._entries.pop(k)
            self._fire_evict(data)

    def _fire_evict(self, data: TaskData) -> None:
        if self.on_evict is not None:
            try:
                self.on_evict(data)
            except Exception:
                pass  # cleanup must never poison the registry paths

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class Worker:
    """One worker = one executor endpoint.

    API mirrors the reference service surface (`worker_service.rs`):
      set_plan     <- CoordinatorChannel SetPlanRequest
      execute_task <- ExecuteTask
      get_info     <- GetWorkerInfo (version checks for rolling upgrades)
    """

    def __init__(
        self,
        url: str = "mem://worker",
        ttl_seconds: float = 600.0,
        version: str = "0.1.0",
        on_plan: Optional[Callable[[ExecutionPlan, TaskKey], ExecutionPlan]] = None,
        peer_channels=None,
    ):
        self.url = url
        self.version = version
        self.registry = TaskRegistry(
            ttl_seconds,
            on_evict=self._on_task_evict,
        )
        self.on_plan = on_plan
        self.table_store = TableStore()
        # per-worker typed metric registry (runtime/telemetry.py): the
        # `get_metrics` RPC serves its snapshot, and the observability
        # service merges per-worker snapshots (worker=url label) into
        # the cluster view. Collector adapters sample the table store's
        # existing accounting at snapshot time — no hot-path overhead.
        from datafusion_distributed_tpu_torch.runtime.telemetry import (
            MetricRegistry,
        )

        self.telemetry = MetricRegistry()
        self.telemetry.register_collector(
            self.table_store.telemetry_families
        )
        self.telemetry.gauge(
            "dftpu_worker_tasks_cached",
            "Task registry entries currently held.",
        ).set_function(lambda: len(self.registry))
        self._tm_tasks = self.telemetry.counter(
            "dftpu_worker_tasks_executed",
            "Task executions by outcome.", labels=("status",),
        )
        self._tm_rows = self.telemetry.counter(
            "dftpu_worker_rows_out", "Rows produced by task executions.",
        )
        self._tm_exec = self.telemetry.histogram(
            "dftpu_worker_execute_seconds",
            "Per-task execute wall seconds (host-side, around the "
            "compiled program).",
        )
        # ChannelResolver-like (get_worker(url)) used by the peer-to-peer
        # data plane to open streams to producer workers (the reference's
        # consumer-side WorkerConnectionPool, `worker_connection_pool.rs`)
        self.peer_channels = peer_channels
        # final progress of partition-range tasks, retained past their
        # drop-driven invalidation (consumed once by task_progress)
        self._final_progress: dict[TaskKey, Optional[dict]] = {}
        # keys whose set_plan attempt was abandoned by a dispatch deadline:
        # the still-running decode thread must not register an orphan
        # entry (pinning decoded tables until the TTL sweep) after the
        # coordinator rerouted — see set_plan's timeout path
        self._abandoned_lock = threading.Lock()
        self._abandoned_plans: set = set()  # guarded-by: _abandoned_lock

    def _on_task_evict(self, data: TaskData) -> None:
        """Registry-exit hook (invalidate, TTL expiry, sweep): release the
        task's shipped table slices and its staged partition slices."""
        self.table_store.remove(data.shipped_table_ids)
        self.table_store.remove(data.staged_partition_ids)

    # -- control plane ------------------------------------------------------
    def set_plan(self, key: TaskKey, plan_obj: dict, task_count: int,
                 config: Optional[dict] = None,
                 headers: Optional[dict] = None,
                 ttl: Optional[float] = None,
                 timeout: Optional[float] = None) -> None:
        """``timeout``: dispatch deadline — a hung decode converts into a
        retryable TaskTimeoutError instead of wedging the dispatcher. An
        abandoned decode is tombstoned so it cannot register an orphan
        entry after the coordinator rerouted (a residual race window
        degrades to the registry's TTL sweep, never to a permanent leak)."""
        if timeout:
            with self._abandoned_lock:
                # a NEW attempt for this key supersedes a stale tombstone
                self._abandoned_plans.discard(key)
            try:
                return call_with_deadline(
                    lambda: self.set_plan(key, plan_obj, task_count,
                                          config=config, headers=headers,
                                          ttl=ttl),
                    timeout, self.url, key,
                )
            except TaskTimeoutError:
                with self._abandoned_lock:
                    self._abandoned_plans.add(key)
                    while len(self._abandoned_plans) > 512:
                        self._abandoned_plans.pop()
                # the abandoned decode may have registered just before the
                # tombstone landed; eviction releases its shipped slices
                self.registry.invalidate(key)
                raise
        if headers:
            validate_passthrough_headers(headers)
        # an enforced worker memory budget rides the task config; the
        # store refuses one (spilling is ROADMAP A.5)
        if config and "worker_memory_budget_bytes" in config:
            self.table_store.set_budget(config["worker_memory_budget_bytes"])
        # cross-wire trace context (runtime/tracing.py): when the
        # coordinator ships one, worker-side phases record spans as plain
        # dicts that ride the task-progress payload back and splice into
        # the query trace under the propagated parent. Host-side only —
        # nothing trace-related may enter a jax-traced function
        # (DFTPU109) or a compile-cache key (execute strips it).
        tctx = (config or {}).get("trace_ctx")
        decode_t0 = time.monotonic() if tctx else 0.0
        try:
            plan = decode_plan(plan_obj, self.table_store)
            _check_decoded_plan(plan, plan_obj, self.url, key,
                                config=config)
            if self.on_plan is not None:
                plan = self.on_plan(plan, key)
        except Exception as e:  # structured propagation to the coordinator
            raise wrap_worker_exception(e, self.url, key) from e
        wire_spans = None
        if tctx:
            from datafusion_distributed_tpu_torch.runtime.tracing import (
                worker_span,
            )

            wire_spans = [worker_span(
                "worker_decode", "codec", decode_t0, time.monotonic(),
                tctx.get("parent"), worker=self.url,
            )]
        from datafusion_distributed_tpu_torch.runtime.codec import collect_table_ids
        from datafusion_distributed_tpu_torch.runtime.peer import (
            attach_peer_channels,
        )

        attach_peer_channels(plan, self.peer_channels, self)
        with self._abandoned_lock:
            if key in self._abandoned_plans:
                # this decode ran past its dispatch deadline; the
                # coordinator already rerouted — registering now would
                # orphan the entry until the TTL sweep
                self._abandoned_plans.discard(key)
                self.table_store.remove(collect_table_ids(plan_obj))
                return
        self.registry.put(TaskData(
            key=key, plan=plan, task_count=task_count,
            config=dict(config or {}), headers=dict(headers or {}),
            metrics={"spans": wire_spans} if wire_spans else {},
            shipped_table_ids=collect_table_ids(plan_obj),
            ttl=ttl,
        ))

    # -- data plane ---------------------------------------------------------
    def execute_task(self, key: TaskKey,
                     timeout: Optional[float] = None) -> Table:
        """``timeout``: execution deadline (seconds). On expiry the attempt
        is abandoned and the retryable TaskTimeoutError surfaces — the
        fault-tolerant coordinator reroutes the task to another worker."""
        if timeout:
            return call_with_deadline(
                lambda: self._execute_task_body(key), timeout, self.url, key
            )
        return self._execute_task_body(key)

    def _execute_task_body(self, key: TaskKey) -> Table:
        data = self.registry.get(key)
        if data is None:
            raise WorkerError(
                f"no plan for task {key} (expired or never set)",
                worker_url=self.url,
                task=key,
            )
        data.executed_at = time.time()
        tctx = (data.config or {}).get("trace_ctx")
        exec_t0 = time.monotonic() if tctx else 0.0
        try:
            from datafusion_distributed_tpu_torch.plan.physical import execute_plan
            from datafusion_distributed_tpu_torch.runtime.metrics import MetricsStore

            store = MetricsStore()
            # the wire trace context is coordinator plumbing, not plan
            # config
            exec_config = {
                k: v for k, v in (data.config or {}).items()
                if k != "trace_ctx"
            }
            out = execute_plan(
                data.plan,
                DistributedTaskContext(key.task_number, data.task_count),
                config=exec_config or None,
                metrics_store=store,
                task_label=f"task{key.task_number}",
            )
            data.metrics["nodes"] = store.per_task.get(
                f"task{key.task_number}", {}
            )
        except WorkerError:
            self._tm_tasks.inc(status="error")
            raise
        except Exception as e:
            self._tm_tasks.inc(status="error")
            raise wrap_worker_exception(e, self.url, key) from e
        data.finished_at = time.time()
        # read in execute_plan's one transfer (ops.table.host_rows)
        data.metrics["rows_out"] = host_rows(out)
        data.metrics["elapsed_s"] = data.finished_at - data.executed_at
        # telemetry (host-side, after the plan ran)
        self._tm_tasks.inc(status="ok")
        self._tm_rows.inc(data.metrics["rows_out"])
        self._tm_exec.observe(data.metrics["elapsed_s"])
        if tctx:
            from datafusion_distributed_tpu_torch.runtime.tracing import (
                worker_span,
            )

            data.metrics.setdefault("spans", []).append(worker_span(
                "worker_execute", "execute", exec_t0, time.monotonic(),
                tctx.get("parent"), worker=self.url,
                rows=data.metrics["rows_out"],
            ))
        return out

    def execute_task_stream(self, key: TaskKey, chunk_rows: int = 65536,
                            cancel=None):
        """Streaming data plane: execute once, then yield the output as
        (chunk Table, est_bytes) row-slices. A set ``cancel`` event stops
        slicing — un-yielded rows never cross the wire (the reference's
        dropped-stream early exit, `impl_execute_task.rs:97-112`).

        Zero-copy plane (default): every chunk is a row-range view of the
        output on its device — no per-chunk copies (`SET
        distributed.zero_copy = off` restores the copying slicer)."""
        from datafusion_distributed_tpu_torch.ops.table import (
            slice_view,
            zero_copy_enabled,
        )
        from datafusion_distributed_tpu_torch.planner.statistics import row_width

        data = self.registry.get(key)
        zc = zero_copy_enabled(data.config if data is not None else None)
        out = self.execute_task(key)
        n = host_rows(out)
        width = row_width(out.schema())
        if n == 0:
            yield out.slice_rows(0, 0), 0
            return
        for lo in range(0, n, max(chunk_rows, 1)):
            if cancel is not None and cancel.is_set():
                return
            count = min(chunk_rows, n - lo)
            yield (
                slice_view(out, lo, count) if zc
                else out.slice_rows(lo, count)
            ), count * width

    def execute_task_partitions(
        self,
        key: TaskKey,
        key_names,
        num_partitions: int,
        part_lo: int,
        part_hi: int,
        per_dest_capacity: int = 0,
        chunk_rows: int = 65536,
        cancel=None,
    ):
        """Partition-range data plane: one stream carries partitions
        [part_lo, part_hi) of this task's hash-partitioned output, each
        chunk tagged with its partition id — the reference's multiplexed
        ExecuteTask stream (`worker_connection_pool.rs:243-308` demuxes the
        same shape into per-partition channels). The output is executed and
        partitioned ONCE per (keys, P) spec and cached on the TaskData;
        `partitions_remaining` decrements per served partition and the
        registry entry self-invalidates at zero (the drop-driven accounting
        of `impl_execute_task.rs:97-112`).

        Yields (partition_id, chunk Table, est_bytes).
        """
        from datafusion_distributed_tpu_torch.planner.statistics import row_width

        data = self.registry.get(key)
        if data is None:
            raise WorkerError(
                f"no plan for task {key} (expired or never set)",
                worker_url=self.url,
                task=key,
            )
        spec = (tuple(key_names), int(num_partitions))
        with data.lock:
            if data.partition_slices is None or data.partition_spec != spec:
                from datafusion_distributed_tpu_torch.ops.table import (
                    zero_copy_enabled,
                )

                zc = zero_copy_enabled(data.config)
                # the output stays on its device: on the zero-copy plane
                # every partition slice and chunk below is a view of one
                # regrouped buffer there
                out = self.execute_task(key)
                if not key_names:
                    # replicate mode (peer broadcast / gather): the FULL
                    # output serves under every virtual partition id — the
                    # reference's NetworkBroadcastExec virtual-partition
                    # scheme (`broadcast.rs:30-69`); entries are references,
                    # not copies, and the per-partition drop accounting
                    # self-invalidates after the last consumer pulled
                    data.partition_slices = [out] * num_partitions
                else:
                    # same hash as the task executor's shuffle, so codes
                    # co-locate across tiers (function-level import:
                    # runtime/coordinator.py imports this module at top
                    # level)
                    from datafusion_distributed_tpu_torch.runtime.coordinator import (  # noqa: E501
                        _shuffle_regroup,
                    )

                    cap = per_dest_capacity or max(int(out.capacity), 8)
                    data.partition_slices = _shuffle_regroup(
                        [out], key_names, num_partitions, cap,
                        zero_copy=zc, exact=zc,
                    )
                data.partition_spec = spec
                data.partitions_served = set()
                data.partitions_remaining = num_partitions
                # staged-byte accounting on EITHER plane (the copying
                # plane's padded slices are real allocations too); on the
                # view plane these are views/aliases of one buffer
                self._stage_partition_slices(key, data)
            # a concurrent stream finishing its range must not yank the
            # slices out from under this one: hold our own reference
            slices = data.partition_slices
        from datafusion_distributed_tpu_torch.ops.table import (
            read_rows,
            slice_view,
            zero_copy_enabled,
        )

        view = zero_copy_enabled(data.config)
        try:
            pieces = slices[part_lo:min(part_hi, num_partitions)]
            read_rows(pieces)  # one transfer for the range's row counts
            for p in range(part_lo, min(part_hi, num_partitions)):
                piece = slices[p]
                n = host_rows(piece)
                width = row_width(piece.schema())
                if n == 0:
                    yield p, piece.slice_rows(0, 0), 0
                else:
                    for lo in range(0, n, max(chunk_rows, 1)):
                        if cancel is not None and cancel.is_set():
                            return
                        count = min(chunk_rows, n - lo)
                        yield p, (
                            slice_view(piece, lo, count) if view
                            else piece.slice_rows(lo, count)
                        ), count * width
                with data.lock:
                    if p not in data.partitions_served:
                        data.partitions_served.add(p)
                        data.partitions_remaining -= 1
        finally:
            with data.lock:
                done = data.partitions_remaining is not None and (
                    data.partitions_remaining <= 0
                )
            # Replicate mode (empty key_names: peer broadcast/gather) must
            # NOT self-invalidate on the last distinct partition — a
            # consumer stage forced wider than the planned fan-out re-pulls
            # a virtual partition id (modulo wrap), and racing that pull
            # against the drop-invalidation fails it with "no plan".
            # Broadcast producers are released by the coordinator's
            # query-end sweep instead (the reference keeps its broadcast
            # batch cache for the query lifetime the same way,
            # `broadcast.rs:71-98`).
            # The same retention applies to any producer shipped with a
            # per-entry TTL override (data.ttl — peer-plane producers, which
            # the coordinator's query-end sweep owns): a consumer whose load
            # succeeded against THIS producer but failed against a departed
            # sibling retries its whole pull set, and the re-pull of an
            # already-fully-served partition must serve from the cached
            # slices instead of dying with a fatal "no plan" (elastic
            # membership: partial-success loads are routine under churn).
            if done and key_names and data.ttl is None:
                # metrics fire on last drop (impl_execute_task.rs:97-112):
                # retain the final progress past the invalidation so the
                # consumer's post-stream progress read still sees it
                self._stash_final_progress(key)
                self.registry.invalidate(key)

    def _stage_partition_slices(self, key: TaskKey, data: TaskData) -> None:
        """Register the partitioned output's slices in the table store so
        the worker's staged-byte accounting covers the peer data plane
        (before this, partition slices lived only on the TaskData —
        invisible to `nbytes`/observability). Slices are views of ONE
        regrouped buffer (or the same replicated output object), so
        identity dedup/view registration counts the buffer once. Released
        by the registry-exit hook like shipped slices; a racing eviction
        (query-end sweep vs a late pull) is healed by the re-check."""
        if data.staged_partition_ids:
            # re-partition under a NEW (keys, P) spec: the previous
            # regrouped buffer's ids must not stay pinned/double-counted
            self.table_store.remove(data.staged_partition_ids)
        from datafusion_distributed_tpu_torch.runtime.codec import (
            staging_attribution,
        )

        with staging_attribution(key.query_id):
            staged = [
                self.table_store.put(s) for s in data.partition_slices
            ]
        data.staged_partition_ids = staged
        if self.registry.get(key) is not data:
            # evicted while we staged: nobody will fire the exit hook for
            # these ids anymore — release them here (idempotent)
            self.table_store.remove(staged)
            data.staged_partition_ids = []

    def transfer_partitions(
        self,
        key: TaskKey,
        key_names,
        num_partitions: int,
        part_lo: int,
        part_hi: int,
        per_dest_capacity: int = 0,
        chunk_rows: int = 65536,
        cancel=None,
        wire_compression: str = "auto",
        shm=None,
    ):
        """In-process face of the streaming `TransferPartitions` RPC
        (grpc_worker.py): same partition-chunk sequence as
        `execute_task_partitions` — the planes' byte-identity contract.
        ``wire_compression``/``shm`` are accepted for surface parity and
        ignored: an in-process hop ships references, zero wire bytes."""
        yield from self.execute_task_partitions(
            key, key_names, num_partitions, part_lo, part_hi,
            per_dest_capacity=per_dest_capacity, chunk_rows=chunk_rows,
            cancel=cancel,
        )

    def partitions_remaining(self, key: TaskKey) -> Optional[int]:
        data = self.registry.get(key)
        return None if data is None else data.partitions_remaining

    def release_task(self, key: TaskKey) -> None:
        """Query-end release of a task that may never have been pulled
        (failed query / unpulled virtual partitions); registry eviction
        frees its shipped table slices."""
        self.registry.invalidate(key)

    def _stash_final_progress(self, key: TaskKey) -> None:
        """Bounded retention (a worker serving many queries must not grow
        this forever when nobody reads the final progress back)."""
        if len(self._final_progress) > 256:
            self._final_progress.pop(next(iter(self._final_progress)))
        self._final_progress[key] = self.task_progress(key)

    # -- observability ------------------------------------------------------
    @property
    def peer_capable(self) -> bool:
        """Whether this worker can open streams to peers (the peer data
        plane needs a channel resolver wired at construction)."""
        return self.peer_channels is not None

    def get_info(self) -> dict:
        return {"url": self.url, "version": self.version,
                "tasks_cached": len(self.registry),
                "peer_capable": self.peer_capable,
                # staged-byte accounting (zero-copy data plane): actual
                # staged bytes/entries/views + peak, per worker — the
                # observability service's data-plane surface
                "store": self.table_store.stats()}

    def get_metrics(self) -> dict:
        """This worker's typed-registry snapshot (runtime/telemetry.py
        wire format) — the `get_metrics` RPC body on both transports;
        `ObservabilityService.get_metrics()` merges per-worker snapshots
        under a worker=url label."""
        return self.telemetry.snapshot()

    def task_progress(self, key: TaskKey) -> Optional[dict]:
        data = self.registry.get(key)
        if data is None:
            return self._final_progress.pop(key, None)
        return {
            "plan_added_at": data.plan_added_at,
            "executed_at": data.executed_at,
            "finished_at": data.finished_at,
            **data.metrics,
        }
