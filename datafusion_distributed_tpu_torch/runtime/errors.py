"""Structured error propagation across the runtime.

The reference round-trips full `DataFusionError` structure over the wire
(`src/protobuf/errors/`, carried in tonic Status details) so
a worker's failure surfaces verbatim at the coordinator. The host-runtime
analogue: every worker exception is wrapped in a WorkerError carrying the
worker url, task key, original type and traceback; `to_dict`/`from_dict`
round-trip it over any transport.

Retryable/fatal taxonomy: the coordinator's fault-tolerant execution layer
(retry + reroute + quarantine, `runtime/coordinator.py`) acts on the ERROR
CLASS, so the class must survive the wire. Infrastructure failures —
transport faults, unreachable/crashed workers, blown deadlines — are
``retryable = True`` subclasses: re-running the same deterministic task on
another worker can succeed. Query-semantic failures (planning errors, an
operator raising on the data itself) stay plain `WorkerError`/`QueryError`
and fail fast: re-executing them burns cluster time to hit the identical
exception N more times.
"""

from __future__ import annotations

import traceback
from typing import Any, Optional


class QueryError(RuntimeError):
    """Base class for engine errors."""


class PlanningError(QueryError):
    pass


class WorkerError(QueryError):
    """An error that happened on (or is attributed to) a worker.

    ``retryable`` is a CLASS property: subclasses representing transient
    infrastructure faults override it to True; query-semantic errors keep
    False so a deterministic failure surfaces on the first attempt.
    """

    retryable = False

    def __init__(
        self,
        message: str,
        worker_url: str = "",
        task: Any = None,
        original_type: str = "",
        original_traceback: str = "",
    ):
        super().__init__(message)
        self.worker_url = worker_url
        self.task = task
        self.original_type = original_type or type(self).__name__
        self.original_traceback = original_traceback

    def __str__(self) -> str:  # coordinator-side rendering
        base = super().__str__()
        loc = f" [worker={self.worker_url}, task={self.task}]" if (
            self.worker_url
        ) else ""
        return f"{base}{loc}"

    def to_dict(self) -> dict:
        t = self.task
        return {
            "message": RuntimeError.__str__(self),
            "worker_url": self.worker_url,
            "task": [t.query_id, t.stage_id, t.task_number] if t else None,
            "original_type": self.original_type,
            "original_traceback": self.original_traceback,
            # the retry/quarantine decision is taken coordinator-side from
            # the CLASS, so it must cross the wire with the error
            "error_class": type(self).__name__,
        }

    @staticmethod
    def from_dict(o: dict) -> "WorkerError":
        from datafusion_distributed_tpu_torch.runtime.worker import TaskKey

        task = TaskKey(*o["task"]) if o.get("task") else None
        cls = _WIRE_CLASSES.get(o.get("error_class", ""), WorkerError)
        return cls(
            o["message"],
            worker_url=o.get("worker_url", ""),
            task=task,
            original_type=o.get("original_type", ""),
            original_traceback=o.get("original_traceback", ""),
        )


class TransportError(WorkerError):
    """A transient wire/transport failure (connection reset, stream broken,
    frame decode): the task itself may be fine — re-dispatching it is safe
    and usually succeeds."""

    retryable = True


class WorkerUnavailableError(WorkerError):
    """The worker cannot be reached or has crashed/restarted (the gRPC
    UNAVAILABLE status; a dead in-memory worker in tests). Retry on a
    DIFFERENT worker; repeated occurrences quarantine the endpoint."""

    retryable = True


class TaskTimeoutError(WorkerError):
    """A dispatch or execution deadline elapsed: a hung worker converts into
    this instead of wedging the whole pool. Retryable — the task reroutes
    while the stuck attempt is abandoned."""

    retryable = True


class TaskCancelledError(QueryError):
    """The per-query cancel event was set (a sibling stage/task failed
    fatally) before this task dispatched or executed. Deliberately NOT a
    WorkerError: cancellation is coordinator-initiated teardown, so it
    must neither count against any worker's health nor bump the
    fatal-failure counters — the ORIGINAL sibling error is the one the
    query surfaces."""

    retryable = False


class QueryPreemptedError(TaskCancelledError):
    """The serving tier SHED this query under memory pressure: a worker
    crossed the hard red-line (resident staged bytes over budget x
    `distributed.worker_memory_redline`) and this was the lowest-priority
    running query. A TaskCancelledError subclass — preemption rides the
    existing cancel path, charges no worker's health and no SLO error
    budget — but typed so callers can distinguish shedding from a user
    cancel: the query's checkpoint frontier is RETAINED and
    `ServingSession.recover()` resumes it byte-identically once pressure
    clears."""

    retryable = False


class PlanIntegrityError(WorkerError):
    """A shipped plan failed its integrity check: the decoded plan's
    structural fingerprint (plan/fingerprint.py) does not match the
    fingerprint stamped at encode time, or a DFTPU_VERIFY_CODEC round-trip
    drifted. Deliberately FATAL (retryable=False): the alternative to this
    error is executing a silently-miscoded plan — wrong results with no
    error — and re-shipping the same bytes would fail identically. Carries
    diagnostic code DFTPU043 (worker post-decode) / DFTPU044 (codec
    round-trip); see plan/verify.py's code registry."""

    retryable = False


#: wire-name -> class, for from_dict reconstruction. Unknown names (an older
#: peer, a user subclass) degrade to plain WorkerError — fail-fast, never
#: spuriously retryable.
_WIRE_CLASSES: dict[str, type] = {
    c.__name__: c
    for c in (WorkerError, TransportError, WorkerUnavailableError,
              TaskTimeoutError, PlanIntegrityError)
}


def is_retryable(exc: BaseException) -> bool:
    """Whether the fault-tolerant executor may re-dispatch after ``exc``."""
    return bool(getattr(exc, "retryable", False))


def wrap_worker_exception(e: Exception, worker_url: str, task) -> WorkerError:
    if isinstance(e, WorkerError):
        # already structured: preserve the (possibly retryable) class and
        # its attribution instead of laundering it into a fatal wrapper
        if not e.worker_url:
            e.worker_url = worker_url
        if e.task is None:
            e.task = task
        return e
    return WorkerError(
        str(e),
        worker_url=worker_url,
        task=task,
        original_type=type(e).__name__,
        original_traceback=traceback.format_exc(),
    )
