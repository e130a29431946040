"""Work-unit feeds: runtime data-feeding of per-task work discovered late.

The reference streams "units of work" (e.g. file addresses discovered during
execution) from the coordinator to worker tasks over the coordinator channel,
chunked by 256, with create/send/receive/process timestamps per unit
(`src/work_unit_feed/`, worker.proto WorkUnit). Only the feed UUID crosses the
wire; the provider object stays coordinator-side.

Host-runtime equivalent: feeds are queues keyed by UUID in a registry. The
coordinator drains the user's provider (any iterable or callable) into the
consuming worker's remote registry in chunks; `WorkUnitScanExec` is the leaf
that blocks on its feed, loads the units (parquet paths or shipped tables)
and pads them into the task's batch. Timestamps are stamped at the same four
lifecycle points as the reference.

Port of the reference `runtime/work_unit_feed.py`. The scan decodes its
units on the host and uploads them, padded, to its device (``device=None``:
the card), as `ParquetScanExec` does; `execute_plan` runs it.
"""

from __future__ import annotations

import queue
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from datafusion_distributed_tpu_torch.ops.table import Table
from datafusion_distributed_tpu_torch.plan.physical import (
    DistributedTaskContext,
    ExecContext,
    ExecutionPlan,
)
from datafusion_distributed_tpu_torch.schema import Schema

CHUNK = 256  # units per message (query_coordinator.rs:44-47)
_DONE = object()


@dataclass
class WorkUnit:
    payload: Any  # e.g. a file path
    created_at: float = field(default_factory=time.time)
    sent_at: Optional[float] = None
    received_at: Optional[float] = None
    processed_at: Optional[float] = None


class WorkUnitFeedRegistry:
    """Coordinator-side: feed id -> provider (iterable or zero-arg callable
    returning one). Registered via SessionContext/DistributedExt-style API."""

    def __init__(self) -> None:
        self.providers: dict[str, Any] = {}

    def register(self, provider) -> str:
        fid = uuid_mod.uuid4().hex
        self.providers[fid] = provider
        return fid

    def units(self, fid: str) -> Iterable[WorkUnit]:
        provider = self.providers[fid]
        items = provider() if callable(provider) else provider
        for payload in items:
            yield WorkUnit(payload)


class RemoteWorkUnitFeedRegistry:
    """Worker-side: per-(feed id, task) queues the coordinator fills
    (impl_coordinator_channel.rs:128-178 demux analogue)."""

    def __init__(self) -> None:
        self.queues: dict[tuple[str, int], "queue.Queue"] = {}

    def queue_for(self, fid: str, task_number: int) -> "queue.Queue":
        # setdefault: the coordinator's feed loop and a task's drain may
        # ask for the same queue at once, and both must get one object
        return self.queues.setdefault((fid, task_number), queue.Queue())

    def drain(self, fid: str, task_number: int,
              timeout: float = 10.0) -> list[WorkUnit]:
        """Block until the feed closes; return all units (bulk execution
        consumes the whole feed before tracing — the 10 s bound mirrors the
        reference's plan-wait timeout)."""
        q = self.queue_for(fid, task_number)
        out: list[WorkUnit] = []
        while True:
            batch = q.get(timeout=timeout)
            if batch is _DONE:
                return out
            now = time.time()
            for u in batch:
                u.received_at = now
                out.append(u)


def stream_feed(
    registry: WorkUnitFeedRegistry,
    remote: RemoteWorkUnitFeedRegistry,
    fid: str,
    task_router: Callable[[WorkUnit, int], int],
    task_count: int,
) -> int:
    """Coordinator loop: chunk units to each task's queue; -> units sent."""
    per_task: dict[int, list[WorkUnit]] = {i: [] for i in range(task_count)}
    sent = 0
    for unit in registry.units(fid):
        t = task_router(unit, task_count)
        unit.sent_at = time.time()
        per_task[t].append(unit)
        sent += 1
        if len(per_task[t]) >= CHUNK:
            remote.queue_for(fid, t).put(per_task[t])
            per_task[t] = []
    for t, batch in per_task.items():
        if batch:
            remote.queue_for(fid, t).put(batch)
        remote.queue_for(fid, t).put(_DONE)
    return sent


class WorkUnitScanExec(ExecutionPlan):
    """Leaf fed by a work-unit feed: units are parquet file paths (the
    reference's work-unit file scan, `test_utils/work_unit_file_scan.rs`)
    loaded at task-load time after the feed closes, onto ``device``."""

    def __init__(self, feed_id: str, schema: Schema, capacity: int,
                 remote_registry: Optional[RemoteWorkUnitFeedRegistry] = None,
                 dictionaries: Optional[dict] = None, device=None):
        super().__init__()
        self.feed_id = feed_id
        self._schema = schema
        self.capacity = capacity
        self.remote_registry = remote_registry
        self.dictionaries = dictionaries
        self.device = device

    def children(self):
        return []

    def with_new_children(self, children):
        assert not children
        return self

    def schema(self):
        return self._schema

    def output_capacity(self):
        return self.capacity

    def load(self, task: DistributedTaskContext) -> Table:
        from datafusion_distributed_tpu_torch.io.parquet import read_parquet

        if self.remote_registry is None:
            raise RuntimeError(
                "WorkUnitScanExec has no remote feed registry attached"
            )
        units = self.remote_registry.drain(self.feed_id, task.task_index)
        now = time.time()
        for u in units:
            u.processed_at = now
        paths = [u.payload for u in units]
        if not paths:
            return Table.empty(self._schema, self.capacity, self.dictionaries,
                               device=self.device)
        return read_parquet(paths, capacity=self.capacity,
                            dictionaries=self.dictionaries,
                            device=self.device)

    def _execute(self, ctx: ExecContext) -> Table:
        return ctx.inputs[self.node_id]

    def display(self):
        return f"WorkUnitScan feed={self.feed_id[:8]} cap={self.capacity}"
