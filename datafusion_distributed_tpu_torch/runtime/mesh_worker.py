"""Meshes-as-workers: a Worker that owns a list of devices and runs a SPAN of
a stage's tasks from ONE shipped plan (port of the reference
`runtime/mesh_worker.py`).

A stage with T tasks over K such workers of width W is dispatched as
contiguous spans: worker k runs tasks [kW, (k+1)W) from one
span-specialized plan, shipped, decoded and checked once for its W tasks.
Between workers the host planes (peer pulls, coordinator streams) move
bytes per task, unchanged: a consumer cannot tell a mesh worker from a
thread-pool worker.

The reference runs a span as one SPMD program (`shard_map` over a jax
`Mesh`, local task i on device i). Stage plans hold no exchange (exchanges
end stages), so that program has no collective: its parallelism is pure
data parallelism. Here the W local tasks of the decoded plan run one after
another, local task i on ``devices[i]`` with its inputs copied there. A
device may be listed more than once (a jax `Mesh` cannot hold one twice):
the tasks that share a device run on it one after another, as every task
does on one card. What the reference's program gives each task is kept: a
leaf loads local index i with the global task count, the W loaded slices
are repadded to one capacity and one dictionary a column, each task
executes as index 0 of the global count, and every task's overflow flags
reach the host in one transfer. Any stray exchange raises.

Unlike the reference, a worker drops a span's outputs as soon as the last
of its tasks has left the registry (every sibling served or released): the
reference keeps the last 16 spans of device outputs a worker until later
spans push them out. No result changes (no task of a span is re-dispatched
alone, so nothing reads a span whose tasks are gone); the card keeps no
stage outputs between queries.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Table,
    apply_lut,
    concat_tables,
    move,
    unify_dictionaries,
)
from datafusion_distributed_tpu_torch.plan.exchanges import IsolatedArmExec
from datafusion_distributed_tpu_torch.plan.physical import (
    _PRECISION_TAG,
    DistributedTaskContext,
    ExecContext,
    ExecutionPlan,
    MemoryScanExec,
    ParquetScanExec,
    _dicts_of,
    collect_leaves,
)
from datafusion_distributed_tpu_torch.runtime.worker import (
    TaskData,
    TaskKey,
    Worker,
)

#: span states a worker keeps at most (the reference's bound)
MAX_SPANS = 16


def span_specializable(plan: ExecutionPlan) -> bool:
    """Span dispatch covers the regular stage shapes; plans whose leaves
    depend on the GLOBAL task index in ways a local re-slice cannot express
    (isolated union arms, work-unit feeds) fall back to per-task dispatch."""
    from datafusion_distributed_tpu_torch.runtime.work_unit_feed import (
        WorkUnitScanExec,
    )

    return not plan.collect(
        lambda n: isinstance(n, (IsolatedArmExec, WorkUnitScanExec))
    )


def span_specialized(plan: ExecutionPlan, lo: int, hi: int) -> ExecutionPlan:
    """Re-slice a stage plan's leaves to tasks [lo, hi), re-indexed to
    local positions 0..hi-lo: the span analogue of `_task_specialized`."""
    from datafusion_distributed_tpu_torch.runtime.peer import (
        PeerShuffleScanExec,
    )

    def walk(node: ExecutionPlan) -> ExecutionPlan:
        if isinstance(node, PeerShuffleScanExec):
            if node.pinned_task is not None or node.pull_all:
                return node
            if node.replicated:
                # broadcast: wrap virtual-partition ids so a span wider
                # than the planned fan-out still pulls a FULL copy per
                # local task (an out-of-range local index would read an
                # empty build side and silently drop join matches)
                p = max(node.num_partitions, 1)
                pulls = [node.pulls_per_task[(lo + i) % p]
                         for i in range(hi - lo)]
            else:
                pulls = node.pulls_per_task[lo:hi]
            return PeerShuffleScanExec(
                pulls, node.key_names, node.num_partitions,
                node.per_dest_capacity, node._schema, node.dictionaries,
                replicated=node.replicated, budget_bytes=node.budget_bytes,
                chunk_rows=node.chunk_rows,
                capacity_hint=node.capacity_hint, device=node.device,
            )
        if isinstance(node, MemoryScanExec) and not node.pinned and (
            not node.replicated
        ):
            sub = node.tasks[lo:hi]
            if not sub and node.tasks:
                # span entirely past this scan's slices (sibling feeds had
                # more): per-task dispatch would read empty via the
                # tasks[0] reference; give the span the same empty table
                ref = node.tasks[0]
                sub = [Table.empty(node.schema(), ref.capacity,
                                   _dicts_of(ref), device=ref.device)]
            return MemoryScanExec(sub, node.schema())
        if isinstance(node, ParquetScanExec):
            return ParquetScanExec(
                node.file_groups[lo:hi], node.schema(), node.capacity,
                projection=node.projection, dictionaries=node.dictionaries,
                device=node.device,
            )
        children = [walk(c) for c in node.children()]
        return node.with_new_children(children) if children else node

    return walk(plan)


def execute_stage_span(
    plan: ExecutionPlan,
    devices,
    span_width: int,
    task_count: int,
    config: Optional[dict] = None,
) -> list[Table]:
    """Execute a span-specialized stage plan: local task i of the span runs
    on ``devices[i]`` -> the ``span_width`` per-task output Tables.

    Every leaf loads local index i with the global ``task_count``, and the
    span's slices of each leaf are repadded to one capacity and one
    dictionary a column (`_repad_uniform`: the reference stacks them over
    its mesh axis, and the outputs' capacities and codes follow from
    that). Each task then executes as task 0 of ``task_count``, as every
    device of the reference's program sees it. The plan runs in its
    prepared form, as `execute_plan` runs a task's plan. Every task's
    capacity and precision flags come to the host in one transfer and
    raise with the reference's two messages: the session's retry loop
    keys on "overflow" in the first."""
    from datafusion_distributed_tpu_torch.plan.fingerprint import (
        bound_params,
        prepare_plan,
    )

    devices = [torch.device(d) for d in devices]
    prep = prepare_plan(plan)
    target = prep.plan
    loaded = {
        leaf.node_id: _repad_uniform([
            leaf.load(DistributedTaskContext(i, task_count))
            for i in range(span_width)
        ])
        for leaf in collect_leaves(target) if hasattr(leaf, "load")
    }
    # the wire trace context is coordinator plumbing, not plan config
    exec_config = {k: v for k, v in (config or {}).items()
                   if k != "trace_ctx"}
    outs: list[Table] = []
    ctxs: list[ExecContext] = []
    with bound_params(prep.param_arrays()):
        for i in range(span_width):
            dev = devices[i]
            ctx = ExecContext(
                task=DistributedTaskContext(0, task_count),
                inputs={nid: move(tables[i], dev)
                        for nid, tables in loaded.items()},
                config=dict(exec_config),
            )
            on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                       else contextlib.nullcontext())
            with on_card:
                outs.append(target.execute(ctx))
            ctxs.append(ctx)
    names = [[n for n, _ in c.overflow_flags] for c in ctxs]
    home = outs[0].device
    fetched = torch.stack([
        v.to(device=home, dtype=torch.int64)
        for v in [f for c in ctxs for _, f in c.overflow_flags]
        + [o.num_rows for o in outs]
    ]).tolist()  # the span's one device-to-host transfer
    for o, n in zip(outs, fetched[len(fetched) - span_width:]):
        o._host_rows = n
    raised: list[str] = []
    pos = 0
    for task_names in names:
        for j, name in enumerate(task_names):
            if fetched[pos + j] and name not in raised:
                raised.append(name)
        pos += len(task_names)
    cap = [n for n in raised if not n.startswith(_PRECISION_TAG)]
    prec = [n for n in raised if n.startswith(_PRECISION_TAG)]
    if cap:
        raise RuntimeError(
            f"hash table overflow in span program (nodes: {cap}); "
            "re-plan with more slots"
        )
    if prec:
        raise RuntimeError(
            "int32 accumulator range exceeded in span program "
            f"(nodes: {prec}); run with DFTPU_PRECISION=x64"
        )
    return outs


def _repad_uniform(tables: list[Table]) -> list[Table]:
    """The span's slices of one leaf with one capacity, one Dictionary per
    string column and the same validity presence, as the reference's stack
    over its mesh axis needs them: peer pulls concat to exact row counts,
    so capacities differ by a few chunks; pulled slices carry their
    producers' dictionaries, and empty fallbacks may carry none."""
    cap = max(t.capacity for t in tables)
    tables = [
        t if t.capacity == cap else concat_tables([t], capacity=cap)
        for t in tables
    ]
    names = tables[0].names
    new_cols: list[list] = [[None] * len(names) for _ in tables]
    for ci in range(len(names)):
        cols = [t.columns[ci] for t in tables]
        d, luts = unify_dictionaries([c.dictionary for c in cols])
        has_validity = any(c.validity is not None for c in cols)
        for ti, c in enumerate(cols):
            data = c.data
            if luts[ti] is not None:
                data = apply_lut(luts[ti], data).to(data.dtype)
            validity = c.validity
            if has_validity and validity is None:
                validity = torch.ones(data.shape, dtype=torch.bool,
                                      device=data.device)
            new_cols[ti][ci] = Column(
                data, validity, c.dtype,
                d if d is not None else c.dictionary,
            )
    out = []
    for t, cols in zip(tables, new_cols):
        r = Table(names, tuple(cols), t.num_rows)
        n = getattr(t, "_host_rows", None)
        if n is not None:
            r._host_rows = n
        out.append(r)
    return out


@dataclass
class _SpanState:
    """Shared state of one shipped span: the plan runs ONCE; every task key
    of the span serves its slot from the kept outputs. ``live``: the local
    indices whose task entries are still registered."""

    key: tuple
    plan: ExecutionPlan
    lo: int
    hi: int
    task_count: int
    outputs: Optional[list] = None
    lock: threading.Lock = field(default_factory=threading.Lock)
    config: dict = field(default_factory=dict)
    live: set = field(default_factory=set)


class MeshWorker(Worker):
    """A Worker whose executor is a list of devices: spans of stage tasks
    run from one decoded plan (`execute_stage_span`); the per-task service
    surface (execute_task / partition streams / peer pulls) is inherited
    unchanged."""

    def __init__(self, url: str, devices, ttl_seconds: float = 600.0,
                 version: str = "0.1.0", peer_channels=None):
        self.devices = [torch.device(d) for d in devices]
        super().__init__(url, ttl_seconds, version,
                         peer_channels=peer_channels,
                         device=self.devices[0])
        self.mesh_width = len(self.devices)
        self._spans_lock = threading.Lock()
        # (query_id, stage_id, lo) -> _SpanState; at most MAX_SPANS
        self._spans: dict = {}  # guarded-by: _spans_lock
        self.spans_run = 0  # guarded-by: _spans_lock

    def _on_task_evict(self, data: TaskData) -> None:
        """Release the task's slices; once the span's last task has left
        the registry, drop the span and its outputs."""
        super()._on_task_evict(data)
        span = getattr(data, "span", None)
        if span is None:
            return
        state, local_idx = span
        with self._spans_lock:
            state.live.discard(local_idx)
            if not state.live and self._spans.get(state.key) is state:
                del self._spans[state.key]

    # -- control plane ------------------------------------------------------
    def set_stage_plan(self, query_id: str, stage_id: int, lo: int, hi: int,
                       task_count: int, plan_obj: dict,
                       config: Optional[dict] = None,
                       headers: Optional[dict] = None,
                       ttl: Optional[float] = None) -> None:
        """Ship ONE span-specialized plan covering tasks [lo, hi); registers
        a TaskData per task so the inherited data-plane surfaces work."""
        from datafusion_distributed_tpu_torch.runtime.codec import (
            collect_table_ids,
            decode_plan,
        )
        from datafusion_distributed_tpu_torch.runtime.errors import (
            wrap_worker_exception,
        )
        from datafusion_distributed_tpu_torch.runtime.peer import (
            attach_peer_channels,
        )
        from datafusion_distributed_tpu_torch.runtime.worker import (
            _check_decoded_plan,
        )

        key0 = TaskKey(query_id, stage_id, lo)
        try:
            plan = decode_plan(plan_obj, self.table_store)
            # the same post-decode integrity/verify gate as set_plan: a
            # span plan serves every task of its span, so a mis-decoded
            # one is exactly the wrong-binding hazard
            _check_decoded_plan(plan, plan_obj, self.url, key0,
                                config=config)
            if self.on_plan is not None:
                plan = self.on_plan(plan, key0)
        except Exception as e:
            raise wrap_worker_exception(e, self.url, key0) from e
        attach_peer_channels(plan, self.peer_channels, self)
        skey = (query_id, stage_id, lo)
        state = _SpanState(key=skey, plan=plan, lo=lo, hi=hi,
                           task_count=task_count, config=dict(config or {}),
                           live=set(range(hi - lo)))
        with self._spans_lock:
            # bounded retention: span outputs are device buffers
            while len(self._spans) >= MAX_SPANS:
                self._spans.pop(next(iter(self._spans)))
            self._spans[skey] = state
        tids = collect_table_ids(plan_obj)
        for i in range(lo, hi):
            data = TaskData(
                key=TaskKey(query_id, stage_id, i), plan=plan,
                task_count=task_count, config=dict(config or {}),
                headers=dict(headers or {}),
                shipped_table_ids=tids if i == lo else [],
                ttl=ttl,
            )
            data.span = (state, i - lo)  # type: ignore[attr-defined]
            self.registry.put(data)

    # -- data plane ---------------------------------------------------------
    def execute_task(self, key: TaskKey) -> Table:
        data = self.registry.get(key)
        span = getattr(data, "span", None) if data is not None else None
        if span is None:
            return super().execute_task(key)
        state, local_idx = span
        with state.lock:
            if state.outputs is None:
                data.executed_at = time.time()
                # always at full width: a short span's trailing positions
                # load empty slices (the reference's short coalesce groups
                # yield empty streams the same way)
                state.outputs = execute_stage_span(
                    state.plan, self.devices, self.mesh_width,
                    state.task_count, config=state.config,
                )
                data.finished_at = time.time()
                with self._spans_lock:
                    self.spans_run += 1
        out = state.outputs[local_idx]
        data.metrics.setdefault("rows_out", out._host_rows)
        data.metrics.setdefault("span", [state.lo, state.hi])
        return out


class InMemoryMeshCluster:
    """K mesh workers × W devices each over the process's device list: the
    meshes-as-workers fixture. ``devices`` may repeat a device (8 tasks of
    two workers on one card: ``[torch.device("cuda")] * 8``); the default
    is every card of the process, one a task."""

    def __init__(self, num_workers: int, devices_per_worker: int,
                 devices=None, ttl_seconds: float = 600.0):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = list(devices)
        need = num_workers * devices_per_worker
        if len(devices) < need:
            raise ValueError(
                f"{need} devices needed, {len(devices)} available"
            )
        self.workers = {}
        for k in range(num_workers):
            url = f"mesh://worker-{k}"
            self.workers[url] = MeshWorker(
                url,
                devices[k * devices_per_worker:(k + 1) * devices_per_worker],
                ttl_seconds=ttl_seconds,
            )
        for w in self.workers.values():
            w.peer_channels = self

    def get_urls(self):
        return list(self.workers.keys())

    def get_worker(self, url: str):
        return self.workers[url]
