"""Peer-to-peer data plane: consumer tasks pull stage inputs directly from
producer workers.

In the reference, a consumer *task running on a worker* opens one stream per
producer task carrying a partition range, demuxed under a shared byte budget
(`src/worker/worker_connection_pool.rs:62-142,243-308`); the
coordinator only ships plans and flips boundaries pending->ready
(`src/coordinator/prepare_static_plan.rs:10-56`). This module
is that architecture for the host tier: `PeerShuffleScanExec` is the
consumer-stage leaf a materialized exchange becomes — at load time it pulls
its partition range from every producer worker over the partition-range
multiplex surface (`Worker.execute_task_partitions` /
`GrpcWorkerClient.execute_task_partitions`), budgeted and demuxed by
`runtime/streams.py` ON THE CONSUMER WORKER. Row bytes never touch the
coordinator.

One node covers all three boundary shapes via its pull specs
(per consumer task j, a list of (producer TaskKey, url, part_lo, part_hi)):

  shuffle    pulls[j] = [(k_i, u_i, j, j+1) for every producer i],
             num_partitions = t_consumer, key_names = hash keys
  broadcast  same shape with key_names = [] — the producer serves its FULL
             output under every virtual partition id (the reference's
             NetworkBroadcastExec virtual-partition scheme, `broadcast.rs`)
  coalesce   pulls[j] = [(k_i, u_i, 0, 1) for i in consumer j's contiguous
  (N:M)      producer group], num_partitions = 1, key_names = []
             (`network_coalesce.rs` div_ceil group arithmetic)

The same-worker pull short-circuits to a direct in-process call
(the reference's LocalWorkerConnection, `worker_connection_pool.rs:48-60`).
"""

from __future__ import annotations

from typing import Optional, Sequence

from datafusion_distributed_tpu_torch.ops.table import Table, concat_tables
from datafusion_distributed_tpu_torch.plan.physical import (
    DistributedTaskContext,
    ExecContext,
    ExecutionPlan,
)
from datafusion_distributed_tpu_torch.schema import Schema


class PeerShuffleScanExec(ExecutionPlan):
    """Consumer-side leaf of a peer-to-peer exchange boundary.

    ``pulls_per_task[j]`` lists this boundary's pull specs for consumer task
    j: ``(producer_key_obj, producer_url, part_lo, part_hi)``. The worker
    executing the consumer plan attaches its channel resolver at plan-set
    time (`Worker.set_plan` -> `attach_peer_channels`); the coordinator never
    sees the pulled rows.
    """

    def __init__(
        self,
        pulls_per_task: Sequence[Sequence[tuple]],
        key_names: Sequence[str],
        num_partitions: int,
        per_dest_capacity: int,
        schema: Schema,
        dictionaries: Optional[dict] = None,
        replicated: bool = False,
        pinned_task: Optional[int] = None,
        pull_all: bool = False,
        budget_bytes: int = 64 << 20,
        chunk_rows: int = 65536,
        capacity_hint: int = 0,
        device=None,
    ):
        super().__init__()
        # the device of an empty result (pulled chunks keep their own)
        self.device = device
        self.pulls_per_task = [list(p) for p in pulls_per_task]
        self.key_names = list(key_names)
        self.num_partitions = int(num_partitions)
        self.per_dest_capacity = int(per_dest_capacity)
        self._schema = schema
        self.dictionaries = dictionaries
        # replicated: every consumer task receives the complete logical
        # data (broadcast boundary) — the task-count policy treats this
        # like a replicated MemoryScan (a stage reading only replicated
        # inputs runs once)
        self.replicated = replicated
        # task specialization pins the executing task's spec list (the
        # analogue of MemoryScan.pinned)
        self.pinned_task = pinned_task
        # an IsolatedArm's sole-consumer semantics: pull EVERY task's specs
        self.pull_all = pull_all
        self.budget_bytes = int(budget_bytes)
        self.chunk_rows = int(chunk_rows)
        self.capacity_hint = int(capacity_hint)
        # attached by the executing worker (never serialized):
        self._channels = None  # ChannelResolver-like: get_worker(url)
        self._local_worker = None  # the executing Worker, for self-bypass

    def pinned_copy(self, task_number: int,
                    pull_all: bool = False) -> "PeerShuffleScanExec":
        """Task-specialized copy (the DistributedLeaf variant-strip
        analogue): the shipped node knows which consumer task it is.
        ``pull_all`` marks an IsolatedArm's sole-consumer pull."""
        return PeerShuffleScanExec(
            self.pulls_per_task, self.key_names, self.num_partitions,
            self.per_dest_capacity, self._schema, self.dictionaries,
            replicated=self.replicated, pinned_task=task_number,
            pull_all=pull_all, budget_bytes=self.budget_bytes,
            chunk_rows=self.chunk_rows, capacity_hint=self.capacity_hint,
            device=self.device,
        )

    # -- tree ---------------------------------------------------------------
    def children(self):
        return []

    def with_new_children(self, children):
        assert not children
        return self

    def schema(self):
        return self._schema

    def output_capacity(self):
        if self.capacity_hint:
            return self.capacity_hint
        n_prod = max((len(p) for p in self.pulls_per_task), default=1)
        return max(n_prod * self.per_dest_capacity, 8)

    # -- data plane ---------------------------------------------------------
    def _specs_for(self, task: DistributedTaskContext) -> list[tuple]:
        if self.pull_all:
            out: list[tuple] = []
            seen = set()
            for specs in self.pulls_per_task:
                for s in specs:
                    marker = (tuple(s[0]), s[1], s[2], s[3])
                    if marker not in seen:
                        seen.add(marker)
                        out.append(s)
            return out
        idx = self.pinned_task if self.pinned_task is not None else task.task_index
        if idx >= len(self.pulls_per_task):
            return []
        return self.pulls_per_task[idx]

    def _resolve(self, url: str):
        lw = self._local_worker
        if lw is not None and getattr(lw, "url", None) == url:
            return lw  # LocalWorkerConnection bypass: no serialization
        if self._channels is None:
            raise RuntimeError(
                "PeerShuffleScanExec has no peer channel resolver attached; "
                "construct the Worker with peer_channels= (or use a cluster "
                "fixture that wires it)"
            )
        try:
            return self._channels.get_worker(url)
        except Exception as e:
            # a producer that left the membership view mid-query: surface
            # as the retryable taxonomy with the endpoint attributed, so
            # the consumer-side failure reads as infrastructure, not data
            from datafusion_distributed_tpu_torch.runtime.errors import (
                WorkerUnavailableError,
            )

            raise WorkerUnavailableError(
                f"peer producer {url} is not resolvable: {e}",
                worker_url=url,
                original_type=type(e).__name__,
            ) from e

    def load(self, task: DistributedTaskContext) -> Table:
        """Pull this task's partition range from every producer: one puller
        per producer stream, budgeted + cancellable via
        `streams.stream_stage_chunks` — the consumer-side connection pool."""
        from datafusion_distributed_tpu_torch.runtime.streams import (
            stream_stage_chunks,
        )
        from datafusion_distributed_tpu_torch.runtime.worker import TaskKey

        specs = self._specs_for(task)
        if not specs:
            return Table.empty(self._schema, 8, self.dictionaries,
                               device=self.device)

        def make_puller(spec):
            key_obj, url, lo, hi = spec

            def pull(cancel):
                worker = self._resolve(url)
                key = TaskKey(key_obj[0], key_obj[1], key_obj[2])
                for _p, piece, est in worker.execute_task_partitions(
                    key, self.key_names, self.num_partitions, lo, hi,
                    per_dest_capacity=self.per_dest_capacity,
                    chunk_rows=self.chunk_rows, cancel=cancel,
                ):
                    yield piece, est

            return pull

        # producer backpressure (enforced worker memory budget): while
        # the CONSUMER worker's store is over budget, pulls trickle
        # instead of piling pulled chunks onto an already-pressured host
        local_store = getattr(self._local_worker, "table_store", None)
        pressure = (
            local_store.under_pressure
            if local_store is not None
            and hasattr(local_store, "under_pressure") else None
        )
        chunks, stats = stream_stage_chunks(
            [make_puller(s) for s in specs], self.budget_bytes,
            pressure=pressure,
        )
        flat = [c for per in chunks for c in per]
        self.last_pull_stats = {
            "bytes_pulled": stats.bytes_streamed,
            "rows": stats.rows,
            "producers": len(specs),
            "peak_in_flight": stats.peak_in_flight,
            # abandoned puller threads (hung producers) — counted by the
            # stream machinery into telemetry/eventlog; surfaced here so
            # a consumer-side pull's leak is visible per boundary too
            "pullers_leaked": stats.extra.get("pullers_leaked", 0),
        }
        if not flat:
            return Table.empty(self._schema, 8, self.dictionaries,
                               device=self.device)
        cap = max(-(-stats.rows // 8) * 8, 8)
        return concat_tables(flat, capacity=cap)

    def _execute(self, ctx: ExecContext) -> Table:
        return ctx.inputs[self.node_id]

    def display(self):
        n_prod = max((len(p) for p in self.pulls_per_task), default=0)
        mode = ("broadcast" if self.replicated
                else ("gather" if not self.key_names else "shuffle"))
        pin = f" task={self.pinned_task}" if self.pinned_task is not None else ""
        return (
            f"PeerShuffleScan mode={mode} producers={n_prod} "
            f"partitions={self.num_partitions}{pin}"
        )


def attach_peer_channels(plan: ExecutionPlan, channels, local_worker) -> None:
    """Wire the executing worker's channel resolver (and itself, for the
    same-worker bypass) into every peer scan of a freshly decoded plan."""
    for node in plan.collect(lambda n: isinstance(n, PeerShuffleScanExec)):
        node._channels = channels
        node._local_worker = local_worker


def shuffle_pulls(producers: Sequence[tuple], t_consumer: int) -> list[list]:
    """pulls[j] = partition j from every producer (hash shuffle / broadcast
    virtual partitions)."""
    return [
        [(key, url, j, j + 1) for key, url in producers]
        for j in range(t_consumer)
    ]


def group_pulls(producers: Sequence[tuple], t_consumer: int) -> list[list]:
    """pulls[j] = full output (partition 0 of 1) of consumer j's contiguous
    div_ceil producer group (`network_coalesce.rs:45-68`)."""
    n = len(producers)
    g = -(-n // max(t_consumer, 1))
    return [
        [(key, url, 0, 1) for key, url in producers[j * g:(j + 1) * g]]
        for j in range(t_consumer)
    ]
