"""Exchange operators: the stage-boundary nodes of the distributed plan
(port of the reference `plan/exchanges.py`).

    ShuffleExchangeExec       hash N:M re-shard on key columns
    RangeShuffleExchangeExec  range re-shard on a sort key (sample sort)
    PartitionReplicatedExec   replicated -> partitioned, no communication
    CoalesceExchangeExec      N -> 1 (or N:M) concatenation
    BroadcastExchangeExec     replicate to every task
    IsolatedArmExec           one UNION arm computed on one assigned task

A boundary splits the plan into stages (producer below, consumer above).
The planner (planner/distributed.py) places them, sizes them and stamps
their stage ids; the verifier checks them. Their capacities, rebuilds and
display strings equal the reference's.

An exchange runs inside a multi-task run (runtime/mesh_executor.py). In
the one-process run (`execute_tasks`) the task contexts share one exchange
cache: the first task to reach it runs its child for every producer task,
routes the rows with the data plane (parallel/exchange.py), and caches the
consumer tables (a shuffle's as a sequence that gathers each when it is
taken); each task then takes its own. In an SPMD run (`execute_on_mesh`,
the context's config carries the `TaskMesh`) each rank runs its own
producer subtree and the exchange's collective (the `*_spmd` functions),
memoized in its own cache. Outside such a run an exchange raises. A
one-task staged plan has no exchange left (`_prepare` elides every 1:1
boundary).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_distributed_tpu_torch.ops.table import Column, Dictionary, Table
from datafusion_distributed_tpu_torch.parallel.exchange import (
    _broadcast_object,
    broadcast_exchange,
    broadcast_exchange_spmd,
    coalesce_exchange,
    coalesce_exchange_spmd,
    group_coalesce_exchange,
    group_coalesce_exchange_spmd,
    live_prefix,
    range_shuffle_exchange,
    range_shuffle_exchange_spmd,
    shuffle_exchange,
    shuffle_exchange_spmd,
)
from datafusion_distributed_tpu_torch.plan.physical import (
    ExecContext,
    ExecutionPlan,
)

#: producer tables of at least this many padded rows are cut to their live
#: rows before routing (smaller ones are kept whole: no host sync)
PREFIX_MIN_ROWS = 1 << 16


class ExchangeExec(ExecutionPlan):
    """Common base: a stage boundary with a producer child."""

    is_exchange = True

    def __init__(self, child: ExecutionPlan, num_tasks: int):
        super().__init__()
        self.child = child
        self.num_tasks = num_tasks
        # stamped by the prepare pass
        self.stage_id: Optional[int] = None
        # producer-stage task count when it differs from the consumer side
        # (stamped by the task-count lattice; None = uniform num_tasks).
        # Coalesce's num_tasks already IS the producer count.
        self.producer_tasks: Optional[int] = None
        # downstream LIMIT's fetch+skip (stamped by the planner's limit
        # rule): a streaming data plane may stop pulling once this many
        # rows arrived
        self.consumer_fetch: Optional[int] = None
        # planner-predicted bytes crossing this boundary (stamped by the
        # partial-aggregate push-down); annotates the plan, never a
        # fingerprint input
        self.predicted_exchange_bytes: Optional[int] = None

    def children(self):
        return [self.child]

    def schema(self):
        return self.child.schema()

    def execute(self, ctx: ExecContext):
        """This task's consumer table. The exchange routes once per run,
        for every task (see ExecContext.exchange_cache); each task records
        its overflow flag once, however often the tree reaches it."""
        mesh = ctx.config.get("mesh")
        if mesh is not None:
            return self._execute_spmd(ctx, mesh)
        routed = ctx.exchange_cache.get(self.node_id)
        if routed is None:
            if not ctx.peers:
                raise RuntimeError(
                    f"{type(self).__name__} executed outside a multi-task "
                    "run: a staged plan with exchanges runs through "
                    "runtime/mesh_executor.execute_tasks"
                )
            tables, overflow = self._route(*self._producers(ctx.peers))
            routed = (tables, overflow, set())
            ctx.exchange_cache[self.node_id] = routed
        tables, overflow, taken = routed
        task = ctx.task.task_index
        if task not in taken:
            taken.add(task)
            if overflow is not None:
                ctx.record_overflow(self, overflow)
        return tables[task]

    def _execute_spmd(self, ctx: ExecContext, mesh) -> Table:
        """One rank of an SPMD run: this rank's producer table through the
        exchange's collective, once per run; its overflow flag and (as the
        reference's mesh records it) its output_rows metric recorded
        once."""
        routed = ctx.exchange_cache.get(self.node_id)
        if routed is None:
            if self.num_tasks != mesh.size:
                raise RuntimeError(
                    f"{self.display()} over {self.num_tasks} tasks in an "
                    f"SPMD run of {mesh.size} ranks")
            routed = self._route_spmd(
                self.child.execute(ctx), mesh,
                ctx.config["exchange_positions"][self.node_id],
                ctx.config["exchange_labels"])
            ctx.exchange_cache[self.node_id] = routed
            if routed[1] is not None:
                ctx.record_overflow(self, routed[1])
            ctx.record_metric(self, "output_rows", routed[0].num_rows)
        # the memo goes once the tree has reached the exchange as often as
        # it will: a consumer table is padded to its full capacity, and
        # holding every exchange's for the whole run does not fit
        left = ctx.config["exchange_reaches"]
        left[self.node_id] -= 1
        if left[self.node_id] <= 0:
            del ctx.exchange_cache[self.node_id]
        return routed[0]

    def _route_spmd(self, table: Table, mesh, position: int,
                    labels: list) -> tuple:
        """This rank's producer table -> (its consumer table, the overflow
        flag or None); ``position`` is the exchange's place among the
        plan's exchanges, ``labels`` theirs by place."""
        raise NotImplementedError

    def _producers(self, peers: list) -> tuple:
        """Every producer task's table, in task order, and their padded
        capacity. A large one is cut to its live rows as soon as it is made
        (`live_prefix`, one host sync), so that the T padded tables never
        exist at once; the data plane gets their capacity beside them."""
        out = []
        for c in peers:
            t = self.child.execute(c)
            out.append(live_prefix(t)
                       if t.capacity >= PREFIX_MIN_ROWS and self._cut()
                       else t)
            capacity = t.capacity
        return out, capacity

    def _cut(self) -> bool:
        """Whether the route reads only the producers' live rows."""
        return True

    def _route(self, producers: list, capacity: int) -> tuple:
        """The producer tasks' tables (or their live rows) and their padded
        capacity -> (the consumer tasks' tables, as a sequence in task
        order, and the overflow flag or None)."""
        raise NotImplementedError


def _stamped(src: ExchangeExec, n: ExchangeExec) -> ExchangeExec:
    """``n`` with ``src``'s planner stamps (a rebuild keeps them)."""
    n.stage_id = src.stage_id
    n.producer_tasks = src.producer_tasks
    n.consumer_fetch = src.consumer_fetch
    return n


class ShuffleExchangeExec(ExchangeExec):
    """Hash shuffle: rows re-shard across tasks by key hash."""

    def __init__(
        self,
        child: ExecutionPlan,
        key_names: Sequence[str],
        num_tasks: int,
        per_dest_capacity: int,
    ):
        super().__init__(child, num_tasks)
        self.key_names = list(key_names)
        # sizing policy lives in planner/distributed.py _mk_shuffle
        self.per_dest_capacity = per_dest_capacity

    def with_new_children(self, children):
        n = _stamped(self, ShuffleExchangeExec(
            children[0], self.key_names, self.num_tasks,
            self.per_dest_capacity,
        ))
        n.predicted_exchange_bytes = self.predicted_exchange_bytes
        return n

    def output_capacity(self):
        # a consumer task receives <= per_dest_capacity from EACH producer
        t_prod = (self.producer_tasks if self.producer_tasks is not None
                  else self.num_tasks)
        return t_prod * self.per_dest_capacity

    def _route(self, producers, capacity):
        return shuffle_exchange(producers, self.key_names, self.num_tasks,
                                self.per_dest_capacity, capacity)

    def _route_spmd(self, table, mesh, position, labels):
        return shuffle_exchange_spmd(table, self.key_names, mesh,
                                     self.per_dest_capacity, position, labels)

    def display(self):
        return (
            f"ShuffleExchange keys=[{', '.join(self.key_names)}] "
            f"tasks={self.num_tasks} per_dest_cap={self.per_dest_capacity}"
        )


class RangeShuffleExchangeExec(ExchangeExec):
    """Range shuffle on a composite SORT key (distributed sample sort):
    after it, task i's rows all order before task i+1's, so a local sort
    per task and an order-preserving coalesce give the global order."""

    def __init__(
        self,
        child: ExecutionPlan,
        sort_keys,  # list[ops.sort.SortKey]
        num_tasks: int,
        per_dest_capacity: int,
    ):
        super().__init__(child, num_tasks)
        self.sort_keys = list(sort_keys)
        self.per_dest_capacity = per_dest_capacity

    def with_new_children(self, children):
        return _stamped(self, RangeShuffleExchangeExec(
            children[0], self.sort_keys, self.num_tasks,
            self.per_dest_capacity,
        ))

    def output_capacity(self):
        t_prod = (self.producer_tasks if self.producer_tasks is not None
                  else self.num_tasks)
        return t_prod * self.per_dest_capacity

    def _route(self, producers, capacity):
        return range_shuffle_exchange(producers, self.sort_keys,
                                      self.num_tasks, self.per_dest_capacity,
                                      capacity=capacity)

    def _route_spmd(self, table, mesh, position, labels):
        return range_shuffle_exchange_spmd(
            table, self.sort_keys, mesh, self.per_dest_capacity,
            position=position, labels=labels)

    def display(self):
        keys = ", ".join(
            f"{k.name}{'' if k.ascending else ' DESC'}" for k in self.sort_keys
        )
        return (
            f"RangeShuffleExchange keys=[{keys}] tasks={self.num_tasks} "
            f"per_dest_cap={self.per_dest_capacity}"
        )


class PartitionReplicatedExec(ExchangeExec):
    """REPLICATED -> PARTITIONED: every task keeps the row-index slice
    ``row % num_tasks == task`` of its identical copy. No communication."""

    def with_new_children(self, children):
        return _stamped(self, PartitionReplicatedExec(children[0],
                                                      self.num_tasks))

    def output_capacity(self):
        return self.child.output_capacity()

    def _cut(self):
        return False  # each task keeps rows of its own whole table

    def _route(self, producers, capacity):
        return [self._keep(t, task)
                for task, t in enumerate(producers)], None

    def _route_spmd(self, table, mesh, position, labels):
        return self._keep(table, mesh.rank), None

    def _keep(self, table: Table, task: int) -> Table:
        idx = torch.arange(table.capacity, device=table.device)
        return table.compact((idx % self.num_tasks) == task)

    def display(self):
        return f"PartitionReplicated tasks={self.num_tasks}"


class CoalesceExchangeExec(ExchangeExec):
    """Producer tasks' rows coalesced for the consumer stage.

    ``num_consumers == 1`` (default): gathered into one logical table,
    replicated on every task. ``num_consumers = M > 1``: N:M — consumer
    task j holds the contiguous producer group [j*g, (j+1)*g),
    g = ceil(N / M)."""

    def __init__(self, child: ExecutionPlan, num_tasks: int,
                 num_consumers: int = 1):
        super().__init__(child, num_tasks)
        self.num_consumers = num_consumers

    def with_new_children(self, children):
        return _stamped(self, CoalesceExchangeExec(
            children[0], self.num_tasks, self.num_consumers
        ))

    def output_capacity(self):
        if self.num_consumers > 1:
            g = -(-self.num_tasks // self.num_consumers)
            return self.child.output_capacity() * g
        return self.child.output_capacity() * self.num_tasks

    def _cut(self):
        # an N:M coalesce with one producer a consumer keeps each whole
        return -(-self.num_tasks // self.num_consumers) > 1

    def _route(self, producers, capacity):
        if self.num_consumers > 1:
            return group_coalesce_exchange(
                producers, self.num_tasks, self.num_consumers,
                capacity), None
        return coalesce_exchange(producers, self.num_tasks,
                                 capacity), None

    def _route_spmd(self, table, mesh, position, labels):
        if self.num_consumers > 1:
            return group_coalesce_exchange_spmd(
                table, mesh, self.num_consumers, position, labels), None
        return coalesce_exchange_spmd(table, mesh, position, labels), None

    def display(self):
        m = (f" consumers={self.num_consumers}"
             if self.num_consumers > 1 else "")
        return f"CoalesceExchange tasks={self.num_tasks}{m}"


class BroadcastExchangeExec(ExchangeExec):
    """Replicate rows to every task (broadcast-join build sides)."""

    def with_new_children(self, children):
        return _stamped(self, BroadcastExchangeExec(children[0],
                                                    self.num_tasks))

    def output_capacity(self):
        return self.child.output_capacity() * self.num_tasks

    def _route(self, producers, capacity):
        return broadcast_exchange(producers, self.num_tasks,
                                  capacity), None

    def _route_spmd(self, table, mesh, position, labels):
        return broadcast_exchange_spmd(table, mesh, position, labels), None

    def display(self):
        return f"BroadcastExchange tasks={self.num_tasks}"


class IsolatedArmExec(ExecutionPlan):
    """One UNION arm assigned to a single task: a replicated arm is computed
    once, on its task, instead of identically on every task. Not an
    exchange: it carries no data between tasks."""

    def __init__(self, child: ExecutionPlan, assigned_task: int):
        super().__init__()
        self.child = child
        self.assigned_task = assigned_task

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return IsolatedArmExec(children[0], self.assigned_task)

    def schema(self):
        return self.child.schema()

    def output_capacity(self):
        return self.child.output_capacity()

    def _execute(self, ctx: ExecContext) -> Table:
        """One task: the arm. In a multi-task run, as the reference's mesh
        tier: every task runs the arm's exchanges (into the shared cache);
        the assigned task alone computes the arm; every other task gets an
        empty table of the arm's columns, capacity and dictionaries, with
        the arm's overflow flags recorded as false."""
        if ctx.task.task_count <= 1:
            return self.child.execute(ctx)
        mesh = ctx.config.get("mesh")
        if mesh is not None:
            return self._execute_spmd(ctx, mesh)
        if not ctx.peers:
            raise RuntimeError(
                "IsolatedArmExec executed outside a multi-task run: a "
                "staged plan runs through runtime/mesh_executor.execute_tasks"
            )
        for ex in self.child.collect(lambda n: n.is_exchange):
            ex.execute(ctx)
        out, flag_names = self._assigned_arm(ctx.peers[self.assigned_task])
        if ctx.task.task_index == self.assigned_task:
            return out
        false = torch.zeros((), dtype=torch.bool, device=out.device)
        ctx.overflow_flags.extend((name, false) for name in flag_names)
        cols = tuple(
            Column(torch.zeros_like(c.data),
                   torch.zeros_like(c.validity)
                   if c.validity is not None else None,
                   c.dtype, c.dictionary)
            for c in out.columns)
        return Table(out.names, cols, out.num_rows.new_zeros(()))

    def _execute_spmd(self, ctx: ExecContext, mesh) -> Table:
        """One rank of an SPMD run, as the reference's mesh arm: every rank
        runs the arm's exchanges (their collectives need every rank); the
        assigned rank alone runs the rest of the arm and broadcasts what
        the others need to stand in for it: the output's columns, capacity
        and dictionaries, and the names of the flags and metrics its run
        recorded. Every other rank returns the empty table of that shape,
        with those flags recorded as false and those metrics as 0."""
        for ex in self.child.collect(lambda n: n.is_exchange):
            ex.execute(ctx)
        spec = None
        if mesh.rank == self.assigned_task:
            flags = len(ctx.overflow_flags)
            metrics = len(ctx.metrics) if ctx.metrics is not None else 0
            out = self.child.execute(ctx)
            pos = ctx.config["node_positions"]
            spec = (
                out.names, out.capacity,
                [(str(c.data.dtype).removeprefix("torch."), c.dtype,
                  c.validity is not None,
                  None if c.dictionary is None else list(c.dictionary.values))
                 for c in out.columns],
                [name for name, _ in ctx.overflow_flags[flags:]],
                [(pos.get(nid, -1), name)
                 for nid, name, _ in (ctx.metrics or [])[metrics:]],
            )
        spec = _broadcast_object(mesh, spec, self.assigned_task)
        if mesh.rank == self.assigned_task:
            return out
        names, capacity, cols, flag_names, metric_keys = spec
        dev = mesh.device
        false = torch.zeros((), dtype=torch.bool, device=dev)
        ctx.overflow_flags.extend((name, false) for name in flag_names)
        if ctx.metrics is not None:
            nodes = ctx.config["nodes"]
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            ctx.metrics.extend((nodes[p].node_id if 0 <= p < len(nodes)
                                else -1, name, zero)
                               for p, name in metric_keys)
        return Table(tuple(names), tuple(
            Column(torch.zeros(capacity, dtype=getattr(torch, dt),
                               device=dev),
                   torch.zeros(capacity, dtype=torch.bool, device=dev)
                   if valid else None, dtype,
                   None if values is None
                   else Dictionary(np.asarray(values, dtype=object)))
            for dt, dtype, valid, values in cols),
            torch.zeros((), dtype=torch.int32, device=dev))

    def _assigned_arm(self, actx: ExecContext) -> tuple:
        """The arm computed once, on the assigned task's own context
        (memoized in the shared cache), and the names of the flags its own
        compute recorded there."""
        key = ("arm", self.node_id)
        done = actx.exchange_cache.get(key)
        if done is None:
            for ex in self.child.collect(lambda n: n.is_exchange):
                ex.execute(actx)
            first = len(actx.overflow_flags)
            out = self.child.execute(actx)
            done = (out, [name for name, _ in actx.overflow_flags[first:]])
            actx.exchange_cache[key] = done
        return done

    def display(self):
        return f"IsolatedArm task={self.assigned_task}"


def assign_arms_to_tasks(weights: Sequence[float], num_tasks: int) -> list:
    """Weighted child->task assignment (greedy LPT): heaviest arm first to
    the least-loaded task. With fewer arms than tasks some tasks receive
    none; with more, tasks receive several."""
    loads = [0.0] * num_tasks
    assignment = [0] * len(weights)
    for i in sorted(range(len(weights)), key=lambda i: -weights[i]):
        task = min(range(num_tasks), key=lambda t: loads[t])
        assignment[i] = task
        loads[task] += weights[i]
    return assignment
