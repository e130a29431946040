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

Executing an exchange needs the T tasks of its stages: that is ROADMAP A.2.
Until then an exchange's `_execute` raises, as the reference's does outside
a mesh. A one-task staged plan has no exchange left (`_prepare` elides every
1:1 boundary), so it runs through `execute_plan` like a single-node plan.
"""

from __future__ import annotations

from typing import Optional, Sequence

from datafusion_distributed_tpu_torch.ops.table import Table
from datafusion_distributed_tpu_torch.plan.physical import (
    ExecContext,
    ExecutionPlan,
)


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
        """Memoized: an exchange runs once per plan run (see
        ExecContext.exchange_cache)."""
        cached = ctx.exchange_cache.get(self.node_id)
        if cached is not None:
            return cached
        out = super().execute(ctx)
        ctx.exchange_cache[self.node_id] = out
        return out

    def _execute(self, ctx: ExecContext) -> Table:
        raise RuntimeError(
            f"{type(self).__name__} executed outside a multi-task run: "
            "exchanges between the tasks of a staged plan are not ported "
            "yet (ROADMAP A.2); a one-task staged plan has none"
        )


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
        # the reference's task-indexed form: a task other than the assigned
        # one contributes an empty arm
        if ctx.task.task_count > 1 and (
            ctx.task.task_index != self.assigned_task
        ):
            t = self.child.execute(ExecContext(
                task=ctx.task, inputs=ctx.inputs, config=ctx.config,
            ))
            return Table(t.names, t.columns, t.num_rows.new_zeros(()))
        return self.child.execute(ctx)

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
