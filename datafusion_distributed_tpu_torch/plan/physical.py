"""Physical plan IR: the ExecutionPlan tree (port of the reference
`plan/physical.py`; the exchange nodes are in plan/exchanges.py).

The reference traces the whole plan into one XLA program; here operators run
eagerly, one PyTorch call after another, on the device of the leaf tables.
Everything else is kept: every node computes a static `output_capacity`
(the padded row bound), and capacity overflow and int32-precision flags are
collected as device booleans while the plan runs and fetched ONCE at the end
(`execute_plan`), so a query pays one flag transfer, not one per node.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field as dc_field
from typing import Callable, Optional, Sequence

import torch

from datafusion_distributed_tpu_torch.ops.aggregate import (
    _VARIANCE_FUNCS,
    AggSpec,
    global_aggregate,
    hash_aggregate,
    singleton_partial_states,
)
from datafusion_distributed_tpu_torch.ops.sort import (
    SortKey,
    limit_table,
    sort_table,
)
from datafusion_distributed_tpu_torch.ops.table import Table, round_up_pow2
from datafusion_distributed_tpu_torch.plan.expressions import (
    PhysicalExpr,
    expr_to_column,
)
from datafusion_distributed_tpu_torch.schema import DataType, Field, Schema


# ---------------------------------------------------------------------------
# Task context
# ---------------------------------------------------------------------------


@dataclass
class DistributedTaskContext:
    """Which task of a stage this execution is (single-node: task 0 of 1)."""

    task_index: int = 0
    task_count: int = 1


@dataclass
class ExecContext:
    """Carried through `execute`."""

    task: DistributedTaskContext
    inputs: dict  # leaf node_id -> loaded device Table
    overflow_flags: list = dc_field(default_factory=list)
    config: dict = dc_field(default_factory=dict)
    # exchange-node memoization: an exchange routes once per run, however
    # often the tree reaches it. In a multi-task run the dict is shared by
    # the tasks' contexts: node_id -> (every task's consumer table, the
    # overflow flag, the tasks that took theirs)
    exchange_cache: dict = dc_field(default_factory=dict)
    # the contexts of every task of a multi-task run, in task order (the
    # same list in each of them; runtime/mesh_executor.py); empty when one
    # task runs alone
    peers: list = dc_field(default_factory=list)
    # per-node metrics (node_id, metric name, 0-d device tensor), recorded
    # only when the caller keeps them (`execute_plan(metrics_store=...)`):
    # they ride the run's one flag transfer to the host
    metrics: Optional[list] = None

    def record_metric(self, node: "ExecutionPlan", name: str, value) -> None:
        if self.metrics is not None:
            self.metrics.append((node.node_id, name, value))

    def record_overflow(self, node: "ExecutionPlan", flag) -> None:
        self.overflow_flags.append((node.label(), flag))

    def record_precision_error(self, node: "ExecutionPlan", flag) -> None:
        """A 32-bit accumulator left its exact range (tpu precision mode).
        Distinct from capacity overflow: growing the hash table cannot fix
        it, so the executor raises a non-retryable error instead."""
        self.overflow_flags.append((_PRECISION_TAG + node.label(), flag))


_PRECISION_TAG = "precision!"

_NODE_COUNTER = itertools.count()


# ---------------------------------------------------------------------------
# Base node
# ---------------------------------------------------------------------------


class ExecutionPlan:
    """Base of the physical plan tree."""

    #: statistics annotations stamped by the SQL planner from catalog NDV:
    #: estimated output rows / filter selectivity. Consumed by
    #: planner/statistics.estimate_rows.
    est_rows: "float | None" = None
    est_selectivity: "float | None" = None
    #: the distributed planner's annotations (planner/distributed.py), read
    #: by the runtime tiers: a pushed-down partial aggregate the runtime may
    #: bail out of, and its predicted rows; a fused multiway join the
    #: runtime may swap back to its binary chain, the probe order the
    #: statistics chose (a hint only), and the shuffles its fusion deleted;
    #: a single-mode aggregate chosen as one global hash table. Never
    #: fingerprinted; kept across with_new_children rebuilds.
    bailout_candidate: "bool | None" = None
    predicted_partial_rows: "int | None" = None
    multiway_bailout_candidate: "bool | None" = None
    probe_order_hint: "tuple | None" = None
    multiway_deleted_exchanges: "int | None" = None
    global_agg_selected: "bool | None" = None
    #: exchange nodes (plan/exchanges.py) set this; the planner and the
    #: verifier find stage boundaries by it
    is_exchange = False

    _PRESERVED_ANNOTATIONS = (
        "est_rows", "est_selectivity",
        "bailout_candidate", "predicted_partial_rows",
        "multiway_bailout_candidate", "probe_order_hint",
        "multiway_deleted_exchanges", "global_agg_selected",
    )

    def __init__(self) -> None:
        self.node_id = next(_NODE_COUNTER)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        impl = cls.__dict__.get("with_new_children")
        if impl is None:
            return
        import functools

        @functools.wraps(impl)
        def wrapped(self, children, _impl=impl):
            n = _impl(self, children)
            if n is not self and type(n) is type(self):
                for a in self._PRESERVED_ANNOTATIONS:
                    v = getattr(self, a, None)
                    if v is not None and getattr(n, a, None) is None:
                        setattr(n, a, v)
            return n

        cls.with_new_children = wrapped

    # -- tree ---------------------------------------------------------------
    def children(self) -> list["ExecutionPlan"]:
        raise NotImplementedError

    def with_new_children(self, children: list["ExecutionPlan"]) -> "ExecutionPlan":
        raise NotImplementedError

    # -- properties ---------------------------------------------------------
    def schema(self) -> Schema:
        raise NotImplementedError

    def output_capacity(self) -> int:
        raise NotImplementedError

    # -- execution ----------------------------------------------------------
    def execute(self, ctx: ExecContext) -> Table:
        """Run this operator; records the per-node output_rows metric when
        the run keeps metrics (the DataFusion baseline metric set
        analogue)."""
        out = self._execute(ctx)
        ctx.record_metric(self, "output_rows", out.num_rows)
        return out

    def _execute(self, ctx: ExecContext) -> Table:
        raise NotImplementedError

    # -- display ------------------------------------------------------------
    def label(self) -> str:
        return type(self).__name__.removesuffix("Exec")

    def display(self) -> str:
        return self.label()

    def display_tree(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.display()]
        for c in self.children():
            lines.append(c.display_tree(indent + 1))
        return "\n".join(lines)

    # -- traversal helpers --------------------------------------------------
    def transform_up(self, f: Callable[["ExecutionPlan"], "ExecutionPlan"]):
        new_children = [c.transform_up(f) for c in self.children()]
        node = self.with_new_children(new_children) if new_children else self
        return f(node)

    def transform_down(self, f: Callable[["ExecutionPlan"], "ExecutionPlan"]):
        node = f(self)
        children = [c.transform_down(f) for c in node.children()]
        return node.with_new_children(children) if children else node

    def collect(self, pred: Callable[["ExecutionPlan"], bool]) -> list["ExecutionPlan"]:
        out = [self] if pred(self) else []
        for c in self.children():
            out.extend(c.collect(pred))
        return out


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


class MemoryScanExec(ExecutionPlan):
    """Scan over pre-loaded device Tables (one per task; single-node plans
    hold one)."""

    def __init__(self, tasks: Sequence[Table], schema: Schema,
                 pinned: bool = False, replicated: bool = False):
        super().__init__()
        self.tasks = list(tasks)
        self._schema = schema
        self.pinned = pinned
        self.replicated = replicated

    def children(self):
        return []

    def with_new_children(self, children):
        assert not children
        return self

    def schema(self):
        return self._schema

    def output_capacity(self):
        return max((t.capacity for t in self.tasks), default=8)

    def load(self, task: DistributedTaskContext) -> Table:
        if self.pinned or self.replicated:
            return self.tasks[0]
        if task.task_index >= len(self.tasks):
            ref = self.tasks[0]
            return Table.empty(self._schema, ref.capacity, _dicts_of(ref),
                               device=ref.device)
        return self.tasks[task.task_index]

    def _execute(self, ctx: ExecContext) -> Table:
        return ctx.inputs[self.node_id]

    def display(self):
        return f"MemoryScan tasks={len(self.tasks)} cap={self.output_capacity()}"


class ParquetScanExec(ExecutionPlan):
    """Parquet leaf: file groups decoded on the host, uploaded padded."""

    def __init__(
        self,
        file_groups: Sequence[Sequence[str]],  # one list of files per task
        schema: Schema,
        capacity: int,
        projection: Optional[Sequence[str]] = None,
        dictionaries: Optional[dict] = None,
        device=None,
    ):
        super().__init__()
        self.file_groups = [list(g) for g in file_groups]
        self._schema = schema if projection is None else schema.select(projection)
        self.projection = list(projection) if projection else None
        self.capacity = capacity
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

        files = (
            self.file_groups[task.task_index]
            if task.task_index < len(self.file_groups)
            else []
        )
        if not files:
            return Table.empty(self._schema, self.capacity, self.dictionaries,
                               device=self.device)
        return read_parquet(
            files,
            columns=self.projection,
            capacity=self.capacity,
            dictionaries=self.dictionaries,
            device=self.device,
        )

    def _execute(self, ctx: ExecContext) -> Table:
        return ctx.inputs[self.node_id]

    def display(self):
        nfiles = sum(len(g) for g in self.file_groups)
        return (
            f"ParquetScan tasks={len(self.file_groups)} files={nfiles} "
            f"cap={self.capacity}"
        )


# ---------------------------------------------------------------------------
# Unary operators
# ---------------------------------------------------------------------------


class FilterExec(ExecutionPlan):
    def __init__(self, predicate: PhysicalExpr, child: ExecutionPlan):
        super().__init__()
        self.predicate = predicate
        self.child = child

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return FilterExec(self.predicate, children[0])

    def schema(self):
        return self.child.schema()

    def output_capacity(self):
        return self.child.output_capacity()

    def _execute(self, ctx: ExecContext) -> Table:
        t = self.child.execute(ctx)
        v = self.predicate.evaluate(t)
        keep = v.data.to(torch.bool) & v.valid_mask()
        return t.compact(keep)

    def display(self):
        return f"Filter: {self.predicate.display()}"


class ProjectionExec(ExecutionPlan):
    def __init__(self, exprs: Sequence[tuple[PhysicalExpr, str]], child: ExecutionPlan):
        super().__init__()
        self.exprs = list(exprs)
        self.child = child

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return ProjectionExec(self.exprs, children[0])

    def schema(self):
        child_schema = self.child.schema()
        fields = []
        for expr, name in self.exprs:
            f = expr.output_field(child_schema)
            fields.append(Field(name, f.dtype, f.nullable))
        return Schema(fields)

    def output_capacity(self):
        return self.child.output_capacity()

    def _execute(self, ctx: ExecContext) -> Table:
        t = self.child.execute(ctx)
        cols = {}
        for expr, name in self.exprs:
            cols[name] = expr_to_column(expr.evaluate(t))
        return Table(tuple(cols.keys()), tuple(cols.values()), t.num_rows)

    def display(self):
        inner = ", ".join(f"{e.display()} AS {n}" for e, n in self.exprs)
        return f"Projection: {inner}"


class HashAggregateExec(ExecutionPlan):
    """GROUP BY over named columns (the planner materializes expressions
    below via a ProjectionExec). Modes: single | partial | final |
    partial_reduce."""

    def __init__(
        self,
        mode: str,
        group_names: Sequence[str],
        aggs: Sequence[AggSpec],
        child: ExecutionPlan,
        num_slots: Optional[int] = None,
    ):
        super().__init__()
        assert mode in ("single", "partial", "final", "partial_reduce")
        self.mode = mode
        self.group_names = list(group_names)
        self.aggs = list(aggs)
        self.child = child
        # Default table size: 2x the input bound keeps the load factor <= 0.5
        # even when every row is distinct.
        self.num_slots = num_slots or min(
            round_up_pow2(2 * max(child.output_capacity(), 16)), 1 << 20
        )
        # OUTPUT capacity: groups <= live input rows, so the packed result
        # never needs more than pow2(input capacity). DFTPU_AGG_COMPACT=0 is
        # the A/B lever, as in the reference.
        if os.environ.get("DFTPU_AGG_COMPACT", "1") == "1":
            self.out_capacity = min(
                self.num_slots,
                round_up_pow2(max(child.output_capacity(), 16)),
            )
        else:
            self.out_capacity = self.num_slots

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return HashAggregateExec(
            self.mode, self.group_names, self.aggs, children[0], self.num_slots
        )

    def schema(self):
        child_schema = self.child.schema()
        fields = [child_schema.field(g) for g in self.group_names]
        for a in self.aggs:
            fields.extend(_agg_output_fields(a, child_schema, self.mode))
        return Schema(fields)

    def output_capacity(self):
        return self.out_capacity if self.group_names else self.num_slots

    def _execute(self, ctx: ExecContext) -> Table:
        t = self.child.execute(ctx)
        prec_flags: list = []
        if not self.group_names:
            out = global_aggregate(t, self.aggs, self.mode,
                                   prec_flags=prec_flags)
        else:
            out, overflow = hash_aggregate(
                t, self.group_names, self.aggs, self.num_slots, self.mode,
                prec_flags=prec_flags, out_capacity=self.out_capacity,
            )
            ctx.record_overflow(self, overflow)
        for f in prec_flags:
            ctx.record_precision_error(self, f)
        return out

    def display(self):
        aggs = ", ".join(f"{a.func}({a.input_name or '*'})" for a in self.aggs)
        return (
            f"HashAggregate mode={self.mode} gby=[{', '.join(self.group_names)}] "
            f"aggs=[{aggs}] slots={self.num_slots}"
        )


def _agg_output_fields(a: AggSpec, child_schema: Schema, mode: str) -> list[Field]:
    if a.func == "count_star" or a.func == "count":
        return [Field(a.output_name, DataType.INT64, nullable=False)]
    if a.func == "avg":
        if mode in ("partial", "partial_reduce"):
            return [
                Field(f"{a.output_name}__sum", DataType.FLOAT64, True),
                Field(f"{a.output_name}__count", DataType.INT64, False),
            ]
        return [Field(a.output_name, DataType.FLOAT64, True)]
    if a.func in _VARIANCE_FUNCS:
        if mode in ("partial", "partial_reduce"):
            return [
                Field(f"{a.output_name}__sum", DataType.FLOAT64, True),
                Field(f"{a.output_name}__sumsq", DataType.FLOAT64, True),
                Field(f"{a.output_name}__count", DataType.INT64, False),
            ]
        return [Field(a.output_name, DataType.FLOAT64, True)]
    if mode in ("final", "partial_reduce"):
        src = child_schema.field(a.output_name)
        return [Field(a.output_name, src.dtype, True)]
    src = child_schema.field(a.input_name) if a.input_name else None
    if a.func == "sum":
        dt = DataType.FLOAT64 if src.dtype.is_float else DataType.INT64
        return [Field(a.output_name, dt, True)]
    # min/max keep input type
    return [Field(a.output_name, src.dtype, True)]


class PartialPassthroughExec(ExecutionPlan):
    """Per-row partial-aggregation states under the exact partial-mode
    schema (ops/aggregate.py `singleton_partial_states`)."""

    def __init__(self, group_names: Sequence[str], aggs: Sequence[AggSpec],
                 child: ExecutionPlan):
        super().__init__()
        self.group_names = list(group_names)
        self.aggs = list(aggs)
        self.child = child

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return PartialPassthroughExec(self.group_names, self.aggs,
                                      children[0])

    def schema(self):
        child_schema = self.child.schema()
        fields = [child_schema.field(g) for g in self.group_names]
        for a in self.aggs:
            fields.extend(_agg_output_fields(a, child_schema, "partial"))
        return Schema(fields)

    def output_capacity(self):
        return self.child.output_capacity()

    def _execute(self, ctx: ExecContext) -> Table:
        return singleton_partial_states(
            self.child.execute(ctx), self.group_names, self.aggs
        )

    def display(self):
        aggs = ", ".join(f"{a.func}({a.input_name or '*'})" for a in self.aggs)
        return (
            f"PartialPassthrough gby=[{', '.join(self.group_names)}] "
            f"aggs=[{aggs}]"
        )


class SortExec(ExecutionPlan):
    def __init__(self, keys: Sequence[SortKey], child: ExecutionPlan,
                 fetch: Optional[int] = None):
        super().__init__()
        self.keys = list(keys)
        self.child = child
        self.fetch = fetch

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return SortExec(self.keys, children[0], self.fetch)

    def schema(self):
        return self.child.schema()

    def output_capacity(self):
        return self.child.output_capacity()

    def _execute(self, ctx: ExecContext) -> Table:
        t = sort_table(self.child.execute(ctx), self.keys)
        if self.fetch is not None:
            t = t.head(self.fetch)
        return t

    def display(self):
        ks = ", ".join(
            f"{k.name} {'ASC' if k.ascending else 'DESC'}" for k in self.keys
        )
        fetch = f" fetch={self.fetch}" if self.fetch is not None else ""
        return f"Sort: [{ks}]{fetch}"


class LimitExec(ExecutionPlan):
    def __init__(self, child: ExecutionPlan, fetch: int, skip: int = 0):
        super().__init__()
        self.child = child
        self.fetch = fetch
        self.skip = skip

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return LimitExec(children[0], self.fetch, self.skip)

    def schema(self):
        return self.child.schema()

    def output_capacity(self):
        return self.child.output_capacity()

    def _execute(self, ctx: ExecContext) -> Table:
        return limit_table(self.child.execute(ctx), self.fetch, self.skip)

    def display(self):
        skip = f" skip={self.skip}" if self.skip else ""
        return f"Limit: fetch={self.fetch}{skip}"


class CoalescePartitionsExec(ExecutionPlan):
    """N input partitions -> 1. A single-node plan already yields one Table,
    so this is identity; it marks stage heads for the distributed planner."""

    def __init__(self, child: ExecutionPlan):
        super().__init__()
        self.child = child

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return CoalescePartitionsExec(children[0])

    def schema(self):
        return self.child.schema()

    def output_capacity(self):
        return self.child.output_capacity()

    def _execute(self, ctx: ExecContext) -> Table:
        return self.child.execute(ctx)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def collect_leaves(plan: ExecutionPlan) -> list[ExecutionPlan]:
    return plan.collect(lambda n: not n.children())


def execute_plan(
    plan: ExecutionPlan,
    task: Optional[DistributedTaskContext] = None,
    config: Optional[dict] = None,
    check_overflow: bool = True,
    metrics_store=None,
    task_label: Optional[str] = None,
) -> Table:
    """Run a single-task plan eagerly: host-load the leaves, execute the
    operators, then fetch every capacity and precision flag in ONE transfer
    and raise on them. The two error messages are the reference's, word for
    word: the session's retry loop keys on the word "overflow" in the
    first and must never see it in the second.

    The plan runs in its prepared form (plan/fingerprint.py, memoized on
    the plan object): numeric comparison literals hoisted into host
    parameter vectors, bound for the run. The hoisted plan reuses the
    original's leaves and node ids.

    The output's live-row count rides the same transfer and is kept on
    the output (`ops.table.host_rows`). With ``metrics_store`` every
    node's output_rows rides it too and is inserted under
    ``task_label`` (runtime/metrics.py MetricsStore protocol), keyed by
    the submitted plan's node ids."""
    from datafusion_distributed_tpu_torch.plan.fingerprint import (
        bound_params,
        prepare_plan,
    )

    task = task or DistributedTaskContext()
    prep = prepare_plan(plan)
    exec_target = prep.plan
    inputs = {
        leaf.node_id: leaf.load(task)
        for leaf in collect_leaves(exec_target) if hasattr(leaf, "load")
    }
    ctx = ExecContext(task=task, inputs=inputs, config=config or {})
    if metrics_store is not None and ctx.config.get("collect_metrics", True):
        ctx.metrics = []
    with bound_params(prep.param_arrays()):
        out = exec_target.execute(ctx)
    cap_flags = [f for name, f in ctx.overflow_flags
                 if not name.startswith(_PRECISION_TAG)]
    prec_flags = [f for name, f in ctx.overflow_flags
                  if name.startswith(_PRECISION_TAG)]
    dev = out.device
    none = torch.zeros((), dtype=torch.bool, device=dev)
    any_overflow = torch.stack(cap_flags).any() if cap_flags else none
    any_precision = torch.stack(prec_flags).any() if prec_flags else none
    metric_vals = [v for _, _, v in ctx.metrics or ()]
    fetched = torch.stack(
        [x.to(torch.int64) for x in
         [any_overflow, any_precision, out.num_rows] + metric_vals]
    ).tolist()  # the run's one device-to-host transfer
    flags = fetched[:2]
    out._host_rows = fetched[2]
    if metrics_store is not None:
        # positions -> THIS submission's node ids (the hoisted plan's
        # pre-order traversal equals the submitted plan's)
        pos_of = {
            n.node_id: i
            for i, n in enumerate(exec_target.collect(lambda _n: True))
        }
        nodes = plan.collect(lambda _n: True)
        node_metrics: dict = {}
        for (nid, name, _), v in zip(ctx.metrics or (), fetched[3:]):
            pos = pos_of.get(nid, -1)
            if 0 <= pos < len(nodes):
                node_metrics.setdefault(nodes[pos].node_id, {})[name] = v
        metrics_store.insert(task_label or f"task{task.task_index}",
                             node_metrics)
    if check_overflow and bool(flags[0]):
        raise RuntimeError(
            f"hash table overflow in plan (nodes: "
            f"{[name for name, _ in ctx.overflow_flags if not name.startswith(_PRECISION_TAG)]}); "
            "re-plan with more slots"
        )
    if bool(flags[1]):
        # deliberately does NOT contain the word "overflow": the session's
        # capacity-retry loop must not retry this (a bigger hash table can't
        # restore int32 exactness).
        raise RuntimeError(
            "int32 accumulator range exceeded in plan (nodes: "
            f"{[name for name, _ in ctx.overflow_flags if name.startswith(_PRECISION_TAG)]}); "
            "run with DFTPU_PRECISION=x64 for 64-bit accumulation"
        )
    return out


def _dicts_of(table: Table) -> dict:
    return {
        n: c.dictionary
        for n, c in zip(table.names, table.columns)
        if c.dictionary is not None
    }
