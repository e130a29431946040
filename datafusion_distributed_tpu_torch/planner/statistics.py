"""Cost model: symbolic per-operator complexity evaluated against
statistics (port of the reference `planner/statistics.py`).

`estimate_rows` sizes hash tables (sql/planner.py); `plan_device_bytes`
guards the overflow-retry loop (sql/context.py); the rest serves the
distributed planner (planner/distributed.py): row widths, per-operator
work, `Cost` (device work, padded device bytes, bytes crossing exchanges),
the partial-aggregate push-down's reduction prediction, and the multiway
join fusion's byte gate and probe order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from datafusion_distributed_tpu_torch.plan.exchanges import (
    BroadcastExchangeExec,
    CoalesceExchangeExec,
    ShuffleExchangeExec,
)
from datafusion_distributed_tpu_torch.plan.joins import (
    CrossJoinExec,
    HashJoinExec,
    MultiwayHashJoinExec,
    UnionExec,
)
from datafusion_distributed_tpu_torch.plan.physical import (
    ExecutionPlan,
    FilterExec,
    HashAggregateExec,
    LimitExec,
    MemoryScanExec,
    ParquetScanExec,
    ProjectionExec,
    SortExec,
)
from datafusion_distributed_tpu_torch.plan.window_exec import WindowExec
from datafusion_distributed_tpu_torch.schema import DataType, Schema

# Trino-style per-datatype byte widths
_BYTES = {
    DataType.INT32: 4,
    DataType.INT64: 8,
    DataType.FLOAT32: 4,
    DataType.FLOAT64: 8,
    DataType.BOOL: 1,
    DataType.DATE32: 4,
    DataType.STRING: 16,  # dictionary code + amortized dictionary share
}


def row_width(schema: Schema) -> int:
    return sum(_BYTES[f.dtype] + (1 if f.nullable else 0) for f in schema.fields)


@dataclass
class Complexity:
    """Symbolic complexity: cost = constant + linear*n + nlogn*n*log2(n)."""

    constant: float = 0.0
    linear: float = 0.0
    nlogn: float = 0.0

    def evaluate(self, n: float) -> float:
        logn = math.log2(max(n, 2.0))
        return self.constant + self.linear * n + self.nlogn * n * logn

    def __add__(self, other: "Complexity") -> "Complexity":
        return Complexity(
            self.constant + other.constant,
            self.linear + other.linear,
            self.nlogn + other.nlogn,
        )


@dataclass
class Cost:
    """Device work / device memory / interconnect, all in bytes."""

    compute: float = 0.0
    memory: float = 0.0
    network: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(
            self.compute + other.compute,
            self.memory + other.memory,
            self.network + other.network,
        )


@dataclass
class PlanStatistics:
    """Measured or sampled row counts per node, keyed by node_id."""

    rows: dict  # node_id -> float estimated rows

    def rows_of(self, node: ExecutionPlan, default: float) -> float:
        return self.rows.get(node.node_id, default)


def estimate_rows(plan: ExecutionPlan, stats: Optional[PlanStatistics] = None) -> float:
    """Bottom-up cardinality estimate (filters shrink, joins keep the probe
    side, aggregates dedupe). Planner-stamped NDV statistics
    (`ExecutionPlan.est_rows` / `.est_selectivity`) take precedence over the
    blanket heuristics."""
    if stats is not None and plan.node_id in stats.rows:
        return stats.rows[plan.node_id]
    if isinstance(plan, MemoryScanExec):
        return float(sum(int(t.num_rows) for t in plan.tasks))
    if isinstance(plan, ParquetScanExec):
        return float(plan.capacity)
    if isinstance(plan, FilterExec):
        n = estimate_rows(plan.child, stats)
        sel = plan.est_selectivity
        return n * sel if sel is not None else n / 3.0
    if isinstance(plan, (ProjectionExec, LimitExec)):
        child = plan.children()[0]
        n = estimate_rows(child, stats)
        if isinstance(plan, LimitExec):
            return min(n, float(plan.fetch))
        return n
    if isinstance(plan, HashAggregateExec):
        n = estimate_rows(plan.child, stats)
        if not plan.group_names:
            return 1.0
        if plan.est_rows is not None:
            return max(min(plan.est_rows, n), 1.0)
        return max(n ** 0.5, 1.0)
    if isinstance(plan, HashJoinExec):
        p = estimate_rows(plan.probe, stats)
        if plan.join_type in ("semi", "anti"):
            return p / 2.0
        # expanding joins emit more than probe rows; expansion_factor is the
        # sizing hint for exactly that fanout
        return p * max(float(getattr(plan, "expansion_factor", 1.0)), 1.0)
    if isinstance(plan, MultiwayHashJoinExec):
        p = estimate_rows(plan.probe, stats)
        for s in plan.steps:
            if s.join_type in ("semi", "anti"):
                p = p / 2.0
            else:
                p = p * max(float(s.expansion_factor), 1.0)
        return p
    if isinstance(plan, CrossJoinExec):
        return estimate_rows(plan.left, stats) * estimate_rows(plan.right, stats)
    if isinstance(plan, UnionExec):
        return sum(estimate_rows(c, stats) for c in plan.children())
    if isinstance(plan, SortExec):
        n = estimate_rows(plan.child, stats)
        return min(n, float(plan.fetch)) if plan.fetch else n
    if plan.children():
        return max(estimate_rows(c, stats) for c in plan.children())
    return 1000.0


def operator_complexity(plan: ExecutionPlan) -> Complexity:
    """Per-operator symbolic device-work model in terms of OUTPUT rows
    (the single-input view; joins get their input shapes in
    `operator_compute_rows`)."""
    if isinstance(plan, (MemoryScanExec, ParquetScanExec)):
        return Complexity(linear=1.0)
    if isinstance(plan, (FilterExec, ProjectionExec, LimitExec)):
        return Complexity(linear=1.0)
    if isinstance(plan, HashAggregateExec):
        return Complexity(linear=3.0)  # hash + claim rounds + scatter
    if isinstance(plan, HashJoinExec):
        return Complexity(linear=4.0)  # build + probe + expand + gather
    if isinstance(plan, CrossJoinExec):
        return Complexity(linear=8.0)
    if isinstance(plan, SortExec):
        return Complexity(nlogn=1.0)
    return Complexity(linear=1.0)


def operator_compute_rows(
    plan: ExecutionPlan, stats: Optional[PlanStatistics] = None
) -> float:
    """Row-ops this operator performs:

      hash join   n_build + n_probe      build pass + probe pass
      multiway    n_probe + sum n_build  one probe pass resolves K tables
      cross join  n_left * n_right       every pair
      hash agg    3 n                    claim-loop rounds over the input
      sort        n log2 n
      window      n log2 n               the partition sort dominates
      elementwise n                      filter/project/limit/scan
    """
    if isinstance(plan, HashJoinExec):
        b = estimate_rows(plan.build, stats)
        p = estimate_rows(plan.probe, stats)
        return b + p
    if isinstance(plan, MultiwayHashJoinExec):
        p = estimate_rows(plan.probe, stats)
        return p + sum(estimate_rows(b, stats) for b in plan.builds)
    if isinstance(plan, CrossJoinExec):
        return (estimate_rows(plan.left, stats)
                * estimate_rows(plan.right, stats))
    if isinstance(plan, HashAggregateExec):
        return 3.0 * estimate_rows(plan.child, stats)
    if isinstance(plan, (SortExec, WindowExec)):
        n = estimate_rows(plan.child, stats)
        return n * math.log2(max(n, 2.0))
    if isinstance(plan, UnionExec):
        return sum(estimate_rows(c, stats) for c in plan.children())
    if plan.children():
        return max(estimate_rows(c, stats) for c in plan.children())
    return estimate_rows(plan, stats)


def _network_bytes(node: ExecutionPlan, rows: float, width: int) -> float:
    """Bytes crossing ``node`` if it is an exchange: a broadcast and a
    coalesce (an all-gather) send every row to every task; a
    partition-replicated split sends nothing."""
    if isinstance(node, ShuffleExchangeExec):
        return rows * width
    if isinstance(node, (BroadcastExchangeExec, CoalesceExchangeExec)):
        return rows * width * node.num_tasks
    return 0.0


def calculate_cost(
    plan: ExecutionPlan, stats: Optional[PlanStatistics] = None
) -> Cost:
    """Total cost of a (sub)plan: compute from the per-operator input rows,
    memory from padded capacities, network from exchange bytes."""
    total = Cost()
    for c in plan.children():
        total = total + calculate_cost(c, stats)
    n = estimate_rows(plan, stats)
    width = row_width(plan.schema())
    work = operator_compute_rows(plan, stats) * width
    mem = float(plan.output_capacity()) * width
    return total + Cost(compute=work, memory=mem,
                        network=_network_bytes(plan, n, width))


def stage_cost(
    head: ExecutionPlan, stats: Optional[PlanStatistics] = None
) -> Cost:
    """Cost of ONE stage: the subtree under ``head`` cut at exchange
    boundaries (nodes below a boundary belong to producer stages). The
    boundary's own network bytes are included."""
    total = Cost()

    def node_cost(node: ExecutionPlan) -> Cost:
        n = estimate_rows(node, stats)
        width = row_width(node.schema())
        work = operator_compute_rows(node, stats) * width
        try:
            mem = float(node.output_capacity()) * width
        except NotImplementedError:
            mem = n * width
        return Cost(compute=work, memory=mem,
                    network=_network_bytes(node, n, width))

    def walk(node: ExecutionPlan) -> None:
        nonlocal total
        total = total + node_cost(node)
        if node.is_exchange and node is not head:
            return  # producer stage: costed with its own stage
        for c in node.children():
            walk(c)

    walk(head)
    return total


def compute_based_task_count(
    cost: Cost,
    bytes_per_task_per_second: float,
    max_tasks: int,
    target_seconds: float = 1.0,
) -> int:
    """Adaptive task sizing: ceil(compute_bytes / bytes_per_task_per_second
    / target_seconds), clamped to [1, max_tasks]."""
    t = math.ceil(cost.compute / max(bytes_per_task_per_second, 1.0)
                  / target_seconds)
    return max(1, min(t, max_tasks))


@dataclass
class ExchangeReduction:
    """Predicted effect of aggregating BELOW an exchange instead of above
    it, from sampled key-distribution statistics."""

    rows_in: float  # raw rows that would cross without the push-down
    rows_out: float  # partial-state rows that cross with it
    rows_per_task: float  # expected distinct groups per producer task
    reduction: float  # 1 - rows_out/rows_in (0 = no win, ->1 = collapse)


def expected_distinct(n: float, ndv: float) -> float:
    """Expected number of DISTINCT values in ``n`` draws from a uniform
    domain of ``ndv`` values: ndv * (1 - (1 - 1/ndv)^n), in log space."""
    n = max(float(n), 0.0)
    ndv = max(float(ndv), 1.0)
    if n <= 0:
        return 0.0
    return ndv * -math.expm1(n * math.log1p(-1.0 / ndv)) if ndv > 1 \
        else 1.0


def predict_partial_agg_reduction(
    rows_in: float, ndv: float, t_producer: int
) -> ExchangeReduction:
    """Rows crossing a shuffle with vs without a pre-exchange partial
    aggregate: each of ``t_producer`` tasks holds ~rows_in/t raw rows and
    emits `expected_distinct(rows_in/t, ndv)` partial states."""
    t = max(int(t_producer), 1)
    rows_in = max(float(rows_in), 0.0)
    per_task = expected_distinct(rows_in / t, ndv)
    rows_out = min(per_task * t, rows_in)
    reduction = 1.0 - (rows_out / rows_in) if rows_in > 0 else 0.0
    return ExchangeReduction(
        rows_in=rows_in, rows_out=rows_out, rows_per_task=per_task,
        reduction=max(reduction, 0.0),
    )


def _padded_bytes(node) -> int:
    """output_capacity * row_width of one node (8 bytes a row, or 0 rows,
    where the node cannot say)."""
    try:
        w = row_width(node.schema())
    except (KeyError, NotImplementedError):
        w = 8
    try:
        cap = int(node.output_capacity())
    except NotImplementedError:
        cap = 0
    return cap * max(w, 1)


def multiway_build_bytes(builds) -> int:
    """Padded byte footprint of a fused join chain's build sides: they are
    ALL resident in one stage at once."""
    return sum(_padded_bytes(b) for b in builds)


def multiway_fusion_allowed(builds, max_bytes: int) -> bool:
    """The fusion pass's gate: some build sides, whose combined resident
    footprint fits the budget."""
    if not builds:
        return False
    return multiway_build_bytes(builds) <= max_bytes


def choose_probe_order(builds, stats: Optional[PlanStatistics] = None):
    """Estimated probe order for a fused chain: smallest estimated build
    first, as step indices. A hint only: reordering the steps would permute
    the fused stage's output columns."""
    est = [(estimate_rows(b, stats), i) for i, b in enumerate(builds)]
    return tuple(i for _, i in sorted(est, key=lambda t: (t[0], t[1])))


def plan_device_bytes(plan) -> int:
    """Coarse upper bound on a plan's device-buffer footprint: the sum over
    nodes of output_capacity * row_width. The overflow-retry guard abandons
    a widened plan beyond the byte budget instead of letting the allocator
    fail opaquely."""
    return sum(_padded_bytes(n) for n in plan.collect(lambda _n: True))
