"""Physical window operator over ops/window.py's segmented scans (port of
the reference `plan/window_exec.py`)."""

from __future__ import annotations

from typing import Sequence

from datafusion_distributed_tpu_torch.ops.sort import SortKey
from datafusion_distributed_tpu_torch.ops.window import WindowFunc, window_compute
from datafusion_distributed_tpu_torch.ops.table import Table
from datafusion_distributed_tpu_torch.plan.physical import ExecContext, ExecutionPlan
from datafusion_distributed_tpu_torch.schema import Field, Schema


class WindowExec(ExecutionPlan):
    """Appends window-function columns. Partition/order/argument expressions
    are materialized as named columns by the planner below this node (same
    convention as HashAggregateExec)."""

    def __init__(
        self,
        child: ExecutionPlan,
        funcs: Sequence[WindowFunc],
        partition_names: Sequence[str],
        order_keys: Sequence[SortKey],
        out_fields: Sequence[Field],
    ):
        super().__init__()
        self.child = child
        self.funcs = list(funcs)
        self.partition_names = list(partition_names)
        self.order_keys = list(order_keys)
        self.out_fields = list(out_fields)

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return WindowExec(
            children[0], self.funcs, self.partition_names, self.order_keys,
            self.out_fields,
        )

    def schema(self):
        return Schema(list(self.child.schema().fields) + self.out_fields)

    def output_capacity(self):
        return self.child.output_capacity()

    def _execute(self, ctx: ExecContext) -> Table:
        t = self.child.execute(ctx)
        cols = window_compute(
            t, self.partition_names, self.order_keys, self.funcs
        )
        for name, col in cols.items():
            t = t.with_column(name, col)
        return t

    def display(self):
        fs = ", ".join(
            f"{f.func}({f.input_name or ''}) AS {f.output_name}"
            for f in self.funcs
        )
        pb = ", ".join(self.partition_names)
        ob = ", ".join(
            f"{k.name} {'ASC' if k.ascending else 'DESC'}"
            for k in self.order_keys
        )
        return f"Window [{fs}] partition=[{pb}] order=[{ob}]"
