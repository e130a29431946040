"""A user-defined ExecutionPlan operator running distributed.

The port of `examples/custom_execution_plan.py` (the reference crate's
`examples/custom_execution_plan.rs`): implement a custom physical
operator, register a codec for it, and watch it survive the full
distributed lifecycle: plan staging, serialization, shipment to workers,
decode, and execution inside each task on the session's device.

The operator here is `WinsorizeExec`: it clamps a numeric column to the
[lo, hi] quantile band estimated from each task's local shard. It is a
single-child, capacity-preserving node (the simplest shape of custom
operator) and composes with the engine's own exchanges (the plan below
shuffles by key after winsorizing, then aggregates).

    python -m datafusion_distributed_tpu_torch.examples.custom_execution_plan
    python -m datafusion_distributed_tpu_torch.examples.custom_execution_plan \\
        --device cpu
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import torch

from datafusion_distributed_tpu_torch.examples._common import (
    parser,
    result,
    show,
)
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec
from datafusion_distributed_tpu_torch.ops.sort import SortKey
from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Table,
    resolve_device,
)
from datafusion_distributed_tpu_torch.plan.physical import (
    ExecContext,
    ExecutionPlan,
    HashAggregateExec,
    MemoryScanExec,
    SortExec,
)
from datafusion_distributed_tpu_torch.planner.distributed import (
    DistributedConfig,
    distribute_plan,
)
from datafusion_distributed_tpu_torch.runtime.codec import (
    decode_plan,
    encode_plan,
    register_codec,
)
from datafusion_distributed_tpu_torch.runtime.coordinator import (
    Coordinator,
    InMemoryCluster,
)

ROWS = 20_000
TASKS = 4
WORKERS = 3
Q = 0.01  # the band: [Q, 1 - Q] quantiles of each task's shard


def nanquantile(values: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of the non-NaN ``values`` with linear
    interpolation, in their dtype: the arithmetic of ``jnp.nanquantile``
    (position q * (count - 1) between the sorted neighbours, weighted
    1 - frac and frac). A sort, so any length works (``torch.nanquantile``
    takes at most 2^24 elements)."""
    ordered = torch.sort(values).values  # NaN sorts last
    count = (~torch.isnan(values)).sum().to(values.dtype)
    pos = torch.tensor(q, dtype=values.dtype, device=values.device) * (
        count - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1 - high_weight
    last = (count - 1).clamp(min=0)
    low_i = torch.minimum(low, last).clamp(min=0).long()
    high_i = torch.minimum(high, last).clamp(min=0).long()
    return ordered[low_i] * low_weight + ordered[high_i] * high_weight


class WinsorizeExec(ExecutionPlan):
    """Clamp ``column`` to its local [q, 1-q] quantile band.

    Everything a custom node must provide: the tree contract (children /
    with_new_children), schema + output_capacity (padded, fixed-capacity
    tables are what every operator exchanges), and `_execute`, which runs
    once a task on its device: torch ops only, no host sync."""

    codec_kind = "winsorize"  # ties the node to its registered codec

    def __init__(self, child: ExecutionPlan, column: str, q: float):
        super().__init__()
        self.child = child
        self.column = column
        self.q = q

    def children(self):
        return [self.child]

    def with_new_children(self, children):
        return WinsorizeExec(children[0], self.column, self.q)

    def schema(self):
        return self.child.schema()

    def output_capacity(self):
        return self.child.output_capacity()

    def label(self):
        return f"Winsorize({self.column}, q={self.q})"

    def _execute(self, ctx: ExecContext) -> Table:
        t = self.child.execute(ctx)
        i = t.names.index(self.column)
        col = t.columns[i]
        live = t.row_mask()
        # quantiles over live rows only (padding is masked to NaN)
        vals = torch.where(live, col.data,
                           torch.tensor(float("nan"), dtype=col.data.dtype,
                                        device=col.data.device))
        lo = nanquantile(vals, self.q)
        hi = nanquantile(vals, 1.0 - self.q)
        clamped = torch.clamp(col.data, lo, hi)
        cols = list(t.columns)
        cols[i] = Column(clamped, col.validity, col.dtype, col.dictionary)
        # a custom metric, visible in explain_analyze / coordinator metrics
        ctx.record_metric(self, "clamped_rows",
                          ((col.data != clamped) & live).sum())
        return Table(t.names, tuple(cols), t.num_rows)


def register() -> None:
    """The codec pair: encode -> JSON-able dict, decode -> node. Workers
    decoding a shipped plan look the kind up in the same process-wide
    registry (`runtime/codec.py` register_codec, the user-codec registry
    analogue of the reference crate's `src/protobuf/user_codec.rs`)."""
    register_codec(
        "winsorize",
        lambda p, store: {"column": p.column, "q": p.q,
                          "c": encode_plan(p.child, store)},
        lambda o, store: WinsorizeExec(decode_plan(o["c"], store),
                                       o["column"], o["q"]),
    )


register()


def run(device=None, n: int = ROWS) -> dict:
    """-> frames: the winsorized group sums (``result``); facts: the
    staged plan's text (``plan``) and the rows clamped across all tasks
    (``clamped``, read back from the coordinator's task metrics)."""
    register()  # idempotent: a caller may have removed the codec
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    # heavy-tailed values: winsorizing changes the group sums visibly
    arrow = pa.table({
        "k": rng.integers(0, 8, n),
        "v": rng.standard_t(df=2, size=n) * 100,
    })
    t = arrow_to_table(arrow, device=dev)

    scan = MemoryScanExec([t], t.schema())
    custom = WinsorizeExec(scan, "v", q=Q)
    agg = HashAggregateExec(
        "single", ["k"],
        [AggSpec("sum", "v", "winsorized_sum"),
         AggSpec("count_star", None, "n")],
        custom,
    )
    plan = SortExec([SortKey("k")], agg)
    dplan = distribute_plan(plan, DistributedConfig(num_tasks=TASKS))

    cluster = InMemoryCluster(num_workers=WORKERS)
    coord = Coordinator(resolver=cluster, channels=cluster)
    out = coord.execute(dplan).to_numpy()
    clamped = sum(
        int(m.get("clamped_rows", 0))
        for task in coord.metrics.values()
        for m in task.get("nodes", {}).values()
        if isinstance(m, dict)
    )
    assert len(out["k"]) == 8
    return result(frames={"result": out},
                  facts={"plan": dplan.display_tree(), "clamped": clamped})


def main(argv=None) -> None:
    r = run(parser(__doc__).parse_args(argv).device)
    print("-- staged plan (custom node inside the task pipeline) --")
    print(r["facts"]["plan"])
    print("\n-- result (winsorized group sums) --")
    print(show(r["frames"]["result"]))
    print(f"\nrows clamped across all tasks: {r['facts']['clamped']}")


if __name__ == "__main__":
    main()
