"""Hand-built distributed plan: a progressive partial-reduction tree.

The port of `examples/custom_partial_reduction_tree.py` (the reference
crate's `examples/custom_distributed_partial_reduction_tree.rs`): exchange
nodes are public, constructible operators. If a plan ALREADY contains
boundaries when it reaches the distributed planner, the planner does not
re-distribute it; it only finalizes what you placed. Here that builds a
GROUP BY reduction tree that shrinks data at every level instead of one
wide gather:

    Final               (1 task)    <- finishes the aggregation
      CoalesceExchange  M -> 1
    PartialReduce       (M tasks)   <- merges partial STATES (fewer states
      CoalesceExchange  N -> M         cross each hop; avg merges its
    Partial             (N tasks)      (sum, count) pair correctly)
      MemoryScan        N slices

`HashAggregateExec(mode="partial_reduce")` is the key node: unlike a plain
coalesce (which only concatenates), it re-groups and merges accumulator
columns while KEEPING them in state form, so a later final stage can
finish the job.

The tree runs three ways: over N tasks in this process
(`runtime/mesh_executor.execute_tasks`, the tasks one after another on the
device), through the coordinator over in-memory workers, and, with
``--ranks R``, as one program over R spawned processes of a
torch.distributed group (`make_mesh`, `execute_on_mesh`; N = R).

    python -m datafusion_distributed_tpu_torch.examples.custom_partial_reduction_tree
    python -m datafusion_distributed_tpu_torch.examples.custom_partial_reduction_tree \\
        --device cpu --ranks 4
"""

from __future__ import annotations

import re
import warnings

import numpy as np
import pyarrow as pa

from datafusion_distributed_tpu_torch.examples._common import (
    module_name,
    parser,
    rank_main,
    result,
    show,
    spawn_ranks,
)
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec
from datafusion_distributed_tpu_torch.ops.sort import SortKey
from datafusion_distributed_tpu_torch.ops.table import resolve_device
from datafusion_distributed_tpu_torch.parallel.exchange import partition_table
from datafusion_distributed_tpu_torch.plan.exchanges import (
    CoalesceExchangeExec,
)
from datafusion_distributed_tpu_torch.plan.physical import (
    HashAggregateExec,
    MemoryScanExec,
    SortExec,
)
from datafusion_distributed_tpu_torch.planner.distributed import (
    DistributedConfig,
    distribute_plan,
)
from datafusion_distributed_tpu_torch.runtime.coordinator import (
    Coordinator,
    InMemoryCluster,
)
from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
    execute_on_mesh,
    execute_tasks,
)

ROWS = 80_000
N_TASKS = 8  # leaf fan-in
M_GROUPS = 2  # intermediate reduction width
WORKERS = 4  # in-memory workers of the coordinated run
_CODE = re.compile(r"(DFTPU\d{3}) error")


def weather(n: int) -> pa.Table:
    """Station-keyed readings, like the reference crate example's table."""
    rng = np.random.default_rng(5)
    return pa.table({
        "station": rng.integers(0, 12, n),
        "temp_c": np.round(rng.normal(15, 9, n), 2),
    })


def tree(table, num_tasks: int):
    aggs = [
        AggSpec("avg", "temp_c", "avg_temp"),
        AggSpec("max", "temp_c", "max_temp"),
        AggSpec("count_star", None, "readings"),
    ]
    scan = MemoryScanExec(partition_table(table, num_tasks), table.schema())
    partial = HashAggregateExec("partial", ["station"], aggs, scan)
    narrow = CoalesceExchangeExec(partial, num_tasks, num_consumers=M_GROUPS)
    reduce_ = HashAggregateExec("partial_reduce", ["station"], aggs, narrow)
    gather = CoalesceExchangeExec(reduce_, num_tasks)
    final = HashAggregateExec("final", ["station"], aggs, gather)
    plan = SortExec([SortKey("station")], final)
    # the planner sees the hand-placed boundaries and only finalizes them
    return distribute_plan(plan, DistributedConfig(num_tasks=num_tasks))


def oracle(arrow: pa.Table) -> dict:
    """Per station, in station order: mean, max and count of temp_c (numpy,
    float64)."""
    st = arrow.column("station").to_numpy()
    temp = arrow.column("temp_c").to_numpy()
    keys, inv = np.unique(st, return_inverse=True)
    count = np.bincount(inv)
    top = np.full(len(keys), -np.inf)
    np.maximum.at(top, inv, temp)
    return {"station": keys, "avg_temp": np.bincount(inv, temp) / count,
            "max_temp": top, "readings": count}


def check_oracle(out: dict, exp: dict) -> None:
    """The tree must agree with the plain computation."""
    np.testing.assert_allclose(out["avg_temp"], exp["avg_temp"], rtol=1e-5)
    np.testing.assert_allclose(out["max_temp"], exp["max_temp"], rtol=1e-6)
    np.testing.assert_array_equal(out["readings"], exp["readings"])


def run(device=None, n: int = ROWS, num_tasks: int = N_TASKS, mesh=None,
        coordinated: bool = True) -> dict:
    """-> frames: the tree's result over ``num_tasks`` tasks in this
    process (``result``) and through the coordinator (``coordinated``),
    each checked against the plain computation; facts: the tree as the
    planner finalized it (``plan``) and the coordinator's verifier codes
    (``verify_warnings``). With ``mesh`` (a `make_mesh()` of this rank)
    the tree runs over the mesh instead, at its size: ``result`` is this
    rank's copy."""
    dev = resolve_device(device)
    arrow = weather(n)
    t = arrow_to_table(arrow, device=dev)
    tasks = mesh.size if mesh is not None else num_tasks
    staged = tree(t, tasks)
    out = result(facts={"plan": staged.display_tree()})
    frames = out["frames"]
    exp = oracle(arrow)
    if mesh is not None:
        frames["result"] = execute_on_mesh(staged, mesh).to_numpy()
    else:
        frames["result"] = execute_tasks(staged, tasks).to_numpy()
    check_oracle(frames["result"], exp)
    if coordinated and mesh is None:
        # the verifier flags the hand-built tree: the gather declares N
        # producer tasks, the partial_reduce stage is fed M partitions
        # (DFTPU031; its N - M extra tasks read nothing). The JAX
        # package's coordinator flags it alike; under strict verification
        # both refuse the tree. Run it in warn mode and report the codes.
        cluster = InMemoryCluster(WORKERS)
        coord = Coordinator(resolver=cluster, channels=cluster,
                            config_options={"verify_plans": "warn"})
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            frames["coordinated"] = coord.execute(staged).to_numpy()
        out["facts"]["verify_warnings"] = sorted({
            code for w in seen for code in _CODE.findall(str(w.message))})
        check_oracle(frames["coordinated"], exp)
    return out


def main(argv=None) -> None:
    args = parser(__doc__, ranks=True).parse_args(argv)
    if args.rank_job is not None:
        raise SystemExit(rank_main(args.rank_job, args.rank, run))
    r = run(args.device)
    print("-- hand-built reduction tree (as finalized by the planner) --")
    print(r["facts"]["plan"])
    print(f"\n-- result ({N_TASKS} tasks in this process) --")
    print(show(r["frames"]["result"]))
    print("\n-- result (through the coordinator; verifier errors "
          f"{r['facts']['verify_warnings']}) --")
    print(show(r["frames"]["coordinated"]))
    if args.ranks:
        got = spawn_ranks(module_name(__file__), args.ranks, args.device)
        print(f"\n-- result (one program over {args.ranks} ranks) --")
        print(show(got["frames"]["result"]))
    print("\nmatches the plain oracle ✓")


if __name__ == "__main__":
    main()
