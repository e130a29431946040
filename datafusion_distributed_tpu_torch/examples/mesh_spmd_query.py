"""A whole distributed query over tasks on the device, and as one program
over a process group.

The port of `examples/mesh_spmd_query.py`. The staged plan (scan ->
broadcast join -> partial agg -> shuffle -> final agg -> coalesce) runs
over 8 tasks in this process: `collect_distributed_table(num_tasks=8)`
runs the tasks one after another on the session's device, each exchange
moving every task's partitions at once (`runtime/mesh_executor.py`
`execute_tasks`); it is not one program, as the JAX package's mesh run
is. With ``--ranks R`` the same plan also runs as one SPMD program over R
spawned processes of a torch.distributed group, one rank a task, its
exchanges as collectives (`make_mesh`,
`collect_distributed_table(mesh=...)`).

    python -m datafusion_distributed_tpu_torch.examples.mesh_spmd_query
    python -m datafusion_distributed_tpu_torch.examples.mesh_spmd_query \\
        --device cpu --ranks 4
"""

from __future__ import annotations

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
from datafusion_distributed_tpu_torch.ops.table import resolve_device
from datafusion_distributed_tpu_torch.sql.context import SessionContext

ROWS = 50_000
TASKS = 8
SQL = ("select s.state, sum(x.qty) total "
       "from sales x, stores s where x.store = s.store_id "
       "group by s.state order by total desc")


def session(device, n: int) -> SessionContext:
    rng = np.random.default_rng(2)
    ctx = SessionContext(device=device)
    ctx.register_arrow("sales", pa.table({
        "store": rng.integers(0, 50, n),
        "item": rng.integers(0, 500, n),
        "qty": rng.integers(1, 20, n).astype(np.int32),
    }))
    ctx.register_arrow("stores", pa.table({
        "store_id": np.arange(50),
        "state": rng.integers(0, 10, 50),
    }))
    return ctx


def run(device=None, n: int = ROWS, num_tasks: int = TASKS,
        mesh=None) -> dict:
    """-> frames ``result`` over ``num_tasks`` tasks in this process, or,
    with ``mesh`` (a `make_mesh()` of this rank), over the mesh: this
    rank's copy of the replicated result; facts: the staged plan's text
    (``plan``)."""
    dev = resolve_device(device)
    df = session(dev, n).sql(SQL)
    tasks = mesh.size if mesh is not None else num_tasks
    plan = df.explain_distributed(num_tasks=tasks)
    got = (df.collect_distributed_table(mesh=mesh) if mesh is not None
           else df.collect_distributed_table(num_tasks=tasks))
    return result(frames={"result": df._strip_quals(got).to_numpy()},
                  facts={"plan": plan})


def main(argv=None) -> None:
    args = parser(__doc__, ranks=True).parse_args(argv)
    if args.rank_job is not None:
        raise SystemExit(rank_main(args.rank_job, args.rank, run))
    dev = resolve_device(args.device)
    print("device:", dev)
    r = run(dev)
    print("-- staged plan --")
    print(r["facts"]["plan"])
    print(f"-- result ({TASKS} tasks in this process) --")
    print(show(r["frames"]["result"]))
    if args.ranks:
        got = spawn_ranks(module_name(__file__), args.ranks, dev)
        print(f"-- result (one SPMD program over {args.ranks} ranks) --")
        print(show(got["frames"]["result"]))


if __name__ == "__main__":
    main()
