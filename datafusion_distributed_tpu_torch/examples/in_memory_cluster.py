"""SQL over an in-process multi-worker cluster.

The port of `examples/in_memory_cluster.py` (the reference crate's
`examples/in_memory_cluster.rs`): a full coordinator/worker topology faked
inside one process. Same planner, codec and task lifecycle as a real
cluster, no sockets; every worker runs its tasks on the session's device.

    python -m datafusion_distributed_tpu_torch.examples.in_memory_cluster
    python -m datafusion_distributed_tpu_torch.examples.in_memory_cluster \\
        --device cpu
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from datafusion_distributed_tpu_torch.examples._common import (
    parser,
    result,
    show,
)
from datafusion_distributed_tpu_torch.ops.table import resolve_device
from datafusion_distributed_tpu_torch.runtime.coordinator import (
    Coordinator,
    InMemoryCluster,
)
from datafusion_distributed_tpu_torch.sql.context import SessionContext

ROWS = 10_000
WORKERS = 3
TASKS = 4
SQL = ("select region, count(*) as orders, sum(amount) as revenue "
       "from orders group by region order by revenue desc")


def run(device=None, n: int = ROWS) -> dict:
    """-> frames ``result``; facts: the staged plan's text (``plan``) and
    the worker task metrics the coordinator collected (``metrics``)."""
    rng = np.random.default_rng(0)
    ctx = SessionContext(device=resolve_device(device))
    ctx.register_arrow("orders", pa.table({
        "o_id": np.arange(n),
        "region": rng.integers(0, 5, n),
        "amount": np.round(rng.uniform(1, 500, n), 2),
    }))
    cluster = InMemoryCluster(num_workers=WORKERS)
    coordinator = Coordinator(resolver=cluster, channels=cluster)
    df = ctx.sql(SQL)
    plan = df.explain_distributed(num_tasks=TASKS)
    out = df._strip_quals(df.collect_coordinated_table(
        coordinator=coordinator, num_tasks=TASKS)).to_numpy()
    return result(frames={"result": out},
                  facts={"plan": plan, "metrics": len(coordinator.metrics)})


def main(argv=None) -> None:
    r = run(parser(__doc__).parse_args(argv).device)
    print("-- staged plan --")
    print(r["facts"]["plan"])
    print("-- result --")
    print(show(r["frames"]["result"]))
    print(f"\nworker task metrics collected: {r['facts']['metrics']}")


if __name__ == "__main__":
    main()
