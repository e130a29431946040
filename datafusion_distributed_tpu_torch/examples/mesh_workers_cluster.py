"""Meshes-as-workers: each worker owns several devices; a stage's tasks on
one worker ship as ONE span plan, and the peer-to-peer data plane moves
partitions between the workers.

The port of `examples/mesh_workers_cluster.py`: SURVEY.md §2.10's
"same-mesh = collective, off-mesh = host RPC" topology, the reference
crate's cluster of multi-threaded workers with each worker's intra-node
parallelism given by a device list instead of a thread pool. On one card
the two workers' eight devices are that card eight times: a span's four
local tasks run one after another on it.

    python -m datafusion_distributed_tpu_torch.examples.mesh_workers_cluster
    python -m datafusion_distributed_tpu_torch.examples.mesh_workers_cluster \\
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
from datafusion_distributed_tpu_torch.runtime.coordinator import Coordinator
from datafusion_distributed_tpu_torch.runtime.mesh_worker import (
    InMemoryMeshCluster,
)
from datafusion_distributed_tpu_torch.sql.context import SessionContext

ROWS = 50_000
WORKERS = 2  # two "hosts"
WIDTH = 4  # devices (tasks) a worker
SQL = ("select c.segment, count(*) n, sum(o.total) revenue "
       "from orders o join customers c on o.custkey = c.custkey "
       "group by c.segment order by revenue desc")


def run(device=None, n: int = ROWS) -> dict:
    """-> frames: the result (``result``) and the single-node result
    (``single``); facts: per worker its mesh width and the span programs
    it ran (``workers``: url -> (width, spans)) and the peer-plane
    boundaries (``peer``); observed: the row bytes those boundaries sent
    through the coordinator (``coordinator_bytes``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    ctx = SessionContext(device=dev)
    ctx.register_arrow("orders", pa.table({
        "custkey": rng.integers(0, 1000, n),
        "total": rng.uniform(1, 1000, n).round(2),
    }))
    ctx.register_arrow("customers", pa.table({
        "custkey": np.arange(1000),
        "segment": np.asarray(
            [f"segment-{i % 5}" for i in range(1000)], dtype=object
        ),
    }))
    ctx.config.distributed_options["bytes_per_task"] = 1  # force fan-out

    # two "hosts", each owning half the devices
    cluster = InMemoryMeshCluster(num_workers=WORKERS,
                                  devices_per_worker=WIDTH,
                                  devices=[dev] * (WORKERS * WIDTH))
    coord = Coordinator(resolver=cluster, channels=cluster)
    df = ctx.sql(SQL)
    out = df._strip_quals(df.collect_coordinated_table(
        coordinator=coord, num_tasks=WORKERS * WIDTH)
    ).to_numpy()
    peer = [m for m in coord.stream_metrics.values()
            if m.get("plane") == "peer"]
    single = df._strip_quals(df.collect_table()).to_numpy()
    assert np.allclose(out["revenue"], single["revenue"], rtol=1e-4), (
        "distributed result diverged from single-node")
    return result(
        frames={"result": out, "single": single},
        facts={"workers": {url: (w.mesh_width, w.spans_run)
                           for url, w in cluster.workers.items()},
               "peer": len(peer)},
        observed={"coordinator_bytes": sum(m["coordinator_bytes"]
                                           for m in peer)})


def main(argv=None) -> None:
    r = run(parser(__doc__).parse_args(argv).device)
    facts = r["facts"]
    print(show(r["frames"]["result"]))
    # each worker ran its stage spans as single span programs:
    for url, (width, spans) in facts["workers"].items():
        print(f"{url}: mesh width {width}, {spans} span programs executed")
    print(f"peer-plane boundaries: {facts['peer']} "
          f"(coordinator row bytes: {r['observed']['coordinator_bytes']})")
    print("matches single-node execution")


if __name__ == "__main__":
    main()
