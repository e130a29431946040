"""Real gRPC workers on localhost ports.

The port of `examples/localhost_cluster.py` (the reference crate's
`examples/localhost_run/worker.rs`): every worker is a real network
service; plans ship as binary frames and results stream back chunked
(Arrow IPC, see `runtime/transport.py`), compressed with zstd where this
process has `zstandard`, raw where it has not: the example prints the
codec its frames used. The same code deploys multi-host by starting
`serve_worker` on each machine and pointing the resolver at their URLs.

    python -m datafusion_distributed_tpu_torch.examples.localhost_cluster
    python -m datafusion_distributed_tpu_torch.examples.localhost_cluster \\
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
from datafusion_distributed_tpu_torch.runtime import transport
from datafusion_distributed_tpu_torch.runtime.coordinator import Coordinator
from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
    start_localhost_cluster,
)
from datafusion_distributed_tpu_torch.sql.context import SessionContext

ROWS = 20_000
WORKERS = 2
TASKS = 4
SQL = ("select kind, count(*) n, avg(ms) avg_ms, max(ms) worst "
       "from events group by kind order by kind")


def run(device=None, n: int = ROWS) -> dict:
    """-> frames ``result``; facts: the number of workers (``workers``)
    and the wire codec of this process (``codec``); observed: the workers'
    urls (``urls``) and what crossed the wire during the query (``wire``:
    `transport.wire_stats()`)."""
    dev = resolve_device(device)
    cluster = start_localhost_cluster(num_workers=WORKERS, device=dev)
    try:
        rng = np.random.default_rng(1)
        ctx = SessionContext(device=dev)
        ctx.register_arrow("events", pa.table({
            "kind": rng.integers(0, 8, n),
            "ms": rng.exponential(20.0, n),
        }))
        coordinator = Coordinator(resolver=cluster, channels=cluster)
        df = ctx.sql(SQL)
        transport.reset_wire_stats()
        out = df._strip_quals(df.collect_coordinated_table(
            coordinator=coordinator, num_tasks=TASKS)).to_numpy()
        urls = cluster.get_urls()
        return result(
            frames={"result": out},
            facts={"workers": len(urls),
                   "codec": transport.effective_codec("zstd")},
            observed={"urls": urls, "wire": transport.wire_stats()})
    finally:
        cluster.shutdown()


def main(argv=None) -> None:
    r = run(parser(__doc__).parse_args(argv).device)
    wire = r["observed"]["wire"]
    print("workers:", r["observed"]["urls"])
    print(show(r["frames"]["result"]))
    print(f"\nwire codec: {r['facts']['codec']}; {wire['frames']} frames, "
          f"{wire['wire_bytes']} B framed")


if __name__ == "__main__":
    main()
