"""Runtime work-unit feeding of a scan.

The port of `examples/work_unit_feed.py` (the reference crate's
`examples/work_unit_feed.rs`): the coordinator discovers units of work
(here: parquet file paths) WHILE the query runs and streams them to worker
tasks in chunks of 256; only the feed's id crosses the wire with the plan.
Each unit carries the four lifecycle timestamps
(created/sent/received/processed). The fed rows land on the scan's device.

    python -m datafusion_distributed_tpu_torch.examples.work_unit_feed
    python -m datafusion_distributed_tpu_torch.examples.work_unit_feed \\
        --device cpu
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from datafusion_distributed_tpu_torch.examples._common import parser, result
from datafusion_distributed_tpu_torch.io.parquet import schema_from_arrow
from datafusion_distributed_tpu_torch.ops.table import (
    resolve_device,
    round_up_pow2,
)
from datafusion_distributed_tpu_torch.plan.physical import execute_plan
from datafusion_distributed_tpu_torch.runtime.work_unit_feed import (
    RemoteWorkUnitFeedRegistry,
    WorkUnitFeedRegistry,
    WorkUnitScanExec,
    stream_feed,
)

ROWS = 100
FILES = 4


def run(device=None, n: int = ROWS) -> dict:
    """-> facts: the units streamed (``sent``), the rows fed (``rows``),
    their ``sum(x)`` (``sum``) and the expected sum (``expected``). The ``n``
    rows of x = 0..n-1 are written as FILES parquet files (n / FILES rows
    each) under a temporary directory, removed afterwards."""
    dev = resolve_device(device)
    per = n // FILES
    # "discovered" inputs: parquet files written over time
    tmp = tempfile.mkdtemp(prefix="wuf_")
    try:
        paths = []
        for i in range(FILES):
            p = os.path.join(tmp, f"part{i}.parquet")
            x = np.arange(i * per, (i + 1) * per)
            pq.write_table(pa.table({"x": x}), p)
            paths.append(p)

        registry = WorkUnitFeedRegistry()
        feed_id = registry.register(lambda: iter(paths))
        remote = RemoteWorkUnitFeedRegistry()

        schema = schema_from_arrow(pq.read_schema(paths[0]))
        scan = WorkUnitScanExec(feed_id, schema,
                                capacity=max(128, round_up_pow2(per * FILES)),
                                remote_registry=remote, device=dev)

        # coordinator side: route every unit to task 0 and close the feed
        sent = stream_feed(
            registry, remote, feed_id,
            task_router=lambda unit, n: 0, task_count=1,
        )
        out = execute_plan(scan)
        rows = int(out.num_rows)
        total = int(np.asarray(out.to_numpy()["x"]).sum(dtype=np.int64))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return result(facts={"sent": sent, "rows": rows, "sum": total,
                         "expected": per * FILES * (per * FILES - 1) // 2})


def main(argv=None) -> None:
    r = run(parser(__doc__).parse_args(argv).device)["facts"]
    print(f"streamed {r['sent']} work units")
    print("rows fed:", r["rows"])
    print("sum(x) =", r["sum"], "(expected", r["expected"], ")")


if __name__ == "__main__":
    main()
