"""User-controlled task->worker routing.

The port of `examples/custom_worker_routing.py` (the reference crate's
`examples/custom_worker_url_routing.rs`): by default tasks round-robin over
workers; a ``route_tasks`` hook pins them (data locality, heterogeneous
hardware, tenancy). Here even stages go to worker 0, odd to worker 1, and
the routing log proves it; each worker also logs the tasks whose plans it
was handed, which must be the routed ones.

    python -m datafusion_distributed_tpu_torch.examples.custom_worker_routing
    python -m datafusion_distributed_tpu_torch.examples.custom_worker_routing \\
        --device cpu
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from datafusion_distributed_tpu_torch.examples._common import (
    head,
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

ROWS = 5_000
WORKERS = 2
TASKS = 4
SQL = "select k, sum(v) sv from t group by k order by sv desc"


def route_by_stage(routes: list):
    """The hook: ``(query_id, stage_id, task_number, urls) -> url``, every
    decision appended to ``routes`` as (stage, task, url)."""

    def route(query_id, stage_id, task_number, urls):
        url = urls[abs(stage_id) % len(urls)]
        routes.append((stage_id, task_number, url))
        return url

    return route


def _log_plans(cluster, ran: list) -> None:
    """Wrap every worker's set_plan to log (stage, task, url) of each task
    plan it receives."""
    for url, w in cluster.workers.items():
        def set_plan(key, *a, _real=w.set_plan, _url=url, **kw):
            ran.append((key.stage_id, key.task_number, _url))
            return _real(key, *a, **kw)

        w.set_plan = set_plan


def run(device=None, n: int = ROWS, bytes_per_task=None) -> dict:
    """-> frames ``result``; facts: the hook's decisions (``routes``:
    (stage, task, url), sorted) and the tasks the workers were handed
    (``ran``, the same triples, sorted). ``bytes_per_task`` (the session
    option; 1 fans every stage out) gives the plan several stages."""
    rng = np.random.default_rng(3)
    ctx = SessionContext(device=resolve_device(device))
    ctx.register_arrow("t", pa.table({
        "k": rng.integers(0, 30, n), "v": rng.normal(size=n),
    }))
    if bytes_per_task is not None:
        ctx.config.distributed_options["bytes_per_task"] = bytes_per_task
    routes: list = []
    ran: list = []
    cluster = InMemoryCluster(WORKERS)
    _log_plans(cluster, ran)
    coordinator = Coordinator(
        resolver=cluster, channels=cluster,
        route_tasks=route_by_stage(routes))
    df = ctx.sql(SQL)
    out = df._strip_quals(df.collect_coordinated_table(
        coordinator=coordinator, num_tasks=TASKS)).to_numpy()
    return result(frames={"result": out},
                  facts={"routes": sorted(routes), "ran": sorted(ran)})


def main(argv=None) -> None:
    r = run(parser(__doc__).parse_args(argv).device)
    print(show(head(r["frames"]["result"], 5)))
    print("\nrouting decisions (stage, task) -> worker:")
    for stage, task, url in r["facts"]["routes"]:
        print(f"  ({stage}, {task}) -> {url}")


if __name__ == "__main__":
    main()
