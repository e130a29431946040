"""Rolling upgrade with REAL drain on an elastic cluster.

The port of `examples/versioned_rolling_upgrade.py` (the reference crate's
`examples/localhost_versioned_run` pair): workers advertise a version, and
a coordinator built with an ``expected_version`` refuses to ship plans to a
mixed-version cluster. The membership layer underneath is `DynamicCluster`:
each worker is upgraded by DRAINING it (no new tasks; in-flight work
finishes; removed only when empty), then adding its upgraded replacement,
which becomes routable immediately. The cluster serves queries through the
whole roll; the version-pinned coordinator is the safety rail that refuses
the mixed-fleet window.

    python -m datafusion_distributed_tpu_torch.examples.versioned_rolling_upgrade
    python -m datafusion_distributed_tpu_torch.examples.versioned_rolling_upgrade \\
        --device cpu
"""

from __future__ import annotations

import time

import numpy as np
import pyarrow as pa

from datafusion_distributed_tpu_torch.examples._common import (
    head,
    parser,
    result,
    show,
)
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec
from datafusion_distributed_tpu_torch.ops.sort import SortKey
from datafusion_distributed_tpu_torch.ops.table import resolve_device
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
    DynamicCluster,
)
from datafusion_distributed_tpu_torch.runtime.errors import WorkerError
from datafusion_distributed_tpu_torch.runtime.worker import Worker

ROWS = 5_000
OLD, NEW = "1.0.3", "1.1.0"
WORKERS = 3  # also the plan's task count


def run(device=None, n: int = ROWS) -> dict:
    """-> what the roll observed. Frames: the result served before the
    roll (``before``), after each drain-and-replace step (``step i``) and
    by the pinned coordinator on the finished fleet (``after``). Facts:
    the fleet's epoch first and after each step (``epochs``), each step's
    drained url and its in-flight tasks at removal (``drained``), the
    pinned coordinator's refusal in the mixed-fleet window (``refusal``)
    and the finished fleet's membership (``snapshot``). Observed: each
    drain's wait in seconds (``drain_wait_s``, by url)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    arrow = pa.table({
        "shard": rng.integers(0, 6, n),
        "latency_ms": rng.exponential(20.0, n),
    })
    t = arrow_to_table(arrow, device=dev)
    plan = SortExec(
        [SortKey("shard")],
        HashAggregateExec(
            "single", ["shard"],
            [AggSpec("avg", "latency_ms", "avg_ms"),
             AggSpec("count_star", None, "n")],
            MemoryScanExec([t], t.schema()),
        ),
    )
    dplan = distribute_plan(plan, DistributedConfig(num_tasks=WORKERS))

    cluster = DynamicCluster()
    for i in range(WORKERS):
        cluster.add_worker(Worker(f"mem://w{i}-{OLD}", version=OLD,
                                  device=dev))
    serving = Coordinator(resolver=cluster, channels=cluster)
    pinned_new = Coordinator(
        resolver=cluster, channels=cluster, expected_version=NEW,
    )
    out = result(
        frames={"before": serving.execute(dplan).to_numpy()},
        facts={"epochs": [cluster.membership_epoch], "drained": [],
               "refusal": None},
        observed={"drain_wait_s": {}})
    frames, facts = out["frames"], out["facts"]
    for i, url in enumerate(cluster.get_urls()):
        cluster.drain_worker(url)
        t0 = time.perf_counter()
        assert cluster.wait_drained(url, timeout_s=10.0), (
            f"{url} did not drain"
        )
        out["observed"]["drain_wait_s"][url] = time.perf_counter() - t0
        facts["drained"].append((url, cluster.in_flight(url)))
        cluster.add_worker(Worker(f"mem://w{i}-{NEW}", version=NEW,
                                  device=dev))
        facts["epochs"].append(cluster.membership_epoch)
        # the cluster keeps serving mid-roll: routing sees live membership
        frames[f"step {i}"] = serving.execute(dplan).to_numpy()
        assert len(frames[f"step {i}"]["shard"]) == 6
        if i == 0:
            # mixed-fleet window: the version-pinned coordinator refuses
            try:
                pinned_new.execute(dplan)
                raise AssertionError("version skew not detected")
            except WorkerError as e:
                facts["refusal"] = str(e)
    facts["snapshot"] = cluster.membership_snapshot()
    frames["after"] = pinned_new.execute(dplan).to_numpy()
    assert len(frames["after"]["shard"]) == 6
    return out


def main(argv=None) -> None:
    r = run(parser(__doc__).parse_args(argv).device)
    facts = r["facts"]
    print(f"-- fleet on {OLD}, epoch {facts['epochs'][0]} --")
    print(show(head(r["frames"]["before"], 3)))
    print("\n-- rolling upgrade, one worker at a time (drain -> replace) --")
    for i, (url, in_flight) in enumerate(facts["drained"]):
        print(f"drained+removed {url} (in-flight at removal: {in_flight})")
        if i == 0:
            print("mixed fleet: pinned coordinator rejected "
                  f"({facts['refusal']})")
    snap = facts["snapshot"]
    print(f"\n-- roll complete: epoch {snap['epoch']}, "
          f"active={snap['active']} --")
    print(show(r["frames"]["after"]))


if __name__ == "__main__":
    main()
