"""The port's observability service (runtime/observability.py) against the
reference's, on the CPU: the same cluster state in both packages, read
through `get_membership`, `get_robustness`, `get_data_plane`,
`get_fault_counters` and `render_openmetrics`, gives the same keys and
values. Byte counts (the staged peaks) and breaker timings are left out:
the two packages lay their tables out differently.

The state: a `DynamicCluster` of 3 workers, 2 failures recorded against
one worker under a threshold of 1 (its breaker open), another worker
draining (the observability half of tests/test_elasticity.py's membership
surface case); then TPC-H q6 (SF 0.002, 4 tasks, the bulk plane, one stage
at a time, warmed up first) over 4 workers under a sticky straggler on
one of them, with hedging on (floor 0.5 s, the straggler's delay 2 s):
every task the straggler holds is hedged and the hedge wins.
"""

import os
import re
from types import SimpleNamespace

import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.runtime import chaos as jchaos
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import health as jhealth
from datafusion_distributed_tpu.runtime import observability as jobs
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.runtime import chaos as tchaos
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import observability as tobs
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import identical

torch.set_num_threads(1)

REF = SimpleNamespace(name="reference", coordinator=jcoord, chaos=jchaos,
                      obs=jobs)
PORT = SimpleNamespace(name="port", coordinator=tcoord, chaos=tchaos,
                       obs=tobs)
PKGS = (REF, PORT)

Q6 = open(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "queries", "tpch",
    "q6.sql")).read()
OPTS = {"bytes_per_task": 1, "task_retry_backoff_s": 0.001,
        "data_plane": "unary", "stage_parallelism": 1}


def _untimed(health: dict) -> dict:
    return {url: {k: v for k, v in s.items() if k != "open_for_s"}
            for url, s in health.items()}


def _membership(p):
    cluster = p.coordinator.DynamicCluster(3)
    urls = cluster.get_urls()
    coord = p.coordinator.Coordinator(
        resolver=cluster, channels=cluster,
        config_options={"quarantine_threshold": 1})
    coord._health_tracker()
    for _ in range(2):
        coord._record_worker_failure(urls[1])
    cluster.drain_worker(urls[2])
    obs = p.obs.ObservabilityService(cluster, cluster, health=coord.health)
    mem = obs.get_membership()
    assert mem["epoch"] == cluster.membership_epoch
    for w in mem["workers"]:
        if "health" in w:
            w["health"] = _untimed({"": w["health"]})[""]
    return mem


def test_get_membership_equals_reference():
    seen = [_membership(p) for p in PKGS]
    assert seen[1] == seen[0]
    mem = seen[0]
    assert mem["active"] == ["mem://worker-0", "mem://worker-1"]
    assert mem["draining"] == ["mem://worker-2"]
    by_url = {w["url"]: w for w in mem["workers"]}
    assert by_url["mem://worker-1"]["health"]["state"] == jhealth.OPEN
    assert by_url["mem://worker-2"]["role"] == "draining"


@pytest.fixture(scope="module")
def hedged():
    """package -> (plain q6, hedged q6, ObservabilityService over the
    hedged run's cluster and coordinator)."""
    arrow = gen_tpch(sf=0.002, seed=7)
    out = {}
    for p, ctx in ((REF, JContext()), (PORT, TContext(device="cpu"))):
        ctx.config.distributed_options["bytes_per_task"] = 1
        for name, tbl in arrow.items():
            ctx.register_arrow(name, tbl)

        def run(cluster, **opts):
            coord = p.coordinator.Coordinator(
                resolver=cluster, channels=cluster,
                config_options={**OPTS, **opts})
            res = ctx.sql(Q6).collect_coordinated_table(
                coordinator=coord, num_tasks=4).to_numpy()
            return res, coord

        base, _c = run(p.coordinator.InMemoryCluster(4))  # warm-up
        cluster = p.coordinator.DynamicCluster(4)
        chaos = p.chaos.wrap_cluster(cluster, p.chaos.FaultPlan(7, [
            p.chaos.FaultSpec(site="execute", kind="straggler",
                              delay_s=2.0, rate=1.0,
                              workers=["mem://worker-1"])]))
        got, coord = run(chaos, hedging=True, hedge_floor_s=0.5,
                         hedge_budget=2)
        obs = p.obs.ObservabilityService(
            cluster, cluster, health=coord.health,
            fault_counters=coord.faults)
        out[p.name] = (base, got, obs)
    return out


def test_hedged_run_equals_its_plain_run(hedged):
    for name, (base, got, _obs) in hedged.items():
        assert identical(base, got), name


def test_get_robustness_and_fault_counters_equal_reference(hedged):
    rob = [hedged[p.name][2].get_robustness() for p in PKGS]
    fc = [hedged[p.name][2].get_fault_counters() for p in PKGS]
    assert rob[1] == rob[0]
    assert fc[1] == fc[0]
    h = rob[0]["hedging"]
    assert h["hedges_issued"] >= 1 and h["hedges_won"] == h["hedges_issued"]
    assert h["hedges_lost"] == h["hedge_budget_denied"] == 0


def test_get_data_plane_equals_reference(hedged):
    planes = []
    for p in PKGS:
        dp = hedged[p.name][2].get_data_plane()
        drop = ("peak_nbytes",)
        planes.append((
            {k: v for k, v in dp.items() if k not in drop + ("workers",)},
            {url: {k: v for k, v in s.items() if k not in drop}
             for url, s in dp["workers"].items()},
        ))
    assert planes[1] == planes[0]
    totals = planes[0][0]
    assert totals["nbytes"] == totals["entries"] == totals["views"] == 0


def _exposition(text: str) -> list:
    """OpenMetrics lines without timings (the breaker's open time, the
    workers' execute-time histograms)."""
    return [line for line in text.splitlines()
            if not re.search(r"open_for|_seconds", line)]


def test_render_openmetrics_equals_reference(hedged):
    texts = [_exposition(hedged[p.name][2].render_openmetrics())
             for p in PKGS]
    assert texts[1] == texts[0]
    assert any('kind="hedges_won"' in line for line in texts[0])
