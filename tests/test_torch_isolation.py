"""The port stands alone: it imports neither jax nor the reference package,
runs a TPC-H query, a window query, a prepared-statement binding, a
ClickBench query, a one-task staged plan with a fused multiway join, the
same plan over four tasks (runtime/mesh_executor.py, its exchanges) and
through the coordinator over four in-memory workers, static and adaptive
(runtime/coordinator.py and the runtime modules it loads), through the
serving tier (runtime/serving.py, with the spill, checkpoint, result-cache
and chaos modules imported) and over a `DynamicCluster` that loses a
worker mid-query with hedging on, read through the observability service,
and over two localhost gRPC workers on the shm plane (runtime/grpc_worker.py,
shm_plane.py, transport.py, native/), traced (`ctx.last_trace()`), and through
a work-unit feed (runtime/work_unit_feed.py), with the console, the cli and
the lock-order harness imported, on the CPU when asked to, and refuses to
start without a CUDA device otherwise; and that pyarrow's allocator
survives the gRPC tier's threads: three fresh localhost gRPC clusters in a
row, on both wire planes, with jax blocked, and a thread that loads nothing
first."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from datafusion_distributed_tpu_torch.ops import table as ttable
from datafusion_distributed_tpu_torch.sql.context import SessionContext

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "datafusion_distributed_tpu_torch"

_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import torch
    torch.set_num_threads(1)
    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.sql.context import SessionContext
    ctx = SessionContext(device="cpu")
    tpchgen.register_tpch(ctx, 0.001, 7)
    sql = open("benchmarks/queries/tpch/q6.sql").read()
    out = ctx.sql(sql).collect_table().to_numpy()
    assert len(out["revenue"]) == 1 and out["revenue"][0] > 0, out
    w = ctx.sql("select o_custkey, row_number() over (partition by "
                "o_custkey order by o_orderdate) rn from orders "
                "order by o_custkey, rn").collect_table().to_numpy()
    assert w["rn"].min() == 1 and len(w["rn"]) > 0, w
    stmt = ctx.prepare(sql.replace("< 24", "< $1"))
    bound = stmt.to_df([24]).collect_table().to_numpy()
    assert bound["revenue"].tobytes() == out["revenue"].tobytes()
    from datafusion_distributed_tpu_torch.data import clickbenchgen
    clickbenchgen.register_clickbench(ctx, 1000, 3)
    cb = ctx.sql(open("benchmarks/queries/clickbench/q9.sql").read())
    assert len(cb.collect_table().to_numpy()["RegionID"]) == 10
    ctx.sql("SET distributed.multiway_join = true")
    star = ("select s_nationkey, count(*) n from lineitem join orders on "
            "l_orderkey = o_orderkey join part on l_partkey = p_partkey "
            "join supplier on l_suppkey = s_suppkey group by s_nationkey "
            "order by s_nationkey")
    sdf = ctx.sql(star)
    assert "MultiwayHashJoin" in sdf.explain_distributed(1)
    assert "stage 0 boundary" in sdf.explain_distributed(4)
    staged = sdf.collect_distributed_table(1).to_numpy()
    assert staged["n"].tobytes() == \
        ctx.sql(star).collect_table().to_numpy()["n"].tobytes()
    four = ctx.sql(star).collect_distributed_table(4).to_numpy()
    assert four["n"].tobytes() == staged["n"].tobytes()
    assert "datafusion_distributed_tpu_torch.runtime.mesh_executor" in \
        sys.modules
    for adaptive in (False, True):
        coord = ctx.sql(star).collect_coordinated_table(
            num_workers=4, num_tasks=4, adaptive=adaptive).to_numpy()
        assert coord["n"].tobytes() == staged["n"].tobytes()
    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )
    with ServingSession(ctx, num_workers=2, num_tasks=2) as srv:
        served = srv.submit(star).result_table(timeout=120).to_numpy()
    assert served["n"].tobytes() == staged["n"].tobytes()
    from datafusion_distributed_tpu_torch.runtime.chaos import (
        FaultPlan, MembershipEvent, wrap_cluster,
    )
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator, DynamicCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.observability import (
        ObservabilityService,
    )
    cluster = DynamicCluster(3)
    chaos = wrap_cluster(cluster, FaultPlan(7, [], membership=[
        MembershipEvent("leave", "mem://worker-1", site="execute")]))
    coord = Coordinator(resolver=chaos, channels=chaos,
                        config_options={"hedging": True})
    churned = ctx.sql(star).collect_coordinated_table(
        coordinator=coord, num_tasks=4).to_numpy()
    assert churned["n"].tobytes() == staged["n"].tobytes()
    mem = ObservabilityService(cluster, cluster).get_membership()
    assert mem["epoch"] == cluster.membership_epoch
    assert mem["departed"] == ["mem://worker-1"]
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )
    grpc_cluster = start_localhost_cluster(2, device="cpu",
                                           rpc_timeout_s=120)
    try:
        coord = Coordinator(resolver=grpc_cluster, channels=grpc_cluster,
                            config_options={"data_plane": "shm"})
        wired = ctx.sql(star).collect_coordinated_table(
            coordinator=coord, num_tasks=4).to_numpy()
    finally:
        grpc_cluster.shutdown()
    assert wired["n"].tobytes() == staged["n"].tobytes()
    ctx.sql("SET distributed.tracing = 'on'")
    traced = ctx.sql(star).collect_coordinated_table(
        num_workers=2, num_tasks=2).to_numpy()
    assert traced["n"].tobytes() == staged["n"].tobytes()
    assert ctx.last_trace()["traceEvents"]
    assert ctx.last_trace_profile().startswith("-- trace profile")
    ctx.sql("SET distributed.tracing = 'off'")
    import os, tempfile
    import pyarrow as pa
    import pyarrow.parquet as pq
    from datafusion_distributed_tpu_torch.io.parquet import schema_from_arrow
    from datafusion_distributed_tpu_torch.plan.physical import execute_plan
    from datafusion_distributed_tpu_torch.runtime import work_unit_feed as wuf
    tmp = tempfile.mkdtemp()
    paths = []
    for i in range(4):
        paths.append(os.path.join(tmp, f"part{i}.parquet"))
        pq.write_table(pa.table({"x": list(range(i * 25, (i + 1) * 25))}),
                       paths[-1])
    feeds = wuf.WorkUnitFeedRegistry()
    fid = feeds.register(lambda: iter(paths))
    remote = wuf.RemoteWorkUnitFeedRegistry()
    assert wuf.stream_feed(feeds, remote, fid, lambda u, n: 0, 1) == 4
    fed = execute_plan(wuf.WorkUnitScanExec(
        fid, schema_from_arrow(pq.read_schema(paths[0])), 128, remote,
        device="cpu")).to_numpy()
    assert int(fed["x"].sum()) == sum(range(100))
    import importlib
    for m in ("errors", "leakcheck", "eventlog", "telemetry", "tracing",
              "metrics", "health", "codec", "worker", "streams", "peer",
              "adaptivity", "coordinator", "spill", "checkpoint",
              "result_cache", "serving", "chaos", "observability",
              "transport", "shm_plane", "grpc_worker", "lockcheck",
              "work_unit_feed", "mesh_worker"):
        importlib.import_module("datafusion_distributed_tpu_torch.runtime."
                                + m)
    for m in ("console", "cli", "data.tpcdsgen"):
        importlib.import_module("datafusion_distributed_tpu_torch." + m)
    importlib.import_module("datafusion_distributed_tpu_torch.native")
    importlib.import_module("datafusion_distributed_tpu_torch.planner."
                            "adaptive")
    assert "verification:" in ctx.sql("EXPLAIN VERIFY " + star)
    loaded = sorted(m for m in sys.modules
                    if m == "datafusion_distributed_tpu"
                    or m.startswith("datafusion_distributed_tpu."))
    assert not loaded, loaded
    assert not any(m == "jax" or m.startswith("jax.")
                   for m, v in sys.modules.items() if v is not None)
    print("ISOLATED-OK")
""")


def test_port_runs_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
        env=env, timeout=300, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED-OK" in proc.stdout


_CLUSTERS_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    import torch
    torch.set_num_threads(1)
    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
    )
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )
    from datafusion_distributed_tpu_torch.sql.context import SessionContext
    ctx = SessionContext(device="cpu")
    tpchgen.register_tpch(ctx, 0.001, 7)
    ctx.sql("SET distributed.multiway_join = true")
    star = ("select s_nationkey, count(*) n from lineitem join orders on "
            "l_orderkey = o_orderkey join part on l_partkey = p_partkey "
            "join supplier on l_suppkey = s_suppkey group by s_nationkey "
            "order by s_nationkey")
    want = ctx.sql(star).collect_table().to_numpy()["n"].tobytes()
    for plane in ("shm", "stream", "shm"):
        cluster = start_localhost_cluster(2, device="cpu", rpc_timeout_s=120)
        try:
            coord = Coordinator(resolver=cluster, channels=cluster,
                                config_options={"data_plane": plane})
            got = ctx.sql(star).collect_coordinated_table(
                coordinator=coord, num_tasks=4).to_numpy()["n"].tobytes()
        finally:
            cluster.shutdown()
        assert got == want, plane
    print("CLUSTERS-OK")
""")


def test_fresh_grpc_clusters_in_a_row_without_jax():
    """The wire tier's stream and handler threads come and go; the first
    of them used to load pyarrow, and a later one crashed in its first
    Arrow allocation (see the package's ``__init__``)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-X", "faulthandler", "-c", _CLUSTERS_SCRIPT],
        capture_output=True, text=True, env=env, timeout=300, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLUSTERS-OK" in proc.stdout


_THREAD_CHURN_SCRIPT = textwrap.dedent("""
    import sys, threading
    sys.modules["jax"] = None
    import numpy as np
    import datafusion_distributed_tpu_torch  # noqa: F401

    def first_use():
        import pyarrow as pa
        pa.array(np.arange(8), mask=np.zeros(8, dtype=bool))

    t = threading.Thread(target=first_use)
    t.start()
    t.join()
    import pyarrow as pa
    assert pa.default_memory_pool().backend_name == "mimalloc"

    def alloc():
        pa.array(np.arange(1000), mask=np.zeros(1000, dtype=bool))

    for _ in range(500):
        t = threading.Thread(target=alloc)
        t.start()
        t.join()
    print("CHURN-OK")
""")


def test_arrow_allocator_survives_thread_churn():
    """Importing the package loads libarrow on the importing thread, so a
    short-lived thread's first use of pyarrow cannot make Arrow's mimalloc
    pool take that thread for the process's main thread (the pool stays
    mimalloc: the fix is the load, not another allocator)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _THREAD_CHURN_SCRIPT], capture_output=True,
        text=True, env=env, timeout=120, cwd=str(REPO),
    )
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-3000:])
    assert "CHURN-OK" in proc.stdout


def test_no_port_module_names_the_reference_package():
    pattern = re.compile(r"\bdatafusion_distributed_tpu\.|\bimport jax\b|"
                         r"\bfrom jax\b")
    offenders = [
        str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert not offenders, offenders


def test_session_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SessionContext()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttable.resolve_device(None)
    assert SessionContext(device="cpu").device.type == "cpu"
