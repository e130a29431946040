"""The port's peer data plane (consumer tasks pull shuffle and broadcast
inputs straight from the producer workers; the coordinator ships plans
only) against the reference's, on the CPU: the counterpart of
tests/test_peer_plane.py.

Every case runs both packages on the same seeded join input (20,000 fact
rows over 50 keys, a 50-row dimension with string names) and compares what
each observes: the result with its capacity, each peer boundary's stream
metrics (plane, coordinator bytes, which must be zero), the workers' store
and registry after the query and after the failure sweep, the broadcast
boundary, the plane switched off, the union arm pinned to one task, the
plane over localhost gRPC (the port's workers on ``device="cpu"``), and a
peer producer that outlives the registry's TTL.
"""

import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_matches_reference,
    identical,
)

torch.set_num_threads(1)

JOIN_SQL = ("select u.name, sum(t.v) s, count(*) c from t join u on t.k = u.k "
            "group by u.name order by s desc")


def _join_ctx(P, n=20_000, seed=0, **opts):
    rng = np.random.default_rng(seed)
    ctx = P.ctx()
    ctx.register_arrow("t", pa.table({"k": rng.integers(0, 50, n),
                                      "v": rng.normal(size=n)}))
    ctx.register_arrow("u", pa.table({
        "k": np.arange(50),
        "name": np.asarray([f"name{i:02d}" for i in range(50)],
                           dtype=object)}))
    ctx.config.distributed_options.update(bytes_per_task=1, **opts)
    return ctx


def _peer(coord) -> list:
    """The peer boundaries' metrics, stage by stage, without rates."""
    return [(sid, {k: v for k, v in m.items()
                   if k in ("plane", "coordinator_bytes", "consumers",
                            "producers")})
            for (_q, sid), m in sorted(coord.stream_metrics.items())
            if m.get("plane") == "peer"]


def _worker_state(cluster) -> list:
    return [(url, len(w.registry), len(w.table_store.tables))
            for url, w in sorted(cluster.workers.items())]


def _run(P, ctx, workers=3, tasks=4, **opts):
    rt = P("runtime.coordinator")
    cluster = rt.InMemoryCluster(workers)
    coord = rt.Coordinator(resolver=cluster, channels=cluster,
                           config_options=opts)
    df = ctx.sql(JOIN_SQL)
    out = df._strip_quals(df.collect_coordinated_table(coordinator=coord,
                                                       num_tasks=tasks))
    return out, _peer(coord), _worker_state(cluster)


@pytest.mark.parametrize("name,seed,opts", [
    ("coshuffled", 0, {"broadcast_joins": False}),
    ("default_join", 1, {}),
    ("broadcast", 3, {"broadcast_joins": True,
                      "broadcast_threshold_rows": 1 << 17}),
])
def test_peer_boundaries_move_no_coordinator_bytes(name, seed, opts):
    got = {P: _run(P, _join_ctx(P, seed=seed, **opts)) for P in BOTH}
    assert_matches_reference(got[REF][0], got[PORT][0], name)
    assert got[PORT][1:] == got[REF][1:]
    peer = got[PORT][1]
    assert peer and all(m["coordinator_bytes"] == 0 for _s, m in peer)
    if name == "coshuffled":
        assert len(peer) >= 2
    # every worker's store and registry are empty after the query
    assert all(r == t == 0 for _u, r, t in got[PORT][2])


def test_peer_plane_failure_sweep_releases_producers():
    got = {}
    for P in BOTH:
        ctx = _join_ctx(P, seed=2, broadcast_joins=False)
        cluster = P("runtime.coordinator").InMemoryCluster(2)
        target = cluster.workers["mem://worker-0"]
        calls = {"n": 0}
        real = target.set_plan

        def flaky_set_plan(*a, calls=calls, real=real, **kw):
            calls["n"] += 1
            if calls["n"] >= 3:
                raise RuntimeError("injected plan-ship failure")
            return real(*a, **kw)

        target.set_plan = flaky_set_plan
        coord = P("runtime.coordinator").Coordinator(resolver=cluster,
                                                     channels=cluster)
        df = ctx.sql(JOIN_SQL)
        with pytest.raises(Exception, match="injected") as ei:
            df.collect_coordinated_table(coordinator=coord, num_tasks=4)
        target.set_plan = real
        assert calls["n"] >= 3, P
        got[P] = (type(ei.value).__name__, _worker_state(cluster))
    assert got[PORT] == got[REF]
    assert all(r == t == 0 for _u, r, t in got[PORT][1])


def test_peer_plane_config_off_restores_coordinator_plane():
    got = {}
    for P in BOTH:
        ctx = _join_ctx(P, seed=4, broadcast_joins=False)
        on = _run(P, ctx)
        off = _run(P, ctx, peer_shuffle=False)
        assert identical(on[0].to_numpy(), off[0].to_numpy()), P
        assert on[1] and not off[1], P
        got[P] = (on, off)
    for i in (0, 1):
        assert_matches_reference(got[REF][i][0], got[PORT][i][0], str(i))
        assert got[PORT][i][1:] == got[REF][i][1:]


def test_peer_union_isolated_arm_pulls_all_partitions():
    rng = np.random.default_rng(5)
    n = 8_000
    a = pa.table({"k": rng.integers(0, 30, n), "v": rng.normal(size=n)})
    b = pa.table({"k": rng.integers(0, 30, n), "v": rng.normal(size=n)})
    sql = ("select k, sum(v) s from (select k, v from a union all "
           "select k, v from b) u group by k order by k")
    got = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.register_arrow("a", a)
        ctx.register_arrow("b", b)
        ctx.config.distributed_options["bytes_per_task"] = 1
        rt = P("runtime.coordinator")
        cluster = rt.InMemoryCluster(3)
        coord = rt.Coordinator(resolver=cluster, channels=cluster)
        df = ctx.sql(sql)
        got[P] = (df._strip_quals(df.collect_coordinated_table(
            coordinator=coord, num_tasks=4)), _peer(coord),
            df._strip_quals(df.collect_table()))
    assert_matches_reference(got[REF][0], got[PORT][0], "union arm")
    assert got[PORT][1] == got[REF][1]
    a_, b_ = got[PORT][0].to_numpy(), got[PORT][2].to_numpy()
    np.testing.assert_array_equal(a_["k"], b_["k"])
    np.testing.assert_allclose(a_["s"], b_["s"], rtol=2e-5, atol=1e-6)


def test_peer_plane_over_grpc_cluster():
    pytest.importorskip("grpc")
    got = {}
    for P in BOTH:
        ctx = _join_ctx(P, n=6_000, seed=6, broadcast_joins=False)
        kw = {"device": "cpu"} if P is PORT else {}
        cluster = P("runtime.grpc_worker").start_localhost_cluster(2, **kw)
        try:
            coord = P("runtime.coordinator").Coordinator(resolver=cluster,
                                                         channels=cluster)
            df = ctx.sql(JOIN_SQL)
            out = df._strip_quals(df.collect_coordinated_table(
                coordinator=coord, num_tasks=2))
            stores = [len(w.table_store.tables)
                      for w in cluster.local_workers]
            got[P] = (out, _peer(coord), stores)
        finally:
            cluster.shutdown()
    assert_matches_reference(got[REF][0], got[PORT][0], "gRPC")
    assert got[PORT][1:] == got[REF][1:]
    assert got[PORT][1] and all(m["coordinator_bytes"] == 0
                                for _s, m in got[PORT][1])
    assert got[PORT][2] == [0, 0]


def test_peer_producer_outlives_registry_ttl():
    got = {}
    for P in BOTH:
        worker = P("runtime.worker")
        w = worker.Worker(ttl_seconds=0.2)
        t = P.table(pa.table({"x": np.arange(32)}))
        scan = P("plan.physical").MemoryScanExec
        enc = P("runtime.codec").encode_plan
        plan_a = enc(scan([t], t.schema()), w.table_store)
        plan_b = enc(scan([t], t.schema()), w.table_store)
        w.set_plan(worker.TaskKey("q", 0, 0), plan_a, 1, ttl=60.0)
        w.set_plan(worker.TaskKey("q", 0, 1), plan_b, 1)
        time.sleep(0.5)
        kept = w.registry.get(worker.TaskKey("q", 0, 0)) is not None
        out = w.execute_task(worker.TaskKey("q", 0, 0))
        expired = w.registry.get(worker.TaskKey("q", 0, 1)) is None
        got[P] = (kept, int(out.num_rows), expired, out.to_numpy())
    assert got[PORT][:3] == got[REF][:3] == (True, 32, True)
    assert identical(got[PORT][3], got[REF][3])
