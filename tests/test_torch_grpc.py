"""The port's gRPC worker tier (runtime/grpc_worker.py) on the CPU, against
the reference's: the port's counterparts of the gRPC cases of
tests/test_runtime.py (3), tests/test_fault_tolerance.py (2),
tests/test_peer_plane.py, tests/test_telemetry.py and tests/test_tracing.py,
plus the devices the tier decodes onto and one `DFTPU_PRECISION=x64`
subprocess case (q1 and q3 coordinated over the port's gRPC cluster
against the reference's).

Every server binds 127.0.0.1:0 and is shut down in the test's teardown;
every RPC the clients make carries a deadline (`rpc_timeout_s`). Every
test runs with the port's leak checker armed in strict mode.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import errors as jerrors
from datafusion_distributed_tpu.runtime import worker as jworker
from datafusion_distributed_tpu_torch import precision
from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
from datafusion_distributed_tpu_torch.plan.physical import (
    HashAggregateExec,
    MemoryScanExec,
)
from datafusion_distributed_tpu_torch.planner.distributed import (
    DistributedConfig,
    distribute_plan,
)
from datafusion_distributed_tpu_torch.runtime import leakcheck as tleak
from datafusion_distributed_tpu_torch.runtime.coordinator import (
    Coordinator,
    InMemoryCluster,
)
from datafusion_distributed_tpu_torch.runtime.errors import (
    WorkerError,
    WorkerUnavailableError,
    is_retryable,
)
from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
    GrpcCluster,
    GrpcWorkerClient,
    start_localhost_cluster,
)
from datafusion_distributed_tpu_torch.runtime.observability import (
    ObservabilityService,
)
from datafusion_distributed_tpu_torch.runtime.worker import TaskKey, Worker
from datafusion_distributed_tpu_torch.sql.context import SessionContext
from tests.test_torch_runtime import J, T, _arrow, _staged
from tests.torch_port_helpers import assert_results_equal, identical

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCH_DIR = os.path.join(REPO, "benchmarks", "queries", "tpch")
FAST = {"task_retry_backoff_s": 0.001}
RPC_TIMEOUT_S = 60.0


@pytest.fixture(autouse=True)
def strict_leak_checker(monkeypatch):
    """The port's leak checker, armed strict for each test: a tracked
    resource still live at its query's end raises; none may be live when
    the test ends."""
    monkeypatch.setattr(tleak, "_installed", True)
    monkeypatch.setattr(tleak, "_strict", True)
    tleak.reset()
    yield
    try:
        tleak.assert_clean()
        assert not tleak.leaks(), tleak.leaks()
    finally:
        tleak.reset()


@pytest.fixture
def cluster2():
    cluster = start_localhost_cluster(2, device="cpu",
                                      rpc_timeout_s=RPC_TIMEOUT_S)
    yield cluster
    cluster.shutdown()


def _assert_drained(cluster):
    for w in cluster.local_workers:
        assert not w.table_store.tables, f"{w.url} leaked staged tables"
        assert len(w.registry) == 0, f"{w.url} leaked task entries"
        assert w.segment_pool.live_segments() == 0


def _plan(n=2048, num_tasks=4):
    """tests/test_fault_tolerance.py's plan: a sum by key over 16 keys."""
    rng = np.random.default_rng(3)
    t = arrow_to_table(pa.table({
        "k": rng.integers(0, 16, n),
        "v": rng.normal(size=n),
    }), device="cpu")
    scan = MemoryScanExec([t], t.schema())
    agg = HashAggregateExec(
        "single", ["k"], [AggSpec("sum", "v", "sv")], scan, 32
    )
    return distribute_plan(agg, DistributedConfig(num_tasks=num_tasks))


def _coord(cluster, **opts):
    return Coordinator(resolver=cluster, channels=cluster,
                       config_options={**FAST, **opts})


@pytest.fixture
def reference_cluster2():
    """The reference's localhost gRPC cluster of two workers, its servers
    bound to 127.0.0.1."""
    from datafusion_distributed_tpu.runtime import grpc_worker as jgrpc

    with pytest.MonkeyPatch.context() as mp:
        serve = jgrpc.serve_worker
        mp.setattr(jgrpc, "serve_worker",
                   lambda w, port=0, host=None: serve(w, port, "127.0.0.1"))
        cluster = jgrpc.start_localhost_cluster(2)
    yield cluster
    cluster.shutdown()


# ---------------------------------------------------------------------------
# tests/test_runtime.py
# ---------------------------------------------------------------------------


def test_grpc_localhost_cluster(cluster2, reference_cluster2):
    """A staged plan over real localhost sockets equals the in-memory
    cluster's result byte for byte and the reference's gRPC cluster's."""
    arrow = _arrow(1200, seed=21)
    got = _coord(cluster2).execute(_staged(arrow, T, 3)).to_numpy()
    mem = InMemoryCluster(2)
    base = _coord(mem).execute(_staged(arrow, T, 3)).to_numpy()
    assert identical(got, base)
    jcl = reference_cluster2
    ref = jcoord.Coordinator(resolver=jcl, channels=jcl).execute(
        _staged(arrow, J, 3)).to_numpy()
    assert_results_equal(ref, got, "sample plan over gRPC")
    infos = [cluster2.get_worker(u).get_info() for u in cluster2.get_urls()]
    assert all("version" in i and i["wire_codecs"] and "shm" in i
               for i in infos)
    assert set(infos[0]) == set(jworker.Worker().get_info())
    _assert_drained(cluster2)


def test_grpc_error_propagation():
    cluster = start_localhost_cluster(1, device="cpu",
                                      rpc_timeout_s=RPC_TIMEOUT_S)
    try:
        client = cluster.get_worker(cluster.get_urls()[0])
        with pytest.raises(WorkerError) as ei:
            client.execute_task(TaskKey("nope", 0, 0))
        assert "no plan" in str(ei.value)
        with pytest.raises(jerrors.WorkerError) as ref:
            jworker.Worker(url=client.url).execute_task(
                jworker.TaskKey("nope", 0, 0))
        # the reference's error as its gRPC tier carries it (an E-frame)
        ref_wire = jerrors.WorkerError.from_dict(ref.value.to_dict())
        assert not ei.value.retryable
        assert type(ei.value).__name__ == type(ref_wire).__name__
        assert str(ei.value) == str(ref_wire)
    finally:
        cluster.shutdown()


def test_grpc_metrics_collected():
    plan = _plan(400, num_tasks=2)
    cluster = start_localhost_cluster(1, device="cpu",
                                      rpc_timeout_s=RPC_TIMEOUT_S)
    try:
        coord = _coord(cluster)
        coord.execute(plan)
        assert len(coord.metrics) > 0
        assert any(m and "elapsed_s" in m for m in coord.metrics.values())
        assert any(m and m.get("rows_out") for m in coord.metrics.values())
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------


def test_grpc_unreachable_worker_maps_to_unavailable():
    client = GrpcWorkerClient("grpc://127.0.0.1:1", device="cpu",
                              rpc_timeout_s=RPC_TIMEOUT_S)
    try:
        with pytest.raises(WorkerUnavailableError) as ei:
            client.get_info()
        assert is_retryable(ei.value)
        assert ei.value.worker_url == "grpc://127.0.0.1:1"
    finally:
        client.close()


def test_grpc_dead_worker_reroutes_to_live_peer():
    """A stopped gRPC server surfaces as UNAVAILABLE -> the retryable
    taxonomy -> the coordinator reroutes to the surviving worker."""
    cluster = GrpcCluster(2, device="cpu", rpc_timeout_s=RPC_TIMEOUT_S)
    try:
        cluster.servers[0].stop(grace=None)
        coord = _coord(cluster, max_task_retries=6)
        out = coord.execute(_plan()).to_numpy()
        base = _coord(InMemoryCluster(1)).execute(_plan()).to_numpy()
        assert identical(out, base)
        assert coord.faults.get("task_retries") >= 1
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# tests/test_peer_plane.py
# ---------------------------------------------------------------------------


def test_peer_plane_over_grpc_cluster(cluster2):
    """Peers pull partition-range streams from each other's servers; no
    row crosses the coordinator on those boundaries; worker state drains
    after the query. Equal to single-node and to the in-memory cluster."""
    rng = np.random.default_rng(6)
    n = 6_000
    ctx = SessionContext(device="cpu")
    ctx.register_arrow("t", pa.table({
        "k": rng.integers(0, 50, n),
        "v": rng.normal(size=n),
    }))
    ctx.register_arrow("u", pa.table({
        "k": np.arange(50),
        "name": np.asarray([f"name{i:02d}" for i in range(50)],
                           dtype=object),
    }))
    ctx.config.distributed_options["bytes_per_task"] = 1
    ctx.config.distributed_options["broadcast_joins"] = False
    sql = ("select u.name, sum(t.v) s, count(*) c from t join u on "
           "t.k = u.k group by u.name order by s desc")
    coord = Coordinator(resolver=cluster2, channels=cluster2)
    got = ctx.sql(sql).collect_coordinated_table(
        coordinator=coord, num_tasks=2).to_numpy()
    single = ctx.sql(sql).collect_table().to_numpy()
    np.testing.assert_array_equal(got["name"], single["name"])
    np.testing.assert_allclose(np.ma.getdata(got["s"]), single["s"],
                               rtol=precision.test_rtol())
    np.testing.assert_array_equal(np.ma.getdata(got["c"]), single["c"])
    mem = InMemoryCluster(2)
    base = ctx.sql(sql).collect_coordinated_table(
        coordinator=Coordinator(resolver=mem, channels=mem),
        num_tasks=2).to_numpy()
    assert identical(got, base)
    stats = [m for m in coord.stream_metrics.values()
             if m.get("plane") == "peer"]
    assert stats and all(s["coordinator_bytes"] == 0 for s in stats)
    _assert_drained(cluster2)


# ---------------------------------------------------------------------------
# tests/test_telemetry.py
# ---------------------------------------------------------------------------


def test_get_metrics_over_grpc(cluster2):
    coord = _coord(cluster2)
    coord.execute(_plan())
    obs = ObservabilityService(cluster2, cluster2)
    out = obs.get_metrics()
    executed = out["metrics"]["dftpu_worker_tasks_executed"]["samples"]
    assert {s[0]["worker"] for s in executed} <= set(cluster2.get_urls())
    assert sum(v for _l, v in executed) >= 2
    # degradation: stop one server — the merge still answers with an
    # error entry for the dead endpoint
    victim = cluster2.get_urls()[0]
    cluster2._by_url[victim][0].stop(grace=None)
    out2 = obs.get_metrics()
    assert "error" in out2["workers"][victim]
    survivor = cluster2.get_urls()[1]
    assert "families" in out2["workers"][survivor]


# ---------------------------------------------------------------------------
# tests/test_tracing.py
# ---------------------------------------------------------------------------


def test_grpc_cross_wire_spans(cluster2):
    coord = _coord(cluster2, tracing="on")
    coord.execute(_plan(n=1024, num_tasks=2))
    trace = coord.last_query_trace()
    spans = trace.span_list()
    by_id = {s.span_id: s for s in spans}
    remote = [s for s in spans if s.attrs.get("remote")]
    assert remote, "worker spans did not cross the gRPC wire"
    for s in remote:
        assert str(s.attrs.get("worker", "")).startswith("grpc://")
        assert s.parent_id in by_id, (
            "gRPC worker span not joined to propagated parent")
    # wire-level dispatch bytes recorded next to staged nbytes
    assert any(s.attrs.get("wire_bytes") for s in spans
               if s.kind == "dispatch")


# ---------------------------------------------------------------------------
# string keys keep their codes across the wire
# ---------------------------------------------------------------------------


def test_string_group_by_over_grpc_keeps_codes(cluster2, reference_cluster2):
    """A GROUP BY on a string column whose rows are sorted, so that every
    task's scan slice holds other strings. Its partial aggregates are
    shuffled by dictionary code. The port ships each string column with
    its whole dictionary and unchanged codes: 26 groups, equal to the
    in-process cluster byte for byte and to single-node. The reference
    ships per-payload GC'd dictionaries, so a code names another string
    in another task, and its gRPC cluster splits groups (asserted as it
    stands: 29 rows for 26 strings, found in this tier's port)."""
    from datafusion_distributed_tpu.sql.context import SessionContext as J

    n = 4000
    letters = np.array([chr(97 + i) * 3 for i in range(26)], dtype=object)
    s = letters[np.sort(np.random.default_rng(0).integers(0, 26, n))]
    arrow = pa.table({"s": pa.array(s.tolist()), "v": np.arange(n) % 7})
    sql = ("select s, sum(v) as sv, count(*) as c from t group by s "
           "order by s")
    ctx = SessionContext(device="cpu")
    ctx.config.distributed_options["bytes_per_task"] = 1
    ctx.register_arrow("t", arrow)
    got = ctx.sql(sql).collect_coordinated_table(
        coordinator=Coordinator(resolver=cluster2, channels=cluster2),
        num_tasks=4).to_numpy()
    mem = InMemoryCluster(2)
    base = ctx.sql(sql).collect_coordinated_table(
        coordinator=Coordinator(resolver=mem, channels=mem),
        num_tasks=4).to_numpy()
    assert identical(got, base)
    assert list(got["s"]) == list(letters)
    assert identical(got, ctx.sql(sql).collect_table().to_numpy())
    _assert_drained(cluster2)
    jctx = J()
    jctx.config.distributed_options["bytes_per_task"] = 1
    jctx.register_arrow("t", arrow)
    ref = jctx.sql(sql).collect_coordinated_table(
        coordinator=jcoord.Coordinator(resolver=reference_cluster2,
                                       channels=reference_cluster2),
        num_tasks=4).to_numpy()
    assert len(ref["s"]) > len(letters)
    assert sorted(set(ref["s"])) == list(letters)


# ---------------------------------------------------------------------------
# string dictionaries on the wire: named by fingerprint, sent once
# ---------------------------------------------------------------------------


def _many_strings_ctx(n=8000, distinct=5000):
    """A table whose string column has a dictionary of the ~4,000 values
    of 24 characters its rows draw from ``distinct`` (~100 KB, above the
    size from which a receiver advertises a dictionary it holds), far
    larger than a chunk's codes."""
    rng = np.random.default_rng(1)
    words = np.array([f"{i:012d}-{i * 7919 % 100003:011d}"
                      for i in range(distinct)], dtype=object)
    s = words[rng.integers(0, distinct, n)]
    arrow = pa.table({"s": pa.array(s.tolist()), "v": np.arange(n) % 11})
    ctx = SessionContext(device="cpu")
    ctx.config.distributed_options["bytes_per_task"] = 1
    ctx.register_arrow("t", arrow)
    return ctx


_DICT_SQL = "select s, sum(v) as sv from t group by s order by s"


class _DictionarySpy:
    """Counts the wire payloads with rows that carry a string column's
    dictionary values, and those that reference it by fingerprint."""

    def __init__(self, monkeypatch):
        from datafusion_distributed_tpu_torch.io import parquet as tpq

        self.shipped = self.referenced = 0
        original = tpq.table_to_arrow

        def spy(table, *a, **kw):
            out = original(table, *a, **kw)
            meta = out.schema.metadata or {}
            if kw.get("whole_dictionaries") and out.num_rows:
                import json

                fps = json.loads(meta.get(b"dftpu_dict_fps", b"{}"))
                refs = json.loads(meta.get(b"dftpu_dict_refs", b"[]"))
                self.referenced += len(refs)
                self.shipped += len(fps) - len(refs)
            return out

        monkeypatch.setattr(tpq, "table_to_arrow", spy)


@pytest.mark.parametrize("opts", [
    {}, {"data_plane": "stream"},
    {"data_plane": "stream", "wire_compression": "off"},
    {"data_plane": "shm"},
], ids=["default", "stream-auto", "stream-off", "shm"])
def test_wire_dictionary_travels_once_per_receiver(cluster2, monkeypatch,
                                                   opts):
    """Every frame kind (SetPlan, P-, A- and S-frames) names a string
    column's dictionary by fingerprint and references it once the receiver
    holds it: a second run of the query ships no dictionary values at
    all, and both runs equal the in-process cluster byte for byte."""
    ctx = _many_strings_ctx()
    mem = InMemoryCluster(2)
    base = ctx.sql(_DICT_SQL).collect_coordinated_table(
        coordinator=Coordinator(resolver=mem, channels=mem),
        num_tasks=4).to_numpy()
    spy = _DictionarySpy(monkeypatch)
    runs = []
    for _ in range(2):
        spy.shipped = spy.referenced = 0
        got = ctx.sql(_DICT_SQL).collect_coordinated_table(
            coordinator=_coord(cluster2, **opts), num_tasks=4).to_numpy()
        assert identical(got, base)
        runs.append((spy.shipped, spy.referenced))
    # cold: at most once per task's SetPlan frame (frames in flight at
    # once to one worker each carry it until the worker acknowledges it),
    # every stream payload referencing it; warm: every payload does
    assert runs[0][0] <= 4 and runs[0][1] > 0, runs
    assert runs[1][0] == 0 and runs[1][1] > 0, runs
    _assert_drained(cluster2)


def test_set_plan_reships_dictionaries_the_worker_dropped(cluster2,
                                                          monkeypatch):
    """A worker that dropped the dictionaries it had adopted (its cache
    is bounded) answers a SetPlan that references them with their
    fingerprints; the client ships the frame again with the values, and
    the result is unchanged."""
    from collections import OrderedDict

    from datafusion_distributed_tpu_torch.io import parquet as tpq

    ctx = _many_strings_ctx()
    first = ctx.sql(_DICT_SQL).collect_coordinated_table(
        coordinator=_coord(cluster2), num_tasks=4).to_numpy()
    ships = []
    original = GrpcWorkerClient._ship_plan

    def ship(client, *a, **kw):
        msg, n = original(client, *a, **kw)
        ships.append("dict_missing" in msg)
        return msg, n

    monkeypatch.setattr(GrpcWorkerClient, "_ship_plan", ship)
    monkeypatch.setattr(tpq, "_ADOPTED", OrderedDict())
    monkeypatch.setattr(tpq, "_adopted_bytes", 0)
    again = ctx.sql(_DICT_SQL).collect_coordinated_table(
        coordinator=_coord(cluster2), num_tasks=4).to_numpy()
    assert identical(again, first)
    assert any(ships), "no SetPlan found its dictionary missing"
    _assert_drained(cluster2)


def test_referenced_dictionary_resolves_or_raises(monkeypatch):
    """A payload that references a dictionary decodes against the one the
    stream holds (the same object, the same codes); with none held it
    raises DictionaryMissing naming the fingerprint."""
    from collections import OrderedDict

    from datafusion_distributed_tpu_torch.io import parquet as tpq
    from datafusion_distributed_tpu_torch.runtime.codec import (
        decode_table,
        encode_table,
    )

    monkeypatch.setattr(tpq, "_ADOPTED", OrderedDict())
    monkeypatch.setattr(tpq, "_adopted_bytes", 0)
    t = arrow_to_table(pa.table({"s": ["b", "a", "c", "a"], "v": [1, 2, 3, 4]}),
                       device="cpu")
    d = t.column("s").dictionary
    fp = tpq._wire_form(d)[1]
    sent: set = set()
    whole = decode_table(encode_table(t, True, sent), device="cpu",
                         held=(held := {}))
    assert sent == {fp} and list(held) == [fp]
    ref = encode_table(t, True, sent)
    shipped = pa.ipc.open_stream(pa.BufferReader(ref)).read_all()
    assert shipped.schema.metadata[b"dftpu_dict_refs"] == b'["s"]'
    assert len(shipped.column("s").chunk(0).dictionary) == 0
    back = decode_table(ref, device="cpu", held=held)
    assert back.column("s").dictionary is whole.column("s").dictionary
    assert identical(back.to_numpy(), t.to_numpy())
    monkeypatch.setattr(tpq, "_ADOPTED", OrderedDict())
    with pytest.raises(tpq.DictionaryMissing) as e:
        decode_table(ref, device="cpu", held={})
    assert e.value.fingerprints == [fp]


def test_adopted_dictionaries_bounded_by_bytes(monkeypatch):
    """The adopted-dictionary cache keeps at most _ADOPTED_MAX_BYTES of
    values, dropping the least recently used first; a dropped dictionary
    is adopted anew, as another object, on its next arrival."""
    from collections import OrderedDict

    from datafusion_distributed_tpu_torch.io import parquet as tpq

    monkeypatch.setattr(tpq, "_ADOPTED", OrderedDict())
    monkeypatch.setattr(tpq, "_adopted_bytes", 0)
    arrays = [pa.array([f"{k}{i:05d}" for i in range(1000)])
              for k in "abc"]
    monkeypatch.setattr(tpq, "_ADOPTED_MAX_BYTES",
                        int(arrays[0].nbytes * 2.5))
    first = [tpq._adopted_dictionary(a) for a in arrays]
    assert len(tpq._ADOPTED) == 2 and tpq._adopted_bytes <= tpq._ADOPTED_MAX_BYTES
    assert tpq._adopted_dictionary(arrays[2]) is first[2]
    again = tpq._adopted_dictionary(arrays[0])
    assert again is not first[0]
    assert list(again.values) == list(first[0].values)
    # under _ADVERTISE_MIN_BYTES: held, but never advertised
    assert tpq.held_dictionaries() == {}
    # not strictly ascending: never adopted
    assert tpq._adopted_dictionary(pa.array(["b", "a"])) is None
    assert tpq._adopted_dictionary(pa.array(["a", "a"])) is None


# ---------------------------------------------------------------------------
# devices: every decode lands on the device its caller named
# ---------------------------------------------------------------------------


def test_decodes_land_on_the_named_device(cluster2):
    assert cluster2.device == torch.device("cpu")
    assert all(w.device == torch.device("cpu")
               for w in cluster2.local_workers)
    for url in cluster2.get_urls():
        assert cluster2.get_worker(url).device == torch.device("cpu")
    # the default is the card, never the CPU
    assert Worker().device.type == "cuda"
    client = GrpcWorkerClient("grpc://127.0.0.1:1")
    assert client.device.type == "cuda"
    client.close()
    out = _coord(cluster2).execute(_plan(n=512, num_tasks=2))
    assert out.device.type == "cpu"


# ---------------------------------------------------------------------------
# x64 mode, in a subprocess (the mode is fixed at import)
# ---------------------------------------------------------------------------

_X64_SCRIPT = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(1)
    from datafusion_distributed_tpu.data.tpchgen import gen_tpch
    from datafusion_distributed_tpu.runtime import coordinator as jcoord
    from datafusion_distributed_tpu.runtime import grpc_worker as jgrpc
    from datafusion_distributed_tpu.sql.context import SessionContext as J
    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )
    from datafusion_distributed_tpu_torch.sql.context import SessionContext as T
    from tests.torch_port_helpers import assert_results_equal
    assert precision.MODE == "x64"
    arrow = gen_tpch(0.002, 7)
    j, t = J(), T(device="cpu")
    for ctx in (j, t):
        ctx.config.distributed_options["bytes_per_task"] = 1
        for name, tbl in arrow.items():
            ctx.register_arrow(name, tbl)
    tcl = start_localhost_cluster(2, device="cpu", rpc_timeout_s=120)
    serve = jgrpc.serve_worker
    jgrpc.serve_worker = lambda w, port=0, host=None: serve(
        w, port, "127.0.0.1")
    jcl = jgrpc.start_localhost_cluster(2)
    try:
        for q in {queries!r}:
            sql = open(f"{qdir}/{{q}}.sql").read()
            got = t.sql(sql).collect_coordinated_table(
                coordinator=tcoord.Coordinator(resolver=tcl, channels=tcl),
                num_tasks=4)
            ref = j.sql(sql).collect_coordinated_table(
                coordinator=jcoord.Coordinator(resolver=jcl, channels=jcl),
                num_tasks=4)
            assert got.capacity == ref.capacity, q
            assert_results_equal(ref.to_numpy(), got.to_numpy(), q)
            for w in tcl.local_workers:
                assert not w.table_store.tables and len(w.registry) == 0
    finally:
        tcl.shutdown()
        jcl.shutdown()
    print("X64-GRPC-OK")
""")


def test_grpc_coordinated_matches_reference_in_x64_mode():
    script = _X64_SCRIPT.format(qdir=TPCH_DIR, queries=("q1", "q3"))
    env = dict(os.environ, DFTPU_PRECISION="x64", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "X64-GRPC-OK" in proc.stdout
