"""The port's coordinator/worker runtime pieces (runtime/codec.py, worker.py,
metrics.py, coordinator.py) against the reference's, case by case as
tests/test_runtime.py holds the reference: the same inputs through both
packages on the CPU, equal results.

- the plan codec's round trip and wire objects; Arrow IPC across the
  packages (the port's bytes decode in the reference and the other way
  round, with nulls, strings, NaN and -0.0); the wire dictionary GC;
- the task registry's TTL, worker error propagation, the on_plan hook;
- a staged plan and a SQL query through the coordinator; per-node metrics
  and explain_analyze;
- the partition-range accounting and partition streams against the bulk
  plane.
"""

import json
import re
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.io.parquet import arrow_to_table as j_arrow
from datafusion_distributed_tpu.ops.aggregate import AggSpec as JAggSpec
from datafusion_distributed_tpu.ops.sort import SortKey as JSortKey
from datafusion_distributed_tpu.plan import physical as jphys
from datafusion_distributed_tpu.planner import distributed as jdist
from datafusion_distributed_tpu.runtime import codec as jcodec
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import errors as jerrors
from datafusion_distributed_tpu.runtime import metrics as jmetrics
from datafusion_distributed_tpu.runtime import worker as jworker
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table as t_arrow
from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec as TAggSpec
from datafusion_distributed_tpu_torch.ops.sort import SortKey as TSortKey
from datafusion_distributed_tpu_torch.plan import physical as tphys
from datafusion_distributed_tpu_torch.planner import distributed as tdist
from datafusion_distributed_tpu_torch.runtime import codec as tcodec
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import errors as terrors
from datafusion_distributed_tpu_torch.runtime import metrics as tmetrics
from datafusion_distributed_tpu_torch.runtime import worker as tworker
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_results_equal, identical

torch.set_num_threads(1)

NT = 4
#: (package tag, arrow_to_table, physical, distributed, codec, coordinator,
#: worker, AggSpec, SortKey)
J = ("jax", j_arrow, jphys, jdist, jcodec, jcoord, jworker, JAggSpec,
     JSortKey)
T = ("torch", lambda a, **kw: t_arrow(a, device="cpu", **kw), tphys, tdist,
     tcodec, tcoord, tworker, TAggSpec, TSortKey)


def _sample(arrow, pkg):
    """Sort(HashAggregate(single) over a memory scan) of ``arrow``."""
    _tag, to_table, phys, _d, _c, _co, _w, Agg, Key = pkg
    t = to_table(arrow)
    scan = phys.MemoryScanExec([t], t.schema())
    agg = phys.HashAggregateExec(
        "single", ["k"],
        [Agg("sum", "v", "sv"), Agg("count_star", None, "n")], scan)
    return phys.SortExec([Key("k")], agg)


def _arrow(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 25, n), "v": rng.normal(size=n)})


def _staged(arrow, pkg, num_tasks=NT):
    dist = pkg[3]
    return dist.distribute_plan(_sample(arrow, pkg),
                                dist.DistributedConfig(num_tasks=num_tasks))


def _cluster_coord(pkg, n=3, cls="Coordinator"):
    co = pkg[5]
    cluster = co.InMemoryCluster(n)
    return getattr(co, cls)(resolver=cluster, channels=cluster), cluster


def _ids_out(obj):
    """An encoded plan with its store ids replaced by their count."""
    if isinstance(obj, dict):
        return {k: (len(v) if k == "tables" else _ids_out(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_ids_out(v) for v in obj]
    return obj


def test_codec_roundtrip_equal_wire_objects():
    arrow = _arrow(100)
    objs, backs = [], []
    for pkg in (J, T):
        dplan = _staged(arrow, pkg)
        store = pkg[4].TableStore()
        obj = pkg[4].encode_plan(dplan, store)
        json.dumps(_ids_out(obj))  # JSON-able
        back = pkg[4].decode_plan(obj, store)
        assert len(back.collect(lambda n: True)) == len(
            dplan.collect(lambda n: True))
        objs.append(_ids_out(obj))
        backs.append(back.display_tree())
    assert objs[1] == objs[0]
    assert backs[1] == backs[0]


#: a table with nulls, strings, NaN and -0.0 for the IPC checks
IPC_ARROW = pa.table({
    "a": pa.array([1, 2, None, -7], pa.int32()),
    "s": pa.array(["x", None, "z", "x"]),
    "f": pa.array([np.nan, -0.0, 1.5, None], pa.float32()),
    "d": pa.array([0.0, -0.0, np.nan, 2.25], pa.float64()),
})


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_ipc_across_packages(direction):
    src, dst = (T, J) if direction == "torch->jax" else (J, T)
    table = src[1](IPC_ARROW)
    wire = src[4].encode_table(table)
    assert isinstance(wire, (bytes, memoryview)) and len(wire) > 0
    back = dst[4].decode_table(wire) if dst is J else dst[4].decode_table(
        wire, device="cpu")
    same_pkg = (src[4].decode_table(wire) if src is J
                else src[4].decode_table(wire, device="cpu"))
    a, b = same_pkg.to_numpy(), back.to_numpy()
    assert identical(a, b), (a, b)
    assert back.capacity == same_pkg.capacity
    # -0.0 and NaN survive bit for bit
    for name in ("f", "d"):
        x, y = np.ma.getdata(a[name]), np.ma.getdata(b[name])
        assert x.tobytes() == y.tobytes(), name


def test_ipc_bytes_equal_across_packages():
    """The same table encodes to the same Arrow IPC bytes in both."""
    j = bytes(J[4].encode_table(J[1](IPC_ARROW)))
    t = bytes(T[4].encode_table(T[1](IPC_ARROW)))
    assert t == j


def test_wire_dictionary_gc():
    vals = [f"value_{i:04d}" for i in range(1000)]
    arrow = pa.table({"s": np.asarray(vals * 20, dtype=object),
                      "x": np.arange(20000)})
    out = []
    for pkg in (J, T):
        t = pkg[1](arrow)
        full = len(pkg[4].encode_table(t))
        keep = (np.arange(t.capacity) % 1000 < 10) & (
            np.arange(t.capacity) < 20000)
        if pkg is J:
            import jax.numpy as jnp

            filtered = t.compact(jnp.asarray(keep))
        else:
            filtered = t.compact(torch.from_numpy(keep))
        wire = pkg[4].encode_table(filtered)
        assert len(wire) < full / 10, (len(wire), full)
        back = (pkg[4].decode_table(wire) if pkg is J
                else pkg[4].decode_table(wire, device="cpu"))
        col = back.column("s")
        assert len(col.dictionary.values) == 10
        out.append((len(wire), list(col.dictionary.values),
                    back.to_numpy()))
    assert out[1][:2] == out[0][:2]
    assert identical(out[1][2], out[0][2])


def test_coordinator_executes_distributed_plan():
    arrow = _arrow()
    res, metric_keys = [], []
    for pkg in (J, T):
        coord, _cluster = _cluster_coord(pkg)
        res.append(coord.execute(_staged(arrow, pkg)).to_numpy())
        assert len(coord.metrics) > 0
        assert all("elapsed_s" in m for m in coord.metrics.values())
        metric_keys.append(sorted((k.stage_id, k.task_number)
                                  for k in coord.metrics))
    assert_results_equal(res[0], res[1], "coordinated sample plan")
    assert metric_keys[1] == metric_keys[0]


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_task_registry_ttl(pkg):
    w = pkg[6]
    reg = w.TaskRegistry(ttl_seconds=0.05)
    key = w.TaskKey("q", 0, 0)
    reg.put(w.TaskData(key=key, plan=None, task_count=1))
    assert reg.get(key) is not None
    time.sleep(0.08)
    reg.put(w.TaskData(key=w.TaskKey("q2", 0, 0), plan=None, task_count=1))
    assert reg.get(key) is None


def test_worker_error_propagation():
    out = []
    for pkg, errors in ((J, jerrors), (T, terrors)):
        w = pkg[6].Worker("mem://w0")
        key = pkg[6].TaskKey("q", 0, 0)
        with pytest.raises(errors.WorkerError) as ei:
            w.execute_task(key)
        d = ei.value.to_dict()
        back = errors.WorkerError.from_dict(d)
        assert back.worker_url == "mem://w0" and back.task == key
        out.append((type(ei.value).__name__, str(ei.value),
                    {k: v for k, v in d.items() if k != "task"}))
    assert out[1] == out[0]
    assert "no plan" in out[0][1]


def test_worker_on_plan_hook():
    arrow = _arrow(500)
    seen_by_pkg = []
    for pkg in (J, T):
        seen = []
        coord, cluster = _cluster_coord(pkg, 2)
        for w in cluster.workers.values():
            w.on_plan = lambda plan, key, seen=seen: (seen.append(
                (key.stage_id, key.task_number)), plan)[1]
        coord.execute(_staged(arrow, pkg, 2))
        assert seen
        seen_by_pkg.append(sorted(seen))
    assert seen_by_pkg[1] == seen_by_pkg[0]


def test_sql_through_coordinator():
    rng = np.random.default_rng(5)
    f = pa.table({"k": rng.integers(0, 10, 1000), "v": rng.normal(size=1000)})
    d = pa.table({"k": np.arange(10), "w": rng.normal(size=10)})
    sql = ("select f.k, sum(f.v + d.w) s from f, d where f.k = d.k "
           "group by f.k order by f.k")
    res = []
    for pkg, ctx in ((J, JContext()), (T, TContext(device="cpu"))):
        ctx.register_arrow("f", f)
        ctx.register_arrow("d", d)
        df = ctx.sql(sql)
        single = df.collect_table().to_numpy()
        coord, _cluster = _cluster_coord(pkg, 2)
        out = df._strip_quals(coord.execute(df.distributed_plan(NT)))
        got = out.to_numpy()
        assert_results_equal(single, got, f"{pkg[0]} single vs coordinated")
        res.append(got)
    assert_results_equal(res[0], res[1], "coordinated across packages")


def _norm_ids(text: str) -> str:
    return re.sub(r"#\d+", "#", text)


def test_metrics_and_explain_analyze():
    arrow = _arrow(300, seed=9)
    texts, per_texts, scan_rows = [], [], []
    for pkg, metrics in ((J, jmetrics), (T, tmetrics)):
        plan = _sample(arrow, pkg)
        store = metrics.MetricsStore()
        pkg[2].execute_plan(plan, metrics_store=store, task_label="task0")
        texts.append(_norm_ids(metrics.explain_analyze(plan, store)))
        per_texts.append(_norm_ids(
            metrics.explain_analyze(plan, store, per_task=True)))
        scan_id = plan.collect(lambda n: not n.children())[0].node_id
        scan_rows.append(store.aggregated()[scan_id]["output_rows"])
    assert "output_rows=" in texts[1] and "HashAggregate" in texts[1]
    assert "output_rows_task0=" in per_texts[1]
    assert scan_rows == [300, 300]
    assert texts[1] == texts[0]
    assert per_texts[1] == per_texts[0]


def test_partition_range_accounting():
    rng = np.random.default_rng(3)
    arrow = pa.table({"k": rng.integers(0, 40, 500),
                      "v": rng.normal(size=500)})
    per_pkg = []
    for pkg in (J, T):
        t = pkg[1](arrow)
        scan = pkg[2].MemoryScanExec([t], t.schema())
        w = pkg[6].Worker()
        key = pkg[6].TaskKey("q", 0, 0)
        store = pkg[4].TableStore()
        plan_obj = pkg[4].encode_plan(scan, store)
        for tid, tbl in store.tables.items():
            w.table_store.tables[tid] = tbl
        w.set_plan(key, plan_obj, task_count=1)
        got: dict = {}
        chunks = []
        for p, piece, _est in w.execute_task_partitions(
                key, ["k"], 4, 0, 2, chunk_rows=64):
            got[p] = got.get(p, 0) + int(piece.num_rows)
            chunks.append((p, piece.to_numpy()))
        assert set(got) <= {0, 1}
        assert w.partitions_remaining(key) == 2
        for p, piece, _est in w.execute_task_partitions(
                key, ["k"], 4, 2, 4, chunk_rows=64):
            got[p] = got.get(p, 0) + int(piece.num_rows)
            chunks.append((p, piece.to_numpy()))
        assert sum(got.values()) == 500
        assert w.registry.get(key) is None
        per_pkg.append((got, chunks))
    assert per_pkg[1][0] == per_pkg[0][0]
    assert [p for p, _ in per_pkg[1][1]] == [p for p, _ in per_pkg[0][1]]
    for (_p, a), (_q, b) in zip(per_pkg[0][1], per_pkg[1][1]):
        assert identical(a, b)


def test_shuffle_partition_streams_match_bulk():
    arrow = _arrow(3000, seed=9)
    res = []
    for pkg in (J, T):
        coord, cluster = _cluster_coord(pkg)
        dplan = _staged(arrow, pkg)
        out = coord.execute(dplan).to_numpy()
        assert any("partitions" in m for m in coord.stream_metrics.values())
        acoord = pkg[5].AdaptiveCoordinator(resolver=cluster,
                                            channels=cluster)
        exp = acoord.execute(dplan).to_numpy()
        assert_results_equal(out, exp, f"{pkg[0]} stream vs bulk")
        res.append(out)
    assert_results_equal(res[0], res[1], "partition streams across packages")
