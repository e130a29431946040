"""The port's work-unit feeds (runtime/work_unit_feed.py) against the
reference's, on the CPU: counterparts of tests/test_work_unit_feed.py
(the round trip over a file scan, the four timestamps, an empty feed), a
feed under a GROUP BY through `execute_plan` as the reference's
examples/work_unit_feed.py runs it, and the scan's fingerprint. The same
seeded parquet files feed both packages."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from datafusion_distributed_tpu.io.parquet import schema_from_arrow as jschema
from datafusion_distributed_tpu.plan import physical as jphys
from datafusion_distributed_tpu.runtime import work_unit_feed as jwuf
from datafusion_distributed_tpu_torch.io.parquet import schema_from_arrow as tschema
from datafusion_distributed_tpu_torch.plan import physical as tphys
from datafusion_distributed_tpu_torch.runtime import work_unit_feed as twuf

torch.set_num_threads(1)

SIDES = (("reference", jwuf, jphys, jschema),
         ("port", twuf, tphys, tschema))


def _files(tmp_path, n=6, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    files = []
    for i in range(n):
        p = tmp_path / f"f{i}.parquet"
        pq.write_table(pa.table({
            "x": np.arange(i * rows, (i + 1) * rows, dtype=np.int64),
            "g": rng.integers(0, 3, rows).astype(np.int64),
            "v": rng.integers(-50, 50, rows).astype(np.int64),
        }), p)
        files.append(str(p))
    return files


def _scan(wuf, schema_of, files, task_count, router, device_kw):
    registry = wuf.WorkUnitFeedRegistry()
    fid = registry.register(lambda: iter(files))
    remote = wuf.RemoteWorkUnitFeedRegistry()
    sent = wuf.stream_feed(registry, remote, fid, router, task_count)
    schema = schema_of(pq.read_schema(files[0]))
    scan = wuf.WorkUnitScanExec(fid, schema, 32, remote, **device_kw)
    return sent, scan, remote, fid


def _kw(name):
    return {"device": "cpu"} if name == "port" else {}


def test_feed_roundtrip_with_file_scan(tmp_path):
    files = _files(tmp_path)
    out = {}
    for name, wuf, phys, schema_of in SIDES:
        counter = [0]

        def router(unit, task_count):
            counter[0] += 1
            return (counter[0] - 1) % task_count

        sent, scan, _, _ = _scan(wuf, schema_of, files, 2, router, _kw(name))
        t0 = phys.execute_plan(scan, phys.DistributedTaskContext(0, 2))
        t1 = phys.execute_plan(scan, phys.DistributedTaskContext(1, 2))
        out[name] = (sent, int(t0.num_rows), int(t1.num_rows),
                     np.asarray(t0.to_numpy()["x"]).tolist(),
                     np.asarray(t1.to_numpy()["x"]).tolist())
    assert out["port"] == out["reference"]
    assert out["port"][:3] == (6, 12, 12)
    assert sorted(out["port"][3] + out["port"][4]) == list(range(24))


def test_feed_timestamps_stamped(tmp_path):
    files = _files(tmp_path, n=3)
    for name, wuf, phys, schema_of in SIDES:
        registry = wuf.WorkUnitFeedRegistry()
        fid = registry.register(files)
        units = []
        remote = wuf.RemoteWorkUnitFeedRegistry()

        def router(unit, task_count):
            units.append(unit)
            return 0

        wuf.stream_feed(registry, remote, fid, router, task_count=1)
        schema = schema_of(pq.read_schema(files[0]))
        scan = wuf.WorkUnitScanExec(fid, schema, 16, remote, **_kw(name))
        table = scan.load(phys.DistributedTaskContext(0, 1))
        assert int(table.num_rows) == 12, name
        for u in units:
            stamps = (u.created_at, u.sent_at, u.received_at,
                      u.processed_at)
            assert None not in stamps, (name, stamps)
            assert list(stamps) == sorted(stamps), (name, stamps)


def test_empty_feed_yields_empty_table():
    out = {}
    for name, wuf, phys, schema_of in SIDES:
        schema = schema_of(pa.schema([("x", pa.int64())]))
        registry = wuf.WorkUnitFeedRegistry()
        fid = registry.register([])
        remote = wuf.RemoteWorkUnitFeedRegistry()
        wuf.stream_feed(registry, remote, fid, lambda u, t: 0, task_count=1)
        scan = wuf.WorkUnitScanExec(fid, schema, 8, remote, **_kw(name))
        table = scan.load(phys.DistributedTaskContext(0, 1))
        out[name] = (int(table.num_rows), table.capacity, table.names)
    assert out["port"] == out["reference"] == (0, 8, ("x",))


def test_feed_under_a_group_by_equals_the_whole_table(tmp_path):
    """Six parquet slices fed through the scan under a GROUP BY equal the
    same GROUP BY over the whole table, in both packages."""
    from datafusion_distributed_tpu.sql.context import SessionContext as JCtx
    from datafusion_distributed_tpu_torch.sql.context import (
        SessionContext as TCtx,
    )

    files = _files(tmp_path, n=6, rows=50, seed=3)
    whole = pa.concat_tables([pq.read_table(f) for f in files])
    sql = ("select g, sum(v) as s, count(*) as n, min(x) as lo "
           "from t group by g order by g")
    out = {}
    for (name, wuf, phys, schema_of), ctx in zip(
            SIDES, (JCtx(), TCtx(device="cpu"))):
        ctx.register_arrow("t", whole)
        want = ctx.sql(sql).collect_table().to_numpy()
        plan = ctx.sql(sql).physical_plan()
        (leaf,) = plan.collect(lambda n: not n.children())
        registry = wuf.WorkUnitFeedRegistry()
        fid = registry.register(lambda: iter(files))
        remote = wuf.RemoteWorkUnitFeedRegistry()
        assert wuf.stream_feed(registry, remote, fid, lambda u, t: 0, 1) == 6
        # the GROUP BY's plan over the table, its scan swapped for the feed
        scan = wuf.WorkUnitScanExec(fid, leaf.schema(),
                                    leaf.output_capacity(), remote,
                                    **_kw(name))
        plan = _with_leaf(plan, scan)
        got = phys.execute_plan(plan).to_numpy()
        got = {k.split(".")[-1]: np.asarray(v) for k, v in got.items()}
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.asarray(want[k]).tolist() == got[k].tolist(), (name, k)
        out[name] = {k: got[k].tolist() for k in sorted(got)}
    assert out["port"] == out["reference"]


def _with_leaf(plan, leaf):
    """``plan`` with its one scan leaf replaced by ``leaf``."""
    kids = plan.children()
    if not kids:
        return leaf
    return plan.with_new_children([_with_leaf(k, leaf) for k in kids])


def test_scan_fingerprint_ignores_the_feed_id(tmp_path):
    """The feed id is a data location, not structure (as the reference's
    plan/fingerprint.py keys it): two scans of one schema and capacity
    share a fingerprint, another capacity does not."""
    from datafusion_distributed_tpu_torch.plan.fingerprint import (
        plan_fingerprint,
    )

    schema = tschema(pa.schema([("x", pa.int64())]))
    a = twuf.WorkUnitScanExec("a" * 32, schema, 16)
    b = twuf.WorkUnitScanExec("b" * 32, schema, 16)
    c = twuf.WorkUnitScanExec("a" * 32, schema, 32)
    assert plan_fingerprint(a) == plan_fingerprint(b)
    assert plan_fingerprint(a) != plan_fingerprint(c)


def test_scan_without_a_registry_raises():
    for name, wuf, phys, schema_of in SIDES:
        schema = schema_of(pa.schema([("x", pa.int64())]))
        scan = wuf.WorkUnitScanExec("f", schema, 8, **_kw(name))
        with pytest.raises(RuntimeError, match="no remote feed registry"):
            scan.load(phys.DistributedTaskContext(0, 1))
