"""The port's zero-copy data plane (runtime/codec.py's TableStore,
ops/table.py's host views, the coordinator's regroup, the worker's
partition plane, the codec) against the reference's, on the CPU: the
counterpart of tests/test_data_plane.py.

Every case runs both packages on the same seeded input and compares what
each observes: the store's accounting (bytes, entries, views, dedup hits,
the peak) through puts, views, aliases, direct dict mutation, a repartition
and a threaded churn; views and contiguous-chunk concats, regrouped slices
against copies, and partition chunks released on drop, with the values and
capacities equal across the packages and, in each package, the storage
shared as its own test says (``np.shares_memory`` and the base buffer in
the reference, ``untyped_storage()`` in the port, as ops/table.py's
``_merge_views`` checks it); one-buffer encoding with the decoded capacity
passed through, each package decoding the other's payload; the
``zero_copy`` knob and the staged bytes that observability and the console
report; TPC-H q5 and q9 on the view plane against the copying plane; q5
under one crash a stage with no slice left and its peak staged bytes.

``test_chunk_plane_rate_at_least_2x`` has no counterpart: it is a
wall-clock ceiling, and such ceilings are flaky under the suite's six
workers (ROADMAP §C.4).
"""

import os
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_matches_reference,
    assert_results_equal,
    identical,
    tpch_contexts,
)

torch.set_num_threads(1)

CHAOS_SEED = int(os.environ.get("DFTPU_CHAOS_SEED", "20260803"))
FAST = {"task_retry_backoff_s": 0.001}


@pytest.fixture(autouse=True)
def _no_zero_copy_env_override(monkeypatch):
    """DFTPU_ZERO_COPY takes priority over the session's knob."""
    monkeypatch.delenv("DFTPU_ZERO_COPY", raising=False)


def _arrow(rows=4096, seed=0, strings=False):
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 64, rows), "v": rng.normal(size=rows)}
    if strings:
        cols["s"] = pa.array(rng.choice(["aa", "bb", "cc"], rows))
    return pa.table(cols)


def _table(P, rows=4096, seed=0, strings=False):
    return P.table(_arrow(rows, seed, strings))


def _storage(P, x):
    """An id of the buffer that column data ``x`` views."""
    if P is PORT:
        return x.untyped_storage().data_ptr()
    return id(P("ops.table")._base_buffer(x))


def _shares(P, a, b) -> bool:
    if P is PORT:
        return (a.untyped_storage().data_ptr()
                == b.untyped_storage().data_ptr())
    return bool(np.shares_memory(np.asarray(a), np.asarray(b)))


def _store(P):
    return P("runtime.codec").TableStore()


def _nbytes(P, t):
    return P("runtime.tracing").table_nbytes(t)


# ---------------------------------------------------------------------------
# TableStore
# ---------------------------------------------------------------------------


def _put_get(P):
    t = _table(P, strings=True)
    s = _store(P)
    tid = s.put(t)
    seq = [s.get(tid) is t, s.nbytes() == _nbytes(P, t), _nbytes(P, t),
           s.entry_nbytes(tid), s.stats()]
    s.remove([tid])
    return seq + [s.tables == {}, s.nbytes(), s.peak_nbytes]


def _dedup(P):
    t = _table(P)
    s = _store(P)
    tids = [s.put(t) for _ in range(4)]
    seq = [s.stats(), s.nbytes(), [s.entry_nbytes(i) for i in tids]]
    for part in (tids[:1], tids[1:3], tids[3:]):
        s.remove(part)
        seq.append((s.nbytes(), s.stats()["entries"]))
    return seq + [s.tables == {}]


def _slices(P):
    t = _table(P)
    s = _store(P)
    tid = s.put(t)
    base = t.columns[0].data
    v = s.get_slice(tid, 100, 500)
    vid = s.put_view(tid, lo=100, count=500)
    vt = s.get(vid)
    seq = [int(v.num_rows), _shares(P, v.columns[0].data, base),
           np.asarray(v.columns[0].data[:500]).tolist() ==
           np.asarray(base[100:600]).tolist(),
           _shares(P, vt.columns[0].data, base), s.nbytes(), s.stats()]
    s.remove([tid, vid])
    return seq + [s.nbytes(), s.tables == {}]


def _dict_mutation(P):
    t = _table(P)
    s = _store(P)
    seq = []
    s.tables["abc"] = t
    seq.append(s.nbytes())
    s.tables["abc"] = t
    seq.append(s.nbytes())
    s.tables.update({"def": t})
    seq.append(s.stats())
    s.tables.setdefault("ghi", t)
    seq.append(s.stats())
    tid, _val = s.tables.popitem()
    seq.append((tid, s.stats()))
    s.tables.clear()
    return seq + [s.nbytes(), s.stats()]


def _threaded(P):
    s = _store(P)
    tables = [_table(P, rows=64, seed=i) for i in range(8)]
    errors = []

    def churn(i):
        try:
            for _ in range(100):
                tid = s.put(tables[i % len(tables)])
                v = s.put_view(tid)
                s.remove([v, tid])
        except Exception as e:  # pragma: no cover - failure detail
            errors.append(e)

    threads = [threading.Thread(target=churn, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    st = s.stats()
    return [errors, s.tables == {}, s.nbytes(), st["entries"]]


STORE_CASES = {"put_get": _put_get, "dedup": _dedup, "slices": _slices,
               "dict_mutation": _dict_mutation, "threaded": _threaded}


@pytest.mark.parametrize("name", sorted(STORE_CASES))
def test_table_store(name):
    got = {P: STORE_CASES[name](P) for P in BOTH}
    assert got[PORT] == got[REF]
    if name == "dedup":
        assert got[PORT][0]["dedup_hits"] == 3 and got[PORT][-1]
    if name == "slices":
        assert got[PORT][1] and got[PORT][3]
    if name == "threaded":
        assert got[PORT] == [[], True, 0, 0]


def _repartition(P):
    worker = P("runtime.worker")
    w = worker.Worker(url="mem://dp-respec")
    t = _table(P, rows=2048)
    obj = P("runtime.codec").encode_plan(
        P("plan.physical").MemoryScanExec([t], t.schema()), w.table_store)
    key = worker.TaskKey("dpr", 0, 0)
    w.set_plan(key, obj, 1, ttl=3600.0)
    parts4 = [(p, int(c.num_rows)) for p, c, _e in w.execute_task_partitions(
        key, ["k"], 4, 0, 4, per_dest_capacity=2048)]
    data = w.registry.get(key)
    first = list(data.staged_partition_ids)
    n1 = w.table_store.stats()["entries"]
    parts2 = [(p, int(c.num_rows)) for p, c, _e in w.execute_task_partitions(
        key, ["k"], 2, 0, 2, per_dest_capacity=2048)]
    released = all(tid not in w.table_store.tables for tid in first)
    n2 = w.table_store.stats()["entries"]
    w.release_task(key)
    return [parts4, parts2, len(first), released, n1, n2,
            w.table_store.tables == {}, w.table_store.nbytes()]


def test_repartition_releases_previous_staged_slices():
    got = {P: _repartition(P) for P in BOTH}
    assert got[PORT] == got[REF]
    assert got[PORT][3] and got[PORT][5] <= got[PORT][4]
    assert got[PORT][6:] == [True, 0]


# ---------------------------------------------------------------------------
# host views, concat, regroup
# ---------------------------------------------------------------------------


def _views(P):
    tab = P("ops.table")
    t = _table(P)
    h = tab.host_view(t)
    v = tab.slice_view(h, 64, 256)
    whole = tab.host_view(_table(P, rows=1000))
    chunks = [tab.slice_view(whole, lo, 250) for lo in range(0, 1000, 250)]
    out = tab.concat_tables(chunks, capacity=1024)
    return {"host_backed": tab.is_host_backed(h),
            "host_shares": _shares(P, h.columns[0].data, t.columns[0].data),
            "slice": (int(v.num_rows), v.capacity,
                      _shares(P, v.columns[0].data, h.columns[0].data)),
            "slice_values": v.to_numpy(),
            "concat": (int(out.num_rows), out.capacity,
                       _shares(P, out.columns[0].data, whole.columns[0].data)),
            "concat_values": out.to_numpy()}


def test_host_view_slice_view_and_contiguous_concat():
    got = {P: _views(P) for P in BOTH}
    for k in ("host_backed", "host_shares", "slice", "concat"):
        assert got[PORT][k] == got[REF][k], k
    assert got[PORT]["slice"] == (256, 256, True)
    assert got[PORT]["concat"] == (1000, 1024, True)
    for k in ("slice_values", "concat_values"):
        assert identical(got[PORT][k], got[REF][k]), k


def test_host_concat_matches_device_concat():
    got = {}
    for P in BOTH:
        tab = P("ops.table")
        a = _table(P, rows=300, seed=1, strings=True)
        b = _table(P, rows=200, seed=2, strings=True)
        dev = tab.concat_tables([a, b], capacity=512)
        hst = tab.concat_tables([tab.host_view(a), tab.host_view(b)],
                                capacity=512)
        assert tab.is_host_backed(hst), P
        got[P] = (dev.to_numpy(), hst.to_numpy(), dev.capacity, hst.capacity)
    assert identical(got[PORT][0], got[PORT][1])
    assert identical(got[PORT][1], got[REF][1])
    assert got[PORT][2:] == got[REF][2:]


def test_shuffle_regroup_view_matches_copy():
    got = {}
    for P in BOTH:
        regroup = P("runtime.coordinator")._shuffle_regroup
        outs = [_table(P, rows=1024, seed=i) for i in range(2)]
        copy = regroup(outs, ["k"], 4, 1024, zero_copy=False)
        view = regroup(outs, ["k"], 4, 1024, zero_copy=True)
        got[P] = [(int(c.num_rows), int(v.num_rows), c.capacity, v.capacity,
                   c.to_numpy(), v.to_numpy()) for c, v in zip(copy, view)]
    assert len(got[PORT]) == len(got[REF]) == 4
    for p, r in zip(got[PORT], got[REF]):
        assert p[:4] == r[:4]
        assert p[0] == p[1] and identical(p[4], p[5])
        assert identical(p[5], r[5])


def test_regroup_exact_slices_share_one_buffer():
    got = {}
    for P in BOTH:
        out = _table(P, rows=2048)
        slices = P("runtime.coordinator")._shuffle_regroup(
            [out], ["k"], 4, 2048, zero_copy=True, exact=True)
        nonzero = [s for s in slices if int(s.num_rows)]
        bases = {_storage(P, s.columns[0].data) for s in nonzero}
        got[P] = ([(int(s.num_rows), s.capacity) for s in slices],
                  len(nonzero), len(bases),
                  [s.to_numpy() for s in slices])
    assert got[PORT][:3] == got[REF][:3]
    assert got[PORT][1] >= 2 and got[PORT][2] == 1
    assert sum(n for n, _c in got[PORT][0]) == 2048
    for a, b in zip(got[PORT][3], got[REF][3]):
        assert identical(a, b)


def _partition_chunks(P):
    worker = P("runtime.worker")
    tab = P("ops.table")
    w = worker.Worker(url="mem://dp-w0")
    t = _table(P, rows=4096)
    obj = P("runtime.codec").encode_plan(
        P("plan.physical").MemoryScanExec([t], t.schema()), w.table_store)
    key = worker.TaskKey("dpq", 0, 0)
    w.set_plan(key, obj, 1)
    gen = w.execute_task_partitions(key, ["k"], 4, 0, 4,
                                    per_dest_capacity=4096)
    p0, chunk0, _est = next(gen)
    slices = w.registry.get(key).partition_slices
    nonzero = [s for s in slices if int(s.num_rows)]
    seq = [p0, int(chunk0.num_rows), all(tab.is_host_backed(s)
                                         for s in slices),
           len({_storage(P, s.columns[0].data) for s in nonzero}),
           _shares(P, chunk0.columns[0].data, slices[p0].columns[0].data),
           w.table_store.nbytes() > 0]
    rest = [(p, int(c.num_rows)) for p, c, _e in gen]
    return seq + [rest, w.table_store.tables == {}, w.table_store.nbytes(),
                  len(w.registry)]


def test_worker_partition_chunks_are_views_and_release_on_drop():
    got = {P: _partition_chunks(P) for P in BOTH}
    assert got[PORT] == got[REF]
    assert got[PORT][2:6] == [True, 1, True, True]
    assert got[PORT][-3:] == [True, 0, 0]


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def test_encode_single_buffer_and_decode_capacity_passthrough():
    payloads, tables = {}, {}
    for P in BOTH:
        t = _table(P, rows=1000, strings=True)
        payloads[P] = P("runtime.codec").encode_table(t)
        tables[P] = t
        assert isinstance(payloads[P], memoryview), P
    for dec in BOTH:
        codec = dec("runtime.codec")
        kw = {"device": "cpu"} if dec is PORT else {}
        for src in BOTH:
            t = tables[src]
            back = codec.decode_table(payloads[src], capacity=int(t.capacity),
                                      **kw)
            exact = codec.decode_table(payloads[src], capacity=1000, **kw)
            assert back.capacity == t.capacity, (dec, src)
            assert (exact.capacity, int(exact.num_rows)) == (1000, 1000)
            assert identical(exact.to_numpy(), tables[REF].to_numpy()), (
                dec, src)


def test_zero_copy_knob_parses_and_gates():
    got = {}
    for P in BOTH:
        cfg = P("sql.context").SessionConfig()
        enabled = P("ops.table").zero_copy_enabled
        seq = []
        for v in ("off", "on", "false", "true"):
            cfg.set_option("distributed.zero_copy", v)
            seq.append((cfg.distributed_options["zero_copy"],
                        enabled(cfg.distributed_options)))
        got[P] = seq + [enabled(None)]
    assert got[PORT] == got[REF]
    assert got[PORT][:2] == [(False, False), (True, True)]


def test_observability_and_console_surface_staged_bytes():
    got = {}
    for P in BOTH:
        cluster = P("runtime.coordinator").InMemoryCluster(2)
        w = next(iter(cluster.workers.values()))
        t = _table(P)
        tid = w.table_store.put(t)
        obs = P("runtime.observability").ObservabilityService(cluster,
                                                             cluster)
        dp = obs.get_data_plane()
        frame = P("console").Console(cluster, cluster).render_frame()
        w.table_store.remove([tid])
        got[P] = (dp["nbytes"], dp["entries"], sorted(dp["workers"]),
                  "data plane" in frame and "staged" in frame,
                  obs.get_data_plane()["nbytes"])
    assert got[PORT] == got[REF]
    assert got[PORT][3] and got[PORT][4] == 0


# ---------------------------------------------------------------------------
# TPC-H
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    return tpch_contexts(bytes_per_task=1)


def _leftover(cluster) -> list:
    return [(len(w.registry), len(w.table_store.tables),
             w.table_store.nbytes()) for w in cluster.workers.values()]


def _tpch_run(P, ctx, sql, cluster, **opts):
    coord = P("runtime.coordinator").Coordinator(
        resolver=cluster, channels=cluster, config_options={**FAST, **opts})
    df = ctx.sql(sql)
    return df._strip_quals(df.collect_coordinated_table(coordinator=coord,
                                                        num_tasks=4))


@pytest.mark.parametrize("qname", ["q5", "q9"])
def test_tpch_view_plane_against_copy_plane(tpch, qname):
    from tests.test_data_plane import TPCH_Q5, TPCH_Q9

    sql = {"q5": TPCH_Q5, "q9": TPCH_Q9}[qname]
    got = {}
    for P in BOTH:
        cluster = P("runtime.coordinator").InMemoryCluster(4)
        on = _tpch_run(P, tpch[P], sql, cluster, zero_copy=True)
        left_on = _leftover(cluster)
        off = _tpch_run(P, tpch[P], sql, cluster, zero_copy=False)
        assert identical(on.to_numpy(), off.to_numpy()), P
        assert on.capacity == off.capacity, P
        got[P] = (on, left_on, _leftover(cluster))
    assert_matches_reference(got[REF][0], got[PORT][0], qname)
    assert got[PORT][1:] == got[REF][1:]
    assert all(x == (0, 0, 0) for x in got[PORT][1] + got[PORT][2])
    single = tpch[PORT].sql(sql)
    assert_results_equal(single._strip_quals(single.collect_table())
                         .to_numpy(), got[PORT][0].to_numpy(), qname)


def test_q5_under_chaos_no_leak_and_peak_staged_bytes(tpch):
    from tests.test_data_plane import TPCH_Q5

    got = {}
    for P in BOTH:
        rt, chaos = P("runtime.coordinator"), P("runtime.chaos")
        arms = {}
        for zc in (False, True):
            cluster = rt.InMemoryCluster(4)
            wrapped = chaos.wrap_cluster(
                cluster, chaos.one_crash_per_stage(CHAOS_SEED))
            out = _tpch_run(P, tpch[P], TPCH_Q5, wrapped, zero_copy=zc,
                            stage_parallelism=1)
            arms[zc] = (out, _leftover(cluster), sum(
                w.table_store.peak_nbytes for w in cluster.workers.values()),
                sorted((f["stage_id"], f["kind"]) for f in
                       wrapped.plan.fired))
        assert identical(arms[True][0].to_numpy(), arms[False][0].to_numpy())
        assert arms[True][2] <= arms[False][2], (P, arms[True][2],
                                                 arms[False][2])
        got[P] = arms
    for zc in (False, True):
        assert_matches_reference(got[REF][zc][0], got[PORT][zc][0], str(zc))
        assert got[PORT][zc][1] == got[REF][zc][1]
        assert got[PORT][zc][3] == got[REF][zc][3]
        assert all(x == (0, 0, 0) for x in got[PORT][zc][1])
    # the peaks of both planes, both packages
    assert {zc: got[PORT][zc][2] for zc in (False, True)} == {
        zc: got[REF][zc][2] for zc in (False, True)}
