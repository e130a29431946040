"""The port's enforced worker memory budget (runtime/codec.py TableStore,
runtime/spill.py), query checkpoints (runtime/checkpoint.py) and
`ServingSession.recover()` against the reference's, on the CPU.

- a budget spills the coldest unreferenced owned entry and `get` refaults
  it byte for byte (live rows, -0.0, NaN, null masks, dictionary codes
  and the dictionary object itself, the padded capacity, the device);
  entries pinned by a view stay resident; `put_view` refaults a spilled
  base; a raced refault serves one winner; peaks, attribution, `stats()`
  and the store's telemetry families;
- a spill file the port writes is read by the reference's `read_spill`,
  and one the reference writes by the port's, to the same rows;
- TPC-H q18 and q21 (SF 0.002, seed 7, 4 tasks over 4 in-memory workers)
  under a budget of half their unconstrained peak: byte-identical to the
  unconstrained run, equal to the reference's, spill engaged; chaos
  `kind="oom"` collapses two workers' budgets mid-query with the same
  result;
- q3 killed at its root stage resumes from its checkpoints on a fresh
  coordinator: `checkpoint_stages_saved` / `_restored` equal to the
  reference's, the result too; at `num_tasks=2` the checkpoints do not
  fingerprint-match and the query re-executes; `recover()` on a fresh
  ServingSession after teardown; the red-line monitor preempts a query
  that `recover()` later completes; admission re-costs from the measured
  peak;
- after each test no staged slice, task entry or spill file is left.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.runtime import chaos as jchaos
from datafusion_distributed_tpu.runtime import checkpoint as jckpt
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import spill as jspill
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.ops.table import Column, Dictionary, Table
from datafusion_distributed_tpu_torch.runtime import chaos as tchaos
from datafusion_distributed_tpu_torch.runtime import checkpoint as tckpt
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import spill as tspill
from datafusion_distributed_tpu_torch.runtime.codec import (
    TableStore,
    staging_attribution,
)
from datafusion_distributed_tpu_torch.runtime.errors import (
    QueryPreemptedError,
)
from datafusion_distributed_tpu_torch.runtime.serving import (
    DONE,
    PREEMPTED,
    ServingSession,
)
from datafusion_distributed_tpu_torch.schema import DataType
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import (
    assert_results_equal,
    identical,
    port_table,
)

torch.set_num_threads(1)

import os  # noqa: E402

TPCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "queries", "tpch")
OPTS = {"bytes_per_task": 1, "task_retry_backoff_s": 0.001}


def _sql(q: str) -> str:
    with open(os.path.join(TPCH_DIR, f"{q}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def env():
    arrow = gen_tpch(sf=0.002, seed=7)
    jctx, tctx = JContext(), TContext(device="cpu")
    for ctx in (jctx, tctx):
        ctx.config.distributed_options.update(OPTS)
        for name, tbl in arrow.items():
            ctx.register_arrow(name, tbl)
    return jctx, tctx


def _coord(module, ctx, cluster, **opts):
    return module.Coordinator(
        resolver=cluster, channels=cluster,
        config_options={**ctx.config.distributed_snapshot(), **opts})


def _collect(module, ctx, cluster, q, num_tasks=4, **opts):
    coord = _coord(module, ctx, cluster, **opts)
    out = ctx.sql(_sql(q)).collect_coordinated_table(coordinator=coord,
                                                     num_tasks=num_tasks)
    return out.to_numpy(), coord


def _workers(cluster):
    return getattr(cluster, "inner", cluster).workers.values()


def _assert_no_leaks(cluster):
    for w in _workers(cluster):
        assert not w.table_store.tables, f"{w.url} leaked staged tables"
        assert len(w.registry) == 0, f"{w.url} leaked task entries"
        assert w.table_store.stats()["spill_files"] == 0, w.url


def _spills(cluster) -> int:
    return sum(w.table_store.stats()["spills"] for w in _workers(cluster))


def _tab(n: int, seed: int, capacity=None):
    """A port table on the CPU whose buffers exercise a byte-exact round
    trip: int64 keys, float64 values with -0.0, NaN and nulls, a
    dictionary-coded string column, and padding past ``n`` rows."""
    rng = np.random.default_rng(seed)
    cap = capacity or n + 24
    v = rng.standard_normal(n)
    v[:3] = (-0.0, np.nan, np.inf)
    valid = rng.random(n) > 0.1
    v[~valid] = 0.0  # the contract leaves values under a null undefined
    d = Dictionary(np.array(["a", "bb", "ccc", "zz"], dtype=object))
    codes = rng.integers(0, 3, n).astype(np.int32)  # "zz" never used

    def col(arr, dtype, validity=None, dictionary=None):
        return Column.from_numpy(arr, dtype, cap, validity, dictionary,
                                 device="cpu")

    return Table(("k", "v", "s"), (
        col(np.arange(n, dtype=np.int64) * 7 - 3, DataType.INT64),
        col(v, DataType.FLOAT64, valid),
        col(codes, DataType.STRING, dictionary=d),
    ), torch.tensor(n, dtype=torch.int32))


def _assert_same_table(got, want):
    """Every buffer byte-identical (padding included), the same null
    masks, capacity, row count, device and dictionary objects."""
    assert got.names == want.names
    assert got.capacity == want.capacity and got.device == want.device
    assert int(got.num_rows) == int(want.num_rows)
    for a, b in zip(got.columns, want.columns):
        assert a.dtype == b.dtype
        assert a.data.numpy().tobytes() == b.data.numpy().tobytes()
        assert (a.validity is None) == (b.validity is None)
        if a.validity is not None:
            assert torch.equal(a.validity, b.validity)
        assert a.dictionary is b.dictionary


# ---------------------------------------------------------------------------
# the enforced budget, entry by entry
# ---------------------------------------------------------------------------


def test_budget_spills_coldest_and_refaults_byte_exact():
    s = TableStore()
    t1, t2, t3 = _tab(4096, 1), _tab(4096, 2), _tab(4096, 3)
    i1, i2, i3 = s.put(t1), s.put(t2), s.put(t3)
    per = s.stats()["nbytes"] // 3
    s.set_budget(per * 2)
    st = s.stats()
    assert st["spills"] == 1 and st["spill_files"] == 1, st
    assert st["nbytes"] <= st["budget_bytes"] and st["spilled_nbytes"] == per
    assert type(s.tables[i1]).__name__ == "_SpilledSentinel"  # the coldest
    g1 = s.get(i1)
    assert g1 is not t1
    _assert_same_table(g1, t1)
    st = s.stats()
    assert st["refaults"] == 1 and st["nbytes"] <= st["budget_bytes"], st
    s.remove([i1, i2, i3])
    st = s.stats()
    assert (st["entries"], st["spill_files"], st["nbytes"],
            st["spilled_nbytes"]) == (0, 0, 0, 0), st


def test_view_pinned_entries_are_unspillable():
    s = TableStore()
    t1 = _tab(4096, 1)
    i1 = s.put(t1)
    v1 = s.put_view(i1, lo=0, count=128)  # pins t1's buffers
    s.set_budget(1)
    assert s.stats()["spills"] == 0
    assert s.get(i1) is t1 and s.under_pressure()
    s.remove([v1])
    s.enforce_budget()  # the pin dropped: now it spills
    assert s.stats()["spills"] == 1 and not s.under_pressure()
    s.remove([i1])
    assert s.stats()["spill_files"] == 0


def test_put_view_refaults_spilled_base():
    s = TableStore()
    t1, t2 = _tab(4096, 1), _tab(2048, 2)
    i1, i2 = s.put(t1), s.put(t2)
    s.set_budget(s.entry_nbytes(i2) + 1)  # spills t1, the coldest
    assert s.stats()["spills"] >= 1
    v = s.put_view(i1, lo=8, count=16)
    got = s.get(v)
    assert torch.equal(got.columns[0].data[:16], t1.columns[0].data[8:24])
    s.remove([v, i1, i2])
    assert s.stats()["spill_files"] == 0


def test_refault_race_keeps_one_winner():
    """Threads racing get() on one spilled entry all see the same table:
    one refault installs it, the losers serve the winner's copy (a loser
    whose file vanished under it too), and the slot is released once."""
    s = TableStore()
    t1, t2 = _tab(4096, 1), _tab(4096, 2)
    i1, i2 = s.put(t1), s.put(t2)
    s.set_budget(s.entry_nbytes(i2) + 1)  # spills i1
    with s._lock:
        stale_slot = s._meta[i1].spilled
    assert stale_slot is not None
    s.set_budget(0)  # nothing respills while the threads race
    got: list = []
    start = threading.Barrier(6)

    def reader():
        start.wait()
        got.append(s.get(i1))

    threads = [threading.Thread(target=reader) for _ in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert all(g is got[0] for g in got) and s.stats()["refaults"] == 1
    _assert_same_table(got[0], t1)
    late = s._refault(i1, stale_slot)  # its file is gone
    assert late is got[0]
    s.remove([i1, i2])
    assert s.stats()["spill_files"] == 0


def test_reset_peak_attribution_and_telemetry():
    """`stats()` and the telemetry families (the port's `stats()`
    returned None before the budget landed), per-phase peaks and
    per-query attribution."""
    from datafusion_distributed_tpu_torch.runtime.telemetry import (
        MetricRegistry,
        render_openmetrics,
    )

    s = TableStore()
    with staging_attribution("qA"):
        ia = s.put(_tab(4096, 1))
    with staging_attribution("qB"):
        ib1, ib2 = s.put(_tab(4096, 2)), s.put(_tab(4096, 3))
    assert s.query_peak_nbytes("qB") == 2 * s.query_peak_nbytes("qA") > 0
    s.remove([ia])
    assert s.query_current_nbytes("qA") == 0
    big = s.stats()["peak_nbytes"]
    assert s.sweep_query_attribution("qB") > 0
    assert s.query_peak_nbytes("qB") == 0
    s.set_budget(s.entry_nbytes(ib2) + 1)
    r = MetricRegistry()
    r.register_collector(s.telemetry_families)
    snap = r.snapshot()
    for name in ("dftpu_store_spilled_bytes", "dftpu_store_spills",
                 "dftpu_store_refaults", "dftpu_store_spill_files",
                 "dftpu_store_budget_bytes", "dftpu_store_staged_bytes"):
        assert name in snap, name
    assert snap["dftpu_store_spilled_bytes"]["samples"][0][1] > 0
    assert "dftpu_store_spilled_bytes " in render_openmetrics(snap)
    s.remove([ib1, ib2])
    assert s.reset_peak() == big and s.stats()["peak_nbytes"] == 0


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_spill_file_interop(tmp_path, direction):
    """The DFSP frame (magic, version, capacity, payload length, Arrow
    IPC) is the reference's: each package reads the other's files."""
    t = _tab(300, 5, capacity=512)
    if direction == "port_to_reference":
        slot = tspill.SpillManager(str(tmp_path)).write_spill(t, 1)
        back = jspill.SpillManager(str(tmp_path)).read_spill(
            jspill.SpillSlot(slot.path, 1, slot.file_bytes, slot.capacity))
        assert back.capacity == 512 and int(back.num_rows) == 300
        got = port_table(back)
    else:
        from datafusion_distributed_tpu.runtime import codec as jcodec

        ref = jcodec.decode_table(bytes(_encoded(t)), capacity=512)
        slot = jspill.SpillManager(str(tmp_path)).write_spill(ref, 1)
        mgr = tspill.SpillManager(str(tmp_path))
        got = mgr.read_spill(tspill.SpillSlot(
            slot.path, 1, slot.file_bytes, slot.capacity, device="cpu"))
        assert mgr.stats()["refaults"] == 1
    want = t.to_numpy()
    assert got.capacity == 512
    assert identical(got.to_numpy(), want)


def _encoded(t):
    from datafusion_distributed_tpu_torch.runtime.codec import encode_table

    return encode_table(t)


# ---------------------------------------------------------------------------
# TPC-H under a budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", ["q18", "q21"])
def test_tpch_under_budget_equals_unconstrained(env, q):
    jctx, tctx = env
    free = tcoord.InMemoryCluster(4)
    base, _ = _collect(tcoord, tctx, free, q)
    peak = max(w.table_store.stats()["peak_nbytes"]
               for w in free.workers.values())
    assert peak > 0
    cluster = tcoord.InMemoryCluster(4)
    got, _ = _collect(tcoord, tctx, cluster, q,
                      worker_memory_budget_bytes=max(peak // 2, 1))
    assert identical(got, base), q
    assert _spills(cluster) > 0, "the budget sat below the peak; no spill"
    assert all(w.table_store.budget_bytes == peak // 2
               for w in cluster.workers.values())
    _assert_no_leaks(cluster)
    ref, _ = _collect(jcoord, jctx, jcoord.InMemoryCluster(4), q)
    assert_results_equal(ref, got, q)


def test_chaos_oom_budget_collapse(env):
    tctx = env[1]
    base, _ = _collect(tcoord, tctx, tcoord.InMemoryCluster(4), "q18")
    plan = tchaos.FaultPlan(20260803, [tchaos.FaultSpec(
        site="execute", kind="oom", rate=1.0, max_total=2,
        budget_bytes=16 << 10)])
    cluster = tchaos.wrap_cluster(tcoord.InMemoryCluster(4), plan)
    got, _ = _collect(tcoord, tctx, cluster, "q18")
    assert identical(got, base)
    assert len([f for f in plan.fired if f["kind"] == "oom"]) == 2
    assert _spills(cluster) > 0
    _assert_no_leaks(cluster)


# ---------------------------------------------------------------------------
# checkpoints, resume, recover
# ---------------------------------------------------------------------------

_ROOT_CRASH = dict(site="execute", kind="crash", stages=[-1], rate=1.0)


def _run_to_failure(chaos, ckpt, module, ctx, cluster, store, rid):
    wrapped = chaos.wrap_cluster(cluster, chaos.FaultPlan(
        20260803, [chaos.FaultSpec(**_ROOT_CRASH)]))
    c1 = _coord(module, ctx, wrapped, peer_shuffle=False,
                max_task_retries=0)
    c1.checkpoints = ckpt.QueryCheckpointer(store, rid, wrapped, wrapped)
    with pytest.raises(Exception, match="injected worker crash"):
        ctx.sql(_sql("q3")).collect_coordinated_table(coordinator=c1,
                                                      num_tasks=4)
    return c1


def _resume(chaos, ckpt, module, ctx, num_tasks=4):
    cluster = module.InMemoryCluster(4)
    store = ckpt.CheckpointStore()
    rid = store.admit(_sql("q3"))
    c1 = _run_to_failure(chaos, ckpt, module, ctx, cluster, store, rid)
    assert store.stats()["recoverable"] == 1
    c2 = _coord(module, ctx, cluster, peer_shuffle=False)
    c2.checkpoints = ckpt.QueryCheckpointer(store, rid, cluster, cluster)
    out = ctx.sql(_sql("q3")).collect_coordinated_table(
        coordinator=c2, num_tasks=num_tasks).to_numpy()
    counts = (c1.faults.as_dict(), c2.faults.as_dict())
    store.release(rid, cluster)
    assert store.stats()["staged_bytes"] == 0
    _assert_no_leaks(cluster)
    return out, counts


def test_checkpoint_resume_q3_equals_reference(env):
    jctx, tctx = env
    got, (saved, resumed) = _resume(tchaos, tckpt, tcoord, tctx)
    ref, (jsaved, jresumed) = _resume(jchaos, jckpt, jcoord, jctx)
    n = saved.get("checkpoint_stages_saved", 0)
    assert n >= 2, saved
    assert n == jsaved.get("checkpoint_stages_saved"), (saved, jsaved)
    assert resumed.get("checkpoint_stages_restored") == n, resumed
    assert resumed.get("queries_resumed") == 1
    for k in ("checkpoint_stages_restored", "queries_resumed",
              "checkpoint_fp_mismatch"):
        assert resumed.get(k) == jresumed.get(k), (k, resumed, jresumed)
    base, _ = _collect(tcoord, tctx, tcoord.InMemoryCluster(4), "q3",
                       peer_shuffle=False)
    assert identical(got, base)
    assert_results_equal(ref, got, "resumed q3")


def test_resume_fingerprint_mismatch_falls_back(env):
    """Resumed at num_tasks=2 the stages fingerprint differently: nothing
    restores, the query re-executes and still equals its own plan."""
    tctx = env[1]
    got, (_saved, resumed) = _resume(tchaos, tckpt, tcoord, tctx,
                                     num_tasks=2)
    assert resumed.get("checkpoint_stages_restored", 0) == 0, resumed
    assert resumed.get("checkpoint_fp_mismatch", 0) >= 1, resumed
    base, _ = _collect(tcoord, tctx, tcoord.InMemoryCluster(4), "q3",
                       num_tasks=2, peer_shuffle=False)
    assert identical(got, base)


def test_serving_recover_after_teardown(env):
    """Session 1's query dies at its root stage; the CheckpointStore
    outlives the session; session 2's recover() completes it from the
    staged frontier, and the store drains to 0 staged bytes."""
    jctx, tctx = env
    inner = tcoord.InMemoryCluster(4)
    store = tckpt.CheckpointStore()
    opts = tctx.config.distributed_options
    opts.update(max_task_retries=0, peer_shuffle=False)
    try:
        crashing = tchaos.wrap_cluster(inner, tchaos.FaultPlan(
            20260803, [tchaos.FaultSpec(**_ROOT_CRASH, max_total=1)]))
        srv1 = ServingSession(tctx, cluster=crashing, num_tasks=4,
                              checkpoints=store)
        h1 = srv1.submit(_sql("q3"))
        with pytest.raises(Exception, match="injected worker crash"):
            h1.result_table(timeout=120)
        srv1.close()
    finally:
        opts.pop("max_task_retries", None)
    st = store.stats()
    assert st["recoverable"] == 1 and st["stages"] >= 2, st
    try:
        srv2 = ServingSession(tctx, cluster=inner, num_tasks=4,
                              checkpoints=store)
        handles = srv2.recover()
        assert len(handles) == 1
        got = handles[0].result_table(timeout=120).to_numpy()
        fc = srv2.faults.as_dict()
        assert fc.get("queries_recovered") == 1, fc
        assert fc.get("checkpoint_stages_restored") == st["stages"], fc
        srv2.close()
    finally:
        opts.pop("peer_shuffle", None)
    assert store.stats()["recoverable"] == 0
    assert store.stats()["staged_bytes"] == 0
    _assert_no_leaks(inner)
    ref, _ = _collect(jcoord, jctx, jcoord.InMemoryCluster(4), "q3")
    assert_results_equal(ref, got, "recovered q3")


def test_checkpoint_store_evicts_oldest_past_cap():
    cluster = tcoord.InMemoryCluster(2)
    tables = [_tab(2048, i) for i in range(3)]
    nb = sum(int(c.data.nbytes) + (int(c.validity.nbytes)
                                   if c.validity is not None else 0)
             for c in tables[0].columns)
    store = tckpt.CheckpointStore(budget_bytes=int(nb * 2.5))
    rid = store.admit("select 1")
    for sid in range(3):
        assert store.save_stage(rid, 0, sid, f"fp{sid}", [tables[sid]],
                                False, False, 1, cluster, cluster) == nb
    st = store.stats()
    assert st["checkpoint_evicted_budget"] == 1 and st["stages"] == 2, st
    assert store.restore_stage(rid, 0, 0, "fp0", cluster) == (None, "miss")
    assert store.restore_stage(rid, 0, 1, "other", cluster) == (
        None, "fp_mismatch")
    hit, why = store.restore_stage(rid, 0, 2, "fp2", cluster)
    assert why == "hit" and hit[0][0] is tables[2]
    store.release(rid, cluster)
    for w in cluster.workers.values():
        assert not w.table_store.tables


def test_redline_preempts_and_recover_completes(env):
    """A worker pinned over the red-line sheds the running query through
    the cancel path (QueryPreemptedError, PREEMPTED, its checkpoint
    frontier kept); once pressure clears recover() completes it."""
    tctx = env[1]
    store = tckpt.CheckpointStore()
    cluster = tchaos.wrap_cluster(tcoord.InMemoryCluster(4), tchaos.FaultPlan(
        1, [tchaos.FaultSpec(site="execute", kind="delay", delay_s=0.1,
                             rate=1.0)], query_scoped=True))
    srv = ServingSession(tctx, cluster=cluster, num_tasks=4,
                         checkpoints=store)
    w0 = next(iter(_workers(cluster)))
    pinned = []
    try:
        h = srv.submit(_sql("q18"))
        deadline = time.monotonic() + 30
        while h.status() == "queued" and time.monotonic() < deadline:
            time.sleep(0.005)
        base = w0.table_store.put(_tab(1 << 15, 99))
        pinned = [base, w0.table_store.put_view(base, lo=0, count=64)]
        w0.table_store.set_budget(1)
        with pytest.raises(QueryPreemptedError):
            h.result_table(timeout=120)
        assert h.status() == PREEMPTED
        assert h.status(detail=True)["preempted"] is True
        assert srv.stats()["completed"].get(PREEMPTED) == 1
        assert store.stats()["recoverable"] == 1
        w0.table_store.remove(pinned)
        pinned = []
        w0.table_store.set_budget(0)
        handles = srv.recover()
        got = handles[0].result_table(timeout=120).to_numpy()
    finally:
        if pinned:
            w0.table_store.remove(pinned)
        w0.table_store.set_budget(0)
        srv.close()
    base_out, _ = _collect(tcoord, tctx, tcoord.InMemoryCluster(4), "q18")
    assert identical(got, base_out)
    assert store.stats()["recoverable"] == 0
    _assert_no_leaks(cluster)


def test_admission_recost_uses_measured_peak(env):
    with ServingSession(env[1], num_workers=2, num_tasks=2) as srv:
        h1 = srv.submit(_sql("q6"))
        h1.result_table(timeout=120)
        assert h1.status() == DONE and h1.peak_staged_bytes > 0
        h2 = srv.submit(_sql("q6"))
        h2.result_table(timeout=120)
        assert h2.est_bytes == h1.peak_staged_bytes
        assert srv.stats()["memory"]["measured_queries"] == 1
    _assert_no_leaks(srv.cluster)


def test_serving_under_a_worker_budget(env):
    """Concurrent q1, q6 and q18 under a worker budget of half their
    aggregate peak: byte-identical to sequential runs, spill engaged."""
    tctx = env[1]
    mix = ("q1", "q6", "q18")
    base = {q: _collect(tcoord, tctx, tcoord.InMemoryCluster(4), q)[0]
            for q in mix}
    probe = tcoord.InMemoryCluster(4)
    with ServingSession(tctx, cluster=probe, num_tasks=4) as srv:
        for h in [srv.submit(_sql(q)) for q in mix]:
            h.result_table(timeout=120)
    peak = max(w.table_store.stats()["peak_nbytes"]
               for w in probe.workers.values())
    opts = tctx.config.distributed_options
    opts.update(worker_memory_budget_bytes=max(peak // 2, 1),
                worker_memory_redline=0)
    cluster = tcoord.InMemoryCluster(4)
    try:
        with ServingSession(tctx, cluster=cluster, num_tasks=4) as srv:
            handles = [(q, srv.submit(_sql(q))) for _ in range(2)
                       for q in mix]
            for q, h in handles:
                assert identical(h.result_table(timeout=120).to_numpy(),
                                 base[q]), q
            assert srv.stats()["memory"]["workers"]
    finally:
        opts.pop("worker_memory_budget_bytes", None)
        opts.pop("worker_memory_redline", None)
    assert _spills(cluster) > 0
    _assert_no_leaks(cluster)
