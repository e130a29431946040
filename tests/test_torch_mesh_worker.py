"""The port's meshes-as-workers tier (runtime/mesh_worker.py and the
coordinator's span dispatch) against the reference's, on the CPU.

The port's `InMemoryMeshCluster(2, 4, devices=["cpu"] * 8)` (two workers of
four local tasks, all on one device) against the reference's
`InMemoryMeshCluster(2, 4)` on its 8 virtual devices (tests/conftest.py),
8 tasks:

- the counterparts of tests/test_mesh_worker.py: join with aggregate,
  broadcast, `span_specialized`'s re-slicing and the union fallback, equal
  to the reference (ints, strings and row order exact, floats at
  test_rtol()); every worker ran a span; the peer plane carried the
  exchange between workers with `coordinator_bytes == 0`;
- TPC-H q1, q3, q5 and q21 at SF 0.002, seed 7: results, result capacity,
  retry count, and every span's per-task output capacities and row counts
  (after the repad of its inputs) equal to the reference's; q11 fails
  DFTPU043 in the reference (ROADMAP §C) and equals single-node in the port;
- every worker's TableStore and task registry empty after each query;
- `_repad_uniform` on slices of different capacities, dictionaries and
  validity, equal to the reference's;
- a span task that fails once with WorkerUnavailableError is not
  re-dispatched alone: the same exception type and FaultCounters in both
  packages; the coordinator's span caches are kept per query and swept;
- q1 and q3 in a DFTPU_PRECISION=x64 subprocess;
- 16 threads executing one span's 4 tasks at once: the span runs once,
  each task gets the reference's slot, and the span is dropped once its
  last task leaves the registry.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import errors as jerrors
from datafusion_distributed_tpu.runtime import mesh_worker as jmw
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import errors as terrors
from datafusion_distributed_tpu_torch.runtime import mesh_worker as tmw
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_results_equal, np_of

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCH_DIR = os.path.join(REPO, "benchmarks", "queries", "tpch")
NT = 8
BOTH = (("reference", jcoord, jmw, JContext),
        ("port", tcoord, tmw, TContext))


def _sql(q: str) -> str:
    with open(os.path.join(TPCH_DIR, f"{q}.sql")) as f:
        return f.read()


def _port_cluster():
    return tmw.InMemoryMeshCluster(2, 4, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def clusters():
    return {"reference": jmw.InMemoryMeshCluster(2, 4),
            "port": _port_cluster()}


def _context(cls, **tables):
    ctx = cls(device="cpu") if cls is TContext else cls()
    for name, tbl in tables.items():
        ctx.register_arrow(name, tbl)
    ctx.config.distributed_options["bytes_per_task"] = 1
    return ctx


def _join_tables(n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "t": pa.table({"k": rng.integers(0, 50, n),
                       "v": rng.normal(size=n)}),
        "u": pa.table({"k": np.arange(50),
                       "name": np.asarray([f"name{i:02d}" for i in range(50)],
                                          dtype=object)}),
    }


def _assert_clean(cluster, what):
    for w in cluster.workers.values():
        assert not w.table_store.tables, (what, w.url, "staged tables left")
        assert len(w.registry) == 0, (what, w.url, "task entries left")


def _spans_ran(name, w) -> bool:
    # the port drops a span once its tasks are gone and counts the runs
    return w.spans_run > 0 if name == "port" else bool(w._spans)


def _run_both(clusters, sql, opts=None, tables=None, contexts=None,
              config=None):
    """``sql`` through Coordinator over each package's mesh cluster at 8
    tasks -> {package: (result Table, coordinator, DataFrame)}."""
    out = {}
    for name, coord_mod, _mw, cls in BOTH:
        cluster = clusters[name]
        if contexts is not None:
            ctx = contexts[name]
        else:
            ctx = _context(cls, **tables)
            ctx.config.distributed_options.update(opts or {})
        coord = coord_mod.Coordinator(
            resolver=cluster, channels=cluster,
            config_options={**ctx.config.distributed_snapshot(),
                            **(config or {})})
        df = ctx.sql(sql)
        res = df.collect_coordinated_table(coordinator=coord, num_tasks=NT)
        _assert_clean(cluster, f"{name}: {sql[:40]}")
        out[name] = (res, coord, df)
    return out


def test_mesh_worker_join_agg_matches_reference(clusters):
    """Join + aggregate + sort across 2 workers × 4 local tasks equals the
    reference; every worker ran a span; the exchange between the workers
    went through the peer plane, none of it through the coordinator."""
    sql = ("select u.name, sum(t.v) s, count(*) c from t join u on "
           "t.k = u.k group by u.name order by s desc")
    got = _run_both(clusters, sql, {"broadcast_joins": False},
                    _join_tables())
    assert_results_equal(got["reference"][0].to_numpy(),
                         got["port"][0].to_numpy(), "join + aggregate")
    single = got["port"][2].collect_table().to_numpy()
    assert_results_equal(single, got["port"][0].to_numpy(), "single-node")
    for name, *_ in BOTH:
        for url, w in clusters[name].workers.items():
            assert _spans_ran(name, w), f"{name}: {url} never ran a span"
        peer = [m for m in got[name][1].stream_metrics.values()
                if m.get("plane") == "peer"]
        assert peer and all(m["coordinator_bytes"] == 0 for m in peer), name


def test_mesh_worker_broadcast_matches_reference(clusters):
    """A small build side broadcasts between the workers (replicate-mode
    peer pulls, one FULL copy per consumer task)."""
    sql = ("select u.name, sum(t.v) s from t join u on t.k = u.k "
           "group by u.name order by u.name")
    got = _run_both(clusters, sql, {"broadcast_joins": True,
                                    "broadcast_threshold_rows": 1 << 17},
                    _join_tables(seed=1))
    assert_results_equal(got["reference"][0].to_numpy(),
                         got["port"][0].to_numpy(), "broadcast join")
    assert got["port"][0].capacity == got["reference"][0].capacity


def test_mesh_worker_union_falls_back_to_per_task(clusters):
    """Plans with isolated union arms cannot be expressed as spans:
    dispatch falls back to per-task execution and stays correct."""
    rng = np.random.default_rng(5)
    n = 6_000
    tables = {
        "a": pa.table({"k": rng.integers(0, 30, n), "v": rng.normal(size=n)}),
        "b": pa.table({"k": rng.integers(0, 30, n), "v": rng.normal(size=n)}),
    }
    sql = ("select k, sum(v) s from (select k, v from a union all "
           "select k, v from b) u group by k order by k")
    got = _run_both(clusters, sql, tables=tables)
    assert_results_equal(got["reference"][0].to_numpy(),
                         got["port"][0].to_numpy(), "union all")
    verdicts = {name: sorted((k[1], v) for k, v in
                             got[name][1]._span_ok_cache.items())
                for name, *_ in BOTH}
    assert verdicts["port"] == verdicts["reference"]


# ---------------------------------------------------------------------------
# span_specialized and the repad, node for node
# ---------------------------------------------------------------------------


def _scan_cases():
    """case -> (build(package modules) -> (node, lo, hi), what to read of
    the specialized node)."""

    def memory(n_tasks):
        def build(pkg):
            tables = [pkg["arrow"](pa.table({
                "x": np.arange(4) + 10 * i,
                "s": np.asarray([f"s{i}{j}" for j in range(4)],
                                dtype=object)}))
                for i in range(n_tasks)]
            return pkg["phys"].MemoryScanExec(tables, tables[0].schema())
        return build

    def read_memory(node):
        return [(int(t.capacity), int(t.num_rows),
                 {k: list(v) for k, v in t.to_numpy().items()},
                 sorted(str(c.dictionary.values.tolist())
                        for c in t.columns if c.dictionary is not None))
                for t in node.tasks]

    def peer(replicated):
        def build(pkg):
            schema = pkg["arrow"](pa.table({"x": np.arange(2)})).schema()
            pulls = [[(("q", 1, p), f"mem://worker-{p % 2}", p, p + 1)]
                     for p in range(4)]
            return pkg["peer"].PeerShuffleScanExec(
                pulls, [] if replicated else ["x"], 4, 16, schema,
                replicated=replicated, chunk_rows=512, capacity_hint=64)
        return build

    def read_peer(node):
        return (node.pulls_per_task, node.key_names, node.num_partitions,
                node.per_dest_capacity, node.replicated, node.chunk_rows,
                node.capacity_hint, node.budget_bytes)

    def parquet(pkg):
        schema = pkg["arrow"](pa.table({"x": np.arange(2)})).schema()
        return pkg["phys"].ParquetScanExec(
            [[f"part-{i}.parquet"] for i in range(8)], schema, 1024,
            projection=["x"])

    def read_parquet(node):
        return (node.file_groups, node.capacity, node.projection)

    return {
        "memory scan": (memory(8), 4, 8, read_memory),
        "memory scan past its slices": (memory(3), 4, 8, read_memory),
        "shuffle pulls": (peer(False), 2, 4, read_peer),
        "broadcast pulls wrap": (peer(True), 2, 6, read_peer),
        "parquet file groups": (parquet, 4, 8, read_parquet),
    }


def _pkg(name):
    if name == "reference":
        from datafusion_distributed_tpu.io.parquet import arrow_to_table
        from datafusion_distributed_tpu.ops import table
        from datafusion_distributed_tpu.plan import physical
        from datafusion_distributed_tpu.runtime import peer
        return {"arrow": arrow_to_table, "phys": physical, "peer": peer,
                "mw": jmw, "table": table}
    from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
    from datafusion_distributed_tpu_torch.ops import table
    from datafusion_distributed_tpu_torch.plan import physical
    from datafusion_distributed_tpu_torch.runtime import peer
    return {"arrow": lambda t: arrow_to_table(t, device="cpu"),
            "phys": physical, "peer": peer, "mw": tmw, "table": table}


@pytest.mark.parametrize("case", list(_scan_cases()))
def test_span_specialized_reslices_leaves(case):
    """span_specialized re-indexes leaf slices to local positions: scans
    re-sliced, a scan past its slices one empty table of tasks[0]'s
    capacity and dictionaries, broadcast pulls wrapped over the planned
    partitions, file groups re-sliced: as the reference's."""
    build, lo, hi, read = _scan_cases()[case]
    got = {}
    for name in ("reference", "port"):
        pkg = _pkg(name)
        got[name] = read(pkg["mw"].span_specialized(build(pkg), lo, hi))
    assert got["port"] == got["reference"]
    if case == "memory scan":
        assert got["port"][0][2]["x"] == [40, 41, 42, 43]
    if case == "broadcast pulls wrap":
        assert [p[0][2] for p in got["port"][0]] == [2, 3, 0, 1]


def test_repad_uniform_matches_reference():
    """The span's slices of one leaf: capacities raised to the largest,
    string codes remapped into one union dictionary, validity added where
    a slice has none; an empty slice without a dictionary takes the
    union's."""
    parts = [
        pa.table({"k": np.arange(3), "s": ["b", "a", "b"]}),
        pa.table({"k": pa.array([7, None, 9]),
                  "s": pa.array(["c", None, "a"])}),
    ]
    got = {}
    for name in ("reference", "port"):
        pkg = _pkg(name)
        tables = [pkg["arrow"](parts[0]), pkg["arrow"](parts[1])]
        table = pkg["table"]
        tables[1] = table.concat_tables([tables[1]], capacity=16)
        empty_kw = {"device": "cpu"} if name == "port" else {}
        tables.append(table.Table.empty(tables[0].schema(), 8, None,
                                        **empty_kw))
        out = pkg["mw"]._repad_uniform(tables)
        got[name] = [
            (int(t.capacity), int(t.num_rows),
             [(np_of(c.data)[:int(t.num_rows)].tolist(),
               None if c.validity is None
               else np_of(c.validity)[:int(t.num_rows)].tolist(),
               None if c.dictionary is None
               else list(c.dictionary.values))
              for c in t.columns])
            for t in out]
    assert got["port"] == got["reference"]
    assert {cap for cap, _, _ in got["port"]} == {16}


# ---------------------------------------------------------------------------
# TPC-H
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    arrow = gen_tpch(sf=0.002, seed=7)
    return {name: _context(cls, **arrow) for name, _c, _m, cls in BOTH}


def _recording_spans(monkeypatch):
    """Every span each package runs: (column names, per-task output
    capacities, per-task row counts)."""
    rec = {"reference": [], "port": []}

    def note(name, outs):
        rec[name].append((tuple(outs[0].names),
                          tuple(int(o.capacity) for o in outs),
                          tuple(int(o.num_rows) for o in outs)))
        return outs

    j_run, t_run = jmw.execute_stage_span_on_mesh, tmw.execute_stage_span
    monkeypatch.setattr(jmw, "execute_stage_span_on_mesh",
                        lambda *a, **k: note("reference", j_run(*a, **k)))
    monkeypatch.setattr(tmw, "execute_stage_span",
                        lambda *a, **k: note("port", t_run(*a, **k)))
    return rec


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q21"])
def test_tpch_over_mesh_workers_matches_reference(clusters, tpch, q,
                                                  monkeypatch):
    rec = _recording_spans(monkeypatch)
    got = _run_both(clusters, _sql(q), contexts=tpch)
    (jres, _jc, jdf), (tres, tco, tdf) = got["reference"], got["port"]
    assert_results_equal(jres.to_numpy(), tres.to_numpy(), q)
    assert tres.names == jres.names and tres.capacity == jres.capacity, q
    assert tdf.last_retry_count == jdf.last_retry_count, q
    assert rec["port"] and sorted(rec["port"]) == sorted(rec["reference"]), q
    single = tpch["port"].sql(_sql(q)).collect_table()
    assert_results_equal(single.to_numpy(), tres.to_numpy(), f"{q} single")
    for w in clusters["port"].workers.values():
        assert not w._spans, (q, w.url, "span outputs kept")


def test_q11_fails_in_the_reference_and_equals_single_node_in_the_port(
        clusters, tpch):
    """The reference's codec ships q11's resolved scalar subquery as a
    literal the worker then hoists (ROADMAP §C); the port ships a subquery
    constant."""
    sql = _sql("q11")
    coord = jcoord.Coordinator(
        resolver=clusters["reference"], channels=clusters["reference"],
        config_options=tpch["reference"].config.distributed_snapshot())
    with pytest.raises(jerrors.PlanIntegrityError, match="DFTPU043"):
        tpch["reference"].sql(sql).collect_coordinated_table(
            coordinator=coord, num_tasks=NT)
    cluster = clusters["port"]
    coord = tcoord.Coordinator(
        resolver=cluster, channels=cluster,
        config_options=tpch["port"].config.distributed_snapshot())
    got = tpch["port"].sql(sql).collect_coordinated_table(
        coordinator=coord, num_tasks=NT)
    _assert_clean(cluster, "q11")
    single = tpch["port"].sql(sql).collect_table()
    assert_results_equal(single.to_numpy(), got.to_numpy(), "q11")
    ref = tpch["reference"].sql(sql).collect_table()
    assert_results_equal(ref.to_numpy(), got.to_numpy(), "q11 reference")


# ---------------------------------------------------------------------------
# the coordinator: the retry guard and the span caches
# ---------------------------------------------------------------------------


def _fail_once(cluster, exc):
    """The second worker raises ``exc`` from its first execute_task."""
    w = cluster.workers[sorted(cluster.workers)[1]]
    real = w.execute_task
    state = {"left": 1}

    def execute_task(key, *a, **kw):
        if state["left"]:
            state["left"] -= 1
            raise exc(f"injected: {w.url} is gone", worker_url=w.url,
                      task=key)
        return real(key, *a, **kw)

    w.execute_task = execute_task


def test_failed_span_task_is_not_redispatched_alone():
    """A task of a shipped span that fails with a retryable error: the
    span plan is shared by its siblings, so no lone re-dispatch; the error
    surfaces with the reference's type and FaultCounters."""
    sql = ("select u.name, sum(t.v) s, count(*) c from t join u on "
           "t.k = u.k group by u.name order by s desc")
    out = {}
    for name, coord_mod, mw, cls in BOTH:
        cluster = (mw.InMemoryMeshCluster(2, 4) if name == "reference"
                   else _port_cluster())
        errors = jerrors if name == "reference" else terrors
        _fail_once(cluster, errors.WorkerUnavailableError)
        ctx = _context(cls, **_join_tables(seed=2))
        coord = coord_mod.Coordinator(
            resolver=cluster, channels=cluster,
            config_options={**ctx.config.distributed_snapshot(),
                            "data_plane": "unary",
                            "task_retry_backoff_s": 0.0})
        with pytest.raises(errors.WorkerUnavailableError) as ei:
            ctx.sql(sql).collect_coordinated_table(coordinator=coord,
                                                   num_tasks=NT)
        stage = ei.value.task.stage_id
        assert coord._stage_span_shipped(coord.last_query_id, stage), name
        out[name] = (type(ei.value).__name__, ei.value.retryable,
                     coord.faults.as_dict())
    assert out["port"] == out["reference"]
    assert "task_retries" not in out["port"][2]


def test_span_caches_kept_per_query_and_swept(clusters):
    """The coordinator keeps each shipped span and each stage's verdict
    until the query is swept (or the next execute starts afresh), as the
    reference's does."""
    sql = ("select u.name, count(*) c from t join u on t.k = u.k "
           "group by u.name order by u.name")
    got = _run_both(clusters, sql, {"broadcast_joins": False},
                    _join_tables(n=4_000, seed=3))
    kept = {}
    for name, *_ in BOTH:
        coord = got[name][1]
        qid = coord.last_query_id
        shipped = sorted(k[1:] for k in coord._span_shipped if k[0] == qid)
        assert shipped and all(coord._stage_span_shipped(qid, s)
                               for s, _lo in shipped), name
        kept[name] = (shipped, sorted(k[1] for k in coord._span_ok_cache))
        coord.sweep_query(qid)
        assert not coord._span_shipped and not coord._span_ok_cache, name
        assert not any(coord._stage_span_shipped(qid, s) for s, _ in shipped)
    assert kept["port"] == kept["reference"]


def test_too_few_devices_raise_as_the_reference():
    msgs = []
    for mw, dev in ((jmw, None), (tmw, "cpu")):
        devs = jax.devices()[:3] if dev is None else [dev] * 3
        with pytest.raises(ValueError) as ei:
            mw.InMemoryMeshCluster(2, 4, devices=devs)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == "8 devices needed, 3 available"
    # the default is one card a task
    with pytest.raises(ValueError, match="8 devices needed, "
                       f"{torch.cuda.device_count()} available"):
        tmw.InMemoryMeshCluster(2, 4)


_X64_SCRIPT = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(1)
    from datafusion_distributed_tpu.data.tpchgen import gen_tpch
    from datafusion_distributed_tpu_torch import precision
    from tests.test_torch_mesh_worker import (
        BOTH, _context, _port_cluster, _run_both)
    from datafusion_distributed_tpu.runtime import mesh_worker as jmw
    from tests.torch_port_helpers import assert_results_equal
    assert precision.MODE == "x64"
    arrow = gen_tpch(0.002, 7)
    contexts = {{name: _context(cls, **arrow) for name, _c, _m, cls in BOTH}}
    clusters = {{"reference": jmw.InMemoryMeshCluster(2, 4),
                "port": _port_cluster()}}
    for q in {queries!r}:
        sql = open(f"{qdir}/{{q}}.sql").read()
        got = _run_both(clusters, sql, contexts=contexts)
        ref, port = got["reference"][0], got["port"][0]
        assert_results_equal(ref.to_numpy(), port.to_numpy(), q)
        assert port.capacity == ref.capacity, q
    print("X64-MESH-OK")
""")


def test_mesh_workers_match_reference_in_x64_mode():
    script = _X64_SCRIPT.format(qdir=TPCH_DIR, queries=("q1", "q3"))
    env = dict(os.environ, DFTPU_PRECISION="x64", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "X64-MESH-OK" in proc.stdout


def test_span_runs_once_under_concurrent_sibling_tasks():
    """16 threads execute the 4 tasks of one shipped span at once, with a
    short switch interval: the span runs exactly once, each task gets its
    own slot (as the reference's worker serves them), and the span is
    dropped once its last task leaves the registry."""
    import threading

    from datafusion_distributed_tpu.runtime.codec import encode_plan as jenc
    from datafusion_distributed_tpu.runtime.worker import TaskKey as JKey
    from datafusion_distributed_tpu_torch.runtime.codec import encode_plan
    from datafusion_distributed_tpu_torch.runtime.worker import TaskKey

    def scan(pkg):
        tables = [pkg["arrow"](pa.table({"x": np.arange(4) + 10 * i}))
                  for i in range(8)]
        return pkg["mw"].span_specialized(
            pkg["phys"].MemoryScanExec(tables, tables[0].schema()), 4, 8)

    ref_worker = jmw.MeshWorker("mesh://ref", jax.devices()[:4])
    ref_worker.set_stage_plan("q", 0, 4, 8, NT,
                              jenc(scan(_pkg("reference")),
                                   ref_worker.table_store))
    want = [np_of(ref_worker.execute_task(JKey("q", 0, i)).columns[0].data)
            .tolist() for i in range(4, 8)]

    worker = tmw.MeshWorker("mesh://port", ["cpu"] * 4)
    worker.set_stage_plan("q", 0, 4, 8, NT,
                          encode_plan(scan(_pkg("port")), worker.table_store))
    got: dict = {}
    errors: list = []

    def run(i):
        try:
            out = worker.execute_task(TaskKey("q", 0, 4 + i % 4))
            got.setdefault(i % 4, []).append(np_of(out.columns[0].data)
                                             .tolist())
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert worker.spans_run == 1
    assert [got[i] for i in range(4)] == [[w] * 4 for w in want]
    assert len(worker._spans) == 1
    for i in range(4, 8):
        worker.registry.invalidate(TaskKey("q", 0, i))
    assert not worker._spans and not worker.table_store.tables
