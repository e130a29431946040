"""One rank of the port's SPMD tests (tests/test_torch_spmd.py,
tests/test_torch_cuda.py): a process of a torch.distributed group that runs
a list of cases over `runtime/mesh_executor.make_mesh()` and pickles what
each case gave.

    python tests/torch_spmd_rank.py <job.json> <rank>

The job names the group's init file (``file://``), its size, the device,
the collective timeout and the cases; rank r writes ``rank<r>.pkl`` beside
the job file. `run_ranks` starts the ranks of one job and reads their
results. A case that raises records its error and the ranks go on with the
next case (an error every rank raises together leaves the group usable).

Imports nothing of jax, and a rank blocks any import of jax or of the JAX
package: the data and plans the JAX package's side needs are built from
numpy here and imported by the tests.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import pyarrow as pa

REPO = Path(__file__).resolve().parent.parent
TPCH_DIR = REPO / "benchmarks" / "queries" / "tpch"
WORDS = ["ant", "bee", "cat", "dog", "eel", "fox", "gnu"]
CAP = 32
SAMPLES = 8  # range-shuffle samples a task, so that small tables split

# ---------------------------------------------------------------------------
# the exchange cases: per-task tables made from a seed on every rank
# ---------------------------------------------------------------------------

#: name -> (kind, arguments); every case runs at world size 2 and 4
EXCHANGE_CASES = {
    "shuffle k": ("shuffle", {"keys": ["k"], "per_dest": CAP}),
    "shuffle k,s": ("shuffle", {"keys": ["k", "s"], "per_dest": CAP}),
    "shuffle f": ("shuffle", {"keys": ["f"], "per_dest": 16}),
    "shuffle b,i": ("shuffle", {"keys": ["b", "i"], "per_dest": CAP}),
    "shuffle overflow": ("shuffle", {"keys": ["k"], "per_dest": 4}),
    "shuffle strings differ": ("shuffle", {"keys": ["s"], "per_dest": CAP,
                                           "dicts": "differ"}),
    "shuffle validity differs": ("shuffle", {"keys": ["i"], "per_dest": CAP,
                                             "validity": "mixed"}),
    "range k": ("range", {"keys": [("k", True, False)]}),
    "range f desc": ("range", {"keys": [("f", False, False)]}),
    "range s desc,k": ("range", {"keys": [("s", False, True),
                                          ("k", True, False)]}),
    "range overflow": ("range", {"keys": [("k", True, False)],
                                 "per_dest": 4}),
    "range strings differ": ("range", {"keys": [("s", True, False)],
                                       "dicts": "differ"}),
    "broadcast": ("broadcast", {}),
    "broadcast strings differ": ("broadcast", {"dicts": "differ",
                                               "validity": "mixed"}),
    "coalesce": ("coalesce", {}),
    "group of 2": ("group", {"consumers": 2}),
    "group of 3": ("group", {"consumers": 3}),
    "group strings differ": ("group", {"consumers": 2, "dicts": "differ",
                                       "validity": "mixed"}),
    "all empty": ("shuffle", {"keys": ["k"], "per_dest": CAP,
                              "rows": "empty"}),
}


def task_tables(seed: int, num_tasks: int, dicts: str = "same",
                validity: str = "all", rows: str = "mixed") -> list:
    """The producer tables of every task (on the CPU): ints with nulls,
    strings, floats with NaN and -0.0, ints, booleans; task 0 full, task
    1 empty, the rest random. Every task's dictionary is its own object;
    with ``dicts="differ"`` each also holds another vocabulary; with
    ``validity="mixed"`` column ``i`` has validity on even tasks only."""
    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.ops.table import (
        Column,
        Dictionary,
        Table,
    )
    from datafusion_distributed_tpu_torch.schema import DataType

    x64 = precision.MODE == "x64"
    ity = np.int64 if x64 else np.int32
    fty = np.float64 if x64 else np.float32
    rng = np.random.default_rng(seed)
    counts = [CAP, 0] + [int(rng.integers(0, CAP + 1))
                         for _ in range(num_tasks - 2)]
    if rows == "empty":
        counts = [0] * num_tasks
    out = []
    for p in range(num_tasks):
        words = WORDS
        if dicts == "differ":
            words = sorted(set(WORDS[p % 3:]) | {f"w{p}", f"x{p % 2}"})
        f = rng.normal(size=CAP).astype(fty)
        f[rng.random(CAP) < 0.1] = np.nan
        f[rng.random(CAP) < 0.1] = -0.0
        cols = {
            "k": (rng.integers(-6, 6, CAP).astype(ity),
                  rng.random(CAP) > 0.15, "int64", None),
            "s": (rng.integers(0, len(words), CAP).astype(np.int32),
                  rng.random(CAP) > 0.1, "string",
                  Dictionary(np.asarray(words, dtype=object))),
            "f": (f, rng.random(CAP) > 0.1, "float64", None),
            "i": (rng.integers(-2**30, 2**30, CAP).astype(ity),
                  rng.random(CAP) > 0.2 if validity == "mixed"
                  and p % 2 == 0 else None, "int32", None),
            "b": (rng.random(CAP) < 0.5, None, "bool", None),
        }
        out.append(Table(tuple(cols), tuple(
            Column(torch.from_numpy(d.copy()),
                   None if v is None else torch.from_numpy(v.copy()),
                   DataType(ty), dic)
            for d, v, ty, dic in cols.values()),
            torch.tensor(counts[p], dtype=torch.int32)))
    return out


def table_difference(a, b) -> str:
    """'' when two port Tables are equal byte for byte (names, capacity,
    num_rows, each column's dtype, data and validity past the live rows
    too, dictionary values), else what differs."""
    if a.names != b.names:
        return f"names {a.names} != {b.names}"
    if a.capacity != b.capacity:
        return f"capacity {a.capacity} != {b.capacity}"
    if a.num_rows.dtype != b.num_rows.dtype or int(a.num_rows) != int(
            b.num_rows):
        return f"num_rows {a.num_rows!r} != {b.num_rows!r}"
    for name, x, y in zip(a.names, a.columns, b.columns):
        if x.dtype != y.dtype or x.data.dtype != y.data.dtype:
            return f"{name}: dtype {x.data.dtype} != {y.data.dtype}"
        if x.data.cpu().numpy().tobytes() != y.data.cpu().numpy().tobytes():
            return f"{name}: data differs"
        if (x.validity is None) != (y.validity is None):
            return f"{name}: validity {x.validity is None} != " \
                   f"{y.validity is None}"
        if x.validity is not None and not np.array_equal(
                x.validity.cpu().numpy(), y.validity.cpu().numpy()):
            return f"{name}: validity differs"
        if (x.dictionary is None) != (y.dictionary is None) or (
                x.dictionary is not None and list(x.dictionary.values)
                != list(y.dictionary.values)):
            return f"{name}: dictionary differs"
    return ""


def check_exchange(mesh, kind: str, args: dict, seed: int) -> str:
    """This rank's SPMD consumer table (and flag) against consumer
    ``mesh.rank`` of the in-process function over every rank's table:
    '' when equal byte for byte."""
    from datafusion_distributed_tpu_torch.ops.sort import SortKey
    from datafusion_distributed_tpu_torch.parallel import exchange as ex

    t = mesh.size
    tables = task_tables(seed, t, args.get("dicts", "same"),
                         args.get("validity", "all"),
                         args.get("rows", "mixed"))
    mine = tables[mesh.rank]
    flag = got_flag = None
    if kind == "shuffle":
        ref, flag = ex.shuffle_exchange(tables, args["keys"], t,
                                        args["per_dest"])
        got, got_flag = ex.shuffle_exchange_spmd(mine, args["keys"], mesh,
                                                 args["per_dest"])
    elif kind == "range":
        keys = [SortKey(*k) for k in args["keys"]]
        per_dest = args.get("per_dest", CAP)
        ref, flag = ex.range_shuffle_exchange(tables, keys, t, per_dest,
                                              samples_per_task=SAMPLES)
        got, got_flag = ex.range_shuffle_exchange_spmd(
            mine, keys, mesh, per_dest, samples_per_task=SAMPLES)
    elif kind == "broadcast":
        ref = ex.broadcast_exchange(tables, t)
        got = ex.broadcast_exchange_spmd(mine, mesh)
    elif kind == "coalesce":
        ref = ex.coalesce_exchange(tables, t)
        got = ex.coalesce_exchange_spmd(mine, mesh)
    else:
        ref = ex.group_coalesce_exchange(tables, t, args["consumers"])
        got = ex.group_coalesce_exchange_spmd(mine, mesh, args["consumers"])
    diff = table_difference(ref[mesh.rank], got)
    if not diff and flag is not None and bool(flag) != bool(got_flag):
        diff = f"overflow flag {bool(got_flag)} != {bool(flag)}"
    return diff


# ---------------------------------------------------------------------------
# TPC-H and the mesh cases of tests/test_torch_tasks.py
# ---------------------------------------------------------------------------


def tpch_sql(q: str) -> str:
    return (TPCH_DIR / f"{q}.sql").read_text()


def tpch_session(device, sf: float = 0.01, seed: int = 7, **opts):
    """A session over TPC-H from the port's generator (equal to the JAX
    package's, tests/test_torch_tpch.py), with the options of
    tests/test_torch_tasks.py (`bytes_per_task = 1`)."""
    from datafusion_distributed_tpu_torch.data.tpchgen import register_tpch
    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    ctx = SessionContext(device=device)
    register_tpch(ctx, sf, seed)
    ctx.config.distributed_options["bytes_per_task"] = 1
    ctx.config.distributed_options.update(opts)
    return ctx


#: the mesh cases: name -> (tables, session options, SQL)
def mesh_case_tables(name: str) -> dict:
    if name == "union arm":
        rng = np.random.default_rng(5)
        return {"t": pa.table({
            "k": rng.integers(0, 10, 512).astype(np.int32),
            "v": rng.normal(size=512)})}
    if name == "range sort":
        rng = np.random.default_rng(5)
        n = 12000
        return {"t": pa.table({
            "k": rng.integers(-500, 500, n).astype("int64"),
            "s": rng.choice(["ant", "bee", "cat", "dog", "elk"], n),
            "v": rng.normal(size=n)})}
    if name == "overflow retry":
        rng = np.random.default_rng(4)
        n = 4000
        return {"f": pa.table({"k": np.where(rng.random(n) < 0.9, 7,
                                             rng.integers(0, 500, n)),
                               "v": rng.normal(size=n)}),
                "g": pa.table({"k": np.arange(500),
                               "w": rng.normal(size=500)})}
    rng = np.random.default_rng(13)  # the reduction tree
    return {"t": pa.table({"k": rng.integers(0, 9, 6000),
                           "v": rng.normal(size=6000)})}


MESH_CASES = {
    "union arm": ({}, "select k, sum(v) as sv from t group by k "
                      "union all select -1 as k, sum(v) as sv from t"),
    "range sort": ({"bytes_per_task": 1, "range_sort_threshold_rows": 64},
                   "select k, s from t where v > 0 order by s desc, k"),
    # a skew factor of 2 sizes the co-shuffled join's per-destination
    # capacity at half a producer's rows at 4 tasks: 90% of the probe rows
    # on one key overflow it once
    "overflow retry": ({"broadcast_joins": False,
                        "broadcast_threshold_rows": 0,
                        "shuffle_skew_factor": 2},
                       "select f.k, sum(v * w) s from f join g on f.k = g.k "
                       "group by f.k order by f.k"),
}


def reduction_tree(m: dict, table, num_tasks: int):
    """partial -> N:M coalesce (2 consumers) -> partial_reduce -> coalesce
    -> final, hand-placed (the planner only finalizes it); ``m`` holds one
    package's modules (phys, ex, dist, agg, sort, split)."""
    ph, ex = m["phys"], m["ex"]
    aggs = [m["agg"]("avg", "v", "av"), m["agg"]("count_star", None, "c")]
    scan = ph.MemoryScanExec(m["split"](table, num_tasks), table.schema())
    partial = ph.HashAggregateExec("partial", ["k"], aggs, scan, num_slots=64)
    narrow = ex.CoalesceExchangeExec(partial, num_tasks, num_consumers=2)
    reduce_ = ph.HashAggregateExec("partial_reduce", ["k"], aggs, narrow,
                                   num_slots=64)
    gather = ex.CoalesceExchangeExec(reduce_, num_tasks)
    final = ph.HashAggregateExec("final", ["k"], aggs, gather, num_slots=64)
    plan = ph.SortExec([m["sort"]("k")], final)
    return m["dist"].distribute_plan(plan,
                                     m["dist"].DistributedConfig(num_tasks))


def _result(table, df=None) -> dict:
    return {"names": table.names, "capacity": table.capacity,
            "rows": int(table.num_rows), "result": table.to_numpy(),
            "retries": df.last_retry_count if df is not None else None}


def run_mesh_case(mesh, name: str) -> dict:
    from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
    from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec
    from datafusion_distributed_tpu_torch.ops.sort import SortKey
    from datafusion_distributed_tpu_torch.parallel.exchange import (
        partition_table,
    )
    from datafusion_distributed_tpu_torch.plan import exchanges, physical
    from datafusion_distributed_tpu_torch.planner import distributed
    from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
        execute_on_mesh,
    )
    from datafusion_distributed_tpu_torch.sql import context
    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    tables = mesh_case_tables(name)
    if name == "reduction tree":
        mods = dict(phys=physical, ex=exchanges, dist=distributed,
                    agg=AggSpec, sort=SortKey, split=partition_table)
        plan = reduction_tree(mods, arrow_to_table(tables["t"],
                                                   device=mesh.device),
                              mesh.size)
        out = _result(execute_on_mesh(plan, mesh))
        out["plan"] = distributed.display_staged_plan(plan)
        return out
    opts, sql = MESH_CASES[name]
    ctx = SessionContext(device=mesh.device)
    for n, t in tables.items():
        ctx.register_arrow(n, t)
    ctx.config.distributed_options.update(opts)
    ran = []
    real = context.execute_on_mesh
    context.execute_on_mesh = lambda p, m, **kw: (
        ran.append(distributed.display_staged_plan(p)) or real(p, m, **kw))
    try:
        df = ctx.sql(sql)
        out = _result(df.collect_distributed_table(mesh=mesh), df)
    finally:
        context.execute_on_mesh = real
    out["plans_run"] = ran
    plan = df.distributed_plan(mesh.size, executing=True, mesh=mesh,
                               config=_executing_config(df, mesh.size))
    out["arms"] = len(plan.collect(
        lambda n: isinstance(n, exchanges.IsolatedArmExec)))
    out["range_shuffles"] = len(plan.collect(
        lambda n: isinstance(n, exchanges.RangeShuffleExchangeExec)))
    return out


def metrics_by_position(plan, per_task: dict) -> dict:
    """A MetricsStore's per-task metrics keyed by each node's position in
    ``plan``'s pre-order (node ids differ between packages and runs)."""
    pos = {n.node_id: i for i, n in enumerate(plan.collect(lambda _n: True))}
    return {task: {pos[nid]: dict(m) for nid, m in nodes.items()}
            for task, nodes in per_task.items()}


def run_metrics_case(mesh) -> dict:
    """The union-arm query's staged plan through `execute_on_mesh` with a
    MetricsStore: every task's per-node metrics, by node position (the
    isolated arm's metrics are 0 on the ranks it is not assigned to)."""
    from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
        execute_on_mesh,
    )
    from datafusion_distributed_tpu_torch.runtime.metrics import MetricsStore
    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    opts, sql = MESH_CASES["union arm"]
    ctx = SessionContext(device=mesh.device)
    for n, t in mesh_case_tables("union arm").items():
        ctx.register_arrow(n, t)
    df = ctx.sql(sql)
    plan = df.distributed_plan(mesh.size, _executing_config(df, mesh.size),
                               executing=True, mesh=mesh)
    store = MetricsStore()
    execute_on_mesh(plan, mesh, metrics_store=store)
    return metrics_by_position(plan, store.per_task)


def run_examples_case(mesh) -> dict:
    """The port's two SPMD examples (custom_partial_reduction_tree,
    mesh_spmd_query) at their own sizes over ``mesh``, and on rank 0 in
    process at the mesh's task count."""
    from datafusion_distributed_tpu_torch.examples import (
        custom_partial_reduction_tree as tree,
        mesh_spmd_query as query,
    )

    out = {}
    for name, mod in (("custom_partial_reduction_tree", tree),
                      ("mesh_spmd_query", query)):
        out[name] = {"spmd": mod.run(device=mesh.device, mesh=mesh)}
        if mesh.rank == 0:
            kw = {"coordinated": False} if mod is tree else {}
            out[name]["in_process"] = mod.run(device=mesh.device,
                                              num_tasks=mesh.size, **kw)
    return out


def _executing_config(df, num_tasks: int):
    import dataclasses

    return dataclasses.replace(df._seeded_distributed_config(num_tasks),
                               uniform_stage_tasks=True)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def run_case(mesh, case: dict, state: dict):
    """One case on this rank -> what it gave (pickled)."""
    kind = case["kind"]
    if kind == "exchanges":
        import torch.distributed as dist

        from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
            make_mesh,
        )

        out = {}
        pair = dist.new_group([0, 1], timeout=timedelta(
            seconds=case.get("timeout_s", 60)))
        for world, m in ((2, make_mesh(pair, device=mesh.device)
                          if mesh.rank < 2 else None), (4, mesh)):
            if m is None:
                continue
            for i, (name, (k, args)) in enumerate(EXCHANGE_CASES.items()):
                out[(name, world)] = check_exchange(m, k, args, seed=100 + i)
        return out
    if kind == "tpch":
        ctx = state.get("tpch")
        if ctx is None:
            ctx = state["tpch"] = tpch_session(mesh.device, case["sf"])
        out = {}
        for q in case["queries"]:
            df = ctx.sql(tpch_sql(q))
            t0 = time.perf_counter()
            got = df.collect_distributed_table(mesh=mesh)
            res = _result(got, df)
            res["s"] = time.perf_counter() - t0
            if case.get("in_process") and mesh.rank == 0:
                ref = df.collect_distributed_table(mesh.size)
                res["in_process"] = {
                    "difference": table_difference(ref, got),
                    "retries": df.last_retry_count}
            out[q] = res
        return out
    if kind == "mesh":
        return {name: run_mesh_case(mesh, name) for name in case["names"]}
    if kind == "metrics":
        return run_metrics_case(mesh)
    if kind == "examples":
        return run_examples_case(mesh)
    if kind == "different_sql":
        ctx = state.get("tpch") or tpch_session(mesh.device, case["sf"])
        q = "q1" if mesh.rank == 0 else "q6"
        t0 = time.perf_counter()
        try:
            ctx.sql(tpch_sql(q)).collect_distributed_table(mesh=mesh)
        except Exception as e:  # noqa: BLE001 - the error is the result
            return {"error": f"{type(e).__name__}: {e}",
                    "s": time.perf_counter() - t0}
        return {"error": None, "s": time.perf_counter() - t0}
    if kind == "make_mesh_without_cuda":
        from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
            make_mesh,
        )

        try:
            make_mesh()
        except RuntimeError as e:
            return {"error": str(e)}
        return {"error": None}
    raise ValueError(f"unknown case {kind}")


def main(argv) -> int:
    # a rank stands alone: any import of jax or of the JAX package raises
    sys.modules["jax"] = None
    sys.modules["datafusion_distributed_tpu"] = None
    import torch
    import torch.distributed as dist

    job = json.loads(Path(argv[0]).read_text())
    rank = int(argv[1])
    torch.set_num_threads(1)
    from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
        make_mesh,
    )

    dist.init_process_group(
        job.get("backend", "gloo"), init_method=f"file://{job['init']}",
        rank=rank, world_size=job["world"],
        timeout=timedelta(seconds=job.get("timeout_s", 60)))
    mesh = make_mesh(device=job["device"])
    results: dict = {}
    state: dict = {}
    try:
        for case in job["cases"]:
            try:
                results[case["name"]] = run_case(mesh, case, state)
            except Exception as e:  # noqa: BLE001 - recorded, then the next
                results[case["name"]] = {
                    "failed": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()}
    finally:
        out = Path(job["init"]).parent / f"rank{rank}.pkl"
        out.write_bytes(pickle.dumps(results))
        dist.destroy_process_group()
    return 0


def run_ranks(world: int, cases: list, workdir, device: str = "cpu",
              timeout_s: float = 300, env=None,
              collective_timeout_s: float = 60) -> list:
    """Start ``world`` ranks on ``cases`` (a gloo group initialised through
    a file in ``workdir``) and return each rank's results, in rank order.
    A rank that fails or outlives ``timeout_s`` fails the call; every rank
    is stopped before it returns."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    job = workdir / "job.json"
    job.write_text(json.dumps({
        "init": str(workdir / "pg"), "world": world, "device": device,
        "timeout_s": collective_timeout_s, "cases": cases}))
    env = dict(env if env is not None else os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    # run by path: a site package named `tests` may shadow this directory
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(job), str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, logs[r][-3000:])
              for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"SPMD ranks failed: {failed}")
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
