"""The port's SPMD tier (`runtime/mesh_executor.execute_on_mesh`,
`make_mesh`, the `*_spmd` exchanges of `parallel/exchange.py`,
`collect_distributed_table(mesh=)`) over real separate processes: gloo
ranks on the CPU, each a process of tests/torch_spmd_rank.py, in which
any import of jax or of the JAX package raises. Each group is initialised
through a file under the test's temporary directory and given a
timeout.

One start of four ranks runs every case below (the first xdist worker to
need it starts them; the others wait and read its results):

- (i) every SPMD exchange at world size 2 (a subgroup of ranks 0 and 1)
  and 4, on each rank byte for byte against consumer ``rank`` of its
  in-process counterpart over every rank's table: data, validity, padding
  rows, ``num_rows``, capacity, dictionary and overflow flag; ints,
  floats with NaN and -0.0, NULLs, booleans, strings whose dictionaries
  differ between ranks, validity on some ranks only, an overflowing
  shuffle, the N:M group coalesce and all-empty producers;
- (ii) the 22 TPC-H queries at SF 0.01 over 4 ranks: every rank's result
  against the JAX package's ``collect_distributed_table(4)`` on its
  host mesh (names, capacity, retries; ints, strings and row order exact,
  floats at test_rtol()), and rank 0's against the port's in-process
  ``collect_distributed_table(4)`` byte for byte; q11, q15 and q22 run
  their scalar subqueries through the mesh;
- (iii) the mesh cases of tests/test_torch_tasks.py at 4 ranks: union-arm
  isolation, the range sort, the pre-injected reduction tree and the
  shuffle-overflow retry;
- the port's two SPMD examples (tests/test_torch_examples.py holds them);
- (v) ranks given different SQL raise the fingerprint error together,
  well inside the group's timeout;
- (vi) ``make_mesh()`` without CUDA and without ``device="cpu"`` raises.

(iv) q1, q3, q9 and q18 run in DFTPU_PRECISION=x64 mode in a subprocess
that starts its own four ranks and holds them against the JAX package in
the same mode."""

import dataclasses
import fcntl
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.io.parquet import arrow_to_table as j_arrow
from datafusion_distributed_tpu.ops.aggregate import AggSpec as JAggSpec
from datafusion_distributed_tpu.ops.sort import SortKey as JSortKey
from datafusion_distributed_tpu.parallel.exchange import (
    partition_table as j_partition,
)
from datafusion_distributed_tpu.plan import exchanges as jex
from datafusion_distributed_tpu.plan import physical as jphys
from datafusion_distributed_tpu.planner import distributed as jdist
from datafusion_distributed_tpu.runtime import mesh_executor as jmesh
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.runtime.mesh_executor import make_mesh
from tests import torch_spmd_rank as ranks
from tests.torch_port_helpers import assert_results_equal

torch.set_num_threads(1)

REPO = str(ranks.REPO)
NT = 4
TPCH = [f"q{i}" for i in range(1, 23)]
X64_QUERIES = ("q1", "q3", "q9", "q18")
MESH_CASES = ("union arm", "range sort", "overflow retry", "reduction tree")
EXCHANGES = [(name, world) for world in (2, 4)
             for name in ranks.EXCHANGE_CASES]
CASES = [
    {"name": "exchanges", "kind": "exchanges"},
    {"name": "tpch", "kind": "tpch", "sf": 0.01, "queries": TPCH,
     "in_process": True},
    {"name": "mesh", "kind": "mesh", "names": list(MESH_CASES)},
    {"name": "metrics", "kind": "metrics"},
    {"name": "examples", "kind": "examples"},
    {"name": "different sql", "kind": "different_sql", "sf": 0.01},
    {"name": "no cuda", "kind": "make_mesh_without_cuda"},
]
#: the group's collective timeout; every start of ranks also has a wall
COLLECTIVE_TIMEOUT_S = 60
RANKS_TIMEOUT_S = 480


@pytest.fixture(scope="session")
def spmd(tmp_path_factory):
    """Every rank's results of CASES, [rank] -> {case name: result}. Under
    xdist the workers share one run: the first takes the lock and starts
    the ranks, the others wait for its pickle."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the session's directory, shared by workers
    done = base / "spmd_results.pkl"
    with open(base / "spmd.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                results = ranks.run_ranks(
                    NT, CASES, base / "spmd_ranks",
                    timeout_s=RANKS_TIMEOUT_S,
                    collective_timeout_s=COLLECTIVE_TIMEOUT_S)
                done.write_bytes(pickle.dumps(results))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return pickle.loads(done.read_bytes())


def _case(spmd, rank: int, name: str):
    got = spmd[rank][name]
    assert not (isinstance(got, dict) and "failed" in got), got.get(
        "traceback") if isinstance(got, dict) else got
    return got


# ---------------------------------------------------------------------------
# (i) the exchanges, byte for byte against the in-process functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,world", EXCHANGES)
def test_spmd_exchange_matches_in_process(spmd, name, world):
    for rank in range(world):
        got = _case(spmd, rank, "exchanges")
        assert got[(name, world)] == "", (name, world, rank,
                                          got[(name, world)])


# ---------------------------------------------------------------------------
# (ii) TPC-H over four ranks against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tpch():
    ctx = JContext()
    for name, table in gen_tpch(0.01, 7).items():
        ctx.register_arrow(name, table)
    ctx.config.distributed_options["bytes_per_task"] = 1
    return ctx


def _assert_ranks_equal(spmd, case: str, key: str, ref, ref_retries,
                        what: str) -> None:
    """Every rank's result of ``case[key]`` against the JAX package's
    table ``ref``: names, capacity, retries and values."""
    for rank in range(NT):
        got = _case(spmd, rank, case)[key]
        assert got["names"] == ref.names, (what, rank)
        assert got["capacity"] == ref.capacity, (what, rank)
        if ref_retries is not None:
            assert got["retries"] == ref_retries, (what, rank)
        assert_results_equal(ref.to_numpy(), got["result"],
                             f"{what}, rank {rank}")


@pytest.mark.parametrize("q", TPCH)
def test_spmd_tpch_matches_reference(spmd, jax_tpch, q):
    jdf = jax_tpch.sql(ranks.tpch_sql(q))
    ref = jdf.collect_distributed_table(NT)
    _assert_ranks_equal(spmd, "tpch", q, ref, jdf.last_retry_count, q)
    inproc = _case(spmd, 0, "tpch")[q]["in_process"]
    assert inproc["difference"] == "", (q, inproc)
    assert inproc["retries"] == jdf.last_retry_count, q


# ---------------------------------------------------------------------------
# (iii) the mesh cases of tests/test_torch_tasks.py
# ---------------------------------------------------------------------------


def _jax_mesh_case(name: str):
    """The JAX package's table (and its DataFrame, or None) for a mesh
    case over 4 tasks, and the staged plans it ran."""
    tables = ranks.mesh_case_tables(name)
    if name == "reduction tree":
        mods = dict(phys=jphys, ex=jex, dist=jdist, agg=JAggSpec,
                    sort=JSortKey, split=j_partition)
        plan = ranks.reduction_tree(mods, j_arrow(tables["t"]), NT)
        return (jmesh.execute_on_mesh(plan, jmesh.make_mesh(NT)), None,
                [jdist.display_staged_plan(plan)])
    opts, sql = ranks.MESH_CASES[name]
    ctx = JContext()
    for n, t in tables.items():
        ctx.register_arrow(n, t)
    ctx.config.distributed_options.update(opts)
    ran = []
    real = jmesh.execute_on_mesh

    def counted(p, m, **kw):
        ran.append(jdist.display_staged_plan(p))
        return real(p, m, **kw)

    jmesh.execute_on_mesh = counted
    try:
        df = ctx.sql(sql)
        out = df.collect_distributed_table(NT)
    finally:
        jmesh.execute_on_mesh = real
    return out, df, ran


@pytest.mark.parametrize("name", MESH_CASES)
def test_spmd_mesh_cases_match_reference(spmd, name):
    ref, jdf, jplans = _jax_mesh_case(name)
    _assert_ranks_equal(spmd, "mesh", name, ref,
                        jdf.last_retry_count if jdf is not None else None,
                        name)
    got = _case(spmd, 0, "mesh")[name]
    if name == "reduction tree":
        assert got["plan"] == jplans[0]
        return
    assert got["plans_run"] == jplans, name
    if name == "union arm":
        assert got["arms"] == 1
    elif name == "range sort":
        assert got["range_shuffles"] == 1
    else:  # one overflow, one widened re-plan, on every rank
        for rank in range(NT):
            run = _case(spmd, rank, "mesh")[name]
            assert run["retries"] == 1 and len(run["plans_run"]) == 2
            assert run["plans_run"][0] != run["plans_run"][1]


def test_spmd_metrics_match_reference(spmd):
    """`execute_on_mesh(metrics_store=)` on the union-arm query: every
    rank inserts every task's per-node metrics, equal by node position to
    the JAX package's mesh (0 for the isolated arm's nodes on the ranks
    it is not assigned to)."""
    from datafusion_distributed_tpu.runtime.metrics import MetricsStore

    opts, sql = ranks.MESH_CASES["union arm"]
    ctx = JContext()
    for n, t in ranks.mesh_case_tables("union arm").items():
        ctx.register_arrow(n, t)
    df = ctx.sql(sql)
    mesh = jmesh.make_mesh(NT)
    plan = df.distributed_plan(NT, dataclasses.replace(
        df._seeded_distributed_config(NT), uniform_stage_tasks=True),
        mesh=mesh)
    store = MetricsStore()
    jmesh.execute_on_mesh(plan, mesh, metrics_store=store)
    ref = ranks.metrics_by_position(plan, store.per_task)
    assert sorted(ref) == [f"task{t}" for t in range(NT)]
    for rank in range(NT):
        assert _case(spmd, rank, "metrics") == ref, rank


# ---------------------------------------------------------------------------
# (iv) x64 mode, (v) lockstep, (vi) make_mesh
# ---------------------------------------------------------------------------

_X64_SCRIPT = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(1)
    from datafusion_distributed_tpu.data.tpchgen import gen_tpch
    from datafusion_distributed_tpu.sql.context import SessionContext
    from datafusion_distributed_tpu_torch import precision
    from tests import torch_spmd_rank as ranks
    from tests.torch_port_helpers import assert_results_equal
    assert precision.MODE == "x64"
    queries = {queries!r}
    res = ranks.run_ranks(4, [{{"name": "tpch", "kind": "tpch",
                                "sf": 0.01, "queries": queries}}],
                          {workdir!r}, timeout_s=400)
    ctx = SessionContext()
    for name, table in gen_tpch(0.01, 7).items():
        ctx.register_arrow(name, table)
    ctx.config.distributed_options["bytes_per_task"] = 1
    for q in queries:
        df = ctx.sql(ranks.tpch_sql(q))
        ref = df.collect_distributed_table(4)
        for rank, r in enumerate(res):
            got = r["tpch"]
            assert "failed" not in got, got.get("traceback")
            got = got[q]
            assert got["names"] == ref.names, (q, rank)
            assert got["capacity"] == ref.capacity, (q, rank)
            assert got["retries"] == df.last_retry_count, (q, rank)
            assert_results_equal(ref.to_numpy(), got["result"],
                                 f"{{q}} rank {{rank}}")
    print("X64-SPMD-OK")
""")


def test_spmd_tpch_in_x64_mode_matches_reference(tmp_path):
    script = _X64_SCRIPT.format(queries=X64_QUERIES,
                                workdir=str(tmp_path / "ranks"))
    env = dict(os.environ, DFTPU_PRECISION="x64", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "X64-SPMD-OK" in proc.stdout


def test_ranks_given_different_sql_raise_together(spmd):
    """Rank 0 runs q1 and the others q6: every rank raises the
    fingerprint error at the run's first collective, not at the group's
    timeout."""
    for rank in range(NT):
        got = _case(spmd, rank, "different sql")
        assert got["error"] is not None, rank
        assert "LockstepError" in got["error"], got
        assert "different plans" in got["error"], got
        assert got["s"] < COLLECTIVE_TIMEOUT_S / 2, got


def test_make_mesh_never_picks_the_cpu(spmd):
    """``make_mesh()`` on a rank without CUDA raises unless the caller
    passes ``device="cpu"`` (the ranks here did); without a process group
    it raises too."""
    for rank in range(NT):
        got = _case(spmd, rank, "no cuda")
        assert got["error"] is not None and "no CUDA" in got["error"], got
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="initialised process group"):
            make_mesh(device="cpu")


def test_spmd_plan_cache_keys_on_the_mesh():
    """The staged plan a mesh runs is cached apart from the in-process
    one (as the JAX package keys it): `distributed_plan(mesh=)` keys on
    whether there is a mesh, not on its object."""
    ctx = ranks.tpch_session("cpu", sf=0.002)
    df = ctx.sql(ranks.tpch_sql("q3"))
    cfg = dataclasses.replace(df._seeded_distributed_config(NT),
                              uniform_stage_tasks=True)
    a = df.distributed_plan(NT, cfg, executing=True)
    b = df.distributed_plan(NT, cfg, executing=True, mesh=_FakeMesh(NT))
    c = df.distributed_plan(NT, cfg, executing=True, mesh=_FakeMesh(NT))
    assert a is not b and b is c


@dataclasses.dataclass(frozen=True)
class _FakeMesh:
    size: int
