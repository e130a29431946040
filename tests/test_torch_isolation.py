"""The port stands alone: it imports neither jax nor the reference package,
runs a TPC-H query, a window query, a prepared-statement binding, a
ClickBench query, a one-task staged plan with a fused multiway join, the
same plan over four tasks (runtime/mesh_executor.py, its exchanges) and
through the coordinator over four in-memory workers, static and adaptive
(runtime/coordinator.py and the runtime modules it loads), on the CPU when
asked to, and refuses to start without a CUDA device otherwise."""

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
    import importlib
    for m in ("errors", "leakcheck", "eventlog", "telemetry", "tracing",
              "metrics", "health", "codec", "worker", "streams", "peer",
              "adaptivity", "coordinator"):
        importlib.import_module("datafusion_distributed_tpu_torch.runtime."
                                + m)
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
