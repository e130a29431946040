"""ClickBench on the port: its numpy generator against the reference's
`gen_clickbench(20_000, 3)` column by column (decoded through the port's
Arrow path), then all 43 queries of benchmarks/queries/clickbench/ through
the reference package and the port on the CPU at those rows — ints,
strings and row order exact (LIMIT ties included: both packages sort
stably from the same order), floats at precision.test_rtol(). Subprocess
cases of a few queries each repeat all 43 in DFTPU_PRECISION=x64 mode (the
mode is fixed at import): int64 sums, int64 key lanes and the general
aggregate in place of the fused int32 one."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from datafusion_distributed_tpu.data.clickbenchgen import (
    gen_clickbench as j_gen,
)
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.data import clickbenchgen as tcb
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_results_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QDIR = os.path.join(REPO, "benchmarks", "queries", "clickbench")
ROWS, SEED = 20_000, 3
QUERIES = [f"q{i}" for i in range(43)]


@pytest.fixture(scope="module")
def sessions():
    arrow = j_gen(rows=ROWS, seed=SEED)
    j = JContext()
    j.register_arrow("hits", arrow)
    t = TContext(device="cpu")
    tcb.register_clickbench(t, ROWS, SEED)
    return j, t, arrow


def test_generator_matches_reference(sessions):
    _j, t, arrow = sessions
    ref = arrow_to_table(arrow, device="cpu")
    mine = t.catalog.tables["hits"]
    assert mine.names == ref.names
    assert mine.capacity == ref.capacity
    assert int(mine.num_rows) == int(ref.num_rows) == ROWS
    for name, a, b in zip(ref.names, mine.columns, ref.columns):
        assert a.dtype == b.dtype, name
        assert torch.equal(a.data, b.data), name
        assert torch.equal(a.validity, b.validity), name
        if b.dictionary is not None:
            assert list(a.dictionary.values) == list(b.dictionary.values), name


@pytest.mark.parametrize("q", QUERIES)
def test_clickbench_query_matches_reference(sessions, q):
    j, t, _arrow = sessions
    with open(os.path.join(QDIR, f"{q}.sql")) as f:
        sql = f.read()
    jdf, tdf = j.sql(sql), t.sql(sql)
    a, b = jdf.collect_table(), tdf.collect_table()
    assert a.names == b.names and a.capacity == b.capacity
    assert tdf.last_retry_count == jdf.last_retry_count
    assert_results_equal(a.to_numpy(), b.to_numpy(), q)


_X64_SCRIPT = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(1)
    from datafusion_distributed_tpu.data.clickbenchgen import gen_clickbench
    from datafusion_distributed_tpu.sql.context import SessionContext as J
    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.data import clickbenchgen
    from datafusion_distributed_tpu_torch.sql.context import SessionContext as T
    from tests.torch_port_helpers import assert_results_equal

    assert precision.MODE == "x64"
    j = J()
    j.register_arrow("hits", gen_clickbench(rows={rows}, seed={seed}))
    t = T(device="cpu")
    clickbenchgen.register_clickbench(t, {rows}, {seed})
    for q in {queries!r}:
        sql = open(f"{qdir}/{{q}}.sql").read()
        jdf, tdf = j.sql(sql), t.sql(sql)
        a, b = jdf.collect_table(), tdf.collect_table()
        assert a.names == b.names and a.capacity == b.capacity, q
        assert tdf.last_retry_count == jdf.last_retry_count, q
        assert_results_equal(a.to_numpy(), b.to_numpy(), q)
    print("X64-CLICKBENCH-OK")
""")

X64_GROUPS = [QUERIES[i:i + 6] for i in range(0, len(QUERIES), 6)]


@pytest.mark.parametrize("queries", X64_GROUPS,
                         ids=[f"{g[0]}-{g[-1]}" for g in X64_GROUPS])
def test_clickbench_matches_reference_in_x64_mode(queries):
    script = _X64_SCRIPT.format(rows=ROWS, seed=SEED, qdir=QDIR,
                                queries=tuple(queries))
    env = dict(os.environ, DFTPU_PRECISION="x64", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env=env, timeout=600, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "X64-CLICKBENCH-OK" in proc.stdout
