"""All 22 TPC-H queries (benchmarks/queries/tpch/*.sql) at SF 0.002, seed 7,
through the reference package and through the port on the CPU: integers,
strings and row order exact, floats at precision.test_rtol() of the
column's scale, result capacities and overflow-retry counts equal. The
port's own numpy-only generator is checked against the reference's
pyarrow one first, so both engines read identical tables. Subprocess cases
of a few queries each repeat all 22 in DFTPU_PRECISION=x64 mode (the mode
is fixed at import). q22 and q13 run once more over `orders` without the
customers whose key is divisible by 3, so that q22 returns rows."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.data import tpchgen as ttpch
from datafusion_distributed_tpu_torch.sql.context import (
    SessionContext as TContext,
)
from tests.torch_port_helpers import assert_results_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QDIR = os.path.join(REPO, "benchmarks", "queries", "tpch")
SF, SEED = 0.002, 7
QUERIES = [f"q{i}" for i in range(1, 23)]


def _sql(q: str) -> str:
    with open(os.path.join(QDIR, f"{q}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def sessions():
    arrow = gen_tpch(SF, SEED)
    jctx = JContext()
    for name, t in arrow.items():
        jctx.register_arrow(name, t)
    tctx = TContext(device="cpu")
    host = ttpch.register_tpch(tctx, SF, SEED)
    return jctx, tctx, arrow, host


def test_generator_matches_reference(sessions):
    """Same seed, same values: every column, dictionary and capacity of the
    port's numpy generator equals the reference generator's tables decoded
    through the Arrow path."""
    jctx, tctx, arrow, _host = sessions
    ref = ttpch.tables_from_reference(arrow, device="cpu")
    for name, t in ref.items():
        mine = tctx.catalog.tables[name]
        assert mine.names == t.names, name
        assert mine.capacity == t.capacity == jctx.catalog.tables[name].capacity
        for cn, a, b in zip(t.names, mine.columns, t.columns):
            assert a.dtype == b.dtype, (name, cn)
            assert torch.equal(a.data, b.data), (name, cn)
            assert torch.equal(a.validity, b.validity), (name, cn)
            if b.dictionary is not None:
                assert list(a.dictionary.values) == list(b.dictionary.values)


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_query_matches_reference(sessions, q):
    jctx, tctx, _arrow, _host = sessions
    sql = _sql(q)
    jdf, tdf = jctx.sql(sql), tctx.sql(sql)
    a = jdf.collect_table()
    b = tdf.collect_table()
    assert b.capacity == a.capacity, q
    assert tdf.last_retry_count == jdf.last_retry_count, q
    assert a.names == b.names
    assert_results_equal(a.to_numpy(), b.to_numpy(), q)


_X64_SCRIPT = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(1)
    from datafusion_distributed_tpu.data.tpchgen import gen_tpch
    from datafusion_distributed_tpu.sql.context import SessionContext as J
    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.sql.context import SessionContext as T
    from tests.torch_port_helpers import assert_results_equal
    assert precision.MODE == "x64"
    j = J()
    for name, t in gen_tpch({sf}, {seed}).items():
        j.register_arrow(name, t)
    t = T(device="cpu")
    tpchgen.register_tpch(t, {sf}, {seed})
    for q in {queries!r}:
        sql = open(f"{qdir}/{{q}}.sql").read()
        a = j.sql(sql).collect_table()
        b = t.sql(sql).collect_table()
        assert a.capacity == b.capacity, q
        assert b.columns[0].data.dtype in (torch.int64, torch.float64, torch.int32), q
        assert_results_equal(a.to_numpy(), b.to_numpy(), q)
    print("X64-TPCH-OK")
""")


X64_GROUPS = [QUERIES[i:i + 4] for i in range(0, len(QUERIES), 4)]


@pytest.mark.parametrize("queries", X64_GROUPS,
                         ids=[f"{g[0]}-{g[-1]}" for g in X64_GROUPS])
def test_tpch_matches_reference_in_x64_mode(queries):
    script = _X64_SCRIPT.format(sf=SF, seed=SEED, qdir=QDIR,
                                queries=tuple(queries))
    env = dict(os.environ, DFTPU_PRECISION="x64", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env=env, timeout=600, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "X64-TPCH-OK" in proc.stdout


def _orders_without_a_third_of_customers(arrow: dict) -> dict:
    """The tables with `orders` cut to the rows whose o_custkey % 3 != 0, as
    TPC-H's own generator leaves a third of the customers without orders
    (the repo's generators give every customer one, so q22 finds none)."""
    orders = arrow["orders"]
    keep = np.asarray(orders.column("o_custkey")) % 3 != 0
    return dict(arrow, orders=orders.filter(pa.array(keep)))


def test_q22_and_q13_with_customers_without_orders():
    """q22 and q13 over customers of whom a third have no order: both
    packages return the same rows (7 and 22 at SF 0.01, seed 7), with the
    same capacities and overflow-retry counts."""
    arrow = _orders_without_a_third_of_customers(gen_tpch(0.01, SEED))
    assert arrow["orders"].num_rows == 9_980
    jctx, tctx = JContext(), TContext(device="cpu")
    for name, t in arrow.items():
        jctx.register_arrow(name, t)
        tctx.register_arrow(name, t)
    for q, rows in (("q22", 7), ("q13", 22)):
        jdf, tdf = jctx.sql(_sql(q)), tctx.sql(_sql(q))
        a, b = jdf.collect_table(), tdf.collect_table()
        assert int(b.num_rows) == int(a.num_rows) == rows, q
        assert b.capacity == a.capacity, q
        assert tdf.last_retry_count == jdf.last_retry_count, q
        assert a.names == b.names
        assert_results_equal(a.to_numpy(), b.to_numpy(), q)
