"""Window functions: the five single-node queries of tests/test_window.py
through the reference package and the port on the CPU (ints and row order
exact, floats at precision.test_rtol()), and the port's log-step segmented
scan against the reference's `lax.associative_scan` one on seeded random
resets, for each op over int and float inputs. The window queries W1-W3
that chip_smoke.py runs on the card (top-N per group, a running sum with
peers, a window over a join's aggregate) match the reference at TPC-H
SF 0.002 too."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import WINDOW_QUERIES
from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.ops import window as jwin
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch import precision as tprec
from datafusion_distributed_tpu_torch.data import tpchgen as ttpch
from datafusion_distributed_tpu_torch.ops import window as twin
from datafusion_distributed_tpu_torch.plan.window_exec import WindowExec
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_results_equal

torch.set_num_threads(1)

QUERIES = {
    "row_number_and_rank":
        "select grp, ord, row_number() over (partition by grp order by ord) rn,"
        " rank() over (partition by grp order by ord) rk,"
        " dense_rank() over (partition by grp order by ord) dr"
        " from s order by grp, ord, rn",
    "partition_aggregate_no_order":
        "select grp, v, sum(v) over (partition by grp) sv,"
        " avg(v) over (partition by grp) av,"
        " count(*) over (partition by grp) cnt"
        " from s order by grp, v",
    "running_sum_with_peers":
        "select grp, ord, sum(v) over (partition by grp order by ord) rs"
        " from s order by grp, ord",
    "window_over_aggregate":
        "select grp, ord, sum(v) sv,"
        " sum(sum(v)) over (partition by grp) total"
        " from s group by grp, ord order by grp, ord",
    "rank_filter_topn_per_group":
        "select grp, ord from ("
        "  select grp, ord, row_number() over"
        "   (partition by grp order by ord desc) rn from s"
        ") t where rn <= 2 order by grp, ord desc",
}


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(0)
    n = 400
    arrow = pa.table({
        "grp": rng.integers(0, 6, n),
        "ord": rng.integers(0, 50, n),
        "v": rng.normal(size=n).round(3),
    })
    j, t = JContext(), TContext(device="cpu")
    j.register_arrow("s", arrow)
    t.register_arrow("s", arrow)
    return j, t


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_window_query_matches_reference(sessions, name):
    j, t = sessions
    df = t.sql(QUERIES[name])
    assert df.physical_plan().collect(lambda n: isinstance(n, WindowExec))
    a = j.sql(QUERIES[name]).collect_table()
    b = df.collect_table()
    assert a.capacity == b.capacity and a.names == b.names
    assert_results_equal(a.to_numpy(), b.to_numpy(), name)


@pytest.fixture(scope="module")
def tpch():
    j, t = JContext(), TContext(device="cpu")
    for name, tbl in gen_tpch(0.002, 7).items():
        j.register_arrow(name, tbl)
    ttpch.register_tpch(t, 0.002, 7)
    return j, t


@pytest.mark.parametrize("name", sorted(WINDOW_QUERIES))
def test_tpch_window_query_matches_reference(tpch, name):
    j, t = tpch
    a = j.sql(WINDOW_QUERIES[name]).collect_table()
    b = t.sql(WINDOW_QUERIES[name]).collect_table()
    assert a.capacity == b.capacity and a.names == b.names
    assert int(b.num_rows) > 0
    assert_results_equal(a.to_numpy(), b.to_numpy(), name)


_ref_scan = jax.jit(jwin._segmented_scan, static_argnums=2)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("n", [1, 7, 1000, 4099])
def test_segmented_scan_matches_reference(op, kind, n):
    rng = np.random.default_rng(n * 7 + len(op) + len(kind))
    if kind == "int":
        vals = rng.integers(-1000, 1000, n).astype(np.int32)
    else:
        vals = rng.normal(size=n).astype(np.float32) * 100
    resets = rng.random(n) < 0.05
    resets[0] = True
    ref = np.asarray(_ref_scan(jnp.asarray(vals), jnp.asarray(resets), op))
    got = twin._segmented_scan(torch.from_numpy(vals),
                               torch.from_numpy(resets), op).numpy()
    assert got.dtype == ref.dtype
    if kind == "int" or op != "sum":
        np.testing.assert_array_equal(got, ref)  # exact
    else:
        scale = float(np.abs(vals).sum())
        np.testing.assert_allclose(got, ref, rtol=tprec.test_rtol(),
                                   atol=tprec.test_rtol() * scale)
    # the scan restarts at every reset and never reads across one
    starts = np.flatnonzero(resets)
    for s, e in zip(starts, list(starts[1:]) + [n]):
        seg = vals[s:e].astype(np.float64)
        acc = {"sum": np.cumsum, "min": np.minimum.accumulate,
               "max": np.maximum.accumulate}[op](seg)
        np.testing.assert_allclose(got[s:e], acc, rtol=1e-4, atol=1e-2)
