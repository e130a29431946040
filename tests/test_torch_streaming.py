"""The port's streaming data plane (runtime/streams.py under the
coordinator's streamed coalesce) against the reference's, on the CPU: the
counterpart of tests/test_streaming.py.

Every case runs both packages on the same seeded arrow input and compares
what each observes:

- the LIMIT early exit (``select a, b from t limit 20000`` over 8 tasks of
  400,000 rows, ``stream_chunk_rows = 4096``): with the chunks forced into
  a fixed arrival order (tests/torch_port_helpers.py ``force_chunk_order``)
  the result's rows and capacity and the stream's rows, chunks, bytes and
  early-exit flag are equal in both packages, under all of task 0's chunks
  first (20,000 rows, capacity 20,000) and under round robin over the
  tasks (20,480 rows, capacity 20,480). On a free run the capacity follows
  the order in which chunks arrive, in both packages alike (ROADMAP §C.2),
  so a free run compares the rows and the bounds of the reference suite;
- the stream budget: ``peak_in_flight`` within the budget plus one chunk's
  slack in both packages, and equal results;
- the streamed coalesce of a global aggregate: equal results and every
  stream moved bytes in both.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_matches_reference,
    force_chunk_order,
)

torch.set_num_threads(1)

LIMIT = 20_000
CHUNK = 4096
TASKS = 8


def _ctx(P, rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ctx = P.ctx()
    ctx.register_arrow("t", pa.table({
        "a": rng.integers(0, 1_000_000, rows),
        "b": rng.normal(size=rows),
    }))
    return ctx


def _limit_run(P, workers: int, order=None) -> dict:
    """The reference suite's early-exit query in package ``P`` over
    ``workers`` in-memory workers, chunks in ``order`` (None: free)."""
    ctx = _ctx(P, 400_000)
    ctx.config.distributed_options["stream_chunk_rows"] = CHUNK
    ctx.config.distributed_options["size_tasks_to_data"] = False
    df = ctx.sql(f"select a, b from t limit {LIMIT}")
    rt = P("runtime.coordinator")
    cluster = rt.InMemoryCluster(workers)
    if order is not None:
        force_chunk_order(cluster, TASKS, order)
    coord = rt.Coordinator(resolver=cluster, channels=cluster,
                           config_options={"stream_chunk_rows": CHUNK})
    out = df.collect_coordinated_table(coordinator=coord, num_tasks=TASKS)
    stats = list(coord.stream_metrics.values())
    assert len(stats) == 1, stats
    s = stats[0]
    return {"num_rows": int(out.num_rows), "capacity": out.capacity,
            "rows": s["rows"], "chunks": s["chunks"],
            "bytes_streamed": s["bytes_streamed"],
            "early_exit": s["early_exit"]}


#: (order, workers) -> the stream each package must show
FORCED = {
    ("task0_first", 2): (LIMIT, 5),
    ("task0_first", TASKS): (LIMIT, 5),
    ("round_robin", TASKS): (5 * CHUNK, 5),
}


@pytest.mark.parametrize("order,workers", sorted(FORCED))
def test_limit_early_exit_forced_order(order, workers):
    got = {P: _limit_run(P, workers, order) for P in BOTH}
    assert got[PORT] == got[REF], got
    rows, chunks = FORCED[(order, workers)]
    s = got[PORT]
    assert s["num_rows"] == LIMIT and s["early_exit"] is True, s
    assert (s["rows"], s["chunks"]) == (rows, chunks), s
    # the coalesced result holds exactly the streamed rows, 8-row aligned
    assert s["capacity"] == -(-rows // 8) * 8, s


def test_limit_early_exit_free_run():
    for P in BOTH:
        s = _limit_run(P, 2)
        assert s["num_rows"] == LIMIT and s["early_exit"] is True, (P, s)
        # one in-flight chunk a task of slack, and far below the bulk
        # plane's 8 x 20,000 rows
        assert LIMIT <= s["rows"] < LIMIT + 9 * CHUNK, (P, s)
        assert s["rows"] < 0.5 * TASKS * LIMIT, (P, s)
        assert s["capacity"] == -(-s["rows"] // 8) * 8, (P, s)


def _budget_run(P):
    ctx = _ctx(P, 100_000, seed=1)
    ctx.config.distributed_options["bytes_per_task"] = 1
    df = ctx.sql("select a, b from t order by a limit 5000")
    rt = P("runtime.coordinator")
    cluster = rt.InMemoryCluster(2)
    coord = rt.Coordinator(resolver=cluster, channels=cluster, config_options={
        "worker_connection_buffer_budget_bytes": 256 * 1024,
        "stream_chunk_rows": 2048,
    })
    out = df._strip_quals(
        df.collect_coordinated_table(coordinator=coord, num_tasks=4))
    return out, list(coord.stream_metrics.values()), df


def test_stream_budget_bounds_in_flight_bytes():
    budget, chunk_rows = 256 * 1024, 2048
    got = {P: _budget_run(P) for P in BOTH}
    assert_matches_reference(got[REF][0], got[PORT][0], "budget")
    single = got[PORT][2]._strip_quals(got[PORT][2].collect_table())
    np.testing.assert_array_equal(got[PORT][0].to_numpy()["a"],
                                  single.to_numpy()["a"])
    for P in BOTH:
        stats = got[P][1]
        assert stats, P
        width = 16  # int64 + float64
        for s in stats:
            assert s["peak_in_flight"] <= budget + chunk_rows * width, (P, s)
    assert ([s["rows"] for s in got[PORT][1]]
            == [s["rows"] for s in got[REF][1]])


def test_streamed_coalesce_matches_bulk_results():
    got = {}
    for P in BOTH:
        ctx = _ctx(P, 50_000, seed=2)
        ctx.config.distributed_options["bytes_per_task"] = 1
        df = ctx.sql("select sum(b) s, count(*) c, min(a) m from t")
        rt = P("runtime.coordinator")
        cluster = rt.InMemoryCluster(2)
        coord = rt.Coordinator(resolver=cluster, channels=cluster)
        got[P] = (df._strip_quals(
            df.collect_coordinated_table(coordinator=coord, num_tasks=4)),
            list(coord.stream_metrics.values()))
        assert got[P][1] and all(s["bytes_streamed"] > 0
                                 for s in got[P][1]), P
    assert_matches_reference(got[REF][0], got[PORT][0], "coalesce")
    assert ([(s["rows"], s["chunks"], s["bytes_streamed"])
             for s in got[PORT][1]]
            == [(s["rows"], s["chunks"], s["bytes_streamed"])
                for s in got[REF][1]])
