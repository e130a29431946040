"""The port's cluster console (console.py) against the reference's, on the
CPU: frames over an empty cluster, a cluster after a traced coordinated
query, a serving session, a worker whose `get_info` fails, a resolver that
fails outright and an idle SLO window, as tests/test_telemetry.py renders
them, then over the port's localhost gRPC workers.

Both consoles get the same inputs (a seeded numpy table, the same
queries) and the frames are compared with the clock, the console process's
rss and cpu, and the sparkline glyphs (which follow wall-clock rates)
masked."""

import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu import console as jconsole
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import serving as jserving
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch import console as tconsole
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import serving as tserving
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext

torch.set_num_threads(1)

SQL = "select k, sum(v) as s, count(*) as n from t group by k order by k"
SIDES = (("reference", jconsole, jcoord, jserving),
         ("port", tconsole, tcoord, tserving))


def _mask(frame: str) -> str:
    frame = re.sub(r"\d\d:\d\d:\d\d", "HH:MM:SS", frame)
    frame = re.sub(r"rss=\S+ cpu=\S+", "rss=R cpu=C", frame)
    frame = re.sub(r"p99 \d+ms", "p99 Pms", frame)
    frame = re.sub(r"[\u2581-\u2588]+", "~", frame)
    return re.sub(r"\d+\.\d\d/s", "R/s", frame)


def _assert_sections(frame: str, *headers: str) -> None:
    """Each section by the header at the start of its own line: the
    tracing line also names the data plane, and a section that raised
    renders as "<label> unavailable" instead."""
    text = re.sub(r"\x1b\[[0-9;]*m", "", frame)
    assert "unavailable" not in text, text
    for header in headers:
        assert re.search("^" + re.escape(header), text, re.M), (header, text)


def _data():
    rng = np.random.default_rng(0)
    return pa.table({"k": rng.integers(0, 8, 4096),
                     "v": rng.normal(size=4096)})


@pytest.fixture(scope="module")
def contexts():
    data = _data()
    out = {}
    for name, ctx in (("reference", JContext()),
                      ("port", TContext(device="cpu"))):
        ctx.register_arrow("t", data)
        out[name] = ctx
    return out


def _frames(fn) -> dict:
    return {name: _mask(fn(name, con, coord, srv))
            for name, con, coord, srv in SIDES}


def test_console_renders_empty_cluster():
    def frame(name, con, coord, srv):
        cluster = coord.InMemoryCluster(2)
        return con.Console(cluster, cluster, poll_s=0.01).render_frame()

    frames = _frames(frame)
    assert frames["port"] == frames["reference"]
    assert "workers (2 active" in frames["port"]
    assert "console rss=" in frames["port"]


def test_console_after_a_traced_query(contexts):
    def frame(name, con, coord, srv):
        ctx = contexts[name]
        ctx.config.distributed_options["tracing"] = "on"
        try:
            cluster = coord.InMemoryCluster(2)
            c = coord.Coordinator(
                resolver=cluster, channels=cluster,
                config_options=ctx.config.distributed_snapshot())
            ctx.sql(SQL).collect_coordinated_table(coordinator=c,
                                                   num_tasks=2)
            console = con.Console(cluster, cluster, poll_s=0.01,
                                  health=c.health, faults=c.faults)
            console.render_frame()
            return console.render_frame()
        finally:
            ctx.config.distributed_options.pop("tracing", None)

    frames = _frames(frame)
    assert frames["port"] == frames["reference"]
    _assert_sections(frames["port"], "workers (2 active",
                     "data plane  staged ", "tracing  ")


def test_console_over_a_serving_session(contexts):
    def frame(name, con, coord, srv):
        ctx = contexts[name]
        with srv.ServingSession(ctx, num_workers=2, num_tasks=2) as s:
            # one at a time: the staged peak and dedup counts of queries
            # in flight together follow the threads' timing
            for _ in range(3):
                s.submit(SQL).result_table(timeout=120)
            console = con.Console(s.cluster, s.cluster, poll_s=0.01,
                                  serving=s)
            assert console.history is s.history
            return console.render_frame()

    frames = _frames(frame)
    assert frames["port"] == frames["reference"]
    assert "serving" in frames["port"] and "3 done" in frames["port"]


def test_console_degrades_on_worker_get_info_error():
    def frame(name, con, coord, srv):
        cluster = coord.InMemoryCluster(2)
        bad = cluster.get_urls()[0]

        class Partial:
            def get_urls(self):
                return cluster.get_urls()

            def get_worker(self, u):
                if u == bad:
                    raise RuntimeError("get_info boom")
                return cluster.get_worker(u)

        return con.Console(Partial(), Partial(), poll_s=0.01).render_frame()

    frames = _frames(frame)
    assert frames["port"] == frames["reference"]
    assert "DOWN" in frames["port"] and "mem://worker-1" in frames["port"]


def test_console_degrades_per_section_never_aborts():
    class Boom:
        def get_urls(self):
            raise RuntimeError("resolver dead")

        def get_worker(self, u):
            raise RuntimeError("resolver dead")

    class BadServing:
        telemetry = None
        history = None

        def stats(self):
            raise RuntimeError("serving store exploded")

    def frame(name, con, coord, srv):
        console = con.Console(Boom(), Boom(), poll_s=0.01,
                              serving=BadServing())
        frames = [console.render_frame() for _ in range(2)]
        assert _mask(frames[0]) == _mask(frames[1])
        return frames[1]

    frames = _frames(frame)
    assert frames["port"] == frames["reference"]
    assert "workers unavailable" in frames["port"]
    assert "console rss=" in frames["port"]


def test_console_slo_line_idle_window_is_no_data_not_breach():
    class IdleServing:
        telemetry = None
        history = None

        def stats(self):
            return {"active": 0, "queued": 0, "admitted_total": 0,
                    "completed": {}, "budget_bytes": 0, "latency": {},
                    "slo": {"window_n": 0, "p99_ms": None,
                            "p99_target_ms": 250.0}}

    def frame(name, con, coord, srv):
        cluster = coord.InMemoryCluster(1)
        return con.Console(cluster, cluster, poll_s=0.01,
                           serving=IdleServing()).render_frame()

    frames = _frames(frame)
    assert frames["port"] == frames["reference"]
    assert "[no data]" in frames["port"] and "BREACH" not in frames["port"]


def test_console_run_writes_frames_and_main_needs_a_url(capsys):
    import io

    for _, con, coord, _srv in SIDES:
        cluster = coord.InMemoryCluster(1)
        out = io.StringIO()
        con.Console(cluster, cluster, poll_s=0.0, out=out).run(frames=2)
        assert out.getvalue().count("cluster console") == 2
        with pytest.raises(SystemExit) as e:
            con.main([])
        assert e.value.code == 2


def test_console_over_grpc_workers(contexts):
    """The port's console over its localhost gRPC workers after a query:
    the worker rows and the data-plane line come over the wire."""
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )

    ctx = contexts["port"]
    cluster = start_localhost_cluster(2, device="cpu", rpc_timeout_s=60)
    try:
        c = tcoord.Coordinator(resolver=cluster, channels=cluster,
                               config_options=ctx.config.distributed_snapshot())
        ctx.sql(SQL).collect_coordinated_table(coordinator=c, num_tasks=2)
        frame = tconsole.Console(cluster, cluster, poll_s=0.01,
                                 faults=c.faults).render_frame()
    finally:
        cluster.shutdown()
    _assert_sections(frame, "workers (2 active", "data plane  staged ")
    assert frame.count("grpc://127.0.0.1:") == 2
    assert "DOWN" not in frame
