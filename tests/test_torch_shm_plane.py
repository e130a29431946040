"""The port's co-located data plane (runtime/shm_plane.py SegmentPool, the
TransferPartitions RPC of runtime/grpc_worker.py, adaptive per-column wire
compression in runtime/codec.py) against the reference's, case by case as
tests/test_shm_plane.py holds the reference. The plane a chunk rides is a
routing decision, never a semantic one.

- refcount lifecycle, torn segments, spill composition, hop
  classification, codec negotiation, the knobs: as the reference's;
- segments cross between the packages: one package publishes, the other
  opens and releases (the DFSP frame is shared);
- TPC-H q1/q3/q12/q18 at SF 0.002 over the port's localhost gRPC cluster
  (two CPU workers) byte-identical across `distributed.data_plane in
  {unary, stream, shm}` and equal to the reference's gRPC cluster (ints,
  strings and row order exact, floats at test_rtol()); no slice, task or
  segment left;
- the reference asserts that a plane toggle traces no new XLA program;
  the port compiles nothing, so here the plane knob must leave the staged
  plan's fingerprint and every shipped plan's fingerprint unchanged;
- a seeded chaos `kind="segment_lost"` schedule: the pull is retried over
  the wire (`dftpu_shm_fallbacks` counts it), the result identical.

Every test runs with the port's leak checker armed in strict mode, and
ends with no tracked resource live.
"""

import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.runtime import shm_plane as jshm
from datafusion_distributed_tpu.runtime import codec as jcodec
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import grpc_worker as jgrpc
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
from datafusion_distributed_tpu_torch.plan.fingerprint import plan_fingerprint
from datafusion_distributed_tpu_torch.runtime import chaos as tchaos
from datafusion_distributed_tpu_torch.runtime import leakcheck as tleak
from datafusion_distributed_tpu_torch.runtime import shm_plane, transport
from datafusion_distributed_tpu_torch.runtime.codec import (
    decode_table,
    decode_table_adaptive,
    encode_table,
    encode_table_adaptive,
)
from datafusion_distributed_tpu_torch.runtime.coordinator import (
    Coordinator,
    InMemoryCluster,
)
from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
    start_localhost_cluster,
)
from datafusion_distributed_tpu_torch.runtime.shm_plane import (
    SegmentError,
    SegmentPool,
)
from datafusion_distributed_tpu_torch.runtime.spill import SpillManager
from datafusion_distributed_tpu_torch.runtime.telemetry import DEFAULT_REGISTRY
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_results_equal, identical

torch.set_num_threads(1)

CHAOS_SEED = 20260803
FAST = {"task_retry_backoff_s": 0.001}
NT = 4
#: every RPC of the tests' clients carries this deadline
RPC_TIMEOUT_S = 60.0
PLANES = ("unary", "stream", "shm")

TPCH = {
    "q1": """
select l_returnflag, l_linestatus,
       sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty,
       avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc,
       count(*) as count_order
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    "q3": """
select l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
""",
    "q12": """
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT'
                  or o_orderpriority = '2-HIGH'
                then 1 else 0 end) as high_line_count,
       sum(case when o_orderpriority <> '1-URGENT'
                 and o_orderpriority <> '2-HIGH'
                then 1 else 0 end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey
  and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate
  and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1995-01-01'
group by l_shipmode
order by l_shipmode
""",
    "q18": """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (
    select l_orderkey from lineitem
    group by l_orderkey having sum(l_quantity) > 300
  )
  and c_custkey = o_custkey
  and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100
""",
}


@pytest.fixture(autouse=True)
def strict_leak_checker(monkeypatch):
    """The port's leak checker, armed strict for each test: a tracked
    resource still live at its query's end raises; none may be live when
    the test ends."""
    monkeypatch.setattr(tleak, "_installed", True)
    monkeypatch.setattr(tleak, "_strict", True)
    tleak.reset()
    yield
    try:
        tleak.assert_clean()
        assert not tleak.leaks(), tleak.leaks()
    finally:
        tleak.reset()


def _table(rows=4096, seed=0, strings=True):
    rng = np.random.default_rng(seed)
    cols = {
        "k": rng.integers(0, 64, rows),
        "v": rng.normal(size=rows),
    }
    if strings:
        cols["s"] = pa.array(rng.choice(["aa", "bb", "cc"], rows))
    return pa.table(cols)


def _port_table(**kw):
    return arrow_to_table(_table(**kw), device="cpu")


def _assert_tables_equal(a, b):
    na, nb = a.to_numpy(), b.to_numpy()
    assert list(na) == list(nb)
    for col in na:
        np.testing.assert_array_equal(np.asarray(na[col]),
                                      np.asarray(nb[col]), err_msg=col)


@pytest.fixture
def pool(tmp_path):
    p = SegmentPool(root=str(tmp_path))
    yield p
    p.shutdown()


@pytest.fixture(scope="module")
def arrow_tables():
    return gen_tpch(sf=0.002, seed=7)


def _ctx(cls, arrow_tables, **kw):
    ctx = cls(**kw)
    ctx.config.distributed_options["bytes_per_task"] = 1  # force fan-out
    for name, arrow in arrow_tables.items():
        ctx.register_arrow(name, arrow)
    return ctx


@pytest.fixture(scope="module")
def tpch_ctx(arrow_tables):
    return _ctx(TContext, arrow_tables, device="cpu")


@pytest.fixture(scope="module")
def grpc_cluster():
    cluster = start_localhost_cluster(2, device="cpu",
                                      rpc_timeout_s=RPC_TIMEOUT_S)
    yield cluster
    cluster.shutdown()


@pytest.fixture(scope="module")
def reference_results(arrow_tables, grpc_cluster):
    """The reference's coordinated results of the four queries over its own
    localhost gRPC cluster (two workers, bound to 127.0.0.1 here), on its
    default plane."""
    jctx = _ctx(JContext, arrow_tables)
    with pytest.MonkeyPatch.context() as mp:
        serve = jgrpc.serve_worker
        mp.setattr(jgrpc, "serve_worker",
                   lambda w, port=0, host=None: serve(w, port, "127.0.0.1"))
        cluster = jgrpc.start_localhost_cluster(2)
    try:
        out = {}
        for q, sql in TPCH.items():
            coord = jcoord.Coordinator(resolver=cluster, channels=cluster,
                                       config_options=dict(FAST))
            out[q] = jctx.sql(sql).collect_coordinated_table(
                coordinator=coord, num_tasks=NT).to_numpy()
        return out
    finally:
        cluster.shutdown()


def _run(ctx, sql, cluster, **opts):
    coord = Coordinator(resolver=cluster, channels=cluster,
                        config_options={**ctx.config.distributed_snapshot(),
                                        **FAST, **opts})
    out = ctx.sql(sql).collect_coordinated_table(coordinator=coord,
                                                 num_tasks=NT)
    return out.to_numpy(), coord


def _assert_no_leaks(cluster):
    for w in cluster.local_workers:
        assert not w.table_store.tables, (
            f"{w.url} leaked TableStore entries")
        assert w.table_store.nbytes() == 0, (
            f"{w.url} accounting leaked: {w.table_store.stats()}")
        assert len(w.registry) == 0, f"{w.url} leaked registry entries"
        assert w.segment_pool.live_segments() == 0, (
            f"{w.url} leaked shm segments: {w.segment_pool.stats()}")


def _saved(plane):
    return DEFAULT_REGISTRY.counter(
        "dftpu_wire_bytes_saved",
        "Wire bytes avoided (shm references, compression delta)",
        labels=("plane",),
    ).value(plane=plane)


# ---------------------------------------------------------------------------
# segment pool: refcount lifecycle, torn segments, spill composition
# ---------------------------------------------------------------------------


def test_segment_lifecycle_publish_open_release(pool):
    t = _port_table(rows=512)
    payload = encode_table(t)
    name, token = pool.publish(payload, capacity=int(t.capacity))
    assert pool.live_segments() == 1
    got, cap = pool.open_segment(name)
    assert bytes(got) == bytes(payload) and cap == int(t.capacity)
    _assert_tables_equal(t, decode_table(got, capacity=cap, device="cpu"))
    pool.release(name, token)
    assert pool.live_segments() == 0  # last release unlinks
    st = pool.stats()
    assert st["published"] == 1 and st["opened"] == 1
    assert st["published_bytes"] == len(payload)


def test_segment_refcounts_broadcast_fanout(pool):
    name, t0 = pool.publish(encode_table(_port_table(rows=64)))
    t1 = pool.acquire(name)
    t2 = pool.acquire(name)
    pool.release(name, t0)
    assert pool.live_segments() == 1  # readers still hold it
    pool.release(name, t1)
    assert pool.live_segments() == 1
    pool.release(name, t2)
    assert pool.live_segments() == 0
    pool.release(name, t2)  # double release: idempotent, no raise
    with pytest.raises(SegmentError):
        pool.acquire(name)  # acquire-after-last-release is gone


def test_torn_segment_raises_segment_error(pool):
    name, token = pool.publish(encode_table(_port_table(rows=128)))
    d = pool.descriptor()["dir"]
    seg = os.path.join(d, f"{name}.seg")
    # truncate mid-payload: the window a dying producer leaves behind
    with open(seg, "r+b") as f:
        f.truncate(10)
    with pytest.raises(SegmentError):
        pool.open_segment(name)
    assert pool.stats()["lost"] == 1
    with open(seg, "wb"):
        pass  # empty file: torn header
    with pytest.raises(SegmentError):
        shm_plane.open_segment_at(d, name)
    os.unlink(seg)
    with pytest.raises(SegmentError):  # vanished entirely
        shm_plane.open_segment_at(d, name)
    pool.release(name, token)  # release of a torn segment is safe
    assert pool.live_segments() == 0


def test_publish_file_serves_spill_without_decode(tmp_path, pool):
    """A SpillManager file is DFSP-framed exactly like a segment, so a
    spilled entry is served by hardlink — no decode/re-encode round trip —
    and refaults byte-identically."""
    t = _port_table(rows=1024, seed=3)
    sm = SpillManager(root=str(tmp_path))
    slot = sm.write_spill(t, nbytes=1)
    name, token = pool.publish_file(slot.path)
    payload, cap = pool.open_segment(name)
    assert cap == int(t.capacity)
    _assert_tables_equal(t, decode_table(payload, capacity=cap,
                                         device="cpu"))
    # pool root and spill root share tmp_path: served by hardlink
    assert pool.stats()["linked"] == 1
    pool.release(name, token)
    assert pool.live_segments() == 0
    sm.release(slot)
    assert sm.live_files() == 0  # the segment was a link, not a borrow


def test_publish_file_rejects_non_dfsp_file(tmp_path, pool):
    bogus = tmp_path / "not-a-segment.bin"
    bogus.write_bytes(b"parquet? arrow? neither.")
    with pytest.raises(SegmentError):
        pool.publish_file(str(bogus))
    assert pool.live_segments() == 0  # failed publish leaves nothing


def test_same_host_classification(tmp_path):
    pool = SegmentPool(root=str(tmp_path))
    desc = pool.descriptor()
    assert SegmentPool.same_host(desc)  # our own descriptor
    assert SegmentPool.same_host({"host": desc["host"]})  # host-only probe
    assert not SegmentPool.same_host(
        {"host": "some-other-host.invalid", "dir": desc["dir"]}
    )
    assert not SegmentPool.same_host(
        {"host": desc["host"], "dir": "/nonexistent/pool/dir"}
    )
    assert not SegmentPool.same_host(None)
    for d in (desc, {"host": desc["host"]}, None,
              {"host": "some-other-host.invalid"}):
        assert SegmentPool.same_host(d) == jshm.SegmentPool.same_host(d)
    pool.shutdown()


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_segments_cross_packages(tmp_path, direction):
    """One package publishes a segment, the other opens it, decodes the
    same rows and drops the last reference (which unlinks it): the DFSP
    frame and the token files are the same in both."""
    arrow = _table(rows=777, seed=11)
    if direction == "torch->jax":
        src = SegmentPool(root=str(tmp_path))
        t = arrow_to_table(arrow, device="cpu")
        payload = encode_table(t)
        opener = jshm
    else:
        from datafusion_distributed_tpu.io.parquet import (
            arrow_to_table as j_arrow,
        )

        src = jshm.SegmentPool(root=str(tmp_path))
        t = j_arrow(arrow)
        payload = jcodec.encode_table(t)
        opener = shm_plane
    name, token = src.publish(payload, capacity=int(t.capacity))
    d = src.descriptor()["dir"]
    extra = opener.acquire_at(d, name)  # a second reader's reference
    got, cap = opener.open_segment_at(d, name)
    assert bytes(got) == bytes(payload) and cap == int(t.capacity)
    mine = decode_table(got, capacity=cap, device="cpu").to_numpy()
    ref = jcodec.decode_table(got, capacity=cap).to_numpy()
    assert list(mine) == list(ref)
    for col in mine:
        np.testing.assert_array_equal(np.asarray(mine[col]),
                                      np.asarray(ref[col]), err_msg=col)
    opener.release_at(d, name, token)
    assert src.live_segments() == 1
    opener.release_at(d, name, extra)
    assert src.live_segments() == 0
    if direction == "torch->jax":
        # the publish token was dropped by the other package, whose
        # releases the port's leak checker cannot see (as with a consumer
        # in another process): tell it
        tleak.note_release("shm-segment", (name, token))
    src.shutdown()


# ---------------------------------------------------------------------------
# wire codec: negotiation + adaptive per-column encode
# ---------------------------------------------------------------------------


def test_codec_negotiation_intersects_both_ends():
    ours = transport.supported_codecs()
    assert "none" in ours  # the identity codec is always speakable
    want = transport.effective_codec("zstd")
    assert transport.negotiate_codec("zstd", ["none", "zstd"]) == want
    # peer without the requested codec: best shared fallback
    assert transport.negotiate_codec("zstd", ["none"]) == "none"
    # lz4 requested: downgrade chain lz4 -> zstd -> none, never naming a
    # codec either end cannot handle
    assert transport.negotiate_codec("lz4", ours) in ours
    # empty/unknown advertisement (old worker): this end's capability
    assert transport.negotiate_codec("zstd", None) == want


def test_get_info_advertises_wire_codecs():
    from datafusion_distributed_tpu.runtime.worker import Worker as JWorker
    from datafusion_distributed_tpu_torch.runtime.worker import Worker

    info = Worker(url="mem://shm-info", device="cpu").get_info()
    ref = JWorker(url="mem://shm-info").get_info()
    assert info["wire_codecs"] == transport.supported_codecs()
    assert info["wire_codecs"] == ref["wire_codecs"]
    assert info["shm"] == ref["shm"]
    assert info["shm"]["published"] == 0
    assert set(info) == set(ref)


def test_adaptive_encode_decode_byte_identical():
    t = _port_table(rows=2048, seed=5, strings=True)
    blobs, codecs = encode_table_adaptive(t, transport.supported_codecs())
    assert len(blobs) == len(t.names)
    assert set(codecs) <= set(blobs)
    back = decode_table_adaptive(blobs, len(blobs), device="cpu")
    base = decode_table(encode_table(t), device="cpu")  # single-blob plane
    _assert_tables_equal(back, base)
    # mixed codecs survive one frame (per-blob comp self-description)
    frame = transport.pack_frame({"cols": len(blobs)}, blobs,
                                 codec="zstd", codecs=codecs)
    header, out = transport.unpack_frame(frame)
    for n in blobs:
        assert bytes(out[n]) == bytes(blobs[n])
    assert transport.frame_saved_bytes(header) >= 0


# ---------------------------------------------------------------------------
# SQL config plumbing
# ---------------------------------------------------------------------------


def test_data_plane_knobs_validate_and_parse():
    from datafusion_distributed_tpu_torch.sql.context import SessionConfig

    cfg = SessionConfig()
    for v in ("auto", "unary", "stream", "shm"):
        cfg.set_option("distributed.data_plane", v)
        assert cfg.distributed_options["data_plane"] == v
    with pytest.raises(ValueError):
        cfg.set_option("distributed.data_plane", "carrier-pigeon")
    for v in ("auto", "off", "zstd", "lz4"):
        cfg.set_option("distributed.wire_compression", v)
        assert cfg.distributed_options["wire_compression"] == v
    with pytest.raises(ValueError):
        cfg.set_option("distributed.wire_compression", "gzip")


def test_set_statement_accepts_bare_word_planes(arrow_tables):
    ctx = _ctx(TContext, arrow_tables, device="cpu")
    ctx.sql("set distributed.data_plane = shm")
    assert ctx.config.distributed_options["data_plane"] == "shm"
    ctx.sql("set distributed.wire_compression = zstd")
    assert ctx.config.distributed_options["wire_compression"] == "zstd"


def test_plane_knobs_leave_the_staged_plan_fingerprint(arrow_tables):
    """The reference asserts that neither knob is trace-relevant config.
    The port compiles nothing; its counterpart: the staged plan of every
    query fingerprints the same under every plane and wire codec, since
    the knobs decide routing, never plan shape."""
    ctx = _ctx(TContext, arrow_tables, device="cpu")
    base = {q: plan_fingerprint(ctx.sql(sql).distributed_plan(NT))
            for q, sql in TPCH.items()}
    assert all(base.values())
    for key, values in (("data_plane", PLANES),
                        ("wire_compression", ("off", "zstd", "lz4"))):
        for v in values:
            ctx.sql(f"set distributed.{key} = {v}")
            got = {q: plan_fingerprint(ctx.sql(sql).distributed_plan(NT))
                   for q, sql in TPCH.items()}
            assert got == base, (key, v)
        ctx.sql(f"set distributed.{key} = auto")


# ---------------------------------------------------------------------------
# TPC-H byte identity across planes (gRPC cluster), against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qname", list(TPCH))
def test_tpch_byte_identical_across_planes(tpch_ctx, grpc_cluster,
                                           reference_results, qname):
    sql = TPCH[qname]
    base, _ = _run(tpch_ctx, sql, grpc_cluster, data_plane="unary")
    assert_results_equal(reference_results[qname], base,
                         f"{qname}: the port's gRPC cluster vs the "
                         "reference's")
    _assert_no_leaks(grpc_cluster)
    saved0 = _saved("shm")
    pub0 = sum(w.segment_pool.stats()["published"]
               for w in grpc_cluster.local_workers)
    for plane in ("stream", "shm"):
        out, _ = _run(tpch_ctx, sql, grpc_cluster, data_plane=plane)
        assert identical(out, base), f"{qname}[{plane}-vs-unary]"
        _assert_no_leaks(grpc_cluster)
    # the shm run rode the segment plane (co-located cluster): segments
    # were published and their payload bytes never hit the wire
    pub1 = sum(w.segment_pool.stats()["published"]
               for w in grpc_cluster.local_workers)
    assert pub1 > pub0, f"{qname}: shm plane never published a segment"
    assert _saved("shm") > saved0, f"{qname}: shm plane saved no wire bytes"


def test_plane_toggle_keeps_shipped_fingerprints(tpch_ctx):
    """Toggling `distributed.data_plane` on a warm query changes no plan:
    each plane ships the same plan fingerprints (`_fp`, the worker's
    integrity check) as its first run did, with planes toggled in
    between, and gives the same bytes. (The reference pins zero new XLA
    traces here; nothing is traced in the port.) In-process cluster, as
    the reference's test runs."""
    cluster = InMemoryCluster(2)
    shipped: list = []
    for w in cluster.workers.values():
        real = w.set_plan

        def set_plan(key, plan_obj, *a, _real=real, **kw):
            shipped.append(plan_obj.get("_fp"))
            return _real(key, plan_obj, *a, **kw)

        w.set_plan = set_plan
    runs, fps = {}, {}
    for plane in PLANES:
        shipped.clear()
        runs[plane], _ = _run(tpch_ctx, TPCH["q3"], cluster,
                              data_plane=plane)
        fps[plane] = sorted(shipped)
        assert all(fps[plane])
    for plane in PLANES:
        shipped.clear()
        out, _ = _run(tpch_ctx, TPCH["q3"], cluster, data_plane=plane)
        assert identical(out, runs[plane]), f"q3[{plane}-warm]"
        assert sorted(shipped) == fps[plane], (
            f"data_plane={plane} toggle changed a shipped plan")
    assert identical(runs["stream"], runs["unary"])
    assert identical(runs["shm"], runs["unary"])


def test_wire_compression_modes_result_invariant(tpch_ctx, grpc_cluster):
    base, _ = _run(tpch_ctx, TPCH["q3"], grpc_cluster, data_plane="unary")
    for mode in ("off", "zstd", "lz4"):
        out, _ = _run(tpch_ctx, TPCH["q3"], grpc_cluster,
                      data_plane="stream", wire_compression=mode)
        assert identical(out, base), f"q3[wire={mode}]"
        _assert_no_leaks(grpc_cluster)


# ---------------------------------------------------------------------------
# chaos: a torn segment is retried over the wire path
# ---------------------------------------------------------------------------


def test_chaos_segment_lost_degrades_to_wire(tpch_ctx):
    """Seeded `kind="segment_lost"` schedule: a segment vanishes between
    publish and open. The pull is retried — shm marked broken for the
    connection, the retry re-pulls over the wire — with results identical
    and zero leaked state on EVERY worker, including the one whose
    partial stream was abandoned."""
    cluster = start_localhost_cluster(2, device="cpu",
                                      rpc_timeout_s=RPC_TIMEOUT_S)
    try:
        base, _ = _run(tpch_ctx, TPCH["q3"], cluster, data_plane="unary")
        fallbacks = DEFAULT_REGISTRY.counter(
            "dftpu_shm_fallbacks",
            "Shm segments lost; pulls degraded to the wire path",
        )
        fb0 = fallbacks.value()
        chaos = tchaos.wrap_cluster(
            cluster, tchaos.one_crash_per_stage(CHAOS_SEED,
                                                kind="segment_lost"))
        out, coord = _run(tpch_ctx, TPCH["q3"], chaos, data_plane="shm")
        assert identical(out, base), "q3[segment_lost]"
        assert fallbacks.value() > fb0, (
            "segment_lost schedule never exercised the degradation path")
        assert coord.faults.get("task_retries") >= 1
        _assert_no_leaks(cluster)
    finally:
        cluster.shutdown()
