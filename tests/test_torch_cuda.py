"""On the card: each CUDA hash-table kernel equals its plain PyTorch version
bit for bit (chip_smoke.py repeats this at main-path shapes), and the
exchange data plane (parallel/exchange.py) gives every consumer task the
same table on the card as on the CPU, byte for byte. The coordinator's
regroup does too, a coordinated query copies no column data to the host,
and the kernels' launch counters stay exact under threads.

This file imports neither jax nor the JAX package, so it also runs where
they are absent, as on a machine with the card:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device every test skips."""

import numpy as np
import pytest
import torch

from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
from datafusion_distributed_tpu_torch.ops.hash import hash_columns

OPS = ("sum", "sum", "min", "max")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _slot0(keys, h):
    lanes = keys.shape[1]
    return (hash_columns([keys[:, i] for i in range(lanes)], [None] * lanes)
            & (h - 1)).to(torch.int32)


def _inputs(dev, n=1 << 16, h=1 << 14, lanes=2, ndv=5000, seed=0,
            dtype=np.int32, live=0.9):
    rng = np.random.default_rng(seed)
    if dtype == np.int64:  # values beyond int32: both halves of a lane vary
        vocab = rng.integers(-2**40, 2**40, (ndv, lanes))
    else:
        vocab = rng.integers(-1000, 1000, (ndv, lanes)).astype(dtype)
    keys = torch.from_numpy(vocab[rng.integers(0, ndv, n)]).to(dev)
    slot0 = _slot0(keys, h)
    live = torch.from_numpy(rng.random(n) < live).to(dev)
    return rng, keys, slot0, live, h


# name -> (_inputs arguments, max_rounds, expected overflow)
BUILD_CASES = {
    "uniform": ({}, hk.MAX_ROUNDS, False),
    "overflow": ({"ndv": 40000}, hk.MAX_ROUNDS, True),  # 40000 > 2^14 slots
    "single key": ({"ndv": 1}, hk.MAX_ROUNDS, False),
    "n below a warp": ({"n": 20, "h": 64}, hk.MAX_ROUNDS, False),
    "ragged n": ({"n": 70001}, hk.MAX_ROUNDS, False),
    "max_rounds=2": ({}, 2, True),
    "int64 lanes": ({"dtype": np.int64}, hk.MAX_ROUNDS, False),
    "one slot": ({"h": 1, "ndv": 1, "n": 300}, hk.MAX_ROUNDS, False),
    "two slots, three keys": ({"h": 2, "ndv": 3, "n": 300}, 8, True),
    "long chains": ({"h": 1 << 12, "ndv": 3500}, hk.MAX_ROUNDS, False),
    "no live row": ({"live": 0.0}, hk.MAX_ROUNDS, False),  # 0 rounds
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_group_build_matches_plain(dev, case):
    kwargs, max_rounds, over = BUILD_CASES[case]
    _rng, keys, slot0, live, h = _inputs(dev, **kwargs)
    hk.reset_launch_counts()
    got = hk.build_group_ids(keys, slot0, live, h, max_rounds)
    assert hk.LAUNCHES["build_group_ids"] == 1
    lanes = keys.shape[1] * keys.element_size() // 4  # int64 -> (lo, hi)
    assert hk.BUILD_SHAPES == {(keys.shape[0], lanes, h): 1}
    ref = hk.build_group_ids_plain(keys, slot0, live, h, max_rounds)
    for a, b in zip(got[:4], ref[:4]):
        assert torch.equal(a, b)
    assert got[4].device.type == "cuda" and got[4].shape == ()
    assert int(got[4]) == int(ref[4])
    assert bool(got[3]) == over
    if bool(got[3]):
        assert int(got[4]) == max_rounds
    assert hk.round_stats() == {"builds": 1, "total": int(got[4]),
                                "max": int(got[4])}


# name -> (_inputs arguments, max_rounds, value generator)
AGG_CASES = {
    "uniform": ({}, hk.MAX_ROUNDS, "full range"),
    "single key": ({"ndv": 1}, hk.MAX_ROUNDS, "full range"),
    "n below a warp": ({"n": 20, "h": 64}, hk.MAX_ROUNDS, "full range"),
    "ragged n": ({"n": 70001}, hk.MAX_ROUNDS, "full range"),
    "max_rounds=2": ({}, 2, "full range"),
    "one slot": ({"h": 1, "ndv": 1, "n": 300}, hk.MAX_ROUNDS, "full range"),
    "two slots, three keys": ({"h": 2, "ndv": 3, "n": 300}, 8, "full range"),
    "wrapping sums": ({"ndv": 50}, hk.MAX_ROUNDS, "near int32 max"),
    "no live row": ({"live": 0.0}, hk.MAX_ROUNDS, "full range"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(AGG_CASES))
def test_group_aggregate_matches_plain(dev, case):
    kwargs, max_rounds, values = AGG_CASES[case]
    rng, keys, slot0, live, h = _inputs(dev, **kwargs)
    n = keys.shape[0]
    if values == "near int32 max":  # every group's sums wrap mod 2^32
        vals_np = rng.integers(2**31 - 1000, 2**31 - 1, (n, 4))
    else:
        vals_np = rng.integers(-2**31, 2**31 - 1, (n, 4))
    vals = torch.from_numpy(vals_np.astype(np.int32)).to(dev)
    hk.reset_launch_counts()
    got = hk.group_aggregate(keys, slot0, live, vals, h, OPS, max_rounds)
    assert hk.LAUNCHES["group_aggregate"] == 1
    ref = hk.group_aggregate_plain(keys, slot0, live, vals, h, OPS,
                                   max_rounds)
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a, b)
    assert int(got[5]) == int(ref[5])
    assert hk.round_stats()["builds"] == 1


def _probe_inputs(dev, slots=(1 << 16,), n=1 << 16, lanes=2, seed=0,
                  dtype=np.int32, active=0.9, full=False):
    """n probe rows against tables of ``slots`` slots each: built from a
    third as many keys, or with ``full`` holding a key in every slot and
    each row starting a few slots before its key's. Keys of the tables are
    even; half the rows carry a key of the table, half an odd one.
    -> multiway_probe's arguments."""
    rng = np.random.default_rng(seed)
    tparts, uparts, kparts, sparts = [], [], [], []
    for h in slots:
        if dtype == np.int64:  # both halves of a lane vary
            vocab = rng.integers(-2**40, 2**40, (h, lanes)) * 2
        else:
            vocab = rng.integers(-10**6, 10**6, (h, lanes)).astype(dtype) * 2
        ndv = h if full else max(1, h // 3)
        pick = rng.integers(0, ndv, n)
        present = vocab[pick]
        pk = torch.from_numpy(np.where(rng.random((n, 1)) < 0.5, present,
                                       present + 1)).to(dev)
        if full:
            tk = torch.from_numpy(vocab).to(dev)
            used = torch.ones(h, dtype=torch.bool, device=dev)
            s0 = torch.from_numpy(
                ((pick - rng.integers(0, 8, n)) % h).astype(np.int32)).to(dev)
        else:
            bkeys = torch.from_numpy(vocab[:ndv]).to(dev)
            _g, tk, used, over, _r = hk.build_group_ids(
                bkeys, _slot0(bkeys, h),
                torch.ones(ndv, dtype=torch.bool, device=dev), h)
            assert not bool(over)
            s0 = _slot0(pk, h)
        tparts.append(tk)
        uparts.append(used)
        kparts.append(pk)
        sparts.append(s0)
    active_t = torch.from_numpy(rng.random((n, len(slots))) < active).to(dev)
    return (torch.stack(kparts, dim=1), torch.stack(sparts, dim=1), active_t,
            torch.cat(tparts), torch.cat(uparts), tuple(slots))


# name -> (_probe_inputs arguments, max_rounds, the launches' routes,
# overflow expected). L2 tables are larger than a block's shared memory
# (227 KB on the H100), shared-memory tables smaller. In a full table an
# absent key walks until max_rounds.
PROBE_CASES = {
    "K=1 l2": ({}, hk.MAX_ROUNDS, ["l2"], False),
    "K=1 smem": ({"slots": (1 << 12,)}, hk.MAX_ROUNDS, ["smem"], False),
    "K=3 l2": ({"slots": (1 << 16, 1 << 14, 1 << 12)}, hk.MAX_ROUNDS,
               ["l2"], False),
    "K=3 smem": ({"slots": (1 << 10, 1 << 9, 1 << 8)}, hk.MAX_ROUNDS,
                 ["smem"], False),
    "int64 lanes l2": ({"dtype": np.int64}, hk.MAX_ROUNDS, ["l2"], False),
    "int64 lanes smem": ({"dtype": np.int64, "slots": (1 << 10,)},
                         hk.MAX_ROUNDS, ["smem"], False),
    "n=0": ({"n": 0}, hk.MAX_ROUNDS, ["l2"], False),
    "n=20": ({"n": 20, "slots": (64,)}, hk.MAX_ROUNDS, ["smem"], False),
    "ragged n l2": ({"n": 70001}, hk.MAX_ROUNDS, ["l2"], False),
    "ragged n smem": ({"n": 70001, "slots": (1 << 11,)}, hk.MAX_ROUNDS,
                      ["smem"], False),
    "no active row": ({"active": 0.0}, hk.MAX_ROUNDS, ["l2"], False),
    "one slot": ({"slots": (1,), "n": 300}, hk.MAX_ROUNDS, ["smem"], True),
    "full table l2, 512 rounds": ({"lanes": 1, "full": True}, hk.MAX_ROUNDS,
                                  ["l2"], True),
    "full table l2, 3 rounds": ({"lanes": 1, "full": True}, 3, ["l2"], True),
    "full table smem, 512 rounds": ({"slots": (1 << 12,), "lanes": 1,
                                     "full": True}, hk.MAX_ROUNDS, ["smem"],
                                    True),
    "full table smem, 3 rounds": ({"slots": (1 << 12,), "lanes": 1,
                                   "full": True}, 3, ["smem"], True),
    # more tables than one launch's descriptors hold: one launch per group
    "K=10": ({"slots": (1 << 13,) * 8 + (1 << 10,) * 2, "lanes": 1,
              "n": 5000}, hk.MAX_ROUNDS, ["l2", "smem"], False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("pack_used", [None, False, True])
@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_probe_matches_plain(dev, case, pack_used):
    kwargs, max_rounds, routes, over = PROBE_CASES[case]
    args = _probe_inputs(dev, **kwargs)
    keys, table_slots = args[0], args[5]
    lanes = keys.shape[2] * (2 if keys.dtype == torch.int64 else 1)
    launches = hk.probe_launches(table_slots, lanes, hk.smem_limit(dev))
    assert [launch.route for launch in launches] == routes
    hk.reset_launch_counts()
    # the L2 route's two records: key lanes and used flags apart, or packed
    # together; the wrapper (None) takes the one packs_records chooses
    if pack_used is None:
        got = hk.multiway_probe(*args, max_rounds)
    else:
        got = hk.probe_cuda(*args, max_rounds, pack_used)
    assert hk.LAUNCHES["multiway_probe"] == len(launches)
    assert sum(hk.PROBE_SHAPES.values()) == len(launches)
    ref = hk.multiway_probe_plain(*args, max_rounds)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bool(got[1].any()) == (over and keys.shape[0] > 0)
    if keys.shape[0] and kwargs.get("active", 0.9) > 0:
        assert bool((got[0] >= 0).any()) and bool((got[0] < 0).any())


# ---------------------------------------------------------------------------
# the exchange data plane (parallel/exchange.py): cuda against cpu
# ---------------------------------------------------------------------------


def _exchange_tables(device, num_tasks: int, seed: int, cap: int = 64):
    """Per-task tables with nulls, dictionary strings, floats (NaN, -0.0),
    booleans and int64, an empty and a full task; the same on any device."""
    from datafusion_distributed_tpu_torch.ops.table import (
        Column,
        Dictionary,
        Table,
    )
    from datafusion_distributed_tpu_torch.schema import DataType

    rng = np.random.default_rng(seed)
    words = Dictionary(np.array(["ant", "bee", "cat", "dog"], dtype=object))
    rows = [cap, 0] + [int(rng.integers(0, cap + 1))
                       for _ in range(num_tasks - 2)]
    out = []
    for n in rows[:num_tasks]:
        f = rng.normal(size=cap).astype(np.float32)
        f[rng.random(cap) < 0.1] = np.nan
        f[rng.random(cap) < 0.1] = -0.0
        cols = {
            "k": (rng.integers(-6, 6, cap).astype(np.int64),
                  rng.random(cap) > 0.15, DataType.INT64, None),
            "s": (rng.integers(0, 4, cap).astype(np.int32),
                  rng.random(cap) > 0.1, DataType.STRING, words),
            "f": (f, rng.random(cap) > 0.1, DataType.FLOAT32, None),
            "b": (rng.random(cap) < 0.5, None, DataType.BOOL, None),
        }
        out.append(Table(tuple(cols), tuple(
            Column(torch.from_numpy(d).to(device),
                   None if v is None else torch.from_numpy(v).to(device),
                   dt, dic)
            for d, v, dt, dic in cols.values()),
            torch.tensor(n, dtype=torch.int32, device=device)))
    return out


def _data_plane(name: str, tables, num_tasks: int):
    from datafusion_distributed_tpu_torch.ops.sort import SortKey
    from datafusion_distributed_tpu_torch.parallel import exchange as ex

    if name == "shuffle":
        return ex.shuffle_exchange(tables, ["k", "s"], num_tasks, 24)
    if name == "shuffle overflow":
        return ex.shuffle_exchange(tables, ["b"], num_tasks, 4)
    if name == "range shuffle":
        return ex.range_shuffle_exchange(
            tables, [SortKey("f", False, True), SortKey("k")], num_tasks, 64)
    if name == "broadcast":
        return ex.broadcast_exchange(tables, num_tasks), None
    if name == "group coalesce":
        return ex.group_coalesce_exchange(tables, num_tasks, 3), None
    raise ValueError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("num_tasks", [2, 8])
@pytest.mark.parametrize("name", ["shuffle", "shuffle overflow",
                                  "range shuffle", "broadcast",
                                  "group coalesce"])
def test_data_plane_cuda_equals_cpu(dev, name, num_tasks):
    """Every consumer task's table, and the overflow flag, equal on the
    card and on the CPU byte for byte."""
    seed = 11 * num_tasks + len(name)
    got, gflag = _data_plane(name, _exchange_tables(dev, num_tasks, seed),
                             num_tasks)
    ref, rflag = _data_plane(name, _exchange_tables("cpu", num_tasks, seed),
                             num_tasks)
    assert (gflag is None) == (rflag is None)
    if rflag is not None:
        assert bool(gflag) == bool(rflag)
    assert len(got) == len(ref) == num_tasks
    for a, b in zip(got, ref):
        assert a.names == b.names and a.capacity == b.capacity
        assert int(a.num_rows) == int(b.num_rows)
        for ca, cb in zip(a.columns, b.columns):
            assert ca.data.cpu().numpy().tobytes() == \
                cb.data.numpy().tobytes()
            assert (ca.validity is None) == (cb.validity is None)
            if cb.validity is not None:
                assert torch.equal(ca.validity.cpu(), cb.validity)


def _live_bytes(table) -> list:
    """Each column's live rows (and validity) as host bytes."""
    n = int(table.num_rows)
    out = []
    for c in table.columns:
        out.append(c.data[:n].cpu().numpy().tobytes())
        out.append(None if c.validity is None
                   else c.validity[:n].cpu().numpy().tobytes())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("zero_copy, exact",
                         [(True, False), (True, True), (False, False)])
def test_regroup_cuda_equals_cpu(dev, zero_copy, exact):
    """The coordinator's shuffle regroup on the card equals the CPU's byte
    for byte (live rows, row counts, capacities), on the view plane and
    on the copying plane."""
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        _shuffle_regroup,
    )

    got = _shuffle_regroup(_exchange_tables(dev, 4, 5), ["k", "s"], 3, 64,
                           zero_copy=zero_copy, exact=exact)
    ref = _shuffle_regroup(_exchange_tables("cpu", 4, 5), ["k", "s"], 3, 64,
                           zero_copy=zero_copy, exact=exact)
    copying = _shuffle_regroup(_exchange_tables("cpu", 4, 5), ["k", "s"], 3,
                               64, zero_copy=False)
    assert len(got) == len(ref) == 3
    for a, b, c in zip(got, ref, copying):
        assert a.device.type == "cuda"
        assert a.names == b.names and a.capacity == b.capacity
        assert int(a.num_rows) == int(b.num_rows) == int(c.num_rows)
        assert _live_bytes(a) == _live_bytes(b) == _live_bytes(c)


@pytest.mark.cuda
def test_coordinated_query_moves_no_column_data_to_the_host(dev):
    """A coordinated TPC-H query on the card copies no column data to the
    host on the in-process planes: with the static coordinator its
    device-to-host bytes stay far below the tables' bytes (row counts and
    flags only; the adaptive coordinator also copies its column sampler's
    bounded sample). Static and adaptive, it equals the CPU's result."""
    import json
    import tempfile
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    sql = (Path(__file__).resolve().parent.parent / "benchmarks" / "queries"
           / "tpch" / "q3.sql").read_text()
    gpu, cpu = SessionContext(device="cuda"), SessionContext(device="cpu")
    for ctx in (gpu, cpu):
        tpchgen.register_tpch(ctx, 0.01, 7)
    table_bytes = sum(
        c.data.nbytes for t in gpu.catalog.tables.values()
        for c in getattr(t, "columns", ()))
    for adaptive in (False, True):
        gpu.sql(sql).collect_coordinated_table(num_workers=4, num_tasks=4,
                                               adaptive=adaptive)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = gpu.sql(sql).collect_coordinated_table(
                num_workers=4, num_tasks=4, adaptive=adaptive)
            torch.cuda.synchronize()
        path = Path(tempfile.mkdtemp()) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        d2h = sum(int(e.get("args", {}).get("bytes", 0)) for e in events
                  if e.get("cat") == "gpu_memcpy"
                  and "DtoH" in e.get("name", ""))
        assert out.device.type == "cuda"
        assert adaptive or d2h < table_bytes / 20, (d2h, table_bytes)
        ref = cpu.sql(sql).collect_coordinated_table(
            num_workers=4, num_tasks=4, adaptive=adaptive)
        a, b = out.to_numpy(), ref.to_numpy()
        assert list(a) == list(b)
        for k in a:
            if a[k].dtype.kind == "f":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4)
            else:
                assert a[k].tolist() == b[k].tolist(), k


@pytest.mark.cuda
def test_launch_counts_exact_under_threads(dev):
    """Kernel 1 launched from 8 threads at once: the launch counter and
    the per-shape count are exact (the coordinator runs tasks on
    threads)."""
    import threading

    _rng, keys, slot0, live, h = _inputs(dev, n=4096, h=1 << 12)
    per_thread = 25
    hk.reset_launch_counts()
    start = threading.Barrier(8)

    def run():
        start.wait()
        for _ in range(per_thread):
            hk.build_group_ids(keys, slot0, live, h)

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert hk.LAUNCHES["build_group_ids"] == 8 * per_thread
    assert hk.BUILD_SHAPES == {(4096, 2, h): 8 * per_thread}
