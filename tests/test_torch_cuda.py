"""On the card: each CUDA hash-table kernel equals its plain PyTorch version
bit for bit (chip_smoke.py repeats this at main-path shapes), and the
exchange data plane (parallel/exchange.py) gives every consumer task the
same table on the card as on the CPU, byte for byte. The coordinator's
regroup does too, a coordinated query copies no column data to the host,
and the kernels' launch counters stay exact under threads. A spilled
TableStore entry refaults onto the card byte for byte, and two clients of
one ServingSession get the sequential results. A hedged query with a
straggling worker and a query under membership churn give the plain
results, and the card's allocated bytes return to their baseline once
the cluster is released. A query over four localhost gRPC workers on the
card, on the default and the shm plane, equals the in-process run. The
table layer counts each copy it makes between card and host. Two gloo
ranks sharing the card run q3 as one SPMD program (`execute_on_mesh`),
byte-identical to the in-process staged run.

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
    assert hk.launches()["build_group_ids"] == 1
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
    assert hk.launches()["group_aggregate"] == 1
    ref = hk.group_aggregate_plain(keys, slot0, live, vals, h, OPS,
                                   max_rounds)
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a, b)
    assert int(got[5]) == int(ref[5])
    assert hk.round_stats()["builds"] == 1


FOLD_OPS = ("sum", "min", "max", "count")
FOLD_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
               torch.int64)
#: slots: one; a GROUP BY-less aggregate's 8; the most that fit the direct
#: strategy's shared memory in int64 (2^12) and int32 (2^13); the hot-slot
#: cache beyond
FOLD_SLOTS = (1, 8, 1 << 12, 1 << 13, 1 << 16)


def _fold_values(gen, dtype, n, dev):
    if dtype == torch.bool:
        return torch.rand(n, generator=gen, device=dev) < 0.5
    info = torch.iinfo(dtype)
    if dtype == torch.int64:  # both words vary; sums wrap
        hi = torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev)
        lo = torch.randint(0, 2**32, (n,), generator=gen, device=dev)
        v = hi * 2**32 + lo
    else:
        v = torch.randint(info.min, info.max + 1, (n,), generator=gen,
                          device=dev).to(dtype)
    v[:4] = torch.tensor([info.min, info.max, info.min, info.max],
                         dtype=dtype)
    return v


def _fold_case(dev, n, num_slots, live, seed, dtype=torch.int64, hot=0):
    """Group ids over ``num_slots`` (``hot`` distinct ids when given), a
    sixth of them the drop slot; the rows past the live prefix (``live``
    rows, None for no bound) in the drop slot too, as the GROUP BYs pass
    them. -> (gid int32, values, num_rows or None)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if hot:
        ids = torch.randint(0, num_slots, (hot,), generator=gen, device=dev)
        gid = ids[torch.randint(0, hot, (n,), generator=gen, device=dev)]
    else:
        gid = torch.randint(0, num_slots, (n,), generator=gen, device=dev)
    drop = torch.rand(n, generator=gen, device=dev) < 1 / 6
    gid = torch.where(drop, num_slots, gid).to(torch.int32)
    num_rows = None
    if live is not None:
        num_rows = torch.tensor(live, dtype=torch.int32, device=dev)
        gid[live:] = num_slots
    return gid, _fold_values(gen, dtype, n, dev), num_rows


def _check_fold(gid, vals, num_slots, op, num_rows):
    v = None if op == "count" else vals
    if op == "sum" and vals.dtype == torch.bool:
        v = vals.to(torch.int32)  # a COUNT's valid.to(int)
    got = hk.group_fold(gid, v, num_slots, op, num_rows)
    ref = hk.group_fold_plain(gid, v, num_slots, op, num_rows)
    assert got.dtype == ref.dtype and torch.equal(got, ref), op


@pytest.mark.cuda
@pytest.mark.parametrize("live", [None, 0, 1, 4321, 70001])
@pytest.mark.parametrize("num_slots", FOLD_SLOTS)
@pytest.mark.parametrize("dtype", FOLD_DTYPES)
def test_group_fold_matches_plain(dev, dtype, num_slots, live):
    """Kernel 4 equals its plain version bit for bit in every value dtype,
    op and strategy, over a ragged row count with live prefixes of none,
    0, 1, part of and all of the rows; int32 and int64 ids alike. The
    launch makes no host sync and counts under its shape."""
    n = 70001
    gid, vals, num_rows = _fold_case(dev, n, num_slots, live, num_slots,
                                     dtype)
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hk.group_fold(gid, vals if dtype != torch.bool else
                      vals.to(torch.int32), num_slots, "sum", num_rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert hk.launches()["group_fold"] == 1
    for op in FOLD_OPS:
        _check_fold(gid, vals, num_slots, op, num_rows)
        _check_fold(gid.long(), vals, num_slots, op, num_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 20, 33])
def test_group_fold_below_a_warp(dev, n):
    for num_slots in (8, 1 << 16):
        gid, vals, _ = _fold_case(dev, max(n, 4), num_slots, None, n)
        for op in FOLD_OPS:
            _check_fold(gid[:n], vals[:n], num_slots, op, None)


#: shapes that the ClickBench cell's GROUP BYs log (2^25 rows): a GROUP
#: BY-less aggregate (8 slots, every row live; q0, q2, q29); SearchPhrase's
#: 13 values in the planner's 256 slots, over every row and with 5% of the
#: rows live and the rest dead (q12, q21, q22); the hot-slot cache: 4
#: groups in 2^26 slots at 2/3 live (q28) and 1,320 groups in 2^18 slots at
#: 90% live (q39); near-distinct keys into 2^26 slots (q30-q32)
#: -> (slots, live rows or None, hot ids)
FOLD_MAIN_SHAPES = {
    "global 8": (8, None, 1),
    "13 hot": (256, None, 13),
    "13 hot, 5% live": (256, (1 << 25) // 20, 13),
    "4 hot in 2^26": (1 << 26, (1 << 25) * 2 // 3, 4),
    "1,320 in 2^18": (1 << 18, (1 << 25) * 9 // 10, 1320),
    "near-distinct": (1 << 26, None, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(FOLD_MAIN_SHAPES))
def test_group_fold_at_main_path_shapes(dev, shape):
    num_slots, live, hot = FOLD_MAIN_SHAPES[shape]
    gid, vals, num_rows = _fold_case(dev, 1 << 25, num_slots, live, 25,
                                     hot=hot)
    if shape == "global 8":  # every row in slot 0, the prefix bounds them
        gid.zero_()
        num_rows = torch.tensor(1 << 25, dtype=torch.int32, device=dev)
    for op in FOLD_OPS:
        _check_fold(gid, vals, num_slots, op, num_rows)


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
    assert hk.launches()["multiway_probe"] == len(launches)
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
    assert hk.launches()["build_group_ids"] == 8 * per_thread
    assert hk.BUILD_SHAPES == {(4096, 2, h): 8 * per_thread}


def _spill_table(dev, n=3000, cap=4096):
    """A card table whose buffers exercise a byte-exact spill round trip:
    int64 keys, float values with -0.0, NaN, inf and nulls, a dictionary
    column (one value unused), zeroed padding past ``n`` rows."""
    from datafusion_distributed_tpu_torch.ops.table import (
        Column,
        Dictionary,
        Table,
    )
    from datafusion_distributed_tpu_torch.schema import DataType

    rng = np.random.default_rng(5)
    v = rng.standard_normal(n)
    v[:3] = (-0.0, np.nan, np.inf)
    valid = rng.random(n) > 0.1
    v[~valid] = 0.0
    d = Dictionary(np.array(["a", "bb", "ccc", "zz"], dtype=object))
    cols = (
        Column.from_numpy(np.arange(n, dtype=np.int64) * 7 - 3,
                          DataType.INT64, cap, device=dev),
        Column.from_numpy(v, DataType.FLOAT64, cap, valid, device=dev),
        Column.from_numpy(rng.integers(0, 3, n).astype(np.int32),
                          DataType.STRING, cap, dictionary=d, device=dev),
    )
    return Table(("k", "v", "s"), cols,
                 torch.tensor(n, dtype=torch.int32, device=dev))


@pytest.mark.cuda
def test_spill_round_trip_on_the_card(dev):
    """A TableStore budget spills a card entry to a host file; `get`
    refaults it onto the same card, every buffer byte-identical (padding,
    -0.0, NaN, null masks, dictionary codes and objects), at its padded
    capacity; the spill file is gone once the entry is released."""
    from datafusion_distributed_tpu_torch.runtime.codec import TableStore

    store = TableStore()
    t1, t2 = _spill_table(dev), _spill_table(dev, n=100, cap=128)
    i1, i2 = store.put(t1), store.put(t2)
    store.set_budget(store.entry_nbytes(i2) + 1)  # spills t1, the coldest
    st = store.stats()
    assert st["spills"] == 1 and st["spill_files"] == 1, st
    back = store.get(i1)
    assert back is not t1 and back.device == t1.device
    assert back.capacity == t1.capacity
    assert int(back.num_rows) == int(t1.num_rows)
    for a, b in zip(back.columns, t1.columns):
        assert a.data.device == b.data.device
        assert a.data.cpu().numpy().tobytes() == b.data.cpu().numpy().tobytes()
        assert (a.validity is None) == (b.validity is None)
        if b.validity is not None:
            assert torch.equal(a.validity, b.validity)
        assert a.dictionary is b.dictionary
    store.remove([i1, i2])
    st = store.stats()
    assert st["entries"] == 0 and st["spill_files"] == 0, st


@pytest.mark.cuda
def test_two_client_serving_on_the_card(dev):
    """Two clients submit TPC-H q3 and q6 to one ServingSession on the
    card at once: each result stays on the card and is byte-identical to
    the same session's sequential coordinated run."""
    import threading
    from pathlib import Path

    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )
    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    qdir = Path(__file__).resolve().parent.parent / "benchmarks" / \
        "queries" / "tpch"
    sqls = {q: (qdir / f"{q}.sql").read_text() for q in ("q3", "q6")}
    ctx = SessionContext(device="cuda")
    tpchgen.register_tpch(ctx, 0.01, 7)
    base = {q: ctx.sql(s).collect_coordinated_table(
        num_workers=4, num_tasks=4).to_numpy() for q, s in sqls.items()}
    got: dict = {}
    cluster = InMemoryCluster(4)
    with ServingSession(ctx, cluster=cluster, num_tasks=4) as srv:
        def client(q):
            t = srv.submit(sqls[q]).result_table(timeout=300)
            assert t.device.type == "cuda"
            got[q] = t.to_numpy()

        threads = [threading.Thread(target=client, args=(q,))
                   for q in sqls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    for q in sqls:
        a, b = got[q], base[q]
        assert list(a) == list(b), q
        for k in a:
            if a[k].dtype == object:
                assert a[k].tolist() == b[k].tolist(), (q, k)
            else:
                assert a[k].tobytes() == b[k].tobytes(), (q, k)
    for w in cluster.workers.values():
        assert not w.table_store.tables and len(w.registry) == 0


def _resilience_session(dev):
    from pathlib import Path

    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    qdir = Path(__file__).resolve().parent.parent / "benchmarks" / \
        "queries" / "tpch"
    ctx = SessionContext(device="cuda")
    ctx.config.distributed_options["bytes_per_task"] = 1
    tpchgen.register_tpch(ctx, 0.01, 7)
    return ctx, lambda q: (qdir / f"{q}.sql").read_text()


def _coordinated_on(ctx, sql, cluster, **opts):
    """``sql`` over ``cluster`` -> (numpy result, fault counters,
    allocated bytes once the coordinator and the result are released)."""
    import gc

    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
    )

    coord = Coordinator(resolver=cluster, channels=cluster, config_options={
        **ctx.config.distributed_snapshot(), **opts})
    out = ctx.sql(sql).collect_coordinated_table(coordinator=coord,
                                                 num_tasks=4)
    assert out.device.type == "cuda"
    res, faults = out.to_numpy(), coord.faults.as_dict()
    for w in cluster.workers.values():
        assert not w.table_store.tables and len(w.registry) == 0
    del out, coord
    gc.collect()
    torch.cuda.synchronize()
    return res, faults, torch.cuda.memory_allocated()


def _assert_same(a, b, exact=True):
    assert list(a) == list(b)
    for k in a:
        if a[k].dtype == object:
            assert a[k].tolist() == b[k].tolist(), k
        elif exact or a[k].dtype.kind != "f":
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4)


@pytest.mark.cuda
def test_hedged_query_on_the_card(dev):
    """q6 with a straggling worker and hedging on: a hedge is issued and
    wins, the result equals single-node's, and the card's allocated bytes
    return to the plain run's baseline (the loser's slices released)."""
    from datafusion_distributed_tpu_torch.runtime import chaos
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )

    ctx, sql = _resilience_session(dev)
    single = ctx.sql(sql("q6")).collect_table().to_numpy()
    plain, _f, base = _coordinated_on(ctx, sql("q6"), InMemoryCluster(4))
    plan = chaos.FaultPlan(7, [chaos.FaultSpec(
        site="execute", kind="straggler", delay_s=2.0, rate=1.0,
        workers=["mem://worker-1"])])
    got, faults, after = _coordinated_on(
        ctx, sql("q6"), chaos.wrap_cluster(InMemoryCluster(4), plan),
        hedging=True, hedge_floor_s=0.25, hedge_budget=2)
    _assert_same(got, plain)
    _assert_same(got, single, exact=False)
    assert faults.get("hedges_won", 0) >= 1, faults
    assert after == base, (after, base)


@pytest.mark.cuda
def test_membership_churn_on_the_card(dev):
    """q3 under the reference's leave/join/drain schedule equals the
    no-churn run byte for byte, and the card's allocated bytes return to
    the no-churn run's baseline."""
    from datafusion_distributed_tpu_torch.runtime import chaos
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        DynamicCluster,
        InMemoryCluster,
    )

    ctx, sql = _resilience_session(dev)
    plain, _f, base = _coordinated_on(ctx, sql("q3"), InMemoryCluster(4))
    cluster = DynamicCluster(4)
    urls = cluster.get_urls()
    plan = chaos.FaultPlan(7, [], membership=[
        chaos.MembershipEvent("leave", urls[1], site="execute", nth_call=0),
        chaos.MembershipEvent("join", "mem://joiner-0", site="set_plan",
                              nth_call=4),
        chaos.MembershipEvent("drain", urls[2], site="execute", nth_call=3),
    ])
    got, _f, after = _coordinated_on(ctx, sql("q3"),
                                 chaos.wrap_cluster(cluster, plan),
                                 max_task_retries=6)
    _assert_same(got, plain)
    assert sorted(f["kind"] for f in plan.fired) == [
        "membership_drain", "membership_join", "membership_leave"]
    assert cluster.wait_drained(urls[2], timeout_s=10.0)
    assert after == base, (after, base)


@pytest.mark.cuda
def test_grpc_cluster_on_the_card(dev):
    """q3 over four localhost gRPC workers on the card, on the default
    plane and on the shm plane, equals the in-process run byte for byte;
    the workers decode onto the card; no shm segment is left; and the
    card's allocated bytes return to the in-process run's baseline once
    the cluster is shut down."""
    import gc

    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
        InMemoryCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )

    ctx, sql = _resilience_session(dev)
    plain, _f, base = _coordinated_on(ctx, sql("q3"), InMemoryCluster(4))
    cluster = start_localhost_cluster(4, rpc_timeout_s=300)
    try:
        assert all(w.device.type == "cuda" for w in cluster.local_workers)
        for plane in ("auto", "shm"):
            coord = Coordinator(resolver=cluster, channels=cluster,
                                config_options={
                                    **ctx.config.distributed_snapshot(),
                                    "data_plane": plane})
            out = ctx.sql(sql("q3")).collect_coordinated_table(
                coordinator=coord, num_tasks=4)
            assert out.device.type == "cuda"
            _assert_same(out.to_numpy(), plain)
            for w in cluster.local_workers:
                assert not w.table_store.tables and len(w.registry) == 0
                assert w.segment_pool.live_segments() == 0
            del out, coord
        published = sum(w.segment_pool.stats()["published"]
                        for w in cluster.local_workers)
        assert published > 0
    finally:
        cluster.shutdown()
    del cluster
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


@pytest.mark.cuda
def test_copy_counters_count_each_table_copy(dev):
    """The table layer counts a copy between card and host where it makes
    it: one packed upload of a table built from host arrays, one packed
    download of its host view, and one copy a tensor moved; the bytes are
    the buffers' (the packed ones with their 16-byte alignment)."""
    import pyarrow as pa

    from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
    from datafusion_distributed_tpu_torch.ops import table as tt

    arrow = pa.table({"k": np.arange(1000, dtype=np.int32),
                      "s": pa.array([None, "b"] * 500)})
    tt.reset_copy_stats()
    t = arrow_to_table(arrow, device=dev)
    up = tt.copy_stats()
    assert (up["h2d_copies"], up["d2h_copies"]) == (1, 0)
    cap = t.capacity
    # k (int32) and s (int32 codes), each with its validity (bool), each
    # aligned to 16 bytes
    assert up["h2d_bytes"] == 2 * (cap * 4 + -(-cap // 16) * 16)
    tt.reset_copy_stats()
    host = tt.host_view(t)
    down = tt.copy_stats()
    assert (down["d2h_copies"], down["d2h_bytes"]) == (1, up["h2d_bytes"])
    assert host.columns[0].data.device.type == "cpu"
    tt.reset_copy_stats()
    moved = tt.move(host, dev)
    again = tt.copy_stats()
    # k, s, their validities and the row count
    assert (again["h2d_copies"], again["d2h_copies"]) == (5, 0)
    _assert_same(moved.to_numpy(), t.to_numpy())


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(dev, tmp_path):
    """q3 at SF 0.01 over two gloo ranks on one card (NCCL refuses two
    ranks on one device, so the group stages its collectives through the
    host): both ranks return the same table, byte-identical to the
    in-process `collect_distributed_table(2)` on the card."""
    import importlib.util
    from pathlib import Path

    # loaded by path: this file runs with --noconftest, and a site package
    # named `tests` may shadow the repo's
    spec = importlib.util.spec_from_file_location(
        "torch_spmd_rank", Path(__file__).with_name("torch_spmd_rank.py"))
    ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks)
    res = ranks.run_ranks(
        2, [{"name": "tpch", "kind": "tpch", "sf": 0.01, "queries": ["q3"],
             "in_process": True}], tmp_path / "ranks",
        device=f"cuda:{torch.cuda.current_device()}", timeout_s=300)
    got = [r["tpch"] for r in res]
    for r in got:
        assert "failed" not in r, r.get("traceback")
    assert got[0]["q3"]["in_process"]["difference"] == ""
    assert got[0]["q3"]["rows"] == got[1]["q3"]["rows"] > 0
    _assert_same(got[0]["q3"]["result"], got[1]["q3"]["result"])
