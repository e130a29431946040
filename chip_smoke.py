#!/usr/bin/env python3
"""Drive datafusion_distributed_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the full run, one card

Phases, each of which must pass:

1. build  — compile every CUDA source of the port (one nvcc per source, all
   started together) and print the card's name and power limit.
2. kernels — each hash-table kernel against its plain PyTorch version on the
   card at main-path shapes (8,388,608 rows = lineitem's padded capacity at
   TPC-H SF 1, 2^21 slots; probe tables at the main path's sizes): bit-exact,
   with call, kernel-only, plain and library times and the bytes bound.
3. main   — TPC-H SF 1 generated by the port, every query through
   SessionContext(device="cuda").sql(...).collect_table().to_numpy(), twice:
   both runs byte-identical, and every kernel's launch count above 0.
4. check  — the same queries at SF 0.01 on "cuda" and on "cpu": integers,
   strings and row order exact, floats at precision.test_rtol() of the
   column's scale.
5. profile — each query once more under torch.profiler: device busy time,
   idle share, sync calls and the port's kernels' device time per query.

The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script fails and prints no result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
QUERY_DIR = Path(__file__).resolve().parent / "benchmarks" / "queries" / "tpch"
CSRC = "datafusion_distributed_tpu_torch/csrc"
SOURCES = {
    "build_group_ids": f"{CSRC}/hash_table.cu",
    "multiway_probe": f"{CSRC}/probe.cu",
    "group_aggregate": f"{CSRC}/hash_table.cu",
}
REPLACES = {
    "build_group_ids":
        "datafusion_distributed_tpu/ops/pallas_hash.py:94",
    "multiway_probe":
        "datafusion_distributed_tpu/ops/pallas_hash.py:259",
    "group_aggregate":
        "datafusion_distributed_tpu/ops/pallas_hash.py:433",
}
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def hash_table_kernels() -> tuple:
    """The __global__ functions of the port's CUDA sources, to find them in
    a profiler trace."""
    from datafusion_distributed_tpu_torch.ops import _build

    return tuple(sorted({m for src in _build.CSRC.glob("*.cu")
                         for m in _GLOBAL.findall(src.read_text())}))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    """Mean device time per call: CUDA events around ``reps`` calls after
    one warm-up call. The card first sleeps while the host enqueues the
    calls, so that the events time the card's work back to back and not
    the host's launch overhead (a call that syncs the host waits anyway)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean host time per call to enqueue ``fn`` (no host sync inside)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def kernel_of(event_name: str, kernels) -> str | None:
    """The port's kernel a profiler event ran, or None."""
    for k in kernels:
        if f"::{k}(" in event_name or f"::{k}<" in event_name:
            return k
    return None


def kernel_ms(fn, reps: int, kernels) -> dict:
    """Device time per call of each of the port's kernels that ``fn``
    launches, from torch.profiler (kernel durations only: no launch gaps,
    copies or memsets)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        k = kernel_of(e.name, kernels) if e.device_type == DeviceType.CUDA \
            else None
        if k:
            out[k] = out.get(k, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise PhaseError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> str:
    from datafusion_distributed_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    check(bool(sources), "no CUDA sources found")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        results = list(ex.map(_build.build, sources))
    for src, (path, report) in zip(sources, results):
        log(f"[build] {src} -> {path.name}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[ptxas] {line.strip()}")
    log(f"[build] {len(sources)} source(s) in {time.perf_counter() - t0:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _keys(rng, n, ndv, lanes, skew: bool):
    """[n, lanes] int32 key lanes with ``ndv`` distinct keys (Zipf-skewed
    when ``skew``); the last of 3 lanes is a validity lane."""
    if skew:
        ids = (rng.zipf(1.3, n) - 1) % ndv
    else:
        ids = rng.integers(0, ndv, n)
    cols = [ids]
    if lanes >= 2:
        cols.append((ids * 7919) % 1_000_003)
    if lanes >= 3:
        cols.append(np.ones(n, dtype=np.int64))
    return np.stack(cols[:lanes], axis=1).astype(np.int32), ids


def _rng(case: str):
    """Each case's own random stream, seeded from its name: adding a case
    moves no other case's inputs."""
    return np.random.default_rng(zlib.crc32(case.encode()))


def _probe_tables(name: str, rng, n: int, h: int):
    """A kernel-2 case: (tables, probe keys [n, K, L] int32). A table is
    (slots, its distinct build keys [B, L] int32) or, for the full table,
    (slots, slot keys [H, L], used [H]) given as they stand."""
    if name in ("K=1", "K=3"):
        # ~0.25 load at 2^21 slots; about a third of the probe keys present
        tables, keys = [], []
        for hslots in (h, h // 2, h // 32)[:int(name[2:])]:
            ndv = int(hslots * 0.4)
            tables.append((hslots, rng.integers(0, ndv, ndv)[:, None]))
            keys.append(rng.integers(0, 2 * ndv, n)[:, None])
        return tables, np.stack(keys, axis=1).astype(np.int32)
    if name == "orders":  # lineitem -> orders at SF 1: every key present
        build = rng.choice(6_000_000, 1_500_000, replace=False) + 1
        return ([(h, build[:, None])],
                build[rng.integers(0, len(build), n)][:, None, None])
    if name == "supplier":  # one key lane: 164 KB, the shared-memory route
        build = np.arange(1, 10_001)
        return [(1 << 15, build[:, None])], rng.integers(1, 10_001, n)[:, None, None]
    if name == "nation":
        return [(64, np.arange(25)[:, None])], rng.integers(0, 25, n)[:, None, None]
    if name == "customer L=2":  # key + validity lane; 3 in 4 keys present
        build = np.stack([np.arange(1, 150_001), np.ones(150_000)], axis=1)
        probe = np.stack([rng.integers(1, 200_001, n), np.ones(n)], axis=1)
        return [(1 << 19, build)], probe[:, None, :]
    if name == "full table":  # every slot used: absent keys walk max_rounds
        slots = 1 << 12
        tkeys = rng.permutation(1_000_000)[:slots][:, None]
        probe = np.where(rng.random(n) < 0.5,
                         tkeys[rng.integers(0, slots, n), 0],
                         rng.integers(1_000_000, 2_000_000, n))
        return [(slots, tkeys, np.ones(slots, bool))], probe[:, None, None]
    raise ValueError(name)


PROBE_CASES = ("K=1", "K=3", "orders", "supplier", "nation", "customer L=2",
               "full table")


def probe_steps(keys, slot0, active, tkeys, used, table_slots,
                max_rounds: int) -> int:
    """Table reads a probe's data needs: per active pair, the steps of its
    chain to a match, an empty slot or max_rounds (multiway_probe_plain's
    loop, counted)."""
    import torch

    total, off = 0, 0
    for k, hslots in enumerate(table_slots):
        act = active[:, k].clone()
        slot = slot0[:, k].long()
        for _ in range(max_rounds):
            live = int(act.sum())
            if not live:
                break
            total += live
            u = used[off + slot]
            act &= u & ~(tkeys[off + slot] == keys[:, k]).all(dim=1)
            slot = torch.where(act, (slot + 1) & (hslots - 1), slot)
        off += hslots
    return total


def phase_kernels(n: int, h: int, reps: int) -> dict:
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.ops.hash import hash_columns

    dev = torch.device("cuda")
    out: dict = {}

    def slot0_of(keys_t, hslots):
        cols = [keys_t[:, i] for i in range(keys_t.shape[1])]
        return (hash_columns(cols, [None] * len(cols)) & (hslots - 1)).to(
            torch.int32)

    live_rows = int(n * 0.72)  # lineitem: 6,001,215 live of 8,388,608
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[:live_rows] = True

    # --- kernel 1: group build -------------------------------------------
    # (name, lanes, distinct keys, Zipf-skewed): ~0.48 load factor at the
    # planner's 2x sizing; one key for every live row; a table loaded near
    # 0.85, whose chains take hundreds of rounds; overflow: more distinct
    # keys than slots
    cases = [
        ("uniform L=1", 1, int(h * 0.48), False),
        ("skewed L=3", 3, int(h * 0.48), True),
        ("hot key L=3", 3, 1, False),
        ("long chain L=1", 1, int(h * 0.85), False),
        ("overflow L=1", 1, h + h // 2, False),
    ]
    k1 = {}
    for name, lanes, ndv, skew in cases:
        keys_np, _ = _keys(_rng(name), n, ndv, lanes, skew)
        keys = torch.from_numpy(keys_np).to(dev)
        s0 = slot0_of(keys, h)
        hk.reset_round_stats()
        got = hk.build_group_ids(keys, s0, live, h)
        stats = hk.round_stats()  # the device counters, read once
        ref = hk.build_group_ids_plain(keys, s0, live, h)
        rounds = int(got[4])
        err = max_abs_err(zip(got[:4], ref[:4]))
        check(err == 0 and rounds == int(ref[4]),
              f"build_group_ids {name}: kernel != plain (err {err}, rounds "
              f"{rounds} vs {int(ref[4])})")
        check(stats == {"builds": 1, "total": rounds, "max": rounds},
              f"build_group_ids {name}: round stats {stats}, rounds {rounds}")
        over = bool(got[3])
        check(over == (name.startswith("overflow")),
              f"build_group_ids {name}: overflow={over}")
        case = {"rounds": rounds, "overflow": over, "max_abs_err": err,
                "groups": int(got[2].sum())}
        if not over:
            case["ms"] = time_ms(lambda: hk.build_group_ids(keys, s0, live, h),
                                 reps)
            case["plain_ms"] = time_ms(
                lambda: hk.build_group_ids_plain(keys, s0, live, h), 1)
            case["library_ms"] = time_ms(
                lambda: torch.unique(keys[:live_rows], dim=0,
                                     return_inverse=True), reps)
            # keys and slot0 of the live rows only: what the build needs
            case["bound_ms"] = bound_ms(
                nbytes(keys[:live_rows], s0[:live_rows], live)
                + nbytes(got[0], got[1], got[2]))
        k1[name] = case
        log(f"[kernels] build_group_ids {name}: {case}")
        del keys, s0, got, ref
    out["build_group_ids"] = dict(k1["skewed L=3"], cases=k1)

    # --- kernel 2: probe of K tables --------------------------------------
    # Every probe row of a case is active where `live` is (72%). Where the
    # package has them (a parent tree may not), the routes are printed and
    # both records of the L2 route are timed: used flags apart from the key
    # lanes, and packed into one record with them (packing pass included).
    variants = hasattr(hk, "probe_cuda")
    kernels = hash_table_kernels()
    k2 = {}
    for name in PROBE_CASES:
        specs, keys_np = _probe_tables(name, _rng(name), n, h)
        tparts, uparts = [], []
        for spec in specs:
            if len(spec) == 3:  # a table as it stands
                tparts.append(torch.from_numpy(spec[1].astype(np.int32)).to(dev))
                uparts.append(torch.from_numpy(spec[2]).to(dev))
                continue
            bkeys = torch.from_numpy(spec[1].astype(np.int32)).to(dev)
            blive = torch.ones(len(bkeys), dtype=torch.bool, device=dev)
            _g, tk, used, bover, _r = hk.build_group_ids(
                bkeys, slot0_of(bkeys, spec[0]), blive, spec[0])
            check(not bool(bover), f"probe table of {name} overflowed")
            tparts.append(tk)
            uparts.append(used)
        slots = tuple(spec[0] for spec in specs)
        keys = torch.from_numpy(keys_np.astype(np.int32)).to(dev)
        ntab = len(slots)
        s0 = torch.stack([slot0_of(keys[:, k], slots[k]) for k in range(ntab)],
                         dim=1)
        active = live[:, None].expand(n, ntab).contiguous()
        args = (keys, s0, active, torch.cat(tparts), torch.cat(uparts), slots)
        got = hk.multiway_probe(*args)
        ref = hk.multiway_probe_plain(*args)
        err = max_abs_err(zip(got, ref))
        check(err == 0, f"multiway_probe {name}: kernel != plain")
        over = [bool(v) for v in got[1].tolist()]
        check(any(over) == (name == "full table"),
              f"multiway_probe {name}: overflow {over}")
        case = {
            "max_abs_err": err, "overflow": over,
            "active_pairs": int(active.sum()),
            "steps": probe_steps(*args, hk.MAX_ROUNDS),
            "found_fraction": float((got[0] >= 0).float().mean()),
            "ms": time_ms(lambda: hk.multiway_probe(*args), reps),
            "host_us": host_us(lambda: hk.multiway_probe(*args), reps),
            "kernel_ms": kernel_ms(lambda: hk.multiway_probe(*args), reps,
                                   kernels),
            "plain_ms": time_ms(lambda: hk.multiway_probe_plain(*args), 1),
            "library_ms": None,
            # keys and slot0 of the active pairs only: what the probe needs
            "bound_ms": bound_ms(
                int(active.sum()) * (4 * keys.shape[2] + 4)
                + nbytes(active, *args[3:5]) + nbytes(*got)),
        }
        # yardstick of the table reads: one random read of a key record per
        # active pair of table 0, as one library gather (index_select)
        gidx = s0[:, 0][active[:, 0]]
        case["gather_ms"] = time_ms(
            lambda: tparts[0].index_select(0, gidx), reps)
        if variants:
            launches = hk.probe_launches(slots, keys.shape[2],
                                         hk.smem_limit(dev))
            case["routes"] = [launch.route for launch in launches]
            case["packs"] = [hk.packs_records(
                n * len(launch.slots), sum(launch.slots), keys.shape[2])
                for launch in launches if launch.route == "l2"]
        if variants and "l2" in case["routes"]:
            for label, pack in (("unpacked", False), ("packed", True)):
                res = hk.probe_cuda(*args, hk.MAX_ROUNDS, pack)
                check(max_abs_err(zip(res, ref)) == 0,
                      f"multiway_probe {name} {label}: kernel != plain")
                case[f"{label}_ms"] = time_ms(
                    lambda: hk.probe_cuda(*args, hk.MAX_ROUNDS, pack), reps)
        k2[name] = case
        log(f"[kernels] multiway_probe {name}: {case}")
        del keys, s0, active, args, got, ref, gidx
    out["multiway_probe"] = dict(
        k2["K=1"], cases=k2,
        max_abs_err=max(c["max_abs_err"] for c in k2.values()))

    # --- kernel 3: group build + int32 fold --------------------------------
    k3 = {}
    ops = ("sum", "sum", "min", "max")  # count, sum, min, max
    for name, lanes, ndv, skew in cases:
        rng = _rng(name)  # kernel 1's keys for the same case, then values
        keys_np, _ = _keys(rng, n, ndv, lanes, skew)
        keys = torch.from_numpy(keys_np).to(dev)
        s0 = slot0_of(keys, h)
        vals_np = np.stack([
            np.ones(n), rng.integers(-1000, 1000, n),
            rng.integers(-2**31, 2**31 - 1, n), rng.integers(-2**31, 2**31 - 1, n),
        ], axis=1).astype(np.int32)
        vals = torch.from_numpy(vals_np).to(dev)
        hk.reset_round_stats()
        got = hk.group_aggregate(keys, s0, live, vals, h, ops)
        stats = hk.round_stats()
        ref = hk.group_aggregate_plain(keys, s0, live, vals, h, ops)
        rounds = int(got[5])
        err = max_abs_err(zip(got[:5], ref[:5]))
        check(err == 0 and rounds == int(ref[5]),
              f"group_aggregate {name}: kernel != plain (err {err}, rounds "
              f"{rounds} vs {int(ref[5])})")
        check(stats == {"builds": 1, "total": rounds, "max": rounds},
              f"group_aggregate {name}: round stats {stats}, rounds {rounds}")
        over = bool(got[4])
        check(over == (name.startswith("overflow")),
              f"group_aggregate {name}: overflow={over}")
        case = {"rounds": rounds, "overflow": over, "max_abs_err": err}
        if not over:
            case["ms"] = time_ms(
                lambda: hk.group_aggregate(keys, s0, live, vals, h, ops), reps)
            case["plain_ms"] = time_ms(lambda: hk.group_aggregate_plain(
                keys, s0, live, vals, h, ops), 1)
            case["library_ms"] = None
            case["bound_ms"] = bound_ms(
                nbytes(keys[:live_rows], s0[:live_rows], vals[:live_rows],
                       live) + nbytes(got[0], got[1], got[2], got[3]))
        k3[name] = case
        log(f"[kernels] group_aggregate {name}: {case}")
        del keys, s0, vals, got, ref
    out["group_aggregate"] = dict(k3["skewed L=3"], cases=k3)
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: TPC-H through the SQL entry point
# ---------------------------------------------------------------------------


def _queries(names):
    return [(q, (QUERY_DIR / f"{q}.sql").read_text()) for q in names]


def _session(device: str, sf: float, seed: int):
    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    ctx = SessionContext(device=device)
    tpchgen.register_tpch(ctx, sf, seed)
    return ctx


def _run(ctx, sql: str) -> dict:
    import torch

    out = ctx.sql(sql).collect_table().to_numpy()
    torch.cuda.synchronize()
    return out


def _identical(a: dict, b: dict) -> bool:
    if list(a) != list(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype == object:
            if list(x) != list(y):
                return False
        elif isinstance(x, np.ma.MaskedArray):
            if not (np.array_equal(np.ma.getmaskarray(x), np.ma.getmaskarray(y))
                    and np.array_equal(np.ma.getdata(x), np.ma.getdata(y))):
                return False
        elif x.tobytes() != y.tobytes():
            return False
    return True


def phase_main(sf: float, names, seed: int) -> dict:
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    t0 = time.perf_counter()
    ctx = _session("cuda", sf, seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[main] TPC-H SF {sf} generated and uploaded in {setup_s:.1f}s")
    # claim-loop rounds are read per run; the launch counts run on
    rounds = {"builds": 0, "total": 0, "max": 0}

    def run_counting_rounds(sql):
        hk.reset_round_stats()
        out = _run(ctx, sql)
        stats = hk.round_stats()  # the device counters, read once a query
        rounds["builds"] += stats["builds"]
        rounds["total"] += stats["total"]
        rounds["max"] = max(rounds["max"], stats["max"])
        return out, stats

    hk.reset_launch_counts()
    per_query = {}
    for q, sql in _queries(names):
        t0 = time.perf_counter()
        first, _ = run_counting_rounds(sql)
        t1 = time.perf_counter()
        before = dict(hk.LAUNCHES)
        second, stats = run_counting_rounds(sql)
        t2 = time.perf_counter()
        check(_identical(first, second), f"{q}: two runs differ")
        rows = len(next(iter(second.values()))) if second else 0
        per_query[q] = {
            "rows": rows, "first_s": t1 - t0, "second_s": t2 - t1,
            "launches": {k: hk.LAUNCHES[k] - before[k] for k in before},
            "rounds": stats,
        }
        log(f"[main] {q}: rows={rows} first={t1 - t0:.3f}s "
            f"second={t2 - t1:.3f}s launches={per_query[q]['launches']} "
            f"rounds={stats}")
    launches = dict(hk.LAUNCHES)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    # the probe launches by (rows, tables, lanes, table slots), both runs
    probe_shapes = sorted(
        ([n, k, lanes, list(slots), c] for (n, k, lanes, slots), c
         in getattr(hk, "PROBE_SHAPES", {}).items()),
        key=lambda s: (-s[0], s[3]))
    for shape in probe_shapes:
        log(f"[main] probe shape rows={shape[0]} tables={shape[1]} "
            f"lanes={shape[2]} slots={shape[3]} launches={shape[4]}")
    return {
        "setup_s": setup_s, "queries": per_query, "launches": launches,
        "probe_shapes": probe_shapes,
        "rounds": {"builds": rounds["builds"], "max": rounds["max"],
                   "mean": (rounds["total"] / rounds["builds"]
                            if rounds["builds"] else 0.0)},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def phase_profile(sf: float, names, seed: int, out_dir) -> dict:
    """Where a query's wall time goes: one warm run of each query under
    torch.profiler. Device busy time is the sum of the device activities
    (kernels, copies, memsets) on the one stream the port uses; the idle
    share is the rest of the wall time. The full op tables go to
    ``out_dir`` when one is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ctx = _session("cuda", sf, seed)
    kernels = hash_table_kernels()
    result = {}
    for q, sql in _queries(names):
        _run(ctx, sql)  # warm: builds, dictionaries, plan-time subqueries
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()  # the profiler's start-up excluded
            _run(ctx, sql)
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        by_name: dict = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        ours: dict = {}  # the port's kernels' device ms, by kernel
        for name, ms in by_name.items():
            k = kernel_of(name, kernels)
            if k:
                ours[k] = ours.get(k, 0.0) + ms
        ka = prof.key_averages()
        syncs = sum(e.count for e in ka
                    if e.key in ("cudaStreamSynchronize",
                                 "cudaDeviceSynchronize", "cudaMemcpyAsync"))
        result[q] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "idle_share": 1.0 - busy_ms / wall_ms,
                     "hash_kernels_ms": sum(ours.values()),
                     "hash_kernels_by_name": ours,
                     "device_activities": len(dev), "sync_calls": syncs,
                     "top_device_ms": top}
        log(f"[profile] {q}: {result[q]}")
        if out_dir:
            path = Path(out_dir) / f"profile_{q}.txt"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(
                ka.table(sort_by="self_cpu_time_total", row_limit=40)
                + "\n" + ka.table(sort_by="self_device_time_total",
                                  row_limit=25))
    return result


def _close(a: dict, b: dict, rtol: float) -> str:
    """'' when equal (floats at rtol of the column's scale), else the first
    differing column."""
    if list(a) != list(b):
        return f"columns {list(a)} vs {list(b)}"
    for k in a:
        x, y = a[k], b[k]
        if x.shape != y.shape:
            return f"{k}: {x.shape} vs {y.shape} rows"
        if x.dtype.kind == "f":
            scale = float(np.nanmax(np.abs(x))) if np.isfinite(x).any() else 0.0
            if not np.allclose(x, y, rtol=rtol, atol=rtol * scale,
                               equal_nan=True):
                return k
        elif not _identical({k: x}, {k: y}):
            return k
    return ""


def phase_check(sf: float, names, seed: int) -> dict:
    from datafusion_distributed_tpu_torch import precision

    gpu = _session("cuda", sf, seed)
    cpu = _session("cpu", sf, seed)
    result = {}
    for q, sql in _queries(names):
        a = _run(gpu, sql)
        b = cpu.sql(sql).collect_table().to_numpy()
        diff = _close(a, b, precision.test_rtol())
        check(diff == "", f"{q}: cuda and cpu differ in {diff}")
        result[q] = len(next(iter(a.values()))) if a else 0
    log(f"[check] SF {sf}: {len(result)} queries equal on cuda and cpu")
    return result


# ---------------------------------------------------------------------------


#: the main-path shapes; fixed, so that every printed number is at them
QUERIES = [f"q{i}" for i in range(1, 23)]
ROWS = 8_388_608  # lineitem's padded capacity at TPC-H SF 1
SLOTS = 1 << 21  # PlannerConfig.max_slots
REPS = 5  # timed calls per kernel, after one warm-up
SLEEP_CYCLES = 20_000_000  # ~10 ms of the card's clock, ahead of timed calls
SF = 1.0  # main path: the smallest official TPC-H scale
CHECK_SF = 0.01  # card against CPU
SEED = 7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,main,check,profile")
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    ap.add_argument("--profile-dir", default=None,
                    help="profile phase: write each query's op tables here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    try:
        import datafusion_distributed_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the port package is missing: {e}")
        return 2

    phases = args.phases.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {"card": None}
    ok = True
    t_all = time.perf_counter()
    for phase in ("build", "kernels", "main", "check", "profile"):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        try:
            if phase == "build":
                results["card"] = phase_build()
            elif phase == "kernels":
                results["kernels"] = phase_kernels(ROWS, SLOTS, REPS)
            elif phase == "main":
                results["main"] = phase_main(SF, QUERIES, SEED)
            elif phase == "check":
                results["check"] = phase_check(CHECK_SF, QUERIES, SEED)
            else:
                results["profile"] = phase_profile(SF, QUERIES, SEED,
                                                   args.profile_dir)
        except Exception as e:  # noqa: BLE001 - report every phase, then fail
            import traceback

            traceback.print_exc()
            log(f"[{phase}] FAILED: {e}")
            results.setdefault("failed", []).append(phase)
            ok = False
        log(f"[{phase}] {time.perf_counter() - t0:.1f}s")
    results["total_s"] = time.perf_counter() - t_all
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1, default=str))
    if not ok:
        log(f"chip_smoke: failed phases {results['failed']}")
        return 1

    kernels = []
    # launches are counted only by the main phase: null when it did not run
    launches = results.get("main", {}).get("launches", {})
    for name, k in results.get("kernels", {}).items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": "bytes", "library_ms": k["library_ms"],
        })
    if "main" in results:
        print(json.dumps({"main": {q: v["second_s"] for q, v in
                                   results["main"]["queries"].items()},
                          "rounds": results["main"]["rounds"]}))
    print(json.dumps({"kernels": kernels}))
    print(results["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
