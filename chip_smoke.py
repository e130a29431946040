#!/usr/bin/env python3
"""Drive datafusion_distributed_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the full run, one card

Phases, each of which must pass:

1. build  — compile every CUDA source of the port (one nvcc per source, all
   started together) and print the card's name and power limit.
2. kernels — each hash-table kernel against its plain PyTorch version on the
   card at main-path shapes (8,388,608 rows = lineitem's padded capacity at
   TPC-H SF 1, 2^21 slots): bit-exact, with kernel / plain / library times
   and the bytes bound.
3. main   — TPC-H SF 1 generated by the port, every query through
   SessionContext(device="cuda").sql(...).collect_table().to_numpy(), twice:
   both runs byte-identical, and every kernel's launch count above 0.
4. check  — the same queries at SF 0.01 on "cuda" and on "cpu": integers,
   strings and row order exact, floats at precision.test_rtol() of the
   column's scale.
5. profile — each query once more under torch.profiler: device busy time,
   idle share and the hash-table kernels' share per query.

The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script fails and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
QUERY_DIR = Path(__file__).resolve().parent / "benchmarks" / "queries" / "tpch"
SOURCE = "datafusion_distributed_tpu_torch/csrc/hash_table.cu"
REPLACES = {
    "build_group_ids":
        "datafusion_distributed_tpu/ops/pallas_hash.py:94",
    "multiway_probe":
        "datafusion_distributed_tpu/ops/pallas_hash.py:259",
    "group_aggregate":
        "datafusion_distributed_tpu/ops/pallas_hash.py:433",
}
#: the __global__ functions of SOURCE, to find them in a profiler trace
HASH_TABLE_KERNELS = ("group_build_kernel", "group_aggregate_kernel",
                      "probe_rows")


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
    """Mean wall time per call on the card: CUDA events around ``reps``
    calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_kernels(n: int, h: int, reps: int) -> dict:
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.ops.hash import hash_columns

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)
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
        keys_np, _ = _keys(rng, n, ndv, lanes, skew)
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
            case["bound_ms"] = bound_ms(
                nbytes(keys, s0, live) + nbytes(got[0], got[1], got[2]))
        k1[name] = case
        log(f"[kernels] build_group_ids {name}: {case}")
        del keys, s0, got, ref
    out["build_group_ids"] = dict(k1["skewed L=3"], cases=k1)

    # --- kernel 2: probe of K tables --------------------------------------
    k2 = {}
    tables = []
    for hslots in (h, h // 2, h // 32):
        ndv = int(hslots * 0.4)
        bkeys_np, _ = _keys(rng, ndv, ndv, 1, False)
        bkeys = torch.from_numpy(bkeys_np).to(dev)
        blive = torch.ones(ndv, dtype=torch.bool, device=dev)
        _g, tk, used, bover, _r = hk.build_group_ids(
            bkeys, slot0_of(bkeys, hslots), blive, hslots)
        check(not bool(bover), "probe table build overflowed")
        tables.append((hslots, ndv, tk, used))
    for ntab in (1, 3):
        tabs = tables[:ntab]
        pkeys = []
        slot0s = []
        for hslots, ndv, _tk, _u in tabs:
            # half the probe keys are present, half absent
            kn = rng.integers(0, 2 * ndv, n).astype(np.int32)[:, None]
            kt = torch.from_numpy(kn).to(dev)
            pkeys.append(kt)
            slot0s.append(slot0_of(kt, hslots))
        keys = torch.stack(pkeys, dim=1)  # [n, K, 1]
        s0 = torch.stack(slot0s, dim=1)
        active = live[:, None].expand(n, ntab).contiguous()
        tkeys = torch.cat([t[2] for t in tabs], dim=0)
        used = torch.cat([t[3] for t in tabs], dim=0)
        slots = tuple(t[0] for t in tabs)
        got = hk.multiway_probe(keys, s0, active, tkeys, used, slots)
        ref = hk.multiway_probe_plain(keys, s0, active, tkeys, used, slots)
        err = max_abs_err(zip(got, ref))
        check(err == 0, f"multiway_probe K={ntab}: kernel != plain")
        found_frac = float((got[0] >= 0).float().mean())
        case = {
            "max_abs_err": err, "found_fraction": found_frac,
            "ms": time_ms(lambda: hk.multiway_probe(keys, s0, active, tkeys,
                                                    used, slots), reps),
            "plain_ms": time_ms(lambda: hk.multiway_probe_plain(
                keys, s0, active, tkeys, used, slots), 1),
            "library_ms": None,
            "bound_ms": bound_ms(nbytes(keys, s0, active, tkeys, used)
                                 + nbytes(got[0], got[1])),
        }
        k2[f"K={ntab}"] = case
        log(f"[kernels] multiway_probe K={ntab}: {case}")
        del keys, s0, active, got, ref
    out["multiway_probe"] = dict(k2["K=1"], cases=k2)

    # --- kernel 3: group build + int32 fold --------------------------------
    k3 = {}
    ops = ("sum", "sum", "min", "max")  # count, sum, min, max
    for name, lanes, ndv, skew in cases:
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
                nbytes(keys, s0, live, vals)
                + nbytes(got[0], got[1], got[2], got[3]))
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
    return {
        "setup_s": setup_s, "queries": per_query, "launches": launches,
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
        ours = sum(ms for name, ms in by_name.items()
                   if any(f"::{k}(" in name for k in HASH_TABLE_KERNELS))
        ka = prof.key_averages()
        syncs = sum(e.count for e in ka
                    if e.key in ("cudaStreamSynchronize",
                                 "cudaDeviceSynchronize", "cudaMemcpyAsync"))
        result[q] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "idle_share": 1.0 - busy_ms / wall_ms,
                     "hash_kernels_ms": ours,
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
            "name": name, "route": "cuda", "source": SOURCE,
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
