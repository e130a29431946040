#!/usr/bin/env python3
"""Drive datafusion_distributed_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the full run, one card

Phases, each of which must pass:

1. build  — compile every CUDA source of the port (one nvcc per source, all
   started together) and print the card's name and power limit.
2. kernels — each hash-table kernel against its plain PyTorch version on the
   card at main-path shapes (8,388,608 rows = lineitem's padded capacity at
   TPC-H SF 1, 2^21 slots; probe tables at the main path's sizes; kernel 4
   at the ClickBench cell's fold shapes, 2^25 rows, in every value dtype):
   bit-exact, with call, kernel-only, plain and library times and the bytes
   bound.
3. main   — TPC-H SF 1 generated by the port, every query through
   SessionContext(device="cuda").sql(...).collect_table().to_numpy(), twice:
   both runs byte-identical, every kernel's launch count above 0, and
   kernel 4 at every shape the runs logged.
4. check  — the same queries at SF 0.01 on "cuda" and on "cpu": integers,
   strings and row order exact, floats at precision.test_rtol() of the
   column's scale.
5. profile — each query once more under torch.profiler: device busy time,
   idle share, sync calls and the port's kernels' device time per query.
6. session — the session as a user drives it at SF 1: a second
   ctx.sql(same text) of every query reuses the planned tree (no planner
   call) with byte-identical results; planning ms of the first and the
   cached submission; every plan verifies with no error diagnostic;
   results with literal hoisting off equal those with it on, byte for byte;
   a prepared TPC-H q6 template bound three times equals ctx.sql on the
   bound text.
7. window — the window queries W1-W3 at SF 1, twice, byte-identical, and
   at SF 0.01 on "cuda" against "cpu".
8. distributed — the staged planner at SF 1: distributed_plan(T) of the
   22 queries and the star query S1 for T in 1, 2, 4, 8, with multiway_join
   off and on (no error diagnostic; first and cached planning ms; the
   device bytes of the scans split for 8 tasks); the one-task staged path
   (collect_distributed_table(1), fused multiway joins on) twice,
   byte-identical and equal to collect_table; kernel 2 at every probe shape
   it logged; and at SF 0.01 the staged results and staged plans on "cuda"
   against "cpu".
9. tasks — the 22 queries and the star queries S1 and S2 through
   collect_distributed_table(8), twice, byte-identical and equal to
   single-node (warm seconds, sync calls, retries, peak memory per query);
   S1 and S2 again with multiway fusion on (their fused nodes timed in
   every task); kernels 1 and 2 at every shape the 8-task runs logged,
   against their plain versions; at SF 0.01, T in 2 and 8 on "cuda"
   against "cpu" (a CPU subprocess that runs meanwhile).
10. coordinator — the 22 queries, S1 and S2 through
   collect_coordinated_table(num_tasks=4) over InMemoryCluster(4), with
   Coordinator at SF 1 and AdaptiveCoordinator at SF 0.1, twice each:
   byte-identical runs, each equal to single-node (warm seconds against single-node and
   against collect_distributed_table(4), sync calls, device-to-host bytes,
   peak memory, retries and the plane of every exchange, per query); q3,
   q5, q18 and q21 under each data-plane knob at SF 0.1 (on the bulk
   plane q21 does not fit the card at SF 1), byte-identical; the
   device-to-host copies of q3 by Python call stack, on a session
   whose planner statistics are cold and again once they are cached;
   kernels 1
   and 2 at every shape the coordinated runs logged, against their plain
   versions; at SF 0.01 both coordinators on "cuda" against "cpu" (a CPU
   subprocess that runs meanwhile); the same four queries at SF 0.1 with
   the planner's partial-aggregate push-down off, against the default
   (float sums at test_rtol(), everything else exact, capacities
   included; warm seconds and exchange bytes of both).
11. serving — TPC-H SF 1 through ServingSession over InMemoryCluster(4)
   at 4 tasks: each query served alone (admission estimate, measured
   peak staged bytes, allocator peak); a closed loop of 8 clients (client
   0 q21, the others q1 and q6, 2 queries each) serialized, FIFO and fair
   share (queries/s, cheap and heavy p50/p99, queue wait, peaks), every
   result byte-identical to the sequential coordinated run; the result
   cache off and on over 32 seeded Poisson arrivals of q1 and three q6
   variants (hit rate, p99; a hit is the cold run's table); a prepared
   q6 through PreparedStatement.submit; q18 under a worker memory
   budget below its peak (spill count and bytes, byte-identical); q3
   killed at its root stage and recover()ed from its checkpoints; kernels
   1 and 2 at every logged shape; at SF 0.01 five served queries on
   "cuda" against "cpu" (a CPU subprocess that runs meanwhile).
12. resilience — TPC-H SF 1 through Coordinator over DynamicCluster(4) at
   4 tasks: q3, q9 and q18 with and without a sticky 2 s
   straggler on one worker, hedging off and on (warm wall per query, hedge
   counters, hedges in flight, the latency sketch's p99), each equal to
   single-node; q3 and q9 under a leave, a join and a drain with
   transport faults, each on a fresh cluster, byte-identical to the
   no-churn run (fired kinds, re-shipped producers, retries, the drain,
   the card's allocated bytes before and after); the serving tier's
   chaos-and-churn mix with hedging on, identical to the sequential runs,
   read through the ObservabilityService; q3 resumed from checkpoints
   after a worker holding them left; kernels 1, 2 and 3 at every logged
   shape; at SF 0.01 churned q3 and hedged q1 on "cuda" against "cpu" (a
   CPU subprocess that runs meanwhile); the leak arms: the serving tier's
   served q1/q6/q3 mix, q3 churned and q3 hedged over the straggler, at
   SF 0.1, cold then warm, in a subprocess with the leak harness armed
   through DFTPU_LEAK_CHECK=strict and in one with DFTPU_LEAK_CHECK=0
   (survivors swept, which must be 0; what the harness tracked; its cost
   in warm seconds per arm).
12b. adaptive — over InMemoryCluster(4) at 4 tasks, the tables on the card:
   the skew split, the partial-aggregate bail-out and the mid-query replan
   forced against the adaptations off (synthetic shapes of 2^20 rows,
   lineitem at SF 0.1 partitioned by its status columns, TPC-H q18 and q9
   at SF 0.1), each cold then warm: equal results, the adaptation records,
   the counters and the warm seconds; an execution deadline over a worker
   that hangs on the root stage, on a streamed stage and as a straggler:
   rerouted, equal to single-node, and once the abandoned attempts end no
   staged slice and the card's allocated bytes as before; a quarantined
   worker routed around and its half-open probe admitted; a corrupt plan
   refused without retries; at SF 1 a LIMIT of 100,000 rows over 8
   streamed tasks against one chunk a task, and a stream budget's peak
   bytes in flight; kernels 1-3 at every logged shape.
13. wire — coordinated TPC-H over real 127.0.0.1 gRPC sockets
   (start_localhost_cluster(4): four gRPC servers in this process, every
   worker on the card) at 4 tasks: q1, q3, q5 and q9 at SF 1,
   cold then warm, over gRPC and over InMemoryCluster(4) on the same
   session (warm seconds of both; device-to-host and host-to-device bytes,
   copies and GB/s; wire bytes before and after compression; SetPlan bytes
   shipped; peak device memory; the card's allocated bytes before the
   cluster started and after its shutdown), each byte-identical to the
   in-process run and equal to single-node; q3 at SF 0.1
   under data_plane default, stream and shm, stream and shm each with
   wire_compression auto and off, and q21 on shm with auto, byte-identical (segments published and
   released, bytes through shm), and q3 under a chaos segment_lost
   schedule; the native
   host hash against the card's on SF 1 key columns; kernels 1, 2 and 3 at
   every logged shape; at SF 0.01 four queries over gRPC on "cuda" against
   "cpu" (a CPU subprocess that runs meanwhile).
14. tools — the operator's tools on the card: `cli.main(["--tpch", "1",
   "-c", q3])`, its printed rows equal to single-node; q3 and q5 through
   the coordinator over InMemoryCluster(4) at SF 1, untraced then traced,
   byte-identical (`ctx.last_trace()`'s events, `trace_coverage`, the
   first lines of `ctx.last_trace_profile()`, the seconds tracing adds);
   `Console.render_frame()` over two localhost gRPC workers after q3 over
   them, with the worker rows and the data-plane line; four parquet slices
   of lineitem streamed through a work-unit feed into a WorkUnitScanExec
   under a GROUP BY, equal to the GROUP BY over the whole table (each
   unit's four timestamps); kernels 1, 2 and 3 at every logged shape; the
   served q1/q6 mix over two gRPC workers at SF 0.1 in a subprocess with
   DFTPU_LOCK_CHECK=0 and, at the same time, in one with
   DFTPU_LOCK_CHECK=1 (warm seconds of both; observed lock-order edges, static or new, hold outliers and
   events; a lock-order cycle fails it); and, in a subprocess with jax
   blocked, a star query over three fresh gRPC clusters in a row (the shm,
   stream and shm planes), each equal to single-node.
15. mesh — meshes-as-workers: TPC-H through Coordinator over
   InMemoryMeshCluster(2, 4, devices=[cuda] * 8) at 8 tasks, so that each
   stage ships one span plan to each worker: q1, q3, q5, q9 and q18
   at SF 1, cold then warm, beside the same queries over
   InMemoryCluster(2) with per-task dispatch (warm seconds of both, spans
   run per worker, set_stage_plan against set_plan calls, peak device
   memory), each equal to single-node; all 22 queries at SF 0.1 over the
   mesh workers, each equal to single-node; the card's allocated bytes
   before the cluster, after the runs and after its release, and what
   workers that keep their last spans (as the JAX package's do) hold
   after q3 and q9 of the warm mix; kernels 1, 2 and 3 at every logged
   shape.
15b. examples — the port's examples (datafusion_distributed_tpu_torch/
   examples/, one a file of examples/) through their run(), each at
   8,388,608 rows with its own key domains (the work-unit feed as 4
   parquet files of 2^21 rows), cold then warm (seconds, peak allocated
   bytes, the example's own observable: clamped rows, routing decisions
   by stage, each worker's drain wait and the epochs, wire bytes and
   codec, span plans run), warm equal to cold; each at 20,000 rows on
   "cuda" against "cpu" in this process (frames at precision.test_rtol(),
   plans, clamped rows, routes, epochs, the refusal, fed rows and sums,
   the console's sections exactly); kernels 1, 2 and 3 at every logged
   shape. The two SPMD examples also run over the spmd phase's ranks.
16. spmd — the SPMD tier: four rank processes of this script form a
   gloo group on the card (NCCL refuses two ranks on one device), each
   over the same TPC-H tables, and run collect_distributed_table(mesh=):
   the 22 queries at SF 0.1 and q1, q3, q5, q9, q18 at SF 1 (the
   ranks' SF 1 tables in host memory, their slices moved to the card)
   cold then warm, every rank's table byte-identical to rank 0's
   in-process collect_distributed_table(4) on the card with equal retries
   (seconds of both, each rank's peak allocated bytes, the bytes each
   exchange kind sent); meanwhile the five at SF 1 over a one-rank NCCL
   group in this process, each equal to
   collect_distributed_table(1); the port's two SPMD examples
   (custom_partial_reduction_tree with 4 leaf tasks and 2 groups,
   mesh_spmd_query) at 8,388,608 rows over the ranks, every rank's result
   byte-identical to rank 0's in-process run at 4 tasks; kernels 1, 2 and
   3 at every shape the ranks logged.
17. clickbench — in a DFTPU_PRECISION=x64 subprocess (the mode is fixed at
   import): the `hits` table at its published 99,997,497 rows, seed 3, all
   43 queries of benchmarks/queries/clickbench/ twice, byte-identical; then
   kernels 1 and 2 at every shape that run gave them (group builds on
   `hits`'s int64 keys through the (lo, hi) lane split, up to 2^28 slots),
   bit-exact against their plain versions; the 43 queries over 8 tasks on
   its first 2^26 rows (8 tasks' buffers on one card do not fit at the
   full size), once each after their single-node runs, against
   single-node on those rows, and
   kernels 1 and 2 at their shapes; at 20,000 rows on "cuda" against
   "cpu", results and the staged plans for 8 tasks; and, in the same x64
   process, TPC-H q3 and q18 at SF 0.1 through the coordinator over
   InMemoryCluster(4), cold then warm, against single-node.

Every phase that holds kernels against their plain versions at the shapes
it logged (the distributed, tasks and coordinator phases, and from
serving on) holds kernel 4 at its logged (rows, slots, op, value dtype)
shapes too, on seeded ids and values drawn on the card.
The check phase also runs q22 and q13 over `orders` without the customers
whose key is divisible by 3, card against CPU (7 and 22 rows at SF 0.01).
The main phase, the window phase, the one-task staged path, each
coordinator's second run, the serving tier's fair-share arm, the hedged
straggler arm's warm run, each warm gRPC run of the wire phase, the tools
phase's in-process runs (cli, tracing, console, feed), each warm run over
the mesh workers, each example's warm run, each rank's warm SPMD runs
and the ClickBench run each
set the kernels' launch counts to 0 just before they run and read them
just after.
The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script fails and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import zlib
from datetime import timedelta
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
QUERY_DIR = Path(__file__).resolve().parent / "benchmarks" / "queries" / "tpch"
CLICKBENCH_DIR = QUERY_DIR.parent / "clickbench"
CSRC = "datafusion_distributed_tpu_torch/csrc"
SOURCES = {
    "build_group_ids": f"{CSRC}/hash_table.cu",
    "multiway_probe": f"{CSRC}/probe.cu",
    "group_aggregate": f"{CSRC}/hash_table.cu",
    "group_fold": f"{CSRC}/group_fold.cu",
}
REPLACES = {
    "build_group_ids":
        "datafusion_distributed_tpu/ops/pallas_hash.py:94",
    "multiway_probe":
        "datafusion_distributed_tpu/ops/pallas_hash.py:259",
    "group_aggregate":
        "datafusion_distributed_tpu/ops/pallas_hash.py:433",
    "group_fold": "no TPU kernel: the GROUP BYs' index_add_ and "
                  "scatter_reduce_ (ops/aggregate.py)",
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


def timed_once(fn) -> tuple:
    """(fn(), its device time in ms): CUDA events around one call, for a
    plain version too slow to run twice."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def device_ops(fn, top: int = 12) -> dict:
    """One warm call of ``fn`` under torch.profiler: its device busy ms, its
    wall ms, and the ``top`` device activities by summed ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    ka = prof.key_averages()
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in ka),
                  key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "busy_ms": sum(by_name.values()),
            "top": [[name[:80], ms] for name, ms in ops[:top]],
            "host_top": [[k[:60], ms, c] for k, ms, c in host[:top]]}


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


def _device_rng(case: str, dev):
    """A case's own random stream on the card (shape checks draw tens of
    millions of keys: host draws and copies cost seconds a shape)."""
    import torch

    return torch.Generator(device=dev).manual_seed(zlib.crc32(case.encode()))


def _ints(gen, shape, dev, lo=-2**31, hi=2**31 - 1):
    """int32 values in [lo, hi) drawn on the card."""
    import torch

    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


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
    out["group_fold"] = phase_fold(dev, reps, kernels)
    torch.cuda.synchronize()
    return out


#: kernel 4's cases, shapes that the ClickBench cell's GROUP BYs log at its
#: 2^25 rows: (slots, live rows or None for all, distinct ids, 0 for
#: near-distinct). A GROUP BY-less aggregate's 8 slots over every row (q0,
#: q2, q29); SearchPhrase's 13 values in the planner's 256 slots, over
#: every row and with 5% live (a filter's compacted prefix, the rest in the
#: drop slot; q12, q21, q22 keep 10-60%); the hot-slot cache: 4 groups in
#: 2^26 slots at 2/3 live (q28) and 1,320 in 2^18 at 90% live (q39);
#: near-distinct keys into 2^26 slots (q30-q32)
FOLD_ROWS = 1 << 25
FOLD_CASES = {
    "global 8": (8, None, 1),
    "13 hot": (256, None, 13),
    "13 hot, 5% live": (256, FOLD_ROWS // 20, 13),
    "4 hot in 2^26": (1 << 26, FOLD_ROWS * 2 // 3, 4),
    "1,320 in 2^18": (1 << 18, FOLD_ROWS * 9 // 10, 1320),
    "near-distinct": (1 << 26, None, 0),
}
#: the value dtypes kernel 4 is checked in at every case: x64's int64, the
#: `tpu` mode's int32 sums, ClickBench's narrow MIN/MAX columns, bool
FOLD_DTYPES = ("int64", "int32", "int16", "uint8", "bool")


def fold_values(gen, n: int, dtype: str, dev):
    """[n] values of ``dtype`` drawn on the card over its whole range, the
    first four rows its extremes."""
    import torch

    dt = getattr(torch, dtype)
    if dt == torch.bool:
        return torch.rand(n, generator=gen, device=dev) < 0.5
    info = torch.iinfo(dt)
    if dt == torch.int64:  # both words vary
        hi = torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev)
        v = hi * 2**32 + torch.randint(0, 2**32, (n,), generator=gen,
                                       device=dev)
    else:
        v = torch.randint(info.min, info.max + 1, (n,), generator=gen,
                          device=dev).to(dt)
    v[:4] = torch.tensor([info.min, info.max, info.min, info.max], dtype=dt)
    return v


def fold_ops(dtype) -> tuple:
    """The folds the aggregates run on values of ``dtype`` (a COUNT takes
    none; bool is only MIN/MAX)."""
    return ("min", "max") if dtype == "bool" else ("sum", "min", "max",
                                                   "count")


def fold_against_plain(gid, vals, slots: int, op: str, num_rows) -> dict:
    """One kernel-4 call against group_fold_plain on the same inputs, bit
    for bit and in dtype: its mismatching slots and the plain version's
    device time."""
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    got = hk.group_fold(gid, vals, slots, op, num_rows)
    ref, plain_ms = timed_once(
        lambda: hk.group_fold_plain(gid, vals, slots, op, num_rows))
    same = got.dtype == ref.dtype and torch.equal(got, ref)
    return {"max_abs_err": 0 if same else max(1, int((got != ref).sum())),
            "plain_ms": plain_ms}


def fold_inputs(name: str, dev) -> tuple:
    """A kernel-4 case of ``FOLD_CASES``, drawn on the card from its name:
    (group ids int32, the rows past the live prefix in the drop slot;
    int64 values; the live prefix as a 0-d int32 tensor; live rows;
    slots)."""
    import torch

    slots, live, hot = FOLD_CASES[name]
    gen = _device_rng(name, dev)
    n = FOLD_ROWS
    if hot:
        ids = torch.randint(0, slots, (hot,), generator=gen, device=dev)
        gid = ids[torch.randint(0, hot, (n,), generator=gen, device=dev)]
    else:
        gid = torch.randint(0, slots, (n,), generator=gen, device=dev)
    gid = gid.to(torch.int32)
    live = n if live is None else live
    gid[live:] = slots
    num_rows = torch.tensor(live, dtype=torch.int32, device=dev)
    vals = torch.randint(-2**62, 2**62, (n,), generator=gen, device=dev)
    return gid, vals, num_rows, live, slots


def phase_fold(dev, reps: int, kernels) -> dict:
    """Kernel 4 against its plain version, bit for bit, for every op and
    every value dtype of ``FOLD_DTYPES`` over int32 ids, then timed for
    SUM and MIN of int64 values beside the library call each replaces
    (index_add_ and scatter_reduce_ over every row and the drop slot, on
    int64 ids, as SegmentSum and segment_minmax called them). Bound: each
    live row's group id and value read once and each slot written once;
    validity reaches the fold folded into the group id (the drop slot), so
    it reads none."""
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    cases = {}
    for name in FOLD_CASES:
        gid, vals, num_rows, live, slots = fold_inputs(name, dev)
        gid64 = gid.long()
        gen = _device_rng(f"{name} values", dev)
        err = 0
        for dtype in FOLD_DTYPES:
            dv = vals if dtype == "int64" else fold_values(gen, FOLD_ROWS,
                                                           dtype, dev)
            for op in fold_ops(dtype):
                v = None if op == "count" else dv
                e = fold_against_plain(gid, v, slots, op,
                                       num_rows)["max_abs_err"]
                err = max(err, e)
                check(e == 0, f"group_fold {name} {op} {dtype}: kernel != "
                      "plain")
            del dv
        case = {"slots": slots, "live_rows": live, "max_abs_err": err,
                "bound_ms": bound_ms(live * (gid.element_size()
                                             + vals.element_size())
                                     + slots * vals.element_size())}
        for op in ("sum", "min"):
            fold = (lambda op=op: hk.group_fold(gid, vals, slots, op, num_rows))
            if op == "sum":
                lib = (lambda: torch.zeros(slots + 1, dtype=vals.dtype,
                                           device=dev).index_add_(0, gid64, vals))
            else:
                lib = (lambda: torch.full(
                    (slots + 1,), torch.iinfo(vals.dtype).max,
                    dtype=vals.dtype, device=dev).scatter_reduce_(
                        0, gid64, vals, reduce="amin"))
            key = "" if op == "sum" else "min_"
            case[f"{key}ms"] = time_ms(fold, reps)
            case[f"{key}kernel_ms"] = kernel_ms(fold, reps, kernels)
            case[f"{key}plain_ms"] = time_ms(
                lambda op=op: hk.group_fold_plain(gid, vals, slots, op,
                                                  num_rows), 1)
            case[f"{key}library_ms"] = time_ms(lib, reps)
        case["bound_share"] = case["bound_ms"] / case["ms"]
        cases[name] = case
        log(f"[kernels] group_fold {name}: {case}")
        del gid, gid64, vals, num_rows
    return dict(cases["13 hot"], cases=cases)


# ---------------------------------------------------------------------------
# phases 3 and 4: TPC-H through the SQL entry point
# ---------------------------------------------------------------------------


def _queries(names):
    return [(q, (QUERY_DIR / f"{q}.sql").read_text()) for q in names]


#: (device, sf, seed) -> the generated TPC-H tables: each is generated and
#: uploaded once a run, and every phase's session registers the same ones
_TABLES: dict = {}


def _session(device: str, sf: float, seed: int):
    """A fresh SessionContext (its own plan cache) over the TPC-H tables."""
    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    ctx = SessionContext(device=device)
    tables = _TABLES.get((device, sf, seed))
    if tables is None:
        tpchgen.register_tpch(ctx, sf, seed)
        _TABLES[(device, sf, seed)] = dict(ctx.catalog.tables)
    else:
        for name, table in tables.items():
            ctx.register_table(name, table)
    return ctx


def _run(ctx, sql: str) -> dict:
    return _collect(ctx.sql(sql))


def _collect(df) -> dict:
    import torch

    out = df.collect_table().to_numpy()
    torch.cuda.synchronize()
    return out


def _collect_staged(df) -> dict:
    """The one-task staged plan's result, as _collect gives a query's."""
    import torch

    out = df.collect_distributed_table(1).to_numpy()
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


def kernel_shapes(hk, tag: str) -> tuple:
    """The build and probe launches since the last reset, by shape, logged:
    builds as [rows, int32 key lanes, slots, launches], probes as [rows,
    tables, lanes, table slots, launches] (a parent tree may lack either
    counter)."""
    builds = sorted(
        ([n, lanes, h, c] for (n, lanes, h), c
         in getattr(hk, "BUILD_SHAPES", {}).items()),
        key=lambda s: (-s[0], -s[2], s[1]))
    probes = sorted(
        ([n, k, lanes, list(slots), c] for (n, k, lanes, slots), c
         in getattr(hk, "PROBE_SHAPES", {}).items()),
        key=lambda s: (-s[0], s[3]))
    for shape in builds:
        log(f"[{tag}] build shape rows={shape[0]} lanes={shape[1]} "
            f"slots={shape[2]} launches={shape[3]}")
    for shape in probes:
        log(f"[{tag}] probe shape rows={shape[0]} tables={shape[1]} "
            f"lanes={shape[2]} slots={shape[3]} launches={shape[4]}")
    return builds, probes


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
        before = hk.launches()
        second, stats = run_counting_rounds(sql)
        t2 = time.perf_counter()
        check(_identical(first, second), f"{q}: two runs differ")
        rows = len(next(iter(second.values()))) if second else 0
        per_query[q] = {
            "rows": rows, "first_s": t1 - t0, "second_s": t2 - t1,
            "launches": {k: n - before[k]
                         for k, n in hk.launches().items()},
            "rounds": stats,
        }
        log(f"[main] {q}: rows={rows} first={t1 - t0:.3f}s "
            f"second={t2 - t1:.3f}s launches={per_query[q]['launches']} "
            f"rounds={stats}")
    launches = hk.launches()
    launches_by_k = _launches_by_k(hk)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    build_shapes, probe_shapes = kernel_shapes(hk, "main")
    folds = fold_shapes(hk, "main")
    fold_checks = fold_shape_checks(folds, torch.device("cuda"), "main")
    return {
        "setup_s": setup_s, "queries": per_query, "launches": launches,
        "launches_by_k": launches_by_k,
        "build_shapes": build_shapes, "probe_shapes": probe_shapes,
        "kernel_checks": {"group_fold": fold_checks},
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


def _without_a_third_of_customers(device: str, sf: float, seed: int):
    """A session over the TPC-H tables with `orders` cut to the rows whose
    o_custkey % 3 != 0, as TPC-H's own generator leaves a third of the
    customers without orders (the port's generator gives every customer
    one, so q22 finds none)."""
    ctx = _session(device, sf, seed)
    orders = ctx.catalog.tables["orders"]
    keep = orders.column("o_custkey").data % 3 != 0
    ctx.register_table("orders", orders.compact(keep))
    return ctx


#: rows of q22 and q13 over those orders at SF 0.01, seed 7 (both packages)
THIRD_ROWS = {"q22": 7, "q13": 22}


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
    gpu = _without_a_third_of_customers("cuda", sf, seed)
    cpu = _without_a_third_of_customers("cpu", sf, seed)
    orders = int(gpu.catalog.tables["orders"].num_rows)
    for q, sql in _queries(THIRD_ROWS):
        a = _run(gpu, sql)
        b = cpu.sql(sql).collect_table().to_numpy()
        diff = _close(a, b, precision.test_rtol())
        check(diff == "", f"{q} (a third of customers without orders): "
              f"cuda and cpu differ in {diff}")
        rows = len(next(iter(a.values())))
        if sf == 0.01 and seed == 7:
            check(rows == THIRD_ROWS[q], f"{q}: {rows} rows, expected "
                  f"{THIRD_ROWS[q]} over {orders} orders")
        result[f"{q}_third"] = rows
    log(f"[check] SF {sf}, {orders} orders: q22 {result['q22_third']} rows, "
        f"q13 {result['q13_third']} rows, equal on cuda and cpu")
    return result


# ---------------------------------------------------------------------------
# phase 6: the session (plan cache, verification, hoisting, prepared q6)
# ---------------------------------------------------------------------------

Q6_TEMPLATE = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1995-01-01'
  and l_discount between $1 - 0.01 and $1 + 0.01
  and l_quantity < $2
"""
Q6_BINDINGS = ((0.06, 24), (0.05, 25), (0.07, 20))


def phase_session(sf: float, names, seed: int) -> dict:
    import torch

    from datafusion_distributed_tpu_torch.plan import fingerprint
    from datafusion_distributed_tpu_torch.plan.verify import (
        verify_physical_plan,
    )
    from datafusion_distributed_tpu_torch.sql import planner

    ctx = _session("cuda", sf, seed)
    calls = []  # one entry per PhysicalPlanner.plan call
    real_plan = planner.PhysicalPlanner.plan

    def counting_plan(self, logical):
        calls.append(1)
        return real_plan(self, logical)

    def plan_ms(sql):
        t0 = time.perf_counter()
        df = ctx.sql(sql)
        df.physical_plan()
        torch.cuda.synchronize()
        return df, (time.perf_counter() - t0) * 1e3

    per_query, hoisted_on = {}, {}
    planner.PhysicalPlanner.plan = counting_plan
    try:
        for q, sql in _queries(names):
            n0 = len(calls)
            first, first_ms = plan_ms(sql)
            check(len(calls) > n0, f"{q}: the first submission did not plan")
            r1 = _collect(first)  # an overflow retry plans (and caches) too
            n1 = len(calls)
            second, cached_ms = plan_ms(sql)
            r2 = _collect(second)
            check(len(calls) == n1 and
                  second.physical_plan() is first.physical_plan(),
                  f"{q}: the second submission planned again")
            check(_identical(r1, r2), f"{q}: cached plan's result differs")
            result = verify_physical_plan(first.physical_plan())
            check(not result.errors(),
                  f"{q}: verification errors\n{result.render()}")
            prep = fingerprint.prepare_plan(first.physical_plan())
            check(prep.fingerprint is not None, f"{q}: no fingerprint")
            hoisted_on[q] = r1
            per_query[q] = {
                "plan_first_ms": first_ms, "plan_cached_ms": cached_ms,
                "planner_calls": n1 - n0,
                "retries": first.last_retry_count,
                "hoisted": len(prep.int_params) + len(prep.float_params),
                "diagnostics": sorted(d.code for d in result.diagnostics),
            }
            log(f"[session] {q}: {per_query[q]}")
    finally:
        planner.PhysicalPlanner.plan = real_plan
    # the same queries with hoisting off, in a session of their own
    off = _session("cuda", sf, seed)
    fingerprint.set_literal_hoisting(False)
    try:
        for q, sql in _queries(names):
            check(_identical(_run(off, sql), hoisted_on[q]),
                  f"{q}: hoisting on and off differ")
    finally:
        fingerprint.set_literal_hoisting(True)
    stmt = ctx.prepare(Q6_TEMPLATE)
    fps = set()
    for params in Q6_BINDINGS:
        df = stmt.to_df(params)
        check(_identical(_collect(df), _run(ctx, stmt.bind_sql(params))),
              f"prepared q6 {params}: differs from ctx.sql")
        fps.add(fingerprint.prepare_plan(df.physical_plan()).fingerprint)
    check(len(fps) == 1, f"prepared q6: {len(fps)} fingerprints")
    log(f"[session] {len(per_query)} queries reuse their plans; hoisting "
        "on and off identical; prepared q6 bound "
        f"{len(Q6_BINDINGS)} times")
    return {"queries": per_query,
            "plan_first_ms": sum(v["plan_first_ms"]
                                 for v in per_query.values()),
            "plan_cached_ms": sum(v["plan_cached_ms"]
                                  for v in per_query.values())}


# ---------------------------------------------------------------------------
# phase 7: window functions
# ---------------------------------------------------------------------------

#: top-N per group; a running sum with peers; a window over an aggregate
#: (the TPC-DS q12/q98 shape)
WINDOW_QUERIES = {
    "W1": "select l_suppkey, l_orderkey, l_extendedprice, rn, rk, dr from "
          "(select l_suppkey, l_orderkey, l_extendedprice, row_number() over "
          "(partition by l_suppkey order by l_extendedprice desc, l_orderkey)"
          " rn, rank() over (partition by l_suppkey order by l_extendedprice"
          " desc) rk, dense_rank() over (partition by l_suppkey order by "
          "l_extendedprice desc) dr from lineitem) t where rn <= 3 "
          "order by l_suppkey, rn",
    "W2": "select o_custkey, o_orderdate, sum(o_totalprice) over (partition "
          "by o_custkey order by o_orderdate) rs, count(*) over (partition by"
          " o_custkey) n from orders order by o_custkey, o_orderdate, rs",
    "W3": "select p_brand, p_type, sum(l_extendedprice) rev, "
          "sum(l_extendedprice) * 100 / sum(sum(l_extendedprice)) over "
          "(partition by p_brand) ratio from lineitem, part where l_partkey ="
          " p_partkey group by p_brand, p_type order by p_brand, p_type",
}
#: the kernels each path must launch
WINDOW_KERNELS = ("build_group_ids", "multiway_probe")
CLICKBENCH_KERNELS = ("build_group_ids",)


def phase_window(sf: float, check_sf: float, seed: int) -> dict:
    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    ctx = _session("cuda", sf, seed)
    per_query = {}
    hk.reset_launch_counts()
    for name, sql in WINDOW_QUERIES.items():
        t0 = time.perf_counter()
        first = _run(ctx, sql)
        t1 = time.perf_counter()
        second = _run(ctx, sql)
        t2 = time.perf_counter()
        check(_identical(first, second), f"{name}: two runs differ")
        per_query[name] = {"rows": len(next(iter(second.values()))),
                           "first_s": t1 - t0, "second_s": t2 - t1}
        log(f"[window] {name}: {per_query[name]}")
    launches = hk.launches()
    for k in WINDOW_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the window "
              "queries")
    gpu = _session("cuda", check_sf, seed)
    cpu = _session("cpu", check_sf, seed)
    for name, sql in WINDOW_QUERIES.items():
        diff = _close(_run(gpu, sql), cpu.sql(sql).collect_table().to_numpy(),
                      precision.test_rtol())
        check(diff == "", f"{name}: cuda and cpu differ in {diff}")
    log(f"[window] SF {check_sf}: {len(WINDOW_QUERIES)} queries equal on "
        "cuda and cpu")
    return {"queries": per_query, "launches": launches}


# ---------------------------------------------------------------------------
# phase 8: the staged (distributed) planner and the one-task staged path
# ---------------------------------------------------------------------------

#: the star query: lineitem probes orders, part and supplier on its own keys,
#: so its three joins fuse into one node that resolves all three probes with
#: one launch of kernel 2 (K = 3)
S1 = """select s_nationkey, p_brand, o_orderpriority, count(*) as n,
       sum(l_quantity) as q
from lineitem join orders on l_orderkey = o_orderkey
join part on l_partkey = p_partkey join supplier on l_suppkey = s_suppkey
group by s_nationkey, p_brand, o_orderpriority
order by s_nationkey, p_brand, o_orderpriority"""
STAGED_TASKS = (1, 2, 4, 8)
#: the kernels the one-task staged path must launch (kernel 3 where a
#: single-mode GROUP BY stays fused, as in q4, q12, q13, q16, q21)
DISTRIBUTED_KERNELS = ("build_group_ids", "multiway_probe", "group_aggregate")


def _staged_queries(names):
    return _queries(names) + [("S1", S1)]


def _launches_by_k(hk) -> dict:
    """Kernel 2's launches since the last reset, by its K (tables a launch)."""
    out: dict = {}
    for (_n, k, _lanes, _slots), c in hk.PROBE_SHAPES.items():
        out[k] = out.get(k, 0) + c
    return dict(sorted(out.items()))


def _scan_split_bytes(plans) -> int:
    """Device bytes of the per-task slices the planner cut the plans' scans
    into (each slice's columns and validity masks), each storage counted
    once: plans over the same table share the split of a column."""
    from datafusion_distributed_tpu_torch.plan.physical import MemoryScanExec

    storages = {}
    for plan in plans:
        for leaf in plan.collect(lambda n: isinstance(n, MemoryScanExec)):
            if len(leaf.tasks) > 1:
                for t in leaf.tasks:
                    for c in t.columns:
                        for x in (c.data, c.validity):
                            if x is not None:
                                st = x.untyped_storage()
                                storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def _fused_nodes(plan):
    from datafusion_distributed_tpu_torch.plan.joins import (
        MultiwayHashJoinExec,
    )

    return plan.collect(lambda n: isinstance(n, MultiwayHashJoinExec))


def phase_distributed(sf: float, check_sf: float, names, seed: int) -> dict:
    """1. distributed_plan(T) of every query and S1 for T in 1, 2, 4, 8, with
    multiway_join off and on: no error diagnostic; first and cached planning
    ms; the device bytes of the split scans at T = 8.
    2. collect_distributed_table(1) with multiway_join on, twice: the runs
    byte-identical and equal to collect_table; kernel 2 launched at K = 3.
    3. Kernel 2 at every probe shape the staged run logged, on seeded
    tables, bit for bit against its plain version.
    4. At SF ``check_sf``: the one-task results on the card equal the CPU's,
    and explain_distributed(T) gives the same string on both devices."""
    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.plan.verify import (
        verify_physical_plan,
    )

    queries = _staged_queries(names)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9

    # --- 1. planning, each T in a session of its own ---------------------
    planning: dict = {}
    split_plans = []
    fused_at: dict = {}
    for t in STAGED_TASKS:
        ctx = _session("cuda", sf, seed)
        row = {"first_ms": 0.0, "cached_ms": 0.0, "plans": 0}
        for mw in (False, True):
            ctx.config.distributed_options["multiway_join"] = mw
            for q, sql in queries:
                t0 = time.perf_counter()
                df = ctx.sql(sql)
                plan = df.distributed_plan(t)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                again = ctx.sql(sql).distributed_plan(t)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                check(again is plan, f"{q} T={t}: the plan was not cached")
                result = verify_physical_plan(plan)
                check(not result.errors(), f"{q} T={t} multiway={mw}: "
                      f"verification errors\n{result.render()}")
                row["first_ms"] += (t1 - t0) * 1e3
                row["cached_ms"] += (t2 - t1) * 1e3
                row["plans"] += 1
                if mw:
                    fused_at.setdefault(t, {})[q] = [
                        len(n.steps) for n in _fused_nodes(plan)]
                if t == 8:
                    split_plans.append(plan)
        planning[t] = row
        log(f"[distributed] T={t}: {row}")
        if t == 8:
            split_bytes = _scan_split_bytes(split_plans)
            del split_plans
        del ctx
    planning_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    check(fused_at[1]["S1"] == [3], f"S1 at T=1 fused as {fused_at[1]['S1']}")

    # --- 2. the one-task staged path --------------------------------------
    ctx = _session("cuda", sf, seed)
    ctx.config.distributed_options["multiway_join"] = True
    per_query: dict = {}
    staged: dict = {}
    hk.reset_launch_counts()
    for q, sql in queries:
        t0 = time.perf_counter()
        df = ctx.sql(sql)
        first = _collect_staged(df)
        t1 = time.perf_counter()
        second = _collect_staged(ctx.sql(sql))
        t2 = time.perf_counter()
        check(_identical(first, second), f"{q}: two staged runs differ")
        staged[q] = second
        per_query[q] = {"rows": len(next(iter(second.values()))),
                        "first_s": t1 - t0, "staged_s": t2 - t1,
                        "retries": df.last_retry_count}
    launches = hk.launches()
    by_k = _launches_by_k(hk)
    _builds, probe_shapes = kernel_shapes(hk, "distributed")
    folds = fold_shapes(hk, "distributed")
    for k in DISTRIBUTED_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the one-task "
              "staged path")
    rtol = precision.test_rtol()
    for q, sql in queries:
        _run(ctx, sql)  # warm
        t0 = time.perf_counter()
        single = _run(ctx, sql)
        per_query[q]["single_s"] = time.perf_counter() - t0
        diff = _close(staged[q], single, rtol)
        check(diff == "", f"{q}: staged and single-node results differ in "
              f"{diff}")
        log(f"[distributed] {q}: {per_query[q]}")

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del ctx, staged
    torch.cuda.empty_cache()
    # kernel 2 at every probe shape the staged run logged, on seeded tables
    probe_checks = probe_shape_checks(probe_shapes, torch.device("cuda"),
                                      "distributed")
    fold_checks = fold_shape_checks(folds, torch.device("cuda"),
                                    "distributed")

    # --- 4. card against CPU ----------------------------------------------
    gpu = _session("cuda", check_sf, seed)
    cpu = _session("cpu", check_sf, seed)
    for c in (gpu, cpu):
        c.config.distributed_options["multiway_join"] = True
    for q, sql in queries:
        a = _collect_staged(gpu.sql(sql))
        b = cpu.sql(sql).collect_distributed_table(1).to_numpy()
        diff = _close(a, b, rtol)
        check(diff == "", f"{q}: staged results on cuda and cpu differ in "
              f"{diff}")
        for t in STAGED_TASKS:
            check(gpu.sql(sql).explain_distributed(t)
                  == cpu.sql(sql).explain_distributed(t),
                  f"{q} T={t}: the staged plan differs on cuda and cpu")
    log(f"[distributed] SF {check_sf}: {len(queries)} queries, equal results "
        "and staged plans on cuda and cpu")
    return {
        "planning": planning, "split_scan_bytes_t8": split_bytes,
        "planning_peak_gb": planning_peak_gb, "base_gb": base_gb,
        "fused_steps": fused_at, "queries": per_query,
        "launches": launches, "multiway_probe_launches_by_k": by_k,
        "probe_shapes": probe_shapes,
        "kernel_checks": {"multiway_probe": probe_checks,
                          "group_fold": fold_checks},
        "peak_gb": peak_gb,
        "staged_s": sum(v["staged_s"] for v in per_query.values()),
        "single_s": sum(v["single_s"] for v in per_query.values()),
    }


# ---------------------------------------------------------------------------
# phase 9: staged plans over 8 tasks on the card
# ---------------------------------------------------------------------------

#: S1's star with a selective first step: the suppliers of one nation keep
#: about 4% of lineitem's rows
S2 = """select p_brand, o_orderpriority, count(*) as n, sum(l_quantity) as q
from lineitem join orders on l_orderkey = o_orderkey
join part on l_partkey = p_partkey join supplier on l_suppkey = s_suppkey
where s_nationkey = 3
group by p_brand, o_orderpriority order by p_brand, o_orderpriority"""
TASKS = 8
CHECK_TASKS = (2, 8)  # card against CPU
NODE_REPS = 3  # timed calls of a fused node, each way, after one warm-up
TASKS_CPU_TIMEOUT_S = 600


def _since(t0: float) -> str:
    return f"{time.perf_counter() - t0:.1f}s into the phase"


def _task_queries(names):
    return _queries(names) + [("S1", S1), ("S2", S2)]


def _collect_tasks(df, num_tasks: int) -> dict:
    import torch

    table = df.collect_distributed_table(num_tasks)
    out = table.to_numpy()
    if table.device.type == "cuda":
        torch.cuda.synchronize()
    return out


def _row_order(a: dict) -> np.ndarray:
    """A permutation sorting the rows by every column, floats last."""
    names = ([k for k in a if a[k].dtype.kind != "f"]
             + [k for k in a if a[k].dtype.kind == "f"])
    keys = []
    for k in names:
        x = a[k]
        if isinstance(x, np.ma.MaskedArray):
            keys.append(np.ma.getmaskarray(x))
            x = np.ma.filled(x, 0 if x.dtype != object else "")
        if x.dtype == object:
            x = np.unique(x.astype(str), return_inverse=True)[1]
        keys.append(x)
    return np.lexsort(keys[::-1])


def _close_or_ties(a: dict, b: dict, rtol: float) -> tuple:
    """(first difference or '', whether the rows had to be compared as a
    sorted set): an ORDER BY that leaves ties may order tied rows
    differently over 8 tasks than on one."""
    diff = _close(a, b, rtol)
    if diff == "":
        return "", False
    ia, ib = _row_order(a), _row_order(b)
    return _close({k: v[ia] for k, v in a.items()},
                  {k: v[ib] for k, v in b.items()}, rtol), True


def _sync_calls(fn) -> int:
    """The synchronizing CUDA calls one call of ``fn`` makes (device to host
    copies, stream syncs), as PyTorch's sync debug mode reports them: a
    profiler trace of 8 tasks' launches takes minutes to read."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


#: (kernel, shape) -> the case of its check, for every shape a phase of
#: this run held against the plain version: a later phase that logs the
#: same shape reuses the case (the run's time limit holds each shape once)
_CHECKED: dict = {}


def _checked_earlier(key, skipped: list):
    """The case of ``key`` if an earlier phase of this run checked it
    (marked with that phase), else None."""
    case = _CHECKED.get(key)
    if case is not None:
        skipped.append(key)
    return case


def _log_reused(tag: str, skipped: list) -> None:
    if skipped:
        log(f"[{tag}] {len(skipped)} shapes were checked bit-exact by an "
            "earlier phase of this run")


def build_shape_checks(build_shapes, dev, tag: str) -> dict:
    """Kernel 1 at every build shape a run logged ([rows, int32 lanes,
    slots, launches]), on seeded keys drawn on the card (about 0.45 *
    slots distinct, 90% of the rows live), bit for bit and round for round
    against its plain version. The launches made here are not the path's."""
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.ops.hash import hash_columns

    builds = {}
    skipped: list = []
    for n, lanes, slots, _count in build_shapes:
        earlier = _checked_earlier(("build", n, lanes, slots), skipped)
        if earlier is not None:
            builds[f"{n}x{lanes}/{slots}"] = earlier
            continue
        gen = _device_rng(f"{tag} build {n} {lanes} {slots}", dev)
        ndv = max(1, int(0.45 * slots))
        vals = _ints(gen, (ndv, lanes), dev)
        keys = vals[torch.randint(0, ndv, (n,), generator=gen, device=dev)]
        s0 = (hash_columns([keys[:, i] for i in range(lanes)],
                           [None] * lanes) & (slots - 1)).to(torch.int32)
        live = torch.rand(n, generator=gen, device=dev) < 0.9
        got = hk.build_group_ids(keys, s0, live, slots)
        ref, plain_ms = timed_once(
            lambda: hk.build_group_ids_plain(keys, s0, live, slots))
        err = max_abs_err(zip(got[:4], ref[:4]))
        case = {"rounds": int(got[4]), "max_abs_err": err,
                "overflow": bool(got[3]), "plain_ms": plain_ms,
                "ms": time_ms(lambda: hk.build_group_ids(keys, s0, live,
                                                         slots), 1)}
        check(err == 0 and case["rounds"] == int(ref[4]),
              f"build_group_ids rows={n} lanes={lanes} slots={slots}: "
              f"kernel != plain ({case}, plain rounds {int(ref[4])})")
        builds[f"{n}x{lanes}/{slots}"] = case
        _CHECKED[("build", n, lanes, slots)] = {**case, "checked_by": tag}
        log(f"[{tag}] build_group_ids rows={n} lanes={lanes} slots={slots}: "
            f"{case}")
        del keys, s0, live, got, ref
    _log_reused(tag, skipped)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return builds


def _fused_node_times(ctx, sql: str, num_tasks: int):
    """The query over ``num_tasks`` tasks, with each task's fused multiway
    node run once more alone on its own inputs and timed. -> its probe
    rows, output rows and time, summed over the tasks, or None when the
    plan has no fused node."""
    from datafusion_distributed_tpu_torch.plan.joins import (
        MultiwayHashJoinExec,
    )
    from datafusion_distributed_tpu_torch.plan.physical import (
        MemoryScanExec,
        execute_plan,
    )

    real = MultiwayHashJoinExec._execute
    records: list = []
    busy: list = []  # set while a node runs alone: its own calls are real

    def timed(self, ctx):
        if busy:
            return real(self, ctx)
        busy.append(True)
        try:
            inputs = [self.probe.execute(ctx)] + [b.execute(ctx)
                                                  for b in self.builds]
            node = self.with_new_children(
                [MemoryScanExec([t], t.schema()) for t in inputs])
            out = execute_plan(node)
            records.append({
                "probe_rows": int(inputs[0].num_rows),
                "rows": int(out.num_rows),
                "ms": time_ms(lambda: execute_plan(node), NODE_REPS)})
        finally:
            busy.clear()
        return real(self, ctx)

    MultiwayHashJoinExec._execute = timed
    try:
        _collect_tasks(ctx.sql(sql), num_tasks)
    finally:
        MultiwayHashJoinExec._execute = real
    if not records:
        return None
    check(len(records) == num_tasks, f"the fused node ran in {len(records)} "
          f"of {num_tasks} tasks")
    return {"tasks": num_tasks, **{k: sum(r[k] for r in records)
                                   for k in ("probe_rows", "rows", "ms")}}


def tasks_cpu_worker(sf: float, out_path: str) -> int:
    """The CPU's collect_distributed_table(T) of the 24 queries at SF ``sf``
    for T in CHECK_TASKS, pickled: the tasks phase holds the card's against
    them."""
    import torch

    torch.set_num_threads(4)
    ctx = _session("cpu", sf, SEED)
    out = {(t, q): _collect_tasks(ctx.sql(sql), t)
           for t in CHECK_TASKS for q, sql in _task_queries(QUERIES)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def phase_tasks(sf: float, check_sf: float, names, seed: int) -> dict:
    """1. The 22 queries, S1 and S2 through collect_distributed_table(8),
    multiway fusion off, twice: the runs byte-identical, each equal to the
    same session's collect_table (sorted rows where ORDER BY leaves ties);
    per query the warm seconds against single-node, sync calls, retries
    and peak device memory.
    2. S1 and S2 with fusion on, equal to step 1's; their fused nodes
    timed in every task at T = 1 and T = 8.
    3. Kernels 1 and 2 at every build and probe shape the T = 8 runs
    logged, bit for bit against their plain versions.
    4. At SF ``check_sf``: collect_distributed_table(T) on the card against
    the CPU (a subprocess that runs meanwhile) for T in 2, 8."""
    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    queries = _task_queries(names)
    rtol = precision.test_rtol()
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t_phase = time.perf_counter()
    # the CPU's results for step 4 are computed meanwhile, in a subprocess
    cpu_out = Path(tempfile.mkdtemp()) / "tasks_cpu.pkl"
    cpu_worker = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--tasks-cpu-worker",
         str(check_sf), "--out", str(cpu_out)], stdout=subprocess.DEVNULL)

    # --- 1. T = 8, fusion off ---------------------------------------------
    ctx = _session("cuda", sf, seed)
    per_query: dict = {}
    results: dict = {}
    for q, sql in queries:
        t0 = time.perf_counter()
        results[q] = _collect_tasks(ctx.sql(sql), TASKS)
        per_query[q] = {"first_s": time.perf_counter() - t0}
        log(f"[tasks] {q} T={TASKS} cold: {per_query[q]['first_s']:.3f}s, "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    hk.reset_launch_counts()
    for q, sql in queries:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        df = ctx.sql(sql)
        warm = _collect_tasks(df, TASKS)
        per_query[q].update(warm_s=time.perf_counter() - t0,
                            retries=df.last_retry_count,
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                            rows=len(next(iter(warm.values()))))
        check(_identical(results[q], warm), f"{q}: two runs at T={TASKS} "
              "differ")
    launches = hk.launches()
    by_k = _launches_by_k(hk)
    builds, probes = kernel_shapes(hk, "tasks")
    folds = fold_shapes(hk, "tasks")
    # kernel 3 fuses a single-mode GROUP BY, which 8 tasks split into
    # partial and final: its launches are reported, not required
    for k in ("build_group_ids", "multiway_probe"):
        check(launches[k] > 0, f"kernel {k} was not launched at T={TASKS}")
    ties = []
    for q, sql in queries:
        _run(ctx, sql)  # warm
        t0 = time.perf_counter()
        single = _run(ctx, sql)
        per_query[q]["single_s"] = time.perf_counter() - t0
        diff, tied = _close_or_ties(results[q], single, rtol)
        check(diff == "", f"{q}: T={TASKS} and single-node results differ in "
              f"{diff}")
        if tied:
            ties.append(q)
        per_query[q]["sync_calls"] = _sync_calls(
            lambda: _collect_tasks(ctx.sql(sql), TASKS))
        per_query[q]["single_sync_calls"] = _sync_calls(
            lambda: _run(ctx, sql))
        log(f"[tasks] {q}: {per_query[q]}")
    log(f"[tasks] compared as sorted rows (ORDER BY ties): {ties} "
        f"({_since(t_phase)})")
    peak_gb = max(v["peak_gb"] for v in per_query.values())
    fused_off = results

    # --- 2. fusion on, and the star queries' fused nodes ------------------
    ctx.config.distributed_options["multiway_join"] = True
    hk.reset_launch_counts()
    for q, sql in (("S1", S1), ("S2", S2)):
        diff = _close(_collect_tasks(ctx.sql(sql), TASKS), fused_off[q],
                      rtol)
        check(diff == "", f"{q}: T={TASKS} with and without multiway "
              f"fusion differ in {diff}")
    mw_launches = hk.launches()
    mw_by_k = _launches_by_k(hk)
    mw_builds, mw_probes = kernel_shapes(hk, "tasks multiway")
    folds.update(fold_shapes(hk, "tasks multiway"))
    del fused_off, results
    # the star queries' fused nodes at T = 1 and 8 at SF ``sf``, and where
    # they do not fuse there (over 8 tasks their broadcast builds pass the
    # planner's byte gate only at a smaller scale) at SF ``check_sf``
    small = _session("cuda", check_sf, seed)
    small.config.distributed_options["multiway_join"] = True
    nodes: dict = {}
    for q, sql in (("S1", S1), ("S2", S2)):
        for t in (1, TASKS):
            for at_sf, c in ((sf, ctx), (check_sf, small)):
                row = _fused_node_times(c, sql, t)
                if row is not None:
                    break
            check(row is not None, f"{q}: no fused node at T={t}")
            nodes[f"{q} T={t}"] = dict(row, sf=at_sf)
            log(f"[tasks] {q} fused node at T={t}, SF {at_sf}: "
                f"{nodes[f'{q} T={t}']} ({_since(t_phase)})")
    ctx.config.distributed_options["multiway_join"] = False
    del ctx, small
    torch.cuda.empty_cache()

    # --- 3. every logged shape against the plain version -----------------
    dev = torch.device("cuda")
    build_checks = build_shape_checks(
        list({tuple(b[:3]): b for b in builds + mw_builds}.values()),
        dev, "tasks")
    probe_checks = probe_shape_checks(
        list({str(p[:4]): p for p in probes + mw_probes}.values()),
        dev, "tasks")
    fold_checks = fold_shape_checks(folds, dev, "tasks")
    log(f"[tasks] shapes checked ({_since(t_phase)})")

    # --- 4. card against CPU ----------------------------------------------
    gpu = _session("cuda", check_sf, seed)
    check(cpu_worker.wait(timeout=TASKS_CPU_TIMEOUT_S) == 0,
          f"the CPU worker exited {cpu_worker.returncode}")
    with open(cpu_out, "rb") as f:
        cpu_results = pickle.load(f)
    identical = 0
    for t in CHECK_TASKS:
        for q, sql in queries:
            a = _collect_tasks(gpu.sql(sql), t)
            diff = _close(a, cpu_results[(t, q)], rtol)
            check(diff == "", f"{q} T={t}: cuda and cpu differ in {diff}")
            identical += _identical(a, cpu_results[(t, q)])
    log(f"[tasks] SF {check_sf}, T in {CHECK_TASKS}: {len(queries)} queries "
        f"equal on cuda and cpu, {identical} of {2 * len(queries)} byte for "
        f"byte ({_since(t_phase)})")
    return {
        "queries": per_query, "ties": ties, "base_gb": base_gb,
        "peak_gb": peak_gb, "launches": launches,
        "multiway_probe_launches_by_k": by_k,
        "multiway_launches": mw_launches,
        "multiway_probe_launches_by_k_fused": mw_by_k,
        "build_shapes": builds, "probe_shapes": probes,
        "kernel_checks": {"build_group_ids": build_checks,
                          "multiway_probe": probe_checks,
                          "group_fold": fold_checks},
        "fused_nodes": nodes,
        "card_cpu_identical": identical,
        "warm_s": sum(v["warm_s"] for v in per_query.values()),
        "single_s": sum(v["single_s"] for v in per_query.values()),
        "sync_calls": sum(v["sync_calls"] for v in per_query.values()),
        "single_sync_calls": sum(v["single_sync_calls"]
                                 for v in per_query.values()),
    }


# ---------------------------------------------------------------------------
# phase 10: the coordinator/worker runtime over 4 in-memory workers
# ---------------------------------------------------------------------------

COORD_TASKS = 4
COORD_WORKERS = 4
#: the knob variants, each byte-identical to the default run on these
#: queries (a forced plane, no peer pulls, no pipelining, one stage at a
#: time)
COORD_KNOB_QUERIES = ("q3", "q5", "q18", "q21")
#: the scale of the knob variants: on the bulk plane (data_plane=unary)
#: q21's shuffle slices keep producers x per-destination capacity rows
#: each, which at SF 1 does not fit the card beside 4 workers' tasks
#: (out of memory at 71 GB allocated)
COORD_KNOB_SF = 0.1
COORD_KNOBS = {
    "data_plane=unary": {"data_plane": "unary"},
    "data_plane=stream": {"data_plane": "stream"},
    "peer_shuffle=false": {"peer_shuffle": False},
    "pipelined_shuffle=false": {"pipelined_shuffle": False},
    "stage_parallelism=1": {"stage_parallelism": 1},
}
COORD_KERNELS = ("build_group_ids", "multiway_probe")
#: the scale of the adaptive coordinator's pass, and why: its sizing gives
#: each of the 4 concurrent tasks of q21's join stage the capacities of the
#: whole stage's rows (the reference's resize_for_inputs from the stage's
#: merged LoadInfo), which at SF 1 peaks past the card's 80 GB (80.84 GB
#: when it failed; 4 workers share one card here); and the whole pass runs
#: at this scale to leave the run's time to the serving phase
COORD_ADAPTIVE_SF = 0.1
#: the queries whose device-to-host copies are traced to their Python
#: call stacks (the copies of ~5 MB a query that static coordinated runs
#: of q2 and q3 showed; q2's copies came from the same stacks as q3's, so
#: only q3 is traced, and the time went to the leak arms)
COORD_D2H_TRACED = ("q3",)
COORD_CPU_TIMEOUT_S = 600


def _coordinated(ctx, sql: str, adaptive: bool, cluster, opts=None,
                 coord=None):
    """One query through collect_coordinated_table(num_tasks=4) on a fresh
    Coordinator (or AdaptiveCoordinator) over ``cluster``, or on ``coord``.
    -> (result, the coordinator, the DataFrame); every worker's store and
    task registry must be empty afterwards."""
    import torch

    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        AdaptiveCoordinator,
        Coordinator,
    )

    if coord is None:
        cls = AdaptiveCoordinator if adaptive else Coordinator
        coord = cls(resolver=cluster, channels=cluster,
                    config_options={**ctx.config.distributed_snapshot(),
                                    **(opts or {})})
    df = ctx.sql(sql)
    table = df.collect_coordinated_table(coordinator=coord,
                                         num_tasks=COORD_TASKS)
    out = table.to_numpy()
    if table.device.type == "cuda":
        torch.cuda.synchronize()
    for w in cluster.workers.values():
        check(not w.table_store.tables and len(w.registry) == 0,
              f"worker {w.url} kept {len(w.table_store.tables)} staged "
              f"tables and {len(w.registry)} tasks after the query")
    return out, coord, df


def _pushdown_arm(ctx, sql: str, cluster, on: bool) -> dict:
    """``sql`` coordinated with the planner's partial-aggregate push-down
    (the session option `distributed.partial_agg_pushdown`) on or off:
    cold then warm on the default plane (the warm result, its capacity and
    row count, both walls), then once on the peerless plane
    (`peer_shuffle=False`), where the coordinator measures the bytes each
    shuffle moved and records the planner's predicted bytes beside them."""
    import torch

    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
    )

    opts = ctx.config.distributed_options
    opts["partial_agg_pushdown"] = on
    try:
        out: dict = {}
        for run in ("cold", "warm"):
            coord = Coordinator(resolver=cluster, channels=cluster,
                                config_options=ctx.config.distributed_snapshot())
            t0 = time.perf_counter()
            table = ctx.sql(sql).collect_coordinated_table(
                coordinator=coord, num_tasks=COORD_TASKS)
            result = table.to_numpy()
            torch.cuda.synchronize()
            out[f"{run}_s"] = time.perf_counter() - t0
        out.update(result=result, capacity=table.capacity,
                   rows=int(table.num_rows))
        _res, coord, _df = _coordinated(ctx, sql, False, cluster,
                                        {"peer_shuffle": False})
        metrics = coord.stream_metrics.values()
        out["exchange_bytes"] = sum(v.get("exchange_bytes", 0)
                                    for v in metrics)
        out["predicted_bytes"] = sum(v.get("predicted_exchange_bytes", 0)
                                     for v in metrics)
    finally:
        opts.pop("partial_agg_pushdown", None)
    for w in cluster.workers.values():
        check(not w.table_store.tables and len(w.registry) == 0,
              f"worker {w.url} kept staged tables or tasks after the "
              "push-down arm")
    return out


def _planes(coord) -> dict:
    """How many exchanges of the run took each data plane."""
    out: dict = {}
    for sm in coord.stream_metrics.values():
        plane = sm.get("plane", "stream")
        out[plane] = out.get(plane, 0) + 1
    return dict(sorted(out.items()))


def _measured(fn) -> tuple:
    """(fn(), its counts): the synchronizing calls one call of ``fn`` makes
    (PyTorch's sync debug mode) and its device-to-host copies, from the
    profiler's record of its CUDA activity, with the card's kernel count
    (0 kernels: the profiler saw no device activity, and the copies are
    not measured)."""
    from torch.profiler import ProfilerActivity, profile

    box: list = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        syncs = _sync_calls(lambda: box.append(fn()))
    copies = kernels = nbytes = 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if "DtoH" in name:
            copies += 1
            nbytes += _copy_bytes(e)
        elif str(e.device_type()).endswith("CUDA") and "emcpy" not in \
                name and "emset" not in name:
            kernels += 1
    if copies and not nbytes:
        # the events carry no byte counts: read them from the exported
        # trace, whose copy events do
        path = Path(tempfile.mkdtemp()) / "trace.json"
        prof.export_chrome_trace(str(path))
        nbytes = sum(
            int(e.get("args", {}).get("bytes", 0))
            for e in json.loads(path.read_text()).get("traceEvents", [])
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""))
        path.unlink()
    return box[0], {"sync_calls": syncs, "d2h_bytes": nbytes,
                    "d2h_copies": copies, "kernels": kernels}


def _copy_bytes(e) -> int:
    """A profiler copy event's bytes, where the event carries them."""
    n = e.nbytes()
    if not n:
        meta = (e.metadata_json() or "").strip()
        if meta:
            meta = json.loads(meta if meta.startswith("{")
                              else "{" + meta + "}")
            n = int(meta.get("bytes", 0))
    extra = getattr(e, "extra_meta", None)
    if not n and extra is not None:
        n = int((extra() or {}).get("bytes", 0))
    return n


def _log_d2h_event() -> None:
    """Log what the profiler records for one device-to-host copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.arange(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.cpu()
    for e in prof.profiler.kineto_results.events():
        if "DtoH" in e.name():
            log(f"[coordinator] a 8 MiB copy as the profiler records it: "
                f"name={e.name()!r} bytes read={_copy_bytes(e)} "
                f"metadata={e.metadata_json()!r} fields="
                f"{[a for a in dir(e) if not a.startswith('_')]}")


def _sync_stacks(fn) -> tuple:
    """(fn(), where its synchronizing calls come from): the call runs under
    PyTorch's sync debug mode, and each warning's Python stack is taken
    where it is raised (in the thread that made the call), grouped by the
    port's and this script's innermost frames. A device-to-host copy is
    such a call. (The profiler's op events, with_stack=True, carried no
    Python frames for these copies on the card.) -> (result,
    [{"frames", "syncs"}]), most first."""
    import threading
    import traceback
    import warnings

    import torch

    def ours(frames) -> tuple:
        return tuple(
            f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in frames
            if ("datafusion_distributed_tpu_torch" in f.filename
                or "chip_smoke" in f.filename) and f.name != "hook")[-6:]

    lock = threading.Lock()
    syncs: dict = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        key = ours(traceback.extract_stack())
        with lock:
            syncs[key] = syncs.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [{"frames": list(k), "syncs": v} for k, v in
                 sorted(syncs.items(), key=lambda kv: -kv[1])]


class _NdvSamples:
    """Counts the planner statistics' host samples while active: each
    column whose distinct count `Catalog.column_ndv` computes (not cached)
    copies a strided sample of up to 2^20 values (and its null mask) to
    the host. -> ``samples``: [(table, column, bytes)]."""

    def __enter__(self):
        from datafusion_distributed_tpu_torch.sql import context

        self.catalog = context.Catalog
        self.original = original = context.Catalog.column_ndv
        self.samples: list = []
        samples = self.samples

        def column_ndv(cat, table, column):
            t = cat.tables.get(table.lower())
            cold = (table.lower(), column) not in cat._ndv_cache
            if cold and t is not None and column in t:
                total = int(t.num_rows)
                n = min(total, 1 << 20)
                stride = max(1, total // max(n, 1))
                rows = len(range(0, total, stride)[:n])
                col = t.column(column)
                nbytes = rows * col.data.element_size() + (
                    rows if col.validity is not None else 0)
                samples.append((table, column, nbytes))
            return original(cat, table, column)

        self.catalog.column_ndv = column_ndv
        return self

    def __exit__(self, *exc):
        self.catalog.column_ndv = self.original


def coord_cpu_worker(sf: float, out_path: str) -> int:
    """The CPU's coordinated results of the 24 queries at SF ``sf``,
    static and adaptive, pickled: the coordinator phase holds the card's
    against them."""
    import torch

    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )

    torch.set_num_threads(4)
    ctx = _session("cpu", sf, SEED)
    cluster = InMemoryCluster(COORD_WORKERS)
    out = {(adaptive, q): _coordinated(ctx, sql, adaptive, cluster)[0]
           for adaptive in (False, True)
           for q, sql in _task_queries(QUERIES)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def phase_coordinator(sf: float, check_sf: float, names, seed: int) -> dict:
    """0. The device-to-host copies of COORD_D2H_TRACED by call stack.
    1. The 22 queries, S1 and S2 through collect_coordinated_table(
    num_tasks=4) over InMemoryCluster(4), with Coordinator and then
    AdaptiveCoordinator (at SF COORD_ADAPTIVE_SF), twice each: the runs byte-identical, each equal to
    the same session's collect_table (sorted rows where ORDER BY leaves
    ties). Kernel launches are counted from 0 over each coordinator's
    second run. Per query: warm seconds against single-node and against
    collect_distributed_table(4); peak device memory; overflow retries; the
    plane each exchange took; and, in each coordinator's first run and in
    one single-node run, sync calls (PyTorch's sync debug mode) and
    device-to-host bytes (the profiler's CUDA activity).
    2. q3, q5, q18 and q21 under each knob variant of COORD_KNOBS, static,
    at SF COORD_KNOB_SF: byte-identical to the default run; then with the
    planner's partial-aggregate push-down off, against the default: float
    sums at test_rtol(), everything else exactly, capacities and row
    counts included, with warm seconds and the peerless plane's measured
    exchange bytes of both.
    3. Kernels 1 and 2 at every build and probe shape the coordinated runs
    logged, bit for bit against their plain versions.
    4. At SF ``check_sf``: both coordinators on the card against the CPU
    (a subprocess that runs meanwhile)."""
    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )

    queries = _task_queries(names)
    rtol = precision.test_rtol()
    t_phase = time.perf_counter()
    cpu_out = Path(tempfile.mkdtemp()) / "coord_cpu.pkl"
    cpu_worker = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--coord-cpu-worker",
         str(check_sf), "--out", str(cpu_out)], stdout=subprocess.DEVNULL)

    ctx = _session("cuda", sf, seed)
    cut = _session("cuda", COORD_ADAPTIVE_SF, seed)
    cluster = InMemoryCluster(COORD_WORKERS)
    per_query: dict = {q: {} for q, _ in queries}

    def session(q, adaptive):
        return cut if adaptive else ctx

    runs: dict = {}
    by_mode: dict = {}
    _log_d2h_event()
    # what copies ~5 MB to the host in the first static run of q3 (and q2):
    # each query on a fresh session (cold planner statistics, as in the
    # measured run below), its synchronizing calls' stacks, the
    # statistics' samples, then the device-to-host bytes (the profiler's
    # CUDA memcpy activity) with cold statistics and once they are cached
    d2h: dict = {}
    for q, sql in _queries(COORD_D2H_TRACED):
        fresh = _session("cuda", sf, seed)
        with _NdvSamples() as ndv:
            _out, sync_stacks = _sync_stacks(
                lambda: _coordinated(fresh, sql, False, cluster)[0])
        _out, cold = _measured(lambda: _coordinated(
            _session("cuda", sf, seed), sql, False, cluster)[0])
        _out, warm = _measured(lambda: _coordinated(
            fresh, sql, False, cluster)[0])
        d2h[q] = {"sync_stacks": sync_stacks, "ndv_samples": ndv.samples,
                  "ndv_sample_bytes": sum(b for _t, _c, b in ndv.samples),
                  "cold_d2h_bytes": cold["d2h_bytes"],
                  "warm_d2h_bytes": warm["d2h_bytes"]}
        log(f"[coordinator] {q} device-to-host copies by call stack: "
            f"{d2h[q]}")
        del fresh
    for mode, adaptive in (("static", False), ("adaptive", True)):
        # run 1, measured: sync calls and device-to-host copies
        first: dict = {}
        for q, sql in queries:
            t0 = time.perf_counter()
            first[q], meas = _measured(lambda: _coordinated(
                session(q, adaptive), sql, adaptive, cluster)[0])
            per_query[q][f"{mode}_first_s"] = time.perf_counter() - t0
            per_query[q].update({f"{mode}_{k}": v for k, v in meas.items()})
        log(f"[coordinator] {mode}, measured run ({_since(t_phase)})")
        # run 2, warm: seconds, peak memory, launches counted from 0
        hk.reset_launch_counts()
        for q, sql in queries:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            warm, coord, df = _coordinated(session(q, adaptive), sql,
                                           adaptive, cluster)
            per_query[q].update({
                f"{mode}_s": time.perf_counter() - t0,
                f"{mode}_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                f"{mode}_retries": df.last_retry_count,
                f"{mode}_planes": _planes(coord)})
            if adaptive:
                per_query[q]["adaptive_decisions"] = list(
                    coord.task_count_decisions)
            check(_identical(first[q], warm), f"{q}: two {mode} "
                  "coordinated runs differ")
        launches = hk.launches()
        for k in COORD_KERNELS:
            check(launches[k] > 0, f"kernel {k} was not launched by the "
                  f"{mode} coordinator")
        builds, probes = kernel_shapes(hk, f"coordinator {mode}")
        by_mode[mode] = {"launches": launches, "build_shapes": builds,
                         "probe_shapes": probes,
                         "folds": fold_shapes(hk, f"coordinator {mode}")}
        runs[mode] = first
        warm_s = sum(v[f"{mode}_s"] for v in per_query.values())
        log(f"[coordinator] {mode}: warm {warm_s:.3f}s, launches "
            f"{launches} ({_since(t_phase)})")
    ties = []
    for q, sql in queries:
        _run(ctx, sql)  # warm
        t0 = time.perf_counter()
        single = _run(ctx, sql)
        per_query[q]["single_s"] = time.perf_counter() - t0
        _single, meas = _measured(lambda: _run(ctx, sql))
        per_query[q].update({f"single_{k}": v for k, v in meas.items()})
        for mode in ("static", "adaptive"):
            base = single
            if mode == "adaptive":
                base = _run(cut, sql)
            diff, tied = _close_or_ties(runs[mode][q], base, rtol)
            check(diff == "", f"{q}: {mode} coordinated and single-node "
                  f"results differ in {diff}")
            if tied:
                ties.append(f"{q} {mode}")
        _collect_tasks(ctx.sql(sql), COORD_TASKS)  # warm
        t0 = time.perf_counter()
        _collect_tasks(ctx.sql(sql), COORD_TASKS)
        per_query[q]["tasks_s"] = time.perf_counter() - t0
        log(f"[coordinator] {q}: {per_query[q]}")
    log(f"[coordinator] compared as sorted rows (ORDER BY ties): {ties} "
        f"({_since(t_phase)})")

    # --- 2. knob variants ---------------------------------------------------
    knobs: dict = {}
    knob_ctx = _session("cuda", COORD_KNOB_SF, seed)
    for q, sql in _queries(COORD_KNOB_QUERIES):
        default = _coordinated(knob_ctx, sql, False, cluster)[0]
        for name, opts in COORD_KNOBS.items():
            got, coord, _df = _coordinated(knob_ctx, sql, False, cluster,
                                           opts)
            check(_identical(got, default), f"{q}: {name} differs from "
                  f"the default coordinated run at SF {COORD_KNOB_SF}")
            knobs[f"{q} {name}"] = _planes(coord)
    log(f"[coordinator] knob variants byte-identical: {knobs} "
        f"({_since(t_phase)})")
    # the planner's push-down off: float sums at rtol (the partial/final
    # merge reassociates them), everything else exact, capacities included
    pushdown: dict = {}
    for q, sql in _queries(COORD_KNOB_QUERIES):
        on = _pushdown_arm(knob_ctx, sql, cluster, True)
        off = _pushdown_arm(knob_ctx, sql, cluster, False)
        diff = _close(off["result"], on["result"], rtol)
        check(diff == "", f"{q}: partial_agg_pushdown=false differs from "
              f"the default coordinated run in {diff}")
        check((off["capacity"], off["rows"]) == (on["capacity"], on["rows"]),
              f"{q}: partial_agg_pushdown=false gives capacity "
              f"{off['capacity']} and {off['rows']} rows, the default "
              f"{on['capacity']} and {on['rows']}")
        pushdown[q] = {
            arm: {k: v for k, v in r.items() if k != "result"}
            for arm, r in (("default", on), ("partial_agg_pushdown=false",
                                             off))}
        pushdown[q]["identical"] = _identical(off["result"], on["result"])
        log(f"[coordinator] {q} at SF {COORD_KNOB_SF}: {pushdown[q]}")
    del knob_ctx
    log(f"[coordinator] partial_agg_pushdown=false equals the default "
        f"({_since(t_phase)})")
    del ctx, runs, cut
    torch.cuda.empty_cache()

    # --- 3. every logged shape against the plain version -----------------
    dev = torch.device("cuda")
    all_builds = [b for m in by_mode.values() for b in m["build_shapes"]]
    all_probes = [p for m in by_mode.values() for p in m["probe_shapes"]]
    build_checks = build_shape_checks(
        list({tuple(b[:3]): b for b in all_builds}.values()), dev,
        "coordinator")
    probe_checks = probe_shape_checks(
        list({str(p[:4]): p for p in all_probes}.values()), dev,
        "coordinator")
    fold_checks = fold_shape_checks(
        {k: c for m in by_mode.values() for k, c in m["folds"].items()}, dev,
        "coordinator")
    log(f"[coordinator] shapes checked ({_since(t_phase)})")

    # --- 4. card against CPU ----------------------------------------------
    gpu = _session("cuda", check_sf, seed)
    small = InMemoryCluster(COORD_WORKERS)
    check(cpu_worker.wait(timeout=COORD_CPU_TIMEOUT_S) == 0,
          f"the CPU worker exited {cpu_worker.returncode}")
    with open(cpu_out, "rb") as f:
        cpu_results = pickle.load(f)
    identical = 0
    for adaptive in (False, True):
        for q, sql in queries:
            a = _coordinated(gpu, sql, adaptive, small)[0]
            diff = _close(a, cpu_results[(adaptive, q)], rtol)
            check(diff == "", f"{q} adaptive={adaptive}: cuda and cpu "
                  f"differ in {diff}")
            identical += _identical(a, cpu_results[(adaptive, q)])
    log(f"[coordinator] SF {check_sf}: {len(queries)} queries equal on cuda "
        f"and cpu, static and adaptive, {identical} of {2 * len(queries)} "
        f"byte for byte ({_since(t_phase)})")

    def total(key):
        return sum(v[key] for v in per_query.values())

    return {
        "queries": per_query, "ties": ties, "knobs": knobs, "d2h": d2h,
        "pushdown": pushdown,
        "adaptive_sf": COORD_ADAPTIVE_SF,
        "launches": by_mode["static"]["launches"],
        "adaptive_launches": by_mode["adaptive"]["launches"],
        "build_shapes": by_mode["static"]["build_shapes"],
        "probe_shapes": by_mode["static"]["probe_shapes"],
        "adaptive_build_shapes": by_mode["adaptive"]["build_shapes"],
        "adaptive_probe_shapes": by_mode["adaptive"]["probe_shapes"],
        "kernel_checks": {"build_group_ids": build_checks,
                          "multiway_probe": probe_checks,
                          "group_fold": fold_checks},
        "card_cpu_identical": identical,
        "summary": {
            k: total(k) for k in (
                "static_s", "adaptive_s", "single_s", "tasks_s",
                "static_sync_calls", "adaptive_sync_calls",
                "single_sync_calls", "single_d2h_bytes", "static_d2h_bytes",
                "adaptive_d2h_bytes", "static_d2h_copies",
                "adaptive_d2h_copies", "static_retries",
                "adaptive_retries")},
        "peak_gb": max(max(v["static_peak_gb"], v["adaptive_peak_gb"])
                       for v in per_query.values()),
    }


# ---------------------------------------------------------------------------
# phase 11: the serving tier
# ---------------------------------------------------------------------------

SERVING_WORKERS = 4
SERVING_TASKS = 4
#: the closed loop (the JAX package's serving bench, bench.py): 8 clients,
#: 2 queries each; client 0 runs the heavy query, the others alternate
#: the cheap ones
SERVING_CLIENTS = 8
SERVING_ITERS = 2
SERVING_HEAVY = "q21"
SERVING_CHEAP = ("q1", "q6")
SERVING_ARMS = {
    "serialized": {"max_concurrent_queries": 1, "fair_share": True},
    "fifo": {"max_concurrent_queries": SERVING_CLIENTS, "fair_share": False},
    "fair_share": {"max_concurrent_queries": SERVING_CLIENTS,
                   "fair_share": True},
}
#: the result-cache arms: open-loop Poisson arrivals of q1 and three q6
#: discount variants, the same seeded workload with the cache off and on
SERVING_BURST_QUERIES = 32
SERVING_BURST_QPS = 10.0
SERVING_BURST_SEED = 11
SERVING_Q6_BINDINGS = ({"qty": 24, "lo": 0.05, "hi": 0.07},
                       {"qty": 30, "lo": 0.02, "hi": 0.09},
                       {"qty": 10, "lo": 0.04, "hi": 0.06})
#: (with q21 beside q18, 3.5 GB spilled in 20 s of the phase; the budget,
#: half q18's peak, is the same without it, and the time went to the leak
#: arms)
SERVING_BUDGET_QUERIES = ("q18",)
SERVING_SOLO = ("q1", "q6", "q21", "q3", "q18")
SERVING_CHECK_QUERIES = ("q1", "q3", "q6", "q18", "q21")
#: a handle that does not resolve within this many seconds fails the phase
SERVING_TIMEOUT_S = 300
SERVING_CPU_TIMEOUT_S = 600


def _pct_ms(walls, q: float):
    """The q-th percentile of wall seconds in ms (serving.percentile_ms's
    index rule, unrounded); None if empty."""
    if not walls:
        return None
    v = sorted(walls)
    return v[min(int(q * len(v)), len(v) - 1)] * 1e3


def _serving_leaks(cluster, what: str) -> None:
    """Every worker's store and task registry empty, no spill file."""
    for w in cluster.workers.values():
        st = w.table_store.stats()
        check(not w.table_store.tables and len(w.registry) == 0
              and st["spill_files"] == 0,
              f"{what}: worker {w.url} kept {st['entries']} staged "
              f"tables, {len(w.registry)} tasks, {st['spill_files']} "
              "spill files")


def _reset_staged_peaks(cluster) -> None:
    for w in cluster.workers.values():
        w.table_store.reset_peak()


def _staged_peaks(cluster) -> dict:
    peaks = [w.table_store.stats()["peak_nbytes"]
             for w in cluster.workers.values()]
    return {"max_worker": max(peaks), "sum_workers": sum(peaks)}


def _served(h) -> dict:
    """A resolved handle's table as numpy (a handle that times out or
    failed raises here, failing the phase)."""
    import torch

    table = h.result_table(timeout=SERVING_TIMEOUT_S)
    check(table.device.type == "cuda",
          f"a served query ran on {table.device}")
    out = table.to_numpy()
    torch.cuda.synchronize()
    return out


def _closed_loop(ctx, cluster, sqls: dict, arm: dict, seed: int) -> dict:
    """One closed-loop arm: SERVING_CLIENTS threads, each submitting its
    workload one query at a time and waiting for each result. -> the
    arm's numbers and its (query, handle, table) records."""
    import threading

    import torch

    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )

    def workload(ci):
        if ci == 0:
            return [SERVING_HEAVY] * SERVING_ITERS
        return [SERVING_CHEAP[(ci + i) % 2] for i in range(SERVING_ITERS)]

    records: list = []
    errors: list = []
    lock = threading.Lock()
    _reset_staged_peaks(cluster)
    torch.cuda.reset_peak_memory_stats()
    srv = ServingSession(ctx, cluster=cluster, num_tasks=SERVING_TASKS,
                         seed=seed, **arm)

    def client(ci):
        try:
            for q in workload(ci):
                h = srv.submit(sqls[q])
                table = h.result_table(timeout=SERVING_TIMEOUT_S)
                with lock:
                    records.append((ci, q, h, table))
        except BaseException as e:  # noqa: BLE001 - checked below
            with lock:
                errors.append(f"client {ci}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(SERVING_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVING_TIMEOUT_S * SERVING_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = srv.stats()
    srv.close(timeout=SERVING_TIMEOUT_S)
    check(not errors, f"closed loop {arm}: {errors}")
    check(not any(t.is_alive() for t in threads),
          f"closed loop {arm}: a client hung")
    n = SERVING_CLIENTS * SERVING_ITERS
    check(len(records) == n, f"closed loop {arm}: {len(records)} of {n}")
    cheap = [h.finished_s - h.submitted_s for ci, _q, h, _t in records
             if ci != 0]
    heavy = [h.finished_s - h.submitted_s for ci, _q, h, _t in records
             if ci == 0]
    waits = [h.queue_wait_s() for _ci, _q, h, _t in records]
    return {
        "records": records,
        "wall_s": wall, "queries": n, "qps": n / wall,
        "cheap_p50_ms": _pct_ms(cheap, 0.50),
        "cheap_p99_ms": _pct_ms(cheap, 0.99),
        "heavy_p50_ms": _pct_ms(heavy, 0.50),
        "heavy_p99_ms": _pct_ms(heavy, 0.99),
        "queue_wait_mean_ms": 1e3 * sum(waits) / len(waits),
        "queue_wait_max_ms": 1e3 * max(waits),
        "peak_staged_bytes": _staged_peaks(cluster),
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "scheduler_peak_in_flight": stats["scheduler"]["peak_in_flight"],
    }


def _burst(ctx, cluster, mix: list, cache_on: bool) -> dict:
    """The open-loop arm: SERVING_BURST_QUERIES Poisson arrivals (seeded)
    of ``mix``, the result cache off or on. -> numbers, and the variant
    index and table of every submission in arrival order."""
    import random

    import torch

    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )

    opts = ctx.config.distributed_options
    opts["result_cache"] = cache_on
    rng = random.Random(SERVING_BURST_SEED)
    workload = [rng.randrange(len(mix)) for _ in range(SERVING_BURST_QUERIES)]
    srv = ServingSession(ctx, cluster=cluster, num_tasks=SERVING_TASKS,
                         max_concurrent_queries=SERVING_CLIENTS,
                         fair_share=True)
    handles = []
    t0 = time.perf_counter()
    try:
        for i in workload:
            handles.append((i, srv.submit(mix[i])))
            time.sleep(rng.expovariate(SERVING_BURST_QPS))
        tables = [(i, h.result_table(timeout=SERVING_TIMEOUT_S))
                  for i, h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rc = (srv.stats().get("result_cache") or {}) if cache_on else {}
    finally:
        srv.close(timeout=SERVING_TIMEOUT_S)
        opts.pop("result_cache", None)
    walls = [h.finished_s - h.submitted_s for _i, h in handles]
    return {
        "tables": tables,
        "wall_s": wall, "queries": len(handles),
        "p50_ms": _pct_ms(walls, 0.50), "p99_ms": _pct_ms(walls, 0.99),
        "hit_rate": rc.get("hit_rate"), "hits": rc.get("hits"),
        "misses": rc.get("misses"), "fills": rc.get("fills"),
        "cache_hits_fast_path": sum(h._cache_hit for _i, h in handles),
    }


def serving_cpu_worker(sf: float, out_path: str) -> int:
    """The CPU's served results of SERVING_CHECK_QUERIES at SF ``sf``,
    submitted at once to one ServingSession over InMemoryCluster(4),
    pickled: the serving phase holds the card's against them."""
    import torch

    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )

    torch.set_num_threads(4)
    ctx = _session("cpu", sf, SEED)
    sqls = dict(_queries(SERVING_CHECK_QUERIES))
    with ServingSession(ctx, cluster=InMemoryCluster(SERVING_WORKERS),
                        num_tasks=SERVING_TASKS) as srv:
        handles = {q: srv.submit(s) for q, s in sqls.items()}
        out = {q: h.result_table(timeout=SERVING_TIMEOUT_S).to_numpy()
               for q, h in handles.items()}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def phase_serving(sf: float, check_sf: float, seed: int) -> dict:
    """The serving tier on the card: TPC-H SF ``sf`` through
    ServingSession(ctx, cluster=InMemoryCluster(4), num_tasks=4).

    1. Each query of SERVING_SOLO through
    collect_coordinated_table(num_tasks=4) (the byte-identity baseline),
    then served alone: its admission estimate, measured peak staged bytes
    and the allocator's peak.
    2. The closed loop in three arms (serialized, FIFO, fair share):
    queries/s, p50 and p99 of the cheap and the heavy queries, queue wait,
    peak staged bytes, peak device memory; every result byte-identical to
    its baseline; no staged slice left. Launches are counted from 0 over
    the fair-share arm.
    3. The result cache: the same seeded open-loop workload with the
    cache off and on (hit rate, p50, p99); a hit returns the cold run's
    table itself; every result byte-identical to the cache-off run of its
    variant. A prepared q6 through PreparedStatement.submit, three
    bindings, each equal to its execute().
    4. SERVING_BUDGET_QUERIES under a worker memory budget of half the
    smaller of their unconstrained peak staged bytes: spill engages
    (count, bytes),
    results byte-identical, no spill file and no staged slice left.
    5. q3 killed at its root stage with a CheckpointStore, then recover()
    on a fresh ServingSession over the same workers: stages restore, the
    result equals q3's, the store drains to 0 staged bytes.
    6. Kernels 1 and 2 at every build and probe shape the phase logged,
    bit for bit against their plain versions.
    7. At SF ``check_sf`` SERVING_CHECK_QUERIES served on the card against
    the CPU (a subprocess that runs meanwhile).
    (The served mix runs with the leak harness armed in the resilience
    phase's `leak_arms`.)"""
    cpu_out = Path(tempfile.mkdtemp()) / "serving_cpu.pkl"
    cpu_worker = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--serving-cpu-worker", str(check_sf), "--out", str(cpu_out)],
        stdout=subprocess.DEVNULL)
    try:
        return _serving_phase(sf, check_sf, seed, cpu_worker, cpu_out)
    finally:
        if cpu_worker.poll() is None:
            cpu_worker.kill()
            cpu_worker.wait()


def _serving_phase(sf, check_sf, seed, cpu_worker, cpu_out) -> dict:
    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.runtime import chaos
    from datafusion_distributed_tpu_torch.runtime.checkpoint import (
        CheckpointStore,
    )
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )

    rtol = precision.test_rtol()
    t_phase = time.perf_counter()
    out: dict = {}
    ctx = _session("cuda", sf, seed)
    sqls = dict(_queries(sorted(set(SERVING_SOLO) | {"q3"})))
    hk.reset_launch_counts()
    shapes_before: dict = {"build": {}, "probe": {}, "fold": {}}

    # --- 1. baselines, and each query served alone ------------------------
    base: dict = {}
    solo: dict = {}
    cluster = InMemoryCluster(SERVING_WORKERS)
    for q in SERVING_SOLO:
        base[q], _coord, _df = _coordinated(ctx, sqls[q], False, cluster)
    with ServingSession(ctx, cluster=cluster, num_tasks=SERVING_TASKS,
                        max_concurrent_queries=1) as srv:
        for q in SERVING_SOLO:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            h = srv.submit(sqls[q])
            got = _served(h)
            solo[q] = {"s": time.perf_counter() - t0,
                       "est_bytes": h.est_bytes,
                       "peak_staged_bytes": h.peak_staged_bytes,
                       "max_memory_allocated_gb":
                           torch.cuda.max_memory_allocated() / 1e9}
            check(_identical(got, base[q]),
                  f"{q}: served alone differs from collect_coordinated_table")
    _serving_leaks(cluster, "solo")
    out["solo"] = solo
    log(f"[serving] solo: {solo} ({_since(t_phase)})")

    # --- 2. closed loop ---------------------------------------------------
    arms: dict = {}
    for name, arm in SERVING_ARMS.items():
        if name == "fair_share":
            shapes_before = {"build": dict(hk.BUILD_SHAPES),
                             "probe": dict(hk.PROBE_SHAPES),
                             "fold": dict(hk.FOLD_SHAPES)}
            hk.reset_launch_counts()
        r = _closed_loop(ctx, cluster, sqls, arm, seed)
        if name == "fair_share":
            out["launches"] = hk.launches()
        for _ci, q, _h, table in r.pop("records"):
            check(_identical(table.to_numpy(), base[q]),
                  f"{q} in the {name} arm differs from its sequential run")
        _serving_leaks(cluster, f"the {name} arm")
        arms[name] = r
        log(f"[serving] {name}: {r} ({_since(t_phase)})")
    out["closed_loop"] = arms
    for k in ("build_group_ids", "multiway_probe"):
        check(out["launches"][k] > 0,
              f"kernel {k} was not launched by the served queries")

    # --- 3. result cache, prepared statements ---------------------------
    q6 = sqls["q6"]
    check("between 0.05 and 0.07" in q6, "q6's discount range moved")
    mix = [sqls["q1"]] + [q6.replace("between 0.05", f"between 0.0{d}")
                          for d in (4, 5, 6)]
    burst_off = _burst(ctx, cluster, mix, cache_on=False)
    burst_on = _burst(ctx, cluster, mix, cache_on=True)
    cold: dict = {}
    first_on: dict = {}
    for i, table in burst_off.pop("tables"):
        cold.setdefault(i, table.to_numpy())
        check(_identical(table.to_numpy(), cold[i]),
              f"variant {i}: two cache-off runs differ")
    for i, table in burst_on.pop("tables"):
        first_on.setdefault(i, table)
        check(table is first_on[i], f"variant {i}: a cache hit did not "
              "return the cold run's table")
        check(_identical(table.to_numpy(), cold[i]),
              f"variant {i}: cached result differs from the cache-off run")
    variants = [cold[i]["revenue"].tobytes() for i in sorted(cold) if i]
    check(len(set(variants)) == len(variants),
          "two q6 discount variants gave the same rows")
    check(_identical(cold[0], base["q1"]), "q1 in the burst differs")
    check(burst_on["hits"] and burst_on["hit_rate"] > 0,
          f"no result-cache hit: {burst_on}")
    rc = ctx._result_cache
    if rc is not None:
        rc.clear()
    _serving_leaks(cluster, "the result-cache arms")
    out["cache"] = {"off": burst_off, "on": burst_on}
    log(f"[serving] result cache off {burst_off}, on {burst_on} "
        f"({_since(t_phase)})")
    template = (q6.replace("< 24", "< $qty")
                .replace("between 0.05 and 0.07", "between $lo and $hi"))
    stmt = ctx.prepare(template)
    prepared = []
    with ServingSession(ctx, cluster=cluster, num_tasks=SERVING_TASKS) as srv:
        handles = [stmt.submit(srv, b) for b in SERVING_Q6_BINDINGS]
        for b, h in zip(SERVING_Q6_BINDINGS, handles):
            got = h.result(timeout=SERVING_TIMEOUT_S)
            want = stmt.execute(b)
            diff = _close({c: got.column(c).to_numpy() for c in got.schema.names},
                          {c: want.column(c).to_numpy()
                           for c in want.schema.names}, rtol)
            check(diff == "", f"prepared q6 {b}: submit and execute "
                  f"differ in {diff}")
            prepared.append(float(got.column("revenue")[0].as_py()))
    check(len(set(prepared)) == 3, f"prepared bindings {prepared}")
    _serving_leaks(cluster, "prepared q6")
    out["prepared_q6"] = prepared

    # --- 4. a worker memory budget ----------------------------------------
    budget_cluster = InMemoryCluster(SERVING_WORKERS)
    peaks = {}
    for q in SERVING_BUDGET_QUERIES:
        _reset_staged_peaks(budget_cluster)
        with ServingSession(ctx, cluster=budget_cluster,
                            num_tasks=SERVING_TASKS) as srv:
            check(_identical(_served(srv.submit(sqls[q])), base[q]),
                  f"{q}: unconstrained served run differs")
        peaks[q] = _staged_peaks(budget_cluster)["max_worker"]
    budget = min(peaks.values()) // 2
    opts = ctx.config.distributed_options
    opts["worker_memory_budget_bytes"] = budget
    opts["worker_memory_redline"] = 0  # spill only: no load shedding
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with ServingSession(ctx, cluster=budget_cluster,
                            num_tasks=SERVING_TASKS) as srv:
            handles = {q: srv.submit(sqls[q]) for q in SERVING_BUDGET_QUERIES}
            for q, h in handles.items():
                check(_identical(_served(h), base[q]),
                      f"{q} under a {budget} B worker budget differs")
            mem = srv.stats()["memory"]["workers"]
    finally:
        opts.pop("worker_memory_budget_bytes", None)
        opts.pop("worker_memory_redline", None)
    spill = {k: sum(w.table_store.stats()[k]
                    for w in budget_cluster.workers.values())
             for k in ("spills", "refaults", "spilled_total_bytes",
                       "refaulted_total_bytes")}
    check(spill["spills"] > 0, f"a {budget} B budget spilled nothing")
    for w in budget_cluster.workers.values():
        w.table_store.set_budget(0)
    _serving_leaks(budget_cluster, "the budget run")
    out["budget"] = {"unconstrained_peak_bytes": peaks, "budget_bytes": budget,
                     "s": time.perf_counter() - t0, **spill,
                     "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "workers": mem}
    log(f"[serving] budget: {out['budget']} ({_since(t_phase)})")

    # --- 5. recover -------------------------------------------------------
    store = CheckpointStore()
    opts.update(max_task_retries=0, peer_shuffle=False)
    try:
        crashing = chaos.wrap_cluster(cluster, chaos.FaultPlan(seed, [
            chaos.FaultSpec(site="execute", kind="crash", stages=[-1],
                            rate=1.0, max_total=1)]))
        srv1 = ServingSession(ctx, cluster=crashing, num_tasks=SERVING_TASKS,
                              checkpoints=store)
        h1 = srv1.submit(sqls["q3"])
        failed = False
        try:
            h1.result_table(timeout=SERVING_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 - the injected crash
            failed = "injected worker crash" in str(e)
        srv1.close(timeout=SERVING_TIMEOUT_S)
        check(failed, "q3 did not fail at its root stage")
        saved = store.stats()
        check(saved["recoverable"] == 1 and saved["stages"] >= 1,
              f"nothing checkpointed: {saved}")
        opts.pop("max_task_retries", None)
        srv2 = ServingSession(ctx, cluster=cluster, num_tasks=SERVING_TASKS,
                              checkpoints=store)
        handles = srv2.recover()
        check(len(handles) == 1, f"recover() gave {len(handles)} handles")
        got = _served(handles[0])
        faults = srv2.faults.as_dict()
        srv2.close(timeout=SERVING_TIMEOUT_S)
    finally:
        opts.pop("max_task_retries", None)
        opts.pop("peer_shuffle", None)
    check(faults.get("checkpoint_stages_restored", 0) >= 1,
          f"recover() restored no stage: {faults}")
    check(_identical(got, base["q3"]), "recovered q3 differs from q3")
    drained = store.stats()
    check(drained["staged_bytes"] == 0 and drained["recoverable"] == 0,
          f"the checkpoint store kept {drained}")
    _serving_leaks(cluster, "recover")
    out["recover"] = {"saved": saved, "faults": faults, "drained": drained}
    log(f"[serving] recover: {out['recover']} ({_since(t_phase)})")
    del ctx
    torch.cuda.empty_cache()

    # --- 6. every logged shape against the plain version ----------------
    builds = dict(shapes_before["build"])
    for k, c in hk.BUILD_SHAPES.items():
        builds[k] = builds.get(k, 0) + c
    probes = dict(shapes_before["probe"])
    for k, c in hk.PROBE_SHAPES.items():
        probes[k] = probes.get(k, 0) + c
    folds = {**shapes_before["fold"], **hk.FOLD_SHAPES}
    dev = torch.device("cuda")
    out["kernel_checks"] = {
        "build_group_ids": build_shape_checks(
            [[n, lanes, h, c] for (n, lanes, h), c in builds.items()], dev,
            "serving"),
        "multiway_probe": probe_shape_checks(
            [[n, k, lanes, list(s), c] for (n, k, lanes, s), c
             in probes.items()], dev, "serving"),
        "group_fold": fold_shape_checks(folds, dev, "serving"),
    }
    out["build_shapes"] = len(builds)
    out["probe_shapes"] = len(probes)
    log(f"[serving] {len(builds)} build and {len(probes)} probe shapes "
        f"checked ({_since(t_phase)})")

    # --- 7. card against CPU ------------------------------------------------
    gpu = _session("cuda", check_sf, seed)
    with ServingSession(gpu, cluster=InMemoryCluster(SERVING_WORKERS),
                        num_tasks=SERVING_TASKS) as srv:
        handles = {q: srv.submit(s)
                   for q, s in _queries(SERVING_CHECK_QUERIES)}
        card = {q: _served(h) for q, h in handles.items()}
    check(cpu_worker.wait(timeout=SERVING_CPU_TIMEOUT_S) == 0,
          f"the CPU worker exited {cpu_worker.returncode}")
    with open(cpu_out, "rb") as f:
        cpu_results = pickle.load(f)
    identical = 0
    for q in SERVING_CHECK_QUERIES:
        diff = _close(card[q], cpu_results[q], rtol)
        check(diff == "", f"{q} served: cuda and cpu differ in {diff}")
        identical += _identical(card[q], cpu_results[q])
    out["card_cpu_identical"] = identical
    log(f"[serving] SF {check_sf}: {len(SERVING_CHECK_QUERIES)} served "
        f"queries equal on cuda and cpu, {identical} byte for byte "
        f"({_since(t_phase)})")
    return out


# ---------------------------------------------------------------------------
# phase 12: straggler hedging, elastic membership and the observability
# service
# ---------------------------------------------------------------------------

RESILIENCE_WORKERS = 4
RESILIENCE_TASKS = 4
#: (q1 and q5 in the four arms took ~20 s of the phase, which went to the
#: leak arms, and q21 ~24 s, which went to the adaptive phase; the
#: straggler costs them the same 2 s as q3 and q18)
RESILIENCE_HEDGE_QUERIES = ("q3", "q9", "q18")
#: the worker-pinned sticky straggler the hedger exists for
RESILIENCE_STRAGGLER = {"site": "execute", "kind": "straggler",
                        "delay_s": 2.0, "rate": 1.0,
                        "workers": ["mem://worker-1"]}
RESILIENCE_HEDGE_KNOBS = {"hedging": True, "hedge_floor_s": 0.25,
                          "hedge_budget": 2}
#: arm -> (the straggler injected, coordinator options); both hedged arms
#: take the same knobs, so the no-fault pair shows what hedging costs
RESILIENCE_ARMS = {
    "no_fault_off": (False, {}),
    "no_fault_on": (False, RESILIENCE_HEDGE_KNOBS),
    "straggler_off": (True, {}),
    "straggler_on": (True, RESILIENCE_HEDGE_KNOBS),
}
#: transport faults beside the membership churn (tests/test_elasticity.py's
#: heavier sweep), retried up to RESILIENCE_CHURN_RETRIES times
RESILIENCE_CHURN_FAULTS = (
    {"site": "execute", "kind": "transport", "rate": 0.1},
    {"site": "set_plan", "kind": "transport", "rate": 0.05},
)
RESILIENCE_CHURN_RETRIES = 8
#: tests/test_serving.py's chaos-and-churn mix
#: the queries churned one by one: the five- and six-way joins and the
#: anti-join of the hedging arms' mix, whose no-churn runs the hedging
#: step already made, and in which the schedule fires all three
#: membership kinds (churning all 22 took 32.5 s of the phase on the
#: card; the time went to the spmd phase; q21, ~10 s with its no-churn run
#: once it left the hedging mix, went to the adaptive phase)
RESILIENCE_CHURN_QUERIES = ("q3", "q9")
RESILIENCE_SERVED = ("q1", "q6", "q3", "q6", "q1", "q3")
RESILIENCE_CPU_TIMEOUT_S = 600
#: the membership kinds the churn schedule fires when a query makes enough
#: calls (a query of few stages ends before the join's or the drain's turn)
CHURN_KINDS = ["membership_drain", "membership_join", "membership_leave"]


def _churn_schedule(chaos, urls):
    """tests/test_elasticity.py's schedule: a leave at the first execute, a
    join at the fifth set_plan, a drain at the fourth execute."""
    return [
        chaos.MembershipEvent("leave", urls[1], site="execute", nth_call=0),
        chaos.MembershipEvent("join", "mem://joiner-0", site="set_plan",
                              nth_call=4),
        chaos.MembershipEvent("drain", urls[2], site="execute", nth_call=3),
    ]


def _churned(ctx, sql: str, seed: int) -> dict:
    """``sql`` over a fresh DynamicCluster(4) under the churn schedule and
    transport faults. -> the result, the fired kinds, the counters, the
    drain verdict; no surviving worker may keep a staged slice or task."""
    from datafusion_distributed_tpu_torch.runtime import chaos
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        DynamicCluster,
    )

    cluster = DynamicCluster(RESILIENCE_WORKERS)
    urls = cluster.get_urls()
    plan = chaos.FaultPlan(seed, [
        chaos.FaultSpec(**s) for s in RESILIENCE_CHURN_FAULTS],
        membership=_churn_schedule(chaos, urls))
    out, coord, _df = _coordinated(
        ctx, sql, False, chaos.wrap_cluster(cluster, plan),
        {"max_task_retries": RESILIENCE_CHURN_RETRIES})
    faults = coord.faults.as_dict()
    fired = sorted(f["kind"] for f in plan.fired)
    drained = ("membership_drain" not in fired
               or cluster.wait_drained(urls[2], timeout_s=10.0))
    return {"result": out, "drained": drained,
            "kinds": sorted({k for k in fired if k.startswith("membership")}),
            "fired": fired,
            "reshipped": faults.get("peer_producers_reshipped", 0),
            "refreshed": faults.get("peer_producers_refreshed", 0),
            "retries": faults.get("task_retries", 0),
            "leaked": sum(len(w.table_store.tables) + len(w.registry)
                          for w in cluster.workers.values())}


def _hedge_arm(ctx, seed: int, straggler: bool, opts: dict):
    """One coordinator over DynamicCluster(4), with the sticky straggler on
    worker-1 or not: its latency sketch, hedge budget and breakers carry
    from query to query, as a long-lived coordinator's do. -> a function
    running one query on it -> its result."""
    from datafusion_distributed_tpu_torch.runtime import chaos
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
        DynamicCluster,
    )

    cluster = DynamicCluster(RESILIENCE_WORKERS)
    if straggler:
        cluster = chaos.wrap_cluster(cluster, chaos.FaultPlan(
            seed, [chaos.FaultSpec(**RESILIENCE_STRAGGLER)]))
    coord = Coordinator(resolver=cluster, channels=cluster, config_options={
        **ctx.config.distributed_snapshot(), **opts})

    def run(sql: str) -> dict:
        return _coordinated(ctx, sql, False, cluster, coord=coord)[0]

    run.coord = coord
    return run


def _fanned_session(device: str, sf: float, seed: int):
    """A session whose stages fan out over every task at a small scale
    (`bytes_per_task = 1`), so churn and the straggler reach them."""
    ctx = _session(device, sf, seed)
    ctx.config.distributed_options["bytes_per_task"] = 1
    return ctx


#: the arms that run with the port's leak harness armed through its switch
#: (DFTPU_LEAK_CHECK=strict: a tracked resource alive at its query's end
#: raises) and unarmed (=0), each setting in a subprocess of its own, since
#: the package arms the harness at import: the serving tier's served mix
#: (RESILIENCE_SERVED), and the churn and straggler-with-hedging arms of
#: this phase, each cold then warm, at this scale (the subprocess generates
#: its own tables). One pair of subprocesses runs all three: a pair takes
#: ~36 s on the card, most of it process start and table generation.
LEAK_SF = 0.1
LEAK_QUERY = "q3"  # the churned and the hedged query
LEAK_ARMS = ("served", "churn", "hedging")
LEAK_TIMEOUT_S = 300


def leakcheck_worker(out_path: str) -> int:
    """The arms of LEAK_ARMS on the card at SF LEAK_SF, cold then
    warm, each result equal to single-node, under whatever DFTPU_LEAK_CHECK
    the environment sets (the package arms the harness at import). Writes
    the walls, the survivors the harness swept and what it tracked as JSON;
    under strict a survivor raises at its query's end and fails the
    worker."""
    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.runtime import leakcheck
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )

    mode = os.environ.get("DFTPU_LEAK_CHECK", "0")
    check(leakcheck.enabled() == (mode not in ("", "0")),
          f"DFTPU_LEAK_CHECK={mode}: harness installed "
          f"{leakcheck.enabled()}")
    check(leakcheck.strict() == (mode.lower() == "strict"),
          f"DFTPU_LEAK_CHECK={mode}: strict {leakcheck.strict()}")
    rtol = precision.test_rtol()
    ctx = _fanned_session("cuda", LEAK_SF, SEED)
    sqls = dict(_queries(sorted(set(RESILIENCE_SERVED) | {LEAK_QUERY})))
    want = {q: _run(ctx, sql) for q, sql in sqls.items()}

    def served() -> list:
        cluster = InMemoryCluster(RESILIENCE_WORKERS)
        with ServingSession(ctx, cluster=cluster,
                            num_tasks=RESILIENCE_TASKS) as srv:
            handles = [(q, srv.submit(sqls[q])) for q in RESILIENCE_SERVED]
            got = [(q, _served(h)) for q, h in handles]
        _serving_leaks(cluster, "the served leak arm")
        return got

    def churn() -> list:
        r = _churned(ctx, sqls[LEAK_QUERY], SEED)
        check(r["leaked"] == 0 and r["drained"],
              f"churned {LEAK_QUERY}: {r['leaked']} staged entries left, "
              f"drained {r['drained']}")
        return [(LEAK_QUERY, r["result"])]

    hedged = _hedge_arm(ctx, SEED, True, RESILIENCE_HEDGE_KNOBS)

    def hedging() -> list:
        return [(LEAK_QUERY, hedged(sqls[LEAK_QUERY]))]

    arms = {"served": served, "churn": churn, "hedging": hedging}
    out: dict = {"mode": mode, "installed": leakcheck.enabled(),
                 "strict": leakcheck.strict(), "sf": LEAK_SF, "arms": {}}
    for arm in LEAK_ARMS:
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = arms[arm]()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            for q, g in got:
                diff, _tied = _close_or_ties(g, want[q], rtol)
                check(diff == "", f"{arm} {q} differs from single-node in "
                      f"{diff}")
        out["arms"][arm] = {"cold_s": walls[0], "warm_s": walls[1],
                            "queries": len(got)}
    faults = hedged.coord.faults.as_dict()
    check(faults.get("hedges_issued", 0) >= 1,
          f"the hedged leak arm issued no hedge: {faults}")
    rep = leakcheck.report(include_static=False)
    out.update(
        swept=len(rep["leaks"]),
        live_attributed=sum(1 for r in rep["live"]
                            if r["query_id"] is not None),
        live=len(rep["live"]), counts=rep["counts"],
        unmatched_releases=rep["unmatched_releases"])
    check(out["swept"] == 0 and out["live_attributed"] == 0,
          f"the leak harness swept {out['swept']} survivors and still "
          f"tracks {out['live_attributed']} resources of finished queries")
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def _side_by_side(runs: dict, timeout_s: float) -> dict:
    """This script once for each entry of ``runs`` (name -> (its
    arguments, its environment)), all started at once, each writing JSON
    to the ``--out`` it is given: -> name -> that JSON and the process's
    wall seconds (``process_s``). One that fails or outlasts
    ``timeout_s`` fails the phase; none is left running."""
    procs = {}
    try:
        for name, (args, env) in runs.items():
            out_path = Path(tempfile.mkdtemp()) / "worker.json"
            t0 = time.perf_counter()
            procs[name] = (out_path, t0, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), *args,
                 "--out", str(out_path)],
                stdout=subprocess.DEVNULL, env=env))
        deadline = time.perf_counter() + timeout_s
        walls: dict = {}
        while len(walls) < len(procs):
            check(time.perf_counter() < deadline,
                  f"{sorted(set(procs) - set(walls))} outlasted {timeout_s} s")
            for name, (_out_path, t0, proc) in procs.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            time.sleep(0.05)
        out = {}
        for name, (out_path, _t0, proc) in procs.items():
            check(proc.returncode == 0,
                  f"{runs[name][0]} ({name}) exited {proc.returncode}")
            out[name] = {**json.loads(out_path.read_text()),
                         "process_s": walls[name]}
        return out
    finally:
        for _out_path, _t0, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def leak_arms() -> dict:
    """LEAK_ARMS in a subprocess unarmed (DFTPU_LEAK_CHECK=0) and, at the
    same time, in one armed strict: -> both reports and the harness's
    cost, the armed warm seconds over the unarmed ones, per arm. A
    survivor, a wrong result or a subprocess that fails fails the phase."""
    runs = {}
    for mode in ("0", "strict"):
        env = dict(os.environ, DFTPU_LEAK_CHECK=mode)
        env.pop("DFTPU_LEAK_CHECK_ARTIFACT", None)
        runs[mode] = (["--leakcheck-worker"], env)
    runs = _side_by_side(runs, LEAK_TIMEOUT_S)
    armed, plain = runs["strict"], runs["0"]
    check(armed["installed"] and armed["strict"] and not plain["installed"],
          f"the switch: armed {armed['installed']}/{armed['strict']}, "
          f"unarmed {plain['installed']}")
    cost = {arm: armed["arms"][arm]["warm_s"] / plain["arms"][arm]["warm_s"]
            for arm in armed["arms"]}
    log(f"[resilience] leak harness armed (DFTPU_LEAK_CHECK=strict) against "
        f"unarmed at SF {LEAK_SF}: swept {armed['swept']} survivors, "
        f"tracked {armed['counts']}; warm armed/unarmed {cost}; "
        f"armed {armed['arms']}, unarmed {plain['arms']}")
    return {"armed": armed, "unarmed": plain, "cost": cost,
            "swept": armed["swept"]}


def resilience_cpu_worker(sf: float, out_path: str) -> int:
    """The CPU's side of the resilience phase's card-against-CPU check at
    SF ``sf``: q3 under the churn schedule (with its fired membership
    kinds) and q1 in the hedged straggler arm (with its hedges issued),
    pickled."""
    import torch

    torch.set_num_threads(4)
    ctx = _fanned_session("cpu", sf, SEED)
    sqls = dict(_queries(("q1", "q3")))
    churn = _churned(ctx, sqls["q3"], SEED)
    hedged = _hedge_arm(ctx, SEED, True, RESILIENCE_HEDGE_KNOBS)
    out = {"q3": (churn["result"], churn["kinds"]),
           "q1": (hedged(sqls["q1"]),
                  hedged.coord.faults.get("hedges_issued"))}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def _tracked_live() -> int:
    """Resources the leak checker (runtime/leakcheck.py) still tracks:
    staged slices, spill slots, checkpoint slices, stream pullers."""
    from datafusion_distributed_tpu_torch.runtime import leakcheck

    return len(leakcheck.live())


def _drain_shapes(hk, acc: dict) -> None:
    """Add the kernels' logged shapes to ``acc`` and set the counts to 0."""
    for name, shapes in (("build", hk.BUILD_SHAPES), ("probe", hk.PROBE_SHAPES),
                         ("agg", hk.AGG_SHAPES), ("fold", hk.FOLD_SHAPES)):
        for k, c in shapes.items():
            acc[name][k] = acc[name].get(k, 0) + c
    hk.reset_launch_counts()


def agg_shape_checks(agg_shapes, dev, tag: str) -> dict:
    """Kernel 3 at every shape a run logged ((rows, int32 lanes, slots,
    ops) -> launches), on seeded keys and values drawn on the card, bit for
    bit and round for round against its plain version."""
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.ops.hash import hash_columns

    aggs = {}
    skipped: list = []
    for (n, lanes, slots, ops), _count in agg_shapes.items():
        earlier = _checked_earlier(("agg", n, lanes, slots, tuple(ops)),
                                   skipped)
        if earlier is not None:
            aggs[f"{n}x{lanes}/{slots}/{','.join(ops)}"] = earlier
            continue
        gen = _device_rng(f"{tag} agg {n} {lanes} {slots} {ops}", dev)
        ndv = max(1, int(0.45 * slots))
        vals = _ints(gen, (ndv, lanes), dev)
        keys = vals[torch.randint(0, ndv, (n,), generator=gen, device=dev)]
        s0 = (hash_columns([keys[:, i] for i in range(lanes)],
                           [None] * lanes) & (slots - 1)).to(torch.int32)
        live = torch.rand(n, generator=gen, device=dev) < 0.9
        values = _ints(gen, (n, len(ops)), dev, -1000, 1000)
        got = hk.group_aggregate(keys, s0, live, values, slots, ops)
        ref = hk.group_aggregate_plain(keys, s0, live, values, slots, ops)
        err = max_abs_err(zip(got[:5], ref[:5]))
        case = {"rounds": int(got[5]), "max_abs_err": err,
                "overflow": bool(got[4])}
        check(err == 0 and case["rounds"] == int(ref[5]),
              f"group_aggregate rows={n} lanes={lanes} slots={slots} "
              f"ops={ops}: kernel != plain ({case})")
        aggs[f"{n}x{lanes}/{slots}/{','.join(ops)}"] = case
        _CHECKED[("agg", n, lanes, slots, tuple(ops))] = {**case,
                                                        "checked_by": tag}
        log(f"[{tag}] group_aggregate rows={n} lanes={lanes} slots={slots} "
            f"ops={ops}: {case}")
        del keys, s0, live, values, got, ref
    _log_reused(tag, skipped)
    torch.cuda.synchronize()
    return aggs


def fold_shapes(hk, tag: str) -> dict:
    """Kernel 4's launches since the last reset, by shape ((rows, slots,
    op, value dtype) -> launches), logged."""
    folds = dict(hk.FOLD_SHAPES)
    for (n, slots, op, dtype), c in sorted(folds.items(), key=str):
        log(f"[{tag}] fold shape rows={n} slots={slots} op={op} "
            f"values={dtype} launches={c}")
    return folds


def fold_shape_checks(fold_shapes, dev, tag: str) -> dict:
    """Kernel 4 at every shape a run logged ((rows, slots, op, value
    dtype) -> launches), bit for bit against its plain version, on seeded
    int32 ids and values drawn on the card: half the rows on 13 hot slots,
    half spread over all the slots (so that past the direct strategy's
    slots both the hot-slot cache and its spill to device memory run), a
    sixth in the drop slot, and a live prefix of 90% of the rows past which
    the ids stay valid (the fold must stop at the prefix, as it must for a
    GROUP BY-less aggregate's zeros); values over their dtype's whole
    range. The launches made here are not the path's."""
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    folds = {}
    skipped: list = []
    for (n, slots, op, dtype), _count in fold_shapes.items():
        label = f"{n}/{slots}/{op}/{dtype}"
        key = ("fold", n, slots, op, dtype)
        earlier = _checked_earlier(key, skipped)
        if earlier is not None:
            folds[label] = earlier
            continue
        gen = _device_rng(f"{tag} fold {label}", dev)
        hot = torch.randint(0, slots, (13,), generator=gen, device=dev)
        gid = torch.where(
            torch.rand(n, generator=gen, device=dev) < 0.5,
            hot[torch.randint(0, 13, (n,), generator=gen, device=dev)],
            torch.randint(0, slots, (n,), generator=gen, device=dev))
        gid = torch.where(torch.rand(n, generator=gen, device=dev) < 1 / 6,
                          slots, gid).to(torch.int32)
        num_rows = torch.tensor(n - n // 10, dtype=torch.int32, device=dev)
        vals = (None if dtype is None else
                fold_values(gen, n, dtype.removeprefix("torch."), dev))
        case = fold_against_plain(gid, vals, slots, op, num_rows)
        case["ms"] = time_ms(lambda: hk.group_fold(gid, vals, slots, op,
                                                   num_rows), 1)
        check(case["max_abs_err"] == 0, f"group_fold rows={n} slots={slots} "
              f"op={op} values={dtype}: kernel != plain ({case})")
        folds[label] = case
        _CHECKED[key] = {**case, "checked_by": tag}
        log(f"[{tag}] group_fold rows={n} slots={slots} op={op} "
            f"values={dtype}: {case}")
        del gid, vals, num_rows, hot
    _log_reused(tag, skipped)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return folds


def phase_resilience(sf: float, check_sf: float, seed: int) -> dict:
    """Straggler hedging, elastic membership with departed-peer healing and
    the observability service on the card, TPC-H SF ``sf`` through
    Coordinator over DynamicCluster(4) at 4 tasks.

    1. Hedging: RESILIENCE_HEDGE_QUERIES in four arms (no fault or a
    sticky 2 s straggler on worker-1; hedging off or on with a 0.25 s floor
    and a budget of 2), each on one coordinator and cluster, the hedged
    arms cold then warm, the unhedged ones warm only:
    warm wall per query, the hedge counters, the most hedges in flight (at
    most the budget), the latency sketch's p99 beside the warm run's task
    walls; every result equal to single-node. Launches are counted from 0 over the
    hedged straggler arm's warm run.
    2. Churn: RESILIENCE_CHURN_QUERIES, each over a fresh DynamicCluster(4) under a
    leave, a join and a drain with transport faults: byte-identical to the
    same session's no-churn coordinated run, the drained worker removed,
    no staged slice left, the card's allocated bytes before the query and
    after its cluster is released.
    3. Serving: tests/test_serving.py's chaos-and-churn mix through
    ServingSession(max_concurrent_queries=6) with hedging on: identical to
    the sequential runs, the per-query chaos state swept, no slice left;
    the ObservabilityService's membership, robustness and data-plane
    totals.
    4. q3 checkpointed, a worker holding its slices removed, resumed.
    5. At SF ``check_sf`` q3 churned and q1 hedged against the CPU (a
    subprocess that runs meanwhile).
    6. Kernels 1-4 at every shape the phase logged, bit for bit
    against their plain versions.
    7. The leak arms (`leak_arms`), at SF LEAK_SF, cold then warm: the
    serving tier's served mix RESILIENCE_SERVED, LEAK_QUERY churned as in
    2 and hedged over the straggler as in 1, in a subprocess with the leak
    harness armed strict through DFTPU_LEAK_CHECK and in one unarmed: no
    survivor swept, each result equal to single-node, the harness's cost
    per arm."""
    cpu_out = Path(tempfile.mkdtemp()) / "resilience_cpu.pkl"
    cpu_worker = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--resilience-cpu-worker", str(check_sf), "--out", str(cpu_out)],
        stdout=subprocess.DEVNULL)
    try:
        return _resilience_phase(sf, check_sf, seed, cpu_worker, cpu_out)
    finally:
        if cpu_worker.poll() is None:
            cpu_worker.kill()
            cpu_worker.wait()


def _resilience_phase(sf, check_sf, seed, cpu_worker, cpu_out) -> dict:
    import gc

    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.runtime import chaos, leakcheck
    from datafusion_distributed_tpu_torch.runtime.checkpoint import (
        CheckpointStore,
        QueryCheckpointer,
    )
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
        DynamicCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.observability import (
        ObservabilityService,
    )
    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )

    rtol = precision.test_rtol()
    t_phase = time.perf_counter()
    out: dict = {}
    ctx = _session("cuda", sf, seed)
    sqls = dict(_queries(QUERIES))
    shapes: dict = {"build": {}, "probe": {}, "agg": {}, "fold": {}}
    hk.reset_launch_counts()
    # every tracked acquisition from here on is checked for its release
    leakcheck.install()
    leakcheck.reset()

    # --- 1. hedging ---------------------------------------------------------
    single = {q: _run(ctx, sqls[q]) for q in RESILIENCE_HEDGE_QUERIES}
    arms: dict = {}
    plain: dict = {}
    for name, (straggler, opts) in RESILIENCE_ARMS.items():
        arm = _hedge_arm(ctx, seed, straggler, opts)
        coord = arm.coord
        walls = {}
        # a hedged arm's cold run fills the latency sketch its warm run
        # hedges by; an unhedged arm needs no warm-up in a warm process
        for run in ("cold", "warm") if opts.get("hedging") else ("warm",):
            if name == "straggler_on" and run == "warm":
                _drain_shapes(hk, shapes)
            if run == "warm":
                coord.metrics.clear()  # the warm run's task walls below
            for q in RESILIENCE_HEDGE_QUERIES:
                t0 = time.perf_counter()
                got = arm(sqls[q])
                walls.setdefault(run, {})[q] = time.perf_counter() - t0
                diff, _tied = _close_or_ties(got, single[q], rtol)
                check(diff == "", f"{q} in the {name} arm ({run}) differs "
                      f"from single-node in {diff}")
                if name == "no_fault_off" and run == "warm":
                    plain[q] = got
            if name == "straggler_on" and run == "warm":
                out["launches"] = hk.launches()
                _drain_shapes(hk, shapes)
        counters = {k: coord.faults.get(k)
                    for k in ("hedges_issued", "hedges_won", "hedges_lost",
                              "hedges_abandoned", "hedge_budget_denied")}
        peak = coord.hedges.peak_in_flight if coord.hedges is not None else 0
        task_walls = sorted(m["elapsed_s"] for m in coord.metrics.values()
                            if m.get("elapsed_s") is not None)
        arms[name] = {
            "warm_s": walls["warm"], "cold_s": walls.get("cold"),
            "warm_sum_s": sum(walls["warm"].values()), **counters,
            "peak_hedges_in_flight": peak,
            "sketch_p99_s": coord.latency.percentile(0.99),
            "task_wall_s": {"tasks": len(task_walls),
                            "median": task_walls[len(task_walls) // 2],
                            "max": task_walls[-1]},
        }
        if opts.get("hedging"):
            check(peak <= opts["hedge_budget"],
                  f"{name}: {peak} hedges in flight, budget "
                  f"{opts['hedge_budget']}")
        del arm, coord
        arms[name]["tracked_live"] = _tracked_live()
        check(arms[name]["tracked_live"] == 0,
              f"{name}: the leak checker tracks "
              f"{arms[name]['tracked_live']} live resources")
        log(f"[resilience] hedging {name}: {arms[name]} ({_since(t_phase)})")
    check(arms["straggler_on"]["hedges_won"] >= 1,
          "no hedge won against the straggler")
    for k in ("build_group_ids", "multiway_probe"):
        check(out["launches"][k] > 0,
              f"kernel {k} was not launched by the hedged straggler arm")
    out["hedging"] = arms

    # --- 2. churn -------------------------------------------------------------
    churn: dict = {}
    for q in RESILIENCE_CHURN_QUERIES:
        base = plain.get(q)
        if base is None:
            base = _coordinated(ctx, sqls[q], False,
                                DynamicCluster(RESILIENCE_WORKERS))[0]
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        r = _churned(ctx, sqls[q], seed)
        wall = time.perf_counter() - t0
        got = r.pop("result")
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        check(_identical(got, base),
              f"{q} under membership churn differs from its no-churn run")
        check("membership_leave" in r["kinds"],
              f"{q}: the leave at the first execute never fired")
        check(r["drained"], f"{q}: the draining worker never drained")
        check(r["leaked"] == 0, f"{q}: {r['leaked']} staged tables or tasks "
              "left on the surviving workers")
        r["tracked_live"] = _tracked_live()
        check(r["tracked_live"] == 0, f"{q}: the leak checker tracks "
              f"{r['tracked_live']} live resources after the churned run")
        churn[q] = {**r, "s": wall, "allocated_before": before,
                    "allocated_after": after}
        log(f"[resilience] churn {q}: {churn[q]} ({_since(t_phase)})")
    out["churn"] = churn
    out["churn_all_kinds"] = [q for q, r in churn.items()
                              if r["kinds"] == CHURN_KINDS]
    out["churn_allocated_differs"] = [
        q for q, r in churn.items()
        if r["allocated_after"] != r["allocated_before"]]

    # --- 3. serving under chaos and churn ---------------------------------
    served_base = {
        q: plain[q] if q in plain else _coordinated(
            ctx, sqls[q], False, DynamicCluster(RESILIENCE_WORKERS))[0]
        for q in set(RESILIENCE_SERVED)}
    cluster = DynamicCluster(RESILIENCE_WORKERS)
    urls = cluster.get_urls()
    plan = chaos.FaultPlan(seed, [
        chaos.FaultSpec(site="execute", kind="transport", rate=0.1),
        chaos.FaultSpec(site="set_plan", kind="transport", rate=0.05),
    ], membership=[
        chaos.MembershipEvent("leave", urls[3], site="execute", nth_call=5),
        chaos.MembershipEvent("join", "mem://joiner-srv", site="set_plan",
                              nth_call=12),
    ], query_scoped=True)
    opts = ctx.config.distributed_options
    opts.update(max_task_retries=RESILIENCE_CHURN_RETRIES,
                **RESILIENCE_HEDGE_KNOBS)
    t0 = time.perf_counter()
    try:
        with ServingSession(ctx, cluster=chaos.wrap_cluster(cluster, plan),
                            num_tasks=RESILIENCE_TASKS,
                            max_concurrent_queries=6) as srv:
            handles = [srv.submit(sqls[q]) for q in RESILIENCE_SERVED]
            for q, h in zip(RESILIENCE_SERVED, handles):
                check(_identical(_served(h), served_base[q]),
                      f"{q} served under chaos and churn differs from its "
                      "sequential run")
            obs = ObservabilityService(cluster, cluster, health=srv.health,
                                       fault_counters=srv.faults,
                                       serving=srv)
            served = {
                "s": time.perf_counter() - t0,
                "membership": obs.get_membership(),
                "robustness": obs.get_robustness(),
                "data_plane": {k: v for k, v in obs.get_data_plane().items()
                               if k != "workers"},
                "hedging": srv.stats()["hedging"],
            }
    finally:
        for k in ("max_task_retries", *RESILIENCE_HEDGE_KNOBS):
            opts.pop(k, None)
    kinds = {f["kind"] for f in plan.fired}
    check({"membership_leave", "membership_join"} <= kinds,
          f"the served mix fired {sorted(kinds)}")
    check(not plan._calls, "the served mix left per-query chaos state")
    _serving_leaks(cluster, "the served chaos-and-churn mix")
    served["tracked_live"] = _tracked_live()
    served["tracked_leaked"] = len(leakcheck.leaks())
    check(served["tracked_live"] == served["tracked_leaked"] == 0,
          f"the served mix left {served['tracked_live']} tracked resources "
          f"live, {served['tracked_leaked']} flagged at query end")
    out["served"] = served
    log(f"[resilience] served under chaos and churn: {served} "
        f"({_since(t_phase)})")

    # --- 4. checkpoint resume after churn -----------------------------------
    cluster = DynamicCluster(RESILIENCE_WORKERS)
    store = CheckpointStore()
    rid = store.admit(sqls["q3"])
    crashing = chaos.wrap_cluster(cluster, chaos.FaultPlan(seed, [
        chaos.FaultSpec(site="execute", kind="crash", stages=[-1],
                        rate=1.0)]))
    c1 = Coordinator(resolver=crashing, channels=crashing, config_options={
        **ctx.config.distributed_snapshot(), "peer_shuffle": False,
        "max_task_retries": 0})
    c1.checkpoints = QueryCheckpointer(store, rid, crashing, crashing)
    failed = False
    try:
        ctx.sql(sqls["q3"]).collect_coordinated_table(
            coordinator=c1, num_tasks=RESILIENCE_TASKS)
    except Exception as e:  # noqa: BLE001 - the injected crash
        failed = "injected worker crash" in str(e)
    check(failed, "q3 did not fail at its root stage")
    held = sorted({url for ck in store._records[rid].stages.values()
                   for url, _t, _n in ck.slices})
    check(bool(held), "no checkpointed slice to lose")
    cluster.remove_worker(held[0])
    c2 = Coordinator(resolver=cluster, channels=cluster, config_options={
        **ctx.config.distributed_snapshot(), "peer_shuffle": False})
    c2.checkpoints = QueryCheckpointer(store, rid, cluster, cluster)
    got = ctx.sql(sqls["q3"]).collect_coordinated_table(
        coordinator=c2, num_tasks=RESILIENCE_TASKS).to_numpy()
    faults = c2.faults.as_dict()
    check(_identical(got, plain["q3"]), "resumed q3 differs from q3")
    check(faults.get("checkpoint_slices_lost", 0) >= 1,
          f"the departed worker's slices were not counted lost: {faults}")
    store.release(rid, cluster)
    _serving_leaks(cluster, "the resumed q3")
    check(_tracked_live() == 0, "the resumed q3 left tracked resources")
    out["resume"] = {"removed": held[0], **{
        k: faults.get(k, 0) for k in (
            "checkpoint_stages_restored", "checkpoint_slices_lost",
            "queries_resumed")}}
    log(f"[resilience] resume after churn: {out['resume']} "
        f"({_since(t_phase)})")
    del ctx, c1, c2, crashing, cluster, store, plain, single
    gc.collect()
    torch.cuda.empty_cache()

    # --- 5. card against CPU -----------------------------------------------
    gpu = _fanned_session("cuda", check_sf, seed)
    small = dict(_queries(("q1", "q3")))
    card_churn = _churned(gpu, small["q3"], seed)
    arm = _hedge_arm(gpu, seed, True, RESILIENCE_HEDGE_KNOBS)
    card_hedged = arm(small["q1"])
    check(cpu_worker.wait(timeout=RESILIENCE_CPU_TIMEOUT_S) == 0,
          f"the CPU worker exited {cpu_worker.returncode}")
    with open(cpu_out, "rb") as f:
        cpu_results = pickle.load(f)
    diff = _close(card_churn["result"], cpu_results["q3"][0], rtol)
    check(diff == "", f"churned q3: cuda and cpu differ in {diff}")
    check(card_churn["kinds"] == cpu_results["q3"][1] == CHURN_KINDS,
          f"churned q3 fired {card_churn['kinds']} on the card, "
          f"{cpu_results['q3'][1]} on the CPU")
    diff = _close(card_hedged, cpu_results["q1"][0], rtol)
    check(diff == "", f"hedged q1: cuda and cpu differ in {diff}")
    out["card_cpu"] = {
        "q3_identical": _identical(card_churn["result"],
                                   cpu_results["q3"][0]),
        "q1_identical": _identical(card_hedged, cpu_results["q1"][0]),
        "q1_hedges_issued": [arm.coord.faults.get("hedges_issued"),
                             cpu_results["q1"][1]]}
    log(f"[resilience] SF {check_sf}: churned q3 and hedged q1 equal on "
        f"cuda and cpu {out['card_cpu']} ({_since(t_phase)})")
    del gpu, arm

    # --- 6. every logged shape against the plain version -------------------
    _drain_shapes(hk, shapes)
    dev = torch.device("cuda")
    out["kernel_checks"] = {
        "build_group_ids": build_shape_checks(
            [[n, lanes, h, c] for (n, lanes, h), c
             in shapes["build"].items()], dev, "resilience"),
        "multiway_probe": probe_shape_checks(
            [[n, k, lanes, list(s), c] for (n, k, lanes, s), c
             in shapes["probe"].items()], dev, "resilience"),
        "group_aggregate": agg_shape_checks(shapes["agg"], dev,
                                            "resilience"),
        "group_fold": fold_shape_checks(shapes["fold"], dev, "resilience"),
    }
    out["shapes"] = {k: len(v) for k, v in shapes.items()}
    log(f"[resilience] shapes checked: {out['shapes']} ({_since(t_phase)})")

    # --- 7. churn and hedging with the leak harness armed and unarmed ------
    out["leak"] = leak_arms()
    log(f"[resilience] leak arms done ({_since(t_phase)})")
    return out


# ---------------------------------------------------------------------------
# phase 12b: the adaptive, fault-tolerant and streaming surfaces
# ---------------------------------------------------------------------------

ADAPTIVE_SF = 0.1  # the TPC-H inputs of (a), (b) and (c)
ADAPTIVE_ROWS = 1 << 20  # the synthetic shapes of (a)
ADAPTIVE_WORKERS = 4
ADAPTIVE_TASKS = 4
#: every adaptation armed, and every one off (tests/test_adaptivity.py)
ADAPT_ON = {"skew_split_factor": 1.5, "skew_split_min_rows": 8,
            "partial_agg_bailout_ratio": 0.8,
            "replan_cardinality_factor": 1.5}
ADAPT_OFF = {"skew_split_factor": 0.0, "partial_agg_bailout_ratio": 0.0,
             "replan_cardinality_factor": 0.0}
#: the bulk shuffle plane, where the skew split and the bail-out act
ADAPT_BULK = {"pipelined_shuffle": False, "data_plane": "unary"}
#: the TPC-H queries that fire the bail-out and the replan
#: (tests/test_torch_adaptivity.py): q18's `group by l_orderkey` reduces
#: its input four-fold, so a bail-out ratio of 0.2 bails out on it
ADAPTIVE_TPCH = {
    "q18": ({**ADAPT_BULK, **ADAPT_ON, "partial_agg_bailout_ratio": 0.2,
             "stage_parallelism": 4},
            ("partial_agg_bailout", "replanned_stages")),
    "q9": ({**ADAPT_ON, "pipelined_shuffle": False, "stage_parallelism": 4},
           ("replanned_stages",)),
}
ADAPTIVE_COUNTERS = ("dftpu_skew_splits", "dftpu_partial_agg_bailouts",
                     "dftpu_replans")
#: (b): worker-1 sleeps DEADLINE_DELAY_S on the faulted call, against an
#: execution deadline of DEADLINE_S; ships have DISPATCH_DEADLINE_S
DEADLINE_DELAY_S = 2.0
DEADLINE_S = 1.0
DISPATCH_DEADLINE_S = 30.0
DEADLINE_SETTLE_S = 60.0  # the most an abandoned attempt may take to end
DEADLINE_QUERY = "q3"
#: (c): the breaker's cool-down, passed on an injected clock: a quarantine
#: that lapses while the queries run in real time would admit the probe
#: into the second query
QUARANTINE_S = 60.0
#: (d): at SF 1, a LIMIT over 8 streamed tasks, and a stream budget
STREAM_LIMIT = 100_000
STREAM_TASKS = 8
STREAM_CHUNK_ROWS = 65_536
STREAM_BUDGET = 32 << 20  # about three 65,536-row chunks of lineitem
STREAM_BUDGET_LIMIT = 1_000_000


def _adaptivity_counts() -> dict:
    from datafusion_distributed_tpu_torch.runtime.telemetry import (
        DEFAULT_REGISTRY,
    )

    snap = DEFAULT_REGISTRY.snapshot()
    return {n: sum(v for _, v in snap.get(n, {}).get("samples", []))
            for n in ADAPTIVE_COUNTERS}


def _adapted(coord) -> dict:
    """Each stage's adaptation record in the coordinator's stream metrics."""
    keys = ("skew_splits", "skew_partition_rows", "partial_agg_bailout",
            "partial_agg_ratio", "replanned_stages")
    out = {}
    for (_q, sid), sm in coord.stream_metrics.items():
        got = {k: sm[k] for k in keys if k in sm}
        if got:
            out[sid] = got
    return out


def _adaptive_arm(run) -> dict:
    """``run()`` -> (numpy result, coordinator), cold then warm: the warm
    result, its seconds, its adaptation records and counter deltas."""
    import torch

    run()
    before = _adaptivity_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, coord = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = _adaptivity_counts()
    return {"result": res, "s": wall, "adapted": _adapted(coord),
            "counters": {k: after[k] - before[k] for k in before}}


def _skewed_plan(slices, dev):
    """A hash shuffle on ``k`` over a scan of ``slices`` (arrow tables, one
    a task) into a coalesce (tests/test_adaptivity.py's hand-built shape)."""
    from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
    from datafusion_distributed_tpu_torch.ops.table import round_up_pow2
    from datafusion_distributed_tpu_torch.plan.exchanges import (
        CoalesceExchangeExec,
        ShuffleExchangeExec,
    )
    from datafusion_distributed_tpu_torch.plan.physical import MemoryScanExec

    tasks = [arrow_to_table(s, device=dev) for s in slices]
    scan = MemoryScanExec(tasks, tasks[0].schema())
    cap = round_up_pow2(2 * max(s.num_rows for s in slices))
    ex = ShuffleExchangeExec(scan, ["k"], len(slices), per_dest_capacity=cap)
    ex.producer_tasks = len(slices)
    ex.stage_id = 1
    root = CoalesceExchangeExec(ex, len(slices))
    root.stage_id = 2
    return root


def _skew_inputs(sf: float, seed: int) -> dict:
    """name -> slices: one hot slice of 3/4 of ADAPTIVE_ROWS beside three
    cold ones, and TPC-H lineitem partitioned by (l_returnflag,
    l_linestatus), where the 'NO' partition holds about half the rows."""
    import pyarrow as pa

    from datafusion_distributed_tpu_torch.data import tpchgen

    rng = np.random.default_rng(seed)

    def mk(n):
        return pa.table({"k": rng.integers(0, 64, n).astype(np.int64),
                         "v": rng.random(n)})

    hot = 3 * ADAPTIVE_ROWS // 4
    cold = (ADAPTIVE_ROWS - hot) // 3
    li = tpchgen.gen_tpch(sf=sf, seed=seed)["lineitem"]

    def decoded(name):
        d = li.dictionaries[name]
        return np.asarray(getattr(d, "values", d),
                          dtype=object)[np.asarray(li.data[name])]

    flag, status = decoded("l_returnflag"), decoded("l_linestatus")
    t = pa.table({k: np.asarray(li.data[c]) for k, c in (
        ("k", "l_orderkey"), ("v", "l_extendedprice"), ("q", "l_quantity"))})
    status_slices = [
        t.take(pa.array(np.nonzero((flag == f) & (status == s))[0]))
        for f, s in (("A", "F"), ("N", "F"), ("N", "O"), ("R", "F"))]
    return {"synthetic": [mk(hot), mk(cold), mk(cold), mk(cold)],
            "lineitem_by_status": status_slices}


def _adapt_coord(cluster, ctx=None, **opts):
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
    )

    base = ctx.config.distributed_snapshot() if ctx is not None else {}
    return Coordinator(resolver=cluster, channels=cluster, config_options={
        **base, "task_retry_backoff_s": 0.001, **opts})


def _no_slices(cluster, what: str) -> None:
    for w in cluster.workers.values():
        check(not w.table_store.tables and len(w.registry) == 0,
              f"{what}: worker {w.url} kept {len(w.table_store.tables)} "
              f"staged tables and {len(w.registry)} tasks")


def _adaptations_on_card(ctx, seed: int, dev) -> dict:
    """(a): each adaptation forced, against its arm with the adaptations
    off, cold then warm."""
    import pyarrow as pa

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )

    out: dict = {}

    def plan_run(slices, opts):
        def run():
            cluster = InMemoryCluster(ADAPTIVE_WORKERS)
            coord = _adapt_coord(cluster, stage_parallelism=1,
                                 **ADAPT_BULK, **opts)
            res = coord.execute(_skewed_plan(slices, dev)).to_numpy()
            _no_slices(cluster, "the skewed plan")
            return res, coord
        return run

    for name, slices in _skew_inputs(ADAPTIVE_SF, seed).items():
        off = _adaptive_arm(plan_run(slices, ADAPT_OFF))
        on = _adaptive_arm(plan_run(slices, {"skew_split_factor": 1.5,
                                             "skew_split_min_rows": 64}))
        hot = max(s.num_rows for s in slices)
        check(_identical(on["result"], off["result"]),
              f"skew split {name}: the split result differs")
        split = [a for a in on["adapted"].values() if a.get("skew_splits")]
        check(bool(split) and split[0]["skew_partition_rows"] == hot
              and on["counters"]["dftpu_skew_splits"] >= 1,
              f"skew split {name}: no split of the {hot}-row slice "
              f"({on['adapted']}, {on['counters']})")
        check(not off["adapted"], f"skew split {name}: the off arm adapted")
        out[f"skew_{name}"] = {"rows": sum(s.num_rows for s in slices),
                               "hot_rows": hot, "off_s": off["s"],
                               "on_s": on["s"], "adapted": on["adapted"],
                               "counters": on["counters"]}
        log(f"[adaptive] skew split {name}: {out[f'skew_{name}']}")

    rng = np.random.default_rng(seed)
    n = ADAPTIVE_ROWS
    ctx.register_arrow("adapt_u", pa.table({
        "k": np.arange(n, dtype=np.int64), "v": rng.random(n)}))
    ctx.register_arrow("adapt_a", pa.table({
        "k": (np.arange(n) % 37).astype(np.int64), "v": rng.random(n)}))
    ctx.register_arrow("adapt_b", pa.table({
        "k": np.arange(37, dtype=np.int64), "w": rng.random(37)}))
    sqls = {
        "bailout": ("SELECT k, SUM(v) AS s FROM adapt_u GROUP BY k "
                    "ORDER BY k"),
        "replan": ("SELECT adapt_a.k, SUM(adapt_a.v * adapt_b.w) AS s FROM "
                   "adapt_a JOIN adapt_b ON adapt_a.k = adapt_b.k WHERE "
                   "adapt_a.v < 0.01 GROUP BY adapt_a.k ORDER BY adapt_a.k"),
    }
    arms = {"bailout": ({**ADAPT_BULK, "partial_agg_bailout_ratio": 0.0},
                        {**ADAPT_BULK, "partial_agg_bailout_ratio": 0.5},
                        "partial_agg_bailout"),
            "replan": ({**ADAPT_BULK, **ADAPT_OFF},
                       {**ADAPT_BULK, "replan_cardinality_factor": 1.5},
                       "replanned_stages")}
    queries = dict(_queries(ADAPTIVE_TPCH))
    for q, (opts, _kinds) in ADAPTIVE_TPCH.items():
        sqls[q] = queries[q]
        arms[q] = ({**opts, **ADAPT_OFF}, opts, None)
    ctx.config.distributed_options.update(bytes_per_task=1,
                                          broadcast_joins=False)
    for name, sql in sqls.items():
        off_opts, on_opts, kind = arms[name]

        def sql_run(opts):
            def run():
                cluster = InMemoryCluster(ADAPTIVE_WORKERS)
                coord = _adapt_coord(cluster, ctx, **opts)
                df = ctx.sql(sql)
                res = df.collect_coordinated_table(
                    coordinator=coord,
                    num_tasks=ADAPTIVE_TASKS).to_numpy()
                _no_slices(cluster, name)
                return res, coord
            return run

        off = _adaptive_arm(sql_run(off_opts))
        on = _adaptive_arm(sql_run(on_opts))
        kinds = ((kind,) if kind is not None
                 else ADAPTIVE_TPCH[name][1])
        fired = {k for a in on["adapted"].values() for k in a}
        check(set(kinds) <= fired, f"{name}: {kinds} did not all fire "
              f"({on['adapted']})")
        identical = _identical(on["result"], off["result"])
        if "partial_agg_bailout" in kinds:
            # partial states round a float sum where the raw rows do not
            # (tests/test_adaptivity.py compares it so too)
            diff = _close(on["result"], off["result"],
                          precision.test_rtol())
            check(diff == "", f"{name}: the bail-out differs in {diff}")
        else:
            check(identical, f"{name}: the adapted result differs")
        check(not off["adapted"], f"{name}: the off arm adapted")
        for k, c in (("partial_agg_bailout",
                      "dftpu_partial_agg_bailouts"),
                     ("replanned_stages", "dftpu_replans")):
            if k in kinds:
                check(on["counters"][c] >= 1,
                      f"{name}: {c} did not count ({on['counters']})")
        out[name] = {"off_s": off["s"], "on_s": on["s"],
                     "identical": identical, "adapted": on["adapted"],
                     "counters": on["counters"]}
        log(f"[adaptive] {name}: {out[name]}")
    return out


def _settled(before: int, deadline: float) -> tuple:
    """Wait until the abandoned attempts' threads end and the card's
    allocated bytes are back to ``before`` -> (seconds waited, threads
    still alive, allocated bytes)."""
    import gc
    import threading

    import torch

    t0 = time.perf_counter()
    while True:
        alive = [t for t in threading.enumerate()
                 if t.name == "dftpu-deadline" and t.is_alive()]
        gc.collect()
        torch.cuda.synchronize()
        now = torch.cuda.memory_allocated()
        if (not alive and now == before) or time.perf_counter() > deadline:
            return time.perf_counter() - t0, len(alive), now
        time.sleep(0.1)


def _deadlines_on_card(ctx, sql: str, single: dict, seed: int) -> dict:
    """(b): one worker of 4 sleeps DEADLINE_DELAY_S on the first execute of
    a stage, or worker-1 on every execute, under the execution, dispatch
    and first-chunk deadlines."""
    import gc

    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.runtime import chaos
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )

    rtol = precision.test_rtol()
    deadlines = {"task_timeout_s": DEADLINE_S,
                 "dispatch_timeout_s": DISPATCH_DEADLINE_S}
    #: name -> (the faulted stages, kind, coordinator options)
    arms = {"root_bulk": ([-1], "delay", {}),
            "first_chunk": ([0], "delay", {"peer_shuffle": False,
                                           "pipelined_shuffle": False}),
            "straggler": (None, "straggler", {})}
    out: dict = {}
    for name, (stages, kind, opts) in arms.items():
        # without the fault: the peak of a healthy run of the same arm
        cluster = InMemoryCluster(ADAPTIVE_WORKERS)
        coord = _adapt_coord(cluster, ctx, **deadlines, **opts)
        ctx.sql(sql).collect_coordinated_table(coordinator=coord,
                                               num_tasks=ADAPTIVE_TASKS)
        del coord, cluster
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cluster = InMemoryCluster(ADAPTIVE_WORKERS)
        coord = _adapt_coord(cluster, ctx, **deadlines, **opts)
        ctx.sql(sql).collect_coordinated_table(coordinator=coord,
                                               num_tasks=ADAPTIVE_TASKS)
        torch.cuda.synchronize()
        healthy_peak = torch.cuda.max_memory_allocated() - before
        del coord
        _no_slices(cluster, f"deadline {name} (healthy)")
        del cluster
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cluster = InMemoryCluster(ADAPTIVE_WORKERS)
        slow = cluster.get_urls()[1]
        # a delay hits whichever worker runs the stage's first task; the
        # straggler is worker-1, sticky
        spec = chaos.FaultSpec(
            site="execute", kind=kind, delay_s=DEADLINE_DELAY_S, rate=1.0,
            workers=[slow] if kind == "straggler" else None, stages=stages,
            max_total=None if kind == "straggler" else 1)
        plan = chaos.FaultPlan(seed, [spec])
        coord = _adapt_coord(chaos.wrap_cluster(cluster, plan), ctx,
                             **deadlines, **opts)
        t0 = time.perf_counter()
        got = ctx.sql(sql).collect_coordinated_table(
            coordinator=coord, num_tasks=ADAPTIVE_TASKS).to_numpy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        faults = {k: v for k, v in coord.faults.as_dict().items() if v}
        diff = _close(got, single, rtol)
        check(diff == "", f"deadline {name}: differs from single-node in "
              f"{diff}")
        check(faults.get("task_timeouts", 0) >= 1 and bool(plan.fired),
              f"deadline {name}: no attempt timed out ({faults})")
        check(faults.get("tasks_rerouted", 0) >= 1,
              f"deadline {name}: the timed-out task was not rerouted "
              f"({faults})")
        del coord, got
        waited, alive, after = _settled(
            before, time.perf_counter() + DEADLINE_SETTLE_S)
        peak = torch.cuda.max_memory_allocated() - before
        check(alive == 0, f"deadline {name}: {alive} abandoned attempts "
              f"still running after {waited:.1f}s")
        _no_slices(cluster, f"deadline {name}, abandoned attempts ended")
        check(after == before, f"deadline {name}: {after - before} bytes "
              "still allocated on the card after the abandoned attempts")
        out[name] = {"s": wall, "faults": faults, "fired": len(plan.fired),
                     "settle_s": waited, "allocated_before": before,
                     "allocated_after": after, "peak_bytes": peak,
                     "healthy_peak_bytes": healthy_peak}
        log(f"[adaptive] deadline {name}: {out[name]}")
        del cluster, plan
    return out


def _breaker_on_card(ctx, sql: str, single: dict, seed: int) -> dict:
    """(c): a flaky worker quarantined and routed around, its half-open
    probe admitted once the cool-down has passed; a corrupt plan failing
    fast as the classified fatal error."""
    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.runtime import chaos, health
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.errors import (
        PlanIntegrityError,
        is_retryable,
    )

    rtol = precision.test_rtol()
    cluster = InMemoryCluster(ADAPTIVE_WORKERS)
    bad = cluster.get_urls()[0]
    # every call to the bad worker fails: a success would close its
    # circuit, and one in flight when it trips would race the check
    plan = chaos.FaultPlan(seed, [
        chaos.FaultSpec(site=site, kind="crash", rate=1.0, workers=[bad])
        for site in ("execute", "set_plan")])
    coord = _adapt_coord(chaos.wrap_cluster(cluster, plan), ctx,
                         quarantine_threshold=1,
                         quarantine_seconds=QUARANTINE_S,
                         max_task_retries=4,
                         peer_shuffle=False, pipelined_shuffle=False)
    lapsed = [0.0]
    coord.health = health.HealthTracker(
        health.HealthPolicy(failure_threshold=1,
                            quarantine_seconds=QUARANTINE_S),
        clock=lambda: time.monotonic() + lapsed[0])
    states, fired, trips = [], [], []
    for i in range(3):
        if i == 2:
            lapsed[0] = QUARANTINE_S * 1.5  # the cool-down passes
        n0 = len(plan.fired)
        got = ctx.sql(sql).collect_coordinated_table(
            coordinator=coord, num_tasks=ADAPTIVE_TASKS).to_numpy()
        diff = _close(got, single, rtol)
        check(diff == "", f"breaker query {i}: differs in {diff}")
        fired.append(len(plan.fired) - n0)
        states.append(coord.health.state_of(bad))
        trips.append(coord.health.snapshot()[bad]["trips"])
    _no_slices(cluster, "the breaker queries")
    faults = {k: v for k, v in coord.faults.as_dict().items() if v}
    check(states == [health.OPEN] * 3 and fired[0] >= 1
          and faults.get("workers_quarantined"),
          f"the flaky worker was not quarantined ({states}, {fired}, "
          f"{faults})")
    check(fired[1] == 0, f"the quarantined worker was sent {fired[1]} "
          "calls of the second query")
    check(fired[2] == 1 and trips == [1, 1, 2],
          f"not one half-open probe after the cool-down ({fired}, trips "
          f"{trips})")
    out = {"states": states, "bad_worker_calls": fired, "trips": trips,
           "faults": faults}

    cluster = InMemoryCluster(ADAPTIVE_WORKERS)
    plan = chaos.FaultPlan(seed, [chaos.FaultSpec(
        site="set_plan", kind="corrupt_plan", rate=1.0, max_total=1)])
    coord = _adapt_coord(chaos.wrap_cluster(cluster, plan), ctx)
    err = None
    try:
        ctx.sql(sql).collect_coordinated_table(coordinator=coord,
                                               num_tasks=ADAPTIVE_TASKS)
    except PlanIntegrityError as e:  # the expected refusal; others raise
        err = e
    check(err is not None, "the corrupt plan was not refused")
    check("DFTPU043" in str(err) and not is_retryable(err),
          f"the corrupt plan failed as {type(err).__name__}: {err}")
    check(coord.faults.get("task_retries") == 0
          and coord.faults.get("fatal_failures") == 1,
          f"the corrupt plan was retried ({coord.faults.as_dict()})")
    _no_slices(cluster, "the corrupt plan")
    out["corrupt_plan"] = {"error": type(err).__name__,
                           "fired": [f["kind"] for f in plan.fired]}
    log(f"[adaptive] breaker and corrupt plan: {out}")
    return out


def _streaming_on_card(sf: float, seed: int) -> dict:
    """(d): at SF 1, the LIMIT early exit over STREAM_TASKS tasks against
    the bulk plane's granularity (one chunk a task), and the stream
    budget's peak bytes in flight."""
    from datafusion_distributed_tpu_torch.planner.statistics import row_width
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )

    ctx = _session("cuda", sf, seed)
    ctx.config.distributed_options["size_tasks_to_data"] = False
    out: dict = {}
    sql = f"select * from lineitem limit {STREAM_LIMIT}"
    width = row_width(ctx.sql(sql).physical_plan().schema())
    for name, chunk in (("stream", STREAM_CHUNK_ROWS), ("bulk", 1 << 30)):
        runs = []
        for _ in range(2):  # cold, warm
            cluster = InMemoryCluster(STREAM_TASKS)
            coord = _adapt_coord(cluster, ctx, stream_chunk_rows=chunk)
            t0 = time.perf_counter()
            got = ctx.sql(sql).collect_coordinated_table(
                coordinator=coord, num_tasks=STREAM_TASKS)
            rows = int(got.num_rows)
            wall = time.perf_counter() - t0
            _no_slices(cluster, f"the LIMIT on the {name} plane")
            (s,) = coord.stream_metrics.values()
            runs.append({"s": wall, "rows": rows, "capacity": got.capacity,
                         "streamed_rows": s["rows"], "chunks": s["chunks"],
                         "bytes_streamed": s["bytes_streamed"],
                         "early_exit": s["early_exit"]})
        check(all(r["rows"] == STREAM_LIMIT for r in runs),
              f"the LIMIT on the {name} plane returned {runs}")
        out[name] = {"cold": runs[0], "warm": runs[1]}
    check(out["stream"]["warm"]["early_exit"]
          and out["stream"]["warm"]["streamed_rows"]
          < STREAM_LIMIT + STREAM_TASKS * STREAM_CHUNK_ROWS,
          f"the LIMIT streamed {out['stream']['warm']}")
    out["row_width"] = width
    out["fetch_capped_bytes"] = STREAM_TASKS * STREAM_LIMIT * width

    budget_sql = f"select * from lineitem limit {STREAM_BUDGET_LIMIT}"
    cluster = InMemoryCluster(ADAPTIVE_WORKERS)
    coord = _adapt_coord(cluster, ctx,
                         worker_connection_buffer_budget_bytes=STREAM_BUDGET,
                         stream_chunk_rows=STREAM_CHUNK_ROWS)
    t0 = time.perf_counter()
    got = ctx.sql(budget_sql).collect_coordinated_table(
        coordinator=coord, num_tasks=STREAM_TASKS)
    wall = time.perf_counter() - t0
    _no_slices(cluster, "the budgeted stream")
    stats = list(coord.stream_metrics.values())
    chunk_bytes = STREAM_CHUNK_ROWS * width
    peak = max(s["peak_in_flight"] for s in stats)
    check(int(got.num_rows) == STREAM_BUDGET_LIMIT,
          f"the budgeted stream returned {int(got.num_rows)} rows")
    check(peak <= STREAM_BUDGET + chunk_bytes,
          f"{peak} bytes in flight over a budget of {STREAM_BUDGET} plus "
          f"one chunk of {chunk_bytes}")
    out["budget"] = {"s": wall, "budget": STREAM_BUDGET,
                     "chunk_bytes": chunk_bytes, "peak_in_flight": peak,
                     "bytes_streamed": sum(s["bytes_streamed"]
                                           for s in stats),
                     "chunks": sum(s["chunks"] for s in stats)}
    log(f"[adaptive] streaming: {out}")
    return out


def phase_adaptive(sf: float, seed: int) -> dict:
    """The coordinated runtime's adaptive, fault-tolerant and streaming
    surfaces on the card, the tables on the card, over InMemoryCluster(4)
    at 4 tasks (tests/test_torch_adaptivity.py, test_torch_fault_tolerance.py
    and test_torch_streaming.py hold them against the reference on the CPU).

    (a) The skew split on a hand-built shuffle of ADAPTIVE_ROWS rows with
    one hot slice and on TPC-H lineitem (SF ADAPTIVE_SF) partitioned by its
    status columns; the bail-out on ADAPTIVE_ROWS all-distinct keys; the
    replan on the selective join of ADAPTIVE_ROWS rows; ADAPTIVE_TPCH at
    SF ADAPTIVE_SF: each arm cold then warm, forced and off, equal (byte
    for byte, the bail-out at test_rtol()), with the adaptation records,
    the counters and the warm seconds.
    (b) Deadlines: worker-1 of 4 sleeps DEADLINE_DELAY_S in one execute of
    the root stage, of a streamed stage, or in every execute (a
    straggler), under task_timeout_s = DEADLINE_S and dispatch_timeout_s:
    rerouted, equal to single-node; once the abandoned attempts end, no
    staged slice and the card's allocated bytes as before the query; the
    peak allocated bytes with the abandoned attempt and without.
    (c) A flaky worker quarantined, routed around, its half-open probe
    admitted after the cool-down; a corrupt plan refused as DFTPU043 with
    no retries.
    (d) At SF ``sf``: STREAM_LIMIT rows over STREAM_TASKS streamed tasks
    against one chunk a task; STREAM_BUDGET_LIMIT rows through a
    STREAM_BUDGET budget, peak in flight within one chunk of it.
    (e) Kernels 1-3 at every shape the phase logged."""
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    shapes: dict = {"build": {}, "probe": {}, "agg": {}, "fold": {}}
    out: dict = {}
    ctx = _session("cuda", ADAPTIVE_SF, seed)
    hk.reset_launch_counts()
    out["adaptations"] = _adaptations_on_card(ctx, seed, dev)
    out["launches"] = hk.launches()
    for k in ("build_group_ids", "multiway_probe"):
        check(out["launches"].get(k, 0) > 0,
              f"kernel {k} was not launched by the adaptation arms")
    _drain_shapes(hk, shapes)
    log(f"[adaptive] (a) done ({_since(t_phase)})")

    sql = dict(_queries((DEADLINE_QUERY,)))[DEADLINE_QUERY]
    fanned = _fanned_session("cuda", ADAPTIVE_SF, seed)
    single = _run(fanned, sql)
    out["deadlines"] = _deadlines_on_card(fanned, sql, single, seed)
    log(f"[adaptive] (b) done ({_since(t_phase)})")
    out["breaker"] = _breaker_on_card(fanned, sql, single, seed)
    log(f"[adaptive] (c) done ({_since(t_phase)})")
    del fanned, ctx
    out["streaming"] = _streaming_on_card(sf, seed)
    log(f"[adaptive] (d) done ({_since(t_phase)})")

    _drain_shapes(hk, shapes)
    out["kernel_checks"] = {
        "build_group_ids": build_shape_checks(
            [[n, lanes, h, c] for (n, lanes, h), c
             in shapes["build"].items()], dev, "adaptive"),
        "multiway_probe": probe_shape_checks(
            [[n, k, lanes, list(s), c] for (n, k, lanes, s), c
             in shapes["probe"].items()], dev, "adaptive"),
        "group_aggregate": agg_shape_checks(shapes["agg"], dev, "adaptive"),
        "group_fold": fold_shape_checks(shapes["fold"], dev, "adaptive"),
    }
    out["shapes"] = {k: len(v) for k, v in shapes.items()}
    log(f"[adaptive] shapes checked: {out['shapes']} ({_since(t_phase)})")
    return out


# ---------------------------------------------------------------------------
# phase 13: the wire tier (gRPC workers, the shm plane, native regroup)
# ---------------------------------------------------------------------------

WIRE_WORKERS = 4
WIRE_TASKS = 4
#: the SF 1 arm: scans, the five-way join, the six-way join, the big GROUP
#: BY (the mesh phase's queries but q21: its SF 1 runs over gRPC took
#: 64.0 s of a 153.4 s phase on the card, and that time went to the leak
#: arms; q21 still crosses the wire at WIRE_KNOB_SF, on shm; q18's SF 1
#: runs, ~24 s, went to the adaptive phase: q18 still crosses the wire in
#: the card-against-CPU check at SF 0.01)
WIRE_QUERIES = ("q1", "q3", "q5", "q9")
#: the plane and codec variants, at WIRE_KNOB_SF
#: (q5's and q18's variants, 3.8 s on the card, went to the spmd phase:
#: q18's exchanges take no partition stream at SF 0.1, and q5's planes
#: are q3's)
WIRE_KNOB_QUERIES = ("q3", "q21")
#: queries that run only some of WIRE_PLANES' variants: q21's five took
#: 23.5 s of a 184.6 s phase on the card, which the run's time limit does
#: not hold beside the resilience phase's churn; it keeps
#: the shm plane, where its stream's segments carry lineitem's dictionaries
WIRE_KNOB_ONLY = {"q21": (("shm", "auto"),)}
WIRE_KNOB_SF = 0.1
#: (data plane, its knobs, the wire compressions it runs under): the
#: default ladder never calls TransferPartitions, the one RPC that reads
#: `wire_compression`, so it runs once
WIRE_PLANES = (("default", {}, ("auto",)),
               ("stream", {"data_plane": "stream"}, ("auto", "off")),
               ("shm", {"data_plane": "shm"}, ("auto", "off")))
#: card against CPU at CHECK_SF
WIRE_CHECK_QUERIES = ("q1", "q3", "q5", "q18")
#: the deadline of every RPC the phase's clients make
WIRE_RPC_TIMEOUT_S = 300.0
WIRE_CPU_TIMEOUT_S = 600
#: the SF 1 key columns the native hash is held against the card's on
WIRE_HASH_COLUMNS = (("lineitem", ("l_orderkey",)),
                     ("lineitem", ("l_orderkey", "l_partkey", "l_suppkey")),
                     ("orders", ("o_custkey", "o_totalprice")))


class _ShipMeter:
    """Sums the framed bytes every GrpcWorkerClient.set_plan puts on the
    wire (its return value) while active: the SetPlan bytes shipped."""

    def __enter__(self):
        import functools
        import threading

        from datafusion_distributed_tpu_torch.runtime import grpc_worker

        self.cls = grpc_worker.GrpcWorkerClient
        self.original = original = self.cls.set_plan
        self.lock = threading.Lock()
        self.bytes = 0
        self.calls = 0
        meter = self

        @functools.wraps(original)
        def set_plan(client, *a, **kw):
            n = original(client, *a, **kw)
            with meter.lock:
                meter.bytes += n
                meter.calls += 1
            return n

        self.cls.set_plan = set_plan
        return self

    def take(self) -> tuple:
        with self.lock:
            out = (self.bytes, self.calls)
            self.bytes = self.calls = 0
        return out

    def __exit__(self, *exc):
        self.cls.set_plan = self.original


def _copies(fn) -> tuple:
    """(fn(), its host/device copies): for each direction the bytes and
    copies the table layer counted where it made them
    (`ops.table.copy_stats`: the packed copies, `move`, `to_device`),
    beside what the profiler's CUDA activity recorded of the same call (in
    every thread of the process, read from its exported trace): its bytes,
    copies and summed device time, the rate those copies reached, and the
    share of the counted bytes it saw (it can drop events; the counts are
    the table layer's)."""
    from torch.profiler import ProfilerActivity, profile

    from datafusion_distributed_tpu_torch.ops.table import (
        copy_stats,
        reset_copy_stats,
    )

    box: list = []
    reset_copy_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        box.append(fn())
    counted = copy_stats()
    path = Path(tempfile.mkdtemp()) / "trace.json"
    prof.export_chrome_trace(str(path))
    seen = {d: {"bytes": 0, "copies": 0, "us": 0.0} for d in ("d2h", "h2d")}
    for e in json.loads(path.read_text()).get("traceEvents", []):
        if e.get("cat") != "gpu_memcpy":
            continue
        name = e.get("name", "")
        d = "d2h" if "DtoH" in name else "h2d" if "HtoD" in name else None
        if d is None:
            continue
        seen[d]["bytes"] += int(e.get("args", {}).get("bytes", 0))
        seen[d]["copies"] += 1
        seen[d]["us"] += float(e.get("dur", 0.0))
    path.unlink()
    out = {}
    for d, v in seen.items():
        b = counted[f"{d}_bytes"]
        out[d] = {"bytes": b, "copies": counted[f"{d}_copies"],
                  "profiler_bytes": v["bytes"],
                  "profiler_copies": v["copies"], "profiler_us": v["us"],
                  "gb_s": v["bytes"] / (v["us"] * 1e3) if v["us"] else None,
                  "profiler_share": v["bytes"] / b if b else None}
    return box[0], out


def _grpc_coordinated(ctx, sql: str, cluster, opts=None, wrap=None):
    """One query through collect_coordinated_table(num_tasks=4) over a
    localhost gRPC ``cluster`` (or ``wrap(cluster)``), on a fresh
    Coordinator. -> (result, coordinator); every worker's store, task
    registry and segment directory must be empty afterwards."""
    import torch

    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
    )

    c = cluster if wrap is None else wrap(cluster)
    coord = Coordinator(resolver=c, channels=c, config_options={
        **ctx.config.distributed_snapshot(), **(opts or {})})
    table = ctx.sql(sql).collect_coordinated_table(coordinator=coord,
                                                   num_tasks=WIRE_TASKS)
    out = table.to_numpy()
    if table.device.type == "cuda":
        torch.cuda.synchronize()
    for w in cluster.local_workers:
        check(not w.table_store.tables and len(w.registry) == 0,
              f"gRPC worker {w.url} kept {len(w.table_store.tables)} staged "
              f"tables and {len(w.registry)} tasks after the query")
        check(w.segment_pool.live_segments() == 0,
              f"gRPC worker {w.url} left {w.segment_pool.live_segments()} "
              "shm segments")
    return out, coord


def wire_cpu_worker(sf: float, out_path: str) -> int:
    """The CPU's side of the wire phase's card-against-CPU check: the
    WIRE_CHECK_QUERIES over start_localhost_cluster(4, device="cpu") at SF
    ``sf``, pickled."""
    import torch

    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )

    torch.set_num_threads(4)
    ctx = _session("cpu", sf, SEED)
    cluster = start_localhost_cluster(WIRE_WORKERS, device="cpu",
                                      rpc_timeout_s=WIRE_RPC_TIMEOUT_S)
    try:
        out = {q: _grpc_coordinated(ctx, sql, cluster)[0]
               for q, sql in _queries(WIRE_CHECK_QUERIES)}
    finally:
        cluster.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def _pool_totals(cluster) -> dict:
    """Segments published, released (published and no longer in a pool
    directory) and their bytes, summed over the cluster's workers."""
    st = [w.segment_pool.stats() for w in cluster.local_workers]
    published = sum(s["published"] for s in st)
    live = sum(s["live_segments"] for s in st)
    return {"published": published, "released": published - live,
            "live": live, "bytes": sum(s["published_bytes"] for s in st)}


def phase_wire(sf: float, check_sf: float, seed: int) -> dict:
    """The wire tier on the card: coordinated TPC-H over real 127.0.0.1
    gRPC sockets (start_localhost_cluster(4), four servers in this
    process, every worker on the card), against the same session's
    in-process cluster.

    1. SF ``sf``: WIRE_QUERIES over gRPC and in-process (InMemoryCluster(4)),
    each cold then warm, default plane ladder and zstd: per query the warm
    seconds of both tiers; device-to-host and host-to-device bytes and
    copies as the table layer counts them (cold and warm gRPC runs), with
    what the profiler's CUDA activity recorded of the cold one and the
    GB/s its copies reached (the coordinator phase measures the copies of
    in-process runs); wire
    bytes as framed and after decompression with what compression saved
    (every frame the process unpacked in the warm gRPC run); SetPlan bytes
    shipped; peak device memory of the warm gRPC run; the card's allocated
    bytes before the query's cluster started and after its shutdown. Each
    gRPC result byte-identical to the in-process run and equal to
    single-node. Launches are counted from 0 over the warm gRPC runs.
    2. SF WIRE_KNOB_SF: WIRE_KNOB_QUERIES under each plane and wire
    compression of WIRE_PLANES (WIRE_KNOB_ONLY's under theirs),
    byte-identical to the in-process run;
    segments published and released, the bytes that went through shm (a
    query whose exchanges take no partition stream publishes none; some
    query must); then q3 under a chaos `segment_lost` schedule on the shm
    plane: a lost segment costs one wire re-pull and gives the same bytes.
    3. The native host hash against the card's `hash_columns` on host
    copies of SF 1 key columns, bit for bit.
    4. At SF ``check_sf`` the WIRE_CHECK_QUERIES over gRPC on the card
    against the CPU (a subprocess that runs meanwhile).
    5. Kernels 1-4 at every shape the phase logged, bit for bit
    against their plain versions. No segment may be left in a pool
    directory and the leak checker must track no live resource."""
    cpu_out = Path(tempfile.mkdtemp()) / "wire_cpu.pkl"
    cpu_worker = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--wire-cpu-worker", str(check_sf), "--out", str(cpu_out)],
        stdout=subprocess.DEVNULL)
    try:
        return _wire_phase(sf, check_sf, seed, cpu_worker, cpu_out)
    finally:
        if cpu_worker.poll() is None:
            cpu_worker.kill()
            cpu_worker.wait()


def _wire_phase(sf, check_sf, seed, cpu_worker, cpu_out) -> dict:
    import gc

    import torch

    from datafusion_distributed_tpu_torch import native, precision
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.ops.hash import hash_columns
    from datafusion_distributed_tpu_torch.ops.table import (
        copy_stats,
        reset_copy_stats,
    )
    from datafusion_distributed_tpu_torch.runtime import (
        chaos,
        leakcheck,
        transport,
    )
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )
    from datafusion_distributed_tpu_torch.runtime.telemetry import (
        DEFAULT_REGISTRY,
    )

    rtol = precision.test_rtol()
    t_phase = time.perf_counter()
    # the codecs this installation can put on the wire (zstd only where the
    # zstandard package is installed; frames ship raw otherwise)
    out: dict = {"codecs": transport.supported_codecs()}
    log(f"[wire] wire codecs here: {out['codecs']}")
    shapes: dict = {"build": {}, "probe": {}, "agg": {}, "fold": {}}
    hk.reset_launch_counts()
    leakcheck.install()
    leakcheck.reset()

    def grpc_cluster():
        return start_localhost_cluster(WIRE_WORKERS, device="cuda",
                                       rpc_timeout_s=WIRE_RPC_TIMEOUT_S)

    def settled() -> int:
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    # --- 1. SF 1: gRPC against in-process -----------------------------------
    ctx = _session("cuda", sf, seed)
    mem = InMemoryCluster(WIRE_WORKERS)
    sqls = dict(_queries(WIRE_QUERIES))
    per_query: dict = {}
    launches: dict = {}
    with _ShipMeter() as ships:
        for q in WIRE_QUERIES:
            sql = sqls[q]
            r: dict = {}
            single = _run(ctx, sql)
            t0 = time.perf_counter()
            cold_mem = _coordinated(ctx, sql, False, mem)[0]
            r["inproc_cold_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            warm_mem = _coordinated(ctx, sql, False, mem)[0]
            r["inproc_s"] = time.perf_counter() - t0
            check(_identical(cold_mem, warm_mem),
                  f"{q}: two in-process runs differ")
            del cold_mem
            before = settled()
            cluster = grpc_cluster()
            try:
                t0 = time.perf_counter()
                cold, r["copies"] = _copies(
                    lambda: _grpc_coordinated(ctx, sql, cluster)[0])
                r["cold_s"] = time.perf_counter() - t0
                check(r["copies"]["d2h"]["bytes"] > 0
                      and r["copies"]["h2d"]["bytes"] > 0,
                      f"{q}: the gRPC run counted no copy between card and "
                      f"host: {r['copies']}")
                ships.take()
                transport.reset_wire_stats()
                _drain_shapes(hk, shapes)
                torch.cuda.reset_peak_memory_stats()
                reset_copy_stats()
                t0 = time.perf_counter()
                warm, coord = _grpc_coordinated(ctx, sql, cluster)
                r["s"] = time.perf_counter() - t0
                r["warm_copies"] = copy_stats()
                r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                for k, v in hk.launches().items():
                    launches[k] = launches.get(k, 0) + v
                _drain_shapes(hk, shapes)
                r["wire"] = transport.wire_stats()
                r["setplan_bytes"], r["setplan_calls"] = ships.take()
                r["planes"] = _planes(coord)
                del coord
            finally:
                cluster.shutdown()
            del cluster
            after = settled()
            r["allocated_before"], r["allocated_after"] = before, after
            check(_identical(cold, warm), f"{q}: two gRPC runs differ")
            check(_identical(warm, warm_mem),
                  f"{q}: the gRPC result differs from the in-process run")
            diff, r["tied"] = _close_or_ties(warm, single, rtol)
            check(diff == "", f"{q} over gRPC differs from single-node in "
                  f"{diff}")
            r["tracked_live"] = _tracked_live()
            check(r["tracked_live"] == 0, f"{q}: the leak checker tracks "
                  f"{r['tracked_live']} live resources")
            per_query[q] = r
            log(f"[wire] {q}: gRPC warm {r['s']:.3f}s against in-process "
                f"{r['inproc_s']:.3f}s; {r} ({_since(t_phase)})")
            del cold, warm, warm_mem, single
    for k in ("build_group_ids", "multiway_probe"):
        check(launches.get(k, 0) > 0,
              f"kernel {k} was not launched by the warm gRPC runs")
    out["queries"] = per_query
    out["launches"] = launches
    out["allocated_differs"] = [
        q for q, r in per_query.items()
        if r["allocated_after"] != r["allocated_before"]]

    # --- 3. the native host hash against the card's ------------------------
    t0 = time.perf_counter()
    native.load()  # built from the checkout's source at first use
    hashes = {"build_s": time.perf_counter() - t0}
    for table, cols in WIRE_HASH_COLUMNS:
        t = ctx.catalog.tables[table]
        n = int(t.num_rows)
        data = [t.column(c).data[:n] for c in cols]
        valid = [t.column(c).validity for c in cols]
        valid = [v[:n] if v is not None else None for v in valid]
        card = hash_columns(data, valid)
        host = [d.cpu().numpy() for d in data]
        host_valid = [v.cpu().numpy() if v is not None else None
                      for v in valid]
        t0 = time.perf_counter()
        got = native.hash_rows(host, host_valid,
                               [t.column(c).dtype for c in cols])
        native_ms = (time.perf_counter() - t0) * 1e3  # host time
        same = bool(np.array_equal(card.cpu().numpy().astype(np.uint32),
                                   got))
        check(same, f"native hash of {table}{cols} differs from the card's")
        hashes[f"{table}({','.join(cols)})"] = {
            "rows": n, "equal": same, "native_ms": native_ms,
            "card_ms": time_ms(lambda: hash_columns(data, valid), 3)}
        del data, valid, card, host, host_valid, got
    out["native_hash"] = hashes
    log(f"[wire] native hash equal to the card's: {hashes} "
        f"({_since(t_phase)})")
    del ctx, mem
    torch.cuda.empty_cache()

    # --- 2. SF 0.1: planes and codecs, segment_lost ------------------------
    knob_ctx = _session("cuda", WIRE_KNOB_SF, seed)
    mem = InMemoryCluster(WIRE_WORKERS)
    cluster = grpc_cluster()
    knobs: dict = {}
    saved = DEFAULT_REGISTRY.counter(
        "dftpu_wire_bytes_saved",
        "Wire bytes avoided (shm references, compression delta)",
        labels=("plane",))
    fallbacks = DEFAULT_REGISTRY.counter(
        "dftpu_shm_fallbacks",
        "Shm segments lost; pulls degraded to the wire path")
    try:
        for q, sql in _queries(WIRE_KNOB_QUERIES):
            base = _coordinated(knob_ctx, sql, False, mem)[0]
            for plane, popts, comps in WIRE_PLANES:
                for comp in comps:
                    if (q in WIRE_KNOB_ONLY
                            and (plane, comp) not in WIRE_KNOB_ONLY[q]):
                        continue
                    pool0 = _pool_totals(cluster)
                    shm0 = saved.value(plane="shm")
                    transport.reset_wire_stats()
                    t0 = time.perf_counter()
                    got, coord = _grpc_coordinated(
                        knob_ctx, sql, cluster,
                        {**popts, "wire_compression": comp})
                    wall = time.perf_counter() - t0
                    _drain_shapes(hk, shapes)
                    check(_identical(got, base),
                          f"{q} over gRPC, data_plane={plane}, "
                          f"wire_compression={comp}: differs from the "
                          "in-process run")
                    pool1 = _pool_totals(cluster)
                    knobs[f"{q} {plane} {comp}"] = {
                        "s": wall, "planes": _planes(coord),
                        "wire": transport.wire_stats(),
                        "segments_published":
                            pool1["published"] - pool0["published"],
                        "segments_released":
                            pool1["released"] - pool0["released"],
                        "shm_bytes": saved.value(plane="shm") - shm0}
                    check(pool1["live"] == 0, f"{q} {plane} {comp}: "
                          f"{pool1['live']} segments left")
                    del coord
            log(f"[wire] SF {WIRE_KNOB_SF} {q}: every plane and codec "
                "byte-identical: "
                f"{ {k: v for k, v in knobs.items() if k.startswith(q)} } "
                f"({_since(t_phase)})")
        check(any(v["segments_published"] for k, v in knobs.items()
                  if " shm " in k), "the shm plane published no segment")
        # one segment_lost schedule on q3: the torn pull is retried over
        # the wire and gives the same bytes
        sql = dict(_queries(("q3",)))["q3"]
        base = _coordinated(knob_ctx, sql, False, mem)[0]
        fb0 = fallbacks.value()
        plan = chaos.one_crash_per_stage(seed, kind="segment_lost")
        got, coord = _grpc_coordinated(
            knob_ctx, sql, cluster, {"data_plane": "shm"},
            wrap=lambda c: chaos.wrap_cluster(c, plan))
        _drain_shapes(hk, shapes)
        check(_identical(got, base),
              "q3 under segment_lost differs from the in-process run")
        lost = {"fallbacks": fallbacks.value() - fb0,
                "retries": coord.faults.get("task_retries"),
                "fired": len(plan.fired)}
        check(lost["fallbacks"] >= 1, f"no segment was lost: {lost}")
        out["segment_lost"] = lost
        log(f"[wire] q3 under segment_lost: byte-identical, {lost} "
            f"({_since(t_phase)})")
        out["pool"] = _pool_totals(cluster)
    finally:
        cluster.shutdown()
    check(out["pool"]["live"] == 0,
          f"segments left in a pool directory: {out['pool']}")
    out["knobs"] = knobs
    out["tracked_live"] = _tracked_live()
    check(out["tracked_live"] == 0,
          f"the leak checker tracks {out['tracked_live']} live resources")
    del knob_ctx, mem, cluster
    gc.collect()
    torch.cuda.empty_cache()

    # --- 4. card against CPU ----------------------------------------------
    gpu = _session("cuda", check_sf, seed)
    small = grpc_cluster()
    try:
        card = {q: _grpc_coordinated(gpu, sql, small)[0]
                for q, sql in _queries(WIRE_CHECK_QUERIES)}
    finally:
        small.shutdown()
    _drain_shapes(hk, shapes)
    check(cpu_worker.wait(timeout=WIRE_CPU_TIMEOUT_S) == 0,
          f"the CPU worker exited {cpu_worker.returncode}")
    with open(cpu_out, "rb") as f:
        cpu_results = pickle.load(f)
    identical = 0
    for q in WIRE_CHECK_QUERIES:
        diff = _close(card[q], cpu_results[q], rtol)
        check(diff == "", f"{q} over gRPC: cuda and cpu differ in {diff}")
        identical += _identical(card[q], cpu_results[q])
    out["card_cpu_identical"] = identical
    log(f"[wire] SF {check_sf}: {len(WIRE_CHECK_QUERIES)} queries over gRPC "
        f"equal on cuda and cpu, {identical} byte for byte "
        f"({_since(t_phase)})")
    del gpu, card

    # --- 5. every logged shape against the plain version -------------------
    dev = torch.device("cuda")
    out["kernel_checks"] = {
        "build_group_ids": build_shape_checks(
            [[n, lanes, h, c] for (n, lanes, h), c
             in shapes["build"].items()], dev, "wire"),
        "multiway_probe": probe_shape_checks(
            [[n, k, lanes, list(s), c] for (n, k, lanes, s), c
             in shapes["probe"].items()], dev, "wire"),
        "group_aggregate": agg_shape_checks(shapes["agg"], dev, "wire"),
        "group_fold": fold_shape_checks(shapes["fold"], dev, "wire"),
    }
    out["shapes"] = {k: len(v) for k, v in shapes.items()}
    log(f"[wire] shapes checked: {out['shapes']} ({_since(t_phase)})")
    return out


# ---------------------------------------------------------------------------
# phase 14: the tools (cli, tracing, console, work-unit feeds, lockcheck)
# ---------------------------------------------------------------------------

TOOLS_TRACED = ("q3", "q5")  # traced through the coordinator at SF 1
TOOLS_WORKERS = 4  # in-memory workers of the traced runs
TOOLS_GRPC_WORKERS = 2  # localhost gRPC workers: console, lockcheck, crash
TOOLS_FEED_SLICES = 4  # parquet slices of lineitem fed to the scan
TOOLS_FEED_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
                      "l_extendedprice", "l_discount", "l_orderkey")
TOOLS_FEED_SQL = (
    "select l_returnflag, l_linestatus, count(*) as n, "
    "sum(l_quantity) as qty, sum(l_extendedprice) as price, "
    "max(l_discount) as top, min(l_orderkey) as lo from li "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
TOOLS_LOCK_SF = 0.1  # the served mix under the lock-order harness
TOOLS_LOCK_MIX = ("q1", "q6") * 4  # submitted at once, twice (cold, warm)
TOOLS_CRASH_SF = 0.01  # three fresh gRPC clusters in a row, jax blocked
TOOLS_CRASH_PLANES = ("shm", "stream", "shm")
TOOLS_STAR = ("select s_nationkey, count(*) n from lineitem join orders on "
              "l_orderkey = o_orderkey join part on l_partkey = p_partkey "
              "join supplier on l_suppkey = s_suppkey group by s_nationkey "
              "order by s_nationkey")
TOOLS_SUB_TIMEOUT_S = 300


def lockcheck_worker(sf: float, out_path: str) -> int:
    """The served q1/q6 mix (TOOLS_LOCK_MIX, all submitted at once, cold
    then warm) through ServingSession over TOOLS_GRPC_WORKERS localhost
    gRPC workers on the card at SF ``sf``, each result equal to
    single-node; with DFTPU_LOCK_CHECK=1 in the environment every lock the
    port creates is instrumented (the package installs the harness at
    import). Writes the walls and the harness's report as JSON; a
    lock-order cycle raised anywhere fails it."""
    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.runtime import lockcheck
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )
    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )

    violations: list = []

    class Recorded(lockcheck.LockOrderViolation):
        """Every violation, also one that a thread's handler swallows."""

        def __init__(self, *a):
            super().__init__(*a)
            violations.append(str(self)[:4000])

    lockcheck.LockOrderViolation = Recorded
    rtol = precision.test_rtol()
    ctx = _session("cuda", sf, SEED)
    sqls = dict(_queries(sorted(set(TOOLS_LOCK_MIX))))
    want = {q: _run(ctx, sql) for q, sql in sqls.items()}
    cluster = start_localhost_cluster(TOOLS_GRPC_WORKERS, device="cuda",
                                      rpc_timeout_s=WIRE_RPC_TIMEOUT_S)
    walls = []
    try:
        with ServingSession(ctx, cluster=cluster,
                            num_tasks=TOOLS_GRPC_WORKERS) as srv:
            for _ in range(2):
                t0 = time.perf_counter()
                handles = [(q, srv.submit(sqls[q])) for q in TOOLS_LOCK_MIX]
                got = [(q, _served(h)) for q, h in handles]
                walls.append(time.perf_counter() - t0)
                for q, g in got:
                    diff = _close(g, want[q], rtol)
                    check(diff == "", f"served {q} differs from single-node "
                          f"in {diff}")
    finally:
        cluster.shutdown()
    torch.cuda.synchronize()
    check(not violations, f"lock-order cycles: {violations}")
    rep = lockcheck.report()
    out = {
        "installed": lockcheck.enabled(), "cold_s": walls[0],
        "warm_s": walls[1], "queries": len(TOOLS_LOCK_MIX),
        "violations": len(violations),
        "static_edges": (len(rep["static_edges"])
                         if rep["static_edges"] is not None else None),
        "edges": [{k: e[k] for k in ("src", "dst", "count", "status")}
                  for e in rep["observed_edges"]],
        "hold_outliers": [{k: o[k] for k in ("lock", "held_s", "thread")}
                          for o in rep["hold_outliers"]],
        "events": [{"kind": e["kind"], "locks_held": e["locks_held"],
                    "thread": e["thread"]} for e in rep["events"]],
    }
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def crash_worker(sf: float, out_path: str) -> int:
    """The wire tier's crash repro on the card: with jax blocked, the star
    query TOOLS_STAR over three fresh localhost gRPC clusters in a row
    (TOOLS_CRASH_PLANES), each result equal to single-node. Before the
    package loaded libarrow at import, a stream thread's first Arrow
    allocation after another such thread exited crashed the process."""
    sys.modules["jax"] = None
    import torch

    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
    )
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )

    ctx = _session("cuda", sf, SEED)
    ctx.sql("SET distributed.multiway_join = true")
    want = _run(ctx, TOOLS_STAR)
    out = {}
    for i, plane in enumerate(TOOLS_CRASH_PLANES):
        t0 = time.perf_counter()
        cluster = start_localhost_cluster(TOOLS_GRPC_WORKERS, device="cuda",
                                          rpc_timeout_s=WIRE_RPC_TIMEOUT_S)
        try:
            coord = Coordinator(resolver=cluster, channels=cluster,
                                config_options={"data_plane": plane})
            got = ctx.sql(TOOLS_STAR).collect_coordinated_table(
                coordinator=coord, num_tasks=WIRE_TASKS).to_numpy()
        finally:
            cluster.shutdown()
        torch.cuda.synchronize()
        check(_identical(got, want),
              f"cluster {i} ({plane}): the star query differs from "
              "single-node")
        out[f"{i} {plane}"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def _plain_text(frame: str) -> str:
    return re.sub(r"\x1b\[[0-9;]*m", "", frame)


def phase_tools(sf: float, seed: int) -> dict:
    """The operator's tools on the card.

    1. cli: `cli.main(["--tpch", sf, "-c", q3])` on the card (its --tpch
    registers the run's generated tables, seed ``seed``, instead of
    generating them again); the printed rows equal single-node q3.
    2. Tracing: TOOLS_TRACED through Coordinator over
    InMemoryCluster(TOOLS_WORKERS) at 4 tasks, untraced then traced (`SET
    distributed.tracing`), warm: the result byte-identical either way,
    `ctx.last_trace()`'s event count, `trace_coverage`, the first lines of
    `ctx.last_trace_profile()` and the seconds tracing adds.
    3. Console: `Console.render_frame()` over TOOLS_GRPC_WORKERS localhost
    gRPC workers on the card after q3 over them (equal to in-process),
    with the worker rows and the data-plane line, and its render time.
    4. Work-unit feed: TOOLS_FEED_SLICES parquet slices of lineitem's
    TOOLS_FEED_COLUMNS streamed to one task and read by a WorkUnitScanExec
    under TOOLS_FEED_SQL's GROUP BY: equal to the GROUP BY over the whole
    table; every unit's four timestamps.
    Launches are counted from 0 over parts 1-4.
    5. Kernels 1-4 at every shape parts 1-4 logged, bit for bit
    against their plain versions.
    6. lockcheck: the served mix of `lockcheck_worker` at SF TOOLS_LOCK_SF
    in a subprocess with DFTPU_LOCK_CHECK=0 and, at the same time, in one
    with DFTPU_LOCK_CHECK=1 (observed edges, static or new; hold outliers;
    events; no lock-order cycle).
    7. Meanwhile, the crash repro of `crash_worker` in a subprocess at SF
    TOOLS_CRASH_SF."""
    import contextlib
    import gc
    import io
    import shutil

    import pyarrow.parquet as pq
    import torch

    from datafusion_distributed_tpu_torch import cli, precision
    from datafusion_distributed_tpu_torch.console import Console
    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.io.parquet import table_to_arrow
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.ops.table import Table
    from datafusion_distributed_tpu_torch.plan.physical import execute_plan
    from datafusion_distributed_tpu_torch.runtime import tracing
    from datafusion_distributed_tpu_torch.runtime import (
        work_unit_feed as wuf,
    )
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )

    rtol = precision.test_rtol()
    t_phase = time.perf_counter()
    out: dict = {}
    shapes: dict = {"build": {}, "probe": {}, "agg": {}, "fold": {}}
    launches: dict = {}

    def take() -> None:
        for k, v in hk.launches().items():
            launches[k] = launches.get(k, 0) + v
        _drain_shapes(hk, shapes)

    ctx = _session("cuda", sf, seed)
    sqls = dict(_queries(TOOLS_TRACED))
    single = {q: _run(ctx, sql) for q, sql in sqls.items()}
    hk.reset_launch_counts()

    # --- 1. the cli --------------------------------------------------------
    cached = _TABLES[("cuda", sf, seed)]
    generate = tpchgen.register_tpch

    def registered(c, sf=0.01, seed=0):
        for name, table in cached.items():
            c.register_table(name, table)

    tpchgen.register_tpch = registered
    printed = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["--tpch", str(sf), "-c", sqls["q3"]])
        cli_s = time.perf_counter() - t0
    finally:
        tpchgen.register_tpch = generate
    torch.cuda.synchronize()
    take()
    lines = printed.getvalue().splitlines()
    keys = [int(ln.split()[0]) for ln in lines
            if ln.split() and ln.split()[0].isdigit()]
    want = single["q3"]["l_orderkey"].tolist()
    check(rc == 0 and keys == want,
          f"cli -c q3 printed keys {keys}, single-node {want}")
    check(f"({len(want)} rows in" in lines[-1],
          f"cli footer: {lines[-1]!r}")
    out["cli"] = {"s": cli_s, "rows": len(keys), "footer": lines[-1],
                  "header": lines[1] if len(lines) > 1 else ""}
    log(f"[tools] cli -c q3 on the card: {out['cli']} ({_since(t_phase)})")

    # --- 2. tracing --------------------------------------------------------
    mem = InMemoryCluster(TOOLS_WORKERS)
    traced: dict = {}
    for q in TOOLS_TRACED:
        sql = sqls[q]
        _coordinated(ctx, sql, False, mem)  # cold
        t0 = time.perf_counter()
        plain = _coordinated(ctx, sql, False, mem)[0]
        off_s = time.perf_counter() - t0
        ctx.config.distributed_options["tracing"] = "on"
        try:
            t0 = time.perf_counter()
            got = _coordinated(ctx, sql, False, mem)[0]
            on_s = time.perf_counter() - t0
        finally:
            ctx.config.distributed_options.pop("tracing", None)
        chrome = ctx.last_trace()
        profile = ctx.last_trace_profile()
        trace = tracing.DEFAULT_TRACE_STORE.last()
        cov, gap = tracing.trace_coverage(trace)
        check(_identical(got, plain), f"traced {q} differs from untraced")
        diff, _ = _close_or_ties(got, single[q], rtol)
        check(diff == "", f"traced {q} differs from single-node in {diff}")
        check(chrome is not None and chrome["traceEvents"]
              and profile.startswith("-- trace profile"),
              f"{q}: no trace recorded")
        traced[q] = {"untraced_s": off_s, "traced_s": on_s,
                     "events": len(chrome["traceEvents"]),
                     "spans": len(trace.span_list()),
                     "coverage": cov, "max_gap": gap,
                     "profile_head": profile.splitlines()[:6]}
        log(f"[tools] traced {q}: {traced[q]} ({_since(t_phase)})")
        del plain, got, chrome, trace
    take()
    out["tracing"] = traced
    del mem

    # --- 3. the console over gRPC workers ----------------------------------
    cluster = start_localhost_cluster(TOOLS_GRPC_WORKERS, device="cuda",
                                      rpc_timeout_s=WIRE_RPC_TIMEOUT_S)
    try:
        got, coord = _grpc_coordinated(ctx, sqls["q3"], cluster)
        con = Console(cluster, cluster, health=coord.health,
                      faults=coord.faults)
        t0 = time.perf_counter()
        frame = _plain_text(con.render_frame())
        render_ms = (time.perf_counter() - t0) * 1e3
        del coord
    finally:
        cluster.shutdown()
    take()
    diff, _ = _close_or_ties(got, single["q3"], rtol)
    check(diff == "", f"q3 over gRPC differs from single-node in {diff}")
    # each section by its own header: the tracing line also names the data
    # plane, and a section that raised renders as "<label> unavailable"
    check(f"workers ({TOOLS_GRPC_WORKERS} active" in frame
          and re.search(r"^data plane  staged ", frame, re.M) is not None
          and "unavailable" not in frame and "DOWN" not in frame,
          f"console frame lacks a section:\n{frame}")
    out["console"] = {"render_ms": render_ms, "frame": frame.splitlines()}
    log(f"[tools] console frame ({render_ms:.1f} ms):\n{frame}")
    del got

    # --- 4. a work-unit feed under a GROUP BY ------------------------------
    li = ctx.catalog.tables["lineitem"]
    sub = Table(TOOLS_FEED_COLUMNS,
                tuple(li.column(c) for c in TOOLS_FEED_COLUMNS), li.num_rows)
    t0 = time.perf_counter()
    arrow = table_to_arrow(sub)
    tmp = Path(tempfile.mkdtemp(prefix="feed_"))
    bounds = np.linspace(0, arrow.num_rows, TOOLS_FEED_SLICES + 1).astype(int)
    paths = []
    for i in range(TOOLS_FEED_SLICES):
        paths.append(str(tmp / f"lineitem_{i}.parquet"))
        pq.write_table(arrow.slice(bounds[i], bounds[i + 1] - bounds[i]),
                       paths[-1])
    write_s = time.perf_counter() - t0
    try:
        ctx.register_arrow("li", arrow)
        whole = _run(ctx, TOOLS_FEED_SQL)
        reg = ctx.catalog.tables["li"]
        dicts = {n: c.dictionary for n, c in zip(reg.names, reg.columns)
                 if c.dictionary is not None}
        df = ctx.sql(TOOLS_FEED_SQL)
        plan = df.physical_plan()
        (leaf,) = plan.collect(lambda n: not n.children())
        feeds = wuf.WorkUnitFeedRegistry()
        fid = feeds.register(lambda: iter(paths))
        remote = wuf.RemoteWorkUnitFeedRegistry()
        units: list = []

        def route(unit, task_count):
            units.append(unit)
            return 0

        t0 = time.perf_counter()
        sent = wuf.stream_feed(feeds, remote, fid, route, 1)
        scan = wuf.WorkUnitScanExec(fid, leaf.schema(),
                                    leaf.output_capacity(), remote,
                                    dictionaries=dicts, device="cuda")

        def swap(node):
            kids = node.children()
            if not kids:
                return scan
            return node.with_new_children([swap(k) for k in kids])

        fed = type(df)._strip_quals(execute_plan(swap(plan))).to_numpy()
        torch.cuda.synchronize()
        feed_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    take()
    check(sent == TOOLS_FEED_SLICES, f"the feed sent {sent} units")
    diff = _close(fed, whole, rtol)
    check(diff == "", f"the fed GROUP BY differs from the whole table's "
          f"in {diff}")
    base = units[0].created_at
    out["feed"] = {
        "rows": arrow.num_rows, "units": sent, "write_s": write_s,
        "feed_s": feed_s, "identical": _identical(fed, whole),
        "groups": len(next(iter(fed.values()))),
        # ms after the first unit's creation: created, sent, received,
        # processed
        "unit_ms": [[round((getattr(u, k) - base) * 1e3, 3) for k in (
            "created_at", "sent_at", "received_at", "processed_at")]
            for u in units]}
    log(f"[tools] work-unit feed: {out['feed']} ({_since(t_phase)})")
    for k in ("build_group_ids", "multiway_probe"):
        check(launches.get(k, 0) > 0,
              f"kernel {k} was not launched by the tools' runs")
    out["launches"] = launches
    del ctx, li, sub, arrow, reg, df, plan, leaf, scan, fed, whole
    gc.collect()
    torch.cuda.empty_cache()

    # --- 5. every logged shape against the plain version -------------------
    dev = torch.device("cuda")
    out["kernel_checks"] = {
        "build_group_ids": build_shape_checks(
            [[n, lanes, h, c] for (n, lanes, h), c
             in shapes["build"].items()], dev, "tools"),
        "multiway_probe": probe_shape_checks(
            [[n, k, lanes, list(s), c] for (n, k, lanes, s), c
             in shapes["probe"].items()], dev, "tools"),
        "group_aggregate": agg_shape_checks(shapes["agg"], dev, "tools"),
        "group_fold": fold_shape_checks(shapes["fold"], dev, "tools"),
    }
    out["shapes"] = {k: len(v) for k, v in shapes.items()}
    log(f"[tools] shapes checked: {out['shapes']} ({_since(t_phase)})")

    # --- 6 and 7: the lock-order harness off and on, side by side (the
    # same work at the same time), and the crash repro meanwhile
    runs = _side_by_side({
        "off": (["--lockcheck-worker", str(TOOLS_LOCK_SF)],
                dict(os.environ, DFTPU_LOCK_CHECK="0")),
        "on": (["--lockcheck-worker", str(TOOLS_LOCK_SF)],
               dict(os.environ, DFTPU_LOCK_CHECK="1")),
        "crash": (["--crash-worker", str(TOOLS_CRASH_SF)],
                  dict(os.environ, DFTPU_LOCK_CHECK="0")),
    }, TOOLS_SUB_TIMEOUT_S)
    lock = {"off": runs["off"], "on": runs["on"]}
    check(not lock["off"]["installed"] and lock["on"]["installed"],
          f"the harness installed: off {lock['off']['installed']}, on "
          f"{lock['on']['installed']}")
    check(lock["on"]["edges"], "the harness observed no lock-order edge")
    # without the static graph every edge reads "unknown", never "new"
    check(lock["on"]["static_edges"] is not None,
          "the harness did not load the static lock graph")
    out["lockcheck"] = lock
    log(f"[tools] lockcheck off / on: warm {lock['off']['warm_s']:.3f} / "
        f"{lock['on']['warm_s']:.3f} s; {lock['on']} ({_since(t_phase)})")
    out["crash_repro"] = runs["crash"]
    log(f"[tools] three fresh gRPC clusters, jax blocked: "
        f"{out['crash_repro']} ({_since(t_phase)})")
    return out


# ---------------------------------------------------------------------------
# phase 15: meshes-as-workers (span dispatch over mesh workers)
# ---------------------------------------------------------------------------

MESH_WORKERS = 2  # mesh workers of the cluster
MESH_WIDTH = 4  # local tasks (devices) a worker
MESH_TASKS = 8  # tasks a stage: one span of 4 on each worker
#: scans, the five- and six-way joins, the big GROUP BY (the anti-join
#: q21 until PR 16: its SF 1 runs over the mesh workers and the SPMD ranks,
#: ~30 s, went to the adaptive phase; it still runs in both phases' 22
#: queries at SF 0.1)
MESH_QUERIES = ("q1", "q3", "q5", "q9", "q18")
#: the queries rerun over workers that keep their spans, as the JAX
#: package's do (the retention peaks at q9, 21.3 GB after it on the card)
MESH_KEPT_QUERIES = ("q3", "q9")
MESH_ALL_SF = 0.1  # all 22 queries over the mesh workers


def _count_calls(cluster, names) -> dict:
    """Count the calls of each named control-plane method on every worker
    of ``cluster`` (the wrappers keep the signatures the coordinator
    inspects). -> the counts, a dict updated in place."""
    import functools
    import threading

    counts = {n: 0 for n in names}
    lock = threading.Lock()
    for w in cluster.workers.values():
        for n in names:
            original = getattr(w, n)

            def counted(*a, _original=original, _n=n, **kw):
                with lock:
                    counts[_n] += 1
                return _original(*a, **kw)

            setattr(w, n, functools.wraps(original)(counted))
    return counts


def _mesh_coordinated(ctx, sql: str, cluster, spans_kept=False) -> dict:
    """One query through Coordinator over ``cluster`` at MESH_TASKS tasks;
    every worker's store, task registry and (unless ``spans_kept``) span
    states must be empty afterwards (a mesh worker drops a span once its
    tasks are gone)."""
    import torch

    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        Coordinator,
    )

    coord = Coordinator(resolver=cluster, channels=cluster,
                        config_options=ctx.config.distributed_snapshot())
    table = ctx.sql(sql).collect_coordinated_table(coordinator=coord,
                                                   num_tasks=MESH_TASKS)
    out = table.to_numpy()
    torch.cuda.synchronize()
    for w in cluster.workers.values():
        check(not w.table_store.tables and len(w.registry) == 0
              and (spans_kept or not getattr(w, "_spans", {})),
              f"worker {w.url} kept {len(w.table_store.tables)} staged "
              f"tables, {len(w.registry)} tasks and "
              f"{len(getattr(w, '_spans', {}))} spans after the query")
    return out


def phase_mesh(sf: float, seed: int) -> dict:
    """Meshes-as-workers on the card: `InMemoryMeshCluster(MESH_WORKERS,
    MESH_WIDTH, devices=[cuda] * 8)`, MESH_TASKS tasks, so that each
    stage ships one span plan to each worker.

    1. MESH_QUERIES at SF ``sf`` through Coordinator over the mesh
    workers, cold then warm, and beside them over
    InMemoryCluster(MESH_WORKERS) at the same task count with per-task
    dispatch (after the mesh runs, so its plans and statistics are
    warm): warm seconds of both, spans run per worker, set_stage_plan
    calls against set_plan calls, peak device memory; every result equal
    to the same session's single-node result. Launches are counted from 0
    over the warm mesh runs.
    2. All 22 queries at SF MESH_ALL_SF over the mesh workers, each equal
    to single-node.
    3. The card's allocated bytes before the cluster, after the runs and
    after the cluster is released; then MESH_KEPT_QUERIES once more over
    mesh workers that keep their last spans as the JAX package's do (no
    release when a span's tasks are gone): the bytes they hold after each
    query.
    4. Kernels 1-4 at every shape the phase logged (the
    single-node reference runs excluded), bit for bit against their plain
    versions; kernel 3's launches are reported by part."""
    import functools
    import gc

    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.mesh_worker import (
        InMemoryMeshCluster,
    )
    from datafusion_distributed_tpu_torch.runtime.worker import Worker

    rtol = precision.test_rtol()
    t_phase = time.perf_counter()
    out: dict = {}
    shapes: dict = {"build": {}, "probe": {}, "agg": {}, "fold": {}}
    launches: dict = {}

    def settled() -> int:
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    ctx = _session("cuda", sf, seed)
    sqls = dict(_queries(MESH_QUERIES))
    single = {q: _run(ctx, sql) for q, sql in sqls.items()}
    hk.reset_launch_counts()
    allocated = {"before": settled()}
    cards = [torch.device("cuda")] * (MESH_WORKERS * MESH_WIDTH)
    mesh = InMemoryMeshCluster(MESH_WORKERS, MESH_WIDTH, devices=cards)
    per_task = InMemoryCluster(MESH_WORKERS)
    mesh_calls = _count_calls(mesh, ("set_stage_plan", "set_plan"))
    task_calls = _count_calls(per_task, ("set_plan",))

    # --- 1. the mix at SF 1: spans against per-task dispatch --------------
    per_query: dict = {}
    for q, sql in sqls.items():
        r: dict = {}
        t0 = time.perf_counter()
        cold = _mesh_coordinated(ctx, sql, mesh)
        r["cold_s"] = time.perf_counter() - t0
        _drain_shapes(hk, shapes)
        runs0 = {u: w.spans_run for u, w in mesh.workers.items()}
        calls0 = dict(mesh_calls)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm = _mesh_coordinated(ctx, sql, mesh)
        r["s"] = time.perf_counter() - t0
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for k, v in hk.launches().items():
            launches[k] = launches.get(k, 0) + v
        _drain_shapes(hk, shapes)
        r["spans"] = {u: w.spans_run - runs0[u]
                      for u, w in mesh.workers.items()}
        r["set_stage_plan"] = mesh_calls["set_stage_plan"] - calls0[
            "set_stage_plan"]
        r["mesh_set_plan"] = mesh_calls["set_plan"] - calls0["set_plan"]
        check(any(r["spans"].values()), f"{q}: no span ran")
        check(_identical(cold, warm), f"{q}: two mesh runs differ")
        calls0 = task_calls["set_plan"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tasks = _mesh_coordinated(ctx, sql, per_task)
        r["per_task_s"] = time.perf_counter() - t0
        r["per_task_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["set_plan"] = task_calls["set_plan"] - calls0
        _drain_shapes(hk, shapes)
        diff, r["tied"] = _close_or_ties(warm, single[q], rtol)
        check(diff == "", f"{q} over mesh workers differs from single-node "
              f"in {diff}")
        diff, _tied = _close_or_ties(tasks, single[q], rtol)
        check(diff == "", f"{q} with per-task dispatch differs from "
              f"single-node in {diff}")
        r["identical_to_per_task"] = _identical(warm, tasks)
        per_query[q] = r
        log(f"[mesh] {q}: spans warm {r['s']:.3f}s against per-task "
            f"{r['per_task_s']:.3f}s; {r} ({_since(t_phase)})")
        del cold, warm, tasks
    for u in mesh.workers:
        check(any(r["spans"][u] for r in per_query.values()),
              f"mesh worker {u} ran no span in the warm runs")
    for k in ("build_group_ids", "multiway_probe"):
        check(launches.get(k, 0) > 0,
              f"kernel {k} was not launched by the warm mesh runs")
    out["queries"] = per_query
    out["launches"] = launches
    out["sf1_s"] = time.perf_counter() - t_phase
    out["warm_s"] = sum(r["s"] for r in per_query.values())
    out["per_task_s"] = sum(r["per_task_s"] for r in per_query.values())
    allocated["after_sf1"] = settled()

    # --- 2. all 22 queries at SF 0.1 --------------------------------------
    small = _session("cuda", MESH_ALL_SF, seed)
    singles = {q: _run(small, sql) for q, sql in _queries(QUERIES)}
    hk.reset_launch_counts()  # the single-node runs' shapes are not the path's
    all22: dict = {}
    t0 = time.perf_counter()
    for q, sql in _queries(QUERIES):
        got = _mesh_coordinated(small, sql, mesh)
        diff, tied = _close_or_ties(got, singles[q], rtol)
        check(diff == "", f"{q} at SF {MESH_ALL_SF} over mesh workers "
              f"differs from single-node in {diff}")
        all22[q] = {"rows": len(next(iter(got.values()))), "tied": tied}
    kernel3 = hk.launches().get("group_aggregate", 0)
    _drain_shapes(hk, shapes)
    out["all22"] = {"s": time.perf_counter() - t0, "queries": all22,
                    "group_aggregate_launches": kernel3}
    log(f"[mesh] SF {MESH_ALL_SF}: all 22 over mesh workers equal to "
        f"single-node in {out['all22']['s']:.1f}s ({_since(t_phase)})")
    del small

    # --- 3. the card's allocated bytes ------------------------------------
    out["spans_run"] = {u: w.spans_run for u, w in mesh.workers.items()}
    out["calls"] = {"mesh": dict(mesh_calls), "per_task": dict(task_calls)}
    allocated["after_runs"] = settled()
    del mesh, per_task
    allocated["after_release"] = settled()
    out["allocated"] = allocated
    log(f"[mesh] allocated bytes: {allocated} ({_since(t_phase)})")
    # what the JAX package's retention would hold: the same warm mix over
    # workers that keep their last MAX_SPANS spans (no release when a
    # span's tasks are gone)
    kept = InMemoryMeshCluster(MESH_WORKERS, MESH_WIDTH, devices=cards)
    for kw in kept.workers.values():
        kw.registry.on_evict = functools.partial(Worker._on_task_evict, kw)
    del kw
    retained = {}
    for q in MESH_KEPT_QUERIES:
        got = _mesh_coordinated(ctx, sqls[q], kept, spans_kept=True)
        diff, _tied = _close_or_ties(got, single[q], rtol)
        check(diff == "", f"{q} with spans kept differs from single-node "
              f"in {diff}")
        retained[q] = {"allocated": settled() - allocated["after_release"],
                       "spans": sum(len(w._spans)
                                    for w in kept.workers.values())}
    del kept
    retained["after_release"] = settled() - allocated["after_release"]
    _drain_shapes(hk, shapes)
    out["spans_kept"] = retained
    log(f"[mesh] with spans kept as the JAX package keeps them, bytes "
        f"above the released baseline: {retained} ({_since(t_phase)})")
    del ctx, single

    # --- 4. every logged shape against the plain version -------------------
    t_checks = time.perf_counter()
    dev = torch.device("cuda")
    out["kernel3_shapes"] = len(shapes["agg"])
    log(f"[mesh] kernel 3 (group_aggregate): "
        f"{launches.get('group_aggregate', 0)} launches in the warm runs at "
        f"SF {sf}, {out['all22']['group_aggregate_launches']} over the 22 "
        f"queries at SF {MESH_ALL_SF}, {len(shapes['agg'])} shapes in the "
        "phase")
    out["kernel_checks"] = {
        "build_group_ids": build_shape_checks(
            [[n, lanes, h, c] for (n, lanes, h), c
             in shapes["build"].items()], dev, "mesh"),
        "multiway_probe": probe_shape_checks(
            [[n, k, lanes, list(s), c] for (n, k, lanes, s), c
             in shapes["probe"].items()], dev, "mesh"),
        "group_aggregate": agg_shape_checks(shapes["agg"], dev, "mesh"),
        "group_fold": fold_shape_checks(shapes["fold"], dev, "mesh"),
    }
    out["shapes"] = {k: len(v) for k, v in shapes.items()}
    out["checks_s"] = time.perf_counter() - t_checks
    log(f"[mesh] shapes checked: {out['shapes']} ({_since(t_phase)})")
    return out


# ---------------------------------------------------------------------------
# phase 15b: the port's examples on the card
# ---------------------------------------------------------------------------

EXAMPLE_ROWS = 1 << 23  # lineitem's padded capacity at TPC-H SF 1
EXAMPLE_CHECK_ROWS = 20_000  # card against CPU
#: the SPMD pair: the in-process examples here, over the ranks in `spmd`
EXAMPLES_SPMD = ("custom_partial_reduction_tree", "mesh_spmd_query")


def phase_examples() -> dict:
    """The port's examples (`datafusion_distributed_tpu_torch/examples/`)
    on the card, each through its ``run()`` as a user calls it.

    Every ``run()`` returns ``{"frames", "facts", "observed"}``
    (`examples/_common.py`).
    1. Each at EXAMPLE_ROWS rows (its own key domains; the work-unit feed
    as 4 parquet files of EXAMPLE_ROWS / 4 rows), cold then warm: seconds
    of both, the warm run's peak allocated bytes above what was allocated
    before it, its frames' rows, its facts (but the plan texts) and what
    it observed; the warm run's frames and facts equal to the cold run's.
    Launches are counted from 0 over the warm runs.
    2. Each at EXAMPLE_CHECK_ROWS rows on "cuda" and on "cpu" in this
    process: frames equal (ints, strings and row order exact, floats at
    precision.test_rtol()), and the facts (plans, clamped rows, routes,
    epochs, the refusal, fed rows and sums, the console's sections)
    exactly.
    3. Kernels 1-4 at every shape the card's runs logged, against
    their plain versions.
    The SPMD pair runs over the ranks in the spmd phase."""
    import importlib

    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.examples import EXAMPLES
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    t_phase = time.perf_counter()
    rtol = precision.test_rtol()
    shapes = {"build": {}, "probe": {}, "agg": {}, "fold": {}}
    launches: dict = {}
    out: dict = {"rows": EXAMPLE_ROWS, "examples": {}}
    hk.reset_launch_counts()
    for name in EXAMPLES:
        mod = importlib.import_module(
            f"datafusion_distributed_tpu_torch.examples.{name}")

        def run(device, n):
            t0 = time.perf_counter()
            r = mod.run(device=device, n=n)
            if device == "cuda":
                torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        cold, cold_s = run("cuda", EXAMPLE_ROWS)
        _drain_shapes(hk, shapes)
        # the run's own peak: above what earlier phases left allocated
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        warm, s = run("cuda", EXAMPLE_ROWS)
        mine = hk.launches()
        for k, v in mine.items():
            launches[k] = launches.get(k, 0) + v
        _drain_shapes(hk, shapes)
        rec = {"cold_s": cold_s, "s": s,
               "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
               "launches": mine,
               "rows": {k: len(next(iter(f.values())))
                        for k, f in warm["frames"].items()},
               "facts": {k: v for k, v in warm["facts"].items()
                         if k != "plan"},
               "observed": warm["observed"]}
        for key, f in warm["frames"].items():
            check(_identical(f, cold["frames"][key]),
                  f"{name}: the warm run's {key} differs from the cold run's")
        check(warm["facts"] == cold["facts"],
              f"{name}: the warm run's facts differ from the cold run's")
        del cold, warm
        # card against CPU at EXAMPLE_CHECK_ROWS
        card, _s = run("cuda", EXAMPLE_CHECK_ROWS)
        _drain_shapes(hk, shapes)
        host, _s = run("cpu", EXAMPLE_CHECK_ROWS)
        hk.reset_launch_counts()
        for key, f in card["frames"].items():
            diff = _close(f, host["frames"][key], rtol)
            check(diff == "", f"{name} at {EXAMPLE_CHECK_ROWS} rows: the "
                  f"card's {key} differs from the CPU's in {diff}")
        check(card["facts"] == host["facts"],
              f"{name} at {EXAMPLE_CHECK_ROWS} rows: the card's facts "
              f"{card['facts']} differ from the CPU's {host['facts']}")
        rec["card_cpu_equal"] = True
        out["examples"][name] = rec
        del card, host
        torch.cuda.empty_cache()
        log(f"[examples] {name}: {rec} ({_since(t_phase)})")
    out["launches"] = launches
    for k in ("build_group_ids", "multiway_probe"):
        check(launches.get(k, 0) > 0,
              f"kernel {k} was not launched by the examples' warm runs")
    log(f"[examples] launches over the warm runs: {launches}")

    t_checks = time.perf_counter()
    dev = torch.device("cuda")
    out["kernel_checks"] = {
        "build_group_ids": build_shape_checks(
            [[n, lanes, h, c] for (n, lanes, h), c
             in shapes["build"].items()], dev, "examples"),
        "multiway_probe": probe_shape_checks(
            [[n, k, lanes, list(s), c] for (n, k, lanes, s), c
             in shapes["probe"].items()], dev, "examples"),
        "group_aggregate": agg_shape_checks(shapes["agg"], dev, "examples"),
        "group_fold": fold_shape_checks(shapes["fold"], dev, "examples"),
    }
    out["shapes"] = {k: len(v) for k, v in shapes.items()}
    out["checks_s"] = time.perf_counter() - t_checks
    log(f"[examples] shapes checked: {out['shapes']} ({_since(t_phase)})")
    return out


# ---------------------------------------------------------------------------
# phase 16: the SPMD tier, gloo ranks sharing the card
# ---------------------------------------------------------------------------

SPMD_RANKS = 4  # gloo ranks on the one card: NCCL refuses two on one device
SPMD_ALL_SF = 0.1  # (a) all 22 queries
SPMD_QUERIES = MESH_QUERIES  # (b) over the ranks, (c) on NCCL
SPMD_COLLECTIVE_TIMEOUT_S = 240  # every group's collectives
SPMD_TIMEOUT_S = 300  # the ranks' wall, startup included


def _dump_tables(tables: dict, path: Path) -> None:
    """The registered tables as host buffers, every padded row (so that a
    rank's tables have the capacities the plans were sized on), in one
    pickle."""
    out = {}
    for name, t in tables.items():
        out[name] = (t.names, int(t.num_rows), [
            (c.data.cpu().numpy(),
             None if c.validity is None else c.validity.cpu().numpy(),
             c.dtype.value,
             None if c.dictionary is None else c.dictionary.values)
            for c in t.columns])
    path.write_bytes(pickle.dumps(out, protocol=5))


def _spmd_session(path: str, device):
    """A session over the tables `_dump_tables` wrote, on ``device``."""
    import torch

    from datafusion_distributed_tpu_torch.ops.table import (
        Column,
        Dictionary,
        Table,
    )
    from datafusion_distributed_tpu_torch.schema import DataType
    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    ctx = SessionContext(device=device)
    for name, (names, rows, cols) in pickle.loads(
            Path(path).read_bytes()).items():
        ctx.register_table(name, Table(tuple(names), tuple(
            Column(torch.from_numpy(d).to(device),
                   None if v is None else torch.from_numpy(v).to(device),
                   DataType(dt),
                   None if vals is None else Dictionary(vals))
            for d, v, dt, vals in cols),
            torch.tensor(rows, dtype=torch.int32, device=device)))
    return ctx


def spmd_rank(job_path: str, rank: int) -> int:
    """One rank of the spmd phase (`--spmd-rank JOB RANK`): a process of a
    gloo group on the card that runs (a) and (b) of `phase_spmd` through
    ``collect_distributed_table(mesh=make_mesh())`` and pickles what it
    saw. Rank 0 also runs each query in process at the same task count."""
    import gc

    import torch
    import torch.distributed as dist

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.parallel import exchange as ex
    from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
        make_mesh,
    )

    t_start = time.perf_counter()
    job = json.loads(Path(job_path).read_text())
    dist.init_process_group(
        "gloo", init_method=f"file://{job['init']}", rank=rank,
        world_size=job["world"],
        timeout=timedelta(seconds=SPMD_COLLECTIVE_TIMEOUT_S))
    out: dict = {"rank": rank}
    try:
        mesh = make_mesh(device=job["device"])
        ready = Path(job["ready"])
        while not ready.exists():
            if time.perf_counter() - t_start > SPMD_TIMEOUT_S:
                raise RuntimeError("the tables were never written")
            time.sleep(0.05)
        out["startup_s"] = time.perf_counter() - t_start
        t0 = time.perf_counter()
        small = _spmd_session(job["tables"]["small"], mesh.device)
        # the SF 1 tables stay in host memory: execute_on_mesh moves each
        # rank's slices to the card (as the JAX package's executor places
        # each task's slices on its device); four ranks' copies of the
        # tables beside four q21 working sets do not fit one card
        big = _spmd_session(job["tables"]["big"], "cpu")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        hk.reset_launch_counts()
        ex.reset_spmd_stats()

        def run(ctx, q: str, **kw) -> tuple:
            df = ctx.sql((QUERY_DIR / f"{q}.sql").read_text())
            t0 = time.perf_counter()
            try:
                got = df.collect_distributed_table(**kw).to_numpy()
            except Exception as e:
                raise RuntimeError(f"{q} with {kw}: {type(e).__name__}: "
                                   f"{e}") from e
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            # the ranks share the card: hand freed blocks back to it
            torch.cuda.empty_cache()
            return got, s, df.last_retry_count

        def spmd(ctx, q: str) -> tuple:
            return run(ctx, q, mesh=mesh)

        def in_process(ctx, q: str) -> tuple:
            return run(ctx, q, num_tasks=mesh.size)

        # (a) all 22 queries at SPMD_ALL_SF
        shapes = {"build": {}, "probe": {}, "agg": {}, "fold": {}}
        t0 = time.perf_counter()
        out["a"] = {q: dict(zip(("result", "s", "retries"), spmd(small, q)))
                    for q in QUERIES}
        out["a_s"] = time.perf_counter() - t0
        _drain_shapes(hk, shapes)
        if rank == 0:
            out["a_inproc"] = {
                q: dict(zip(("result", "s", "retries"),
                            in_process(small, q)))
                for q in QUERIES}
        del small
        gc.collect()
        torch.cuda.empty_cache()
        done = Path(job["nccl_done"])
        while not done.exists():  # (c) in the phase's process is over
            if time.perf_counter() - t_start > SPMD_TIMEOUT_S:
                raise RuntimeError("the one-rank NCCL runs never ended")
            time.sleep(0.05)
        hk.reset_launch_counts()  # the in-process arm's are not the path's
        # (b) the SPMD_QUERIES at SF 1, cold then warm
        out["b"] = {}
        launches: dict = {}
        for q in SPMD_QUERIES:
            cold, cold_s, _r = spmd(big, q)
            _drain_shapes(hk, shapes)
            ex.reset_spmd_stats()
            torch.cuda.reset_peak_memory_stats()
            warm, s, retries = spmd(big, q)
            for k, v in hk.launches().items():
                launches[k] = launches.get(k, 0) + v
            _drain_shapes(hk, shapes)
            log(f"[spmd rank {rank}] {q}: cold {cold_s:.3f}s, warm {s:.3f}s, "
                f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            out["b"][q] = {
                "result": warm, "identical_to_cold": _identical(cold, warm),
                "cold_s": cold_s, "s": s, "retries": retries,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "sent_bytes": ex.spmd_stats()}
        # the port's two SPMD examples at EXAMPLE_ROWS over the ranks
        examples = _examples_spmd()
        out["examples"] = {}
        for name, mod in examples.items():
            t0 = time.perf_counter()
            got = mod.run(device=mesh.device, n=EXAMPLE_ROWS, mesh=mesh)
            torch.cuda.synchronize()
            out["examples"][name] = {"result": got["frames"]["result"],
                                     "plan": got["facts"]["plan"],
                                     "s": time.perf_counter() - t0}
            _drain_shapes(hk, shapes)
            torch.cuda.empty_cache()
        out["launches"] = launches
        out["shapes"] = shapes
        if rank == 0:
            # the examples in process on the card, at the ranks' task count
            out["examples_inproc"] = {}
            for name, mod in examples.items():
                kw = ({"coordinated": False}
                      if name == "custom_partial_reduction_tree" else {})
                got = mod.run(device=mesh.device, n=EXAMPLE_ROWS,
                              num_tasks=mesh.size, **kw)
                out["examples_inproc"][name] = {
                    "result": got["frames"]["result"],
                    "plan": got["facts"]["plan"]}
                torch.cuda.empty_cache()
            # the in-process arm on the card, as a user's session runs it
            card = _spmd_session(job["tables"]["big"], mesh.device)
            out["b_inproc"] = {}
            for q in SPMD_QUERIES:
                cold, cold_s, _r = in_process(card, q)
                torch.cuda.reset_peak_memory_stats()
                warm, s, retries = in_process(card, q)
                out["b_inproc"][q] = {
                    "result": warm, "cold_s": cold_s, "s": s,
                    "retries": retries,
                    "peak_bytes": torch.cuda.max_memory_allocated()}
        dist.barrier()
    except Exception as e:  # noqa: BLE001 - reported to the phase
        import traceback

        traceback.print_exc()
        out["failed"] = f"{type(e).__name__}: {e}"
    finally:
        Path(job["out"].format(rank=rank)).write_bytes(pickle.dumps(out))
        dist.destroy_process_group()
    return 1 if "failed" in out else 0


def _examples_spmd() -> dict:
    import importlib

    return {name: importlib.import_module(
        f"datafusion_distributed_tpu_torch.examples.{name}")
        for name in EXAMPLES_SPMD}


def _nccl_world_of_one(tables: str, tmp: Path) -> dict:
    """(c): the SPMD_QUERIES through ``collect_distributed_table(mesh=)``
    on a one-rank NCCL group, each equal to collect_distributed_table(1)
    byte for byte (its plan has no exchange left: the run's collectives
    are the plan check and the flags' all_reduce)."""
    import torch
    import torch.distributed as dist

    from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
        make_mesh,
    )

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp / 'nccl'}", rank=0, world_size=1,
        timeout=timedelta(seconds=SPMD_COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_mesh(device=f"cuda:{torch.cuda.current_device()}")
        ctx = _spmd_session(tables, mesh.device)
        out = {}
        for q, sql in _queries(SPMD_QUERIES):
            df = ctx.sql(sql)
            t0 = time.perf_counter()
            got = df.collect_distributed_table(mesh=mesh).to_numpy()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            ref = ctx.sql(sql).collect_distributed_table(1).to_numpy()
            check(_identical(got, ref), f"{q} over NCCL at world size 1 "
                  "differs from collect_distributed_table(1)")
            out[q] = {"s": s, "retries": df.last_retry_count,
                      "rows": len(next(iter(got.values())))}
        return out
    finally:
        dist.destroy_process_group()


def phase_spmd(sf: float, seed: int) -> dict:
    """The SPMD tier on the card: a staged plan as one program over a
    torch.distributed group, one rank a task.

    SPMD_RANKS rank processes (this script with ``--spmd-rank``) form a
    gloo group on the card, each over the same TPC-H tables (written once
    by this process) through ``collect_distributed_table(mesh=)``:
    (a) the 22 queries at SF SPMD_ALL_SF, each rank's table byte-identical
    to rank 0's in-process ``collect_distributed_table(SPMD_RANKS)`` with
    equal retries; (b) SPMD_QUERIES at SF ``sf`` cold then warm, each
    rank's session over the tables in host memory (execute_on_mesh moves
    its slices to the card; four copies on the card do not fit beside four
    q21 working sets) (seconds, each rank's peak allocated bytes and the
    bytes each exchange kind sent, launches counted from 0 over the warm
    runs), beside rank 0's in-process runs on the card, byte-identical.
    Meanwhile (as the ranks load and run (a)) this process runs (c): SPMD_QUERIES
    at SF ``sf`` over a one-rank NCCL group, each equal to
    ``collect_distributed_table(1)``; the ranks start (b) once it is done,
    and this process then holds no table on the card. Then kernels 1, 2 and 3 at every
    shape the ranks and (c) logged, against their plain versions. A rank
    that fails or outlives SPMD_TIMEOUT_S fails the phase."""
    import gc
    import shutil

    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="dftpu-spmd-"))
    job = tmp / "job.json"
    job.write_text(json.dumps({
        "init": str(tmp / "gloo"), "world": SPMD_RANKS,
        "device": f"cuda:{torch.cuda.current_device()}",
        "ready": str(tmp / "ready"), "nccl_done": str(tmp / "nccl_done"),
        "out": str(tmp / "rank{rank}.pkl"),
        "tables": {"small": str(tmp / "small.pkl"),
                   "big": str(tmp / "big.pkl")}}))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(SPMD_RANKS)]
    torch.cuda.empty_cache()  # the ranks need the card's memory
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--spmd-rank",
         str(job), str(r)], stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=str(Path(__file__).resolve().parent), env=env)
        for r in range(SPMD_RANKS)]
    out: dict = {}
    try:
        _dump_tables(_session("cuda", SPMD_ALL_SF, seed).catalog.tables,
                     tmp / "small.pkl")
        _dump_tables(_session("cuda", sf, seed).catalog.tables,
                     tmp / "big.pkl")
        # four ranks' q21 working sets at SF 1 take nearly the whole card:
        # this process keeps no table on it (the clickbench phase, next,
        # clears them too)
        _TABLES.clear()
        gc.collect()
        torch.cuda.empty_cache()
        out["parent_allocated"] = torch.cuda.memory_allocated()
        (tmp / "ready").touch()
        out["dump_s"] = time.perf_counter() - t_phase
        log(f"[spmd] {SPMD_RANKS} ranks started; tables written in "
            f"{out['dump_s']:.1f}s; this process holds "
            f"{out['parent_allocated']} B on the card")
        # (c) while the ranks load their tables and run (a) at SF 0.1; the
        # ranks start (b) once it is done
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        out["nccl"] = _nccl_world_of_one(str(tmp / "big.pkl"), tmp)
        out["nccl_s"] = time.perf_counter() - t0
        shapes = {"build": {}, "probe": {}, "agg": {}, "fold": {}}
        _drain_shapes(hk, shapes)
        gc.collect()
        torch.cuda.empty_cache()
        (tmp / "nccl_done").touch()
        log(f"[spmd] (c) {len(out['nccl'])} queries at SF {sf} over NCCL "
            f"at world size 1 equal to collect_distributed_table(1): "
            f"{out['nccl']} ({_since(t_phase)})")
        deadline = t_phase + SPMD_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} outlived {SPMD_TIMEOUT_S}s")
        for lf in logs:
            lf.close()
        ranks = []
        for r, p in enumerate(procs):
            path = tmp / f"rank{r}.pkl"
            res = pickle.loads(path.read_bytes()) if path.exists() else {}
            if p.returncode != 0 or "failed" in res:
                tail = (tmp / f"rank{r}.log").read_text()[-3000:]
                raise RuntimeError(
                    f"rank {r} exited {p.returncode}: {res.get('failed')}\n"
                    f"{tail}")
            ranks.append(res)
        log(f"[spmd] {SPMD_RANKS} ranks done ({_since(t_phase)})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in logs:
            lf.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["rank_s"] = {k: [r[k] for r in ranks]
                     for k in ("startup_s", "load_s", "a_s")}

    # (a) the 22 queries against rank 0's in-process runs
    ref = ranks[0]["a_inproc"]
    for q in QUERIES:
        for r, res in enumerate(ranks):
            check(_identical(res["a"][q]["result"], ref[q]["result"]),
                  f"{q} at SF {SPMD_ALL_SF}: rank {r}'s SPMD table differs "
                  "from the in-process run")
            check(res["a"][q]["retries"] == ref[q]["retries"],
                  f"{q} at SF {SPMD_ALL_SF}: rank {r} retried "
                  f"{res['a'][q]['retries']} times, in process "
                  f"{ref[q]['retries']}")
    out["a"] = {q: {"s": max(r["a"][q]["s"] for r in ranks),
                    "inproc_s": ref[q]["s"], "retries": ref[q]["retries"]}
                for q in QUERIES}
    log(f"[spmd] (a) 22 queries at SF {SPMD_ALL_SF} over {SPMD_RANKS} gloo "
        f"ranks byte-identical to in-process on every rank "
        f"({_since(t_phase)})")

    # (b) the SPMD_QUERIES at SF 1
    ref = ranks[0]["b_inproc"]
    out["b"] = {}
    for q in SPMD_QUERIES:
        for r, res in enumerate(ranks):
            got = res["b"][q]
            check(got["identical_to_cold"],
                  f"{q}: rank {r}'s cold and warm SPMD runs differ")
            check(_identical(got["result"], ref[q]["result"]),
                  f"{q} at SF {sf}: rank {r}'s SPMD table differs from the "
                  "in-process run")
            check(got["retries"] == ref[q]["retries"],
                  f"{q} at SF {sf}: rank {r} retries differ")
        sent: dict = {}
        for res in ranks:
            for k, v in res["b"][q]["sent_bytes"].items():
                sent[k] = sent.get(k, 0) + v
        out["b"][q] = {
            "cold_s": max(r["b"][q]["cold_s"] for r in ranks),
            "s": max(r["b"][q]["s"] for r in ranks),
            "inproc_cold_s": ref[q]["cold_s"], "inproc_s": ref[q]["s"],
            "retries": ref[q]["retries"],
            "peak_gb": [r["b"][q]["peak_bytes"] / 1e9 for r in ranks],
            "inproc_peak_gb": ref[q]["peak_bytes"] / 1e9,
            "sent_bytes": sent}
        log(f"[spmd] (b) {q}: {out['b'][q]} ({_since(t_phase)})")
    out["warm_s"] = sum(r["s"] for r in out["b"].values())
    out["inproc_s"] = sum(r["inproc_s"] for r in out["b"].values())

    # the port's SPMD examples at EXAMPLE_ROWS against rank 0's in-process
    # run at the same task count
    out["examples"] = {}
    for name in EXAMPLES_SPMD:
        ref = ranks[0]["examples_inproc"][name]
        for r, res in enumerate(ranks):
            got = res["examples"][name]
            check(_identical(got["result"], ref["result"]),
                  f"example {name}: rank {r}'s SPMD result differs from the "
                  "in-process run")
            check(got["plan"] == ref["plan"],
                  f"example {name}: rank {r}'s staged plan differs")
        out["examples"][name] = {
            "s": max(res["examples"][name]["s"] for res in ranks),
            "rows": len(next(iter(ref["result"].values())))}
    log(f"[spmd] the examples over {SPMD_RANKS} ranks at {EXAMPLE_ROWS} "
        f"rows byte-identical to in-process: {out['examples']} "
        f"({_since(t_phase)})")
    launches: dict = {}
    for res in ranks:
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for kind in shapes:
            for key, c in res["shapes"][kind].items():
                shapes[kind][key] = shapes[kind].get(key, 0) + c
    for k in ("build_group_ids", "multiway_probe"):
        check(launches.get(k, 0) > 0,
              f"kernel {k} was not launched by the ranks' warm runs")
    out["launches"] = launches
    log(f"[spmd] SF {sf} warm {out['warm_s']:.2f}s over {SPMD_RANKS} ranks "
        f"against {out['inproc_s']:.2f}s in process; launches {launches} "
        f"({_since(t_phase)})")

    # kernels 1-4 at every shape the ranks and (c) logged
    dev = torch.device("cuda")
    out["kernel_checks"] = {
        "build_group_ids": build_shape_checks(
            [[n, lanes, h, c] for (n, lanes, h), c
             in shapes["build"].items()], dev, "spmd"),
        "multiway_probe": probe_shape_checks(
            [[n, k, lanes, list(s), c] for (n, k, lanes, s), c
             in shapes["probe"].items()], dev, "spmd"),
        "group_aggregate": agg_shape_checks(shapes["agg"], dev, "spmd"),
        "group_fold": fold_shape_checks(shapes["fold"], dev, "spmd"),
    }
    out["shapes"] = {k: len(v) for k, v in shapes.items()}
    log(f"[spmd] shapes checked: {out['shapes']} ({_since(t_phase)})")
    return out


# ---------------------------------------------------------------------------
# phase 17: ClickBench in x64 mode, in a subprocess
# ---------------------------------------------------------------------------

CLICKBENCH_ROWS = 99_997_497  # ClickBench's `hits` table
CLICKBENCH_TASK_ROWS = 1 << 26  # its first 67,108,864 rows, over 8 tasks
CLICKBENCH_CHECK_ROWS = 20_000  # card against CPU, as the CPU tests size it
CLICKBENCH_SEED = 3
CLICKBENCH_QUERIES = [f"q{i}" for i in range(43)]
CLICKBENCH_RETRIES = 8  # overflow retries (SessionConfig; default 3)
STAGED_CLICKBENCH_TASKS = 8  # staged plans, card against CPU at 20,000 rows


def phase_clickbench(timeout_s: float) -> dict:
    """Run the ClickBench worker (this script with --clickbench-worker) in
    a DFTPU_PRECISION=x64 subprocess; its exit code decides the phase."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "clickbench.json"
        # expandable segments: `hits` and its split for 8 tasks leave the
        # allocator little room for whole new blocks
        env = dict(os.environ, DFTPU_PRECISION="x64")
        env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        # the overflow retry's default 16 GB plan budget is below `hits`
        # itself at this size: let a widened plan use 3/4 of the card
        env.setdefault("DFTPU_RETRY_BYTES_BUDGET", str(int(
            0.75 * torch.cuda.get_device_properties(0).total_memory)))
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--clickbench-worker", "--out", str(out)],
            env=env, timeout=timeout_s, stdout=subprocess.DEVNULL,
        )
        check(proc.returncode == 0,
              f"the ClickBench subprocess exited {proc.returncode}")
        return json.loads(out.read_text())


def clickbench_worker(out_path: str) -> int:
    import resource

    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.data import clickbenchgen
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.sql.context import (
        SessionConfig,
        SessionContext,
    )

    check(precision.MODE == "x64", f"precision mode {precision.MODE}")
    rows = CLICKBENCH_ROWS
    queries = [(q, (CLICKBENCH_DIR / f"{q}.sql").read_text())
               for q in CLICKBENCH_QUERIES]
    t0 = time.perf_counter()
    # q36's filter is estimated at a few rows at this size (28,822 groups
    # at 5 M rows on a 32-slot table): from there, 4x a retry reaches its
    # groups in 6 retries, not the default 3
    ctx = SessionContext(SessionConfig(overflow_retries=CLICKBENCH_RETRIES),
                         device="cuda")
    clickbenchgen.register_clickbench(ctx, rows, CLICKBENCH_SEED)
    # GROUP BYs over ~10^8 distinct keys (WatchID, ClientIP, ...) need
    # tables above the default 2^21-slot cap: twice the padded row count
    slots = 2 * ctx.catalog.tables["hits"].capacity
    ctx.sql(f"SET planner.max_slots = {slots}")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[clickbench] hits: {rows} rows generated and uploaded in "
        f"{setup_s:.1f}s; max_slots {slots}")
    per_query = {}
    hk.reset_launch_counts()
    for q, sql in queries:
        t0 = time.perf_counter()
        first = _run(ctx, sql)
        t1 = time.perf_counter()
        df = ctx.sql(sql)
        second = _collect(df)
        t2 = time.perf_counter()
        check(_identical(first, second), f"{q}: two runs differ")
        # a plan that overflows is cached with its widened retry, and a
        # warm run executes both, as the reference's session does
        per_query[q] = {"rows": len(next(iter(second.values()))),
                        "first_s": t1 - t0, "second_s": t2 - t1,
                        "retries": df.last_retry_count}
        log(f"[clickbench] {q}: {per_query[q]}")
    launches = hk.launches()
    for k in CLICKBENCH_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by ClickBench")
    build_shapes, probe_shapes = kernel_shapes(hk, "clickbench")
    folds = fold_shapes(hk, "clickbench")
    peak_dev = torch.cuda.max_memory_allocated()

    peak_host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    hits = ctx.catalog.tables["hits"]
    key_cols = {name: hits.column(name) for name in CLICKBENCH_KEY_COLUMNS}
    live = hits.row_mask()
    # 8 tasks hold T padded copies of each exchange's buffers on one card:
    # at 99,997,497 rows the 43 queries do not fit (PERF.md), so they run
    # on the first CLICKBENCH_TASK_ROWS rows
    # (kept on the host while the kernel checks take the card's memory)
    cut = _row_prefix(hits, CLICKBENCH_TASK_ROWS, "cpu")
    del ctx, hits
    torch.cuda.empty_cache()
    kernel_checks = clickbench_kernel_checks(key_cols, live, build_shapes,
                                             probe_shapes)
    del key_cols, live
    torch.cuda.empty_cache()
    kernel_checks["group_fold"] = fold_shape_checks(
        folds, torch.device("cuda"), "clickbench")
    checked = {tuple(b[:3]) for b in build_shapes} | {
        str(p[:4]) for p in probe_shapes}
    t8 = _clickbench_tasks(_on_device(cut, "cuda"), queries, checked)
    del cut
    torch.cuda.empty_cache()
    gpu = SessionContext(device="cuda")
    clickbenchgen.register_clickbench(gpu, CLICKBENCH_CHECK_ROWS,
                                      CLICKBENCH_SEED)
    cpu = SessionContext(device="cpu")
    clickbenchgen.register_clickbench(cpu, CLICKBENCH_CHECK_ROWS,
                                      CLICKBENCH_SEED)
    from datafusion_distributed_tpu_torch.plan.verify import (
        verify_physical_plan,
    )

    for q, sql in queries:
        diff = _close(_run(gpu, sql), cpu.sql(sql).collect_table().to_numpy(),
                      precision.test_rtol())
        check(diff == "", f"{q}: cuda and cpu differ in {diff}")
        # the staged plan for 8 tasks (at this size only: splitting `hits`
        # at 99,997,497 rows would copy it at plan time)
        gdf = gpu.sql(sql)
        text = gdf.explain_distributed(STAGED_CLICKBENCH_TASKS)
        result = verify_physical_plan(
            gdf.distributed_plan(STAGED_CLICKBENCH_TASKS))
        check(not result.errors(), f"{q}: staged plan verification errors"
              f"\n{result.render()}")
        check(text == cpu.sql(sql).explain_distributed(
            STAGED_CLICKBENCH_TASKS),
              f"{q}: the staged plan differs on cuda and cpu")
    log(f"[clickbench] {CLICKBENCH_CHECK_ROWS} rows: {len(queries)} queries "
        "equal on cuda and cpu, and so are their staged plans for "
        f"{STAGED_CLICKBENCH_TASKS} tasks")
    del gpu, cpu
    torch.cuda.empty_cache()
    x64_coordinated = _x64_coordinated()
    Path(out_path).write_text(json.dumps({
        "rows": rows, "setup_s": setup_s, "max_slots": slots,
        "overflow_retries": CLICKBENCH_RETRIES,
        "retry_bytes_budget": os.environ.get("DFTPU_RETRY_BYTES_BUDGET"),
        "queries": per_query, "launches": launches,
        "build_shapes": build_shapes, "probe_shapes": probe_shapes,
        "kernel_checks": kernel_checks,
        "warm_s": sum(v["second_s"] for v in per_query.values()),
        "peak_device_gb": peak_dev / 1e9, "peak_host_gb": peak_host / 1e9,
        "t8": t8, "x64_coordinated": x64_coordinated,
    }))
    return 0


#: the coordinated tier in x64 mode: these TPC-H queries over
#: COORD_WORKERS in-memory workers at COORD_TASKS tasks, at this scale,
#: each against its own single-node result (in the ClickBench worker, the
#: run's x64 process)
X64_COORD_QUERIES = ("q3", "q18")
X64_COORD_SF = 0.1


def _x64_coordinated() -> dict:
    """X64_COORD_QUERIES through collect_coordinated_table(num_tasks=4)
    over InMemoryCluster(4) at SF X64_COORD_SF in the process's x64 mode,
    cold then warm, both equal to single-node (exactly, and at
    test_rtol() where the sums were reassociated)."""
    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.runtime.coordinator import (
        InMemoryCluster,
    )

    check(precision.MODE == "x64", f"precision mode {precision.MODE}")
    rtol = precision.test_rtol()
    ctx = _session("cuda", X64_COORD_SF, SEED)
    cluster = InMemoryCluster(COORD_WORKERS)
    out = {}
    for q, sql in _queries(X64_COORD_QUERIES):
        t0 = time.perf_counter()
        single = _run(ctx, sql)
        single_s = time.perf_counter() - t0
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = _coordinated(ctx, sql, False, cluster)[0]
            walls.append(time.perf_counter() - t0)
            diff, tied = _close_or_ties(got, single, rtol)
            check(diff == "", f"{q} coordinated in x64 mode differs from "
                  f"single-node in {diff}")
        out[q] = {"identical": _identical(got, single), "tied": tied,
                  "cold_s": walls[0], "warm_s": walls[1],
                  "single_s": single_s}
        log(f"[clickbench] x64 coordinated {q} at SF {X64_COORD_SF} over "
            f"{COORD_WORKERS} workers: {out[q]}")
    _TABLES.pop(("cuda", X64_COORD_SF, SEED), None)
    return out


def _row_prefix(table, rows: int, device):
    """A copy of the table's first ``rows`` rows on ``device`` (capacity
    ``rows``, a power of two), with its dictionaries."""
    check(int(table.num_rows) >= rows, f"a prefix of {rows} rows of a "
          f"table of {int(table.num_rows)}")
    return _on_device(table, device, rows)


def _on_device(table, device, rows=None):
    """A copy of the table's first ``rows`` rows (all of them) on
    ``device``."""
    from datafusion_distributed_tpu_torch.ops.table import Column, Table

    rows = table.capacity if rows is None else rows
    return Table(table.names, tuple(
        Column(c.data[:rows].to(device, copy=True),
               c.validity[:rows].to(device, copy=True)
               if c.validity is not None else None, c.dtype, c.dictionary)
        for c in table.columns), table.num_rows.clamp(max=rows).to(device))


def _clickbench_tasks(hits, queries, checked: set) -> dict:
    """The 43 queries over 8 tasks on ``hits``, once each after the same
    session's single-node runs (so the data is on the card and only the
    staged plan is new), each held against the single-node result (a LIMIT
    query on its ORDER BY columns); then kernels 1 and 2 at every shape
    the run logged and not in ``checked`` (shapes the full-size run
    already held), against their plain versions. (No cold pass over 8
    tasks runs first: it took as long as this one, 26 s on the card, and
    was compared with nothing.)"""
    import torch

    from datafusion_distributed_tpu_torch import precision
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.sql.context import (
        SessionConfig,
        SessionContext,
    )

    rows = int(hits.num_rows)
    ctx = SessionContext(SessionConfig(overflow_retries=CLICKBENCH_RETRIES),
                         device="cuda")
    ctx.register_table("hits", hits)
    ctx.sql(f"SET planner.max_slots = {2 * hits.capacity}")
    single: dict = {}
    single_s: dict = {}
    for q, sql in queries:
        _run(ctx, sql)
        t0 = time.perf_counter()
        single[q] = _run(ctx, sql)
        single_s[q] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    hk.reset_launch_counts()
    t8: dict = {}
    limit_cut = {}
    for q, sql in queries:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        df = ctx.sql(sql)
        got = _collect_tasks(df, TASKS)
        t8[q] = {"s": time.perf_counter() - t0, "single_s": single_s[q],
                 "retries": df.last_retry_count,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        keys = _limit_keys(sql)
        ref = single[q]
        if keys is not None:
            # a LIMIT cuts ties where the order of tied rows decides: only
            # the ORDER BY columns are determined (none without ORDER BY)
            limit_cut[q] = keys
            check(len(next(iter(got.values()))) ==
                  len(next(iter(ref.values()))), f"{q}: T={TASKS} rows")
            got = {k: v for k, v in got.items() if k.split(".")[-1] in keys}
            ref = {k: v for k, v in ref.items() if k.split(".")[-1] in keys}
            diff = _close(got, ref, precision.test_rtol())
        else:
            diff, t8[q]["ties"] = _close_or_ties(got, ref,
                                                 precision.test_rtol())
        check(diff == "", f"{q}: T={TASKS} and single-node differ in {diff}")
        log(f"[clickbench] {q} T={TASKS}: {t8[q]}")
    launches = hk.launches()
    for k in CLICKBENCH_KERNELS:
        check(launches[k] > 0,
              f"kernel {k} was not launched by ClickBench at T={TASKS}")
    builds, probes = kernel_shapes(hk, f"clickbench T={TASKS}")
    folds = fold_shapes(hk, f"clickbench T={TASKS}")
    peak = max(v["peak_gb"] for v in t8.values())
    log(f"[clickbench] T={TASKS}, {rows} rows: "
        f"{sum(v['s'] for v in t8.values()):.3f}s, peak {peak:.2f} GB; "
        f"LIMIT queries compared on their ORDER BY columns: {limit_cut}")
    del ctx, single
    torch.cuda.empty_cache()
    key_cols = {name: hits.column(name) for name in CLICKBENCH_KEY_COLUMNS}
    checks = clickbench_kernel_checks(
        key_cols, hits.row_mask(),
        [b for b in builds if tuple(b[:3]) not in checked],
        [p for p in probes if str(p[:4]) not in checked])
    checks["group_fold"] = fold_shape_checks(folds, torch.device("cuda"),
                                             f"clickbench T={TASKS}")
    return {"rows": rows, "queries": t8, "launches": launches,
            "build_shapes": builds, "probe_shapes": probes,
            "kernel_checks": checks,
            "s": sum(v["s"] for v in t8.values()),
            "single_s": sum(single_s.values()),
            "peak_device_gb": peak,
            "limit_keys": limit_cut}


def _limit_keys(sql: str):
    """The ORDER BY column names of a query with a LIMIT ([] without an
    ORDER BY), None without a LIMIT."""
    text = " ".join(sql.split())
    if not re.search(r"\blimit\b", text, re.I):
        return None
    m = re.search(r"\border by (.*?) limit\b", text, re.I)
    if m is None:
        return []
    return [re.sub(r"\s+(asc|desc)$", "", k.strip(), flags=re.I).strip('"')
            for k in m.group(1).split(",")]


#: the key columns of the group-build checks at ClickBench's shapes: WatchID
#: (about one distinct value a row), then the other keys of q31 and q16
CLICKBENCH_KEY_COLUMNS = ("WatchID", "ClientIP", "UserID")


def _clickbench_keys(key_cols: dict, n: int, lanes: int, slots: int,
                     max_slots: int):
    """Int64 key lanes [n, lanes // 2] and slot0 for a build check of ``n``
    rows, ``lanes`` int32 lanes and ``slots`` slots, as the x64 GROUP BY
    forms them (payload lanes, then validity lanes): from `hits`'s own key
    columns where the table is the widest the path builds, else from
    WatchID cut to ~0.45 * slots distinct keys."""
    import torch

    from datafusion_distributed_tpu_torch.ops.aggregate import _fold_key_lanes
    from datafusion_distributed_tpu_torch.ops.hash import hash_columns

    lanes64 = lanes // 2
    nkeys = (lanes64 + 1) // 2  # each key a payload lane and a validity lane
    check(nkeys <= len(CLICKBENCH_KEY_COLUMNS),
          f"no check keys for {lanes} lanes")
    cols = [key_cols[c] for c in CLICKBENCH_KEY_COLUMNS[:nkeys]]
    data = [_first_rows(c.data, n).to(torch.int64) for c in cols]
    valids = [_first_rows(c.validity, n) if c.validity is not None else None
              for c in cols]
    if slots < max_slots:
        ndv = max(1, int(0.45 * slots))
        data = [data[0] % ndv] + [(data[0] % ndv) * (7919 + j) % 1_000_003
                                  for j in range(1, nkeys)]
        valids = [None] * nkeys
    lane_plan = [True] * (lanes64 - nkeys) + [False] * (2 * nkeys - lanes64)
    keys64, _ = _fold_key_lanes(data, valids, lane_plan, n)
    keys = torch.stack(keys64, dim=1)
    slot0 = (hash_columns(data, valids) & (slots - 1)).to(torch.int32)
    return keys, slot0


def _first_rows(x, n: int):
    """``x``'s first ``n`` rows; past its end it starts over (a build over 8
    tasks' coalesced tables may take more rows than the table has)."""
    import torch

    if n <= x.shape[0]:
        return x[:n]
    return x[torch.arange(n, device=x.device) % x.shape[0]]


def probe_shape_checks(probe_shapes, dev, tag: str) -> dict:
    """Kernel 2 at every probe shape a run logged ([rows, tables, lanes,
    table slots, launches]), on seeded tables (drawn on the card) of the
    recorded slots and keys half present, held bit for bit against its
    plain version. The
    launches made here are not the path's: they come after its counts were
    read."""
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    from datafusion_distributed_tpu_torch.ops.hash import hash_columns

    probes = {}
    skipped: list = []
    for n, ntab, lanes, slots, _count in probe_shapes:
        key = ("probe", n, ntab, lanes, tuple(slots))
        earlier = _checked_earlier(key, skipped)
        if earlier is not None:
            probes[f"{n}x{ntab}x{lanes}/{slots}"] = earlier
            continue
        gen = _device_rng(f"{tag} probe {n} {lanes} {slots}", dev)
        tparts, uparts, kparts = [], [], []
        for hslots in slots:
            ndv = max(1, int(0.4 * hslots))
            bkeys = _ints(gen, (ndv, lanes), dev)
            cols = [bkeys[:, i] for i in range(lanes)]
            bs0 = (hash_columns(cols, [None] * lanes) & (hslots - 1)).to(
                torch.int32)
            _g, tk, used, bover, _r = hk.build_group_ids(
                bkeys, bs0, torch.ones(ndv, dtype=torch.bool, device=dev),
                hslots)
            check(not bool(bover), f"a {tag} probe table overflowed")
            tparts.append(tk)
            uparts.append(used)
            present = bkeys[torch.randint(0, ndv, (n,), generator=gen,
                                          device=dev)]
            absent = _ints(gen, (n, lanes), dev)
            half = torch.rand(n, generator=gen, device=dev) < 0.5
            kparts.append(torch.where(half[:, None], present, absent))
        keys = torch.stack(kparts, dim=1).contiguous()
        s0 = torch.stack([
            (hash_columns([keys[:, k, i] for i in range(lanes)],
                          [None] * lanes) & (slots[k] - 1)).to(torch.int32)
            for k in range(ntab)], dim=1)
        active = torch.ones((n, ntab), dtype=torch.bool, device=dev)
        args = (keys, s0, active, torch.cat(tparts), torch.cat(uparts),
                tuple(slots))
        case = _probe_against_plain(args)
        check(case["max_abs_err"] == 0, f"multiway_probe rows={n} "
              f"tables={ntab} lanes={lanes} slots={slots}: kernel != plain")
        probes[f"{n}x{ntab}x{lanes}/{slots}"] = case
        _CHECKED[key] = {**case, "checked_by": tag}
        log(f"[{tag}] multiway_probe rows={n} tables={ntab} "
            f"lanes={lanes} slots={slots}: {case}")
        del keys, s0, active, args, tparts, uparts, kparts
    _log_reused(tag, skipped)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return probes


def _probe_against_plain(args) -> dict:
    """One multiway_probe call on ``args`` against multiway_probe_plain on
    the same inputs: the largest difference, and both times."""
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    got = hk.multiway_probe(*args)
    ref = hk.multiway_probe_plain(*args)
    return {"max_abs_err": max_abs_err(zip(got, ref)),
            "found_fraction": float((got[0] >= 0).float().mean()),
            "ms": time_ms(lambda: hk.multiway_probe(*args), 1),
            "plain_ms": time_ms(lambda: hk.multiway_probe_plain(*args), 1)}


def clickbench_kernel_checks(key_cols: dict, live, build_shapes,
                             probe_shapes) -> dict:
    """Kernels 1 and 2 at every shape the ClickBench run gave them, held bit
    for bit against their plain versions on the same inputs: each group
    build on int64 keys through the (lo, hi) lane split, each probe on
    seeded tables of the recorded slots. The launches made here are not
    the path's: they come after its counts were read."""
    import torch

    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    dev = live.device
    max_slots = max((h for _n, _l, h, _c in build_shapes), default=0)
    builds = {}
    for n, lanes, slots, _count in build_shapes:
        keys, s0 = _clickbench_keys(key_cols, n, lanes, slots, max_slots)
        check(keys.shape[1] * 2 == lanes, f"build check lanes {keys.shape}")
        lv = _first_rows(live, n)
        got = hk.build_group_ids(keys, s0, lv, slots)
        ref, plain_ms = timed_once(
            lambda: hk.build_group_ids_plain(keys, s0, lv, slots))
        err = max_abs_err(zip(got[:4], ref[:4]))
        rounds = int(got[4])
        case = {"rounds": rounds, "max_abs_err": err,
                "groups": int(got[2].sum()), "overflow": bool(got[3]),
                "plain_ms": plain_ms}
        check(err == 0 and rounds == int(ref[4]),
              f"build_group_ids rows={n} lanes={lanes} slots={slots}: "
              f"kernel != plain ({case}, plain rounds {int(ref[4])})")
        del got, ref
        case["ms"] = time_ms(lambda: hk.build_group_ids(keys, s0, lv, slots), 1)
        builds[f"{n}x{lanes}/{slots}"] = case
        log(f"[clickbench] build_group_ids rows={n} lanes={lanes} "
            f"slots={slots}: {case}")
        del keys, s0
        torch.cuda.empty_cache()
    probes = probe_shape_checks(probe_shapes, dev, "clickbench")
    torch.cuda.synchronize()
    return {"build_group_ids": builds, "multiway_probe": probes}


# ---------------------------------------------------------------------------


#: the main-path shapes; fixed, so that every printed number is at them
QUERIES = [f"q{i}" for i in range(1, 23)]
ROWS = 8_388_608  # lineitem's padded capacity at TPC-H SF 1
SLOTS = 1 << 21  # PlannerConfig.max_slots
REPS = 5  # timed calls per kernel, after one warm-up
SLEEP_CYCLES = 20_000_000  # ~10 ms of the card's clock, ahead of timed calls
SF = 1.0  # main path: the smallest official TPC-H scale
PHASES = ("build", "kernels", "main", "check", "profile", "session",
          "window", "distributed", "tasks", "coordinator", "serving",
          "resilience", "adaptive", "wire", "tools", "mesh", "examples",
          "spmd", "clickbench")
CLICKBENCH_TIMEOUT_S = 800
CHECK_SF = 0.01  # card against CPU
SEED = 7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    ap.add_argument("--profile-dir", default=None,
                    help="profile phase: write each query's op tables here")
    ap.add_argument("--clickbench-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--tasks-cpu-worker", type=float, default=None,
                    metavar="SF", help=argparse.SUPPRESS)
    ap.add_argument("--coord-cpu-worker", type=float, default=None,
                    metavar="SF", help=argparse.SUPPRESS)
    ap.add_argument("--serving-cpu-worker", type=float, default=None,
                    metavar="SF", help=argparse.SUPPRESS)
    ap.add_argument("--resilience-cpu-worker", type=float, default=None,
                    metavar="SF", help=argparse.SUPPRESS)
    ap.add_argument("--wire-cpu-worker", type=float, default=None,
                    metavar="SF", help=argparse.SUPPRESS)
    ap.add_argument("--lockcheck-worker", type=float, default=None,
                    metavar="SF", help=argparse.SUPPRESS)
    ap.add_argument("--crash-worker", type=float, default=None,
                    metavar="SF", help=argparse.SUPPRESS)
    ap.add_argument("--leakcheck-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--spmd-rank", nargs=2, default=None,
                    metavar=("JOB", "RANK"), help=argparse.SUPPRESS)
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
    if args.tasks_cpu_worker is not None:
        return tasks_cpu_worker(args.tasks_cpu_worker, args.out)
    if args.coord_cpu_worker is not None:
        return coord_cpu_worker(args.coord_cpu_worker, args.out)
    if args.serving_cpu_worker is not None:
        return serving_cpu_worker(args.serving_cpu_worker, args.out)
    if args.resilience_cpu_worker is not None:
        return resilience_cpu_worker(args.resilience_cpu_worker, args.out)
    if args.wire_cpu_worker is not None:
        return wire_cpu_worker(args.wire_cpu_worker, args.out)
    if args.lockcheck_worker is not None:
        return lockcheck_worker(args.lockcheck_worker, args.out)
    if args.crash_worker is not None:
        return crash_worker(args.crash_worker, args.out)
    if args.leakcheck_worker:
        return leakcheck_worker(args.out)
    if args.spmd_rank is not None:
        return spmd_rank(args.spmd_rank[0], int(args.spmd_rank[1]))
    if args.clickbench_worker:
        try:
            return clickbench_worker(args.out)
        except Exception as e:  # noqa: BLE001 - the exit code reports it
            import traceback

            traceback.print_exc()
            log(f"[clickbench] FAILED: {e}")
            return 1

    phases = args.phases.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {"card": None}
    ok = True
    t_all = time.perf_counter()
    for phase in PHASES:
        if phase not in phases:
            continue
        if phase == "clickbench":
            # the x64 subprocess needs the card's memory to itself
            _TABLES.clear()
            torch.cuda.empty_cache()
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
            elif phase == "profile":
                results["profile"] = phase_profile(SF, QUERIES, SEED,
                                                   args.profile_dir)
            elif phase == "session":
                results["session"] = phase_session(SF, QUERIES, SEED)
            elif phase == "window":
                results["window"] = phase_window(SF, CHECK_SF, SEED)
            elif phase == "distributed":
                results["distributed"] = phase_distributed(
                    SF, CHECK_SF, QUERIES, SEED)
            elif phase == "tasks":
                results["tasks"] = phase_tasks(SF, CHECK_SF, QUERIES, SEED)
            elif phase == "coordinator":
                results["coordinator"] = phase_coordinator(
                    SF, CHECK_SF, QUERIES, SEED)
            elif phase == "serving":
                results["serving"] = phase_serving(SF, CHECK_SF, SEED)
            elif phase == "resilience":
                results["resilience"] = phase_resilience(SF, CHECK_SF, SEED)
            elif phase == "adaptive":
                results["adaptive"] = phase_adaptive(SF, SEED)
            elif phase == "wire":
                results["wire"] = phase_wire(SF, CHECK_SF, SEED)
            elif phase == "tools":
                results["tools"] = phase_tools(SF, SEED)
            elif phase == "mesh":
                results["mesh"] = phase_mesh(SF, SEED)
            elif phase == "examples":
                results["examples"] = phase_examples()
            elif phase == "spmd":
                results["spmd"] = phase_spmd(SF, SEED)
            else:
                results["clickbench"] = phase_clickbench(CLICKBENCH_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 - report every phase, then fail
            import traceback

            traceback.print_exc()
            log(f"[{phase}] FAILED: {e}")
            results.setdefault("failed", []).append(phase)
            ok = False
        results.setdefault("phase_s", {})[phase] = time.perf_counter() - t0
        log(f"[{phase}] {results['phase_s'][phase]:.1f}s")
    results["total_s"] = time.perf_counter() - t_all
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1, default=str))
    if not ok:
        log(f"chip_smoke: failed phases {results['failed']}")
        return 1

    kernels = []
    # launches: the main path's (TPC-H, tpu mode), and by path (TPC-H,
    # window, ClickBench in x64 mode); null where the phase did not run
    paths = {"tpch_tpu": ("main",), "window": ("window",),
             "staged_t1": ("distributed",), "staged_t8": ("tasks",),
             "coordinated": ("coordinator",),
             "coordinated_adaptive": ("coordinator",),
             "serving": ("serving",),
             "resilience": ("resilience",),
             "adaptive": ("adaptive",),
             "wire": ("wire",),
             "tools": ("tools",),
             "mesh": ("mesh",),
             "examples": ("examples",),
             "spmd": ("spmd",),
             "clickbench_x64": ("clickbench",),
             "clickbench_t8": ("clickbench", "t8")}
    shape_checks = [results.get(phase, {}).get("kernel_checks", {})
                    for phase in ("main", "distributed", "tasks",
                                  "coordinator", "serving", "resilience",
                                  "adaptive", "wire", "tools", "mesh",
                                  "examples", "spmd", "clickbench")]
    shape_checks.append(results.get("clickbench", {}).get("t8", {})
                        .get("kernel_checks", {}))
    for name, k in results.get("kernels", {}).items():
        # the kernel phase's cases and the checks at the main path's, the
        # staged runs' and ClickBench's shapes
        err = max([k["max_abs_err"]] + [
            c["max_abs_err"] for checks in shape_checks
            for c in checks.get(name, {}).values()])
        by_path = {}
        for path, (phase, *sub) in paths.items():
            r = results.get(phase)
            for key in sub:
                r = r.get(key) if r else None
            launches = "launches"
            if path == "coordinated_adaptive":
                launches = "adaptive_launches"
            by_path[path] = r[launches].get(name) if r else None
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": by_path["tpch_tpu"],
            "launches_by_path": by_path,
            "max_abs_err": err, "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": "bytes", "library_ms": k["library_ms"],
        }
        if name == "multiway_probe":
            # kernel 2's launches by K (tables a launch), by path
            entry["launches_by_k"] = {
                path: results[phase].get(key)
                for path, phase, key in (
                    ("tpch_tpu", "main", "launches_by_k"),
                    ("staged_t1", "distributed",
                     "multiway_probe_launches_by_k"),
                    ("staged_t8", "tasks", "multiway_probe_launches_by_k"),
                    ("staged_t8_multiway", "tasks",
                     "multiway_probe_launches_by_k_fused"))
                if phase in results}
        kernels.append(entry)
    if "main" in results:
        print(json.dumps({"main": {q: v["second_s"] for q, v in
                                   results["main"]["queries"].items()},
                          "rounds": results["main"]["rounds"]}))
    if "session" in results:
        print(json.dumps({"session": {
            k: results["session"][k]
            for k in ("plan_first_ms", "plan_cached_ms")}}))
    if "window" in results:
        print(json.dumps({"window": {
            q: v["second_s"]
            for q, v in results["window"]["queries"].items()}}))
    if "distributed" in results:
        d = results["distributed"]
        print(json.dumps({"distributed": {
            "planning_ms": {t: [v["first_ms"], v["cached_ms"]]
                            for t, v in d["planning"].items()},
            "split_scan_bytes_t8": d["split_scan_bytes_t8"],
            "staged_s": d["staged_s"], "single_s": d["single_s"],
            "multiway_probe_launches_by_k":
                d["multiway_probe_launches_by_k"]}}))
    if "tasks" in results:
        d = results["tasks"]
        print(json.dumps({"tasks": {
            k: d[k] for k in ("warm_s", "single_s", "sync_calls",
                              "single_sync_calls", "peak_gb", "ties",
                              "fused_nodes", "card_cpu_identical")}}))
    if "coordinator" in results:
        d = results["coordinator"]
        print(json.dumps({"coordinator": {
            **d["summary"], "peak_gb": d["peak_gb"], "ties": d["ties"],
            "card_cpu_identical": d["card_cpu_identical"]}}))
    if "serving" in results:
        d = results["serving"]
        print(json.dumps({"serving": {
            "closed_loop": {arm: {k: v for k, v in r.items()
                                  if k != "peak_staged_bytes"}
                            for arm, r in d["closed_loop"].items()},
            "cache": {arm: {k: r[k] for k in ("p50_ms", "p99_ms",
                                              "hit_rate", "wall_s")}
                      for arm, r in d["cache"].items()},
            "budget": {k: d["budget"][k] for k in (
                "budget_bytes", "spills", "spilled_total_bytes",
                "refaults", "s")},
            "recover_restored":
                d["recover"]["faults"].get("checkpoint_stages_restored"),
            "launches": d["launches"],
            "card_cpu_identical": d["card_cpu_identical"]}}))
    if "resilience" in results:
        d = results["resilience"]
        print(json.dumps({"resilience": {
            "hedging": {arm: {k: v for k, v in r.items() if k != "cold_s"}
                        for arm, r in d["hedging"].items()},
            "churn": {q: {k: r[k] for k in (
                "s", "fired", "reshipped", "refreshed", "retries", "drained",
                "leaked", "tracked_live", "allocated_before",
                "allocated_after")}
                for q, r in d["churn"].items()},
            "churn_allocated_differs": d["churn_allocated_differs"],
            "churn_all_kinds": d["churn_all_kinds"],
            "served": d["served"], "resume": d["resume"],
            "card_cpu": d["card_cpu"], "shapes": d["shapes"],
            "launches": d["launches"]}}))
    if "adaptive" in results:
        d = results["adaptive"]
        print(json.dumps({"adaptive": {
            "adaptations": {k: {x: r[x] for x in (
                "off_s", "on_s", "adapted", "counters")}
                for k, r in d["adaptations"].items()},
            "deadlines": d["deadlines"], "breaker": d["breaker"],
            "streaming": {k: d["streaming"][k] for k in (
                "stream", "bulk", "budget", "fetch_capped_bytes")},
            "shapes": d["shapes"], "launches": d["launches"]}}))
    if "wire" in results:
        d = results["wire"]
        print(json.dumps({"wire": {
            "queries": {q: {
                "s": r["s"], "inproc_s": r["inproc_s"],
                "cold_s": r["cold_s"], "peak_gb": r["peak_gb"],
                "d2h": r["copies"]["d2h"], "h2d": r["copies"]["h2d"],
                "wire": r["wire"], "setplan_bytes": r["setplan_bytes"],
                "allocated_before": r["allocated_before"],
                "allocated_after": r["allocated_after"]}
                for q, r in d["queries"].items()},
            "allocated_differs": d["allocated_differs"],
            "codecs": d["codecs"],
            "segment_lost": d["segment_lost"], "pool": d["pool"],
            "native_hash": d["native_hash"], "shapes": d["shapes"],
            "card_cpu_identical": d["card_cpu_identical"],
            "launches": d["launches"]}}))
    if "tools" in results:
        d = results["tools"]
        print(json.dumps({"tools": {
            "cli": d["cli"],
            "tracing": {q: {k: v for k, v in r.items()
                            if k != "profile_head"}
                        for q, r in d["tracing"].items()},
            "console_render_ms": d["console"]["render_ms"],
            "feed": {k: d["feed"][k] for k in (
                "rows", "units", "write_s", "feed_s", "identical",
                "unit_ms")},
            "lockcheck": {arm: {k: r[k] for k in (
                "cold_s", "warm_s", "process_s", "installed", "violations",
                "static_edges")} | {
                    "edges": len(r["edges"]),
                    "new_edges": sum(e["status"] == "new"
                                     for e in r["edges"]),
                    "hold_outliers": len(r["hold_outliers"]),
                    "events": len(r["events"])}
                for arm, r in d["lockcheck"].items()},
            "crash_repro": d["crash_repro"], "shapes": d["shapes"],
            "launches": d["launches"]}}))
    if "mesh" in results:
        d = results["mesh"]
        print(json.dumps({"mesh": {
            "queries": {q: {k: r[k] for k in (
                "s", "cold_s", "per_task_s", "spans", "set_stage_plan",
                "mesh_set_plan", "set_plan", "peak_gb", "per_task_peak_gb")}
                for q, r in d["queries"].items()},
            "warm_s": d["warm_s"], "per_task_s": d["per_task_s"],
            "all22_s": d["all22"]["s"], "allocated": d["allocated"],
            "spans_kept": d["spans_kept"], "shapes": d["shapes"],
            "launches": d["launches"]}}))
    if "examples" in results:
        d = results["examples"]
        print(json.dumps({"examples": {
            "rows": d["rows"], "examples": d["examples"],
            "shapes": d["shapes"], "launches": d["launches"]}}, default=str))
    if "spmd" in results:
        d = results["spmd"]
        print(json.dumps({"spmd": {
            "b": d["b"], "warm_s": d["warm_s"], "inproc_s": d["inproc_s"],
            "a_s": max(d["rank_s"]["a_s"]), "nccl": d["nccl"],
            "rank_s": d["rank_s"], "dump_s": d["dump_s"],
            "examples": d["examples"],
            "shapes": d["shapes"], "launches": d["launches"]}}))
    if "clickbench" in results:
        cb = results["clickbench"]
        print(json.dumps({"clickbench": {
            **{k: cb[k] for k in ("rows", "setup_s", "warm_s",
                                  "peak_device_gb", "peak_host_gb")},
            "t8": {k: cb["t8"][k] for k in (
                "rows", "s", "single_s", "peak_device_gb")},
            "x64_coordinated": cb["x64_coordinated"]}}))
    print(json.dumps({"kernels": kernels}))
    print(results["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
