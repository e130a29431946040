"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line (see `portbench/README.md`)."""

from __future__ import annotations

import contextlib
import gc
import hashlib
import math
import os
import random
import sys
import time

import numpy as np

from harness import cells, compare, program, roofline, trace
from harness.load import capacity_of


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def generate(config: dict, seed: int, device):
    gen = cells.module("generators", config["generator"])
    args = dict(config["generator_args"])
    if config.get("generate_on") == "device":
        rows = args["rows"]
        return gen.generate(**args, seed=seed, device=device,
                            capacity=capacity_of(rows))
    return gen.generate(**args, seed=seed)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def digest(out: dict) -> str:
    h = hashlib.sha256()
    for name, vals in out.items():
        h.update(name.encode())
        arr = np.asarray(vals)
        if arr.dtype == object:
            h.update("\x00".join(map(str, arr.tolist())).encode())
        else:
            h.update(str(arr.dtype).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def p90(values: list) -> float:
    """The 90th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


class _GcClock:
    """Counts the interpreter's garbage collections and their seconds while
    it is installed (logged beside the window, never a metric)."""

    def __init__(self) -> None:
        self.count, self.seconds, self._t = 0, 0.0, 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase, _info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count += 1
            self.seconds += time.perf_counter() - self._t

    def stop(self) -> None:
        if self._on in gc.callbacks:
            gc.callbacks.remove(self._on)


def run_cell(cell: dict, config: dict, traffic: dict, *, seed: int,
             seconds: float, traced: bool, device, t0: float) -> dict:
    import torch

    device = torch.device(device)
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("this harness drives one client in a closed loop")
    if device.type == "cuda" and config.get("retry_bytes_budget_share"):
        total = torch.cuda.get_device_properties(device).total_memory
        os.environ["DFTPU_RETRY_BYTES_BUDGET"] = str(int(
            config["retry_bytes_budget_share"] * total))
    queries = cells.queries(traffic)
    split = {"imports": time.perf_counter() - t0}

    t = time.perf_counter()
    tables = generate(config, seed, device)
    _sync(device)
    split["generate"] = time.perf_counter() - t
    t = time.perf_counter()
    entry = cells.module("entries", traffic["entry"]).Entry(
        config, tables, device)
    _sync(device)
    split["load"] = time.perf_counter() - t
    if config.get("generate_on") == "device":
        tables = None  # made again from the seed for the reference
    t = time.perf_counter()
    for name, sql in queries:
        try:
            entry.run(sql, lambda _step: contextlib.nullcontext())
        except Exception as e:  # noqa: BLE001 - the window counts it
            log(f"warm pass: {name} failed: {type(e).__name__}: "
                f"{str(e)[:300]}")
    _sync(device)
    split["warm_pass"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    log("setup_s split: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      split.items()))

    rng = random.Random(seed)
    results, latencies, steps, failures = [], [], [], []
    gc_time = _GcClock()
    prof, before = None, None
    if traced:
        from torch.profiler import ProfilerActivity, profile, \
            record_function

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        before = program.launch_shapes()
        prof = profile(activities=acts)
        prof.__enter__()
    max_passes = traffic.get("trace_passes") if traced else None
    start = time.perf_counter()
    passes = 0
    while True:
        order = list(queries)
        rng.shuffle(order)
        for name, sql in order:
            if traced:
                def mark(step, name=name):
                    return record_function(f"{trace.RANGE}:{step}:{name}")
            else:
                def mark(_step):
                    return contextlib.nullcontext()
            q0 = time.perf_counter()
            try:
                out, step = entry.run(sql, mark)
            except Exception as e:  # noqa: BLE001 - a failed query is data
                failures.append((name, f"{type(e).__name__}: {e}"))
                continue
            latencies.append(time.perf_counter() - q0)
            results.append((name, out))
            steps.append({"name": name, **step})
        passes += 1
        elapsed = time.perf_counter() - start
        if elapsed >= seconds or (max_passes and passes >= max_passes):
            break
    _sync(device)
    window = time.perf_counter() - start
    gc_time.stop()
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    after = program.launch_shapes() if traced else None
    entry.close()
    del entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"window: {passes} passes, {len(latencies)} queries, "
        f"{len(failures)} failed, {window:.3f} s")
    for name, err in failures:
        log(f"failed {name}: {err[:300]}")
    log(f"garbage collection in the window: {gc_time.count} collections, "
        f"{gc_time.seconds:.3f} s")
    by_query: dict = {}
    for st in steps:
        by_query.setdefault(st["name"], []).append(
            st["plan"] + st["execute"] + st["to_host"])
    log("median ms by query: " + ", ".join(
        f"{q} {1e3 * sorted(v)[len(v) // 2]:.1f}" for q, v in
        sorted(by_query.items(), key=lambda kv: int(kv[0][1:]))))

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": cell.get("chips", 1),
           "memory_peak_bytes": int(peak)}
    metrics: dict = {}
    breakdown = None
    if traced:
        rec = trace.records(
            prof, steps, trace.kernel_symbols(program.csrc()),
            program.since(before[0], after[0]),
            program.since(before[1], after[1]),
            roofline.hbm_bytes_per_s(kind))
        del prof
        dev["busy_s"] = trace.busy_s(rec)
        dev["window_s"] = trace.window_s(rec)
        for m in cells.per_layer(cell["name"]):
            value = cells.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = trace.breakdown(rec)
        del rec
    else:
        tail = 1e3 * p90(latencies) if latencies else None
        values = {"queries_per_s": len(latencies) / window,
                  "query_p90_ms": tail, "peak_device_gb": peak / 1e9,
                  "setup_s": setup_s}
        if tail is not None:
            beyond = sum(1 for v in latencies if 1e3 * v > tail)
            log(f"query_p90_ms over {len(latencies)} queries, {beyond} "
                "beyond it")
        for m in cells.end_to_end(cell["name"]):
            value = values.get(cells.base(m["name"], values))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = check(config, results, failures, tables, seed, device)
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(latencies) + len(failures),
           "failed": len(failures), "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return out


def check(config: dict, results: list, failures: list, tables, seed: int,
          device) -> dict:
    """Compare every distinct result of the window with the reference."""
    import torch

    t = time.perf_counter()
    distinct: dict = {}
    for name, out in results:
        distinct.setdefault(name, {}).setdefault(digest(out), out)
    del results
    if tables is None:
        tables = generate(config, seed, device)
    g = config["guarantees"]
    ref = cells.module("reference", config["reference"])
    view = ref.prepare(tables, {"rtol": g["float_rtol"], "device": device})
    wrong, worst = [], 0.0
    for name in sorted(distinct, key=lambda q: int(q[1:])):
        expected = ref.QUERIES[name](view)
        for out in distinct[name].values():
            fault, err = compare.compare(out, expected, g["float_rtol"],
                                         g["float_floor"])
            worst = max(worst, err)
            if fault:
                wrong.append(name)
                log(f"wrong {name}: {fault}")
        del expected
    del view, tables
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"reference: {sum(len(v) for v in distinct.values())} distinct "
        f"results of {len(distinct)} queries checked in "
        f"{time.perf_counter() - t:.3f} s")
    return {
        "failed_queries": {"value": len(failures), "limit": 0},
        "wrong_results": {"value": len(wrong), "limit": 0},
        "float_rel_err": {"value": worst, "limit": g["float_rtol"]},
    }
