"""The traced run's records, read from `torch.profiler` (CPU and CUDA
activities) over whole passes of the mix.

`records(prof, ...)` turns the profiler's events into plain data that the
per-layer metric readers (`portbench/metrics/<name>.py`) take:

- ``device``: every device activity (kernel, copy, memset) as
  ``(name, start_ns, end_ns)``;
- ``runtime``: CUDA runtime calls on the host by name, with their counts;
- ``ranges``: the benchmark's own host ranges, ``(step, query, start_ns,
  end_ns)`` with the step ``plan``, ``execute`` or ``to_host``;
- ``window_ns``: from the first range's start to the last one's end;
- ``queries``: the traced queries with their host seconds per step;
- ``kernels``: the ``__global__`` functions of each of the port's CUDA
  sources, by file name (the port's kernel names, read from its sources);
- ``build_shapes`` and ``probe_shapes``: the launches of kernels 1 and 2 by
  shape over the traced passes (the port's `hash_kernels` counters);
- ``hbm_bytes_per_s``: the card's memory bandwidth from `roofline.PEAKS`.
"""

from __future__ import annotations

import re
from pathlib import Path

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")

#: the prefix of the benchmark's host ranges
RANGE = "portbench"


def kernel_symbols(csrc: Path) -> dict:
    """{source file name: [its __global__ functions]}."""
    return {src.name: sorted(set(_GLOBAL.findall(src.read_text())))
            for src in sorted(Path(csrc).glob("*.cu"))}


def kernel_of(event_name: str, symbols) -> str | None:
    """The kernel symbol a device event ran, or None."""
    for k in symbols:
        if f"::{k}(" in event_name or f"::{k}<" in event_name \
                or event_name == k or event_name.startswith(f"{k}("):
            return k
    return None


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every profiler event."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            start = e.start_ns()
            yield (e.name(), e.device_type() == DeviceType.CUDA, start,
                   start + e.duration_ns())
        return
    for e in prof.events():
        yield (e.name, e.device_type == DeviceType.CUDA,
               int(e.time_range.start * 1000), int(e.time_range.end * 1000))


def records(prof, queries: list, kernels: dict, build_shapes: dict,
            probe_shapes: dict, hbm_bytes_per_s) -> dict:
    device, runtime, ranges = [], {}, []
    for name, on_device, start, end in _events(prof):
        if on_device:
            # the profiler mirrors each host range on the device's
            # timeline; it is no device work
            if not name.startswith(RANGE + ":"):
                device.append((name, start, end))
        elif name.startswith(RANGE + ":"):
            _pre, step, query = name.split(":", 2)
            ranges.append((step, query, start, end))
        elif name.startswith("cuda"):
            runtime[name] = runtime.get(name, 0) + 1
    ranges.sort(key=lambda r: r[2])
    window = (ranges[0][2], ranges[-1][3]) if ranges else (0, 0)
    return {"device": device, "runtime": runtime, "ranges": ranges,
            "window_ns": window, "queries": queries, "kernels": kernels,
            "build_shapes": build_shapes, "probe_shapes": probe_shapes,
            "hbm_bytes_per_s": hbm_bytes_per_s}


def busy_intervals(rec: dict) -> list:
    """The union of the device activities inside the window, merged."""
    lo, hi = rec["window_ns"]
    spans = sorted((max(s, lo), min(e, hi)) for _n, s, e in rec["device"]
                   if e > lo and s < hi)
    merged: list = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(rec: dict) -> float:
    return sum(e - s for s, e in busy_intervals(rec)) / 1e9


def window_s(rec: dict) -> float:
    lo, hi = rec["window_ns"]
    return (hi - lo) / 1e9


def idle_gaps(rec: dict) -> dict:
    """Idle device seconds inside the window, by the benchmark's host range
    that was open ("<step> <query>"; "between queries" where none was)."""
    lo, hi = rec["window_ns"]
    gaps, cursor = [], lo
    for s, e in busy_intervals(rec):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    ranges = rec["ranges"]  # in order, and never overlapping
    out: dict = {}
    i = 0
    for s, e in gaps:
        while i < len(ranges) and ranges[i][3] <= s:
            i += 1
        covered = 0
        j = i
        while j < len(ranges) and ranges[j][2] < e:
            step, query, rs, re_ = ranges[j]
            overlap = min(e, re_) - max(s, rs)
            if overlap > 0:
                label = f"{step} {query}"
                out[label] = out.get(label, 0.0) + overlap / 1e9
                covered += overlap
            j += 1
        if e - s > covered:
            label = "between queries"
            out[label] = out.get(label, 0.0) + (e - s - covered) / 1e9
    return out


def device_ops(rec: dict) -> dict:
    """Device seconds by activity name."""
    out: dict = {}
    for name, s, e in rec["device"]:
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def kernel_seconds(rec: dict, symbols) -> float:
    """Device seconds of the activities that ran one of ``symbols``."""
    return sum((e - s) / 1e9 for name, s, e in rec["device"]
               if kernel_of(name, symbols))


def breakdown(rec: dict, top: int = 10) -> dict:
    ops = sorted(device_ops(rec).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(rec).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}
