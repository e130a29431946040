"""The program's own spans in a traced run, and the device time, syncs and
idle time put down to them.

While `torch.profiler` records, the port opens a profiler range
``dftpu:<kind>:<name>`` at each span site of its single-node path
(`datafusion_distributed_tpu_torch/runtime/tracing.py`: ``session:sql``,
``planner:physical_plan``, ``executor:attempt``, ``op:<operator>``,
``expr:like``, ``kernel:build_group_ids``, ...). They are function-scope
ranges: they lie on the profiler's clock beside the CUDA runtime calls they
enclose and have no mirror on the device's timeline, so the readers of
`harness/trace.py` count nothing of them.

`records(prof)` reads, from the same profile:

- ``spans``: ``(kind, name, query, thread, start_ns, end_ns, parent)``,
  ``query`` from the benchmark's `portbench:<step>:<query>` range around
  the span, ``parent`` the index of the innermost span around it or None;
- ``attributed``: every device activity (not a range's mirror) as
  ``(name, start_ns, end_ns, span)``: the CUDA runtime call that launched
  it (the one with its correlation id) was issued on a thread at a
  moment, and ``span`` is the index of the innermost span open on that
  thread then, or None;
- ``sync_calls``: ``(name, thread, ts_ns, span)`` of the runtime calls that
  `metrics/executor.syncs_per_query.py` counts.

`program_totals()` and `live_build_rows()` read the port's counters of the
traced passes, once, after the window: the span totals
(`tracing.span_totals()`, each span's host time summed by the program) and
kernel 1's live rows by shape (`hash_kernels.live_build_rows()`); each is
None where the port keeps no such counter.

The readers of the metrics ``session.plan_span_ms``,
``executor.retry_ms_per_query`` and ``operators.host_string_ms_per_query``
take the span totals from the program; those of
``executor.operator_syncs_per_query``,
``operators.aggregate_device_ms_per_query`` and
``kernels.group_build_roofline`` take ``attributed``, ``sync_calls`` and
``live_build_rows`` from the records, which `harness/trace.py` does not
give them yet (`portbench/spans_run.py` adds them).
"""

from __future__ import annotations

from harness import trace

#: the prefix of the program's profiler ranges
PREFIX = "dftpu"
#: the runtime calls `executor.syncs_per_query` counts
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync")


def _raw(prof):
    """(name, on_device, thread, start_ns, end_ns, correlation id) of every
    profiler event; nothing where the profiler gives no correlation ids."""
    from torch.autograd import DeviceType

    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        return
    for e in events:
        start = e.start_ns()
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               e.start_thread_id(), start, start + e.duration_ns(),
               e.correlation_id())


def records(prof) -> dict:
    return from_events(list(_raw(prof)))


def from_events(events: list) -> dict:
    """The records of `records` from plain event tuples (see `_raw`)."""
    ranges, spans, calls, device = [], [], [], []
    for name, on_device, thread, start, end, corr in events:
        if on_device:
            if not name.startswith((trace.RANGE + ":", PREFIX + ":")):
                device.append((name, start, end, corr))
        elif name.startswith(PREFIX + ":"):
            _pre, kind, label = name.split(":", 2)
            spans.append([kind, label, None, thread, start, end, None])
        elif name.startswith(trace.RANGE + ":"):
            ranges.append((name.split(":", 2)[2], start, end))
        elif name.startswith("cuda"):
            calls.append((name, thread, start, corr))
    spans.sort(key=lambda s: (s[3], s[4], -s[5]))
    _nest(spans)
    _name_queries(spans, sorted(ranges, key=lambda r: r[1]))
    where = _innermost(spans, calls)
    launch = {corr: where[i] for i, (_n, _t, _s, corr) in enumerate(calls)}
    return {
        "spans": [tuple(s) for s in spans],
        "attributed": [(name, start, end, launch.get(corr))
                       for name, start, end, corr in device],
        "sync_calls": [(name, thread, ts, where[i])
                       for i, (name, thread, ts, _c) in enumerate(calls)
                       if name in SYNC_CALLS],
    }


def _nest(spans: list) -> None:
    """Set each span's parent: the innermost span of its thread around it
    (``spans`` sorted by thread, start, longest first)."""
    stack: list = []
    for i, s in enumerate(spans):
        while stack and (spans[stack[-1]][3] != s[3]
                         or spans[stack[-1]][5] < s[5]):
            stack.pop()
        s[6] = stack[-1] if stack else None
        stack.append(i)


def _name_queries(spans: list, ranges: list) -> None:
    """Each span's query: that of the benchmark's range around its start."""
    j = 0
    for s in sorted(spans, key=lambda s: s[4]):
        while j < len(ranges) and ranges[j][2] < s[4]:
            j += 1
        if j < len(ranges) and ranges[j][1] <= s[4]:
            s[2] = ranges[j][0]


def _innermost(spans: list, calls: list) -> list:
    """For each call (name, thread, ts, corr), the index of the innermost
    span open on its thread at ``ts``, or None."""
    by_thread: dict = {}
    for i, s in enumerate(spans):
        by_thread.setdefault(s[3], []).append(i)
    out: list = [None] * len(calls)
    order = sorted(range(len(calls)), key=lambda i: (calls[i][1], calls[i][2]))
    stack: list = []
    thread, k, idx = None, 0, []
    for ci in order:
        _name, t, ts, _corr = calls[ci]
        if t != thread:
            thread, k, idx, stack = t, 0, by_thread.get(t, []), []
        while k < len(idx) and spans[idx[k]][4] <= ts:
            while stack and spans[stack[-1]][5] < spans[idx[k]][4]:
                stack.pop()
            stack.append(idx[k])
            k += 1
        while stack and spans[stack[-1]][5] < ts:
            stack.pop()
        out[ci] = stack[-1] if stack else None
    return out


def nearest(rec: dict, kind: str) -> list:
    """For each span, the index of the nearest span of ``kind`` at or
    around it (itself, else its parent's, ...), or None: the operator whose
    work an activity under an ``expr:`` or ``kernel:`` span is."""
    spans = rec["spans"]
    out: list = [None] * len(spans)
    for i, s in enumerate(spans):  # a parent comes before its children
        out[i] = i if s[0] == kind else (
            out[s[6]] if s[6] is not None else None)
    return out


def device_seconds(rec: dict, kind: str, name: str) -> float:
    """Device seconds of the activities whose nearest ``kind`` span is
    ``kind:name``: for ``op:HashAggregate``, the aggregate's own work and
    its kernel wrappers', not that of the operators below it."""
    owner = nearest(rec, kind)
    spans = rec["spans"]
    return sum((end - start) / 1e9 for _n, start, end, span
               in rec["attributed"] if span is not None
               and owner[span] is not None and spans[owner[span]][1] == name)


def unattributed_seconds(rec: dict) -> float:
    """Device seconds inside the window put down to no span."""
    lo, hi = rec["window_ns"]
    return sum((min(end, hi) - max(start, lo)) / 1e9
               for _n, start, end, span in rec["attributed"]
               if span is None and end > lo and start < hi)


def idle_by_span(rec: dict) -> dict:
    """Idle device seconds inside the window by the innermost program span
    open on the host's busiest thread, and its query (``"expr:like q22"``);
    where no span was open, by the benchmark's range as
    `trace.idle_gaps` labels it."""
    spans = rec["spans"]
    threads: dict = {}
    for s in spans:
        threads[s[3]] = threads.get(s[3], 0) + 1
    main = max(threads, key=threads.get) if threads else None
    # the host's time line: (start, end, innermost span) segments
    idx = sorted((i for i, s in enumerate(spans) if s[3] == main),
                 key=lambda i: (spans[i][4], -spans[i][5]))
    bounds = sorted({t for i in idx for t in spans[i][4:6]})
    segments, stack, k = [], [], 0
    for lo, hi in zip(bounds, bounds[1:]):
        while k < len(idx) and spans[idx[k]][4] <= lo:
            while stack and spans[stack[-1]][5] <= spans[idx[k]][4]:
                stack.pop()
            stack.append(idx[k])
            k += 1
        while stack and spans[stack[-1]][5] <= lo:
            stack.pop()
        if stack:
            segments.append((lo, hi, stack[-1]))
    out: dict = {}
    covered: list = []
    gaps = _gaps(rec)
    j = 0
    for s, e in gaps:
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        m = j
        while m < len(segments) and segments[m][0] < e:
            lo, hi, i = segments[m]
            overlap = min(e, hi) - max(s, lo)
            if overlap > 0:
                sp = spans[i]
                label = f"{sp[0]}:{sp[1]} {sp[2]}" if sp[2] else \
                    f"{sp[0]}:{sp[1]}"
                out[label] = out.get(label, 0.0) + overlap / 1e9
                covered.append((max(s, lo), min(e, hi)))
            m += 1
    # what no span covers keeps the benchmark's own label
    rest = dict(rec, device=rec["device"] + [("", a, b) for a, b in covered])
    for label, seconds in trace.idle_gaps(rest).items():
        out[label] = out.get(label, 0.0) + seconds
    return out


def _gaps(rec: dict) -> list:
    lo, hi = rec["window_ns"]
    gaps, cursor = [], lo
    for s, e in trace.busy_intervals(rec):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    return gaps


def top(values: dict, n: int = 10) -> list:
    return [[k, v] for k, v in
            sorted(values.items(), key=lambda kv: -kv[1])[:n]]


def program_totals():
    """The port's span totals (`tracing.span_totals()`: spans closed while
    the profiler recorded), or None where the port keeps none."""
    try:
        from datafusion_distributed_tpu_torch.runtime import tracing
    except ImportError:
        return None
    totals = getattr(tracing, "span_totals", None)
    return totals() if totals is not None else None


def live_build_rows():
    """Kernel 1's live rows by build shape, counted by the port while the
    profiler recorded (one device-to-host copy), or None where the port
    counts none."""
    try:
        from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
    except ImportError:
        return None
    rows = getattr(hk, "live_build_rows", None)
    return rows() if rows is not None else None


def span_seconds(totals: dict, *prefixes: str) -> float:
    """Host seconds of the totals whose key begins with one of
    ``prefixes``."""
    return sum(seconds for key, (_n, seconds) in totals.items()
               if key.startswith(prefixes))
