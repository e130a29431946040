"""End-to-end distributed query tracing (host-side spans + events).

The reference's ObservabilityService answers *what is running where*
(Ping / GetTaskProgress / GetClusterWorkers); nothing in either engine
answered *where a query's wall time went* across
coordinator -> dispatch -> worker -> exchange. This module is that layer:
hierarchical spans ``query -> stage -> task -> attempt`` with typed child
spans for the hot phases (compile/verify, codec encode, dispatch RPC,
worker execute, exchange transfer, TableStore staging) and structured
trace *events* for every fault-path transition the engine already has
(retry, reroute, quarantine, heal, cancel, membership epoch change).

Design constraints (mirrors the MetricsStore contracts):

- ALWAYS CHEAP WHEN OFF: call sites hold a `NULL_TRACER` whose methods
  are no-ops; no span objects, no clock reads, no per-task dict copies.
  `SET distributed.tracing = off|on|sampled` selects the mode per query.
- HOST-SIDE ONLY: spans wrap coordinator/worker *host* phases; nothing
  here may run inside a jax-traced function (tools/check_tracer_safety.py
  rule DFTPU109 enforces it), and the wire context must never enter a
  compile-cache key (span ids differ per task — keying on them would
  force one XLA trace per task; see plan/physical.py's cfg_items filter).
- BOUNDED: a ring buffer per query (oldest spans dropped once
  ``span_cap`` is hit, count surfaced as ``dropped``), LRU across queries
  with RUNNING queries pinned — identical retention contract to
  MetricsStore.stage_spans.
- DETERMINISTIC ENOUGH TO TEST: all timestamps are `time.monotonic`
  (one system-wide clock — comparable across processes on one host, the
  gRPC-localhost tier included); tests assert ordering, never wall-clock.

Cross-wire propagation: the coordinator attaches ``trace_ctx``
(`{"q": query_id, "parent": span_id}`) to the per-dispatch config dict of
the task envelope (runtime/coordinator.py `_dispatch_task`); the worker
records its decode/execute spans as plain JSON-able dicts carrying that
wire parent (runtime/worker.py), and they ride the existing task-progress
payload back — over the in-process transport AND the gRPC response — to
be spliced into the query trace under the propagated parent span.

Exports: Chrome trace-event JSON (``to_chrome_trace`` — load the file in
Perfetto / chrome://tracing), a text profile report (``render_profile``,
folded into `explain_analyze`), and live aggregate counters
(`ObservabilityService.get_trace_summary`, console panel).

The single-node path (`DataFrame.collect_table`, `execute_plan` and what
runs under it) has spans of its own, opened by `span(kind, name)` at fixed
sites: ``session:sql``, ``planner:physical_plan``, ``executor:attempt``
(with ``executor:overflow`` around the widening after an overflow),
``executor:load``, ``executor:flags``, ``op:<operator label>``, the host's
dictionary work ``expr:like|derive|unify|in|cast|length|concat``, the
kernel wrappers ``kernel:build_group_ids|multiway_probe|group_aggregate``
and the host
reads ``table:to_host`` and ``table:host_rows``. Such a span goes to up to
three places:

- the profiler: while `torch.profiler` records, the span is also a
  profiler range named ``dftpu:<kind>:<name>`` (`_RecordFunctionFast`, a
  function-scope range: it lies on the profiler's clock beside the CUDA
  runtime calls it encloses, and the profiler gives it no mirror on the
  device's timeline), so each device activity can be put down to the
  innermost span open on the thread that launched it;
- the trace store: under ``SET distributed.tracing = 'on'`` (or sampled)
  `collect_table` opens a `QueryTrace` (`local_query`) and the thread's
  spans land in it, on this module's `time.monotonic` clock, so
  ``ctx.last_trace()`` covers single-node queries too;
- the span totals: while either is on, each closed span adds its host
  nanoseconds to `span_totals()` by kind, name and outcome.

Off (no profiler recording, no single-node trace open) a span site costs
one check of two module-level flags and hands out the shared null
context: no span object, no clock read, no dict.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
import zlib
from collections import deque
from typing import Any, Optional

import torch.autograd.profiler as _autograd_profiler

try:  # a function-scope profiler range: no device-timeline mirror
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # pragma: no cover - older torch: spans skip the mirror
    _RecordFunctionFast = None

#: `SET distributed.tracing` modes (validated at SET time, sql/context.py)
TRACING_MODES = ("off", "on", "sampled")

#: config key the trace context rides under in the task envelope. MUST
#: stay out of every compile-cache key (plan/physical.py filters it from
#: cfg_items; runtime/worker.py strips it before execute_plan) — span ids
#: differ per task and would otherwise fragment the program caches into
#: one XLA trace per task.
TRACE_CTX_KEY = "trace_ctx"

_SPAN_CAP = 4096     # ring-buffer bound per query
_EVENT_CAP = 2048    # trace-level event bound per query
_QUERY_CAP = 32      # LRU bound across queries (running ones pinned)


def table_nbytes(table) -> int:
    """Host-side device-buffer byte count of an ops Table: data + validity
    of every column (no device sync — `.nbytes` reads the aval). The
    data-plane attribution unit: in-process shipments move exactly these
    buffers (by reference), the wire transport serializes them (plus codec
    framing), so spans attributed with this match `nbytes` by
    construction."""
    total = 0
    for c in getattr(table, "columns", ()):
        data = getattr(c, "data", None)
        if data is not None:
            total += int(data.nbytes)
        validity = getattr(c, "validity", None)
        if validity is not None:
            total += int(validity.nbytes)
    return total


def resolve_tracing_mode(options: Optional[dict]) -> str:
    """The effective `SET distributed.tracing` mode from a config-options
    dict (unknown/missing -> off: tracing is strictly opt-in)."""
    mode = str((options or {}).get("tracing", "off") or "off").strip().lower()
    return mode if mode in TRACING_MODES else "off"


def _sampled(query_id: str, rate: float) -> bool:
    """Deterministic per-query sampling decision: a hash of the query id
    against ``rate`` — the same query id always decides the same way, so a
    replayed run re-traces the same queries."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(query_id.encode()) / 0xFFFFFFFF) < rate


class Span:
    """One closed span. ``t0``/``t1`` are raw `time.monotonic` seconds;
    exports normalize against the trace origin."""

    __slots__ = ("span_id", "parent_id", "name", "kind", "t0", "t1",
                 "attrs")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 kind: str, t0: float, t1: float = 0.0,
                 attrs: Optional[dict] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs if attrs is not None else {}

    @property
    def duration(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict:
        return {
            "id": self.span_id, "parent": self.parent_id,
            "name": self.name, "kind": self.kind,
            "t0": self.t0, "t1": self.t1, "attrs": dict(self.attrs),
        }


class _NullSpan:
    """The span NULL_TRACER hands out: swallows every mutation."""

    __slots__ = ()
    span_id = None
    parent_id = None
    attrs: dict = {}
    t0 = t1 = 0.0
    duration = 0.0

    def set(self, **attrs) -> "_NullSpan":
        return self

    def note(self, key, value) -> "_NullSpan":
        return self


_A_NULL_SPAN = _NullSpan()


class _NullCtx:
    """Reusable no-op context manager yielding the null span."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _A_NULL_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_A_NULL_CTX = _NullCtx()


class _NullTracer:
    """The off-mode tracer: every method is a constant-time no-op — call
    sites keep one unconditional code path and pay ~nothing when tracing
    is off (the "always cheap when off" contract)."""

    __slots__ = ()
    active = False

    def span(self, name, kind, parent=None, **attrs):
        return _A_NULL_CTX

    def start_span(self, name, kind, parent=None, **attrs):
        return _A_NULL_SPAN

    def end_span(self, span) -> None:
        pass

    def event(self, name, **attrs) -> None:
        pass

    def reserved_id(self, key):
        return None

    def finish_reserved(self, key, name, kind, t0, t1, parent=None,
                        **attrs) -> None:
        pass

    def current_id(self):
        return None

    def wire_ctx(self):
        return None

    def splice(self, span_dicts, default_parent=None) -> None:
        pass


NULL_TRACER = _NullTracer()


class QueryTrace:
    """One query's bounded span/event store. Thread-safe: spans land from
    the coordinator's stage/task fan-out threads and (spliced) worker
    payloads concurrently."""

    def __init__(self, query_id: str, span_cap: int = _SPAN_CAP,
                 event_cap: int = _EVENT_CAP):
        self.query_id = query_id
        self.t0 = time.monotonic()
        self.t1: Optional[float] = None
        self.finished = False
        # ring buffers: deque(maxlen=...) drops the OLDEST on overflow;
        # `dropped` counts evictions so exports can say "N spans dropped"
        self.spans: deque = deque(maxlen=span_cap)  # guarded-by: _lock
        self.events: deque = deque(maxlen=event_cap)  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock
        self.events_dropped = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self._next_id = 0  # guarded-by: _lock
        self._reserved: dict = {}  # guarded-by: _lock
        self.root_id: Optional[int] = None
        # summary tally memo, filled by TraceStore._tally once finished
        self._tally_cache: Optional[tuple] = None

    # -- id allocation ------------------------------------------------------
    def new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def reserve(self, key) -> int:
        """Pre-allocate a span id for ``key`` (e.g. ``("stage", 3)``) so
        children created BEFORE the span closes (task spans inside a still
        -running stage) can parent under it; `finish_reserved` later
        appends the span with this id."""
        with self._lock:
            sid = self._reserved.get(key)
            if sid is None:
                self._next_id += 1
                sid = self._reserved[key] = self._next_id
            return sid

    # -- recording ----------------------------------------------------------
    def add_span(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(span)

    def add_event(self, t: float, name: str, attrs: dict,
                  parent: Optional[int]) -> None:
        with self._lock:
            if len(self.events) == self.events.maxlen:
                self.events_dropped += 1
            self.events.append((t, name, attrs, parent))

    # -- inspection ---------------------------------------------------------
    def span_list(self) -> list:
        with self._lock:
            return list(self.spans)

    def event_list(self) -> list:
        with self._lock:
            return list(self.events)

    def root_span(self) -> Optional[Span]:
        rid = self.root_id
        if rid is None:
            return None
        for s in self.span_list():
            if s.span_id == rid:
                return s
        return None

    def finish(self) -> None:
        self.finished = True
        if self.t1 is None:
            self.t1 = time.monotonic()


class Tracer:
    """Per-query recording facade over a QueryTrace. Implicit parenting
    rides a PER-THREAD span stack (`span()` pushes/pops), so nested host
    phases need no explicit plumbing; work fanned out to pool threads
    passes an explicit ``parent`` (usually a reserved stage span id) to
    seed its own stack."""

    __slots__ = ("trace", "_local")
    active = True

    def __init__(self, trace: QueryTrace):
        self.trace = trace
        self._local = threading.local()

    # -- parent stack -------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current_id(self) -> Optional[int]:
        st = self._stack()
        return st[-1] if st else self.trace.root_id

    # -- spans --------------------------------------------------------------
    def span(self, name: str, kind: str, parent: Optional[int] = None,
             **attrs):
        """Context manager: opens a span now, closes+records it on exit.
        An exception closing the span is recorded as ``error=<TypeName>``
        and re-raised."""
        return _SpanCtx(self, name, kind, parent, attrs)

    def start_span(self, name: str, kind: str,
                   parent: Optional[int] = None, **attrs) -> Span:
        """Explicit begin (no stack participation) — for spans whose end
        lives in a different scope (the query root)."""
        pid = parent if parent is not None else self.current_id()
        return Span(self.trace.new_id(), pid, name, kind,
                    time.monotonic(), attrs=attrs)

    def end_span(self, span: Span) -> None:
        span.t1 = time.monotonic()
        self.trace.add_span(span)

    def reserved_id(self, key) -> int:
        return self.trace.reserve(key)

    def finish_reserved(self, key, name: str, kind: str, t0: float,
                        t1: float, parent: Optional[int] = None,
                        **attrs) -> None:
        """Record the span pre-allocated by `reserved_id(key)` with
        explicit timestamps (the stage spans: the scheduler knows
        submit/start/end after the fact). Default parent: the recording
        thread's current span (the scheduler span), else the root."""
        sid = self.trace.reserve(key)
        pid = parent if parent is not None else self.current_id()
        self.trace.add_span(Span(sid, pid, name, kind, t0, t1, attrs))

    # -- events -------------------------------------------------------------
    def event(self, name: str, **attrs) -> None:
        self.trace.add_event(time.monotonic(), name, attrs,
                             self.current_id())

    # -- cross-wire ---------------------------------------------------------
    def wire_ctx(self) -> dict:
        """The context that rides the task envelope: worker-side spans
        recorded under it join the trace at `splice` time via the
        propagated parent span id."""
        return {"q": self.trace.query_id, "parent": self.current_id()}

    def splice(self, span_dicts, default_parent: Optional[int] = None
               ) -> None:
        """Adopt worker-side span dicts (see worker_span) into this trace:
        each gets a fresh local id and parents under its propagated
        ``wire_parent`` (falling back to ``default_parent`` / the root).
        Worker timestamps are CLOCK_MONOTONIC — system-wide on Linux, so
        same-host workers (in-process and gRPC-localhost tiers) splice
        without rebasing."""
        if default_parent is None:
            default_parent = self.current_id()
        for d in span_dicts:
            try:
                pid = d.get("wire_parent")
                if pid is None:
                    pid = default_parent
                attrs = dict(d.get("attrs") or {})
                attrs.setdefault("remote", True)
                self.trace.add_span(Span(
                    self.trace.new_id(), pid,
                    str(d.get("name", "worker")),
                    str(d.get("kind", "execute")),
                    float(d.get("t0", 0.0)), float(d.get("t1", 0.0)),
                    attrs,
                ))
            except (TypeError, ValueError, KeyError):
                continue  # a malformed wire span must never fail the task


class _SpanCtx:
    __slots__ = ("_tracer", "_span", "_name", "_kind", "_parent", "_attrs")

    def __init__(self, tracer: Tracer, name, kind, parent, attrs):
        self._tracer = tracer
        self._name = name
        self._kind = kind
        self._parent = parent
        self._attrs = attrs
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        tr = self._tracer
        pid = self._parent if self._parent is not None else tr.current_id()
        sp = Span(tr.trace.new_id(), pid, self._name, self._kind,
                  time.monotonic(), attrs=self._attrs)
        tr._stack().append(sp.span_id)
        self._span = sp
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._span
        tr = self._tracer
        st = tr._stack()
        if st and st[-1] == sp.span_id:
            st.pop()
        elif sp.span_id in st:  # defensive: unwound out of order
            st.remove(sp.span_id)
        if exc_type is not None:
            sp.attrs.setdefault("error", exc_type.__name__)
        sp.t1 = time.monotonic()
        tr.trace.add_span(sp)
        return False


def worker_span(name: str, kind: str, t0: float, t1: float,
                wire_parent, **attrs) -> dict:
    """A worker-side span as a plain JSON-able dict: rides the existing
    task-progress payload back to the coordinator (in-process AND gRPC)
    where `Tracer.splice` adopts it under the propagated parent."""
    return {"name": name, "kind": kind, "t0": t0, "t1": t1,
            "wire_parent": wire_parent, "attrs": attrs}


class TraceStore:
    """query_id -> QueryTrace, LRU-bounded with running queries pinned
    (the MetricsStore retention contract). One process-wide default store
    (`DEFAULT_TRACE_STORE`) backs `ctx.last_trace()`,
    `QueryHandle.trace()`, explain_analyze's profile fold and the
    observability summary."""

    def __init__(self, query_cap: int = _QUERY_CAP,
                 span_cap: int = _SPAN_CAP):
        self.query_cap = query_cap
        self.span_cap = span_cap
        # insertion order == LRU order
        self._traces: dict = {}  # guarded-by: _lock; per-query: swept-by finish
        self._running: set = set()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._started_total = 0  # guarded-by: _lock

    # -- lifecycle ----------------------------------------------------------
    def begin(self, query_id: str, mode: str,
              sample_rate: float = 0.125):
        """-> a live Tracer for this query, or NULL_TRACER when the mode
        (or the sampling decision) says no. The trace is pinned against
        LRU eviction until `finish(query_id)`."""
        if mode == "off":
            return NULL_TRACER
        if mode == "sampled" and not _sampled(query_id, sample_rate):
            return NULL_TRACER
        trace = QueryTrace(query_id, span_cap=self.span_cap)
        with self._lock:
            self._running.add(query_id)
            self._traces[query_id] = trace
            self._started_total += 1
            self._evict_locked()
        return Tracer(trace)

    def finish(self, query_id: str) -> None:
        with self._lock:
            self._running.discard(query_id)
            trace = self._traces.get(query_id)
            self._evict_locked()
        if trace is not None:
            trace.finish()

    def _evict_locked(self) -> None:
        if len(self._traces) <= self.query_cap:
            return
        for qid in list(self._traces):
            if len(self._traces) <= self.query_cap:
                break
            if qid in self._running:
                continue  # never evict a live query's trace
            self._traces.pop(qid)

    # -- lookup -------------------------------------------------------------
    def get(self, query_id: str) -> Optional[QueryTrace]:
        with self._lock:
            trace = self._traces.get(query_id)
            if trace is not None:  # move-to-end: LRU touch
                self._traces.pop(query_id)
                self._traces[query_id] = trace
            return trace

    def last(self) -> Optional[QueryTrace]:
        """Most recently FINISHED trace (running ones are still filling)."""
        with self._lock:
            finished = [t for t in self._traces.values() if t.finished]
        if not finished:
            return None
        return max(finished, key=lambda t: t.t1 or 0.0)

    def annotate(self, query_id: str, **attrs) -> None:
        """Attach attrs to a trace's root span after the fact (the serving
        tier adds admission queue-wait once the handle resolves)."""
        trace = self.get(query_id)
        if trace is None:
            return
        root = trace.root_span()
        if root is not None:
            root.attrs.update(attrs)

    # -- aggregate counters (observability surface) -------------------------
    @staticmethod
    def _tally(trace: QueryTrace) -> tuple:
        """(spans_by_kind, events_by_name, bytes, dropped) for one trace.
        Cached once the trace is FINISHED — its spans/events are immutable
        from then on (post-finish `annotate` only touches root attrs, not
        counts), so the console polling the summary twice a second scans
        only the handful of running traces, not every retained one."""
        cached = getattr(trace, "_tally_cache", None)
        if cached is not None:
            return cached
        by_kind: dict = {}
        by_name: dict = {}
        nbytes = 0
        for s in trace.span_list():
            by_kind[s.kind] = by_kind.get(s.kind, 0) + 1
            b = s.attrs.get("bytes")
            if b:
                nbytes += int(b)
        for _t, name, _a, _p in trace.event_list():
            by_name[name] = by_name.get(name, 0) + 1
        out = (by_kind, by_name, nbytes, trace.dropped)
        if trace.finished:
            trace._tally_cache = out
        return out

    def summary(self) -> dict:
        with self._lock:
            traces = list(self._traces.values())
            running = len(self._running)
            started = self._started_total
        spans_by_kind: dict = {}
        events_by_name: dict = {}
        total_bytes = 0
        dropped = 0
        for t in traces:
            by_kind, by_name, nbytes, t_dropped = self._tally(t)
            dropped += t_dropped
            for k, n in by_kind.items():
                spans_by_kind[k] = spans_by_kind.get(k, 0) + n
            for k, n in by_name.items():
                events_by_name[k] = events_by_name.get(k, 0) + n
            total_bytes += nbytes
        return {
            "traces": len(traces),
            "traces_started": started,
            "running": running,
            "spans": sum(spans_by_kind.values()),
            "spans_by_kind": spans_by_kind,
            "spans_dropped": dropped,
            "events": sum(events_by_name.values()),
            "events_by_name": events_by_name,
            "data_plane_bytes": total_bytes,
        }


DEFAULT_TRACE_STORE = TraceStore()


# ---------------------------------------------------------------------------
# single-node spans: the profiler mirror, the single-node query trace and the
# span totals (module docstring)
# ---------------------------------------------------------------------------

#: the prefix of the profiler ranges the single-node spans open
PROFILER_PREFIX = "dftpu"

_LOCAL_LOCK = threading.Lock()
#: single-node query traces open in this process (`local_query`); with the
#: profiler's own flag, what a span site checks
_local_open = 0  # guarded-by: _LOCAL_LOCK
#: ``.tracer``: the thread's open single-node Tracer
_local = threading.local()
#: (kind, name, outcome) -> [spans, host ns] of the spans closed while on
_TOTALS: dict = {}  # guarded-by: _LOCAL_LOCK


def spans_on() -> bool:
    """True while `torch.profiler` records or a single-node query trace is
    open: a span site then records (see `span`)."""
    return bool(_local_open) or _autograd_profiler._is_profiler_enabled


def span(kind: str, name: str, attr: str = "", value: Any = None):
    """A span of the single-node path, ``<kind>:<name>``, with at most one
    attribute ``attr`` = ``value`` (more with ``note`` inside). A context
    manager; off (`spans_on()` false) it is the shared null context, whose
    span's ``note`` does nothing: no span object, no clock read, no dict."""
    if not (_local_open or _autograd_profiler._is_profiler_enabled):
        return _A_NULL_CTX
    return _LocalSpan(kind, name, attr, value)


class _LocalSpan:
    """One open single-node span: its profiler range while the profiler
    records, its Span in the thread's single-node trace when one is open,
    and its host nanoseconds in the totals."""

    __slots__ = ("kind", "name", "attrs", "_range", "_ctx", "_t0")

    def __init__(self, kind: str, name: str, attr: str, value: Any):
        self.kind = kind
        self.name = name
        self.attrs = {attr: value} if attr else {}
        self._range = None
        self._ctx = None
        self._t0 = 0

    def __enter__(self) -> "_LocalSpan":
        if (_RecordFunctionFast is not None
                and _autograd_profiler._is_profiler_enabled):
            self._range = _RecordFunctionFast(
                f"{PROFILER_PREFIX}:{self.kind}:{self.name}")
            self._range.__enter__()
        tracer = getattr(_local, "tracer", None)
        if tracer is not None:
            self._ctx = tracer.span(self.name, self.kind)
            self._ctx.__enter__().attrs = self.attrs  # one dict, shared
        self._t0 = time.perf_counter_ns()
        return self

    def note(self, key: str, value: Any) -> "_LocalSpan":
        """Set an attribute known only once the span is open (the plan
        cache's ``cache``, an attempt's ``outcome``)."""
        self.attrs[key] = value
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        ns = time.perf_counter_ns() - self._t0
        if self._ctx is not None:
            self._ctx.__exit__(exc_type, exc, tb)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        key = (self.kind, self.name, self.attrs.get("outcome"))
        with _LOCAL_LOCK:
            slot = _TOTALS.get(key)
            if slot is None:
                _TOTALS[key] = [1, ns]
            else:
                slot[0] += 1
                slot[1] += ns
        return False


def span_totals() -> dict:
    """``{"<kind>:<name>[:<outcome>]": (spans, host seconds)}`` of the
    single-node spans closed while spans were on, since the last
    `reset_span_totals()`: the profiler's ranges summed, without a
    profiler (an attempt's key carries its outcome, ``ok`` or
    ``overflow``)."""
    with _LOCAL_LOCK:
        items = [(k, tuple(v)) for k, v in _TOTALS.items()]
    out: dict = {}
    for (kind, name, outcome), (count, ns) in items:
        key = f"{kind}:{name}" + (f":{outcome}" if outcome else "")
        out[key] = (count, ns / 1e9)
    return out


def reset_span_totals() -> None:
    with _LOCAL_LOCK:
        _TOTALS.clear()


def local_query(mode: str, sample_rate: float = 0.125, store=None):
    """The single-node query trace of one `DataFrame.collect_table`: under
    ``mode`` ``on`` (or ``sampled``, and sampled) a context manager that
    opens a `QueryTrace` in ``store`` (`DEFAULT_TRACE_STORE`) with a root
    span ``query``, makes it the thread's for `span`, and finishes it on
    exit; ``off`` gives the null context."""
    if mode == "off":
        return _A_NULL_CTX
    return _LocalQuery(store or DEFAULT_TRACE_STORE, mode, sample_rate)


class _LocalQuery:
    __slots__ = ("_store", "_mode", "_rate", "_qid", "_tracer", "_root",
                 "_prev")

    def __init__(self, store: TraceStore, mode: str, rate: float):
        self._store = store
        self._mode = mode
        self._rate = rate
        self._qid = uuid.uuid4().hex
        self._tracer = NULL_TRACER
        self._root = None
        self._prev = None

    def __enter__(self):
        global _local_open
        tracer = self._store.begin(self._qid, self._mode, self._rate)
        if tracer is NULL_TRACER:
            return _A_NULL_SPAN
        self._tracer = tracer
        self._root = tracer.start_span("query", "query", query_id=self._qid,
                                       path="single-node")
        tracer.trace.root_id = self._root.span_id
        self._prev = getattr(_local, "tracer", None)
        _local.tracer = tracer
        with _LOCAL_LOCK:
            _local_open += 1
        return self._root

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _local_open
        if self._tracer is NULL_TRACER:
            return False
        with _LOCAL_LOCK:
            _local_open -= 1
        _local.tracer = self._prev
        if exc_type is not None:
            self._root.attrs.setdefault("error", exc_type.__name__)
        self._tracer.end_span(self._root)
        self._store.finish(self._qid)
        return False


# ---------------------------------------------------------------------------
# analysis helpers (tests + profile report)
# ---------------------------------------------------------------------------


def _interval_union(intervals) -> list:
    """Merge [lo, hi] intervals -> disjoint sorted list."""
    ivs = sorted((lo, hi) for lo, hi in intervals if hi > lo)
    out: list = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def trace_coverage(trace: QueryTrace) -> tuple:
    """(covered_fraction, max_gap_fraction) of the ROOT span's interval by
    the union of every other span — the acceptance metric: >= 95% of the
    measured query wall attributed, no unattributed gap over 5%."""
    root = trace.root_span()
    if root is None or root.duration <= 0:
        return 0.0, 1.0
    lo, hi = root.t0, root.t1
    union = _interval_union(
        (max(s.t0, lo), min(s.t1, hi))
        for s in trace.span_list() if s.span_id != root.span_id
    )
    covered = sum(b - a for a, b in union)
    # gaps: before the first covered interval, between them, after the last
    gaps = []
    cursor = lo
    for a, b in union:
        gaps.append(a - cursor)
        cursor = b
    gaps.append(hi - cursor)
    dur = hi - lo
    return covered / dur, (max(gaps) if gaps else dur) / dur


def stage_data_rates(trace: QueryTrace) -> dict:
    """stage_id -> {"bytes", "wall_s", "bytes_per_s"}: every byte-carrying
    span (codec encode, dispatch ship, exchange transfer, worker staging)
    summed per stage lane and divided by the stage's EXECUTE wall (queue
    wait excluded) — the measured GB/s column the zero-copy roadmap item
    needs."""
    spans = trace.span_list()
    stage_spans = {
        s.attrs.get("stage"): s for s in spans if s.kind == "stage"
    }
    # children index: stage lane membership is transitive over parents
    by_id = {s.span_id: s for s in spans}

    def stage_of(s: Span):
        seen = 0
        cur = s
        while cur is not None and seen < 64:
            if cur.kind == "stage":
                return cur.attrs.get("stage")
            cur = by_id.get(cur.parent_id)
            seen += 1
        return None

    out: dict = {}
    for s in spans:
        b = s.attrs.get("bytes")
        if not b:
            continue
        sid = s.attrs.get("stage")
        if sid is None:
            sid = stage_of(s)
        if sid is None:
            continue
        slot = out.setdefault(sid, {"bytes": 0, "wall_s": 0.0})
        slot["bytes"] += int(b)
    for sid, slot in out.items():
        st = stage_spans.get(sid)
        wall = None
        if st is not None:
            wall = max(st.duration - float(st.attrs.get("queue_s", 0.0)),
                       0.0)
        slot["wall_s"] = wall if wall else 0.0
        slot["bytes_per_s"] = (
            slot["bytes"] / wall if wall else None
        )
    return out


def self_times(trace: QueryTrace) -> list:
    """[(span, self_seconds)] sorted descending: span duration minus the
    union of its direct children's intervals (overlapping children — a
    stage's concurrent tasks — must not subtract twice)."""
    spans = trace.span_list()
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent_id, []).append(s)
    out = []
    for s in spans:
        kids = children.get(s.span_id, ())
        covered = sum(
            b - a for a, b in _interval_union(
                (max(k.t0, s.t0), min(k.t1, s.t1)) for k in kids
            )
        )
        out.append((s, max(s.duration - covered, 0.0)))
    out.sort(key=lambda p: -p[1])
    return out


def format_bytes(n: float) -> str:
    """Human-readable byte count (shared with console.py — one formatter,
    no drift between the panel and the profile report)."""
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


_fmt_bytes = format_bytes


def render_profile(trace: QueryTrace, top_n: int = 10) -> str:
    """The per-query text profile (folded into explain_analyze): top-N
    spans by self time, per-stage data-plane bytes/sec, queue-wait vs
    execute split, fault events."""
    root = trace.root_span()
    spans = trace.span_list()
    if root is None or not spans:
        return ""
    lines = [f"-- trace profile (query {trace.query_id[:8]}) --"]
    cov, max_gap = trace_coverage(trace)
    lines.append(
        f"wall {root.duration:.4f}s  {len(spans)} spans"
        + (f" ({trace.dropped} dropped)" if trace.dropped else "")
        + f"  coverage {cov * 100.0:.1f}%"
        f"  max gap {max_gap * 100.0:.1f}%"
    )
    lines.append("top spans by self time:")
    for s, self_s in self_times(trace)[:top_n]:
        if self_s <= 0.0:
            continue
        where = []
        for k in ("stage", "task", "attempt", "worker"):
            v = s.attrs.get(k)
            if v is not None:
                where.append(f"{k}={v}")
        b = s.attrs.get("bytes")
        if b:
            where.append(_fmt_bytes(b))
        lines.append(
            f"  {self_s:8.4f}s  {s.kind:<9} {s.name:<18} "
            + " ".join(where)
        )
    rates = stage_data_rates(trace)
    if rates:
        lines.append("per-stage data plane:")
        for sid in sorted(rates, key=lambda x: (x is None, x)):
            slot = rates[sid]
            rate = slot.get("bytes_per_s")
            rate_txt = (
                f"{rate / 1e9:.3f} GB/s" if rate else "n/a"
            )
            lines.append(
                f"  stage {sid}: {_fmt_bytes(slot['bytes'])} "
                f"in {slot['wall_s']:.4f}s = {rate_txt}"
            )
    stage_spans = [s for s in spans if s.kind == "stage"]
    if stage_spans:
        queue = sum(float(s.attrs.get("queue_s", 0.0)) for s in stage_spans)
        execute = sum(s.duration for s in stage_spans) - queue
        lines.append(
            f"queue wait {queue:.4f}s vs execute {max(execute, 0.0):.4f}s "
            "(summed over stages)"
        )
    events = trace.event_list()
    if events:
        counts: dict = {}
        for _t, name, _a, _p in events:
            counts[name] = counts.get(name, 0) + 1
        lines.append(
            "events: " + ", ".join(
                f"{k}={counts[k]}" for k in sorted(counts)
            )
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------


def to_chrome_trace(trace: QueryTrace) -> dict:
    """Chrome trace-event JSON (the 'X' complete-event + 'i' instant-event
    subset Perfetto renders directly). Lanes (tids) group spans by stage /
    worker so the stage overlap and the data-plane hops read visually."""
    spans = trace.span_list()
    by_id = {s.span_id: s for s in spans}
    base = trace.t0
    lanes: dict = {}

    def lane_for(s: Span) -> str:
        if s.kind in ("query", "schedule", "plan"):
            return "coordinator"
        cur = s
        hops = 0
        while cur is not None and hops < 64:
            sid = cur.attrs.get("stage")
            if cur.kind == "stage" and sid is not None:
                return f"stage {sid}"
            cur = by_id.get(cur.parent_id)
            hops += 1
        return "coordinator"

    def tid_of(label: str) -> int:
        if label not in lanes:
            lanes[label] = len(lanes) + 1
        return lanes[label]

    events = []
    for s in spans:
        args = {k: v for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append({
            "name": s.name,
            "cat": s.kind,
            "ph": "X",
            "ts": round((s.t0 - base) * 1e6, 3),
            "dur": round(s.duration * 1e6, 3),
            "pid": 1,
            "tid": tid_of(lane_for(s)),
            "args": args,
        })
    for t, name, attrs, parent in trace.event_list():
        parent_span = by_id.get(parent)
        lane = lane_for(parent_span) if parent_span else "coordinator"
        events.append({
            "name": name, "cat": "event", "ph": "i", "s": "t",
            "ts": round((t - base) * 1e6, 3),
            "pid": 1, "tid": tid_of(lane), "args": dict(attrs),
        })
    for label, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": label},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "query_id": trace.query_id,
            "spans_dropped": trace.dropped,
        },
    }


def chrome_trace_json(trace: QueryTrace) -> str:
    return json.dumps(to_chrome_trace(trace))
