"""Structured JSON event logging, correlated with traces and metrics.

Before this module the fault paths were asymmetric: every transition
(task_retry, worker_quarantined, hedge_won, checkpoint_saved, ...)
emitted a TRACE event — visible only when `SET distributed.tracing` was
on and only inside that query's bounded trace — and nothing else. The
event log is the always-on half: one `log_event(kind, **fields)` path
carrying the SAME query/stage/task ids as the trace spans, so logs,
metrics, and traces correlate on the same ids (find a `task_retry` in
the log, open the query id's trace, read the matching event + the
`dftpu_faults` counter it also bumped).

- Ring-buffered (bounded — a long-lived serving process keeps the last
  ``capacity`` events, with a dropped counter), thread-safe.
- ``DFTPU_EVENT_LOG=path``: every event is ALSO appended to ``path`` as
  one JSON line at log time (operator tailing / post-mortem). `dump()`
  writes the current ring on demand.
- Host-side only: no event-log call may run inside a jax-traced
  function (tools/check_tracer_safety.py rule DFTPU110) and nothing
  here enters a compile-cache key.

Event schema (README "Telemetry"): ``{"ts": unix_seconds, "seq": n,
"kind": str, "query_id"/"stage"/"task"/"worker": optional ids,
...kind-specific fields}`` — every value must be JSON-serializable
(non-serializable values are repr()'d rather than failing the caller).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class EventLog:
    """Bounded structured event ring with an optional JSONL sink."""

    def __init__(self, capacity: int = 4096,
                 path: Optional[str] = None):
        if capacity < 1:
            raise ValueError("event-log capacity must be >= 1")
        self.capacity = int(capacity)
        # sink resolution is per-log-call (env read at call time would
        # cost a getenv per event; the default log resolves it lazily
        # instead — see default_event_log)
        self.path = path
        self._lock = threading.Lock()
        self._ring: list = []  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        #: MONOTONIC per-kind totals (never decremented by ring
        #: eviction) — the counter-typed exposition must not go down or
        #: scrapers read every eviction as a counter reset
        self._kind_counts: dict = {}  # guarded-by: _lock
        self._sink = None  # guarded-by: _lock  (lazily opened file)
        self._sink_failed = False  # guarded-by: _lock

    def log(self, kind: str, **fields) -> dict:
        """Record one event; -> the event dict (already stamped). The
        id fields (`query_id`, `stage`, `task`, `worker`) are plain
        kwargs — callers pass whichever apply, matching the trace-event
        attribute names so the two streams join on them."""
        event = {"ts": time.time(), "kind": str(kind)}
        for k, v in fields.items():
            if v is None:
                continue
            try:
                json.dumps(v)
                event[k] = v
            except (TypeError, ValueError):
                event[k] = repr(v)
        line = None
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._kind_counts[event["kind"]] = (
                self._kind_counts.get(event["kind"], 0) + 1
            )
            self._ring.append(event)
            while len(self._ring) > self.capacity:
                self._ring.pop(0)
                self._dropped += 1
            if self.path and not self._sink_failed:
                try:
                    if self._sink is None:
                        self._sink = open(self.path, "a",
                                          encoding="utf-8")
                    line = self._sink
                except OSError:
                    self._sink_failed = True  # never poison callers
        if line is not None:
            try:
                # the file object's write/flush are thread-safe enough
                # for whole-line appends; a torn tail only costs the
                # reader one line (bench.py's event reader tolerates it)
                line.write(json.dumps(event) + "\n")
                line.flush()
            except (OSError, ValueError):
                with self._lock:
                    self._sink_failed = True
        return event

    def events(self, kind: Optional[str] = None,
               query_id: Optional[str] = None) -> list:
        """Snapshot copy of the ring, optionally filtered."""
        with self._lock:
            ring = list(self._ring)
        return [
            e for e in ring
            if (kind is None or e["kind"] == kind)
            and (query_id is None or e.get("query_id") == query_id)
        ]

    def stats(self) -> dict:
        with self._lock:
            return {
                "events": len(self._ring),
                "total": self._seq,
                "dropped": self._dropped,
                "sink": self.path if not self._sink_failed else None,
            }

    def telemetry_families(self) -> list:
        """Registry adapter (runtime/telemetry.py): per-kind event
        counters + the drop counter."""
        from datafusion_distributed_tpu_torch.runtime.telemetry import family

        with self._lock:
            by_kind = dict(self._kind_counts)
            dropped, total = self._dropped, self._seq
        return [
            family("dftpu_events", "counter",
                   "Structured events ever logged, by kind.",
                   [({"kind": k}, v) for k, v in sorted(by_kind.items())]),
            family("dftpu_events_logged", "counter",
                   "Structured events ever logged.", [({}, total)]),
            family("dftpu_events_dropped", "counter",
                   "Events evicted from the bounded ring.",
                   [({}, dropped)]),
        ]

    def dump(self, path: Optional[str] = None) -> int:
        """Write the retained ring as JSON lines; -> events written."""
        target = path or self.path
        if not target:
            raise ValueError("no dump path (arg or DFTPU_EVENT_LOG)")
        events = self.events()
        with open(target, "w", encoding="utf-8") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)

    def clear(self) -> None:
        with self._lock:
            self._ring = []
            self._dropped = 0

    def close(self) -> None:
        with self._lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.close()
            except OSError:
                pass


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[EventLog] = None  # guarded-by: _DEFAULT_LOCK


def default_event_log() -> EventLog:
    """The process-wide event log (lazily built so DFTPU_EVENT_LOG is
    read once, at first use)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = EventLog(
                capacity=int(os.environ.get("DFTPU_EVENT_LOG_CAP",
                                            "4096")),
                path=os.environ.get("DFTPU_EVENT_LOG") or None,
            )
        return _DEFAULT


def log_event(kind: str, **fields) -> dict:
    """Module-level convenience over the process-wide log."""
    return default_event_log().log(kind, **fields)
