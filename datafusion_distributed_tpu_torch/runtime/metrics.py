"""Metrics collection + explain_analyze rendering.

The reference collects DataFusion per-node metrics on workers, protobuf-ships
them to the coordinator's MetricsStore, and `explain_analyze` stitches them
back into the plan display labeled by task
(`src/metrics/task_metrics_rewriter.rs`,
`stage.rs display_plan_ascii`). TPU twist: metrics inside a jitted program
must be *traced outputs*, so operators record row-count scalars into the
ExecContext during tracing and the executors return them alongside the
result; host-side wall-clock and bytes metrics attach per task afterwards.

Formats mirror DistributedMetricsFormat::{Aggregated, PerTask}.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from datafusion_distributed_tpu_torch.plan.physical import ExecutionPlan


#: bound on distinct queries whose stage spans a MetricsStore retains
#: (least-recently-touched evicted first — a long-lived serving process
#: must not grow forever; queries still RUNNING are pinned and never
#: evicted, so a burst of short queries cannot erase an in-flight heavy
#: query's spans before its own explain_analyze reads them)
_STAGE_SPAN_QUERY_CAP = 64


@dataclass
class MetricsStore:
    """(task_label -> node_id -> {metric: value}); the watch-map analogue of
    the reference's MetricsStore (`metrics_store.rs`). Also holds the
    concurrent stage scheduler's per-stage wall-clock spans
    (submit -> start -> materialized) and per-query wall clocks, rendered
    by `explain_analyze` as a critical-path summary whose
    `sum(stage wall) / query wall` overlap factor is the proof that
    independent stages actually ran concurrently.

    Thread-safe: under the multi-query serving tier one store is shared
    by every in-flight query's coordinator, so span recording, the
    running-query pin set, and LRU eviction all serialize on one lock."""

    per_task: dict = field(default_factory=dict)  # guarded-by: _lock
    #: query_id -> {stage_id: {"submit_s","start_s","end_s","wall_s",
    #:                          "queue_s","plane"}} (LRU-ordered: a touch
    #: moves the query to the end; eviction pops from the front)
    stage_spans: dict = field(default_factory=dict)  # guarded-by: _lock; per-query: bounded 64
    #: query_id -> total query wall seconds
    query_walls: dict = field(default_factory=dict)  # guarded-by: _lock; per-query: bounded 64

    def __post_init__(self):
        import threading

        self._lock = threading.Lock()
        #: queries currently executing — exempt from LRU eviction
        self._running: set = set()  # guarded-by: _lock

    def insert(self, task_label: str, node_metrics: dict) -> None:
        # DFTPU201 fix: concurrent task threads insert into one shared
        # store under the serving tier; an unlocked dict write raced the
        # snapshot reads below
        with self._lock:
            self.per_task[task_label] = node_metrics

    # -- query lifetime (eviction pinning) ----------------------------------
    def begin_query(self, query_id: str) -> None:
        """Pin ``query_id``: its spans/wall survive any LRU pressure until
        `finish_query`. Coordinator.execute brackets every query with
        these; a begin without a finish (caller died mid-query) is still
        bounded — the pin set only holds in-flight queries."""
        with self._lock:
            self._running.add(query_id)

    def finish_query(self, query_id: str) -> None:
        with self._lock:
            self._running.discard(query_id)
            self._evict_lru()

    def running_queries(self) -> set:
        with self._lock:
            return set(self._running)

    def _evict_lru(self) -> None:
        """Evict least-recently-touched NON-running queries down to the
        cap (caller holds the lock). If running queries alone exceed the
        cap the store grows past it — never evict a live query."""
        for store in (self.stage_spans, self.query_walls):
            if len(store) <= _STAGE_SPAN_QUERY_CAP:
                continue
            for qid in list(store):
                if len(store) <= _STAGE_SPAN_QUERY_CAP:
                    break
                if qid in self._running:
                    continue
                store.pop(qid)

    def _touch(self, store: dict, query_id: str) -> None:
        hit = store.pop(query_id, None)
        if hit is not None:
            store[query_id] = hit  # move-to-end: LRU

    # -- stage scheduling spans ---------------------------------------------
    def record_stage_span(self, query_id: str, stage_id: int,
                          submit_s: float, start_s: float, end_s: float,
                          plane: str = "") -> None:
        """One stage's scheduler span, in seconds on a shared monotonic
        clock: ``submit_s`` when the scheduler enqueued it, ``start_s``
        when a pool slot picked it up, ``end_s`` when its output
        materialized. ``wall_s`` (start->end) is the stage's true
        execution span; queue wait is reported separately so a bounded
        stage_parallelism does not inflate the overlap arithmetic."""
        with self._lock:
            self._touch(self.stage_spans, query_id)
            spans = self.stage_spans.setdefault(query_id, {})
            spans[stage_id] = {
                "submit_s": submit_s,
                "start_s": start_s,
                "end_s": end_s,
                "wall_s": max(end_s - start_s, 0.0),
                "queue_s": max(start_s - submit_s, 0.0),
                "plane": plane,
            }
            self._evict_lru()

    def record_query_wall(self, query_id: str, wall_s: float) -> None:
        with self._lock:
            self._touch(self.query_walls, query_id)
            self.query_walls[query_id] = wall_s
            self._evict_lru()

    def _span_query(self, query_id: Optional[str]) -> Optional[str]:
        if query_id is not None:
            return query_id if query_id in self.stage_spans else None
        return next(reversed(self.stage_spans), None)

    def stage_schedule_summary(self, query_id: Optional[str] = None) -> dict:
        """{"query_id", "stages", "sum_stage_wall_s", "query_wall_s",
        "overlap_factor", "max_concurrent"} for ``query_id`` (default: the
        most recent query). overlap_factor = sum(stage wall)/query wall —
        1.0 means fully serial; >1.0 proves inter-stage overlap.
        max_concurrent is the peak number of stage spans covering one
        instant (computed from the recorded intervals)."""
        with self._lock:
            qid = self._span_query(query_id)
            if qid is None:
                return {}
            spans = dict(self.stage_spans[qid])
            wall = self.query_walls.get(qid)
        total = sum(s["wall_s"] for s in spans.values())
        events = []
        for s in spans.values():
            events.append((s["start_s"], 1))
            events.append((s["end_s"], -1))
        peak = cur = 0
        for _, d in sorted(events):
            cur += d
            peak = max(peak, cur)
        return {
            "query_id": qid,
            "stages": dict(spans),
            "sum_stage_wall_s": total,
            "query_wall_s": wall,
            "overlap_factor": (total / wall) if wall else None,
            "max_concurrent": peak,
        }

    def render_stage_schedule(self, query_id: Optional[str] = None) -> str:
        """Human-readable critical-path summary (explain_analyze appends
        this below the plan tree when spans exist)."""
        s = self.stage_schedule_summary(query_id)
        if not s:
            return ""
        lines = [f"-- stage schedule (query {s['query_id'][:8]}) --"]
        t0 = min(
            (sp["submit_s"] for sp in s["stages"].values()), default=0.0
        )
        for sid in sorted(s["stages"]):
            sp = s["stages"][sid]
            label = "root " if sid == -1 else f"stage {sid}"
            plane = f"  [{sp['plane']}]" if sp.get("plane") else ""
            lines.append(
                f"{label:<9} wall {sp['wall_s']:.4f}s  "
                f"+{sp['start_s'] - t0:.4f}s start  "
                f"queue {sp['queue_s']:.4f}s{plane}"
            )
        wall = s["query_wall_s"]
        if wall:
            lines.append(
                f"sum(stage wall) {s['sum_stage_wall_s']:.4f}s / "
                f"query wall {wall:.4f}s = overlap factor "
                f"{s['overlap_factor']:.2f}x "
                f"(peak {s['max_concurrent']} concurrent stages)"
            )
        else:
            lines.append(
                f"sum(stage wall) {s['sum_stage_wall_s']:.4f}s "
                f"(peak {s['max_concurrent']} concurrent stages)"
            )
        return "\n".join(lines)

    def aggregated(self) -> dict:
        """node_id -> {metric: summed value across tasks}."""
        with self._lock:
            per_task = dict(self.per_task)
        out: dict = {}
        for metrics in per_task.values():
            for nid, mm in metrics.items():
                slot = out.setdefault(nid, {})
                for name, v in mm.items():
                    slot[name] = slot.get(name, 0) + v
        return out

    def per_task_view(self) -> dict:
        """node_id -> {metric_taskN: value} (PerTask format)."""
        with self._lock:
            per_task = dict(self.per_task)
        out: dict = {}
        for label, metrics in sorted(per_task.items()):
            for nid, mm in metrics.items():
                slot = out.setdefault(nid, {})
                for name, v in mm.items():
                    slot[f"{name}_{label}"] = v
        return out


class HedgeBudget:
    """In-flight budget for speculative (hedged) task attempts — the
    stampede guard of the straggler hedger (runtime/coordinator.py): a
    cold latency sketch or a genuinely slow stage makes EVERY task look
    hedge-worthy, and without a bound the hedger would double the
    cluster's load exactly when it is already slow. One budget is shared
    by every per-query coordinator under the serving tier, so the bound
    is cluster-wide, not per-query.

    `try_acquire(limit)` admits a hedge while fewer than ``limit``
    speculative attempts are in flight (the limit is passed per call so
    a live `SET distributed.hedge_budget` applies to the next hedge
    decision); the hedge releases its slot when its attempt resolves."""

    def __init__(self) -> None:
        import threading

        self._lock = threading.Lock()
        self._in_flight = 0  # guarded-by: _lock
        self.peak_in_flight = 0  # guarded-by: _lock
        self.denied = 0  # guarded-by: _lock

    def try_acquire(self, limit: int) -> bool:
        with self._lock:
            if limit <= 0 or self._in_flight >= limit:
                self.denied += 1
                return False
            self._in_flight += 1
            self.peak_in_flight = max(
                self.peak_in_flight, self._in_flight
            )
            return True

    def release(self) -> None:
        with self._lock:
            self._in_flight = max(self._in_flight - 1, 0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "in_flight": self._in_flight,
                "peak_in_flight": self.peak_in_flight,
                "denied": self.denied,
            }

    def telemetry_families(self) -> list:
        """Typed-registry adapter (runtime/telemetry.py)."""
        from datafusion_distributed_tpu_torch.runtime.telemetry import family

        s = self.stats()
        return [
            family("dftpu_hedges_in_flight", "gauge",
                   "Speculative (hedged) attempts currently in flight.",
                   [({}, s["in_flight"])]),
            family("dftpu_hedges_peak_in_flight", "gauge",
                   "High-water mark of concurrent hedged attempts.",
                   [({}, s["peak_in_flight"])]),
            family("dftpu_hedges_denied", "counter",
                   "Hedge attempts denied by the in-flight budget.",
                   [({}, s["denied"])]),
        ]


class FaultCounters:
    """Thread-safe counters for the fault-tolerant execution layer
    (retries, reroutes, timeouts, quarantine trips). Surfaced through
    `Coordinator.faults` and `ObservabilityService.get_fault_counters`;
    mergeable across coordinators like the latency sketch."""

    def __init__(self) -> None:
        import threading

        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}  # guarded-by: _lock

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def as_dict(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def merge(self, other: "FaultCounters") -> "FaultCounters":
        for name, n in other.as_dict().items():
            self.bump(name, n)
        return self

    def telemetry_families(self) -> list:
        """Typed-registry adapter (runtime/telemetry.py): every fault
        counter as one `dftpu_faults{kind=...}` counter family — the
        single exposition sink for the retry/quarantine/hedge/checkpoint
        counters this store already accumulates."""
        from datafusion_distributed_tpu_torch.runtime.telemetry import family

        return [family(
            "dftpu_faults", "counter",
            "Fault-tolerance transitions by kind (retries, reroutes, "
            "timeouts, quarantines, hedges, checkpoints).",
            [({"kind": k}, v) for k, v in sorted(self.as_dict().items())],
        )]


def explain_analyze(
    plan: ExecutionPlan,
    store: MetricsStore,
    per_task: bool = False,
    diagnostics: "Optional[list]" = None,
    trace_store=None,
) -> str:
    """Render the plan tree with metrics stitched into each node line.

    ``diagnostics``: verifier findings (plan/verify.py Diagnostic list, or
    a VerifyResult) rendered per node id next to the runtime metrics —
    e.g. a "literal not hoistable — plan will not share compiles" warning
    lands on the exact Filter it applies to. None = run the verifier here
    so explain_analyze always shows static findings alongside metrics.

    ``trace_store``: the distributed-tracing store whose per-query
    profile report is appended when the executed query was traced (None =
    the process-wide default store, runtime/tracing.py)."""
    from datafusion_distributed_tpu_torch.plan.verify import (
        VerifyResult,
        diag_suffix,
        verify_physical_plan,
    )

    node_metrics = store.per_task_view() if per_task else store.aggregated()
    if diagnostics is None:
        result = verify_physical_plan(plan)
    elif isinstance(diagnostics, VerifyResult):
        result = diagnostics
    else:
        result = VerifyResult(diagnostics)
    diag_by_node = result.by_node()
    lines = []

    def walk(node: ExecutionPlan, indent: int) -> None:
        mm = node_metrics.get(node.node_id, {})
        suffix = ""
        if mm:
            inner = ", ".join(f"{k}={_fmt(v)}" for k, v in sorted(mm.items()))
            suffix = f"  [{inner}]"
        suffix += diag_suffix(diag_by_node.get(node.node_id, ()))
        marker = ""
        if getattr(node, "is_exchange", False):
            marker = f" ── stage {node.stage_id}"
        lines.append("  " * indent + node.display() + marker + suffix)
        for c in node.children():
            walk(c, indent + 1)

    walk(plan, 0)
    # the schedule block binds to THIS plan's execution (the coordinator
    # stamps `_last_query_id` at submit): a store holding spans for many
    # queries must not render some other query's critical path here —
    # an unstamped plan (never coordinator-executed) renders none
    qid = getattr(plan, "_last_query_id", None)
    if qid is not None and store.stage_spans:
        schedule = store.render_stage_schedule(qid)
        if schedule:
            lines.append("")
            lines.append(schedule)
    # distributed-tracing profile fold (runtime/tracing.py): when the
    # query ran with `SET distributed.tracing` on, append its per-query
    # profile — top spans by self time, per-stage data-plane bytes/sec,
    # queue-wait vs execute split, fault events
    if qid is not None:
        from datafusion_distributed_tpu_torch.runtime.tracing import (
            DEFAULT_TRACE_STORE,
            render_profile,
        )

        ts = trace_store if trace_store is not None else DEFAULT_TRACE_STORE
        trace = ts.get(qid)
        if trace is not None:
            profile = render_profile(trace)
            if profile:
                lines.append("")
                lines.append(profile)
    return "\n".join(lines)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


class LatencySketch:
    """Mergeable log-bucketed latency sketch (the DDSketch role in the
    reference: per-task latency distributions shipped as sketch bytes and
    merged coordinator-side, `metrics/latency_metric.rs:3-13`,
    worker.proto PercentileLatency).

    Buckets are powers of gamma, giving a fixed RELATIVE accuracy
    (gamma=1.02 -> ~2% error on any quantile) with tiny fixed state —
    mergeable by adding bucket counts, exactly the property DDSketch is
    used for."""

    def __init__(self, gamma: float = 1.02, min_value: float = 1e-6):
        import math
        import threading

        self.gamma = gamma
        self.min_value = min_value
        self._log_gamma = math.log(gamma)
        self.buckets: dict[int, int] = {}  # guarded-by: _lock
        self.count = 0  # guarded-by: _lock
        self.min: Optional[float] = None  # guarded-by: _lock
        self.max: Optional[float] = None  # guarded-by: _lock
        # the serving tier shares ONE sketch across every concurrent
        # query's coordinator and calling threads: the read-modify-write on
        # buckets/count must serialize or updates are silently lost
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        import math

        v = max(float(value), self.min_value)
        idx = int(math.ceil(math.log(v / self.min_value) / self._log_gamma))
        with self._lock:
            self.buckets[idx] = self.buckets.get(idx, 0) + 1
            self.count += 1
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        assert other.gamma == self.gamma
        with other._lock:
            obuckets = dict(other.buckets)
            ocount, omin, omax = other.count, other.min, other.max
        with self._lock:
            for idx, c in obuckets.items():
                self.buckets[idx] = self.buckets.get(idx, 0) + c
            self.count += ocount
            for bound, ov in (("min", omin), ("max", omax)):
                sv = getattr(self, bound)
                if ov is not None:
                    pick = min if bound == "min" else max
                    setattr(self, bound, ov if sv is None else pick(sv, ov))
        return self

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1] -> value with <= gamma relative error."""
        with self._lock:
            if self.count == 0:
                return None
            buckets = dict(self.buckets)
            count, vmax = self.count, self.max
        target = max(1, int(round(q * count)))
        seen = 0
        for idx in sorted(buckets):
            seen += buckets[idx]
            if seen >= target:
                # bucket midpoint in log space
                return self.min_value * self.gamma ** (idx - 0.5)
        return vmax

    def summary(self) -> dict:
        return {
            "count": self.count,
            "min": self.min,
            "p50": self.percentile(0.50),
            "p75": self.percentile(0.75),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "max": self.max,
        }

    def telemetry_families(self, name: str, help_text: str = "") -> list:
        """Typed-registry adapter (runtime/telemetry.py): the sketch as
        a prometheus-style summary — `<name>{quantile=...}` gauges plus
        `<name>_observations` — under a caller-chosen metric name (one
        sketch class serves both the task- and query-latency roles)."""
        from datafusion_distributed_tpu_torch.runtime.telemetry import family

        s = self.summary()
        quantiles = [
            ({"quantile": q}, s[q])
            for q in ("p50", "p95", "p99")
            if s.get(q) is not None
        ]
        fams = [family(
            f"{name}_observations", "counter",
            f"Observations recorded into {name}.", [({}, s["count"])],
        )]
        if quantiles:
            fams.append(family(
                name, "gauge",
                help_text or f"Log-bucketed latency sketch {name} "
                             "(seconds).",
                quantiles,
            ))
        return fams

    def to_dict(self) -> dict:
        """Wire format (the sketch-bytes analogue)."""
        with self._lock:
            return {
                "gamma": self.gamma,
                "min_value": self.min_value,
                "buckets": {str(k): v for k, v in self.buckets.items()},
                "count": self.count,
                "min": self.min,
                "max": self.max,
            }

    @classmethod
    def from_dict(cls, d: dict) -> "LatencySketch":
        s = cls(gamma=d["gamma"], min_value=d["min_value"])
        s.buckets = {int(k): v for k, v in d["buckets"].items()}
        s.count = d["count"]
        s.min = d["min"]
        s.max = d["max"]
        return s
