"""Cluster-wide telemetry: typed metric registry, OpenMetrics exposition,
time-series history, SLO tracking.

The reference's `console/` tier is fed by a continuously collected,
uniformly named metric stream (SURVEY §L-map); before this module every
number in the host runtime lived in an ad-hoc dict (`FaultCounters`,
`HedgeBudget`, `TableStore.stats`, serving `stats()`), pulled on demand
with no standard exposition format and no history. This module is the
single sink those surfaces now publish through:

- `MetricRegistry`: thread-safe typed metrics — `Counter` (monotonic),
  `Gauge` (point-in-time, optionally callback-backed), `Histogram`
  (fixed buckets + sum/count) — each registered ONCE with a name, help
  text, and a FIXED label-name set (prometheus/OpenMetrics semantics:
  a metric family's label keys never vary per sample). Existing stores
  adapt via `register_collector` (a callable returning `family(...)`
  dicts sampled at snapshot time — zero hot-path overhead for counters
  that already exist elsewhere).
- `render_openmetrics`: the Prometheus/OpenMetrics text exposition of a
  snapshot (`# HELP` / `# TYPE` / samples / `# EOF`), served per worker
  through the `get_metrics` RPC on both transports and merged
  cluster-wide by `ObservabilityService.get_metrics()`.
- `TelemetryHistory`: a bounded time-series ring sampling snapshots at a
  configurable resolution — the console's sparkline columns (qps, p99,
  staged bytes, fault rate) render from it (a wired serving session
  SHARES its ring with the console, so per-query registry samples and
  per-frame console samples land in one history).
- `SloTracker`: rolling latency/error window computing SLO attainment
  and error-budget burn against the `SET distributed.slo_p99_ms` /
  `slo_error_rate` targets.

Naming convention (README "Telemetry"): `dftpu_<area>_<name>[_<unit>]`;
counters are registered WITHOUT the `_total` suffix — the exposition
appends it (prometheus client convention). Everything here is host-side
only: no telemetry call may run inside a jax-traced function
(tools/check_tracer_safety.py rule DFTPU110), and no metric name or
label ever enters a compile-cache key.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Optional

_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

#: default histogram bucket upper bounds (seconds-flavored; callers
#: measuring bytes pass their own)
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(
            f"invalid metric name {name!r} (expected [a-z_][a-z0-9_]*)"
        )
    return name


def _label_key(label_names: tuple, labels: dict) -> tuple:
    """Canonical per-sample key: label VALUES in the registered
    label-NAME order (fixed label sets — a sample naming an unknown or
    missing label is a programming error, caught here)."""
    if set(labels) != set(label_names):
        raise ValueError(
            f"labels {sorted(labels)} do not match the registered label "
            f"set {sorted(label_names)}"
        )
    return tuple(str(labels[k]) for k in label_names)


class Metric:
    """One registered metric family. Samples are keyed by label-value
    tuple (in registered label-name order); label-less metrics hold one
    sample under the empty tuple."""

    type: str = "untyped"

    def __init__(self, name: str, help_text: str,
                 label_names: tuple = ()):
        self.name = _check_name(name)
        self.help = str(help_text)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._samples: dict = {}  # guarded-by: _lock
        #: callback-backed samples (populated only by Gauge.set_function;
        #: lives here so field and guarding lock share one class — the
        #: concurrency lint's per-class model)
        self._functions: dict = {}  # guarded-by: _lock

    def _labels_dict(self, key: tuple) -> dict:
        return dict(zip(self.label_names, key))

    def samples(self) -> list:
        """[[labels_dict, value], ...] — a snapshot copy."""
        with self._lock:
            items = list(self._samples.items())
        return [[self._labels_dict(k), v] for k, v in items]

    def family(self) -> dict:
        return {
            "type": self.type,
            "help": self.help,
            "labels": list(self.label_names),
            "samples": self.samples(),
        }


class Counter(Metric):
    """Monotonic counter. Exposition appends `_total` to the name."""

    type = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._samples.get(key, 0)


class Gauge(Metric):
    """Point-in-time value; `set_function` installs a callback sampled
    at snapshot time (for values that already live elsewhere — a store's
    byte count — so no push site is needed)."""

    type = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._samples[key] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0) + amount

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            fn = self._functions.get(key)
            if fn is None:
                return self._samples.get(key, 0)
        return float(fn())

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._functions[key] = fn

    def samples(self) -> list:
        with self._lock:
            items = dict(self._samples)
            functions = list(self._functions.items())
        # callbacks run OUTSIDE the lock (a callback touching another
        # locked object must not nest under this metric's lock)
        for key, fn in functions:
            try:
                items[key] = float(fn())
            except Exception:
                items.pop(key, None)  # degrade: drop the broken sample
        return [[self._labels_dict(k), v] for k, v in items.items()]


class Histogram(Metric):
    """Fixed-bucket histogram (cumulative `le` buckets + sum + count —
    the prometheus exposition shape). Buckets are upper bounds; +Inf is
    implicit."""

    type = "histogram"

    def __init__(self, name: str, help_text: str,
                 label_names: tuple = (), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.label_names, labels)
        v = float(value)
        with self._lock:
            slot = self._samples.get(key)
            if slot is None:
                slot = self._samples[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            idx = len(self.buckets)
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    idx = i
                    break
            slot["counts"][idx] += 1
            slot["sum"] += v
            slot["count"] += 1

    def samples(self) -> list:
        out = []
        with self._lock:
            items = [
                (k, {"counts": list(s["counts"]), "sum": s["sum"],
                     "count": s["count"]})
                for k, s in self._samples.items()
            ]
        for key, slot in items:
            cum = 0
            bucket_pairs = []
            for bound, c in zip(self.buckets, slot["counts"]):
                cum += c
                bucket_pairs.append([bound, cum])
            bucket_pairs.append(["+Inf", slot["count"]])
            out.append([
                self._labels_dict(key),
                {"buckets": bucket_pairs, "sum": slot["sum"],
                 "count": slot["count"]},
            ])
        return out

    def family(self) -> dict:
        fam = super().family()
        fam["bucket_bounds"] = list(self.buckets)
        return fam


def family(name: str, metric_type: str, help_text: str,
           samples) -> tuple:
    """One collector-produced metric family: `(name, family_dict)`.
    ``samples``: iterable of (labels_dict, value). Collector adapters
    over existing stores (FaultCounters.telemetry_families etc.) build
    these instead of mutating typed metrics on every hot-path bump."""
    pairs = [(dict(ls), v) for ls, v in samples]
    return (_check_name(name), {
        "type": metric_type,
        "help": str(help_text),
        "labels": sorted({k for ls, _v in pairs for k in ls}),
        "samples": [[ls, v] for ls, v in pairs],
    })


class MetricRegistry:
    """Thread-safe named registry. Each metric is registered ONCE
    (name + help + label set); re-registering with an identical
    signature returns the existing object (per-query coordinators share
    the serving tier's counters this way), a conflicting signature
    raises — silent divergence between two call sites' idea of a metric
    is exactly what a typed registry exists to prevent."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}  # guarded-by: _lock
        self._collectors: list = []  # guarded-by: _lock

    def _register(self, cls, name: str, help_text: str,
                  label_names, **kw) -> Metric:
        label_names = tuple(label_names)
        with self._lock:
            hit = self._metrics.get(name)
            if hit is not None:
                buckets = kw.get("buckets")
                if (type(hit) is not cls
                        or hit.label_names != label_names
                        or (buckets is not None
                            and tuple(sorted(float(b) for b in buckets))
                            != getattr(hit, "buckets", None))):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{hit.type} with labels {hit.label_names}"
                        + (f" and buckets {hit.buckets}"
                           if hasattr(hit, "buckets") else "")
                    )
                return hit
            m = cls(name, help_text, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_text: str,
                labels=()) -> Counter:
        return self._register(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str, labels=()) -> Gauge:
        return self._register(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str, labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help_text, labels,
                              buckets=buckets)

    def register_collector(self, fn: Callable[[], list]) -> None:
        """``fn() -> [ (name, family_dict), ... ]`` (the `family`
        helper), sampled at every snapshot. The adapter path for
        counters that already live in another thread-safe store."""
        with self._lock:
            self._collectors.append(fn)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """{name: family_dict} — JSON-able, the `get_metrics` wire
        format. Typed metrics first; collector families may not shadow
        a registered typed name."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out: dict = {}
        for m in metrics:
            out[m.name] = m.family()
        for fn in collectors:
            try:
                fams = fn()
            except Exception:
                continue  # a broken adapter degrades, never aborts
            for name, fam in fams:
                if name not in out:
                    out[name] = fam
                else:
                    out[name]["samples"].extend(fam["samples"])
        return out

    def render_openmetrics(self) -> str:
        return render_openmetrics(self.snapshot())


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(merged[k])}"' for k in sorted(merged)
    )
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (math.inf, -math.inf):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_openmetrics(snapshot: dict) -> str:
    """Prometheus/OpenMetrics text exposition of a `snapshot()` (or a
    merged cluster snapshot): `# HELP` / `# TYPE` per family, one sample
    line per label set, counters suffixed `_total`, histograms expanded
    to `_bucket{le=...}` / `_sum` / `_count`, terminated by `# EOF`."""
    lines = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        ftype = fam.get("type", "untyped")
        lines.append(f"# HELP {name} {fam.get('help', '')}".rstrip())
        lines.append(f"# TYPE {name} {ftype}")
        suffix = "_total" if ftype == "counter" else ""
        for labels, value in fam.get("samples", ()):
            if ftype == "histogram" and isinstance(value, dict):
                for le, count in value.get("buckets", ()):
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, {'le': le})} "
                        f"{_fmt_value(count)}"
                    )
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(value.get('sum', 0))}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} "
                    f"{_fmt_value(value.get('count', 0))}"
                )
            else:
                lines.append(
                    f"{name}{suffix}{_fmt_labels(labels)} "
                    f"{_fmt_value(value)}"
                )
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def merge_snapshots(base: Optional[dict], others: dict) -> dict:
    """Fold per-worker snapshots into one cluster snapshot: every sample
    from ``others[url]`` gains a ``worker=url`` label (so two workers'
    identically named gauges stay distinguishable), ``base`` (the
    coordinator/serving-side registry) merges unlabeled. First writer
    wins the family's type/help; samples concatenate."""
    merged: dict = {}

    def fold(snap: dict, extra: Optional[dict]) -> None:
        for name, fam in snap.items():
            slot = merged.get(name)
            if slot is None:
                slot = merged[name] = {
                    "type": fam.get("type", "untyped"),
                    "help": fam.get("help", ""),
                    "labels": list(fam.get("labels", ())),
                    "samples": [],
                }
                if "bucket_bounds" in fam:
                    slot["bucket_bounds"] = fam["bucket_bounds"]
            if extra:
                for lbl in extra:
                    if lbl not in slot["labels"]:
                        slot["labels"].append(lbl)
            for labels, value in fam.get("samples", ()):
                merged_labels = dict(labels)
                if extra:
                    merged_labels.update(extra)
                slot["samples"].append([merged_labels, value])

    if base:
        fold(base, None)
    for url in sorted(others):
        fold(others[url], {"worker": url})
    return merged


def scalar_series(snapshot: dict) -> dict:
    """Flatten a snapshot to {series_name: float} for history sampling:
    `name` for label-less samples, `name{k=v,...}` otherwise; histograms
    contribute `name_sum` / `name_count`."""
    out: dict = {}
    for name, fam in snapshot.items():
        for labels, value in fam.get("samples", ()):
            key = name + _fmt_labels(labels)
            if isinstance(value, dict):  # histogram
                out[name + "_sum" + _fmt_labels(labels)] = float(
                    value.get("sum", 0)
                )
                out[name + "_count" + _fmt_labels(labels)] = float(
                    value.get("count", 0)
                )
            else:
                try:
                    out[key] = float(value)
                except (TypeError, ValueError):
                    continue
    return out


class TelemetryHistory:
    """Bounded time-series ring over registry snapshots. `sample()` at
    most once per ``resolution_s`` (extra calls are no-ops, so a console
    refreshing at 2 Hz against a 1 s resolution keeps a 1 s grid);
    ``capacity`` bounds retention — a long-lived serving process holds
    `capacity * resolution_s` seconds of history and not a byte more."""

    def __init__(self, capacity: int = 240, resolution_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 2:
            raise ValueError("history capacity must be >= 2")
        self.capacity = int(capacity)
        self.resolution_s = float(resolution_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: list = []  # guarded-by: _lock
        self._last_ts: Optional[float] = None  # guarded-by: _lock

    def sample(self, registry=None, extra: Optional[dict] = None) -> bool:
        """Append one (ts, values) point: the registry's flattened
        scalar series plus ``extra`` (derived values the caller already
        computed — a latency summary, a qps). -> whether a point was
        recorded (False inside the resolution window)."""
        now = self._clock()
        with self._lock:
            if (self._last_ts is not None
                    and now - self._last_ts < self.resolution_s):
                return False
            self._last_ts = now
        values: dict = {}
        if registry is not None:
            snap = (registry.snapshot()
                    if hasattr(registry, "snapshot") else registry)
            values.update(scalar_series(snap))
        if extra:
            for k, v in extra.items():
                if v is None:
                    continue
                try:
                    values[k] = float(v)
                except (TypeError, ValueError):
                    continue
        with self._lock:
            self._ring.append((now, values))
            while len(self._ring) > self.capacity:
                self._ring.pop(0)
        return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def series(self, name: str) -> list:
        """[(ts, value), ...] for points where ``name`` was present."""
        with self._lock:
            ring = list(self._ring)
        return [(ts, vals[name]) for ts, vals in ring if name in vals]

    def latest(self, name: str):
        s = self.series(name)
        return s[-1][1] if s else None

    def rate(self, name: str):
        """Per-second rate over the last two points holding ``name``
        (counter delta / dt; None with <2 points or a reset)."""
        s = self.series(name)
        if len(s) < 2:
            return None
        (t0, v0), (t1, v1) = s[-2], s[-1]
        if t1 <= t0 or v1 < v0:
            return None
        return (v1 - v0) / (t1 - t0)

    def rate_series(self, name: str) -> list:
        """[(ts, per-second delta), ...] across consecutive points
        (negative deltas — counter resets — drop)."""
        s = self.series(name)
        out = []
        for (t0, v0), (t1, v1) in zip(s, s[1:]):
            if t1 > t0 and v1 >= v0:
                out.append((t1, (v1 - v0) / (t1 - t0)))
        return out

    def sparkline(self, name: str, width: int = 24,
                  as_rate: bool = False) -> str:
        s = self.rate_series(name) if as_rate else self.series(name)
        return sparkline([v for _ts, v in s[-width:]])


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values, width: Optional[int] = None) -> str:
    """Unicode block sparkline of ``values`` (empty string for no
    data; a flat series renders as its low block)."""
    vals = [float(v) for v in values]
    if width is not None:
        vals = vals[-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_BLOCKS[0] * len(vals)
    return "".join(
        _SPARK_BLOCKS[min(
            int((v - lo) / span * (len(_SPARK_BLOCKS) - 1) + 0.5),
            len(_SPARK_BLOCKS) - 1,
        )]
        for v in vals
    )


class SloTracker:
    """Rolling SLO attainment + error-budget burn over the last
    ``window`` completed queries. Targets are passed per `snapshot()`
    call (the serving tier reads `SET distributed.slo_p99_ms` /
    `slo_error_rate` live — a SET applies to the next read, like every
    other serving knob)."""

    def __init__(self, window: int = 512):
        if window < 1:
            raise ValueError("slo window must be >= 1")
        self.window = int(window)
        self._lock = threading.Lock()
        self._ring: list = []  # guarded-by: _lock  (wall_s, ok) pairs
        self._total = 0  # guarded-by: _lock
        self._total_errors = 0  # guarded-by: _lock

    def record(self, wall_s: Optional[float], ok: bool = True) -> None:
        """One resolved query: its admission->completion wall (None for
        a query that failed before running) and whether it succeeded."""
        with self._lock:
            self._ring.append(
                (float(wall_s) if wall_s is not None else None, bool(ok))
            )
            while len(self._ring) > self.window:
                self._ring.pop(0)
            self._total += 1
            if not ok:
                self._total_errors += 1

    def snapshot(self, p99_target_ms=None,
                 error_rate_target=None) -> dict:
        """{"window_n", "p99_ms", "error_rate", and per configured
        target: "p99_target_ms", "latency_attainment" (fraction of the
        window's successful queries at or under target), "p99_ok",
        "error_rate_target", "error_budget_burn" (error_rate / target:
        1.0 = burning exactly the budget, >1 = burning faster)}."""
        with self._lock:
            ring = list(self._ring)
            total, total_errors = self._total, self._total_errors
        walls = sorted(w for w, ok in ring if ok and w is not None)
        n = len(ring)
        errors = sum(1 for _w, ok in ring if not ok)
        out: dict = {
            "window_n": n,
            "total": total,
            "total_errors": total_errors,
            "error_rate": (errors / n) if n else None,
            "p99_ms": None,
            "p50_ms": None,
        }
        if walls:
            out["p99_ms"] = _exact_pct(walls, 0.99) * 1e3
            out["p50_ms"] = _exact_pct(walls, 0.50) * 1e3
        if p99_target_ms is not None:
            try:
                target = float(p99_target_ms)
            except (TypeError, ValueError):
                target = None
            if target and target > 0:
                out["p99_target_ms"] = target
                if walls:
                    out["latency_attainment"] = sum(
                        1 for w in walls if w * 1e3 <= target
                    ) / len(walls)
                    out["p99_ok"] = bool(out["p99_ms"] <= target)
        if error_rate_target is not None:
            try:
                et = float(error_rate_target)
            except (TypeError, ValueError):
                et = None
            if et is not None and et >= 0 and n:
                out["error_rate_target"] = et
                if et > 0:
                    out["error_budget_burn"] = (errors / n) / et
                else:
                    # a zero-error budget: any error is an infinite burn
                    out["error_budget_burn"] = (
                        math.inf if errors else 0.0
                    )
        return out

    def telemetry_families(self, p99_target_ms=None,
                           error_rate_target=None) -> list:
        s = self.snapshot(p99_target_ms=p99_target_ms,
                          error_rate_target=error_rate_target)
        fams = [
            family("dftpu_slo_window_queries", "gauge",
                   "Completed queries in the rolling SLO window.",
                   [({}, s["window_n"])]),
        ]
        for key, metric, help_text in (
            ("latency_attainment", "dftpu_slo_latency_attainment",
             "Fraction of windowed queries at or under the p99 target."),
            ("error_budget_burn", "dftpu_slo_error_budget_burn",
             "Windowed error rate over the error-rate target "
             "(>1 = burning budget)."),
            ("p99_ms", "dftpu_slo_p99_ms",
             "Rolling p99 latency over the SLO window (milliseconds)."),
        ):
            if s.get(key) is not None and s[key] != math.inf:
                fams.append(family(metric, "gauge", help_text,
                                   [({}, s[key])]))
        return fams


def _exact_pct(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    idx = max(0, min(len(sorted_vals) - 1,
                     int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


#: process-wide default registry — the sink for components not owned by
#: a Worker or ServingSession (standalone coordinators bind their fault
#: counters here when no explicit registry is wired)
DEFAULT_REGISTRY = MetricRegistry()
