"""Observability service: cluster discovery, task progress, system metrics.

The reference runs a separate gRPC ObservabilityService with `Ping`,
`GetTaskProgress` (per-task partition completion + output rows) and
`GetClusterWorkers`, plus optional 100 ms RSS/CPU sampling
(`src/observability/service.rs`). Host-runtime equivalent over the
in-process worker objects; system metrics read /proc directly (no
sysinfo dependency).

Port of the reference `runtime/observability.py`. The workers' stores
hold their tables on the session's device, so `get_data_plane()` reports
device bytes on the card.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SystemMetrics:
    """Frozen: the sampler thread publishes a new snapshot per tick via a
    single reference assignment (GIL-atomic), so readers can never observe
    a half-updated sample — mutation is a bug by construction."""

    rss_bytes: int = 0
    cpu_seconds: float = 0.0
    sampled_at: float = 0.0


def sample_system_metrics() -> SystemMetrics:
    rss = 0
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        rss = pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    cpu = 0.0
    try:
        cpu = sum(os.times()[:2])
    except OSError:
        pass
    return SystemMetrics(rss_bytes=rss, cpu_seconds=cpu, sampled_at=time.time())


class SystemMetricsSampler:
    """Background sampler (the reference samples every 100 ms under the
    `system-metrics` feature).

    Thread-safety contract: ``latest`` always holds a FROZEN
    SystemMetrics snapshot, replaced wholesale by the sampler thread —
    a single reference assignment is atomic under the GIL, so readers on
    any thread see either the previous complete sample or the next one,
    never a torn mix. Assertion-backed: the snapshot type is frozen, so
    an accidental in-place mutation raises instead of racing."""

    def __init__(self, interval_s: float = 0.1):
        self.interval = interval_s
        self.latest = sample_system_metrics()
        assert type(self.latest).__dataclass_params__.frozen, (
            "SystemMetrics must stay frozen: the cross-thread handoff "
            "relies on immutable snapshots + atomic reference swap"
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SystemMetricsSampler":
        def loop():
            while not self._stop.wait(self.interval):
                # publish: one atomic reference swap of a frozen snapshot
                self.latest = sample_system_metrics()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent: stop() on a never-started or already-stopped
        sampler is a no-op; concurrent/repeated calls join at most once."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=1.0)


class ObservabilityService:
    """Ping / GetTaskProgress / GetClusterWorkers over a worker cluster.

    ``health``/``fault_counters`` (optional): the coordinator's
    `HealthTracker` and `FaultCounters` — wiring them in annotates cluster
    listings with circuit-breaker state and exposes the retry/quarantine
    counters next to the task-progress surface.

    ``serving`` (optional): a `runtime/serving.py ServingSession` — wiring
    it in exposes the multi-query tier's active/queued/admitted counts and
    latency summary through `get_serving_stats` (and the console's
    serving line)."""

    def __init__(self, resolver, channels, sample_system: bool = False,
                 health=None, fault_counters=None, serving=None,
                 trace_store=None, checkpoints=None, telemetry=None,
                 result_cache=None):
        self.resolver = resolver
        self.channels = channels
        self.health = health
        self.fault_counters = fault_counters
        self.serving = serving
        # checkpoint store (runtime/checkpoint.py) surfaced by
        # get_robustness; falls back to the wired serving session's store
        self.checkpoints = checkpoints
        # result/sub-plan cache (runtime/result_cache.py) surfaced by
        # get_result_cache; falls back to the wired serving session's
        # context cache
        self.result_cache = result_cache
        # distributed-tracing store surfaced by get_trace_summary (None =
        # the process-wide default, runtime/tracing.py)
        self.trace_store = trace_store
        # coordinator/serving-side typed metric registry
        # (runtime/telemetry.py) merged unlabeled into get_metrics();
        # falls back to the wired serving session's registry
        self.telemetry = telemetry
        self.sampler = SystemMetricsSampler().start() if sample_system else None

    def ping(self) -> dict:
        return {"ok": True, "ts": time.time()}

    def get_cluster_workers(self) -> list[dict]:
        health = self.health.snapshot() if self.health is not None else {}
        out = []
        for url in self.resolver.get_urls():
            try:
                info = self.channels.get_worker(url).get_info()
            except Exception as e:
                info = {"url": url, "error": str(e)}
            if url in health:
                info["health"] = health[url]
            out.append(info)
        return out

    def get_worker_health(self) -> dict:
        """url -> circuit-breaker state (empty without a wired tracker)."""
        return self.health.snapshot() if self.health is not None else {}

    def get_membership(self) -> dict:
        """Combined membership + health snapshot: the resolver's epoch and
        role sets (an epoch-versioned DynamicCluster exposes them via
        `membership_snapshot`; a static resolver degrades to active-only)
        with each worker's circuit-breaker state joined in — one surface
        answering both "who is in the cluster" and "who is being routed
        around"."""
        snap = getattr(self.resolver, "membership_snapshot", None)
        if callable(snap):
            base = snap()
        else:
            base = {
                "epoch": getattr(self.resolver, "membership_epoch", None),
                "active": list(self.resolver.get_urls()),
                "draining": [],
                "departed": [],
            }
        health = self.health.snapshot() if self.health is not None else {}
        workers = []
        for role in ("active", "draining"):
            for url in base.get(role, ()):
                entry = {"url": url, "role": role}
                if url in health:
                    entry["health"] = health[url]
                workers.append(entry)
        return {
            "epoch": base.get("epoch"),
            "active": list(base.get("active", ())),
            "draining": list(base.get("draining", ())),
            "departed": list(base.get("departed", ())),
            "workers": workers,
        }

    def get_fault_counters(self) -> dict:
        """Retry/quarantine/timeout counters (empty without wiring)."""
        if self.fault_counters is None:
            return {}
        return self.fault_counters.as_dict()

    def get_data_plane(self) -> dict:
        """Per-worker TableStore accounting (the zero-copy data plane's
        staged-bytes surface): ACTUAL staged bytes / entry / view counts
        and high-water marks, from each worker's `get_info()["store"]`
        (the gRPC client forwards the server's numbers). This is the
        complement to the serving tier's admission ESTIMATE — what is
        really held, not what was predicted. Degrades per worker like
        `get_cluster_workers`."""
        workers: dict = {}
        totals = {"nbytes": 0, "entries": 0, "views": 0, "peak_nbytes": 0,
                  "dedup_hits": 0, "budget_bytes": 0, "spilled_nbytes": 0,
                  "spills": 0, "refaults": 0, "spill_files": 0}
        for url in self.resolver.get_urls():
            try:
                info = self.channels.get_worker(url).get_info()
            except Exception as e:
                workers[url] = {"error": str(e)}
                continue
            stats = info.get("store")
            if not isinstance(stats, dict):
                continue
            workers[url] = stats
            for k in totals:
                totals[k] += int(stats.get(k, 0))
        return {**totals, "workers": workers}

    def get_metrics(self) -> dict:
        """Merged cluster-wide telemetry snapshot (runtime/telemetry.py):
        every worker's `get_metrics` RPC snapshot folded under a
        worker=url label, plus the coordinator/serving-side registry
        (wired directly or through the serving session) unlabeled —
        the single exposition the console, bench, and any scrape read.

        Degrades per worker like `get_data_plane`: an unreachable or
        erroring worker contributes an error entry in ``workers`` and
        the rest of the cluster still answers."""
        per_worker: dict = {}
        workers: dict = {}
        for url in self.resolver.get_urls():
            try:
                w = self.channels.get_worker(url)
                snap = w.get_metrics()
            except Exception as e:
                workers[url] = {"error": str(e)}
                continue
            if not isinstance(snap, dict):
                workers[url] = {"error": "non-dict metrics snapshot"}
                continue
            per_worker[url] = snap
            workers[url] = {"families": len(snap)}
        local = self.telemetry
        if local is None and self.serving is not None:
            local = getattr(self.serving, "telemetry", None)
        from datafusion_distributed_tpu_torch.runtime.telemetry import (
            merge_snapshots,
        )

        base = None
        if local is not None:
            try:
                base = local.snapshot()
            except Exception as e:
                workers["<local>"] = {"error": str(e)}
        else:
            # no registry wired (standalone coordinator observability):
            # expose whatever adapters ARE wired directly, so the merged
            # view still carries fault/breaker counters
            fams: list = []
            for src in (self.fault_counters, self.health):
                if src is not None:
                    try:
                        fams.extend(src.telemetry_families())
                    except Exception:
                        pass
            if fams:
                base = dict(fams)
        return {
            "metrics": merge_snapshots(base, per_worker),
            "workers": workers,
        }

    def render_openmetrics(self) -> str:
        """OpenMetrics text exposition of the merged cluster snapshot."""
        from datafusion_distributed_tpu_torch.runtime.telemetry import (
            render_openmetrics,
        )

        return render_openmetrics(self.get_metrics()["metrics"])

    def get_serving_stats(self) -> dict:
        """Multi-query serving tier counters (empty without a wired
        ServingSession): active/queued query counts, admitted totals,
        admission budget accounting, scheduler state, latency summary."""
        if self.serving is None:
            return {}
        try:
            return self.serving.stats()
        except Exception as e:
            return {"error": str(e)}

    def get_robustness(self) -> dict:
        """Straggler-hedging + query-checkpoint counters (the serving-
        hardening robustness layer): hedge issue/win/loss/deny totals and
        checkpoint save/restore/fallback totals from the wired
        FaultCounters, plus the checkpoint store's live record/byte
        accounting when one is wired (directly or through the serving
        session). Empty sub-dicts without wiring — same degradation
        contract as get_fault_counters."""
        fc = (
            self.fault_counters.as_dict()
            if self.fault_counters is not None else {}
        )
        out = {
            "hedging": {
                k: fc.get(k, 0)
                for k in ("hedges_issued", "hedges_won", "hedges_lost",
                          "hedges_abandoned", "hedge_budget_denied")
            },
            "checkpoint": {
                k: fc.get(k, 0)
                for k in ("checkpoint_stages_saved",
                          "checkpoint_stages_restored",
                          "checkpoint_fp_mismatch",
                          "checkpoint_slices_lost", "queries_resumed",
                          "queries_recovered")
            },
        }
        store = self.checkpoints
        if store is None and self.serving is not None:
            store = getattr(self.serving, "checkpoints", None)
        if store is not None:
            try:
                out["checkpoint"]["store"] = store.stats()
            except Exception as e:
                out["checkpoint"]["store"] = {"error": str(e)}
        return out

    def get_result_cache(self) -> dict:
        """Fingerprint-keyed result/sub-plan cache counters
        (runtime/result_cache.py): hit/miss/fill totals for both tiers,
        invalidation count, live bytes vs budget, and spill/refault
        accounting from the cache's backing TableStore — resolved from
        the wired cache directly or through the serving session's
        SessionContext. Sub-plan restore totals come from the wired
        FaultCounters (``subplan_cache_stages_restored``). Per-worker
        rows report each worker store's spill/refault counters (the
        layer cached frontiers bypass) and degrade like
        `get_data_plane`: an unreachable worker contributes an error
        entry and the rest still answer. Empty ``cache`` sub-dict
        without wiring — same degradation contract as get_robustness."""
        fc = (
            self.fault_counters.as_dict()
            if self.fault_counters is not None else {}
        )
        out: dict = {
            "subplan": {
                "stages_restored": fc.get("subplan_cache_stages_restored",
                                          0),
            },
            "cache": {},
        }
        rc = self.result_cache
        if rc is None and self.serving is not None:
            ctx = getattr(self.serving, "ctx", None)
            rc = getattr(ctx, "_result_cache", None)
        if rc is not None:
            try:
                out["cache"] = rc.stats()
            except Exception as e:
                out["cache"] = {"error": str(e)}
        workers: dict = {}
        for url in self.resolver.get_urls():
            try:
                info = self.channels.get_worker(url).get_info()
            except Exception as e:
                workers[url] = {"error": str(e)}
                continue
            stats = info.get("store")
            if not isinstance(stats, dict):
                continue
            workers[url] = {
                k: int(stats.get(k, 0))
                for k in ("spills", "refaults", "spilled_nbytes",
                          "spill_files")
            }
        out["workers"] = workers
        return out

    def get_task_progress(self, keys) -> dict:
        """TaskKey list -> progress dicts from whichever worker holds each.

        Degrades per worker like `get_cluster_workers`: a single erroring
        or departed worker mid-scan must not abort the whole listing —
        its probe is skipped and the remaining workers still answer (the
        key is simply absent if no surviving worker holds it)."""
        out = {}
        for key in keys:
            for url in self.resolver.get_urls():
                try:
                    p = self.channels.get_worker(url).task_progress(key)
                except Exception:
                    continue  # dead/departed worker: try the next one
                if p is not None:
                    out[key] = {**p, "worker": url}
                    break
        return out

    def get_trace_summary(self) -> dict:
        """Live aggregate counters of the distributed-tracing subsystem
        (runtime/tracing.py): traces held/running, span counts by kind,
        fault events by name, total data-plane bytes attributed. Served
        from the wired TraceStore (default: the process-wide store)."""
        from datafusion_distributed_tpu_torch.runtime.tracing import (
            DEFAULT_TRACE_STORE,
        )

        store = self.trace_store or DEFAULT_TRACE_STORE
        try:
            return store.summary()
        except Exception as e:
            return {"error": str(e)}

    def system_metrics(self) -> Optional[SystemMetrics]:
        return self.sampler.latest if self.sampler else None
