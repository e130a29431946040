"""Terminal cluster monitor — the reference `console/` (ratatui TUI) analogue.

Discovers the cluster from a seed worker via the observability service and
redraws worker + task state at a fixed poll interval
(`console/src/main.rs:14-47` polls GetClusterWorkers once and
GetTaskProgress every 100 ms). Pure ANSI — no curses dependency — so it
runs over any ssh/tmux session next to the bench.

Usage:
    python -m datafusion_distributed_tpu_torch.console grpc://host:port [...]
or programmatically against any resolver/channels pair:
    Console(resolver, channels).run()

Port of the reference `console.py`, over the port's `ObservabilityService`:
the same sections, in the same order, from the same fields. The workers'
stores hold their tables on the card, so the data-plane line reports device
bytes there.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from datafusion_distributed_tpu_torch.runtime.observability import (
    ObservabilityService,
    sample_system_metrics,
)

_CLEAR = "\x1b[2J\x1b[H"
_BOLD = "\x1b[1m"
_DIM = "\x1b[2m"
_RESET = "\x1b[0m"


# one byte formatter for the whole observability surface (panel +
# trace profile report) — defined in runtime/tracing.py
from datafusion_distributed_tpu_torch.runtime.tracing import (  # noqa: E402
    format_bytes as _fmt_bytes,
)


class Console:
    def __init__(self, resolver, channels, poll_s: float = 0.5,
                 out=None, health=None, serving=None, faults=None,
                 checkpoints=None, telemetry=None):
        # ``health``: a coordinator's HealthTracker — wiring it in joins
        # circuit-breaker state into the membership rows below.
        # ``serving``: a runtime/serving.py ServingSession — wiring it in
        # adds the multi-query tier's active/queued/admitted line.
        # ``faults``/``checkpoints``: a coordinator's FaultCounters and a
        # runtime/checkpoint.py CheckpointStore — wiring either adds the
        # robustness line (hedge + checkpoint/resume counters).
        # ``telemetry``: a runtime/telemetry.py MetricRegistry merged
        # into the cluster metrics surface (defaults to the serving
        # session's registry when one is wired)
        self.obs = ObservabilityService(resolver, channels, health=health,
                                        serving=serving,
                                        fault_counters=faults,
                                        checkpoints=checkpoints,
                                        telemetry=telemetry)
        self.poll_s = poll_s
        self.out = out or sys.stdout
        self.tracked_keys: list = []  # TaskKeys to poll progress for
        # time-series ring feeding the sparkline columns: a wired
        # serving session SHARES its ring (its per-query samples and
        # this console's per-frame samples land in one history — the
        # session's registry series and the frame-derived qps/p99/
        # staged/fault values merge per point); standalone consoles
        # keep a local ring sampled once per rendered frame
        from datafusion_distributed_tpu_torch.runtime.telemetry import (
            TelemetryHistory,
        )

        shared = getattr(serving, "history", None)
        # explicit None test: an EMPTY shared ring is len()-falsy but
        # still the ring to share
        self.history = shared if shared is not None else (
            TelemetryHistory(capacity=240, resolution_s=max(poll_s, 0.1))
        )

    def track(self, keys) -> None:
        self.tracked_keys = list(keys)

    @staticmethod
    def _section(lines: list, label: str, fn) -> None:
        """Degrade PER LINE: a failing store/worker/panel renders a dim
        error line instead of aborting the whole refresh loop (the
        console must stay useful exactly when parts of the cluster are
        broken)."""
        try:
            fn()
        except Exception as e:
            lines.append(
                f"{_DIM}{label} unavailable: "
                f"{str(e)[:60] or type(e).__name__}{_RESET}"
            )

    def render_frame(self) -> str:
        """One frame of the display (separated from run() for testing).
        Every panel degrades independently (`_section`): an empty or
        partially broken store renders its line as unavailable and the
        remaining panels still draw."""
        lines = []
        lines.append(
            f"{_BOLD}datafusion-distributed-tpu cluster console{_RESET}  "
            f"{_DIM}{time.strftime('%H:%M:%S')}{_RESET}"
        )
        shared: dict = {}
        self._section(lines, "workers",
                      lambda: self._render_workers(lines, shared))
        self._section(lines, "serving",
                      lambda: self._render_serving(lines, shared))
        self._section(lines, "robustness",
                      lambda: self._render_robustness(lines))
        self._section(lines, "result cache",
                      lambda: self._render_result_cache(lines, shared))
        self._section(lines, "data plane",
                      lambda: self._render_data_plane(lines, shared))
        self._section(lines, "telemetry",
                      lambda: self._render_telemetry(lines, shared))
        self._section(lines, "tracing",
                      lambda: self._render_tracing(lines))
        self._section(lines, "tasks",
                      lambda: self._render_tasks(lines))
        sm = sample_system_metrics()
        lines.append(
            f"\n{_DIM}console rss={_fmt_bytes(sm.rss_bytes)} "
            f"cpu={sm.cpu_seconds:.1f}s{_RESET}"
        )
        return "\n".join(lines)

    def _render_workers(self, lines: list, shared: dict) -> None:
        workers = self.obs.get_cluster_workers()
        shared["workers"] = workers
        mem = self.obs.get_membership()
        health = {
            w["url"]: w.get("health", {})
            for w in mem.get("workers", ())
        }
        draining = list(mem.get("draining", ()))
        head = f"\n{_BOLD}workers ({len(workers)} active"
        if draining:
            head += f", {len(draining)} draining"
        head += f"){_RESET}"
        if mem.get("epoch") is not None:
            head += f"  {_DIM}membership epoch {mem['epoch']}{_RESET}"
        lines.append(head)
        lines.append(
            f"  {'url':<28} {'tasks':>5} {'ver':>7} {'status':>10}"
        )
        for w in workers:
            if "error" in w:
                lines.append(
                    f"  {w.get('url', '?'):<28} {'-':>5} {'-':>7} "
                    f"{'DOWN':>10}  {_DIM}{w['error'][:40]}{_RESET}"
                )
                continue
            url = w.get("url", "?")
            breaker = health.get(url, {}).get("state")
            status = breaker if breaker and breaker != "closed" else "up"
            lines.append(
                f"  {url:<28} "
                f"{w.get('tasks_cached', 0):>5} "
                f"{w.get('version', '-'):>7} "
                f"{status:>10}"
            )
        for url in draining:
            try:
                info = self.obs.channels.get_worker(url).get_info()
                tasks = info.get("tasks_cached", 0)
                ver = info.get("version", "-")
            except Exception:
                tasks, ver = "-", "-"
            lines.append(
                f"  {url:<28} {tasks:>5} {ver:>7} {'draining':>10}"
            )
        # data-plane staged-byte totals from the worker infos ALREADY
        # fetched above (get_info carries "store"): no second get_info
        # fan-out per refresh (ObservabilityService.get_data_plane is the
        # standalone programmatic surface for the same numbers)
        dp = {"nbytes": 0, "entries": 0, "views": 0, "peak_nbytes": 0,
              "dedup_hits": 0, "budget_bytes": 0, "spilled_nbytes": 0,
              "spills": 0, "refaults": 0, "spill_files": 0}
        for w in workers:
            st = w.get("store")
            if isinstance(st, dict):
                for k in dp:
                    dp[k] += int(st.get(k, 0))
        shared["dp"] = dp

    def _render_serving(self, lines: list, shared: dict) -> None:
        dp = shared.get("dp", {})
        srv = self.obs.get_serving_stats()
        shared["srv"] = srv
        if srv and "error" not in srv:
            comp = srv.get("completed", {})
            lat = srv.get("latency", {}) or {}
            p99 = lat.get("p99")
            line = (
                f"\n{_BOLD}serving{_RESET}  "
                f"{srv.get('active', 0)} active, "
                f"{srv.get('queued', 0)} queued, "
                f"{srv.get('admitted_total', 0)} admitted "
                f"({comp.get('done', 0)} done, "
                f"{comp.get('failed', 0)} failed, "
                f"{comp.get('cancelled', 0)} cancelled)"
            )
            budget = srv.get("budget_bytes") or 0
            if budget:
                # admission ESTIMATE next to the ACTUAL staged bytes from
                # the workers' TableStore accounting (get_data_plane)
                line += (
                    f"  {_DIM}footprint "
                    f"{_fmt_bytes(srv.get('in_use_bytes', 0))}/"
                    f"{_fmt_bytes(budget)} est, "
                    f"{_fmt_bytes(dp.get('nbytes', 0))} staged{_RESET}"
                )
            if p99 is not None:
                line += f"  {_DIM}p99 {p99 * 1e3:.0f}ms{_RESET}"
            lines.append(line)
            # SLO line (runtime/telemetry.py SloTracker via serving
            # stats): only rendered once a target is declared
            slo = srv.get("slo") or {}
            if slo.get("p99_target_ms") is not None or (
                slo.get("error_rate_target") is not None
            ):
                segments = []
                att = slo.get("latency_attainment")
                if slo.get("p99_target_ms") is not None:
                    ok = slo.get("p99_ok")
                    # ok is None while the window is empty (idle tier):
                    # that is "no data", not a breach
                    verdict = ("no data" if ok is None
                               else "OK" if ok else "BREACH")
                    seg = (
                        f"p99 {slo.get('p99_ms') or 0:.0f}ms vs "
                        f"{slo['p99_target_ms']:.0f}ms target "
                        f"[{verdict}]"
                    )
                    if att is not None:
                        seg += f", attainment {att * 100:.1f}%"
                    segments.append(seg)
                burn = slo.get("error_budget_burn")
                if burn is not None:
                    segments.append(f"error-budget burn {burn:.2f}x")
                lines.append(
                    f"{_BOLD}slo{_RESET}      " + ", ".join(segments)
                    + f"  {_DIM}window {slo.get('window_n', 0)}q{_RESET}"
                )

    def _render_robustness(self, lines: list) -> None:
        rb = self.obs.get_robustness()
        hed = rb.get("hedging", {})
        ckpt = rb.get("checkpoint", {})
        ck_counts = {k: v for k, v in ckpt.items() if k != "store"}
        if any(hed.values()) or any(ck_counts.values()):
            line = (
                f"\n{_BOLD}robustness{_RESET}  hedges "
                f"{hed.get('hedges_issued', 0)} issued "
                f"({hed.get('hedges_won', 0)} won, "
                f"{hed.get('hedges_lost', 0)} lost, "
                f"{hed.get('hedge_budget_denied', 0)} denied), "
                f"checkpoints {ckpt.get('checkpoint_stages_saved', 0)} "
                f"saved / {ckpt.get('checkpoint_stages_restored', 0)} "
                f"restored, {ckpt.get('queries_resumed', 0)} resumed"
            )
            st = ckpt.get("store")
            if isinstance(st, dict) and not st.get("error"):
                line += (
                    f"  {_DIM}{st.get('recoverable', 0)} recoverable, "
                    f"{_fmt_bytes(st.get('staged_bytes', 0))} "
                    f"staged{_RESET}"
                )
            lines.append(line)

    def _render_result_cache(self, lines: list, shared: dict) -> None:
        """Result/sub-plan cache line: hit/miss totals with a hit-rate
        sparkline (fed through the telemetry sample below — the ring
        records at most one point per frame), live bytes vs budget, and
        spill/invalidation counters. Quiet (no line) until the cache
        sees traffic, like the robustness panel."""
        rcs = self.obs.get_result_cache()
        cache = rcs.get("cache") or {}
        shared["rc"] = cache
        if cache.get("error") or not (
                cache.get("hits") or cache.get("misses")
                or cache.get("entries")):
            return
        rate = cache.get("hit_rate")
        line = (
            f"\n{_BOLD}result cache{_RESET}  "
            f"{cache.get('hits', 0)} hits / "
            f"{cache.get('misses', 0)} misses"
        )
        spark = self.history.sparkline("rc_hit_rate")
        if spark:
            line += f"  hit-rate {spark}"
        if rate is not None:
            line += f" {rate * 100:.0f}%"
        line += (
            f"  {_fmt_bytes(cache.get('nbytes', 0))} in "
            f"{cache.get('entries', 0)}+{cache.get('subplan_entries', 0)} "
            f"entries"
        )
        extras = []
        if cache.get("budget_bytes"):
            extras.append(f"budget {_fmt_bytes(cache['budget_bytes'])}")
        if cache.get("spills"):
            extras.append(
                f"spilled {_fmt_bytes(cache.get('spilled_nbytes', 0))} "
                f"({cache.get('refaults', 0)} refaults)"
            )
        if cache.get("invalidations"):
            extras.append(f"{cache['invalidations']} invalidations")
        sp = rcs.get("subplan", {})
        if sp.get("stages_restored"):
            extras.append(f"{sp['stages_restored']} stages restored")
        if extras:
            line += f"  {_DIM}" + ", ".join(extras) + _RESET
        lines.append(line)

    def _render_data_plane(self, lines: list, shared: dict) -> None:
        dp = shared.get("dp", {})
        if dp.get("entries") or dp.get("peak_nbytes"):
            lines.append(
                f"\n{_BOLD}data plane{_RESET}  staged "
                f"{_fmt_bytes(dp.get('nbytes', 0))} in "
                f"{dp.get('entries', 0)} entries "
                f"({dp.get('views', 0)} views, "
                f"{dp.get('dedup_hits', 0)} dedup)  "
                f"{_DIM}peak {_fmt_bytes(dp.get('peak_nbytes', 0))}{_RESET}"
            )
        # enforced-budget line only once a budget or spill activity
        # exists (a quiet unbudgeted tier adds no noise)
        if dp.get("budget_bytes") or dp.get("spills"):
            lines.append(
                f"{_BOLD}memory{_RESET}     budget "
                f"{_fmt_bytes(dp.get('budget_bytes', 0))}  spilled "
                f"{_fmt_bytes(dp.get('spilled_nbytes', 0))} in "
                f"{dp.get('spill_files', 0)} files  "
                f"{_DIM}{dp.get('spills', 0)} spills / "
                f"{dp.get('refaults', 0)} refaults{_RESET}"
            )

    def _render_telemetry(self, lines: list, shared: dict) -> None:
        """Sparkline columns over the console-local history ring: qps
        and fault rate as counter RATES, p99 and staged bytes as point
        values — the at-a-glance trend row the flat counters above
        cannot show."""
        srv = shared.get("srv") or {}
        dp = shared.get("dp", {})
        comp = srv.get("completed", {}) or {}
        lat = srv.get("latency", {}) or {}
        faults = self.obs.get_fault_counters()
        self.history.sample(None, extra={
            "queries_done": sum(comp.values()) if comp else None,
            "p99_ms": (lat.get("p99") * 1e3
                       if lat.get("p99") is not None else None),
            "staged_bytes": dp.get("nbytes"),
            "faults": sum(faults.values()) if faults else 0,
            "rc_hit_rate": (shared.get("rc") or {}).get("hit_rate"),
        })
        if len(self.history) < 2:
            return  # nothing to trend yet (first frame / empty tier)
        cols = []
        qps = self.history.rate("queries_done")
        spark = self.history.sparkline("queries_done", as_rate=True)
        if spark:
            cols.append(f"qps {spark} {qps if qps is not None else 0:.2f}/s")
        spark = self.history.sparkline("p99_ms")
        if spark:
            cols.append(
                f"p99 {spark} {self.history.latest('p99_ms'):.0f}ms"
            )
        spark = self.history.sparkline("staged_bytes")
        if spark:
            cols.append(
                "staged "
                f"{spark} {_fmt_bytes(self.history.latest('staged_bytes'))}"
            )
        spark = self.history.sparkline("faults", as_rate=True)
        if spark:
            fr = self.history.rate("faults")
            cols.append(f"faults {spark} {fr if fr is not None else 0:.2f}/s")
        if cols:
            lines.append(
                f"\n{_BOLD}telemetry{_RESET}  " + "  ".join(cols)
            )

    def _render_tracing(self, lines: list) -> None:
        ts = self.obs.get_trace_summary()
        if ts and not ts.get("error") and ts.get("traces"):
            line = (
                f"\n{_BOLD}tracing{_RESET}  "
                f"{ts['traces']} traces ({ts.get('running', 0)} running), "
                f"{ts.get('spans', 0)} spans, "
                f"{ts.get('events', 0)} events, "
                f"data plane {_fmt_bytes(ts.get('data_plane_bytes', 0))}"
            )
            if ts.get("spans_dropped"):
                line += f"  {_DIM}{ts['spans_dropped']} dropped{_RESET}"
            ev = ts.get("events_by_name") or {}
            faults = {k: v for k, v in ev.items()
                      if k in ("task_retry", "task_rerouted", "peer_heal",
                               "worker_quarantined", "query_cancel",
                               "hedge_issued", "hedge_won", "hedge_lost",
                               "checkpoint_saved", "query_resumed")}
            if faults:
                line += "  " + _DIM + ", ".join(
                    f"{k}={faults[k]}" for k in sorted(faults)
                ) + _RESET
            lines.append(line)

    def _render_tasks(self, lines: list) -> None:
        if self.tracked_keys:
            prog = self.obs.get_task_progress(self.tracked_keys)
            lines.append(f"\n{_BOLD}tasks ({len(prog)}){_RESET}")
            for key, p in prog.items():
                lines.append(
                    f"  {key}  rows={p.get('output_rows', '?')} "
                    f"worker={p.get('worker', '?')}"
                )

    def run(self, frames: Optional[int] = None) -> None:
        """Redraw loop; frames=None runs until interrupted."""
        count = 0
        try:
            while frames is None or count < frames:
                self.out.write(_CLEAR + self.render_frame() + "\n")
                self.out.flush()
                count += 1
                if frames is None or count < frames:
                    time.sleep(self.poll_s)
        except KeyboardInterrupt:
            pass


def main(argv: Optional[list] = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        raise SystemExit(2)

    class _StaticResolver:
        def __init__(self, urls):
            self.urls = urls

        def get_urls(self):
            return self.urls

    class _GrpcChannels:
        def __init__(self):
            self._clients: dict = {}

        def get_worker(self, url):
            from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
                GrpcWorkerClient,
            )

            if url not in self._clients:
                self._clients[url] = GrpcWorkerClient(url)
            return self._clients[url]

    Console(_StaticResolver(argv), _GrpcChannels()).run()


if __name__ == "__main__":
    main()
