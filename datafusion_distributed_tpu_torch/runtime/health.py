"""Worker health tracking: consecutive-failure circuit breaker with
half-open recovery probes.

The reference schedules around unreachable workers at the connection-pool
layer (`worker_connection_pool.rs` marks broken channels); scheduling-aware
systems treat tolerating slow/failing participants as a first-class
scheduler concern (Chasing Similarity, arXiv:1810.00511). Here the
coordinator's router consults this tracker on every dispatch: a worker that
keeps failing is QUARANTINED (circuit open) so tasks flow to healthy peers;
after a cool-down the circuit goes HALF-OPEN and the next dispatch acts as a
recovery probe — success closes the circuit, another failure re-opens it
with an escalated cool-down.

Deliberately transport-agnostic and clock-injectable (deterministic tests).
Thread-safe: stage fan-out records failures from concurrent task threads.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclass
class HealthPolicy:
    #: consecutive failures that trip the breaker (quarantine the worker)
    failure_threshold: int = 3
    #: first quarantine duration; escalates by ``backoff_factor`` per
    #: consecutive trip (a worker that fails its recovery probe waits longer)
    quarantine_seconds: float = 30.0
    backoff_factor: float = 2.0
    max_quarantine_seconds: float = 300.0


@dataclass
class _WorkerState:
    state: str = CLOSED
    consecutive_failures: int = 0
    #: consecutive breaker trips (resets on a successful probe)
    trips: int = 0
    open_until: float = 0.0
    #: half-open: when the outstanding probe's admission expires — until
    #: then further dispatches are refused (ONE probe, not a stampede)
    probe_until: float = 0.0
    total_failures: int = 0
    total_successes: int = 0
    #: hedge losses (speculative peer finished first) — observability
    #: only, NEVER breaker input: slow is not broken
    hedge_losses: int = 0


class HealthTracker:
    """Per-worker circuit breakers keyed by url."""

    def __init__(self, policy: Optional[HealthPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or HealthPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self._workers: dict[str, _WorkerState] = {}  # guarded-by: _lock

    def _state_locked(self, url: str) -> _WorkerState:
        # DFTPU201 fix (naming): caller holds `_lock` — the *_locked
        # suffix is the convention the concurrency lint enforces for
        # helpers that mutate guarded state on the caller's lock
        s = self._workers.get(url)
        if s is None:
            s = self._workers[url] = _WorkerState()
        return s

    def record_success(self, url: str) -> None:
        with self._lock:
            s = self._state_locked(url)
            s.total_successes += 1
            s.consecutive_failures = 0
            s.trips = 0
            s.state = CLOSED

    def record_hedge_loss(self, url: str) -> None:
        """The worker lost a hedge race (its attempt was outpaced by a
        speculative re-dispatch). Distinct from `record_failure` by
        design: a hedge loss NEVER advances `consecutive_failures` or
        trips the breaker — a slow-but-correct worker must stay routable
        (hedging exists to route around it per task), and quarantining
        on slowness would amplify one straggler into lost capacity."""
        with self._lock:
            s = self._state_locked(url)
            s.hedge_losses += 1

    def record_failure(self, url: str) -> bool:
        """-> True when this failure TRIPPED the breaker (closed/half-open ->
        open); the caller counts quarantine events off that edge."""
        with self._lock:
            s = self._state_locked(url)
            s.total_failures += 1
            s.consecutive_failures += 1
            if s.state == HALF_OPEN:
                # failed recovery probe: straight back to open, longer
                tripped = self._open(s)
                return tripped
            if (
                s.state == CLOSED
                and s.consecutive_failures >= self.policy.failure_threshold
            ):
                return self._open(s)
            return False

    def _open(self, s: _WorkerState) -> bool:
        s.trips += 1
        dur = min(
            self.policy.quarantine_seconds
            * (self.policy.backoff_factor ** (s.trips - 1)),
            self.policy.max_quarantine_seconds,
        )
        s.state = OPEN
        s.open_until = self._clock() + dur
        return True

    def is_available(self, url: str) -> bool:
        """Whether the router may send work to ``url`` now. An expired
        quarantine flips the breaker to half-open and admits the dispatch
        as the recovery probe — ONE probe at a time: while the probe is
        outstanding further dispatches are refused, so a stage fan-out
        landing right after expiry cannot stampede a still-dead worker.
        A probe that never resolves (its task died without a recorded
        outcome) re-admits after another quarantine period."""
        with self._lock:
            s = self._workers.get(url)
            if s is None or s.state == CLOSED:
                return True
            now = self._clock()
            if s.state == OPEN:
                if now >= s.open_until:
                    s.state = HALF_OPEN
                    s.probe_until = now + self.policy.quarantine_seconds
                    return True
                return False
            # HALF_OPEN: the admitted probe is still in flight
            if now >= s.probe_until:
                s.probe_until = now + self.policy.quarantine_seconds
                return True
            return False

    def route_filter(self, urls) -> list[str]:
        """Candidate urls for ONE dispatch. Unlike `healthy`, a probe
        admission PINS the dispatch to the probing worker (returns only
        it): admitting a probe from a candidate listing and then routing
        the task elsewhere would consume the probe slot without ever
        resolving it, leaving a recovered worker routed-around for extra
        quarantine periods."""
        with self._lock:
            now = self._clock()
            avail = []
            for u in urls:
                s = self._workers.get(u)
                if s is None or s.state == CLOSED:
                    avail.append(u)
                    continue
                if s.state == OPEN and now >= s.open_until:
                    s.state = HALF_OPEN
                    s.probe_until = now + self.policy.quarantine_seconds
                    return [u]  # this dispatch IS the recovery probe
                if s.state == HALF_OPEN and now >= s.probe_until:
                    # the admitted probe never resolved: re-admit one
                    s.probe_until = now + self.policy.quarantine_seconds
                    return [u]
            return avail

    def forget(self, url: str) -> bool:
        """Drop all breaker state for ``url`` (the worker left the
        membership — quarantine/backoff state for a nonexistent endpoint
        is dead weight, and a rejoining worker under the same url starts
        with a clean slate). -> whether state existed."""
        with self._lock:
            return self._workers.pop(url, None) is not None

    def prune(self, live_urls) -> list[str]:
        """Forget every tracked worker NOT in ``live_urls`` — called by the
        coordinator on membership change so the per-worker maps track the
        cluster instead of growing monotonically across churn. -> the urls
        dropped."""
        live = set(live_urls)
        with self._lock:
            dead = [u for u in self._workers if u not in live]
            for u in dead:
                del self._workers[u]
            return dead

    def state_of(self, url: str) -> str:
        with self._lock:
            s = self._workers.get(url)
            return CLOSED if s is None else s.state

    def telemetry_families(self) -> list:
        """Typed-registry adapter (runtime/telemetry.py): worker counts
        by breaker state plus per-worker success/failure/hedge-loss
        totals (labeled by url — bounded by cluster size, and pruned
        with the membership like the breaker state itself)."""
        from datafusion_distributed_tpu_torch.runtime.telemetry import family

        snap = self.snapshot()
        by_state = {CLOSED: 0, OPEN: 0, HALF_OPEN: 0}
        for s in snap.values():
            by_state[s["state"]] = by_state.get(s["state"], 0) + 1
        fams = [family(
            "dftpu_health_workers", "gauge",
            "Tracked workers by circuit-breaker state.",
            [({"state": k}, v) for k, v in sorted(by_state.items())],
        )]
        for key, metric, help_text in (
            ("total_successes", "dftpu_health_successes",
             "Successful dispatch outcomes per worker."),
            ("total_failures", "dftpu_health_failures",
             "Failed dispatch outcomes per worker."),
            ("hedge_losses", "dftpu_health_hedge_losses",
             "Hedge races lost per worker (never breaker input)."),
        ):
            samples = [
                ({"url": url}, s[key]) for url, s in sorted(snap.items())
            ]
            if samples:
                fams.append(family(metric, "counter", help_text, samples))
        return fams

    def snapshot(self) -> dict:
        """url -> breaker state, for observability surfaces."""
        with self._lock:
            now = self._clock()
            return {
                url: {
                    "state": s.state,
                    "consecutive_failures": s.consecutive_failures,
                    "trips": s.trips,
                    "open_for_s": max(s.open_until - now, 0.0)
                    if s.state == OPEN else 0.0,
                    "total_failures": s.total_failures,
                    "total_successes": s.total_successes,
                    "hedge_losses": s.hedge_losses,
                }
                for url, s in self._workers.items()
            }
