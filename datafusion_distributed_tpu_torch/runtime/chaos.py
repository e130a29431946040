"""Deterministic fault injection for the host-runtime tier.

Port of the reference `runtime/chaos.py`, with every fault kind (crash,
transport, delay, straggler, corrupt_plan, oom, skew and segment_lost) and
the membership events.

A seeded `FaultPlan` wraps a cluster's workers (`wrap_cluster` /
`ChaosWorker`) and injects faults at the coordinator-visible call sites:

  set_plan   crash-on-ship (dispatch failures); kind="corrupt_plan"
             mutates the encoded plan in transit — the worker's
             post-decode fingerprint check (plan/verify.py DFTPU043 via
             runtime/worker.py) must convert it into the classified fatal
             PlanIntegrityError instead of wrong results
  execute    crash-mid-execute / transient transport errors / slow-worker
             delays, applied uniformly to execute_task,
             execute_task_stream, execute_task_partitions and
             transfer_partitions; kind="segment_lost" (transfer-only)
             tears the next shm segment mid-stream, asserting the pull
             is retried over the wire path instead of failing the query

Membership churn (`MembershipEvent`): seeded `leave`/`join`/`drain`
events scheduled by site/stage/task like the fault kinds above, applied
to the wrapped cluster's dynamic-membership surface
(runtime/coordinator.py `DynamicCluster`) when the triggering call
arrives — a departed worker's endpoint then fails retryably, exercising
the coordinator's live re-routing and peer-producer re-ship paths.

PER-CALL decisions are DETERMINISTIC and thread-order independent: each
(site, stage, task, nth-call) tuple hashes with the seed to a unit float
compared against the spec's rate, so an uncapped schedule replays
identically under the same seed regardless of how the stage fan-out's
threads interleave. Per-stage / total caps (`max_per_stage`, `max_total`)
bound how many faults fire — `FaultSpec(site="execute", rate=1.0,
max_per_stage=1)` is the canonical "one worker crash per stage" schedule
of tests/test_fault_tolerance.py. Caveat: a cap slot is consumed in call
ARRIVAL order, so capped schedules keep their fire COUNT deterministic at
rate=1.0 but may attribute a fault to a different (task, worker) across
runs when sibling tasks race for the slot; assertions on a capped
schedule should target results/counters, not which task was hit (the
suite's determinism test uses uncapped specs for exactly this reason).

This mirrors what Zerrow (arXiv:2504.06151) treats as part of pipeline
correctness: failure paths — including buffer cleanup after a failed
attempt — are exercised on purpose, not discovered in production.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from datafusion_distributed_tpu_torch.runtime.errors import (
    TransportError,
    WorkerError,
    WorkerUnavailableError,
)

#: injection sites a FaultSpec may name
SITES = ("set_plan", "execute")


@dataclass
class FaultSpec:
    """One fault family: where, what, how often, and bounds."""

    site: str  # "set_plan" | "execute"
    #: "crash" | "transport" | "delay" | "corrupt_plan" | "straggler" |
    #: "oom". "delay" rolls per CALL (uniform injected latency);
    #: "straggler" is WORKER-PINNED: one seeded decision per (query, url)
    #: makes that worker sticky-slow for the REST of the query at every
    #: matching call — the real tail-latency pathology (one slow machine,
    #: not a uniformly slow cluster) the hedger exists to beat. Caps
    #: count straggler WORKERS elected, not delayed calls. "oom"
    #: COLLAPSES the target worker's enforced memory budget mid-query
    #: (TableStore.set_budget to ``budget_bytes``, or half its current
    #: resident bytes when unset) and delegates the call: the spill/
    #: backpressure/shedding machinery must absorb it — results stay
    #: byte-identical, zero leaked slices, zero leaked spill files.
    #: "skew" is a WORKLOAD-shaping fault, not an error: the matching
    #: task's bulk output has ``skew_fraction`` of its ``skew_column``
    #: values overwritten with the column's row-0 value, concentrating
    #: a hot key so the downstream hash shuffle lands one hot partition
    #: (the input the skew-aware splitter in runtime/adaptivity.py
    #: corrects for). Seeded and query-scoped like every other kind —
    #: replaying the same schedule reshapes the same tasks — but it
    #: CHANGES DATA by design, so A/B comparisons must run BOTH arms
    #: under the same skew schedule. Bulk execute_task only: the
    #: streaming/partition planes pass through untouched.
    kind: str = "crash"
    rate: float = 1.0  # per-call probability (seed-hashed, deterministic)
    delay_s: float = 0.0  # for kind="delay"/"straggler": injected latency
    #: for kind="oom": the collapsed budget (None = half the worker's
    #: resident staged bytes at injection time, minimum 1)
    budget_bytes: Optional[int] = None
    #: for kind="skew": the shuffle-key column to concentrate — None
    #: targets the task output's FIRST column (the planner emits the
    #: group/shuffle key first, under internal names like ``__g0`` that
    #: a spec cannot know); a NAMED column that is absent makes the fire
    #: a no-op. ``skew_fraction`` of the task's rows are overwritten
    #: with the row-0 hot value.
    skew_column: Optional[str] = None
    skew_fraction: float = 0.8
    #: restrict to these worker urls (substring match); None = any worker
    workers: Optional[Sequence[str]] = None
    #: restrict to these stage ids; None = any stage
    stages: Optional[Sequence[int]] = None
    #: restrict to these task numbers; None = any task
    tasks: Optional[Sequence[int]] = None
    #: at most this many fires per stage (None = unbounded)
    max_per_stage: Optional[int] = None
    #: at most this many fires total (None = unbounded)
    max_total: Optional[int] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r} (expected one of {SITES})"
            )

    def _matches(self, site: str, url: str, stage_id: int,
                 task_number: int) -> bool:
        if site != self.site:
            return False
        if self.workers is not None and not any(
            w in url for w in self.workers
        ):
            return False
        if self.stages is not None and stage_id not in self.stages:
            return False
        if self.tasks is not None and task_number not in self.tasks:
            return False
        return True


#: membership actions a MembershipEvent may name (runtime/coordinator.py
#: DynamicCluster surface)
MEMBERSHIP_ACTIONS = ("leave", "join", "drain")


@dataclass
class MembershipEvent:
    """One scheduled membership mutation: WHEN a call matching
    (site, stages, tasks) arrives for the ``nth_call`` time, the target
    ``url`` leaves / joins / starts draining the wrapped DynamicCluster —
    the elastic analogue of a FaultSpec, scheduled by site/stage/task like
    the existing fault kinds. Events fire exactly once. Like capped fault
    specs, the trigger slot is consumed in call ARRIVAL order, so under a
    concurrent stage fan-out the triggering (task, worker) may vary across
    runs while the EVENT SET stays deterministic — assert on results and
    membership state, not on which call pulled the trigger."""

    action: str  # "leave" | "join" | "drain"
    url: str  # the worker that leaves/joins/drains
    site: str = "execute"  # triggering call site ("set_plan" | "execute")
    #: restrict triggering calls to these stage ids; None = any stage
    stages: Optional[Sequence[int]] = None
    #: restrict triggering calls to these task numbers; None = any task
    tasks: Optional[Sequence[int]] = None
    #: fire on the nth MATCHING call (0 = the first)
    nth_call: int = 0
    #: leave only: release the departing worker's registry/store (process
    #: death); False leaks on purpose (for testing leak detection itself)
    release: bool = True

    def __post_init__(self):
        if self.action not in MEMBERSHIP_ACTIONS:
            raise ValueError(
                f"unknown membership action {self.action!r} "
                f"(expected one of {MEMBERSHIP_ACTIONS})"
            )
        if self.site not in SITES:
            raise ValueError(
                f"unknown membership trigger site {self.site!r} "
                f"(expected one of {SITES})"
            )

    def _matches(self, site: str, stage_id: int, task_number: int) -> bool:
        if site != self.site:
            return False
        if self.stages is not None and stage_id not in self.stages:
            return False
        if self.tasks is not None and task_number not in self.tasks:
            return False
        return True


class FaultPlan:
    """Seeded, thread-safe fault schedule shared by a cluster's
    ChaosWorkers. `fired` records every injected fault (site, url, stage,
    task, kind) — tests assert against it, and a failure report quoting it
    plus the seed reproduces the schedule. ``membership`` adds scheduled
    `leave`/`join`/`drain` events applied to the wrapped cluster's
    dynamic-membership surface at the same call sites."""

    def __init__(self, seed: int, specs: Sequence[FaultSpec],
                 membership: Sequence[MembershipEvent] = (),
                 query_scoped: bool = False):
        self.seed = int(seed)
        self.specs = list(specs)
        self.membership = list(membership)
        #: per-QUERY call counting (the multi-query serving tier): each
        #: query's (stage, task) call counts start at zero and the hash
        #: input stays query-free, so every concurrent query replays the
        #: IDENTICAL seeded fault schedule regardless of how the queries
        #: interleave — per-query chaos determinism. Off (the default),
        #: counts accumulate plan-wide across queries/attempts, the
        #: pre-serving behavior every existing schedule was written
        #: against. Caps (max_per_stage / max_total) stay plan-global in
        #: both modes: they bound total injected damage, not per-query
        #: schedules.
        self.query_scoped = bool(query_scoped)
        # forensic log of injected faults: bounded so a long-lived
        # serving process under sustained chaos (soak tests) cannot grow
        # it forever — schedules assert on far fewer than the cap
        self.fired: list[dict] = []  # guarded-by: _lock; per-query: bounded 4096
        self._lock = threading.Lock()
        #: (spec_idx, query_scope, site, stage, task) -> call count (the
        #: nth-call input of the hash, so repeated attempts of one task
        #: re-roll; query_scope is "" unless query_scoped)
        self._calls: dict[tuple, int] = {}  # guarded-by: _lock
        self._per_stage: dict[tuple, int] = {}  # guarded-by: _lock
        self._totals: dict[int, int] = {}  # guarded-by: _lock
        #: (spec_idx, query_scope, url) -> elected straggler? ONE seeded
        #: decision per key; True keeps delaying every later matching
        #: call — the sticky-slow-worker fault (kind="straggler")
        self._stragglers: dict[tuple, bool] = {}  # guarded-by: _lock
        #: event idx -> matching-call count / fired flag
        self._member_calls: dict[int, int] = {}  # guarded-by: _lock
        self._member_fired: set = set()  # guarded-by: _lock

    _FIRED_CAP = 4096

    def _note_fired_locked(self, rec: dict) -> None:
        """Record an injected fault; oldest entries roll off past the
        cap so a long-lived serving process never grows the log
        unboundedly."""
        self.fired.append(rec)
        if len(self.fired) > self._FIRED_CAP:
            del self.fired[: len(self.fired) - self._FIRED_CAP]

    def membership_due(self, site: str, url: str, key) -> list:
        """Membership events whose trigger this call just satisfied (each
        fires once); the caller applies them to the cluster."""
        if not self.membership:
            return []
        stage_id = getattr(key, "stage_id", -1)
        task_number = getattr(key, "task_number", 0)
        due = []
        with self._lock:
            for i, ev in enumerate(self.membership):
                if i in self._member_fired:
                    continue
                if not ev._matches(site, stage_id, task_number):
                    continue
                nth = self._member_calls.get(i, 0)
                self._member_calls[i] = nth + 1
                if nth != ev.nth_call:
                    continue
                self._member_fired.add(i)
                self._note_fired_locked({
                    "site": site, "url": ev.url, "stage_id": stage_id,
                    "task_number": task_number,
                    "kind": f"membership_{ev.action}", "nth_call": nth,
                    "trigger_url": url,
                })
                due.append(ev)
        return due

    def _unit(self, spec_idx: int, site: str, stage_id: int,
              task_number: int, nth: int) -> float:
        h = hashlib.sha256(
            f"{self.seed}:{spec_idx}:{site}:{stage_id}:"
            f"{task_number}:{nth}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def decide(self, site: str, url: str, key) -> Optional[FaultSpec]:
        """The fault (if any) to inject for this call. At most one spec
        fires per call (first declared wins)."""
        stage_id = getattr(key, "stage_id", -1)
        task_number = getattr(key, "task_number", 0)
        qscope = (getattr(key, "query_id", "") or "") if (
            self.query_scoped
        ) else ""
        with self._lock:
            for i, spec in enumerate(self.specs):
                if not spec._matches(site, url, stage_id, task_number):
                    continue
                if spec.kind == "straggler":
                    if self._straggler_locked(i, spec, qscope, url, site,
                                              stage_id, task_number):
                        return spec
                    continue
                ck = (i, qscope, site, stage_id, task_number)
                nth = self._calls.get(ck, 0)
                self._calls[ck] = nth + 1
                if spec.max_total is not None and (
                    self._totals.get(i, 0) >= spec.max_total
                ):
                    continue
                sk = (i, stage_id)
                if spec.max_per_stage is not None and (
                    self._per_stage.get(sk, 0) >= spec.max_per_stage
                ):
                    continue
                if self._unit(i, site, stage_id, task_number,
                              nth) >= spec.rate:
                    continue
                self._totals[i] = self._totals.get(i, 0) + 1
                self._per_stage[sk] = self._per_stage.get(sk, 0) + 1
                self._note_fired_locked({
                    "site": site, "url": url, "stage_id": stage_id,
                    "task_number": task_number, "kind": spec.kind,
                    "nth_call": nth,
                })
                return spec
        return None

    def _straggler_locked(self, i: int, spec: FaultSpec, qscope: str,
                          url: str, site: str, stage_id: int,
                          task_number: int) -> bool:
        """Sticky straggler election (caller holds `_lock`): decide ONCE
        per (spec, query-scope, url) whether this worker is slow, then
        answer every later matching call from that verdict — the rest of
        the query sees one consistently slow endpoint, not independent
        per-call coin flips. Caps bound ELECTIONS, not delayed calls."""
        sk = (i, qscope, url)
        verdict = self._stragglers.get(sk)
        if verdict is None:
            if spec.max_total is not None and (
                self._totals.get(i, 0) >= spec.max_total
            ):
                verdict = False
            else:
                h = hashlib.sha256(
                    f"{self.seed}:{i}:straggler:{qscope}:{url}".encode()
                ).digest()
                unit = int.from_bytes(h[:8], "big") / float(1 << 64)
                verdict = unit < spec.rate
            self._stragglers[sk] = verdict
            if verdict:
                self._totals[i] = self._totals.get(i, 0) + 1
                self._note_fired_locked({
                    "site": site, "url": url, "stage_id": stage_id,
                    "task_number": task_number, "kind": "straggler",
                    "nth_call": 0,
                })
        return verdict

    def sweep_query(self, query_id: str) -> int:
        """Release the per-query call-count state for a COMPLETED query
        (meaningful under ``query_scoped``: each in-flight query holds its
        own counters, and a long-lived serving process must shed them when
        the query resolves); -> entries removed. The coordinator's
        ``on_query_end`` hook is the natural caller."""
        if not query_id:
            return 0
        with self._lock:
            dead = [ck for ck in self._calls if ck[1] == query_id]
            for ck in dead:
                del self._calls[ck]
            sticky = [
                sk for sk in self._stragglers if sk[1] == query_id
            ]
            for sk in sticky:
                del self._stragglers[sk]
        return len(dead) + len(sticky)


def _interruptible_sleep(delay_s: float, cancel=None,
                         poll_s: float = 0.005) -> None:
    """Injected-delay sleep honoring the call's cancel handle: the delay
    is chopped into ``poll_s`` increments and aborts as soon as
    ``cancel.is_set()`` — so a hedged/cancelled loser stuck in an
    injected delay releases its slot at CANCELLATION latency, not after
    the full delay, and chaos tests measure the real cancel plumbing
    (the per-query cancel event / a hedge attempt's loser-cancel ride in
    through the worker surface's ``cancel=`` parameter)."""
    if delay_s <= 0:
        return
    if cancel is None:
        time.sleep(delay_s)
        return
    deadline = time.monotonic() + delay_s
    while not cancel.is_set():
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        time.sleep(min(poll_s, remaining))


def _raise_for(spec: FaultSpec, site: str, url: str, key) -> None:
    if spec.kind == "crash":
        raise WorkerUnavailableError(
            f"[chaos] injected worker crash at {site}",
            worker_url=url, task=key,
        )
    if spec.kind == "transport":
        raise TransportError(
            f"[chaos] injected transient transport error at {site}",
            worker_url=url, task=key,
        )
    raise WorkerError(
        f"[chaos] unknown fault kind {spec.kind!r}",
        worker_url=url, task=key,
    )


def _apply_skew(table, spec: FaultSpec):
    """kind="skew": concentrate a hot key in the task's bulk output —
    the first ``skew_fraction`` of ``skew_column``'s live rows are
    overwritten with the column's row-0 value (and row-0 validity), on
    COPIES of the column's tensors, on its device; capacity, row count,
    schema, and every other column are untouched. A missing/absent column
    or an empty task degrades to a no-op rather than failing the call."""
    from datafusion_distributed_tpu_torch.ops.table import (
        Column,
        Table,
        host_rows,
    )

    name = spec.skew_column or (table.names[0] if table.names else None)
    if not name or name not in table.names:
        return table
    rows = host_rows(table)
    if rows <= 0:
        return table
    hot = int(rows * min(max(spec.skew_fraction, 0.0), 1.0))
    if hot <= 0:
        return table
    col = table.column(name)
    data = col.data.clone()
    data[:hot] = data[0]
    validity = col.validity
    if validity is not None:
        validity = validity.clone()
        validity[:hot] = validity[0]
    cols = tuple(
        Column(data, validity, col.dtype, col.dictionary)
        if n == name else table.column(n)
        for n in table.names
    )
    return Table(tuple(table.names), cols, table.num_rows)


#: encoded-plan int fields that are STRUCTURAL (they enter the plan
#: fingerprint), so perturbing one yields a plan that decodes cleanly but
#: fingerprints differently — the exact "silently different program"
#: corruption the post-decode check exists to catch
_CORRUPTIBLE_KEYS = ("slots", "per_dest", "capacity", "out_cap", "fetch")


def _corrupt_plan_obj(plan_obj: dict) -> dict:
    """Deep-copied ``plan_obj`` with the first structural int field
    perturbed (deterministic walk: dict insertion order). The perturbed
    value is DOUBLED, not incremented: every corruptible field is a
    capacity-like count whose validity survives doubling (power-of-two
    slots stay powers of two), so the corrupted plan decodes AND executes
    cleanly — producing a silently different program, the exact hazard
    the post-decode fingerprint check exists to catch. Falls back to
    appending a bogus column to the first encoded schema when no numeric
    field exists (pure-scan plans)."""
    import copy

    obj = copy.deepcopy(plan_obj)
    done = []

    def walk(o):
        if done:
            return
        if isinstance(o, dict):
            for k, v in o.items():
                if k in _CORRUPTIBLE_KEYS and isinstance(v, int) and not (
                    isinstance(v, bool)
                ) and v > 0:
                    o[k] = v * 2
                    done.append(k)
                    return
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)

    walk(obj)
    if not done:

        def walk_schema(o):
            if done:
                return
            if isinstance(o, dict):
                if isinstance(o.get("schema"), list):
                    o["schema"] = o["schema"] + [["__chaos", "int32", True]]
                    done.append("schema")
                    return
                for v in o.values():
                    walk_schema(v)
            elif isinstance(o, list):
                for v in o:
                    walk_schema(v)

        walk_schema(obj)
    return obj


class ChaosWorker:
    """Fault-injecting proxy around a Worker (or any duck-typed worker
    client): intercepts the coordinator-visible call sites, delegates
    everything else untouched. `kind="delay"` sleeps then delegates —
    paired with `SET distributed.task_timeout_s` it exercises the
    hung-worker -> TaskTimeoutError conversion."""

    def __init__(self, inner, plan: FaultPlan, cluster=None):
        self._inner = inner
        self._plan = plan
        self._cluster = cluster  # ChaosCluster, for membership events

    def _membership(self, site: str, key) -> None:
        """Apply any membership events this call triggers, then fail the
        call if THIS worker is no longer a member: a departed worker's
        endpoint is dead — staged slices and shipped plans went with it —
        and the coordinator's retry machinery must re-stage onto
        survivors."""
        if self._cluster is None:
            return
        for ev in self._plan.membership_due(site, self.url, key):
            self._cluster.apply_membership(ev)
        if self._cluster.is_departed(self.url):
            raise WorkerUnavailableError(
                f"[chaos] worker left the cluster at {site}",
                worker_url=self.url, task=key,
            )

    # -- intercepted control plane ------------------------------------------
    def set_plan(self, key, plan_obj, task_count, cancel=None, **kw):
        # ``cancel`` is consumed HERE (the injected delay polls it), not
        # forwarded: the inner worker surface has no dispatch-cancel
        # parameter — the coordinator only passes it because this proxy
        # declares it
        self._membership("set_plan", key)
        spec = self._plan.decide("set_plan", self.url, key)
        if spec is not None:
            if spec.kind in ("delay", "straggler"):
                _interruptible_sleep(spec.delay_s, cancel)
            elif spec.kind == "oom":
                self._apply_oom(spec)
            elif spec.kind == "corrupt_plan":
                # in-transit corruption: a DEEP copy is mutated (the
                # in-process transport shares the dict object with the
                # coordinator, which must keep its pristine copy for
                # retries/cleanup). The worker's post-decode fingerprint
                # check must refuse this plan (PlanIntegrityError), not
                # execute it.
                plan_obj = _corrupt_plan_obj(plan_obj)
            else:
                _raise_for(spec, "set_plan", self.url, key)
        return self._inner.set_plan(key, plan_obj, task_count, **kw)

    # -- intercepted data plane ---------------------------------------------
    def _apply_oom(self, spec: FaultSpec) -> None:
        """Collapse this worker's enforced memory budget (seeded
        per-worker budget collapse): spill engages immediately on the
        resident entries, and subsequent staging runs under the
        collapsed budget. No error is raised — memory pressure is a
        DEGRADATION fault, and the resilience machinery (spill,
        backpressure, shedding) must absorb it without changing
        results."""
        store = getattr(self._inner, "table_store", None)
        if store is None or not hasattr(store, "set_budget"):
            return
        budget = spec.budget_bytes
        if budget is None:
            budget = max(store.nbytes() // 2, 1)
        store.set_budget(budget)

    def _execute_fault(self, key, cancel=None):
        self._membership("execute", key)
        spec = self._plan.decide("execute", self.url, key)
        if spec is not None:
            if spec.kind in ("delay", "straggler"):
                _interruptible_sleep(spec.delay_s, cancel)
            elif spec.kind == "oom":
                self._apply_oom(spec)
            elif spec.kind == "skew":
                # workload-shaping, not an error: manifests on the RESULT
                # of bulk execute_task (the caller applies _apply_skew);
                # call-time is a no-op so stream/partition paths that
                # share this fault site pass through untouched
                pass
            elif spec.kind == "segment_lost":
                # transfer-specific: ARM the client's tear-next-segment
                # hook and delegate — the fault manifests mid-stream as
                # a vanished shm segment (the window a dying producer
                # leaves behind), and the assertion is that the pull is
                # retried over the wire path, not that this call raises.
                # On clients without the hook (in-process workers, other
                # data-plane calls) the schedule slot is a no-op.
                if hasattr(self._inner, "_chaos_tear_next_segment"):
                    self._inner._chaos_tear_next_segment = True
            else:
                _raise_for(spec, "execute", self.url, key)
        return spec

    def execute_task(self, key, cancel=None):
        # deliberately NO timeout= parameter: advertising one would make
        # the coordinator delegate deadline enforcement to the inner
        # worker, which cannot see this proxy's injected delay — the
        # coordinator's thread deadline must cover the whole (faulty)
        # call. ``cancel`` IS declared: the coordinator's attempt-cancel
        # plumbing (per-query event, hedge loser-cancel) reaches the
        # injected delay's poll loop through it; the inner in-process
        # worker has no cancel surface, so it is consumed here.
        spec = self._execute_fault(key, cancel)
        out = self._inner.execute_task(key)
        if spec is not None and spec.kind == "skew":
            out = _apply_skew(out, spec)
        return out

    def execute_task_stream(self, key, **kw):
        # inject at CALL time, not first-iteration: the coordinator's
        # retry-while-nothing-yielded window must see the fault before
        # any chunk is out. The stream's own cancel event (already part
        # of the surface) doubles as the delay's interrupt.
        self._execute_fault(key, kw.get("cancel"))
        return self._inner.execute_task_stream(key, **kw)

    def execute_task_partitions(self, key, *a, **kw):
        self._execute_fault(key, kw.get("cancel"))
        return self._inner.execute_task_partitions(key, *a, **kw)

    def transfer_partitions(self, key, *a, **kw):
        # explicit proxy (NOT __getattr__ passthrough) so transfer pulls
        # sit under the same execute-site fault schedule as the other
        # data-plane calls — including kind="segment_lost", which arms
        # the client's tear hook in _execute_fault and lets the stream
        # proceed into the torn-segment window
        self._execute_fault(key, kw.get("cancel"))
        return self._inner.transfer_partitions(key, *a, **kw)

    # -- transparent delegation ---------------------------------------------
    def __getattr__(self, name):
        return getattr(self._inner, name)


@dataclass
class ChaosCluster:
    """Resolver+channels facade over a real cluster, handing out
    ChaosWorker proxies. The inner workers' PEER channels stay unwrapped
    (peer pulls model worker<->worker links; this harness injects at the
    coordinator<->worker boundary). Membership events in the FaultPlan
    are applied through the inner cluster's dynamic-membership surface
    (DynamicCluster add/remove/drain); the membership API itself —
    `add_worker`, `drain_worker`, `membership_epoch`,
    `membership_snapshot`, `workers`, ... — passes through via
    `__getattr__` so a coordinator sees the chaos-wrapped cluster as the
    elastic cluster it wraps."""

    inner: "object"
    plan: FaultPlan
    _proxies: dict = field(default_factory=dict)  # guarded-by: _proxy_lock
    # stage fan-out threads resolve workers concurrently with chaos
    # membership events popping proxies from worker-call threads: an
    # unlocked check-then-insert could mint two proxies for one url
    # (splitting the fault plan's nth-call view of that worker) or
    # resurrect a departed worker's proxy mid-pop
    _proxy_lock: threading.Lock = field(default_factory=threading.Lock)

    def get_urls(self) -> list[str]:
        return self.inner.get_urls()

    def get_worker(self, url: str) -> ChaosWorker:
        with self._proxy_lock:
            if url not in self._proxies:
                self._proxies[url] = ChaosWorker(
                    self.inner.get_worker(url), self.plan, cluster=self
                )
            return self._proxies[url]

    # -- membership events ----------------------------------------------------
    def apply_membership(self, ev: MembershipEvent) -> None:
        if ev.action == "leave":
            self.inner.remove_worker(ev.url, release=ev.release)
            with self._proxy_lock:
                self._proxies.pop(ev.url, None)
        elif ev.action == "join":
            self.inner.add_worker(ev.url)
        else:  # drain
            self.inner.drain_worker(ev.url)

    def is_departed(self, url: str) -> bool:
        probe = getattr(self.inner, "is_departed", None)
        return bool(probe(url)) if callable(probe) else False

    def __getattr__(self, name: str):
        # dynamic-membership + introspection passthrough (only reached for
        # attributes not defined on the facade itself)
        return getattr(self.inner, name)


def wrap_cluster(cluster, plan: FaultPlan) -> ChaosCluster:
    """Wrap any resolver+channels cluster (InMemoryCluster,
    DynamicCluster) in the fault-injection harness."""
    return ChaosCluster(cluster, plan)


def one_crash_per_stage(seed: int, kind: str = "crash",
                        max_total: Optional[int] = None) -> FaultPlan:
    """The canonical acceptance schedule: the first task dispatch of every
    stage hits one injected fault, forcing a retry+reroute per stage."""
    return FaultPlan(seed, [
        FaultSpec(site="execute", kind=kind, rate=1.0, max_per_stage=1,
                  max_total=max_total),
    ])
