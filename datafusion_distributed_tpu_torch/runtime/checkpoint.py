"""Query checkpoint/resume: per-stage output snapshots + recovery.

Port of the reference `runtime/checkpoint.py`. Peer healing re-ships
*producers* onto survivors mid-query, but a COORDINATOR loss would throw
away every completed stage of every admitted query. On stage completion
the coordinator snapshots the stage's materialized consumer slices into
the workers' TableStores (data stays on the cluster, on the device it was
made on; the coordinator keeps metadata only), and a fresh
session/coordinator resumes an admitted query from its last completed
stage frontier instead of re-running it from scratch.

Records are validated, never trusted:

- each `StageCheckpoint` carries the stage's STRUCTURAL FINGERPRINT
  (plan/fingerprint.py — literal values included, since the pristine
  pre-hoist subtree is fingerprinted): on resume the re-planned query's
  stage must fingerprint identically or the checkpoint is ignored and
  the stage re-executes (`checkpoint_fp_mismatch`);
- each staged slice is fetched from the worker recorded as holding it:
  a departed worker (or an evicted id) invalidates ONLY that stage
  (`checkpoint_slices_lost`) — the stage re-executes, and its own
  producers still restore from THEIR checkpoints, so a partially-lost
  frontier heals incrementally exactly like the elastic-membership
  re-ship path;
- the membership epoch at save time rides the record for observability
  (the snapshot a resume decision can be audited against).

Restored slices are the byte-exact Tables the original run produced, so
a resumed query's downstream computation — and therefore its result —
is byte-identical to an uninterrupted run.

Scope: the in-process data plane (workers exposing `table_store`).
A wire transport would stage checkpoint slices through a store RPC;
workers without the surface simply never checkpoint (save returns
None, resume falls back to full re-execution). The AdaptiveCoordinator
opts out entirely (`Coordinator._checkpoint_eligible`): its consumer
task counts derive from runtime LoadInfo, so a restored lattice could
disagree with a re-derived one.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Optional

from datafusion_distributed_tpu_torch.runtime import leakcheck as _leakcheck

#: query-record lifecycle states
ADMITTED = "admitted"  # running (or interrupted mid-run): recoverable
RESUMED = "resumed"    # picked up by ServingSession.recover()
DONE = "done"          # resolved; slices released


@dataclass(frozen=True)
class StageCheckpoint:
    """One completed stage's snapshot: the consumer-side scan rebuilt
    verbatim on restore. Frozen — a record is immutable once saved (the
    cross-thread handoff relies on it, like SystemMetrics)."""

    exec_index: int          # which coordinator.execute() of the query
    stage_id: int
    fingerprint: str         # structural fp of the pristine exchange subtree
    #: (worker_url, table_id, nbytes) per consumer slice — the task lattice
    slices: tuple
    replicated: bool
    pinned: bool
    t_prod: int              # producer task count at save time
    membership_epoch: Optional[int]
    saved_s: float           # monotonic save stamp


class QueryRecord:
    """One admitted query's checkpoint state in the store."""

    __slots__ = ("record_id", "sql", "priority", "status", "stages",
                 "resumes")

    def __init__(self, sql: str, priority: int):
        self.record_id = uuid.uuid4().hex
        self.sql = sql
        self.priority = int(priority)
        self.status = ADMITTED
        #: (exec_index, stage_id) -> StageCheckpoint
        self.stages: dict = {}
        self.resumes = 0


class CheckpointStore:
    """Cross-session registry of admitted queries and their completed-
    stage snapshots. Deliberately decoupled from any ServingSession so it
    SURVIVES a session/coordinator teardown — construct one, pass it to
    session after session, and `ServingSession.recover()` resumes
    whatever the previous session left unresolved.

    Thread-safe: per-query coordinators save stages from stage-DAG
    fan-out threads while the serving tier admits/releases concurrently.
    Slice staging/fetching runs OUTSIDE the lock (worker TableStore calls
    block on their own locks); only record bookkeeping is held under it.

    Memory accounting: checkpoint slices stage through `TableStore.
    put_as` — the ACCOUNTED surface — so they count against each
    worker's staged bytes, enforced budget, and spill machinery like any
    other entry (before the budget work they were visible but uncapped
    demand). ``budget_bytes`` additionally caps the store's OWN total:
    past it, the oldest recoverable checkpoints evict (slices released,
    resume degrades to re-execution, `checkpoint_evicted_budget`
    counter) instead of growing unbounded; the just-saved checkpoint is
    protected so a single over-cap stage still makes progress.
    """

    def __init__(self, budget_bytes: int = 0) -> None:
        self._lock = threading.Lock()
        self._records: dict[str, QueryRecord] = {}  # guarded-by: _lock
        self.saves = 0  # guarded-by: _lock
        self.restores = 0  # guarded-by: _lock
        self.budget_bytes = max(int(budget_bytes or 0), 0)
        self.evicted_budget = 0  # guarded-by: _lock

    # -- query lifecycle -----------------------------------------------------
    def admit(self, sql: str, priority: int = 0) -> str:
        """Register an admitted query; -> its record id."""
        rec = QueryRecord(sql, priority)
        with self._lock:
            self._records[rec.record_id] = rec
        return rec.record_id

    def mark_resumed(self, record_id: str) -> None:
        with self._lock:
            rec = self._records.get(record_id)
            if rec is not None:
                rec.status = RESUMED
                rec.resumes += 1

    def incomplete(self) -> list:
        """Records a fresh session should recover: admitted (or already
        once-resumed) queries that never resolved. Snapshot list — the
        caller iterates without the lock."""
        with self._lock:
            return [
                r for r in self._records.values() if r.status != DONE
            ]

    def release(self, record_id: str, channels) -> int:  # releases: checkpoint-slice
        """The query resolved (or was cancelled): drop its record and
        release every staged checkpoint slice through ``channels``
        (departed workers already released theirs with their process);
        -> slices released. The zero-leak half of the acceptance gate."""
        with self._lock:
            rec = self._records.pop(record_id, None)
        if rec is None:
            return 0
        released = 0
        if _leakcheck.enabled():
            for sk in rec.stages:
                _leakcheck.note_release(
                    "checkpoint-slice", (record_id, sk[0], sk[1])
                )
        for ck in rec.stages.values():
            for url, tid, _nbytes in ck.slices:
                try:
                    store = getattr(channels.get_worker(url),
                                    "table_store", None)
                    if store is not None:
                        store.remove([tid])
                        released += 1
                except Exception:
                    pass  # departed worker: its store died with it
        return released

    # -- stage snapshots ------------------------------------------------------
    def save_stage(self, record_id: str, exec_index: int, stage_id: int,  # acquires: checkpoint-slice (managed)
                   fingerprint: str, tables, replicated: bool,
                   pinned: bool, t_prod: int, resolver,
                   channels) -> Optional[int]:
        """Stage ``tables`` (the consumer-side scan slices) into the live
        workers' TableStores, round-robin, and record the checkpoint;
        -> staged bytes, or None when the snapshot could not be taken
        (no store surface / a mid-save departure — never an error: a
        failed checkpoint degrades to re-execution, not a failed query).
        """
        from datafusion_distributed_tpu_torch.runtime.tracing import table_nbytes

        try:
            urls = resolver.get_urls()
        except Exception:
            urls = []
        if not urls:
            return None
        staged: list = []  # (url, tid, nbytes)
        total = 0
        try:
            for i, t in enumerate(tables):
                url = urls[(stage_id + i) % len(urls)]
                store = getattr(channels.get_worker(url), "table_store",
                                None)
                if store is None or not hasattr(store, "put_as"):
                    raise LookupError("worker has no TableStore surface")
                tid = (
                    f"ckpt-{record_id[:8]}-{exec_index}-{stage_id}-{i}-"
                    f"{uuid.uuid4().hex[:8]}"
                )
                store.put_as(tid, t)
                nb = table_nbytes(t)
                staged.append((url, tid, nb))
                total += nb
        except Exception:
            # partial snapshot is worthless: release what staged and skip
            for url, tid, _nb in staged:
                try:
                    getattr(channels.get_worker(url), "table_store").remove(
                        [tid]
                    )
                except Exception:
                    pass
            return None
        ck = StageCheckpoint(
            exec_index=exec_index, stage_id=stage_id,
            fingerprint=fingerprint, slices=tuple(staged),
            replicated=bool(replicated), pinned=bool(pinned),
            t_prod=int(t_prod),
            membership_epoch=getattr(resolver, "membership_epoch", None),
            saved_s=time.monotonic(),
        )
        displaced = None
        with self._lock:
            rec = self._records.get(record_id)
            if rec is None:
                released = True  # query resolved while we staged
            else:
                # same-key re-save (two executors racing one record):
                # the displaced snapshot's slices must release or they
                # leak in the workers' stores for the process lifetime
                displaced = rec.stages.get((exec_index, stage_id))
                rec.stages[(exec_index, stage_id)] = ck
                self.saves += 1
                released = False
                if _leakcheck.enabled():
                    # recovery checkpoints INTENTIONALLY outlive the
                    # query (no query attribution): CheckpointStore
                    # release/_drop_stage are the release paths, so only
                    # assert_clean-style audits see a stuck slice
                    _leakcheck.note_acquire(
                        "checkpoint-slice",
                        (record_id, exec_index, stage_id),
                        tag="CheckpointStore.save_stage",
                    )
        if displaced is not None:
            for url, tid, _nb in displaced.slices:
                try:
                    getattr(channels.get_worker(url), "table_store").remove(
                        [tid]
                    )
                except Exception:
                    pass
        if released:
            for url, tid, _nb in staged:
                try:
                    getattr(channels.get_worker(url), "table_store").remove(
                        [tid]
                    )
                except Exception:
                    pass
            return None
        self._enforce_budget(channels, protect=(record_id,
                                                (exec_index, stage_id)))
        return total

    def _enforce_budget(self, channels, protect=None) -> None:
        """Evict the OLDEST recoverable checkpoints while the store's
        total staged bytes exceed ``budget_bytes`` (0 = uncapped).
        ``protect`` — (record_id, stage_key) of the just-saved
        checkpoint — is never evicted, so one over-cap stage still
        lands. Slice release runs outside the lock."""
        if not self.budget_bytes:
            return
        while True:
            evicted = None
            with self._lock:
                total = sum(
                    nb
                    for r in self._records.values()
                    for ck in r.stages.values()
                    for _u, _t, nb in ck.slices
                )
                if total <= self.budget_bytes:
                    return
                cands = [
                    (ck.saved_s, rid, key)
                    for rid, r in self._records.items()
                    for key, ck in r.stages.items()
                    if (rid, key) != protect
                ]
                if not cands:
                    return  # only the protected save remains: keep it
                _, rid, key = min(cands)
                evicted = self._records[rid].stages.pop(key)
                self.evicted_budget += 1
                if _leakcheck.enabled():
                    _leakcheck.note_release(
                        "checkpoint-slice", (rid, key[0], key[1])
                    )
            for url, tid, _nb in evicted.slices:
                try:
                    getattr(channels.get_worker(url), "table_store").remove(
                        [tid]
                    )
                except Exception:
                    pass  # departed worker: its slices died with it

    def restore_stage(self, record_id: str, exec_index: int,
                      stage_id: int, fingerprint: Optional[str],
                      channels):
        """-> (slices, replicated, pinned, t_prod) for a valid checkpoint
        of this stage, or (None, reason) where reason is one of
        "miss" / "fp_mismatch" / "slice_lost". Every slice is fetched
        from the worker recorded as holding it; a departed worker or an
        evicted id invalidates the checkpoint (and drops the record so
        the re-executed stage can save a fresh one)."""
        with self._lock:
            rec = self._records.get(record_id)
            ck = rec.stages.get((exec_index, stage_id)) if rec else None
        if ck is None:
            return None, "miss"
        if fingerprint is None or ck.fingerprint != fingerprint:
            self._drop_stage(record_id, exec_index, stage_id, channels)
            return None, "fp_mismatch"
        tables = []
        try:
            for url, tid, _nb in ck.slices:
                store = getattr(channels.get_worker(url), "table_store",
                                None)
                if store is None:
                    raise LookupError(f"no store on {url}")
                tables.append(store.get(tid))
        except Exception:
            self._drop_stage(record_id, exec_index, stage_id, channels)
            return None, "slice_lost"
        with self._lock:
            self.restores += 1
        return (tables, ck.replicated, ck.pinned, ck.t_prod), "hit"

    def _drop_stage(self, record_id: str, exec_index: int, stage_id: int,
                    channels) -> None:
        """Invalidate one stage's checkpoint (release surviving slices)."""
        with self._lock:
            rec = self._records.get(record_id)
            ck = (
                rec.stages.pop((exec_index, stage_id), None)
                if rec else None
            )
        if ck is None:
            return
        if _leakcheck.enabled():
            _leakcheck.note_release(
                "checkpoint-slice", (record_id, exec_index, stage_id)
            )
        for url, tid, _nb in ck.slices:
            try:
                getattr(channels.get_worker(url), "table_store").remove(
                    [tid]
                )
            except Exception:
                pass

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            recs = list(self._records.values())
            out = {
                "queries": len(recs),
                "recoverable": sum(1 for r in recs if r.status != DONE),
                "stages": sum(len(r.stages) for r in recs),
                "staged_bytes": sum(
                    nb
                    for r in recs
                    for ck in r.stages.values()
                    for _u, _t, nb in ck.slices
                ),
                "saves": self.saves,
                "restores": self.restores,
                "budget_bytes": self.budget_bytes,
                "checkpoint_evicted_budget": self.evicted_budget,
            }
        return out


def exchange_fingerprints(plan) -> dict:
    """{stage_id: fingerprint-or-None} over a plan's PRISTINE exchange
    subtrees, pre-hoist — literal values are structural, so two queries
    differing only in literals can never share a stage snapshot. Shared
    by `QueryCheckpointer.begin_execute` (intra-query checkpoint keys)
    and the cross-query sub-plan cache (runtime/result_cache.py), so
    the two tiers' keys can never drift."""
    from datafusion_distributed_tpu_torch.plan.fingerprint import (
        plan_fingerprint,
    )

    fps: dict = {}
    try:
        exchanges = plan.collect(
            lambda n: getattr(n, "is_exchange", False)
        )
    except Exception:
        exchanges = []
    for node in exchanges:
        sid = node.stage_id if node.stage_id is not None else 0
        fps[sid] = plan_fingerprint(node)
    return fps


class QueryCheckpointer:
    """Per-query facade installed as `Coordinator.checkpoints`: binds one
    store record to one cluster and tracks the execute-call sequence so
    subquery and overflow-retry executes key their stages independently
    of the main execute (the sequence is deterministic for a given SQL,
    so a resume's Nth execute matches the original run's Nth).

    `begin_execute` runs on the executing thread before any stage fan-out;
    the per-execute fingerprint map is read-only afterwards, so
    save/restore from concurrent stage threads need no lock here (the
    store serializes record mutation itself)."""

    def __init__(self, store: CheckpointStore, record_id: str, resolver,
                 channels):
        self.store = store
        self.record_id = record_id
        self.resolver = resolver
        self.channels = channels
        self._exec_index = -1
        self._stage_fps: dict = {}

    def begin_execute(self, plan) -> None:
        """Stamp a new execute() and fingerprint its pristine exchange
        subtrees (pre-hoist — see `exchange_fingerprints`)."""
        self._exec_index += 1
        self._stage_fps = exchange_fingerprints(plan)

    def stage_fingerprint(self, stage_id: int) -> Optional[str]:
        return self._stage_fps.get(stage_id)

    def save(self, stage_id: int, tables, replicated: bool, pinned: bool,
             t_prod: int) -> Optional[int]:
        fp = self.stage_fingerprint(stage_id)
        if fp is None:
            return None  # unfingerprintable stage: not checkpointable
        return self.store.save_stage(
            self.record_id, self._exec_index, stage_id, fp, tables,
            replicated, pinned, t_prod, self.resolver, self.channels,
        )

    def restore(self, stage_id: int):
        """-> ((slices, replicated, pinned, t_prod), "hit") or
        (None, reason)."""
        return self.store.restore_stage(
            self.record_id, self._exec_index, stage_id,
            self.stage_fingerprint(stage_id), self.channels,
        )
