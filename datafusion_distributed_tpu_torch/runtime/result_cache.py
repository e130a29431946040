"""Fingerprint-keyed result & sub-plan cache (`SET distributed.
result_cache`) — the serving tier's answer to repeated and
literal-variant traffic. Port of the reference `runtime/result_cache.py`.

Two tiers share one byte-budgeted TableStore:

- **Whole-result cache**: keyed on (post-hoist structural plan
  fingerprint, hoisted-literal parameter vectors, full PlannerConfig
  snapshot, catalog generation, task profile) — see
  `plan/fingerprint.py result_cache_key`. Identical and literal-variant
  resubmissions skip planning *and* execution entirely and return the
  staged result Table BY REFERENCE through the zero-copy TableStore
  surface (a hit is the same buffers the cold run produced — byte
  identity is structural, not re-verified). Single-flight: concurrent
  submissions of one key block on the owner's fill instead of
  stampeding duplicate executions.
- **Sub-plan cache**: exchange-subtree frontiers keyed CROSS-QUERY by
  the pre-hoist subtree fingerprint checkpoint.py already computes
  (literal values are structural there, so two queries differing only
  in literals never share a frontier). A new query's coordinator
  restores a cached frontier through the same
  `_materialize_exchange_node` hook the checkpoint/resume path rides —
  slices live in THIS cache's store, so a hit never consults departed
  workers.

Residency: the owned TableStore enforces
`SET distributed.result_cache_budget_bytes` by SPILLING cold entries
via SpillManager instead of evicting them — `get` refaults byte-exactly
onto the device the entry lived on, its dictionaries rebound.
Invalidation: `register_table` bumps
`catalog.generation`; `sync`/`invalidate_generation` drop every entry
staged under an older generation (whole-result keys also carry the
generation, so a stale entry can never even be looked up).

Entries are deliberately process-lifetime (they outlive the queries
that filled them, exactly like checkpoint slices): store inserts run
under ``staging_attribution(None)`` so query-end leak sweeps never flag
them, and each logical entry is tracked as a ``result-cache-entry``
with the leak harness until invalidated/cleared.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

from datafusion_distributed_tpu_torch.runtime import leakcheck as _leakcheck
from datafusion_distributed_tpu_torch.runtime.codec import (
    CodecError,
    TableStore,
    staging_attribution,
)

__all__ = ["ResultCache"]

#: how long a single-flight waiter blocks on the owner before giving up
#: and executing itself (a wedged owner must not deadlock the tier; the
#: duplicate fill displaces harmlessly)
_FLIGHT_WAIT_S = 600.0

#: reused-coordinator bound on per-execute fingerprint maps (fresh
#: coordinators sweep via end_query; a user-held coordinator that never
#: sweeps sheds its oldest execute's map instead of growing forever)
_QUERY_FPS_BOUND = 32


def _key_fp(key) -> Optional[str]:
    """The display fingerprint of a whole-result key (event labels)."""
    if isinstance(key, tuple):
        for part in key:
            if isinstance(part, str):
                return part[:16]
    return None


def _log(kind: str, **fields) -> None:
    """Best-effort event-log emission — cache observability must never
    fail (or slow) the query path it annotates."""
    try:
        from datafusion_distributed_tpu_torch.runtime.eventlog import log_event

        log_event(kind, **fields)
    except Exception:
        pass


class _Entry:
    """One whole-result entry: the staged result's table id plus the
    bookkeeping invalidation and stats need."""

    __slots__ = ("tid", "nbytes", "generation")

    def __init__(self, tid: str, nbytes: int, generation):
        self.tid = tid
        self.nbytes = nbytes
        self.generation = generation


class _SubplanEntry:
    """One cached exchange frontier: per-slice table ids plus the scan
    annotations a restore must reproduce exactly."""

    __slots__ = ("tids", "replicated", "pinned", "t_prod", "nbytes",
                 "generation")

    def __init__(self, tids, replicated, pinned, t_prod, nbytes,
                 generation):
        self.tids = tids
        self.replicated = replicated
        self.pinned = pinned
        self.t_prod = t_prod
        self.nbytes = nbytes
        self.generation = generation


class ResultCache:
    """Whole-result + sub-plan cache over one spill-backed TableStore.

    Thread-safe: serving client threads probe `lookup`, per-query
    threads race `begin`/`fill`, and coordinator stage threads call the
    sub-plan surface — all against one instance. Store I/O (staging,
    refault, spill) always runs OUTSIDE the cache lock."""

    def __init__(self, budget_bytes: int = 0) -> None:
        self._lock = threading.Lock()
        # single-flight rendezvous: waiters block here until the owner
        # fills or fails their key (condition over the SAME lock, so
        # the wait atomically releases the cache state it re-checks)
        self._flight_cv = threading.Condition(self._lock)
        # the residency tier: byte-budgeted, spills cold entries via
        # SpillManager and refaults byte-exactly on get (codec.py)
        self._store = TableStore(budget_bytes=int(budget_bytes or 0))
        self._results: dict = {}  # guarded-by: _lock
        self._subplans: dict = {}  # guarded-by: _lock
        self._flights: set = set()  # guarded-by: _lock
        # execute-scoped pre-hoist exchange fingerprints (the sub-plan
        # keys), stamped by Coordinator.execute via begin_query
        self._query_fps: dict = {}  # guarded-by: _lock; per-query: swept-by end_query; per-query: bounded 32
        self._generation = None  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.fills = 0  # guarded-by: _lock
        self.subplan_hits = 0  # guarded-by: _lock
        self.subplan_misses = 0  # guarded-by: _lock
        self.subplan_fills = 0  # guarded-by: _lock
        self.invalidations = 0  # guarded-by: _lock

    # -- configuration -------------------------------------------------------
    def set_budget(self, budget_bytes) -> None:
        """Replace the enforced byte budget (0/None = unlimited); the
        store rebalances (spills) immediately."""
        self._store.set_budget(budget_bytes)

    def sync(self, generation=None, budget_bytes=None) -> None:
        """Reconcile with the session: adopt the live catalog generation
        (dropping entries staged under an older one — the lazy half of
        `register_table` invalidation, covering direct catalog writes)
        and the live budget knob."""
        if generation is not None:
            self.invalidate_generation(generation)
        if budget_bytes is not None:
            try:
                b = int(float(budget_bytes or 0))
            except (TypeError, ValueError):
                b = 0
            if b != self._store.budget_bytes:
                self._store.set_budget(b)

    # -- invalidation --------------------------------------------------------
    def invalidate_generation(self, generation) -> int:  # releases: result-cache-entry
        """Drop every entry staged under a generation other than
        ``generation`` and adopt it; -> entries dropped. Idempotent and
        cheap when nothing changed (the register_table hot path)."""
        dead_tids: list = []
        dropped = 0
        with self._lock:
            if generation == self._generation:
                return 0
            self._generation = generation
            for key in [k for k, e in self._results.items()
                        if e.generation != generation]:
                e = self._results.pop(key)
                dead_tids.append(e.tid)
                if _leakcheck.enabled():
                    _leakcheck.note_release(
                        "result-cache-entry", (id(self), e.tid)
                    )
                dropped += 1
            for fp in [f for f, e in self._subplans.items()
                       if e.generation != generation]:
                e = self._subplans.pop(fp)
                dead_tids.extend(e.tids)
                if _leakcheck.enabled():
                    _leakcheck.note_release(
                        "result-cache-entry", (id(self), "sp:" + fp)
                    )
                dropped += 1
            if dropped:
                self.invalidations += dropped
        if dead_tids:
            # store release OUTSIDE the cache lock: a spilled victim's
            # slot unlink happens under the store's own lock
            self._store.remove(dead_tids)
        if dropped:
            _log("result_cache_invalidate", entries=dropped,
                 generation=generation)
        return dropped

    # -- whole-result surface ------------------------------------------------
    def lookup(self, key, query_id=None):
        """Non-blocking peek (the serving tier's pre-costing admission
        probe): the cached Table or None. A miss is NOT counted — the
        executing path's `begin` counts it exactly once."""
        if key is None:
            return None
        with self._lock:
            e = self._results.get(key)
        if e is None:
            return None
        return self._fetch(key, e, query_id)

    def begin(self, key, query_id=None):
        """Single-flight consult: -> ("hit", table) or ("miss", None).
        On a miss the CALLER owns execution and MUST resolve the flight
        with `fill` (success) or `fail` (error) — concurrent callers of
        the same key block here until then instead of executing
        duplicates."""
        deadline = time.monotonic() + _FLIGHT_WAIT_S
        while True:
            entry = None
            with self._flight_cv:
                e = self._results.get(key)
                if e is not None:
                    entry = e
                elif key not in self._flights:
                    self._flights.add(key)
                    self.misses += 1
                    miss = True
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # wedged owner: execute ourselves — the
                        # duplicate fill displaces, never corrupts
                        self.misses += 1
                        miss = True
                    else:
                        self._flight_cv.wait(timeout=min(remaining, 1.0))
                        continue
            if entry is None:
                if miss:
                    _log("result_cache_miss", fingerprint=_key_fp(key),
                         query_id=query_id)
                    return ("miss", None)
                continue
            t = self._fetch(key, entry, query_id)
            if t is not None:
                return ("hit", t)
            # entry vanished between peek and fetch (raced invalidate):
            # loop — next pass either sees a fresh entry or owns a miss

    def _fetch(self, key, entry: _Entry, query_id):
        """Resolve an entry's Table outside the cache lock (a spilled
        entry refaults byte-exactly here); None if it raced away."""
        try:
            t = self._store.get(entry.tid)
        except CodecError:
            return None
        with self._lock:
            self.hits += 1
        _log("result_cache_hit", fingerprint=_key_fp(key),
             nbytes=entry.nbytes, query_id=query_id)
        return t

    def fill(self, key, table, query_id=None) -> None:  # acquires: result-cache-entry (managed)
        """Install an executed result and wake the key's waiters.
        Unattributed staging: entries outlive the filling query, so the
        query-end leak sweep must not claim them."""
        tid = "rc-" + uuid.uuid4().hex
        with staging_attribution(None):
            self._store.put_as(tid, table)
        nbytes = self._store.entry_nbytes(tid)
        stale = None
        with self._flight_cv:
            old = self._results.get(key)
            if old is not None:
                # raced duplicate execution (flight-timeout path): the
                # newest fill wins, the displaced entry releases below
                stale = old.tid
                if _leakcheck.enabled():
                    _leakcheck.note_release(
                        "result-cache-entry", (id(self), old.tid)
                    )
            self._results[key] = _Entry(tid, nbytes, self._generation)
            self.fills += 1
            if _leakcheck.enabled():
                _leakcheck.note_acquire(
                    "result-cache-entry", (id(self), tid),
                    tag="ResultCache.fill",
                )
            self._flights.discard(key)
            self._flight_cv.notify_all()
        if stale is not None:
            self._store.remove([stale])
        _log("result_cache_fill", fingerprint=_key_fp(key),
             nbytes=nbytes, query_id=query_id)

    def fail(self, key) -> None:
        """The owning execution failed: release the flight so one waiter
        takes over ownership (its next `begin` pass claims the miss)."""
        with self._flight_cv:
            self._flights.discard(key)
            self._flight_cv.notify_all()

    # -- sub-plan surface (Coordinator._materialize_exchange_node) -----------
    def begin_query(self, query_id: str, plan) -> None:
        """Stamp one Coordinator.execute: fingerprint the plan's
        pristine exchange subtrees (pre-hoist — shared helper with the
        checkpoint tier, so sub-plan keys and checkpoint keys can never
        drift) under the execute's query id."""
        from datafusion_distributed_tpu_torch.runtime.checkpoint import (
            exchange_fingerprints,
        )

        fps = exchange_fingerprints(plan)
        with self._lock:
            while len(self._query_fps) >= _QUERY_FPS_BOUND:
                self._query_fps.pop(next(iter(self._query_fps)))
            self._query_fps[query_id] = fps

    def end_query(self, query_id: str) -> None:
        """Query-end sweep of the execute's fingerprint map (the cached
        frontiers themselves stay — they are the cross-query point)."""
        with self._lock:
            self._query_fps.pop(query_id, None)

    def restore_subplan(self, query_id: str, stage_id: int):
        """-> (slices, replicated, pinned, t_prod) for a cached frontier
        matching this execute's stage fingerprint, or None. Slices are
        served from THIS cache's store (refaulting if spilled), so a
        restore never consults any worker."""
        with self._lock:
            fp = (self._query_fps.get(query_id) or {}).get(stage_id)
            if fp is None:
                return None
            e = self._subplans.get(fp)
            if e is None:
                self.subplan_misses += 1
                return None
            tids = e.tids
            meta = (e.replicated, e.pinned, e.t_prod)
        slices = []
        for tid in tids:
            try:
                slices.append(self._store.get(tid))
            except CodecError:
                return None  # raced invalidate mid-restore: re-execute
        with self._lock:
            self.subplan_hits += 1
        _log("result_cache_subplan_hit", fingerprint=fp[:16],
             stage=stage_id, query_id=query_id)
        return (slices, *meta)

    def save_subplan(self, query_id: str, stage_id: int, slices,  # acquires: result-cache-entry (managed)
                     replicated: bool, pinned: bool,
                     t_prod: int) -> Optional[int]:
        """Stage a just-materialized frontier under its subtree
        fingerprint; -> staged bytes or None (unfingerprintable stage /
        already cached / raced sibling)."""
        with self._lock:
            fp = (self._query_fps.get(query_id) or {}).get(stage_id)
            if fp is None or fp in self._subplans:
                return None
            gen = self._generation
        tids = []
        total = 0
        with staging_attribution(None):
            for t in slices:
                tid = "rcsp-" + uuid.uuid4().hex
                self._store.put_as(tid, t)
                tids.append(tid)
                total += self._store.entry_nbytes(tid)
        stale = None
        with self._lock:
            if fp in self._subplans:
                stale = tids  # raced sibling saved first: drop ours
            else:
                self._subplans[fp] = _SubplanEntry(
                    tuple(tids), replicated, pinned, t_prod, total, gen
                )
                self.subplan_fills += 1
                if _leakcheck.enabled():
                    _leakcheck.note_acquire(
                        "result-cache-entry", (id(self), "sp:" + fp),
                        tag="ResultCache.save_subplan",
                    )
        if stale is not None:
            self._store.remove(stale)
            return None
        _log("result_cache_subplan_fill", fingerprint=fp[:16],
             stage=stage_id, nbytes=total, query_id=query_id)
        return total

    # -- lifecycle -----------------------------------------------------------
    def clear(self) -> int:  # releases: result-cache-entry
        """Drop every cached entry (and its store bytes / spill files);
        -> entries dropped. The test-facing zero-leak teardown."""
        dead: list = []
        with self._lock:
            for e in self._results.values():
                dead.append(e.tid)
                if _leakcheck.enabled():
                    _leakcheck.note_release(
                        "result-cache-entry", (id(self), e.tid)
                    )
            for fp, e in self._subplans.items():
                dead.extend(e.tids)
                if _leakcheck.enabled():
                    _leakcheck.note_release(
                        "result-cache-entry", (id(self), "sp:" + fp)
                    )
            n = len(self._results) + len(self._subplans)
            self._results.clear()
            self._subplans.clear()
            self._query_fps.clear()
        if dead:
            self._store.remove(dead)
        return n

    close = clear

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = {
                "hits": self.hits,
                "misses": self.misses,
                "fills": self.fills,
                "subplan_hits": self.subplan_hits,
                "subplan_misses": self.subplan_misses,
                "subplan_fills": self.subplan_fills,
                "invalidations": self.invalidations,
                "entries": len(self._results),
                "subplan_entries": len(self._subplans),
                "generation": self._generation,
            }
        probes = out["hits"] + out["misses"]
        out["hit_rate"] = (out["hits"] / probes) if probes else 0.0
        s = self._store.stats()
        for k in ("nbytes", "budget_bytes", "spilled_nbytes", "spills",
                  "refaults", "spill_files"):
            out[k] = s[k]
        return out

    def telemetry_families(self) -> list:
        """Typed-registry adapter (runtime/telemetry.py): the
        `dftpu_result_cache_*` families, eagerly present (zero-valued)
        from the first snapshot so dashboards never see a gap between
        'cache off' and 'cache cold'."""
        from datafusion_distributed_tpu_torch.runtime.telemetry import family

        st = self.stats()
        return [
            family("dftpu_result_cache_hits", "counter",
                   "Cache hits by tier (result = whole-result, "
                   "subplan = exchange-frontier).",
                   [({"tier": "result"}, st["hits"]),
                    ({"tier": "subplan"}, st["subplan_hits"])]),
            family("dftpu_result_cache_misses", "counter",
                   "Cache misses by tier.",
                   [({"tier": "result"}, st["misses"]),
                    ({"tier": "subplan"}, st["subplan_misses"])]),
            family("dftpu_result_cache_invalidations", "counter",
                   "Entries dropped by catalog-generation bumps.",
                   [({}, st["invalidations"])]),
            family("dftpu_result_cache_bytes", "gauge",
                   "Resident cached bytes (owned, spill-blind).",
                   [({}, st["nbytes"])]),
            family("dftpu_result_cache_spilled_bytes", "gauge",
                   "Cached bytes currently spilled to the disk segment.",
                   [({}, st["spilled_nbytes"])]),
            family("dftpu_result_cache_entries", "gauge",
                   "Live entries by tier.",
                   [({"tier": "result"}, st["entries"]),
                    ({"tier": "subplan"}, st["subplan_entries"])]),
        ]
