"""Plan (de)serialization codec.

The reference ships task-specialized plan subtrees to workers as protobuf
(`DistributedCodec`, `src/protobuf/distributed_codec.rs`, with
user-codec composition). Here plans serialize to JSON-able dicts; bulk data
never rides inside the plan — scan leaves serialize as *table references*
into a shipment store (in-process: shared by reference, the
LocalWorkerConnection zero-copy bypass analogue; cross-host: Arrow IPC bytes
via `encode_table`/`decode_table`).

User extension nodes register via `register_codec` (the user-codec registry
analogue, `src/protobuf/user_codec.rs`).

Port of the reference `runtime/codec.py`. In process, staged tables stay on
the device they were made on and are shared by reference; only
`encode_table`/`encode_table_adaptive` (Arrow IPC, for bytes that leave the
process) copy columns to the host — and the spill segment
(runtime/spill.py), which an enforced worker memory budget writes the
coldest staged entries to.
"""

from __future__ import annotations

import threading
import uuid
from typing import Callable, Optional

from datafusion_distributed_tpu_torch.runtime import leakcheck as _leakcheck
from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec
from datafusion_distributed_tpu_torch.ops.sort import SortKey
from datafusion_distributed_tpu_torch.ops.table import Table
from datafusion_distributed_tpu_torch.plan import expressions as pe
from datafusion_distributed_tpu_torch.plan.exchanges import (
    BroadcastExchangeExec,
    CoalesceExchangeExec,
    IsolatedArmExec,
    PartitionReplicatedExec,
    ShuffleExchangeExec,
)
from datafusion_distributed_tpu_torch.plan.joins import (
    CrossJoinExec,
    HashJoinExec,
    MultiwayHashJoinExec,
    MultiwayJoinStep,
    UnionExec,
)
from datafusion_distributed_tpu_torch.plan.physical import (
    CoalescePartitionsExec,
    ExecutionPlan,
    FilterExec,
    HashAggregateExec,
    LimitExec,
    MemoryScanExec,
    ParquetScanExec,
    PartialPassthroughExec,
    ProjectionExec,
    SortExec,
)
from datafusion_distributed_tpu_torch.schema import DataType, Field, Schema


class CodecError(ValueError):
    pass


_USER_CODECS: dict[str, tuple[Callable, Callable]] = {}


def register_codec(kind: str, encode: Callable, decode: Callable) -> None:
    """Register (encode(node, ctx) -> dict, decode(obj, ctx) -> node) for a
    custom ExecutionPlan type."""
    _USER_CODECS[kind] = (encode, decode)


def _table_nbytes(table) -> int:
    from datafusion_distributed_tpu_torch.runtime.tracing import table_nbytes

    return table_nbytes(table)


def _spill_event(name: str, tid: str, nbytes: int) -> None:
    """Structured spill/refault trace event (runtime/eventlog.py) —
    best-effort: observability must never fail the staging path."""
    try:
        from datafusion_distributed_tpu_torch.runtime.eventlog import log_event

        log_event(name, table_id=tid, nbytes=int(nbytes))
    except Exception:
        pass


class _EntryMeta:
    """Accounting record of one store entry. ``base`` is None for an entry
    that OWNS its buffers (counted once in the store's byte total) and the
    owning entry's id for a view/alias (shares buffers, counted zero);
    ``refs`` counts the aliases of an owning entry. ``spilled`` holds the
    entry's on-disk SpillSlot while its buffers live in the host spill
    segment (runtime/spill.py) instead of memory; ``owner_query`` is the
    query id staging attribution captured at insert (the serving tier's
    estimate-vs-measured loop reads per-query peaks from it)."""

    __slots__ = ("nbytes", "base", "refs", "spilled", "owner_query")

    def __init__(self, nbytes: int, base: Optional[str] = None,
                 owner_query: Optional[str] = None):
        self.nbytes = int(nbytes)
        self.base = base
        self.refs = 0
        self.spilled = None
        self.owner_query = owner_query


class _SpilledSentinel:
    """Placeholder value a spilled entry's table id maps to: the entry is
    LIVE (it still counts as staged, releases normally, leaks if leaked)
    but its buffers are on disk until `get` refaults them."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<spilled>"


_SPILLED = _SpilledSentinel()

#: staging-attribution context (thread-local): while set, owned bytes
#: inserted into ANY TableStore on this thread are attributed to the
#: query id — the coordinator wraps dispatch encodes, the worker wraps
#: decode + partition staging. Per-query peaks close the serving tier's
#: estimate-vs-measured admission loop.
_staging_attr = threading.local()


class staging_attribution:
    """``with staging_attribution(query_id): ...`` — attribute owned-byte
    inserts on this thread to ``query_id`` (None = unattributed)."""

    __slots__ = ("qid", "prev")

    def __init__(self, qid: Optional[str]):
        self.qid = qid
        self.prev = None

    def __enter__(self):
        self.prev = getattr(_staging_attr, "qid", None)
        _staging_attr.qid = self.qid
        return self

    def __exit__(self, *exc):
        _staging_attr.qid = self.prev


def _current_attribution() -> Optional[str]:
    return getattr(_staging_attr, "qid", None)


class _TableDict(dict):
    """tid -> Table mapping of a TableStore. Legacy call sites mutate it
    directly (`store.tables[tid] = t` on the wire receive path,
    `.clear()` on cluster teardown), so the mapping itself routes every
    mutation through the store's byte accounting — the two can never
    disagree."""

    __slots__ = ("_store",)

    def __init__(self, store: "TableStore"):
        super().__init__()
        self._store = store

    def __setitem__(self, tid, table):
        with self._store._lock:
            self._store._release_locked(tid)
            self._store._insert_locked(tid, table)

    def __delitem__(self, tid):
        with self._store._lock:
            if not dict.__contains__(self, tid):
                raise KeyError(tid)
            self._store._release_locked(tid)

    def pop(self, tid, *default):
        with self._store._lock:
            if dict.__contains__(self, tid):
                val = dict.__getitem__(self, tid)
                self._store._release_locked(tid)
                return val
        if default:
            return default[0]
        raise KeyError(tid)

    def clear(self):
        with self._store._lock:
            for tid in list(dict.keys(self)):
                self._store._release_locked(tid)

    def update(self, *args, **kwargs):
        # route through __setitem__ so every inserted entry is accounted
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __ior__(self, other):
        self.update(other)
        return self

    def setdefault(self, tid, default=None):
        with self._store._lock:
            if dict.__contains__(self, tid):
                return dict.__getitem__(self, tid)
            self._store._insert_locked(tid, default)
            return default

    def popitem(self):
        with self._store._lock:
            tid = next(reversed(self), None)
            if tid is None:
                raise KeyError("popitem(): dictionary is empty")
            val = dict.__getitem__(self, tid)
            self._store._release_locked(tid)
            return tid, val


class TableStore:
    """Shipment store: table id -> staged Table — the buffer-owning,
    byte-accounted heart of the zero-copy data plane.

    In-process peers share entries by reference; cross-host transport
    serializes them with encode_table. Callers release shipped entries when
    their task completes (drop-driven cleanup, like the reference's
    partition-drop accounting).

    Zero-copy semantics:

    - ``put`` DEDUPLICATES by table identity: staging the same Table object
      again (broadcast fan-out — one entry per consumer task; retry
      re-ships of unchanged slices) registers an alias that shares the
      buffers and counts ZERO additional bytes. Releasing the owning entry
      while aliases remain promotes an alias (refcounted release, never a
      copy).
    - ``put_view``/``get_slice`` expose row-range VIEWS of a staged entry
      (views of the same buffers via ops.table.slice_view) so
      per-destination slices and chunk streams reference one staged buffer.
    - Thread-safe: serving-tier threads and stage-DAG fan-out threads
      mutate one worker store concurrently; every mutation (including the
      legacy direct `tables[tid] = t` writes) runs under one lock.
    - Byte-accounted: ``nbytes()``/``stats()`` report live owned bytes,
      entry/view counts and the high-water mark — the observability
      service's actual-staged-bytes surface, and the recorded entry sizes
      (`entry_nbytes`) are what dispatch encode spans attribute, so store
      accounting and trace bytes can never disagree.
    - Budget-ENFORCED: when ``budget_bytes`` is set (constructor,
      `set_budget`, the `DFTPU_WORKER_MEM_BUDGET` env, or the
      `distributed.worker_memory_budget_bytes` knob shipped with task
      configs), staging past the budget spills the coldest unreferenced
      owned entries to a host-disk segment (runtime/spill.py) and `get`
      refaults them transparently — byte-exact, original capacity
      preserved. Entries pinned by views/aliases are unspillable (their
      buffers are shared); `under_pressure()` reports residency still
      over budget after spilling, which is what the stream planes'
      producer backpressure keys on. Spill/refault file I/O always runs
      OUTSIDE the store lock."""

    def __init__(self, budget_bytes: Optional[int] = None) -> None:
        self._lock = threading.RLock()
        # every mutation of `tables` routes through _TableDict, which
        # takes this store's lock itself — the guarded fields below are
        # the accounting the _locked helpers keep in sync with it
        self.tables: _TableDict = _TableDict(self)
        self._meta: dict[str, _EntryMeta] = {}  # guarded-by: _lock
        self._by_identity: dict[int, str] = {}  # guarded-by: _lock
        self._owned_nbytes = 0  # guarded-by: _lock
        self.peak_nbytes = 0  # guarded-by: _lock
        self.put_count = 0  # guarded-by: _lock
        self.dedup_hits = 0  # guarded-by: _lock
        # -- enforced memory budget (0 = unlimited) --------------------------
        if budget_bytes is None:
            import os

            try:
                budget_bytes = int(float(
                    os.environ.get("DFTPU_WORKER_MEM_BUDGET", "0")
                ))
            except (TypeError, ValueError):
                budget_bytes = 0
        self.budget_bytes = max(int(budget_bytes or 0), 0)  # guarded-by: _lock
        self._spill = None  # SpillManager, lazy  # guarded-by: _lock
        self._spilling: set = set()  # tids mid-spill  # guarded-by: _lock
        self.spilled_nbytes = 0  # live bytes in the segment  # guarded-by: _lock
        self.spill_count = 0  # guarded-by: _lock
        self.refault_count = 0  # guarded-by: _lock
        # -- per-query staging attribution (logical demand, spill-blind) ----
        self._query_bytes: dict[str, int] = {}  # guarded-by: _lock; per-query: bounded 512
        self._query_peak: dict[str, int] = {}  # guarded-by: _lock; per-query: bounded 512

    # -- accounting core (callers hold self._lock) ---------------------------
    def _insert_locked(self, tid: str, table: Table,
                       base: Optional[str] = None,
                       nbytes: Optional[int] = None) -> str:
        meta = _EntryMeta(
            _table_nbytes(table) if nbytes is None else nbytes, base=base,
            owner_query=_current_attribution(),
        )
        dict.__setitem__(self.tables, tid, table)
        self._meta[tid] = meta
        if _leakcheck.enabled():
            _leakcheck.note_acquire(
                "store-entry", (id(self), tid),
                query_id=meta.owner_query,
                tag="view" if base is not None else "owner",
            )
        if base is None:
            self._by_identity[id(table)] = tid
            self._owned_nbytes += meta.nbytes
            self.peak_nbytes = max(self.peak_nbytes, self._owned_nbytes)
            self._attr_add_locked(meta)
        else:
            b = self._meta.get(base)
            if b is not None:
                b.refs += 1
        return tid

    def _attr_add_locked(self, meta: _EntryMeta) -> None:
        """Charge an OWNING insert's logical bytes to its query (spill-
        blind: attribution measures staging DEMAND, which is what the
        admission re-cost loop needs, not residency). Bounded: a
        long-lived worker sheds the oldest query's attribution instead
        of growing per-query dicts forever (sweep_query_attribution is
        the cooperative path)."""
        qid = meta.owner_query
        if not qid or not meta.nbytes:
            return
        cur = self._query_bytes.get(qid, 0) + meta.nbytes
        self._query_bytes[qid] = cur
        if cur > self._query_peak.get(qid, 0):
            self._query_peak[qid] = cur
        while len(self._query_peak) > 512:
            old = next(iter(self._query_peak))
            self._query_peak.pop(old, None)
            self._query_bytes.pop(old, None)

    def _attr_sub_locked(self, meta: _EntryMeta) -> None:
        qid = meta.owner_query
        if not qid or not meta.nbytes:
            return
        cur = self._query_bytes.get(qid)
        if cur is not None:
            self._query_bytes[qid] = max(cur - meta.nbytes, 0)

    def _release_locked(self, tid: str) -> None:
        meta = self._meta.pop(tid, None)
        table = None
        if dict.__contains__(self.tables, tid):
            table = dict.__getitem__(self.tables, tid)
            dict.__delitem__(self.tables, tid)
        if meta is None:
            return
        if _leakcheck.enabled():
            _leakcheck.note_release("store-entry", (id(self), tid))
        if meta.base is not None:
            b = self._meta.get(meta.base)
            if b is not None:
                b.refs = max(b.refs - 1, 0)
            return
        if meta.spilled is not None:
            # spilled owner: its bytes live in the segment, not the
            # resident total — release the disk slot instead (unlink,
            # idempotent, O(1): not a registered blocking call). A view
            # registered against it in put_view's unlocked window still
            # promotes below: the view holds its own pre-spill buffers.
            self.spilled_nbytes -= meta.nbytes
            self._attr_sub_locked(meta)
            if self._spill is not None:
                self._spill.release(meta.spilled)
        else:
            self._owned_nbytes -= meta.nbytes
            self._attr_sub_locked(meta)
            if table is not None and self._by_identity.get(id(table)) == tid:
                del self._by_identity[id(table)]
        if meta.refs > 0:
            # views/aliases still reference the buffers: promote the first
            # one to owner so shared staged bytes stay accounted until the
            # LAST reference drops (refcounted release, not a copy). A
            # promoted slice-view accounts its own logical bytes — a
            # deliberate undercount of the full base buffer it pins.
            heir = next(
                (t2 for t2, m2 in self._meta.items() if m2.base == tid),
                None,
            )
            if heir is not None:
                hm = self._meta[heir]
                hm.base = None
                hm.refs = 0
                for m2 in self._meta.values():
                    if m2 is not hm and m2.base == tid:
                        m2.base = heir
                        hm.refs += 1
                ht = dict.__getitem__(self.tables, heir)
                self._by_identity.setdefault(id(ht), heir)
                self._owned_nbytes += hm.nbytes
                self.peak_nbytes = max(
                    self.peak_nbytes, self._owned_nbytes
                )
                self._attr_add_locked(hm)

    def _canonical(self, tid: str) -> str:
        m = self._meta.get(tid)
        while m is not None and m.base is not None:
            tid = m.base
            m = self._meta.get(tid)
        return tid

    # -- public surface ------------------------------------------------------
    def put(self, table: Table) -> str:  # acquires: store-entry (managed)
        tid = uuid.uuid4().hex
        with self._lock:
            self.put_count += 1
            canon = self._by_identity.get(id(table))
            if canon is not None and dict.get(self.tables, canon) is table:
                # identity dedup: the SAME staged object (broadcast
                # fan-out, retry re-ship) becomes a zero-byte alias
                self.dedup_hits += 1
                self._insert_locked(tid, table, base=canon,
                                    nbytes=self._meta[canon].nbytes)
            else:
                self._insert_locked(tid, table)
        self.enforce_budget()
        return tid

    def put_as(self, tid: str, table: Table) -> str:  # acquires: store-entry (managed)
        """Stage under a caller-chosen id (the wire receive path — the
        shipping side minted the id and the plan references it — and the
        checkpoint store's accounted staging surface)."""
        self.tables[tid] = table
        self.enforce_budget()
        return tid

    def put_view(self, base_tid: str, table: Optional[Table] = None,  # acquires: store-entry (managed)
                 lo: int = 0, count: Optional[int] = None) -> str:
        """Register a zero-copy VIEW of an existing entry as its own id:
        shares the base buffers (zero owned bytes; the base stays pinned by
        refcount until the last view drops). ``table`` may be a view the
        caller already built over the entry's buffers; otherwise rows
        [lo, lo+count) are sliced here via `get_slice`. The base resolves
        BEFORE the lock is taken: a spilled base refaults in `get`, whose
        file I/O must never run under the store lock."""
        if table is None:
            base_table = self.get(base_tid)  # refaults a spilled base
            if count is None:
                count = int(base_table.num_rows) - lo
            table = self.get_slice(base_tid, lo, count)
        with self._lock:
            canon = self._canonical(base_tid)
            if canon not in self._meta:
                raise CodecError(
                    f"table {base_tid} not in shipment store"
                )
            # the base may have (re-)spilled inside the unlocked window
            # above: registering the view is still correct — the view
            # holds its own (pre-spill) buffers, and the spilled-owner
            # release path promotes surviving views exactly like the
            # resident path, so nothing leaks accounting either way
            tid = uuid.uuid4().hex
            self.put_count += 1
            self._insert_locked(tid, table, base=canon)
        return tid

    def get(self, tid: str) -> Table:
        with self._lock:
            if not dict.__contains__(self.tables, tid):
                raise CodecError(f"table {tid} not in shipment store")
            val = dict.__getitem__(self.tables, tid)
            m = self._meta.get(tid)
            if m is not None:
                # LRU touch: budget victim selection walks _meta in
                # order, so a re-read entry moves to the hot end
                self._meta[tid] = self._meta.pop(tid)
            if val is not _SPILLED or m is None:
                return val
            slot = m.spilled
        return self._refault(tid, slot)

    def _refault(self, tid: str, slot) -> Table:
        """Restore a spilled entry's buffers from the segment (file read
        OUTSIDE the lock) and re-install them; a raced second refault or
        a raced release both resolve to one consistent winner."""
        from datafusion_distributed_tpu_torch.runtime.spill import SpillError

        try:
            table = self._spill_manager().read_spill(slot)
        except SpillError:
            # a raced WINNER may have refaulted + released (unlinked)
            # the slot between our locked read and this open: re-check
            # under the lock and serve the winner's resident table — the
            # entry is live and recoverable, never an error. A vanished
            # ENTRY (raced remove) keeps the not-in-store contract.
            with self._lock:
                m = self._meta.get(tid)
                if m is None:
                    raise CodecError(
                        f"table {tid} not in shipment store"
                    )
                if dict.__contains__(self.tables, tid):
                    cur = dict.__getitem__(self.tables, tid)
                    if cur is not _SPILLED:
                        return cur
                new_slot = m.spilled
            if new_slot is not None and new_slot is not slot:
                # re-spilled under a fresh slot mid-race: read that one
                return self._refault(tid, new_slot)
            raise
        release_slot = None
        with self._lock:
            m = self._meta.get(tid)
            if m is None or m.spilled is not slot:
                # released (return the content that was live at call
                # time) or already refaulted by a sibling (serve theirs)
                if m is not None and dict.__contains__(self.tables, tid):
                    cur = dict.__getitem__(self.tables, tid)
                    if cur is not _SPILLED:
                        table = cur
            else:
                dict.__setitem__(self.tables, tid, table)
                m.spilled = None
                self._owned_nbytes += m.nbytes
                self.peak_nbytes = max(self.peak_nbytes, self._owned_nbytes)
                self.spilled_nbytes -= m.nbytes
                self.refault_count += 1
                self._by_identity.setdefault(id(table), tid)
                release_slot = slot
        if release_slot is not None:
            self._spill.release(release_slot)
            _spill_event("store_refault", tid,
                         self.entry_nbytes(tid))
            # the refault may push residency back over budget: rebalance
            # by spilling colder entries (never this one — it is now the
            # hottest by LRU order)
            self.enforce_budget()
        return table

    # -- enforced memory budget ---------------------------------------------
    def _spill_manager(self):
        with self._lock:
            if self._spill is None:
                from datafusion_distributed_tpu_torch.runtime.spill import (
                    SpillManager,
                )

                self._spill = SpillManager()
            return self._spill

    def set_budget(self, budget_bytes) -> None:
        """Set/replace the enforced byte budget (0/None = unlimited) and
        rebalance immediately — the chaos `kind="oom"` collapse path."""
        try:
            b = max(int(float(budget_bytes or 0)), 0)
        except (TypeError, ValueError):
            return
        with self._lock:
            self.budget_bytes = b
        self.enforce_budget()

    def under_pressure(self) -> bool:
        """Residency still over budget AFTER spilling (every remaining
        entry is pinned by refs or mid-spill): the producer-backpressure
        signal the stream planes consult."""
        with self._lock:
            return bool(self.budget_bytes) and (
                self._owned_nbytes > self.budget_bytes
            )

    def enforce_budget(self) -> int:
        """Spill coldest unreferenced owned entries until resident owned
        bytes fit the budget; -> bytes spilled. Victims are chosen under
        the lock; the file WRITE runs outside it, then the
        entry swaps to the spilled sentinel if it is still live and
        unchanged. No-op without a budget. A disk failure degrades to an
        unenforced budget — never a failed staging."""
        from datafusion_distributed_tpu_torch.runtime.spill import SpillError

        spilled_total = 0
        while True:
            with self._lock:
                if not self.budget_bytes or (
                    self._owned_nbytes <= self.budget_bytes
                ):
                    break
                victim = next(
                    (t for t, m in self._meta.items()
                     if m.base is None and m.spilled is None
                     and m.refs == 0 and t not in self._spilling
                     and dict.get(self.tables, t) is not None),
                    None,
                )
                if victim is None:
                    break  # everything left is pinned: backpressure takes over
                self._spilling.add(victim)
                table = dict.__getitem__(self.tables, victim)
                nbytes = self._meta[victim].nbytes
            try:
                slot = self._spill_manager().write_spill(table, nbytes)
            except SpillError:
                with self._lock:
                    self._spilling.discard(victim)
                break  # disk trouble: leave resident, stop trying
            with self._lock:
                self._spilling.discard(victim)
                m = self._meta.get(victim)
                live = (
                    m is not None and m.base is None
                    and m.spilled is None
                    and dict.get(self.tables, victim) is table
                )
                if not live or m.refs > 0:
                    # released/replaced/aliased while the write ran: the
                    # slot is orphaned — drop it (release is idempotent)
                    release_orphan = slot
                else:
                    release_orphan = None
                    dict.__setitem__(self.tables, victim, _SPILLED)
                    m.spilled = slot
                    self._owned_nbytes -= m.nbytes
                    self.spilled_nbytes += m.nbytes
                    self.spill_count += 1
                    spilled_total += m.nbytes
                    if self._by_identity.get(id(table)) == victim:
                        del self._by_identity[id(table)]
            if release_orphan is not None:
                self._spill.release(release_orphan)
            else:
                _spill_event("store_spill", victim, nbytes)
        return spilled_total

    def reset_peak(self) -> int:
        """Reset the high-water mark to the CURRENT residency and return
        the previous peak — per-phase peaks for bench arms (the lifetime
        peak was monotone and made them unmeasurable)."""
        with self._lock:
            prev = self.peak_nbytes
            self.peak_nbytes = self._owned_nbytes
            return prev

    # -- per-query staging attribution ---------------------------------------
    def query_peak_nbytes(self, query_id: str) -> int:
        """Peak logical bytes this query ever had staged here (demand,
        spill-blind) — the measured side of the admission re-cost loop."""
        with self._lock:
            return self._query_peak.get(query_id, 0)

    def query_current_nbytes(self, query_id: str) -> int:
        with self._lock:
            return self._query_bytes.get(query_id, 0)

    def sweep_query_attribution(self, query_id: str) -> int:
        """Drop a resolved query's attribution state; -> its peak."""
        with self._lock:
            self._query_bytes.pop(query_id, None)
            return self._query_peak.pop(query_id, 0)

    def get_slice(self, tid: str, lo: int, count: int) -> Table:
        """Zero-copy row-range view of a staged entry (not registered —
        use `put_view` to give the view its own id/lifetime)."""
        from datafusion_distributed_tpu_torch.ops.table import slice_view

        return slice_view(self.get(tid), lo, count)

    def remove(self, tids) -> None:  # releases: store-entry
        with self._lock:
            for tid in tids:
                self._release_locked(tid)

    # -- accounting surface --------------------------------------------------
    def nbytes(self) -> int:
        """Live owned bytes (shared buffers counted once)."""
        with self._lock:
            return self._owned_nbytes

    def entry_nbytes(self, tid: str) -> int:
        """The recorded logical size of one entry — what a dispatch encode
        span attributes for this table id (always the size recorded at
        put time, so spans and store accounting cannot disagree)."""
        with self._lock:
            m = self._meta.get(tid)
            return m.nbytes if m is not None else 0

    def stats(self) -> dict:
        with self._lock:
            views = sum(
                1 for m in self._meta.values() if m.base is not None
            )
            out = {
                "entries": len(self._meta),
                "nbytes": self._owned_nbytes,
                "views": views,
                "peak_nbytes": self.peak_nbytes,
                "puts": self.put_count,
                "dedup_hits": self.dedup_hits,
                "budget_bytes": self.budget_bytes,
                "spilled_nbytes": self.spilled_nbytes,
                "spills": self.spill_count,
                "refaults": self.refault_count,
            }
            spill = self._spill
        # the spill manager's lock nests AFTER the store lock everywhere
        # else; reading its counters outside ours keeps the static
        # order graph a tree
        if spill is not None:
            ss = spill.stats()
            out["spill_files"] = ss["spill_files"]
            out["spilled_total_bytes"] = ss["spill_bytes"]
            out["refaulted_total_bytes"] = ss["refault_bytes"]
        else:
            out["spill_files"] = 0
            out["spilled_total_bytes"] = 0
            out["refaulted_total_bytes"] = 0
        return out

    def telemetry_families(self) -> list:
        """Typed-registry adapter (runtime/telemetry.py): the staged-byte
        accounting as uniformly named gauges/counters, sampled at
        snapshot time — the `get_metrics` face of the numbers `stats()`
        already keeps (one source of truth, two surfaces)."""
        from datafusion_distributed_tpu_torch.runtime.telemetry import family

        s = self.stats()
        return [
            family("dftpu_store_staged_bytes", "gauge",
                   "Live owned bytes staged in the table store "
                   "(shared buffers counted once).",
                   [({}, s["nbytes"])]),
            family("dftpu_store_entries", "gauge",
                   "Staged entries (owners + views/aliases).",
                   [({}, s["entries"])]),
            family("dftpu_store_views", "gauge",
                   "Zero-copy view/alias entries sharing an owner's "
                   "buffers.", [({}, s["views"])]),
            family("dftpu_store_peak_bytes", "gauge",
                   "High-water mark of owned staged bytes.",
                   [({}, s["peak_nbytes"])]),
            family("dftpu_store_puts", "counter",
                   "Entries ever staged.", [({}, s["puts"])]),
            family("dftpu_store_dedup_hits", "counter",
                   "Identity-dedup hits (zero-byte aliases).",
                   [({}, s["dedup_hits"])]),
            family("dftpu_store_budget_bytes", "gauge",
                   "Enforced worker memory budget (0 = unlimited).",
                   [({}, s["budget_bytes"])]),
            family("dftpu_store_spilled_bytes", "gauge",
                   "Live staged bytes resident in the host spill "
                   "segment instead of memory.",
                   [({}, s["spilled_nbytes"])]),
            family("dftpu_store_spills", "counter",
                   "Entries ever spilled to the host segment.",
                   [({}, s["spills"])]),
            family("dftpu_store_refaults", "counter",
                   "Spilled entries refaulted back on get().",
                   [({}, s["refaults"])]),
            family("dftpu_store_spill_files", "gauge",
                   "Spill files currently on disk (0 once drained — "
                   "the zero-leak gate's file half).",
                   [({}, s["spill_files"])]),
        ]


def collect_table_ids(plan_obj: dict) -> list[str]:
    """All shipment-store ids referenced by an encoded plan (a scan's
    shipped dictionary values hold none, and are not walked)."""
    out: list[str] = []

    def walk(o):
        if isinstance(o, dict):
            if o.get("t") == "memscan":
                out.extend(o["tables"])
            for k, v in o.items():
                if k != "dictionaries":
                    walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)

    walk(plan_obj)
    return out


# ---------------------------------------------------------------------------
# schema / expressions
# ---------------------------------------------------------------------------


def encode_schema(s: Schema) -> list:
    return [[f.name, f.dtype.value, f.nullable] for f in s.fields]


def decode_schema(obj) -> Schema:
    return Schema([Field(n, DataType(d), bool(nl)) for n, d, nl in obj])


def encode_expr(e: pe.PhysicalExpr) -> dict:
    if isinstance(e, pe.Col):
        return {"t": "col", "name": e.name}
    if isinstance(e, pe.Literal):
        v = e.value
        return {"t": "lit", "value": v, "dtype": e.dtype.value}
    if isinstance(e, pe.BinaryOp):
        return {"t": "bin", "op": e.op, "l": encode_expr(e.left),
                "r": encode_expr(e.right)}
    if isinstance(e, pe.BooleanOp):
        return {"t": "bool", "op": e.op, "l": encode_expr(e.left),
                "r": encode_expr(e.right)}
    if isinstance(e, pe.Not):
        return {"t": "not", "c": encode_expr(e.child)}
    if isinstance(e, pe.IsNull):
        return {"t": "isnull", "c": encode_expr(e.child), "neg": e.negated}
    if isinstance(e, pe.Cast):
        return {"t": "cast", "c": encode_expr(e.child), "to": e.to.value}
    if isinstance(e, pe.Like):
        return {"t": "like", "c": encode_expr(e.child), "p": e.pattern,
                "neg": e.negated}
    if isinstance(e, pe.InList):
        return {"t": "inlist", "c": encode_expr(e.child),
                "values": list(e.values), "neg": e.negated}
    if isinstance(e, pe.Case):
        return {
            "t": "case",
            "branches": [[encode_expr(c), encode_expr(v)] for c, v in e.branches],
            "else": encode_expr(e.otherwise) if e.otherwise else None,
        }
    if isinstance(e, pe.Alias):
        return {"t": "alias", "c": encode_expr(e.child), "name": e.name}
    if isinstance(e, pe.Negate):
        return {"t": "neg", "c": encode_expr(e.child)}
    if isinstance(e, pe.Extract):
        return {"t": "extract", "part": e.part, "c": encode_expr(e.child)}
    if isinstance(e, pe.Substring):
        return {"t": "substr", "c": encode_expr(e.child), "start": e.start,
                "length": e.length}
    if isinstance(e, pe.Coalesce):
        return {"t": "coalesce", "args": [encode_expr(a) for a in e.args]}
    if isinstance(e, pe.Abs):
        return {"t": "abs", "c": encode_expr(e.child)}
    if isinstance(e, pe.Round):
        return {"t": "round", "c": encode_expr(e.child), "digits": e.digits}
    if isinstance(e, pe.StringCase):
        return {"t": "strcase", "c": encode_expr(e.child), "upper": e.upper}
    if isinstance(e, pe.ConcatStrings):
        return {"t": "concat", "args": [encode_expr(a) for a in e.args]}
    if isinstance(e, pe.DateTrunc):
        return {"t": "datetrunc", "unit": e.unit, "c": encode_expr(e.child)}
    if isinstance(e, pe.StrLength):
        return {"t": "strlen", "c": encode_expr(e.child)}
    if isinstance(e, pe.RegexpReplace):
        return {"t": "regexp_replace", "c": encode_expr(e.child),
                "p": e.pattern, "r": e.replacement}
    # a resolved scalar subquery is a constant by the time plans ship
    from datafusion_distributed_tpu_torch.sql.logical import ScalarSubqueryExpr

    if isinstance(e, ScalarSubqueryExpr) and getattr(e, "resolved", None):
        # shipped as a subquery constant, not a plain literal: a literal
        # would be hoisted into the parameter vector on the worker, and
        # its plan would no longer fingerprint as the coordinator's (the
        # reference ships "lit" and fails DFTPU043 on q11, q15 and q22)
        value, dtype = e.resolved
        return {"t": "subqlit", "value": value, "dtype": dtype.value}
    raise CodecError(f"cannot encode expression {type(e).__name__}")


def decode_expr(o: dict) -> pe.PhysicalExpr:
    t = o["t"]
    if t == "col":
        return pe.Col(o["name"])
    if t == "lit":
        return pe.Literal(o["value"], DataType(o["dtype"]))
    if t == "bin":
        return pe.BinaryOp(o["op"], decode_expr(o["l"]), decode_expr(o["r"]))
    if t == "bool":
        return pe.BooleanOp(o["op"], decode_expr(o["l"]), decode_expr(o["r"]))
    if t == "not":
        return pe.Not(decode_expr(o["c"]))
    if t == "isnull":
        return pe.IsNull(decode_expr(o["c"]), o["neg"])
    if t == "cast":
        return pe.Cast(decode_expr(o["c"]), DataType(o["to"]))
    if t == "like":
        return pe.Like(decode_expr(o["c"]), o["p"], o["neg"])
    if t == "inlist":
        return pe.InList(decode_expr(o["c"]), tuple(o["values"]), o["neg"])
    if t == "case":
        branches = tuple(
            (decode_expr(c), decode_expr(v)) for c, v in o["branches"]
        )
        otherwise = decode_expr(o["else"]) if o["else"] else None
        return pe.Case(branches, otherwise)
    if t == "alias":
        return pe.Alias(decode_expr(o["c"]), o["name"])
    if t == "neg":
        return pe.Negate(decode_expr(o["c"]))
    if t == "extract":
        return pe.Extract(o["part"], decode_expr(o["c"]))
    if t == "substr":
        return pe.Substring(decode_expr(o["c"]), o["start"], o["length"])
    if t == "coalesce":
        return pe.Coalesce(tuple(decode_expr(a) for a in o["args"]))
    if t == "abs":
        return pe.Abs(decode_expr(o["c"]))
    if t == "round":
        return pe.Round(decode_expr(o["c"]), o["digits"])
    if t == "strcase":
        return pe.StringCase(decode_expr(o["c"]), o["upper"])
    if t == "concat":
        return pe.ConcatStrings(tuple(decode_expr(a) for a in o["args"]))
    if t == "datetrunc":
        return pe.DateTrunc(o["unit"], decode_expr(o["c"]))
    if t == "strlen":
        return pe.StrLength(decode_expr(o["c"]))
    if t == "regexp_replace":
        return pe.RegexpReplace(decode_expr(o["c"]), o["p"], o["r"])
    if t == "subqlit":
        from datafusion_distributed_tpu_torch.sql.logical import (
            ScalarSubqueryExpr,
        )

        return ScalarSubqueryExpr.resolved_constant(o["value"],
                                                    DataType(o["dtype"]))
    raise CodecError(f"cannot decode expression kind {t!r}")


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def encode_plan(p: ExecutionPlan, store: TableStore) -> dict:
    """Encode ``p``, stamping its structural fingerprint (plan/fingerprint)
    into the wire object under ``"_fp"``. Decoders ignore the key; workers
    compare it against the DECODED plan's fingerprint (runtime/worker.py
    post-decode check, diagnostic DFTPU043) so a miscoded/corrupted plan
    becomes a classified fatal error instead of wrong results.

    ``DFTPU_VERIFY_CODEC=1`` additionally round-trips the encoding through
    decode_plan right here and fails fast (DFTPU044) on fingerprint drift —
    the debug-mode assertion for codec changes."""
    from datafusion_distributed_tpu_torch.plan.fingerprint import prepare_plan

    obj = _encode_plan_node(p, store)
    fp = prepare_plan(p).fingerprint
    if fp is not None:
        obj["_fp"] = fp
        import os

        if os.environ.get("DFTPU_VERIFY_CODEC") == "1":
            _verify_codec_roundtrip(p, obj, store, fp)
    return obj


def _verify_codec_roundtrip(p: ExecutionPlan, obj: dict, store: TableStore,
                            fp: str) -> None:
    from datafusion_distributed_tpu_torch.plan.fingerprint import prepare_plan
    from datafusion_distributed_tpu_torch.runtime.errors import PlanIntegrityError

    decoded = decode_plan(obj, store)
    got = prepare_plan(decoded).fingerprint
    if got != fp:
        raise PlanIntegrityError(
            f"DFTPU044: codec round-trip fingerprint drift for "
            f"{type(p).__name__}: encoded plan fingerprints as {fp}, "
            f"decode(encode(plan)) as {got} — the codec dropped or "
            "reordered structural state (DFTPU_VERIFY_CODEC=1)"
        )


def _encode_plan_node(p: ExecutionPlan, store: TableStore) -> dict:
    if isinstance(p, MemoryScanExec):
        return {
            "t": "memscan",
            "tables": [store.put(t) for t in p.tasks],
            "schema": encode_schema(p.schema()),
            "pinned": p.pinned,
            "replicated": p.replicated,
        }
    if isinstance(p, ParquetScanExec):
        return {
            "t": "pqscan",
            "file_groups": p.file_groups,
            "schema": encode_schema(p._schema),
            "capacity": p.capacity,
            "projection": p.projection,
            "device": str(p.device) if p.device is not None else None,
            # shared dictionaries must travel: per-worker rebuilt dictionaries
            # would make codes incomparable across the exchange
            "dictionaries": {
                name: list(d.values)
                for name, d in (p.dictionaries or {}).items()
            } or None,
        }
    if isinstance(p, FilterExec):
        return {"t": "filter", "pred": encode_expr(p.predicate),
                "c": _encode_plan_node(p.child, store)}
    if isinstance(p, ProjectionExec):
        return {
            "t": "project",
            "exprs": [[encode_expr(e), n] for e, n in p.exprs],
            "c": _encode_plan_node(p.child, store),
        }
    if isinstance(p, HashAggregateExec):
        return {
            "t": "agg",
            "mode": p.mode,
            "groups": p.group_names,
            "aggs": [[a.func, a.input_name, a.output_name] for a in p.aggs],
            "slots": p.num_slots,
            "c": _encode_plan_node(p.child, store),
        }
    if isinstance(p, PartialPassthroughExec):
        return {
            "t": "partial_passthrough",
            "groups": p.group_names,
            "aggs": [[a.func, a.input_name, a.output_name] for a in p.aggs],
            "c": _encode_plan_node(p.child, store),
        }
    if isinstance(p, SortExec):
        return {
            "t": "sort",
            "keys": [[k.name, k.ascending, k.nulls_first] for k in p.keys],
            "fetch": p.fetch,
            "c": _encode_plan_node(p.child, store),
        }
    if isinstance(p, LimitExec):
        return {"t": "limit", "fetch": p.fetch, "skip": p.skip,
                "c": _encode_plan_node(p.child, store)}
    if isinstance(p, CoalescePartitionsExec):
        return {"t": "coalesce_parts", "c": _encode_plan_node(p.child, store)}
    if isinstance(p, HashJoinExec):
        return {
            "t": "hashjoin",
            "jt": p.join_type,
            "pk": p.probe_keys,
            "bk": p.build_keys,
            "residual": encode_expr(p.residual) if p.residual else None,
            "out_cap": p.out_capacity,
            "slots": p.num_slots,
            "mark": p.mark_name,
            "null_aware": p.null_aware,
            "probe": _encode_plan_node(p.probe, store),
            "build": _encode_plan_node(p.build, store),
        }
    if isinstance(p, MultiwayHashJoinExec):
        return {
            "t": "mwjoin",
            "steps": [
                {
                    "jt": s.join_type,
                    "pk": list(s.probe_keys),
                    "bk": list(s.build_keys),
                    "residual": (encode_expr(s.residual)
                                 if s.residual else None),
                    "out_cap": s.out_capacity,
                    "slots": s.num_slots,
                    "mark": s.mark_name,
                    "null_aware": s.null_aware,
                }
                for s in p.steps
            ],
            "probe": _encode_plan_node(p.probe, store),
            "builds": [_encode_plan_node(b, store) for b in p.builds],
        }
    if isinstance(p, CrossJoinExec):
        return {"t": "crossjoin", "out_cap": p.out_capacity,
                "l": _encode_plan_node(p.left, store),
                "r": _encode_plan_node(p.right, store)}
    if isinstance(p, UnionExec):
        return {"t": "union",
                "cs": [_encode_plan_node(c, store) for c in p.children()]}
    from datafusion_distributed_tpu_torch.plan.window_exec import WindowExec

    if isinstance(p, WindowExec):
        return {
            "t": "window",
            "funcs": [[f.func, f.input_name, f.output_name, f.frame]
                      for f in p.funcs],
            "partitions": p.partition_names,
            "orders": [[k.name, k.ascending, k.nulls_first]
                       for k in p.order_keys],
            "fields": encode_schema(Schema(p.out_fields)),
            "c": _encode_plan_node(p.child, store),
        }
    from datafusion_distributed_tpu_torch.plan.exchanges import (
        RangeShuffleExchangeExec,
    )

    # exchange boundary state: producer_tasks and consumer_fetch are
    # STRUCTURAL (they enter output_capacity and the plan fingerprint) —
    # dropping them on the wire re-shaped decoded plans silently until the
    # DFTPU043/044 integrity checks made the loss a hard error
    if isinstance(p, RangeShuffleExchangeExec):
        return {
            "t": "range_shuffle",
            "keys": [[k.name, k.ascending, k.nulls_first]
                     for k in p.sort_keys],
            "tasks": p.num_tasks, "per_dest": p.per_dest_capacity,
            "stage": p.stage_id, "prod": p.producer_tasks,
            "cfetch": p.consumer_fetch,
            "c": _encode_plan_node(p.child, store),
        }
    if isinstance(p, ShuffleExchangeExec):
        return {"t": "shuffle", "keys": p.key_names, "tasks": p.num_tasks,
                "per_dest": p.per_dest_capacity, "stage": p.stage_id,
                "prod": p.producer_tasks, "cfetch": p.consumer_fetch,
                "c": _encode_plan_node(p.child, store)}
    if isinstance(p, CoalesceExchangeExec):
        return {"t": "coalesce_ex", "tasks": p.num_tasks, "stage": p.stage_id,
                "consumers": p.num_consumers,
                "prod": p.producer_tasks, "cfetch": p.consumer_fetch,
                "c": _encode_plan_node(p.child, store)}
    if isinstance(p, BroadcastExchangeExec):
        return {"t": "broadcast_ex", "tasks": p.num_tasks, "stage": p.stage_id,
                "prod": p.producer_tasks, "cfetch": p.consumer_fetch,
                "c": _encode_plan_node(p.child, store)}
    if isinstance(p, PartitionReplicatedExec):
        return {"t": "partrep", "tasks": p.num_tasks, "stage": p.stage_id,
                "prod": p.producer_tasks, "cfetch": p.consumer_fetch,
                "c": _encode_plan_node(p.child, store)}
    if isinstance(p, IsolatedArmExec):
        return {"t": "isoarm", "task": p.assigned_task,
                "c": _encode_plan_node(p.child, store)}
    from datafusion_distributed_tpu_torch.runtime.peer import PeerShuffleScanExec

    if isinstance(p, PeerShuffleScanExec):
        return {
            "t": "peerscan",
            "pulls": [
                [[list(key), url, lo, hi] for key, url, lo, hi in specs]
                for specs in p.pulls_per_task
            ],
            "keys": p.key_names,
            "parts": p.num_partitions,
            "per_dest": p.per_dest_capacity,
            "schema": encode_schema(p._schema),
            "dictionaries": {
                name: list(d.values)
                for name, d in (p.dictionaries or {}).items()
            } or None,
            "replicated": p.replicated,
            "pinned_task": p.pinned_task,
            "pull_all": p.pull_all,
            "budget": p.budget_bytes,
            "chunk_rows": p.chunk_rows,
            "cap_hint": p.capacity_hint,
            "device": str(p.device) if p.device is not None else None,
        }
    kind = getattr(p, "codec_kind", None)
    if kind and kind in _USER_CODECS:
        enc, _ = _USER_CODECS[kind]
        return {"t": f"user:{kind}", "body": enc(p, store)}
    raise CodecError(f"cannot encode plan node {type(p).__name__}")


def _restore_exchange_state(n, o: dict):
    n.stage_id = o["stage"]
    n.producer_tasks = o.get("prod")
    n.consumer_fetch = o.get("cfetch")
    return n


def decode_plan(o: dict, store: TableStore) -> ExecutionPlan:
    t = o["t"]
    if t == "memscan":
        tables = [store.get(tid) for tid in o["tables"]]
        return MemoryScanExec(tables, decode_schema(o["schema"]),
                              pinned=o.get("pinned", False),
                              replicated=o.get("replicated", False))
    if t == "pqscan":
        from datafusion_distributed_tpu_torch.ops.table import Dictionary
        import numpy as np

        dicts = None
        if o.get("dictionaries"):
            dicts = {
                name: Dictionary(np.asarray(vals, dtype=object))
                for name, vals in o["dictionaries"].items()
            }
        return ParquetScanExec(
            o["file_groups"], decode_schema(o["schema"]), o["capacity"],
            o["projection"], dicts, device=o.get("device"),
        )
    if t == "filter":
        return FilterExec(decode_expr(o["pred"]), decode_plan(o["c"], store))
    if t == "project":
        return ProjectionExec(
            [(decode_expr(e), n) for e, n in o["exprs"]],
            decode_plan(o["c"], store),
        )
    if t == "agg":
        return HashAggregateExec(
            o["mode"], o["groups"],
            [AggSpec(f, i, n) for f, i, n in o["aggs"]],
            decode_plan(o["c"], store), o["slots"],
        )
    if t == "partial_passthrough":
        return PartialPassthroughExec(
            o["groups"],
            [AggSpec(f, i, n) for f, i, n in o["aggs"]],
            decode_plan(o["c"], store),
        )
    if t == "sort":
        return SortExec(
            [SortKey(n, a, nf) for n, a, nf in o["keys"]],
            decode_plan(o["c"], store), o["fetch"],
        )
    if t == "limit":
        return LimitExec(decode_plan(o["c"], store), o["fetch"], o["skip"])
    if t == "coalesce_parts":
        return CoalescePartitionsExec(decode_plan(o["c"], store))
    if t == "hashjoin":
        return HashJoinExec(
            decode_plan(o["probe"], store), decode_plan(o["build"], store),
            o["pk"], o["bk"], o["jt"],
            residual=decode_expr(o["residual"]) if o["residual"] else None,
            out_capacity=o["out_cap"], num_slots=o["slots"],
            mark_name=o["mark"], null_aware=o["null_aware"],
        )
    if t == "mwjoin":
        return MultiwayHashJoinExec(
            decode_plan(o["probe"], store),
            [decode_plan(b, store) for b in o["builds"]],
            [
                MultiwayJoinStep(
                    probe_keys=tuple(s["pk"]), build_keys=tuple(s["bk"]),
                    join_type=s["jt"], out_capacity=s["out_cap"],
                    num_slots=s["slots"],
                    residual=(decode_expr(s["residual"])
                              if s["residual"] else None),
                    mark_name=s["mark"], null_aware=s["null_aware"],
                )
                for s in o["steps"]
            ],
        )
    if t == "crossjoin":
        return CrossJoinExec(decode_plan(o["l"], store),
                             decode_plan(o["r"], store), o["out_cap"])
    if t == "union":
        return UnionExec([decode_plan(c, store) for c in o["cs"]])
    if t == "window":
        from datafusion_distributed_tpu_torch.ops.window import WindowFunc
        from datafusion_distributed_tpu_torch.plan.window_exec import WindowExec

        return WindowExec(
            decode_plan(o["c"], store),
            [WindowFunc(*args) for args in o["funcs"]],
            o["partitions"],
            [SortKey(n, a, nf) for n, a, nf in o["orders"]],
            list(decode_schema(o["fields"]).fields),
        )
    if t == "range_shuffle":
        from datafusion_distributed_tpu_torch.plan.exchanges import (
            RangeShuffleExchangeExec,
        )

        n = RangeShuffleExchangeExec(
            decode_plan(o["c"], store),
            [SortKey(nm, a, nf) for nm, a, nf in o["keys"]],
            o["tasks"], o["per_dest"],
        )
        return _restore_exchange_state(n, o)
    if t == "shuffle":
        n = ShuffleExchangeExec(decode_plan(o["c"], store), o["keys"],
                                o["tasks"], o["per_dest"])
        return _restore_exchange_state(n, o)
    if t == "coalesce_ex":
        n = CoalesceExchangeExec(decode_plan(o["c"], store), o["tasks"],
                                 o.get("consumers", 1))
        return _restore_exchange_state(n, o)
    if t == "broadcast_ex":
        n = BroadcastExchangeExec(decode_plan(o["c"], store), o["tasks"])
        return _restore_exchange_state(n, o)
    if t == "partrep":
        n = PartitionReplicatedExec(decode_plan(o["c"], store), o["tasks"])
        return _restore_exchange_state(n, o)
    if t == "isoarm":
        return IsolatedArmExec(decode_plan(o["c"], store), o["task"])
    if t == "peerscan":
        from datafusion_distributed_tpu_torch.ops.table import Dictionary
        from datafusion_distributed_tpu_torch.runtime.peer import (
            PeerShuffleScanExec,
        )
        import numpy as np

        dicts = None
        if o.get("dictionaries"):
            dicts = {
                name: Dictionary(np.asarray(vals, dtype=object))
                for name, vals in o["dictionaries"].items()
            }
        return PeerShuffleScanExec(
            [
                [(tuple(key), url, lo, hi) for key, url, lo, hi in specs]
                for specs in o["pulls"]
            ],
            o["keys"], o["parts"], o["per_dest"],
            decode_schema(o["schema"]), dicts,
            replicated=o.get("replicated", False),
            pinned_task=o.get("pinned_task"),
            pull_all=o.get("pull_all", False),
            budget_bytes=o.get("budget", 64 << 20),
            chunk_rows=o.get("chunk_rows", 65536),
            capacity_hint=o.get("cap_hint", 0),
            device=o.get("device"),
        )
    if t.startswith("user:"):
        kind = t[5:]
        if kind not in _USER_CODECS:
            raise CodecError(f"no codec registered for {kind!r}")
        _, dec = _USER_CODECS[kind]
        return dec(o["body"], store)
    raise CodecError(f"cannot decode plan kind {t!r}")


# ---------------------------------------------------------------------------
# table transport (cross-host payloads)
# ---------------------------------------------------------------------------


def _live_on_host(table: Table) -> Table:
    """The table's live rows in host memory: the one place the runtime
    copies column data off the device (bytes about to leave the process)."""
    from datafusion_distributed_tpu_torch.ops.table import (
        host_rows,
        host_view,
        slice_view,
    )

    return host_view(slice_view(table, 0, host_rows(table)))


def encode_table(table: Table, whole_dictionaries: bool = False,
                 sent: Optional[set] = None) -> memoryview:
    """Table -> Arrow IPC payload (the Flight data-plane analogue):
    dictionary-GC'd string columns + logical-dtype metadata (the wire shape
    of io/parquet.table_to_arrow). Writes through `pa.BufferOutputStream`
    and returns a memoryview over the resulting Arrow buffer — the old
    `BytesIO` + `getvalue()` shape duplicated the whole payload at peak
    (one copy in the stream, a second in getvalue). Consumers (transport
    framing, compression, len) all speak the buffer protocol.
    ``whole_dictionaries`` ships string columns with their whole
    dictionaries and unchanged codes, named by fingerprint; a dictionary
    whose fingerprint is in ``sent`` (the receiver holds it) goes as a
    reference (io/parquet.py `table_to_arrow`): the gRPC tier's
    encoding."""
    import pyarrow as pa

    from datafusion_distributed_tpu_torch.io.parquet import table_to_arrow

    arrow = table_to_arrow(_live_on_host(table), dictionary_gc=True,
                           logical_metadata=True,
                           whole_dictionaries=whole_dictionaries, sent=sent)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, arrow.schema) as w:
        w.write_table(arrow)
    # getvalue() on a BufferOutputStream is zero-copy (an Arrow buffer);
    # the memoryview keeps it alive and exposes the buffer protocol
    return memoryview(sink.getvalue())


def decode_table(data, capacity: Optional[int] = None, device=None,
                 held: Optional[dict] = None) -> Table:
    """Arrow IPC payload -> Table on ``device`` (None: the card), uploaded
    in one copy. Reads through `pa.BufferReader` (no BytesIO staging
    copy); ``capacity`` passes through to the column build; ``held``:
    fingerprint -> Dictionary, the dictionaries the receiver advertised
    and those earlier payloads of the stream carried (`encode_table`'s
    ``sent``; io/parquet.py `arrow_to_host_columns`)."""
    import pyarrow as pa

    from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table

    with pa.ipc.open_stream(pa.BufferReader(data)) as r:
        arrow = r.read_all()
    return arrow_to_table(arrow, capacity=capacity, device=device,
                          held=held)


# ---------------------------------------------------------------------------
# adaptive per-column wire compression (remote hops only)
# ---------------------------------------------------------------------------

#: rows sampled per column when choosing its wire codec — enough to see
#: repetition without paying a full-column unique() on wide exchanges
WIRE_SAMPLE_ROWS = 512
#: payloads under this ship as one plainly-compressed blob: per-column
#: IPC framing has fixed schema overhead that only pays on real payloads
ADAPTIVE_MIN_BYTES = 1 << 12


def choose_column_codec(column, available) -> str:
    """Wire codec for ONE arrow column from sampled statistics — the
    adaptive half of the remote data plane. Dictionary/string columns
    are dominated by repeated values and codes: the strongest available
    codec (zstd) wins. Repetitive columns (sampled unique ratio <= 0.5)
    prefer the cheapest negotiated codec (lz4 beats zstd on speed when
    both ends speak it). High-entropy floats ship raw — compressing
    random mantissas burns CPU to save nothing. ``available`` is the
    NEGOTIATED codec set (both endpoints), not this process's."""
    import pyarrow as pa

    avail = set(available or ())

    def best(*prefs: str) -> str:
        for p in prefs:
            if p in avail:
                return p
        return "none"

    t = column.type
    if pa.types.is_dictionary(t) or pa.types.is_string(t) or (
        pa.types.is_large_string(t)
    ):
        return best("zstd", "lz4")
    sample = column.slice(0, min(len(column), WIRE_SAMPLE_ROWS))
    try:
        ratio = len(sample.unique()) / max(len(sample), 1)
    except pa.ArrowInvalid:
        ratio = 1.0
    if ratio <= 0.5:
        return best("lz4", "zstd")
    if pa.types.is_floating(t):
        return "none"
    return best("zstd", "lz4")


def encode_table_adaptive(table: Table, available,
                          whole_dictionaries: bool = False,
                          sent: Optional[set] = None
                          ) -> tuple[dict, dict]:
    """Table -> per-column Arrow IPC blobs with per-column codec picks;
    -> (blobs {"c<i>": payload}, codecs {"c<i>": codec}). Each column is
    its own single-column IPC stream so the transport's per-blob
    ``comp`` framing (self-describing) carries a MIXED-codec frame; the
    decoder reassembles the columns into one table. Returns ({}, {})
    for a zero-column table — callers fall back to `encode_table`.
    ``whole_dictionaries`` and ``sent`` as for `encode_table` (the first
    column's blob carries the payload's dictionary references)."""
    import pyarrow as pa

    from datafusion_distributed_tpu_torch.io.parquet import table_to_arrow

    arrow = table_to_arrow(_live_on_host(table), dictionary_gc=True,
                           logical_metadata=True,
                           whole_dictionaries=whole_dictionaries, sent=sent)
    blobs: dict = {}
    codecs: dict = {}
    for i in range(arrow.num_columns):
        single = arrow.select([i])
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, single.schema) as w:
            w.write_table(single)
        name = f"c{i}"
        blobs[name] = memoryview(sink.getvalue())
        codecs[name] = choose_column_codec(arrow.column(i), available)
    return blobs, codecs


def decode_table_adaptive(blobs: dict, num_cols: int,
                          capacity: Optional[int] = None,
                          device=None, held: Optional[dict] = None) -> Table:
    """Reassemble `encode_table_adaptive` blobs into one Table: the
    single-column arrow tables are re-joined and decoded through the
    SAME `arrow_to_table` call as the single-blob path, so both wire
    shapes build byte-identical tables. ``held`` as for
    `decode_table`."""
    import pyarrow as pa

    from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table

    if num_cols <= 0:
        raise CodecError("adaptive frame with zero columns")
    parts = []
    for i in range(num_cols):
        with pa.ipc.open_stream(pa.BufferReader(blobs[f"c{i}"])) as r:
            parts.append(r.read_all())
    arrow = parts[0]
    for t in parts[1:]:
        arrow = arrow.append_column(t.schema.field(0), t.column(0))
    return arrow_to_table(arrow, capacity=capacity, device=device,
                          held=held)
