"""Planner-side adaptivity hooks (port of the planner's part of the
reference `runtime/adaptivity.py`).

The distributed planner notes here what it decided: joins fused into
multiway stages, the shuffles that fusion deleted, and aggregates planned
as one global hash table. Each note adds to a process-wide counter of the
reference's name. The reference also logs an event and exports the
counters through its telemetry registry; both come with the runtime tiers
(ROADMAP A.5). Counters are process-wide: read them as deltas.
"""

from __future__ import annotations

import threading

__all__ = [
    "counter",
    "note_multiway_fusion",
    "note_global_agg_selected",
]

_COUNTERS = {
    "dftpu_joins_fused": 0,
    "dftpu_exchanges_deleted": 0,
    "dftpu_global_agg_selected": 0,
}
_LOCK = threading.Lock()


def _count(name: str, amount: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] += int(amount)


def counter(name: str) -> int:
    """The current value of one of the planner's counters."""
    with _LOCK:
        return _COUNTERS[name]


def note_multiway_fusion(joins_fused: int, exchanges_deleted: int) -> None:
    """A fusion pass collapsed ``joins_fused`` binary joins into multiway
    stages and deleted ``exchanges_deleted`` intermediate shuffles."""
    _count("dftpu_joins_fused", joins_fused)
    _count("dftpu_exchanges_deleted", exchanges_deleted)


def note_global_agg_selected() -> None:
    """An aggregate was planned as one shared global hash table instead of
    partial + merge (sampled NDV too high for partial states to shrink)."""
    _count("dftpu_global_agg_selected")
