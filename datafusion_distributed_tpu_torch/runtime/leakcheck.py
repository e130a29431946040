"""Opt-in runtime resource-leak harness (``DFTPU_LEAK_CHECK=1``).

The static half of the resource model lives in
tools/check_resource_lifecycle.py: declared acquire/release lifecycles
(``# acquires: <kind>`` / ``# releases: <kind>``), path-sensitive
DFTPU301–307 discipline rules, and per-query growth annotations. This
module is the dynamic half — the instrumented witness that the declared
model matches reality under the suite's seeded chaos/churn/hedging
schedules:

- ``install()`` (called from the package ``__init__`` when
  ``DFTPU_LEAK_CHECK=1``, mirroring lockcheck) arms cheap explicit
  hooks embedded at every tracked acquisition/release point:
  TableStore entry insert/release (kind ``store-entry``, attributed to
  the owning query), SpillManager slot create/release (``spill-slot``),
  shm segment-pool token create/drop (``shm-segment``), PartitionFeed
  puller thread start/exit (``stream-puller``), and CheckpointStore
  stage save/drop (``checkpoint-slice``). When the harness is not
  installed every hook is a two-instruction no-op.
- every live resource keeps its creation-site tag: kind, key, owning
  query id (when the acquiring surface runs under
  ``staging_attribution``/a task key), and the acquisition stack.
- ``sweep_query(qid)`` — called from ``Coordinator.sweep_query`` at
  query end — flags every still-live resource attributed to that query
  as a leak: counted into ``dftpu_leaked_resources{kind}`` telemetry,
  recorded with its acquisition stack, and (under
  ``DFTPU_LEAK_CHECK=strict``) raised as `ResourceLeakError`.
- ``assert_clean()`` is the test-facing gate: zero live tracked
  resources (catalog tables and other process-lifetime entries are
  acquired OUTSIDE the harness's attribution and excluded via
  ``exclude_unattributed=True`` where a test only cares about
  query-scoped state).
- ``report()`` / the ``DFTPU_LEAK_CHECK_ARTIFACT=<path>`` atexit dump
  merge the observed live/leaked sets with the DECLARED static model
  (loaded from tools/check_resource_lifecycle.py when available), the
  same merged-artifact shape lockcheck uses for lock edges.

Zero-dependency on purpose: stdlib only, so the package ``__init__``
can install it before any other submodule import.
"""

from __future__ import annotations

import atexit
import os
import threading
import traceback
import _thread

__all__ = [
    "ResourceLeakError",
    "assert_clean",
    "enabled",
    "install",
    "leaks",
    "live",
    "note_acquire",
    "note_release",
    "note_transfer",
    "report",
    "reset",
    "strict",
    "sweep_query",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)

_STACK_LIMIT = 14
_MAX_LEAK_RECORDS = 200

_installed = False
_strict = False
#: raw lock (never instrumented — the lock harness wraps package locks,
#: and the leak harness must not recurse into it)
_lock = _thread.allocate_lock()
_live: dict = {}  # (kind, key) -> record dict
_leaks: list = []  # flagged survivor records (bounded)
_counts: dict = {}  # kind -> acquired/released/leaked totals
_unmatched_releases = 0
_seq = 0


class ResourceLeakError(RuntimeError):
    """Tracked resources survived query end under strict mode; carries
    the survivor records (kind, key, query id, acquisition stack)."""

    def __init__(self, message: str, records: list):
        super().__init__(message)
        self.records = records


def enabled() -> bool:
    return _installed


def strict() -> bool:
    return _strict


def install() -> None:
    """Arm the harness (idempotent). ``DFTPU_LEAK_CHECK=strict`` makes
    query-end survivors raise instead of only being counted."""
    global _installed, _strict
    if _installed:
        return
    _installed = True
    _strict = os.environ.get("DFTPU_LEAK_CHECK", "").lower() == "strict"
    artifact = os.environ.get("DFTPU_LEAK_CHECK_ARTIFACT")
    if artifact:
        atexit.register(_dump_artifact, artifact)


def reset() -> None:
    """Drop all tracked state (tests)."""
    global _unmatched_releases
    with _lock:
        _live.clear()
        del _leaks[:]
        _counts.clear()
        _unmatched_releases = 0


def _stack() -> list:
    # drop the two harness frames (note_acquire + _stack)
    return traceback.format_list(
        traceback.extract_stack(limit=_STACK_LIMIT)[:-2]
    )


def _bump(kind: str, field: str, n: int = 1) -> None:
    c = _counts.setdefault(
        kind, {"acquired": 0, "released": 0, "leaked": 0}
    )
    c[field] += n


def note_acquire(kind: str, key, query_id=None, tag=None) -> None:
    """A tracked resource came alive. ``key`` must be hashable and
    unique among live resources of ``kind``; ``query_id`` attributes it
    to a query sweep; ``tag`` is a free-form creation-site label."""
    if not _installed:
        return
    rec = {
        "kind": kind,
        "key": key,
        "query_id": query_id,
        "tag": tag,
        "thread": threading.current_thread().name,
        "stack": _stack(),
    }
    with _lock:
        global _seq
        _seq += 1
        rec["seq"] = _seq
        _live[(kind, key)] = rec
        _bump(kind, "acquired")


def note_release(kind: str, key) -> None:
    """A tracked resource was released (idempotent: unmatched releases
    are counted, not errors — release paths are deliberately
    re-entrant)."""
    if not _installed:
        return
    global _unmatched_releases
    with _lock:
        if _live.pop((kind, key), None) is None:
            _unmatched_releases += 1
        else:
            _bump(kind, "released")


def note_transfer(kind: str, key, query_id=None) -> None:
    """Ownership moved (e.g. a handle was parked in a structure owned by
    another query, or detached to process lifetime with
    ``query_id=None``): re-attribute without re-stacking."""
    if not _installed:
        return
    with _lock:
        rec = _live.get((kind, key))
        if rec is not None:
            rec["query_id"] = query_id


def sweep_query(query_id) -> list:
    """Query end: every live resource attributed to ``query_id`` is a
    leak. -> the flagged records (also kept in ``leaks()``, counted into
    ``dftpu_leaked_resources{kind}``; raises under strict mode)."""
    if not _installed or query_id is None:
        return []
    with _lock:
        flagged = [
            rec for (kind, key), rec in _live.items()
            if rec.get("query_id") == query_id
        ]
        for rec in flagged:
            _live.pop((rec["kind"], rec["key"]), None)
            rec["leaked_at"] = f"sweep_query({query_id})"
            _bump(rec["kind"], "leaked")
            if len(_leaks) < _MAX_LEAK_RECORDS:
                _leaks.append(rec)
    if flagged:
        _emit_telemetry(flagged)
        if _strict:
            raise ResourceLeakError(
                f"{len(flagged)} resource(s) survived query end for "
                f"query {query_id}: "
                + ", ".join(
                    f"{r['kind']}:{r['key']!r}" for r in flagged[:5]
                ),
                flagged,
            )
    return flagged


def _emit_telemetry(flagged: list) -> None:
    """Best-effort ``dftpu_leaked_resources{kind}`` counters + a
    structured event — leak OBSERVABILITY must never fail the query."""
    per_kind: dict = {}
    for rec in flagged:
        per_kind[rec["kind"]] = per_kind.get(rec["kind"], 0) + 1
    try:
        from datafusion_distributed_tpu_torch.runtime.telemetry import (
            DEFAULT_REGISTRY,
        )

        c = DEFAULT_REGISTRY.counter(
            "dftpu_leaked_resources",
            "Tracked resources still live when their owning query ended "
            "(DFTPU_LEAK_CHECK harness).",
            labels=("kind",),
        )
        for kind, n in per_kind.items():
            c.inc(n, kind=kind)
    except Exception:
        pass
    try:
        from datafusion_distributed_tpu_torch.runtime.eventlog import log_event

        log_event("resources_leaked", **per_kind)
    except Exception:
        pass


def live(query_id=None, kind=None) -> list:
    """Snapshot of live tracked resources, optionally filtered."""
    with _lock:
        return [
            dict(rec) for rec in _live.values()
            if (query_id is None or rec.get("query_id") == query_id)
            and (kind is None or rec["kind"] == kind)
        ]


def leaks() -> list:
    """Records flagged by past sweeps (bounded)."""
    with _lock:
        return [dict(r) for r in _leaks]


def assert_clean(exclude_unattributed: bool = False) -> None:
    """Raise `ResourceLeakError` if any tracked resource is live (the
    test-facing zero-leak gate). ``exclude_unattributed=True`` ignores
    process-lifetime resources acquired without a query attribution
    (catalog tables, recovery checkpoints)."""
    with _lock:
        survivors = [
            dict(rec) for rec in _live.values()
            if not (exclude_unattributed and rec.get("query_id") is None)
        ]
    if survivors:
        lines = [
            f"  {r['kind']}:{r['key']!r} (query={r['query_id']}, "
            f"tag={r['tag']})"
            for r in survivors[:10]
        ]
        raise ResourceLeakError(
            f"{len(survivors)} tracked resource(s) still live:\n"
            + "\n".join(lines),
            survivors,
        )


def _static_model():
    """The DECLARED model from tools/check_resource_lifecycle.py, or
    None outside a repo checkout — same importlib-spec loading seam
    lockcheck uses for the static lock graph."""
    path = os.path.join(_REPO_ROOT, "tools",
                        "check_resource_lifecycle.py")
    if not os.path.exists(path):
        return None
    try:
        import importlib.util
        import sys

        spec = importlib.util.spec_from_file_location(
            "_dftpu_resource_lint", path
        )
        mod = importlib.util.module_from_spec(spec)
        # dataclass creation inside the tool resolves its defining
        # module through sys.modules — register before exec
        sys.modules["_dftpu_resource_lint"] = mod
        try:
            spec.loader.exec_module(mod)
            return mod.declared_model_json()
        finally:
            sys.modules.pop("_dftpu_resource_lint", None)
    except Exception:
        return None


def report(include_static: bool = True) -> dict:
    """Merged observed-vs-declared view: live resources, flagged leaks,
    per-kind totals, and the static model's declared lifecycles."""
    with _lock:
        out = {
            "installed": _installed,
            "strict": _strict,
            "live": [dict(r) for r in _live.values()],
            "leaks": [dict(r) for r in _leaks],
            "counts": {k: dict(v) for k, v in _counts.items()},
            "unmatched_releases": _unmatched_releases,
        }
    if include_static:
        out["declared_model"] = _static_model()
    return out


def _dump_artifact(path: str) -> None:
    import json

    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(report(), f, indent=2)
    except OSError:
        pass  # artifact write must never fail the exiting process
