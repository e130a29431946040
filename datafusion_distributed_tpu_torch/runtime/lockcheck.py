"""Opt-in runtime lock-order / race harness (``DFTPU_LOCK_CHECK=1``).

The static half of the concurrency model lives in
tools/check_concurrency.py: guarded-by declarations, lock discipline, and
a nested-acquisition graph built from ``with`` nesting and cross-class
calls. This module is the dynamic half — the instrumented witness that
the static graph matches reality under the suite's seeded chaos/churn
schedules:

- ``install()`` (called from the package ``__init__`` when
  ``DFTPU_LOCK_CHECK=1``) replaces ``threading.Lock``/``RLock``/
  ``Condition`` with factories that wrap locks CREATED BY THIS PACKAGE
  in instrumented proxies. Third-party locks (torch, grpc,
  concurrent.futures) pass through untouched — the harness watches the
  engine, not the interpreter.
- every instrumented lock is named after its creation site
  (``ClassName._attr`` — the same identity the static analyzer uses), and
  each thread keeps its acquisition stack.
- acquiring lock B while holding lock A records the observed edge A->B
  with the full acquisition stack. A NEW edge (absent from the static
  graph) is recorded, not an error — the merged artifact shows it. An
  edge that closes a CYCLE among observed edges is a hard error
  (`LockOrderViolation`) raised BEFORE blocking, carrying both sides'
  acquisition stacks — the harness reports the deadlock instead of
  hanging the suite on it.
- re-acquiring a non-reentrant ``Lock`` already held by the same thread
  raises `LockReentryError` immediately (the alternative is a silent
  permanent hang).
- releases record hold times; holds above ``DFTPU_LOCK_CHECK_HOLD_S``
  (default 0.25s) are kept as outliers, and ``note_blocking()`` hooks
  (the first-use build of a kernel library: ops/_build.py for the CUDA
  kernels, native/__init__.py for the host library) record
  ``lock_while_kernel_build`` events, a lock held across an nvcc or g++
  run.
- ``report()`` / the ``DFTPU_LOCK_CHECK_ARTIFACT=<path>`` atexit dump
  merge the observed graph with the static one (tools/
  check_concurrency.py run over this package's files, when the repo
  checkout is there): every edge is marked ``static`` (predicted) or
  ``new`` (observed only at runtime).

Port of the reference `runtime/lockcheck.py`: only locks whose creating
line lies in this package are instrumented. The threading factories it
keeps as the originals are those at its import, so one process installs
one package's harness.

Zero-dependency on purpose: this module imports only the stdlib, so the
package ``__init__`` can install it before any other submodule creates a
lock.
"""

from __future__ import annotations

import atexit
import linecache
import os
import re
import sys
import threading
import time
import traceback
import _thread

__all__ = [
    "LockOrderViolation",
    "LockReentryError",
    "enabled",
    "install",
    "note_blocking",
    "report",
    "reset",
    "wrap_lock",
]

#: package root (…/datafusion_distributed_tpu_torch) and repo root above it
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)

_HOLD_OUTLIER_S = float(os.environ.get("DFTPU_LOCK_CHECK_HOLD_S", "0.25"))
_MAX_OUTLIERS = 100
_MAX_EVENTS = 100
_STACK_LIMIT = 14

_orig_lock = threading.Lock
_orig_rlock = threading.RLock
_orig_condition = threading.Condition

_installed = False
#: registry guard: a RAW lock (never instrumented — the checker must not
#: watch itself)
_reg_lock = _thread.allocate_lock()
#: (src, dst) -> {"count", "stack", "thread", "t"}
_edges: dict = {}
#: src -> set(dst), the adjacency the cycle check walks
_adj: dict = {}
_outliers: list = []
_events: list = []
_tls = threading.local()


class LockOrderViolation(RuntimeError):
    """An acquisition closed a cycle among observed lock-order edges."""


class LockReentryError(RuntimeError):
    """A thread re-acquired a non-reentrant Lock it already holds."""


def enabled() -> bool:
    """Whether install() has patched the threading factories (the one
    predicate — hooks like note_blocking key off it)."""
    return _installed


# ---------------------------------------------------------------------------
# creation-site naming
# ---------------------------------------------------------------------------


_ASSIGN_RE = re.compile(r"(self\.)?([A-Za-z_]\w*)\s*(?::[^=]*)?=[^=]")


def _from_package(frame) -> bool:
    fn = frame.f_code.co_filename
    return fn.startswith(_PKG_DIR) and not fn.endswith("lockcheck.py")


def _dataclass_site(frame):
    """'ClassName.field' when ``frame`` is a dataclass-generated __init__
    of a package class mid-way through a field(default_factory=...) —
    the field being initialized is the first one (declaration order)
    whose local still holds the _HAS_DEFAULT_FACTORY sentinel. Covers
    TaskData.lock / ChaosCluster._proxy_lock, whose creation otherwise
    attributes to the instantiation call site and never joins the static
    graph."""
    if frame.f_code.co_name != "__init__":
        return None
    slf = frame.f_locals.get("self")
    if slf is None:
        return None
    cls = type(slf)
    fields = getattr(cls, "__dataclass_fields__", None)
    if fields is None or not getattr(
        cls, "__module__", ""
    ).startswith("datafusion_distributed_tpu_torch"):
        return None
    import dataclasses

    sentinel = getattr(dataclasses, "_HAS_DEFAULT_FACTORY", None)
    if sentinel is None:
        return None
    try:
        assigned = slf.__dict__
    except AttributeError:  # slots dataclass: fall back to call site
        return None
    for fname in fields:
        # the locals keep the sentinel even after their field assigned;
        # the field being initialized RIGHT NOW is the first (declaration
        # order) still missing from the instance
        if frame.f_locals.get(fname) is sentinel and fname not in assigned:
            return f"{cls.__name__}.{fname}"
    return None


def _caller_frame():
    """The IMMEDIATE creator frame when it belongs to this package (or
    is a package dataclass's generated __init__ running a
    field(default_factory=...)); (None, None) otherwise.
    -> (frame, dataclass_site_or_None).

    Deliberately NOT a walk up the stack: stdlib objects the package
    constructs (cf.Future conditions, queue.Queue mutexes, Thread
    events) create their locks one frame below a package frame, and
    instrumenting them would merge many distinct per-object locks under
    one package call-site name — a fabricated shared identity the cycle
    detector could weave into a spurious deadlock report. 'The engine's
    own locks' means locks whose creating line of code is the
    package's."""
    f = sys._getframe(2)
    if f is None:
        return None, None
    site = _dataclass_site(f)
    if site is not None:
        return f, site
    if _from_package(f):
        return f, None
    return None, None


def _frame_class(frame):
    slf = frame.f_locals.get("self")
    if slf is not None:
        return type(slf).__name__
    qual = frame.f_locals.get("__qualname__")
    if isinstance(qual, str):
        return qual.split(".")[-1]
    return None


def _site_name(frame) -> str:
    """'ClassName._attr' / 'rel/path.py:NAME' / 'rel/path.py:lineno' —
    chosen to line up with the static analyzer's lock identities so the
    merged graph joins cleanly."""
    rel = os.path.relpath(frame.f_code.co_filename, _REPO_ROOT).replace(
        os.sep, "/"
    )
    line = linecache.getline(frame.f_code.co_filename, frame.f_lineno)
    m = _ASSIGN_RE.search(line)
    attr = m.group(2) if m else None
    cls = _frame_class(frame)
    if attr and m.group(1) and cls:           # self._lock = ...
        return f"{cls}.{attr}"
    if attr and cls and not m.group(1):       # class-level attr
        return f"{cls}.{attr}"
    if attr and frame.f_code.co_name == "<module>":
        return f"{rel}:{attr}"
    return f"{rel}:{frame.f_lineno}"


# ---------------------------------------------------------------------------
# per-thread held-stack + edge/cycle machinery
# ---------------------------------------------------------------------------


class _Held:
    __slots__ = ("lock", "t0", "count")

    def __init__(self, lock) -> None:
        self.lock = lock
        self.t0 = time.monotonic()
        self.count = 1


def _held_stack() -> list:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


_THIS_FILE = f'File "{os.path.abspath(__file__)}"'


def _fmt_stack() -> str:
    frames = traceback.format_stack(limit=_STACK_LIMIT)
    # drop this module's frames at the tail — the user wants THEIR code
    # (matched by path: a caller's file may also end in lockcheck.py)
    return "".join(
        f for f in frames if _THIS_FILE not in f.split("\n")[0]
    )


def _reachable(src: str, dst: str) -> "list | None":
    """Path src->...->dst over observed edges, or None."""
    seen = {src}
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        for nxt in _adj.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _before_acquire(lock: "_InstrumentedLock") -> None:
    st = _held_stack()
    for h in st:
        if h.lock is lock and lock.kind == "lock":
            raise LockReentryError(
                f"thread {threading.current_thread().name!r} re-acquires "
                f"non-reentrant lock {lock.name} it already holds "
                "(DFTPU207 at runtime — this would deadlock)\n"
                "second acquisition at:\n" + _fmt_stack()
            )
    holders = [h for h in st if h.lock is not lock]
    if not holders:
        return
    src = holders[-1].lock.name
    dst = lock.name
    if src == dst:
        return
    # fast path: a known edge changes neither the graph nor its cycles
    # (any cycle is raised when its CLOSING edge is first observed), so
    # repeat traversals skip the stack capture and the reachability walk
    with _reg_lock:
        hit = _edges.get((src, dst))
        if hit is not None:
            hit["count"] += 1
            return
    my_stack = _fmt_stack()
    with _reg_lock:
        hit = _edges.get((src, dst))
        if hit is not None:  # raced another thread's first observation
            hit["count"] += 1
            return
        # would this NEW edge close a cycle among observed edges? check
        # BEFORE blocking so the harness reports instead of hanging.
        # A cycle-closing edge is NOT recorded: a recurring inversion
        # must re-enter this slow path and raise EVERY time, not sail
        # through the known-edge fast path into the real deadlock
        path = _reachable(dst, src)
        if path is None:
            _edges[(src, dst)] = {
                "count": 1,
                "stack": my_stack,
                "thread": threading.current_thread().name,
                "t": time.monotonic(),
            }
            _adj.setdefault(src, set()).add(dst)
        if path is not None:
            other = _edges.get((path[0], path[1]))
            other_stack = other["stack"] if other else "<unrecorded>"
            other_thread = other["thread"] if other else "?"
            raise LockOrderViolation(
                "lock-order cycle observed (deadlock): acquiring "
                f"{dst} while holding {src}, but the reverse order "
                f"{' -> '.join(path)} was already observed.\n"
                f"--- this acquisition ({src} -> {dst}, thread "
                f"{threading.current_thread().name!r}):\n{my_stack}"
                f"--- prior acquisition ({path[0]} -> {path[1]}, thread "
                f"{other_thread!r}):\n{other_stack}"
            )


def _after_acquire(lock) -> None:
    st = _held_stack()
    for h in st:
        if h.lock is lock:   # reentrant re-acquire: bump, no new frame
            h.count += 1
            return
    st.append(_Held(lock))


def _after_release(lock) -> None:
    st = _held_stack()
    for i in range(len(st) - 1, -1, -1):
        h = st[i]
        if h.lock is lock:
            h.count -= 1
            if h.count <= 0:
                st.pop(i)
                dt = time.monotonic() - h.t0
                if dt >= _HOLD_OUTLIER_S:
                    with _reg_lock:
                        if len(_outliers) < _MAX_OUTLIERS:
                            _outliers.append({
                                "lock": lock.name,
                                "held_s": round(dt, 4),
                                "thread":
                                    threading.current_thread().name,
                                "released_at": _fmt_stack(),
                            })
            return


def note_blocking(what: str) -> None:
    """Record that a known-blocking operation (a kernel library's
    first-use build) started while this thread holds instrumented locks.
    Cheap no-op when the harness is not installed."""
    if not _installed:
        return
    held = [h.lock.name for h in _held_stack()]
    if not held:
        return
    with _reg_lock:
        if len(_events) < _MAX_EVENTS:
            _events.append({
                "kind": f"lock_while_{what}",
                "locks_held": held,
                "thread": threading.current_thread().name,
                "stack": _fmt_stack(),
            })


# ---------------------------------------------------------------------------
# instrumented lock types
# ---------------------------------------------------------------------------


class _InstrumentedLock:
    kind = "lock"

    def __init__(self, inner, name: str) -> None:
        self._inner = inner
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            _before_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _after_acquire(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        _after_release(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<lockcheck {self.kind} {self.name} at {id(self):#x}>"


class _InstrumentedRLock(_InstrumentedLock):
    kind = "rlock"

    # Condition(RLock) integration: these keep cv.wait()'s release window
    # visible to the held-stack (a Condition falls back to plain
    # acquire/release only for locks WITHOUT these methods)
    def _release_save(self):
        state = self._inner._release_save()
        st = _held_stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i].lock is self:
                st.pop(i)
                break
        return state

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        _after_acquire(self)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def wrap_lock(inner=None, name: str = "", kind: str = "lock"):
    """Directly wrap a lock (tests use this without installing the global
    factories)."""
    if inner is None:
        inner = _orig_lock() if kind == "lock" else _orig_rlock()
    cls = _InstrumentedLock if kind == "lock" else _InstrumentedRLock
    return cls(inner, name or f"<anon-{kind}-{id(inner):#x}>")


# ---------------------------------------------------------------------------
# factories (installed over threading.*)
# ---------------------------------------------------------------------------


def _lock_factory():
    frame, dc_site = _caller_frame()
    if frame is None:
        return _orig_lock()
    return _InstrumentedLock(_orig_lock(), dc_site or _site_name(frame))


def _rlock_factory():
    frame, dc_site = _caller_frame()
    if frame is None:
        return _orig_rlock()
    return _InstrumentedRLock(_orig_rlock(), dc_site or _site_name(frame))


def _condition_factory(lock=None):
    if lock is not None:
        # an instrumented (or foreign) lock passed explicitly: the real
        # Condition drives it through acquire/release/_release_save,
        # which the wrapper already tracks
        return _orig_condition(lock)
    frame, dc_site = _caller_frame()
    if frame is None:
        return _orig_condition()
    return _orig_condition(
        _InstrumentedRLock(_orig_rlock(), dc_site or _site_name(frame))
    )


def install() -> bool:
    """Install the instrumented factories (idempotent); -> whether the
    harness is now active. Called from the package __init__ under
    ``DFTPU_LOCK_CHECK=1`` — BEFORE any submodule creates a lock, so
    module-level and class-level locks are wrapped too."""
    global _installed
    if _installed:
        return True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    _installed = True
    artifact = os.environ.get("DFTPU_LOCK_CHECK_ARTIFACT")
    if artifact:
        atexit.register(_dump_artifact, artifact)
    return True


def reset() -> None:
    """Clear observed state (tests)."""
    with _reg_lock:
        _edges.clear()
        _adj.clear()
        del _outliers[:]
        del _events[:]


# ---------------------------------------------------------------------------
# reporting: observed graph merged with the static one
# ---------------------------------------------------------------------------


def _package_files() -> list:
    """Every .py file of this package, the static graph's input."""
    out = []
    for root, dirs, files in os.walk(_PKG_DIR):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        out.extend(os.path.join(root, f) for f in sorted(files)
                   if f.endswith(".py"))
    return out


def _static_edges() -> "set | None":
    """(src, dst) set from tools/check_concurrency.py over this package's
    files, or None when the tool is unavailable (installed package without
    the repo checkout). Without ``files`` the tool would scan the
    reference package."""
    tool = os.path.join(_REPO_ROOT, "tools", "check_concurrency.py")
    if not os.path.exists(tool):
        return None
    try:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "_dftpu_check_concurrency", tool
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return set(mod.build_lock_graph(files=_package_files()))
    except Exception:
        return None


def report(include_static: bool = True) -> dict:
    """Merged observed-vs-static view: every observed edge marked
    ``static`` (predicted by the analyzer) or ``new``, plus hold-time
    outliers and blocking events."""
    static = _static_edges() if include_static else None
    with _reg_lock:
        edges = [
            {
                "src": s,
                "dst": d,
                "count": meta["count"],
                "thread": meta["thread"],
                "status": (
                    "unknown" if static is None
                    else ("static" if (s, d) in static else "new")
                ),
            }
            for (s, d), meta in sorted(_edges.items())
        ]
        out = {
            "installed": _installed,
            "observed_edges": edges,
            "static_edges": (
                sorted([list(e) for e in static])
                if static is not None else None
            ),
            "hold_outliers": list(_outliers),
            "events": list(_events),
        }
    return out


def _dump_artifact(path: str) -> None:
    import json

    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(report(), f, indent=2)
    except OSError:
        pass  # artifact write must never fail the exiting process
