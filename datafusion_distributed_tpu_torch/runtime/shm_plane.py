"""Cross-process shared-memory segment pool for the co-located data plane.

The reference exchanges Arrow batches between workers over Arrow Flight
even when producer and consumer share a host; Zerrow (PAPERS.md) shows
the shape this module implements instead: co-located processes exchange
buffers BY REFERENCE through named segments, so a same-host hop costs
one encode + one read instead of encode -> gRPC frame -> decode with the
payload on the wire.

Port of the reference `runtime/shm_plane.py`. Segments hold Arrow IPC
bytes in host memory, as there: a producer on the card copies its chunk's
live rows to the host once to encode them, and the consumer decodes onto
its own device. No device memory is shared between processes.

Segments are plain files under the pool root: ``DFTPU_SHM_DIR`` when set
(point it at a tmpfs, such as ``/dev/shm``, for memory-backed segments),
else the process's temp directory. They are framed EXACTLY like the spill
files (runtime/spill.py):

    magic b"DFSP" | u32 version | u32 capacity | u64 payload length |
    Arrow IPC stream payload (runtime/codec.encode_table)

Sharing the frame is the composition contract: a spilled entry IS a
valid segment, so `publish_file` serves a spill file by hardlink
without a decode/re-encode round trip, and a consumer refaults either
through the same `decode_table(capacity=...)` path. The frame is the
reference's too, so a segment published by either package opens in the
other.

Cross-process refcounts live on the filesystem, not in any process:
each segment ``<name>.seg`` has a sidecar ``<name>.refs/`` directory
holding one token file per outstanding reference. `publish` creates the
segment with one token (transferred to the consumer inside the S-frame
of the transfer stream); `acquire` adds a token for an additional
reader; `release` unlinks a specific token and, at zero tokens, unlinks
the segment — whichever process drops the last reference reclaims it,
exactly the TableStore's refcounted-release discipline one level down.

Failure classification: a torn/vanished segment raises `SegmentError`.
The transfer client then marks the shm plane broken for that connection
and the pull is retried over the wire path — the same bytes, one retry.

Locking contract: the pool lock guards only the in-process
counters/bookkeeping; `publish` / `publish_file` / `open_segment` are
blocking calls — segment I/O never runs under the pool lock (the
spill-manager shape: decide locked, do I/O unlocked, account locked).
"""

from __future__ import annotations

import os
import shutil
import socket
import tempfile
import threading
import uuid
from struct import error as _struct_error
from typing import Optional

from datafusion_distributed_tpu_torch.runtime import leakcheck as _leakcheck
from datafusion_distributed_tpu_torch.runtime.spill import (
    _HEADER,
    _MAGIC,
    _VERSION,
)

#: env override for the pool root (tests point it at a tmpdir; a
#: deployment points it at any shared tmpfs)
SHM_DIR_ENV = "DFTPU_SHM_DIR"


class SegmentError(RuntimeError):
    """A segment is torn, missing, or unreadable. The pull that read it
    is retried over the wire path."""


def _default_root() -> str:
    return os.environ.get(SHM_DIR_ENV) or tempfile.gettempdir()


# -- directory-addressed segment access (consumer side) ----------------------
# A consumer reads segments out of the PRODUCER's pool directory (the
# S-frame carries {dir, seg, token}), so the read/refcount half works on
# any (dir, name) pair — no pool instance required on the reading side.


def open_segment_at(d: str, name: str) -> tuple[bytes, int]:
    """Read the segment ``name`` in pool directory ``d``; -> (Arrow IPC
    payload, capacity). Raises `SegmentError` on a missing or torn
    segment. BLOCKING (file read); never call under a lock."""
    path = os.path.join(d, f"{name}.seg")
    try:
        with open(path, "rb") as f:
            head = f.read(_HEADER.size)
            if len(head) != _HEADER.size:
                raise SegmentError(f"torn segment header {name}")
            magic, version, cap, plen = _HEADER.unpack(head)
            if magic != _MAGIC or version != _VERSION:
                raise SegmentError(f"bad segment frame {name}")
            payload = f.read(plen)
            if len(payload) != plen:
                raise SegmentError(f"torn segment payload {name}")
    except OSError as e:
        raise SegmentError(f"segment {name} unreadable: {e}") from e
    return payload, cap


def acquire_at(d: str, name: str) -> str:  # acquires: shm-segment
    """Add a reference to a live segment (broadcast fan-out); -> the new
    token. Only valid while an existing reference is held."""
    if not os.path.exists(os.path.join(d, f"{name}.seg")):
        raise SegmentError(f"segment {name} is gone")
    token = uuid.uuid4().hex
    refs = os.path.join(d, f"{name}.refs")
    os.makedirs(refs, exist_ok=True)
    with open(os.path.join(refs, token), "wb"):
        pass
    if _leakcheck.enabled():
        _leakcheck.note_acquire("shm-segment", (name, token),
                                tag="acquire_at")
    return token


def release_at(d: str, name: str, token: str) -> None:  # releases: shm-segment
    """Drop one reference; the LAST release unlinks the segment.
    Idempotent per token and safe on an already-torn segment (the
    `segment_lost` path releases what it failed to read)."""
    if _leakcheck.enabled():
        _leakcheck.note_release("shm-segment", (name, token))
    refs = os.path.join(d, f"{name}.refs")
    try:
        os.unlink(os.path.join(refs, token))
    except OSError:
        pass  # token already dropped (double release)
    try:
        remaining = os.listdir(refs)
    except OSError:
        remaining = None  # refs dir already reclaimed
    if not remaining:
        try:
            os.unlink(os.path.join(d, f"{name}.seg"))
        except OSError:
            pass
        try:
            os.rmdir(refs)
        except OSError:
            pass


class SegmentPool:
    """Owns one segment directory (lazily created under the pool root)
    and its publish/acquire/release lifecycle. Thread-safe: concurrent
    publishes from stream-serving threads touch disjoint files; only the
    counters share the lock."""

    def __init__(self, root: Optional[str] = None):
        self._root = root
        self._dir: Optional[str] = None  # guarded-by: _lock
        self._lock = threading.Lock()
        self.published = 0  # guarded-by: _lock
        self.published_bytes = 0  # guarded-by: _lock
        self.opened = 0  # guarded-by: _lock
        self.opened_bytes = 0  # guarded-by: _lock
        self.linked = 0  # guarded-by: _lock
        self.lost = 0  # guarded-by: _lock

    def _ensure_dir(self) -> str:
        with self._lock:
            if self._dir is None:
                self._dir = tempfile.mkdtemp(
                    prefix="dftpu-seg-", dir=self._root or _default_root()
                )
            return self._dir

    # -- host classification -------------------------------------------------
    def descriptor(self) -> dict:
        """The pool's identity a client ships in a transfer request so
        the server can classify the hop: same hostname AND a reachable
        pool directory => co-located, serve segments; anything else =>
        remote, serve wire frames."""
        return {"host": socket.gethostname(), "dir": self._ensure_dir()}

    @staticmethod
    def same_host(desc: Optional[dict]) -> bool:
        """Whether ``desc`` (a peer's `descriptor()`) names THIS host —
        the remote/co-located hop classification. When the descriptor
        carries a pool directory it must also be reachable from here.
        Conservative on any doubt: a misclassified-remote hop only costs
        wire bytes, a misclassified-local one fails its read with
        `SegmentError` and is retried over the wire."""
        if not isinstance(desc, dict):
            return False
        try:
            if desc.get("host") != socket.gethostname():
                return False
            d = desc.get("dir")
            return True if d is None else os.path.isdir(d)
        except OSError:
            return False

    # -- blocking I/O entry points (never call under a lock) -----------------
    def publish(self, payload, capacity: int = 0) -> tuple[str, str]:  # acquires: shm-segment
        """Write an `encode_table` payload as a named segment with ONE
        reference token; -> (name, token). The token transfers to the
        consumer (ride it in the S-frame); whoever holds it releases.
        BLOCKING (file write)."""
        d = self._ensure_dir()
        name = uuid.uuid4().hex
        tmp = os.path.join(d, f"{name}.tmp")
        try:
            with open(tmp, "wb") as f:
                f.write(_HEADER.pack(_MAGIC, _VERSION, int(capacity),
                                     len(payload)))
                f.write(payload)
            token = self._add_ref(name)
            # rename AFTER the token exists: a name is never visible
            # without a reference holding it alive
            os.rename(tmp, os.path.join(d, f"{name}.seg"))
        except OSError as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise SegmentError(f"segment publish failed: {e}") from e
        with self._lock:
            self.published += 1
            self.published_bytes += len(payload)
        return name, token

    def publish_file(self, path: str) -> tuple[str, str]:  # acquires: shm-segment
        """Serve an existing DFSP-framed file (a SpillManager slot) as a
        segment WITHOUT decoding it: hardlink into the pool (same
        filesystem), byte copy across filesystems. -> (name, token).
        BLOCKING (link/copy + header read)."""
        d = self._ensure_dir()
        name = uuid.uuid4().hex
        seg = os.path.join(d, f"{name}.seg")
        try:
            with open(path, "rb") as f:
                magic, version, _cap, _plen = _HEADER.unpack(
                    f.read(_HEADER.size)
                )
            if magic != _MAGIC or version != _VERSION:
                raise SegmentError(f"{path} is not a DFSP-framed file")
            token = self._add_ref(name)
            try:
                os.link(path, seg)
                linked = True
            except OSError:
                shutil.copyfile(path, seg)
                linked = False
        except (OSError, _struct_error) as e:
            self._drop_ref_files(name)
            raise SegmentError(f"segment link failed: {e}") from e
        with self._lock:
            self.published += 1
            if linked:
                self.linked += 1
        return name, token

    def open_segment(self, name: str) -> tuple[bytes, int]:
        """Read a segment's Arrow IPC payload; -> (payload, capacity).
        The caller still holds its reference — read then `release`.
        Raises `SegmentError` on a missing or torn segment. BLOCKING
        (file read)."""
        try:
            payload, cap = open_segment_at(self._ensure_dir(), name)
        except SegmentError:
            with self._lock:
                self.lost += 1
            raise
        with self._lock:
            self.opened += 1
            self.opened_bytes += len(payload)
        return payload, cap

    # -- cross-process refcounts ---------------------------------------------
    def _add_ref(self, name: str) -> str:
        token = uuid.uuid4().hex
        refs = os.path.join(self._ensure_dir(), f"{name}.refs")
        os.makedirs(refs, exist_ok=True)
        with open(os.path.join(refs, token), "wb"):
            pass
        if _leakcheck.enabled():
            _leakcheck.note_acquire("shm-segment", (name, token),
                                    tag="SegmentPool.publish")
        return token

    def acquire(self, name: str) -> str:  # acquires: shm-segment
        """Add a reference for an additional reader (broadcast fan-out);
        -> the new token. Only valid while holding an existing
        reference — acquire-after-last-release is a protocol error."""
        return acquire_at(self._ensure_dir(), name)

    def release(self, name: str, token: str) -> None:  # releases: shm-segment
        """Drop one reference; the LAST release unlinks the segment."""
        release_at(self._ensure_dir(), name, token)

    def _drop_ref_files(self, name: str) -> None:
        refs = os.path.join(self._ensure_dir(), f"{name}.refs")
        try:
            for t in os.listdir(refs):
                if _leakcheck.enabled():
                    _leakcheck.note_release("shm-segment", (name, t))
                try:
                    os.unlink(os.path.join(refs, t))
                except OSError:
                    pass
            os.rmdir(refs)
        except OSError:
            pass

    # -- observability / lifecycle -------------------------------------------
    def live_segments(self) -> int:
        """Segments currently in the pool DIRECTORY (filesystem is the
        cross-process ground truth, not this instance's counters) — the
        zero-leak gate reads 0 here once every stream drained."""
        with self._lock:
            d = self._dir
        if d is None:
            return 0
        try:
            return sum(1 for n in os.listdir(d) if n.endswith(".seg"))
        except OSError:
            return 0

    def stats(self) -> dict:
        with self._lock:
            out = {
                "published": self.published,
                "published_bytes": self.published_bytes,
                "opened": self.opened,
                "opened_bytes": self.opened_bytes,
                "linked": self.linked,
                "lost": self.lost,
            }
        out["live_segments"] = self.live_segments()
        return out

    def shutdown(self) -> None:
        """Reclaim the pool directory (process teardown / test cleanup):
        the backstop for references a dead consumer never released."""
        with self._lock:
            d, self._dir = self._dir, None
        if d is None:
            return
        if _leakcheck.enabled():
            # the rmtree reclaims every surviving token file wholesale
            try:
                for refs in os.listdir(d):
                    if not refs.endswith(".refs"):
                        continue
                    name = refs[: -len(".refs")]
                    for t in os.listdir(os.path.join(d, refs)):
                        _leakcheck.note_release("shm-segment", (name, t))
            except OSError:
                pass
        shutil.rmtree(d, ignore_errors=True)
