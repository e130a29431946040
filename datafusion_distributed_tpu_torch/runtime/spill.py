"""Host-disk spill segment for the enforced worker memory budget.

Port of the reference `runtime/spill.py`. The TableStore is the single
byte-accounted owner of every staged buffer, so enforcement and spill
happen BY ENTRY: when a worker's staged bytes exceed
`distributed.worker_memory_budget_bytes`, the store spills its coldest
unreferenced owned entries into this segment and refaults them
transparently on `get`.

This is the one path of the runtime that copies table bytes to the host on
purpose: a spill moves an entry's live rows off the device (Arrow IPC, as
`codec.encode_table` writes it) into a host file, and frees the device
buffers; a refault copies them back onto the device the entry was spilled
from, never onto another one.

File format ("encode_table-framed", the reference's): one file per
spilled entry —

    magic b"DFSP" | u32 version | u32 capacity | u64 payload length |
    Arrow IPC stream payload (runtime/codec.encode_table)

The capacity rides the frame so a refaulted Table rebuilds with the EXACT
padded capacity of the original (decode_table(capacity=...)). Live values
round-trip byte-exactly through the Arrow IPC payload (-0.0 and NaN
included), the null masks and the dictionaries too; rows past `num_rows`
and the values under a null, undefined by the Table contract, come back
zeroed. Columns that had no null mask get none back.

Locking contract: `write_spill` and `read_spill` are blocking calls — file
I/O on a spill segment never runs under a store lock. The TableStore picks
victims under its lock, releases it, does the I/O here, then re-acquires
to swap the entry.

Zero-leak contract: every `SpillSlot` is released exactly once (entry
release, refault completion, or a raced re-insert); `live_files()` /
`stats()["spill_files"]` read 0 once a store is drained.
"""

from __future__ import annotations

import os
import struct
import tempfile
import threading
import uuid
from typing import Optional

from datafusion_distributed_tpu_torch.runtime import leakcheck as _leakcheck

_MAGIC = b"DFSP"
_VERSION = 1
_HEADER = struct.Struct(">4sIIQ")  # magic, version, capacity, payload len


class SpillError(RuntimeError):
    """A spill write/read failed (disk full, torn frame, vanished file).
    Callers degrade: a failed WRITE leaves the entry resident (budget
    unenforced, never data loss); a failed READ of a live slot is a real
    error — the bytes exist nowhere else."""


class SpillSlot:
    """One spilled entry's on-disk location + restore metadata.

    ``dict_cols`` retains the original columns' `Dictionary` OBJECTS
    (host-side, small by design — only codes are device data): a refault
    remaps the decoded codes back into the ORIGINAL dictionary's code
    space and rebinds the original object, so codes stay comparable
    across exchange boundaries with tables that never spilled.
    ``device`` is where the entry lived and where it refaults;
    ``no_validity`` names the columns that had no null mask."""

    __slots__ = ("path", "nbytes", "file_bytes", "capacity", "released",
                 "dict_cols", "device", "no_validity")

    def __init__(self, path: str, nbytes: int, file_bytes: int,
                 capacity: int, dict_cols: Optional[dict] = None,
                 device=None, no_validity=()):
        self.path = path
        self.nbytes = int(nbytes)       # logical (accounted) bytes
        self.file_bytes = int(file_bytes)
        self.capacity = int(capacity)
        self.released = False
        self.dict_cols = dict_cols or {}
        self.device = device
        self.no_validity = frozenset(no_validity)


def _rebind_dictionaries(table, dict_cols: dict, no_validity=frozenset()):
    """Restore the ORIGINAL Dictionary objects on a refaulted table (and
    drop the all-true null masks the decode gave columns that had none).

    The wire decode built fresh (GC'd, re-sorted) dictionaries; left that
    way, a refaulted table's codes would live in a DIFFERENT code space
    from sibling tables that never spilled. Each decoded code is remapped
    through a values lookup table back into the original dictionary's
    code space, on the table's device; a value missing from the original
    dictionary (impossible for a faithful round trip) aborts the rebind for
    that column and keeps the decoded fallback — values stay correct
    either way."""
    if not dict_cols and not no_validity:
        return table
    import numpy as np
    import torch

    from datafusion_distributed_tpu_torch.ops.table import Column, Table

    new_cols = []
    changed = False
    for name, col in zip(table.names, table.columns):
        if name in no_validity and col.validity is not None:
            col = Column(col.data, None, col.dtype, col.dictionary)
            changed = True
        orig = dict_cols.get(name)
        decoded = getattr(col, "dictionary", None)
        if orig is None or decoded is None or decoded is orig:
            new_cols.append(col)
            continue
        index = orig.index()  # value -> original code
        lut = np.empty(len(decoded.values), dtype=np.int32)
        ok = True
        for i, v in enumerate(decoded.values):
            code = index.get(v)
            if code is None:
                ok = False
                break
            lut[i] = code
        if not ok:
            new_cols.append(col)
            continue
        codes = col.data
        if len(lut):
            lut_t = torch.from_numpy(lut).to(codes.device)
            inside = (codes >= 0) & (codes < len(lut))
            remapped = torch.where(
                inside, lut_t[codes.clamp(0, len(lut) - 1).long()], codes
            ).to(torch.int32)
        else:
            remapped = codes
        new_cols.append(Column(remapped, col.validity, col.dtype, orig))
        changed = True
    if not changed:
        return table
    return Table(table.names, tuple(new_cols), table.num_rows)


class SpillManager:
    """Owns one spill directory (lazily created under the system temp
    dir, or ``root`` when given) and its slot lifecycle. Thread-safe:
    concurrent spills/refaults from stage fan-out threads touch disjoint
    files; only the counters share the lock."""

    def __init__(self, root: Optional[str] = None):
        self._root = root
        self._dir: Optional[str] = None
        self._lock = threading.Lock()
        self._live: set = set()  # guarded-by: _lock
        self.spills = 0  # guarded-by: _lock
        self.spill_bytes = 0  # guarded-by: _lock
        self.refaults = 0  # guarded-by: _lock
        self.refault_bytes = 0  # guarded-by: _lock

    def _ensure_dir(self) -> str:
        with self._lock:
            if self._dir is None:
                self._dir = self._root or tempfile.mkdtemp(
                    prefix="dftpu-spill-"
                )
                os.makedirs(self._dir, exist_ok=True)
            return self._dir

    # -- blocking I/O entry points (never call under a store lock) ----------
    def write_spill(self, table, nbytes: int) -> SpillSlot:  # acquires: spill-slot
        """Encode ``table`` into a framed spill file (its live rows copied
        to the host); -> its slot. Blocking (disk write)."""
        from datafusion_distributed_tpu_torch.runtime.codec import encode_table

        payload = encode_table(table)
        cap = int(getattr(table, "capacity", 0))
        path = os.path.join(self._ensure_dir(), f"{uuid.uuid4().hex}.spill")
        try:
            with open(path, "wb") as f:
                f.write(_HEADER.pack(_MAGIC, _VERSION, cap, len(payload)))
                f.write(payload)
        except OSError as e:
            try:
                os.unlink(path)
            except OSError:
                pass
            raise SpillError(f"spill write failed: {e}") from e
        cols = tuple(zip(getattr(table, "names", ()),
                         getattr(table, "columns", ())))
        dict_cols = {
            name: col.dictionary for name, col in cols
            if getattr(col, "dictionary", None) is not None
        }
        slot = SpillSlot(
            path, nbytes, _HEADER.size + len(payload), cap,
            dict_cols=dict_cols, device=table.device,
            no_validity=[name for name, col in cols if col.validity is None],
        )
        with self._lock:
            self._live.add(path)
            self.spills += 1
            self.spill_bytes += slot.nbytes
        if _leakcheck.enabled():
            _leakcheck.note_acquire("spill-slot", path,
                                    tag="SpillManager.write_spill")
        return slot

    def read_spill(self, slot: SpillSlot):
        """Decode a spilled entry back into a Table on the device it was
        spilled from (original capacity preserved). Blocking (disk read).
        The slot stays live; the caller releases it once the refault is
        installed (a raced second reader must still be able to read)."""
        from datafusion_distributed_tpu_torch.runtime.codec import decode_table

        try:
            with open(slot.path, "rb") as f:
                header = f.read(_HEADER.size)
                magic, version, cap, plen = _HEADER.unpack(header)
                if magic != _MAGIC or version != _VERSION:
                    raise SpillError(
                        f"bad spill frame header in {slot.path}"
                    )
                payload = f.read(plen)
                if len(payload) != plen:
                    raise SpillError(f"torn spill frame in {slot.path}")
        except (OSError, struct.error) as e:
            raise SpillError(f"spill read failed: {e}") from e
        table = decode_table(payload, capacity=cap or None,
                             device=slot.device)
        table = _rebind_dictionaries(table, slot.dict_cols, slot.no_validity)
        with self._lock:
            self.refaults += 1
            self.refault_bytes += slot.nbytes
        return table

    # -- lifecycle -----------------------------------------------------------
    def release(self, slot: SpillSlot) -> None:  # releases: spill-slot
        """Unlink a slot's file (idempotent)."""
        if slot.released:
            return
        slot.released = True
        if _leakcheck.enabled():
            _leakcheck.note_release("spill-slot", slot.path)
        with self._lock:
            self._live.discard(slot.path)
        try:
            os.unlink(slot.path)
        except OSError:
            pass  # already gone (process restart sweep, test cleanup)

    def live_files(self) -> int:
        with self._lock:
            return len(self._live)

    def stats(self) -> dict:
        with self._lock:
            return {
                "spills": self.spills,
                "spill_bytes": self.spill_bytes,
                "refaults": self.refaults,
                "refault_bytes": self.refault_bytes,
                "spill_files": len(self._live),
            }
