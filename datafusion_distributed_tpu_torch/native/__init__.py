"""ctypes bindings to the native host data plane (see src/dftpu.cpp).

Port of the reference `native/`. The C++ source is compiled with ``g++ -O3
-shared -fPIC -std=c++17`` at first use into the package's ``_build/``
directory (which ``.gitignore`` lists), named by the hash of the source so
that an edited source rebuilds; nothing is built when the module is
imported. A failed build raises: callers pick the native path by where a
table lives (host memory), never by whether the library built.

The hash is bit-identical to ops/hash.py `hash_columns`, so a host regroup
and a device regroup send every key to the same destination.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "src" / "dftpu.cpp"
BUILD_DIR = _HERE.parent / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libdftpu_{digest}.so"


def build() -> Path:
    """Compile the source unless its hashed library exists; -> its path.
    Raises RuntimeError when there is no compiler or the build fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host data plane "
                           "cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE),
         "-o", str(tmp)],
        capture_output=True, text=True, timeout=120,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        # lock-while-building witness (runtime/lockcheck.py): an engine
        # lock held across a g++ run
        from datafusion_distributed_tpu_torch.runtime import lockcheck

        lockcheck.note_blocking("kernel_build")
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.dftpu_hash_rows.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            np.ctypeslib.ndpointer(np.int32),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int32,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint32),
        ]
        lib.dftpu_shuffle_dest.argtypes = [
            np.ctypeslib.ndpointer(np.uint32),
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int64),
        ]
        lib.dftpu_bucket_indices.argtypes = [
            np.ctypeslib.ndpointer(np.int32),
            ctypes.c_int64,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
        ]
        lib.dftpu_version.restype = ctypes.c_int32
        _lib = lib
        return lib


def hash_rows(cols: list, valids: list, dtypes=None) -> np.ndarray:
    """Combined uint32 hash of host key columns (numpy arrays), bit-identical
    to ops.hash.hash_columns on the same values. ``dtypes`` (the columns'
    logical types) is accepted for the reference's signature: the hash
    dispatches on each array's actual dtype, the bits the device holds."""
    lib = load()
    n = len(cols[0])
    payloads = []
    kinds = np.zeros(len(cols), dtype=np.int32)
    for i, c in enumerate(cols):
        adt = np.asarray(c).dtype
        if adt == np.int64:
            payloads.append(np.ascontiguousarray(c, dtype=np.int64))
            kinds[i] = 0
        elif adt == np.float64:
            payloads.append(
                np.ascontiguousarray(c, dtype=np.float64).view(np.int64)
            )
            kinds[i] = 0
        elif adt == np.float32:
            bits = np.ascontiguousarray(c, dtype=np.float32).view(np.uint32)
            payloads.append(bits.astype(np.int64))
            kinds[i] = 1
        else:  # int32 / date32 / bool / dictionary codes: their low 32 bits
            u = np.ascontiguousarray(c).astype(np.int64)
            payloads.append(u & np.int64(0xFFFFFFFF))
            kinds[i] = 1
    col_ptrs = (ctypes.c_void_p * len(cols))(
        *[p.ctypes.data_as(ctypes.c_void_p) for p in payloads]
    )
    vbufs = []
    vptrs = (ctypes.c_void_p * len(cols))()
    for i, v in enumerate(valids):
        if v is None:
            vptrs[i] = None
        else:
            vb = np.ascontiguousarray(v, dtype=np.uint8)
            vbufs.append(vb)
            vptrs[i] = vb.ctypes.data_as(ctypes.c_void_p).value
    out = np.empty(n, dtype=np.uint32)
    lib.dftpu_hash_rows(col_ptrs, kinds, vptrs, len(cols), n, out)
    return out


def shuffle_buckets(
    hash_: np.ndarray, live: Optional[np.ndarray], parts: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (offsets[parts+1], indices[sum(counts)], counts[parts]): CSR of row
    indices per destination bucket (``hash % parts``), each bucket's rows in
    their original order; rows where ``live`` is false are left out."""
    lib = load()
    n = len(hash_)
    dest = np.empty(n, dtype=np.int32)
    counts = np.empty(parts, dtype=np.int64)
    live_ptr = None
    if live is not None:
        live8 = np.ascontiguousarray(live, dtype=np.uint8)
        live_ptr = live8.ctypes.data_as(ctypes.c_void_p)
    lib.dftpu_shuffle_dest(
        np.ascontiguousarray(hash_, dtype=np.uint32), live_ptr, n, parts,
        dest, counts,
    )
    offsets = np.empty(parts + 1, dtype=np.int64)
    indices = np.empty(int(counts.sum()), dtype=np.int64)
    lib.dftpu_bucket_indices(dest, n, parts, counts, offsets, indices)
    return offsets, indices, counts
