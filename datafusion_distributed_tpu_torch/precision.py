"""Compute-precision policy: 32-bit device storage by default.

The same two modes as the reference package's `precision.py`, resolved once
at import time from the ``DFTPU_PRECISION`` environment variable:

- ``tpu`` (default): every device tensor — columns, accumulators,
  temporaries — is 32-bit. Logical INT64/FLOAT64 schema types are stored as
  int32/float32 on the device; the host->device boundary range-checks
  integer narrowing (`ops/table.py Column.from_numpy`), so silent
  truncation is impossible. Float aggregation accumulates in float32;
  result parity against a float64 oracle holds at `oracle_rtol`.
- ``x64``: exact mode — float64/int64 device columns.

The name ``tpu`` is kept so that one environment variable selects the same
mode in both packages; on the GPU it means "32-bit storage", nothing more.
The mode is import-time only; tests that need the other mode run in a
subprocess.
"""

from __future__ import annotations

import os

import numpy as np
import torch

MODE = os.environ.get("DFTPU_PRECISION", "tpu").strip().lower()
if MODE not in ("tpu", "x64"):
    raise ValueError(
        f"DFTPU_PRECISION must be 'tpu' or 'x64', got {MODE!r}"
    )

#: Device storage dtype per logical DataType value (see schema.DataType).
#: Narrowed entries apply in tpu mode only.
_NARROW = {
    "int64": np.int32,
    "float64": np.float32,
}


def narrow_np_dtype(wide: np.dtype) -> np.dtype:
    """Map a logical numpy dtype to its device storage dtype for this mode."""
    if MODE == "x64":
        return np.dtype(wide)
    return np.dtype(_NARROW.get(np.dtype(wide).name, wide))


_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """numpy dtype -> torch dtype (the device storage types only)."""
    return _TORCH_DTYPES[np.dtype(np_dtype)]


#: dtype for folded key lanes in the claim-loop hash table / join probe
#: (ops/aggregate.py, ops/join.py).
LANE_INT = np.int64 if MODE == "x64" else np.int32
#: integer accumulator (counts, rank numbering, metric counters)
ACC_INT = np.int64 if MODE == "x64" else np.int32

LANE_TORCH = torch_dtype(LANE_INT)
ACC_INT_TORCH = torch_dtype(ACC_INT)


def oracle_rtol() -> float:
    """Float tolerance for result-parity comparison against an f64 oracle.

    tpu mode: f32 scatter-add over N addends accumulates ~eps_f32*sqrt(N)
    relative error (random-sign model); 5e-4 covers N up to ~10^7.
    """
    return 1e-6 if MODE == "x64" else 5e-4


def oracle_atol() -> float:
    """Absolute float tolerance beside `oracle_rtol`, for values near 0."""
    return 1e-6 if MODE == "x64" else 1e-4


def test_rtol() -> float:
    """Tolerance for engine-vs-engine comparisons (same inputs, two
    summation orders)."""
    return 1e-12 if MODE == "x64" else 2e-5
