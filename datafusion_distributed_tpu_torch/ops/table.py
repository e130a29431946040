"""Device-resident padded columnar batches (the Arrow `RecordBatch` analogue).

Port of the reference package's `ops/table.py`. The padded-table contract is
unchanged:

- every column is a fixed-`capacity` device tensor,
- the number of live rows is a 0-d int32 device tensor ``num_rows`` (so
  filters and joins change it without a host round trip),
- rows at index >= num_rows are garbage and masked out by ``row_mask()``,
- null semantics ride in per-column validity masks (bool tensors),
- strings live as int32 dictionary codes; the dictionaries themselves stay on
  the host in a registry keyed by small ints.

All tensors of one Table live on one device (``Table.device``). Operators
allocate their outputs on the device of their inputs.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from datafusion_distributed_tpu_torch.schema import DataType, Field, Schema

# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """None means the card. Without a CUDA device that raises: nothing runs
    on the CPU unless the caller asks for it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def parse_bool_knob(value) -> bool:
    """The reference's parser for boolean `SET distributed.*` knobs
    ("off"/"false"/"0"/"" are false, everything else truthy), applied at
    SET time (sql/context.py)."""
    if isinstance(value, str):
        return value.strip().lower() not in ("0", "false", "off", "")
    return bool(value)


def nonzero_static(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Static-size ``nonzero``: the indices of the True entries of a 1-D
    bool mask, packed to the front of an int32 tensor of length ``size`` and
    padded with index 0 (``jnp.nonzero(mask, size=size, fill_value=0)``).
    A cumsum gives each kept entry its output position and one scatter
    places it — no host sync, unlike ``torch.nonzero``. Entries past
    ``size`` are dropped into a scratch slot."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    dst = torch.where(mask & (pos < size), pos, size)
    out = torch.zeros(size + 1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dst, torch.arange(n, dtype=torch.int32,
                                      device=mask.device))
    return out[:size]


def drop_index(idx: torch.Tensor, keep: torch.Tensor, size: int):
    """int64 scatter index with the rows not kept sent to slot ``size`` (a
    scratch slot the caller allocates and slices off): the port's form of
    JAX's ``mode="drop"`` scatters."""
    return torch.where(keep, idx.to(torch.int64), size)


# ---------------------------------------------------------------------------
# Host-side dictionary registry
# ---------------------------------------------------------------------------

_DICT_COUNTER = itertools.count()
# Weak registry: a Dictionary lives as long as some Column references it.
_DICT_REGISTRY: "weakref.WeakValueDictionary[int, Dictionary]" = (
    weakref.WeakValueDictionary()
)
# (sorted input dict ids) -> union Dictionary; see unify_dictionaries
_UNION_DICT_CACHE: dict = {}
_DICT_CACHE_LOCK = threading.Lock()


def lru_get_or_create(cache: dict, key, mint, cap: int):
    """Thread-safe get-or-mint with LRU eviction (python dicts preserve
    insertion order; move-to-end on hit). Memoizing derived dictionaries
    keeps their identity stable across repeated evaluations."""
    with _DICT_CACHE_LOCK:
        if key in cache:
            val = cache.pop(key)
            cache[key] = val  # move to end = most recently used
        else:
            val = mint()
            cache[key] = val
        while len(cache) > cap:
            cache.pop(next(iter(cache)))
        return val


class Dictionary:
    """A host-side sorted string dictionary, identified by a small int.

    Dictionaries are sorted at construction so that code order ==
    lexicographic order; this lets ORDER BY / MIN / MAX / comparisons run
    directly on int32 codes on the device.
    """

    __slots__ = ("dict_id", "values", "_index", "__weakref__")

    def __init__(self, values: np.ndarray):
        values = np.asarray(values, dtype=object)
        if values.ndim != 1:
            raise ValueError("dictionary must be 1-D")
        self.dict_id = next(_DICT_COUNTER)
        self.values = values
        self._index: Optional[dict] = None
        _DICT_REGISTRY[self.dict_id] = self

    @staticmethod
    def from_strings(values: Iterable[str]) -> "Dictionary":
        return Dictionary(np.asarray(list(values), dtype=object))

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, value: str) -> int:
        """Host-side lookup: string -> code, or -1 if absent."""
        return self.index().get(value, -1)

    def index(self) -> dict:
        """Cached str -> code map."""
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        valid = (codes >= 0) & (codes < len(self.values))
        out[valid] = self.values[codes[valid]]
        out[~valid] = None
        return out

    def is_sorted(self) -> bool:
        if len(self.values) < 2:
            return True
        v = self.values.astype(str)
        return bool(np.all(v[:-1] <= v[1:]))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Dictionary) and other.dict_id == self.dict_id

    def __hash__(self) -> int:
        return hash(("Dictionary", self.dict_id))

    def __repr__(self) -> str:
        return f"Dictionary(id={self.dict_id}, n={len(self.values)})"


def get_dictionary(dict_id: int) -> Dictionary:
    return _DICT_REGISTRY[dict_id]


# ---------------------------------------------------------------------------
# Column
# ---------------------------------------------------------------------------


@dataclass
class Column:
    """A single padded device column.

    ``data``: [capacity] tensor (dtype per DataType; strings = int32 codes)
    ``validity``: [capacity] bool tensor, or None when non-nullable.
    """

    data: torch.Tensor
    validity: Optional[torch.Tensor]
    dtype: DataType
    dictionary: Optional[Dictionary] = None

    @staticmethod
    def from_numpy(
        values: np.ndarray,
        dtype: DataType,
        capacity: int,
        validity: Optional[np.ndarray] = None,
        dictionary: Optional[Dictionary] = None,
        device=None,
    ) -> "Column":
        dev = resolve_device(device)
        n = len(values)
        if n > capacity:
            raise ValueError(f"{n} values > capacity {capacity}")
        np_dtype = np.dtype(dtype.np_dtype)
        vals = np.asarray(values)
        # tpu precision mode stores logical 64-bit ints as int32; narrowing
        # must be loud, never a silent wrap
        if (
            n
            and np.issubdtype(vals.dtype, np.integer)
            and np.issubdtype(np_dtype, np.integer)
            and vals.dtype.itemsize > np_dtype.itemsize
        ):
            info = np.iinfo(np_dtype)
            lo, hi = vals.min(), vals.max()
            if lo < info.min or hi > info.max:
                raise OverflowError(
                    f"int values [{lo}, {hi}] exceed {np_dtype} device "
                    "storage; run with DFTPU_PRECISION=x64 for 64-bit keys"
                )
        buf = np.zeros(capacity, dtype=np_dtype)
        buf[:n] = vals
        data = torch.from_numpy(buf).to(dev)
        col_validity = None
        if validity is not None:
            v = np.zeros(capacity, dtype=np.bool_)
            v[:n] = validity
            col_validity = torch.from_numpy(v).to(dev)
        return Column(data, col_validity, dtype, dictionary)

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def valid_mask(self, capacity: Optional[int] = None) -> torch.Tensor:
        """Per-row null mask (True = non-null). Does NOT account for num_rows."""
        if self.validity is not None:
            return self.validity
        return torch.ones(capacity or self.capacity, dtype=torch.bool,
                          device=self.data.device)

    def gather(self, idx: torch.Tensor) -> "Column":
        data = torch.index_select(self.data, 0, idx)
        validity = (
            torch.index_select(self.validity, 0, idx)
            if self.validity is not None else None
        )
        return Column(data, validity, self.dtype, self.dictionary)

    def with_validity(self, validity: Optional[torch.Tensor]) -> "Column":
        return Column(self.data, validity, self.dtype, self.dictionary)


# ---------------------------------------------------------------------------
# Table
# ---------------------------------------------------------------------------


def _rows(num_rows, device) -> torch.Tensor:
    return torch.as_tensor(num_rows, dtype=torch.int32, device=device)


@dataclass
class Table:
    """A padded columnar batch: named columns + live-row count."""

    names: tuple[str, ...]
    columns: tuple[Column, ...]
    num_rows: torch.Tensor  # 0-d int32 on the table's device

    # -- construction -------------------------------------------------------
    @staticmethod
    def make(columns: dict[str, Column], num_rows) -> "Table":
        names = tuple(columns.keys())
        cols = tuple(columns.values())
        caps = {c.capacity for c in cols}
        if len(caps) > 1:
            raise ValueError(f"column capacities differ: {caps}")
        return Table(names, cols, _rows(num_rows, cols[0].data.device))

    @staticmethod
    def from_numpy(
        data: dict[str, np.ndarray],
        schema: Schema,
        capacity: Optional[int] = None,
        validity: Optional[dict[str, np.ndarray]] = None,
        dictionaries: Optional[dict[str, Dictionary]] = None,
        device=None,
    ) -> "Table":
        """Build a device Table from host arrays (string columns must already
        be int32 codes with a matching entry in ``dictionaries``)."""
        if not data:
            raise ValueError("from_numpy needs at least one column")
        dev = resolve_device(device)
        n = len(next(iter(data.values())))
        cap = capacity if capacity is not None else max(1, _round_up(n))
        cols: dict[str, Column] = {}
        for f in schema.fields:
            vals = data[f.name]
            if len(vals) != n:
                raise ValueError(f"column {f.name} length {len(vals)} != {n}")
            v = validity.get(f.name) if validity else None
            d = dictionaries.get(f.name) if dictionaries else None
            if f.dtype == DataType.STRING and d is None:
                raise ValueError(f"string column {f.name} needs a dictionary")
            cols[f.name] = Column.from_numpy(vals, f.dtype, cap, v, d, dev)
        return Table.make(cols, n)

    @staticmethod
    def empty(schema: Schema, capacity: int, dictionaries=None,
              device=None) -> "Table":
        dev = resolve_device(device)
        cols = {}
        for f in schema.fields:
            d = dictionaries.get(f.name) if dictionaries else None
            cols[f.name] = Column(
                torch.zeros(capacity, dtype=f.dtype.torch_dtype, device=dev),
                torch.zeros(capacity, dtype=torch.bool, device=dev)
                if f.nullable else None,
                f.dtype,
                d,
            )
        return Table.make(cols, 0)

    # -- introspection ------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> Column:
        try:
            return self.columns[self.names.index(name)]
        except ValueError:
            raise KeyError(f"no column {name!r}; have {list(self.names)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def as_dict(self) -> dict[str, Column]:
        return dict(zip(self.names, self.columns))

    def schema(self) -> Schema:
        return Schema(
            [
                Field(n, c.dtype, nullable=c.validity is not None)
                for n, c in zip(self.names, self.columns)
            ]
        )

    def row_mask(self) -> torch.Tensor:
        """[capacity] bool: True for live (non-padding) rows."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows

    # -- transforms ---------------------------------------------------------
    def select(self, names: Sequence[str]) -> "Table":
        return Table(
            tuple(names), tuple(self.column(n) for n in names), self.num_rows
        )

    def rename(self, mapping: dict[str, str]) -> "Table":
        names = tuple(mapping.get(n, n) for n in self.names)
        return Table(names, self.columns, self.num_rows)

    def with_column(self, name: str, col: Column) -> "Table":
        d = self.as_dict()
        d[name] = col
        return Table(tuple(d.keys()), tuple(d.values()), self.num_rows)

    def gather(self, idx: torch.Tensor, num_rows) -> "Table":
        cols = tuple(c.gather(idx) for c in self.columns)
        return Table(self.names, cols, _rows(num_rows, self.device))

    def compact(self, keep: torch.Tensor) -> "Table":
        """Select rows where ``keep`` is True, packed to the front.

        ``keep`` is a [capacity] bool mask; padding rows are masked here.
        A static-size nonzero + gather keeps capacities fixed while
        num_rows becomes the popcount."""
        keep = keep & self.row_mask()
        idx = nonzero_static(keep, self.capacity)
        n = torch.sum(keep, dtype=torch.int32)
        return self.gather(idx, n)

    def head(self, limit) -> "Table":
        n = torch.minimum(self.num_rows, _rows(limit, self.device))
        return Table(self.names, self.columns, n)

    def slice_rows(self, lo: int, count: int) -> "Table":
        """Row-range slice [lo, lo+count) as a compact table (host offsets:
        reads num_rows)."""
        n = int(self.num_rows)
        lo = max(0, min(lo, n))
        count = max(0, min(count, n - lo))
        cols = tuple(
            Column(
                c.data[lo:lo + count],
                c.validity[lo:lo + count] if c.validity is not None else None,
                c.dtype, c.dictionary,
            )
            for c in self.columns
        )
        return Table(self.names, cols, _rows(count, self.device))

    # -- host materialization -----------------------------------------------
    def to_numpy(self, decode_strings: bool = True) -> dict[str, np.ndarray]:
        n = int(self.num_rows)
        out: dict[str, np.ndarray] = {}
        for name, col in zip(self.names, self.columns):
            vals = col.data[:n].cpu().numpy()
            if col.dtype == DataType.STRING and decode_strings:
                assert col.dictionary is not None
                vals = col.dictionary.decode(vals)
            if col.validity is not None:
                mask = col.validity[:n].cpu().numpy()
                if vals.dtype == object:
                    vals = vals.copy()
                    vals[~mask] = None
                elif np.issubdtype(vals.dtype, np.floating):
                    vals = vals.astype(np.float64, copy=True)
                    vals[~mask] = np.nan
                else:
                    vals = np.ma.masked_array(vals, mask=~mask)
            out[name] = vals
        return out

    def to_pandas(self):
        import pandas as pd

        n = int(self.num_rows)
        cols = {}
        for name, col in zip(self.names, self.columns):
            vals = col.data[:n].cpu().numpy()
            if col.dtype == DataType.STRING:
                assert col.dictionary is not None
                vals = col.dictionary.decode(vals)
            s = pd.Series(vals)
            if col.validity is not None:
                mask = col.validity[:n].cpu().numpy()
                s = s.where(pd.Series(mask), other=None)
            cols[name] = s
        return pd.DataFrame(cols)

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}:{c.dtype.value}" for n, c in zip(self.names, self.columns)
        )
        return f"Table(capacity={self.capacity}, cols=[{cols}])"


def _round_up(n: int, multiple: int = 8) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def round_up_pow2(n: int, minimum: int = 8) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def apply_lut(lut, codes: torch.Tensor) -> torch.Tensor:
    """Gather ``lut[clip(codes)]`` with a host LUT moved to the codes'
    device (dictionary remaps and per-code predicate tables)."""
    t = torch.as_tensor(np.asarray(lut), device=codes.device)
    return t[torch.clamp(codes, 0, len(lut) - 1).to(torch.int64)]


def concat_tables(tables: Sequence[Table],
                  capacity: Optional[int] = None) -> Table:
    """Concatenate same-schema tables into one padded table (rows are packed
    via cumulative offsets; capacity sizing is the caller's, as everywhere
    else in the engine)."""
    if not tables:
        raise ValueError("concat of zero tables")
    first = tables[0]
    dev = first.device
    total_cap = capacity or sum(t.capacity for t in tables)
    names = first.names
    for t in tables[1:]:
        if t.names != names:
            raise ValueError(f"concat schema mismatch: {t.names} vs {names}")
        for ci in range(len(names)):
            a, b = first.columns[ci], t.columns[ci]
            if a.dtype != b.dtype:
                raise ValueError(
                    f"concat dtype mismatch on {names[ci]!r}: {a.dtype} vs {b.dtype}"
                )
    out_cols = []
    offsets = []
    acc = torch.zeros((), dtype=torch.int32, device=dev)
    for t in tables:
        offsets.append(acc)
        acc = acc + t.num_rows
    total_rows = acc
    for ci in range(len(names)):
        src_dtype = first.columns[ci].dtype
        dictionary, luts = unify_dictionaries(
            [t.columns[ci].dictionary for t in tables]
        )
        has_validity = any(t.columns[ci].validity is not None for t in tables)
        data = torch.zeros(total_cap + 1, dtype=src_dtype.torch_dtype,
                           device=dev)
        validity = (torch.zeros(total_cap + 1, dtype=torch.bool, device=dev)
                    if has_validity else None)
        for t, off, lut in zip(tables, offsets, luts):
            col = t.columns[ci]
            live = t.row_mask()
            dst = drop_index(
                off + torch.arange(t.capacity, dtype=torch.int32, device=dev),
                live, total_cap,
            )
            vals = col.data
            if lut is not None:
                vals = apply_lut(lut, vals)
            data.index_put_((dst,), vals.to(data.dtype))
            if has_validity:
                validity.index_put_((dst,), col.valid_mask())
        out_cols.append(Column(
            data[:total_cap],
            validity[:total_cap] if validity is not None else None,
            src_dtype, dictionary,
        ))
    return Table(names, tuple(out_cols), total_rows)


def unify_dictionaries(dicts):
    """Pick a common dictionary for a set of string columns and per-input
    code-remap LUTs (None = codes pass through). The union is SORTED, so
    remapped codes preserve lexicographic order — callers use this for
    concat, cross-dictionary comparison, and COALESCE alike."""
    present = [d for d in dicts if d is not None]
    if not present:
        return None, [None] * len(dicts)
    unique = {d.dict_id: d for d in present}
    if len(unique) == 1:
        return present[0], [None] * len(dicts)
    vals = [d.values.astype(str) for d in unique.values()]
    if all(np.array_equal(v, vals[0]) for v in vals[1:]):
        # same vocabulary, distinct objects: codes already agree
        return present[0], [None] * len(dicts)
    union_vals = np.unique(np.concatenate(vals))
    union = lru_get_or_create(
        _UNION_DICT_CACHE, tuple(sorted(unique)),
        lambda: Dictionary(union_vals.astype(object)), cap=256,
    )
    luts = []
    for d in dicts:
        if d is None or len(d) == 0:
            luts.append(None if d is None else np.zeros(1, dtype=np.int32))
            continue
        luts.append(
            np.searchsorted(union_vals, d.values.astype(str)).astype(np.int32)
        )
    return union, luts
