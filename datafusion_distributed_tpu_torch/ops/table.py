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
import os
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
        data = to_device(buf, dev)
        col_validity = None
        if validity is not None:
            v = np.zeros(capacity, dtype=np.bool_)
            v[:n] = validity
            col_validity = to_device(v, dev)
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
        reads num_rows once, `host_rows`): views of this table's buffers
        with the reference's capacity, ``count`` rounded up to 8 as far as
        the buffers reach."""
        n = host_rows(self)
        lo = max(0, min(lo, n))
        count = max(0, min(count, n - lo))
        end = min(lo + max(_round_up(count), 8), self.capacity)
        cols = tuple(
            Column(
                c.data[lo:end],
                c.validity[lo:end] if c.validity is not None else None,
                c.dtype, c.dictionary,
            )
            for c in self.columns
        )
        return _with_host_rows(
            Table(self.names, cols, rows_tensor(count, self.device)), count)

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
    else in the engine). Inside a plan the row counts stay on the device;
    the runtime's staged tables carry theirs on the host (`host_rows`),
    and then the concat checks the capacity as the reference's host path
    does and may return a view (`_concat_known`)."""
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
    ns = [known_rows(t) for t in tables]
    if None not in ns:
        # every row count is already on the host (staged views, streamed
        # chunks): check the capacity and copy live rows by host offsets,
        # or hand out one view when the inputs abut in one buffer
        total = sum(ns)
        if total > total_cap:
            raise ValueError(
                f"concat overflow: {total} rows > capacity {total_cap}")
        return _concat_known(tables, names, ns, total_cap)
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


# ---------------------------------------------------------------------------
# Staging primitives of the coordinator/worker runtime
# ---------------------------------------------------------------------------
#
# The reference's runtime rebinds staged tables to host numpy buffers once
# (`host_view`) and then slices and reassembles them as numpy views. Here
# tables between stages stay on the device they were made on: a row-range
# slice is a `narrow` view of the same tensors, and views that abut in one
# buffer reassemble without a copy. What the host needs is the live-row
# count, read once per table and kept on it (`host_rows`); `read_rows`
# reads many in one transfer. Buffers are immutable by contract: every
# consumer shares them by reference. Only bytes that leave the process
# (Arrow IPC, runtime/codec.py) go through `host_view`.


def zero_copy_enabled(config: Optional[dict] = None) -> bool:
    """Effective `SET distributed.zero_copy` (default ON). The env override
    ``DFTPU_ZERO_COPY`` wins over session config (the A/B escape hatch)."""
    env = os.environ.get("DFTPU_ZERO_COPY")
    if env is not None:
        return parse_bool_knob(env)
    return parse_bool_knob((config or {}).get("zero_copy", True))


def known_rows(table: Table) -> Optional[int]:
    """The live-row count if the host already holds it, else None."""
    return getattr(table, "_host_rows", None)


def _with_host_rows(table: Table, n: int) -> Table:
    table._host_rows = int(n)
    return table


def host_rows(table: Table) -> int:
    """The live-row count as a host int: read once (one device-to-host
    transfer for a table on the card) and kept on the table."""
    n = known_rows(table)
    if n is None:
        n = _with_host_rows(table, int(table.num_rows))._host_rows
    return n


def read_rows(tables: Sequence[Table]) -> list:
    """`host_rows` of every table, the unread ones in one transfer per
    device."""
    todo: dict = {}
    for t in tables:
        if known_rows(t) is None:
            todo.setdefault(t.device, []).append(t)
    for group in todo.values():
        if len(group) == 1:
            host_rows(group[0])
            continue
        vals = torch.stack([t.num_rows.to(torch.int64) for t in group])
        for t, n in zip(group, vals.cpu().tolist()):
            _with_host_rows(t, n)
    return [known_rows(t) for t in tables]


def rows_tensor(n: int, device) -> torch.Tensor:
    """A 0-d int32 row count made on ``device`` by a fill kernel (a host
    scalar copied to the card would synchronize)."""
    return torch.full((), int(n), dtype=torch.int32, device=device)


def host_prefix(table: Table, count: int) -> list:
    """The first ``count`` rows of every column as host numpy arrays,
    [(data, validity or None)], in one device-to-host transfer: the
    columns' bytes are packed into one buffer on the device first."""
    parts = []
    for c in table.columns:
        parts.append(c.data[:count])
        if c.validity is not None:
            parts.append(c.validity[:count])
    if table.device.type == "cpu":
        host = [p.numpy() for p in parts]
    else:
        flat = torch.cat([p.contiguous().view(torch.uint8)
                          for p in parts]).cpu().numpy()
        host, off = [], 0
        for p in parts:
            nb = p.numel() * p.element_size()
            np_dtype = torch.empty(0, dtype=p.dtype).numpy().dtype
            host.append(flat[off:off + nb].copy().view(np_dtype))
            off += nb
    out, i = [], 0
    for c in table.columns:
        data = host[i]
        i += 1
        validity = None
        if c.validity is not None:
            validity = host[i]
            i += 1
        out.append((data, validity))
    return out


def slice_view(table: Table, lo: int, count: int) -> Table:
    """Zero-copy row-range view [lo, lo+count) of a table on its own
    device: `narrow` views of the same tensors, capacity == count exactly,
    the row count kept on the host."""
    n = host_rows(table)
    lo = max(0, min(lo, n))
    count = max(0, min(count, n - lo))
    cols = tuple(
        Column(
            c.data.narrow(0, lo, count),
            c.validity.narrow(0, lo, count) if c.validity is not None
            else None,
            c.dtype, c.dictionary,
        )
        for c in table.columns
    )
    return _with_host_rows(
        Table(table.names, cols, rows_tensor(count, table.device)), count)


def is_host_backed(table: Table) -> bool:
    """True when every buffer lives in host memory."""
    return table.device.type == "cpu" and all(
        c.data.device.type == "cpu" for c in table.columns)


def move(table: Table, device) -> Table:
    """The table on ``device`` (the same object when it is there already);
    the host row count travels with it."""
    dev = torch.device(device)
    if table.device == dev:
        return table
    cols = tuple(
        Column(
            c.data.to(dev),
            c.validity.to(dev) if c.validity is not None else None,
            c.dtype, c.dictionary,
        )
        for c in table.columns
    )
    out = Table(table.names, cols, table.num_rows.to(dev))
    n = known_rows(table)
    return _with_host_rows(out, n) if n is not None else out


def host_view(table: Table) -> Table:
    """The table's buffers in host memory: free for a table on the CPU,
    one device-to-host copy of every column otherwise. Only bytes that
    leave the process need it (Arrow IPC); the in-process planes keep
    tables on their device."""
    return table if is_host_backed(table) else move(table, "cpu")


def to_device(arr: np.ndarray, device=None) -> torch.Tensor:
    """Host buffer -> tensor on ``device`` (None: the card); on the CPU the
    tensor shares the buffer, so the caller hands it over: it must not be
    mutated afterwards."""
    return torch.from_numpy(arr).to(resolve_device(device))


def _merge_views(arrs: list, want_len: int) -> Optional[torch.Tensor]:
    """Exact-length contiguous 1-D views that abut in ONE storage -> one
    view of length ``want_len`` over that storage (reading past the last
    view only if the storage has the room), else None."""
    nz = [a for a in arrs if a.numel()]
    if not nz:
        return None
    first = nz[0]
    storage = first.untyped_storage()
    end = first.data_ptr() + first.numel() * first.element_size()
    for a in nz[1:]:
        if (a.untyped_storage().data_ptr() != storage.data_ptr()
                or a.data_ptr() != end or not a.is_contiguous()):
            return None
        end += a.numel() * a.element_size()
    room = (storage.data_ptr() + storage.nbytes() - first.data_ptr()) \
        // first.element_size()
    if want_len > room or not first.is_contiguous():
        return None
    return first.as_strided((want_len,), (1,))


def _concat_known(tables, names, ns, total_cap: int) -> Table:
    """Concat of tables whose row counts the host holds: one view of the
    base buffer when the inputs are contiguous views that abut in it and
    need no dictionary re-encode; otherwise one copy of each input's live
    rows into a zero-padded buffer (the device path's padding)."""
    total = sum(ns)
    dev = tables[0].device
    unified = [
        unify_dictionaries([t.columns[ci].dictionary for t in tables])
        for ci in range(len(names))
    ]
    view = _concat_views(tables, names, ns, unified, total_cap)
    if view is not None:
        return _with_host_rows(view, total)
    out_cols = []
    for ci in range(len(names)):
        cols = [t.columns[ci] for t in tables]
        dtype = cols[0].dtype
        d, luts = unified[ci]
        has_validity = any(c.validity is not None for c in cols)
        data = torch.zeros(total_cap, dtype=dtype.torch_dtype, device=dev)
        validity = (torch.zeros(total_cap, dtype=torch.bool, device=dev)
                    if has_validity else None)
        off = 0
        for c, lut, n in zip(cols, luts, ns):
            if n:
                vals = c.data[:n]
                if lut is not None:
                    vals = apply_lut(lut, vals)
                data[off:off + n] = vals.to(data.dtype)
                if has_validity:
                    if c.validity is not None:
                        validity[off:off + n] = c.validity[:n]
                    else:
                        validity[off:off + n] = True
            off += n
        out_cols.append(Column(data, validity, dtype, d))
    return _with_host_rows(
        Table(tuple(names), tuple(out_cols), rows_tensor(total, dev)), total)


def _concat_views(tables, names, ns, unified, total_cap: int):
    total = sum(ns)
    if total == 0:
        return None
    for _d, luts in unified:
        if any(lut is not None for lut in luts):
            return None
    out_cols = []
    for ci in range(len(names)):
        cols = [t.columns[ci] for t in tables]
        if len({c.validity is not None for c in cols}) > 1:
            return None
        for c, n in zip(cols, ns):
            if c.data.shape[0] != n or (
                    c.validity is not None and c.validity.shape[0] != n):
                return None  # not an exact-length view
        merged = _merge_views([c.data for c in cols], total_cap)
        if merged is None:
            return None
        merged_validity = None
        if cols[0].validity is not None:
            merged_validity = _merge_views([c.validity for c in cols],
                                           total_cap)
            if merged_validity is None:
                return None
        out_cols.append(Column(merged, merged_validity, cols[0].dtype,
                               unified[ci][0]))
    return Table(tuple(names), tuple(out_cols),
                 rows_tensor(total, tables[0].device))
