"""Host-side Arrow/Parquet <-> device Table (port of the reference
`io/parquet.py`).

Decoding stays on the host (pyarrow, imported inside the functions that need
it, so the engine itself runs on numpy alone), and the upload pads each table
to a static capacity; string columns are dictionary-encoded against a sorted
dictionary so device codes compare in lexicographic order.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from datafusion_distributed_tpu_torch.ops.table import (
    Dictionary,
    Table,
    round_up_pow2,
)
from datafusion_distributed_tpu_torch.schema import DataType, Field, Schema


def _arrow_type_to_dtype(t) -> DataType:
    import pyarrow as pa

    if pa.types.is_int8(t) or pa.types.is_int16(t) or pa.types.is_int32(t):
        return DataType.INT32
    if pa.types.is_int64(t) or pa.types.is_uint32(t) or pa.types.is_uint64(t):
        return DataType.INT64
    if pa.types.is_uint8(t) or pa.types.is_uint16(t):
        return DataType.INT32
    if pa.types.is_float32(t):
        return DataType.FLOAT32
    if pa.types.is_float64(t):
        return DataType.FLOAT64
    if pa.types.is_decimal(t):
        return DataType.FLOAT64
    if pa.types.is_boolean(t):
        return DataType.BOOL
    if pa.types.is_date(t):
        return DataType.DATE32
    if pa.types.is_timestamp(t):
        return DataType.INT64
    if pa.types.is_string(t) or pa.types.is_large_string(t) or (
        pa.types.is_dictionary(t)
    ):
        return DataType.STRING
    raise NotImplementedError(f"unsupported arrow type: {t}")


_dict_lock = threading.Lock()
#: Dictionary -> its wire form (Arrow values, fingerprint, adoptable): the
#: sender's side of whole-dictionary wire columns, made once per
#: dictionary, not per payload
_WIRE_FORM: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # guarded-by: _dict_lock
#: adopted wire dictionaries, least recently used first: fingerprint ->
#: (Arrow values, Dictionary)
_ADOPTED: "OrderedDict[str, tuple]" = OrderedDict()  # guarded-by: _dict_lock
#: the Arrow bytes of the values _ADOPTED keeps, at most _ADOPTED_MAX_BYTES
#: (the oldest go first; the newest stays whatever its size). A dictionary
#: that went is adopted anew on its next arrival, as another object:
#: concatenations then unify it (`unify_dictionaries`) instead of sharing it
_ADOPTED_MAX_BYTES = 256 << 20
_adopted_bytes = 0  # guarded-by: _dict_lock
#: dictionaries of fewer Arrow bytes are never advertised as held: they
#: travel with the first payload of each stream or frame, and the lists of
#: fingerprints that requests and responses carry stay short
_ADVERTISE_MIN_BYTES = 64 << 10


class DictionaryMissing(KeyError):
    """A wire payload references a dictionary, by fingerprint, that the
    receiver does not hold (its sender believed it did): the sender ships
    the payload again with the dictionary's values."""

    def __init__(self, fingerprints):
        self.fingerprints = list(fingerprints)
        super().__init__(f"wire dictionaries not held: {self.fingerprints}")


def _fingerprint(arr) -> str:
    """A string array's content fingerprint (its values, offsets from 0,
    whatever slice of which buffers holds them)."""
    import hashlib

    import pyarrow as pa

    n = len(arr)
    bufs = arr.buffers()
    wide = pa.types.is_large_string(arr.type)
    offs = np.frombuffer(bufs[1], dtype=np.int64 if wide else np.int32,
                         count=n + 1, offset=arr.offset * (8 if wide else 4))
    h = hashlib.blake2b(digest_size=16)
    h.update((offs - offs[0]).astype(np.int64).tobytes())
    if n and bufs[2] is not None:
        h.update(memoryview(bufs[2])[int(offs[0]):int(offs[-1])])
    if arr.null_count:
        h.update(np.asarray(arr.is_null()).tobytes())
    return h.hexdigest()


def _strictly_ascending(arr) -> bool:
    """Sorted and duplicate-free, with no null: what a receiver adopts
    as a Dictionary (repeated values would give equal strings distinct
    codes, splitting their groups). Byte order of UTF-8 is code-point
    order, the Dictionary's."""
    import pyarrow.compute as pc

    n = len(arr)
    if arr.null_count:
        return False
    return n < 2 or bool(pc.all(pc.less(arr.slice(0, n - 1),
                                        arr.slice(1))).as_py())


def _wire_form(d: Dictionary) -> tuple:
    """(Arrow values, fingerprint, adoptable) of ``d``."""
    with _dict_lock:
        form = _WIRE_FORM.get(d)
    if form is None:
        import pyarrow as pa

        arr = pa.array(d.values.tolist(), type=pa.string())
        form = (arr, _fingerprint(arr), _strictly_ascending(arr))
        with _dict_lock:
            _WIRE_FORM[d] = form
    return form


def held_dictionaries() -> dict:
    """fingerprint -> Dictionary of the wire dictionaries of at least
    _ADVERTISE_MIN_BYTES this process holds adopted: what a receiver
    advertises before a stream (its ``have``). The returned dict holds
    them for as long as it lives."""
    with _dict_lock:
        return {fp: d for fp, (arr, d) in _ADOPTED.items()
                if arr.nbytes >= _ADVERTISE_MIN_BYTES}


def advertised(held: dict) -> list:
    """The fingerprints of ``held`` (fingerprint -> Dictionary, as a
    decode filled it) that a receiver advertises: those of at least
    _ADVERTISE_MIN_BYTES."""
    return [fp for fp, d in held.items()
            if _wire_form(d)[0].nbytes >= _ADVERTISE_MIN_BYTES]


def _adopted_dictionary(arrow_values,
                        fp: Optional[str] = None) -> Optional[Dictionary]:
    """The Dictionary for a wire column's dictionary values (``fp``: their
    fingerprint, as the sender computed it), or None when the values are
    not strictly ascending. Equal values arriving again (the same column
    on another stream or frame) map to the same Dictionary object while
    _ADOPTED keeps it, so tables decoded from them concatenate without
    remapping codes."""
    global _adopted_bytes

    if fp is None:
        fp = _fingerprint(arrow_values)
    with _dict_lock:
        hit = _ADOPTED.get(fp)
        if hit is not None:
            _ADOPTED.move_to_end(fp)
            return hit[1]
    if not _strictly_ascending(arrow_values):
        return None
    import pyarrow as pa

    dvals = np.asarray(arrow_values.to_numpy(zero_copy_only=False),
                       dtype=object)
    d = Dictionary(dvals)
    # a copy: the received array is a view of its whole payload's buffers
    kept = pa.array(dvals, type=pa.string())
    with _dict_lock:
        hit = _ADOPTED.get(fp)  # another thread adopted it meanwhile
        if hit is not None:
            _ADOPTED.move_to_end(fp)
            return hit[1]
        _ADOPTED[fp] = (kept, d)
        _WIRE_FORM[d] = (kept, fp, True)
        _adopted_bytes += kept.nbytes
        while len(_ADOPTED) > 1 and _adopted_bytes > _ADOPTED_MAX_BYTES:
            _adopted_bytes -= _ADOPTED.popitem(last=False)[1][0].nbytes
    return d


def schema_from_arrow(arrow_schema) -> Schema:
    return Schema(
        [
            Field(f.name, _arrow_type_to_dtype(f.type), nullable=f.nullable)
            for f in arrow_schema
        ]
    )


def arrow_to_host_columns(
    arrow_table,
    dictionaries: Optional[dict[str, Dictionary]] = None,
    held: Optional[dict[str, Dictionary]] = None,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray], dict[str, Dictionary], Schema]:
    """Arrow table -> (host data arrays, validity arrays, dictionaries, schema).

    String columns become int32 code arrays. If ``dictionaries`` supplies a
    Dictionary for a column, codes are produced against it (values missing
    from the dictionary become -1/null); otherwise a fresh sorted dictionary
    is built from the column's values.

    Wire payloads (`table_to_arrow` with ``whole_dictionaries``) name each
    string column's dictionary by fingerprint (``dftpu_dict_fps``). A
    column they list under ``dftpu_dict_refs`` ships its codes alone: its
    dictionary is taken from ``held`` (fingerprint -> Dictionary: the
    ones the receiver advertised before the stream, and those earlier
    payloads of the stream or frame carried) or, failing that, from the
    process's adopted dictionaries; `DictionaryMissing` when neither has
    it. The dictionaries of every payload with rows are recorded into
    ``held`` (an IPC stream of no rows carries no dictionary values).
    """
    import pyarrow as pa
    import pyarrow.compute as pc

    schema = schema_from_arrow(arrow_table.schema)
    meta = arrow_table.schema.metadata or {}
    refs, fps = set(), {}
    if b"dftpu_dict_fps" in meta:
        import json as _json

        fps = _json.loads(meta[b"dftpu_dict_fps"].decode())
        refs = set(_json.loads(meta.get(b"dftpu_dict_refs", b"[]").decode()))
    if b"dftpu_logical" in meta:
        # wire payloads carry their LOGICAL dtypes (runtime/codec.py): the
        # physical arrow width reflects the sender's precision mode, not
        # the column's logical type
        import json as _json

        logical = _json.loads(meta[b"dftpu_logical"].decode())
        schema = Schema([
            Field(f.name, DataType(logical.get(f.name, f.dtype.value)),
                  f.nullable)
            for f in schema.fields
        ])
    data: dict[str, np.ndarray] = {}
    validity: dict[str, np.ndarray] = {}
    dicts: dict[str, Dictionary] = {}
    for f in schema.fields:
        col = arrow_table.column(f.name)
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        null_mask = np.asarray(col.is_valid())
        if f.dtype == DataType.STRING:
            provided0 = dictionaries.get(f.name) if dictionaries else None
            if pa.types.is_dictionary(col.type) and provided0 is None:
                # wire fast path: a dictionary array arriving from
                # encode_table carries a sorted dictionary (GC'd, or the
                # column's whole one, or a reference to one the receiver
                # holds) — adopt it and its codes directly instead of
                # decoding + re-uniquing (the receive half of the
                # reference's dictionary handling,
                # `impl_execute_task.rs:184-201` DictionaryHandling::Resend)
                fp = fps.get(f.name)
                if f.name in refs:
                    adopted = (held or {}).get(fp)
                    if adopted is None:
                        with _dict_lock:
                            hit = _ADOPTED.get(fp)
                        if hit is None:
                            raise DictionaryMissing([fp])
                        adopted = hit[1]
                else:
                    adopted = _adopted_dictionary(col.dictionary, fp)
                    if (adopted is not None and held is not None
                            and fp is not None and arrow_table.num_rows):
                        held[fp] = adopted
                if adopted is not None:
                    import pyarrow.compute as pc

                    idx = col.indices
                    if not null_mask.all():
                        idx = pc.fill_null(idx, 0)
                    codes = np.asarray(
                        idx.to_numpy(zero_copy_only=False)
                    ).astype(np.int32)
                    codes = np.where(null_mask, codes, 0).astype(np.int32)
                    data[f.name] = codes
                    dicts[f.name] = adopted
                    validity[f.name] = null_mask
                    continue
            if pa.types.is_dictionary(col.type):
                col = col.cast(pa.string())
            values = np.asarray(col.to_numpy(zero_copy_only=False), dtype=object)
            strs = np.where(null_mask, values, "").astype(str)
            provided = dictionaries.get(f.name) if dictionaries else None
            if provided is not None:
                d = provided
            else:
                d = Dictionary(np.unique(strs[null_mask]).astype(object))
            # Vectorized encode: a sorted dictionary admits searchsorted with
            # an equality check for absent values; unsorted (caller-provided)
            # dictionaries fall back to the exact hash-map path.
            if len(d.values) == 0:
                codes = np.full(len(strs), -1, dtype=np.int32)
            elif d.is_sorted():
                sorted_vals = d.values.astype(str)
                pos = np.searchsorted(sorted_vals, strs)
                pos_c = np.clip(pos, 0, len(sorted_vals) - 1).astype(np.int32)
                found = sorted_vals[pos_c] == strs
                codes = np.where(found, pos_c, -1).astype(np.int32)
            else:
                idx = d.index()
                codes = np.asarray(
                    [idx.get(v, -1) for v in strs], dtype=np.int32
                )
            null_mask = null_mask & (codes >= 0)
            codes = np.where(codes < 0, 0, codes)
            data[f.name] = codes
            dicts[f.name] = d
        elif f.dtype == DataType.DATE32:
            arr = col.cast(pa.date32()).to_numpy(zero_copy_only=False)
            days = arr.astype("datetime64[D]").astype(np.int64).astype(np.int32)
            days = np.where(null_mask, days, 0).astype(np.int32)
            data[f.name] = days
        elif f.dtype == DataType.BOOL:
            arr = col.to_numpy(zero_copy_only=False)
            arr = np.asarray(arr, dtype=object)
            arr = np.where(null_mask, arr, False)
            data[f.name] = arr.astype(np.bool_)
        else:
            # Fill nulls inside Arrow first: pyarrow's to_numpy converts
            # nullable int columns through float64, which silently rounds
            # int64 values above 2^53 — fatal for join keys. fill_null keeps
            # the column in its native width. Timestamps flow through int64
            # epoch values (cast), dates already handled above. Real (valid)
            # NaN payloads in float columns are preserved as-is.
            if pa.types.is_timestamp(col.type):
                col = col.cast(pa.int64())
            elif pa.types.is_decimal(col.type):
                col = col.cast(pa.float64())
            if not null_mask.all():
                col = pc.fill_null(col, 0)
            arr = col.to_numpy(zero_copy_only=False)
            # Keep the column's native (wide) width here: Column.from_numpy
            # owns the narrowing and range-checks it loudly in tpu precision
            # mode. An astype here would wrap int64 join keys / timestamps
            # silently before the guard could see the wide dtype.
            if np.issubdtype(np.asarray(arr).dtype, np.integer):
                data[f.name] = np.asarray(arr)
            else:
                data[f.name] = np.asarray(arr).astype(
                    f.dtype.logical_np_dtype
                )
        validity[f.name] = null_mask
    return data, validity, dicts, schema


def read_parquet(
    paths: str | Sequence[str],
    columns: Optional[Sequence[str]] = None,
    capacity: Optional[int] = None,
    dictionaries: Optional[dict[str, Dictionary]] = None,
    device=None,
) -> Table:
    """Read parquet file(s) into a single padded device Table."""
    import pyarrow.parquet as pq
    import pyarrow as pa

    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    tables = [pq.read_table(p, columns=list(columns) if columns else None) for p in paths]
    arrow_table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
    return arrow_to_table(arrow_table, capacity=capacity,
                          dictionaries=dictionaries, device=device)


def arrow_to_table(
    arrow_table,
    capacity: Optional[int] = None,
    dictionaries: Optional[dict[str, Dictionary]] = None,
    device=None,
    held: Optional[dict[str, Dictionary]] = None,
) -> Table:
    """``held`` as for `arrow_to_host_columns`."""
    data, validity, dicts, schema = arrow_to_host_columns(
        arrow_table, dictionaries, held)
    n = arrow_table.num_rows
    cap = capacity or round_up_pow2(max(n, 1))
    return Table.from_numpy(
        data, schema, capacity=cap, validity=validity, dictionaries=dicts,
        device=device,
    )


def table_to_arrow(table: Table, dictionary_gc: bool = False,
                   logical_metadata: bool = False,
                   whole_dictionaries: bool = False,
                   sent: Optional[set] = None):
    """Device Table -> Arrow table (host materialization).

    Default shape decodes strings to plain arrays (pandas-friendly). The
    WIRE shape (``dictionary_gc=True``) instead ships string columns as
    dictionary arrays whose dictionaries are garbage-collected to only the
    values the live rows reference — the reference's dictionary/view-array
    GC before Flight encode (`impl_execute_task.rs:244-274`): a slice
    referencing 10 of a 100k-value dictionary ships 10 values, and
    repeated strings ship as int32 codes. The GC'd subset of a sorted
    dictionary stays sorted, so the receiver adopts it directly
    (arrow_to_host_columns fast path). ``logical_metadata=True`` attaches
    the columns' LOGICAL dtypes as schema metadata: physical arrow widths
    narrow in tpu precision mode (FLOAT64 logical -> f32 device data), and
    a consumer inferring dtypes from the wire would otherwise disagree
    with a same-worker bypass pull of the identical table.

    ``whole_dictionaries=True`` ships each string column as a dictionary
    array over the column's WHOLE dictionary with its codes unchanged, so
    the receiver adopts a dictionary equal to the sender's and the same
    codes (the gRPC tier: a hash exchange downstream routes string keys by
    their codes, which must mean the same string in every task, as they
    do when the tasks share one dictionary in process). Each such column's
    dictionary is named by its fingerprint (``dftpu_dict_fps``). ``sent``
    (one stream or frame of payloads): the fingerprints of the
    dictionaries the receiver holds — those it advertised and those
    earlier payloads carried; a column whose dictionary is among them
    ships its codes alone, listed under ``dftpu_dict_refs``, and the
    dictionaries of every payload with rows are added to it. A dictionary
    the receiver would not adopt (not strictly ascending) always ships
    whole."""
    import pyarrow as pa

    n = int(table.num_rows)
    arrays = []
    names = []
    refs = []
    fps = {}
    for name, col in zip(table.names, table.columns):
        vals = col.data[:n].cpu().numpy()
        mask = None
        if col.validity is not None:
            mask = ~col.validity[:n].cpu().numpy()
        if col.dtype == DataType.STRING and whole_dictionaries:
            assert col.dictionary is not None
            codes = vals.astype(np.int64)
            valid = np.ones(n, dtype=bool) if mask is None else ~mask
            live = valid & (codes >= 0) & (
                codes < len(col.dictionary.values)
            )
            values, fp, adoptable = _wire_form(col.dictionary)
            fps[name] = fp
            known = adoptable and sent is not None and fp in sent
            if known:
                refs.append(name)
            elif adoptable and sent is not None and n:
                sent.add(fp)
            arrays.append(pa.DictionaryArray.from_arrays(
                pa.array(np.where(live, codes, 0).astype(np.int32),
                         mask=~live),
                pa.array([], type=pa.string()) if known else values,
                safe=not known,
            ))
        elif col.dtype == DataType.STRING and dictionary_gc:
            assert col.dictionary is not None
            codes = vals.astype(np.int64)
            valid = np.ones(n, dtype=bool) if mask is None else ~mask
            live = valid & (codes >= 0) & (
                codes < len(col.dictionary.values)
            )
            used = np.unique(codes[live])
            subset = col.dictionary.values[used]
            fill = used[0] if len(used) else 0
            new_codes = np.searchsorted(
                used, np.where(live, codes, fill)
            ).astype(np.int32)
            arrays.append(pa.DictionaryArray.from_arrays(
                pa.array(new_codes, mask=~live),
                pa.array(subset.tolist(), type=pa.string()),
            ))
        elif col.dtype == DataType.STRING:
            assert col.dictionary is not None
            decoded = col.dictionary.decode(vals)
            if mask is not None:
                decoded = decoded.copy()
                decoded[mask] = None
            arrays.append(pa.array(decoded.tolist(), type=pa.string()))
        elif col.dtype == DataType.DATE32:
            arr = pa.array(vals.astype(np.int32), type=pa.int32(), mask=mask)
            arrays.append(arr.cast(pa.date32()))
        else:
            arrays.append(pa.array(vals, mask=mask))
        names.append(name)
    out = pa.table(dict(zip(names, arrays)))
    if logical_metadata:
        import json as _json

        meta = {
            b"dftpu_logical": _json.dumps({
                name: col.dtype.value
                for name, col in zip(table.names, table.columns)
            }).encode()
        }
        if fps:
            meta[b"dftpu_dict_fps"] = _json.dumps(fps).encode()
        if refs:
            meta[b"dftpu_dict_refs"] = _json.dumps(refs).encode()
        out = out.replace_schema_metadata(meta)
    return out
