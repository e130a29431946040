"""Load the benchmark's generated tables into the port's session through its
public registration, `SessionContext.register_table`.

Host columns (numpy) go through `Table.from_numpy`, as the port's own
generators load them. Columns made on the device (torch tensors, already
padded to the capacity) become the table's buffers as they are, narrowed to
the storage type of the precision mode where that differs, with a range
check that refuses to wrap, as `Table.from_numpy` does. Every column gets
an all-true validity mask over its rows, as the port's generators give.
"""

from __future__ import annotations

import numpy as np
import torch

_TYPES = {"int64": "INT64", "int32": "INT32", "float64": "FLOAT64",
          "date32": "DATE32", "string": "STRING"}


def capacity_of(rows: int) -> int:
    """The padded capacity of a table of ``rows`` rows: the next power of
    two, at least 8 (the port's `round_up_pow2`)."""
    cap = 8
    while cap < rows:
        cap *= 2
    return cap


def rows_of(table: dict) -> int:
    if "rows" in table:
        return int(table["rows"])
    return len(next(iter(table["columns"].values())))


def register(ctx, tables: dict) -> dict:
    """Register every generated table; -> {name: capacity}."""
    from datafusion_distributed_tpu_torch.ops.table import (
        Column,
        Dictionary,
        Table,
        rows_tensor,
    )
    from datafusion_distributed_tpu_torch.schema import DataType, Field, \
        Schema

    caps = {}
    for name, t in tables.items():
        n = rows_of(t)
        types = {c: DataType[_TYPES[k]] for c, k in t["types"].items()}
        dicts = {c: Dictionary(np.asarray(d, dtype=object))
                 for c, d in t["dicts"].items()}
        first = next(iter(t["columns"].values()))
        if isinstance(first, np.ndarray):
            cap = capacity_of(n)
            schema = Schema([Field(c, types[c], True) for c in t["columns"]])
            table = Table.from_numpy(
                t["columns"], schema, capacity=cap,
                validity={c: np.ones(n, dtype=np.bool_) for c in t["columns"]},
                dictionaries=dicts, device=ctx.device)
        else:
            cap = int(first.shape[0])
            live = torch.arange(cap, device=first.device) < n
            cols = []
            for c, data in t["columns"].items():
                want = types[c].torch_dtype
                if data.dtype != want:
                    data = _narrow(c, data, n, want)
                cols.append(Column(data, live.clone(), types[c],
                                   dicts.get(c)))
            table = Table(tuple(t["columns"]), tuple(cols),
                          rows_tensor(n, first.device))
        ctx.register_table(name, table)
        caps[name] = cap
    return caps


def _narrow(name: str, data: torch.Tensor, n: int, dtype) -> torch.Tensor:
    info = torch.iinfo(dtype)
    lo, hi = int(data[:n].min()), int(data[:n].max())
    if lo < info.min or hi > info.max:
        raise OverflowError(
            f"{name}: values [{lo}, {hi}] exceed {dtype} device storage")
    return data.to(dtype)
