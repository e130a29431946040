"""Exchange data plane (port of the reference `parallel/exchange.py`).

Only the plan-time split is ported so far: `partition_table` cuts a leaf
table into per-task row ranges when the distributed planner gives a stage
more than one task. The collectives (hash shuffle, broadcast, coalesce)
come with the execution of exchanges across tasks (ROADMAP A.2).
"""

from __future__ import annotations

import torch

from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Table,
    round_up_pow2,
)


def partition_table(table: Table, num_parts: int) -> list[Table]:
    """Split a Table into ``num_parts`` contiguous row-range slices of equal
    padded capacity (the reference's arithmetic: ceil(rows / parts) rows a
    slice, capacity its power of two, at least 8). Slice i holds rows
    [i * per, (i + 1) * per) and zeros beyond them.

    The copy runs on the table's device. It reads ``num_rows`` once (one
    host sync) and makes one padded [parts, capacity] tensor a column, of
    which each slice's column is a row, filled by at most two copies (the
    full slices, then the last partial one); the row counts travel in one
    host-to-device copy."""
    n = int(table.num_rows)
    per = (n + num_parts - 1) // num_parts if num_parts else 0
    cap = max(round_up_pow2(max(per, 1)), 8)
    counts = [max(0, min(per, n - i * per)) for i in range(num_parts)]

    def split(data: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((num_parts, cap), dtype=data.dtype,
                          device=data.device)
        full = n // per if per else 0  # slices holding `per` rows
        if full:
            out[:full, :per] = data[:full * per].reshape(full, per)
        if full < num_parts and n > full * per:
            out[full, :n - full * per] = data[full * per:n]
        return out

    parts = [split(c.data) for c in table.columns]
    valids = [split(c.validity) if c.validity is not None else None
              for c in table.columns]
    rows = torch.tensor(counts, dtype=torch.int32, device=table.device)
    out = []
    for i in range(num_parts):
        cols = tuple(
            Column(d[i], v[i] if v is not None else None, c.dtype,
                   c.dictionary)
            for d, v, c in zip(parts, valids, table.columns)
        )
        out.append(Table(table.names, cols, rows[i]))
    return out
