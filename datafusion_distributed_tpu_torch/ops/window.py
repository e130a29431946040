"""Window functions: rank / row_number / running and partition aggregates
(port of the reference `ops/window.py`).

One stable sort by (partition keys, order keys), then every window quantity
is a *segmented scan* over the sorted view, and the results scatter back to
the original row order. Default SQL framing is honored: with ORDER BY,
aggregates use the RANGE UNBOUNDED-PRECEDING..CURRENT-ROW frame (peers
included) via a broadcast-to-peer-group pass; without ORDER BY they cover
the whole partition.

The reference's scan is `lax.associative_scan`; here it is a log-step
(Hillis-Steele) scan of `torch.where` passes over the static capacity. It is
exact for min, max and integer sums; a float sum is rounded along another
association tree than the reference's and agrees at `test_rtol()`. A running
sum is never formed as a global prefix minus the prefix at the segment
start: in float32 that difference cancels catastrophically over millions of
rows. Everything stays on the device, with no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_distributed_tpu_torch.ops.sort import SortKey, sort_permutation
from datafusion_distributed_tpu_torch.ops.table import Column, Table
from datafusion_distributed_tpu_torch.schema import DataType


@dataclass(frozen=True)
class WindowFunc:
    func: str  # rank|dense_rank|row_number|sum|avg|min|max|count|count_star
    input_name: Optional[str]
    output_name: str
    frame: str = "range"  # "range": peers share frame-end; "rows": per row


def _segmented_scan(vals: torch.Tensor, resets: torch.Tensor,
                    op: str) -> torch.Tensor:
    """Inclusive scan of ``vals`` restarting wherever resets[i] is True:
    ceil(log2 n) passes, each combining every element with the partial
    result ``d`` places before it (the reference's combine, applied as
    (earlier, later))."""
    if op not in ("sum", "min", "max"):
        raise NotImplementedError(op)
    v, f = vals, resets
    n = v.shape[0]
    d = 1
    while d < n:
        prev_v, prev_f = v[:-d], f[:-d]
        cur_v, cur_f = v[d:], f[d:]
        if op == "sum":
            comb = prev_v + cur_v
        elif op == "min":
            comb = torch.minimum(prev_v, cur_v)
        else:
            comb = torch.maximum(prev_v, cur_v)
        v = torch.cat([v[:d], torch.where(cur_f, cur_v, comb)])
        f = torch.cat([f[:d], cur_f | prev_f])
        d <<= 1
    return v


def _changed(col, perm: torch.Tensor) -> torch.Tensor:
    """True at sorted position 0 and wherever the column's value (or its
    validity) differs from the previous sorted row."""
    d = col.data[perm]
    head = torch.ones(1, dtype=torch.bool, device=d.device)
    changed = torch.cat([head, d[1:] != d[:-1]])
    if col.validity is not None:
        v = col.validity[perm]
        changed = changed | torch.cat([~head, v[1:] != v[:-1]])
    return changed


def _last_of_group(gid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The largest sorted index of each row's group, per row."""
    cap = idx.shape[0]
    last = torch.zeros(cap, dtype=torch.int32, device=idx.device)
    last.scatter_reduce_(0, gid.long(), idx, "amax")
    return last[gid.long()]


def window_compute(
    table: Table,
    partition_names: Sequence[str],
    order_keys: Sequence[SortKey],
    funcs: Sequence[WindowFunc],
) -> dict[str, Column]:
    """-> {output_name: Column} aligned with the table's ORIGINAL row order."""
    cap = table.capacity
    dev = table.device
    i64 = DataType.INT64.torch_dtype
    keys = [SortKey(p) for p in partition_names] + list(order_keys)
    perm = (
        sort_permutation(table, keys) if keys
        else torch.arange(cap, dtype=torch.int32, device=dev)
    ).long()
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    live_sorted = table.row_mask()[perm]

    # partition / peer boundaries in sorted order
    new_part = idx == 0
    for p in partition_names:
        new_part = new_part | _changed(table.column(p), perm)
    new_order = new_part
    for k in order_keys:
        new_order = new_order | _changed(table.column(k.name), perm)
    # dead rows sort last; give them their own partition so they don't bleed
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    new_part = new_part | torch.cat([no, live_sorted[1:] != live_sorted[:-1]])
    new_order = new_order | new_part

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    seg_start = torch.cummax(torch.where(new_part, idx, zero), dim=0).values
    rn = idx - seg_start  # 0-based row_number within partition
    rank0 = (torch.cummax(torch.where(new_order, idx, zero), dim=0).values
             - seg_start)
    dense_cum = torch.cumsum(new_order.to(i64), dim=0).to(i64)
    dense0 = dense_cum - dense_cum[seg_start.long()]

    # peer-group end index (for RANGE ..CURRENT ROW frames): the largest
    # sorted index sharing this row's peer group
    peer_gid = (torch.cumsum(new_order.to(torch.int32), dim=0) - 1).to(
        torch.int32)
    peer_end = _last_of_group(peer_gid, idx).long()

    out: dict[str, Column] = {}
    for f in funcs:
        if f.func == "row_number":
            res = (rn + 1).to(i64)
            validity = None
        elif f.func == "rank":
            res = (rank0 + 1).to(i64)
            validity = None
        elif f.func == "dense_rank":
            res = (dense0 + 1).to(i64)
            validity = None
        elif f.func in ("sum", "avg", "min", "max", "count", "count_star"):
            if f.func == "count_star":
                vals = live_sorted.to(i64)
                valid_sorted = live_sorted
            else:
                col = table.column(f.input_name)
                vals = col.data[perm]
                valid_sorted = col.valid_mask()[perm] & live_sorted
            if f.func in ("count", "count_star"):
                scan_vals = valid_sorted.to(i64)
                op = "sum"
            elif f.func == "avg":
                scan_vals = torch.where(
                    valid_sorted, vals, torch.zeros_like(vals)
                ).to(DataType.FLOAT64.torch_dtype)
                op = "sum"
            elif f.func == "sum":
                acc = (DataType.FLOAT64.torch_dtype
                       if vals.dtype.is_floating_point else i64)
                scan_vals = torch.where(
                    valid_sorted, vals, torch.zeros_like(vals)).to(acc)
                op = "sum"
            else:
                op = f.func
                fill = torch.full_like(vals, _identity(vals.dtype, op))
                scan_vals = torch.where(valid_sorted, vals, fill)
            running = _segmented_scan(scan_vals, new_part, op)
            cnt_running = _segmented_scan(valid_sorted.to(i64), new_part,
                                          "sum")
            if order_keys and f.frame == "rows":
                # ROWS frame: strictly per-row running values
                res, cnt = running, cnt_running
            elif order_keys and f.frame != "full":
                # RANGE frame: value at the END of the peer group
                res, cnt = running[peer_end], cnt_running[peer_end]
            else:
                # whole partition: value at the END of the partition
                part_gid = (torch.cumsum(new_part.to(torch.int32), dim=0)
                            - 1).to(torch.int32)
                end = _last_of_group(part_gid, idx).long()
                res, cnt = running[end], cnt_running[end]
            if f.func == "avg":
                res = res / torch.where(cnt == 0, torch.ones_like(cnt), cnt)
            if f.func in ("count", "count_star"):
                validity = None
            else:
                validity = torch.zeros(cap, dtype=torch.bool, device=dev)
                validity[perm] = cnt > 0
        else:
            raise NotImplementedError(f"window function {f.func}")

        data = torch.zeros(cap, dtype=res.dtype, device=dev)
        data[perm] = res  # result[perm[i]] = computed[i]
        dtype = _out_dtype(f, table)
        out[f.output_name] = Column(data.to(dtype.torch_dtype), validity,
                                    dtype)
    return out


def _identity(dt: torch.dtype, op: str):
    if dt.is_floating_point:
        return np.inf if op == "min" else -np.inf
    info = torch.iinfo(dt)
    return info.max if op == "min" else info.min


def window_output_dtype(func: str, input_dtype: "DataType | None") -> DataType:
    """Single source of truth for window result dtypes (used by the kernel
    and the logical schema)."""
    if func in ("rank", "dense_rank", "row_number", "count", "count_star"):
        return DataType.INT64
    if func == "avg":
        return DataType.FLOAT64
    if func == "sum":
        return (
            DataType.FLOAT64 if input_dtype is not None and input_dtype.is_float
            else DataType.INT64
        )
    return input_dtype


def _out_dtype(f: WindowFunc, table: Table) -> DataType:
    input_dtype = (
        table.column(f.input_name).dtype if f.input_name is not None else None
    )
    return window_output_dtype(f.func, input_dtype)
