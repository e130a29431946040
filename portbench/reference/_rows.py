"""Row helpers shared by the plain references: grouping, sorting and the
expected-result record that `harness/compare.py` reads. Plain PyTorch."""

from __future__ import annotations

import numpy as np
import torch


def tensor(values, device=None) -> torch.Tensor:
    t = values if isinstance(values, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(values))
    return t if device is None else t.to(device)


def group(keys: list) -> tuple:
    """Group rows by the int64 key columns. -> (group of each row, [each
    key column's value per group]), groups in ascending key order."""
    keys = [k.to(torch.int64) for k in keys]
    combined, ranges, radix = None, [], 1
    for k in keys:
        lo = int(k.min()) if k.numel() else 0
        hi = int(k.max()) if k.numel() else 0
        ranges.append((lo, hi - lo + 1))
        radix *= hi - lo + 1
    if radix < 2**62:
        for k, (lo, span) in zip(keys, ranges):
            part = k - lo
            combined = part if combined is None else combined * span + part
        if combined is None:
            combined = torch.zeros(0, dtype=torch.int64)
        uniq, inv = torch.unique(combined, return_inverse=True)
        out = []
        rest = uniq
        for lo, span in reversed(ranges):
            out.append(rest % span + lo)
            rest = rest // span
        return inv, out[::-1]
    stacked = torch.stack(keys, dim=1)
    uniq, inv = torch.unique(stacked, dim=0, return_inverse=True)
    return inv, [uniq[:, i] for i in range(len(keys))]


def count(inv: torch.Tensor, groups: int) -> torch.Tensor:
    return torch.bincount(inv, minlength=groups).to(torch.int64)


def total(inv: torch.Tensor, values: torch.Tensor, groups: int):
    """Per-group sums: int64 for integers, float64 for floats."""
    dtype = torch.float64 if values.is_floating_point() else torch.int64
    out = torch.zeros(groups, dtype=dtype, device=values.device)
    return out.index_add_(0, inv, values.to(dtype))


def lowest(inv: torch.Tensor, values: torch.Tensor, groups: int):
    out = torch.full((groups,), torch.iinfo(torch.int64).max
                     if not values.is_floating_point() else float("inf"),
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, inv, values, reduce="amin")


def distinct_count(inv: torch.Tensor, values: torch.Tensor, groups: int):
    """COUNT(DISTINCT values) per group."""
    _pair, (g, _v) = group([inv, values])
    return torch.bincount(g, minlength=groups).to(torch.int64)


def result(columns: list, order=(), limit=None, offset: int = 0,
           slack: int = 64, optional=None, min_rows: int = 0) -> dict:
    """Sort the rows by ``order`` ([(column index, descending)]), keep
    those up to the cut at ``offset + limit`` with every row tied with the
    last one before it and ``slack`` more, and return the expected-result
    record (see `harness/compare.py`)."""
    n = int(tensor(columns[0][1]).shape[0]) if columns else 0
    if order and n:
        dev = tensor(columns[0][1]).device
        idx = torch.arange(n, device=dev)
        for i, desc in reversed(list(order)):
            key = tensor(columns[i][1]).to(dev)[idx]
            idx = idx[torch.sort(key, stable=True, descending=desc).indices]
        end = n
        if limit is not None and offset + limit < n:
            cut = offset + limit - 1
            keys = [tensor(columns[i][1]).to(dev)[idx] for i, _d in order]
            tied = torch.ones(n, dtype=torch.bool, device=dev)
            for k in keys:
                tied &= k == k[cut]
            last = int(torch.nonzero(tied).flatten().max())
            end = min(n, max(last + 1, cut + 1) + slack)
        idx = idx[:end]
        columns = [(name, _take(v, idx), d) for name, v, d in columns]
        if optional is not None:
            optional = _take(optional, idx)
    return {"columns": columns, "order": list(order), "limit": limit,
            "offset": offset, "optional": optional, "min_rows": min_rows}


def _take(values, idx: torch.Tensor):
    if isinstance(values, torch.Tensor):
        return values[idx.to(values.device)]
    return np.asarray(values)[idx.cpu().numpy()]
