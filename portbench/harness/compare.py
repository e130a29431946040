"""The comparison of a query's result with the plain reference's.

A reference function returns an *expected* result (a dict):

- ``columns``: ``[(name, values, dictionary), ...]`` in output order.
  ``values`` is a numpy array or a torch tensor; ``dictionary`` is a sorted
  array of strings when ``values`` are codes into it, else None (then string
  values are given as strings). ``name`` None matches any output name. A
  column whose name starts with ``#`` is hidden: it is not in the output and
  serves only the order (a sort key that the query does not select).
- ``order``: ``[(column index, descending), ...]``: the query's ORDER BY;
  the reference's rows are sorted by it.
- ``limit``, ``offset``: the query's LIMIT and OFFSET. The rows may end
  anywhere after position ``offset + limit``, as long as every row tied with
  the one at ``offset + limit - 1`` is kept.
- ``optional``: a bool mask of rows that may be missing (a HAVING or an
  equality on floats whose outcome lies within the float tolerance), with
  ``min_rows`` the fewest rows the answer may have. Only without LIMIT.

A program result is right when it has as many rows as the query allows,
each row is a distinct row of the reference (integers, strings and dates
equal; floats within ``rtol`` of the reference's, relative to the largest
magnitude in that column of the reference's rows, and at least ``floor``:
the repository's convention, since a float32 group sum errs by a share of
the column's scale, not of the group's own value), and its rows follow the reference's order: the
sort keys of the rows it matched equal, position by position, the keys of
the reference's rows at ``offset .. offset + rows``. Ties may so come in any
order and in any choice at the cut. `compare` returns the first fault it
finds (or "") and the largest float error of the rows it matched.
"""

from __future__ import annotations

import numpy as np
import torch

#: above this many reference rows, rows are looked up on the reference's
#: device, one program row at a time
HOST_ROWS = 1 << 20


def _program_columns(out: dict) -> list:
    cols = []
    for name, vals in out.items():
        if isinstance(vals, np.ma.MaskedArray):
            if vals.mask.any():
                raise ValueError(f"column {name} has nulls")
            vals = vals.data
        if np.issubdtype(vals.dtype, np.datetime64):
            vals = vals.astype(np.int64)
        cols.append((name.split(".")[-1], np.asarray(vals)))
    return cols


def _ref_tensor(values) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values
    return torch.from_numpy(np.ascontiguousarray(values))


def _encode(ref_values, dictionary, prog_values):
    """String columns as int64 codes on both sides: codes into the
    reference's dictionary (a program string it lacks gets -1)."""
    if dictionary is None:
        strs = np.asarray(ref_values).astype(str)
        dictionary, codes = np.unique(strs, return_inverse=True)
        ref = torch.from_numpy(codes.astype(np.int64).reshape(-1))
    else:
        ref = _ref_tensor(ref_values).to(torch.int64)
    index = {s: i for i, s in enumerate(np.asarray(dictionary).tolist())}
    prog = np.array([-1 if v is None else index.get(str(v), -1)
                     for v in prog_values], dtype=np.int64)
    return ref, prog


def _is_string(values, dictionary) -> bool:
    if dictionary is not None:
        return True
    if isinstance(values, torch.Tensor):
        return False
    return values.dtype.kind in "OUS"


def _scale(values: torch.Tensor, floor: float) -> float:
    finite = values[torch.isfinite(values)]
    return max(float(finite.abs().max()) if finite.numel() else 0.0, floor)


def compare(out: dict, expected: dict, rtol: float, floor: float):
    """-> (fault or "", largest float error of the matched rows)."""
    prog = _program_columns(out)
    cols = expected["columns"]
    shown = [c for c in cols if not (c[0] or "").startswith("#")]
    if len(prog) != len(shown):
        return (f"{len(prog)} columns, expected {len(shown)}: "
                f"{[n for n, _ in prog]}"), 0.0
    n_prog = len(prog[0][1]) if prog else 0
    ref, pvals, kinds = [], [], []
    it = iter(prog)
    for name, values, dictionary in cols:
        hidden = (name or "").startswith("#")
        pname, pv = (None, None) if hidden else next(it)
        if name is not None and not hidden and pname.lower() != name.lower():
            return f"column {pname!r}, expected {name!r}", 0.0
        if _is_string(values, dictionary):
            r, p = _encode(values, dictionary,
                           pv if pv is not None else np.array([]))
            kind = "exact"
        else:
            r = _ref_tensor(values)
            kind = "float" if r.dtype.is_floating_point else "exact"
            r = r.to(torch.float64 if kind == "float" else torch.int64)
            if pv is not None:
                if pv.dtype == object or pv.dtype.kind not in "biuf":
                    return f"column {pname!r} holds {pv.dtype}", 0.0
                p = pv.astype(np.float64 if kind == "float" else np.int64)
        ref.append(r)
        pvals.append(None if hidden else p)
        kinds.append(("hidden-" if hidden else "") + kind)
    n_ref = int(ref[0].shape[0]) if ref else 0
    order = expected.get("order", [])
    limit, offset = expected.get("limit"), expected.get("offset", 0)
    optional = expected.get("optional")
    if optional is not None:
        optional = _ref_tensor(optional).to(torch.bool).cpu().numpy()
        lo = max(int((~optional).sum()), expected.get("min_rows", 0))
        hi = n_ref
    else:
        lo = hi = max(0, n_ref - offset)
        if limit is not None:
            lo = hi = min(lo, limit)
    if not lo <= n_prog <= hi:
        want = lo if lo == hi else f"{lo}..{hi}"
        return f"{n_prog} rows, expected {want}", 0.0
    scales = [_scale(r, floor) if k.endswith("float") else 1.0
              for r, k in zip(ref, kinds)]
    matched, err = _match(ref, pvals, kinds, scales, n_prog, rtol)
    if isinstance(matched, str):
        return matched, err
    if optional is not None:
        required = np.flatnonzero(~optional)
        missing = np.setdiff1d(required, np.asarray(matched, dtype=np.int64))
        if len(missing):
            return f"{len(missing)} required rows missing", err
    if order:
        keys = [(ref[i], desc, kinds[i].endswith("float"), scales[i])
                for i, desc in order]
        fault = _check_order(keys, matched, offset, optional is not None,
                             rtol)
        if fault:
            return fault, err
    return "", err


def _match(ref, pvals, kinds, scales, n_prog, rtol):
    """Each program row -> a distinct reference row: equal exact columns,
    then the earliest unused row in the reference's order whose floats are
    within the tolerance. -> (list of reference rows | fault, max error)."""
    exact = [i for i, k in enumerate(kinds) if k == "exact"]
    floats = [i for i, k in enumerate(kinds) if k == "float"]
    n_ref = int(ref[0].shape[0]) if ref else 0
    used: set = set()
    matched = []
    worst = 0.0
    on_host = n_ref <= HOST_ROWS
    if on_host:
        host = [r.cpu().numpy() for r in ref]
        buckets: dict = {}
        ekeys = list(zip(*[host[i].tolist() for i in exact])) if exact \
            else [()] * n_ref
        for row, key in enumerate(ekeys):
            buckets.setdefault(key, []).append(row)
    for j in range(n_prog):
        key = tuple(int(pvals[i][j]) for i in exact)
        if on_host:
            cands = buckets.get(key, [])
        else:
            mask = torch.ones(n_ref, dtype=torch.bool, device=ref[0].device)
            for i, v in zip(exact, key):
                mask &= ref[i] == v
            cands = torch.nonzero(mask).flatten().tolist()
        best, best_err = None, None
        for row in cands:
            if row in used:
                continue
            e = 0.0
            for i in floats:
                r = float(host[i][row]) if on_host else float(ref[i][row])
                p = float(pvals[i][j])
                if np.isnan(p) or np.isnan(r):
                    # a NULL on one side only: wholly wrong
                    e = max(e, 0.0 if np.isnan(p) and np.isnan(r) else 1.0)
                else:
                    e = max(e, abs(p - r) / scales[i])
            if e <= rtol:
                best, best_err = row, e
                break
            if best_err is None or e < best_err:
                best, best_err = row, e
        if best is None:
            return f"row {j} {key} is not in the reference", worst
        worst = max(worst, best_err)
        if best_err > rtol:
            return (f"row {j} {key}: a float differs by {best_err:.3g} "
                    "of the reference"), worst
        used.add(best)
        matched.append(best)
    return matched, worst


def _key_cmp(a, b, desc, is_float, scale, rtol) -> int:
    """-1 if a sorts before b, 0 if tied (floats within the tolerance)."""
    if is_float and abs(a - b) <= rtol * scale:
        return 0
    if a == b:
        return 0
    before = a > b if desc else a < b
    return -1 if before else 1


def _check_order(keys, matched, offset, optional, rtol) -> str:
    def tuple_of(row):
        return [float(r[row]) if f else int(r[row]) for r, _d, f, _s in keys]

    seq = [tuple_of(row) for row in matched]
    if optional:
        pairs = zip(seq, seq[1:])
        for pos, (a, b) in enumerate(pairs):
            for (_r, desc, f, sc), x, y in zip(keys, a, b):
                c = _key_cmp(x, y, desc, f, sc, rtol)
                if c > 0:
                    return f"rows {pos} and {pos + 1} out of order"
                if c < 0:
                    break
        return ""
    for pos, got in enumerate(seq):
        want = tuple_of(offset + pos)
        for (_r, desc, f, sc), x, y in zip(keys, got, want):
            if _key_cmp(x, y, desc, f, sc, rtol) != 0:
                return (f"row {pos} sorts as {got}, the reference's row "
                        f"{offset + pos} as {want}")
    return ""


def as_output(expected: dict) -> dict:
    """An expected result rendered as a program's output: the rows at
    ``offset .. offset + limit`` in the reference's order, hidden columns
    left out, strings decoded (the control puts a reference in the
    program's place so)."""
    offset, limit = expected.get("offset", 0), expected.get("limit")
    out = {}
    for i, (name, values, dictionary) in enumerate(expected["columns"]):
        if (name or "").startswith("#"):
            continue
        v = values.cpu().numpy() if isinstance(values, torch.Tensor) \
            else np.asarray(values)
        v = v[offset:None if limit is None else offset + limit]
        if dictionary is not None:
            v = np.asarray(dictionary, dtype=object)[v.astype(np.int64)]
        out[name or f"column{i}"] = v
    return out
