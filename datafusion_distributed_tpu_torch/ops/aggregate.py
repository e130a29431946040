"""Hash GROUP BY aggregation (port of the reference `ops/aggregate.py`).

The group table is built by the claim loop of the reference — computed on
the card by the CUDA group-build kernel (`ops/hash_kernels.py`), on the CPU
by its plain PyTorch version — so every row gets the same slot as in the
reference and the output row order (slot order) is the same.

Aggregates then reduce by slot id (`SegmentSum`, `segment_minmax`). Float
sums must be run-to-run identical, and a float scatter-add on the card adds
in whatever order its atomics land, so float sums are sort-based segment
reductions; integer sums, counts, minima and maxima go to the per-slot fold
(`hash_kernels.group_fold`, kernel 4), since integer adds, minima and maxima
do not depend on their order.

Group keys may be any fixed-width device dtype (dict codes included); nulls
group together (SQL semantics), tracked via a folded-in validity lane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_distributed_tpu_torch import precision
from datafusion_distributed_tpu_torch.ops import hash_kernels
from datafusion_distributed_tpu_torch.ops.hash import fold_payload, hash_columns
from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Table,
    nonzero_static,
)
from datafusion_distributed_tpu_torch.schema import DataType

_LANE = precision.LANE_TORCH
_ACC_INT = precision.ACC_INT_TORCH

#: aggregate functions whose partial states merge exactly (avg through its
#: sum and count), so the distributed planner may push them below a
#: shuffle (planner/distributed.py `_partial_agg_pushdown_pass`). The
#: variance family decomposes too, but its three states widen the exchange.
PUSHDOWN_DECOMPOSABLE_FUNCS = frozenset(
    {"sum", "count", "count_star", "min", "max", "avg"}
)


@dataclass(frozen=True)
class AggSpec:
    """One aggregate: func in {sum,count,count_star,min,max,avg} or the
    variance family."""

    func: str
    input_name: Optional[str]  # None for count_star
    output_name: str


@dataclass
class GroupTable:
    """Result of the claim loop: per-row group ids + per-slot key columns."""

    group_ids: torch.Tensor  # [N] int32 slot per row (garbage for dead rows)
    slot_used: torch.Tensor  # [H] bool
    slot_keys: list  # per key column: [H] values
    slot_key_valid: list  # per key column: [H] bool or None
    num_groups: torch.Tensor  # 0-d int32
    overflow: torch.Tensor  # 0-d bool: table too small, results invalid


class SegmentSum:
    """Per-slot sums over one group-id vector: ``SegmentSum(gid, H)(vals)``
    -> [H]. Rows with gid == H drop out (the reference's ``mode="drop"``
    scatter), and so do the rows at or past ``num_rows`` (a 0-d tensor: the
    live prefix), when given.

    Integer sums are one per-slot fold (kernel 4): integer adds, wrapping
    included, give the same result in any order. Float sums must be
    run-to-run identical (the reference promises it), but a float
    scatter-add on the card adds in the order its atomics land. They reduce
    the rows sorted by slot instead: one stable sort of ``gid`` over the
    whole capacity, shared by every float sum over it, then
    ``torch.segment_reduce``, which reduces each slot's rows in a fixed
    order. (PyTorch's deterministic ``index_add_`` serialises the rows of a
    slot and took seconds per query at TPC-H SF 1: see PERF.md.)
    """

    def __init__(self, gid: torch.Tensor, num_slots: int,
                 num_rows: Optional[torch.Tensor] = None):
        self.gid = gid
        self.num_slots = num_slots
        self.num_rows = num_rows
        self._order: Optional[torch.Tensor] = None
        self._lengths: Optional[torch.Tensor] = None

    def __call__(self, vals: torch.Tensor,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        vals = vals.to(dtype or vals.dtype)
        if not vals.dtype.is_floating_point:
            return hash_kernels.group_fold(self.gid, vals, self.num_slots,
                                           "sum", self.num_rows)
        if self._order is None:
            self._order = torch.argsort(self.gid.to(torch.int64), stable=True)
            # the sort's segments span the whole capacity: every row counts,
            # and the drop slot H holds the rows no other slot does
            counts = hash_kernels.group_fold(self.gid, None, self.num_slots,
                                             "count")
            dropped = self.gid.shape[0] - counts.sum()
            self._lengths = torch.cat([counts, dropped.reshape(1)])
        out = torch.segment_reduce(vals[self._order], "sum",
                                   lengths=self._lengths, unsafe=True,
                                   initial=0)
        return out[:self.num_slots]


def segment_minmax(vals: torch.Tensor, gid: torch.Tensor, num_slots: int,
                   op: str, num_rows: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[num_slots] per-slot MIN or MAX of ``vals``; rows with gid ==
    num_slots, or at or past ``num_rows`` when given, drop out, and empty
    slots hold the dtype's identity. Integer, dictionary-code and bool
    inputs fold in kernel 4; floats scatter-reduce."""
    if not vals.dtype.is_floating_point:
        return hash_kernels.group_fold(gid, vals, num_slots, op, num_rows)
    init = _dtype_max(vals.dtype) if op == "min" else _dtype_min(vals.dtype)
    z = torch.full((num_slots + 1,), init, dtype=vals.dtype,
                   device=vals.device)
    z.scatter_reduce_(0, gid.to(torch.int64), vals,
                      reduce="amin" if op == "min" else "amax")
    return z[:num_slots]


def _where0(mask, vals):
    return torch.where(mask, vals, torch.zeros((), dtype=vals.dtype,
                                               device=vals.device))


def _fold_key_lanes(key_cols, key_valids, lane_plan, n):
    """Keys folded to fixed-width integer lanes (int32 in tpu precision
    mode, int64 in x64 mode). Nullability is an explicit extra lane:
    column i with lane_plan[i] contributes lanes [payload-with-nulls-zeroed,
    is_valid]. Returns (lanes list, per-key-column validity lane index or
    None)."""
    keys64 = []
    valid_lane_of: list = []
    for c, v in zip(key_cols, key_valids):
        payload = fold_payload(c, _LANE)
        if v is not None:
            payload = _where0(v, payload)
        keys64.append(payload)
        valid_lane_of.append(None)
    for i, (v, want) in enumerate(zip(key_valids, lane_plan)):
        if want:
            valid_lane_of[i] = len(keys64)
            keys64.append(
                v.to(_LANE) if v is not None
                else torch.ones(n, dtype=_LANE, device=key_cols[0].device)
            )
    return keys64, valid_lane_of


def build_group_table(
    key_cols: Sequence[torch.Tensor],
    key_valids: Sequence[Optional[torch.Tensor]],
    live: torch.Tensor,
    num_slots: int,
    max_rounds: int = 512,
    lane_plan: Optional[Sequence[bool]] = None,
) -> GroupTable:
    """Assign each live row a group id (a slot in a power-of-two table).

    ``lane_plan`` fixes which key columns carry a validity lane (True).
    Joins pass the union of build+probe nullability so both sides fold to
    identical lane layouts; by default it mirrors ``key_valids``.
    """
    assert num_slots & (num_slots - 1) == 0, "num_slots must be a power of two"
    n = key_cols[0].shape[0]
    if lane_plan is None:
        lane_plan = [v is not None for v in key_valids]
    keys64, valid_lane_of = _fold_key_lanes(key_cols, key_valids, lane_plan, n)
    h0 = hash_columns(list(key_cols), list(key_valids))
    slot0 = (h0 & (num_slots - 1)).to(torch.int32)
    keys_mat = torch.stack(keys64, dim=1)  # [N, lanes]
    gid, slot_keys, slot_used, overflow, _rounds = (
        hash_kernels.build_group_ids(keys_mat, slot0, live, num_slots,
                                     max_rounds)
    )
    return _group_table_from_raw(
        gid, slot_keys, slot_used, overflow, key_cols, key_valids,
        valid_lane_of,
    )


def _group_table_from_raw(gid, slot_keys, slot_used, overflow, key_cols,
                          key_valids, valid_lane_of) -> GroupTable:
    """Unfold the raw [H, lanes] table back into per-key-column tensors."""
    out_keys = []
    out_valid = []
    for i, c in enumerate(key_cols):
        payload = slot_keys[:, i].contiguous()
        lane = valid_lane_of[i]
        out_valid.append(slot_keys[:, lane] != 0 if lane is not None else None)
        if c.dtype == torch.float64:  # x64 mode only
            out_keys.append(payload.view(torch.float64))
        elif c.dtype == torch.float32:
            out_keys.append(payload.to(torch.int32).view(torch.float32))
        else:
            out_keys.append(payload.to(c.dtype))
    return GroupTable(
        group_ids=gid,
        slot_used=slot_used,
        slot_keys=out_keys,
        slot_key_valid=out_valid,
        num_groups=torch.sum(slot_used, dtype=torch.int32),
        overflow=overflow,
    )


def hash_aggregate(
    table: Table,
    group_names: Sequence[str],
    aggs: Sequence[AggSpec],
    num_slots: int,
    mode: str = "single",  # "single" | "partial" | "final" | "partial_reduce"
    prec_flags: Optional[list] = None,
    out_capacity: Optional[int] = None,
) -> tuple[Table, torch.Tensor]:
    """GROUP BY aggregation. Returns (result table, overflow flag).

    ``prec_flags``, when given, collects device bools flagging integer SUM
    results that left int32's exact range (tpu precision mode only).
    Modes: partial emits accumulator columns, final merges them, single
    aggregates in one step, partial_reduce merges and re-emits accumulator
    columns. The result holds the groups packed to the front, in slot order.
    """
    if mode == "single" and group_names and aggs:
        fused = _try_global_hash_aggregate(
            table, group_names, aggs, num_slots, out_capacity, prec_flags
        )
        if fused is not None:
            return fused
    live = table.row_mask()
    key_cols = [table.column(g).data for g in group_names]
    key_valids = [table.column(g).validity for g in group_names]
    gt = build_group_table(key_cols, key_valids, live, num_slots)
    gid = torch.where(live, gt.group_ids, num_slots)  # dead rows drop out

    out_cols: dict[str, Column] = {}
    for g, keys, kv in zip(group_names, gt.slot_keys, gt.slot_key_valid):
        src = table.column(g)
        out_cols[g] = Column(keys, kv, src.dtype, src.dictionary)

    seg_sum = SegmentSum(gid, num_slots, table.num_rows)
    for spec in aggs:
        out_cols.update(
            _eval_agg(spec, table, gid, live, num_slots, mode, seg_sum,
                      prec_flags)
        )

    # Pack used slots to the front, into a tighter capacity when the caller
    # supplies one (groups never exceed live input rows).
    packed = Table.make(out_cols, gt.num_groups)
    out_cap = min(out_capacity or num_slots, num_slots)
    idx = nonzero_static(gt.slot_used, out_cap)
    packed = packed.gather(idx, gt.num_groups)
    overflow = gt.overflow
    if out_cap < num_slots:
        overflow = overflow | (gt.num_groups > out_cap)
    return packed, overflow


def _try_global_hash_aggregate(
    table: Table,
    group_names: Sequence[str],
    aggs: Sequence[AggSpec],
    num_slots: int,
    out_capacity: Optional[int],
    prec_flags: Optional[list],
) -> Optional[tuple[Table, torch.Tensor]]:
    """Fused group build + accumulator fold (the CUDA group-aggregate
    kernel). Engages only where it is exact: count/count(*)/sum/min/max over
    4-byte integer inputs in tpu precision mode (int32 adds and min/max do
    not depend on order). The slot layout is kernel 1's, so the result —
    row order included — equals the unfused path. Returns None when
    ineligible."""
    if np.dtype(precision.LANE_INT).itemsize != 4:
        return None
    for spec in aggs:
        if spec.func == "count_star":
            continue
        if spec.func not in ("count", "sum", "min", "max"):
            return None
        col = table.column(spec.input_name)
        if not col.dtype.is_integer:
            return None
        if col.data.element_size() != 4:
            return None

    live = table.row_mask()
    n = table.capacity
    i32 = torch.int32
    int32_max = int(np.iinfo(np.int32).max)
    int32_min = int(np.iinfo(np.int32).min)

    # accumulator plan: per agg, value columns pre-mapped so invalid rows
    # carry the op identity (the kernel has no validity lanes)
    ops: list[str] = []
    vcols: list[torch.Tensor] = []
    plan: list[tuple] = []
    for spec in aggs:
        if spec.func == "count_star":
            idx = len(ops)
            ops.append("sum")
            vcols.append(live.to(i32))
            plan.append(("count", spec.output_name, idx, None))
            continue
        col = table.column(spec.input_name)
        valid = col.valid_mask() & live
        cnt_idx = len(ops)
        ops.append("sum")
        vcols.append(valid.to(i32))
        if spec.func == "count":
            plan.append(("count", spec.output_name, cnt_idx, None))
            continue
        vidx = len(ops)
        data = col.data.to(i32)
        if spec.func == "sum":
            ops.append("sum")
            vcols.append(_where0(valid, data))
        elif spec.func == "min":
            ops.append("min")
            vcols.append(torch.where(valid, data, int32_max))
        else:
            ops.append("max")
            vcols.append(torch.where(valid, data, int32_min))
        plan.append((spec.func, spec.output_name, vidx, (cnt_idx, col)))
    if len(ops) > hash_kernels.MAX_ACCS:
        return None

    key_cols = [table.column(g).data for g in group_names]
    key_valids = [table.column(g).validity for g in group_names]
    lane_plan = [v is not None for v in key_valids]
    keys64, _ = _fold_key_lanes(key_cols, key_valids, lane_plan, n)
    h0 = hash_columns(list(key_cols), list(key_valids))
    slot0 = (h0 & (num_slots - 1)).to(i32)
    gid, rep, used, acc, overflow, _rounds = hash_kernels.group_aggregate(
        torch.stack(keys64, dim=1).to(i32), slot0, live,
        torch.stack(vcols, dim=1), num_slots, tuple(ops),
    )

    # group key columns: gather the claiming representative row — for
    # every used slot that row holds exactly the slot's key values
    safe_rep = torch.where(used, rep, 0)
    out_cols: dict[str, Column] = {}
    for g in group_names:
        src = table.column(g)
        kv = None
        if src.validity is not None:
            kv = src.validity[safe_rep] & used
        out_cols[g] = Column(src.data[safe_rep], kv, src.dtype,
                             src.dictionary)

    vgid = torch.where(live, gid, num_slots)

    seg_sum = SegmentSum(vgid, num_slots)
    i64 = DataType.INT64.torch_dtype
    for kind, name, idx, extra in plan:
        if kind == "count":
            out_cols[name] = Column(acc[:, idx].to(i64), None, DataType.INT64)
        elif kind == "sum":
            cnt_idx, col = extra
            nonempty = acc[:, cnt_idx]
            out_cols[name] = Column(acc[:, idx].to(i64), nonempty > 0,
                                    DataType.INT64)
            _check_int32_sum_range(vcols[idx], seg_sum, prec_flags)
        else:  # min / max
            cnt_idx, col = extra
            nonempty = acc[:, cnt_idx]
            out_cols[name] = Column(acc[:, idx].to(col.data.dtype),
                                    nonempty > 0, col.dtype, col.dictionary)

    num_groups = torch.sum(used, dtype=i32)
    packed = Table.make(out_cols, num_groups)
    out_cap = min(out_capacity or num_slots, num_slots)
    pack_idx = nonzero_static(used, out_cap)
    packed = packed.gather(pack_idx, num_groups)
    if out_cap < num_slots:
        overflow = overflow | (num_groups > out_cap)
    return packed, overflow


def global_aggregate(table: Table, aggs: Sequence[AggSpec], mode: str = "single",
                     prec_flags: Optional[list] = None) -> Table:
    """Aggregation with no GROUP BY: one output row (capacity 8). Shares
    the per-aggregate evaluation with hash_aggregate, with every live row
    mapped to group 0; the dead rows past the live prefix drop out of its
    integer folds."""
    live = table.row_mask()
    cap = 8
    gid = torch.zeros(table.capacity, dtype=torch.int32, device=table.device)

    seg_sum = SegmentSum(gid, cap, table.num_rows)
    cols: dict[str, Column] = {}
    for spec in aggs:
        cols.update(_eval_agg(spec, table, gid, live, cap, mode, seg_sum,
                              prec_flags))
    return Table(tuple(cols.keys()), tuple(cols.values()),
                 torch.tensor(1, dtype=torch.int32, device=table.device))


def _mean_shifted_seg_sum(vals, valid, seg_sum, group_counts):
    """Per-group float sum as seg_sum(x - m) + m*n_g (float32 storage).

    A raw float32 scatter-add over millions of same-sign values drifts
    ~sqrt(N)*eps relative; centering the residuals near zero makes the
    scatter-add cancel instead of accumulate. m only needs to be a rough
    center but must be finite (else m = 0, the raw scatter-add)."""
    m = torch.sum(vals) / torch.clamp(torch.sum(valid), min=1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = seg_sum(_where0(valid, vals - m))
    return z + m * group_counts.to(vals.dtype)


def _eval_agg(spec, table, gid, live, num_slots, mode, seg_sum,
              prec_flags=None):
    """Produce the output column(s) for one AggSpec in the given mode."""
    name = spec.output_name
    i64 = DataType.INT64.torch_dtype
    f64 = DataType.FLOAT64.torch_dtype
    if spec.func == "count_star":
        if mode in ("final", "partial_reduce"):
            acc = table.column(f"{name}")
            vals = _where0(live, acc.data)
            return {name: Column(seg_sum(vals), None, DataType.INT64)}
        cnt = seg_sum(live.to(i64))
        return {name: Column(cnt, None, DataType.INT64)}

    # sum/count/min/max: the merged accumulator IS the final value, so
    # partial_reduce and final share one merge
    if mode in ("final", "partial_reduce") and spec.func in (
        "sum", "count", "min", "max",
    ):
        acc = table.column(name)
        valid = acc.valid_mask() & live
        if spec.func in ("sum", "count"):
            vals = _where0(valid, acc.data)
            merged = seg_sum(vals)
            if spec.func == "sum":
                _check_int32_sum_range(vals, seg_sum, prec_flags)
        else:
            merged = segment_minmax(
                acc.data, torch.where(valid, gid, num_slots), num_slots,
                spec.func, seg_sum.num_rows,
            )
        nonempty = seg_sum(valid.to(_ACC_INT))
        if spec.func == "count":
            return {name: Column(merged, None, DataType.INT64)}
        return {name: Column(merged, nonempty > 0, acc.dtype, acc.dictionary)}

    if mode in ("final", "partial_reduce") and spec.func == "avg":
        s = table.column(f"{name}__sum")
        c = table.column(f"{name}__count")
        valid = live & s.valid_mask()
        ssum = seg_sum(_where0(valid, s.data))
        scnt = seg_sum(_where0(live, c.data))
        out_valid = scnt > 0
        if mode == "partial_reduce":  # keep the (sum, count) state form
            return {
                f"{name}__sum": Column(ssum, out_valid, DataType.FLOAT64),
                f"{name}__count": Column(scnt, None, DataType.INT64),
            }
        avg = ssum / torch.where(scnt == 0, 1, scnt)
        return {name: Column(avg, out_valid, DataType.FLOAT64)}

    if spec.func in _VARIANCE_FUNCS and mode in ("final", "partial_reduce"):
        s = table.column(f"{name}__sum")
        sq = table.column(f"{name}__sumsq")
        c = table.column(f"{name}__count")
        valid = live & s.valid_mask()
        ssum = seg_sum(_where0(valid, s.data))
        ssumsq = seg_sum(_where0(valid, sq.data))
        scnt = seg_sum(_where0(live, c.data))
        if mode == "partial_reduce":  # keep the (sum, sumsq, count) state
            nz = scnt > 0
            return {
                f"{name}__sum": Column(ssum, nz, DataType.FLOAT64),
                f"{name}__sumsq": Column(ssumsq, nz, DataType.FLOAT64),
                f"{name}__count": Column(scnt, None, DataType.INT64),
            }
        return {name: _variance_result(spec.func, ssum, ssumsq, scnt)}

    # partial/single over raw input
    col = table.column(spec.input_name)
    valid = col.valid_mask() & live
    vgid = torch.where(valid, gid, num_slots)

    if spec.func in _VARIANCE_FUNCS:
        vals = _where0(valid, col.data).to(f64)
        s = seg_sum(vals)
        sq = seg_sum(vals * vals)
        cnt = seg_sum(valid.to(i64))
        if mode == "partial":
            return {
                f"{name}__sum": Column(s, cnt > 0, DataType.FLOAT64),
                f"{name}__sumsq": Column(sq, cnt > 0, DataType.FLOAT64),
                f"{name}__count": Column(cnt, None, DataType.INT64),
            }
        return {name: _variance_result(spec.func, s, sq, cnt)}

    if spec.func == "count":
        cnt = seg_sum(valid.to(i64))
        return {name: Column(cnt, None, DataType.INT64)}

    if spec.func == "sum" or (spec.func == "avg" and mode == "partial"):
        acc_dtype = f64 if col.dtype.is_float else i64
        vals = _where0(valid, col.data).to(acc_dtype)
        nonempty = seg_sum(valid.to(_ACC_INT))
        if col.dtype.is_float and acc_dtype == torch.float32:
            s = _mean_shifted_seg_sum(vals, valid, seg_sum, nonempty)
        else:
            s = seg_sum(vals)
            _check_int32_sum_range(vals, seg_sum, prec_flags)
        sum_dtype = DataType.FLOAT64 if col.dtype.is_float else DataType.INT64
        if spec.func == "sum":
            return {name: Column(s, nonempty > 0, sum_dtype)}
        # partial avg: emit sum + count pair
        return {
            f"{name}__sum": Column(s.to(f64), nonempty > 0, DataType.FLOAT64),
            f"{name}__count": Column(nonempty, None, DataType.INT64),
        }

    if spec.func == "avg":  # single
        vals = _where0(valid, col.data).to(f64)
        cnt = seg_sum(valid.to(_ACC_INT))
        if vals.dtype == torch.float32:
            s = _mean_shifted_seg_sum(vals, valid, seg_sum, cnt)
        else:
            s = seg_sum(vals)
        avg = s / torch.where(cnt == 0, 1, cnt)
        return {name: Column(avg, cnt > 0, DataType.FLOAT64)}

    if spec.func in ("min", "max"):
        red = segment_minmax(col.data, vgid, num_slots, spec.func,
                             seg_sum.num_rows)
        nonempty = seg_sum(valid.to(_ACC_INT))
        return {
            name: Column(red, nonempty > 0, col.dtype, col.dictionary)
        }

    raise NotImplementedError(f"aggregate function {spec.func}")


#: SQL variance family, computed via the (sum, sumsq, count) decomposition.
_VARIANCE_FUNCS = {"stddev", "stddev_samp", "stddev_pop", "var_samp",
                   "var_pop"}


def _variance_result(func: str, s, sq, cnt):
    """(sum, sumsq, count) -> variance/stddev Column with SQL null rules
    (samp needs n>=2, pop needs n>=1)."""
    f = DataType.FLOAT64.torch_dtype
    pop = func.endswith("_pop")
    sqrt = func.startswith("stddev")
    n = cnt.to(f)
    safe_n = torch.clamp(n, min=1.0)
    mean = s.to(f) / safe_n
    m2 = sq.to(f) - n * mean * mean  # sum((x-mean)^2), up to rounding
    m2 = torch.clamp(m2, min=0.0)
    denom = safe_n if pop else torch.clamp(n - 1.0, min=1.0)
    var = m2 / denom
    out = torch.sqrt(var) if sqrt else var
    valid = cnt >= (1 if pop else 2)
    return Column(out, valid, DataType.FLOAT64)


def singleton_partial_states(table: Table, group_names, aggs) -> Table:
    """Per-row singleton partial-aggregation states: for each input row, the
    accumulator a partial aggregate would emit for a one-row group —
    schema-identical to ``hash_aggregate(mode="partial")`` over the same
    input."""
    i64 = DataType.INT64.torch_dtype
    f64 = DataType.FLOAT64.torch_dtype
    cols: dict = {}
    for g in group_names:
        cols[g] = table.column(g)
    for spec in aggs:
        name = spec.output_name
        if spec.func == "count_star":
            cols[name] = Column(
                torch.ones(table.capacity, dtype=i64, device=table.device),
                None, DataType.INT64,
            )
            continue
        col = table.column(spec.input_name)
        valid = col.valid_mask()
        one = valid.to(i64)
        if spec.func == "count":
            cols[name] = Column(one, None, DataType.INT64)
        elif spec.func == "sum":
            acc_dtype = f64 if col.dtype.is_float else i64
            vals = _where0(valid, col.data).to(acc_dtype)
            sum_dtype = (DataType.FLOAT64 if col.dtype.is_float
                         else DataType.INT64)
            cols[name] = Column(vals, valid, sum_dtype)
        elif spec.func == "avg":
            vals = _where0(valid, col.data).to(f64)
            cols[f"{name}__sum"] = Column(vals, valid, DataType.FLOAT64)
            cols[f"{name}__count"] = Column(one, None, DataType.INT64)
        elif spec.func in _VARIANCE_FUNCS:
            vals = _where0(valid, col.data).to(f64)
            cols[f"{name}__sum"] = Column(vals, valid, DataType.FLOAT64)
            cols[f"{name}__sumsq"] = Column(
                vals * vals, valid, DataType.FLOAT64
            )
            cols[f"{name}__count"] = Column(one, None, DataType.INT64)
        elif spec.func in ("min", "max"):
            cols[name] = Column(col.data, valid, col.dtype, col.dictionary)
        else:
            raise NotImplementedError(
                f"no singleton partial state for {spec.func}"
            )
    return Table(tuple(cols.keys()), tuple(cols.values()), table.num_rows)


def _check_int32_sum_range(vals, seg_sum, prec_flags):
    """tpu precision mode: int32 scatter-add wraps silently past 2^31, so
    estimate each group's sum in float32 alongside and flag when any group's
    magnitude approaches the boundary. No-op in x64 mode."""
    if prec_flags is None:
        return
    if vals.dtype != torch.int32:
        return
    est = seg_sum(vals.to(torch.float32), dtype=torch.float32)
    prec_flags.append(torch.any(torch.abs(est) > float(np.float32(2.0**31 * 0.995))))


def _dtype_max(dt: torch.dtype):
    if dt.is_floating_point:
        return float("inf")
    if dt == torch.bool:
        return True
    return torch.iinfo(dt).max


def _dtype_min(dt: torch.dtype):
    if dt.is_floating_point:
        return float("-inf")
    if dt == torch.bool:
        return False
    return torch.iinfo(dt).min
