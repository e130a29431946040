"""Hash join (inner / left / semi / anti / mark), port of the reference
`ops/join.py`.

1. BUILD: group build-side rows by key with the claim-loop group build
   (ops/aggregate.build_group_table, the CUDA group-build kernel on the card)
   -> a CSR layout (counts + offsets + rows sorted by group) enumerates
   duplicates.
2. PROBE: each probe row walks the read-only table to its key's slot (or
   none): the CUDA probe kernel with K = 1 on the card.
3. EXPAND: pair output positions come from an exclusive cumsum of per-probe
   match counts; each output row finds its probe row by searchsorted and its
   duplicate ordinal by subtraction — static capacities, no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from datafusion_distributed_tpu_torch import precision
from datafusion_distributed_tpu_torch.ops import hash_kernels
from datafusion_distributed_tpu_torch.ops.aggregate import (
    GroupTable,
    SegmentSum,
    _where0,
    build_group_table,
)
from datafusion_distributed_tpu_torch.ops.hash import fold_payload, hash_columns
from datafusion_distributed_tpu_torch.ops.table import Column, Table
from datafusion_distributed_tpu_torch.schema import DataType


def _fold_keys(cols, valids, lane_plan):
    """Payload folding with a FIXED lane layout shared by build and probe:
    ``lane_plan[i]`` == True adds a validity lane for key column i."""
    lane = precision.LANE_TORCH
    lanes = []
    for c, v in zip(cols, valids):
        payload = fold_payload(c, lane)
        if v is not None:
            payload = _where0(v, payload)
        lanes.append(payload)
    n = cols[0].shape[0]
    for v, want in zip(valids, lane_plan):
        if want:
            lanes.append(
                v.to(lane) if v is not None
                else torch.ones(n, dtype=lane, device=cols[0].device)
            )
    return torch.stack(lanes, dim=1)  # [N, lanes]


def probe_inputs(
    probe_cols: Sequence[torch.Tensor],
    probe_valids: Sequence[Optional[torch.Tensor]],
    live: torch.Tensor,
    lane_plan: Sequence[bool],
    num_slots: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One table's probe inputs: the folded key lanes [N, lanes], each
    row's first slot [N] int32 and the rows that probe at all [N] (live,
    no NULL key)."""
    n = probe_cols[0].shape[0]
    keys_mat = _fold_keys(probe_cols, probe_valids, lane_plan)
    h0 = hash_columns(list(probe_cols), list(probe_valids))
    slot = (h0 & (num_slots - 1)).to(torch.int32)
    has_null = torch.zeros(n, dtype=torch.bool, device=live.device)
    for v in probe_valids:
        if v is not None:
            has_null = has_null | ~v
    return keys_mat, slot, live & ~has_null


def probe_group_table(
    gt_slot_keys_raw: torch.Tensor,  # [H, lanes] LANE_INT (raw matrix)
    slot_used: torch.Tensor,  # [H] bool
    probe_cols: Sequence[torch.Tensor],
    probe_valids: Sequence[Optional[torch.Tensor]],
    live: torch.Tensor,
    lane_plan: Sequence[bool],
    max_rounds: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Find each probe row's slot in a built table; -1 when absent.
    Returns (found, overflow): overflow=True when a probe chain exhausted
    max_rounds. A NULL key never matches (SQL join semantics)."""
    num_slots = slot_used.shape[0]
    keys_mat, slot, active = probe_inputs(
        probe_cols, probe_valids, live, lane_plan, num_slots)
    found, over = hash_kernels.multiway_probe(
        keys_mat[:, None, :], slot[:, None], active[:, None],
        gt_slot_keys_raw, slot_used, (num_slots,), max_rounds,
    )
    return found[:, 0], over[0]


@dataclass
class BuildSide:
    """Build-side hash table + CSR duplicate layout, reusable across probes."""

    raw_slot_keys: torch.Tensor  # [H, lanes]
    slot_used: torch.Tensor  # [H]
    counts: torch.Tensor  # [H] rows per group
    offsets: torch.Tensor  # [H] exclusive start into rows_by_group
    rows_by_group: torch.Tensor  # [M] build row indices sorted by group
    table: Table
    overflow: torch.Tensor
    lane_plan: tuple  # per key col: validity lane present?
    has_null_key: torch.Tensor  # 0-d bool: a live build row had a null key


def build_join_table(
    build: Table,
    key_names: Sequence[str],
    num_slots: int,
    lane_plan: Optional[Sequence[bool]] = None,
) -> BuildSide:
    live = build.row_mask()
    cols = [build.column(k).data for k in key_names]
    valids = [build.column(k).validity for k in key_names]
    if lane_plan is None:
        lane_plan = [v is not None for v in valids]
    lane_plan = tuple(lane_plan)
    # SQL join: null keys on the build side can never match; treat as dead.
    # (NOT IN needs to know they existed: has_null_key.)
    has_null = torch.zeros(build.capacity, dtype=torch.bool,
                           device=build.device)
    for v in valids:
        if v is not None:
            has_null = has_null | ~v
    has_null_key = torch.any(live & has_null)
    live = live & ~has_null
    gt = build_group_table(cols, valids, live, num_slots, lane_plan=lane_plan)
    m = build.capacity
    gid = torch.where(live, gt.group_ids, num_slots)
    counts = SegmentSum(gid, num_slots)(
        torch.ones(m, dtype=torch.int32, device=build.device))
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)  # exclusive
    rows_by_group = torch.argsort(gid, stable=True).to(torch.int32)
    raw = _raw_slot_keys(gt, lane_plan)
    return BuildSide(
        raw_slot_keys=raw,
        slot_used=gt.slot_used,
        counts=counts,
        offsets=offsets,
        rows_by_group=rows_by_group,
        table=build,
        overflow=gt.overflow,
        lane_plan=lane_plan,
        has_null_key=has_null_key,
    )


def _raw_slot_keys(gt: GroupTable, lane_plan) -> torch.Tensor:
    """Re-fold the group table's per-slot keys into the raw lane matrix the
    probe compares against (same lane layout as _fold_keys)."""
    lane = precision.LANE_TORCH
    lanes = []
    h = gt.slot_used.shape[0]
    for keys, kv in zip(gt.slot_keys, gt.slot_key_valid):
        payload = fold_payload(keys, lane)
        if kv is not None:
            payload = _where0(kv, payload)
        lanes.append(payload)
    for kv, want in zip(gt.slot_key_valid, lane_plan):
        if want:
            lanes.append(
                kv.to(lane) if kv is not None
                else torch.ones(h, dtype=lane, device=gt.slot_used.device)
            )
    return torch.stack(lanes, dim=1)


def hash_join(
    probe: Table,
    build_side: BuildSide,
    probe_keys: Sequence[str],
    join_type: str,  # inner | left | semi | anti | mark
    out_capacity: int,
    probe_prefix: str = "",
    build_prefix: str = "",
) -> tuple[Table, torch.Tensor]:
    """Join probe against a built side. Returns (result, overflow flag).

    inner/left: probe columns then build columns; semi/anti: probe rows
    filtered by match; mark: probe plus a BOOL `__mark` column. `left`
    marks unmatched probe rows' build columns invalid."""
    live = probe.row_mask()
    cols = [probe.column(k).data for k in probe_keys]
    valids = [probe.column(k).validity for k in probe_keys]
    g, probe_overflow = probe_group_table(
        build_side.raw_slot_keys, build_side.slot_used, cols, valids,
        live, build_side.lane_plan,
    )
    table_overflow = build_side.overflow | probe_overflow
    found = g >= 0
    g_safe = torch.where(found, g, 0).to(torch.int64)
    match_count = torch.where(found & live, build_side.counts[g_safe], 0)

    if join_type in ("semi", "anti", "mark"):
        has_match = match_count > 0
        if join_type == "semi":
            return probe.compact(has_match), table_overflow
        if join_type == "anti":
            return probe.compact(live & ~has_match), table_overflow
        mark = Column(has_match, None, DataType.BOOL)
        return probe.with_column("__mark", mark), table_overflow

    if join_type == "left":
        out_rows = torch.where(live, torch.clamp(match_count, min=1), 0)
    elif join_type == "inner":
        out_rows = match_count
    else:
        raise NotImplementedError(f"join type {join_type}")

    cum = torch.cumsum(out_rows, 0, dtype=torch.int32)
    total = (cum[-1] if out_rows.shape[0] > 0
             else torch.zeros((), dtype=torch.int32, device=probe.device))
    starts = cum - out_rows
    overflow = table_overflow | (total > out_capacity)

    j = torch.arange(out_capacity, dtype=torch.int32, device=probe.device)
    # probe row for output j: first row whose cumulative end exceeds j
    l_idx = torch.searchsorted(cum, j, right=True).to(torch.int32)
    l_idx = torch.clamp(l_idx, 0, probe.capacity - 1)
    k = j - starts[l_idx]  # duplicate ordinal within the match group
    lg = g_safe[l_idx]
    matched = k < match_count[l_idx]
    pos = torch.clamp(build_side.offsets[lg] + k, 0,
                      build_side.rows_by_group.shape[0] - 1)
    r_idx = build_side.rows_by_group[pos]
    r_idx = torch.where(matched, r_idx, 0)

    out_cols: dict[str, Column] = {}
    for name, col in zip(probe.names, probe.columns):
        out_cols[probe_prefix + name] = col.gather(l_idx)
    for name, col in zip(build_side.table.names, build_side.table.columns):
        c = col.gather(r_idx)
        if join_type == "left":
            v = c.valid_mask(out_capacity) & matched
            c = Column(c.data, v, c.dtype, c.dictionary)
        out_cols[build_prefix + name] = c
    result = Table(tuple(out_cols.keys()), tuple(out_cols.values()), total)
    return result, overflow
