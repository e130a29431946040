"""Exchange data plane (port of the reference `parallel/exchange.py`).

The reference moves rows between the tasks of a stage with XLA collectives
inside one SPMD program (`all_to_all` for a hash or range shuffle,
`all_gather` for a broadcast or coalesce, `ppermute` for the N:M coalesce).
Here every function takes the list of the producer tasks' tables, in task
order, and returns the list of the consumer tasks' tables (plus the overflow
flag where the reference has one). On one device a collective is plain
indexing: each consumer's rows are gathered from the concatenated producer
columns with one index a column, so no value is bit-cast into lanes.

Each consumer's table equals the one its counterpart receives on the
reference's mesh byte for byte: data, validity, ``num_rows``, capacity, the
padding rows past ``num_rows`` (the reference compacts with a static-size
``nonzero`` padded with index 0, so they repeat row 0 of its receive buffer)
and the overflow flag (any producer's, the reference's ``pmax``).

`partition_table` is the plan-time split of a scan into per-task slices; it
memoizes the split of each column on that column's tensor.
"""

from __future__ import annotations

import weakref
from collections.abc import Sequence
from typing import Optional

import torch

from datafusion_distributed_tpu_torch.ops.hash import hash_columns
from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Table,
    apply_lut,
    concat_tables,
    nonzero_static,
    round_up_pow2,
    unify_dictionaries,
)


def _check_producers(tables: Sequence[Table], num_tasks: int,
                     capacity: Optional[int]) -> int:
    """The producers' common padded capacity C (one SPMD program: every
    task's table has the same shape). With ``capacity`` the tables may be
    their live prefixes (`live_prefix`), each of at most C rows."""
    if len(tables) != num_tasks:
        raise ValueError(
            f"{len(tables)} producer tables for an exchange over "
            f"{num_tasks} tasks"
        )
    caps = {t.capacity for t in tables}
    if capacity is None:
        if len(caps) != 1:
            raise ValueError(f"producer tables of unequal capacity: {caps}")
        return caps.pop()
    if max(caps) > capacity:
        raise ValueError(f"producer tables above capacity {capacity}: {caps}")
    return capacity


def live_prefix(table: Table) -> Table:
    """A copy of the table's live rows, and of row 0 when it has none:
    all that a consumer can receive of a producer (rows past num_rows only
    ever reach a consumer as the padding that repeats producer 0's row 0).
    Reads num_rows (one host sync); the data-plane functions take such
    prefixes with the producers' padded ``capacity``."""
    n = max(int(table.num_rows), 1)
    return Table(table.names, tuple(
        Column(c.data[:n].clone(),
               c.validity[:n].clone() if c.validity is not None else None,
               c.dtype, c.dictionary)
        for c in table.columns), table.num_rows)


class _Sources:
    """The producer tables' columns laid end to end (with ``zero_row``, one
    all-zero row with no valid entry after them), from which consumer
    tables are gathered. String columns whose producers carry different
    dictionaries are remapped onto their union, as `concat_tables` does.
    Built once an exchange; the producers' own tables may go after."""

    def __init__(self, tables: Sequence[Table], zero_row: bool):
        first = tables[0]
        dev = first.device
        self.names = first.names
        self.columns = []
        for ci, col0 in enumerate(first.columns):
            cols = [t.columns[ci] for t in tables]
            dictionary, luts = unify_dictionaries([c.dictionary
                                                   for c in cols])
            parts = [c.data if lut is None
                     else apply_lut(lut, c.data).to(c.data.dtype)
                     for c, lut in zip(cols, luts)]
            vparts = ([c.valid_mask() for c in cols]
                      if any(c.validity is not None for c in cols) else None)
            if zero_row:
                parts.append(torch.zeros(1, dtype=col0.data.dtype,
                                         device=dev))
                if vparts is not None:
                    vparts.append(torch.zeros(1, dtype=torch.bool,
                                              device=dev))
            self.columns.append((
                torch.cat(parts),
                torch.cat(vparts) if vparts is not None else None,
                col0.dtype, dictionary))

    def gather(self, index: torch.Tensor, num_rows) -> Table:
        return Table(self.names, tuple(
            Column(torch.index_select(d, 0, index),
                   torch.index_select(v, 0, index) if v is not None
                   else None, dt, dic)
            for d, v, dt, dic in self.columns), num_rows)


class _Shuffled(Sequence):
    """The consumer tables of a shuffle, each gathered when it is taken:
    one device holds every task's producers once, but only one consumer
    table at a time (each is num_tasks * per_dest_capacity rows)."""

    def __init__(self, sources: _Sources, order, starts, kept, lengths,
                 cap: int):
        self.sources = sources
        self.order = order  # the producers' rows sorted by dest, end to end
        self.starts = starts  # [P, T + 1] where each dest's rows begin
        self.kept = kept  # [T, P] rows each consumer keeps of each producer
        self.offsets = torch.cumsum(kept, 1) - kept  # where they land
        self.n = kept.sum(1, dtype=torch.int32)
        idt = order.dtype
        self.lengths = torch.tensor(lengths, dtype=idt, device=order.device)
        self.base = torch.cumsum(self.lengths, 0) - self.lengths
        self.cap = cap

    def __len__(self) -> int:
        return self.kept.shape[0]

    def __getitem__(self, j: int) -> Table:
        if not 0 <= j < len(self):
            raise IndexError(j)  # ends iteration
        t, cap = len(self), self.cap
        dev, idt = self.order.device, self.order.dtype
        r = torch.arange(cap, dtype=idt, device=dev)
        # element (p, r): producer p's r-th row bound for consumer j
        valid = r < self.kept[j][:, None]
        pos = torch.minimum(self.starts[:, j].to(idt)[:, None] + r,
                            (self.lengths - 1)[:, None])
        src = torch.index_select(self.order, 0,
                                 (pos + self.base[:, None]).reshape(-1))
        dst = torch.where(valid, self.offsets[j][:, None] + r, t * cap)
        # the rows past n repeat the receive buffer's row 0: producer 0's
        # first row for j, else the zero row after the producers' rows
        first = self.order[torch.clamp(self.starts[0, j],
                                       max=self.lengths[0] - 1)]
        pad = torch.where(self.kept[j, 0] > 0, first,
                          self.lengths.sum().to(idt))
        index = pad.expand(t * cap + 1).clone()
        index.scatter_(0, dst.reshape(-1).to(torch.int64), src)
        return self.sources.gather(index[:t * cap], self.n[j])


def shuffle_exchange(
    tables: Sequence[Table],
    key_names: Sequence[str],
    num_tasks: int,
    per_dest_capacity: int,
    capacity: Optional[int] = None,
) -> tuple[Sequence[Table], torch.Tensor]:
    """Hash-repartition rows across the tasks: a live row goes to task
    hash(keys) % num_tasks. Consumer j receives at most
    ``per_dest_capacity`` rows from each producer (capacity
    num_tasks * per_dest_capacity); rows past that are dropped and flagged.
    The consumer tables come as a sequence that gathers each when it is
    taken. ``capacity``: the producers' padded capacity, where ``tables``
    are their live prefixes."""
    _check_producers(tables, num_tasks, capacity)
    dests = []
    for t in tables:
        h = hash_columns([t.column(k).data for k in key_names],
                         [t.column(k).validity for k in key_names])
        dest = h % num_tasks
        dests.append(torch.where(t.row_mask(), dest, num_tasks))
    return _route_by_dest(tables, dests, num_tasks, per_dest_capacity)


def _route_by_dest(
    tables: Sequence[Table],
    dests: Sequence[torch.Tensor],
    num_tasks: int,
    per_dest_capacity: int,
) -> tuple[Sequence[Table], torch.Tensor]:
    """Move each live row of producer p to consumer ``dests[p][row]`` (dead
    rows carry num_tasks). The shared routing core of the hash and range
    shuffles, with the reference's order: a stable sort of each producer's
    rows by destination; consumer j then holds the first
    ``per_dest_capacity`` rows bound for it from each producer, producer
    after producer in task order, compacted; its padding rows repeat its
    receive buffer's row 0 (producer 0's first row for j, else zeros)."""
    dev = tables[0].device
    lengths = [t.capacity for t in tables]
    idt = torch.int32 if sum(lengths) < 2**31 - 1 else torch.int64
    bounds = torch.arange(num_tasks + 1, dtype=torch.int64, device=dev)
    orders, starts = [], []
    base = 0
    for d in dests:
        d = d.to(torch.int64)
        o = torch.argsort(d, stable=True)
        starts.append(torch.searchsorted(d[o], bounds))
        orders.append((o + base).to(idt))
        base += d.shape[0]
    starts = torch.stack(starts)
    counts = starts[:, 1:] - starts[:, :-1]  # [P, T] rows for each consumer
    overflow = (counts > per_dest_capacity).any()
    kept = torch.clamp(counts, max=per_dest_capacity).T.contiguous()
    return _Shuffled(_Sources(tables, zero_row=True), torch.cat(orders),
                     starts, kept, lengths, per_dest_capacity), overflow


def _order_encode(col: Column, ascending: bool,
                  nulls_first: bool) -> torch.Tensor:
    """An order-isomorphic int64 encoding of a sort-key column: the
    reference's unsigned encoding of the column's width w (IEEE radix trick
    for floats, sign flip for ints, dictionary codes for strings, all bits
    flipped when descending, NaN last, nulls at the extremes) shifted by
    -2^(w-1) into the signed range, which keeps its order and its ties."""
    d = col.data
    if d.dtype == torch.bool:
        w, s = 4, d.to(torch.int64) - (1 << 31)
    elif d.dtype.is_floating_point:
        w = d.element_size()
        i = d.view({4: torch.int32, 8: torch.int64}[w])
        s = torch.where(i < 0, i ^ ((1 << (8 * w - 1)) - 1), i)
        s = s.to(torch.int64)
    else:
        w = d.element_size()
        s = d.to(torch.int64)
        if not d.is_signed():
            s = s - (1 << (8 * w - 1))
    hi = (1 << (8 * w - 1)) - 1
    lo = -(1 << (8 * w - 1))
    if not ascending:
        s = ~s
    if d.dtype.is_floating_point:
        # the local sort places NaN last whatever the direction
        s = torch.where(torch.isnan(d), hi, s)
    if col.validity is not None:
        s = torch.where(col.validity, s, lo if nulls_first else hi)
    return s


def range_shuffle_exchange(
    tables: Sequence[Table],
    keys,  # list[ops.sort.SortKey]
    num_tasks: int,
    per_dest_capacity: int,
    samples_per_task: int = 64,
    capacity: Optional[int] = None,
) -> tuple[Sequence[Table], torch.Tensor]:
    """Range-partition rows across the tasks by the composite sort key (a
    sample sort): each producer contributes ``samples_per_task`` evenly
    spaced live rows, the num_tasks - 1 splitters sit at the live samples'
    quantiles, and a row goes to the number of splitters at or below it.
    After a local sort per task, the tasks' rows in task order are the
    global order. ``capacity`` as for `shuffle_exchange` (a sample never
    lies past a producer's live rows, or row 0 when it has none)."""
    cap = _check_producers(tables, num_tasks, capacity)
    dev = tables[0].device
    s = min(samples_per_task, cap)
    enc = [[_order_encode(t.column(k.name), k.ascending, k.nulls_first)
            for k in keys] for t in tables]
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    g_live, g = [], [[] for _ in keys]
    for t, e in zip(tables, enc):
        n = t.num_rows.to(torch.int32)
        # int32 arithmetic, as the reference's
        pos = torch.div(ar * torch.clamp(n, min=1), s, rounding_mode="floor")
        pos = torch.clamp(pos, 0, min(cap, t.capacity) - 1).to(torch.int64)
        g_live.append(ar < n)
        for li, lane in enumerate(e):
            g[li].append(lane[pos])
    live = torch.cat(g_live)
    lanes = [torch.cat(x) for x in g]
    dead = (~live).to(torch.int8)
    order = torch.argsort(dead, stable=True)
    for lane in reversed(lanes):
        order = order[torch.argsort(lane[order], stable=True)]
    order = order[torch.argsort(dead[order], stable=True)]
    total = live.sum(dtype=torch.int32)
    ranks = torch.div(
        torch.arange(1, num_tasks, dtype=torch.int32, device=dev) * total,
        num_tasks, rounding_mode="floor")
    ranks = torch.minimum(torch.clamp(ranks, min=0),
                          torch.clamp(total - 1, min=0)).to(torch.int64)
    split_idx = order[ranks]
    splitters = [lane[split_idx] for lane in lanes]  # per key: [T - 1]

    dests = []
    for t, e in zip(tables, enc):
        rows = t.capacity
        dest = torch.zeros(rows, dtype=torch.int64, device=dev)
        for j in range(num_tasks - 1):
            gt = torch.zeros(rows, dtype=torch.bool, device=dev)
            eq = torch.ones(rows, dtype=torch.bool, device=dev)
            for lane, spl in zip(e, splitters):
                sj = spl[j]
                gt = gt | (eq & (lane > sj))
                eq = eq & (lane == sj)
            dest = dest + (gt | eq).to(torch.int64)
        dest = torch.where(total > 0, dest, 0)
        dests.append(torch.where(t.row_mask(), dest, num_tasks))
    return _route_by_dest(tables, dests, num_tasks, per_dest_capacity)


def broadcast_exchange(tables: Sequence[Table], num_tasks: int,
                       capacity: Optional[int] = None) -> list[Table]:
    """Replicate every producer's live rows to all tasks: each consumer
    holds the producers' live rows in task order (capacity num_tasks * C);
    the padding rows repeat producer 0's row 0. Every consumer gets the
    same table. ``capacity`` as for `shuffle_exchange`."""
    c = _check_producers(tables, num_tasks, capacity)
    live = torch.cat([t.row_mask() for t in tables])
    out = _Sources(tables, zero_row=False).gather(
        nonzero_static(live, num_tasks * c), live.sum(dtype=torch.int32))
    return [out] * num_tasks


def coalesce_exchange(tables: Sequence[Table], num_tasks: int,
                      capacity: Optional[int] = None) -> list[Table]:
    """N tasks -> one logical table, held whole by every task (the
    consumer stage runs alike on each)."""
    return broadcast_exchange(tables, num_tasks, capacity)


def group_coalesce_exchange(tables: Sequence[Table], num_tasks: int,
                            num_consumers: int,
                            capacity: Optional[int] = None) -> list[Table]:
    """The N:M coalesce: consumer j < M holds the contiguous producer group
    [j*g, (j+1)*g), g = ceil(N / M), concatenated with capacity g * C (a
    producer past N contributes nothing); tasks >= M are empty. At g = 1
    every task keeps its own table (so the tables must be whole, not
    prefixes)."""
    g = -(-num_tasks // num_consumers)
    if g == 1:
        return list(tables)
    cap = _check_producers(tables, num_tasks, capacity)
    first = tables[0]
    zero = Table(first.names, tuple(
        Column(torch.zeros_like(c.data),
               torch.zeros_like(c.validity) if c.validity is not None
               else None, c.dtype, c.dictionary)
        for c in first.columns), first.num_rows.new_zeros(()))
    out = []
    for j in range(num_tasks):
        if j >= num_consumers:
            parts = [zero] * g
        else:
            parts = [tables[p] if p < num_tasks else zero
                     for p in range(j * g, (j + 1) * g)]
        t = concat_tables(parts, capacity=g * cap)
        if j >= num_consumers:
            t = Table(t.names, t.columns, t.num_rows.new_zeros(()))
        out.append(t)
    return out


def _compact_with_mask(table: Table, keep: torch.Tensor) -> Table:
    """Rows where ``keep`` is True packed to the front (``keep`` already
    excludes padding); the rows past them repeat row 0."""
    idx = nonzero_static(keep, table.capacity)
    n = torch.sum(keep, dtype=torch.int32)
    return table.gather(idx, n)


# ---------------------------------------------------------------------------
# plan-time split of a scan
# ---------------------------------------------------------------------------

#: id(column tensor) -> {(rows, parts): [parts, capacity] split}; an entry
#: goes when its tensor does (a finalizer), so that dropping the registered
#: table frees its splits. Keyed by id: a tensor compares elementwise.
_SPLITS: dict = {}


def _split_column(data: torch.Tensor, n: int, num_parts: int, per: int,
                  cap: int) -> torch.Tensor:
    """``data``'s first ``n`` rows cut into ``num_parts`` slices of ``per``
    rows, each padded with zeros to ``cap``: one [parts, cap] tensor, made
    once for a tensor, row count and part count, and shared by every plan
    that splits the same column so."""
    memo = _SPLITS.get(id(data))
    if memo is None:
        memo = _SPLITS[id(data)] = {}
        weakref.finalize(data, _SPLITS.pop, id(data), None)
    out = memo.get((n, num_parts))
    if out is None:
        out = torch.zeros((num_parts, cap), dtype=data.dtype,
                          device=data.device)
        full = n // per if per else 0  # slices holding `per` rows
        if full:
            out[:full, :per] = data[:full * per].reshape(full, per)
        if full < num_parts and n > full * per:
            out[full, :n - full * per] = data[full * per:n]
        memo[(n, num_parts)] = out
    return out


def partition_table(table: Table, num_parts: int) -> list[Table]:
    """Split a Table into ``num_parts`` contiguous row-range slices of equal
    padded capacity (the reference's arithmetic: ceil(rows / parts) rows a
    slice, capacity its power of two, at least 8). Slice i holds rows
    [i * per, (i + 1) * per) and zeros beyond them.

    The copy runs on the table's device. It reads ``num_rows`` once (one
    host sync) and makes one padded [parts, capacity] tensor a column, of
    which each slice's column is a row, filled by at most two copies (the
    full slices, then the last partial one). The split of a column is
    memoized on its tensor (`_split_column`), so plans over the same table
    share it; the row counts travel in one host-to-device copy."""
    n = int(table.num_rows)
    per = (n + num_parts - 1) // num_parts if num_parts else 0
    cap = max(round_up_pow2(max(per, 1)), 8)
    counts = [max(0, min(per, n - i * per)) for i in range(num_parts)]

    def split(data: Optional[torch.Tensor]):
        if data is None:
            return None
        return _split_column(data, n, num_parts, per, cap)

    parts = [split(c.data) for c in table.columns]
    valids = [split(c.validity) for c in table.columns]
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
