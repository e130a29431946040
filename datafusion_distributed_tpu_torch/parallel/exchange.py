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

The `*_spmd` functions are the same exchanges for an SPMD run
(runtime/mesh_executor.py `execute_on_mesh`): each rank holds only its own
producer table, and the rows cross as torch.distributed collectives
(all_to_all_single for the shuffles and the N:M coalesce, the all-gather
for broadcast and coalesce); rank i's table equals consumer i of the
function above byte for byte (see their section below).

`partition_table` is the plan-time split of a scan into per-task slices; it
memoizes the split of each column on that column's tensor.
"""

from __future__ import annotations

import hashlib
import weakref
from collections.abc import Sequence
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from datafusion_distributed_tpu_torch.ops.hash import hash_columns
from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Dictionary,
    Table,
    apply_lut,
    concat_tables,
    host_rows,
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
    s = min(samples_per_task, cap)
    enc = [[_order_encode(t.column(k.name), k.ascending, k.nulls_first)
            for k in keys] for t in tables]
    samples = [_samples(t, e, s, min(cap, t.capacity))
               for t, e in zip(tables, enc)]
    live = torch.cat([x[0] for x in samples])
    lanes = [torch.cat([x[1][li] for x in samples]) for li in range(len(keys))]
    splitters, total = _splitters(live, lanes, num_tasks)
    dests = [_range_dests(t, e, splitters, total, num_tasks)
             for t, e in zip(tables, enc)]
    return _route_by_dest(tables, dests, num_tasks, per_dest_capacity)


def _samples(table: Table, enc, s: int, rows: int) -> tuple:
    """A producer's ``s`` evenly spaced samples of its live rows: (live
    flags [s], one [s] lane per key of ``enc``); ``rows`` bounds the
    positions (the table's capacity, or its padded capacity)."""
    ar = torch.arange(s, dtype=torch.int32, device=table.device)
    n = table.num_rows.to(torch.int32)
    # int32 arithmetic, as the reference's
    pos = torch.div(ar * torch.clamp(n, min=1), s, rounding_mode="floor")
    pos = torch.clamp(pos, 0, rows - 1).to(torch.int64)
    return ar < n, [lane[pos] for lane in enc]


def _splitters(live: torch.Tensor, lanes, num_tasks: int) -> tuple:
    """The num_tasks - 1 splitters at the live samples' quantiles (every
    producer's samples end to end, in task order) and the live count."""
    dev = live.device
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
    return [lane[split_idx] for lane in lanes], total  # per key: [T - 1]


def _range_dests(table: Table, enc, splitters, total,
                 num_tasks: int) -> torch.Tensor:
    """Each row's task: the number of splitters at or below it
    (lexicographic over the key lanes); dead rows carry num_tasks."""
    rows = table.capacity
    dev = table.device
    dest = torch.zeros(rows, dtype=torch.int64, device=dev)
    for j in range(num_tasks - 1):
        gt = torch.zeros(rows, dtype=torch.bool, device=dev)
        eq = torch.ones(rows, dtype=torch.bool, device=dev)
        for lane, spl in zip(enc, splitters):
            sj = spl[j]
            gt = gt | (eq & (lane > sj))
            eq = eq & (lane == sj)
        dest = dest + (gt | eq).to(torch.int64)
    dest = torch.where(total > 0, dest, 0)
    return torch.where(table.row_mask(), dest, num_tasks)


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
# SPMD: one process a task, the exchanges as collectives
# ---------------------------------------------------------------------------
#
# Under `runtime/mesh_executor.execute_on_mesh` each rank of a
# torch.distributed process group is one task and holds only its own table.
# The functions below take that table and the run's `TaskMesh` (the group,
# this rank, the world size, the device) and return this rank's consumer
# table, and the overflow flag where the in-process function has one: equal
# byte for byte to consumer ``mesh.rank`` of the in-process function over
# every rank's table (data, validity, ``num_rows``, capacity, padding rows,
# dictionary, flag).
#
# Every exchange begins with one header, gathered from every rank: the
# exchange's position in the plan, its kind, the producer's column count,
# capacity and live rows, and a digest of its columns' validity and string
# dictionaries. A rank at another exchange than its peers makes every rank
# raise at once (`LockstepError`), instead of mixing stages. Dictionaries
# that differ between ranks are gathered and unified in rank order, as the
# in-process route unifies its producers', before any code crosses a rank.
# Rows cross as unsigned byte lanes: each column bit-cast by ``.view`` and
# stacked with the columns of its element width, one collective a width.
# On a gloo group with tensors on the card (several ranks sharing one
# card), every collective's buffers are staged through the host.

#: exchange kinds, as the header carries them
_SHUFFLE, _RANGE, _BROADCAST, _COALESCE, _GROUP = 1, 2, 3, 4, 5
_KINDS = {_SHUFFLE: "hash shuffle", _RANGE: "range shuffle",
          _BROADCAST: "broadcast", _COALESCE: "coalesce",
          _GROUP: "group coalesce"}
#: lane dtype of each element width: bool and 1-byte columns as uint8
_LANE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
#: bytes this process sent to the other ranks of its SPMD runs, by kind
#: (`_KINDS`' names; "control" for headers, counts and plan checks)
_SENT: dict = {}


def spmd_stats() -> dict:
    """Bytes this process sent to other ranks in SPMD exchanges, by
    exchange kind, since the last `reset_spmd_stats`."""
    return dict(_SENT)


def reset_spmd_stats() -> None:
    _SENT.clear()


def _count_sent(kind: str, nbytes: int) -> None:
    _SENT[kind] = _SENT.get(kind, 0) + int(nbytes)


class LockstepError(RuntimeError):
    """Ranks of one SPMD run reached different exchanges (or disagree on
    one): raised on every rank together."""


def _wire(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the group's collectives take it: the host for a gloo
    group over the card's tensors, else where it is."""
    t = t.contiguous()
    return t.cpu() if mesh.host_staged and t.is_cuda else t


def _gather_rows(mesh, t: torch.Tensor, kind: str = "control"
                 ) -> torch.Tensor:
    """[m, ...] on every rank -> [size * m, ...], rank after rank."""
    src = _wire(mesh, t)
    _count_sent(kind, src.numel() * src.element_size() * (mesh.size - 1))
    out = src.new_empty((mesh.size * src.shape[0], *src.shape[1:]))
    _ALL_GATHER(out, src, group=mesh.group)
    return out.to(mesh.device)


def _exchange_rows(mesh, t: torch.Tensor, send: list, recv: list,
                   kind: str = "control"):
    """all_to_all over dim 0: ``send[d]`` rows of ``t`` (in order) to rank
    d, ``recv[p]`` rows from rank p, rank after rank."""
    src = _wire(mesh, t)
    row = src[0].numel() * src.element_size() if src.shape[0] else 0
    _count_sent(kind, row * (sum(send) - send[mesh.rank]))
    out = src.new_empty((sum(recv), *src.shape[1:]))
    dist.all_to_all_single(out, src, recv, send, group=mesh.group)
    return out.to(mesh.device)


def _ints_device(mesh) -> torch.device:
    return torch.device("cpu") if mesh.host_staged else mesh.device


def _gather_ints(mesh, values) -> np.ndarray:
    """Every rank's int64 vector ``values`` -> [size, len] on the host."""
    t = torch.as_tensor(np.asarray(values, dtype=np.int64),
                        device=_ints_device(mesh)).reshape(1, -1)
    return _gather_rows(mesh, t).cpu().numpy()


def _swap_ints(mesh, rows) -> np.ndarray:
    """Row d of ``rows`` ([size, k] int64) to rank d -> [size, k] on the
    host: row p from rank p."""
    t = torch.as_tensor(np.asarray(rows, dtype=np.int64),
                        device=_ints_device(mesh))
    one = [1] * mesh.size
    return _exchange_rows(mesh, t, one, one).cpu().numpy()


def _broadcast_object(mesh, obj, root: int):
    """``obj`` of rank ``root`` (a group rank), on every rank."""
    box = [obj]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(mesh.group, root), group=mesh.group,
        device=_ints_device(mesh))
    return box[0]


def _fingerprint(data: bytes) -> int:
    """A positive 62-bit digest of ``data``, alike in every process."""
    d = hashlib.blake2b(data, digest_size=8).digest()
    return (int.from_bytes(d, "little") >> 2) | 1


def _dictionary_fingerprint(d) -> int:
    """A string Dictionary's content fingerprint as an int64 (the wire
    tier's, of its values in order, memoized on the object): equal on
    every rank that holds the same vocabulary, whatever the object."""
    from datafusion_distributed_tpu_torch.io.parquet import _wire_form

    return (int(_wire_form(d)[1][:15], 16) << 1) | 1


class _Agreed:
    """What every rank learned from an exchange's header: each producer's
    live rows, and where the columns' validity or dictionaries differ
    between ranks, each producer's (``words``: [size, ncols, 2] of
    has-validity and dictionary fingerprint; ``dicts``: column -> every
    producer's Dictionary, this rank's own object at its index)."""

    def __init__(self, rows, words, dicts):
        self.rows = rows
        self.words = words
        self.dicts = dicts

    def columns(self, table: Table, producers) -> tuple:
        """For the consumer of ``producers`` (producer indices, in order):
        each column's validity presence, its dictionary, and the code LUT
        of each producer (None: codes pass through)."""
        out = []
        for ci, c in enumerate(table.columns):
            if self.words is None:
                valid = c.validity is not None
            else:
                valid = bool(self.words[list(producers), ci, 0].any())
            ds = self.dicts.get(ci)
            if ds is None:
                out.append((valid, c.dictionary, [None] * len(producers)))
            else:
                union, luts = unify_dictionaries([ds[p] for p in producers])
                out.append((valid, union, luts))
        return out


def _agree(table: Table, mesh, kind: int, position: int,
           labels: Sequence[str]) -> _Agreed:
    """The exchange's header, gathered from every rank (see above); raises
    `LockstepError` on every rank when they are not at the same
    exchange."""
    words = np.asarray(
        [[int(c.validity is not None),
          _dictionary_fingerprint(c.dictionary)
          if c.dictionary is not None else 0] for c in table.columns],
        dtype=np.int64).reshape(-1, 2)
    rows = host_rows(table)
    head = _gather_ints(mesh, [position, kind, len(table.columns),
                               table.capacity, rows,
                               _fingerprint(words.tobytes())])

    def name(pos) -> str:
        pos = int(pos)
        return (f"#{pos} ({labels[pos]})" if 0 <= pos < len(labels)
                else f"#{pos}")

    for r, (pos, k, ncols, cap, _n, _d) in enumerate(head):
        if pos != position:
            raise LockstepError(
                f"SPMD ranks out of lockstep: rank {mesh.rank} is at "
                f"exchange {name(position)} and rank {r} at exchange "
                f"{name(pos)}")
        if (k, ncols, cap) != (kind, len(table.columns), table.capacity):
            raise LockstepError(
                f"SPMD ranks disagree at exchange {name(position)}: rank "
                f"{mesh.rank} has a {_KINDS.get(kind)} of "
                f"{len(table.columns)} columns at capacity "
                f"{table.capacity}, rank {r} a {_KINDS.get(int(k))} of "
                f"{ncols} columns at capacity {cap}")
    agreed = _Agreed([int(n) for n in head[:, 4]], None, {})
    if (head[:, 5] == head[0, 5]).all():
        return agreed
    agreed.words = _gather_ints(mesh, words.reshape(-1)).reshape(
        mesh.size, -1, 2)
    differ = [ci for ci in range(len(table.columns))
              if (agreed.words[:, ci, 1] != words[ci, 1]).any()]
    if differ:
        mine = {ci: table.columns[ci].dictionary for ci in differ}
        held = [None] * mesh.size
        dist.all_gather_object(
            held, {ci: None if d is None else list(d.values)
                   for ci, d in mine.items()}, group=mesh.group)
        for ci in differ:
            agreed.dicts[ci] = [
                mine[ci] if r == mesh.rank
                else None if held[r][ci] is None
                else Dictionary(np.asarray(held[r][ci], dtype=object))
                for r in range(mesh.size)]
    return agreed


def _pack(table: Table, columns, k: int, rows) -> tuple:
    """The rows ``rows`` (an index tensor, or a count: the first rows) of
    every column, remapped by its LUT at producer index ``k`` of
    ``columns`` (as `_Agreed.columns` gives them), and, where any
    producer of the exchange has one, of its validity, as unsigned lanes
    grouped by element width: ({width: [rows, lanes]}, per column (width,
    data lane, validity lane or None)). Every rank packs the same
    layout; only the rows that cross are copied."""
    if isinstance(rows, torch.Tensor):
        def take(x):
            return torch.index_select(x, 0, rows)
    else:
        def take(x):
            return x[:rows]
    lanes: dict = {}
    layout = []
    for c, (valid, _dictionary, luts) in zip(table.columns, columns):
        d = take(c.data)
        if luts[k] is not None:
            d = apply_lut(luts[k], d).to(c.data.dtype)
        w = d.element_size()
        group = lanes.setdefault(w, [])
        group.append(d.view(_LANE[w]))
        at = (w, len(group) - 1, None)
        if valid:
            ones = lanes.setdefault(1, [])
            v = (take(c.validity) if c.validity is not None
                 else torch.ones_like(d, dtype=torch.bool))
            ones.append(v.view(torch.uint8))
            at = (w, at[1], len(ones) - 1)
        layout.append(at)
    return {w: torch.stack(lanes[w], 1) for w in sorted(lanes)}, layout


def _send(lanes: dict, move) -> dict:
    """``move`` (a collective over a [rows, bytes] uint8 buffer) applied
    to each width class of ``lanes``, which it empties as it goes (so that
    a send buffer goes as soon as its class has crossed) -> the received
    lanes, by width."""
    out = {}
    for w in sorted(lanes):
        x = lanes.pop(w)
        out[w] = move(x.view(torch.uint8)).view(x.dtype)
        del x
    return out


def _unpack(table: Table, columns, layout, recv: dict, num_rows: int,
            capacity: int, pad, device, index=None) -> Table:
    """The consumer table of ``capacity`` rows from the received lanes
    ``recv`` ({width: [rows, lanes]}): with ``index``, row i of every
    column is row ``index[i]`` of the lanes; else the first ``num_rows``
    rows are the lanes' and the rest repeat lane row ``pad`` (None: an
    all-zero row with no valid entry). ``columns`` is the consumer's
    (validity, dictionary): a column has validity only where its own
    producers had one, a subset of the lanes packed. One buffer a column
    is allocated, of the consumer's capacity."""
    def column(lane):
        if index is not None:
            return torch.index_select(lane, 0, index)
        out = lane.new_empty(capacity)
        out[:num_rows] = lane[:num_rows]
        out[num_rows:] = 0 if pad is None else lane[pad]
        return out

    cols = []
    for c, (valid, dictionary, _lut), (w, li, vi) in zip(
            table.columns, columns, layout):
        data = column(recv[w][:, li]).view(c.data.dtype)
        validity = (column(recv[1][:, vi]).view(torch.bool)
                    if valid else None)
        cols.append(Column(data, validity, c.dtype, dictionary))
    return Table(table.names, tuple(cols),
                 torch.tensor(num_rows, dtype=torch.int32, device=device))


def _route_spmd(table: Table, dest: torch.Tensor, mesh,
                per_dest_capacity: int, agreed: _Agreed,
                kind: str) -> tuple[Table, torch.Tensor]:
    """`_route_by_dest` on one rank: the counts first (with each
    producer's overflow flag), then only the rows each consumer keeps, one
    uneven all_to_all a width class. The consumer's rows come producer
    after producer; its padding repeats its receive buffer's row 0, as in
    `_Shuffled`."""
    t, cap = mesh.size, per_dest_capacity
    d = dest.to(torch.int64)
    order = torch.argsort(d, stable=True)
    sd = d[order]
    bounds = torch.arange(t + 1, dtype=torch.int64, device=d.device)
    starts = torch.searchsorted(sd, bounds)
    counts = (starts[1:] - starts[:-1]).tolist()
    over = int(any(n > cap for n in counts))
    got = _swap_ints(mesh, [[n, over] for n in counts])
    send = [min(n, cap) for n in counts]
    recv = [min(int(n), cap) for n in got[:, 0]]
    overflow = torch.tensor(bool(got[:, 1].any()), device=mesh.device)
    rank = torch.arange(d.shape[0], device=d.device) - starts[sd]
    picked = order[(sd < t) & (rank < cap)]
    del d, order, sd, rank
    columns = agreed.columns(table, range(t))
    lanes, layout = _pack(table, columns, mesh.rank, picked)
    del picked
    out = _send(lanes, lambda x: _exchange_rows(mesh, x, send, recv, kind))
    n = sum(recv)
    return _unpack(table, columns, layout, out, n, t * cap,
                   0 if recv[0] > 0 else None, mesh.device), overflow


def shuffle_exchange_spmd(table: Table, key_names: Sequence[str], mesh,
                          per_dest_capacity: int, position: int = 0,
                          labels: Sequence[str] = ()
                          ) -> tuple[Table, torch.Tensor]:
    """`shuffle_exchange` on one rank of an SPMD run: this rank's producer
    table -> its consumer table and the overflow flag (any producer's).
    ``position`` is the exchange's place in the plan, ``labels`` every
    exchange's label by position (for the lockstep check's message)."""
    agreed = _agree(table, mesh, _SHUFFLE, position, labels)
    h = hash_columns([table.column(k).data for k in key_names],
                     [table.column(k).validity for k in key_names])
    dest = torch.where(table.row_mask(), h % mesh.size, mesh.size)
    return _route_spmd(table, dest, mesh, per_dest_capacity, agreed,
                       _KINDS[_SHUFFLE])


def range_shuffle_exchange_spmd(table: Table, keys, mesh,
                                per_dest_capacity: int,
                                samples_per_task: int = 64,
                                position: int = 0,
                                labels: Sequence[str] = ()
                                ) -> tuple[Table, torch.Tensor]:
    """`range_shuffle_exchange` on one rank: every rank's samples are
    gathered in one collective, so each computes the same splitters."""
    agreed = _agree(table, mesh, _RANGE, position, labels)
    t, cap = mesh.size, table.capacity
    s = min(samples_per_task, cap)
    enc = [_order_encode(table.column(k.name), k.ascending, k.nulls_first)
           for k in keys]
    live, lanes = _samples(table, enc, s, cap)
    mine = torch.stack([live.to(torch.int64)] + lanes)  # [1 + keys, s]
    every = _gather_rows(mesh, mine[None], _KINDS[_RANGE])
    splitters, total = _splitters(
        every[:, 0].reshape(-1).to(torch.bool),
        [every[:, 1 + i].reshape(-1) for i in range(len(keys))], t)
    dest = _range_dests(table, enc, splitters, total, t)
    return _route_spmd(table, dest, mesh, per_dest_capacity, agreed,
                       _KINDS[_RANGE])


def broadcast_exchange_spmd(table: Table, mesh, position: int = 0,
                            labels: Sequence[str] = (),
                            kind: int = _BROADCAST) -> Table:
    """`broadcast_exchange` on one rank: every producer's first
    max(1, live rows) rows gathered in one collective a width class (the
    consumer reads their live rows, and producer 0's row 0 as padding)."""
    agreed = _agree(table, mesh, kind, position, labels)
    t, cap = mesh.size, table.capacity
    rows = agreed.rows
    m = max(1, max(rows))
    columns = agreed.columns(table, range(t))
    lanes, layout = _pack(table, columns, mesh.rank, m)
    out = _send(lanes, lambda x: _gather_rows(mesh, x, _KINDS[kind]))
    index = np.zeros(t * cap, dtype=np.int64)
    live = np.concatenate([p * m + np.arange(n) for p, n in enumerate(rows)])
    index[:len(live)] = live
    return _unpack(table, columns, layout, out, sum(rows), t * cap, 0,
                   mesh.device, torch.from_numpy(index).to(mesh.device))


def coalesce_exchange_spmd(table: Table, mesh, position: int = 0,
                           labels: Sequence[str] = ()) -> Table:
    """`coalesce_exchange` on one rank: every rank holds the whole."""
    return broadcast_exchange_spmd(table, mesh, position, labels,
                                   kind=_COALESCE)


def group_coalesce_exchange_spmd(table: Table, mesh, num_consumers: int,
                                 position: int = 0,
                                 labels: Sequence[str] = ()) -> Table:
    """`group_coalesce_exchange` on one rank: each producer's live rows go
    to its consumer alone (one uneven all_to_all a width class, zero rows
    to every other rank), so a consumer holds at most g * C rows."""
    t, m = mesh.size, num_consumers
    g = -(-t // m)
    if g == 1:
        return table
    agreed = _agree(table, mesh, _GROUP, position, labels)
    cap, rows, me = table.capacity, agreed.rows, mesh.rank

    def group(j):  # consumer j's producers; a short group pads with 0
        return [p if p < t else 0 for p in range(j * g, (j + 1) * g)]

    def members(j):
        return [p for p in range(j * g, (j + 1) * g) if p < t]

    # the lanes carry validity wherever any producer has it, so that every
    # rank packs (and calls the collectives for) the same width classes
    every = agreed.columns(table, range(t))
    j = me // g  # this producer's consumer
    luts = agreed.columns(table, group(j))
    lanes, layout = _pack(table, [(v, None, lut) for (v, _d, _l),
                                  (_v, _d2, lut) in zip(every, luts)],
                          me - j * g, rows[me])
    send = [rows[me] if d == j else 0 for d in range(t)]
    recv = [rows[p] if me < m and p in members(me) else 0 for p in range(t)]
    out = _send(lanes, lambda x: _exchange_rows(mesh, x, send, recv,
                                                _KINDS[_GROUP]))
    # a rank past the consumers holds the empty table of producer 0's
    # columns
    mine = agreed.columns(table, group(me) if me < m else [0] * g)
    return _unpack(table, mine, layout, out, sum(recv), g * cap, None,
                   mesh.device)


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
