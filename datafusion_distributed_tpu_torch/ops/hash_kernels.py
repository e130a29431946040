"""The port's hand-written kernels: CUDA wrappers and their plain PyTorch versions.

Kernels 1-3 each replace one Pallas TPU kernel of the reference package
(`datafusion_distributed_tpu/ops/pallas_hash.py`); kernel 4, the per-slot
fold of integer values, replaces the library scatters the GROUP BYs called
(`ops/aggregate.py`). The CUDA sources are `csrc/hash_table.cu` (kernels 1
and 3), `csrc/probe.cu` (kernel 2) and `csrc/group_fold.cu` (kernel 4), whose
headers say what bounds them on the card and what their design does about it.

=====================  ============================================  ==============================
wrapper                replaces                                      CUDA entry point
=====================  ============================================  ==============================
build_group_ids        pallas_build_group_ids  (pallas_hash.py:94)   dftpu_group_build
multiway_probe         pallas_multiway_probe   (pallas_hash.py:259)  dftpu_multiway_probe (probe.cu)
group_aggregate        pallas_global_hash_aggregate (:433)           dftpu_group_aggregate
group_fold             index_add_ / scatter_reduce_ (no TPU kernel)  dftpu_group_fold (group_fold.cu)
=====================  ============================================  ==============================

Layout. Kernels 1-3 keep the slot layout of the reference's XLA claim loop
(`ops/aggregate.py build_group_table`), not the Pallas kernels' sequential
inserts into 2^16-slot VMEM partitions: the port's GROUP BY output order
then equals the reference's default path byte for byte. Grouping, the
representative row (lowest row index of a group) and the accumulators equal
what the Pallas kernels compute; the partitions and their 2^20-slot cap were
VMEM artifacts and are gone.

Dispatch. A wrapper runs the plain version only because its inputs lie on
the CPU; for CUDA tensors it launches the kernel or raises. Each launch adds
one to its shape in ``BUILD_SHAPES``, ``PROBE_SHAPES``, ``AGG_SHAPES`` or
``FOLD_SHAPES``;
`launches()` sums them per wrapper. Each call of a wrapper, on either path,
is a ``kernel:<wrapper name>`` span (runtime/tracing.py). Key lanes are
int32; int64 lanes (``DFTPU_PRECISION=x64``) are split into (lo, hi) int32
pairs, which keeps equality — and therefore every slot — unchanged.

Builds. A build's round count and overflow flag are 0-d tensors on the
build's device, and each build adds to that device's ``ROUND_STATS``
counter (the CUDA kernel on the card, the plain path on the CPU), so a
build on the card makes no host sync; `round_stats()` reads the counters
when asked. ``BUILD_SHAPES`` counts the launches of kernel 1 by shape,
``AGG_SHAPES`` those of kernel 3. While spans are on (the profiler records
or a single-node trace is open: `tracing.spans_on()`) each build also adds
its live-row count, which kernel 1 leaves on the card in its scratch, to a
device counter of its shape (``LIVE_ROWS``: one device add, no sync);
`live_build_rows()` reads them.

Probe. Kernel 2 walks (row, table) pairs in chunks of two a thread, read
coalesced, and each thread walks its two chains in lock step, issuing a
step's table reads of both before it compares either. A launch takes at most
``MAX_TABLES_PER_LAUNCH`` tables, whose descriptors (first slot, slot count)
travel by value as the kernel's parameter: no host-to-device copy per
launch; more tables take one launch per group (`probe_launches`). Each group
takes one of two routes, chosen from its tables' bytes (`probe_route`):
``"smem"`` when the key lanes and used flags fit one block's shared memory
(every block bulk-copies them in once, then probes from shared memory),
else ``"l2"``, which reads the tables through L2 (the read-only path) while
the row stream is streamed past it, the key lanes of a slot only once its
used flag says it is used. Where a launch has at least
``PACK_PAIRS_PER_SLOT`` pairs per table slot (`packs_records`), the L2 route
first packs each slot's key lanes and used flag into one record, so a step
reads one 32-byte sector instead of two; the packing pass reads and writes
the whole table, so it pays only for probes large beside their tables
(PERF.md). A route the card refuses raises; neither falls back to the
other. ``PROBE_SHAPES`` counts the launches by shape.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import threading
from typing import NamedTuple

import numpy as np
import torch

from datafusion_distributed_tpu_torch.ops import _build
from datafusion_distributed_tpu_torch.runtime import tracing

MAX_ROUNDS = 512
_INT32_MAX = int(np.iinfo(np.int32).max)
_INT32_MIN = int(np.iinfo(np.int32).min)
#: accumulator ops of group_aggregate, with their identities
AGG_OPS = {"sum": (0, 0), "min": (1, _INT32_MAX), "max": (2, _INT32_MIN)}
#: most accumulators of one group_aggregate (two bits of a 64-bit op word each)
MAX_ACCS = 32

#: group-build launches since the last reset, by shape: (rows, int32 key
#: lanes, slots) -> launches
BUILD_SHAPES: dict = {}
#: probe launches since the last reset, by shape: (rows, tables, lanes,
#: table slots) -> launches
PROBE_SHAPES: dict = {}
#: fused GROUP BY launches since the last reset, by shape: (rows, int32 key
#: lanes, slots, accumulator ops) -> launches
AGG_SHAPES: dict = {}
#: per-slot fold launches since the last reset, by shape: (rows, slots, op,
#: value dtype or None for a count) -> launches
FOLD_SHAPES: dict = {}
#: most tables of one probe launch (csrc/probe.cu kMaxTables)
MAX_TABLES_PER_LAUNCH = 8
#: most (row, table) pairs of one probe on the card (csrc/probe.cu kMaxPairs)
MAX_PAIRS = 2**31 - 2**23
#: the L2 route packs each slot's key lanes and used flag into one record
#: before it probes when the launch has at least this many (row, table)
#: pairs per table slot: the packing pass reads and writes the whole table,
#: and pays only where the probe's reads far outnumber the slots; at 4, the
#: 22 TPC-H queries spent more device time than at 16 or never (PERF.md)
PACK_PAIRS_PER_SLOT = 16
#: live rows of the group builds made while spans were on, since the last
#: reset: (device, (rows, int32 key lanes, slots)) -> 0-d int64 counter on
#: that device (the plain path counts on the CPU)
LIVE_ROWS: dict = {}
#: claim-loop rounds of the builds since the last reset, one int64 [3]
#: counter per device (builds, rounds summed, most rounds of one build):
#: the CUDA builds add to theirs on the card, the plain path to the CPU's
ROUND_STATS: dict = {}
#: every update of the counters above holds this lock: the coordinator runs
#: stages and tasks on threads, and an unlocked read-modify-write loses
#: counts
_COUNT_LOCK = threading.Lock()


def _round_stats_of(dev: torch.device) -> torch.Tensor:
    with _COUNT_LOCK:
        t = ROUND_STATS.get(dev)
        if t is None:
            t = ROUND_STATS[dev] = torch.zeros(3, dtype=torch.int64,
                                               device=dev)
        return t


def _count_launch(shapes: dict, shape: tuple) -> None:
    """One launch of a kernel, counted under its shape in ``shapes``."""
    with _COUNT_LOCK:
        shapes[shape] = shapes.get(shape, 0) + 1


def launches() -> dict:
    """Kernel launches per wrapper since the last reset (the plain CPU
    versions do not count): the sums of the shape counters."""
    with _COUNT_LOCK:
        return {"build_group_ids": sum(BUILD_SHAPES.values()),
                "multiway_probe": sum(PROBE_SHAPES.values()),
                "group_aggregate": sum(AGG_SHAPES.values()),
                "group_fold": sum(FOLD_SHAPES.values())}


def _add_live_rows(dev: torch.device, shape: tuple,
                   rows: torch.Tensor) -> None:
    """Add a build's live-row count (a 0-d tensor on ``dev``) to its
    shape's counter: one device add, no sync."""
    with _COUNT_LOCK:
        t = LIVE_ROWS.get((dev, shape))
        if t is None:
            t = LIVE_ROWS[(dev, shape)] = torch.zeros(
                (), dtype=torch.int64, device=dev)
        t.add_(rows)


def live_build_rows() -> dict:
    """Kernel 1's live rows by build shape (rows, int32 key lanes, slots),
    summed over devices, of the builds made while spans were on since the
    last reset. Reads each device's counters in one device-to-host copy."""
    with _COUNT_LOCK:
        items = list(LIVE_ROWS.items())
    by_dev: dict = {}
    for (dev, shape), t in items:
        by_dev.setdefault(dev, []).append((shape, t))
    out: dict = {}
    for pairs in by_dev.values():
        for (shape, _t), v in zip(pairs,
                                  torch.stack([t for _s, t in pairs]).tolist()):
            out[shape] = out.get(shape, 0) + int(v)
    return out


def round_stats() -> dict:
    """The round counters summed over devices (reads each card's counter:
    one device-to-host copy per device)."""
    out = {"builds": 0, "total": 0, "max": 0}
    for t in ROUND_STATS.values():
        builds, total, most = (int(v) for v in t.tolist())
        out["builds"] += builds
        out["total"] += total
        out["max"] = max(out["max"], most)
    return out


def reset_round_stats() -> None:
    for t in ROUND_STATS.values():
        t.zero_()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        BUILD_SHAPES.clear()
        PROBE_SHAPES.clear()
        AGG_SHAPES.clear()
        FOLD_SHAPES.clear()
        LIVE_ROWS.clear()
    reset_round_stats()


def _note_rounds_cpu(rounds: torch.Tensor) -> None:
    r = int(rounds)
    t = _round_stats_of(torch.device("cpu"))
    with _COUNT_LOCK:
        t[0] += 1
        t[1] += r
        t[2] = max(int(t[2]), r)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_PLL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "hash_table.cu": {
        "dftpu_group_build": [_P, _P, _P, _LL, _I, _LL, _I, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P],
        "dftpu_group_aggregate": [_P, _P, _P, _P, _ULL, _LL, _I, _I, _LL, _I,
                                  _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P],
    },
    "probe.cu": {
        "dftpu_multiway_probe": [_P, _P, _P, _P, _P, _PLL, _PLL, _I, _I, _I,
                                 _LL, _I, _I, _I, _P, _P, _P, _P],
        "dftpu_probe_smem_limit": [_PLL],
    },
    "group_fold.cu": {
        "dftpu_group_fold": [_P, _I, _P, _I, _P, _LL, _LL, _I, _I, _LL, _P,
                             _P],
    },
}


def _lib(source: str = "hash_table.cu") -> ctypes.CDLL:
    lib = _build.load(source)
    if not getattr(lib, "_dftpu_typed", False):
        for name, args in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.dftpu_error_string.argtypes = [ctypes.c_int]
        lib.dftpu_error_string.restype = ctypes.c_char_p
        lib._dftpu_typed = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.dftpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {what} failed: error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _require_cuda(*tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(
                f"mixed devices: expected CUDA tensors, got {t.device}"
            )


def _i32_lanes(keys: torch.Tensor) -> torch.Tensor:
    """Key lanes as contiguous int32, int64 lanes split into (lo, hi)."""
    keys = keys.contiguous()
    if keys.dtype == torch.int64:
        return keys.view(torch.int32)
    if keys.dtype != torch.int32:
        raise TypeError(f"key lanes must be int32 or int64, got {keys.dtype}")
    return keys


def _lanes_back(slot_keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return slot_keys.view(torch.int64) if dtype == torch.int64 else slot_keys


def _pow2(num_slots: int) -> None:
    if num_slots < 1 or num_slots & (num_slots - 1):
        raise ValueError(f"num_slots must be a power of two, got {num_slots}")


# ---------------------------------------------------------------------------
# Kernel 1: group build
# ---------------------------------------------------------------------------


def build_group_ids_plain(keys_mat, slot0, live, num_slots: int,
                          max_rounds: int = MAX_ROUNDS):
    """The reference's XLA claim loop as torch ops (one host-checked round
    per iteration). keys_mat [N, L] int, slot0 [N] int32, live [N] bool ->
    (gid [N] i32, slot_keys [H, L], slot_used [H] bool, overflow 0-d bool,
    rounds 0-d i32). Each round works on the rows still unresolved, in row
    order: a resolved row takes no part in a later round (it claims
    nothing and its slot never changes), so the result is the loop's over
    all rows, and a round costs what is left of the build."""
    n, lanes = keys_mat.shape
    dev = keys_mat.device
    h = num_slots
    gid = torch.zeros(n, dtype=torch.int32, device=dev)
    slot_keys = torch.zeros((h, lanes), dtype=keys_mat.dtype, device=dev)
    slot_used = torch.zeros(h, dtype=torch.bool, device=dev)
    # the unresolved rows, ascending, and each one's candidate slot
    act = torch.nonzero(live.to(torch.bool)).flatten()
    slot = slot0.to(torch.int64)[act]
    rounds = 0
    while rounds < max_rounds and act.numel():
        # 1. unresolved rows claim their candidate slot (min row-id wins)
        owner = torch.full((h,), n, dtype=torch.int64, device=dev)
        owner.scatter_reduce_(0, slot, act, reduce="amin")
        # only claims on slots empty at the start of the round count
        winner = (owner[slot] == act) & ~slot_used[slot]
        # 2. winners (one a slot) write their keys and mark their slots
        wslot = slot[winner]
        slot_keys[wslot] = keys_mat[act[winner]]
        slot_used[wslot] = True
        # 3. everyone compares; match -> resolve, mismatch on used -> probe
        used = slot_used[slot]
        match = used & (slot_keys[slot] == keys_mat[act]).all(dim=1)
        gid[act[match]] = slot[match].to(torch.int32)
        advance = used & ~match
        slot = torch.where(advance, (slot + 1) & (h - 1), slot)
        act, slot = act[~match], slot[~match]
        rounds += 1
    overflow = torch.tensor(act.numel() > 0, device=dev)
    return (gid, slot_keys, slot_used, overflow,
            torch.tensor(rounds, dtype=torch.int32, device=dev))


def build_group_ids(keys_mat, slot0, live, num_slots: int,
                    max_rounds: int = MAX_ROUNDS):
    """Assign each live row the slot of its key in an open-addressed table
    of ``num_slots`` (power of two) slots, by linear probing from ``slot0``;
    the first row of a key claims its slot. Same outputs as
    `build_group_ids_plain`; on the card the overflow flag and the round
    count stay device tensors, so a build makes no host sync."""
    _check_build_args(num_slots, max_rounds, keys_mat.shape[0])
    with tracing.span("kernel", "build_group_ids") as sp:
        lane_dtype = keys_mat.dtype
        keys = _i32_lanes(keys_mat)
        n, lanes = keys.shape
        shape = (n, lanes, num_slots)
        sp.note("shape", shape)
        if keys.device.type == "cpu":
            out = build_group_ids_plain(keys, slot0, live, num_slots,
                                        max_rounds)
            _note_rounds_cpu(out[4])
            if tracing.spans_on():
                _add_live_rows(keys.device, shape,
                               live.to(torch.bool).sum())
            return (out[0], _lanes_back(out[1], lane_dtype)) + out[2:]
        _require_cuda(slot0, live)
        dev = keys.device
        slot0 = slot0.to(torch.int32).contiguous()
        live = live.to(torch.bool).contiguous()
        outs = _build_outputs(n, lanes, num_slots, dev)
        # held past the launch; its counts[0] is the build's live rows
        scratch = _build_scratch(n, num_slots, max_rounds, dev)
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.dftpu_group_build(
                _ptr(keys), _ptr(slot0), _ptr(live), n, lanes, num_slots,
                max_rounds, *[_ptr(t) for t in outs],
                _ptr(_round_stats_of(dev)), *[_ptr(t) for t in scratch],
                _stream(keys),
            )
        _check(lib, err, "dftpu_group_build")
        _count_launch(BUILD_SHAPES, shape)
        if tracing.spans_on():
            _add_live_rows(dev, shape, scratch[2][0])
        gid, slot_keys, slot_used, rounds, overflow = outs
        return (gid, _lanes_back(slot_keys, lane_dtype), slot_used, overflow,
                rounds)


def _check_build_args(num_slots: int, max_rounds: int, n: int) -> None:
    _pow2(num_slots)
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be at least 1, got {max_rounds}")
    if n > _INT32_MAX:
        raise ValueError(f"{n} rows: row ids must fit int32")


def _build_outputs(n: int, lanes: int, num_slots: int, dev):
    """gid, slot_keys, slot_used, rounds, overflow: written by the kernel."""
    return (
        torch.empty(n, dtype=torch.int32, device=dev),
        torch.empty((num_slots, lanes), dtype=torch.int32, device=dev),
        torch.empty(num_slots, dtype=torch.bool, device=dev),
        torch.empty((), dtype=torch.int32, device=dev),
        torch.empty((), dtype=torch.bool, device=dev),
    )


def _build_scratch(n: int, num_slots: int, max_rounds: int, dev):
    return (
        # two lists of (row, slot) pairs: the rows left unresolved
        torch.empty((2, n, 2), dtype=torch.int32, device=dev),
        torch.empty(num_slots, dtype=torch.int32, device=dev),  # owner
        # live rows, then the rows left unresolved after each round
        torch.empty(max_rounds + 1, dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# Kernel 2: probe of K read-only tables
# ---------------------------------------------------------------------------


def multiway_probe_plain(keys, slot0, active, tkeys_packed, used_packed,
                         table_slots, max_rounds: int = MAX_ROUNDS):
    """Per table k, the reference's round-synchronous probe loop
    (`ops/join.py probe_group_table`): linear probing from slot0, stop at an
    empty slot (absent) or a full-lane match, overflow after max_rounds.
    keys [N, K, L], slot0 [N, K], active [N, K] bool, tkeys_packed
    [sum H_k, L], used_packed [sum H_k] bool -> (found [N, K] i32 local slot
    or -1, over [K] bool)."""
    n, ntab, _ = keys.shape
    dev = keys.device
    found = torch.full((n, ntab), -1, dtype=torch.int32, device=dev)
    over = torch.zeros(ntab, dtype=torch.bool, device=dev)
    off = 0
    for k, hk in enumerate(table_slots):
        act = active[:, k].to(torch.bool)
        slot = slot0[:, k].to(torch.int64)
        fk = found[:, k].clone()
        rounds = 0
        while rounds < max_rounds and bool(act.any()):
            used = used_packed[off + slot]
            match = used & (tkeys_packed[off + slot] == keys[:, k]).all(dim=1)
            fk = torch.where(act & match, slot.to(torch.int32), fk)
            act = act & used & ~match
            slot = torch.where(act, (slot + 1) & (hk - 1), slot)
            rounds += 1
        found[:, k] = fk
        over[k] = act.any()
        off += hk
    return found, over


def multiway_probe(keys, slot0, active, tkeys_packed, used_packed,
                   table_slots, max_rounds: int = MAX_ROUNDS):
    """Each (row, table) pair walks table k's chain for a full-lane key
    match. K = 1 is the hash-join probe. Same outputs as
    `multiway_probe_plain`."""
    table_slots = tuple(int(h) for h in table_slots)
    for hk in table_slots:
        _pow2(hk)
    if sum(table_slots) != tkeys_packed.shape[0]:
        raise ValueError(
            f"packed tables hold {tkeys_packed.shape[0]} slots, "
            f"table_slots sums to {sum(table_slots)}"
        )
    n, ntab, _ = keys.shape
    if ntab != len(table_slots):
        raise ValueError(f"{ntab} key sets for {len(table_slots)} tables")
    with tracing.span("kernel", "multiway_probe") as sp:
        keys = _i32_lanes(keys)
        tkeys = _i32_lanes(tkeys_packed)
        if keys.shape[2] != tkeys.shape[1]:
            raise ValueError(
                "probe keys and tables have different lane counts")
        sp.note("shape", (n, ntab, keys.shape[2], table_slots))
        if keys.device.type == "cpu":
            return multiway_probe_plain(keys, slot0, active, tkeys,
                                        used_packed, table_slots, max_rounds)
        return probe_cuda(keys, slot0, active, tkeys, used_packed,
                          table_slots, max_rounds)


class ProbeLaunch(NamedTuple):
    """One probe launch: a group of consecutive tables and its route."""

    k0: int  # the group's first table
    offsets: tuple  # each table's first slot in the packed arrays
    slots: tuple  # each table's slot count
    route: str  # "smem" or "l2"


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def smem_table_bytes(slots: int, lanes: int) -> int:
    """Shared memory the shared-memory route takes for tables of ``slots``
    slots in all: their int32 key lanes and their used flags, each span
    widened to 16-byte boundaries for the bulk copies (csrc/probe.cu)."""
    return _round16(4 * lanes * slots) + 16 + _round16(slots) + 16


def probe_route(slots: int, lanes: int, smem_limit: int) -> str:
    """"smem" when tables of ``slots`` slots in all fit ``smem_limit`` bytes
    of a block's shared memory, else "l2"."""
    return "smem" if smem_table_bytes(slots, lanes) <= smem_limit else "l2"


@functools.lru_cache(maxsize=256)
def probe_launches(table_slots: tuple, lanes: int, smem_limit: int,
                   cap: int = MAX_TABLES_PER_LAUNCH) -> tuple:
    """The launches of one probe: consecutive groups of at most ``cap``
    tables, each with its tables' descriptors and the route their bytes
    choose. ``table_slots`` is a tuple of ints."""
    offsets = (0,) + tuple(itertools.accumulate(table_slots))[:-1]
    return tuple(
        ProbeLaunch(k0, offsets[k0:k0 + cap], table_slots[k0:k0 + cap],
                    probe_route(sum(table_slots[k0:k0 + cap]), lanes,
                                smem_limit))
        for k0 in range(0, len(table_slots), cap))


_ROUTE_CODES = {"l2": 0, "l2_packed": 1, "smem": 2}  # csrc/probe.cu Route
_SMEM_LIMITS: dict = {}  # device index -> bytes


def smem_limit(dev: torch.device) -> int:
    """Bytes of shared memory a block of the shared-memory route may take
    on the card ``dev`` (asked once per card)."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    limit = _SMEM_LIMITS.get(index)
    if limit is None:
        lib = _lib("probe.cu")
        out = ctypes.c_longlong(0)
        with torch.cuda.device(index):
            _check(lib, lib.dftpu_probe_smem_limit(ctypes.byref(out)),
                   "dftpu_probe_smem_limit")
        limit = _SMEM_LIMITS[index] = out.value
    return limit


def packs_records(pairs: int, slots: int, lanes: int) -> bool:
    """Whether an L2-route launch of ``pairs`` (row, table) pairs against
    tables of ``slots`` slots in all first packs each slot's key lanes and
    used flag into one record (at most 3 int32 lanes)."""
    return lanes <= 3 and pairs >= PACK_PAIRS_PER_SLOT * slots


def probe_cuda(keys, slot0, active, tkeys, used, table_slots,
               max_rounds: int, pack_used=None):
    """`multiway_probe` on the card: one launch per group of tables
    (`probe_launches`), by the route the group's bytes choose. The L2
    route packs its records as `packs_records` says, or as ``pack_used``
    forces (True packs where the lanes allow, False never)."""
    _require_cuda(keys, slot0, active, tkeys, used)
    dev = keys.device
    keys = _i32_lanes(keys)
    tkeys = _i32_lanes(tkeys)
    n, ntab, lanes = keys.shape
    if n * ntab > MAX_PAIRS:
        raise ValueError(f"{n} rows x {ntab} tables: at most {MAX_PAIRS} "
                         "(row, table) pairs a probe")
    slot0 = slot0.to(torch.int32).contiguous()
    active = active.to(torch.bool).contiguous()
    used = used.to(torch.bool).contiguous()
    found = torch.empty((n, ntab), dtype=torch.int32, device=dev)
    over = torch.empty(ntab, dtype=torch.bool, device=dev)  # the C side fills
    lib = _lib("probe.cu")
    launches = probe_launches(table_slots, lanes, smem_limit(dev))
    with torch.cuda.device(dev):
        for launch in launches:
            g = len(launch.slots)
            pack = (packs_records(n * g, sum(launch.slots), lanes)
                    if pack_used is None else pack_used and lanes <= 3)
            route, scratch = launch.route, None
            if route == "l2" and pack:
                route = "l2_packed"
                scratch = torch.empty((sum(launch.slots), 2 if lanes == 1 else 4),
                                      dtype=torch.int32, device=dev)
            err = lib.dftpu_multiway_probe(
                _ptr(keys), _ptr(slot0), _ptr(active), _ptr(tkeys), _ptr(used),
                (ctypes.c_longlong * g)(*launch.offsets),
                (ctypes.c_longlong * g)(*launch.slots), g, launch.k0, ntab, n,
                lanes, max_rounds, _ROUTE_CODES[route],
                None if scratch is None else _ptr(scratch), _ptr(found),
                _ptr(over), _stream(keys),
            )
            _check(lib, err, "dftpu_multiway_probe")
            _count_launch(PROBE_SHAPES, (n, g, lanes, launch.slots))
    return found, over


# ---------------------------------------------------------------------------
# Kernel 3: group build fused with an int32 accumulator fold
# ---------------------------------------------------------------------------


def group_aggregate_plain(keys_mat, slot0, live, values, num_slots: int,
                          ops: tuple, max_rounds: int = MAX_ROUNDS):
    """Kernel 1's build, then an int32 sum/min/max fold of ``values``
    [N, A] per accumulator (callers pre-map invalid rows to each op's
    identity) and ``rep`` = lowest live row index per used slot (0 for
    unused slots). -> (gid, rep, used, acc [H, A] i32, overflow, rounds)."""
    gid, _tk, used, overflow, rounds = build_group_ids_plain(
        keys_mat, slot0, live, num_slots, max_rounds
    )
    n = keys_mat.shape[0]
    dev = keys_mat.device
    h = num_slots
    vgid = torch.where(live, gid.to(torch.int64), h)
    rep = torch.full((h + 1,), _INT32_MAX, dtype=torch.int32, device=dev)
    rep.scatter_reduce_(0, vgid, torch.arange(n, dtype=torch.int32,
                                              device=dev), reduce="amin")
    rep = torch.where(used, rep[:h], 0)
    accs = []
    for a, op in enumerate(ops):
        code, ident = AGG_OPS[op]
        acc = torch.full((h + 1,), ident, dtype=torch.int32, device=dev)
        v = values[:, a].to(torch.int32)
        if op == "sum":
            acc.index_add_(0, vgid, v)
        else:
            acc.scatter_reduce_(0, vgid, v,
                                reduce="amin" if op == "min" else "amax")
        accs.append(acc[:h])
    acc = (torch.stack(accs, dim=1) if accs
           else torch.zeros((h, 0), dtype=torch.int32, device=dev))
    return gid, rep, used, acc, overflow, rounds


def group_aggregate(keys_mat, slot0, live, values, num_slots: int,
                    ops: tuple, max_rounds: int = MAX_ROUNDS):
    """Group build + int32 accumulator fold in one call (at most
    ``MAX_ACCS`` accumulators); same outputs as `group_aggregate_plain`."""
    _check_build_args(num_slots, max_rounds, keys_mat.shape[0])
    for op in ops:
        if op not in AGG_OPS:
            raise ValueError(f"unknown accumulator op {op!r}")
    if len(ops) > MAX_ACCS:
        raise ValueError(f"{len(ops)} accumulators, at most {MAX_ACCS}")
    if values.shape[1] != len(ops):
        raise ValueError(f"{values.shape[1]} value columns for {len(ops)} ops")
    if keys_mat.dtype != torch.int32 or values.dtype != torch.int32:
        raise TypeError("group_aggregate takes int32 key lanes and values")
    with tracing.span("kernel", "group_aggregate") as sp:
        sp.note("shape", (*keys_mat.shape, num_slots, tuple(ops)))
        return _group_aggregate(keys_mat, slot0, live, values, num_slots,
                                ops, max_rounds)


def _group_aggregate(keys_mat, slot0, live, values, num_slots: int,
                     ops: tuple, max_rounds: int):
    if keys_mat.device.type == "cpu":
        out = group_aggregate_plain(keys_mat, slot0, live, values, num_slots,
                                    ops, max_rounds)
        _note_rounds_cpu(out[5])
        return out
    _require_cuda(slot0, live, values)
    dev = keys_mat.device
    n, lanes = keys_mat.shape
    keys = keys_mat.contiguous()
    values = values.contiguous()
    slot0 = slot0.to(torch.int32).contiguous()
    live = live.to(torch.bool).contiguous()
    # the op codes travel by value, two bits each: no host-to-device copy
    op_word = sum(AGG_OPS[o][0] << (2 * a) for a, o in enumerate(ops))
    acc = torch.empty((num_slots, len(ops)), dtype=torch.int32, device=dev)
    rep = torch.empty(num_slots, dtype=torch.int32, device=dev)
    gid, slot_keys, used, rounds, overflow = _build_outputs(
        n, lanes, num_slots, dev)
    scratch = _build_scratch(n, num_slots, max_rounds, dev)  # held past launch
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.dftpu_group_aggregate(
            _ptr(keys), _ptr(slot0), _ptr(live), _ptr(values), op_word,
            n, lanes, len(ops), num_slots, max_rounds, _ptr(gid),
            _ptr(slot_keys), _ptr(used), _ptr(acc), _ptr(rep), _ptr(rounds),
            _ptr(overflow), _ptr(_round_stats_of(dev)),
            *[_ptr(t) for t in scratch], _stream(keys),
        )
    _check(lib, err, "dftpu_group_aggregate")
    _count_launch(AGG_SHAPES, (n, lanes, num_slots, tuple(ops)))
    return gid, rep, used, acc, overflow, rounds


# ---------------------------------------------------------------------------
# Kernel 4: per-slot fold of integer values
# ---------------------------------------------------------------------------

#: ops of group_fold (csrc/group_fold.cu Op; a count is a sum of ones)
FOLD_OPS = {"sum": 0, "min": 1, "max": 2, "count": 0}
#: value dtypes the fold reads in place -> csrc/group_fold.cu Kind
_FOLD_KINDS = {torch.bool: 1, torch.uint8: 1, torch.int8: 2, torch.int16: 3,
               torch.int32: 4, torch.int64: 5}


def _fold_dtypes(vals, op: str) -> tuple:
    """(accumulator dtype, result dtype) of a fold: 1- to 4-byte values fold
    in int32 and narrow back, int64 in int64, a count in int64."""
    if op == "count":
        return torch.int64, torch.int64
    if vals.dtype not in _FOLD_KINDS or (op == "sum"
                                         and vals.dtype == torch.bool):
        raise TypeError(f"group_fold {op} takes integer values, got "
                        f"{vals.dtype}")
    acc = torch.int64 if vals.dtype == torch.int64 else torch.int32
    return acc, vals.dtype


def _fold_identity(op: str, dtype: torch.dtype) -> int:
    if op in ("sum", "count"):
        return 0
    if dtype == torch.bool:
        return int(op == "min")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def group_fold_plain(gid, vals, num_slots: int, op: str, num_rows=None):
    """[num_slots] fold, by ``op`` (sum, min, max, or count: the rows), of
    ``vals`` over the rows whose ``gid`` lies in [0, num_slots) among the
    first ``num_rows`` (a 0-d tensor; all rows when None). The drop slot
    ``num_slots`` and any id outside the table add nothing. Sums wrap in
    the values' dtype, as ``index_add_`` does; slots without rows hold the
    op's identity in that dtype (the dtype's max for min, min for max)."""
    acc_dtype, out_dtype = _fold_dtypes(vals, op)
    n = gid.shape[0] if num_rows is None else min(gid.shape[0],
                                                  max(int(num_rows), 0))
    g = gid[:n].to(torch.int64)
    keep = (g >= 0) & (g < num_slots)
    g = g[keep]
    out = torch.full((num_slots,), _fold_identity(op, out_dtype),
                     dtype=acc_dtype, device=gid.device)
    if op == "count":
        return out.index_add_(0, g, torch.ones_like(g))
    v = vals[:n][keep].to(acc_dtype)
    if op == "sum":
        out.index_add_(0, g, v)
    else:
        out.scatter_reduce_(0, g, v, reduce="amin" if op == "min" else "amax")
    return out.to(out_dtype)


def group_fold(gid, vals, num_slots: int, op: str, num_rows=None):
    """Per-slot fold of integer values (`group_fold_plain`'s outputs): the
    GROUP BYs' integer SUMs, COUNTs, MINs and MAXes. ``gid`` [N] int32 or
    int64, ``vals`` [N] bool or integer (None for a count), ``num_rows`` a
    0-d integer tensor on their device bounding the live prefix, or None.
    On the card the live prefix is read by the kernel: no host sync."""
    if op not in FOLD_OPS:
        raise ValueError(f"unknown fold op {op!r}")
    if (vals is None) != (op == "count"):
        raise ValueError("a count takes no values; every other fold does")
    if gid.dtype not in (torch.int32, torch.int64) or gid.dim() != 1:
        raise TypeError(f"group ids must be [N] int32 or int64, got "
                        f"{tuple(gid.shape)} {gid.dtype}")
    if vals is not None and vals.shape != gid.shape:
        raise ValueError(f"{tuple(vals.shape)} values for "
                         f"{tuple(gid.shape)} group ids")
    if not 1 <= num_slots <= _INT32_MAX:
        raise ValueError(f"num_slots must lie in [1, 2^31), got {num_slots}")
    acc_dtype, out_dtype = _fold_dtypes(vals, op)
    n = gid.shape[0]
    with tracing.span("kernel", "group_fold") as sp:
        shape = (n, num_slots, op, None if vals is None else str(vals.dtype))
        sp.note("shape", shape)
        if gid.device.type == "cpu":
            return group_fold_plain(gid, vals, num_slots, op, num_rows)
        _require_cuda(*(t for t in (vals, num_rows) if t is not None))
        dev = gid.device
        gid = gid.contiguous()
        if vals is not None:
            vals = vals.contiguous()
        if num_rows is not None:
            num_rows = num_rows.to(torch.int32).reshape(())
        ident = _fold_identity(op, out_dtype)
        acc_bytes = 8 if acc_dtype == torch.int64 else 4
        out = torch.full((num_slots,), ident, dtype=acc_dtype, device=dev)
        if n == 0:
            return out.to(out_dtype)
        lib = _lib("group_fold.cu")
        with torch.cuda.device(dev):
            err = lib.dftpu_group_fold(
                _ptr(gid), gid.element_size(),
                None if vals is None else _ptr(vals),
                0 if vals is None else _FOLD_KINDS[vals.dtype],
                None if num_rows is None else _ptr(num_rows), n, num_slots,
                FOLD_OPS[op], acc_bytes, ident, _ptr(out), _stream(out),
            )
        _check(lib, err, "dftpu_group_fold")
        _count_launch(FOLD_SHAPES, shape)
        return out.to(out_dtype)
