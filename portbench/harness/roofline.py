"""The table of peaks and the byte counts of the port's kernels.

A kernel's roofline share is the least time its launches could take, the
bytes they must move over the card's memory bandwidth, divided by the
device time they took. The wrappers of the port expose each launch's
shape, not its live rows or active pairs, so a launch is counted with only
the bytes it moves whatever the data: where a row may be dead, its key
bytes are not counted. The share can so only come out too low, never above
what the kernel reaches.
"""

from __future__ import annotations

#: published peaks (NVIDIA's data sheet, SXM part, dense), by the name
#: `torch.cuda.get_device_name()` gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(device_name: str):
    peak = PEAKS.get(device_name)
    return peak["hbm_bytes_per_s"] if peak else None


def build_bytes(rows: int, lanes: int, slots: int) -> int:
    """Kernel 1 (`build_group_ids`, csrc/hash_table.cu): every row's live
    flag read (1 byte) and group id written (4 bytes), and the table it
    clears and fills written once: the int32 key lanes and the used flag of
    every slot. The keys and first slots of the live rows are not counted."""
    return 5 * rows + slots * (4 * lanes + 1)


def probe_bytes(rows: int, tables: int) -> int:
    """Kernel 2 (`multiway_probe`, csrc/probe.cu), one launch over
    ``tables`` tables: every (row, table) pair's active flag read (1 byte)
    and found slot written (4 bytes). The keys and first slots of the
    active pairs and the table slots a probe reads are not counted."""
    return 5 * rows * tables


def share_pct(min_bytes: int, seconds: float, bytes_per_s):
    """The least time over the time taken, in percent; None without a
    launch, a device time or a peak."""
    if not min_bytes or not seconds or not bytes_per_s:
        return None
    return 100.0 * (min_bytes / bytes_per_s) / seconds
