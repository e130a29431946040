"""kernels.group_build_roofline: kernel 1's group builds (the port's
`build_group_ids` wrapper) against the card's memory bandwidth, in
percent: the least time of the builds over the device time of the
activities launched inside the wrapper's ``kernel:build_group_ids``
spans, whatever kernel ran there. Least time: `harness/roofline.py`
`build_bytes` for every launch by shape (`build_shapes`), plus each live
row's key lanes and first slot read (4 B a lane and 4 B), from the
program's live-row counts (``live_build_rows``, by shape), over the peak.
Nothing without the records' ``attributed`` activities and live rows, or
without a build."""

from harness import roofline, spans


def read(rec: dict):
    live = rec.get("live_build_rows")
    if rec.get("attributed") is None or live is None:
        return None
    need = sum(count * roofline.build_bytes(rows, lanes, slots)
               for (rows, lanes, slots), count in rec["build_shapes"].items())
    need += sum(n * (4 * lanes + 4) for (_rows, lanes, _slots), n
                in live.items())
    seconds = spans.device_seconds(rec, "kernel", "build_group_ids")
    return roofline.share_pct(need, seconds, rec["hbm_bytes_per_s"])
