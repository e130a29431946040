"""kernels.probe_roofline: kernel 2 (`multiway_probe`, every kernel of
csrc/probe.cu: the probe routes and the record packing a launch may run
first): the least time of its launches over the traced passes
(`harness/roofline.probe_bytes` over the card's memory bandwidth, from the
wrapper's PROBE_SHAPES) over their device time, in percent. Nothing where
it did not run."""

from harness import roofline, trace

SOURCE = "probe.cu"


def read(rec: dict):
    symbols = rec["kernels"].get(SOURCE)
    if not symbols:
        return None
    need = sum(count * roofline.probe_bytes(rows, tables)
               for (rows, tables, _lanes, _slots), count
               in rec["probe_shapes"].items())
    return roofline.share_pct(need, trace.kernel_seconds(rec, symbols),
                              rec["hbm_bytes_per_s"])
