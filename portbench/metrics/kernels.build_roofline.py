"""kernels.build_roofline: kernel 1 (`build_group_ids`,
`group_build_kernel` in csrc/hash_table.cu): the least time of its launches
over the traced passes (`harness/roofline.build_bytes` over the card's
memory bandwidth, from the wrapper's BUILD_SHAPES) over their device time,
in percent. Nothing where it did not run."""

from harness import roofline, trace

SYMBOLS = ("group_build_kernel",)


def read(rec: dict):
    known = [k for syms in rec["kernels"].values() for k in syms]
    if not all(k in known for k in SYMBOLS):
        return None
    need = sum(count * roofline.build_bytes(rows, lanes, slots)
               for (rows, lanes, slots), count in rec["build_shapes"].items())
    return roofline.share_pct(need, trace.kernel_seconds(rec, SYMBOLS),
                              rec["hbm_bytes_per_s"])
