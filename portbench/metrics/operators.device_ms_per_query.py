"""operators.device_ms_per_query: device milliseconds per query of every
device activity (torch kernels, copies, memsets) that is not one of the
port's own CUDA kernels (`csrc/*.cu`)."""

from harness import trace


def read(rec: dict):
    qs = rec["queries"]
    if not qs or not rec["device"]:
        return None
    ours = [k for syms in rec["kernels"].values() for k in syms]
    total = sum((e - s) / 1e9 for _n, s, e in rec["device"])
    return 1e3 * (total - trace.kernel_seconds(rec, ours)) / len(qs)
