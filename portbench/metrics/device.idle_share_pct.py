"""device.idle_share_pct: the share of the traced window in which no
device activity ran, in percent: 1 - the union of the device activities'
intervals over the window, the window running from the first query's start
to the last one's end."""

from harness import trace


def read(rec: dict):
    window = trace.window_s(rec)
    if window <= 0 or not rec["device"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(rec) / window)
