"""executor.retry_ms_per_query: host milliseconds per query in the
program's ``executor:attempt`` spans whose outcome is ``overflow``: the
passes of `DataFrame.collect_table`'s retry loop that planned, ran and were
thrown away because a hash table overflowed (the widening after each is
inside). The mean over the traced queries, read from the port's span
totals (`harness/spans.py`); nothing where the port keeps none, or where
no device activity was traced."""

from harness import spans


def read(rec: dict):
    totals = spans.program_totals()
    if totals is None or not rec["queries"] or not rec["device"]:
        return None
    seconds = spans.span_seconds(totals, "executor:attempt:overflow")
    return 1e3 * seconds / len(rec["queries"])
