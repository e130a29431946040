"""operators.aggregate_device_ms_per_query: device milliseconds per query
of the activities put down to ``op:HashAggregate`` spans: launched while
the innermost operator span open on the launching thread was a GROUP BY
(its hashes, scatter-adds, segmented sums and kernel 1, under the kernel
wrappers' spans too; not the filters and projections below it, which run
inside it under their own ``op:`` spans). From the records' ``attributed``
activities (`harness/spans.py`); nothing without them or without an
aggregate."""

from harness import spans


def read(rec: dict):
    if rec.get("attributed") is None or not rec["queries"]:
        return None
    if not any(s[:2] == ("op", "HashAggregate") for s in rec["spans"]):
        return None
    seconds = spans.device_seconds(rec, "op", "HashAggregate")
    return 1e3 * seconds / len(rec["queries"])
