"""executor.operator_syncs_per_query: of the runtime calls that
`executor.syncs_per_query` counts (stream and device synchronizations and
async copies), those issued while an ``op:`` span of the program was open
on the issuing thread: the syncs the operators make, beside the executor's
flag fetch, the planner's and the result's copy. Per traced query, from
the records' ``sync_calls`` (`harness/spans.py`); nothing without them."""

from harness import spans


def read(rec: dict):
    calls = rec.get("sync_calls")
    if calls is None or not rec["queries"] or not rec.get("spans"):
        return None
    op = spans.nearest(rec, "op")
    n = sum(1 for _n, _t, _ts, span in calls
            if span is not None and op[span] is not None)
    return n / len(rec["queries"])
