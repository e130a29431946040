"""session.plan_span_ms: host milliseconds per query in the program's own
spans ``session:sql`` (`SessionContext.sql`: parse and bind) and
``planner:physical_plan`` (`DataFrame.physical_plan`, both of its calls a
query: the benchmark's and the one in `collect_table`'s retry loop, with
the plan cache and the plan's verification), the mean over the traced
queries. Read from the port's span totals (`harness/spans.py`); nothing
where the port keeps none, or where no device activity was traced (the
CPU's host time is all of its work)."""

from harness import spans


def read(rec: dict):
    totals = spans.program_totals()
    if totals is None or not rec["queries"] or not rec["device"]:
        return None
    seconds = spans.span_seconds(totals, "session:sql",
                                 "planner:physical_plan")
    return 1e3 * seconds / len(rec["queries"])
