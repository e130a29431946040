"""session.plan_ms: host milliseconds per query in `ctx.sql(text)` and
`df.physical_plan()` (the session, the SQL front end, the planner and the
plan cache), the mean over the traced queries; the benchmark's own timer."""


def read(rec: dict):
    qs = rec["queries"]
    if not qs:
        return None
    return 1e3 * sum(q["plan"] for q in qs) / len(qs)
