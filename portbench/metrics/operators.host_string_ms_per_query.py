"""operators.host_string_ms_per_query: host milliseconds per query in the
program's ``expr:*`` spans: the string work done on the host over a
column's dictionary before the device gathers by code (a LIKE's regex over
every entry, a derived dictionary such as SUBSTRING's, the union of two
dictionaries, a string IN's code lookup, a string CAST's parse, LENGTH's
and CONCAT's tables). The mean over the traced queries, read from the
port's span totals (`harness/spans.py`); nothing where the port keeps
none, or where no device activity was traced."""

from harness import spans


def read(rec: dict):
    totals = spans.program_totals()
    if totals is None or not rec["queries"] or not rec["device"]:
        return None
    return 1e3 * spans.span_seconds(totals, "expr:") / len(rec["queries"])
