"""A run of a cell through `run.py` that also reads the program's own spans.

    python3 portbench/spans_run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--tracing on]

With ``--trace 1`` the traced run's records gain what `harness/spans.py`
reads from the same profile (``spans``, ``attributed``, ``sync_calls``) and
the program's counters of the traced passes (``live_build_rows``; the claim
loop's rounds, from `hash_kernels.round_stats()` read before and after the
traced passes, never inside them). After `run.py`'s result line it prints
one more JSON line: every per-layer metric that has a reader under
`metrics/`, the ten largest idle totals by program span and query
(``idle_by_span``), and how completely the device time was put down to the
spans (``attribution``). ``--tracing on`` runs the cell's session under
``SET distributed.tracing = 'on'`` (a single-node query trace a query),
to measure what that costs. Needs what `run.py` needs: a CUDA card and the
port beside `portbench/`.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import cells, program, spans, trace  # noqa: E402

_KEPT: dict = {}


def _records(original):
    def records(prof, *args, **kwargs):
        rec = original(prof, *args, **kwargs)
        rec.update(spans.records(prof))
        rec["live_build_rows"] = spans.live_build_rows()
        _KEPT["rec"] = rec
        return rec
    return records


def _shapes(original):
    rounds = []

    def launch_shapes():
        from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

        rounds.append(hk.round_stats())
        return original()
    return launch_shapes, rounds


def _traced_session(entry_cls):
    class Entry(entry_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ctx.sql("SET distributed.tracing = 'on'")
    return Entry


def summary(rec: dict, rounds: list) -> dict:
    readings = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        value = cells.reader(path.stem).read(rec)
        if value is not None:
            readings[path.stem] = value
    busy = trace.busy_s(rec)
    build_symbol = trace.kernel_seconds(rec, ("group_build_kernel",))
    build_span = spans.device_seconds(rec, "kernel", "build_group_ids")
    host = {}
    for s in rec["spans"]:
        key = f"{s[0]}:{s[1]}"
        host[key] = host.get(key, 0.0) + (s[5] - s[4]) / 1e9
    out = {
        "per_layer": readings,
        "idle_by_span": spans.top(spans.idle_by_span(rec)),
        "attribution": {
            "busy_s": busy,
            "unattributed_s": spans.unattributed_seconds(rec),
            "unattributed_share": (spans.unattributed_seconds(rec) / busy
                                   if busy else None),
            "group_build_kernel_s": build_symbol,
            "build_group_ids_span_s": build_span,
            "sync_calls": len(rec["sync_calls"]),
        },
        "device_s_by_span": spans.top(_device_by_span(rec), 15),
        "syncs_by_span": spans.top(_syncs_by_span(rec), 15),
        "host_s_by_span": spans.top(host, 15),
        "program_span_totals": spans.program_totals(),
    }
    if len(rounds) == 2:
        before, after = rounds
        out["rounds"] = {"builds": after["builds"] - before["builds"],
                         "total": after["total"] - before["total"],
                         "max_since_start": after["max"]}
    return out


def _device_by_span(rec: dict) -> dict:
    out: dict = {}
    for _n, start, end, span in rec["attributed"]:
        key = "none" if span is None else ":".join(rec["spans"][span][:2])
        out[key] = out.get(key, 0.0) + (end - start) / 1e9
    return out


def _syncs_by_span(rec: dict) -> dict:
    out: dict = {}
    for name, _t, _ts, span in rec["sync_calls"]:
        key = name + " in " + ("none" if span is None
                               else ":".join(rec["spans"][span][:2]))
        out[key] = out.get(key, 0) + 1
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    tracing_on = False
    if "--tracing" in argv:
        i = argv.index("--tracing")
        tracing_on = argv[i + 1] == "on"
        del argv[i:i + 2]
    trace.records = _records(trace.records)
    program.launch_shapes, rounds = _shapes(program.launch_shapes)
    if tracing_on:
        entries = cells.module("entries", "session")
        entries.Entry = _traced_session(entries.Entry)
    import run

    run.T0 = T0
    rc = run.main(argv)
    if rc == 0 and "rec" in _KEPT:
        print(json.dumps(summary(_KEPT.pop("rec"), rounds), default=str),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
