"""Live cluster console against a running cluster.

The port of `examples/console_monitor.py` (the reference crate's
`console/` TUI): worker discovery + task progress at a poll interval. This
example starts an in-process cluster, runs a query on the session's device
and renders a few console frames (point `python -m
datafusion_distributed_tpu_torch.console grpc://host:port` at a real
cluster).

    python -m datafusion_distributed_tpu_torch.examples.console_monitor
    python -m datafusion_distributed_tpu_torch.examples.console_monitor \\
        --device cpu
"""

from __future__ import annotations

import io
import re
import sys

import numpy as np
import pyarrow as pa

from datafusion_distributed_tpu_torch.console import Console
from datafusion_distributed_tpu_torch.examples._common import parser, result
from datafusion_distributed_tpu_torch.ops.table import resolve_device
from datafusion_distributed_tpu_torch.runtime.coordinator import (
    Coordinator,
    InMemoryCluster,
)
from datafusion_distributed_tpu_torch.sql.context import SessionContext

ROWS = 8_000
FRAMES = 3
POLL_S = 0.2
CLEAR = "\x1b[2J\x1b[H"  # what Console.run writes ahead of each frame
ANSI = re.compile(r"\x1b\[[0-9;]*[A-Za-z]")


def sections(frame: str) -> list:
    """A console frame's section titles (its bold runs)."""
    return [ANSI.sub("", s)
            for s in re.findall(r"\x1b\[1m(.*?)\x1b\[0m", frame)]


def worker_rows(frame: str) -> list:
    """A console frame's worker rows, split into their fields."""
    return [ANSI.sub("", x).split() for x in frame.splitlines()
            if ANSI.sub("", x).strip().startswith("mem://")]


def run(device=None, n: int = ROWS, out=None) -> dict:
    """-> facts: each frame's section titles (``sections``) and worker
    rows (``workers``), its clock and process figures left out; observed:
    the console's frames as it wrote them (``frames``, each without its
    clear-screen prefix) and the task keys it tracked (``tracked``, as
    text). ``out`` also receives everything the console writes."""
    cluster = InMemoryCluster(3)
    coordinator = Coordinator(resolver=cluster, channels=cluster)
    rng = np.random.default_rng(4)
    ctx = SessionContext(device=resolve_device(device))
    ctx.register_arrow("t", pa.table({
        "k": rng.integers(0, 20, n), "v": rng.normal(size=n),
    }))
    df = ctx.sql("select k, avg(v) from t group by k")
    df.collect_coordinated_table(coordinator=coordinator, num_tasks=4)

    buf = io.StringIO()
    console = Console(cluster, cluster, poll_s=POLL_S, out=buf)
    tracked = list(coordinator.metrics.keys())[:5]
    console.track(tracked)
    console.run(frames=FRAMES)
    text = buf.getvalue()
    if out is not None:
        out.write(text)
        out.flush()
    frames = [f.rstrip("\n") for f in text.split(CLEAR) if f]
    return result(
        facts={"sections": [sections(f) for f in frames],
               "workers": [worker_rows(f) for f in frames]},
        observed={"frames": frames, "tracked": [str(k) for k in tracked]})


def main(argv=None) -> None:
    run(parser(__doc__).parse_args(argv).device, out=sys.stdout)


if __name__ == "__main__":
    main()
