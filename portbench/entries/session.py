"""Entry path `session`: single-node SQL through the port's `SessionContext`
on one device, the path a user of the library calls.

A query is `ctx.sql(text)` then `df.physical_plan()` (the session's plan
cache answers warm calls), then `df.collect_table()` (execution with the
overflow retry), then `Table.to_numpy()`: its result as host numpy arrays.
The three steps are the host ranges `plan`, `execute` and `to_host` that a
traced run labels the device's idle gaps with.
"""

from __future__ import annotations

import re
import time

from harness import load

_CAPACITY = re.compile(r"\{capacity:(\w+)\*(\d+)\}")


class Entry:
    def __init__(self, config: dict, tables: dict, device) -> None:
        from datafusion_distributed_tpu_torch.sql.context import (
            SessionConfig,
            SessionContext,
        )

        self.ctx = SessionContext(SessionConfig(**config.get("session", {})),
                                  device=device)
        caps = load.register(self.ctx, tables)
        for stmt in config.get("set", []):
            self.ctx.sql(_CAPACITY.sub(
                lambda m: str(caps[m.group(1)] * int(m.group(2))), stmt))

    def run(self, sql: str, mark) -> tuple:
        """-> (result columns, {"plan", "execute", "to_host"} seconds).
        ``mark(step)`` is a context manager around each step."""
        t0 = time.perf_counter()
        with mark("plan"):
            df = self.ctx.sql(sql)
            try:
                df.physical_plan()
            except RuntimeError as e:
                # a plan-time subquery that overflows: collect_table's
                # retry widens and plans again
                if "overflow" not in str(e):
                    raise
        t1 = time.perf_counter()
        with mark("execute"):
            table = df.collect_table()
        t2 = time.perf_counter()
        with mark("to_host"):
            out = table.to_numpy()
        t3 = time.perf_counter()
        return out, {"plan": t1 - t0, "execute": t2 - t1, "to_host": t3 - t2}

    def close(self) -> None:
        self.ctx = None
