"""SQL REPL over an in-memory distributed cluster.

The reference ships a datafusion-cli fork wired to an InMemoryChannelResolver
— a full distributed REPL in one process (`cli/src/main.rs`). Same
capability here, on the card (``--device cpu`` runs the plain versions of
the kernels on the host):

    python -m datafusion_distributed_tpu_torch.cli \
        --register lineitem=path/to/lineitem.parquet --tasks 8

Commands inside the REPL:
    <sql>;                 run a query (single-node by default)
    \\d                     list tables
    \\explain <sql>         show the physical plan
    \\explain_dist <sql>    show the staged distributed plan
    \\dist on|off           toggle distributed execution (the staged plan
                           over --tasks tasks on the session's device)
    \\tpch [sf]             generate + register TPC-H tables
    \\q                     quit
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="GPU query engine REPL")
    parser.add_argument("--register", action="append", default=[],
                        metavar="NAME=PATH", help="register a parquet table")
    parser.add_argument("--tasks", type=int, default=8,
                        help="task count for distributed execution")
    parser.add_argument("--command", "-c", default=None,
                        help="run one SQL string and exit")
    parser.add_argument("--tpch", type=float, default=None, metavar="SF",
                        help="generate + register TPC-H tables at this SF")
    parser.add_argument("--device", default=None,
                        help="torch device of the session (default: cuda)")
    args = parser.parse_args(argv)

    from datafusion_distributed_tpu_torch.sql.context import SessionContext

    ctx = SessionContext(device=args.device)
    for spec in args.register:
        name, _, path = spec.partition("=")
        if not path:
            print(f"bad --register {spec!r}; want NAME=PATH", file=sys.stderr)
            return 2
        ctx.register_parquet(name, path)
        print(f"registered {name} from {path}")
    if args.tpch is not None:
        from datafusion_distributed_tpu_torch.data.tpchgen import register_tpch

        register_tpch(ctx, sf=args.tpch)
        print(f"registered TPC-H tables at SF={args.tpch}")

    distributed = False

    def run_sql(sql: str) -> None:
        nonlocal distributed
        t0 = time.perf_counter()
        df = ctx.sql(sql)
        if df is None:
            print("OK")
            return
        if distributed:
            table = df.collect_distributed_table(num_tasks=args.tasks)
            out = df._strip_quals(table).to_pandas()
        else:
            out = df.to_pandas()
        dt = time.perf_counter() - t0
        with _full_width():
            print(out.to_string(index=False, max_rows=40))
        print(f"({len(out)} rows in {dt:.3f}s"
              f"{' distributed' if distributed else ''})")

    if args.command:
        run_sql(args.command)
        return 0

    print("GPU distributed query engine — \\q to quit, \\d to list tables")
    buf = ""
    while True:
        try:
            prompt = "... " if buf else "sql> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        stripped = line.strip()
        if not buf and stripped.startswith("\\"):
            cmd, _, rest = stripped.partition(" ")
            if cmd == "\\q":
                return 0
            if cmd == "\\d":
                for name in sorted(ctx.catalog.tables):
                    t = ctx.catalog.tables[name]
                    print(f"  {name}  ({int(t.num_rows)} rows, "
                          f"{len(t.names)} cols)")
                continue
            if cmd == "\\dist":
                distributed = rest.strip() == "on"
                print(f"distributed execution: {'on' if distributed else 'off'}")
                continue
            if cmd == "\\explain":
                print(ctx.sql(rest).explain())
                continue
            if cmd == "\\explain_dist":
                print(ctx.sql(rest).explain_distributed(args.tasks))
                continue
            if cmd == "\\tpch":
                from datafusion_distributed_tpu_torch.data.tpchgen import (
                    register_tpch,
                )

                sf = float(rest) if rest.strip() else 0.01
                register_tpch(ctx, sf=sf)
                print(f"registered TPC-H tables at SF={sf}")
                continue
            print(f"unknown command {cmd}")
            continue
        buf += ("\n" if buf else "") + line
        if stripped.endswith(";"):
            sql, buf = buf, ""
            try:
                run_sql(sql)
            except Exception as e:
                print(f"error: {type(e).__name__}: {e}", file=sys.stderr)


class _full_width:
    def __enter__(self):
        import pandas as pd

        self._ctx = pd.option_context("display.width", 200,
                                      "display.max_columns", 50)
        self._ctx.__enter__()
        return self

    def __exit__(self, *a):
        self._ctx.__exit__(*a)


if __name__ == "__main__":
    sys.exit(main())
