"""Rehearse a run of a cell on the CPU at a small size, through the same
harness code as `portbench/run.py`, without its look for a card.

    python portbench/tests/rehearse.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> --size <rows or scale> [--fault <kind>]

``--fault`` breaks the timed path underneath the harness, to see `correct`
come out false: ``alter`` changes one value of every answer where the port
produces it (`Table.to_numpy`), ``half`` registers only the first half of
each table's rows (half of the input left out of every answer). The last
line is the result; the line before it lists the loaded modules that the
benchmark forbids.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def _break(kind: str) -> None:
    from datafusion_distributed_tpu_torch.ops.table import Table
    from harness import load

    if kind == "alter":
        original = Table.to_numpy

        def to_numpy(self, *a, **kw):
            out = original(self, *a, **kw)
            for name, vals in out.items():
                if len(vals) and vals.dtype.kind in "if":
                    vals = vals.copy()
                    vals[0] = vals[0] + 1
                    out[name] = vals
                    break
            return out

        Table.to_numpy = to_numpy
    elif kind == "half":
        original_register = load.register

        def register(ctx, tables):
            halved = {}
            for name, t in tables.items():
                n = load.rows_of(t)
                if "rows" in t:
                    halved[name] = dict(t, rows=n // 2)
                else:
                    halved[name] = dict(t, columns={
                        c: v[: max(1, n // 2)] for c, v in
                        t["columns"].items()})
            return original_register(ctx, halved)

        load.register = register
    else:
        raise ValueError(f"unknown fault {kind!r}")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--size", type=float, required=True)
    p.add_argument("--fault")
    args = p.parse_args()

    from harness import cells, runner

    cell = cells.prepared(args.workload)
    config = cells.config(cell["config"])
    mix = cells.traffic(cell["traffic"])
    os.environ.update(config.get("env", {}))
    key = "rows" if "rows" in config["generator_args"] else "scale"
    size = int(args.size) if key == "rows" else args.size
    config["generator_args"] = dict(config["generator_args"], **{key: size})
    if args.fault:
        _break(args.fault)
    result = runner.run_cell(cell, config, mix, seed=args.seed,
                             seconds=args.seconds, traced=bool(args.trace),
                             device="cpu", t0=T0)
    import run

    print(json.dumps(run.forbidden_modules()))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
