"""The control of a cell: what `correct` must refuse.

    python3 portbench/control.py --workload <cell> --seed <n> [--seconds s]

The configuration's ``control`` names it. ``"kind": "program"`` runs the
cell through the same harness as `run.py` with the control's environment
laid over the configuration's (the port's own narrower precision path), for
``--seconds`` (0: one pass of the mix). ``"kind": "reference"`` puts the
plain reference, with every float it reads and computes rounded to
``round``, in the program's place, and compares each query's answer with
the reference in full precision. Either way the last line of standard
output is a JSON object with the numbers compared, each beside its limit,
and whether the control came out correct (it must not). The benchmark's own
runs never run it; `portbench/tests/test_portbench_runs.py` holds it at a
small size.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

def reference_control(config: dict, seed: int, device) -> dict:
    import torch

    from harness import cells, compare, runner

    dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16,
             "float32": torch.float32}[config["control"]["round"]]
    tables = runner.generate(config, seed, device)
    g = config["guarantees"]
    ref = cells.module("reference", config["reference"])
    full = ref.prepare(tables, {"rtol": g["float_rtol"], "device": device})
    low = ref.prepare(tables, {"rtol": g["float_rtol"], "device": device,
                               "round": lambda x: x.to(dtype).to(x.dtype)})
    wrong, worst = [], 0.0
    for name, fn in ref.QUERIES.items():
        fault, err = compare.compare(compare.as_output(fn(low)), fn(full),
                                     g["float_rtol"], g["float_floor"])
        worst = max(worst, err)
        if fault:
            wrong.append(name)
            runner.log(f"control {name}: {fault}")
    checks = {"failed_queries": {"value": 0, "limit": 0},
              "wrong_results": {"value": len(wrong), "limit": 0},
              "float_rel_err": {"value": worst, "limit": g["float_rtol"]}}
    return {"correct": all(c["value"] <= c["limit"]
                           for c in checks.values()), "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=float,
                   help="rows or scale in place of the configuration's")
    args = p.parse_args(argv)

    from harness import cells, runner

    cell = cells.prepared(args.workload)
    config = cells.config(cell["config"])
    if args.size is not None:
        key = "rows" if "rows" in config["generator_args"] else "scale"
        size = int(args.size) if key == "rows" else args.size
        config["generator_args"] = dict(config["generator_args"],
                                        **{key: size})
    control = config["control"]
    os.environ.update(config.get("env", {}))
    if control["kind"] == "program":
        os.environ.update(control["env"])
        result = runner.run_cell(cell, config, cells.traffic(cell["traffic"]),
                                 seed=args.seed, seconds=args.seconds,
                                 traced=False, device=args.device, t0=T0)
        result = {"correct": result["correct"], "checks": result["checks"]}
    else:
        import torch

        result = reference_control(config, args.seed,
                                   torch.device(args.device))
    result["control"] = control["why"]
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
