"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the port
(`datafusion_distributed_tpu_torch/`) and `BENCHMARK.json`, on a machine
with a CUDA card. The last line of standard output is the result as one
JSON object; everything else goes to standard error. See
`portbench/README.md`.
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

#: top-level module names that must not be loaded in the process that
#: prints the result (the JAX package is the port's reference, not the
#: system measured)
FORBIDDEN = ("jax", "jaxlib", "flax", "datafusion_distributed_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import cells, runner

    cell = cells.workload(args.workload)
    config = cells.config(cell["config"])
    mix = cells.traffic(cell["traffic"])
    os.environ.update(config.get("env", {}))

    import torch

    chips = cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        runner.log(f"{args.workload} needs {chips} CUDA device(s); "
                   f"found {torch.cuda.device_count()}")
        return 2
    import datafusion_distributed_tpu_torch  # noqa: F401 - the system measured

    result = runner.run_cell(cell, config, mix, seed=args.seed,
                             seconds=args.seconds, traced=bool(args.trace),
                             device="cuda", t0=T0)
    found = forbidden_modules()
    if found:
        runner.log(f"loaded in this process: {', '.join(found)}")
        return 3
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
