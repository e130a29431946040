"""What the examples share: the device rule, frames, the command line and
the ranks of the two SPMD examples.

Every example's ``run()`` returns one shape, ``{"frames": ..., "facts":
..., "observed": ...}``:

- ``frames``: name -> result frame. A frame is what `Table.to_numpy()`
  gives: column name -> numpy array, rows in the table's order. `show`
  prints one as the JAX package's examples print theirs (pandas, no index).
- ``facts``: name -> what the example saw that does not depend on the
  device or the run (staged-plan texts, clamped rows, routes, epochs, the
  refusal, fed rows and sums, the console's sections): equal on the card
  and on the CPU, run after run.
- ``observed``: name -> what the run measured and may vary (drain waits,
  wire bytes, urls, the console's raw frames).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

from datafusion_distributed_tpu_torch.ops.table import resolve_device


def show(frame: dict) -> str:
    import pandas as pd

    return pd.DataFrame(frame).to_string(index=False)


def head(frame: dict, rows: int) -> dict:
    return {k: v[:rows] for k, v in frame.items()}


def result(frames: dict | None = None, facts: dict | None = None,
           observed: dict | None = None) -> dict:
    """An example's ``run()`` result (see the module's docstring)."""
    return {"frames": frames or {}, "facts": facts or {},
            "observed": observed or {}}


def parser(doc: str, ranks: bool = False) -> argparse.ArgumentParser:
    """The command line every example takes: ``--device`` (default: the
    card; ``cpu`` runs the plain versions of the kernels on the host);
    with ``ranks`` also ``--ranks R``."""
    ap = argparse.ArgumentParser(
        description=doc.strip().splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    if ranks:
        ap.add_argument("--ranks", type=int, default=None, metavar="R",
                        help="also run over R spawned processes of a "
                             "torch.distributed group, one rank a task")
        ap.add_argument("--rank-job", default=None, help=argparse.SUPPRESS)
        ap.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    return ap


#: seconds a spawned group may take, startup included
RANKS_TIMEOUT_S = 600


def spawn_ranks(module: str, world: int, device) -> dict:
    """Run ``python -m <module> --rank-job JOB --rank r`` for r < ``world``
    and return rank 0's result: each rank joins one gloo group through a
    file under a temporary directory, runs the example over `make_mesh()`
    on ``device`` (every rank on it: NCCL refuses two ranks on one card)
    and pickles what it saw."""
    device = str(resolve_device(device))
    with tempfile.TemporaryDirectory(prefix="dftpu-ranks-") as tmp:
        job = Path(tmp) / "job.json"
        job.write_text(json.dumps({
            "init": str(Path(tmp) / "pg"), "world": world,
            "device": device,
            "out": str(Path(tmp) / "rank{rank}.pkl")}))
        # the ranks import this package from where this process found it
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, "--rank-job", str(job),
             "--rank", str(r)], stdout=subprocess.PIPE, env=env,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode, logs[r][-2000:])
                  for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"ranks failed: {failed}")
        return pickle.loads(Path(job.parent / "rank0.pkl").read_bytes())


def rank_main(job_path: str, rank: int, run) -> int:
    """One spawned rank: join the group, call ``run(device=...,
    mesh=make_mesh(...))`` and pickle its result."""
    import torch.distributed as dist

    from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
        make_mesh,
    )

    job = json.loads(Path(job_path).read_text())
    dist.init_process_group(
        "gloo", init_method=f"file://{job['init']}", rank=rank,
        world_size=job["world"], timeout=timedelta(seconds=RANKS_TIMEOUT_S))
    try:
        mesh = make_mesh(device=job["device"])
        out = run(device=mesh.device, mesh=mesh)
        Path(job["out"].format(rank=rank)).write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def module_name(file: str) -> str:
    return f"{__package__}.{Path(file).stem}"

