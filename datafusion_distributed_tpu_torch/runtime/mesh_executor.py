"""Task executor: run a staged plan's T tasks on one device (port of the
reference `runtime/mesh_executor.py`).

The reference runs a staged plan as one SPMD program over a jax `Mesh`:
every device is a task, every stage runs on every device, and exchanges are
collectives. Here the T tasks run in one process, each with a context of
its own (its leaves' slices, its overflow flags) and one exchange cache
shared by all: the first task to reach an exchange runs the exchange's
producer subtree for every task and routes the rows
(plan/exchanges.py, parallel/exchange.py), and each task then reads its
own consumer table. Tasks that no consumer reaches never run.

The root stage's output is replicated in the reference, which returns
device 0's copy. Where the root stage reads only exchanges whose output
every task holds whole (a one-consumer coalesce, a broadcast) and has no
task-dependent node (a scan slice, an isolated arm), task 0 alone runs it;
otherwise every task does, and task 0's output is returned.
"""

from __future__ import annotations

import torch

from datafusion_distributed_tpu_torch.ops.table import Table
from datafusion_distributed_tpu_torch.plan.exchanges import (
    BroadcastExchangeExec,
    CoalesceExchangeExec,
    IsolatedArmExec,
)
from datafusion_distributed_tpu_torch.plan.physical import (
    _PRECISION_TAG,
    DistributedTaskContext,
    ExecContext,
    ExecutionPlan,
    collect_leaves,
)
from datafusion_distributed_tpu_torch.planner.distributed import _stage_nodes


def root_stage_is_replicated(plan: ExecutionPlan) -> bool:
    """Whether every task's root stage computes the same table: it reads
    only one-consumer coalesces and broadcasts, and holds no scan and no
    isolated arm."""
    for n in _stage_nodes(plan):
        if n.is_exchange:
            if isinstance(n, CoalesceExchangeExec):
                if n.num_consumers != 1:
                    return False
            elif not isinstance(n, BroadcastExchangeExec):
                return False
        elif not n.children() or isinstance(n, IsolatedArmExec):
            return False
    return True


def execute_tasks(plan: ExecutionPlan, num_tasks: int) -> Table:
    """Run the staged plan over ``num_tasks`` tasks on its leaves' device
    and return the root's output as task 0 holds it. Every task's capacity
    and precision flags are fetched in ONE transfer at the end and raise
    with the reference's two messages, word for word: the session's retry
    loop keys on "overflow" in the first and reads the node names in it.

    The plan runs in its prepared form (literals hoisted, bound for the
    run), as `execute_plan` runs a single-node plan."""
    from datafusion_distributed_tpu_torch.plan.fingerprint import (
        bound_params,
        prepare_plan,
    )

    if num_tasks < 1:
        raise ValueError(f"num_tasks must be at least 1, got {num_tasks}")
    prep = prepare_plan(plan)
    target = prep.plan
    leaves = [leaf for leaf in collect_leaves(target) if hasattr(leaf, "load")]
    peers: list = []
    shared: dict = {}
    try:
        for i in range(num_tasks):
            task = DistributedTaskContext(i, num_tasks)
            peers.append(ExecContext(
                task=task, inputs={leaf.node_id: leaf.load(task)
                                   for leaf in leaves},
                exchange_cache=shared, peers=peers,
            ))
        with bound_params(prep.param_arrays()):
            if root_stage_is_replicated(target):
                out = target.execute(peers[0])
            else:
                out = [target.execute(c) for c in peers][0]
        cap_flags = [f for c in peers for name, f in c.overflow_flags
                     if not name.startswith(_PRECISION_TAG)]
        prec_flags = [f for c in peers for name, f in c.overflow_flags
                      if name.startswith(_PRECISION_TAG)]
        none = torch.zeros((), dtype=torch.bool, device=out.device)
        any_overflow = torch.stack(cap_flags).any() if cap_flags else none
        any_precision = torch.stack(prec_flags).any() if prec_flags else none
        flags = torch.stack([any_overflow, any_precision]).cpu()  # one fetch
        names = [name for name, _ in peers[0].overflow_flags]
    finally:
        # the contexts hold each other (peers): free the run's tables now
        shared.clear()
        peers.clear()
    if bool(flags[0]):
        raise RuntimeError(
            f"exchange/hash capacity overflow on mesh (nodes: "
            f"{[n for n in names if not n.startswith(_PRECISION_TAG)]}); "
            "re-plan with larger capacities"
        )
    if bool(flags[1]):
        raise RuntimeError(
            "int32 accumulator range exceeded on mesh (nodes: "
            f"{[n for n in names if n.startswith(_PRECISION_TAG)]}); "
            "run with DFTPU_PRECISION=x64 for 64-bit accumulation"
        )
    return out
