"""Task executors: run a staged plan's T tasks (port of the reference
`runtime/mesh_executor.py`).

The reference runs a staged plan as one SPMD program over a jax `Mesh`:
every device is a task, every stage runs on every device, and exchanges are
collectives. The port has both forms:

- `execute_on_mesh` is that program over a torch.distributed process
  group (`make_mesh`): each rank is one task, loads only its own slice of
  each leaf, runs every node of the plan (the root included), and meets
  its peers in the exchanges' collectives (`parallel/exchange.py`, the
  `*_spmd` functions). Every rank must run the same plan: each builds the
  same session over the same tables and calls the same SQL, and the run
  checks the plans' fingerprints before its first exchange.
- `execute_tasks` runs the T tasks in one process, each with a context of
  its own (its leaves' slices, its overflow flags) and one exchange cache
  shared by all: the first task to reach an exchange runs the exchange's
  producer subtree for every task and routes the rows
  (plan/exchanges.py, parallel/exchange.py), and each task then reads its
  own consumer table. Tasks that no consumer reaches never run.

The root stage's output is replicated in the reference, which returns
device 0's copy. In `execute_tasks`, where the root stage reads only
exchanges whose output every task holds whole (a one-consumer coalesce, a
broadcast) and has no task-dependent node (a scan slice, an isolated
arm), task 0 alone runs it; otherwise every task does, and task 0's
output is returned. In `execute_on_mesh` every rank runs it and returns
its own copy.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from datafusion_distributed_tpu_torch.ops.table import Table, move
from datafusion_distributed_tpu_torch.parallel.exchange import (
    LockstepError,
    _fingerprint,
    _gather_ints,
    _gather_rows,
    _wire,
)
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


# ---------------------------------------------------------------------------
# SPMD: one rank a task over a process group
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TaskMesh:
    """The tasks of one SPMD run: the process group, this rank's task
    index (its rank in the group), the task count (the group's size) and
    the device this rank's tables live on."""

    group: Any
    rank: int
    size: int
    device: torch.device

    @property
    def host_staged(self) -> bool:
        """Whether the collectives take host buffers: a gloo group over
        tensors on the card (several ranks sharing one card, where NCCL
        refuses two ranks on one device)."""
        return (self.device.type == "cuda"
                and dist.get_backend(self.group) == "gloo")


def make_mesh(group=None, device=None) -> TaskMesh:
    """The `TaskMesh` of this process in ``group`` (default: the default
    group, which the caller has initialised, e.g. under torchrun). The
    device defaults to ``cuda:{LOCAL_RANK}``; without CUDA it raises unless
    the caller passes ``device="cpu"``. The backend is the group's, as the
    caller chose it."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group first (torchrun sets its "
            "environment)")
    group = group if group is not None else dist.group.WORLD
    if device is None:
        device = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"make_mesh: no CUDA device for {device}; pass device='cpu' "
                "to run the ranks on the host")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return TaskMesh(group, dist.get_rank(group), dist.get_world_size(group),
                    device)


def _check_same_plan(mesh: TaskMesh, prep, target: ExecutionPlan) -> None:
    """One all_gather of the plan's fingerprint (and its hoisted literals):
    every rank raises if any rank holds another plan."""
    from datafusion_distributed_tpu_torch.planner.distributed import (
        display_staged_plan,
    )

    text = prep.fingerprint or display_staged_plan(target)
    ints, floats = prep.param_arrays()
    mine = _fingerprint(text.encode() + ints.tobytes() + floats.tobytes())
    every = _gather_ints(mesh, [mine])[:, 0]
    if (every != mine).any():
        raise LockstepError(
            "SPMD ranks hold different plans (fingerprints by rank: "
            f"{[hex(int(x)) for x in every]}): every rank must build the "
            "same session over the same tables and run the same SQL")


def execute_on_mesh(plan: ExecutionPlan, mesh: TaskMesh,
                    check_overflow: bool = True,
                    metrics_store=None) -> Table:
    """Run the staged plan as one SPMD program over ``mesh``: this rank is
    task ``mesh.rank`` of ``mesh.size``. Call it on every rank with the same
    plan; each returns the replicated root table.

    The rank loads its own slice of each leaf onto ``mesh.device`` and runs
    the prepared plan; each exchange runs this rank's producer subtree and
    its collective. The capacity and precision flags are reduced across the
    ranks with one all_reduce(MAX) and raise on every rank with the
    reference's two messages, word for word (the session's retry loop keys
    on them). With ``metrics_store`` every rank's per-node metrics are
    gathered in one collective and inserted under task0..taskN-1."""
    from datafusion_distributed_tpu_torch.plan.fingerprint import (
        bound_params,
        prepare_plan,
    )

    prep = prepare_plan(plan)
    target = prep.plan
    _check_same_plan(mesh, prep, target)
    task = DistributedTaskContext(mesh.rank, mesh.size)
    nodes = target.collect(lambda _n: True)
    exchanges = [n for n in nodes if n.is_exchange]
    # how often the tree reaches each exchange: once a parent, and once
    # more for an isolated arm's pre-pass over its exchanges
    reaches = Counter(n.node_id for n in exchanges)
    for arm in nodes:
        if isinstance(arm, IsolatedArmExec):
            reaches.update(n.node_id
                           for n in arm.child.collect(lambda n: n.is_exchange))
    ctx = ExecContext(
        task=task,
        inputs={leaf.node_id: move(leaf.load(task), mesh.device)
                for leaf in collect_leaves(target) if hasattr(leaf, "load")},
        config={
            "mesh": mesh,
            "exchange_positions": {n.node_id: i
                                   for i, n in enumerate(exchanges)},
            "exchange_labels": [n.display() for n in exchanges],
            "exchange_reaches": reaches,
            "node_positions": {n.node_id: i for i, n in enumerate(nodes)},
            "nodes": nodes,
        },
    )
    if metrics_store is not None:
        ctx.metrics = []
    with bound_params(prep.param_arrays()):
        out = target.execute(ctx)
    names = [name for name, _ in ctx.overflow_flags]
    none = torch.zeros((), dtype=torch.bool, device=mesh.device)
    cap = [f for n, f in ctx.overflow_flags if not n.startswith(_PRECISION_TAG)]
    prec = [f for n, f in ctx.overflow_flags if n.startswith(_PRECISION_TAG)]
    flags = _wire(mesh, torch.stack([
        torch.stack(cap).any() if cap else none,
        torch.stack(prec).any() if prec else none]).to(torch.int32))
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=mesh.group)
    flags = flags.tolist()
    if metrics_store is not None:
        keys = [(ctx.config["node_positions"].get(nid, -1), name)
                for nid, name, _ in ctx.metrics]
        mine = torch.stack([v.to(torch.int64).reshape(())
                            for _, _, v in ctx.metrics]) if keys else \
            torch.zeros(0, dtype=torch.int64, device=mesh.device)
        every = _gather_rows(mesh, mine[None]).cpu().tolist()  # [T, M]
        # positions -> THIS submission's node ids (the prepared plan's
        # pre-order traversal equals the submitted plan's)
        submitted = plan.collect(lambda _n: True)
        for t, row in enumerate(every):
            node_metrics: dict = {}
            for (pos, name), v in zip(keys, row):
                if 0 <= pos < len(submitted):
                    node_metrics.setdefault(
                        submitted[pos].node_id, {})[name] = int(v)
            metrics_store.insert(f"task{t}", node_metrics)
    if check_overflow and flags[0]:
        raise RuntimeError(
            f"exchange/hash capacity overflow on mesh (nodes: "
            f"{[n for n in names if not n.startswith(_PRECISION_TAG)]}); "
            "re-plan with larger capacities"
        )
    if flags[1]:
        raise RuntimeError(
            "int32 accumulator range exceeded on mesh (nodes: "
            f"{[n for n in names if n.startswith(_PRECISION_TAG)]}); "
            "run with DFTPU_PRECISION=x64 for 64-bit accumulation"
        )
    return out
