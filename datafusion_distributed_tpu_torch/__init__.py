"""datafusion_distributed_tpu_torch — the query engine on PyTorch and CUDA.

A port of the `datafusion_distributed_tpu` package (JAX on a TPU) to PyTorch
on an NVIDIA H100. It keeps the reference package's module layout and names:

- ops/       padded columnar Table + operators; the hash-table kernels are
             hand-written CUDA (csrc/hash_table.cu, ops/hash_kernels.py)
- plan/      physical plan IR + expression IR, executed eagerly; the
             exchange nodes and the fused multiway join of staged plans
- planner/   statistics and cost model; the distributed (staged) planner
- parallel/  the plan-time split of a table into per-task slices
- runtime/   the planner's adaptivity counters
- sql/       SQL front end (parser -> logical plan -> physical plan)
- io/        host-side Arrow/Parquet <-> device Table
- data/      TPC-H generator (numpy only)

Entry point: ``sql.context.SessionContext(device=None)`` runs on ``cuda``;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
Nothing here imports jax or the reference package.
"""

from datafusion_distributed_tpu_torch import precision  # noqa: F401
from datafusion_distributed_tpu_torch.schema import DataType, Field, Schema
from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Dictionary,
    Table,
)

__version__ = "0.1.0"

__all__ = [
    "DataType",
    "Field",
    "Schema",
    "Column",
    "Dictionary",
    "Table",
]
