"""datafusion_distributed_tpu_torch — the query engine on PyTorch and CUDA.

A port of the `datafusion_distributed_tpu` package (JAX on a TPU) to PyTorch
on an NVIDIA H100. It keeps the reference package's module layout and names:

- ops/       padded columnar Table + operators; the hash-table kernels are
             hand-written CUDA (csrc/hash_table.cu, ops/hash_kernels.py)
- plan/      physical plan IR + expression IR, executed eagerly; the
             exchange nodes and the fused multiway join of staged plans
- planner/   statistics and cost model; the distributed (staged) planner
- parallel/  the plan-time split of a table into per-task slices
- runtime/   the coordinator/worker runtime, the task executor, adaptivity
- sql/       SQL front end (parser -> logical plan -> physical plan)
- io/        host-side Arrow/Parquet <-> device Table
- data/      TPC-H generator (numpy only)

Entry point: ``sql.context.SessionContext(device=None)`` runs on ``cuda``;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
Nothing here imports jax or the reference package.
"""

import os as _os

# Runtime lock-order / race harness (runtime/lockcheck.py): installed
# FIRST under DFTPU_LOCK_CHECK=1, before any submodule import, so every
# lock the package creates (module-level, class-level, per-instance) is
# wrapped; observed acquisition order is asserted against the static graph
# of tools/check_concurrency.py over this package.
if _os.environ.get("DFTPU_LOCK_CHECK", "0") not in ("", "0"):
    from datafusion_distributed_tpu_torch.runtime import (
        lockcheck as _lockcheck,
    )

    _lockcheck.install()

# Runtime resource-leak harness (runtime/leakcheck.py), the dynamic half of
# the resource model that tools/check_resource_lifecycle.py checks
# statically: installed under DFTPU_LEAK_CHECK=1 (or =strict, where a
# survivor at query end raises), before any submodule import, so every
# tracked acquisition (store entries, spill slots, shm segments, stream
# pullers, checkpoint slices, result-cache entries) is witnessed.
if _os.environ.get("DFTPU_LEAK_CHECK", "0") not in ("", "0"):
    from datafusion_distributed_tpu_torch.runtime import (
        leakcheck as _leakcheck,
    )

    _leakcheck.install()

# Load libarrow on the importing thread. Arrow's default memory pool is the
# mimalloc bundled in pyarrow, and mimalloc takes the thread that loads the
# library for the process's main thread. The port imports pyarrow lazily,
# so without this the first load came on a short-lived thread (a stream or
# gRPC handler thread encoding the first wire payload). Once that thread
# exited, glibc gave its thread block (the same thread id) to a later
# thread, which mimalloc then took for the main thread: its first Arrow
# allocation read the exited thread's torn-down heap and crashed
# (SIGSEGV in mi_thread_init, seen as `pa.array` in a stream thread).
# tests/test_torch_isolation.py holds both the thread churn and the gRPC
# tier to it. This holds only where the package (or pyarrow) is first
# imported on a thread that lives as long as the process, as the main
# thread does: an application that first imports it lazily from a pool or
# request thread meets the same crash, and should import it on its main
# thread first.
import pyarrow as _pyarrow  # noqa: E402,F401

from datafusion_distributed_tpu_torch import precision  # noqa: E402,F401
from datafusion_distributed_tpu_torch.schema import (  # noqa: E402
    DataType,
    Field,
    Schema,
)
from datafusion_distributed_tpu_torch.ops.table import (  # noqa: E402
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
