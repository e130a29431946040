"""SessionContext: the user-facing API, single-node part (port of the
reference `sql/context.py`).

    ctx = SessionContext()                  # on the card ("cuda")
    ctx.register_parquet("lineitem", "lineitem.parquet")
    df = ctx.sql("select l_returnflag, sum(l_quantity) from lineitem group by 1")
    df.collect_table().to_numpy()
    df.collect()        # -> pyarrow Table
    df.to_pandas()

Tables are uploaded to the session's device at registration; every query
then runs there. ``SessionContext(device="cpu")`` runs on the host with the
plain PyTorch versions of the kernels. Every plan is verified before it
runs (plan/verify.py, `SET distributed.verify_plans`), and physical plans
are cached per session, keyed on the logical plan's structural fingerprint
(plan/fingerprint.py), so a fresh ``ctx.sql(same_text)`` reuses the planned
tree. ``ctx.prepare("... where x < $1")`` binds parameters into a template.

The distributed planner is ported: ``df.distributed_plan(T)`` and
``df.explain_distributed(T)`` give the staged plan for T tasks,
``df.explain_verify()`` and ``EXPLAIN VERIFY <query>`` render it with the
verifier's diagnostics, and ``df.collect_distributed_table(1)`` runs the
one-task staged plan (fused multiway joins included) on the session's
device; ``df.collect_distributed_table(T)`` runs it over T tasks.
``df.collect_coordinated_table(num_tasks=T)`` runs it through the
coordinator/worker runtime, consulting the whole-result cache first when
``SET distributed.result_cache`` is on (``ctx.result_cache()``); the
serving tier (runtime/serving.py `ServingSession`) submits queries from
many clients at once. With ``SET distributed.tracing = 'on'``,
``ctx.last_trace()`` is the last coordinated query's Chrome trace and
``ctx.last_trace_profile()`` its text profile (runtime/tracing.py).
"""

from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass, replace
from typing import Optional, Sequence

from datafusion_distributed_tpu_torch.ops.table import Table, resolve_device
from datafusion_distributed_tpu_torch.plan.physical import (
    ExecutionPlan,
    MemoryScanExec,
    execute_plan,
)
from datafusion_distributed_tpu_torch.runtime.mesh_executor import (
    execute_tasks,
)
from datafusion_distributed_tpu_torch.schema import Field, Schema
from datafusion_distributed_tpu_torch.sql.logical import Binder, LogicalPlan
from datafusion_distributed_tpu_torch.sql.parser import (
    CreateView,
    DropView,
    ExplainVerify,
    SetOption,
    parse_statements,
)
from datafusion_distributed_tpu_torch.sql.planner import (
    PhysicalPlanner,
    PlannerConfig,
)

#: distinct sentinel for Catalog._ndv_cache misses (None is a valid
#: cached verdict: "no such column")
_NDV_MISS = object()


class Catalog:
    """Named device-resident tables + views."""

    def __init__(self) -> None:
        self.tables: dict[str, Table] = {}
        self.views: dict[str, LogicalPlan] = {}
        self._ndv_cache: dict = {}
        self._ndv_lock = threading.Lock()
        # bumped on every (re-)registration: physical plans embed scan
        # Tables and plan-time scalar-subquery results
        self.generation = 0

    def register_table(self, name: str, table: Table) -> None:
        with self._ndv_lock:
            self.tables[name.lower()] = table
            self.generation += 1
            self._ndv_cache = {
                k: v for k, v in self._ndv_cache.items()
                if k[0] != name.lower()
            }

    def has_table(self, name: str) -> bool:
        return name.lower() in self.tables

    def table_schema(self, name: str) -> Schema:
        return self.tables[name.lower()].schema()

    def table_rows(self, name: str) -> int:
        return int(self.tables[name.lower()].num_rows)

    def column_ndv(self, table: str, column: str):
        """Distinct count from a strided sample of at most 2^20 rows,
        computed once per column (the statistics hash tables are sized
        with) — the same estimate as the reference's."""
        key = (table.lower(), column)
        with self._ndv_lock:
            cached = self._ndv_cache.get(key, _NDV_MISS)
            gen0 = self.generation
        if cached is not _NDV_MISS:
            return cached
        import numpy as np

        t = self.tables.get(table.lower())
        if t is None or column not in t:
            ndv = None
        else:
            total = int(t.num_rows)
            n = min(total, 1 << 20)
            stride = max(1, total // max(n, 1))
            col = t.column(column)
            vals = col.data[:total:stride][:n].cpu().numpy()
            if col.validity is not None:
                vals = vals[col.validity[:total:stride][:n].cpu().numpy()]
            sampled = max(len(vals), 1)
            ndv = int(len(np.unique(vals)))
            # distinct-on-sample extrapolates only when near-unique
            if ndv > 0.9 * sampled:
                ndv = min(int(ndv * (total / sampled)), total)
            elif sampled < total:
                # a non-extrapolated sampled count can undercount: pad it
                ndv = min(int(ndv * 1.5) + 16, total)
        with self._ndv_lock:
            if self.generation != gen0:
                return ndv
            return self._ndv_cache.setdefault(key, ndv)

    def scan_exec(self, name: str, columns: Sequence[str]) -> ExecutionPlan:
        t = self.tables[name.lower()]
        return MemoryScanExec([t.select(columns)], t.schema().select(columns))


@dataclass
class SessionConfig:
    planner: PlannerConfig = None  # type: ignore[assignment]
    overflow_retries: int = 3
    # `SET distributed.<key> = <value>`: the staged planner reads the
    # planning knobs, the coordinator the runtime ones
    # (runtime/coordinator.py FAULT_TOLERANCE_DEFAULTS)
    distributed_options: dict = None  # type: ignore[assignment]
    # user headers forwarded verbatim to workers (auth etc.; the
    # passthrough_headers analogue)
    passthrough_headers: dict = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.planner is None:
            self.planner = PlannerConfig()
        if self.distributed_options is None:
            self.distributed_options = {}
        if self.passthrough_headers is None:
            self.passthrough_headers = {}

    def set_option(self, name: str, value) -> None:
        scope, _, key = name.partition(".")
        if scope == "distributed":
            if key == "plan_cache_size":
                # sizes the reference's compiled-program cache, which the
                # eager port does not have; validated as the reference does
                int(value)
            elif key == "literal_hoisting":
                from datafusion_distributed_tpu_torch.plan.fingerprint import (
                    set_literal_hoisting,
                )

                set_literal_hoisting(value)
            elif key == "verify_plans":
                from datafusion_distributed_tpu_torch.plan.verify import MODES

                value = str(value).strip().lower()
                if value not in MODES:
                    raise ValueError(
                        f"invalid verify_plans mode {value!r} (expected "
                        f"one of {MODES})"
                    )
            elif key == "data_plane":
                # data-plane selection (runtime/coordinator.py): auto keeps
                # the routing ladder; unary/stream/shm force one plane
                value = str(value).strip().lower()
                if value not in ("auto", "unary", "stream", "shm"):
                    raise ValueError(
                        f"invalid data_plane {value!r} (expected one of "
                        f"('auto', 'unary', 'stream', 'shm'))"
                    )
            elif key == "wire_compression":
                # the wire transports' codec policy (runtime/grpc_worker.py
                # TransferPartitions), validated as the reference does
                value = str(value).strip().lower()
                if value not in ("auto", "off", "zstd", "lz4"):
                    raise ValueError(
                        f"invalid wire_compression {value!r} (expected "
                        f"one of ('auto', 'off', 'zstd', 'lz4'))"
                    )
            elif key == "max_concurrent_queries":
                # serving-tier admission knobs (runtime/serving.py) are
                # validated at SET time: a bad value must fail the SET,
                # not wedge admission decisions mid-serve
                value = int(value)
                if value < 1:
                    raise ValueError(
                        "max_concurrent_queries must be >= 1"
                    )
            elif key == "admission_budget_bytes":
                value = float(value)
                if value < 0:
                    raise ValueError(
                        "admission_budget_bytes must be >= 0 (0 = "
                        "unlimited)"
                    )
            elif key == "worker_memory_budget_bytes":
                # enforced per-worker staging budget (runtime/codec.py
                # TableStore + runtime/spill.py): validated at SET time
                # like the admission knobs; 0 = unlimited
                value = float(value)
                if value < 0:
                    raise ValueError(
                        "worker_memory_budget_bytes must be >= 0 (0 = "
                        "unlimited)"
                    )
            elif key == "worker_memory_redline":
                # red-line shedding factor (runtime/serving.py): resident
                # bytes over budget x factor preempt the lowest-priority
                # running query; 0 disables shedding
                value = float(value)
                if value != 0 and value < 1.0:
                    raise ValueError(
                        "worker_memory_redline must be 0 (shedding off) "
                        "or >= 1.0 (a red-line below the budget would "
                        "shed before spill/backpressure even engage)"
                    )
            elif key == "checkpoint_budget_bytes":
                # CheckpointStore byte cap (runtime/checkpoint.py):
                # oldest recoverable checkpoints evict past it
                value = float(value)
                if value < 0:
                    raise ValueError(
                        "checkpoint_budget_bytes must be >= 0 (0 = "
                        "uncapped)"
                    )
            elif key == "result_cache_budget_bytes":
                # ResultCache byte budget (runtime/result_cache.py):
                # cold entries past it SPILL (SpillManager) instead of
                # evicting, and refault byte-exactly on the next hit
                value = float(value)
                if value < 0:
                    raise ValueError(
                        "result_cache_budget_bytes must be >= 0 (0 = "
                        "unlimited)"
                    )
            elif key == "serving_stage_slots":
                value = int(value)
                if value < 0:
                    raise ValueError(
                        "serving_stage_slots must be >= 0 (0 = auto: "
                        "the worker count)"
                    )
            elif key in ("fair_share", "zero_copy", "hedging",
                         "checkpointing", "pipelined_shuffle",
                         "partial_agg_pushdown", "multiway_join",
                         "global_hash_agg", "result_cache"):
                # the reference's boolean knobs, coerced at SET time
                from datafusion_distributed_tpu_torch.ops.table import (
                    parse_bool_knob,
                )

                value = parse_bool_knob(value)
            elif key == "hedge_quantile":
                # hedging knobs validated at SET time like the serving
                # admission knobs: a bad value must fail the SET, not
                # silently disable (or stampede) the hedger mid-serve
                value = float(value)
                if not 0.0 <= value <= 1.0:
                    raise ValueError("hedge_quantile must be in [0, 1]")
            elif key == "hedge_floor_s":
                value = float(value)
                if value < 0:
                    raise ValueError("hedge_floor_s must be >= 0")
            elif key == "hedge_budget":
                value = int(value)
                if value < 0:
                    raise ValueError(
                        "hedge_budget must be >= 0 (0 disables hedging "
                        "by denying every speculative attempt)"
                    )
            elif key == "slo_p99_ms":
                # SLO targets (runtime/telemetry.py SloTracker, read
                # live by the serving tier's stats surface): validated at
                # SET time like the other serving knobs
                value = float(value)
                if value <= 0:
                    raise ValueError("slo_p99_ms must be > 0")
            elif key == "slo_error_rate":
                value = float(value)
                if not 0.0 <= value <= 1.0:
                    raise ValueError(
                        "slo_error_rate must be in [0, 1]"
                    )
            elif key == "tracing":
                # distributed-tracing mode (runtime/tracing.py):
                # validated at SET time so a typo fails the SET, not the
                # queries silently running untraced
                from datafusion_distributed_tpu_torch.runtime.tracing import (
                    TRACING_MODES,
                )

                value = str(value).strip().lower()
                if value not in TRACING_MODES:
                    raise ValueError(
                        f"invalid tracing mode {value!r} (expected one "
                        f"of {TRACING_MODES})"
                    )
            elif key == "tracing_sample_rate":
                value = float(value)
                if not 0.0 <= value <= 1.0:
                    raise ValueError(
                        "tracing_sample_rate must be in [0, 1]"
                    )
            elif key == "skew_split_factor":
                # runtime-adaptivity knobs (runtime/adaptivity.py),
                # validated at SET time like the serving knobs
                value = float(value)
                if value != 0 and value < 1.0:
                    raise ValueError(
                        "skew_split_factor must be 0 (splitting off) or "
                        ">= 1.0 (a hot partition is one ABOVE the "
                        "median)"
                    )
            elif key == "skew_split_min_rows":
                value = int(value)
                if value < 0:
                    raise ValueError(
                        "skew_split_min_rows must be >= 0"
                    )
            elif key == "partial_agg_bailout_ratio":
                value = float(value)
                if not 0.0 <= value <= 1.0:
                    raise ValueError(
                        "partial_agg_bailout_ratio must be in [0, 1] "
                        "(0 disables the bail-out; 1 bails only when "
                        "the partial reduces nothing)"
                    )
            elif key == "replan_cardinality_factor":
                value = float(value)
                if value != 0 and value < 1.0:
                    raise ValueError(
                        "replan_cardinality_factor must be 0 (replan "
                        "off) or >= 1.0 (measured/estimated divergence "
                        "factor)"
                    )
            self.distributed_options[key] = value
        elif scope == "planner":
            if not hasattr(self.planner, key):
                raise ValueError(f"unknown planner option {key!r}")
            setattr(self.planner, key, value)
        else:
            raise ValueError(f"unknown option scope {scope!r}")

    def distributed_snapshot(self) -> dict:
        """A point-in-time copy of `distributed_options`: ``list(d.items())``
        copies in one C call, so a concurrent SET cannot fail the copy."""
        return dict(list(self.distributed_options.items()))


class OverflowRetryAbandoned(RuntimeError):
    """Raised (instead of another widening) when an overflow retry's plan
    would exceed the device-memory budget. A distinct type so the retry
    loop's `"overflow" in str(e)` filter does not catch it."""


def _overflow_node_names(err) -> str:
    """The overflow error names the capacity-capable nodes of the plan
    ("... (nodes: ['HashAggregate']); ..."); they bound which planner knobs
    a retry must widen."""
    m = re.search(r"nodes: \[([^\]]*)\]", str(err))
    return m.group(1) if m else ""


def _widen_for_overflow(pcfg: PlannerConfig, dcfg, err,
                        force_all: bool = False):
    """-> (pcfg, dcfg) with only the capacity knobs implicated by the
    overflow error widened 4x: join expansion, aggregate slots, and (for a
    staged plan, ``dcfg`` not None) the shuffles' skew factor. Everything
    applicable widens when nothing applicable is implicated, or on the last
    attempt (``force_all``)."""
    names = _overflow_node_names(err)
    join = "Join" in names
    agg = "Aggregate" in names
    shuf = "Shuffle" in names and dcfg is not None
    if force_all or not (join or agg or shuf):
        join = agg = True
        shuf = dcfg is not None
    pcfg = replace(
        pcfg,
        join_expansion_factor=pcfg.join_expansion_factor * (4 if join else 1),
        agg_slot_factor=pcfg.agg_slot_factor * (4 if agg else 1),
    )
    if shuf:
        dcfg = replace(dcfg, shuffle_skew_factor=dcfg.shuffle_skew_factor * 4)
    return pcfg, dcfg


def _overflow_retry_guard(plan, attempt: int, last_err) -> None:
    """Abandon an overflow retry whose widened plan would need more device
    memory than the budget (DFTPU_RETRY_BYTES_BUDGET, default 16 GB)."""
    if attempt == 0:
        return
    from datafusion_distributed_tpu_torch.planner.statistics import (
        plan_device_bytes,
    )

    raw = os.environ.get("DFTPU_RETRY_BYTES_BUDGET", "")
    try:
        budget = float(raw) if raw else 16e9
    except ValueError:
        raise RuntimeError(
            f"DFTPU_RETRY_BYTES_BUDGET={raw!r} is not a number"
        ) from None
    need = plan_device_bytes(plan)
    if need > budget:
        raise OverflowRetryAbandoned(
            f"overflow-retry abandoned: widened plan needs ~{need/1e9:.1f}GB "
            f"device buffers (budget {budget/1e9:.1f}GB, "
            "DFTPU_RETRY_BYTES_BUDGET); original overflow: "
            f"{last_err}"
        )


class DataFrame:
    """A planned (but unexecuted) query."""

    def __init__(self, ctx: "SessionContext", logical: LogicalPlan):
        self.ctx = ctx
        self.logical = logical
        # plan memoization goes through the SESSION-level cache keyed by the
        # logical plan's structural fingerprint, so a fresh
        # ctx.sql(same_text) reuses the planned physical tree (with its
        # plan-time scalar subqueries already executed); this dict is the
        # fallback for logical plans without a fingerprint
        self._plan_cache: dict = {}
        self._logical_fp = -1  # lazily computed; None = unfingerprintable
        self.last_retry_count = 0

    def _logical_fingerprint(self):
        if self._logical_fp == -1:
            from datafusion_distributed_tpu_torch.plan.fingerprint import (
                logical_fingerprint,
            )

            self._logical_fp = logical_fingerprint(self.logical)
        return self._logical_fp

    def _plan_cache_get(self, key):
        lfp = self._logical_fingerprint()
        if lfp is None:
            return self._plan_cache.get(key)
        return self.ctx._plan_cache_get(
            (lfp, self.ctx.catalog.generation, key)
        )

    def _plan_cache_put(self, key, plan) -> None:
        lfp = self._logical_fingerprint()
        if lfp is None:
            self._plan_cache[key] = plan
        else:
            self.ctx._plan_cache_put(
                (lfp, self.ctx.catalog.generation, key), plan
            )

    @staticmethod
    def _pcfg_key(cfg: PlannerConfig) -> tuple:
        """EVERY PlannerConfig field keys the plan cache: at session scope
        a fresh ctx.sql() no longer re-plans, so a SET of any planner knob
        must miss."""
        return tuple(getattr(cfg, k) for k in type(cfg).__dataclass_fields__)

    def physical_plan(self, config: Optional[PlannerConfig] = None) -> ExecutionPlan:
        from datafusion_distributed_tpu_torch.plan.verify import (
            enforce_verification,
        )

        cfg = config or self.ctx.config.planner
        key = self._pcfg_key(cfg)
        plan = self._plan_cache_get(key)
        if plan is None:
            plan = PhysicalPlanner(self.ctx.catalog, cfg).plan(self.logical)
            self._plan_cache_put(key, plan)
        # static verification before the plan runs (memoized on the plan
        # object, so cache hits and retry-loop re-submissions verify once)
        enforce_verification(
            plan, options=self.ctx.config.distributed_options,
            context="physical plan",
        )
        return plan

    def collect_table(self) -> Table:
        """Execute, with automatic re-plan on hash/join capacity overflow:
        capacities are planned optimistically and widened on overflow."""
        cfg = self.ctx.config.planner
        last_err: Optional[Exception] = None
        for attempt in range(self.ctx.config.overflow_retries + 1):
            try:
                # planning is inside the try: scalar subqueries execute at
                # plan time and their overflows must trigger the same retry
                plan = self.physical_plan(cfg)
                _overflow_retry_guard(plan, attempt, last_err)
                out = execute_plan(plan)
                self.last_retry_count = attempt
                return out
            except RuntimeError as e:
                if isinstance(e, OverflowRetryAbandoned):
                    raise
                if "overflow" not in str(e):
                    raise
                last_err = e
                cfg, _ = _widen_for_overflow(
                    cfg, None, e,
                    force_all=attempt >= self.ctx.config.overflow_retries - 1,
                )
        raise last_err  # type: ignore[misc]

    def collect(self):
        """-> pyarrow Table with user-facing column names."""
        from datafusion_distributed_tpu_torch.io.parquet import table_to_arrow

        return table_to_arrow(self._strip_quals(self.collect_table()))

    def to_pandas(self):
        return self._strip_quals(self.collect_table()).to_pandas()

    @staticmethod
    def _strip_quals(t: Table) -> Table:
        names = []
        seen = set()
        for n in t.names:
            short = n.split(".")[-1] if "." in n else n
            # duplicate short names (SELECT c.x, o.x) keep their qualifier
            names.append(n if short in seen else short)
            seen.add(short)
        return Table(tuple(names), t.columns, t.num_rows)

    # -- the staged (distributed) plan ---------------------------------------
    def distributed_plan(self, num_tasks: int = 8, config=None,
                         planner_config: Optional[PlannerConfig] = None,
                         executing: bool = False, coordinator=None):
        """The staged plan for ``num_tasks`` tasks, verified and cached per
        session. ``config`` (a DistributedConfig) defaults to the session's
        `SET distributed.*` options. ``executing`` marks the plan that
        `collect_distributed_table` runs: its scalar subqueries run through
        the same staged path, it is verified for a program over
        ``num_tasks`` tasks, and it is cached apart from the plan that
        EXPLAIN renders (the reference's mesh and mesh-less entries).
        With ``coordinator`` (`collect_coordinated_table`) the scalar
        subqueries run through that coordinator instead: f32 sums are only
        bitwise-reproducible under an identical task split (TPC-H q15
        compares them for equality)."""
        from datafusion_distributed_tpu_torch.plan.verify import (
            enforce_verification,
        )
        from datafusion_distributed_tpu_torch.planner.distributed import (
            DistributedConfig,
            distribute_plan,
        )

        if config is None:
            opts = {
                k: v
                for k, v in self.ctx.config.distributed_snapshot().items()
                if k in DistributedConfig.__dataclass_fields__
            }
            opts.setdefault("num_tasks", num_tasks)
            config = DistributedConfig(**opts)
        cfg = config
        pcfg = planner_config or self.ctx.config.planner
        # EVERY plan-shaping config field keys the cache; the unhashable
        # estimator keys by identity
        cfg_key = tuple(
            id(v) if k == "task_estimator" else v
            for k, v in (
                (k, getattr(cfg, k))
                for k in type(cfg).__dataclass_fields__
            )
        )
        verify_kw = dict(
            options=self.ctx.config.distributed_options,
            mesh_axis_size=cfg.num_tasks if executing else None,
            context="distributed plan",
        )
        key = ("dist", cfg_key, self._pcfg_key(pcfg), executing,
               coordinator is not None)
        plan = self._plan_cache_get(key)
        if plan is not None:
            enforce_verification(plan, **verify_kw)
            return plan
        subquery_executor = None
        if executing:
            def subquery_executor(p):
                return execute_tasks(distribute_plan(p, cfg), cfg.num_tasks)
        elif coordinator is not None:
            # plans shipped to workers must be self-contained, and the
            # subquery runs through the same distributed path as the
            # outer query
            def subquery_executor(p):
                return coordinator.execute(distribute_plan(p, cfg))

        planner = PhysicalPlanner(self.ctx.catalog, pcfg, subquery_executor)
        plan = distribute_plan(planner.plan(self.logical), cfg)
        self._plan_cache_put(key, plan)
        enforce_verification(plan, **verify_kw)
        return plan

    def collect_distributed_table(self, num_tasks: Optional[int] = None
                                  ) -> Table:
        """Run the staged plan for ``num_tasks`` tasks (None: 1, the
        session's one device) on the session's device, every stage at that
        many tasks, with the overflow retry of `collect_table` (shuffle
        capacities widen too). The tasks and the exchanges between them run
        in `runtime/mesh_executor.execute_tasks`; the result is task 0's
        copy of the replicated root, as on the reference's mesh."""
        t = 1 if num_tasks is None else int(num_tasks)
        if t < 1:
            raise ValueError(f"num_tasks must be at least 1, got {t}")
        pcfg = self.ctx.config.planner
        # one program over t tasks: every stage runs at t
        dcfg = replace(self._seeded_distributed_config(t),
                       uniform_stage_tasks=True)
        last_err: Optional[Exception] = None
        for attempt in range(self.ctx.config.overflow_retries + 1):
            try:
                plan = self.distributed_plan(t, dcfg, pcfg, executing=True)
                _overflow_retry_guard(plan, attempt, last_err)
                out = execute_tasks(plan, t)
                self.last_retry_count = attempt
                return out
            except RuntimeError as e:
                if isinstance(e, OverflowRetryAbandoned):
                    raise
                if "overflow" not in str(e):
                    raise
                last_err = e
                # widen in place so every other customized field survives
                pcfg, dcfg = _widen_for_overflow(
                    pcfg, dcfg, e,
                    force_all=attempt >= self.ctx.config.overflow_retries - 1,
                )
        raise last_err  # type: ignore[misc]

    def collect_distributed(self, num_tasks: Optional[int] = None):
        """`collect_distributed_table` -> pyarrow Table."""
        from datafusion_distributed_tpu_torch.io.parquet import table_to_arrow

        return table_to_arrow(
            self._strip_quals(self.collect_distributed_table(num_tasks))
        )

    def _result_cache_key(self, num_tasks: int):
        """Whole-result cache key for this query at the session's live
        configuration (plan/fingerprint.py result_cache_key): the
        post-hoist staged-plan fingerprint + literal parameter vectors,
        extended with the full PlannerConfig snapshot, the catalog
        generation, and the task profile (f32 sums are only bitwise-
        reproducible under an identical task split, so a profile change
        must miss). None when caching cannot apply (unfingerprintable
        plan)."""
        from datafusion_distributed_tpu_torch.plan.fingerprint import (
            result_cache_key,
        )

        try:
            plan = self.distributed_plan(
                num_tasks, self._seeded_host_config(num_tasks),
                self.ctx.config.planner,
            )
            return result_cache_key(plan, extra=(
                self._pcfg_key(self.ctx.config.planner),
                self.ctx.catalog.generation,
                int(num_tasks),
            ))
        except Exception:
            return None

    def collect_coordinated_table(
        self,
        coordinator=None,
        num_workers: int = 2,
        num_tasks: int = 4,
        adaptive: bool = False,
    ) -> Table:
        """Execute through the in-process Coordinator/Worker runtime
        (runtime/coordinator.py) instead of the one-process task executor.
        With no ``coordinator`` an in-memory cluster of ``num_workers`` is
        spun up — the reference's InMemoryChannelResolver rung its whole
        TPC suite runs on. ``adaptive=True`` uses the AdaptiveCoordinator.
        Every stage task runs on the session's device. Overflow -> re-plan
        with widened capacities, like `collect_table`.

        With `SET distributed.result_cache` on, the whole-result cache is
        consulted FIRST (runtime/result_cache.py): a hit returns the staged
        result by reference — no cluster, no coordinator, no execution.
        Concurrent submissions of one key single-flight: one executes, the
        rest block for its fill."""
        rc = self.ctx.result_cache()
        key = self._result_cache_key(num_tasks) if rc is not None else None
        if key is None:
            return self._collect_coordinated_uncached(
                coordinator, num_workers, num_tasks, adaptive
            )
        state, cached = rc.begin(key)
        if state == "hit":
            return cached
        try:
            out = self._collect_coordinated_uncached(
                coordinator, num_workers, num_tasks, adaptive
            )
        except BaseException:
            rc.fail(key)
            raise
        rc.fill(key, out)
        return out

    def _collect_coordinated_uncached(
        self,
        coordinator=None,
        num_workers: int = 2,
        num_tasks: int = 4,
        adaptive: bool = False,
    ) -> Table:
        from datafusion_distributed_tpu_torch.runtime.coordinator import (
            AdaptiveCoordinator,
            Coordinator,
            InMemoryCluster,
        )

        if coordinator is None:
            cluster = InMemoryCluster(num_workers)
            cls = AdaptiveCoordinator if adaptive else Coordinator
            coordinator = cls(
                resolver=cluster, channels=cluster,
                config_options=self.ctx.config.distributed_snapshot(),
                passthrough_headers=dict(self.ctx.config.passthrough_headers),
            )
        if getattr(coordinator, "result_cache", None) is None:
            # cross-query sub-plan frontier sharing rides the same
            # coordinator hook as checkpoint restore (None when the
            # result_cache knob is off)
            coordinator.result_cache = self.ctx.result_cache()
        pcfg = self.ctx.config.planner
        dcfg = self._seeded_host_config(num_tasks)
        last_err: Optional[Exception] = None
        adaptive_coord = hasattr(coordinator, "pin_overflow_headroom")
        try:
            for attempt in range(self.ctx.config.overflow_retries + 1):
                if adaptive_coord and attempt:
                    # widen-and-pin for the retry: subquery successes
                    # through the same coordinator must not reset the
                    # widened headroom mid-attempt
                    coordinator.pin_overflow_headroom(attempt)
                try:
                    plan = self.distributed_plan(
                        num_tasks, dcfg, pcfg, coordinator=coordinator
                    )
                    _overflow_retry_guard(plan, attempt, last_err)
                    out = coordinator.execute(plan)
                    self.last_retry_count = attempt
                    return out
                except RuntimeError as e:
                    if isinstance(e, OverflowRetryAbandoned):
                        raise
                    if "overflow" not in str(e):
                        raise
                    last_err = e
                    pcfg, dcfg = _widen_for_overflow(
                        pcfg, dcfg, e,
                        force_all=attempt
                        >= self.ctx.config.overflow_retries - 1,
                    )
            raise last_err  # type: ignore[misc]
        finally:
            if adaptive_coord:
                coordinator.release_overflow_headroom()

    def collect_coordinated(self, **kw):
        """`collect_coordinated_table` -> pyarrow Table."""
        from datafusion_distributed_tpu_torch.io.parquet import table_to_arrow

        return table_to_arrow(
            self._strip_quals(self.collect_coordinated_table(**kw))
        )

    def _seeded_host_config(self, num_tasks: int):
        """Like _seeded_distributed_config, but for the coordinator tier,
        where task counts are real scheduling units: bytes-based sizing is
        on by default (SET distributed.size_tasks_to_data=false opts
        out)."""
        cfg = self._seeded_distributed_config(num_tasks)
        if "size_tasks_to_data" not in self.ctx.config.distributed_options:
            cfg = replace(cfg, size_tasks_to_data=True)
        return cfg

    def _seeded_distributed_config(self, num_tasks: int):
        """DistributedConfig honoring the session's `SET distributed.*`
        options, at ``num_tasks`` tasks."""
        from datafusion_distributed_tpu_torch.planner.distributed import (
            DistributedConfig,
        )

        opts = {
            k: v for k, v in self.ctx.config.distributed_snapshot().items()
            if k in DistributedConfig.__dataclass_fields__
        }
        opts["num_tasks"] = num_tasks
        return DistributedConfig(**opts)

    def explain(self) -> str:
        return self.physical_plan().display_tree()

    def explain_distributed(self, num_tasks: int = 8) -> str:
        """The staged plan for ``num_tasks`` tasks, one node a line, each
        exchange marked with its stage id."""
        from datafusion_distributed_tpu_torch.planner.distributed import (
            display_staged_plan,
        )

        return display_staged_plan(self.distributed_plan(num_tasks))

    def explain_verify(self, num_tasks: Optional[int] = None,
                       mesh_axis_size: Optional[int] = None
                       ) -> "VerifyReport":
        """The `EXPLAIN VERIFY` surface: the staged plan annotated with every
        verifier diagnostic per node (plan/verify.py). Never raises on a
        malformed plan: it shows what strict mode would reject."""
        from datafusion_distributed_tpu_torch.plan.verify import (
            render_verified_tree,
            verify_physical_plan,
        )

        t = num_tasks or int(
            self.ctx.config.distributed_options.get("num_tasks", 8)
        )
        plan = self._plan_without_enforce(t)
        result = verify_physical_plan(plan, mesh_axis_size=mesh_axis_size)
        return VerifyReport(render_verified_tree(plan, result), result)

    def _plan_without_enforce(self, num_tasks: int):
        """The staged plan with enforcement suppressed: EXPLAIN VERIFY must
        render a strict-mode-rejected plan, not die on it."""
        opts = self.ctx.config.distributed_options
        saved = opts.get("verify_plans")
        opts["verify_plans"] = "off"
        try:
            return self.distributed_plan(
                num_tasks, self._seeded_distributed_config(num_tasks),
                self.ctx.config.planner,
            )
        finally:
            if saved is None:
                opts.pop("verify_plans", None)
            else:
                opts["verify_plans"] = saved

    def logical_display(self) -> str:
        return self.logical.display_tree()


class VerifyReport(str):
    """The result of `EXPLAIN VERIFY` / `DataFrame.explain_verify`: renders
    as the annotated plan tree; `.result` carries the structured
    VerifyResult and `.diagnostics` the raw Diagnostic list."""

    def __new__(cls, text: str, result):
        obj = super().__new__(cls, text)
        obj.result = result
        obj.diagnostics = result.diagnostics
        return obj


class SessionContext:
    def __init__(self, config: Optional[SessionConfig] = None, device=None):
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.config = config or SessionConfig()
        # session-level physical-plan cache, keyed by (logical-plan
        # fingerprint, catalog generation, planner knobs): distinct
        # ctx.sql(text) submissions of the same query reuse the planned
        # tree instead of re-planning. Bounded LRU (entries pin scan
        # Tables that may since have been re-registered); locked, since
        # several threads may plan against one session.
        self._plans: dict = {}
        self._plans_lock = threading.Lock()
        # fingerprint-keyed whole-result + sub-plan cache (runtime/
        # result_cache.py), created lazily on the first consult with
        # `SET distributed.result_cache` on; _plans_lock guards creation
        self._result_cache = None  # guarded-by: _plans_lock

    _PLAN_CACHE_ENTRIES = 128

    def result_cache(self):
        """The session's ResultCache when `SET distributed.result_cache`
        is on, else None. Every consult reconciles the cache with the
        live catalog generation (lazy invalidation — covers table
        registrations that bypassed SessionContext.register_table) and
        the `result_cache_budget_bytes` knob."""
        from datafusion_distributed_tpu_torch.ops.table import parse_bool_knob

        opts = self.config.distributed_options
        try:
            if not parse_bool_knob(opts.get("result_cache", False)):
                return None
        except ValueError:
            return None
        rc = self._result_cache
        if rc is None:
            from datafusion_distributed_tpu_torch.runtime.result_cache import (
                ResultCache,
            )

            with self._plans_lock:
                rc = self._result_cache
                if rc is None:
                    rc = self._result_cache = ResultCache()
        rc.sync(
            generation=self.catalog.generation,
            budget_bytes=opts.get("result_cache_budget_bytes", 0),
        )
        return rc

    def _plan_cache_get(self, key):
        with self._plans_lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.pop(key)
                self._plans[key] = plan  # move-to-end: LRU
            return plan

    def _plan_cache_put(self, key, plan) -> None:
        with self._plans_lock:
            while len(self._plans) >= self._PLAN_CACHE_ENTRIES:
                self._plans.pop(next(iter(self._plans)))
            self._plans[key] = plan

    # -- registration ---------------------------------------------------------
    def register_parquet(self, name: str, paths, capacity: Optional[int] = None):
        import pyarrow as pa
        import pyarrow.parquet as pq

        if isinstance(paths, (str,)):
            paths = [paths]
        tables = [pq.read_table(p) for p in paths]
        arrow = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        self.register_arrow(name, arrow, capacity)

    def register_arrow(self, name: str, arrow_table, capacity=None):
        from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table

        self.register_table(
            name, arrow_to_table(arrow_table, capacity, device=self.device)
        )

    def register_table(self, name: str, table: Table):
        if table.device != self.device:
            raise ValueError(
                f"table {name!r} lives on {table.device}, the session on "
                f"{self.device}"
            )
        self.catalog.register_table(name, table)
        rc = self._result_cache
        if rc is not None:
            # eager half of result-cache invalidation: the generation
            # bump above makes every cached entry (whole-result AND
            # sub-plan frontier) stale — drop them NOW so a post-update
            # query can never be served pre-update rows
            rc.invalidate_generation(self.catalog.generation)

    # -- SQL ------------------------------------------------------------------
    def sql(self, query: str) -> DataFrame:
        stmts = parse_statements(query)
        result: Optional[DataFrame] = None
        views: dict[str, LogicalPlan] = dict(self.catalog.views)
        for stmt in stmts:
            if isinstance(stmt, CreateView):
                binder = Binder(_ViewCatalog(self.catalog, views), views)
                plan = binder.bind(stmt.query)
                if stmt.column_aliases:
                    from datafusion_distributed_tpu_torch.plan import (
                        expressions as pe,
                    )
                    from datafusion_distributed_tpu_torch.sql.logical import (
                        LProject,
                    )

                    fields = plan.schema().fields
                    if len(stmt.column_aliases) != len(fields):
                        raise ValueError("view column alias arity mismatch")
                    plan = LProject(
                        [(pe.Col(f.name), n)
                         for f, n in zip(fields, stmt.column_aliases)],
                        plan,
                    )
                views[stmt.name.lower()] = plan
                self.catalog.views[stmt.name.lower()] = plan
            elif isinstance(stmt, DropView):
                views.pop(stmt.name.lower(), None)
                self.catalog.views.pop(stmt.name.lower(), None)
            elif isinstance(stmt, SetOption):
                self.config.set_option(stmt.name, stmt.value)
            elif isinstance(stmt, ExplainVerify):
                binder = Binder(_ViewCatalog(self.catalog, views), views)
                # later statements of the script still run; the report is
                # the script's result only when it is the last statement
                result = DataFrame(
                    self, binder.bind(stmt.query)).explain_verify()
            else:
                binder = Binder(_ViewCatalog(self.catalog, views), views)
                result = DataFrame(self, binder.bind(stmt))
        if result is None:
            if stmts:
                return None  # DDL/SET-only script
            raise ValueError("no SQL statements in input")
        return result

    def last_trace(self):
        """Chrome trace-event JSON dict of the most recently completed
        traced query (load in Perfetto / chrome://tracing), or None when
        nothing ran with `SET distributed.tracing` on. Coordinated
        executions record into the process-wide trace store whichever
        coordinator object ran them (runtime/tracing.py)."""
        from datafusion_distributed_tpu_torch.runtime.tracing import (
            DEFAULT_TRACE_STORE,
            to_chrome_trace,
        )

        trace = DEFAULT_TRACE_STORE.last()
        return to_chrome_trace(trace) if trace is not None else None

    def last_trace_profile(self) -> str:
        """Text profile report of the most recent traced query ('' when
        none): the explain_analyze trace fold, standalone."""
        from datafusion_distributed_tpu_torch.runtime.tracing import (
            DEFAULT_TRACE_STORE,
            render_profile,
        )

        trace = DEFAULT_TRACE_STORE.last()
        return render_profile(trace) if trace is not None else ""

    def prepare(self, template: str) -> "PreparedStatement":
        """Prepared-statement API: ``ctx.prepare("... where x < $1")`` -> a
        PreparedStatement whose ``execute(params)`` bindings share one
        structural fingerprint through literal hoisting
        (plan/fingerprint.py)."""
        return PreparedStatement(self, template)


def _parse_placeholders(template: str) -> list:
    """-> [(literal_text | None, param_name | None)] segments of a
    prepared-statement template. Placeholders are ``$name`` or ``$1``-style
    (1-based positional); ``$`` inside single-quoted SQL string literals,
    double-quoted identifiers, and ``--`` / ``/* */`` comments is text,
    not a placeholder (standard '' / "" escaping respected)."""
    out: list = []
    buf: list = []
    i, n = 0, len(template)
    ph = re.compile(r"\$([A-Za-z_][A-Za-z0-9_]*|[0-9]+)")
    while i < n:
        c = template[i]
        if c in ("'", '"'):
            q = c
            j = i + 1
            while j < n:
                if template[j] == q:
                    if j + 1 < n and template[j + 1] == q:
                        j += 2
                        continue
                    break
                j += 1
            buf.append(template[i:j + 1])
            i = j + 1
        elif c == "-" and template[i:i + 2] == "--":
            j = template.find("\n", i)
            j = n if j < 0 else j
            buf.append(template[i:j])
            i = j
        elif c == "/" and template[i:i + 2] == "/*":
            j = template.find("*/", i + 2)
            j = n if j < 0 else j + 2
            buf.append(template[i:j])
            i = j
        elif c == "$":
            m = ph.match(template, i)
            if m:
                if buf:
                    out.append(("".join(buf), None))
                    buf = []
                out.append((None, m.group(1)))
                i = m.end()
            else:
                buf.append(c)
                i += 1
        else:
            buf.append(c)
            i += 1
    if buf:
        out.append(("".join(buf), None))
    return out


def _format_param(value) -> str:
    """SQL literal text for a bound parameter value. Numeric and date
    parameters become exactly the literals the template author would have
    written, so literal hoisting lifts them into the parameter vectors and
    every binding shares one structural fingerprint."""
    import datetime as _dt

    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return repr(value)
    if isinstance(value, _dt.datetime):
        # DATE32 is the engine's only temporal type: a datetime binds as
        # its date ONLY when that loses nothing
        if (value.hour or value.minute or value.second
                or value.microsecond or value.tzinfo is not None):
            raise TypeError(
                "datetime parameters with a time-of-day (or tzinfo) are "
                "not supported — the engine's temporal type is DATE32; "
                "pass a datetime.date"
            )
        return f"date '{value.date().isoformat()}'"
    if isinstance(value, _dt.date):
        return f"date '{value.isoformat()}'"
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    raise TypeError(
        f"unsupported prepared-statement parameter type "
        f"{type(value).__name__}"
    )


class PreparedStatement:
    """A parameterized query template (``ctx.prepare(sql)``): every
    ``execute(params)`` binds the parameter values as literals; numeric and
    date literals hoist into the parameter vectors, so all bindings of one
    template share one structural fingerprint. String parameters bind too,
    but distinct string values fingerprint distinctly (their evaluation is
    host-side dictionary work).

    Placeholders: ``$name`` (bind with a dict / kwargs) or ``$1..$n``
    (bind with a sequence). `warm()` runs the first execution eagerly;
    `execute_coordinated` runs a binding through the coordinator, and
    `submit(serving_session, params)` through the serving tier.
    """

    def __init__(self, ctx: "SessionContext", template: str):
        self.ctx = ctx
        self.template = template
        self._segments = _parse_placeholders(template)
        names: list[str] = []
        for _text, name in self._segments:
            if name is not None and name not in names:
                names.append(name)
        if not names:
            raise ValueError(
                "prepared statement has no $placeholders — use ctx.sql()"
                " for parameter-free queries"
            )
        self.param_names = names
        self.positional = all(n.isdigit() for n in names)

    def _mapping(self, params, kw) -> dict:
        if params is None:
            mapping = dict(kw)
        elif isinstance(params, dict):
            mapping = {**params, **kw}
        elif isinstance(params, (list, tuple)):
            if not self.positional:
                raise ValueError(
                    "sequence parameters require $1..$n placeholders; "
                    f"this template names {self.param_names}"
                )
            mapping = {str(i + 1): v for i, v in enumerate(params)}
            mapping.update(kw)
        else:
            raise TypeError(
                "params must be a dict, a sequence, or keyword arguments"
            )
        missing = [n for n in self.param_names if n not in mapping]
        if missing:
            raise ValueError(f"missing parameters: {missing}")
        return mapping

    def bind_sql(self, params=None, **kw) -> str:
        """The template with every placeholder bound as a SQL literal."""
        mapping = self._mapping(params, kw)
        return "".join(
            text if name is None else _format_param(mapping[name])
            for text, name in self._segments
        )

    def to_df(self, params=None, **kw) -> "DataFrame":
        """Plan the bound statement (session plan cache applies)."""
        return self.ctx.sql(self.bind_sql(params, **kw))

    def execute(self, params=None, **kw):
        """Single-process execution -> pyarrow Table."""
        return self.to_df(params, **kw).collect()

    def execute_coordinated(self, params=None, coordinator=None,
                            num_workers: int = 2, num_tasks: int = 4,
                            **kw):
        """Coordinator/worker execution -> pyarrow Table."""
        return self.to_df(params, **kw).collect_coordinated(
            coordinator=coordinator, num_workers=num_workers,
            num_tasks=num_tasks,
        )

    def submit(self, session, params=None, priority: int = 0, **kw):
        """Submit a binding to a ServingSession (runtime/serving.py) ->
        QueryHandle: parse + bind + plan-cache hit, then admission."""
        return session.submit(self.bind_sql(params, **kw),
                              priority=priority)

    def warm(self, params=None, **kw) -> "PreparedStatement":
        """Run the first execution now. -> self, for chaining."""
        self.execute(params, **kw)
        return self


class _ViewCatalog:
    """Catalog facade that also resolves registered views (as CTEs)."""

    def __init__(self, catalog: Catalog, views: dict):
        self.catalog = catalog
        self.views = views

    def has_table(self, name: str) -> bool:
        return self.catalog.has_table(name) or name.lower() in self.views

    def table_schema(self, name: str) -> Schema:
        if name.lower() in self.views:
            s = self.views[name.lower()].schema()
            return Schema(
                [Field(f.name.split(".")[-1], f.dtype, f.nullable)
                 for f in s.fields]
            )
        return self.catalog.table_schema(name)

    def table_rows(self, name: str) -> int:
        if name.lower() in self.views:
            return 1000
        return self.catalog.table_rows(name)

    def column_ndv(self, table: str, column: str):
        if table.lower() in self.views:
            return None
        return self.catalog.column_ndv(table, column)

    def scan_exec(self, name: str, columns):
        return self.catalog.scan_exec(name, columns)
