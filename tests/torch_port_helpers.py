"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py): the
same numpy inputs go into the reference (JAX) package and into the port, and
results come back as numpy for comparison.

The port itself never imports the reference; only these tests hold both.
"""

from __future__ import annotations

import numpy as np
import torch

from datafusion_distributed_tpu_torch import precision as tprec
from datafusion_distributed_tpu_torch.ops.table import (
    Column as TColumn,
    Dictionary as TDictionary,
    Table as TTable,
)
from datafusion_distributed_tpu_torch.schema import DataType as TDataType

# the suite runs under pytest-xdist with several workers on few cores
torch.set_num_threads(1)


def port_table(ref_table) -> TTable:
    """A reference-package Table -> numpy -> a port Table on the CPU:
    identical buffers (padding included), validity and dictionaries."""
    cols = []
    for c in ref_table.columns:
        data = torch.from_numpy(np.array(c.data))
        validity = (torch.from_numpy(np.array(c.validity))
                    if c.validity is not None else None)
        d = (TDictionary(np.asarray(c.dictionary.values, dtype=object))
             if c.dictionary is not None else None)
        cols.append(TColumn(data, validity, TDataType(c.dtype.value), d))
    return TTable(tuple(ref_table.names), tuple(cols),
                  torch.tensor(int(ref_table.num_rows), dtype=torch.int32))


def np_of(x) -> np.ndarray:
    """A jax array or torch tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def normalized(result: dict) -> dict:
    """Table.to_numpy() output with null entries zeroed (the two packages
    may leave different garbage under a null)."""
    out = {}
    for k, v in result.items():
        if isinstance(v, np.ma.MaskedArray):
            out[k] = (np.ma.getmaskarray(v), np.ma.filled(v, 0))
        else:
            out[k] = v
    return out


def assert_results_equal(a: dict, b: dict, what: str = "") -> None:
    """Ints, strings, nulls and row order exact; floats at test_rtol() of
    the column's scale. Float sums in float32 storage carry an absolute
    error ~eps * sum|x| of the column's magnitude, which two summation
    orders (the reference's and the port's) do not share — an element that
    is a near-cancelling sum can differ far beyond test_rtol of itself."""
    assert first_difference(a, b) == "", (
        f"{what}: results differ in {first_difference(a, b)}"
    )


def identical(a: dict, b: dict) -> bool:
    """Table.to_numpy() results equal byte for byte: names, dtypes, shapes,
    null masks, values (strings as lists)."""
    if list(a) != list(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if isinstance(x, np.ma.MaskedArray) or isinstance(y, np.ma.MaskedArray):
            if not (np.array_equal(np.ma.getmaskarray(x), np.ma.getmaskarray(y))
                    and identical({k: np.ma.getdata(x)},
                                  {k: np.ma.getdata(y)})):
                return False
        elif x.dtype == object:
            if list(x) != list(y):
                return False
        elif x.tobytes() != y.tobytes():
            return False
    return True


def first_difference(a: dict, b: dict) -> str:
    if list(a) != list(b):
        return f"column names {list(a)} vs {list(b)}"
    rtol = tprec.test_rtol()
    na, nb = normalized(a), normalized(b)
    for k in na:
        x, y = na[k], nb[k]
        if isinstance(x, tuple) or isinstance(y, tuple):
            if not (isinstance(x, tuple) and isinstance(y, tuple)):
                return f"{k} (nullability)"
            if not (np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])):
                return k
            continue
        if x.shape != y.shape:
            return f"{k} ({x.shape[0]} vs {y.shape[0]} rows)"
        if x.dtype.kind == "f":
            scale = float(np.nanmax(np.abs(x))) if np.isfinite(x).any() else 0.0
            if not np.allclose(x, y, rtol=rtol, atol=rtol * scale,
                               equal_nan=True):
                return k
        elif x.dtype == object:
            if list(x) != list(y):
                return k
        elif not np.array_equal(x, y):
            return k
    return ""


def mask_subquery_floats(tokens, found: list):
    """The token tree with each resolved scalar subquery's float value
    replaced by a marker (collected in ``found``): two packages sum floats
    in different orders, so such a value agrees at test_rtol, not to the
    bit, and neither does its token."""
    if isinstance(tokens, tuple):
        if (len(tokens) == 3 and tokens[0] == "subqlit"
                and isinstance(tokens[1], tuple) and tokens[1][0] == "float"):
            found.append(float(tokens[1][1]))
            return ("subqlit", "float", tokens[2])
        return tuple(mask_subquery_floats(x, found) for x in tokens)
    return tokens


def diagnostics(result) -> list:
    """A VerifyResult's findings as comparable tuples (node ids differ
    between the packages; the node's label does not)."""
    return [(d.code, d.severity, d.node, d.message)
            for d in result.diagnostics]


#: the distributed planner's annotations of a node and of an exchange
PLANNER_ANNOTATIONS = (
    "est_rows", "bailout_candidate", "predicted_partial_rows",
    "multiway_bailout_candidate", "probe_order_hint",
    "multiway_deleted_exchanges", "global_agg_selected", "stage_id",
    "producer_tasks", "consumer_fetch", "predicted_exchange_bytes",
)


def planner_annotations(plan) -> list:
    """Each node's class and planner annotations, in pre-order."""
    return [(type(n).__name__,) + tuple(getattr(n, a, None)
                                         for a in PLANNER_ANNOTATIONS)
            for n in plan.collect(lambda _n: True)]


def assert_staged_plans_equal(jplan, tplan, num_tasks: int,
                              what: str = "") -> None:
    """A staged plan of the reference and the port's counterpart: the same
    display string, the same planner annotations, the same verifier findings with the mesh width given
    and not given, no error finding, and the same structural fingerprint
    (a scalar subquery's float value at test_rtol). With the mesh width
    given, a stage of another width is an error in both packages alike."""
    from datafusion_distributed_tpu.plan import fingerprint as jfp
    from datafusion_distributed_tpu.plan import verify as jver
    from datafusion_distributed_tpu.planner.distributed import (
        display_staged_plan as jdisplay,
    )
    from datafusion_distributed_tpu_torch.plan import fingerprint as tfp
    from datafusion_distributed_tpu_torch.plan import verify as tver
    from datafusion_distributed_tpu_torch.planner.distributed import (
        display_staged_plan as tdisplay,
    )

    assert tdisplay(tplan) == jdisplay(jplan), f"{what}: display differs"
    assert planner_annotations(tplan) == planner_annotations(jplan), \
        f"{what}: annotations differ"
    for axis in (None, num_tasks):
        jr = jver.verify_physical_plan(jplan, mesh_axis_size=axis)
        tr = tver.verify_physical_plan(tplan, mesh_axis_size=axis)
        assert diagnostics(tr) == diagnostics(jr), f"{what} axis={axis}"
        assert axis is not None or not tr.errors(), f"{what}: {tr.render()}"
    jprep, tprep = jfp.prepare_plan(jplan), tfp.prepare_plan(tplan)
    assert tprep.fingerprint is not None, what
    assert (tprep.int_params, tprep.float_params) == (
        jprep.int_params, jprep.float_params), what
    if tprep.fingerprint != jprep.fingerprint:
        jf, tf = [], []
        assert mask_subquery_floats(
            tfp._canon_plan(tprep.plan), tf) == mask_subquery_floats(
            jfp._canon_plan(jprep.plan), jf), f"{what}: fingerprint differs"
        assert tf and np.allclose(tf, jf, rtol=tprec.test_rtol()), what


class Pkg:
    """One of the two packages: ``P("runtime.streams")`` is its module of
    that path, ``P.table(arrow)`` an arrow table as its Table (on the CPU
    in the port), ``P.ctx()`` a session on the CPU."""

    def __init__(self, root: str, device=None):
        self.root, self.device = root, device
        self.name = "torch" if root.endswith("_torch") else "jax"

    def __call__(self, path: str):
        import importlib

        return importlib.import_module(f"{self.root}.{path}")

    def __repr__(self):
        return self.name

    def table(self, arrow, **kw):
        if self.device is not None:
            kw["device"] = self.device
        return self("io.parquet").arrow_to_table(arrow, **kw)

    def ctx(self):
        ctx_cls = self("sql.context").SessionContext
        return ctx_cls() if self.device is None else ctx_cls(
            device=self.device)


REF = Pkg("datafusion_distributed_tpu")
PORT = Pkg("datafusion_distributed_tpu_torch", device="cpu")
BOTH = (REF, PORT)


def tpch_contexts(sf: float = 0.002, seed: int = 7, **distributed) -> dict:
    """{REF: ctx, PORT: ctx} over the same generated TPC-H tables (the
    reference generator's arrow tables), with ``distributed`` set as
    session distributed options."""
    from datafusion_distributed_tpu.data.tpchgen import gen_tpch

    arrow = gen_tpch(sf=sf, seed=seed)
    out = {}
    for P in BOTH:
        ctx = P.ctx()
        ctx.config.distributed_options.update(distributed)
        for name, tbl in arrow.items():
            ctx.register_arrow(name, tbl)
        out[P] = ctx
    return out


def assert_no_leaks(cluster) -> None:
    """No staged table or task entry left on any worker of ``cluster``."""
    for w in cluster.workers.values():
        assert not w.table_store.tables, f"{w.url} leaked TableStore entries"
        assert len(w.registry) == 0, f"{w.url} leaked registry entries"


def coordinated(P, ctx, sql: str, cluster, **opts):
    """``sql`` through ``P``'s Coordinator over ``cluster`` at 4 tasks, with
    fast retries and the coordinator options ``opts`` -> (the result with
    unqualified names, the coordinator)."""
    df = ctx.sql(sql)
    coord = P("runtime.coordinator").Coordinator(
        resolver=cluster, channels=cluster,
        config_options={"task_retry_backoff_s": 0.001, **opts})
    out = df._strip_quals(
        df.collect_coordinated_table(coordinator=coord, num_tasks=4))
    return out, coord


def assert_matches_reference(ref, got, what: str = "") -> None:
    """A port Table against the reference's: names and capacity equal, the
    rows as assert_results_equal holds them."""
    assert got.names == ref.names, what
    assert got.capacity == ref.capacity, what
    assert_results_equal(ref.to_numpy(), got.to_numpy(), what)


def record_shipped_plans(cluster, observe=None) -> list:
    """A list that gathers (stage, task, observed) of every task plan
    shipped to ``cluster``'s workers from now on: ``observe(encoded
    plan)``, by default the fingerprint its encoder stamped on it."""
    if observe is None:
        observe = lambda plan_obj: plan_obj.get("_fp")  # noqa: E731
    got = []
    for w in cluster.workers.values():
        real = w.set_plan

        def set_plan(key, plan_obj, *a, _real=real, **kw):
            got.append((key.stage_id, key.task_number, observe(plan_obj)))
            return _real(key, plan_obj, *a, **kw)

        w.set_plan = set_plan
    return got


def sum_by_key_plan(P, n: int = 2048, num_tasks: int = 4):
    """The reference suites' hand-built plan in package ``P``: a sum of a
    normal column by 16 keys, staged for ``num_tasks`` tasks."""
    import pyarrow as pa

    phys = P("plan.physical")
    dist = P("planner.distributed")
    rng = np.random.default_rng(3)
    t = P.table(pa.table({"k": rng.integers(0, 16, n),
                          "v": rng.normal(size=n)}))
    scan = phys.MemoryScanExec([t], t.schema())
    agg = phys.HashAggregateExec(
        "single", ["k"], [P("ops.aggregate").AggSpec("sum", "v", "sv")],
        scan, 32)
    return dist.distribute_plan(agg, dist.DistributedConfig(
        num_tasks=num_tasks))


class ChunkOrder:
    """Serializes the chunks of a coordinated stage's streamed tasks into a
    fixed arrival order: ``"task0_first"`` lets the lowest live task yield
    every chunk before the next one starts; ``"round_robin"`` passes the
    turn to the next live task after each chunk. A task's turn ends when
    the consumer asks for its next chunk (so the chunk already went
    through the consumer queue), and a cancelled stream stops waiting."""

    ORDERS = ("task0_first", "round_robin")

    def __init__(self, num_tasks: int, order: str):
        import threading

        assert order in self.ORDERS, order
        self.order = order
        self._cv = threading.Condition()
        self._live = list(range(num_tasks))
        self._pos = 0

    def _owner(self):
        return self._live[self._pos] if self._live else None

    def wrap(self, stream, task: int, cancel):
        try:
            for item in stream:
                with self._cv:
                    while self._owner() != task and not (
                            cancel is not None and cancel.is_set()):
                        self._cv.wait(0.05)
                yield item
                with self._cv:
                    if self.order == "round_robin" and self._live:
                        self._pos = (self._pos + 1) % len(self._live)
                    self._cv.notify_all()
        finally:
            with self._cv:
                i = self._live.index(task)
                self._live.pop(i)
                if i < self._pos:
                    self._pos -= 1
                if self._pos >= len(self._live):
                    self._pos = 0
                self._cv.notify_all()


def force_chunk_order(cluster, num_tasks: int, order: str) -> ChunkOrder:
    """Wrap every worker's ``execute_task_stream`` of ``cluster`` so that
    the chunks of a streamed stage of ``num_tasks`` tasks reach the
    coordinator in ``order`` (ChunkOrder). Round robin needs every task
    executing at once: the coordinator runs at most one streamed task a
    worker, so the cluster needs a worker per task."""
    assert order != "round_robin" or len(cluster.workers) >= num_tasks
    seq = ChunkOrder(num_tasks, order)
    for w in cluster.workers.values():
        real = w.execute_task_stream

        def stream(key, *a, _real=real, cancel=None, **kw):
            return seq.wrap(_real(key, *a, cancel=cancel, **kw),
                            key.task_number, cancel)

        w.execute_task_stream = stream
    return seq
