"""The port's single-node session against the reference package's on the
CPU: structural fingerprints, the session plan cache and literal hoisting
(the single-node cases of tests/test_plan_fingerprint.py), the plan
verifier (the single-node cases of tests/test_plan_verify.py: the same
codes, severities and messages), all 22 TPC-H plans (no error diagnostic,
the same diagnostics and fingerprints in both packages, byte-identical
results with hoisting on and off), prepared statements, and EXPLAIN VERIFY
with test_plan_verify.py's clean sweep, whose text and findings equal the
reference's."""

import os
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.io.parquet import arrow_to_table as j_arrow
from datafusion_distributed_tpu.ops.aggregate import AggSpec as JAggSpec
from datafusion_distributed_tpu.ops.sort import SortKey as JSortKey
from datafusion_distributed_tpu.plan import expressions as jpe
from datafusion_distributed_tpu.plan import fingerprint as jfp
from datafusion_distributed_tpu.plan import joins as jjoins
from datafusion_distributed_tpu.plan import physical as jphys
from datafusion_distributed_tpu.plan import verify as jver
from datafusion_distributed_tpu.schema import DataType as JDT
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.data import tpchgen as ttpch
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table as t_arrow
from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec as TAggSpec
from datafusion_distributed_tpu_torch.ops.sort import SortKey as TSortKey
from datafusion_distributed_tpu_torch.plan import expressions as tpe
from datafusion_distributed_tpu_torch.plan import fingerprint as tfp
from datafusion_distributed_tpu_torch.plan import joins as tjoins
from datafusion_distributed_tpu_torch.plan import physical as tphys
from datafusion_distributed_tpu_torch.plan import verify as tver
from datafusion_distributed_tpu_torch import precision as tprec
from datafusion_distributed_tpu_torch.schema import DataType as TDT
from datafusion_distributed_tpu_torch.sql import planner as tplanner
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import (
    assert_results_equal,
    identical,
    mask_subquery_floats,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QDIR = os.path.join(REPO, "benchmarks", "queries", "tpch")
TPCH = [f"q{i}" for i in range(1, 23)]


def _arrow(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": rng.integers(0, 50, n).astype("int64"),
        "b": (rng.random(n) * 10).astype("float64"),
        "s": pa.array([["x", "y", "z"][i % 3] for i in range(n)]),
    })


def _contexts(capacity=None, tables=(("t", 0),)):
    """A reference session and a port session (CPU) over the same tables."""
    j, t = JContext(), TContext(device="cpu")
    for name, seed in tables:
        j.register_arrow(name, _arrow(seed=seed), capacity=capacity)
        t.register_arrow(name, _arrow(seed=seed), capacity=capacity)
    return j, t


Q = "select s, sum(b) as sb, count(*) as n from t where a > 10 group by s order by s"


def _fp(pkg, plan):
    return (jfp if pkg == "j" else tfp).prepare_plan(plan).fingerprint


def _both(ctxs, sql):
    """-> (reference plan, port plan) of ``sql``."""
    j, t = ctxs
    return j.sql(sql).physical_plan(), t.sql(sql).physical_plan()


# ---------------------------------------------------------------------------
# fingerprints, the session plan cache and literal hoisting
# ---------------------------------------------------------------------------


def test_identical_resubmission_reuses_the_session_plan(monkeypatch):
    j, t = _contexts()
    calls = []
    real = tplanner.PhysicalPlanner.plan
    monkeypatch.setattr(tplanner.PhysicalPlanner, "plan",
                        lambda self, lp: calls.append(1) or real(self, lp))
    t1, t2 = t.sql(Q), t.sql(Q)
    r1 = t1.collect_table().to_numpy()
    r2 = t2.collect_table().to_numpy()
    assert len(calls) == 1, "identical resubmission re-planned"
    assert t2.physical_plan() is t1.physical_plan()
    assert identical(r1, r2)
    j1, j2 = j.sql(Q), j.sql(Q)
    assert j2.physical_plan() is j1.physical_plan()
    assert_results_equal(j1.collect_table().to_numpy(), r1, Q)


def test_literal_variant_shares_its_fingerprint():
    ctxs = _contexts()
    q2 = Q.replace("a > 10", "a > 30")
    for pkg, (p1, p2) in zip("jt", zip(_both(ctxs, Q), _both(ctxs, q2))):
        assert p1 is not p2
        assert _fp(pkg, p1) == _fp(pkg, p2), pkg
    j, t = ctxs
    assert _fp("t", t.sql(q2).physical_plan()) == _fp(
        "j", j.sql(q2).physical_plan())
    # the hoisted literal is bound at run time: the variant's own result
    assert_results_equal(j.sql(q2).collect_table().to_numpy(),
                         t.sql(q2).collect_table().to_numpy(), q2)
    prep = tfp.prepare_plan(t.sql(q2).physical_plan())
    assert prep.int_params == (30,) and prep.plan is not t.sql(
        q2).physical_plan()


@pytest.mark.parametrize("case", ["string_literal", "capacity",
                                  "swapped_leaves_same_alias",
                                  "swapped_leaves_other_alias"])
def test_fingerprint_equivalences_match_the_reference(case):
    """Equal digests in the port exactly where they are equal in the
    reference, and the same digests."""
    two = (("t1", 1), ("t2", 2))
    if case == "string_literal":
        qx = ("select s, sum(b) as sb, count(*) as n from t where a > 10 "
              "and s = 'x' group by s order by s")
        plans = [_both(_contexts(), qx),
                 _both(_contexts(), qx.replace("'x'", "'y'"))]
    elif case == "capacity":
        plans = [_both(_contexts(capacity=64), Q),
                 _both(_contexts(capacity=256), Q)]
    elif case == "swapped_leaves_same_alias":
        ctxs = _contexts(tables=two)
        q = "select sum(b) as sb from {} as u where a > 10"
        plans = [_both(ctxs, q.format("t1")), _both(ctxs, q.format("t2"))]
    else:
        ctxs = _contexts(tables=two)
        q = "select sum(b) as sb from {} where a > 10"
        plans = [_both(ctxs, q.format("t1")), _both(ctxs, q.format("t2"))]
    jf = [_fp("j", p[0]) for p in plans]
    tf = [_fp("t", p[1]) for p in plans]
    assert tf == jf
    assert (tf[0] == tf[1]) == (case == "swapped_leaves_same_alias")


@pytest.mark.parametrize("value", [3, -7, 2.5, 0.1])
def test_scalar_tokens_match_the_reference(value):
    """A numpy scalar, and a 0-d tensor of its value and dtype, take the
    reference's token of the numpy scalar; a Python scalar the reference's
    token of the Python scalar."""
    for dt in ((np.int64, np.int32) if isinstance(value, int)
               else (np.float64, np.float32)):
        scalar = np.asarray(value, dtype=dt)[()]
        ref = jfp._canon_value(scalar)
        assert tfp._canon_value(scalar) == ref
        assert tfp._canon_value(torch.from_numpy(np.asarray(scalar))) == ref
    assert tfp._canon_value(value) == jfp._canon_value(value)


def test_logical_fingerprint_and_catalog_generation():
    j, t = _contexts()
    for ctx, fp in ((j, jfp), (t, tfp)):
        df1, df2 = ctx.sql(Q), ctx.sql(Q)
        lf1 = fp.logical_fingerprint(df1.logical)
        assert lf1 is not None and lf1 == fp.logical_fingerprint(df2.logical)
        old = df1.physical_plan()
        assert df2.physical_plan() is old
        # re-registration bumps the generation: the old plan holds the old
        # tables and must not be served
        ctx.register_arrow("t", _arrow(seed=9))
        assert ctx.sql(Q).physical_plan() is not old
    assert tfp.logical_fingerprint(t.sql(Q).logical) == \
        jfp.logical_fingerprint(j.sql(Q).logical)


def test_hoisting_knob():
    j, t = _contexts()
    q2 = Q.replace("a > 10", "a > 30")
    try:
        for ctx, pkg in ((j, "j"), (t, "t")):
            ctx.sql("set distributed.literal_hoisting = 0")
        assert not tfp.hoist_enabled() and not jfp.hoist_enabled()
        fps = {pkg: (_fp(pkg, p1), _fp(pkg, p2)) for pkg, p1, p2 in
               zip("jt", *(_both((j, t), q) for q in (Q, q2)))}
        assert fps["t"] == fps["j"]
        assert fps["t"][0] != fps["t"][1]
    finally:
        tfp.set_literal_hoisting(True)
        jfp.set_literal_hoisting(True)
    assert tfp.hoist_enabled()


def test_session_plan_cache_lru_bounded():
    j, t = _contexts()
    for ctx in (j, t):
        ctx._PLAN_CACHE_ENTRIES = 2
        plans = [ctx.sql(f"select a from t order by a limit {lim}")
                 .physical_plan() for lim in (1, 2, 3)]
        assert len(ctx._plans) == 2
        # the oldest entry was evicted: limit 1 re-plans
        assert ctx.sql("select a from t order by a limit 1"
                       ).physical_plan() is not plans[0]
        assert ctx.sql("select a from t order by a limit 3"
                       ).physical_plan() is plans[2]
    assert TContext._PLAN_CACHE_ENTRIES == JContext._PLAN_CACHE_ENTRIES == 128


# ---------------------------------------------------------------------------
# the verifier: seeded malformed plans
# ---------------------------------------------------------------------------


def _vtables(with_string=False, n=64):
    rng = np.random.default_rng(7)
    cols = {"a": rng.integers(0, 10, n).astype(np.int64),
            "b": rng.normal(size=n)}
    if with_string:
        cols["s"] = np.asarray(
            [f"v{int(i) % 5}" for i in rng.integers(0, 100, n)], dtype=object)
    arrow = pa.table(cols)
    return j_arrow(arrow), t_arrow(arrow, device="cpu")


def _malformed(case: str, pkg: str):
    """The same malformed plan, built from either package's classes."""
    phys, pe, joins = ((jphys, jpe, jjoins) if pkg == "j"
                       else (tphys, tpe, tjoins))
    SortKey = JSortKey if pkg == "j" else TSortKey
    AggSpec = JAggSpec if pkg == "j" else TAggSpec
    DT = JDT if pkg == "j" else TDT
    side = 0 if pkg == "j" else 1

    def scan(with_string=False):
        t = _vtables(with_string)[side]
        return phys.MemoryScanExec([t], t.schema())

    if case == "DFTPU011":
        return phys.SortExec([SortKey("no_such_col", True, False)], scan())
    if case == "DFTPU012":
        return joins.HashJoinExec(scan(), scan(True), ["a"], ["s"], "inner")
    if case == "DFTPU013":
        return joins.UnionExec([scan(), scan(True)])
    if case == "DFTPU015":
        return phys.FilterExec(pe.Col("a"), scan())
    if case == "DFTPU021":
        agg = phys.HashAggregateExec(
            "single", ["a"], [AggSpec("count_star", None, "c")], scan(),
            num_slots=4)
        agg.est_rows = 1000.0
        return agg
    if case == "DFTPU022":
        return phys.HashAggregateExec(
            "single", [], [AggSpec("count_star", None, "c")], scan(),
            num_slots=1 << 32)
    if case == "DFTPU023":
        j = joins.HashJoinExec(scan(), scan(), ["a"], ["a"], "inner",
                               num_slots=8)
        j.build.est_rows = 4096.0
        return j
    if case == "DFTPU041":
        class OpaqueExec(phys.MemoryScanExec):
            pass

        t = _vtables()[side]
        return OpaqueExec([t], t.schema())
    if case == "DFTPU042":
        return phys.FilterExec(pe.Like(pe.Col("s"), "%abc%", False),
                               scan(True))
    if case == "clean":
        return phys.FilterExec(
            pe.BinaryOp("<", pe.Col("a"), pe.Literal(5, DT.INT64)), scan())
    raise ValueError(case)


def _diags(result):
    return [(d.code, d.severity, d.node, d.message)
            for d in result.diagnostics]


_SEVERITY = {"DFTPU011": "error", "DFTPU012": "error", "DFTPU013": "error",
             "DFTPU015": "error", "DFTPU021": "warning", "DFTPU022": "error",
             "DFTPU023": "warning", "DFTPU041": "warning",
             "DFTPU042": "warning", "clean": None}


@pytest.mark.parametrize("case", sorted(_SEVERITY))
def test_verifier_diagnostics_match_the_reference(case):
    jr = jver.verify_physical_plan(_malformed(case, "j"))
    tr = tver.verify_physical_plan(_malformed(case, "t"))
    assert _diags(tr) == _diags(jr)
    if case == "clean":
        assert not tr.diagnostics
        return
    assert case in tr.codes()
    assert {d.severity for d in tr.diagnostics if d.code == case} == \
        {_SEVERITY[case]}
    assert tr.ok == jr.ok == (_SEVERITY[case] == "warning")
    assert tver.render_verified_tree(_malformed(case, "t"), tr).splitlines()[
        0].split("!")[0] == jver.render_verified_tree(
            _malformed(case, "j"), jr).splitlines()[0].split("!")[0]


def test_cycle_stops_every_later_pass():
    f = tphys.FilterExec(
        tpe.BinaryOp(">", tpe.Col("a"), tpe.Literal(3, TDT.INT64)),
        _malformed("DFTPU011", "t").child)
    f.child = f  # back-edge
    assert tver.verify_physical_plan(f).codes() == {"DFTPU033"}


def test_mode_resolution_precedence(monkeypatch):
    monkeypatch.delenv("DFTPU_VERIFY_PLANS", raising=False)
    for v in (jver, tver):
        assert v.resolve_verify_mode(None) == "warn"
    monkeypatch.setenv("DFTPU_VERIFY_PLANS", "off")
    for v in (jver, tver):
        assert v.resolve_verify_mode(None) == "off"
        assert v.resolve_verify_mode({"verify_plans": "strict"}) == "strict"
        with pytest.raises(ValueError):
            v.resolve_verify_mode({"verify_plans": "bogus"})
    assert tver.MODES == jver.MODES == ("strict", "warn", "off")


def test_enforce_modes():
    bad = _malformed("DFTPU011", "t")
    with pytest.raises(tver.PlanVerificationError) as ei:
        tver.enforce_verification(bad, mode="strict")
    assert "DFTPU011" in str(ei.value)
    assert "overflow" not in str(ei.value)  # must not trip the retry loop
    with pytest.raises(jver.PlanVerificationError) as ej:
        jver.enforce_verification(_malformed("DFTPU011", "j"), mode="strict")
    # the same text but for the per-process node ids
    assert re.sub(r"node=\d+", "", str(ei.value)) == re.sub(
        r"node=\d+", "", str(ej.value))
    with pytest.warns(RuntimeWarning, match="DFTPU011"):
        tver.enforce_verification(bad, mode="warn")
    assert tver.enforce_verification(bad, mode="off") is None
    # warnings never raise, even in strict mode
    tver.enforce_verification(_malformed("DFTPU021", "t"), mode="strict")


def test_session_verifies_before_running(monkeypatch):
    """strict rejects a plan the verifier finds malformed, warn runs it
    with a RuntimeWarning; both before anything executes."""
    _j, t = _contexts()
    df = t.sql(Q)
    bad = tver.VerifyResult([tver.Diagnostic("DFTPU011", "error", None, "x")])
    monkeypatch.setattr(tver, "verify_physical_plan", lambda plan, **kw: bad)
    ran = []
    monkeypatch.setattr(
        "datafusion_distributed_tpu_torch.sql.context.execute_plan",
        lambda plan: ran.append(plan))
    t.sql("set distributed.verify_plans = strict")
    with pytest.raises(tver.PlanVerificationError):
        df.collect_table()
    assert not ran
    df2 = t.sql(Q.replace("10", "11"))
    t.sql("set distributed.verify_plans = warn")
    with pytest.warns(RuntimeWarning, match="DFTPU011"):
        df2.collect_table()
    assert len(ran) == 1


@pytest.mark.parametrize("key,good,bad", [
    ("verify_plans", "warn", "sloppy"),
    ("plan_cache_size", "64", "'many'"),
    ("literal_hoisting", "'on'", None),
    ("result_cache", "'off'", None),
])
def test_set_validation_matches_the_reference(key, good, bad):
    j, t = _contexts()
    try:
        for ctx in (j, t):
            ctx.sql(f"SET distributed.{key} = {good}")
        assert t.config.distributed_options[key] == \
            j.config.distributed_options[key]
        if bad is not None:
            for ctx in (j, t):
                with pytest.raises(ValueError):
                    ctx.sql(f"SET distributed.{key} = {bad}")
    finally:
        tfp.set_literal_hoisting(True)
        jfp.set_literal_hoisting(True)
        jphys.set_plan_cache_size(jphys._plan_cache_default())


#: the knobs the reference validates and coerces at SET time
#: (sql/context.py): knob -> (a good value, a bad value; a negative one
#: quoted, since the SET grammar has no unary minus)
SET_KNOBS = {
    "data_plane": ("'STREAM'", "'disk'"),
    "wire_compression": ("'ZSTD'", "'zip'"),
    "tracing": ("'On'", "'bogus'"),
    "tracing_sample_rate": ("1", "2"),
    "hedge_quantile": ("0.95", "2"),
    "hedge_floor_s": ("0", "'-1'"),
    "hedge_budget": ("3", "'-1'"),
    "skew_split_factor": ("2", "0.5"),
    "skew_split_min_rows": ("100", "'-1'"),
    "partial_agg_bailout_ratio": ("0.8", "1.5"),
    "replan_cardinality_factor": ("4", "0.5"),
}


@pytest.mark.parametrize("knob", list(SET_KNOBS))
def test_set_knob_coercion_matches_the_reference(knob):
    """A good value is stored as the reference stores it (value and
    type); a bad one raises the reference's ValueError message and stores
    nothing."""
    good, bad = SET_KNOBS[knob]
    stored, msgs = [], []
    for ctx in (JContext(), TContext(device="cpu")):
        ctx.sql(f"SET distributed.{knob} = {good}")
        value = ctx.config.distributed_options.pop(knob)
        stored.append((value, type(value)))
        with pytest.raises(ValueError) as ei:
            ctx.sql(f"SET distributed.{knob} = {bad}")
        assert knob not in ctx.config.distributed_options
        msgs.append(str(ei.value))
    assert stored[1] == stored[0]
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# EXPLAIN VERIFY and the clean sweep (tests/test_plan_verify.py's cases)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def verify_ctxs():
    """The reference's and the port's session over test_plan_verify.py's
    table ``t``."""
    rng = np.random.default_rng(11)
    arrow = pa.table({
        "k": rng.integers(0, 6, 2000),
        "v": rng.normal(size=2000),
        "s": np.asarray([f"cat{i % 4}" for i in range(2000)], dtype=object),
    })
    j, t = JContext(), TContext(device="cpu")
    j.register_arrow("t", arrow)
    t.register_arrow("t", arrow)
    return j, t


def test_explain_verify_statement(verify_ctxs):
    from datafusion_distributed_tpu_torch.sql.context import VerifyReport

    sql = ("EXPLAIN VERIFY select k, count(*) c from t "
           "where s like '%at1%' group by k")
    jrep, rep = (ctx.sql(sql) for ctx in verify_ctxs)
    assert isinstance(rep, VerifyReport)
    assert str(rep) == str(jrep)
    assert _diags(rep.result) == _diags(jrep.result)
    assert "verification:" in rep
    # the unhoistable LIKE warning lands on the Filter node line
    assert "DFTPU042" in rep
    assert any(d.code == "DFTPU042" for d in rep.diagnostics)
    assert all(d.severity != "error" for d in rep.diagnostics)


@pytest.mark.parametrize("num_tasks,axis", [(4, None), (4, 4), (2, 8),
                                             (None, None)])
def test_explain_verify_method_matches_the_reference(verify_ctxs, num_tasks,
                                                     axis):
    sql = "select k, sum(v) s from t group by k order by k"
    jrep, rep = (ctx.sql(sql).explain_verify(num_tasks=num_tasks,
                                             mesh_axis_size=axis)
                 for ctx in verify_ctxs)
    assert str(rep) == str(jrep)
    assert _diags(rep.result) == _diags(jrep.result)
    assert "verification:" in rep
    # a mesh narrower or wider than the stages is an error (DFTPU035)
    assert bool(rep.result.errors()) == (axis not in (None, num_tasks))


#: test_plan_verify.py's inlined battery (every operator family)
SWEEP_QUERIES = {
    "global_agg": "select count(*) c, sum(v) s, avg(v) a from t",
    "group_sort": "select k, sum(v) s from t group by k order by s desc",
    "filter_like": "select k from t where s like '%at3%' and v > 0.5",
    "topk": "select k, v from t order by v desc limit 7",
    "window": "select k, v, row_number() over "
              "(partition by k order by v) rn from t",
    "join": "select a.k, sum(a.v + b.v) s from t a, t b "
            "where a.k = b.k group by a.k",
    "union": "select k from t where v > 1 union all "
             "select k from t where v < -1",
    "in_list": "select count(*) c from t where k in (1, 3, 5)",
    "subquery": "select k from t where v > (select avg(v) from t)",
    "distinct": "select k, count(distinct s) u from t group by k",
}


@pytest.mark.parametrize("name", sorted(SWEEP_QUERIES))
def test_clean_sweep_matches_the_reference(verify_ctxs, name):
    from datafusion_distributed_tpu.planner.distributed import (
        DistributedConfig as JDC,
    )
    from datafusion_distributed_tpu_torch.planner.distributed import (
        DistributedConfig as TDC,
    )

    jdf, tdf = (ctx.sql(SWEEP_QUERIES[name]) for ctx in verify_ctxs)
    pairs = [(jdf.physical_plan(), tdf.physical_plan()),
             (jdf.distributed_plan(num_tasks=4),
              tdf.distributed_plan(num_tasks=4))]
    # lattice-active configs reshape stage widths; they must stay coherent
    for kw in ({"max_tasks_per_stage": 3}, {"size_tasks_to_data": True},
               {"cardinality_task_count_factor": 2.0}):
        pairs.append((jdf.distributed_plan(config=JDC(num_tasks=8, **kw)),
                      tdf.distributed_plan(config=TDC(num_tasks=8, **kw))))
    for jp, tp in pairs:
        jr, tr = jver.verify_physical_plan(jp), tver.verify_physical_plan(tp)
        assert tr.ok, f"{name}: false positives:\n{tr.render()}"
        assert _diags(tr) == _diags(jr)
        assert tp.display_tree() == jp.display_tree()


# ---------------------------------------------------------------------------
# TPC-H: diagnostics, fingerprints, hoisting on and off, prepared statements
# ---------------------------------------------------------------------------


SF, SEED = 0.002, 7


@pytest.fixture(scope="module")
def tpch():
    jctx = JContext()
    for name, tbl in gen_tpch(SF, SEED).items():
        jctx.register_arrow(name, tbl)
    tctx = TContext(device="cpu")
    ttpch.register_tpch(tctx, SF, SEED)
    return jctx, tctx


def _sql(q):
    with open(os.path.join(QDIR, f"{q}.sql")) as f:
        return f.read()


@pytest.mark.parametrize("q", TPCH)
def test_tpch_plan_verifies_and_fingerprints_as_the_reference(tpch, q):
    jctx, tctx = tpch
    jp = jctx.sql(_sql(q)).physical_plan()
    tp = tctx.sql(_sql(q)).physical_plan()
    jr, tr = jver.verify_physical_plan(jp), tver.verify_physical_plan(tp)
    assert not tr.errors(), f"{q}: {tr.render()}"
    assert _diags(tr) == _diags(jr)
    jprep, tprep = jfp.prepare_plan(jp), tfp.prepare_plan(tp)
    assert tprep.fingerprint is not None
    assert (tprep.int_params, tprep.float_params) == (
        jprep.int_params, jprep.float_params)
    if tprep.fingerprint != jprep.fingerprint:
        jf, tf = [], []
        assert mask_subquery_floats(
            tfp._canon_plan(tprep.plan), tf) == mask_subquery_floats(
            jfp._canon_plan(jprep.plan), jf)
        assert tf and np.allclose(tf, jf, rtol=tprec.test_rtol())


@pytest.fixture(scope="module")
def unhoisted(tpch):
    """A second port session over the same tables, whose plans are only
    ever prepared with hoisting off."""
    ctx = TContext(device="cpu")
    for name, table in tpch[1].catalog.tables.items():
        ctx.register_table(name, table)
    return ctx


@pytest.mark.parametrize("q", TPCH)
def test_tpch_hoisting_on_and_off_byte_identical(tpch, unhoisted, q):
    df = tpch[1].sql(_sql(q))
    on = df.collect_table().to_numpy()
    prep = tfp.prepare_plan(df.physical_plan())
    assert prep.plan is not df.physical_plan() or not (
        prep.int_params or prep.float_params)
    try:
        tfp.set_literal_hoisting(False)
        off_df = unhoisted.sql(_sql(q))
        off = off_df.collect_table().to_numpy()
        off_prep = tfp.prepare_plan(off_df.physical_plan())
    finally:
        tfp.set_literal_hoisting(True)
    assert off_prep.plan is off_df.physical_plan()
    assert not off_prep.int_params and not off_prep.float_params
    assert identical(on, off)


def test_tpch_hoists_literals(tpch):
    counts = [len(tfp.prepare_plan(tpch[1].sql(_sql(q)).physical_plan())
                  .int_params) for q in TPCH]
    assert sum(counts) > 0 and counts[TPCH.index("q6")] == 3


Q6_TEMPLATE = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1995-01-01'
  and l_discount between $1 - 0.01 and $1 + 0.01
  and l_quantity < $2
"""


def test_prepared_statement_bindings(tpch):
    jctx, tctx = tpch
    tstmt, jstmt = tctx.prepare(Q6_TEMPLATE), jctx.prepare(Q6_TEMPLATE)
    assert tstmt.param_names == jstmt.param_names == ["1", "2"]
    fps = set()
    for params in ((0.06, 24), (0.05, 25), (0.07, 20)):
        sql = tstmt.bind_sql(params)
        assert sql == jstmt.bind_sql(params)
        got = tstmt.to_df(params).collect_table().to_numpy()
        assert identical(got, tctx.sql(sql).collect_table().to_numpy())
        assert_results_equal(jctx.sql(sql).collect_table().to_numpy(), got,
                             str(params))
        fps.add(tfp.prepare_plan(tstmt.to_df(params).physical_plan())
                .fingerprint)
    assert len(fps) == 1  # every binding shares one structural fingerprint
    assert tstmt.warm((0.06, 24)) is tstmt
    assert tstmt.execute((0.06, 24)).num_rows == 1
    with pytest.raises(ValueError, match="missing"):
        tstmt.bind_sql([0.06])
    with pytest.raises(ValueError, match="no \\$placeholders"):
        tctx.prepare("select 1")
