"""The port's fused multiway joins and the one-task staged path against
the reference package's on the CPU:

- the fusion-pass units of tests/test_multiway_join.py (default off, the
  broadcast chain of case A, the identity-shuffle deletion of case B, the
  stop at a re-keying shuffle), with equal staged plans and equal counter
  deltas in both packages; the star queries S1 and S2 fuse into one node
  of three steps at T = 1 and 8;
- the verifier's multiway arms (DFTPU011/012/023/025/034), with the
  reference's findings;
- `MultiwayHashJoinExec` on a seeded fixture (K = 2 and K = 3): the port's
  fused node (its binary chain, one single-table probe a step), the
  port's chain and the reference's fused node give byte-identical tables;
- `collect_distributed_table(1)` with `multiway_join` on: the 13 TPC-H
  queries that fuse at one task and the star queries S1 and S2 (S2's first
  step keeps the suppliers of one nation) equal the reference's
  `collect_distributed_table(1)` on a one-device CPU mesh; the other 9
  equal the reference's `collect_table`. Capacities and retry counts are
  equal too, and every result equals the port's own `collect_table` byte
  for byte. (Both stars over 8 tasks: tests/test_torch_tasks.py.)"""

import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.io.parquet import arrow_to_table as j_arrow
from datafusion_distributed_tpu.plan import exchanges as jex
from datafusion_distributed_tpu.plan import joins as jjoins
from datafusion_distributed_tpu.plan import physical as jphys
from datafusion_distributed_tpu.plan import verify as jver
from datafusion_distributed_tpu.runtime.telemetry import DEFAULT_REGISTRY
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table as t_arrow
from datafusion_distributed_tpu_torch.plan import exchanges as tex
from datafusion_distributed_tpu_torch.plan import joins as tjoins
from datafusion_distributed_tpu_torch.plan import physical as tphys
from datafusion_distributed_tpu_torch.plan import verify as tver
from datafusion_distributed_tpu_torch.runtime import adaptivity
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import (
    assert_results_equal,
    assert_staged_plans_equal,
    diagnostics,
    identical,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QDIR = os.path.join(REPO, "benchmarks", "queries", "tpch")

#: the star query: lineitem probes orders, part and supplier on its own
#: keys, so its three joins fuse into one node
S1 = """select s_nationkey, p_brand, o_orderpriority, count(*) as n,
       sum(l_quantity) as q
from lineitem join orders on l_orderkey = o_orderkey
join part on l_partkey = p_partkey join supplier on l_suppkey = s_suppkey
group by s_nationkey, p_brand, o_orderpriority
order by s_nationkey, p_brand, o_orderpriority"""

#: S1's star with a selective first step: the suppliers of one nation
S2 = """select p_brand, o_orderpriority, count(*) as n, sum(l_quantity) as q
from lineitem join orders on l_orderkey = o_orderkey
join part on l_partkey = p_partkey join supplier on l_suppkey = s_suppkey
where s_nationkey = 3
group by p_brand, o_orderpriority order by p_brand, o_orderpriority"""
STARS = {"S1": S1, "S2": S2}

#: the TPC-H queries with a fused node at one task (SF 0.002, seed 7)
FUSED = ["q2", "q3", "q5", "q7", "q8", "q9", "q10", "q11", "q16", "q17",
         "q18", "q20", "q21"]
UNFUSED = [f"q{i}" for i in range(1, 23) if f"q{i}" not in FUSED]


def _sql(q: str) -> str:
    if q in STARS:
        return STARS[q]
    with open(os.path.join(QDIR, f"{q}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def arrow_tables():
    return gen_tpch(0.002, 7)


def _contexts(arrow_tables, **opts):
    """A reference and a port session over the same TPC-H tables, with the
    same session options."""
    jctx, tctx = JContext(), TContext(device="cpu")
    for name, tbl in arrow_tables.items():
        jctx.register_arrow(name, tbl)
        tctx.register_arrow(name, tbl)
    for ctx in (jctx, tctx):
        ctx.config.distributed_options.update(opts)
    return jctx, tctx


def _ref_counter(name: str) -> float:
    fam = DEFAULT_REGISTRY.snapshot().get(name, {})
    return sum(v for _, v in fam.get("samples", []))


def _planned(ctxs, q: str, num_tasks: int = 4):
    """-> (reference staged plan, port staged plan), checked equal, and the
    counter deltas the two planners noted."""
    names = ("dftpu_joins_fused", "dftpu_exchanges_deleted")
    j0 = [_ref_counter(n) for n in names]
    t0 = [adaptivity.counter(n) for n in names]
    jp = ctxs[0].sql(_sql(q)).distributed_plan(num_tasks=num_tasks)
    tp = ctxs[1].sql(_sql(q)).distributed_plan(num_tasks=num_tasks)
    jd = [_ref_counter(n) - v for n, v in zip(names, j0)]
    td = [adaptivity.counter(n) - v for n, v in zip(names, t0)]
    assert td == jd, (q, td, jd)
    assert_staged_plans_equal(jp, tp, num_tasks, q)
    return jp, tp, td


def _mw_nodes(plan):
    return plan.collect(
        lambda n: isinstance(n, tjoins.MultiwayHashJoinExec))


# ---------------------------------------------------------------------------
# the fusion pass
# ---------------------------------------------------------------------------


def test_fusion_off_by_default(arrow_tables):
    _jp, tp, deltas = _planned(_contexts(arrow_tables), "q5")
    assert not _mw_nodes(tp) and deltas == [0, 0]


def test_fusion_case_a_broadcast_chain(arrow_tables):
    """Default broadcast config: q5's five joins chain directly (no probe
    exchanges) and fuse into ONE node; nothing to delete."""
    _jp, tp, (fused, deleted) = _planned(
        _contexts(arrow_tables, multiway_join=True), "q5")
    (mw,) = _mw_nodes(tp)
    assert len(mw.steps) == 5 and mw.multiway_deleted_exchanges == 0
    assert mw.multiway_bailout_candidate
    assert fused == 5 and deleted == 0


def test_fusion_case_b_identity_shuffle_deletion(arrow_tables):
    """Co-shuffled q21: the consecutive probe re-shuffles on l1.l_orderkey
    are identity re-partitions; fusing the chain deletes the two interior
    ones, and the fused node runs on the base shuffle's layout."""
    _jp, tp, (fused, deleted) = _planned(_contexts(
        arrow_tables, multiway_join=True, broadcast_joins=False,
        broadcast_threshold_rows=0), "q21")
    (mw,) = _mw_nodes(tp)
    assert len(mw.steps) == 3 and mw.multiway_deleted_exchanges == 2
    assert isinstance(mw.probe, tex.ShuffleExchangeExec)
    assert fused == 3 and deleted == 2


def test_fusion_stops_on_rekeying_shuffle(arrow_tables):
    """Co-shuffled q5 re-hashes a DIFFERENT key at every step: deleting those
    shuffles would re-route rows, so nothing fuses."""
    _jp, tp, deltas = _planned(_contexts(
        arrow_tables, multiway_join=True, broadcast_joins=False,
        broadcast_threshold_rows=0), "q5")
    assert not _mw_nodes(tp) and deltas == [0, 0]


@pytest.mark.parametrize("q", ["S1", "S2"])
def test_star_queries_fuse_into_one_node(arrow_tables, q):
    for t in (1, 8):
        _jp, tp, (fused, _deleted) = _planned(
            _contexts(arrow_tables, multiway_join=True), q, t)
        (mw,) = _mw_nodes(tp)
        assert len(mw.steps) == 3 and fused == 3


# ---------------------------------------------------------------------------
# MultiwayHashJoinExec on a seeded fixture, in both packages
# ---------------------------------------------------------------------------


def _fixture_arrow(seed: int, k: int, n=1500, nb=96):
    rng = np.random.default_rng(seed)
    probe = {f"k{i}": rng.integers(0, nb, n) for i in range(1, k + 1)}
    probe["pv"] = np.arange(n)
    builds = [pa.table({f"k{i}": rng.integers(0, nb, nb),
                        f"b{i}": np.arange(nb)}) for i in range(1, k + 1)]
    return pa.table(probe), builds


def _fixture(pkg, seed: int, k: int):
    """-> (binary chain, fused node, [(leaf, table)]) in package ``pkg``."""
    joins, phys, to_table = (
        (jjoins, jphys, j_arrow) if pkg == "j"
        else (tjoins, tphys, lambda a: t_arrow(a, device="cpu")))
    probe_a, builds_a = _fixture_arrow(seed, k)
    pt = to_table(probe_a)
    bts = [to_table(b) for b in builds_a]
    sp = phys.MemoryScanExec([pt], pt.schema())
    sbs = [phys.MemoryScanExec([b], b.schema()) for b in bts]
    cur, steps = sp, []
    for i, sb in enumerate(sbs, start=1):
        cur = joins.HashJoinExec(cur, sb, [f"k{i}"], [f"k{i}"], "inner")
        steps.append(joins.MultiwayJoinStep.from_join(cur))
    mw = joins.MultiwayHashJoinExec(sp, sbs, steps)
    return cur, mw, [(sp, pt)] + list(zip(sbs, bts))


def _run_node(pkg, node, leaves):
    phys = jphys if pkg == "j" else tphys
    ctx = phys.ExecContext(task=phys.DistributedTaskContext(0, 1), inputs={})
    for leaf, table in leaves:
        ctx.inputs[leaf.node_id] = table
    out = node.execute(ctx)
    flags = [bool(f) for _, f in ctx.overflow_flags]
    return out, flags


@pytest.mark.parametrize("k", [2, 3])
def test_multiway_exec_byte_identical_to_reference(k):
    """The fused node, its binary chain and the reference's fused node give
    byte-identical tables."""
    jchain, jmw, jleaves = _fixture("j", 3 + k, k)
    tchain, tmw, tleaves = _fixture("t", 3 + k, k)
    ref, ref_flags = _run_node("j", jmw, jleaves)
    fused, fused_flags = _run_node("t", tmw, tleaves)
    chain, chain_flags = _run_node("t", tchain, tleaves)
    assert not any(ref_flags + fused_flags + chain_flags)
    assert fused_flags == chain_flags
    assert int(fused.num_rows) == int(chain.num_rows) == int(ref.num_rows)
    assert fused.num_rows > 0
    assert fused.capacity == chain.capacity == ref.capacity
    assert fused.names == chain.names == ref.names
    a, b = fused.to_numpy(), chain.to_numpy()
    assert identical(a, b)
    r = {n: np.asarray(v) for n, v in ref.to_numpy().items()}
    assert identical({n: v.astype(a[n].dtype) for n, v in r.items()}, a)
    assert all(a[n].tobytes() == r[n].astype(a[n].dtype).tobytes()
               for n in a)
    assert tmw.display() == jmw.display()


def test_fused_node_probes_one_table_a_step(monkeypatch):
    """The fused node runs as its chain: one single-table probe a step."""
    from datafusion_distributed_tpu_torch.ops import hash_kernels

    calls = []
    real = hash_kernels.multiway_probe

    def counting(keys, *args, **kw):
        calls.append(keys.shape[1])
        return real(keys, *args, **kw)

    monkeypatch.setattr(hash_kernels, "multiway_probe", counting)
    chain, mw, leaves = _fixture("t", 6, 3)
    _run_node("t", mw, leaves)
    assert calls == [1, 1, 1]
    calls.clear()
    _run_node("t", chain, leaves)
    assert calls == [1, 1, 1]


# ---------------------------------------------------------------------------
# the verifier's multiway arms, against the reference's findings
# ---------------------------------------------------------------------------


def _bad_variant(pkg, case: str):
    joins, ex = (jjoins, jex) if pkg == "j" else (tjoins, tex)
    to_table = j_arrow if pkg == "j" else (lambda a: t_arrow(a, device="cpu"))
    phys = jphys if pkg == "j" else tphys
    _chain, mw, _leaves = _fixture(pkg, 8, 2)

    def step(**kw):
        return joins.MultiwayJoinStep(**{**dict(
            probe_keys=("k1",), build_keys=("k1",), join_type="inner",
            out_capacity=64, num_slots=64), **kw})

    def resized(num_slots):
        return [joins.MultiwayJoinStep(**{**s.__dict__,
                                          "num_slots": num_slots})
                for s in mw.steps]

    if case == "DFTPU011":
        return joins.MultiwayHashJoinExec(
            mw.probe, mw.builds, [step(probe_keys=("no_such",)), mw.steps[1]])
    if case == "DFTPU012":
        ft = to_table(pa.table({"k1": np.linspace(0.0, 1.0, 8)}))
        return joins.MultiwayHashJoinExec(
            mw.probe, [phys.MemoryScanExec([ft], ft.schema()), mw.builds[1]],
            [step(), mw.steps[1]])
    if case == "DFTPU023":
        return joins.MultiwayHashJoinExec(mw.probe, mw.builds, resized(8))
    if case == "DFTPU025":
        return joins.MultiwayHashJoinExec(mw.probe, mw.builds,
                                          resized(1 << 21))
    if case == "DFTPU034":
        return joins.MultiwayHashJoinExec(
            mw.probe,
            [ex.ShuffleExchangeExec(mw.builds[0], ["k1"], 4, 64),
             ex.ShuffleExchangeExec(mw.builds[1], ["k2"], 8, 64)],
            list(mw.steps))
    raise ValueError(case)


#: code -> is the plan still ok (a warning) or not (an error)
VERIFIER_ARMS = {"DFTPU011": False, "DFTPU012": False, "DFTPU023": True,
                 "DFTPU025": True, "DFTPU034": False}


@pytest.mark.parametrize("code", sorted(VERIFIER_ARMS))
def test_verifier_multiway_arms_match_reference(code):
    jr = jver.verify_physical_plan(_bad_variant("j", code))
    tr = tver.verify_physical_plan(_bad_variant("t", code))
    assert diagnostics(tr) == diagnostics(jr)
    assert code in tr.codes()
    assert tr.ok == jr.ok == VERIFIER_ARMS[code]


# ---------------------------------------------------------------------------
# the one-task staged path against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def staged(arrow_tables):
    return _contexts(arrow_tables, multiway_join=True)


@pytest.mark.parametrize("q", FUSED + list(STARS) + UNFUSED)
def test_one_task_staged_results_match_reference(staged, q):
    jctx, tctx = staged
    jdf, tdf = jctx.sql(_sql(q)), tctx.sql(_sql(q))
    # the reference runs its fused plans on a one-device mesh; the rest
    # equal its single-node session (their staged plan is that plan)
    ref = (jdf.collect_distributed_table(1) if q not in UNFUSED
           else jdf.collect_table())
    got = tdf.collect_distributed_table(1)
    assert got.capacity == ref.capacity and got.names == ref.names, q
    assert tdf.last_retry_count == jdf.last_retry_count, q
    assert_results_equal(ref.to_numpy(), got.to_numpy(), q)
    plan = tdf.distributed_plan(1, tdf._seeded_distributed_config(1))
    assert bool(_mw_nodes(plan)) == (q not in UNFUSED), q
    single = tctx.sql(_sql(q)).collect_table()
    assert identical(got.to_numpy(), single.to_numpy()), q
