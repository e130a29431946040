"""The port's straggler hedging and query checkpoint/resume under churn
(runtime/coordinator.py `_hedged_execute` / `_hedged_first_chunk`, the
`HedgeBudget`, runtime/chaos.py `kind="straggler"`) against the
reference's, on the CPU.

The counterparts of tests/test_hedging_recovery.py, each run through both
packages on the same inputs (TPC-H at SF 0.002, seed 7, `bytes_per_task =
1`, no broadcast joins, 4 tasks over 4 in-memory workers, q1, q3, q6):

- results under a sticky straggler with hedging on byte-identical to each
  package's plain coordinated run, and equal across the packages (floats
  at test_rtol());
- the hedge counters as the reference's tests read them, not as exact
  counts (they depend on thread timing): at least one hedge issued and
  resolved, never more hedges in flight than the budget, budget 0 denies
  every hedge, a hedge loss never trips the breaker;
- the seeded straggler election and the injected delay's cancel poll
  equal to the reference's;
- checkpoint resume (byte-identical, every saved stage restored), the
  fingerprint-mismatch and departed-worker fallbacks, and the serving
  tier's `recover()`, with the same counters in both packages;
- after every query no worker keeps a staged slice or a task.
"""

import os
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from datafusion_distributed_tpu.data.tpchgen import gen_tpch
from datafusion_distributed_tpu.runtime import chaos as jchaos
from datafusion_distributed_tpu.runtime import checkpoint as jckpt
from datafusion_distributed_tpu.runtime import coordinator as jcoord
from datafusion_distributed_tpu.runtime import serving as jserving
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.runtime import chaos as tchaos
from datafusion_distributed_tpu_torch.runtime import checkpoint as tckpt
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.runtime import serving as tserving
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import assert_results_equal, identical

torch.set_num_threads(1)

REF = SimpleNamespace(name="reference", coordinator=jcoord, chaos=jchaos,
                      checkpoint=jckpt, serving=jserving)
PORT = SimpleNamespace(name="port", coordinator=tcoord, chaos=tchaos,
                       checkpoint=tckpt, serving=tserving)
PKGS = (REF, PORT)

SEED = 20260803
OPTS = {"bytes_per_task": 1, "broadcast_joins": False,
        "task_retry_backoff_s": 0.001}
TPCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "queries", "tpch")


def _sql(q: str) -> str:
    with open(os.path.join(TPCH_DIR, f"{q}.sql")) as f:
        return f.read()


MIX = {"q1": _sql("q1"), "q3": _sql("q3"), "q6": _sql("q6")}


@pytest.fixture(scope="module")
def ctxs():
    arrow = gen_tpch(sf=0.002, seed=7)
    out = {}
    for p, ctx in ((REF, JContext()), (PORT, TContext(device="cpu"))):
        ctx.config.distributed_options.update(OPTS)
        for name, tbl in arrow.items():
            ctx.register_arrow(name, tbl)
        out[p.name] = ctx
    return out


@pytest.fixture(scope="module")
def plain(ctxs):
    """package -> query -> its plain coordinated result over 4 workers;
    the two packages' results equal."""
    out = {}
    for p in PKGS:
        out[p.name] = {
            q: _run(p, ctxs[p.name], q, p.coordinator.InMemoryCluster(4))[0]
            for q in MIX}
    for q in MIX:
        assert_results_equal(out["reference"][q], out["port"][q], q)
    return out


def _coord(p, cluster, **opts):
    return p.coordinator.Coordinator(resolver=cluster, channels=cluster,
                                     config_options={**OPTS, **opts})


def _run(p, ctx, q, cluster, coord=None, num_tasks=4, **opts):
    coord = coord or _coord(p, cluster, **opts)
    out = ctx.sql(MIX[q]).collect_coordinated_table(
        coordinator=coord, num_tasks=num_tasks).to_numpy()
    return out, coord


def _hedge_opts(**over):
    """Hedging on with a floor far below the injected straggler delay."""
    return {"hedging": True, "hedge_floor_s": 0.05, "hedge_budget": 4,
            **over}


def _straggler_plan(p, seed=SEED, delay_s=0.4, workers=("worker-1",)):
    return p.chaos.FaultPlan(seed, [p.chaos.FaultSpec(
        site="execute", kind="straggler", delay_s=delay_s,
        workers=list(workers), rate=1.0)], query_scoped=True)


def _assert_no_leaks(cluster):
    for w in cluster.workers.values():
        assert not w.table_store.tables, f"{w.url} leaked staged tables"
        assert len(w.registry) == 0, f"{w.url} leaked task entries"


# ---------------------------------------------------------------------------
# chaos: sticky straggler + interruptible delays
# ---------------------------------------------------------------------------


class _DummyWorker:
    url = "mem://dummy-0"

    def execute_task(self, key):
        return "ok"


class _Key:
    query_id, stage_id, task_number = "q", 0, 0


def test_straggler_election_sticky_and_seeded():
    """One seeded election per (query, url), every later matching call
    slow; the elections of a sub-rate schedule equal the reference's."""
    seen = []
    for p in PKGS:
        plan = _straggler_plan(p, seed=11, delay_s=0.05, workers=("dummy",))
        w = p.chaos.ChaosWorker(_DummyWorker(), plan)
        t0 = time.monotonic()
        for _ in range(3):
            w.execute_task(_Key())
        assert time.monotonic() - t0 >= 0.14, p.name
        obs = [[f["kind"] for f in plan.fired]]
        elected = p.chaos.FaultPlan(3, [p.chaos.FaultSpec(
            site="execute", kind="straggler", delay_s=0.0, rate=0.5)])
        for i in range(6):
            class K:
                query_id, stage_id, task_number = "q", 0, i

            p.chaos.ChaosWorker(type("W", (), {
                "url": f"mem://w-{i}",
                "execute_task": lambda self, key: None,
            })(), elected).execute_task(K())
        obs.append([f["url"] for f in elected.fired])
        seen.append(obs)
    assert seen[1] == seen[0]
    assert seen[0][0] == ["straggler"]


def test_injected_delay_polls_cancel():
    for p in PKGS:
        plan = p.chaos.FaultPlan(SEED, [p.chaos.FaultSpec(
            site="execute", kind="delay", delay_s=2.0, rate=1.0)])
        w = p.chaos.ChaosWorker(_DummyWorker(), plan)
        ev = threading.Event()
        walls = {}

        def call():
            t0 = time.monotonic()
            w.execute_task(_Key(), cancel=ev)
            walls["wall"] = time.monotonic() - t0

        t = threading.Thread(target=call)
        t.start()
        time.sleep(0.1)
        ev.set()
        t.join(timeout=5)
        assert not t.is_alive()
        assert walls["wall"] < 1.0, (p.name, walls)


# ---------------------------------------------------------------------------
# straggler hedging
# ---------------------------------------------------------------------------


def _hedged(p, ctx, queries, **opts):
    """``queries`` through one coordinator with hedging on over a sticky
    straggler -> (results, coordinator, fired kinds)."""
    plan = _straggler_plan(p)
    chaos = p.chaos.wrap_cluster(p.coordinator.InMemoryCluster(4), plan)
    coord = _coord(p, chaos, **_hedge_opts(**opts))
    outs = {q: _run(p, ctx, q, None, coord=coord)[0] for q in queries}
    _assert_no_leaks(chaos.inner)
    return outs, coord, {f["kind"] for f in plan.fired}


def test_hedge_fires_winner_wins_byte_identical(ctxs, plain):
    for p in PKGS:
        outs, coord, kinds = _hedged(p, ctxs[p.name], ("q1", "q6", "q3"))
        for q, got in outs.items():
            assert identical(got, plain[p.name][q]), (p.name, q)
        fc = coord.faults.as_dict()
        assert fc.get("hedges_issued", 0) >= 1, (p.name, fc)
        assert fc.get("hedges_won", 0) + fc.get("hedges_lost", 0) >= 1, fc
        assert kinds == {"straggler"}


def test_hedge_loss_never_trips_breaker(ctxs, plain):
    for p in PKGS:
        outs, coord, _k = _hedged(p, ctxs[p.name], ("q3",))
        assert identical(outs["q3"], plain[p.name]["q3"]), p.name
        fc = coord.faults.as_dict()
        assert fc.get("hedges_issued", 0) >= 1, (p.name, fc)
        assert fc.get("workers_quarantined", 0) == 0, (p.name, fc)
        snap = coord.health.snapshot() if coord.health is not None else {}
        assert all(s["state"] == "closed" for s in snap.values()), snap
        assert any(s.get("hedge_losses", 0) >= 1 for s in snap.values())


def test_hedge_budget_bound(ctxs, plain):
    """Budget 0 denies every speculative attempt; budget 1 bounds the
    hedges in flight to one at any instant."""
    for p in PKGS:
        ctx = ctxs[p.name]
        chaos = p.chaos.wrap_cluster(p.coordinator.InMemoryCluster(4),
                                     _straggler_plan(p, delay_s=0.2))
        got, coord = _run(p, ctx, "q6", chaos,
                          **_hedge_opts(hedge_budget=0))
        assert identical(got, plain[p.name]["q6"]), p.name
        fc = coord.faults.as_dict()
        assert fc.get("hedges_issued", 0) == 0, (p.name, fc)
        assert fc.get("hedge_budget_denied", 0) >= 1, (p.name, fc)
        _assert_no_leaks(chaos.inner)
        outs, coord, _k = _hedged(p, ctx, ("q3",), hedge_budget=1)
        assert identical(outs["q3"], plain[p.name]["q3"]), p.name
        assert coord.faults.get("hedges_issued") >= 1
        assert coord.hedges.peak_in_flight <= 1, coord.hedges.stats()


def test_hedging_deterministic_under_seed(ctxs, plain):
    for p in PKGS:
        fired = []
        for _run_ in range(2):
            plan = _straggler_plan(p)
            chaos = p.chaos.wrap_cluster(p.coordinator.InMemoryCluster(4),
                                         plan)
            got, _c = _run(p, ctxs[p.name], "q3", chaos, **_hedge_opts())
            assert identical(got, plain[p.name]["q3"]), p.name
            fired.append(sorted((f["kind"], f["url"]) for f in plan.fired))
            _assert_no_leaks(chaos.inner)
        assert fired[0] == fired[1], (p.name, fired)


# ---------------------------------------------------------------------------
# query checkpoint/resume
# ---------------------------------------------------------------------------


def _run_to_failure(p, ctx, cluster, store, rid):
    """q3 whose root stage's only attempt crashes after its producer
    stages completed and checkpointed."""
    chaos = p.chaos.wrap_cluster(cluster, p.chaos.FaultPlan(SEED, [
        p.chaos.FaultSpec(site="execute", kind="crash", stages=[-1],
                          rate=1.0)]))
    c1 = _coord(p, chaos, peer_shuffle=False, max_task_retries=0)
    c1.checkpoints = p.checkpoint.QueryCheckpointer(store, rid, chaos, chaos)
    with pytest.raises(Exception):
        ctx.sql(MIX["q3"]).collect_coordinated(coordinator=c1, num_tasks=4)
    return c1


def _resume(p, ctx, cluster, store, rid, num_tasks=4):
    c2 = _coord(p, cluster, peer_shuffle=False)
    c2.checkpoints = p.checkpoint.QueryCheckpointer(store, rid, cluster,
                                                    cluster)
    got, _c = _run(p, ctx, "q3", None, coord=c2, num_tasks=num_tasks)
    return got, c2.faults.as_dict()


def test_checkpoint_resume_mid_query_byte_identical(ctxs, plain):
    seen = []
    for p in PKGS:
        inner = p.coordinator.InMemoryCluster(4)
        store = p.checkpoint.CheckpointStore()
        rid = store.admit(MIX["q3"])
        saved = _run_to_failure(p, ctxs[p.name], inner, store, rid
                                ).faults.get("checkpoint_stages_saved")
        assert saved >= 2 and store.stats()["recoverable"] == 1
        got, fc = _resume(p, ctxs[p.name], inner, store, rid)
        assert identical(got, plain[p.name]["q3"]), p.name
        assert fc.get("checkpoint_stages_restored") == saved, fc
        assert fc.get("queries_resumed") == 1, fc
        store.release(rid, inner)
        _assert_no_leaks(inner)
        seen.append(saved)
    assert seen[1] == seen[0]


def test_resume_fingerprint_mismatch_falls_back(ctxs, plain):
    """A resume over another task lattice (2 tasks) restores nothing and
    re-executes, byte-identical to its own plan's plain run."""
    seen = []
    for p in PKGS:
        ctx = ctxs[p.name]
        inner = p.coordinator.InMemoryCluster(4)
        store = p.checkpoint.CheckpointStore()
        rid = store.admit(MIX["q3"])
        _run_to_failure(p, ctx, inner, store, rid)
        base2, _c = _run(p, ctx, "q3", p.coordinator.InMemoryCluster(4),
                         num_tasks=2, peer_shuffle=False)
        got, fc = _resume(p, ctx, inner, store, rid, num_tasks=2)
        assert identical(got, base2), p.name
        # over 2 tasks the port's float sums add in another order than
        # over 4 (the reference's happen to agree byte for byte)
        assert_results_equal(got, plain[p.name]["q3"], p.name)
        assert fc.get("checkpoint_stages_restored", 0) == 0, fc
        assert fc.get("checkpoint_fp_mismatch", 0) >= 1, fc
        store.release(rid, inner)
        _assert_no_leaks(inner)
        seen.append(fc.get("checkpoint_fp_mismatch"))
    assert seen[1] == seen[0]


def test_resume_after_membership_churn_falls_back(ctxs, plain):
    """A worker holding checkpointed slices departs between the teardown
    and the resume: its stages re-execute, the rest restore."""
    seen = []
    for p in PKGS:
        ctx = ctxs[p.name]
        cluster = p.coordinator.DynamicCluster(4)
        store = p.checkpoint.CheckpointStore()
        rid = store.admit(MIX["q3"])
        _run_to_failure(p, ctx, cluster, store, rid)
        rec = store._records[rid]
        held = sorted({url for ck in rec.stages.values()
                       for url, _t, _n in ck.slices})
        assert held, "no checkpointed slices to lose"
        cluster.remove_worker(held[0])
        got, fc = _resume(p, ctx, cluster, store, rid)
        assert identical(got, plain[p.name]["q3"]), p.name
        assert fc.get("checkpoint_slices_lost", 0) >= 1, fc
        store.release(rid, cluster)
        _assert_no_leaks(cluster)
        seen.append((held[0], fc.get("checkpoint_slices_lost")))
    assert seen[1] == seen[0]


def test_serving_recover_after_teardown(ctxs, plain):
    for p in PKGS:
        ctx = ctxs[p.name]
        inner = p.coordinator.InMemoryCluster(4)
        store = p.checkpoint.CheckpointStore()
        opts = ctx.config.distributed_options
        opts["max_task_retries"] = 0
        opts["peer_shuffle"] = False
        try:
            chaos = p.chaos.wrap_cluster(inner, p.chaos.FaultPlan(SEED, [
                p.chaos.FaultSpec(site="execute", kind="crash",
                                  stages=[-1], rate=1.0, max_total=1)]))
            srv1 = p.serving.ServingSession(ctx, cluster=chaos, num_tasks=4,
                                            checkpoints=store)
            h1 = srv1.submit(MIX["q3"])
            with pytest.raises(Exception):
                h1.result(timeout=300)
            srv1.close()
            opts.pop("max_task_retries", None)
            st = store.stats()
            assert st["recoverable"] == 1 and st["stages"] >= 1, st
            srv2 = p.serving.ServingSession(ctx, cluster=inner, num_tasks=4,
                                            checkpoints=store)
            handles = srv2.recover()
            assert len(handles) == 1
            got = handles[0].result_table(timeout=300).to_numpy()
            assert identical(got, plain[p.name]["q3"]), p.name
            fc = srv2.faults.as_dict()
            assert fc.get("queries_recovered") == 1, fc
            assert fc.get("checkpoint_stages_restored", 0) >= 1, fc
            srv2.close()
        finally:
            opts.pop("max_task_retries", None)
            opts.pop("peer_shuffle", None)
        assert store.stats()["recoverable"] == 0, store.stats()
        assert store.stats()["staged_bytes"] == 0, store.stats()
        _assert_no_leaks(inner)


def test_serving_done_and_cancelled_release_checkpoints(ctxs, plain):
    for p in PKGS:
        ctx = ctxs[p.name]
        inner = p.coordinator.InMemoryCluster(4)
        store = p.checkpoint.CheckpointStore()
        opts = ctx.config.distributed_options
        opts["peer_shuffle"] = False
        try:
            with p.serving.ServingSession(ctx, cluster=inner, num_tasks=4,
                                          checkpoints=store) as srv:
                got = srv.submit(MIX["q6"]).result_table(timeout=300)
                assert identical(got.to_numpy(), plain[p.name]["q6"])
                assert store.stats()["queries"] == 0, store.stats()
        finally:
            opts.pop("peer_shuffle", None)
        _assert_no_leaks(inner)
