"""The port's runtime leak harness (runtime/leakcheck.py) against the
reference's, on the CPU: the counterpart of the runtime half of
tests/test_resource_lifecycle.py (its static half, the lint over the port's
files, is in tests/test_torch_lockcheck.py).

Only the port's harness is armed in this process (a fixture over the port's
module, strict). The reference's harness runs in a subprocess of its own,
armed there by its ``DFTPU_LEAK_CHECK`` switch, so this process never
changes the reference's state. Each case runs both packages on the same
input and compares what each observes:

- an injected leak flagged at its query's sweep with its acquisition
  stack; a sweep counted into telemetry and the event log; TableStore
  entries tracked and released; ``assert_clean`` and its survivors;
- the ``DFTPU_LEAK_CHECK`` switch: the port imported under
  ``DFTPU_LEAK_CHECK=1`` with jax blocked arms its harness (not strict),
  counts a swept leak, and its ``DFTPU_LEAK_CHECK_ARTIFACT`` dump carries
  the same counts as the reference's and the port's own declared model;
- the reference suite's chaos-crash, membership-churn and hedging
  schedules leak-clean under strict, each result held against the
  reference's run of the same schedule; an armed run returning what an
  unarmed one does;
- one strict replay each of the seeded schedules of the port's serving,
  churn and hedging files (tests/test_torch_serving.py,
  test_torch_elasticity.py, test_torch_hedging.py), held against the
  reference's coordinated results.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from datafusion_distributed_tpu_torch.runtime import leakcheck as tleak
from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_no_leaks,
    assert_results_equal,
    identical,
    sum_by_key_plan,
    tpch_contexts,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCH_DIR = os.path.join(REPO, "benchmarks", "queries", "tpch")
CHAOS_SEED = int(os.environ.get("DFTPU_CHAOS_SEED", "20260803"))
FAST = {"task_retry_backoff_s": 0.001}


def _sql(q: str) -> str:
    with open(os.path.join(TPCH_DIR, f"{q}.sql")) as f:
        return f.read()


@pytest.fixture
def armed(monkeypatch):
    """The port's harness armed strict for one test, its state restored
    after; nothing may be live or flagged when the test ends."""
    monkeypatch.setattr(tleak, "_installed", True)
    monkeypatch.setattr(tleak, "_strict", True)
    tleak.reset()
    yield tleak
    try:
        tleak.assert_clean(exclude_unattributed=True)
        assert not tleak.leaks(), tleak.leaks()
    finally:
        tleak.reset()


# ---------------------------------------------------------------------------
# harness units: the port in process, the reference in a subprocess
# ---------------------------------------------------------------------------


def _injected_leak(P, lc):
    lc.note_acquire("spill-slot", "/tmp/leaky-slot", query_id="q-inj",
                    tag="test-injection")
    try:
        lc.sweep_query("q-inj")
        records = None
    except lc.ResourceLeakError as e:
        records = e.records
    (rec,) = records
    leaked = lc.leaks()
    lc.note_acquire("spill-slot", "/tmp/ok", query_id="q-ok")
    lc.note_release("spill-slot", "/tmp/ok")
    return {
        "record": {k: rec[k] for k in ("kind", "key", "query_id", "tag",
                                       "leaked_at")},
        "fields": sorted(rec),
        "stack_names_site": any("test_torch_leakcheck" in fr
                                for fr in rec["stack"]),
        "leaks": [r["key"] for r in leaked],
        "clean_sweep": lc.sweep_query("q-ok"),
    }


def _sweep_telemetry(P, lc):
    reg = P("runtime.telemetry").DEFAULT_REGISTRY
    log = P("runtime.eventlog").default_event_log()

    def total():
        fam = (reg.snapshot().get("dftpu_leaked_resources") or {}).get(
            "samples", [])
        return sum(v for _labels, v in fam)

    before = total()
    seq0 = max((e["seq"] for e in log.events()), default=-1)
    strict = lc._strict
    lc._strict = False  # count, don't raise
    try:
        lc.note_acquire("shm-segment", ("seg", 1), query_id="q-tel")
        flagged = lc.sweep_query("q-tel")
    finally:
        lc._strict = strict
    events = [{k: v for k, v in e.items() if k not in ("ts", "seq")}
              for e in log.events(kind="resources_leaked")
              if e["seq"] > seq0]
    return {"flagged": len(flagged), "telemetry": total() - before,
            "events": events}


def _table_store(P, lc):
    s = P("runtime.codec").TableStore()
    tid = s.put(P.table(pa.table({"x": np.arange(64)})))
    live = lc.live(kind="store-entry")
    out = {"live": [(r["key"][1] == tid, r["query_id"]) for r in live]}
    s.remove([tid])
    out["after"] = lc.live(kind="store-entry")
    lc.assert_clean()
    return out


def _assert_clean(P, lc):
    lc.note_acquire("stream-puller", ("q", 0), query_id="q-x")
    out = []
    try:
        lc.assert_clean()
        out.append("clean")
    except lc.ResourceLeakError as e:
        out.append(len(e.records))
    lc.reset()
    lc.note_acquire("checkpoint-slice", ("r", 0, 0), query_id=None)
    lc.assert_clean(exclude_unattributed=True)
    try:
        lc.assert_clean()
        out.append("clean")
    except lc.ResourceLeakError as e:
        out.append(len(e.records))
    lc.reset()
    return out


UNIT_CASES = {"injected_leak": _injected_leak,
              "sweep_telemetry": _sweep_telemetry,
              "table_store": _table_store,
              "assert_clean": _assert_clean}

_REFERENCE_UNITS = textwrap.dedent("""
    import json, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    from datafusion_distributed_tpu.runtime import leakcheck
    assert leakcheck.enabled() and leakcheck.strict()
    from tests.test_torch_leakcheck import UNIT_CASES
    from tests.torch_port_helpers import REF
    out = {}
    for name, fn in UNIT_CASES.items():
        leakcheck.reset()
        out[name] = fn(REF, leakcheck)
    print("UNITS=" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_units():
    """Each unit case run through the reference's harness, armed strict
    by its own switch in a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", DFTPU_LEAK_CHECK="strict",
               PYTHONPATH=REPO)
    env.pop("DFTPU_LEAK_CHECK_ARTIFACT", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_UNITS],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("UNITS=")][-1]
    return json.loads(line[len("UNITS="):])


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_harness_units_match_reference(armed, reference_units, case):
    got = json.loads(json.dumps(UNIT_CASES[case](PORT, armed)))
    assert got == reference_units[case], case
    if case == "injected_leak":
        assert got["record"]["kind"] == "spill-slot"
        assert got["record"]["tag"] == "test-injection"
        assert got["stack_names_site"] and got["clean_sweep"] == []
        assert got["leaks"] == ["/tmp/leaky-slot"]
        armed.reset()
    elif case == "sweep_telemetry":
        assert got["flagged"] == 1 and got["telemetry"] == 1
        assert got["events"][-1]["shm-segment"] == 1
        armed.reset()
    elif case == "table_store":
        assert got["live"] == [[True, None]] and got["after"] == []
    else:
        assert got == [1, 1]


# ---------------------------------------------------------------------------
# the DFTPU_LEAK_CHECK switch
# ---------------------------------------------------------------------------

_SWITCH = textwrap.dedent("""
    import json, sys
    if {port!r}:
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        import {root}  # noqa: F401
        assert "datafusion_distributed_tpu" not in sys.modules
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import {root}  # noqa: F401
    from {root}.runtime import leakcheck
    assert leakcheck.enabled() and not leakcheck.strict()
    leakcheck.note_acquire("spill-slot", "/tmp/x", query_id="q")
    assert len(leakcheck.sweep_query("q")) == 1
    print("ARMED-OK")
""")


def _switch(P, artifact):
    env = dict(os.environ, JAX_PLATFORMS="cpu", DFTPU_LEAK_CHECK="1",
               DFTPU_LEAK_CHECK_ARTIFACT=str(artifact), PYTHONPATH=REPO)
    code = _SWITCH.format(port=P is PORT, root=P.root)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, cwd=REPO, timeout=240)
    assert "ARMED-OK" in r.stdout, (P, r.stderr[-4000:])
    return json.loads(artifact.read_text())


def test_leak_check_switch_arms_the_port(tmp_path):
    """``DFTPU_LEAK_CHECK=1`` at import arms the port's harness, as it
    arms the reference's; the artifact's counts equal the reference's, and
    its declared model is the one the lint builds over the port's files."""
    ref = _switch(REF, tmp_path / "ref.json")
    got = _switch(PORT, tmp_path / "port.json")
    assert got["installed"] and not got["strict"]
    assert got["counts"] == ref["counts"] == {
        "spill-slot": {"acquired": 1, "released": 0, "leaked": 1}}
    assert [r["key"] for r in got["leaks"]] == ["/tmp/x"]
    model = got["declared_model"]
    assert model and sorted(model) == sorted(ref["declared_model"])
    for kind, decl in model.items():
        assert decl["acquirers"], kind
        assert decl["modules"] and all(
            m.startswith("datafusion_distributed_tpu_torch/")
            for m in decl["modules"]), (kind, decl["modules"])
        assert {k: v for k, v in decl.items() if k != "modules"} == \
            ref["declared_model"][kind], kind
    assert "store-entry" in model


# ---------------------------------------------------------------------------
# the seeded schedules, leak-clean under strict
# ---------------------------------------------------------------------------


def _crash(P, cluster):
    chaos = P("runtime.chaos")
    return chaos.wrap_cluster(cluster, chaos.one_crash_per_stage(CHAOS_SEED))


def _leave(P, cluster):
    chaos = P("runtime.chaos")
    return chaos.wrap_cluster(cluster, chaos.FaultPlan(CHAOS_SEED, [],
                              membership=[chaos.MembershipEvent(
                                  "leave", cluster.get_urls()[0],
                                  site="execute", nth_call=0)]))


def _straggle(P, cluster):
    chaos = P("runtime.chaos")
    return chaos.wrap_cluster(cluster, chaos.FaultPlan(CHAOS_SEED, [
        chaos.FaultSpec(site="execute", kind="straggler", delay_s=0.4,
                        workers=[cluster.get_urls()[1]], rate=1.0)]))


#: the reference suite's schedules: (cluster class, wrap, knobs, check)
SCHEDULES = {
    "chaos_crash": ("InMemoryCluster", _crash, {},
                    lambda w, c, victim: any(f["kind"] == "crash"
                                             for f in w.plan.fired)),
    "membership_churn": ("DynamicCluster", _leave, {},
                         lambda w, c, victim: victim not in c.get_urls()),
    "hedging": ("InMemoryCluster", _straggle,
                {"hedging": True, "hedge_floor_s": 0.05, "hedge_budget": 4},
                lambda w, c, victim: True),
}


def _sweep_all(coord):
    """Sweep every query the coordinator ran: under strict a survivor
    raises from sweep_query with its acquisition stack."""
    for qid in {k.query_id for k in list(coord.metrics)}:
        coord.sweep_query(qid)


def _schedule(P, name):
    cls, wrap, knobs, check = SCHEDULES[name]
    cluster = getattr(P("runtime.coordinator"), cls)(3)
    victim = cluster.get_urls()[0]
    wrapped = wrap(P, cluster)
    coord = P("runtime.coordinator").Coordinator(
        resolver=wrapped, channels=wrapped,
        config_options={**FAST, **knobs})
    out = coord.execute(sum_by_key_plan(P)).to_numpy()
    assert len(out["k"]) == 16
    assert check(wrapped, cluster, victim), (P, name)
    assert_no_leaks(cluster)
    _sweep_all(coord)
    order = np.argsort(out["k"], kind="stable")
    return {k: v[order] for k, v in out.items()}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_leak_clean_under_strict(armed, name):
    ref = _schedule(REF, name)
    got = _schedule(PORT, name)
    armed.assert_clean(exclude_unattributed=True)
    counts = armed.report(include_static=False)["counts"]
    assert counts.get("store-entry", {}).get("acquired", 0) > 0, counts
    assert all(c["leaked"] == 0 for c in counts.values()), counts
    assert_results_equal(ref, got, name)


def test_armed_run_returns_what_an_unarmed_one_does(monkeypatch):
    """The counterpart of the reference's "harness adds zero XLA traces":
    arming the port's harness changes no result byte."""
    co = PORT("runtime.coordinator")

    def run():
        cluster = co.InMemoryCluster(3)
        coord = co.Coordinator(resolver=cluster, channels=cluster,
                               config_options=FAST)
        return coord.execute(sum_by_key_plan(PORT)).to_numpy(), coord

    plain, _ = run()
    monkeypatch.setattr(tleak, "_installed", True)
    monkeypatch.setattr(tleak, "_strict", False)
    tleak.reset()
    try:
        got, coord = run()
        _sweep_all(coord)
        counts = tleak.report(include_static=False)["counts"]
    finally:
        tleak.reset()
    assert counts["store-entry"]["acquired"] > 0
    assert counts["store-entry"]["leaked"] == 0
    assert identical(plain, got)


# ---------------------------------------------------------------------------
# strict replays of the port's serving, churn and hedging schedules
# ---------------------------------------------------------------------------

MIX = ("q1", "q3", "q6")


@pytest.fixture(scope="module")
def tpch():
    """Both packages' sessions as tests/test_torch_serving.py configures
    them; ``ref(q)`` the reference's sequential coordinated result."""
    ctxs = tpch_contexts(bytes_per_task=1, broadcast_joins=False,
                         task_retry_backoff_s=0.001)
    memo = {}

    def ref(q):
        if q not in memo:
            ctx = ctxs[REF]
            co = REF("runtime.coordinator")
            cluster = co.InMemoryCluster(4)
            coord = co.Coordinator(
                resolver=cluster, channels=cluster,
                config_options=ctx.config.distributed_snapshot())
            memo[q] = ctx.sql(_sql(q)).collect_coordinated_table(
                coordinator=coord, num_tasks=4).to_numpy()
        return memo[q]

    return ctxs, ref


def _sweep_cluster_clean(cluster):
    assert_no_leaks(cluster)
    for w in cluster.workers.values():
        assert w.table_store.stats()["spill_files"] == 0, w.url


def test_serving_replay_leak_clean_under_strict(armed, tpch):
    """tests/test_torch_serving.py's concurrent mix: six clients submit
    q1, q3 and q6 twice each at once."""
    ctxs, ref = tpch
    co = PORT("runtime.coordinator")
    cluster = co.InMemoryCluster(4)
    results: dict = {}
    errors: list = []
    with PORT("runtime.serving").ServingSession(
            ctxs[PORT], cluster=cluster, num_tasks=4, fair_share=True,
            seed=3) as srv:
        def client(i):
            try:
                for _ in range(2):
                    q = MIX[i % len(MIX)]
                    results.setdefault(q, []).append(srv.submit(_sql(
                        q)).result_table(timeout=120).to_numpy())
            except BaseException as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not errors, errors
    _sweep_cluster_clean(cluster)
    for q in MIX:
        assert len(results[q]) == 4, q
        for got in results[q]:
            assert_results_equal(ref(q), got, f"served {q}")


def test_churn_replay_leak_clean_under_strict(armed, tpch):
    """tests/test_torch_elasticity.py's leave + join + drain schedule on
    q3 over three workers."""
    ctxs, ref = tpch
    co = PORT("runtime.coordinator")
    chaos = PORT("runtime.chaos")
    cluster = co.DynamicCluster(3)
    urls = cluster.get_urls()
    wrapped = chaos.wrap_cluster(cluster, chaos.FaultPlan(
        CHAOS_SEED, [], membership=[
            chaos.MembershipEvent("leave", urls[1], site="execute",
                                  nth_call=0),
            chaos.MembershipEvent("join", "mem://joiner-0", site="set_plan",
                                  nth_call=4),
            chaos.MembershipEvent("drain", urls[2], site="execute",
                                  nth_call=3)]))
    coord = co.Coordinator(
        resolver=wrapped, channels=wrapped,
        config_options={**ctxs[PORT].config.distributed_snapshot(),
                        "max_task_retries": 6})
    got = ctxs[PORT].sql(_sql("q3")).collect_coordinated_table(
        coordinator=coord, num_tasks=4).to_numpy()
    assert sorted(f["kind"] for f in wrapped.plan.fired) == [
        "membership_drain", "membership_join", "membership_leave"]
    assert cluster.wait_drained(urls[2], timeout_s=10.0)
    _sweep_cluster_clean(cluster)
    _sweep_all(coord)
    assert_results_equal(ref("q3"), got, "q3 under churn")


def test_hedging_replay_leak_clean_under_strict(armed, tpch):
    """tests/test_torch_hedging.py's sticky straggler on worker-1 with
    hedging on: q1, q6 and q3 through one coordinator."""
    ctxs, ref = tpch
    co = PORT("runtime.coordinator")
    chaos = PORT("runtime.chaos")
    plan = chaos.FaultPlan(CHAOS_SEED, [chaos.FaultSpec(
        site="execute", kind="straggler", delay_s=0.4,
        workers=["worker-1"], rate=1.0)], query_scoped=True)
    wrapped = chaos.wrap_cluster(co.InMemoryCluster(4), plan)
    coord = co.Coordinator(
        resolver=wrapped, channels=wrapped,
        config_options={**ctxs[PORT].config.distributed_snapshot(),
                        "hedging": True, "hedge_floor_s": 0.05,
                        "hedge_budget": 4})
    for q in ("q1", "q6", "q3"):
        got = ctxs[PORT].sql(_sql(q)).collect_coordinated_table(
            coordinator=coord, num_tasks=4).to_numpy()
        assert_results_equal(ref(q), got, f"hedged {q}")
    assert coord.faults.as_dict().get("hedges_issued", 0) >= 1
    assert {f["kind"] for f in plan.fired} == {"straggler"}
    _sweep_cluster_clean(wrapped.inner)
    _sweep_all(coord)

